"""Each scene is deterministic for a seed, differs between seeds, and puts
the target where the look direction says."""

import numpy as np
import pytest
import torch

from portbench.harness import spec
from portbench.reference.plain import delays_s

SCENES = {"look_burst": "ami8.mega.b256", "echo_look": "respeaker4.fused.b16"}


def small(cell):
    c = spec.load_cell(cell)
    c.traffic.update(batch=2, utterance_s=0.25)
    return c


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_deterministic_for_a_seed(scene):
    c = small(SCENES[scene])
    seed = 2**31 + 12345
    a = c.scene().make(seed, 1, c.traffic, c.config, "cpu")
    b = c.scene().make(seed, 1, c.traffic, c.config, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_differs_between_seeds_and_batches(scene):
    c = small(SCENES[scene])
    a = c.scene().make(7, 0, c.traffic, c.config, "cpu")
    b = c.scene().make(8, 0, c.traffic, c.config, "cpu")
    d = c.scene().make(7, 1, c.traffic, c.config, "cpu")
    assert not torch.equal(a["x"], b["x"]) and not torch.equal(a["x"], d["x"])
    assert a["x"].shape == (2, c.config["array"]["n_mics"], 4000)


def test_target_arrives_with_the_look_directions_delays():
    c = small("ami8.mega.b256")
    c.traffic["scene"] = dict(c.traffic["scene"], snr_db=80.0)  # the target alone, to the eye
    x = c.scene().make(3, 0, c.traffic, c.config, "cpu")["x"][0].double().numpy()
    tau = delays_s(c.config["array"], c.config["look_deg"]) * c.config["array"]["fs"]
    n = x.shape[-1]
    f = np.fft.rfftfreq(n)
    X = np.fft.rfft(x, axis=-1)
    # the cross-spectrum phase of mic m against mic 0 in the band 0.05-0.2 fs
    band = (f > 0.05) & (f < 0.2)
    for m in range(1, x.shape[0]):
        ph = np.angle(X[m, band] * np.conj(X[0, band]))
        slope = np.polyfit(2 * np.pi * f[band], np.unwrap(ph), 1)[0]
        assert abs(-slope - (tau[m] - tau[0])) < 0.05, (m, -slope, tau[m] - tau[0])
