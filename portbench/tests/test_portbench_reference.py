"""The plain references agree with the program's plain versions on the
CPU, and each control (the reference in the configuration's lower
precision) fails the cell's limits."""

import numpy as np
import pytest
import torch

from portbench.harness import checks, spec
from portbench.reference.plain import Precision, fir, tf32_round


def scene(cell, B, seconds, seed=5):
    c = spec.load_cell(cell)
    c.traffic.update(batch=B, utterance_s=seconds)
    return c, c.scene().make(seed, 0, c.traffic, c.config, "cpu")


def test_ami8_matches_the_programs_plain_version():
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process

    c, batch = scene("ami8.mega.b16", 2, 0.75)
    x = batch["x"].double()
    cfg = dict(c.config, t_chunk=8)  # the rank-1 handover, steady chunks and a re-anchor in 93 frames
    want = c.reference().run({"x": x}, cfg)["y"]
    got = enhance_process(x, ArrayGeometry.circular(8, 0.10), (90.0, 0.0), EnhanceConfig(), backend="mega",
                          inv_mode="rank1", device="cpu", t_chunk=8)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-12


def test_respeaker4_matches_the_programs_plain_version():
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process

    c, batch = scene("respeaker4.fused.b16", 2, 0.5)
    x, far = batch["x"].double(), batch["far"].double()
    want = c.reference().run({"x": x, "far": far}, c.config)
    got = full_stack_process(x, far, ArrayGeometry.circular(4, 0.032), (197.0 / 180.0 * np.pi, 0.0),
                             FullStackConfig(n_mics=4), backend="fused", device="cpu")
    for k, g in zip(("enhanced", "kws", "p"), got):
        assert float((g - want[k]).abs().max() / want[k].abs().max()) < 1e-10, k


def test_fir_is_a_causal_convolution():
    g = torch.Generator().manual_seed(1)
    x, taps = torch.randn(2, 3, 700, generator=g, dtype=torch.float64), torch.randn(3, 150, generator=g, dtype=torch.float64)
    y = fir(x, taps, Precision())
    for b in range(2):
        for ch in range(3):
            ref = np.convolve(x[b, ch].numpy(), taps[ch].numpy())[:700]
            assert np.allclose(y[b, ch].numpy(), ref, atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-12, 1.0 + 2.0**-12, -3.0], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -3.0]


@pytest.mark.parametrize("cell", ["ami8.mega.b16", "respeaker4.fused.b16"])
def test_control_fails_the_cells_limits(cell):
    """The configuration's control at a size a test holds: two 4 s
    utterances on the CPU."""
    c, batch = scene(cell, 2, 4.0)
    pool, samples = [batch], [(0, None)]
    got = checks.control_numbers(c, pool, samples, Precision(c.config["control"]))[0]
    limits = c.checks["limits"]
    assert any(not got[n] <= lim for n, lim in limits.items()), (got, limits)
