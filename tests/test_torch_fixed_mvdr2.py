"""Port parity for ``beamform/fixed.py`` (DS and SD weights, ``apply_weights``,
``fixed_process``) and the offline MVDR of ``beamform/mvdr.py``
(``offline_mvdr_weights``, ``adaptive_mvdr2_process``), each against its
``distantspeech_tpu`` twin in float64 on the CPU, on linear and circular
arrays: 1e-10 of the output's scale for the closed forms (the weights and
their application) and 1e-9 for the Rvv recursions.  A behavioural check
on a noise-only lead-in: the offline MVDR passes the target and removes a
coherent interferer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.array.steering import steering_vector
from distantspeech_tpu.beamform import fixed as jfix, mvdr as jmvdr
from distantspeech_tpu.transform import StftConfig as JStft
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import fixed as tfix, mvdr as tmvdr
from distantspeech_tpu_torch.transform import StftConfig as TStft

CLOSED, RECURSION = 1e-10, 1e-9


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1e-300))


GEOMS = {"linear4": ("linear", 4, 0.032), "circular4": ("circular", 4, 0.032), "linear3": ("linear", 3, 0.05)}


def _geoms(name):
    kind, M, d = GEOMS[name]
    return getattr(TGeometry, kind)(M, d), getattr(JGeometry, kind)(M, d)


@pytest.mark.parametrize("weight_type", ["DS", "SD"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_fixed_weights_and_process(geom, weight_type):
    tg, jg = _geoms(geom)
    n_fft = 128
    tcfg = tfix.FixedBeamformerConfig(stft=TStft(n_fft, n_fft // 2), weight_type=weight_type, diag_value=1e-2)
    jcfg = jfix.FixedBeamformerConfig(stft=JStft(n_fft, n_fft // 2), weight_type=weight_type, diag_value=1e-2)
    W = tfix.fixed_beamformer_weights(tg, (60.0, 0.0), tcfg)
    np.testing.assert_array_equal(W, jfix.fixed_beamformer_weights(jg, (60.0, 0.0), jcfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, tg.n_mics, 64 * 30))
    X = rng.standard_normal((2, tg.n_mics, 9, 65)) + 1j * rng.standard_normal((2, tg.n_mics, 9, 65))
    _close(tfix.apply_weights(torch.as_tensor(W), torch.as_tensor(X)), jfix.apply_weights(jnp.asarray(W), jnp.asarray(X)),
           CLOSED)
    got = tfix.fixed_process(x, W, tcfg.stft, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    _close(got, jfix.fixed_process(jnp.asarray(x), jnp.asarray(W), jcfg.stft), CLOSED)


def test_fixed_weights_refuse_an_unknown_type():
    with pytest.raises(ValueError, match="unknown weight_type"):
        tfix.fixed_beamformer_weights(TGeometry.linear(4), (90.0, 0.0), tfix.FixedBeamformerConfig(weight_type="MVDR"))


@pytest.mark.parametrize("n_est", [0, 7, 40])
def test_offline_mvdr_weights(n_est):
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((2, 30, 65, 4)) + 1j * rng.standard_normal((2, 30, 65, 4))) * 0.3
    steer = steering_vector(TGeometry.circular(4, 0.032), np.array([np.pi / 3, 0.0]), 128)
    got = tmvdr.offline_mvdr_weights(torch.as_tensor(X), steer, n_est_frames=n_est)
    _close(got, jmvdr.offline_mvdr_weights(jnp.asarray(X), jnp.asarray(steer), n_est_frames=n_est), RECURSION)


def _lead_in_scene(M, S, lead, seed):
    """White noise on every mic, plus a broadside burst after ``lead`` samples."""
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((M, S))
    x[:, lead:] += rng.standard_normal(S - lead)[None, :]
    return x


@pytest.mark.parametrize("n_est", [0, 12, 200])
@pytest.mark.parametrize("geom", ["linear4", "circular4"])
def test_adaptive_mvdr2_process(geom, n_est):
    tg, _ = _geoms(geom)
    x = _lead_in_scene(tg.n_mics, 128 * 40, 128 * 14, seed=2)
    steer = steering_vector(tg, np.array([np.pi / 2, 0.0]), 256)
    got = tmvdr.adaptive_mvdr2_process(x, steer, n_est_frames=n_est, device="cpu")
    assert got.dtype == torch.float64
    _close(got, jmvdr.adaptive_mvdr2_process(jnp.asarray(x), jnp.asarray(steer), n_est_frames=n_est), RECURSION)


def test_adaptive_mvdr2_removes_a_coherent_interferer():
    """Noise-only lead-in with a coherent endfire interferer: after the
    estimation window the broadside target passes at unit gain (the MVDR
    constraint) and the interferer is cancelled."""
    M, S, lead = 4, 16000, 128 * 40
    g = TGeometry.linear(M, 0.032)
    rng = np.random.default_rng(3)
    tgt = np.zeros(S)
    tgt[lead:] = rng.standard_normal(S - lead)
    intf = rng.standard_normal(S + M)
    d = np.arange(M)  # endfire: mic m hears the interferer m samples late
    interferer = np.stack([intf[M - m : M - m + S] for m in d])
    steer = steering_vector(g, np.array([np.pi / 2, 0.0]), 256)
    run = lambda sig: tmvdr.adaptive_mvdr2_process(sig, steer, n_est_frames=40, device="cpu").numpy()
    y_t, y_i = run(np.tile(tgt, (M, 1))), run(interferer)
    seg = slice(lead + 2048, S - 512)
    assert abs(10 * np.log10(np.mean(y_t[seg] ** 2) / np.mean(tgt[seg] ** 2))) < 0.5
    assert 10 * np.log10(np.mean(y_i[seg] ** 2) / np.mean(interferer[0, seg] ** 2)) < -10
