"""Kernel K1 of the port on the CPU: ``fused_mvdr_scan_plain`` (the plain
version of the CUDA kernel in ``csrc/mvdr.cu``) against the JAX Pallas
kernel ``pallas_mvdr_scan`` in interpret mode, and the ``pallas`` backend
of ``enhance_process`` against the JAX package's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distantspeech_tpu.beamform import enhance as jenh
from distantspeech_tpu.beamform.mvdr import MvdrConfig as JMvdrConfig
from distantspeech_tpu.noise.mcra import mcra_run as j_mcra_run
from distantspeech_tpu.ops.pallas_mvdr import pallas_mvdr_scan
from distantspeech_tpu.transform import analysis as j_analysis, synthesis as j_synthesis
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.beamform import enhance as tenh
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig as TMvdrConfig
from distantspeech_tpu_torch.noise.mcra import mcra_run as t_mcra_run
from distantspeech_tpu_torch.ops import cuda_mvdr as cm
from distantspeech_tpu_torch.transform import analysis as t_analysis

M = 4


def _spectra(seed, T=23, B=3, F=5, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    Z = (rng.standard_normal((T, B, F, M)) + 1j * rng.standard_normal((T, B, F, M))).astype(dtype)
    gate = (rng.uniform(size=(T, B, F)) > 0.3).astype(np.float32)
    gate[0] = 1.0  # every lane opens on frame 0, so no output is 0/0
    steer = np.exp(1j * rng.uniform(0, 2 * np.pi, (F, M))).astype(dtype)
    p = rng.uniform(size=(T, B, F)).astype(np.float32)
    lam = rng.uniform(0.2, 3.0, size=(T, B, F)).astype(np.float32)
    return Z, gate, steer, p, lam


@pytest.mark.parametrize("gain", [False, True], ids=["mvdr", "mvdr_omlsa"])
def test_plain_matches_pallas_interpret(gain):
    """Both kernel variants, float32, at JAX's own tolerance for its kernel."""
    Z, gate, steer, p, lam = _spectra(1)
    kw = dict(rel_diag=1e-3)
    jkw = dict(p=jnp.asarray(p), lam=jnp.asarray(lam)) if gain else {}
    tkw = dict(p=torch.as_tensor(p), lam=torch.as_tensor(lam)) if gain else {}
    want = np.asarray(pallas_mvdr_scan(jnp.asarray(Z), jnp.asarray(gate), jnp.asarray(steer), f_tile=8,
                                       t_chunk=8, interpret=True, **kw, **jkw))
    got = cm.fused_mvdr_scan_plain(torch.as_tensor(Z), torch.as_tensor(gate), torch.as_tensor(steer), **kw, **tkw)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    Z, gate, steer, p, lam = _spectra(2)
    args = (torch.as_tensor(Z), torch.as_tensor(gate), torch.as_tensor(steer))
    cm.LAUNCHES["fused_mvdr_scan"] = 0
    kw = dict(p=torch.as_tensor(p), lam=torch.as_tensor(lam))
    assert torch.equal(cm.fused_mvdr_scan(*args, **kw), cm.fused_mvdr_scan_plain(*args, **kw))
    assert cm.LAUNCHES["fused_mvdr_scan"] == 0


def test_api_validation():
    Z = torch.zeros((4, 2, 5, 3), dtype=torch.complex64)
    g = torch.ones((4, 2, 5))
    a = torch.ones((5, 3), dtype=torch.complex64)
    with pytest.raises(ValueError, match="BOTH p and lam"):
        cm.fused_mvdr_scan(Z, g, a, p=g)
    with pytest.raises(ValueError, match="BOTH p and lam"):
        cm.fused_mvdr_scan_plain(Z, g, a, lam=g)
    with pytest.raises(ValueError, match="4-D"):
        cm.fused_mvdr_scan(Z[:, 0], g[:, 0], a)
    with pytest.raises(ValueError, match="T, B, F, M"):
        tenh.enhance_scan_pallas(tenh.EnhanceConfig(), a, Z[:, 0])
    with pytest.raises(ValueError, match=r"\[B, M, S\]"):
        tenh.enhance_process(np.zeros((3, 1280), np.float32), TGeometry.linear(3, 0.032), backend="pallas", device="cpu")


def test_enhance_scan_pallas_float64_matches_jax_scan():
    """The MCRA pre-scan plus the plain K1 is ``enhance_scan`` to float64
    rounding (the benched config: vad_guard and rel_diag)."""
    rng = np.random.default_rng(4)
    T, B = 40, 2
    cfg_j, cfg_t = jenh.EnhanceConfig(), tenh.EnhanceConfig()
    F = cfg_t.stft.half_bin
    Z = rng.standard_normal((T, B, F, M)) + 1j * rng.standard_normal((T, B, F, M))
    steer = np.exp(1j * rng.uniform(0, 2 * np.pi, (F, M)))
    state = jenh.enhance_init(cfg_j, M, batch_shape=(B,), cdtype=jnp.complex128)
    _, want = jenh.enhance_scan(cfg_j, jnp.asarray(steer), state, jnp.asarray(Z))
    got = tenh.enhance_scan_pallas(cfg_t, torch.as_tensor(steer), torch.as_tensor(Z))
    want = np.asarray(want)
    assert got.dtype == torch.complex128
    assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) <= 1e-9


def _jax_pallas_backend(x, cfg):
    """JAX's ``enhance_process(backend='pallas')`` with the kernel in
    interpret mode (the backend itself compiles it for the TPU)."""
    steer = jnp.asarray(_steer(np.complex64))
    X = j_analysis(jnp.asarray(x), cfg.stft)
    Zt = jnp.moveaxis(jnp.moveaxis(X, -3, -1), -3, 0)
    Y = jenh.enhance_scan_pallas(cfg, steer, Zt, interpret=True)
    return np.asarray(j_synthesis(jnp.moveaxis(Y, 0, -2), cfg.stft))


def _steer(dtype):
    return steering_vector(TGeometry.linear(M, 0.032), np.array([np.pi / 2, 0.0]), 256).astype(dtype)


@pytest.mark.parametrize("vad_guard, tol", [(False, 1e-4), (True, 1e-3)], ids=["guard_off", "guarded"])
def test_enhance_process_pallas_matches_jax(vad_guard, tol):
    """The whole ``pallas`` backend, float32, against JAX's and against the
    float64 result.  Both sides' MCRA pre-scans give the same gate
    (asserted), so no decision flips; what remains is float32 rounding.
    The guarded gate updates the covariance rarely, and with the rel_diag
    loading of 1e-5 the solve amplifies float32 rounding to the order of
    1e-4 of max|y| on both sides, so the guarded config is held to 1e-3."""
    rng = np.random.default_rng(5)
    S = 128 * 48
    env = np.sin(2 * np.pi * 1.3 * np.arange(S) / 16000) > 0
    x = (0.3 * rng.standard_normal((2, M, S)) + (env * rng.standard_normal(S))[None, None]).astype(np.float32)
    kw = dict(mcra_L=15, vad_guard=vad_guard, rel_diag=1e-5)
    cfg_j, cfg_t = jenh.EnhanceConfig(mvdr=JMvdrConfig(**kw)), tenh.EnhanceConfig(mvdr=TMvdrConfig(**kw))
    want = _jax_pallas_backend(x, cfg_j)
    cm.LAUNCHES["fused_mvdr_scan"] = 0
    got = tenh.enhance_process(x, TGeometry.linear(M, 0.032), (90.0, 0.0), cfg_t, backend="pallas", device="cpu")
    exact = tenh.enhance_process(x.astype(np.float64), TGeometry.linear(M, 0.032), (90.0, 0.0), cfg_t,
                                 backend="pallas", device="cpu").numpy()
    assert cm.LAUNCHES["fused_mvdr_scan"] == 0
    assert got.dtype == torch.float32 and got.shape == want.shape
    gate_j = _gate(j_analysis(jnp.asarray(x), cfg_j.stft), cfg_j, lambda c, y, **k: j_mcra_run(c, jnp.asarray(y), **k))
    gate_t = _gate(t_analysis(torch.as_tensor(x), cfg_t.stft), cfg_t, lambda c, y, **k: t_mcra_run(c, torch.as_tensor(y), **k))
    assert np.array_equal(gate_j, gate_t)
    scale = np.max(np.abs(exact))
    assert np.max(np.abs(got.numpy() - want)) <= tol * scale
    assert np.max(np.abs(got.numpy() - exact)) <= tol * scale
    assert np.max(np.abs(want - exact)) <= tol * scale


def _gate(X, cfg, mcra_run):
    """The covariance gate of the MCRA pre-scan on analysis spectra X."""
    lam, p, sr = mcra_run(cfg.mvdr.mcra, np.abs(np.asarray(X)[:, 0]).transpose(1, 0, 2) ** 2, return_sr=True)
    gate = np.asarray(p) < cfg.mvdr.p_vad
    return gate & (np.asarray(sr) <= cfg.mvdr.mcra.delta_s) if cfg.mvdr.vad_guard else gate
