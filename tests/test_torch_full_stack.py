"""The port's full streaming stack (AEC -> KWS tap -> TDGSC with the
OM-LSA-multi postfilter) on the CPU: ``full_stack_process(backend="scan")``
against the JAX package in float64; the ``fused`` chain's plain versions
(of kernels K7, K6 and K5) against JAX's ``fused`` chain of Pallas kernels
in interpret mode in float32; and a mid-run handover of the JAX state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.runtime import full_stack as jfs
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.ops import cuda_aec as ca, cuda_flms as cf
from distantspeech_tpu_torch.runtime import full_stack as tfs

ANG = (np.pi / 2, 0.0)
M, T = 4, 20


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-300))


def _scene(B, S, seed, dtype=np.float32):
    """A far end echoed on every mic through one decaying path, a
    broadside target burst and independent noise per mic."""
    rng = np.random.default_rng(seed)
    far = rng.standard_normal((B, S + 127)) * 0.5
    ir = rng.standard_normal(128) * np.exp(-np.arange(128) / 20.0)
    echo = np.stack([np.convolve(far[b], ir, mode="valid") for b in range(B)])
    env = (np.sin(2 * np.pi * 5.0 * np.arange(S) / 16000) > 0).astype(np.float64)
    tgt = rng.standard_normal((B, S)) * env * 0.5
    x = (echo + tgt)[:, None, :] + 0.05 * rng.standard_normal((B, M, S))
    return far[:, 127:].astype(dtype), x.astype(dtype)


def test_scan_matches_jax_float64():
    far, x = _scene(2, 12 * 256, 1, np.float64)
    want = jfs.full_stack_process(jnp.asarray(x), jnp.asarray(far), JGeometry.linear(M, 0.032), ANG,
                                  jfs.FullStackConfig(n_mics=M))
    got = tfs.full_stack_process(x, far, TGeometry.linear(M, 0.032), ANG, tfs.FullStackConfig(n_mics=M), device="cpu")
    assert got[0].shape == (2, 12 * 256) and got[2].shape == (2, 12, 257)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and _rel(g, w) <= 1e-9


def test_fused_plain_chain_matches_jax_fused():
    """B=8 x 4 x 20 frames, float32: JAX's chain of interpret-mode Pallas
    kernels (K7 -> K6 -> K5 with the postfilter) against the port's chain of
    plain versions, which is what ``backend="fused"`` runs on CPU tensors."""
    far, x = _scene(8, T * 256, 2)
    want = jfs.full_stack_process(jnp.asarray(x), jnp.asarray(far), JGeometry.linear(M, 0.032), ANG,
                                  jfs.FullStackConfig(n_mics=M), backend="fused")
    for k in ca.LAUNCHES:
        ca.LAUNCHES[k] = 0
    for k in cf.LAUNCHES:
        cf.LAUNCHES[k] = 0
    got = tfs.full_stack_process(x, far, TGeometry.linear(M, 0.032), ANG, tfs.FullStackConfig(n_mics=M),
                                 backend="fused", device="cpu")
    assert sum(ca.LAUNCHES.values()) + sum(cf.LAUNCHES.values()) == 0
    (o1, k1, p1), (o2, k2, p2) = (np.asarray(a) for a in want), (a.numpy() for a in got)
    assert o2.dtype == np.float32 and o2.shape == (8, T * 256) and p2.shape == (8, T, 257)
    assert _rel(o2, o1) < 1e-4
    assert _rel(k2, k1) < 1e-4
    np.testing.assert_allclose(p2, p1, atol=1e-6)


def test_validation():
    far, x = _scene(1, 4 * 256, 3)
    cfg = tfs.FullStackConfig(n_mics=M, aec=tfs.AecConfig(filter_len=512, num_block=1))
    with pytest.raises(ValueError, match="block_len"):
        tfs.full_stack_process(x, far, TGeometry.linear(M, 0.032), ANG, cfg, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tfs.full_stack_process(x, far, TGeometry.linear(M, 0.032), ANG, tfs.FullStackConfig(n_mics=M),
                               backend="pallas", device="cpu")


def _as_dict(state):
    if hasattr(state, "_asdict"):
        return {k: _as_dict(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def test_handover_mid_run():
    """JAX runs 2 frames in float64; its config and state carry into the
    port, whose next ``full_stack_step`` gives JAX's next outputs."""
    cj = jfs.FullStackConfig(n_mics=M)
    ct = convert.full_stack_config_from_dict(dataclasses.asdict(cj))
    assert ct == tfs.FullStackConfig(n_mics=M)
    far, x = _scene(2, 3 * 256, 4, np.float64)
    coeffs = np.asarray(jfs.time_alignment_filters(JGeometry.linear(M, 0.032), ANG))
    sj = jfs.full_stack_init(cj, coeffs, (2,), dtype=jnp.float64)
    step = jax.jit(jfs.full_stack_step, static_argnums=0)
    for t in range(2):
        blk = slice(t * 256, (t + 1) * 256)
        sj, _ = step(cj, jnp.asarray(coeffs), sj, jnp.asarray(x[..., blk]), jnp.asarray(far[..., blk]))
    blk = slice(2 * 256, 3 * 256)
    _, want = step(cj, jnp.asarray(coeffs), sj, jnp.asarray(x[..., blk]), jnp.asarray(far[..., blk]))
    st = convert.full_stack_state_from_numpy(_as_dict(sj), device="cpu")
    assert st.aec.cnt == 2 and st.gsc.mcra.frm_cnt == 2 and st.fir_cache.shape == (2, M, coeffs.shape[-1] - 1)
    _, got = tfs.full_stack_step(ct, torch.as_tensor(coeffs), st, torch.as_tensor(x[..., blk]),
                                 torch.as_tensor(far[..., blk]))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9
