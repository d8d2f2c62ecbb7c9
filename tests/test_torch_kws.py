"""The port's dual-mic KWS cleaner on the CPU: ``kws_process`` against the
JAX package in float64, ``fused_kws_plain`` (the plain version of kernel
K6, ``csrc/kws.cu``) against the JAX Pallas kernel in interpret mode in
float32, and a mid-run handover of the JAX state.  A 0.1 s defer gives a
7-slot FIFO, so it wraps within the 20 frames."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.kws import dual_mic as jk
from distantspeech_tpu.ops.pallas_flms import fused_kws as j_fused
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.kws import dual_mic as tk
from distantspeech_tpu_torch.ops import cuda_flms as cf
from distantspeech_tpu_torch.runtime.profiling import counters, reset_counters

DEFER = dict(defer_seconds=0.1)
T = 20


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-300))


def _scene(B, S, seed, dtype=np.float32):
    """An interferer reaching mic 1 through a short path from mic 0, plus a
    near-field keyword burst on mic 1 only and a little noise."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, S + 31))
    h = rng.standard_normal(32) * np.exp(-np.arange(32) / 6.0)
    x1 = np.stack([np.convolve(x0[b], h, mode="valid") for b in range(B)])
    x1[:, S // 2 :] += rng.standard_normal((B, S - S // 2)) * 0.5
    x = np.stack([x0[:, 31:], x1], axis=1) + 0.01 * rng.standard_normal((B, 2, S))
    return x.astype(dtype)


def test_the_fifo_wraps():
    cfg = tk.DualMicKwsConfig(**DEFER)
    assert cfg.delay_frames_n == jk.DualMicKwsConfig(**DEFER).delay_frames_n == 7 < T


def test_kws_process_matches_jax_float64():
    x = _scene(2, T * 256, 1, np.float64)
    want = jk.kws_process(jnp.asarray(x), jk.DualMicKwsConfig(**DEFER))
    got = tk.kws_process(x, tk.DualMicKwsConfig(**DEFER), device="cpu")
    assert got.dtype == torch.float64 and _rel(got, want) <= 1e-9
    # the cleaner passes mic 1 (delayed by L/2) until the FIFO has wrapped
    d = torch.nn.functional.pad(torch.as_tensor(x[:, 1]), (128, 0))[:, : T * 256]
    assert torch.equal(got[:, : 7 * 256], d[:, : 7 * 256])
    assert _rel(got[:, 7 * 256 :], d[:, 7 * 256 :]) > 1e-3


def test_fused_plain_matches_pallas_interpret():
    """float32, B=8 x 20 frames: the tolerance the JAX kernel is held to."""
    x = _scene(8, T * 256, 2)
    want = np.asarray(j_fused(jnp.asarray(x), jk.DualMicKwsConfig(**DEFER), interpret=True))
    got = cf.fused_kws_plain(torch.as_tensor(x), tk.DualMicKwsConfig(**DEFER))
    assert got.dtype == torch.float32 and _rel(got, want) < 1e-5
    # float64: the plain version is the kws_step loop
    x64 = torch.as_tensor(x[:2].astype(np.float64))
    assert _rel(cf.fused_kws_plain(x64, tk.DualMicKwsConfig(**DEFER)),
                tk.kws_process(x64, tk.DualMicKwsConfig(**DEFER), device="cpu")) <= 1e-9


def test_fused_routing_and_strided_input():
    """A CPU tensor runs the plain version, also from a strided view (mics
    0/1 of a wider array), and launches nothing."""
    x = torch.as_tensor(_scene(3, 6 * 256 + 50, 3))
    wide = torch.cat([x, x[:, :1]], dim=1)[:, :2]
    reset_counters()
    got = cf.fused_kws(wide, tk.DualMicKwsConfig(**DEFER))
    assert "launch.fused_kws" not in counters() and got.shape == (3, 6 * 256)
    assert torch.equal(got, cf.fused_kws_plain(x, tk.DualMicKwsConfig(**DEFER)))
    with pytest.raises(ValueError, match="B, 2, S"):
        cf.fused_kws(x[:, :1])


def _as_dict(state):
    if hasattr(state, "_asdict"):
        return {k: _as_dict(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def test_handover_mid_run():
    """JAX runs 9 frames (past a FIFO wrap) in float64; its config and state
    carry into the port, whose next ``kws_step`` gives JAX's next output."""
    cj = jk.DualMicKwsConfig(**DEFER)
    ct = convert.kws_config_from_dict(dataclasses.asdict(cj))
    assert ct == tk.DualMicKwsConfig(**DEFER)
    x = _scene(2, 10 * 256, 4, np.float64)
    sj = jk.kws_init(cj, (2,), dtype=jnp.float64)
    for t in range(9):
        sj, _ = jk.kws_step(cj, sj, jnp.asarray(x[:, 0, t * 256 : (t + 1) * 256]), jnp.asarray(x[:, 1, t * 256 : (t + 1) * 256]))
    blk = slice(9 * 256, 10 * 256)
    _, want = jk.kws_step(cj, sj, jnp.asarray(x[:, 0, blk]), jnp.asarray(x[:, 1, blk]))
    st = convert.kws_state_from_numpy(_as_dict(sj), device="cpu")
    assert st.w_fifo.shape == (2, 7, 256) and st.anc.W.dtype == torch.complex128
    _, got = tk.kws_step(ct, st, torch.as_tensor(x[:, 0, blk]), torch.as_tensor(x[:, 1, blk]))
    assert _rel(got, want) <= 1e-9
