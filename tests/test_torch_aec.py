"""The port's echo canceller on the CPU: ``mdf_step`` and ``aec_step``
against the JAX package in float64, ``fused_aec_plain`` (the plain version
of kernel K7, ``csrc/aec.cu``) against the JAX Pallas kernel in interpret
mode in float32 and against the port's own ``aec_step`` loop in float64,
and a mid-run handover of the JAX state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.adaptive import aec as ja, mdf as jm
from distantspeech_tpu.ops.pallas_aec import fused_aec as j_fused
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.adaptive import aec as ta, mdf as tm
from distantspeech_tpu_torch.ops import cuda_aec as ca
from distantspeech_tpu_torch.runtime.profiling import counters, reset_counters

CFG = dict(filter_len=512, num_block=2)  # the full stack's AEC: 2 blocks of 256


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-300))


def _scene(B, M, S, seed, dtype=np.float32):
    """Far-end white noise, its echo through a decaying 64-tap path on every
    mic (a different path per mic), near-end noise and a burst of near-end
    talk in the second half (so the transfer logic sees double talk)."""
    rng = np.random.default_rng(seed)
    far = rng.standard_normal((B, S + 63))
    ir = rng.standard_normal((M, 64)) * np.exp(-np.arange(64) / 10.0)
    echo = np.stack([[np.convolve(far[b], ir[m], mode="valid") for m in range(M)] for b in range(B)])
    near = rng.standard_normal((B, M, S)) * 0.05
    near[..., S // 2 :] += rng.standard_normal((B, 1, S - S // 2)) * 0.5
    return far[:, 63:].astype(dtype), (echo + near).astype(dtype)


@pytest.mark.parametrize("num_block, prop", [(1, False), (1, True), (2, False), (2, True)])
def test_mdf_step_matches_jax_float64(num_block, prop):
    kw = dict(filter_len=128, num_block=num_block, prop=prop)
    cj, ct = jm.MdfConfig(**kw), tm.MdfConfig(**kw)
    far, x = _scene(2, 1, 12 * cj.block_len, 1, np.float64)
    sj = jm.mdf_init(cj, (2,), dtype=jnp.float64)
    st = tm.mdf_init(ct, (2,), dtype=torch.float64, device="cpu")
    trunc = dict(fir_truncate=5) if num_block == 1 else {}
    L = cj.block_len
    for t in range(12):
        blk = slice(t * L, (t + 1) * L)
        sj, (ej, wj) = jm.mdf_step(cj, sj, jnp.asarray(far[:, blk]), jnp.asarray(x[:, 0, blk]), **trunc)
        st, (et, wt) = tm.mdf_step(ct, st, torch.as_tensor(far[:, blk]), torch.as_tensor(x[:, 0, blk]), **trunc)
        assert _rel(et, ej) <= 1e-9 and _rel(wt, wj) <= 1e-9
    assert _rel(torch.view_as_real(st.W), np.stack([np.real(sj.W), np.imag(sj.W)], -1)) <= 1e-9
    if num_block == 2:
        with pytest.raises(ValueError, match="num_block == 1"):
            tm.mdf_step(ct, st, torch.as_tensor(far[:, :L]), torch.as_tensor(x[:, 0, :L]), fir_truncate=5)


def _run_jax_aec(cfg, far, x, T, dtype=jnp.float64):
    """aec_step over T frames on every mic (the far end broadcast)."""
    L = cfg.block_len
    state = ja.aec_init(cfg, x.shape[:-1], dtype=dtype)
    step = jax.jit(ja.aec_step, static_argnums=0)
    outs = []
    for t in range(T):
        blk = slice(t * L, (t + 1) * L)
        state, (o, _) = step(cfg, state, jnp.broadcast_to(jnp.asarray(far[:, None, blk]), x[..., blk].shape),
                                    jnp.asarray(x[..., blk]))
        outs.append(np.asarray(o))
    return state, np.concatenate(outs, axis=-1)


def test_aec_step_matches_jax_float64():
    cj, ct = ja.AecConfig(**CFG), ta.AecConfig(**CFG)
    T, L = 20, cj.block_len
    far, x = _scene(2, 2, T * L, 2, np.float64)
    sj, want = _run_jax_aec(cj, far, x, T)
    st = ta.aec_init(ct, (2, 2), dtype=torch.float64, device="cpu")
    outs = []
    for t in range(T):
        blk = slice(t * L, (t + 1) * L)
        st, (o, w) = ta.aec_step(ct, st, torch.as_tensor(far[:, None, blk]).expand(2, 2, L), torch.as_tensor(x[..., blk]))
        outs.append(o)
    assert _rel(torch.cat(outs, -1), want) <= 1e-9
    assert st.cnt == int(sj.cnt) == T
    for k in ("Ryy", "Rey", "Davg1", "Dvar2", "Py"):
        assert _rel(getattr(st, k), getattr(sj, k)) <= 1e-9
    assert _rel(torch.view_as_real(st.foreground), np.stack([np.real(sj.foreground), np.imag(sj.foreground)], -1)) <= 1e-9


@pytest.fixture(scope="module")
def fused_case():
    """B=8 x 4 mics x 20 frames, float32: the JAX kernel in interpret mode
    and the port's plain version."""
    far, x = _scene(8, 4, 20 * 256, 3)
    want = np.asarray(j_fused(jnp.asarray(far), jnp.asarray(x), ja.AecConfig(**CFG), interpret=True))
    got = ca.fused_aec_plain(torch.as_tensor(far), torch.as_tensor(x), ta.AecConfig(**CFG))
    return far, x, want, got


def test_fused_plain_matches_pallas_interpret(fused_case):
    """float32, the tolerance the JAX kernel is held to against its scan."""
    _, _, want, got = fused_case
    assert got.dtype == torch.float32 and got.shape == (8, 4, 20 * 256)
    assert _rel(got, want) < 1e-5


def test_fused_plain_matches_the_step_loop_float64(fused_case):
    """In float64 the kernel's plain version is the ``aec_step`` loop: the
    packed DFT matrices and the blocked de-emphasis change only rounding.
    The scene has double talk, so the transfer logic fires."""
    far, x, _, _ = fused_case
    far, x = far[:2].astype(np.float64), x[:2].astype(np.float64)
    cfg = ta.AecConfig(**CFG)
    got, upd = ca.aec_frames_plain(*ca._prepare(torch.as_tensor(far), torch.as_tensor(x), cfg), cfg, decisions=True)
    st = ta.aec_init(cfg, (2, 4), dtype=torch.float64, device="cpu")
    outs = []
    for t in range(20):
        blk = slice(t * 256, (t + 1) * 256)
        st, (o, _) = ta.aec_step(cfg, st, torch.as_tensor(far[:, None, blk]).expand(2, 4, 256), torch.as_tensor(x[..., blk]))
        outs.append(o)
    assert _rel(got, torch.cat(outs, -1)) <= 1e-9
    assert 0 < int(upd.sum()) < upd.numel()


def test_fused_routing_and_validation():
    far, x = (torch.as_tensor(a) for a in _scene(3, 2, 256 * 6 + 100, 4))  # any B; a sub-block tail is dropped
    reset_counters()
    got = ca.fused_aec(far, x, ta.AecConfig(**CFG))
    assert "launch.fused_aec" not in counters() and got.shape == (3, 2, 256 * 6)
    assert torch.equal(got, ca.fused_aec_plain(far, x, ta.AecConfig(**CFG)))
    for bad, match in ((dict(num_block=4), "num_block"), (dict(non_causal=True), "causal"),
                       (dict(prop=False), "two_path\\+prop"), (dict(filter_len=384, num_block=1), "power of two")):
        with pytest.raises(ValueError, match=match):
            ca.fused_aec(far, x, ta.AecConfig(**{**CFG, **bad}))


def _as_dict(state):
    if hasattr(state, "_asdict"):
        return {k: _as_dict(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def test_handover_mid_run():
    """JAX runs 5 frames in float64; its config and state carry into the
    port, whose next ``aec_step`` gives JAX's next output."""
    cj = ja.AecConfig(**CFG)
    ct = convert.aec_config_from_dict(dataclasses.asdict(cj))
    assert ct == ta.AecConfig(**CFG)
    far, x = _scene(2, 3, 6 * 256, 5, np.float64)
    sj, _ = _run_jax_aec(cj, far, x, 5)
    blk = slice(5 * 256, 6 * 256)
    farb = np.broadcast_to(far[:, None, blk], x[..., blk].shape).copy()
    _, (want, want_w) = jax.jit(ja.aec_step, static_argnums=0)(cj, sj, jnp.asarray(farb), jnp.asarray(x[..., blk]))
    st = convert.aec_state_from_numpy(_as_dict(sj), device="cpu")
    assert st.cnt == 5 and isinstance(st.cnt, int) and st.W.dtype == torch.complex128
    _, (out, w) = ta.aec_step(ct, st, torch.as_tensor(farb), torch.as_tensor(x[..., blk]))
    assert _rel(out, want) <= 1e-9 and _rel(w, want_w) <= 1e-9
