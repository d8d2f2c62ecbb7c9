"""The port's time-domain GSC on the CPU: ``tdgsc_process(backend="scan")``
against the JAX scan in float64, ``fused_tdgsc_plain`` (the plain version
of kernel K5, ``csrc/flms.cu``) against the JAX Pallas kernel in interpret
mode in float32 at the JAX kernel's own tolerances, the ``fused`` backend's
routing of CPU tensors, and a mid-run handover of the JAX state."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import tdgsc as jt
from distantspeech_tpu.ops.pallas_flms import fused_tdgsc as j_fused
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import tdgsc as tt
from distantspeech_tpu_torch.ops import cuda_flms as cf

ANG = (np.pi / 2, 0.0)
B, M, S = 8, 4, 4096


def _noise(seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, M, S)).astype(dtype)


def _burst(seed=3):
    """A speech-like modulated burst that drives MCRA's raw indicator across
    its threshold, so ``vad_guard`` binds."""
    rng = np.random.default_rng(seed)
    env = (np.sin(2 * np.pi * 5.0 * np.arange(S) / 16000) > 0).astype(np.float32)
    return rng.standard_normal((B, M, S)).astype(np.float32) * (0.2 + env)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


@pytest.mark.parametrize("postfilter", [False, True], ids=["core", "postfilter"])
def test_scan_matches_jax_float64(postfilter):
    x = _noise(1, np.float64)
    want = jt.tdgsc_process(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, jt.TdGscConfig(n_mics=M, postfilter=postfilter))
    got = tt.tdgsc_process(x, TGeometry.linear(M, 0.032), ANG, tt.TdGscConfig(n_mics=M, postfilter=postfilter), device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _rel(g, w) <= 1e-9


@pytest.fixture(scope="module")
def fused_cases():
    """(name, x, kwargs) -> (JAX interpret result, the port's plain result)."""
    cases = {"default": (_noise(0), {}), "vad_guard": (_burst(), dict(vad_guard=True)),
             "postfilter": (_noise(4), dict(postfilter=True))}
    out = {}
    for name, (x, kw) in cases.items():
        want = j_fused(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, jt.TdGscConfig(n_mics=M, **kw), interpret=True)
        got = cf.fused_tdgsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, tt.TdGscConfig(n_mics=M, **kw))
        out[name] = (tuple(np.asarray(w) for w in want), tuple(g.numpy() for g in got))
    return out


@pytest.mark.parametrize("name, out_tol", [("default", 1e-5), ("vad_guard", 1e-5), ("postfilter", 1e-4)])
def test_fused_plain_matches_pallas_interpret(fused_cases, name, out_tol):
    """float32, the tolerances the JAX kernel is held to against its scan."""
    (o1, p1, bm1), (o2, p2, bm2) = fused_cases[name]
    assert o2.dtype == np.float32
    assert _rel(o2, o1) < out_tol
    np.testing.assert_allclose(p2, p1, atol=1e-6)
    assert _rel(bm2, bm1) < 1e-5


def test_vad_guard_binds(fused_cases):
    """On the burst scene the guarded canceller differs from the unguarded."""
    (o_guard, _, _), _ = fused_cases["vad_guard"]
    o_free = cf.fused_tdgsc_plain(torch.as_tensor(_burst()), TGeometry.linear(M, 0.032), ANG, tt.TdGscConfig(n_mics=M))[0]
    assert _rel(o_free.numpy(), o_guard) > 1e-4


def test_fused_backend_runs_the_plain_version_on_cpu():
    x = torch.as_tensor(_noise(5)[:3, :, : 256 * 6 + 100])  # any B; a sub-frame tail is dropped
    cfg = tt.TdGscConfig(n_mics=M, postfilter=True)
    cf.LAUNCHES["fused_tdgsc"] = 0
    got = tt.tdgsc_process(x, TGeometry.linear(M, 0.032), ANG, cfg, backend="fused", device="cpu")
    want = cf.fused_tdgsc_plain(x, TGeometry.linear(M, 0.032), ANG, cfg)
    assert cf.LAUNCHES["fused_tdgsc"] == 0
    assert got[0].shape == (3, 256 * 6) and got[1].shape == (3, 6, 257) and got[2].shape == (3, M - 1, 256 * 6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="M=4"):
        cf.fused_tdgsc(x[:, :3], TGeometry.linear(3, 0.032), ANG, cfg)
    with pytest.raises(ValueError, match="backend"):
        tt.tdgsc_process(x, TGeometry.linear(M, 0.032), ANG, cfg, backend="pallas", device="cpu")


def _as_dict(state):
    """A JAX state NamedTuple as nested dicts of numpy arrays."""
    if hasattr(state, "_asdict"):
        return {k: _as_dict(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def test_handover_mid_run():
    """JAX runs 5 frames with the postfilter; its config and state carry into
    the port, whose next ``tdgsc_step`` gives JAX's next output."""
    cfg_j = jt.TdGscConfig(n_mics=M, postfilter=True)
    cfg_t = convert.tdgsc_config_from_dict(dataclasses.asdict(cfg_j))
    assert cfg_t == tt.TdGscConfig(n_mics=M, postfilter=True)
    rng = np.random.default_rng(6)
    L = cfg_j.frame_len
    fbf, bm = rng.standard_normal((6, 2, L)), rng.standard_normal((6, 2, M - 1, L))
    state = jt.tdgsc_init(cfg_j, batch_shape=(2,), dtype=jnp.float64)
    for t in range(5):
        state, _ = jt.tdgsc_step(cfg_j, state, jnp.asarray(fbf[t]), jnp.asarray(bm[t]))
    _, (want_out, want_p) = jt.tdgsc_step(cfg_j, state, jnp.asarray(fbf[5]), jnp.asarray(bm[5]))

    st = convert.tdgsc_state_from_numpy(_as_dict(state), device="cpu")
    assert st.mcra.frm_cnt == 5 and st.omlsa.frm_cnt == 5 and st.aic.W.dtype == torch.complex128
    _, (out, p) = tt.tdgsc_step(cfg_t, st, torch.as_tensor(fbf[5]), torch.as_tensor(bm[5]))
    assert _rel(out, want_out) <= 1e-9
    assert _rel(p, want_p) <= 1e-9
