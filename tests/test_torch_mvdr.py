"""Port parity: MCRA, the small-matrix solves and the adaptive MVDR of
``distantspeech_tpu_torch`` against ``distantspeech_tpu``, float64 on the
CPU, to 1e-9 of the signal scale."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import mvdr as jmvdr
from distantspeech_tpu.noise import mcra as jmcra
from distantspeech_tpu.stats import linalg as jla, psd as jpsd
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import mvdr as tmvdr
from distantspeech_tpu_torch.noise import mcra as tmcra
from distantspeech_tpu_torch.stats import linalg as tla, psd as tpsd

TOL = 1e-9


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.max(np.abs(want)))


def _scene(B, M, S, seed):
    rng = np.random.default_rng(seed)
    env = np.sin(2 * np.pi * 1.3 * np.arange(S) / 16000) > 0
    return 0.3 * rng.standard_normal((B, M, S)) + (env * rng.standard_normal(S))[None, None]


def test_mcra_run_with_resets():
    """T = 80 frames at L = 15: past the 2L forcing, through five minima-window
    resets, with the raw indicator S/Smin and the final counters."""
    cfg_j, cfg_t = jmcra.McraConfig(L=15), tmcra.McraConfig(L=15)
    rng = np.random.default_rng(0)
    gain = 1.0 + 4.0 * (np.sin(np.arange(80) / 6.0)[:, None, None] > 0.5)  # bursts of "speech"
    Y = rng.exponential(size=(80, 3, cfg_t.half_bin)) * gain
    want = jmcra.mcra_run(cfg_j, jnp.asarray(Y), return_sr=True)
    got = tmcra.mcra_run(cfg_t, torch.as_tensor(Y), return_sr=True)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    js, ts = jmcra.mcra_init(cfg_j, (3,), jnp.float64), tmcra.mcra_init(cfg_t, (3,), torch.float64, device="cpu")
    for y in Y:
        js, _ = jmcra.mcra_step(cfg_j, js, jnp.asarray(y))
        ts, _ = tmcra.mcra_step(cfg_t, ts, torch.as_tensor(y))
    assert (ts.ell, ts.frm_cnt) == (int(js.ell), int(js.frm_cnt))
    for name in ("S", "Smin", "Stmp", "p", "lambda_d"):
        _close(getattr(ts, name).numpy(), getattr(js, name))


@pytest.mark.parametrize("M", [2, 4, 8])
def test_small_matrix_solves(M):
    rng = np.random.default_rng(M)
    Z = rng.standard_normal((3, 5, 2 * M, M)) + 1j * rng.standard_normal((3, 5, 2 * M, M))
    A = np.einsum("...tm,...tn->...mn", Z, Z.conj()) / (2 * M) + 1e-3 * np.eye(M)
    b = rng.standard_normal((3, 5, M)) + 1j * rng.standard_normal((3, 5, M))
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    _close(tla.ldl_solve(At, bt).numpy(), jla.ldl_solve(jnp.asarray(A), jnp.asarray(b)))
    _close(tla.gauss_jordan_inv(At).numpy(), jla.gauss_jordan_inv(jnp.asarray(A)))
    _close(tla.matvec(At, bt).numpy(), jla.matvec(jnp.asarray(A), jnp.asarray(b)))
    _close(tla.vecmat(bt, At).numpy(), jla.vecmat(jnp.asarray(b), jnp.asarray(A)))
    _close(tla.trace_mm(At, At).numpy(), jla.trace_mm(jnp.asarray(A), jnp.asarray(A)))
    _close(tpsd.rank1_update(At, bt, 0.9).numpy(), jpsd.rank1_update(jnp.asarray(A), jnp.asarray(b), 0.9))
    _close(tpsd.hermitize(At).numpy(), jpsd.hermitize(jnp.asarray(A)))


@pytest.mark.parametrize("kw", [dict(), dict(rel_diag=1e-5, vad_guard=True, mcra_L=20)])
def test_mvdr_process(kw):
    M = 4
    x = _scene(2, M, 128 * 70, seed=3)
    want = np.asarray(jmvdr.mvdr_process(jnp.asarray(x), JGeometry.linear(M, 0.032), (90.0, 0.0), jmvdr.MvdrConfig(**kw)))
    got = tmvdr.mvdr_process(x, TGeometry.linear(M, 0.032), (90.0, 0.0), tmvdr.MvdrConfig(**kw), device="cpu")
    _close(got.numpy(), want)
