"""The shapes the kernels take beyond 8 mics, on the CPU: the plain versions
of K1 (``fused_mvdr_scan``), K5 (``fused_tdgsc``, core and postfilter), K8
(``fused_fdgsc``) and K10 (``fused_srp_spectrum``) at 12 mics against the
JAX Pallas kernels in interpret mode, in float32, at the tolerances their
3- and 6-mic twins hold (test_torch_mic_counts*.py); K2/K4's are in
test_torch_mic_counts_wide_enhance.py.
The kernels themselves are held to these plain versions on the card
(``chip_smoke.py``) and in the CPU rehearsal of their sources
(``test_torch_csrc_rehearsal.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import fdgsc as jf
from distantspeech_tpu.beamform import tdgsc as jt
from distantspeech_tpu.ops.pallas_flms import fused_fdgsc as j_fdgsc, fused_tdgsc as j_tdgsc
from distantspeech_tpu.ops.pallas_mvdr import pallas_mvdr_scan
from distantspeech_tpu.ops.pallas_srp import fused_srp_spectrum as j_srp
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import fdgsc as tf
from distantspeech_tpu_torch.beamform import tdgsc as tt
from distantspeech_tpu_torch.doa import srp as tsrp
from distantspeech_tpu_torch.ops import cuda_flms as cf, cuda_mvdr as cm, cuda_srp as cr
from distantspeech_tpu_torch.transform import analysis

ANG = (np.pi / 2, 0.0)
M = 12


def _rel(got, want):
    """max |got - want| / max |want| (complex or real)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


@pytest.mark.parametrize("gain", [False, True], ids=["mvdr", "mvdr_omlsa"])
def test_k1_plain_matches_pallas_interpret_at_12_mics(gain):
    """test_torch_mic_counts.py's case at 12 mics, held to K1's gate, 1e-4 of
    max|Y|: the float32 rounding of a 12 x 12 LDL^H solve puts both float32
    versions ~5e-5 of max|Y| from the float64 plain version (JAX's no nearer
    than the port's, within 1.5x plus 1e-5), more than the element-wise
    tolerance that holds at 3 and 6 mics allows on the smallest outputs."""
    rng = np.random.default_rng(M)
    T, B, F = 23, 3, 5
    Z = (rng.standard_normal((T, B, F, M)) + 1j * rng.standard_normal((T, B, F, M))).astype(np.complex64)
    gate = (rng.uniform(size=(T, B, F)) > 0.3).astype(np.float32)
    gate[0] = 1.0  # every lane opens on frame 0, so no output is 0/0
    steer = np.exp(1j * rng.uniform(0, 2 * np.pi, (F, M))).astype(np.complex64)
    p = rng.uniform(size=(T, B, F)).astype(np.float32)
    lam = rng.uniform(0.2, 3.0, size=(T, B, F)).astype(np.float32)
    jkw = dict(p=jnp.asarray(p), lam=jnp.asarray(lam)) if gain else {}
    tkw = dict(p=torch.as_tensor(p), lam=torch.as_tensor(lam)) if gain else {}
    want = np.asarray(pallas_mvdr_scan(jnp.asarray(Z), jnp.asarray(gate), jnp.asarray(steer), rel_diag=1e-3, f_tile=8,
                                       t_chunk=8, interpret=True, **jkw))
    got = cm.fused_mvdr_scan_plain(torch.as_tensor(Z), torch.as_tensor(gate), torch.as_tensor(steer), rel_diag=1e-3,
                                   **tkw)
    kw64 = {k: v.double() for k, v in tkw.items()}
    ref = cm.fused_mvdr_scan_plain(torch.as_tensor(Z.astype(np.complex128)), torch.as_tensor(gate).double(),
                                   torch.as_tensor(steer.astype(np.complex128)), rel_diag=1e-3, **kw64)
    assert _rel(got.numpy(), want) <= 1e-4
    assert _rel(got.numpy(), ref.numpy()) <= 1.5 * _rel(want, ref.numpy()) + 1e-5


@pytest.mark.parametrize("postfilter", [False, True], ids=["core", "postfilter"])
def test_k5_plain_matches_pallas_interpret_at_12_mics(postfilter):
    """test_torch_mic_counts_gsc.py's tolerances (out 1e-5, 1e-4 with the
    postfilter; p 1e-6; bm 1e-5) at 12 mics (C = 11)."""
    x = np.random.default_rng(M).standard_normal((8, M, 8 * 256)).astype(np.float32)
    want = j_tdgsc(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, jt.TdGscConfig(n_mics=M, postfilter=postfilter),
                   interpret=True)
    got = cf.fused_tdgsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG,
                               tt.TdGscConfig(n_mics=M, postfilter=postfilter))
    (o1, p1, bm1), (o2, p2, bm2) = (np.asarray(w) for w in want), (g.numpy() for g in got)
    assert _rel(o2, o1) < (1e-4 if postfilter else 1e-5)
    np.testing.assert_allclose(p2, p1, atol=1e-6)
    assert _rel(bm2, bm1) < 1e-5


def test_k8_plain_matches_pallas_interpret_at_12_mics():
    """test_torch_mic_counts_interpret.py's tolerances at 12 mics."""
    x = np.random.default_rng(M).standard_normal((8, M, 10 * 256)).astype(np.float32)
    want = j_fdgsc(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, jf.FdGscConfig(n_mics=M), interpret=True)
    got = cf.fused_fdgsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, tf.FdGscConfig(n_mics=M))
    (o1, p1, bm1), (o2, p2, bm2) = (np.asarray(w) for w in want), (g.numpy() for g in got)
    assert _rel(o2, o1) < 1e-5
    np.testing.assert_allclose(p2, p1, atol=1e-6)
    assert _rel(bm2, bm1) < 1e-5


def test_k10_plain_matches_pallas_interpret_at_12_mics():
    """test_torch_srp.py's batched case at 12 mics (1e-5, the same picks)."""
    cfg = tsrp.SrpConfig()
    grid = tsrp.srp_steering_grid(cfg, TGeometry.linear(M, 0.032))
    x = torch.as_tensor(np.random.default_rng(M).standard_normal((2, M, 8000)).astype(np.float32))
    Y = torch.movedim(torch.movedim(analysis(x, cfg.stft), -3, -1), -3, 0).numpy()  # [T, B, F, M]
    want = np.asarray(j_srp(jnp.asarray(Y), grid, phat=True, interpret=True))
    got = cr.fused_srp_spectrum(torch.as_tensor(Y), grid, phat=True).numpy()
    assert got.shape == want.shape == Y.shape[:-2] + (360,)
    assert _rel(got, want) < 1e-5
    assert (got.argmax(-1) == want.argmax(-1)).all()
