"""The plain version of kernel K9 (``ops/cuda_sgsc.py``, ``csrc/sgsc.cu``)
against the JAX package's Pallas kernel ``fused_subband_gsc`` in interpret
mode, float32, at the JAX kernel's own test size (B=8 x 4 mics x 16 frames)
and bars (out and bm < 1e-4 of max, p within 2e-3): the default config, the
AIC guards, and the guards with the McCDR's MCRA window cut to L=3 on both
sides, so that the CDR-driven q moves within 16 frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import subband_gsc as jsg
from distantspeech_tpu.ops.pallas_sgsc import fused_subband_gsc as j_fused
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import subband_gsc as tsg
from distantspeech_tpu_torch.ops import cuda_sgsc as cs
from test_torch_subband_gsc import J_SHORT, T_SHORT

ANG = (np.pi / 2, 0.0)
B, M, L, T = 8, 4, 256, 16

CASES = {
    "default": (jsg.SubbandGscConfig(n_mics=M), tsg.SubbandGscConfig(n_mics=M)),
    "guards": (jsg.SubbandGscConfig(n_mics=M, aic_warmup_frames=4, aic_freeze_thresh=0.5),
               tsg.SubbandGscConfig(n_mics=M, aic_warmup_frames=4, aic_freeze_thresh=0.5)),
    "short_mcra_guards": (J_SHORT[0](n_mics=M, aic_warmup_frames=4, aic_freeze_thresh=0.5),
                          T_SHORT[0](n_mics=M, aic_warmup_frames=4, aic_freeze_thresh=0.5)),
}


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case):
    cj, ct = CASES[case]
    x = np.random.default_rng(0).standard_normal((B, M, T * L)).astype(np.float32)
    want = j_fused(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, cj, interpret=True)
    got = cs.fused_subband_gsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, ct)
    (o1, p1, bm1), (o2, p2, bm2) = (np.asarray(w) for w in want), (g.numpy() for g in got)
    assert o2.dtype == np.float32 and p2.shape == (B, T, L + 1) and bm2.shape == (B, M, T * L)
    assert _rel(o2, o1) < 1e-4
    np.testing.assert_allclose(p2, p1, atol=2e-3)
    assert _rel(bm2, bm1) < 1e-4
    # p moves: strictly inside (0, 1) on some lane-frames, and the xi < 0
    # repair fires
    assert bool(((p2 > 1e-3) & (p2 < 1 - 1e-3)).any())
    sig, sf = cs.front_end(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, ct)
    assert bool((cs.subband_gsc_frames_plain(sig, sf, ct, decisions=True)[3] & cs.REPAIR).any())
