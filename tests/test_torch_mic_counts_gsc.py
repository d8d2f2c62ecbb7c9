"""The mic counts K5 (``fused_tdgsc``) takes between 2 and 8, on the CPU:
its plain version at 3 and 6 mics, core and postfilter, against the JAX
Pallas kernel in interpret mode, in float32, at the tolerances
test_torch_tdgsc.py holds 4 mics to.  At 3 mics C = M - 1 is even (the
gradient pairs are all full; the postfiltered beam takes a pair of its
own), at 6 odd.  The kernels themselves are held to these plain versions on the card
(``chip_smoke.py``) and in the CPU rehearsal of their sources
(``test_torch_csrc_rehearsal.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import tdgsc as jt
from distantspeech_tpu.ops.pallas_flms import fused_tdgsc as j_tdgsc
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import tdgsc as tt
from distantspeech_tpu_torch.ops import cuda_flms as cf

ANG = (np.pi / 2, 0.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


@pytest.mark.parametrize("postfilter", [False, True], ids=["core", "postfilter"])
@pytest.mark.parametrize("M", [3, 6])
def test_k5_plain_matches_pallas_interpret(M, postfilter):
    """float32, B=8 x 8 frames of noise: the tolerances test_torch_tdgsc.py
    holds 4 mics to (out 1e-5, 1e-4 with the postfilter; p 1e-6; bm 1e-5);
    C = M - 1 is even at 3 mics, odd at 6."""
    x = np.random.default_rng(M).standard_normal((8, M, 8 * 256)).astype(np.float32)
    want = j_tdgsc(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, jt.TdGscConfig(n_mics=M, postfilter=postfilter),
                   interpret=True)
    got = cf.fused_tdgsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG,
                               tt.TdGscConfig(n_mics=M, postfilter=postfilter))
    (o1, p1, bm1), (o2, p2, bm2) = (np.asarray(w) for w in want), (g.numpy() for g in got)
    assert _rel(o2, o1) < (1e-4 if postfilter else 1e-5)
    np.testing.assert_allclose(p2, p1, atol=1e-6)
    assert _rel(bm2, bm1) < 1e-5
