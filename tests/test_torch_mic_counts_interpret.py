"""Plain versions at 3 mics against the JAX Pallas kernels in interpret
mode, float32: K2/K4's (``fused_enhance_plain``; K4 packs the mics in pairs,
the last one alone) at n_fft 256 (<= 1e-4), and K8's (``fused_fdgsc``; its
last mic pair half empty) at 3 and 6 mics at test_torch_fdgsc.py's
tolerances.  The kernels themselves are held to these plain versions on the card
(``chip_smoke.py``) and in the CPU rehearsal of their sources
(``test_torch_csrc_rehearsal.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import enhance as jenh
from distantspeech_tpu.beamform import fdgsc as jf
from distantspeech_tpu.beamform.mvdr import MvdrConfig as JMvdrConfig
from distantspeech_tpu.ops.pallas_enhance import fused_enhance as j_fused_enh, fused_enhance_full as j_full
from distantspeech_tpu.ops.pallas_flms import fused_fdgsc as j_fdgsc
from distantspeech_tpu.transform.stft import StftConfig as JStftConfig
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.beamform import enhance as tenh
from distantspeech_tpu_torch.beamform import fdgsc as tf
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig as TMvdrConfig
from distantspeech_tpu_torch.ops import cuda_enhance as ce, cuda_flms as cf
from distantspeech_tpu_torch.transform.stft import StftConfig as TStftConfig

ANG = (np.pi / 2, 0.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _speech(B, M, S, seed, dtype):
    """Noise on every mic under a common 1.3 Hz on/off burst, so that MCRA's
    p comes and goes."""
    rng = np.random.default_rng(seed)
    env = np.sin(2 * np.pi * 1.3 * np.arange(S) / 16000) > 0
    return (0.3 * rng.standard_normal((B, M, S)) + (env * rng.standard_normal(S))[None, None]).astype(dtype)


def _enhance_cfgs(n_fft):
    kw = dict(mcra_L=15, rel_diag=1e-3)
    return (jenh.EnhanceConfig(mvdr=JMvdrConfig(stft=JStftConfig(n_fft, n_fft // 2), **kw)),
            tenh.EnhanceConfig(mvdr=TMvdrConfig(stft=TStftConfig(n_fft, n_fft // 2), **kw)))


def _steer(M, n_fft, dtype):
    return steering_vector(TGeometry.linear(M, 0.032), np.array([np.pi / 2, 0.0]), n_fft).astype(dtype)


@pytest.mark.parametrize("jax_kernel", [j_fused_enh, j_full], ids=["fused_enhance", "fused_enhance_full"])
def test_k2_k4_plain_float32_matches_pallas_interpret_at_3_mics(jax_kernel):
    """float32 against the TPU kernels run by the Pallas interpreter at an
    odd mic count (K4 packs the mics in pairs, the last one alone)."""
    cj, ct = _enhance_cfgs(256)
    x = _speech(8, 3, 128 * 40, seed=13, dtype=np.float32)
    want = np.asarray(jax_kernel(jnp.asarray(x), _steer(3, 256, np.complex64), cj, interpret=True))
    got = ce.fused_enhance_plain(torch.as_tensor(x), _steer(3, 256, np.complex64), ct)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("M", [3, 6])
def test_k8_plain_matches_pallas_interpret(M):
    """float32, B=8 x 10 frames of noise: test_torch_fdgsc.py's tolerances."""
    x = np.random.default_rng(M).standard_normal((8, M, 10 * 256)).astype(np.float32)
    want = j_fdgsc(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, jf.FdGscConfig(n_mics=M), interpret=True)
    got = cf.fused_fdgsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, tf.FdGscConfig(n_mics=M))
    (o1, p1, bm1), (o2, p2, bm2) = (np.asarray(w) for w in want), (g.numpy() for g in got)
    assert _rel(o2, o1) < 1e-5
    np.testing.assert_allclose(p2, p1, atol=1e-6)
    assert _rel(bm2, bm1) < 1e-5
