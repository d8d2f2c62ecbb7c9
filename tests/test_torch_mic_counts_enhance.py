"""K2/K4's plain version (``fused_enhance_plain``, the plain version of
both kernels) at the mic counts and transform sizes the kernels take beyond
the 4-mic, 256-point case: 3 and 6 mics at n_fft 256, 8 mics at 512 and 2
at 1024, against the JAX scan in float64 (<= 1e-9).  The kernels themselves are held to these plain versions on the card
(``chip_smoke.py``) and in the CPU rehearsal of their sources
(``test_torch_csrc_rehearsal.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import enhance as jenh
from distantspeech_tpu.beamform.mvdr import MvdrConfig as JMvdrConfig
from distantspeech_tpu.transform.stft import StftConfig as JStftConfig
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.beamform import enhance as tenh
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig as TMvdrConfig
from distantspeech_tpu_torch.ops import cuda_enhance as ce
from distantspeech_tpu_torch.transform.stft import StftConfig as TStftConfig


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


@pytest.mark.parametrize("M, n_fft", [(3, 256), (6, 256), (8, 512), (2, 1024)])
def test_k2_k4_plain_float64_matches_jax_scan(M, n_fft):
    """ldl mode, 40 frames (past MCRA's 2L = 30 frames of forced p): the lane
    recursion at these mic counts and transform sizes is the JAX scan's math
    to float64 rounding."""
    cj, ct = _enhance_cfgs(n_fft)
    x = _speech(2, M, n_fft // 2 * 40, seed=M, dtype=np.float64)
    want = jenh.enhance_process(jnp.asarray(x), JGeometry.linear(M, 0.032), (90.0, 0.0), cj)
    got = ce.fused_enhance_plain(torch.as_tensor(x), _steer(M, n_fft, np.complex128), ct)
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-9
