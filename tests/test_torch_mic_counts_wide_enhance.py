"""K2/K4's plain version (``fused_enhance_plain``) beyond 8 mics and beyond
the powers of two, on the CPU: at 12 mics against the JAX Pallas kernels
``fused_enhance`` and ``fused_enhance_full`` in interpret mode, and at
n_fft 768 against ``fused_enhance_full``, in float32, at the 1e-4 of
test_torch_mic_counts_interpret.py's 3-mic case.  The kernels themselves
are held to this plain version on the card (``chip_smoke.py``) and in the
CPU rehearsal of their sources (``test_torch_csrc_rehearsal.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.beamform import enhance as jenh
from distantspeech_tpu.beamform.mvdr import MvdrConfig as JMvdrConfig
from distantspeech_tpu.ops.pallas_enhance import fused_enhance as j_fused_enh, fused_enhance_full as j_full
from distantspeech_tpu.transform.stft import StftConfig as JStftConfig
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.beamform import enhance as tenh
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig as TMvdrConfig
from distantspeech_tpu_torch.ops import cuda_enhance as ce
from distantspeech_tpu_torch.transform.stft import StftConfig as TStftConfig

ANG = (np.pi / 2, 0.0)
M = 12


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _speech(B, mics, S, seed):
    """Noise on every mic under a common 1.3 Hz on/off burst, so that MCRA's
    p comes and goes."""
    rng = np.random.default_rng(seed)
    env = np.sin(2 * np.pi * 1.3 * np.arange(S) / 16000) > 0
    return (0.3 * rng.standard_normal((B, mics, S)) + (env * rng.standard_normal(S))[None, None]).astype(np.float32)


@pytest.mark.parametrize("jax_kernel, mics, n_fft", [(j_fused_enh, M, 256), (j_full, M, 256), (j_full, 4, 768)],
                         ids=["fused_enhance-12-256", "fused_enhance_full-12-256", "fused_enhance_full-4-768"])
def test_k2_k4_plain_matches_pallas_interpret(jax_kernel, mics, n_fft):
    """test_torch_mic_counts_interpret.py's 3-mic case (<= 1e-4) at 12 mics,
    and K4's at n_fft 768 (a transform size that is not a power of two):
    B=8 x 24 frames with MCRA's window cut to L=5, so that p moves after its
    2L = 10 frames of forced p."""
    kw = dict(mcra_L=5, rel_diag=1e-3)
    cj = jenh.EnhanceConfig(mvdr=JMvdrConfig(stft=JStftConfig(n_fft, n_fft // 2), **kw))
    ct = tenh.EnhanceConfig(mvdr=TMvdrConfig(stft=TStftConfig(n_fft, n_fft // 2), **kw))
    x = _speech(8, mics, n_fft // 2 * 24, seed=mics)
    steer = steering_vector(TGeometry.linear(mics, 0.032), np.array(ANG), n_fft).astype(np.complex64)
    want = np.asarray(jax_kernel(jnp.asarray(x), steer, cj, interpret=True))
    got = ce.fused_enhance_plain(torch.as_tensor(x), steer, ct)
    assert _rel(got, want) <= 1e-4
