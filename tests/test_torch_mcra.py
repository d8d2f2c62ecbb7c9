"""The port's MCRA on the CPU: ``mcra_run_plain`` (the plain version of the
MCRA lane kernel, ``csrc/mcra.cu``) against the JAX package's ``mcra_run``
(one ``lax.scan``) in float64, with and without S / Smin; ``mcra_run`` on a
CPU tensor is that plain version and launches nothing; the kernel's wrapper
takes float32 CUDA tensors only.  The kernel itself is held to the plain
version on the card (``chip_smoke.py``) and in the CPU rehearsal of its
source (``test_torch_csrc_rehearsal.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.noise import mcra as jmcra
from distantspeech_tpu_torch.noise import mcra as tmcra
from distantspeech_tpu_torch.ops import cuda_mcra
from distantspeech_tpu_torch.runtime.profiling import counters, reset_counters


def _power(T, batch, F, seed):
    """Noise power with bursts of speech-like power on some frames."""
    rng = np.random.default_rng(seed)
    gain = 1.0 + 30.0 * (rng.random((T,) + batch + (1,)) < 0.4)
    return rng.gamma(1.0, 1.0, (T,) + batch + (F,)) * gain


@pytest.mark.parametrize("return_sr", [False, True], ids=["lam_p", "lam_p_sr"])
def test_plain_matches_jax_float64(return_sr):
    """48 frames at L = 4 (11 minima-window resets, p free after frame 8) over
    a [2, 3] batch of lanes: the frame loop is JAX's scan to float64 rounding."""
    cfg_j = dataclasses.replace(jmcra.McraConfig(nfft=128), L=4)
    cfg_t = dataclasses.replace(tmcra.McraConfig(nfft=128), L=4)
    Y = _power(48, (2, 3), cfg_t.half_bin, seed=5)
    want = jmcra.mcra_run(cfg_j, jnp.asarray(Y), return_sr=return_sr)
    got = tmcra.mcra_run_plain(cfg_t, torch.as_tensor(Y), return_sr=return_sr)
    assert len(got) == len(want) == (3 if return_sr else 2)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-300)
    p = got[1].numpy()
    assert p.min() < 0.01 and p.max() > 0.9  # p moved both ways


def test_cpu_tensors_take_the_plain_version():
    cfg = tmcra.McraConfig()
    Y = torch.as_tensor(_power(20, (4,), cfg.half_bin, seed=6), dtype=torch.float32)
    reset_counters()
    for return_sr in (False, True):
        for g, w in zip(tmcra.mcra_run(cfg, Y, return_sr=return_sr), tmcra.mcra_run_plain(cfg, Y, return_sr)):
            assert torch.equal(g, w)
    assert "launch.mcra_run" not in counters()


def test_kernel_wrapper_takes_float32_cuda_tensors():
    cfg = tmcra.McraConfig()
    Y = torch.ones((5, 2, cfg.half_bin))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mcra.mcra_frames(cfg, Y, Y)
    assert "launch.mcra_run" not in counters()
