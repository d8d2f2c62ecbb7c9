"""The fused paths of the port on the CPU: ``fused_enhance_plain`` (the plain
version of both CUDA kernels) against the JAX scan in float64 and against
the JAX Pallas kernels (interpret mode) in float32; the wrappers and
``enhance_process`` route CPU tensors to it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import enhance as jenh
from distantspeech_tpu.beamform.mvdr import MvdrConfig as JMvdrConfig
from distantspeech_tpu.ops.pallas_enhance import fused_enhance as j_fused, fused_enhance_full as j_full
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.beamform import enhance as tenh
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig as TMvdrConfig
from distantspeech_tpu_torch.ops import cuda_enhance as ce

M = 4


def _scene(B, S, seed, dtype):
    rng = np.random.default_rng(seed)
    env = np.sin(2 * np.pi * 1.3 * np.arange(S) / 16000) > 0
    return (0.3 * rng.standard_normal((B, M, S)) + (env * rng.standard_normal(S))[None, None]).astype(dtype)


def _steer(dtype=np.complex128):
    return steering_vector(TGeometry.linear(M, 0.032), np.array([np.pi / 2, 0.0]), 256).astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("rel_diag", [0.0, 1e-3])
def test_plain_float64_matches_jax_scan(rel_diag):
    """ldl mode, guard off: the lane recursion (split complex, closed-form
    MCRA counters) is the scan's math to float64 rounding."""
    kw = dict(mcra_L=15, rel_diag=rel_diag)
    x = _scene(2, 128 * 80, seed=11, dtype=np.float64)
    want = jenh.enhance_process(jnp.asarray(x), JGeometry.linear(M, 0.032), (90.0, 0.0),
                                jenh.EnhanceConfig(mvdr=JMvdrConfig(**kw)))
    got = ce.fused_enhance_plain(torch.as_tensor(x), _steer(), tenh.EnhanceConfig(mvdr=TMvdrConfig(**kw)))
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-9


@pytest.fixture(scope="module")
def float32_case():
    kw = dict(mcra_L=15, rel_diag=1e-3)
    x = _scene(8, 128 * 40, seed=12, dtype=np.float32)
    return x, jenh.EnhanceConfig(mvdr=JMvdrConfig(**kw)), tenh.EnhanceConfig(mvdr=TMvdrConfig(**kw))


@pytest.mark.parametrize("jax_kernel", [j_fused, j_full], ids=["fused_enhance", "fused_enhance_full"])
def test_plain_float32_matches_pallas_interpret(float32_case, jax_kernel):
    """float32 against the TPU kernels run by the Pallas interpreter: the two
    sides differ only in the analysis products' summation order."""
    x, cfg_j, cfg_t = float32_case
    want = np.asarray(jax_kernel(jnp.asarray(x), _steer(np.complex64), cfg_j, interpret=True))
    got = ce.fused_enhance_plain(torch.as_tensor(x), _steer(np.complex64), cfg_t)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("backend", ["fused", "mega"])
def test_cpu_tensors_take_the_plain_version(float32_case, backend):
    """On CPU tensors both wrappers, and enhance_process with their
    backends, are the plain version exactly (and launch nothing)."""
    x, _, cfg = float32_case
    x = torch.as_tensor(x[:2, :, : 128 * 21 + 50])  # a sub-hop tail is dropped
    ce.LAUNCHES.update(fused_enhance=0, fused_enhance_full=0)
    want = ce.fused_enhance_plain(x, _steer(np.complex64), cfg, inv_mode="rank1", t_chunk=8)
    wrapper = ce.fused_enhance_full if backend == "mega" else ce.fused_enhance
    got = wrapper(x, _steer(np.complex64), cfg, inv_mode="rank1", t_chunk=8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = tenh.enhance_process(x, TGeometry.linear(M, 0.032), (90.0, 0.0), cfg, backend=backend,
                               inv_mode="rank1", device="cpu", t_chunk=8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.shape == (2, 128 * 21)
    assert ce.LAUNCHES == {"fused_enhance": 0, "fused_enhance_full": 0}


def test_validation():
    cfg = tenh.EnhanceConfig()
    x = torch.zeros(2, M, 1280)
    with pytest.raises(ValueError, match="inv_mode"):
        ce.fused_enhance_full(x, _steer(), cfg, inv_mode="sm")
    with pytest.raises(ValueError, match=r"\[B, M, S\]"):
        ce.fused_enhance(x[0], _steer(), cfg)
    with pytest.raises(ValueError, match="steer"):
        ce.fused_enhance_plain(x, _steer()[:, :2], cfg)
    with pytest.raises(ValueError, match=r"backend='pallas' needs x of shape \[B, M, S\]"):
        tenh.enhance_process(x[0], TGeometry.linear(M, 0.032), backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tenh.enhance_process(x, TGeometry.linear(M, 0.032), backend="nope", device="cpu")


@pytest.mark.parametrize("wrapper", [ce.fused_enhance, ce.fused_enhance_full])
def test_no_fallback_off_the_cpu(wrapper):
    """A tensor that is neither on the CPU nor on a card is refused, not
    quietly run by the plain version."""
    x = torch.zeros(2, M, 1280, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(x, _steer(), tenh.EnhanceConfig())
