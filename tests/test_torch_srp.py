"""The port's SRP-PHAT on the CPU: the steering grid and
``srp_process(backend="scan")`` (with its MCRA track) against the JAX package
in float64; the plain version of kernel K10 (``ops/cuda_srp.py``,
``csrc/srp.cu``) against the JAX Pallas kernel ``fused_srp_spectrum`` in
interpret mode and against the einsum path, in float32, with the JAX tests'
cases (row padding, the unbatched [M, S] input, ``phat=False``); the
``fused`` backend's routing of CPU tensors; and a DOA pick."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.doa import srp as jsrp
from distantspeech_tpu.ops.pallas_srp import fused_srp_spectrum as j_fused
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.doa import srp as tsrp
from distantspeech_tpu_torch.ops import cuda_srp as cr
from distantspeech_tpu_torch.runtime.profiling import counters, reset_counters


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-300))


def test_steering_grid_matches_jax():
    for M, d in ((8, 0.032), (4, 0.05)):
        np.testing.assert_array_equal(tsrp.srp_steering_grid(tsrp.SrpConfig(), TGeometry.linear(M, d)),
                                      jsrp.srp_steering_grid(jsrp.SrpConfig(), JGeometry.linear(M, d)))


@pytest.mark.parametrize("phat", [True, False])
def test_scan_matches_jax_float64(phat):
    x = np.random.default_rng(0).standard_normal((2, 8, 16000))
    want = jsrp.srp_process(jnp.asarray(x), JGeometry.linear(8, 0.032), phat=phat)
    got = tsrp.srp_process(x, TGeometry.linear(8, 0.032), phat=phat, device="cpu")
    assert got[0].shape == (2, 125, 360) and got[1].shape == (2, 125, 129)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and _rel(g, w) <= 1e-9


def _spectrum(Y_np, grid, phat=True):
    """JAX's kernel (interpret mode), JAX's einsum path and the port's plain
    kernel version on the same float32 spectrogram."""
    a = np.asarray(j_fused(jnp.asarray(Y_np), grid, phat=phat, interpret=True))
    b = np.asarray(jsrp.srp_angle_spectrum(jnp.asarray(Y_np), jnp.asarray(grid), phat=phat))
    c = cr.fused_srp_spectrum(torch.as_tensor(Y_np), grid, phat=phat).numpy()
    return a, b, c


@pytest.mark.parametrize("case", ["batched", "row_padding_unbatched", "no_phat"])
def test_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(1)
    cfg = tsrp.SrpConfig()
    if case == "no_phat":
        grid = tsrp.srp_steering_grid(cfg, TGeometry.linear(4, 0.032))
        Y = (rng.standard_normal((7, 129, 4)) + 1j * rng.standard_normal((7, 129, 4))).astype(np.complex64)
        a, b, c = _spectrum(Y, grid, phat=False)
    else:
        M, d, shape = (8, 0.032, (2, 8, 16000)) if case == "batched" else (4, 0.05, (4, 6400))
        grid = tsrp.srp_steering_grid(cfg, TGeometry.linear(M, d))
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
        from distantspeech_tpu_torch.transform import analysis

        Y = torch.movedim(torch.movedim(analysis(x, cfg.stft), -3, -1), -3, 0).numpy()  # [T, ..., F, M]
        a, b, c = _spectrum(Y, grid)
    assert c.dtype == np.float32 and c.shape == a.shape == Y.shape[:-2] + (360,)
    assert _rel(c, a) < 1e-5 and _rel(c, b) < 1e-5
    assert (c.argmax(-1) == a.argmax(-1)).all() and (c.argmax(-1) == b.argmax(-1)).all()


def test_phat_whitening_is_shared():
    """Both backends whiten with ``cuda_srp.phat_whiten``, JAX's Y / (|Y| +
    1e-6): the einsum path and the kernel's rows with ``phat`` are the same
    calls on the whitened spectrum without it."""
    rng = np.random.default_rng(4)
    Y = torch.as_tensor(rng.standard_normal((5, 2, 129, 4)) + 1j * rng.standard_normal((5, 2, 129, 4)))
    grid = tsrp.srp_steering_grid(tsrp.SrpConfig(), TGeometry.linear(4, 0.032))
    Yw = cr.phat_whiten(Y)
    np.testing.assert_allclose(Yw.numpy(), Y.numpy() / (np.abs(Y.numpy()) + 1e-6), rtol=1e-12, atol=0)
    assert torch.equal(tsrp.srp_angle_spectrum(Y, grid), tsrp.srp_angle_spectrum(Yw, grid, phat=False))
    assert torch.equal(cr.whitened_rows(Y), cr.whitened_rows(Yw, phat=False))
    assert _rel(tsrp.srp_angle_spectrum(Y, grid), jsrp.srp_angle_spectrum(jnp.asarray(Y.numpy()), jnp.asarray(grid))) <= 1e-9


def test_pack_grid_layout():
    """[yr | yi] @ G[f] is [Re | Im] of sum_m conj(a_theta,f,m) y_m."""
    rng = np.random.default_rng(5)
    grid = tsrp.srp_steering_grid(tsrp.SrpConfig(), TGeometry.linear(4, 0.032))  # [360, 129, 4]
    y = rng.standard_normal((3, 129, 4)) + 1j * rng.standard_normal((3, 129, 4))
    G = cr.pack_grid(grid, "cpu")
    assert G.dtype == torch.float32 and G.shape == (129, 8, 720)
    z = torch.einsum("rfk,fka->rfa", torch.as_tensor(np.concatenate([y.real, y.imag], -1)), G.double())
    want = np.einsum("afm,rfm->rfa", grid.conj().astype(np.complex64).astype(np.complex128), y)
    assert _rel(z[..., :360], want.real) <= 1e-12 and _rel(z[..., 360:], want.imag) <= 1e-12


def test_fused_backend_runs_the_plain_version_on_cpu():
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((3, 4, 4000)).astype(np.float32))
    geom = TGeometry.linear(4, 0.032)
    reset_counters()
    s1, p1 = tsrp.srp_process(x, geom, backend="fused", device="cpu")
    s2, p2 = tsrp.srp_process(x, geom, device="cpu")
    assert "launch.fused_srp_spectrum" not in counters()
    assert s1.shape == s2.shape == (3, 31, 360) and s1.dtype == torch.float32
    assert _rel(s1, s2) < 1e-5 and torch.equal(p1, p2)
    with pytest.raises(ValueError, match="backend"):
        tsrp.srp_process(x, geom, backend="pallas", device="cpu")


def test_doa_pick():
    """A source reaching mic m m samples after mic 0: cos(theta) =
    c / (0.032 fs), 47.9 degrees, or its mirror 312.1."""
    rng = np.random.default_rng(3)
    s = rng.standard_normal((2, 16000 + 8))
    x = np.stack([s[:, 8 - m : 8 - m + 16000] for m in range(8)], axis=1).astype(np.float32)
    spec, _ = tsrp.srp_process(x, TGeometry.linear(8, 0.032), backend="fused", device="cpu")
    pick = int(spec.sum(dim=(0, 1)).argmax())
    true = np.degrees(np.arccos(343.0 / (0.032 * 16000)))
    assert min(abs(pick - true), abs(pick - (360 - true))) <= 1.0
