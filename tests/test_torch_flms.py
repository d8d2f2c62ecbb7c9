"""The building blocks of the port's time-domain GSC on the CPU, each against
its JAX counterpart in float64 (<= 1e-9 relative): recurrences, DC notch,
emphasis, FIR, alignment filters, real DFTs, delay lines, the FLMS step and
the multichannel OM-LSA; and the packed DFT matrices of kernel K5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distantspeech_tpu.adaptive import feature as jfeat
from distantspeech_tpu.adaptive import flms as jflms
from distantspeech_tpu.array.alignment import time_alignment_filters as j_align
from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.noise import omlsa as jom
from distantspeech_tpu.ops import delay as jdelay, dft as jdft, fir as jfir, iir as jiir
from distantspeech_tpu_torch.adaptive import feature as tfeat
from distantspeech_tpu_torch.adaptive import flms as tflms
from distantspeech_tpu_torch.array.alignment import time_alignment_filters as t_align
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.noise import omlsa as tom
from distantspeech_tpu_torch.ops import cuda_flms as cf
from distantspeech_tpu_torch.ops import delay as tdelay, dft as tdft, fir as tfir, iir as tiir

RNG = np.random.default_rng(0)


def _close(got, want, tol=1e-9):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-300)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_first_order_recurrence():
    b = RNG.standard_normal((3, 700))
    s0 = RNG.standard_normal(3)
    _close(tiir.first_order_recurrence(0.97, _t(b), _t(s0)), jiir.first_order_recurrence(0.97, jnp.asarray(b), jnp.asarray(s0)))
    _close(tiir.first_order_recurrence(0.5, _t(b[0]), 0.25), jiir.first_order_recurrence(0.5, jnp.asarray(b[0]), 0.25))
    with pytest.raises(ValueError, match="scalar"):  # a per-step coefficient would need a sample-level scan
        tiir.first_order_recurrence(_t(RNG.uniform(0.5, 1.0, (3, 700))), _t(b), _t(s0))


def test_affine_recurrence_and_blocked_form():
    A = RNG.uniform(-0.5, 0.5, (2, 37, 2, 2))
    b = RNG.standard_normal((2, 37, 2))
    s0 = RNG.standard_normal((2, 2))
    _close(tiir.affine_recurrence(_t(A), _t(b), _t(s0)), jiir.affine_recurrence(jnp.asarray(A), jnp.asarray(b), jnp.asarray(s0)))
    Ac, Bv = np.array([[1.9, 1.0], [-0.91, 0.0]]), np.array([-0.1, 0.09])
    x = RNG.standard_normal((2, 1000))  # 3 full 256-blocks and a short tail
    _close(tiir.constant_affine_blocked(Ac, Bv, _t(x), _t(s0)),
           jiir.constant_affine_blocked(Ac, Bv, jnp.asarray(x), jnp.asarray(s0)))


def test_dc_notch_and_emphasis_streaming():
    x = RNG.standard_normal((2, 3, 1600))
    js, ts = jfeat.dc_notch_init((2, 3), dtype=jnp.float64), tfeat.dc_notch_init((2, 3), dtype=torch.float64, device="cpu")
    je, te = jfeat.emphasis_init((2, 3), dtype=jnp.float64), tfeat.emphasis_init((2, 3), dtype=torch.float64, device="cpu")
    for blk in np.split(x, 4, axis=-1):  # chunked: the carries must hold across calls
        js, jy = jfeat.dc_notch(js, jnp.asarray(blk), radius=0.98)
        ts, ty = tfeat.dc_notch(ts, _t(blk), radius=0.98)
        _close(ty, jy)
        je, jp = jfeat.pre_emphasis(je, jnp.asarray(blk))
        te, tp = tfeat.pre_emphasis(te, _t(blk))
        _close(tp, jp)
        je, jd = jfeat.de_emphasis(je, jnp.asarray(blk))
        te, td = tfeat.de_emphasis(te, _t(blk))
        _close(td, jd)
    _close(ts.mem, js.mem)


def test_fir_and_alignment_filters():
    for angle in ((np.pi / 2, 0.0), (197.0 / 180.0 * np.pi, 0.0)):
        coeffs = t_align(TGeometry.linear(4, 0.032), angle)
        _close(coeffs, j_align(JGeometry.linear(4, 0.032), angle))
    x = RNG.standard_normal((2, 4, 1000))
    _close(tfir.fir_filter_offline(_t(x), _t(coeffs)), jfir.fir_filter_offline(jnp.asarray(x), jnp.asarray(coeffs)))
    cache_t = torch.zeros((2, 4, coeffs.shape[-1] - 1), dtype=torch.float64)
    cache_j = jnp.zeros((2, 4, coeffs.shape[-1] - 1))
    taps = tfir.fir_block_taps(_t(coeffs), 250)
    for blk in np.split(x, 4, axis=-1):
        cache_j, yj = jfir.fir_filter_block(cache_j, jnp.asarray(blk), jnp.asarray(coeffs))
        cache_t, yt = tfir.fir_filter_block(cache_t, _t(blk), taps)
        _close(yt, yj)


def test_rdft_irdft_and_delays():
    x = RNG.standard_normal((3, 300))
    _close(torch.view_as_real(tdft.rdft(_t(x), n=512)), np.stack(np.broadcast_arrays(
        np.real(jdft.rdft(jnp.asarray(x), n=512)), np.imag(jdft.rdft(jnp.asarray(x), n=512))), axis=-1))
    X = RNG.standard_normal((3, 257)) + 1j * RNG.standard_normal((3, 257))
    _close(tdft.irdft(_t(X), n=512), jdft.irdft(jnp.asarray(X), n=512))
    cj, ct = jdelay.delay_samples_init((2,), 100, dtype=jnp.float64), tdelay.delay_samples_init((2,), 100, torch.float64, "cpu")
    fj, ft = jdelay.delay_frames_init((2,), 3, (5,), dtype=jnp.float64), tdelay.delay_frames_init((2,), 3, (5,), torch.float64, "cpu")
    for blk in np.split(RNG.standard_normal((2, 240)), 4, axis=-1):
        cj, yj = jdelay.delay_samples(cj, jnp.asarray(blk))
        ct, yt = tdelay.delay_samples(ct, _t(blk))
        _close(yt, yj)
        fj, gj = jdelay.delay_frames(fj, jnp.asarray(blk[:, :5]))
        ft, gt = tdelay.delay_frames(ft, _t(blk[:, :5]))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


@pytest.mark.parametrize("two_path", [False, True], ids=["one_path", "two_path"])
def test_flms_step(two_path):
    """Non-causal, fir_truncate and a per-bin gate p (the TDGSC canceller's
    configuration), and the two-path variant."""
    C, L, T = 3, 64, 12
    kw = dict(filter_len=L, n_channels=C, non_causal=not two_path, two_path=two_path)
    cj, ct = jflms.FlmsConfig(**kw), tflms.FlmsConfig(**kw)
    sj = jflms.flms_init(cj, (2,), dtype=jnp.float64)
    st = tflms.flms_init(ct, (2,), dtype=torch.float64, device="cpu")
    w0 = RNG.standard_normal((2, L)) * 0.1
    if two_path:
        sj, st = jflms.flms_set_weights(cj, sj, jnp.asarray(w0)), tflms.flms_set_weights(ct, st, _t(w0))
    x = RNG.standard_normal((T, 2, C, L))
    d = RNG.standard_normal((T, 2, L))
    p = RNG.uniform(0.0, 1.0, (T, 2, 1, cj.half_bin))
    step = dict() if two_path else dict(fir_truncate=5)
    for t in range(T):
        sj, (ej, wj) = jflms.flms_step(cj, sj, jnp.asarray(x[t]), jnp.asarray(d[t]), p=jnp.asarray(p[t]), **step)
        st, (et, wt) = tflms.flms_step(ct, st, _t(x[t]), _t(d[t]), p=_t(p[t]), **step)
        _close(et, ej)
        _close(wt, wj)
    _close(torch.view_as_real(st.W), np.stack([np.real(sj.W), np.imag(sj.W)], axis=-1))
    _close(st.P, sj.P)


def test_omlsa_step_and_run():
    M, F, T = 4, 257, 40
    Y = RNG.uniform(0.1, 2.0, (T, 2, F)) * (1.0 + 5.0 * (np.arange(T)[:, None, None] % 10 < 4))
    U = RNG.uniform(0.1, 2.0, (T, 2, M - 1, F))
    cj, ct = jom.OmlsaConfig(nfft=512, n_channels=M), tom.OmlsaConfig(nfft=512, n_channels=M)
    for a, b in zip(tom.omlsa_run(ct, _t(Y), _t(U)), jom.omlsa_run(cj, jnp.asarray(Y), jnp.asarray(U))):
        _close(a, b)
    sj, st = jom.omlsa_init(cj, (2,), dtype=jnp.float64), tom.omlsa_init(ct, (2,), dtype=torch.float64, device="cpu")
    for t in range(3):
        sj, oj = jom.omlsa_step(cj, sj, jnp.asarray(Y[t]), jnp.asarray(U[t]))
        st, ot = tom.omlsa_step(ct, st, _t(Y[t]), _t(U[t]))
    for a, b in zip(ot, oj):
        _close(a, b)
    _close(st.zeta_U, sj.zeta_U)
    assert st.frm_cnt == int(sj.frm_cnt) == 3


def test_packed_dft_matrices():
    """K5's plain version uses the JAX kernel's packed matrices: they are
    the JAX package's own numbers, invert each other, and unpack to rfft."""
    from distantspeech_tpu.ops.pallas_flms import plain_dft_packed, windowed_dft_packed

    n = 512
    for got, want in zip(cf.plain_dft_packed(n) + cf.windowed_dft_packed(n, n // 2),
                         plain_dft_packed(n) + windowed_dft_packed(n, n // 2)):
        _close(got, want, tol=1e-12)
    CS, AB = cf.plain_dft_packed(n)
    x = RNG.standard_normal((4, n))
    Z = x @ CS
    np.testing.assert_allclose(Z @ AB, x, atol=1e-10)
    re, im = cf._unpack(torch.as_tensor(Z), n // 2 + 1)
    ref = np.fft.rfft(x, axis=-1)
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), ref, atol=1e-9)
    np.testing.assert_array_equal(cf._pack(re, im).numpy(), Z)
