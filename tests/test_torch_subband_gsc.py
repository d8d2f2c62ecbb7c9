"""The port's subband GSC on the CPU: its building blocks (the diffuse
coherence, the MSC recursion, McCDR, McSpp and its base tracker, the subband
adaptive filters) and ``subband_gsc_process(backend="scan")`` against the
JAX package in float64; the chained streaming step against the offline
path; the plain version of kernel K9 (``csrc/sgsc.cu``) against the scan;
the ``fused`` backend's routing of CPU tensors; and a mid-run handover of
the JAX state.  The McSpp comparisons also run with the McCDR's MCRA window
cut to L=3, so that MCRA's p leaves its floor within 16 frames."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.adaptive import subband as jsub
from distantspeech_tpu.array.coherence import diffuse_coherence as j_diffuse
from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import subband_gsc as jsg
from distantspeech_tpu.coherence import msc as jmsc
from distantspeech_tpu.noise import mccdr as jcdr, mcspp as jspp, mcspp_base as jspb
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.adaptive import subband as tsub
from distantspeech_tpu_torch.array.coherence import diffuse_coherence as t_diffuse
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import subband_gsc as tsg
from distantspeech_tpu_torch.coherence import msc as tmsc
from distantspeech_tpu_torch.noise import mccdr as tcdr, mcspp as tspp, mcspp_base as tspb
from distantspeech_tpu_torch.ops import cuda_flms as cf, cuda_sgsc as cs
from distantspeech_tpu_torch.stats import linalg as tla

ANG = (np.pi / 2, 0.0)
M, L = 4, 256


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-300))


def short_mcra(gsc_cfg, spp_cfg, cdr_cfg):
    """Subclasses of one package's (SubbandGscConfig, McSppConfig,
    McCdrConfig) whose McCDR MCRA window is L=3."""

    class Cdr(cdr_cfg):
        @property
        def mcra(self):
            return dataclasses.replace(super().mcra, L=3)

    class Spp(spp_cfg):
        @property
        def mccdr(self):
            return Cdr(nfft=self.nfft, n_channels=min(4, self.n_channels))

    class Gsc(gsc_cfg):
        @property
        def spp(self):
            return Spp(nfft=self.frame_len * 2, n_channels=self.n_mics)

    return Gsc, Spp


J_SHORT = short_mcra(jsg.SubbandGscConfig, jspp.McSppConfig, jcdr.McCdrConfig)
T_SHORT = short_mcra(tsg.SubbandGscConfig, tspp.McSppConfig, tcdr.McCdrConfig)


def _spectra(T, B, F, C, seed):
    """[T, B, F, C] complex128 frames of a common source plus noise, so that
    the pair coherence and the McSpp statistics are not trivial."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((T, B, F, 1)) + 1j * rng.standard_normal((T, B, F, 1))
    gain = np.exp(1j * rng.uniform(0, 2 * np.pi, (1, 1, F, C)))
    env = (rng.random((T, 1, 1, 1)) < 0.5) * 4.0
    noise = rng.standard_normal((T, B, F, C)) + 1j * rng.standard_normal((T, B, F, C))
    return src * gain * env + noise


def test_diffuse_coherence_and_pairs_match_jax():
    for geom in (TGeometry.circular(4, 0.032, c=343.0), TGeometry.linear(6, 0.05)):
        jgeom = JGeometry(geom.mic_loc, fs=geom.fs, c=geom.c)
        np.testing.assert_array_equal(t_diffuse(geom, 512), j_diffuse(jgeom, 512))
    for n in (2, 4, 6):
        for a, b in zip(tmsc.pair_indices(n), jmsc.pair_indices(n)):
            np.testing.assert_array_equal(a, b)
    assert tmsc.pair_index(4, 1, 2) == jmsc.pair_index(4, 1, 2) == 3
    np.testing.assert_array_equal(tcdr.McCdrConfig(nfft=512).fn_pair(), jcdr.McCdrConfig(nfft=512).fn_pair())


def test_msc_and_mccdr_steps_match_jax_float64():
    T, B, F = 12, 2, 129
    Y = _spectra(T, B, F, 4, 0)
    sj = jmsc.msc_init(4, F, (B,), cdtype=jnp.complex128)
    st = tmsc.msc_init(4, F, (B,), cdtype=torch.complex128, device="cpu")
    for t in range(T):
        sj, fj = jmsc.msc_update(sj, jnp.asarray(Y[t]), 0.9)
        st, ft = tmsc.msc_update(st, torch.as_tensor(Y[t]), 0.9)
        assert _rel(ft, fj) <= 1e-9 and _rel(st.Pxii, sj.Pxii) <= 1e-9
    # the short MCRA window (L=3) lets MCRA's p move after its first 6 frames
    for short in (False, True):
        cj, ct = jcdr.McCdrConfig(nfft=256), tcdr.McCdrConfig(nfft=256)
        if short:
            cj, ct = J_SHORT[1](nfft=256).mccdr, T_SHORT[1](nfft=256).mccdr
        Fn = cj.fn_pair()
        sj = jcdr.mccdr_init(cj, (B,), cdtype=jnp.complex128)
        st = tcdr.mccdr_init(ct, (B,), cdtype=torch.complex128, device="cpu")
        top = 0.0
        for t in range(T):
            sj, gj = jcdr.mccdr_step(cj, jnp.asarray(Fn), sj, jnp.asarray(Y[t]))
            st, gt = tcdr.mccdr_step(ct, torch.as_tensor(Fn), st, torch.as_tensor(Y[t]))
            assert gt.dtype == torch.float64 and _rel(gt, gj) <= 1e-9
            top = max(top, float(gt.max()))
        # Gamma <= 1, so above sqrt(p_min) = 0.0316 MCRA's p has left its floor
        assert (top > 0.035) == short


@pytest.mark.parametrize("short", [False, True], ids=["default", "short_mcra"])
def test_mcspp_steps_match_jax_float64(short):
    """McSpp through its warm start, its repair loading and beyond; and the
    base tracker."""
    T, B, F = 14, 2, 129
    Y = _spectra(T, B, F, 4, 1)
    cj, ct = (J_SHORT[1], T_SHORT[1]) if short else (jspp.McSppConfig, tspp.McSppConfig)
    cj, ct = cj(nfft=256), ct(nfft=256)
    Fn = cj.mccdr.fn_pair()
    sj = jspp.mcspp_init(cj, (B,), cdtype=jnp.complex128)
    st = tspp.mcspp_init(ct, (B,), cdtype=torch.complex128, device="cpu")
    got, want = [], []
    for t in range(T):
        sj, oj = jspp.mcspp_step(cj, jnp.asarray(Fn), sj, jnp.asarray(Y[t]))
        st, ot = tspp.mcspp_step(ct, torch.as_tensor(Fn), st, torch.as_tensor(Y[t]))
        assert _rel(st.Phi_vv, sj.Phi_vv) <= 1e-9
        got.append(ot)
        want.append(oj)
    assert st.frm_cnt == int(sj.frm_cnt) == T
    # held over all frames: in the warm start Phi_xx = 0, so w is 0 on one
    # side and rounding-level on the other
    for g, w in zip(zip(*got), zip(*want)):
        assert _rel(torch.stack(g), np.stack(w)) <= 1e-9
    p = torch.stack([o.p for o in got]).numpy()
    assert ((p > 0.0) & (p < 1.0)).any()
    bj, bt = jspb.McSppBaseConfig(nfft=256), tspb.McSppBaseConfig(nfft=256)
    sj = jspb.mcspp_base_init(bj, (B,), cdtype=jnp.complex128)
    st = tspb.mcspp_base_init(bt, (B,), cdtype=torch.complex128, device="cpu")
    for t in range(T):
        sj, oj = jspb.mcspp_base_step(bj, sj, jnp.asarray(Y[t]))
        st, ot = tspb.mcspp_base_step(bt, st, torch.as_tensor(Y[t]))
        for g, w in zip(ot, oj):
            assert _rel(g, w) <= 1e-9


def test_mcspp_long_run_where_the_cdr_radicand_cancels():
    """250 frames (B5's length) at F=257 of a source 20 dB over the noise,
    the same on every mic: at the low bins the pair coherence meets the
    diffuse model, where the JAX package's expanded CDR radicand cancels.
    In float64 the port is JAX (<= 1e-9).  In float32 the port's p stays
    within K9's 2e-3 gate of its float64 p and JAX's does not, so a change
    to ``cdr_gamma`` that brings the cancellation back is seen."""
    T, B, nfft = 250, 2, 512
    F = nfft // 2 + 1
    rng = np.random.default_rng(0)
    src = rng.standard_normal((T, B, F, 1)) + 1j * rng.standard_normal((T, B, F, 1))
    env = np.repeat(rng.random((T // 10 + 1, 1, 1, 1)) < 0.5, 10, axis=0)[:T]
    Y = src * env + 0.1 * (rng.standard_normal((T, B, F, 4)) + 1j * rng.standard_normal((T, B, F, 4)))
    cj, ct = jspp.McSppConfig(nfft=nfft), tspp.McSppConfig(nfft=nfft)
    Fn = cj.mccdr.fn_pair()
    step = jax.jit(jspp.mcspp_step, static_argnums=0)
    p = {}
    for bits, cdj, cdt in ((64, jnp.complex128, torch.complex128), (32, jnp.complex64, torch.complex64)):
        sj = jspp.mcspp_init(cj, (B,), cdtype=cdj)
        st = tspp.mcspp_init(ct, (B,), cdtype=cdt, device="cpu")
        Fj, Ft = jnp.asarray(Fn, dtype=jnp.finfo(cdj).dtype), torch.as_tensor(Fn, dtype=cdt.to_real())
        pj, pt = [], []
        for t in range(T):
            sj, oj = step(cj, Fj, sj, jnp.asarray(Y[t], dtype=cdj))
            st, ot = tspp.mcspp_step(ct, Ft, st, torch.as_tensor(Y[t], dtype=cdt))
            pj.append(np.asarray(oj.p))
            pt.append(ot.p.numpy())
        if bits == 64:
            assert _rel(st.Phi_vv, sj.Phi_vv) <= 1e-9
        p[bits] = np.stack(pj).astype(np.float64), np.stack(pt).astype(np.float64)
    (j64, t64), (j32, t32) = p[64], p[32]
    assert _rel(t64, j64) <= 1e-9
    assert np.abs(t32 - t64).max() < 2e-3 < np.abs(j32 - j64).max()


def test_mcspp_float32_p_gap_to_jax():
    """The port's float32 McSpp p against JAX's float32 p, step by step, over
    48 frames at F=65 with the McCDR's MCRA window cut to L=3, so that p
    moves: the two differ only in the CDR radicand's form and in rounding.
    The gap is 2.2e-05 here, held below 1e-4; over B5's 250 frames at F=257
    JAX's radicand cancels and its float32 p leaves K9's 2e-3 gate of
    float64 (test_mcspp_long_run_where_the_cdr_radicand_cancels)."""
    T, B, nfft = 48, 2, 128
    Y = _spectra(T, B, nfft // 2 + 1, 4, 3)
    cj, ct = J_SHORT[1](nfft=nfft), T_SHORT[1](nfft=nfft)
    Fn = cj.mccdr.fn_pair()
    step = jax.jit(jspp.mcspp_step, static_argnums=0)
    sj = jspp.mcspp_init(cj, (B,), cdtype=jnp.complex64)
    st = tspp.mcspp_init(ct, (B,), cdtype=torch.complex64, device="cpu")
    Fj, Ft = jnp.asarray(Fn, dtype=jnp.float32), torch.as_tensor(Fn, dtype=torch.float32)
    pj, pt = [], []
    for t in range(T):
        sj, oj = step(cj, Fj, sj, jnp.asarray(Y[t], dtype=jnp.complex64))
        st, ot = tspp.mcspp_step(ct, Ft, st, torch.as_tensor(Y[t], dtype=torch.complex64))
        pj.append(np.asarray(oj.p))
        pt.append(ot.p.numpy())
    pj, pt = np.stack(pj), np.stack(pt)
    assert pt.dtype == np.float32 and ((pt > 0.05) & (pt < 0.95)).mean() > 0.2  # p moves
    assert np.abs(pt - pj).max() < 1e-4


def test_plain_k9_inverse_from_hermitian_storage():
    """K9's plain inverse and repair take the covariance in hermitian storage
    (the real diagonal, the 6 upper entries in csrc/sgsc.cu's order) and a
    load, and update only the columns a pivot changes: against the port's
    ``gauss_jordan_inv`` of the full complex matrix, float64; the repair's
    trace is Re tr(P Phi) - 4."""
    rng = np.random.default_rng(9)
    v = rng.standard_normal((5, 3, 6, 4)) + 1j * rng.standard_normal((5, 3, 6, 4))
    A = np.einsum("...si,...sj->...ij", v, v.conj())  # [5, 3, 4, 4] hermitian, positive definite
    iu, ju = np.triu_indices(4, 1)
    assert (tuple(iu), tuple(ju)) == cs._IU
    d, o = A.real[..., range(4), range(4)], A[..., iu, ju]
    load = rng.random((5, 1, 1))
    Pr, Pi, tr = cs._repair(*(torch.as_tensor(a) for a in (d, o.real, o.imag, A.real, A.imag, load)))
    want = tla.gauss_jordan_inv(torch.as_tensor(A + load[..., None] * np.eye(4))).numpy()
    assert _rel(Pr.numpy() + 1j * Pi.numpy(), want) <= 1e-12
    assert _rel(tr, np.trace(want @ A, axis1=-2, axis2=-1).real - 4.0) <= 1e-12


def test_subband_filters_match_jax_float64():
    T, B, F, C = 10, 2, 33, 3
    rng = np.random.default_rng(2)
    c1j, c1t = jsub.SubbandAfConfig(num_bands=64), tsub.SubbandAfConfig(num_bands=64)
    cmj = jsub.SubbandAfConfig(num_bands=64, n_channels=C, mu=0.01, alpha=0.8)
    cmt = tsub.SubbandAfConfig(num_bands=64, n_channels=C, mu=0.01, alpha=0.8)
    cx = lambda *s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    s1j, s1t = jsub.subband_lms_init(c1j, (B,), cdtype=jnp.complex128), tsub.subband_lms_init(c1t, (B,), torch.complex128, "cpu")
    smj, smt = jsub.subband_lms_init(cmj, (B,), cdtype=jnp.complex128), tsub.subband_lms_init(cmt, (B,), torch.complex128, "cpu")
    srj, srt = jsub.subband_rls_init(c1j, (B,), cdtype=jnp.complex128), tsub.subband_rls_init(c1t, (B,), torch.complex128, device="cpu")
    for t in range(T):
        x, d, xm, p = cx(B, F), cx(B, F), cx(B, F, C), rng.random((B, F))
        s1j, ej = jsub.subband_lms_step(c1j, s1j, jnp.asarray(x), jnp.asarray(d), p=jnp.asarray(p))
        s1t, et = tsub.subband_lms_step(c1t, s1t, torch.as_tensor(x), torch.as_tensor(d), p=torch.as_tensor(p))
        assert _rel(et, ej) <= 1e-9 and _rel(s1t.W, s1j.W) <= 1e-9
        smj, ej = jsub.subband_lms_mc_step(cmj, smj, jnp.asarray(xm), jnp.asarray(d), p=jnp.asarray(1 - p))
        smt, et = tsub.subband_lms_mc_step(cmt, smt, torch.as_tensor(xm), torch.as_tensor(d), p=torch.as_tensor(1 - p))
        assert _rel(et, ej) <= 1e-9 and _rel(smt.W, smj.W) <= 1e-9
        srj, ej = jsub.subband_rls_step(c1j, srj, jnp.asarray(x), jnp.asarray(d))
        srt, et = tsub.subband_rls_step(c1t, srt, torch.as_tensor(x), torch.as_tensor(d))
        assert _rel(et, ej) <= 1e-9 and _rel(srt.P, srj.P) <= 1e-9


def _scene(B, S, seed, dtype=np.float64):
    """Noise on every mic and, over frames 4-11, a loud burst from
    broadside (identical on every mic)."""
    rng = np.random.default_rng(seed)
    n = np.arange(S)
    env = ((n >= 4 * L) & (n < 12 * L)).astype(np.float64)
    return (rng.standard_normal((B, 1, S)) * env * 6.0 + rng.standard_normal((B, M, S))).astype(dtype)


@pytest.mark.parametrize("short", [False, True], ids=["default", "short_mcra"])
def test_scan_matches_jax_float64(short):
    """B=2 x 4 x 16 frames; with the short window p takes values strictly
    inside (0, 1) and the xi < 0 repair fires."""
    x = _scene(2, 16 * L, 3)
    cj, ct = (J_SHORT[0], T_SHORT[0]) if short else (jsg.SubbandGscConfig, tsg.SubbandGscConfig)
    want = jsg.subband_gsc_process(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, cj(n_mics=M))
    got = tsg.subband_gsc_process(x, TGeometry.linear(M, 0.032), ANG, ct(n_mics=M), device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and _rel(g, w) <= 1e-9
    p = got[1]
    assert bool(((p > 1e-3) & (p < 1 - 1e-3)).any())
    dec = cs.subband_gsc_frames_plain(*cs.front_end(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, ct(n_mics=M)),
                                      ct(n_mics=M), decisions=True)[3]
    assert bool((dec & cs.REPAIR).any())


@pytest.mark.parametrize("cfg", [tsg.SubbandGscConfig(n_mics=M), T_SHORT[0](n_mics=M, aic_warmup_frames=4, aic_freeze_thresh=0.5)],
                         ids=["default", "short_mcra_guards"])
def test_plain_matches_the_scan_float64(cfg):
    """In float64 the kernel's plain version is the scan's recursion."""
    x = _scene(2, 16 * L + 100, 4)  # a sub-frame tail is dropped
    got = cs.fused_subband_gsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, cfg)
    want = tsg.subband_gsc_process(x, TGeometry.linear(M, 0.032), ANG, cfg, device="cpu")
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9


def test_chained_step_matches_process():
    x = _scene(2, 10 * L, 5)
    geom = TGeometry.linear(M, 0.032)
    cfg = T_SHORT[0](n_mics=M, aic_warmup_frames=3)
    want = tsg.subband_gsc_process(x, geom, ANG, cfg, device="cpu")
    aligned = cf.aligned_mics(torch.as_tensor(x), geom, ANG)
    Fn = torch.as_tensor(cfg.spp.mccdr.fn_pair())
    state = tsg.subband_gsc_init(cfg, (2,), dtype=torch.float64, device="cpu")
    outs = []
    for t in range(10):
        state, out = tsg.subband_gsc_step(cfg, Fn, state, aligned[..., t * L : (t + 1) * L])
        outs.append(out)
    got = (torch.cat([o[0] for o in outs], -1), torch.stack([o[1] for o in outs], -2), torch.cat([o[2] for o in outs], -1))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9


def test_fused_backend_runs_the_plain_version_on_cpu():
    x = torch.as_tensor(_scene(3, 6 * L + 10, 6, np.float32))  # any B
    cfg = tsg.SubbandGscConfig(n_mics=M)
    cs.LAUNCHES["fused_subband_gsc"] = 0
    got = tsg.subband_gsc_process(x, TGeometry.linear(M, 0.032), ANG, cfg, backend="fused", device="cpu")
    want = cs.fused_subband_gsc_plain(x, TGeometry.linear(M, 0.032), ANG, cfg)
    assert cs.LAUNCHES["fused_subband_gsc"] == 0
    assert got[0].shape == (3, 6 * L) and got[1].shape == (3, 6, L + 1) and got[2].shape == (3, M, 6 * L)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    with pytest.raises(ValueError, match="n_mics"):
        tsg.subband_gsc_process(torch.zeros(1, 6, 4 * L), TGeometry.linear(6, 0.032), ANG,
                                tsg.SubbandGscConfig(n_mics=6), backend="fused", device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        tsg.subband_gsc_process(torch.zeros(1, 4, 4 * 96), TGeometry.linear(4, 0.032), ANG,
                                tsg.SubbandGscConfig(frame_len=96), backend="fused", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tsg.subband_gsc_process(x, TGeometry.linear(M, 0.032), ANG, cfg, backend="pallas", device="cpu")


def _as_dict(state):
    if hasattr(state, "_asdict"):
        return {k: _as_dict(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def test_handover_mid_run():
    """JAX runs 3 streaming frames in float64; its config and state carry
    into the port, whose next ``subband_gsc_step`` gives JAX's next output."""
    cj = jsg.SubbandGscConfig(n_mics=M, aic_warmup_frames=2)
    ct = convert.subband_gsc_config_from_dict(dataclasses.asdict(cj))
    assert ct == tsg.SubbandGscConfig(n_mics=M, aic_warmup_frames=2)
    assert convert.srp_config_from_dict({"n_fft": 512, "resolution": 2}).stft.hop == 256
    al = np.random.default_rng(7).standard_normal((4, 2, M, L))
    Fn = cj.spp.mccdr.fn_pair()
    sj = jsg.subband_gsc_init(cj, (2,), dtype=jnp.float64)
    step = jax.jit(jsg.subband_gsc_step, static_argnums=0)
    for t in range(3):
        sj, _ = step(cj, jnp.asarray(Fn), sj, jnp.asarray(al[t]))
    _, want = step(cj, jnp.asarray(Fn), sj, jnp.asarray(al[3]))
    st = convert.subband_gsc_state_from_numpy(_as_dict(sj), device="cpu")
    assert st.core.spp.frm_cnt == 3 and st.core.spp.mccdr.mcra.frm_cnt == 3 and st.core.aic.W.shape == (2, L + 1, 2, M)
    _, got = tsg.subband_gsc_step(ct, torch.as_tensor(Fn), st, torch.as_tensor(al[3]))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9
