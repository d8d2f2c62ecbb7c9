"""Kernel K9: the fused subband GSC frame loop.

Counterpart of ``distantspeech_tpu/ops/pallas_sgsc.py``: the CUDA kernel of
``csrc/sgsc.cu`` replaces the Pallas kernel ``_sgsc_kernel`` (called by
``fused_subband_gsc``).  Per frame of frame_len samples and per bin: the
McCDR pair-(1, 2) coherence and its MCRA track, McSpp's Phi_yy / Phi_vv
4x4 hermitian recursions with two Gauss-Jordan inverses (the second, the
repair, only where xi < 0), xi / gamma / p, the per-mic 2-tap subband NLMS
blocking matrix (p-gated), the BM synthesis and the AIC-input analysis, the
multichannel 2-tap NLMS AIC ((1 - p)-gated) and the output overlap-add.

``fused_subband_gsc`` is ``subband_gsc_process(backend="fused")``.  The
input-only front end is plain PyTorch outside the kernel, as in JAX: DC
notch, alignment FIR, fixed beamformer (channel mean) and MCRA's 3-tap
frequency smoothing of the mic-0 STFT power.  ``subband_gsc_frames`` runs
the frame recursion: on a CPU tensor its plain version
``subband_gsc_frames_plain``, on a CUDA tensor the kernel (or it raises).

The plain version repeats the kernel's lane arithmetic: the covariances in
hermitian storage (the real diagonal and the 6 upper entries), the inverses
in ``stats.linalg.gauss_jordan_inv``'s elimination order without pivoting,
the repair inverse only on the lanes where xi < 0, and the loading from one
q-band mean a frame.  It does every transform as one dense product against
the packed sqrt-Hann matrices (``cuda_flms.windowed_dft_packed``, the
synthesis gain folded in); the kernel does them as warp-owned radix-8 FFTs
on real pairs packed into complex ones (``csrc/flms_fft.cuh``).  So
``chip_smoke.py`` can count the elementwise work a frame needs on it.  The
TPU's 384-lane padding, its ``sub`` row tiling, the VMEM-fit ``t_chunk``
and the split real / imaginary planes are dropped; any B >= 1 is taken,
M = 4 only (McSpp's CDR is the 4-channel one); the kernel takes frame_len
64, 128 and 256 (a thread a bin of its 512-thread block).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from distantspeech_tpu_torch._device import wrapper_input
from distantspeech_tpu_torch.noise.mccdr import cdr_gamma
from distantspeech_tpu_torch.noise.mcra import _freq_smooth
from distantspeech_tpu_torch.ops import _build
from distantspeech_tpu_torch.ops.cuda_enhance import _bin_masks, _mcra_frame
from distantspeech_tpu_torch.ops.cuda_flms import _pack, _twiddles, _unpack, aligned_mics, windowed_dft_packed
from distantspeech_tpu_torch.ops.cuda_mvdr import _mcra_params, _McraParams
from distantspeech_tpu_torch.transform.stft import StftConfig, stft_frames

LAUNCHES = {"fused_subband_gsc": 0}
AF_EPS = 1e-4  # the subband NLMS power floor (subband_lms_step's eps)
REPAIR, OVER_DELTA = 1, 2  # decision bits: the xi < 0 repair ran; MCRA's S / Smin > delta_s


def _default_cfg():
    from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig

    return SubbandGscConfig()


def _check(x: torch.Tensor, cfg):
    """Validate x [B, 4, S] and the layout; return x cut to T whole frames."""
    L = cfg.frame_len
    if x.ndim != 3 or x.shape[1] != 4 or cfg.n_mics != 4:
        raise ValueError(f"fused_subband_gsc needs x [B, 4, S] and n_mics == 4 (McSpp's CDR is 4-channel), "
                         f"got {tuple(x.shape)}, n_mics={cfg.n_mics}")
    if L < 64 or L & (L - 1):
        raise ValueError(f"fused_subband_gsc needs frame_len a power of two >= 64, got {L}")
    T = x.shape[-1] // L
    if T < 1:
        raise ValueError(f"x needs at least one frame ({L} samples)")
    return x[..., : T * L]


def front_end(x: torch.Tensor, geometry, angle_rad, cfg):
    """The frame loop's inputs from x [B, 4, S']: sig [B, 5, S'] (the
    aligned mics, then the fixed beamformer) and MCRA's smoothed mic-0 STFT
    power sf [B, T, F]."""
    aligned = aligned_mics(x, geometry, angle_rad)
    scfg = cfg.stft
    D0 = stft_frames(torch.nn.functional.pad(aligned[:, 0], (scfg.overlap, 0)), scfg)
    sf = _freq_smooth(D0.real**2 + D0.imag**2, cfg.spp.mccdr.mcra.b)
    return torch.cat([aligned, aligned.mean(dim=1, keepdim=True)], dim=1), sf


def _cmulc(ar, ai, br, bi):
    """a * conj(b) on (re, im) planes."""
    return ar * br + ai * bi, ai * br - ar * bi


# the upper off-diagonal entries (i < j) of a hermitian 4x4 in the order of
# csrc/sgsc.cu's off(i, j): (0,1), (0,2), (0,3), (1,2), (1,3), (2,3)
_IU = ((0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3))


def _full(d, o_r, o_i):
    """Hermitian storage (real diagonal d [..., 4], upper entries o [..., 6])
    -> the full matrix as (re, im) planes [..., 4, 4]."""
    i, j = _IU
    Ar = torch.diag_embed(d)
    Ai = torch.zeros_like(Ar)
    Ar[..., i, j] = o_r
    Ar[..., j, i] = o_r
    Ai[..., i, j] = o_i
    Ai[..., j, i] = -o_i
    return Ar, Ai


def _inv4(d, o_r, o_i, load):
    """P = (A + load I)^-1 for the hermitian A (d, o): Gauss-Jordan on
    [A | I] in ``gauss_jordan_inv``'s order without pivoting; the pivot row
    divides as a conj(b) / |b|^2.  Pivot k updates only the 3 other rows and
    the columns k+1 .. 4+k: the columns left of them already hold unit
    vectors and those right of them zeros, which the step leaves as they
    are."""
    n = d.shape[-1]
    Ar, Ai = _full(d + load, o_r, o_i)
    eye = torch.eye(n, dtype=d.dtype, device=d.device).expand(Ar.shape)
    wr, wi = torch.cat([Ar, eye], dim=-1), torch.cat([Ai, torch.zeros_like(eye)], dim=-1)
    for k in range(n):
        rows, cols = [r for r in range(n) if r != k], slice(k + 1, n + k + 1)
        br, bi = wr[..., k, k, None], wi[..., k, k, None]
        den = br * br + bi * bi
        ar, ai = wr[..., k, cols], wi[..., k, cols]
        rr, ri = (ar * br + ai * bi) / den, (ai * br - ar * bi) / den
        cr, ci = wr[..., rows, k, None], wi[..., rows, k, None]
        wr[..., rows, cols] = wr[..., rows, cols] - (cr * rr[..., None, :] - ci * ri[..., None, :])
        wi[..., rows, cols] = wi[..., rows, cols] - (cr * ri[..., None, :] + ci * rr[..., None, :])
        wr[..., k, cols], wi[..., k, cols] = rr, ri
    return wr[..., n:], wi[..., n:]


def _trace_re(Pr, Pi, Yr, Yi):
    """Re tr(P Y) - 4."""
    return torch.sum(Pr * Yr.transpose(-1, -2) - Pi * Yi.transpose(-1, -2), dim=(-2, -1)) - 4.0


def _repair(d, o_r, o_i, Yr, Yi, load):
    """The repair on the lanes that take it (xi < 0): P = (Phi_yy + load I)^-1
    from Phi_yy's hermitian storage (d, o) and Re tr(P Phi_yy) - 4 against
    its full planes (Yr, Yi).  Returns (Pr, Pi, the trace)."""
    Pr, Pi = _inv4(d, o_r, o_i, load)
    return Pr, Pi, _trace_re(Pr, Pi, Yr, Yi)


def subband_gsc_frames_plain(sig: torch.Tensor, sf: torch.Tensor, cfg, decisions: bool = False):
    """Plain version of the K9 kernel: the subband GSC frame recursion.

    sig [B, 5, S'] aligned mics then FBF, sf [B, T, F] MCRA's smoothed
    mic-0 power.  Returns (out [B, S'], p [B, T, F], bm [B, 4, S']) in
    sig's dtype; with ``decisions`` also dec [B, T, F] uint8, the bits
    REPAIR (xi < 0: the repair inverse was taken) and OVER_DELTA (MCRA's
    S / Smin > delta_s)."""
    sp, mc, bcfg, acfg = cfg.spp, cfg.spp.mccdr.mcra, cfg.bm, cfg.aic
    B, _, S = sig.shape
    L = hop = cfg.frame_len
    M, T, F = 4, S // L, L + 1
    dt, dev = sig.dtype, sig.device
    CSW, ABW = (torch.as_tensor(m, dtype=dt, device=dev) for m in windowed_dft_packed(2 * L, L))
    blocks = torch.nn.functional.pad(sig, (hop, 0)).reshape(B, M + 1, T + 1, hop)
    Zr, Zi = _unpack(torch.cat([blocks[:, :, :-1], blocks[:, :, 1:]], dim=-1) @ CSW, F)  # [B, 5, T, F], input-only
    Fn = torch.as_tensor(sp.mccdr.fn_pair(), dtype=dt, device=dev)
    lo, hi = sp.qband
    iu, ju = _IU

    bins = _bin_masks(F, dev)
    zero = sig.new_zeros((B, F))
    st = dict(S=zero, Smin=zero, Stmp=zero, P=zero, Lam=zero)
    m11 = m22 = m12r = m12i = zero
    Yd = Vd = sig.new_zeros((B, F, M))  # Phi_yy, Phi_vv in hermitian storage: the real diagonal,
    Yor = Yoi = Vor = Voi = sig.new_zeros((B, F, 6))  # the upper off-diagonal entries (re, im)
    zc = sig.new_zeros((B, M, F))
    Wb = [zc] * 4  # BM W0 re, W0 im, W1 re, W1 im  [B, 4, F]
    Wa = [zc] * 4  # AIC
    Ur_prev = Ui_prev = zc
    Pbm = Paic = zero
    XPr = XPi = zero
    ola_bm, u_prev, ola_out = sig.new_zeros((B, M, hop)), sig.new_zeros((B, M, hop)), sig.new_zeros((B, hop))
    out, p_out, bm_out = sig.new_empty((B, T, hop)), sig.new_empty((B, T, F)), sig.new_empty((B, M, T, hop))
    dec = torch.empty((B, T, F), dtype=torch.uint8, device=dev) if decisions else None
    for t in range(T):
        dr, di = Zr[:, :M, t], Zi[:, :M, t]  # [B, 4, F]
        Xr, Xi = Zr[:, M, t], Zi[:, M, t]

        # ---- McCDR: the pair-(1, 2) coherence and MCRA on mic 0
        a = sp.mccdr.alpha_msc
        m11 = a * m11 + (1.0 - a) * (dr[:, 1] ** 2 + di[:, 1] ** 2)
        m22 = a * m22 + (1.0 - a) * (dr[:, 2] ** 2 + di[:, 2] ** 2)
        cr, ci = _cmulc(dr[:, 1], di[:, 1], dr[:, 2], di[:, 2])
        m12r, m12i = a * m12r + (1.0 - a) * cr, a * m12i + (1.0 - a) * ci
        den = torch.sqrt(m11 * m22)
        G = cdr_gamma(Fn, m12r / den, m12i / den)
        p_mcra, _, sr = _mcra_frame(t, dr[:, 0] ** 2 + di[:, 0] ** 2, sf[:, t], st, bins, mc)
        q = 1.0 - torch.sqrt(G * p_mcra)

        # ---- the adaptive loading from the q band's mean (before the warm pin)
        q_avg = torch.sum(q[:, lo:hi], dim=-1, keepdim=True) / float(hi - lo)
        dval = (q_avg * sp.diag_max + (1.0 - q_avg) * sp.diag_min)[..., None]  # [B, 1, 1]

        # ---- Phi_yy; Phi_vv tracks it while warm
        warm = t < sp.warmup_frames
        er, ei = dr.transpose(1, 2), di.transpose(1, 2)  # [B, F, 4]
        psd_d = er * er + ei * ei
        psd_or, psd_oi = _cmulc(er[..., iu], ei[..., iu], er[..., ju], ei[..., ju])
        Yd = sp.alpha * Yd + (1.0 - sp.alpha) * psd_d
        Yor = sp.alpha * Yor + (1.0 - sp.alpha) * psd_or
        Yoi = sp.alpha * Yoi + (1.0 - sp.alpha) * psd_oi
        if warm:
            Vd, Vor, Voi = Yd, Yor, Yoi
            q = torch.full_like(q, 0.99)
        Yr, Yi = _full(Yd, Yor, Yoi)

        # ---- the estimation core: the repair only on the lanes where xi < 0
        Pr, Pi = _inv4(Vd, Vor, Voi, dval)
        tr = _trace_re(Pr, Pi, Yr, Yi)
        neg = tr < 0.0
        load = dval.expand(B, F, 1)[neg] if t < sp.repair_frames else 0.0
        Pr[neg], Pi[neg], tr[neg] = _repair(Yd[neg], Yor[neg], Yoi[neg], Yr[neg], Yi[neg], load)
        xi = torch.clamp(tr, 1e-6, 1e8)
        # gamma = y^H P Phi_yy P y - y^H P y
        lr = torch.sum(er[..., :, None] * Pr + ei[..., :, None] * Pi, dim=-2)  # conj(y)_k P[k][j]
        li = torch.sum(er[..., :, None] * Pi - ei[..., :, None] * Pr, dim=-2)
        rr = torch.sum(Pr * er[..., None, :] - Pi * ei[..., None, :], dim=-1)  # P[j][k] y_k
        ri = torch.sum(Pr * ei[..., None, :] + Pi * er[..., None, :], dim=-1)
        hr = torch.sum(Yr * rr[..., None, :] - Yi * ri[..., None, :], dim=-1)  # Phi_yy P y
        hi_ = torch.sum(Yr * ri[..., None, :] + Yi * rr[..., None, :], dim=-1)
        t1 = torch.sum(lr * hr - li * hi_, dim=-1)
        t2 = torch.sum(lr * er - li * ei, dim=-1)
        gamma = torch.clamp(t1 - t2, 1e-6, 1e8)
        ratio = q / (1.0 - q) * (1.0 + xi) * torch.exp(-(gamma / (1.0 + xi)))
        p = torch.clamp(torch.where(q >= 1.0, 0.0, 1.0 / (1.0 + ratio)), 0.0, 1.0)
        p_out[:, t] = p
        if decisions:
            dec[:, t] = neg.to(torch.uint8) * REPAIR + (sr > mc.delta_s).to(torch.uint8) * OVER_DELTA

        # ---- the noise update
        at = (sp.alpha_d + (1.0 - sp.alpha_d) * p)[..., None]
        one_m_at = 1.0 - at
        Vd = at * Vd + one_m_at * psd_d
        Vor = at * Vor + one_m_at * psd_or
        Voi = at * Voi + one_m_at * psd_oi

        # ---- blocking matrix: per-mic 2-tap subband NLMS, p-gated
        pbuf = Xr * Xr + Xi * Xi + XPr * XPr + XPi * XPi
        Pbm = bcfg.alpha * Pbm + (1.0 - bcfg.alpha) * pbuf
        xr, xi_, xpr, xpi = Xr[:, None], Xi[:, None], XPr[:, None], XPi[:, None]
        y0 = _cmulc(xr, xi_, Wb[0], Wb[1])
        y1 = _cmulc(xpr, xpi, Wb[2], Wb[3])
        pc = p[:, None]
        e_r, e_i = dr - (y0[0] + y1[0]) * pc, di - (y0[1] + y1[1]) * pc
        scale = (2.0 * bcfg.mu * p / (Pbm + AF_EPS))[:, None]
        g0, g1 = _cmulc(xr, xi_, e_r, e_i), _cmulc(xpr, xpi, e_r, e_i)
        Wb = [Wb[0] + g0[0] * scale, Wb[1] + g0[1] * scale, Wb[2] + g1[0] * scale, Wb[3] + g1[1] * scale]

        # ---- BM synthesis, then the AIC input analysis
        fr = _pack(e_r, e_i) @ ABW  # [B, 4, 2L]
        blk = ola_bm + fr[..., :hop]
        ola_bm = fr[..., hop:]
        bm_out[:, :, t] = blk
        Ur, Ui = _unpack(torch.cat([u_prev, blk], dim=-1) @ CSW, F)
        u_prev = blk

        # ---- AIC: multichannel 2-tap subband NLMS, (1 - p)-gated
        gate = 1.0 - p
        if cfg.aic_freeze_thresh > 0.0:
            gate = gate * (p <= cfg.aic_freeze_thresh)
        if cfg.aic_warmup_frames > 0:
            gate = gate * float(t >= cfg.aic_warmup_frames)
        a0, a1 = _cmulc(Ur, Ui, Wa[0], Wa[1]), _cmulc(Ur_prev, Ui_prev, Wa[2], Wa[3])
        yr, yi = torch.sum(a0[0] + a1[0], dim=1), torch.sum(a0[1] + a1[1], dim=1)
        pw = torch.sum(Ur * Ur + Ui * Ui + Ur_prev * Ur_prev + Ui_prev * Ui_prev, dim=1)
        ar_, ai_ = XPr - yr * gate, XPi - yi * gate  # desired: the delayed FBF, X_{t-1}
        Paic = acfg.alpha * Paic + (1.0 - acfg.alpha) * pw / float(M)
        scale = (2.0 * acfg.mu * gate / (Paic + AF_EPS))[:, None]
        g0 = _cmulc(Ur, Ui, ar_[:, None], ai_[:, None])
        g1 = _cmulc(Ur_prev, Ui_prev, ar_[:, None], ai_[:, None])
        Wa = [Wa[0] + g0[0] * scale, Wa[1] + g0[1] * scale, Wa[2] + g1[0] * scale, Wa[3] + g1[1] * scale]
        Ur_prev, Ui_prev = Ur, Ui

        fr = _pack(ar_, ai_) @ ABW
        out[:, t] = ola_out + fr[:, :hop]
        ola_out = fr[:, hop:]
        XPr, XPi = Xr, Xi
    res = (out.reshape(B, T * hop), p_out, bm_out.reshape(B, M, T * hop))
    return (*res, dec) if decisions else res


def fused_subband_gsc_plain(x, geometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg=None):
    """Plain version of ``fused_subband_gsc`` (any float dtype, any device)."""
    cfg = _default_cfg() if cfg is None else cfg
    return subband_gsc_frames_plain(*front_end(_check(torch.as_tensor(x), cfg), geometry, angle_rad, cfg), cfg)


# ---- the CUDA side ----------------------------------------------------------


class _SgscParams(ctypes.Structure):
    """Mirror of ``SgscParams`` in csrc/sgsc.cu (field order and types must
    match); derived constants are computed here in double."""

    _fields_ = [
        ("mc", _McraParams),
        ("msc_alpha", ctypes.c_float), ("msc_one_m_alpha", ctypes.c_float),
        ("sp_alpha", ctypes.c_float), ("sp_one_m_alpha", ctypes.c_float),
        ("sp_alpha_d", ctypes.c_float), ("sp_one_m_alpha_d", ctypes.c_float),
        ("diag_min", ctypes.c_float), ("diag_max", ctypes.c_float),
        ("warmup", ctypes.c_int), ("repair", ctypes.c_int), ("q_lo", ctypes.c_int), ("q_hi", ctypes.c_int),
        ("bm_alpha", ctypes.c_float), ("bm_one_m_alpha", ctypes.c_float), ("bm_mu2", ctypes.c_float),
        ("aic_alpha", ctypes.c_float), ("aic_one_m_alpha", ctypes.c_float), ("aic_mu2", ctypes.c_float),
        ("af_eps", ctypes.c_float), ("freeze", ctypes.c_float), ("aic_warmup", ctypes.c_int),
    ]


def _sgsc_params(cfg) -> _SgscParams:
    sp, bcfg, acfg = cfg.spp, cfg.bm, cfg.aic
    lo, hi = sp.qband
    return _SgscParams(
        mc=_mcra_params(sp.mccdr.mcra),
        msc_alpha=sp.mccdr.alpha_msc, msc_one_m_alpha=1.0 - sp.mccdr.alpha_msc,
        sp_alpha=sp.alpha, sp_one_m_alpha=1.0 - sp.alpha, sp_alpha_d=sp.alpha_d, sp_one_m_alpha_d=1.0 - sp.alpha_d,
        diag_min=sp.diag_min, diag_max=sp.diag_max,
        warmup=sp.warmup_frames, repair=sp.repair_frames, q_lo=lo, q_hi=hi,
        bm_alpha=bcfg.alpha, bm_one_m_alpha=1.0 - bcfg.alpha, bm_mu2=2.0 * bcfg.mu,
        aic_alpha=acfg.alpha, aic_one_m_alpha=1.0 - acfg.alpha, aic_mu2=2.0 * acfg.mu,
        af_eps=AF_EPS, freeze=cfg.aic_freeze_thresh, aic_warmup=cfg.aic_warmup_frames,
    )


@functools.lru_cache(maxsize=16)
def _tables(L: int, device) -> torch.Tensor:
    """[3 N + F] float32, N = 2 L: the FFT twiddles; the sqrt-Hann analysis
    window; the synthesis window with the hop / W0 gain and the inverse
    FFT's 1 / N folded in; McSpp's diffuse pair coherence Fn."""
    from distantspeech_tpu_torch.noise.mcspp import McSppConfig

    N = 2 * L
    scfg = StftConfig(N, L)
    win = scfg.window
    fn = McSppConfig(nfft=N).mccdr.fn_pair()
    tabs = np.concatenate([_twiddles(N), win, win * scfg.synthesis_gain / N, fn])
    return torch.as_tensor(tabs, dtype=torch.float32, device=device)


def _library() -> ctypes.CDLL:
    lib = _build.load("sgsc")
    if not getattr(lib, "_signatures_set", False):
        lib.fused_sgsc_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        lib.fused_sgsc_launch.restype = ctypes.c_int
        lib._signatures_set = True
    return lib


def subband_gsc_frames(sig: torch.Tensor, sf: torch.Tensor, cfg, decisions: bool = False):
    """The K9 kernel: ``subband_gsc_frames_plain``'s recursion, one block per
    utterance.  CPU tensors run ``subband_gsc_frames_plain``; CUDA tensors
    launch the kernel (float32, contiguous) or raise."""
    if sig.device.type == "cpu":
        return subband_gsc_frames_plain(sig, sf, cfg, decisions)
    _build.check_tensors("fused_subband_gsc", sig, sf)
    B, C, S = sig.shape
    L = cfg.frame_len
    T, F = S // L, L + 1
    if C != 5 or S % L or sf.shape != (B, T, F):
        raise ValueError("fused_subband_gsc: sig must be [B, 5, S'] with S' whole frames and sf [B, T, F]")
    if L not in (64, 128, 256):
        raise ValueError(f"fused_subband_gsc: the kernel takes frame_len 64, 128 or 256, got {L}")
    dev = sig.device
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    p = torch.empty((B, T, F), dtype=torch.float32, device=dev)
    bm = torch.empty((B, 4, S), dtype=torch.float32, device=dev)
    dec = torch.empty((B, T, F), dtype=torch.uint8, device=dev)
    params = _sgsc_params(cfg)
    err = _library().fused_sgsc_launch(
        sig.data_ptr(), sf.data_ptr(), _tables(L, dev).data_ptr(), out.data_ptr(), p.data_ptr(), bm.data_ptr(),
        dec.data_ptr(), B, T, L, ctypes.addressof(params), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch("sgsc", err, "fused_subband_gsc")
    LAUNCHES["fused_subband_gsc"] += 1
    return (out, p, bm, dec) if decisions else (out, p, bm)


def fused_subband_gsc(x, geometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg=None):
    """Fused subband GSC: x [B, 4, S] -> (out [B, S'], p [B, T, F],
    bm [B, 4, S']), like ``beamform.subband_gsc.subband_gsc_process``.  The
    front end runs as plain PyTorch, the frame loop in
    ``subband_gsc_frames``.  A tensor stays on its device; other inputs go
    to the card."""
    cfg = _default_cfg() if cfg is None else cfg
    sig, sf = front_end(_check(wrapper_input(x), cfg), geometry, angle_rad, cfg)
    return subband_gsc_frames(sig.contiguous(), sf.contiguous(), cfg)
