"""Kernels K5, K6 and K8: the fused FLMS frame loops of the GSC family.

Counterparts of ``distantspeech_tpu/ops/pallas_flms.py``:

- K5 ``fused_tdgsc`` (``csrc/flms.cu``), below;
- K6 ``fused_kws`` (``csrc/kws.cu``) replaces ``_kws_kernel``: the
  dual-mic KWS cleaner, an FLMS ANC whose taps a frozen cleaner applies
  Dn frames late through a circular FIFO (``kws.dual_mic.kws_process``);
- K8 ``fused_fdgsc`` (``csrc/fdgsc.cu``) replaces ``_fdgsc_kernel``: the
  FDGSC core, MCRA (L=60) with the low-bin p pinning, M CCAF-clamped
  blocking-matrix FLMS filters and the norm-constrained AIC
  (``beamform.fdgsc.fdgsc_process``).  Its front end (notch, alignment,
  FBF, the reference-channel STFT power, the causality delays) is plain
  PyTorch, as in JAX.

Each ``*_frames`` function runs a kernel's frame recursion: on a CPU tensor
its plain version ``*_frames_plain``, on a CUDA tensor the kernel (or it
raises).  What is said below of K5's bins and transforms holds for all
three.

K5: the CUDA kernels of ``csrc/flms.cu`` replace the Pallas kernels
``_tdgsc_kernel`` (MCRA on the fixed-beamformer power gating a non-causal
multichannel overlap-save FLMS canceller) and ``_tdgsc_pf_kernel`` (the
same plus the OM-LSA-multi postfilter: a windowed STFT of the canceller
output, 1 + C MCRA trackers, the TBRR absence probability and
decision-directed gain, sqrt(G), and the windowed ISTFT overlap-add).

``fused_tdgsc`` is ``tdgsc_process(backend="fused")``.  The bulk
preprocessing is plain PyTorch outside the kernel, as in the JAX package:
DC notch, alignment FIR, fixed beamformer (channel mean) and pairwise
blocking matrix, the FBF STFT power that MCRA reads, the blocking-matrix
STFT powers of the postfilter, and the desired signal delayed by
filter_len / 2.  ``tdgsc_frames`` runs the frame recursion: on a CPU
tensor its plain version ``tdgsc_frames_plain``, on a CUDA tensor the
kernel (or it raises).

All F = n_fft/2 + 1 bins are uniform lanes; the TPU kernel's packing (the
Nyquist bin in imag lane 0, the postfilter's Nyquist lane slots) is not
needed.  Its edge semantics stay: the Nyquist bin's p is pinned at p_min
and so its FLMS gate at 1 - p_min, bins 0 and F-1 keep the ``vad_guard``
open (MCRA never updates their S), the postfilter's Nyquist MCRA is the
pinned closed form, and the OM-LSA smoothing is zero-padded.

The plain version computes every transform as a dense product against the
packed DFT matrices of the JAX kernel (``plain_dft_packed``,
``windowed_dft_packed``); K5 and K8 compute them as FFTs owned by one warp
or a warp pair, two real transforms packed into each complex one
(``csrc/flms_fft.cuh``), K6 as the block-wide radix-2 FFT of
``csrc/flms_lane.cuh``.  The two round differently; the canceller's
small-step LMS does not compound the gap.  The TPU knobs ``t_chunk``,
``sub``, ``unroll`` and ``_stages`` are dropped (the result does not depend
on them), and any B >= 1 is taken.
"""

from __future__ import annotations

import ctypes
import functools
import numpy as np
import torch

from distantspeech_tpu_torch._device import wrapper_input
from distantspeech_tpu_torch.adaptive.feature import dc_notch, dc_notch_init
from distantspeech_tpu_torch.array.alignment import time_alignment_filters
from distantspeech_tpu_torch.noise.mcra import _freq_smooth
from distantspeech_tpu_torch.noise.omlsa import omlsa_init, omlsa_step
from distantspeech_tpu_torch.ops import _build
from distantspeech_tpu_torch.ops.cuda_enhance import _bin_masks, _mcra_frame
from distantspeech_tpu_torch.ops.cuda_mvdr import _mcra_params, _McraParams
from distantspeech_tpu_torch.ops.fir import fir_filter_offline
from distantspeech_tpu_torch.transform.stft import StftConfig, _dft_matrices, _idft_matrices, stft_frames

LAUNCHES = {"fused_tdgsc": 0, "fused_kws": 0, "fused_fdgsc": 0}
_KERNEL_CHANNELS = range(1, 8)  # C = M - 1 the K5 templates are instantiated for: 1 to 7
_FDGSC_MICS = range(2, 9)  # M the K8 templates are instantiated for: 2 to 8
FDGSC_MAXNORM = 0.003  # the FDGSC AIC's filter-norm ceiling (aic_step's default)


@functools.lru_cache(maxsize=None)
def plain_dft_packed(n_fft: int):
    """Packed plain (unwindowed) rDFT matrices (CS [n_fft, n_fft],
    AB [n_fft, n_fft], float64) with fl = n_fft // 2 and the column / row
    order [re 0..fl-1 | re Nyquist | im 1..fl-1]: the structurally zero sin
    columns of k = 0 and k = fl are dropped."""
    fl = n_fft // 2
    F = fl + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(F)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    cos, sin = np.cos(ang), np.sin(ang)
    CS = np.concatenate([cos[:, :fl], cos[:, fl:], sin[:, 1:fl]], axis=1)

    kk = np.arange(F)[:, None]
    tt = np.arange(n_fft)[None, :]
    ang2 = 2.0 * np.pi * kk * tt / n_fft
    scale = np.full((F, 1), 2.0)
    scale[0] = 1.0
    scale[-1] = 1.0
    A = np.cos(ang2) * scale / n_fft
    Bm = -np.sin(ang2) * scale / n_fft
    AB = np.concatenate([A[:fl], A[fl:], Bm[1:fl]], axis=0)
    return CS, AB


@functools.lru_cache(maxsize=None)
def windowed_dft_packed(n_fft: int, hop: int, fold_gain: bool = True):
    """Packed sqrt-Hann windowed analysis / synthesis matrices in the layout
    of ``plain_dft_packed`` (the STFT's matrices, column / row packed).
    With ``fold_gain`` the hop / W0 synthesis scale is folded into ABW."""
    cfg = StftConfig(n_fft, hop)
    fl = n_fft // 2
    C, Sn = _dft_matrices(cfg)
    CSW = np.concatenate([C, Sn[:, 1:fl]], axis=1)
    A, Bm = _idft_matrices(cfg)
    ABW = np.concatenate([A, Bm[1:fl]], axis=0)
    if fold_gain:
        ABW = ABW * cfg.synthesis_gain
    return CSW, ABW


def _unpack(Z: torch.Tensor, F: int):
    """Packed [..., n_fft] -> (re, im), each [..., F], with the exact zero
    imaginary parts of bins 0 and F-1."""
    zero = torch.zeros_like(Z[..., :1])
    return Z[..., :F], torch.cat([zero, Z[..., F:], zero], dim=-1)


def _pack(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.cat([re, im[..., 1:-1]], dim=-1)


def _check(x: torch.Tensor, cfg):
    """Validate x [B, M, S] and the layout; return x cut to T whole frames."""
    acfg = cfg.aic
    Lf, hop, n_fft = acfg.filter_len, acfg.hop, acfg.n_fft
    if x.ndim != 3 or x.shape[1] != cfg.n_mics:
        raise ValueError(f"fused_tdgsc needs x [B, M={cfg.n_mics}, S], got {tuple(x.shape)}")
    if hop != Lf or n_fft != 2 * Lf or Lf & (Lf - 1):
        raise ValueError(
            f"fused_tdgsc needs hop == filter_len a power of two and n_fft == 2 filter_len "
            f"(got L={Lf}, hop={hop}, n_fft={n_fft})"
        )
    T = x.shape[-1] // Lf
    if T < 1:
        raise ValueError(f"x needs at least one frame ({Lf} samples)")
    return x[..., : T * Lf]


def aligned_mics(x: torch.Tensor, geometry, angle_rad) -> torch.Tensor:
    """The DC notch (radius 0.98) and fractional-delay alignment of x
    [..., M, S]."""
    _, xn = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype, device=x.device), x, radius=0.98)
    coeffs = torch.as_tensor(time_alignment_filters(geometry, angle_rad), dtype=x.dtype, device=x.device)
    return fir_filter_offline(xn, coeffs)


def front_end(x: torch.Tensor, geometry, angle_rad, cfg):
    """The TDGSC's frame-independent front end over a whole signal:
    ``aligned_mics``, fixed beamformer (channel mean) and pairwise-difference
    blocking matrix.  x: [..., M, S] -> (fbf [..., S], bm [..., M-1, S])."""
    aligned = aligned_mics(x, geometry, angle_rad)
    return aligned.mean(dim=-2), aligned[..., :-1, :] - aligned[..., 1:, :]


def _kernel_inputs(fbf: torch.Tensor, bm: torch.Tensor, cfg):
    """The frame loop's inputs from the front end: the desired signal (FBF
    delayed by filter_len / 2), the FBF STFT power [B, T, F] and, with the
    postfilter, the blocking-matrix STFT powers [B, C, T, F] (None
    without)."""
    Lf, scfg = cfg.frame_len, cfg.stft
    S = fbf.shape[-1]
    d = torch.nn.functional.pad(fbf, (Lf // 2, 0))[..., :S]
    D = stft_frames(torch.nn.functional.pad(fbf, (scfg.overlap, 0)), scfg)
    yp = D.real**2 + D.imag**2
    up = None
    if cfg.postfilter:
        U = stft_frames(torch.nn.functional.pad(bm, (scfg.overlap, 0)), scfg)
        up = U.real**2 + U.imag**2
    return d, yp, up


def tdgsc_frames_plain(bm: torch.Tensor, d: torch.Tensor, yp: torch.Tensor, up, cfg):
    """Plain version of the K5 kernel: the TDGSC frame recursion.

    bm [B, C, S'] blocking-matrix outputs, d [B, S'] delayed FBF, yp
    [B, T, F] FBF power, up [B, C, T, F] blocking-matrix powers (postfilter
    only, else None).  Per frame: MCRA on yp gates (1 - p, and the raw
    S/Smin <= delta_s with ``vad_guard``) the non-causal overlap-save FLMS
    whose taps w [B, C, Lf] are held in time domain, so the gradient
    constraint and ``fir_truncate`` are masks; with the postfilter the
    canceller output then goes through OM-LSA-multi and the ISTFT.
    Returns (out [B, S'], p [B, T, F]) in bm's dtype."""
    acfg, mc = cfg.aic, cfg.mcra
    B, C, S = bm.shape
    Lf = hop = acfg.filter_len
    T, F = S // Lf, Lf + 1
    dt, dev = bm.dtype, bm.device
    CS, AB = (torch.as_tensor(m, dtype=dt, device=dev) for m in plain_dft_packed(acfg.n_fft))
    blocks = torch.nn.functional.pad(bm, (hop, 0)).reshape(B, C, T + 1, hop)
    Xr, Xi = _unpack(blocks[:, :, :-1] @ CS[:hop] + blocks[:, :, 1:] @ CS[hop:], F)  # [B, C, T, F], input-only
    sf = _freq_smooth(yp, mc.b)
    d = d.reshape(B, T, hop)

    bins = _bin_masks(F, dev)
    n = torch.arange(Lf, device=dev)
    edge = (n >= cfg.fir_truncate) & (n < Lf - cfg.fir_truncate)
    zero = bm.new_zeros((B, F))
    st = dict(S=zero, Smin=zero, Stmp=zero, P=zero, Lam=zero)
    wt = bm.new_zeros((B, C, Lf))
    Pw = zero
    out = bm.new_empty((B, T, hop))
    p_out = bm.new_empty((B, T, F))
    if cfg.postfilter:
        pf = _Postfilter(cfg, B, dt, dev)
    for t in range(T):
        p, _, sr = _mcra_frame(t, yp[:, t], sf[:, t], st, bins, mc)
        p_out[:, t] = p
        gate = 1.0 - p
        if cfg.vad_guard:
            gate = gate * (sr <= mc.delta_s)
        xr, xi = Xr[:, :, t], Xi[:, :, t]  # [B, C, F]
        wr, wi = _unpack(wt @ CS[:Lf], F)
        Yr = torch.sum(xr * wr - xi * wi, dim=1)
        Yi = torch.sum(xr * wi + xi * wr, dim=1)
        Pw = torch.clamp(acfg.alpha * Pw + (1.0 - acfg.alpha) * torch.sum(xr * xr + xi * xi, dim=1), min=1e-4)
        e = d[:, t] - _pack(Yr, Yi) @ AB[:, hop:]  # [B, hop]
        Er, Ei = _unpack(e @ CS[hop:], F)  # rdft of the front-zero-padded error
        Pc = Pw[:, None]
        gr = (xr * Er[:, None] + xi * Ei[:, None]) / Pc
        gi = (xr * Ei[:, None] - xi * Er[:, None]) / Pc
        # gradient constraint (keep the first n_fft - hop = Lf samples), the
        # per-bin gate, and back to taps; fir_truncate keeps w exact in Lf taps
        Gr, Gi = _unpack((_pack(gr, gi) @ AB[:, :Lf]) @ CS[:Lf], F)
        g = gate[:, None]
        u = _pack(Gr * g, Gi * g) @ AB[:, :Lf]
        wt = torch.where(edge, wt + 2.0 * acfg.mu * u, 0.0)
        out[:, t] = pf.frame(e, up[:, :, t]) if cfg.postfilter else e
    return out.reshape(B, T * hop), p_out


class _Postfilter:
    """OM-LSA-multi on the canceller output, one frame at a time: the state
    of ``tdgsc_frames_plain``'s postfilter branch (windowed analysis,
    ``omlsa_step``, sqrt(G), windowed synthesis and overlap-add)."""

    def __init__(self, cfg, B, dt, dev):
        self.cfg, self.hop = cfg.omlsa, cfg.frame_len
        CSW, ABW = windowed_dft_packed(cfg.stft.n_fft, cfg.stft.hop)
        self.CSW = torch.as_tensor(CSW, dtype=dt, device=dev)
        self.ABW = torch.as_tensor(ABW, dtype=dt, device=dev)
        self.state = omlsa_init(self.cfg, (B,), dtype=dt, device=dev)
        self.prev = torch.zeros((B, self.hop), dtype=dt, device=dev)
        self.ola = torch.zeros((B, self.hop), dtype=dt, device=dev)

    def frame(self, e: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Canceller output block e [B, hop] and this frame's reference
        powers u [B, C, F] -> the postfiltered output block [B, hop]."""
        hop = self.hop
        yr, yi = _unpack(self.prev @ self.CSW[:hop] + e @ self.CSW[hop:], self.cfg.half_bin)
        self.prev = e
        self.state, (_, _, G) = omlsa_step(self.cfg, self.state, yr * yr + yi * yi, u)
        sg = torch.sqrt(G)
        f = _pack(sg * yr, sg * yi) @ self.ABW  # windowed ISTFT, synthesis gain folded in
        out = f[:, :hop] + self.ola
        self.ola = f[:, hop:]
        return out


def fused_tdgsc_plain(x, geometry, angle_rad, cfg):
    """Plain version of ``fused_tdgsc`` (any float dtype, any device):
    x [B, M, S] -> (out [B, S'], p [B, T, F], bm [B, M-1, S']) with
    S' = T * frame_len."""
    x = _check(torch.as_tensor(x), cfg)
    fbf, bm = front_end(x, geometry, angle_rad, cfg)
    return (*tdgsc_frames_plain(bm, *_kernel_inputs(fbf, bm, cfg), cfg), bm)


# ---- the CUDA side ----------------------------------------------------------


class _TdgscParams(ctypes.Structure):
    """Mirror of ``TdgscParams`` in csrc/flms.cu (field order and types must
    match); derived constants are computed here in double."""

    _fields_ = [
        ("mc", _McraParams), ("om", _McraParams),
        ("b0", ctypes.c_float), ("b1", ctypes.c_float), ("b2", ctypes.c_float),
        ("ob0", ctypes.c_float), ("ob1", ctypes.c_float), ("ob2", ctypes.c_float),
        ("alpha", ctypes.c_float), ("one_m_alpha", ctypes.c_float), ("mu2", ctypes.c_float),
        ("ft", ctypes.c_int), ("vad_guard", ctypes.c_int),
        ("o_alpha_s", ctypes.c_float), ("o_one_m_alpha_s", ctypes.c_float),
        ("o_alpha_d", ctypes.c_float), ("o_one_m_alpha_d", ctypes.c_float),
        ("o_alpha_xi", ctypes.c_float), ("o_one_m_alpha_xi", ctypes.c_float),
        ("o_beta", ctypes.c_float), ("o_bmin", ctypes.c_float), ("o_eps", ctypes.c_float),
        ("o_gh", ctypes.c_float), ("o_gh_gl", ctypes.c_float), ("o_gl", ctypes.c_float),
        ("o_oh", ctypes.c_float), ("o_oh_ol", ctypes.c_float), ("o_ol", ctypes.c_float),
        ("o_qmin", ctypes.c_float), ("o_qmax", ctypes.c_float),
        ("o_gmin", ctypes.c_float), ("o_log_gmin", ctypes.c_float), ("syn_gain", ctypes.c_float),
    ]


def _tdgsc_params(cfg) -> _TdgscParams:
    acfg, mc, om = cfg.aic, cfg.mcra, cfg.omlsa
    return _TdgscParams(
        mc=_mcra_params(mc), om=_mcra_params(om.mcra),
        b0=mc.b[0], b1=mc.b[1], b2=mc.b[2], ob0=om.mcra.b[0], ob1=om.mcra.b[1], ob2=om.mcra.b[2],
        alpha=acfg.alpha, one_m_alpha=1.0 - acfg.alpha, mu2=2.0 * acfg.mu,
        ft=cfg.fir_truncate, vad_guard=int(cfg.vad_guard),
        o_alpha_s=om.alpha_s, o_one_m_alpha_s=1.0 - om.alpha_s,
        o_alpha_d=om.alpha_d, o_one_m_alpha_d=1.0 - om.alpha_d,
        o_alpha_xi=om.alpha_xi, o_one_m_alpha_xi=1.0 - om.alpha_xi,
        o_beta=om.beta, o_bmin=om.Bmin, o_eps=om.eps_tbrr,
        o_gh=om.gamma_high, o_gh_gl=om.gamma_high - om.gamma_low, o_gl=om.gamma_low,
        o_oh=om.omega_high, o_oh_ol=om.omega_high - om.omega_low, o_ol=om.omega_low,
        o_qmin=om.q_min, o_qmax=om.q_max, o_gmin=om.gmin, o_log_gmin=float(np.log(om.gmin)),
        syn_gain=cfg.stft.synthesis_gain,
    )


def _twiddles(n_fft: int) -> np.ndarray:
    """[n_fft] float64: the FFT twiddles e^{-2 pi i j / n_fft}, j < n_fft / 2,
    as (cos, sin) pairs, with the exact zeros kept exact (so bins 0 and
    n_fft / 2 of a real signal stay real)."""
    ang = -2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    tw[np.abs(tw) < 1e-12] = 0.0
    return tw.ravel()


@functools.lru_cache(maxsize=16)
def _tables(n_fft: int, device) -> torch.Tensor:
    """[3 n_fft / 2] float32: the FFT twiddles, then the sqrt-Hann analysis /
    synthesis window."""
    win = StftConfig(n_fft, n_fft // 2).window
    return torch.as_tensor(np.concatenate([_twiddles(n_fft), win]), dtype=torch.float32, device=device)


# csrc/<name>.cu -> its launcher and argument types (p: pointer, i: int)
_LAUNCHERS = {
    "flms": ("fused_tdgsc_launch", "pppppppiiiipp"),  # K5
    "kws": ("fused_kws_launch", "pppppiiiipp"),  # K6
    "fdgsc": ("fused_fdgsc_launch", "ppppppppiiiipp"),  # K8
}


def _library(name: str = "flms") -> ctypes.CDLL:
    lib = _build.load(name)
    if not getattr(lib, "_signatures_set", False):
        fn_name, sig = _LAUNCHERS[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int for c in sig]
        fn.restype = ctypes.c_int
        lib._signatures_set = True
    return lib


def tdgsc_frames(bm: torch.Tensor, d: torch.Tensor, yp: torch.Tensor, up, cfg):
    """The K5 kernel: ``tdgsc_frames_plain``'s recursion, one block per
    utterance.  CPU tensors run ``tdgsc_frames_plain``; CUDA tensors launch
    the kernel (float32, contiguous, C = M - 1 from 1 to 7) or raise."""
    if bm.device.type == "cpu":
        return tdgsc_frames_plain(bm, d, yp, up, cfg)
    B, C, S = bm.shape
    Lf = cfg.frame_len
    T, F = S // Lf, Lf + 1
    extra = () if up is None else (up,)
    _build.check_tensors("fused_tdgsc", bm, d, yp, *extra)
    if C not in _KERNEL_CHANNELS:
        raise ValueError(f"fused_tdgsc: the kernel is built for M - 1 from 1 to 7 (2 to 8 mics), got {C}")
    if d.shape != (B, S) or yp.shape != (B, T, F) or (up is not None and up.shape != (B, C, T, F)):
        raise ValueError("fused_tdgsc: d must be [B, S'], yp [B, T, F] and up [B, C, T, F]")
    if (up is not None) != cfg.postfilter:
        raise ValueError("fused_tdgsc: up is given exactly when cfg.postfilter is set")
    out = torch.empty((B, S), dtype=torch.float32, device=bm.device)
    p = torch.empty((B, T, F), dtype=torch.float32, device=bm.device)
    params = _tdgsc_params(cfg)
    err = _library("flms").fused_tdgsc_launch(
        bm.data_ptr(), d.data_ptr(), yp.data_ptr(), up.data_ptr() if up is not None else None,
        _tables(2 * Lf, bm.device).data_ptr(), out.data_ptr(), p.data_ptr(), C, B, T, Lf,
        ctypes.addressof(params), torch.cuda.current_stream(bm.device).cuda_stream,
    )
    _build.check_launch("flms", err, "fused_tdgsc")
    LAUNCHES["fused_tdgsc"] += 1
    return out, p


def fused_tdgsc(x, geometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg=None):
    """Fused TDGSC (``cfg.postfilter`` selects the postfilter variant):
    x [B, M, S] -> (out [B, S'], p [B, T, F], bm [B, M-1, S']), like
    ``beamform.tdgsc.tdgsc_process``.  The front end runs as plain PyTorch,
    the frame loop in ``tdgsc_frames``.  A tensor stays on its device;
    other inputs go to the card."""
    if cfg is None:
        from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig

        cfg = TdGscConfig()
    x = _check(wrapper_input(x), cfg)
    fbf, bm = front_end(x, geometry, angle_rad, cfg)
    bm = bm.contiguous()
    d, yp, up = (a.contiguous() if a is not None else None for a in _kernel_inputs(fbf, bm, cfg))
    return (*tdgsc_frames(bm, d, yp, up, cfg), bm)


# ---- K6: the dual-mic KWS cleaner -------------------------------------------


def _kws_check(x: torch.Tensor, cfg):
    """Validate x [B, 2, S] and the layout; return x cut to T whole frames."""
    fcfg = cfg.flms
    Lf, hop, n_fft = fcfg.filter_len, fcfg.hop, fcfg.n_fft
    if x.ndim != 3 or x.shape[1] != 2:
        raise ValueError(f"fused_kws needs x [B, 2, S], got {tuple(x.shape)}")
    if hop != Lf or n_fft != 2 * Lf or Lf & (Lf - 1):
        raise ValueError(f"fused_kws needs the default hop == filter_len layout, a power of two (got L={Lf})")
    T = x.shape[-1] // Lf
    if T < 1:
        raise ValueError(f"x needs at least one frame ({Lf} samples)")
    return x[..., : T * Lf]


def _kws_inputs(x: torch.Tensor, cfg):
    """(x0 [B, S'], d [B, S']): the ANC input mic and the desired mic 1
    delayed by filter_len / 2 (the non-causal FLMS)."""
    Lf, S = cfg.flms.filter_len, x.shape[-1]
    return x[:, 0], torch.nn.functional.pad(x[:, 1], (Lf // 2, 0))[..., :S]


def kws_frames_plain(x0: torch.Tensor, d: torch.Tensor, cfg) -> torch.Tensor:
    """Plain version of the K6 kernel: the KWS cleaner's frame recursion.

    x0 [B, S'] ANC input, d [B, S'] delayed desired mic.  Per frame: the
    FLMS ANC adapts (taps w [B, Lf] in time domain, 2 mu step, the gradient
    constraint a mask), its new taps go into a circular FIFO of Dn slots,
    and the taps pushed Dn frames ago (zeros until the FIFO has wrapped)
    run a frozen cleaner on the same frame.  Returns cleaned [B, S']."""
    fcfg = cfg.flms
    B, S = x0.shape
    Lf = hop = fcfg.filter_len
    T, F, Dn = S // Lf, Lf + 1, cfg.delay_frames_n
    CS, AB = (torch.as_tensor(m, dtype=x0.dtype, device=x0.device) for m in plain_dft_packed(fcfg.n_fft))
    blocks = torch.nn.functional.pad(x0, (hop, 0)).reshape(B, T + 1, hop)
    Xr, Xi = _unpack(blocks[:, :-1] @ CS[:hop] + blocks[:, 1:] @ CS[hop:], F)  # [B, T, F], input-only
    d = d.reshape(B, T, hop)
    w = x0.new_zeros((B, Lf))
    Pw = x0.new_zeros((B, F))
    fifo = x0.new_zeros((B, Dn, Lf))
    out = x0.new_empty((B, T, hop))

    def filtered(taps, xr, xi):
        wr, wi = _unpack(taps @ CS[:Lf], F)
        return _pack(xr * wr - xi * wi, xr * wi + xi * wr) @ AB[:, hop:]

    for t in range(T):
        xr, xi = Xr[:, t], Xi[:, t]
        Pw = torch.clamp(fcfg.alpha * Pw + (1.0 - fcfg.alpha) * (xr * xr + xi * xi), min=1e-4)
        e = d[:, t] - filtered(w, xr, xi)
        Er, Ei = _unpack(e @ CS[hop:], F)
        g = _pack((xr * Er + xi * Ei) / Pw, (xr * Ei - xi * Er) / Pw) @ AB[:, :Lf]  # keep the first Lf taps
        w = w + 2.0 * fcfg.mu * g
        slot = t % Dn
        w_old = fifo[:, slot].clone()  # taps pushed Dn frames ago
        fifo[:, slot] = w
        out[:, t] = d[:, t] - filtered(w_old, xr, xi)
    return out.reshape(B, T * hop)


def fused_kws_plain(x, cfg=None) -> torch.Tensor:
    """Plain version of ``fused_kws`` (any float dtype, any device)."""
    cfg = _kws_default() if cfg is None else cfg
    return kws_frames_plain(*_kws_inputs(_kws_check(torch.as_tensor(x), cfg), cfg), cfg)


def _kws_default():
    from distantspeech_tpu_torch.kws.dual_mic import DualMicKwsConfig

    return DualMicKwsConfig()


class _KwsParams(ctypes.Structure):
    """Mirror of ``KwsParams`` in csrc/kws.cu."""

    _fields_ = [("alpha", ctypes.c_float), ("one_m_alpha", ctypes.c_float), ("mu2", ctypes.c_float)]


def _kws_launch(x0, d, cfg, fifo, out, stream) -> None:
    """Launch K6 on x0, d [B, S'] with the zeroed FIFO scratch fifo
    [B, Dn, Lf] into out [B, S']."""
    fcfg = cfg.flms
    B, S = x0.shape
    Lf = fcfg.filter_len
    params = _KwsParams(alpha=fcfg.alpha, one_m_alpha=1.0 - fcfg.alpha, mu2=2.0 * fcfg.mu)
    err = _library("kws").fused_kws_launch(
        x0.data_ptr(), d.data_ptr(), _tables(fcfg.n_fft, x0.device).data_ptr(), fifo.data_ptr(), out.data_ptr(),
        B, S // Lf, Lf, cfg.delay_frames_n, ctypes.addressof(params), stream,
    )
    _build.check_launch("kws", err, "fused_kws")


def kws_frames(x0: torch.Tensor, d: torch.Tensor, cfg) -> torch.Tensor:
    """The K6 kernel: ``kws_frames_plain``'s recursion, one block per
    utterance, the FIFO in a zeroed global scratch [B, Dn, Lf].  CPU tensors
    run ``kws_frames_plain``; CUDA tensors launch the kernel (float32,
    contiguous) or raise."""
    if x0.device.type == "cpu":
        return kws_frames_plain(x0, d, cfg)
    _build.check_tensors("fused_kws", x0, d)
    B, S = x0.shape
    Lf = cfg.flms.filter_len
    if d.shape != (B, S) or S % Lf:
        raise ValueError("fused_kws: x0 and d must be [B, S'] with S' whole frames")
    fifo = torch.zeros((B, cfg.delay_frames_n, Lf), dtype=torch.float32, device=x0.device)
    out = torch.empty_like(x0)
    _kws_launch(x0, d, cfg, fifo, out, torch.cuda.current_stream(x0.device).cuda_stream)
    LAUNCHES["fused_kws"] += 1
    return out


def fused_kws(x, cfg=None) -> torch.Tensor:
    """Fused dual-mic KWS cleaner: x [B, 2, S] -> cleaned [B, S'], like
    ``kws.dual_mic.kws_process``.  x may be a strided view (mics 0/1 of a
    wider array): the kernel's inputs are contiguous copies.  A tensor stays
    on its device; other inputs go to the card."""
    cfg = _kws_default() if cfg is None else cfg
    x0, d = _kws_inputs(_kws_check(wrapper_input(x), cfg), cfg)
    return kws_frames(x0.contiguous(), d.contiguous(), cfg)


# ---- K8: the frequency-domain GSC --------------------------------------------


def _fdgsc_check(x: torch.Tensor, cfg):
    Lf = cfg.frame_len
    if x.ndim != 3 or x.shape[1] != cfg.n_mics:
        raise ValueError(f"fused_fdgsc needs x [B, M={cfg.n_mics}, S], got {tuple(x.shape)}")
    if Lf < 128 or Lf & (Lf - 1):
        raise ValueError(f"fused_fdgsc needs frame_len a power of two >= 128 (the p pinning reads bins 32..127), got {Lf}")
    if cfg.postfilter:
        raise ValueError("fused_fdgsc implements the postfilter=False core")
    T = x.shape[-1] // Lf
    if T < 1:
        raise ValueError(f"x needs at least one frame ({Lf} samples)")
    return x[..., : T * Lf]


def fdgsc_front_end(x: torch.Tensor, geometry, angle_rad, cfg, dc_notch_input: bool = True):
    """The FDGSC's frame-independent front end over whole signals: the DC
    notch, alignment FIR and FBF; the MCRA input (the STFT power of the
    notched raw reference channel, [B, T, F]); and the causality delays.
    Returns (fbf [B, S'], aligned delayed by L/2 [B, M, S'], fbf delayed by
    L [B, S'], power [B, T, F])."""
    Lf, S = cfg.frame_len, x.shape[-1]
    if dc_notch_input:
        _, x = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype, device=x.device), x, radius=0.98)
    coeffs = torch.as_tensor(time_alignment_filters(geometry, angle_rad), dtype=x.dtype, device=x.device)
    aligned = fir_filter_offline(x, coeffs)
    fbf = aligned.mean(dim=-2)
    D = stft_frames(torch.nn.functional.pad(x[:, 0], (cfg.stft.overlap, 0)), cfg.stft)
    power = D.real**2 + D.imag**2
    dbm = torch.nn.functional.pad(aligned, (Lf // 2, 0))[..., :S]
    daic = torch.nn.functional.pad(fbf, (Lf, 0))[..., :S]
    return fbf, dbm, daic, power


def fdgsc_frames_plain(fbf, dbm, daic, yp, cfg):
    """Plain version of the K8 kernel: the FDGSC frame recursion.

    fbf [B, S'] fixed beamformer, dbm [B, M, S'] delayed aligned mics, daic
    [B, S'] delayed FBF, yp [B, T, F] reference-channel power.  Per frame:
    MCRA (L=60) on yp with the low-32-bin p pinning; M blocking-matrix FLMS
    filters on the shared FBF spectrum (p = 1, no 2x), CCAF-clamped in tap
    space; the M-channel AIC on [e_prev, e_bm] stepped by 1 - mean(p), its
    norm ceiling computed on the half spectrum of the updated, unconstrained
    filter.  Filter state is Lf time-domain taps.  Returns (out [B, S'],
    p [B, T, F], bm [B, M, S'])."""
    from distantspeech_tpu_torch.beamform.gsc_filters import bm_bounds

    mc, bcfg, acfg = cfg.mcra, cfg.bm, cfg.aic
    B, M, S = dbm.shape
    Lf = hop = cfg.frame_len
    N = 2 * Lf
    T, F = S // Lf, Lf + 1
    dt, dev = dbm.dtype, dbm.device
    CS, AB = (torch.as_tensor(m, dtype=dt, device=dev) for m in plain_dft_packed(N))
    blocks = torch.nn.functional.pad(fbf, (hop, 0)).reshape(B, T + 1, hop)
    Xr, Xi = _unpack(blocks[:, :-1] @ CS[:hop] + blocks[:, 1:] @ CS[hop:], F)  # [B, T, F], input-only
    sf = _freq_smooth(yp, mc.b)
    dbm = dbm.reshape(B, M, T, hop)
    daic = daic.reshape(B, T, hop)
    ub = torch.as_tensor(bm_bounds(N), dtype=dt, device=dev)

    bins = _bin_masks(F, dev)
    k = torch.arange(F, device=dev)
    low32, mid = k < 32, (k >= 32) & (k < 128)
    zero = dbm.new_zeros((B, F))
    st = dict(S=zero, Smin=zero, Stmp=zero, P=zero, Lam=zero)
    Pbm, Paic = zero, zero
    Wbm, Waic = dbm.new_zeros((B, M, Lf)), dbm.new_zeros((B, M, Lf))
    Eprev = dbm.new_zeros((B, M, hop))
    out, p_out, bm_out = dbm.new_empty((B, T, hop)), dbm.new_empty((B, T, F)), dbm.new_empty((B, M, T, hop))
    for t in range(T):
        p, _, _ = _mcra_frame(t, yp[:, t], sf[:, t], st, bins, mc)
        mid_mean = torch.sum(torch.where(mid, p, 0.0), dim=-1, keepdim=True) / 96.0
        p_ret = torch.where(low32 & (mid_mean > 0.8), torch.clamp(p, min=0.8), p)
        p_out[:, t] = p_ret
        step = (acfg.mu * (1.0 - p_ret.mean(dim=-1)))[:, None, None]  # the AIC's scalar gate

        # ---- blocking matrix: M single-channel FLMS on the FBF spectrum
        xr, xi = Xr[:, t, None], Xi[:, t, None]  # [B, 1, F]
        Pbm = torch.clamp(bcfg.alpha * Pbm + (1.0 - bcfg.alpha) * (xr[:, 0] ** 2 + xi[:, 0] ** 2), min=1e-4)
        wr, wi = _unpack(Wbm @ CS[:Lf], F)
        e_bm = dbm[:, :, t] - _pack(xr * wr - xi * wi, xr * wi + xi * wr) @ AB[:, hop:]  # [B, M, hop]
        bm_out[:, :, t] = e_bm
        Er, Ei = _unpack(e_bm @ CS[hop:], F)
        Pc = Pbm[:, None]
        g = _pack((xr * Er + xi * Ei) / Pc, (xr * Ei - xi * Er) / Pc) @ AB[:, :Lf]
        Wbm = torch.minimum(torch.clamp(Wbm + bcfg.mu * g, min=-0.001), ub[:Lf])

        # ---- AIC: the M-channel FLMS on the BM outputs, input [e_prev, e_bm]
        ar, ai = _unpack(Eprev @ CS[:hop] + e_bm @ CS[hop:], F)  # [B, M, F]
        Eprev = e_bm
        war, wai = _unpack(Waic @ CS[:Lf], F)
        Yr = torch.sum(ar * war - ai * wai, dim=1)
        Yi = torch.sum(ar * wai + ai * war, dim=1)
        Paic = torch.clamp(acfg.alpha * Paic + (1.0 - acfg.alpha) * torch.sum(ar * ar + ai * ai, dim=1), min=1e-4)
        e = daic[:, t] - _pack(Yr, Yi) @ AB[:, hop:]
        out[:, t] = e
        Er, Ei = _unpack(e @ CS[hop:], F)
        Pc = Paic[:, None]
        gr = (ar * Er[:, None] + ai * Ei[:, None]) / Pc
        gi = (ar * Ei[:, None] - ai * Er[:, None]) / Pc
        # the norm ceiling on the updated, unconstrained filter's half spectrum
        nr, ni = war + step * gr, wai + step * gi
        norm = torch.sum(nr * nr + ni * ni, dim=(1, 2)) / N / N
        scale = torch.where(norm > FDGSC_MAXNORM, torch.sqrt(FDGSC_MAXNORM / torch.clamp(norm, min=1e-30)), 1.0)
        Waic = (Waic + step * (_pack(gr, gi) @ AB[:, :Lf])) * scale[:, None, None]
    return out.reshape(B, T * hop), p_out, bm_out.reshape(B, M, T * hop)



def fused_fdgsc_plain(x, geometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg=None, dc_notch_input: bool = True):
    """Plain version of ``fused_fdgsc`` (any float dtype, any device)."""
    cfg = _fdgsc_default() if cfg is None else cfg
    fbf, dbm, daic, yp = fdgsc_front_end(_fdgsc_check(torch.as_tensor(x), cfg), geometry, angle_rad, cfg,
                                         dc_notch_input)
    return fdgsc_frames_plain(fbf, dbm, daic, yp, cfg)


def _fdgsc_default():
    from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig

    return FdGscConfig()


class _FdgscParams(ctypes.Structure):
    """Mirror of ``FdgscParams`` in csrc/fdgsc.cu (field order and types
    must match); derived constants are computed here in double."""

    _fields_ = [
        ("mc", _McraParams),
        ("b0", ctypes.c_float), ("b1", ctypes.c_float), ("b2", ctypes.c_float),
        ("bm_alpha", ctypes.c_float), ("bm_one_m_alpha", ctypes.c_float), ("bm_mu", ctypes.c_float),
        ("aic_alpha", ctypes.c_float), ("aic_one_m_alpha", ctypes.c_float), ("aic_mu", ctypes.c_float),
        ("maxnorm", ctypes.c_float),
    ]


def _fdgsc_params(cfg) -> _FdgscParams:
    mc, bcfg, acfg = cfg.mcra, cfg.bm, cfg.aic
    return _FdgscParams(
        mc=_mcra_params(mc), b0=mc.b[0], b1=mc.b[1], b2=mc.b[2],
        bm_alpha=bcfg.alpha, bm_one_m_alpha=1.0 - bcfg.alpha, bm_mu=bcfg.mu,
        aic_alpha=acfg.alpha, aic_one_m_alpha=1.0 - acfg.alpha, aic_mu=acfg.mu, maxnorm=FDGSC_MAXNORM,
    )


@functools.lru_cache(maxsize=16)
def _fdgsc_tables(n_fft: int, device) -> torch.Tensor:
    """[n_fft + n_fft / 2] float32: the FFT twiddles, then the CCAF upper
    bounds of the blocking-matrix taps."""
    from distantspeech_tpu_torch.beamform.gsc_filters import bm_bounds

    return torch.as_tensor(np.concatenate([_twiddles(n_fft), bm_bounds(n_fft)]), dtype=torch.float32, device=device)



def _fdgsc_launch(fbf, dbm, daic, yp, cfg, out, p, bm, stream) -> None:
    B, M, S = dbm.shape
    Lf = cfg.frame_len
    params = _fdgsc_params(cfg)
    err = _library("fdgsc").fused_fdgsc_launch(
        fbf.data_ptr(), dbm.data_ptr(), daic.data_ptr(), yp.data_ptr(), _fdgsc_tables(2 * Lf, dbm.device).data_ptr(),
        out.data_ptr(), p.data_ptr(), bm.data_ptr(), M, B, S // Lf, Lf, ctypes.addressof(params), stream,
    )
    _build.check_launch("fdgsc", err, "fused_fdgsc")


def fdgsc_frames(fbf, dbm, daic, yp, cfg):
    """The K8 kernel: ``fdgsc_frames_plain``'s recursion, one block per
    utterance.  CPU tensors run ``fdgsc_frames_plain``; CUDA tensors launch
    the kernel (float32, contiguous, M from 2 to 8) or raise."""
    if dbm.device.type == "cpu":
        return fdgsc_frames_plain(fbf, dbm, daic, yp, cfg)
    _build.check_tensors("fused_fdgsc", fbf, dbm, daic, yp)
    B, M, S = dbm.shape
    Lf = cfg.frame_len
    T, F = S // Lf, Lf + 1
    if M not in _FDGSC_MICS:
        raise ValueError(f"fused_fdgsc: the kernel is built for M from 2 to 8, got {M}")
    if fbf.shape != (B, S) or daic.shape != (B, S) or yp.shape != (B, T, F) or S % Lf:
        raise ValueError("fused_fdgsc: fbf and daic must be [B, S'], dbm [B, M, S'] and yp [B, T, F]")
    out = torch.empty_like(fbf)
    p = torch.empty((B, T, F), dtype=torch.float32, device=dbm.device)
    bm = torch.empty_like(dbm)
    _fdgsc_launch(fbf, dbm, daic, yp, cfg, out, p, bm, torch.cuda.current_stream(dbm.device).cuda_stream)
    LAUNCHES["fused_fdgsc"] += 1
    return out, p, bm


def fused_fdgsc(x, geometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg=None, dc_notch_input: bool = True):
    """Fused FDGSC (the postfilter=False core): x [B, M, S] -> (out [B, S'],
    p [B, T, F], bm [B, M, S']), like ``beamform.fdgsc.fdgsc_process``.  The
    front end runs as plain PyTorch, the frame loop in ``fdgsc_frames``.  A
    tensor stays on its device; other inputs go to the card."""
    cfg = _fdgsc_default() if cfg is None else cfg
    ins = fdgsc_front_end(_fdgsc_check(wrapper_input(x), cfg), geometry, angle_rad, cfg, dc_notch_input)
    return fdgsc_frames(*(a.contiguous() for a in ins), cfg)
