"""Kernel K5: the fused time-domain GSC (TDGSC) frame loop.

Counterpart of ``distantspeech_tpu/ops/pallas_flms.py`` ``fused_tdgsc``:
the CUDA kernels of ``csrc/flms.cu`` replace its Pallas kernels
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
``windowed_dft_packed``); the kernel computes them as radix-2 FFTs.  The
two round differently; the canceller's small-step LMS does not compound
the gap.  The TPU knobs ``t_chunk``, ``sub``, ``unroll`` and ``_stages``
are dropped (the result does not depend on them), and any B >= 1 is taken.
"""

from __future__ import annotations

import ctypes
import functools
import numpy as np
import torch

from distantspeech_tpu_torch.adaptive.feature import dc_notch, dc_notch_init
from distantspeech_tpu_torch.array.alignment import time_alignment_filters
from distantspeech_tpu_torch.noise.mcra import _freq_smooth
from distantspeech_tpu_torch.noise.omlsa import omlsa_init, omlsa_step
from distantspeech_tpu_torch.ops import _build
from distantspeech_tpu_torch.ops.cuda_enhance import _bin_masks, _mcra_frame
from distantspeech_tpu_torch.ops.cuda_mvdr import _mcra_params, _McraParams
from distantspeech_tpu_torch.ops.fir import fir_filter_offline
from distantspeech_tpu_torch.transform.stft import StftConfig, _dft_matrices, _idft_matrices, stft_frames

LAUNCHES = {"fused_tdgsc": 0}
_KERNEL_CHANNELS = (1, 3, 7)  # C = M - 1 the CUDA templates are instantiated for


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


def front_end(x: torch.Tensor, geometry, angle_rad, cfg):
    """The TDGSC's frame-independent front end over a whole signal:
    DC notch (radius 0.98), fractional-delay alignment, fixed beamformer
    (channel mean) and pairwise-difference blocking matrix.
    x: [..., M, S] -> (fbf [..., S], bm [..., M-1, S])."""
    _, xn = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype, device=x.device), x, radius=0.98)
    coeffs = torch.as_tensor(time_alignment_filters(geometry, angle_rad), dtype=x.dtype, device=x.device)
    aligned = fir_filter_offline(xn, coeffs)
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


@functools.lru_cache(maxsize=16)
def _tables(n_fft: int, device) -> torch.Tensor:
    """[3 n_fft / 2] float32: the FFT twiddles e^{-2 pi i j / n_fft},
    j < n_fft / 2, as (cos, sin) pairs with the exact zeros kept exact, then
    the sqrt-Hann analysis / synthesis window."""
    ang = -2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    tw[np.abs(tw) < 1e-12] = 0.0
    win = StftConfig(n_fft, n_fft // 2).window
    return torch.as_tensor(np.concatenate([tw.ravel(), win]), dtype=torch.float32, device=device)


def _library() -> ctypes.CDLL:
    lib = _build.load("flms")
    if not getattr(lib, "_signatures_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_tdgsc_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, p]
        lib.fused_tdgsc_launch.restype = i
        lib._signatures_set = True
    return lib


def tdgsc_frames(bm: torch.Tensor, d: torch.Tensor, yp: torch.Tensor, up, cfg):
    """The K5 kernel: ``tdgsc_frames_plain``'s recursion, one block per
    utterance.  CPU tensors run ``tdgsc_frames_plain``; CUDA tensors launch
    the kernel (float32, contiguous, C = M - 1 in 1, 3, 7) or raise."""
    if bm.device.type == "cpu":
        return tdgsc_frames_plain(bm, d, yp, up, cfg)
    B, C, S = bm.shape
    Lf = cfg.frame_len
    T, F = S // Lf, Lf + 1
    extra = () if up is None else (up,)
    _build.check_tensors("fused_tdgsc", bm, d, yp, *extra)
    if C not in _KERNEL_CHANNELS:
        raise ValueError(f"fused_tdgsc: the kernel is built for M - 1 in {_KERNEL_CHANNELS}, got {C}")
    if d.shape != (B, S) or yp.shape != (B, T, F) or (up is not None and up.shape != (B, C, T, F)):
        raise ValueError("fused_tdgsc: d must be [B, S'], yp [B, T, F] and up [B, C, T, F]")
    if (up is not None) != cfg.postfilter:
        raise ValueError("fused_tdgsc: up is given exactly when cfg.postfilter is set")
    out = torch.empty((B, S), dtype=torch.float32, device=bm.device)
    p = torch.empty((B, T, F), dtype=torch.float32, device=bm.device)
    params = _tdgsc_params(cfg)
    err = _library().fused_tdgsc_launch(
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
    the frame loop in ``tdgsc_frames``."""
    if cfg is None:
        from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig

        cfg = TdGscConfig()
    x = _check(torch.as_tensor(x), cfg)
    fbf, bm = front_end(x, geometry, angle_rad, cfg)
    bm = bm.contiguous()
    d, yp, up = (a.contiguous() if a is not None else None for a in _kernel_inputs(fbf, bm, cfg))
    return (*tdgsc_frames(bm, d, yp, up, cfg), bm)
