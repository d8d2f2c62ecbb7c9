"""Kernel K7: the fused speex-style AEC frame loop.

Counterpart of ``distantspeech_tpu/ops/pallas_aec.py`` ``fused_aec``: the
CUDA kernel of ``csrc/aec.cu`` replaces its Pallas kernel ``_aec_kernel``,
the whole two-path MDF recursion of ``adaptive.aec.aec_step`` over an
utterance: background and foreground filters in frequency, the speex
transfer logic, the echo-leak regression, the per-bin optimal step size
with 3-tap smoothing, the proportionate block steps, the constrained
gradient and the de-emphasis IIR of the output.  M mics share one far end.

``fused_aec`` is ``runtime.full_stack``'s first stage.  The pre-emphasis
of both inputs is input-only and runs as plain PyTorch outside the kernel,
as in the JAX package; ``aec_frames`` runs the frame recursion: on a CPU
tensor its plain version ``aec_frames_plain``, on a CUDA tensor the kernel
(or it raises).

All F = n_fft/2 + 1 bins are uniform lanes (the TPU kernel's packing of the
Nyquist bin into imag lane 0 is not needed); the imaginary parts of bins 0
and F-1 are exact zeros on both sides.  The plain version computes every
transform as a dense product against the packed DFT matrices
(``plain_dft_packed``) and the de-emphasis as the blocked state-space
product ``_deemph_mats``, as the JAX kernel does; the kernel computes the
transforms as warp-owned FFTs (the far end's once per utterance-frame) and
the de-emphasis as a warp scan.  Only the
causal two_path + prop + constrain configuration with ``num_block`` in
(1, 2) is taken, as in JAX; the TPU knobs ``t_chunk``, ``sub`` and
``interpret`` are dropped, and any B >= 1 is taken.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from distantspeech_tpu_torch._device import wrapper_input
from distantspeech_tpu_torch.adaptive.feature import emphasis_init, pre_emphasis
from distantspeech_tpu_torch.ops import _build
from distantspeech_tpu_torch.ops.cuda_flms import _pack, _twiddles, _unpack, plain_dft_packed
from distantspeech_tpu_torch.runtime.profiling import count, span

DEEMPH = 0.98  # the de-emphasis pole of adaptive.feature.de_emphasis


@functools.lru_cache(maxsize=None)
def _deemph_mats(n: int, alpha: float):
    """Blocked first-order IIR y[n] = x[n] + alpha y[n-1] (float64): the
    in-block lower-triangular Toeplitz response R1 [n, n] (y = x @ R1 from a
    zero state) and the initial-state decay alpha^(j+1) [n]."""
    j = np.arange(n)[None, :]
    m = np.arange(n)[:, None]
    R1 = np.where(j >= m, alpha ** np.maximum(j - m, 0), 0.0)
    return R1, alpha ** (np.arange(n) + 1.0)


def _check_cfg(cfg):
    if cfg.num_block not in (1, 2):
        raise ValueError("fused_aec supports num_block in (1, 2)")
    if cfg.non_causal:
        raise ValueError("fused_aec implements the causal (default) AEC")
    if not (cfg.two_path and cfg.prop and cfg.constrain):
        raise ValueError("fused_aec implements the production two_path+prop+constrain AEC")
    hop = cfg.block_len
    if hop < 32 or hop & (hop - 1):
        raise ValueError(f"fused_aec needs block_len a power of two >= 32, got {hop}")


def _prepare(far: torch.Tensor, x: torch.Tensor, cfg):
    """Validate far [B, S] and x [B, M, S]; return both cut to T whole
    blocks and pre-emphasised (from the zero state)."""
    _check_cfg(cfg)
    if x.ndim != 3 or far.shape != (x.shape[0], x.shape[-1]):
        raise ValueError(f"fused_aec needs far [B, S] and x [B, M, S], got {tuple(far.shape)}, {tuple(x.shape)}")
    hop = cfg.block_len
    T = x.shape[-1] // hop
    if T < 1:
        raise ValueError(f"x needs at least one block ({hop} samples)")
    B, M = x.shape[:2]
    _, farp = pre_emphasis(emphasis_init((B,), dtype=far.dtype, device=far.device), far[..., : T * hop])
    _, xp = pre_emphasis(emphasis_init((B, M), dtype=x.dtype, device=x.device), x[..., : T * hop])
    return farp, xp


def aec_frames_plain(farp: torch.Tensor, xp: torch.Tensor, cfg, decisions: bool = False):
    """Plain version of the K7 kernel: the AEC frame recursion on the
    pre-emphasised far end farp [B, S'] and mics xp [B, M, S'].  Returns the
    echo-free, de-emphasised mics [B, M, S'] in xp's dtype; with
    ``decisions`` also the transfer-logic decision of every frame
    [B, M, T] (bool)."""
    B, M, S = xp.shape
    hop, NB = cfg.block_len, cfg.num_block
    T, F = S // hop, hop + 1
    dt, dev = xp.dtype, xp.device
    CS, AB = (torch.as_tensor(m, dtype=dt, device=dev) for m in plain_dft_packed(cfg.n_fft))
    win = torch.as_tensor(cfg.window(), dtype=dt, device=dev)
    R1, decay = (torch.as_tensor(m, dtype=dt, device=dev) for m in _deemph_mats(hop, DEEMPH))
    blocks = torch.nn.functional.pad(farp, (hop, 0)).reshape(B, T + 1, hop)
    Zr, Zi = _unpack(blocks[:, :-1] @ CS[:hop] + blocks[:, 1:] @ CS[hop:], F)  # [B, T, F], input-only
    d = xp.reshape(B, M, T, hop)

    zc = xp.new_zeros((B, M, NB, F))
    Wr, Wi, Fr, Fi = zc, zc, zc, zc
    P = xp.new_zeros((B, F))
    Py, Pe = xp.new_zeros((B, M, F)), xp.new_zeros((B, M, F))
    zs = xp.new_zeros((B, M))
    Ryy, Rey, Davg1, Davg2, Dvar1, Dvar2, memE = zs + 1.0, zs + 1.0, zs, zs, zs, zs, zs
    g, g1 = cfg.gamma, 1.0 - cfg.gamma
    out = xp.new_empty((B, M, T, hop))
    upds = torch.empty((B, M, T), dtype=torch.bool, device=dev)
    zero_spec = xp.new_zeros((B, F))
    for t in range(T):
        # far-end block spectra X_b = Xm[t - b], shared by every mic
        Xs = [(Zr[:, t], Zi[:, t]), (Zr[:, t - 1], Zi[:, t - 1]) if t > 0 else (zero_spec, zero_spec)][:NB]
        pw = sum(xr * xr + xi * xi for xr, xi in Xs)
        P = cfg.alpha * P + (1.0 - cfg.alpha) * pw
        Pr = (P + 1e-6)[:, None]

        def filt(Hr, Hi):
            yr = sum(xr[:, None] * Hr[:, :, b] - xi[:, None] * Hi[:, :, b] for b, (xr, xi) in enumerate(Xs))
            yi = sum(xr[:, None] * Hi[:, :, b] + xi[:, None] * Hr[:, :, b] for b, (xr, xi) in enumerate(Xs))
            return yr, yi

        Ybr, Ybi = filt(Wr, Wi)  # [B, M, F]
        Yfr, Yfi = filt(Fr, Fi)
        yb = _pack(Ybr, Ybi) @ AB[:, hop:]  # [B, M, hop]
        yf = _pack(Yfr, Yfi) @ AB[:, hop:]
        d_t = d[:, :, t]
        e_b = d_t - yb
        e_f = d_t - yf

        # ---- the two-path transfer logic, per mic
        Sff = torch.sum(e_f * e_f, dim=-1)
        See = torch.sum(e_b * e_b, dim=-1)
        dby = yf - yb
        Dbf = torch.sum(dby * dby, dim=-1)
        Davg1 = 0.6 * Davg1 + 0.4 * (Sff - See)
        Davg2 = 0.85 * Davg2 + 0.15 * (Sff - See)
        Dvar1 = 0.36 * Dvar1 + 0.16 * Sff * Dbf
        Dvar2 = 0.7225 * Dvar2 + 0.0225 * Sff * Dbf
        upd = (
            ((Sff - See) * torch.abs(Sff - See) > Sff * Dbf)
            | (Davg1 * torch.abs(Davg1) > 0.5 * Dvar1)
            | (Davg2 * torch.abs(Davg2) > 0.25 * Dvar2)
        )
        upds[:, :, t] = upd
        Davg1, Davg2, Dvar1, Dvar2 = (torch.where(upd, 0.0, v) for v in (Davg1, Davg2, Dvar1, Dvar2))
        u4 = upd[:, :, None, None]
        Fr, Fi = torch.where(u4, Wr, Fr), torch.where(u4, Wi, Fi)
        yfm = torch.where(upd[..., None], win[hop:] * yf + win[:hop] * yb, yf)
        o = d_t - yfm

        # ---- the leak regression and the per-bin optimal step size
        Er, Ei = _unpack(e_b @ CS[hop:], F)  # rdft of the front-zero-padded error
        Ysq = Ybr * Ybr + Ybi * Ybi
        Rsq = Er * Er + Ei * Ei
        Py = g1 * Py + g * Ysq
        Pe = g1 * Pe + g * Rsq
        Eh, Yh = Rsq - Pe, Ysq - Py
        Pyy = torch.sqrt(torch.sum(Yh * Yh, dim=-1))
        Pey = torch.sum(Eh * Yh, dim=-1) / (Pyy + 1e-6)
        Syy = torch.sum(yb * yb, dim=-1)
        a = cfg.beta0 * torch.clamp(Syy / See, max=1.0)
        Ryy = (1.0 - a) * Ryy + a * Pyy
        Rey = (1.0 - a) * Rey + a * Pey
        leak = Rey / (Ryy + 1e-6)
        mu = leak[..., None] * Ysq / (Rsq + 1e-3)
        mu = torch.cat([2.0 * mu[..., :2], mu[..., 2:]], dim=-1)  # bins 0 and 1 get 2 mu
        mu = torch.clamp(mu, 1e-3, cfg.mu_max)
        mp = torch.nn.functional.pad(mu, (1, 1))  # 3-tap smoothing, zero-padded
        mu = 0.25 * mp[..., :-2] + 0.5 * mp[..., 1:-1] + 0.25 * mp[..., 2:]
        if t < 5:
            mu = torch.full_like(mu, 0.1)

        # ---- the constrained gradient (keep the first hop taps) and the
        # proportionate update from the current W
        Gr, Gi = [], []
        for xr, xi in Xs:
            gr = (xr[:, None] * Er + xi[:, None] * Ei) / Pr
            gi = (xr[:, None] * Ei - xi[:, None] * Er) / Pr
            cr, ci = _unpack((_pack(gr, gi) @ AB[:, :hop]) @ CS[:hop], F)
            Gr.append(cr)
            Gi.append(ci)
        props = torch.sqrt(torch.sum(Wr * Wr + Wi * Wi, dim=-1))  # [B, M, NB]
        props = props + 0.1 * torch.clamp(props, min=1e-6)
        scale = 0.99 * props / (1e-6 + torch.sum(props, dim=-1, keepdim=True))
        step = scale[..., None] * mu[:, :, None]
        Wr = Wr + step * torch.stack(Gr, dim=2)
        Wi = Wi + step * torch.stack(Gi, dim=2)

        # ---- the de-emphasis y[n] = x[n] + 0.98 y[n-1], blocked
        y = o @ R1 + memE[..., None] * decay
        memE = y[..., -1]
        out[:, :, t] = y
    out = out.reshape(B, M, T * hop)
    return (out, upds) if decisions else out


def fused_aec_plain(far, x, cfg=None):
    """Plain version of ``fused_aec`` (any float dtype, any device)."""
    cfg = _default_cfg() if cfg is None else cfg
    return aec_frames_plain(*_prepare(torch.as_tensor(far), torch.as_tensor(x), cfg), cfg)


def _default_cfg():
    from distantspeech_tpu_torch.adaptive.aec import AecConfig

    return AecConfig(filter_len=512, num_block=2)


# ---- the CUDA side ----------------------------------------------------------


class _AecParams(ctypes.Structure):
    """Mirror of ``AecParams`` in csrc/aec.cu (field order and types must
    match); derived constants are computed here in double."""

    _fields_ = [
        ("alpha", ctypes.c_float), ("one_m_alpha", ctypes.c_float),
        ("gamma", ctypes.c_float), ("one_m_gamma", ctypes.c_float),
        ("beta0", ctypes.c_float), ("mu_max", ctypes.c_float),
    ]


def _aec_params(cfg) -> _AecParams:
    return _AecParams(alpha=cfg.alpha, one_m_alpha=1.0 - cfg.alpha, gamma=cfg.gamma, one_m_gamma=1.0 - cfg.gamma,
                      beta0=cfg.beta0, mu_max=cfg.mu_max)


@functools.lru_cache(maxsize=16)
def _tables(n_fft: int, device) -> torch.Tensor:
    """[3 n_fft / 2 + n_fft / 2 + 1] float32: the FFT twiddles (as in
    ``cuda_flms._tables``), the Hann window of the two-path blend
    (``AecConfig.window``), and the de-emphasis powers 0.98^k, k <= n_fft/2."""
    hop = n_fft // 2
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    apow = DEEMPH ** np.arange(hop + 1, dtype=np.float64)
    return torch.as_tensor(np.concatenate([_twiddles(n_fft), win, apow]), dtype=torch.float32, device=device)


def launch_layout(cfg, M: int):
    """(mics a block holds, its dynamic shared memory in bytes) of the
    kernel's launch for M mics; 0 mics if not even one fits."""
    smem = ctypes.c_longlong()
    per_block = _build.load("aec").fused_aec_layout(cfg.num_block, cfg.block_len, M, ctypes.byref(smem))
    return per_block, smem.value


def _launch(farp, xp, cfg, out, upd, stream) -> int:
    """``aec_frames``' launch into out (and the decisions upd as float32
    0 / 1, where not None); its error code."""
    B, M, S = xp.shape
    hop = cfg.block_len
    params = _aec_params(cfg)
    return _build.load("aec").fused_aec_launch(
        farp.data_ptr(), xp.data_ptr(), _tables(cfg.n_fft, xp.device).data_ptr(), out.data_ptr(),
        upd.data_ptr() if upd is not None else None, cfg.num_block, B, M, S // hop, hop,
        ctypes.addressof(params), stream,
    )


def aec_frames(farp: torch.Tensor, xp: torch.Tensor, cfg, decisions: bool = False):
    """The K7 kernel: ``aec_frames_plain``'s recursion, one block per
    utterance (all its mics, or as many as the block's shared memory holds).
    CPU tensors run ``aec_frames_plain``; CUDA tensors launch the kernel
    (float32, contiguous) or raise."""
    if xp.device.type == "cpu":
        return aec_frames_plain(farp, xp, cfg, decisions)
    with span("ds.k7.launch"):
        _check_cfg(cfg)
        _build.check_tensors("fused_aec", farp, xp)
        B, M, S = xp.shape
        if farp.shape != (B, S) or S % cfg.block_len:
            raise ValueError("fused_aec: farp must be [B, S'] and xp [B, M, S'] with S' whole blocks")
        out = torch.empty_like(xp)
        upd = torch.empty((B, M, S // cfg.block_len), dtype=torch.float32, device=xp.device) if decisions else None
        err = _launch(farp, xp, cfg, out, upd, torch.cuda.current_stream(xp.device).cuda_stream)
        _build.check_launch("aec", err, "fused_aec")
        count("launch.fused_aec")
    return (out, upd > 0.5) if decisions else out


def fused_aec(far, x, cfg=None):
    """Fused AEC over whole utterances: far [B, S] shared far end, x
    [B, M, S] mics -> echo-free [B, M, S'] with S' = T * block_len
    (``aec_step`` semantics, batched over the mic axis as in
    ``runtime.full_stack``).  Tensors stay on their device; other inputs go
    to the card."""
    cfg = _default_cfg() if cfg is None else cfg
    with span("ds.k7.prepare"):
        farp, xp = _prepare(wrapper_input(far), wrapper_input(x), cfg)
        farp, xp = farp.contiguous(), xp.contiguous()
    return aec_frames(farp, xp, cfg)
