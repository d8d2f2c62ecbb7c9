"""Fused flagship paths: STFT -> MCRA -> gated MVDR -> OM-LSA -> ISTFT.

Counterpart of ``distantspeech_tpu/ops/pallas_enhance.py``.  Two CUDA
kernels (``csrc/enhance.cu``, lane math in ``csrc/enhance_lane.cuh``)
replace its Pallas kernels:

- ``fused_enhance`` replaces ``pallas_enhance.fused_enhance`` (``_enhance_kernel``
  and its Nyquist companion).  The windowed DFT, the 3-tap MCRA
  cross-bin smoothing ``Sf`` and the inverse DFT are matrix products
  outside the kernel, as in the JAX package; the kernel ``enhance_lanes``
  runs a lane per (utterance, bin), looping over every frame with the
  lane's state in registers: MCRA, the covariance gate (``p < p_vad``, and
  ``S/Smin <= delta_s`` with ``vad_guard``), the MVDR update and solve and
  the OM-LSA gain.  Up to 16 mics a thread pair (above 8 mics 4 threads)
  runs a lane, the rows of its covariance (then its factors) split between
  them; above, one thread a lane on a memory lane.
- ``fused_enhance_full`` replaces ``pallas_enhance.fused_enhance_full``
  (``_mega_kernel`` and its Nyquist companion): waveform [B, M, S] in,
  waveform [B, S] out, one block per utterance.  Framing, the windowed
  analysis (the mics in pairs through complex FFTs), the smoothing, the
  lane recursion, the inverse FFT and the overlap-add all run in the block,
  the transforms of frames t + 1 and t - 1 on warps of their own while the
  lane warps run frame t; the spectra never reach device memory.

Both run in float32 and treat the F = n_fft/2 + 1 bins uniformly (the TPU
kernel's Nyquist companion call and lane packing are not needed); bin F-1
keeps its MCRA semantics (p at its floor, noise PSD pinned at 1e-8 before
each update, gate open).  ``inv_mode='rank1'`` (kernel K3 of the JAX
package, a mode of both kernels) runs ``warm_chunks = ceil(64 / t_chunk)``
chunks of exact per-frame LDL^H, factors the covariance in place, then
applies Bennett rank-1 factor updates, re-anchoring the ``rel_diag``
loading at every steady chunk start after the first.  ``t_chunk`` is
therefore part of the semantics, not a tiling: kernel and plain version
take the same value.

Bounds on an H100 at the flagship size (B=64, M=8, 4 s): the mega kernel
moves 147 MB (0.04 ms at 3.35 TB/s) and does ~5.5e9 float32 operations
with its transforms counted as real FFTs (~0.08 ms at 67 TFLOP/s), so
operations bound it; the lane kernel alone moves 314 MB of spectra for
~4e9 operations, so bytes bound it (~0.09 ms).  Both run a per-lane
recursion with the state in registers, a serial chain of frames that
neither bound counts; chip_smoke.py computes the bounds and times both.

On a CPU tensor the wrappers run ``fused_enhance_plain`` (one dtype-generic
plain-PyTorch function with the semantics of both kernels); on a CUDA
tensor they launch the kernel or raise.  Each launch counts
``launch.<wrapper>`` in ``runtime.profiling``'s registry.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from distantspeech_tpu_torch.noise.mcra import _freq_smooth
from distantspeech_tpu_torch.ops import _build
from distantspeech_tpu_torch.ops.cuda_mvdr import (
    _LaneParams,
    _ldl_factor_into,
    _mcra_params,
    _mvdr_output,
    _mvdr_update_ldl,
    _mvdr_update_rank1,
    _omlsa_gain,
    _refresh_loading,
)
from distantspeech_tpu_torch.ops.framing import overlap_add
from distantspeech_tpu_torch.runtime.profiling import count, span
from distantspeech_tpu_torch.transform.stft import _dft_matrices, _idft_matrices

# inv_mode='rank1': frames of exact per-frame LDL^H before the Bennett
# handover, rounded up to whole frame chunks
_RANK1_WARM_FRAMES = 64


def _pick_t_chunk(T: int, cap: int = 64):
    """Largest divisor of T that is <= cap, or None if every such divisor is
    below 8."""
    for tc in range(min(cap, T), 7, -1):
        if T % tc == 0:
            return tc
    return None


def _warm_chunks(t_chunk: int) -> int:
    return max(1, -(-_RANK1_WARM_FRAMES // t_chunk))


def _prepare(x: torch.Tensor, steer, cfg, t_chunk, inv_mode):
    """Validate, drop the sub-hop tail, and return (x, steering planes
    [M, 2, F] in x's dtype, t_chunk)."""
    stft = cfg.stft
    if inv_mode not in ("ldl", "rank1"):
        raise ValueError(f"inv_mode must be 'ldl' or 'rank1', got {inv_mode!r}")
    if stft.n_fft != 2 * stft.hop:
        raise ValueError("the fused paths need 50% overlap (n_fft == 2*hop)")
    if x.ndim != 3:
        raise ValueError(f"the fused paths need x of shape [B, M, S], got {tuple(x.shape)}")
    x = x[..., : x.shape[-1] // stft.hop * stft.hop]
    T = x.shape[-1] // stft.hop
    if T < 1:
        raise ValueError(f"x needs at least one hop ({stft.hop} samples)")
    with span("ds.prep.steering"):
        steer = torch.as_tensor(steer)
        if steer.shape != (stft.half_bin, x.shape[1]):
            raise ValueError(f"steer must be [F, M] = {(stft.half_bin, x.shape[1])}, got {tuple(steer.shape)}")
        planes = torch.stack([steer.real.T, steer.imag.T], dim=1).to(device=x.device, dtype=x.dtype).contiguous()
        if steer.device.type == "cpu" and x.device.type == "cuda":  # from pageable memory: waits for the stream
            count("host_sync.prep.steering")
    tc = t_chunk or _pick_t_chunk(T) or 64
    return x, planes, tc


@functools.lru_cache(maxsize=16)
def _dft_operators(stft, dtype, device):
    """(CS [n_fft, 2F], AB [2F, n_fft]): the windowed forward DFT as
    [cos | sin] columns and the windowed inverse as [A ; B] rows, with the
    structural zeros (sin of 0 and pi) exact.  Built once per config, dtype
    and device."""
    F = stft.half_bin
    C, Sn = _dft_matrices(stft)
    A, Bm = _idft_matrices(stft)
    Sn[:, 0] = Sn[:, F - 1] = 0.0
    Bm[0] = Bm[F - 1] = 0.0
    CS = torch.as_tensor(np.concatenate([C, Sn], axis=1), dtype=dtype, device=device)
    AB = torch.as_tensor(np.concatenate([A, Bm], axis=0), dtype=dtype, device=device)
    return CS, AB


def _analysis_planes(x: torch.Tensor, stft) -> torch.Tensor:
    """Windowed DFT of every frame, [B, M, S] -> Z [T, M, 2, B, F] (real and
    imaginary planes, lane index b*F + k contiguous).  Frame t is hop-blocks
    t-1 and t of the signal (zeros before it): two half-frame products."""
    B, M, S = x.shape
    F, hop = stft.half_bin, stft.hop
    T = S // hop
    CS, _ = _dft_operators(stft, x.dtype, x.device)
    blocks = torch.nn.functional.pad(x, (hop, 0)).reshape(B, M, T + 1, hop)
    Y = blocks[:, :, :-1] @ CS[:hop] + blocks[:, :, 1:] @ CS[hop:]  # [B, M, T, 2F]
    return Y.reshape(B, M, T, 2, F).permute(2, 1, 3, 0, 4).contiguous()


def _smoothed_power(Z: torch.Tensor, b) -> torch.Tensor:
    """MCRA's 3-tap cross-bin smoothing of the mic-0 power: Sf [T, B, F]."""
    return _freq_smooth(Z[:, 0, 0] ** 2 + Z[:, 0, 1] ** 2, b)


def _synthesis_planes(Y: torch.Tensor, stft) -> torch.Tensor:
    """Inverse windowed DFT + overlap-add: Y [T, 2, B, F] -> y [B, T*hop],
    scaled by the reference's hop / W0."""
    T, _, B, F = Y.shape
    _, AB = _dft_operators(stft, Y.dtype, Y.device)
    frames = Y.permute(2, 0, 1, 3).reshape(B, T, 2 * F) @ AB  # [B, T, n_fft]
    return overlap_add(frames, stft.hop)[..., : stft.hop * T] * stft.synthesis_gain


def _bin_masks(F: int, device):
    """MCRA's bin classes (interior, lead, first, last) as [F] masks."""
    k = torch.arange(F, device=device)
    return (k >= 1) & (k <= F - 2), k <= F - 2, k == 0, k == F - 1


def _mcra_frame(tg, Yp, Sf_t, st, bins, mc):
    """One MCRA frame on [B, F] lanes at global frame ``tg`` (the counters
    ell / frm_cnt of ``noise.mcra`` in closed form: the minima window
    resets at tg % L == L-1, p is forced to 0 for tg < 2L, frame 0 seeds).
    Updates ``st`` and returns (p, lambda_d, S/Smin)."""
    interior, lead, first, last = bins
    if tg == 0:
        S, Smin = st["S"], torch.where(lead, Yp, st["Smin"])
        Stmp = torch.where(lead, Yp, st["Stmp"])
        p_sel = torch.where(lead, torch.zeros_like(Yp), st["P"])
        lam_pre = torch.where(lead, Yp, st["Lam"])
    else:
        S = torch.where(interior, mc.alpha_s * st["S"] + (1.0 - mc.alpha_s) * Sf_t, st["S"])
        Smin1 = torch.minimum(st["Smin"], S)
        Stmp1 = torch.minimum(st["Stmp"], S)
        if tg % mc.L == mc.L - 1:
            Smin1, Stmp1 = torch.minimum(Stmp1, S), S
        Smin = torch.where(interior, Smin1, st["Smin"])
        Stmp = torch.where(interior, Stmp1, st["Stmp"])
        if tg < 2 * mc.L:
            p_upd = torch.zeros_like(Yp)
        else:
            I = (S / (Smin + 1e-6) > mc.delta_s).to(Yp.dtype)
            p_upd = mc.alpha_p * st["P"] + (1.0 - mc.alpha_p) * I
        p_sel = torch.where(first, 0.0, torch.where(interior, p_upd, st["P"]))
        lam_pre = st["Lam"]
    p = torch.clamp(p_sel, mc.p_min, mc.p_max)
    lam_pre = torch.where(last, 1e-8, lam_pre)
    alpha_t = mc.alpha_d + (1.0 - mc.alpha_d) * p
    lam = alpha_t * lam_pre + (1.0 - alpha_t) * Yp
    st.update(S=S, Smin=Smin, Stmp=Stmp, P=p, Lam=lam)
    return p, lam, S / (Smin + 1e-6)


def enhance_lanes_plain(Z, Sf, steer_planes, cfg, t_chunk: int, inv_mode: str = "ldl") -> torch.Tensor:
    """Plain version of the ``enhance_lanes`` kernel: the per-lane frame
    recursion over spectra Z [T, M, 2, B, F] and smoothed power Sf [T, B, F]
    with steering planes [M, 2, F].  Returns the gained spectra [T, 2, B, F]
    in Z's dtype."""
    T, M, _, B, F = Z.shape
    mv, mc = cfg.mvdr, cfg.mvdr.mcra
    bins = _bin_masks(F, Z.device)
    ar = [steer_planes[m, 0] for m in range(M)]
    ai = [steer_planes[m, 1] for m in range(M)]
    zero = Z.new_zeros((B, F))
    Rr = [[zero] * M for _ in range(M)]
    Ri = [[zero] * M for _ in range(M)]
    Ur, Ui = [zero] * M, [zero] * M
    st = dict(S=zero, Smin=zero, Stmp=zero, P=zero, Lam=zero)
    Gh = Gam = torch.ones_like(zero)
    Ld = None
    rank1 = inv_mode == "rank1"
    refresh = rank1 and bool(mv.rel_diag)
    warm = _warm_chunks(t_chunk)
    out = Z.new_empty((T, 2, B, F))
    for t in range(T):
        chunk, pos = divmod(t, t_chunk)
        steady = rank1 and chunk >= warm
        if steady and refresh and pos == 0 and chunk >= warm + 1:
            Ld = _refresh_loading(Rr, Ri, Ld, M, mv.diag, mv.rel_diag)
        zr = [Z[t, m, 0] for m in range(M)]
        zi = [Z[t, m, 1] for m in range(M)]
        p, lam, sr = _mcra_frame(t, zr[0] * zr[0] + zi[0] * zi[0], Sf[t], st, bins, mc)
        upd = p < mv.p_vad
        if mv.vad_guard:
            upd = upd & (sr <= mc.delta_s)
        if steady:
            Ld = _mvdr_update_rank1(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, mv.alpha_v, Ld=Ld)
        else:
            _mvdr_update_ldl(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, mv.alpha_v, mv.diag, mv.rel_diag)
        yr, yi = _mvdr_output(zr, zi, ar, ai, Ur, Ui, M)
        (out[t, 0], out[t, 1]), Gh, Gam = _omlsa_gain(yr, yi, p, lam, Gh, Gam, cfg.alpha_xi, cfg.gmin)
        if rank1 and chunk == warm - 1 and pos == t_chunk - 1:  # handover: factor in place
            load = _ldl_factor_into(Rr, Ri, M, mv.diag, mv.rel_diag)
            if refresh:
                Ld = load
    return out


def fused_enhance_plain(x: torch.Tensor, steer, cfg, t_chunk: int = None, inv_mode: str = "ldl") -> torch.Tensor:
    """Plain-PyTorch version of both kernels (any float dtype, any device):
    x [B, M, S] -> y [B, T*hop] with T = S // hop."""
    x, planes, tc = _prepare(x, steer, cfg, t_chunk, inv_mode)
    Z = _analysis_planes(x, cfg.stft)
    Y = enhance_lanes_plain(Z, _smoothed_power(Z, cfg.mvdr.mcra.b), planes, cfg, tc, inv_mode)
    return _synthesis_planes(Y, cfg.stft)


# ---- the CUDA side ----------------------------------------------------------


def _lane_params(cfg, M: int, t_chunk: int, inv_mode: str) -> _LaneParams:
    mv, mc = cfg.mvdr, cfg.mvdr.mcra
    rank1 = inv_mode == "rank1"
    return _LaneParams(
        mc=_mcra_params(mc),
        b0=mc.b[0], b1=mc.b[1], b2=mc.b[2],
        alpha_v=mv.alpha_v, beta_v=1.0 - mv.alpha_v,
        ba_v=(1.0 - mv.alpha_v) / mv.alpha_v, inv_alpha_v=1.0 / mv.alpha_v,
        diag=mv.diag, rel_diag_m=mv.rel_diag / M, p_vad=mv.p_vad,
        alpha_xi=cfg.alpha_xi, one_m_alpha_xi=1.0 - cfg.alpha_xi,
        gmin=cfg.gmin, log_gmin=float(np.log(cfg.gmin)),
        vad_guard=int(mv.vad_guard), rank1=int(rank1), refresh=int(rank1 and bool(mv.rel_diag)),
        t_chunk=t_chunk, warm_chunks=_warm_chunks(t_chunk),
    )


def _lanes_launch(Z, Sf, steer_planes, cfg, t_chunk: int, inv_mode: str, Y, scratch, stream) -> int:
    """``enhance_lanes``' launch into Y with the scratch (or None) that
    ``fused_enhance_scratch_floats`` asks; its error code."""
    T, M, _, B, F = Z.shape
    params = _lane_params(cfg, M, t_chunk, inv_mode)
    return _build.load("enhance").fused_enhance_launch(
        Z.data_ptr(), Sf.data_ptr(), steer_planes.data_ptr(), Y.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, M, B, F, T, ctypes.addressof(params), stream,
    )


def enhance_lanes(Z, Sf, steer_planes, cfg, t_chunk: int, inv_mode: str = "ldl") -> torch.Tensor:
    """The ``fused_enhance`` kernel: per-lane recursion over spectra
    Z [T, M, 2, B, F] and Sf [T, B, F] -> gained spectra [T, 2, B, F].
    Any M >= 2: above 16 mics the lane states live in shared memory, or in a
    global scratch where they do not fit (M > 27).
    CPU tensors run ``enhance_lanes_plain``."""
    if Z.device.type == "cpu":
        return enhance_lanes_plain(Z, Sf, steer_planes, cfg, t_chunk, inv_mode)
    _build.check_tensors("fused_enhance", Z, Sf, steer_planes)
    T, M, _, B, F = Z.shape
    if M < 2:
        raise ValueError(f"fused_enhance: the kernel takes M >= 2 mics, got M={M}")
    if Sf.shape != (T, B, F) or steer_planes.shape != (M, 2, F):
        raise ValueError("fused_enhance: Sf must be [T, B, F] and steer_planes [M, 2, F]")
    Y = torch.empty((T, 2, B, F), dtype=torch.float32, device=Z.device)
    n_scratch = _build.load("enhance").fused_enhance_scratch_floats(M, B, F)  # lane states above 8 mics
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=Z.device) if n_scratch > 0 else None
    err = _lanes_launch(Z, Sf, steer_planes, cfg, t_chunk, inv_mode, Y, scratch,
                        torch.cuda.current_stream(Z.device).cuda_stream)
    _build.check_launch("enhance", err, "fused_enhance")
    count("launch.fused_enhance")
    return Y


def fused_enhance(x: torch.Tensor, steer, cfg, t_chunk: int = None, inv_mode: str = "ldl") -> torch.Tensor:
    """Time-domain flagship pipeline with the lane recursion in one kernel:
    x [B, M, S] -> y [B, T*hop].  Analysis, smoothing and synthesis are
    matrix products around ``enhance_lanes``.  steer: [F, M] complex."""
    x, planes, tc = _prepare(x, steer, cfg, t_chunk, inv_mode)
    Z = _analysis_planes(x, cfg.stft)
    Y = enhance_lanes(Z, _smoothed_power(Z, cfg.mvdr.mcra.b).contiguous(), planes, cfg, tc, inv_mode)
    return _synthesis_planes(Y, cfg.stft)


@functools.lru_cache(maxsize=16)
def _dft_tables(stft, device) -> torch.Tensor:
    """[3, n_fft] float32: the analysis/synthesis window, cos(2 pi j / N) and
    sin(2 pi j / N), with the exact zeros of cos and sin kept exact."""
    N = stft.n_fft
    ang = 2.0 * np.pi * np.arange(N) / N
    c, s = np.cos(ang), np.sin(ang)
    c[np.abs(c) < 1e-12] = 0.0
    s[np.abs(s) < 1e-12] = 0.0
    return torch.as_tensor(np.stack([stft.window, c, s]), dtype=torch.float32, device=device)


def _full_launch(x, steer_planes, cfg, t_chunk: int, inv_mode: str, y, scratch, stream) -> int:
    """``fused_enhance_full``'s launch into y with B times the scratch (or
    None) that ``fused_enhance_full_scratch_floats`` asks; its error code."""
    B, M, S = x.shape
    stft = cfg.stft
    params = _lane_params(cfg, M, t_chunk, inv_mode)
    return _build.load("enhance").fused_enhance_full_launch(
        x.data_ptr(), _dft_tables(stft, x.device).data_ptr(), steer_planes.data_ptr(), y.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, M, B, stft.n_fft, S // stft.hop,
        stft.synthesis_gain, ctypes.addressof(params), stream,
    )


def fused_enhance_full(x: torch.Tensor, steer, cfg, t_chunk: int = None, inv_mode: str = "ldl") -> torch.Tensor:
    """The whole flagship pipeline in one kernel: x [B, M, S] -> y [B, T*hop].
    steer: [F, M] complex; any M >= 2 and any n_fft that is a multiple of
    256, as the JAX kernel takes.  CPU tensors run ``fused_enhance_plain``."""
    if x.device.type == "cpu":
        return fused_enhance_plain(x, steer, cfg, t_chunk, inv_mode)
    x, planes, tc = _prepare(x, steer, cfg, t_chunk, inv_mode)
    with span("ds.k4.launch"):
        x = x.contiguous()
        _build.check_tensors("fused_enhance_full", x)
        B, M, S = x.shape
        n_fft = cfg.stft.n_fft
        # floats of scratch a block for the lane states that fit no block; -1: a shape it does not take
        n_scratch = _build.load("enhance").fused_enhance_full_scratch_floats(M, n_fft)
        if n_scratch < 0:
            raise ValueError(f"fused_enhance_full: the kernel takes M >= 2 and n_fft a multiple of 256, "
                             f"got M={M}, n_fft={n_fft}; backend='fused' runs any")
        y = torch.empty((B, S), dtype=torch.float32, device=x.device)
        scratch = torch.empty((B * n_scratch,), dtype=torch.float32, device=x.device) if n_scratch > 0 else None
        err = _full_launch(x, planes, cfg, tc, inv_mode, y, scratch, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check_launch("enhance", err, "fused_enhance_full")
        count("launch.fused_enhance_full")
    return y
