"""Subband GSC: subband-LMS blocking matrix + multichannel subband-LMS AIC.

Counterpart of ``distantspeech_tpu/beamform/subband_gsc.py``.  Per
frame_len block: DC notch, fractional-delay alignment, McSpp speech
presence from the aligned spectra, a per-mic subband NLMS blocking matrix
estimating the FBF -> mic transfer (p-gated), a frame_len delay on the FBF
path, and a [bin, tap, mic] subband NLMS interference canceller gated by
1 - p.  Every subband filter runs through an STFT round trip with
n_fft = 2 frame_len, hop = frame_len.

The M per-mic BM filters and their transforms batch over a leading mic
axis.  Offline, the input-only transforms (aligned spectra, FBF, delayed
FBF) are computed over the whole utterance in bulk; only the recursive core
runs frame by frame.  ``unroll``, JAX's numerically inert scan hint, is
dropped.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.adaptive.subband import (
    SubbandAfConfig,
    SubbandLmsState,
    subband_lms_init,
    subband_lms_mc_step,
    subband_lms_step,
)
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.noise.mcspp import McSppConfig, McSppState, mcspp_init, mcspp_step
from distantspeech_tpu_torch.ops.cuda_flms import aligned_mics
from distantspeech_tpu_torch.ops.cuda_sgsc import fused_subband_gsc
from distantspeech_tpu_torch.ops.delay import delay_samples
from distantspeech_tpu_torch.transform import StftConfig, istft_stream, stft_frames, stft_stream


@dataclasses.dataclass(frozen=True)
class SubbandGscConfig:
    n_mics: int = 4
    frame_len: int = 256
    aic_freeze_thresh: float = 0.0  # > 0: hard-freeze the AIC where p exceeds it
    aic_warmup_frames: int = 0  # > 0: freeze the AIC for the first N frames

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.frame_len * 2, self.frame_len)

    @property
    def half_bin(self) -> int:
        return self.frame_len + 1

    @property
    def spp(self) -> McSppConfig:
        return McSppConfig(nfft=self.frame_len * 2, n_channels=self.n_mics)

    @property
    def bm(self) -> SubbandAfConfig:
        return SubbandAfConfig(num_bands=self.frame_len * 2, filter_len=2, mu=0.1)

    @property
    def aic(self) -> SubbandAfConfig:
        return SubbandAfConfig(num_bands=self.frame_len * 2, filter_len=2, n_channels=self.n_mics, mu=0.01, alpha=0.8)


class SubbandGscCoreState(NamedTuple):
    """The recursive part: McSpp, the two subband filters and their
    output-side transform carries."""

    spp: McSppState
    bm: SubbandLmsState  # leading mic axis
    istft_bm: torch.Tensor  # BM error synthesis carries [..., M, L]
    aic: SubbandLmsState
    stft_aic_x: torch.Tensor  # AIC input (BM output) carry [..., M, L]
    istft_aic: torch.Tensor  # AIC error synthesis carry [..., L]


class SubbandGscState(NamedTuple):
    """Streaming state: the input-side transform carries and the core."""

    stft_al: torch.Tensor  # aligned-spectra carry [..., M, L]
    stft_fbf: torch.Tensor  # FBF analysis carry [..., L]
    delay_fbf: torch.Tensor  # [..., L]
    stft_fbf_d: torch.Tensor  # delayed-FBF analysis carry [..., L]
    core: SubbandGscCoreState


def _cdtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def subband_gsc_core_init(cfg: SubbandGscConfig, batch_shape=(), dtype=torch.float32, device=None) -> SubbandGscCoreState:
    dev = resolve_device(device)
    L, M = cfg.frame_len, cfg.n_mics
    cdtype = _cdtype(dtype)
    z = lambda *s: torch.zeros((*batch_shape, *s), dtype=dtype, device=dev)
    return SubbandGscCoreState(
        spp=mcspp_init(cfg.spp, batch_shape, cdtype=cdtype, device=dev),
        bm=subband_lms_init(cfg.bm, (*batch_shape, M), cdtype=cdtype, device=dev),
        istft_bm=z(M, L),
        aic=subband_lms_init(cfg.aic, batch_shape, cdtype=cdtype, device=dev),
        stft_aic_x=z(M, L),
        istft_aic=z(L),
    )


def subband_gsc_init(cfg: SubbandGscConfig, batch_shape=(), dtype=torch.float32, device=None) -> SubbandGscState:
    dev = resolve_device(device)
    L, M = cfg.frame_len, cfg.n_mics
    z = lambda *s: torch.zeros((*batch_shape, *s), dtype=dtype, device=dev)
    return SubbandGscState(stft_al=z(M, L), stft_fbf=z(L), delay_fbf=z(L), stft_fbf_d=z(L),
                           core=subband_gsc_core_init(cfg, batch_shape, dtype=dtype, device=dev))


def subband_gsc_core_step(
    cfg: SubbandGscConfig, Fn: torch.Tensor, state: SubbandGscCoreState,
    D: torch.Tensor, Xf: torch.Tensor, Yf: torch.Tensor,
) -> Tuple[SubbandGscCoreState, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One frame_len block on precomputed input spectra.

    D: [..., M, F] aligned-mic spectra; Xf: [..., F] FBF spectrum; Yf:
    [..., F] frame_len-delayed FBF spectrum.  Fn: the McSpp CDR's diffuse
    pair coherence (``cfg.spp.mccdr.fn_pair()``).  Returns (state,
    (output [..., L], p [..., F], bm_out [..., M, L]))."""
    scfg = cfg.stft
    spp_state, spp_out = mcspp_step(cfg.spp, Fn, state.spp, torch.movedim(D, -2, -1))
    p = spp_out.p

    # blocking matrix: per-mic SubbandLMS (fbf -> mic), p-gated
    bm_state, e_bm = subband_lms_step(cfg.bm, state.bm, Xf[..., None, :].expand(D.shape), D, p=p[..., None, :])
    istft_bm, bm_out = istft_stream(state.istft_bm, e_bm[..., None, :], scfg)  # [..., M, L]

    # AIC: multichannel SubbandLmsMc (bm_out -> delayed fbf), (1 - p)-gated
    stft_aic_x, Uf = stft_stream(state.stft_aic_x, bm_out, scfg)  # [..., M, 1, F]
    gate = 1.0 - p
    if cfg.aic_freeze_thresh > 0.0:
        gate = gate * (p <= cfg.aic_freeze_thresh)
    if cfg.aic_warmup_frames > 0:
        gate = gate * float(state.spp.frm_cnt >= cfg.aic_warmup_frames)
    aic_state, e_aic = subband_lms_mc_step(cfg.aic, state.aic, torch.movedim(Uf[..., 0, :], -2, -1), Yf, p=gate)
    istft_aic, out = istft_stream(state.istft_aic, e_aic[..., None, :], scfg)

    new_state = SubbandGscCoreState(spp=spp_state, bm=bm_state, istft_bm=istft_bm, aic=aic_state,
                                    stft_aic_x=stft_aic_x, istft_aic=istft_aic)
    return new_state, (out, p, bm_out)


def subband_gsc_step(
    cfg: SubbandGscConfig, Fn: torch.Tensor, state: SubbandGscState, aligned: torch.Tensor
) -> Tuple[SubbandGscState, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One frame_len block from time-domain input (the streaming entry).
    aligned: [..., M, L] time-aligned mics.  Returns (state, (output
    [..., L], p [..., F], bm_out [..., M, L]))."""
    scfg = cfg.stft
    fbf = aligned.mean(dim=-2)
    stft_al, D = stft_stream(state.stft_al, aligned, scfg)  # [..., M, 1, F]
    stft_fbf, Xf = stft_stream(state.stft_fbf, fbf, scfg)  # [..., 1, F]
    delay_fbf, fbf_d = delay_samples(state.delay_fbf, fbf)
    stft_fbf_d, Yf = stft_stream(state.stft_fbf_d, fbf_d, scfg)
    core, out = subband_gsc_core_step(cfg, Fn, state.core, D[..., 0, :], Xf[..., 0, :], Yf[..., 0, :])
    return SubbandGscState(stft_al=stft_al, stft_fbf=stft_fbf, delay_fbf=delay_fbf, stft_fbf_d=stft_fbf_d,
                           core=core), out


def subband_gsc_process(
    x, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    cfg: SubbandGscConfig = SubbandGscConfig(), backend: str = "scan", device=None,
):
    """Offline SubbandGSC.  x: [..., M, S].

    Returns (output [..., S'], p [..., T, F], bm_output [..., M, S']) with
    S' = T * frame_len.

    backend: 'scan' (the per-frame core loop on bulk input spectra, any
    batch shape) or 'fused' (kernel K9, ``ops.cuda_sgsc.fused_subband_gsc``;
    x [B, 4, S]).  On a CPU tensor 'fused' runs the kernel's plain PyTorch
    version."""
    x = torch.as_tensor(x, device=resolve_device(device))
    if backend == "fused":
        return fused_subband_gsc(x, geometry, angle_rad, cfg)
    if backend != "scan":
        raise ValueError(f"backend must be 'scan' or 'fused', got {backend!r}")
    L = cfg.frame_len
    scfg = cfg.stft
    T = x.shape[-1] // L
    aligned = aligned_mics(x, geometry, angle_rad)[..., : T * L]
    fbf = aligned.mean(dim=-2)
    fbf_d = torch.nn.functional.pad(fbf, (L, 0))[..., : T * L]
    pad = lambda a: torch.nn.functional.pad(a, (scfg.overlap, 0))
    D_all = stft_frames(pad(aligned), scfg)  # [..., M, T, F]
    Xf_all = stft_frames(pad(fbf), scfg)  # [..., T, F]
    Yf_all = stft_frames(pad(fbf_d), scfg)
    Fn = torch.as_tensor(cfg.spp.mccdr.fn_pair(), dtype=x.dtype, device=x.device)

    state = subband_gsc_core_init(cfg, batch_shape=x.shape[:-2], dtype=x.dtype, device=x.device)
    outs, ps, bms = [], [], []
    for t in range(T):
        state, (out, p, bm_out) = subband_gsc_core_step(cfg, Fn, state, D_all[..., t, :], Xf_all[..., t, :],
                                                        Yf_all[..., t, :])
        outs.append(out)
        ps.append(p)
        bms.append(bm_out)
    return torch.cat(outs, dim=-1), torch.stack(ps, dim=-2), torch.cat(bms, dim=-1)
