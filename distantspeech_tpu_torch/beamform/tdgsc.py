"""Time-domain GSC: alignment -> mean FBF -> pairwise BM -> FLMS AIC.

Counterpart of ``distantspeech_tpu/beamform/tdgsc.py``.  Per frame_len
block: DC notch each mic, fractional-delay time alignment, fixed
beamformer = channel mean, pairwise-difference blocking matrix, and a
non-causal FLMS interference canceller stepped per bin by (1 - p) from an
MCRA tracker (L=65) on the FBF spectrum; optionally the OM-LSA-multi
postfilter applied as sqrt(G) through a streaming STFT round trip.

The frame-independent front end (notch, alignment, FBF, BM) runs over the
whole signal at once (``ops.cuda_flms.front_end``); only the recursive
parts (MCRA, FLMS, OM-LSA, the transform carries) run per frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import check_unroll, resolve_device
from distantspeech_tpu_torch.adaptive.flms import FlmsConfig, FlmsState, flms_init, flms_step
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.noise.mcra import McraConfig, McraState, mcra_init, mcra_step
from distantspeech_tpu_torch.noise.omlsa import OmlsaConfig, OmlsaState, omlsa_init, omlsa_step
from distantspeech_tpu_torch.ops.cuda_flms import front_end, fused_tdgsc
from distantspeech_tpu_torch.transform import StftConfig, istft_stream, stft_stream


@dataclasses.dataclass(frozen=True)
class TdGscConfig:
    n_mics: int = 4
    frame_len: int = 256
    fir_truncate: int = 30
    postfilter: bool = False
    # additionally gate the canceller's step on MCRA's raw speech indicator
    # S/Smin <= delta_s (the GSC-family analogue of MvdrConfig.vad_guard):
    # MCRA forces p = 0 for its first 2L = 130 frames, so on captures that
    # start mid-speech the canceller would adapt at full rate on the target
    # and cancel it through blocking-matrix leakage.  False matches the
    # reference exactly.
    vad_guard: bool = False

    @property
    def stft(self) -> StftConfig:
        # the MCRA and postfilter transforms run at n_fft = 2 frame_len, hop = frame_len
        return StftConfig(self.frame_len * 2, self.frame_len)

    @property
    def half_bin(self) -> int:
        return self.frame_len + 1

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.frame_len * 2, L=65)

    @property
    def aic(self) -> FlmsConfig:
        return FlmsConfig(filter_len=self.frame_len, n_channels=self.n_mics - 1, non_causal=True)

    @property
    def omlsa(self) -> OmlsaConfig:
        return OmlsaConfig(nfft=self.frame_len * 2, n_channels=self.n_mics)


class TdGscState(NamedTuple):
    stft_fbf: torch.Tensor  # MCRA-transform input carry [..., L]
    mcra: McraState
    aic: FlmsState
    omlsa: OmlsaState
    stft_y: torch.Tensor  # postfilter analysis carry [..., L]
    stft_bm: torch.Tensor  # postfilter reference carry [..., M-1, L]
    istft_y: torch.Tensor  # postfilter synthesis carry [..., L]


def tdgsc_init(cfg: TdGscConfig, batch_shape=(), dtype=torch.float32, device=None) -> TdGscState:
    dev = resolve_device(device)
    L, C = cfg.frame_len, cfg.n_mics
    z = torch.zeros((*batch_shape, L), dtype=dtype, device=dev)
    return TdGscState(
        stft_fbf=z,
        mcra=mcra_init(cfg.mcra, batch_shape, dtype=dtype, device=dev),
        aic=flms_init(cfg.aic, batch_shape, dtype=dtype, device=dev),
        omlsa=omlsa_init(cfg.omlsa, batch_shape, dtype=dtype, device=dev),
        stft_y=z,
        stft_bm=torch.zeros((*batch_shape, C - 1, L), dtype=dtype, device=dev),
        istft_y=z,
    )


def tdgsc_step(cfg: TdGscConfig, state: TdGscState, fbf: torch.Tensor, bm: torch.Tensor):
    """One frame_len block.  fbf: [..., L] fixed-beamformer block; bm:
    [..., M-1, L] blocking-matrix block.  Returns (state, (output [..., L],
    p [..., F]))."""
    scfg = cfg.stft
    stft_fbf, D = stft_stream(state.stft_fbf, fbf, scfg)  # [..., 1, F]
    mcra_state, (_, p) = mcra_step(cfg.mcra, state.mcra, D[..., 0, :].abs() ** 2)

    gate = 1.0 - p
    if cfg.vad_guard:
        gate = gate * (mcra_state.S / (mcra_state.Smin + 1e-6) <= cfg.mcra.delta_s)
    aic_state, (out, _) = flms_step(cfg.aic, state.aic, bm, fbf, p=gate[..., None, :], fir_truncate=cfg.fir_truncate)

    omlsa_state, stft_y, stft_bm, istft_y = state.omlsa, state.stft_y, state.stft_bm, state.istft_y
    if cfg.postfilter:
        stft_y, Y = stft_stream(state.stft_y, out, scfg)  # [..., 1, F]
        stft_bm, U = stft_stream(state.stft_bm, bm, scfg)  # [..., M-1, 1, F]
        omlsa_state, (_, _, G) = omlsa_step(cfg.omlsa, state.omlsa, Y[..., 0, :].abs() ** 2, U[..., 0, :].abs() ** 2)
        Yg = Y[..., 0, :] * torch.sqrt(G)
        istft_y, out = istft_stream(state.istft_y, Yg[..., None, :], scfg)

    new_state = TdGscState(
        stft_fbf=stft_fbf, mcra=mcra_state, aic=aic_state,
        omlsa=omlsa_state, stft_y=stft_y, stft_bm=stft_bm, istft_y=istft_y,
    )
    return new_state, (out, p)


def tdgsc_process(
    x, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    cfg: TdGscConfig = TdGscConfig(), unroll: int = 1, backend: str = "scan", device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Offline TDGSC.  x: [..., M, S] -> (output [..., S'], p [..., T, F],
    bm_output [..., M-1, S']) with S' = T * frame_len.

    backend: 'scan' (the per-frame ``tdgsc_step`` loop, any batch shape) or
    'fused' (kernel K5, ``ops.cuda_flms.fused_tdgsc``; x [B, M, S];
    ``postfilter`` selects its postfilter variant).  On a CPU tensor
    'fused' runs the kernel's plain PyTorch version.  ``unroll`` is JAX's
    scan hint, inert here (``_device.check_unroll``)."""
    check_unroll(unroll)
    x = torch.as_tensor(x, device=resolve_device(device))
    if backend == "fused":
        return fused_tdgsc(x, geometry, angle_rad, cfg)
    if backend != "scan":
        raise ValueError(f"backend must be 'scan' or 'fused', got {backend!r}")
    L = cfg.frame_len
    T = x.shape[-1] // L
    fbf, bm = front_end(x, geometry, angle_rad, cfg)
    state = tdgsc_init(cfg, batch_shape=x.shape[:-2], dtype=x.dtype, device=x.device)
    outs, ps = [], []
    for t in range(T):
        state, (out, p) = tdgsc_step(cfg, state, fbf[..., t * L : (t + 1) * L], bm[..., t * L : (t + 1) * L])
        outs.append(out)
        ps.append(p)
    return torch.cat(outs, dim=-1), torch.stack(ps, dim=-2), bm[..., : T * L]
