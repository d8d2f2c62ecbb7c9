"""Robust overlap-save frequency-domain GSC (Herbordt / Kellermann style).

Counterpart of ``distantspeech_tpu/beamform/fdgsc.py``.  Per frame_len
block: DC notch, fractional-delay alignment, mean FBF, an adaptive
blocking matrix (one CCAF-clamped FLMS per mic estimating the FBF -> mic
transfer), causality delays (aligned by L/2, FBF by L), and a
norm-constrained multichannel AIC stepped by the scalar ``1 - mean(p)`` of
an MCRA (L=60) track on the raw reference channel.

The reference's quirks are kept as the JAX package keeps them:

- the post-processing that pins the low 32 bins of p to >= 0.8 when the
  mean over bins 32..127 exceeds 0.8 mutates the *returned* p, and the AIC
  step is the mean of that mutated p;
- the BM filters update with p = 1;
- the postfilter (default off) applies OM-LSA-multi to the current frame.

The M per-mic BM filters run as one batched FLMS with a leading mic axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import check_unroll, resolve_device
from distantspeech_tpu_torch.adaptive.feature import dc_notch, dc_notch_init
from distantspeech_tpu_torch.adaptive.flms import FlmsConfig, FlmsState, flms_init
from distantspeech_tpu_torch.array.alignment import time_alignment_filters
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.beamform.gsc_filters import aic_step, bm_step
from distantspeech_tpu_torch.noise.mcra import McraConfig, McraState, mcra_init, mcra_step
from distantspeech_tpu_torch.noise.omlsa import OmlsaConfig, OmlsaState, omlsa_init, omlsa_step
from distantspeech_tpu_torch.ops.cuda_flms import fused_fdgsc
from distantspeech_tpu_torch.ops.delay import delay_samples
from distantspeech_tpu_torch.ops.fir import fir_filter_offline
from distantspeech_tpu_torch.transform import StftConfig, istft_stream, stft_stream


@dataclasses.dataclass(frozen=True)
class FdGscConfig:
    n_mics: int = 4
    frame_len: int = 256
    postfilter: bool = False

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.frame_len * 2, self.frame_len)

    @property
    def half_bin(self) -> int:
        return self.frame_len + 1

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.frame_len * 2, L=60)

    @property
    def bm(self) -> FlmsConfig:
        return FlmsConfig(filter_len=self.frame_len, mu=0.1, alpha=0.9)

    @property
    def aic(self) -> FlmsConfig:
        return FlmsConfig(filter_len=self.frame_len, n_channels=self.n_mics, mu=0.1, alpha=0.9)

    @property
    def omlsa(self) -> OmlsaConfig:
        return OmlsaConfig(nfft=self.frame_len * 2, n_channels=self.n_mics)


class FdGscState(NamedTuple):
    stft_x: torch.Tensor  # raw-input transform carry [..., M, L]
    mcra: McraState
    bm: FlmsState  # batched over a leading mic axis: [..., M, 1, *]
    aic: FlmsState
    delay_aligned: torch.Tensor  # [..., M, L/2]
    delay_fbf: torch.Tensor  # [..., L]
    omlsa: OmlsaState
    stft_y: torch.Tensor
    istft_y: torch.Tensor


def fdgsc_init(cfg: FdGscConfig, batch_shape=(), dtype=torch.float32, device=None) -> FdGscState:
    dev = resolve_device(device)
    L, M = cfg.frame_len, cfg.n_mics
    z = lambda *shape: torch.zeros((*batch_shape, *shape), dtype=dtype, device=dev)
    return FdGscState(
        stft_x=z(M, L),
        mcra=mcra_init(cfg.mcra, batch_shape, dtype=dtype, device=dev),
        bm=flms_init(cfg.bm, (*batch_shape, M), dtype=dtype, device=dev),
        aic=flms_init(cfg.aic, batch_shape, dtype=dtype, device=dev),
        delay_aligned=z(M, L // 2),
        delay_fbf=z(L),
        omlsa=omlsa_init(cfg.omlsa, batch_shape, dtype=dtype, device=dev),
        stft_y=z(L),
        istft_y=z(L),
    )


def fdgsc_step(
    cfg: FdGscConfig, state: FdGscState, x: torch.Tensor, aligned: torch.Tensor
) -> Tuple[FdGscState, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One frame_len block.  x: [..., M, L] raw mics; aligned: [..., M, L]
    time-aligned mics.  Returns (state, (output [..., L], p [..., F],
    bm_out [..., M, L]))."""
    scfg = cfg.stft
    fbf = aligned.mean(dim=-2)  # [..., L]

    stft_x, D = stft_stream(state.stft_x, x, scfg)  # [..., M, 1, F]
    mcra_state, (_, p) = mcra_step(cfg.mcra, state.mcra, D[..., 0, 0, :].abs() ** 2)

    # the returned-p mutation: pin the low 32 bins when the mid band is speech
    mid_mean = p[..., 32:128].mean(dim=-1, keepdim=True)
    low = p[..., :32]
    p_ret = torch.cat([torch.where(mid_mean > 0.8, torch.clamp(low, min=0.8), low), p[..., 32:]], dim=-1)

    delay_aligned, aligned_d = delay_samples(state.delay_aligned, aligned)
    delay_fbf, fbf_d = delay_samples(state.delay_fbf, fbf)

    # adaptive BM: per mic, input = fbf, desired = delayed aligned mic
    bm_in = fbf[..., None, None, :].expand(*aligned.shape[:-1], 1, fbf.shape[-1])
    bm_state, (bm_out, _) = bm_step(cfg.bm, state.bm, bm_in, aligned_d)  # e: [..., M, L]

    # AIC with the scalar step gate 1 - mean(p_ret)
    gate = 1.0 - p_ret.mean(dim=-1)
    aic_state, (out, _) = aic_step(cfg.aic, state.aic, bm_out, fbf_d, p=gate[..., None, None], weight_norm=True)

    omlsa_state, stft_y, istft_y = state.omlsa, state.stft_y, state.istft_y
    if cfg.postfilter:
        stft_y, Y = stft_stream(state.stft_y, out, scfg)
        omlsa_state, (_, _, G) = omlsa_step(cfg.omlsa, state.omlsa, Y[..., 0, :].abs() ** 2,
                                            D[..., :-1, 0, :].abs() ** 2)
        Yg = Y[..., 0, :] * torch.sqrt(G).to(Y.dtype)
        istft_y, out = istft_stream(state.istft_y, Yg[..., None, :], scfg)

    new_state = FdGscState(
        stft_x=stft_x, mcra=mcra_state, bm=bm_state, aic=aic_state,
        delay_aligned=delay_aligned, delay_fbf=delay_fbf,
        omlsa=omlsa_state, stft_y=stft_y, istft_y=istft_y,
    )
    return new_state, (out, p_ret, bm_out)


def fdgsc_process(
    x, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    cfg: FdGscConfig = FdGscConfig(), dc_notch_input: bool = True, unroll: int = 1,
    backend: str = "scan", device=None,
):
    """Offline FDGSC.  x: [..., M, S] -> (output [..., S'], p [..., T, F],
    bm_output [..., M, S']) with S' = T * frame_len.

    backend: 'scan' (the per-frame ``fdgsc_step`` loop, any batch shape) or
    'fused' (kernel K8, ``ops.cuda_flms.fused_fdgsc``; x [B, M, S], the
    postfilter off).  On a CPU tensor 'fused' runs the kernel's plain
    PyTorch version.  ``unroll`` is JAX's scan hint, inert here
    (``_device.check_unroll``)."""
    check_unroll(unroll)
    x = torch.as_tensor(x, device=resolve_device(device))
    if backend == "fused":
        return fused_fdgsc(x, geometry, angle_rad, cfg, dc_notch_input=dc_notch_input)
    if backend != "scan":
        raise ValueError(f"backend must be 'scan' or 'fused', got {backend!r}")
    L = cfg.frame_len
    if dc_notch_input:
        _, x = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype, device=x.device), x, radius=0.98)
    coeffs = torch.as_tensor(time_alignment_filters(geometry, angle_rad), dtype=x.dtype, device=x.device)
    aligned = fir_filter_offline(x, coeffs)

    T = x.shape[-1] // L
    state = fdgsc_init(cfg, batch_shape=x.shape[:-2], dtype=x.dtype, device=x.device)
    outs, ps, bms = [], [], []
    for t in range(T):
        blk = slice(t * L, (t + 1) * L)
        state, (out, p, bm_out) = fdgsc_step(cfg, state, x[..., blk], aligned[..., blk])
        outs.append(out)
        ps.append(p)
        bms.append(bm_out)
    return torch.cat(outs, dim=-1), torch.stack(ps, dim=-2), torch.cat(bms, dim=-1)
