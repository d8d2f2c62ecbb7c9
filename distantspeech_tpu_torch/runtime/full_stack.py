"""The full streaming front-end stack: AEC -> GSC -> OM-LSA postfilter,
with a KWS tap.

Counterpart of ``distantspeech_tpu/runtime/full_stack.py`` (the "full
streaming stack" configuration: AEC + GSC + postfilter + dual-mic KWS
front end, batched utterances).  One block step composes the package's
step functions:

1. the speex-style AEC cancels the far-end reference from every mic (the
   mono canceller batches over the mic axis);
2. a dual-mic KWS cleaner taps mics 0/1 of the AEC output as the hotword
   path;
3. the echo-free mics run through the time-domain GSC (DC notch,
   alignment, blocking matrix, FLMS canceller, optional OM-LSA postfilter).

Everything batches over leading axes.  The stages only feed forward, so
``full_stack_process(backend="fused")`` chains three whole-utterance
kernels: K7 ``fused_aec``, K6 ``fused_kws`` on its mics 0/1, K5
``fused_tdgsc`` on all of it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import check_unroll, resolve_device
from distantspeech_tpu_torch.adaptive.aec import AecConfig, AecState, aec_init, aec_step
from distantspeech_tpu_torch.adaptive.feature import DcNotchState, dc_notch, dc_notch_init
from distantspeech_tpu_torch.array.alignment import time_alignment_filters
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, TdGscState, tdgsc_init, tdgsc_step
from distantspeech_tpu_torch.kws.dual_mic import DualMicKwsConfig, DualMicKwsState, kws_init, kws_step
from distantspeech_tpu_torch.ops.cuda_aec import fused_aec
from distantspeech_tpu_torch.ops.cuda_flms import fused_kws, fused_tdgsc
from distantspeech_tpu_torch.ops.fir import fir_block_taps, fir_filter_block


@dataclasses.dataclass(frozen=True)
class FullStackConfig:
    n_mics: int = 4
    frame_len: int = 256
    aec: AecConfig = AecConfig(filter_len=512, num_block=2)
    postfilter: bool = True

    @property
    def gsc(self) -> TdGscConfig:
        return TdGscConfig(n_mics=self.n_mics, frame_len=self.frame_len, postfilter=self.postfilter)

    @property
    def kws(self) -> DualMicKwsConfig:
        return DualMicKwsConfig(frame_len=self.frame_len)


class FullStackState(NamedTuple):
    aec: AecState  # batched over the mic axis
    notch: DcNotchState
    fir_cache: torch.Tensor  # alignment FIR tail [..., M, K-1]
    gsc: TdGscState
    kws: DualMicKwsState


def full_stack_init(
    cfg: FullStackConfig, coeffs: np.ndarray, batch_shape=(), dtype=torch.float32, device=None
) -> FullStackState:
    dev = resolve_device(device)
    M, K = cfg.n_mics, coeffs.shape[-1]
    return FullStackState(
        aec=aec_init(cfg.aec, (*batch_shape, M), dtype=dtype, device=dev),
        notch=dc_notch_init((*batch_shape, M), dtype=dtype, device=dev),
        fir_cache=torch.zeros((*batch_shape, M, K - 1), dtype=dtype, device=dev),
        gsc=tdgsc_init(cfg.gsc, batch_shape, dtype=dtype, device=dev),
        kws=kws_init(cfg.kws, batch_shape, dtype=dtype, device=dev),
    )


def full_stack_step(
    cfg: FullStackConfig, coeffs: torch.Tensor, state: FullStackState, x: torch.Tensor, far_end: torch.Tensor,
) -> Tuple[FullStackState, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One frame_len block through the whole stack.  x: [..., M, L] mics;
    far_end: [..., L] playback reference; coeffs: the alignment filters
    [M, K], or their block matrix from ``fir_block_taps``.  cfg.aec's
    block_len must equal cfg.frame_len.  Returns (state, (enhanced [..., L],
    kws_clean [..., L], p [..., F]))."""
    # 1. echo cancellation on every mic (the far end broadcast across mics)
    aec_state, (echo_free, _) = aec_step(cfg.aec, state.aec, far_end[..., None, :].expand(x.shape), x)

    # 2. the KWS tap on mics 0/1 of the echo-free signal
    kws_state, kws_clean = kws_step(cfg.kws, state.kws, echo_free[..., 0, :], echo_free[..., 1, :])

    # 3. DC notch, time alignment, fixed BF, blocking matrix, FLMS GSC
    notch_state, xn = dc_notch(state.notch, echo_free, radius=0.98)
    fir_cache, aligned = fir_filter_block(state.fir_cache, xn, coeffs)
    fbf = aligned.mean(dim=-2)
    bm = aligned[..., :-1, :] - aligned[..., 1:, :]
    gsc_state, (out, p) = tdgsc_step(cfg.gsc, state.gsc, fbf, bm)

    new_state = FullStackState(aec=aec_state, notch=notch_state, fir_cache=fir_cache, gsc=gsc_state, kws=kws_state)
    return new_state, (out, kws_clean, p)


def full_stack_process(
    x, far_end, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    cfg: FullStackConfig = FullStackConfig(), unroll: int = 1, backend: str = "scan", device=None,
):
    """Offline run of the full stack.  x: [..., M, S]; far_end: [..., S].
    Returns (enhanced [..., S'], kws_clean [..., S'], p [..., T, F]) with
    S' = T * frame_len.

    backend: 'scan' (the per-frame ``full_stack_step`` loop, any batch
    shape) or 'fused' (x [B, M, S]: kernels K7, K6 and K5 chained, each over
    the whole utterance; exactly the scan's math, since the stages only feed
    forward).  On CPU tensors 'fused' runs the kernels' plain versions.
    ``unroll`` is JAX's scan hint, inert here (``_device.check_unroll``)."""
    check_unroll(unroll)
    if cfg.aec.block_len != cfg.frame_len:
        raise ValueError("aec.block_len must equal frame_len for the composed stack")
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    far_end = torch.as_tensor(far_end, device=dev)
    if backend == "fused":
        echo_free = fused_aec(far_end, x, cfg.aec)
        kws_clean = fused_kws(echo_free[:, :2], cfg.kws)
        out, p, _ = fused_tdgsc(echo_free, geometry, angle_rad, cfg.gsc)
        return out, kws_clean, p
    if backend != "scan":
        raise ValueError(f"backend must be 'scan' or 'fused', got {backend!r}")
    L = cfg.frame_len
    T = x.shape[-1] // L
    coeffs_np = np.asarray(time_alignment_filters(geometry, angle_rad))
    # the block-Toeplitz tap matrix, built once outside the frame loop
    taps = fir_block_taps(torch.as_tensor(coeffs_np, dtype=x.dtype, device=x.device), L)

    state = full_stack_init(cfg, coeffs_np, batch_shape=x.shape[:-2], dtype=x.dtype, device=x.device)
    outs, kws, ps = [], [], []
    for t in range(T):
        blk = slice(t * L, (t + 1) * L)
        state, (out, kc, p) = full_stack_step(cfg, taps, state, x[..., blk], far_end[..., blk])
        outs.append(out)
        kws.append(kc)
        ps.append(p)
    return torch.cat(outs, dim=-1), torch.cat(kws, dim=-1), torch.stack(ps, dim=-2)
