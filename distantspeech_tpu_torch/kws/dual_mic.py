"""Dual-mic KWS cleaner (the "hotword cleaner" pattern).

Counterpart of ``distantspeech_tpu/kws/dual_mic.py``: a continuously
adapting FLMS ANC (mic 0 -> mic 1) whose taps are applied 1.5 seconds late
by a second, frozen filter, so the cleaner never adapts to (and never
cancels) the keyword itself, only the earlier interference.  Per frame:
adapt the ANC, push its taps into a FIFO, load the FIFO tail into the
cleaner, run the cleaner without updating.

``kws_process`` is the per-frame loop; the whole-utterance kernel K6 is
``ops.cuda_flms.fused_kws``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.adaptive.flms import FlmsConfig, FlmsState, flms_init, flms_step
from distantspeech_tpu_torch.ops.delay import delay_frames, delay_frames_init
from distantspeech_tpu_torch.ops.dft import rdft


@dataclasses.dataclass(frozen=True)
class DualMicKwsConfig:
    frame_len: int = 256
    fs: int = 16000
    mu: float = 0.1
    alpha: float = 0.1
    defer_seconds: float = 1.5

    @property
    def flms(self) -> FlmsConfig:
        return FlmsConfig(filter_len=self.frame_len, mu=self.mu, alpha=self.alpha, non_causal=True)

    @property
    def delay_frames_n(self) -> int:
        # the reference's DelayFrames(frameLen, delay) queues delay + 1 frames
        return int(self.defer_seconds * self.fs) // self.frame_len + 1


class DualMicKwsState(NamedTuple):
    anc: FlmsState
    cleaner: FlmsState
    w_fifo: torch.Tensor  # deferred taps [..., Dn, filter_len]


def kws_init(cfg: DualMicKwsConfig, batch_shape=(), dtype=torch.float32, device=None) -> DualMicKwsState:
    dev = resolve_device(device)
    return DualMicKwsState(
        anc=flms_init(cfg.flms, batch_shape, dtype=dtype, device=dev),
        cleaner=flms_init(cfg.flms, batch_shape, dtype=dtype, device=dev),
        w_fifo=delay_frames_init(batch_shape, cfg.delay_frames_n, (cfg.frame_len,), dtype=dtype, device=dev),
    )


def kws_step(
    cfg: DualMicKwsConfig, state: DualMicKwsState, x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[DualMicKwsState, torch.Tensor]:
    """One frame_len block.  x0, x1: [..., L] the two mics.  Returns
    (state, cleaned [..., L])."""
    anc_state, (_, w) = flms_step(cfg.flms, state.anc, x0[..., None, :], x1)
    w_fifo, w_delayed = delay_frames(state.w_fifo, w[..., 0, :])

    # load the deferred taps into the cleaner and run it frozen
    cleaner_state = state.cleaner._replace(W=rdft(w_delayed, n=cfg.flms.n_fft)[..., None, :])
    cleaner_state, (cleaned, _) = flms_step(cfg.flms, cleaner_state, x0[..., None, :], x1, update=0.0)
    return DualMicKwsState(anc=anc_state, cleaner=cleaner_state, w_fifo=w_fifo), cleaned


def kws_process(x, cfg: DualMicKwsConfig = DualMicKwsConfig(), device=None) -> torch.Tensor:
    """Offline cleaning.  x: [..., 2, S] -> [..., S'] with S' whole frames."""
    x = torch.as_tensor(x, device=resolve_device(device))
    L = cfg.frame_len
    T = x.shape[-1] // L
    state = kws_init(cfg, batch_shape=x.shape[:-2], dtype=x.dtype, device=x.device)
    outs = []
    for t in range(T):
        blk = x[..., t * L : (t + 1) * L]
        state, out = kws_step(cfg, state, blk[..., 0, :], blk[..., 1, :])
        outs.append(out)
    return torch.cat(outs, dim=-1)
