"""Dual-mic coherence-based enhancement (binaural noise reduction).

Counterpart of ``distantspeech_tpu/coherence/enhance.py``: per frame, the
recursive pair PSDs / CSDs (alpha = 0.6), the estimated complex coherence
of the (0, 1) pair, one of the five gain rules
(``coherence.weights.coherent_gain``), the multiplicative gain and the
ISTFT.  Offline, only the PSD recursion loops over frames
(``coherence.msc.msc_run``); the gain rule reads no state, so it runs once
on the stacked [T, ..., F] coherence.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.array.coherence import diffuse_coherence
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.coherence.msc import MscState, msc_coherence, msc_init, msc_run, msc_update, pair_index
from distantspeech_tpu_torch.coherence.weights import coherent_gain
from distantspeech_tpu_torch.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class BinauralConfig:
    n_fft: int = 256
    method: int = 3
    alpha: float = 0.6  # the PSD recursion
    radius: float = 0.032

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.n_fft // 2)

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1


def binaural_step(
    cfg: BinauralConfig, Fn: torch.Tensor, state: MscState, Z: torch.Tensor
) -> Tuple[MscState, Tuple[torch.Tensor, torch.Tensor]]:
    """One frame.  Fn: [F] diffuse coherence of pair (0, 1); Z: [..., F, 2].
    Returns (state, (Y [..., F] enhanced spectrum, snr [..., F]))."""
    state, Fvv_est = msc_update(state, Z, cfg.alpha)
    G, snr = coherent_gain(Fvv_est[..., pair_index(2, 0, 1)], Fn, method=cfg.method, r=cfg.radius)
    return state, (G.to(Z.dtype) * Z[..., 0], snr)


def binaural_process(x, geometry: ArrayGeometry, cfg: BinauralConfig = BinauralConfig(), device=None):
    """Offline dual-mic enhancement.  x: [..., 2, S] -> (y [..., S],
    snr [..., T, F]) on ``device``."""
    x = torch.as_tensor(x, device=resolve_device(device))
    Fn = torch.as_tensor(diffuse_coherence(geometry, cfg.n_fft)[:, 0, 1], dtype=x.dtype, device=x.device)
    X = analysis(x, cfg.stft)  # [..., 2, T, F]
    Zt = torch.movedim(torch.movedim(X, -3, -1), -3, 0)  # [T, ..., F, 2]
    state = msc_init(2, cfg.half_bin, batch_shape=Zt.shape[1:-2], cdtype=Zt.dtype, device=x.device)
    _, Pxii, Pxij = msc_run(state, Zt, cfg.alpha)
    Fx = msc_coherence(Pxii, Pxij)[..., pair_index(2, 0, 1)]  # [T, ..., F]
    G, snr = coherent_gain(Fx, Fn, method=cfg.method, r=cfg.radius)
    y = synthesis(torch.movedim(G.to(Zt.dtype) * Zt[..., 0], 0, -2), cfg.stft)
    return y, torch.movedim(snr, 0, -2)
