"""McCowan/Zelinski coherence-model postfilter.

Counterpart of ``distantspeech_tpu/postfilter/mccowan.py``: recursive auto
and cross PSDs over the mic pairs, the diffuse-coherence-corrected source
PSD of each pair (McCowan eq. 22, the coherence clipped at 0.7), the pair
average (eq. 23) and the Wiener gain W = Pss / Pssnn applied to the
beamformer's output through the streaming STFT round trip.  Offline, only
the PSD recursion loops over frames (``coherence.msc.msc_run``); eqs. 22-23
read no state and run once on the stacked [T, ..., F] PSDs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.array.coherence import diffuse_coherence
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.coherence.msc import MscState, msc_init, msc_run, msc_update, pair_indices
from distantspeech_tpu_torch.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class McCowanConfig:
    n_fft: int = 256
    n_mics: int = 4
    alpha: float = 0.8  # the PSD recursion
    coh_max: float = 0.7  # eq. 22's coherence clip

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.n_fft // 2)

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1


def _wiener_gain(cfg: McCowanConfig, fvv_pairs: torch.Tensor, Pxii: torch.Tensor, Pxij: torch.Tensor) -> torch.Tensor:
    """Eqs. 22-23 from the PSDs Pxii [..., F, M], Pxij [..., F, P] -> W [..., F]."""
    M = Pxii.shape[-1]
    i_idx, j_idx = (torch.as_tensor(a, device=Pxii.device) for a in pair_indices(M))
    Fvv = torch.clamp(fvv_pairs, max=cfg.coh_max)
    Pss_e = (Pxij.real - 0.5 * Fvv * (Pxii[..., i_idx] + Pxii[..., j_idx])) / (1.0 - Fvv)  # eq. 22, each pair
    Pss = torch.sum(Pss_e, dim=-1) * 2.0 / (M * M - M)  # eq. 23, the pair average
    Pssnn = torch.sum(Pxii, dim=-1) / M
    return Pss / Pssnn


def mccowan_gain(
    cfg: McCowanConfig, fvv_pairs: torch.Tensor, state: MscState, Z: torch.Tensor
) -> Tuple[MscState, torch.Tensor]:
    """One frame of the postfilter gain.  fvv_pairs: [F, P] diffuse
    coherence of each (i < j) pair; Z: [..., F, M] multichannel spectra.
    Returns (state, W [..., F])."""
    state, _ = msc_update(state, Z, cfg.alpha)
    return state, _wiener_gain(cfg, fvv_pairs, state.Pxii, state.Pxij)


def mccowan_process(
    x, ds, geometry: ArrayGeometry, cfg: McCowanConfig = McCowanConfig(), device=None
) -> torch.Tensor:
    """Offline postfiltering of a beamformed signal.  x: [..., M, S]
    (time-aligned) mics; ds: [..., S] beamformed signal.  Returns [..., S]
    on ``device`` (the streaming STFT round trip)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    ds = torch.as_tensor(ds, device=dev)
    i_idx, j_idx = pair_indices(geometry.n_mics)
    fvv = diffuse_coherence(geometry, cfg.n_fft)  # [F, M, M]
    fvv_pairs = torch.as_tensor(fvv[:, i_idx, j_idx], dtype=x.dtype, device=dev)

    X = analysis(x, cfg.stft)  # [..., M, T, F]
    Zt = torch.movedim(torch.movedim(X, -3, -1), -3, 0)  # [T, ..., F, M]
    D = analysis(ds, cfg.stft)  # [..., T, F]

    state = msc_init(geometry.n_mics, cfg.half_bin, batch_shape=Zt.shape[1:-2], cdtype=Zt.dtype, device=dev)
    _, Pxii, Pxij = msc_run(state, Zt, cfg.alpha)
    W = torch.movedim(_wiener_gain(cfg, fvv_pairs, Pxii, Pxij), 0, -2)  # [..., T, F]
    return synthesis(D * W.to(D.dtype), cfg.stft)
