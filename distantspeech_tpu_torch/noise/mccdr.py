"""Coherent-to-diffuse-ratio speech presence (Schwarz & Kellermann 2015).

Counterpart of ``distantspeech_tpu/noise/mccdr.py``: the unbiased CDR
estimator (eq. 25 of [Schwarz15]) on the (1, 2) mic pair of a circular
array, fused with an MCRA speech-presence track of the reference channel.
The output Gamma = sqrt(CDR^2_clipped * p_mcra) is read by McSpp as
``q = 1 - Gamma``.  The diffuse coherence Fn of the (1, 2) pair of a
circular r = 0.032 array is designed on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.array.coherence import diffuse_coherence
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.coherence.msc import MscState, msc_init, msc_update, pair_index
from distantspeech_tpu_torch.noise.mcra import McraConfig, McraState, mcra_init, mcra_step


@dataclasses.dataclass(frozen=True)
class McCdrConfig:
    nfft: int = 256
    n_channels: int = 4
    alpha_msc: float = 0.9  # coherence recursion
    radius: float = 0.032

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.nfft, L=65)

    def fn_pair(self) -> np.ndarray:
        """Diffuse coherence of the (1, 2) pair, [F] float64."""
        geom = ArrayGeometry.circular(self.n_channels, self.radius, c=343.0)
        return diffuse_coherence(geom, self.nfft)[:, 1, 2]


class McCdrState(NamedTuple):
    msc: MscState
    mcra: McraState


def mccdr_init(cfg: McCdrConfig, batch_shape=(), cdtype=torch.complex64, device=None) -> McCdrState:
    dev = resolve_device(device)
    return McCdrState(
        msc=msc_init(cfg.n_channels, cfg.half_bin, batch_shape, cdtype=cdtype, device=dev),
        mcra=mcra_init(cfg.mcra, batch_shape, dtype=cdtype.to_real(), device=dev),
    )


def cdr_gamma(Fn: torch.Tensor, Fxr: torch.Tensor, Fxi: torch.Tensor) -> torch.Tensor:
    """The clipped squared CDR estimate from the diffuse coherence Fn and the
    estimated complex coherence Fx = Fxr + i Fxi of the pair (eq. 25 of
    [Schwarz15]).

    The radicand Fn^2 Fxr^2 - Fn^2 |Fx|^2 + Fn^2 - 2 Fn Fxr + |Fx|^2 (the
    JAX package's form) is evaluated as (Fn - Fxr)^2 + (1 - Fn^2) Fxi^2: the
    same value, as two terms that are >= 0 for |Fn| <= 1.  The expanded form
    cancels where the pair's coherence meets the diffuse model, five O(1)
    terms to float32's rounding noise, which then moves q = 1 - sqrt(Gamma p)
    near 1 and with it McSpp's p (through q / (1 - q)) by far more than a
    rounding.  The JAX package's clamp of the radicand at 0, its guard
    against sqrt of a negative, stays."""
    Fx2 = Fxr * Fxr + Fxi * Fxi
    Fn2 = Fn * Fn
    rad = (Fn - Fxr) * (Fn - Fxr) + (1.0 - Fn2) * (Fxi * Fxi)
    num = Fn * Fxr - Fx2 - torch.sqrt(torch.clamp(rad, min=0.0))
    Gamma = num / torch.clamp(Fx2 - 1.0, max=-1e-3)
    Gamma = Gamma * Gamma
    Gamma = torch.where(Gamma > 1.0, 1.0, Gamma)
    return torch.where(Gamma < 0.0, 1e-3, Gamma)


def mccdr_step(cfg: McCdrConfig, Fn: torch.Tensor, state: McCdrState, y: torch.Tensor) -> Tuple[McCdrState, torch.Tensor]:
    """One CDR frame.  Fn: [F] diffuse coherence of pair (1, 2)
    (``cfg.fn_pair()``); y: [..., F, C] complex spectrum.  Returns
    (new_state, Gamma [..., F])."""
    msc_state, Fvv_est = msc_update(state.msc, y, cfg.alpha_msc)
    Fx = Fvv_est[..., pair_index(cfg.n_channels, 1, 2)]
    Gamma = cdr_gamma(Fn, Fx.real, Fx.imag)
    mcra_state, (_, p_mcra) = mcra_step(cfg.mcra, state.mcra, y[..., 0].abs() ** 2)
    return McCdrState(msc=msc_state, mcra=mcra_state), torch.sqrt(Gamma * p_mcra)
