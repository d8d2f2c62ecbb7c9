"""Recursive spatial statistics, one frame at a time, batched over bins
(counterpart of ``distantspeech_tpu/stats/psd.py``)."""

from __future__ import annotations

import torch


def rank1_update(R: torch.Tensor, z: torch.Tensor, alpha: float) -> torch.Tensor:
    """R <- alpha R + (1 - alpha) z z^H.  R: [..., F, C, C]; z: [..., F, C]."""
    outer = z[..., :, None] * torch.conj(z)[..., None, :]
    return alpha * R + (1.0 - alpha) * outer


def hermitize(R: torch.Tensor) -> torch.Tensor:
    """Force Hermitian symmetry, 0.5 (R + R^H)."""
    return 0.5 * (R + torch.conj(R).transpose(-1, -2))
