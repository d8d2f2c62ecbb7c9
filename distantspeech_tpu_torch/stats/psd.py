"""Recursive spatial statistics, one frame at a time, batched over bins
(counterpart of ``distantspeech_tpu/stats/psd.py``)."""

from __future__ import annotations

import numpy as np
import torch


def update_psd(Z: torch.Tensor, Pxii: torch.Tensor, alpha: float = 0.8) -> torch.Tensor:
    """Recursive auto-PSD: P <- alpha P + (1 - alpha) |Z|^2.  Z: complex, any
    shape; Pxii: real, the same shape."""
    return alpha * Pxii + (1.0 - alpha) * torch.real(Z * torch.conj(Z))


def _pair_indices(n_ch: int):
    """Upper-triangle (i < j) channel pairs, ordered (0,1), (0,2), ...,
    (C-2, C-1)."""
    iu = np.triu_indices(n_ch, k=1)
    return iu[0], iu[1]


def update_csd(Z: torch.Tensor, Pxij: torch.Tensor, alpha: float = 0.8) -> torch.Tensor:
    """Recursive cross-PSD over channel pairs.  Z: [..., F, C] complex; Pxij:
    [..., F, C (C - 1) / 2] complex in ``_pair_indices`` order."""
    i_idx, j_idx = (torch.as_tensor(a, device=Z.device) for a in _pair_indices(Z.shape[-1]))
    cur = Z[..., i_idx] * torch.conj(Z[..., j_idx])
    return alpha * Pxij + (1.0 - alpha) * cur


def rank1_update(R: torch.Tensor, z: torch.Tensor, alpha: float) -> torch.Tensor:
    """R <- alpha R + (1 - alpha) z z^H.  R: [..., F, C, C]; z: [..., F, C]."""
    outer = z[..., :, None] * torch.conj(z)[..., None, :]
    return alpha * R + (1.0 - alpha) * outer


def hermitize(R: torch.Tensor) -> torch.Tensor:
    """Force Hermitian symmetry, 0.5 (R + R^H)."""
    return 0.5 * (R + torch.conj(R).transpose(-1, -2))
