"""Recursive magnitude-squared-coherence (MSC) estimation between mic pairs.

Counterpart of ``distantspeech_tpu/coherence/msc.py``: a first-order
recursion of per-channel auto-PSDs and upper-triangle cross-PSDs, with the
estimated coherence Fvv_est[i, j] = Pxij / sqrt(Pxii_i Pxii_j).  The state is
kept in packed pair form [..., F, P], P = M (M - 1) / 2, in the order
(0, 1), (0, 2), ..., (1, 2), ...
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device


def pair_indices(n_ch: int) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (i < j) pairs in packed order."""
    iu = np.triu_indices(n_ch, k=1)
    return iu[0], iu[1]


def pair_index(n_ch: int, i: int, j: int) -> int:
    """Packed index of pair (i, j), i < j."""
    ii, jj = pair_indices(n_ch)
    return int(np.nonzero((ii == i) & (jj == j))[0][0])


class MscState(NamedTuple):
    Pxii: torch.Tensor  # auto PSDs   [..., F, M] real
    Pxij: torch.Tensor  # cross PSDs  [..., F, P] complex


def msc_init(n_ch: int, half_bin: int, batch_shape=(), cdtype=torch.complex64, device=None) -> MscState:
    dev = resolve_device(device)
    P = n_ch * (n_ch - 1) // 2
    return MscState(
        Pxii=torch.zeros((*batch_shape, half_bin, n_ch), dtype=cdtype.to_real(), device=dev),
        Pxij=torch.zeros((*batch_shape, half_bin, P), dtype=cdtype, device=dev),
    )


def msc_update(state: MscState, Z: torch.Tensor, alpha: float) -> Tuple[MscState, torch.Tensor]:
    """One recursion frame.  Z: [..., F, M] complex spectrum.  Returns
    (new_state, Fvv_est [..., F, P]), the estimated complex coherence of
    each pair."""
    i_idx, j_idx = (torch.as_tensor(a, device=Z.device) for a in pair_indices(Z.shape[-1]))
    Pxii = alpha * state.Pxii + (1.0 - alpha) * (Z * torch.conj(Z)).real
    Pxij = alpha * state.Pxij + (1.0 - alpha) * Z[..., i_idx] * torch.conj(Z[..., j_idx])
    denom = torch.sqrt(Pxii[..., i_idx] * Pxii[..., j_idx])
    return MscState(Pxii=Pxii, Pxij=Pxij), Pxij / denom.to(Pxij.dtype)
