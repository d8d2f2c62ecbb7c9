"""Recursive magnitude-squared-coherence (MSC) estimation between mic pairs.

Counterpart of ``distantspeech_tpu/coherence/msc.py``: a first-order
recursion of per-channel auto-PSDs and upper-triangle cross-PSDs, with the
estimated coherence Fvv_est[i, j] = Pxij / sqrt(Pxii_i Pxii_j).  The state is
kept in packed pair form [..., F, P], P = M (M - 1) / 2, in the order
(0, 1), (0, 2), ..., (1, 2), ...
"""

from __future__ import annotations

from functools import lru_cache
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


@lru_cache(maxsize=None)
def _pair_index_tensors(n_ch: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pair_indices`` on ``device``, copied there once."""
    return tuple(torch.as_tensor(a, device=device) for a in pair_indices(n_ch))


def _coherence(Pxii: torch.Tensor, Pxij: torch.Tensor, i_idx: torch.Tensor, j_idx: torch.Tensor) -> torch.Tensor:
    denom = torch.sqrt(Pxii[..., i_idx] * Pxii[..., j_idx])
    return Pxij / denom.to(Pxij.dtype)


def msc_coherence(Pxii: torch.Tensor, Pxij: torch.Tensor) -> torch.Tensor:
    """The estimated complex coherence of each pair from the PSDs:
    Pxij / sqrt(Pxii_i Pxii_j), [..., F, P]."""
    return _coherence(Pxii, Pxij, *_pair_index_tensors(Pxii.shape[-1], Pxii.device))


def msc_update(state: MscState, Z: torch.Tensor, alpha: float) -> Tuple[MscState, torch.Tensor]:
    """One recursion frame.  Z: [..., F, M] complex spectrum.  Returns
    (new_state, Fvv_est [..., F, P]), the estimated complex coherence of
    each pair."""
    i_idx, j_idx = _pair_index_tensors(Z.shape[-1], Z.device)
    Pxii = alpha * state.Pxii + (1.0 - alpha) * (Z * torch.conj(Z)).real
    Pxij = alpha * state.Pxij + (1.0 - alpha) * Z[..., i_idx] * torch.conj(Z[..., j_idx])
    return MscState(Pxii=Pxii, Pxij=Pxij), _coherence(Pxii, Pxij, i_idx, j_idx)


def msc_run(state: MscState, Zt: torch.Tensor, alpha: float) -> Tuple[MscState, torch.Tensor, torch.Tensor]:
    """``msc_update`` over the frames of Zt [T, ..., F, M], with the new
    terms formed for every frame at once and only the two first-order
    recursions left in the frame loop (the same operations as
    ``msc_update``, so the same numbers).  Returns (final state, Pxii
    [T, ..., F, M], Pxij [T, ..., F, P]): the state after each frame."""
    i_idx, j_idx = _pair_index_tensors(Zt.shape[-1], Zt.device)
    Uii = (1.0 - alpha) * (Zt * torch.conj(Zt)).real
    Uij = (1.0 - alpha) * Zt[..., i_idx] * torch.conj(Zt[..., j_idx])
    Pxii, Pxij = state
    ii, ij = [], []
    for uii, uij in zip(Uii.unbind(0), Uij.unbind(0)):
        Pxii = alpha * Pxii + uii
        Pxij = alpha * Pxij + uij
        ii.append(Pxii)
        ij.append(Pxij)
    return MscState(Pxii=Pxii, Pxij=Pxij), torch.stack(ii), torch.stack(ij)
