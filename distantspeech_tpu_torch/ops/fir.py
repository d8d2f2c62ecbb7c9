"""Multichannel causal FIR filtering as block-Toeplitz matrix products.

Counterpart of ``distantspeech_tpu/ops/fir.py``.  Each output block is
``window @ T`` with ``T[c, i, o] = flip(coeffs)[c, i - o]``: one matrix
product per channel instead of a grouped convolution.  The K-1 tail
samples are carried between blocks.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _tap_matrix(coeffs: torch.Tensor, W: int, L: int) -> torch.Tensor:
    """[C, W, L] block-Toeplitz response: T[c, i, o] = flip(coeffs)[c, i-o]
    (zero outside 0 <= i-o < K)."""
    K = coeffs.shape[-1]
    fc = torch.flip(coeffs, dims=[-1])
    d = torch.arange(W, device=coeffs.device)[:, None] - torch.arange(L, device=coeffs.device)[None, :]
    valid = (d >= 0) & (d < K)
    t = fc[..., d.clamp(0, K - 1)]  # [C, W, L]
    return torch.where(valid, t, torch.zeros_like(t))


def fir_block_taps(coeffs: torch.Tensor, L: int) -> torch.Tensor:
    """The [C, K-1+L, L] block-Toeplitz matrix for ``fir_filter_block`` with
    L-sample blocks; build it once, outside a frame loop."""
    return _tap_matrix(coeffs, coeffs.shape[-1] - 1 + L, L)


def fir_filter_block(cache: torch.Tensor, x: torch.Tensor, coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal per-channel FIR of one block.

    cache: [..., C, K-1] carried input tail; x: [..., C, L] block; coeffs:
    [C, K] taps (tap 0 oldest), or the [C, K-1+L, L] matrix from
    ``fir_block_taps``.  Returns (new_cache [..., C, K-1], y [..., C, L])
    with y[n] = sum_k flip(coeffs)[k] * ext[n + k], ext = [cache, x]."""
    L = x.shape[-1]
    if coeffs.ndim == 3:
        T = coeffs.to(x.dtype)
        K = T.shape[-2] - L + 1
    else:
        K = coeffs.shape[-1]
        T = _tap_matrix(coeffs.to(x.dtype), K - 1 + L, L)
    ext = torch.cat([cache, x], dim=-1)  # [..., C, K-1+L]
    y = torch.einsum("...cw,cwo->...co", ext, T)
    return (ext[..., -(K - 1):] if K > 1 else cache), y


def fir_filter_offline(x: torch.Tensor, coeffs: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Whole-signal causal FIR from a zero cache: x [..., C, S] -> [..., C, S].

    Blocked so each window is two adjacent blocks; ``block`` is doubled
    until it covers the K-1 halo."""
    K = coeffs.shape[-1]
    S = x.shape[-1]
    Lb = block
    while Lb < K - 1:
        Lb *= 2
    nblk = -(-S // Lb)
    ext = torch.nn.functional.pad(x, (Lb, nblk * Lb - S))
    xb = ext.reshape(*x.shape[:-1], nblk + 1, Lb)
    win = torch.cat([xb[..., :-1, Lb - (K - 1) :], xb[..., 1:, :]], dim=-1)  # [..., C, nblk, W]
    T = _tap_matrix(coeffs.to(x.dtype), K - 1 + Lb, Lb)  # [C, W, Lb]
    y = torch.einsum("...cnw,cwo->...cno", win, T)
    return y.reshape(*x.shape[:-1], nblk * Lb)[..., :S]
