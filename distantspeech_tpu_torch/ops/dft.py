"""Small real DFTs as dense matrix products.

Counterpart of ``distantspeech_tpu/ops/dft.py``: ``rdft`` / ``irdft`` are
``torch.fft.rfft`` / ``irfft`` over the last axis, computed as one product
against a [cos | sin] matrix (up to ``MATMUL_MAX_N`` points, the FFT
above).  The plain versions of the port's FLMS kernels use these matrices,
so the plain path rounds like the JAX package's.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

MATMUL_MAX_N = 2048


@lru_cache(maxsize=None)
def _fwd_mat(n: int) -> np.ndarray:
    k = np.arange(n // 2 + 1)[None, :]
    t = np.arange(n)[:, None]
    ang = -2.0 * np.pi * t * k / n
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1)  # [n, 2F]


@lru_cache(maxsize=None)
def _inv_mat(n: int) -> np.ndarray:
    F = n // 2 + 1
    k = np.arange(F)[:, None]
    t = np.arange(n)[None, :]
    ang = 2.0 * np.pi * k * t / n
    scale = np.full((F, 1), 2.0)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    A = np.cos(ang) * scale / n
    B = -np.sin(ang) * scale / n
    return np.concatenate([A, B], axis=0)  # [2F, n]


def rdft(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """``torch.fft.rfft(x, n=n)`` over the last axis as one matrix product."""
    L = x.shape[-1]
    if n is None:
        n = L
    if n > MATMUL_MAX_N:
        return torch.fft.rfft(x, n=n)
    if L < n:
        x = torch.nn.functional.pad(x, (0, n - L))
    elif L > n:
        x = x[..., :n]
    Y = x @ torch.as_tensor(_fwd_mat(n), dtype=x.dtype, device=x.device)
    F = n // 2 + 1
    return torch.complex(Y[..., :F], Y[..., F:])


def irdft(X: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """``torch.fft.irfft(X, n=n)`` over the last axis as one matrix product."""
    if n is None:
        n = 2 * (X.shape[-1] - 1)
    if n > MATMUL_MAX_N or X.shape[-1] != n // 2 + 1:
        return torch.fft.irfft(X, n=n)
    AB = torch.as_tensor(_inv_mat(n), dtype=X.real.dtype, device=X.device)
    return torch.cat([X.real, X.imag], dim=-1) @ AB
