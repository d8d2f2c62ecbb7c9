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


@lru_cache(maxsize=None)
def _mat_on(inverse: bool, n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The DFT matrix on ``device``, copied there once (a frame loop calls
    ``rdft`` / ``irdft`` every step)."""
    return torch.as_tensor(_inv_mat(n) if inverse else _fwd_mat(n), dtype=dtype, device=device)


def _check_last(t: torch.Tensor, axis: int, what: str) -> None:
    if axis not in (-1, t.ndim - 1):
        raise ValueError(f"{what} only supports the last axis, got axis={axis} of a {t.ndim}-d input")


def rdft(x: torch.Tensor, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """``torch.fft.rfft(x, n=n)`` over the last axis (the only ``axis``
    taken, as in the JAX package) as one matrix product."""
    _check_last(x, axis, "rdft")
    L = x.shape[-1]
    if n is None:
        n = L
    if n > MATMUL_MAX_N:
        return torch.fft.rfft(x, n=n)
    if L < n:
        x = torch.nn.functional.pad(x, (0, n - L))
    elif L > n:
        x = x[..., :n]
    Y = x @ _mat_on(False, n, x.dtype, x.device)
    F = n // 2 + 1
    return torch.complex(Y[..., :F], Y[..., F:])


def irdft(X: torch.Tensor, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """``torch.fft.irfft(X, n=n)`` over the last axis (the only ``axis``
    taken, as in the JAX package) as one matrix product."""
    _check_last(X, axis, "irdft")
    if n is None:
        n = 2 * (X.shape[-1] - 1)
    if n > MATMUL_MAX_N or X.shape[-1] != n // 2 + 1:
        return torch.fft.irfft(X, n=n)
    return torch.cat([X.real, X.imag], dim=-1) @ _mat_on(True, n, X.real.dtype, X.device)
