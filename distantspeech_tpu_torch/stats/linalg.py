"""Batched small-matrix solves, unrolled over the static matrix size
(counterpart of ``distantspeech_tpu/stats/linalg.py``).

The matrices are tiny (M <= 16) and batched over bins and utterances, so
every routine is M elementwise steps over the batch rather than a library
factorisation per matrix.
"""

from __future__ import annotations

import torch


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``A @ x`` as multiply-reduce.  A: [..., M, N]; x: [..., N]."""
    return torch.sum(A * x[..., None, :], dim=-1)


def vecmat(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Batched ``x^T A``.  x: [..., M]; A: [..., M, N] -> [..., N]."""
    return torch.sum(x[..., :, None] * A, dim=-2)


def trace_mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """tr(A @ B) = sum_ij A_ij B_ji without forming the product."""
    return torch.sum(A * B.transpose(-1, -2), dim=(-2, -1))


def gauss_jordan_inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of well-conditioned (diagonally loaded) matrices [..., M, M]
    by unrolled Gauss-Jordan elimination without pivoting."""
    M = A.shape[-1]
    eye = torch.eye(M, dtype=A.dtype, device=A.device).expand(A.shape)
    work = torch.cat([A, eye], dim=-1)
    for k in range(M):
        pivot_row = work[..., k, :] / work[..., k, k][..., None]
        elim = work - work[..., :, k][..., :, None] * pivot_row[..., None, :]
        elim[..., k, :] = pivot_row
        work = elim
    return work[..., :, M:]


def diag_loaded_inv(A: torch.Tensor, diag: float) -> torch.Tensor:
    """inv(A + diag I) by the unrolled elimination."""
    return gauss_jordan_inv(A + diag * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device))


def ldl_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for hermitian positive-definite A [..., M, M], b [..., M]:
    unrolled LDL^H factorisation (unit lower L, real D, no sqrt) and two
    triangular solves."""
    M = A.shape[-1]
    L = [[None] * M for _ in range(M)]
    D = [None] * M
    Dinv = [None] * M
    for j in range(M):
        d = A[..., j, j]
        for k in range(j):
            d = d - (L[j][k] * torch.conj(L[j][k])) * D[k]
        D[j] = d
        Dinv[j] = 1.0 / d
        for i in range(j + 1, M):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * torch.conj(L[j][k]) * D[k]
            L[i][j] = s * Dinv[j]
    v = [None] * M  # forward: L v = b (unit diagonal)
    for i in range(M):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * v[k]
        v[i] = s
    x = [None] * M  # diagonal + backward: L^H x = v / D
    for i in range(M - 1, -1, -1):
        s = v[i] * Dinv[i]
        for k in range(i + 1, M):
            s = s - torch.conj(L[k][i]) * x[k]
        x[i] = s
    return torch.stack(x, dim=-1)
