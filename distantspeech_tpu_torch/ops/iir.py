"""Linear recurrences over the sample axis.

Counterpart of ``distantspeech_tpu/ops/iir.py``.  A constant-coefficient
IIR ``s[n] = A s[n-1] + Bv x[n]`` is never run as a sample-level scan: it
sweeps [..., N, k, k] tensors through memory log2(N) times.
``constant_affine_blocked`` evaluates it by block state-space
decomposition instead: two large matrix products per block (the in-block
Toeplitz response and the decay of the block's initial state) around a
block-level recurrence of N // block steps.  ``affine_recurrence`` is that
block-level recurrence (a log-depth doubling scan over its step axis);
``first_order_recurrence`` is the k = 1 case of the blocked form.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _doubling_scan(A: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of the affine maps s -> A[n] s + b[n] along ``dim``
    (A [..., N, k, k], b [..., N, k], ``dim`` the N axis of b): log2(N)
    rounds of composing each map with the one 2^r steps before it."""
    N = b.shape[dim]
    shift = 1
    while shift < N:
        A_prev = A.narrow(dim - 1, 0, N - shift)
        b_prev = b.narrow(dim, 0, N - shift)
        A_cur = A.narrow(dim - 1, shift, N - shift)
        b_cur = b.narrow(dim, shift, N - shift)
        A_new = torch.sum(A_cur[..., :, :, None] * A_prev[..., None, :, :], dim=-2)
        b_new = torch.sum(A_cur * b_prev[..., None, :], dim=-1) + b_cur
        A = torch.cat([A.narrow(dim - 1, 0, shift), A_new], dim=dim - 1)
        b = torch.cat([b.narrow(dim, 0, shift), b_new], dim=dim)
        shift *= 2
    return A, b


def affine_recurrence(A: torch.Tensor, b: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """Solve s[n] = A[n] @ s[n-1] + b[n] for a small state dim k.

    A: [..., N, k, k]; b: [..., N, k]; s0: [..., k].
    Returns s: [..., N, k] (the state after absorbing each step)."""
    Acum, bcum = _doubling_scan(A, b, dim=-2)
    return torch.sum(Acum * s0[..., None, None, :], dim=-1) + bcum


@lru_cache(maxsize=None)
def _blocked_consts(A_key: tuple, Bv_key: tuple, k: int, n: int):
    """Block state-space constants for s[n] = A s[n-1] + Bv x[n] over an
    n-sample block (float64 numpy):

      Rm [n, n*k] : in-block response  — R[j] = sum_{m<=j} A^{j-m} Bv x[m]
      G  [n, k]   : block charge       — c   = sum_{m} A^{n-1-m} Bv x[m]
      P  [k, k]   : block propagator A^n
      S1 [k, n*k] : initial-state response A^{j+1} s_start per sample j
    """
    A = np.asarray(A_key, np.float64).reshape(k, k)
    Bv = np.asarray(Bv_key, np.float64)
    powers = [np.eye(k)]
    for _ in range(n):
        powers.append(powers[-1] @ A)
    pw = np.stack(powers)  # [n+1, k, k], pw[j] = A^j
    v = pw[:n] @ Bv  # [n, k], v[j] = A^j Bv
    j = np.arange(n)[None, :]
    m = np.arange(n)[:, None]
    R = np.where((j >= m)[..., None], v[np.clip(j - m, 0, None)], 0.0)  # [m, j, k]
    Rm = R.reshape(n, n * k)
    G = v[::-1].copy()  # G[m] = A^{n-1-m} Bv
    P = pw[n]
    S1 = np.transpose(pw[1 : n + 1], (2, 0, 1)).reshape(k, n * k)  # [i, j*k+e] = (A^{j+1})[e,i]
    return Rm, G, P, S1


def constant_affine_blocked(A, Bv, x: torch.Tensor, s0: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Solve s[n] = A s[n-1] + Bv x[n] with constant (A, Bv) over the last
    axis of x, s[-1] = s0; returns the full state sequence [..., N, k].

    Exact block state-space evaluation: per block, the in-block response
    and the initial-state decay are two products with precomputed float64
    constants, around ``affine_recurrence`` over the N // block block
    ends.  A shorter tail block takes its own constants."""
    A = np.asarray(A, np.float64)
    Bv = np.asarray(Bv, np.float64)
    k = Bv.shape[0]
    N = x.shape[-1]
    batch = x.shape[:-1]
    key = (tuple(A.ravel()), tuple(Bv.ravel()))

    def const(a):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    def run_segment(xseg, s0, n):
        Rm, G, P, S1 = _blocked_consts(key[0], key[1], k, n)
        T = xseg.shape[-1] // n
        xb = xseg.reshape(*batch, T, n)
        inblock = xb @ const(Rm)
        c = xb @ const(G)  # [..., T, k]
        Pb = const(P).expand(*batch, T, k, k)
        m_ends = affine_recurrence(Pb, c, s0)  # [..., T, k]
        m_starts = torch.cat([s0[..., None, :], m_ends[..., :-1, :]], dim=-2)
        states = (inblock + m_starts @ const(S1)).reshape(*batch, T * n, k)
        return states, m_ends[..., -1, :]

    n_main = min(block, N)
    n_full = (N // n_main) * n_main
    states, s_end = run_segment(x[..., :n_full], s0, n_main)
    if n_full != N:  # remainder tail as one short block
        tail, _ = run_segment(x[..., n_full:], s_end, N - n_full)
        states = torch.cat([states, tail], dim=-2)
    return states


def first_order_recurrence(a, b: torch.Tensor, s0) -> torch.Tensor:
    """Solve s[n] = a * s[n-1] + b[n] over the last axis, s[-1] = s0.

    a: a scalar coefficient (the blocked form with k = 1; a per-step
    coefficient has no blocked form and would need a sample-level scan,
    so it is refused); b: [..., N]; s0: scalar or [...] initial state.
    Returns s: [..., N]."""
    if np.ndim(a) != 0:
        raise ValueError("first_order_recurrence takes a scalar coefficient")
    s0 = torch.as_tensor(s0, dtype=b.dtype, device=b.device).expand(b.shape[:-1])
    return constant_affine_blocked(np.array([[float(a)]]), np.array([1.0]), b, s0[..., None])[..., 0]
