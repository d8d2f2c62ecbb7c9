"""Nyquist(M) filterbank prototype design (Kumatani/McDonough method).

Counterpart of ``distantspeech_tpu/transform/filterbank_design.py``, a
numpy copy: the port never imports the JAX package.  Host-side, one-time
design, never on the device.  Every matrix is assembled by vectorised
indexing:

- E[i,j] = sum_k h[kM-i] h[kM-j]  -> a [L_g, 2m+1] gather matrix product;
- P[i,j] = factor((i-j) % D) * autocorr(h)[i-j]  (the inner sum over l only
  depends on i-j) -> one correlate() plus an outer factor mask;
- the k==md or k%M!=0 row/column deletions -> boolean-mask indexing.

The solver branches (eig / null space / Lagrange / SVD) follow the JAX
package's decision tree, so the designed prototypes agree to float
rounding.  Designed pairs are cached as .npz in this package's own
``_prototype_cache/`` (written to a temporary name and renamed, so that
concurrent processes never read a partial file).
"""

from __future__ import annotations

import os
import tempfile
from typing import Tuple

import numpy as np

_CACHE_DIR = os.path.join(os.path.dirname(__file__), "_prototype_cache")


def _null_space(A: np.ndarray) -> np.ndarray:
    """Null-space basis via SVD."""
    U, W, VH = np.linalg.svd(A)
    V = VH.T
    rowN, colN = A.shape
    tol = max(rowN, colN) * W.max() * 2.2204e-16
    sX = int(np.sum(W > tol))
    return V[:, sX:colN]


def design_analysis_prototype(M: int, m: int, D: int, wpW: int = 1) -> Tuple[np.ndarray, float]:
    """Analysis prototype h [M*m] and inband aliasing distortion beta."""
    L_h = M * m
    md = L_h / 2 if m != 1 else 0
    tau_h = L_h / 2
    w_p = np.pi / (wpW * M)

    i = np.arange(L_h)[:, None]
    j = np.arange(L_h)[None, :]
    j_i = j - i

    factor = np.where(j_i % D == 0, D - 1, -1.0)
    den = np.where(j_i == 0, 1e-12, np.pi * j_i)
    C = np.where(j_i == 0, factor / D, factor * np.sin(np.pi * j_i / D) / den)

    den = np.where(j_i == 0, 1e-12, w_p * j_i)
    A = np.where(j_i == 0, 1.0, np.sin(w_p * j_i) / den)

    ii = np.arange(L_h)
    den = np.where((tau_h - ii) == 0, 1e-12, w_p * (tau_h - ii + 1e-12))
    b = np.where((tau_h - ii) == 0, 1.0, np.sin(w_p * (tau_h - ii)) / den)[:, None]

    # delete rows/cols of the structurally-zero taps (k % M == 0, k != md)
    keep = (ii == md) | (ii % M != 0)
    delC = C[np.ix_(keep, keep)]
    delA = A[np.ix_(keep, keep)]
    delb = b[keep]

    if np.linalg.matrix_rank(delC) == len(delC):
        eVal, eVec = np.linalg.eig(delC)
        rh = eVec[:, np.argmin(eVal)]
        if not np.any(rh > 0):
            rh = -rh
    else:
        nulldelC = _null_space(delC)
        if nulldelC.shape[1] == 0:
            raise ArithmeticError("No. null space bases is 0")
        T1 = delA @ nulldelC
        T1_2 = nulldelC.T @ T1
        if np.linalg.matrix_rank(T1_2) == len(T1_2):
            x = np.linalg.solve(T1_2, nulldelC.T @ delb)
        else:
            x = np.linalg.pinv(T1) @ delb
        rh = (nulldelC @ x)[:, 0]

    h = np.zeros(L_h)
    h[keep] = np.real(rh)
    h = h[:, None]
    beta = float((h.T @ C @ h)[0, 0])
    return h, beta


def design_synthesis_prototype(h: np.ndarray, M: int, m: int, D: int) -> Tuple[np.ndarray, float]:
    """Synthesis prototype g [M*m] and residual aliasing distortion epsir."""
    h = h.reshape(-1, 1)
    L_h = len(h)
    L_g = M * m
    md = L_h / 2 if m != 1 else 0
    tau_t = int(md + L_g / 2)
    hf = h[:, 0]

    # E[i,j] = sum_k h[kM-i] h[kM-j]: gather h at kM-i (zero out of range)
    k = np.arange(0, 2 * m + 1)
    idx = k[None, :] * M - np.arange(L_g)[:, None]  # [L_g, 2m+1]
    valid = (idx >= 0) & (idx < L_h)
    Hk = np.where(valid, hf[np.clip(idx, 0, L_h - 1)], 0.0)
    E = (M * M) * (Hk @ Hk.T)

    # P[i,j] = factor((i-j) % D) * acorr[i-j], acorr[d] = sum_l h[l+j] h[l+i]
    acorr = np.correlate(hf, hf, mode="full")  # lag axis [-(L_h-1) .. L_h-1]
    i = np.arange(L_g)[:, None]
    j = np.arange(L_g)[None, :]
    lag = i - j  # matches h[l+j]*h[l+i] summed over l
    factor = np.where((lag % D) == 0, D - 1.0, -1.0)
    P = factor * np.where(np.abs(lag) <= L_h - 1, acorr[np.clip(lag + L_h - 1, 0, 2 * L_h - 2)], 0.0)
    P = (M / float(D * D)) * P

    f = np.zeros((L_g, 1))
    sel = (tau_t - np.arange(L_g) >= 0) & (tau_t - np.arange(L_g) < L_h)
    f[sel, 0] = hf[(tau_t - np.arange(L_g))[sel]]
    f = (M / (np.pi * D)) * f

    # H: rows are M-shifted time-reversed h segments
    rowN = 2 * m - 1
    H = np.zeros((rowN, L_g))
    sX = M
    eX = sX - L_g + 1
    for r in range(rowN):
        s = min(max(sX, 1), L_g)
        e = min(max(eX, 1), L_g)
        H[r, e - 1 : s] = hf[np.arange(s, e - 1, -1) - 1]
        sX += M
        eX += M
    C0 = np.zeros((rowN, 1))
    C0[m - 1, 0] = D * 1.0 / M

    sizeP = len(P)
    rank_P = np.linalg.matrix_rank(P)
    if rank_P == sizeP:
        invP = np.linalg.inv(P)
        H_invP_HT = H @ invP @ H.T
        g = invP @ H.T @ np.linalg.inv(H_invP_HT) @ C0
    elif rank_P <= (sizeP - rowN):
        nullP = _null_space(P)
        y = np.linalg.pinv(H @ nullP) @ C0
        g = nullP @ y
    else:
        UP, WP, VP = np.linalg.svd(P)
        pnullP = VP[:, (sizeP - rowN) : sizeP]
        y = np.linalg.solve(H @ pnullP, C0)
        g = pnullP @ y

    epsir = float((g.T @ P @ g)[0, 0])
    return g, epsir


def nyquist_prototypes(M: int, m: int = 2, r: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Design (or load cached) analysis/synthesis prototype pair.

    The (M, m, r) parameterisation of the JAX package: D = M // 2**r.
    Returns (h [M*m], g [M*m]) flat float64 arrays.
    """
    D = max(M // (2**r), 1)
    os.makedirs(_CACHE_DIR, exist_ok=True)
    path = os.path.join(_CACHE_DIR, f"nyquist-M{M}-m{m}-r{r}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["h"], z["g"]
    h, _ = design_analysis_prototype(M, m, D)
    g, _ = design_synthesis_prototype(h, M, m, D)
    h, g = h.ravel(), g.ravel()
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=_CACHE_DIR)
    with os.fdopen(fd, "wb") as f:
        np.savez(f, h=h, g=g)
    os.replace(tmp, path)
    return h, g
