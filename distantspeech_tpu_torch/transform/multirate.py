"""Multirate utilities: remez lowpass, rational resampling, minimax
fractional delay, and the overlap-save FFT convolution.

Counterpart of ``distantspeech_tpu/transform/multirate.py``.  The design
helpers ``low_pass``, ``resample`` and ``frac_delay`` are host NumPy / SciPy
(a copy of the JAX package's, which are pure NumPy); ``overlap_save`` is
torch and batched.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device


def low_pass(numtaps: int, B: float, epsilon: float = 0.1) -> np.ndarray:
    """Remez lowpass with transition band epsilon * B."""
    from scipy.signal import remez

    return remez(numtaps, [0, (1 - epsilon) * B, B, 0.5], [1, 0], grid_density=32)


def resample(x: np.ndarray, p: int, q: int) -> np.ndarray:
    """Rational-rate resampling by p / q."""
    from scipy.signal import fftconvolve

    g = math.gcd(p, q)
    p, q = p // g, q // g
    m = max(p, q)
    h = low_pass(10 * m + 1, 1.0 / (2.0 * m))
    x_up = np.kron(x, np.concatenate(([1.0], np.zeros(p - 1))))
    x_rs = fftconvolve(x_up, h)
    x_ds = x_rs[h.shape[0] // 2 + 1 :: q]
    return x_ds[: int(np.floor(x.shape[0] * p / q))]


def frac_delay(
    delta: float, N: int, w_max: float = 0.9, C: int = 4, iters: int = 200, tol: float = 1e-12
) -> np.ndarray:
    """Minimax-optimal fractional-delay FIR (Putnam & Smith, "Design of
    Fractional Delay Filters Using Convex Optimization"): the Chebyshev
    solution of min max_i |F(w_i) h - e^(-j w_i delta)| on a grid of C N
    frequencies up to w_max pi, by Lawson's iteratively reweighted least
    squares (one small [2 C N, N] real ``lstsq`` an iteration)."""
    N_C = int(C * N)
    w = np.linspace(0, w_max * np.pi, N_C)
    n = np.arange(N)
    F = np.exp(-1j * w[:, None] * n)  # [N_C, N]
    d = np.exp(-1j * w * delta)

    # stacked real system: rows (Re; Im) of F h = d
    A = np.concatenate([F.real, F.imag], axis=0)
    y = np.concatenate([d.real, d.imag])

    wt = np.ones(N_C)
    h = None
    prev = np.inf
    for _ in range(iters):
        sw = np.concatenate([np.sqrt(wt), np.sqrt(wt)])  # the same weight for the (Re, Im) rows
        h, *_ = np.linalg.lstsq(A * sw[:, None], y * sw, rcond=None)
        err = np.abs(F @ h - d)
        # Lawson update: w_i <- w_i |e_i|, renormalised
        wt = wt * np.maximum(err, 1e-30)
        wt /= wt.sum()
        emax = err.max()
        if abs(prev - emax) < tol * max(emax, 1e-30):
            break
        prev = emax
    return h


def overlap_save(signal, filt, stride: int = 4, pad_start: bool = True, device=None) -> torch.Tensor:
    """Overlap-save FFT convolution, batched.  signal: [..., S]; filt: [K].

    Returns [..., S_p] on ``device``, S_p the length after the start
    padding (the JAX package's shape); the output beyond the last full
    block is zero."""
    dev = resolve_device(device)
    signal = torch.as_tensor(signal, device=dev)
    filt = torch.as_tensor(filt, device=dev).reshape(-1)
    K = filt.shape[0]
    min_win = stride + K - 1
    n_fft = int(2 ** (int(np.log2(min_win)) + 1))

    if pad_start:
        signal = torch.nn.functional.pad(signal, (n_fft - stride - K + stride - 1, 0))

    W = torch.fft.rfft(filt, n=n_fft)
    S = signal.shape[-1]
    n_block = (S - n_fft) // stride
    blocks = signal.unfold(-1, n_fft, stride)[..., :n_block, :]  # [..., n_block, n_fft]
    y = torch.fft.irfft(W * torch.fft.rfft(blocks, dim=-1), n=n_fft, dim=-1)
    valid = y[..., -(n_fft - K + 1) :][..., :stride]  # [..., n_block, stride]
    out = torch.zeros_like(signal)
    out[..., : n_block * stride] = valid.reshape(*valid.shape[:-2], n_block * stride)
    return out
