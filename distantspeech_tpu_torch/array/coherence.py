"""Spatial coherence models for idealised noise fields (numpy only, host-side).

Counterpart of ``distantspeech_tpu/array/coherence.py``.
"""

from __future__ import annotations

import numpy as np

from distantspeech_tpu_torch.array.geometry import ArrayGeometry


def diffuse_coherence(geometry: ArrayGeometry, n_fft: int = 256, coh_max: float = 0.9998) -> np.ndarray:
    """Spherically-isotropic (diffuse) noise-field coherence Gamma(f).

    Gamma[k, i, j] = sinc(2 pi f_k d_ij / c) (unnormalised sinc), with the
    diagonal clamped to ``coh_max`` and the DC bin evaluated at f = 1e-6.

    Returns [half_bin, M, M] float64.
    """
    half_bin = round(n_fft / 2 + 1)
    f = np.linspace(0.0, geometry.fs / 2.0, half_bin)
    f[0] = 1e-6
    diff = geometry.mic_loc[:, None, :] - geometry.mic_loc[None, :, :]
    d = np.sqrt(np.sum(diff**2, axis=-1))  # [M, M]
    x = 2.0 * np.pi * f[:, None, None] * d[None] / geometry.c
    with np.errstate(divide="ignore", invalid="ignore"):
        coh = np.sin(x) / x
    eye = np.broadcast_to(np.eye(geometry.n_mics, dtype=bool), coh.shape)
    return np.where(eye, coh_max, coh)
