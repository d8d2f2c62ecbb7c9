"""Hoshuyama CCAF coefficient bounds for robust-GSC blocking matrices.

Counterpart of ``distantspeech_tpu/beamform/ccaf.py``, a numpy copy:
vectorised over taps and mics, with the hardcoded sin(delta-theta) = 0.34
of the reference kept.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def ccafbounds(
    mic_loc: np.ndarray, fs: float = 16000, c: float = 343, p: float = 1, order: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Upper/lower tap bounds for the BM CCAF filters.

    mic_loc: [3, M] mic positions (a column per mic).
    Returns (phi [order, M], psi = -phi).
    """
    sin_dt = 0.34
    centroid = np.mean(mic_loc, axis=1, keepdims=True)  # [3, 1]
    bm = np.sqrt(np.sum((mic_loc - centroid) ** 2, axis=0))  # [M]
    Tm = bm * fs * sin_dt / c  # [M]
    n = np.arange(1, order + 1)[:, None]  # [order, 1]
    denom = np.maximum(0.1, np.maximum((n - p) - Tm[None, :], -(n - p) - Tm[None, :]))
    phi = 1.0 / (np.pi * denom)
    return phi, -phi
