"""Fractional-delay time alignment (the GSC fixed-beamformer steering).

Counterpart of ``distantspeech_tpu/array/alignment.py`` (host-side numpy):
the filter design runs once per look direction; ``ops.fir`` applies it.
"""

from __future__ import annotations

import numpy as np

from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import compute_tau


def fractional_delay_filter_bank(delays: np.ndarray) -> np.ndarray:
    """Windowed-sinc fractional-delay bank.

    delays: [C] in (fractional) samples.  Returns [filter_len, C] with
    filter_len = 81 + ceil(max(delays - min(delays)))."""
    delays = np.array(delays, dtype=np.float64)
    delays -= delays.min()
    N = delays.shape[0]
    L = 81
    filter_length = L + int(np.ceil(delays).max())
    bank_flat = np.zeros(N * filter_length)
    di = np.floor(delays).astype(np.int64)
    df = delays - di
    T = np.arange(L)
    indices = T[None, :] + (di[:, None] + filter_length * np.arange(N)[:, None])
    sinc_times = T - df[:, None] - (L - 1) / 2
    windows = np.tile(np.hanning(L), N)
    bank_flat[indices.ravel()] = windows * np.sinc(sinc_times.ravel())
    return np.reshape(bank_flat, (N, -1)).T


def time_alignment_filters(geometry: ArrayGeometry, angle_rad) -> np.ndarray:
    """The per-mic alignment FIR bank for a look direction: every channel
    is delayed to the latest arrival (delays ``-(tau - max(tau)) * fs``).
    Returns coeffs [C, K] (channel-major, for ``ops.fir``)."""
    tau = compute_tau(geometry, np.asarray(angle_rad, dtype=np.float64))
    tau = -(tau - np.max(tau))
    return fractional_delay_filter_bank(tau * geometry.fs).T
