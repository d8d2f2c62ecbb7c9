"""TDOA and free-field steering vectors (numpy only, host-side).

Counterpart of ``distantspeech_tpu/array/steering.py`` without its
``jax.numpy`` helper.
"""

from __future__ import annotations

import numpy as np

from distantspeech_tpu_torch.array.geometry import ArrayGeometry


def omega_bins(n_fft: int, fs: int, half_bin: int | None = None) -> np.ndarray:
    """Angular frequency of each rfft bin, 2 pi k fs / n_fft.  [half_bin]."""
    if half_bin is None:
        half_bin = n_fft // 2 + 1
    return 2.0 * np.pi * np.arange(half_bin) * (fs / n_fft)


def _unit_direction(incident_angle) -> np.ndarray:
    """(azimuth, elevation) [..., 2] in radians -> unit vector [..., 3]."""
    incident_angle = np.asarray(incident_angle, dtype=np.float64)
    az = incident_angle[..., 0]
    el = incident_angle[..., 1]
    return np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1)


def compute_tau(geometry: ArrayGeometry, incident_angle, normalize: bool = False) -> np.ndarray:
    """Far-field delay of each mic relative to the origin, -(r_m . u) / c.
    ``normalize`` subtracts mic 0's delay.  Returns [..., M]."""
    u = _unit_direction(incident_angle)
    tau = -(u @ geometry.mic_loc.T) / geometry.c
    if normalize:
        tau = tau - tau[..., :1]
    return tau


def steering_vector(geometry: ArrayGeometry, incident_angle, n_fft: int, dtype=np.complex128) -> np.ndarray:
    """a[..., k, m] = exp(-1j omega_k tau_m).  Returns [..., half_bin, M]."""
    tau = compute_tau(geometry, incident_angle)
    omega = omega_bins(n_fft, geometry.fs)
    phase = omega[..., :, None] * tau[..., None, :]
    return np.exp(-1j * phase).astype(dtype)
