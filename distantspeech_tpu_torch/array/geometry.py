"""Microphone-array geometry (numpy only, host-side metadata).

Counterpart of ``distantspeech_tpu/array/geometry.py``; the port keeps its
own copy so it never imports the JAX package.  Axis conventions: mic 0 on
the +x axis, azimuth counter-clockwise from +x, 90 deg along +y.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SOUND_SPEED = 343.0
DEFAULT_FS = 16000


def sph2cart(azimuth, elevation, r):
    """(azimuth, elevation, radius) -> Cartesian, angles in radians."""
    x = r * np.cos(elevation) * np.cos(azimuth)
    y = r * np.cos(elevation) * np.sin(azimuth)
    z = r * np.sin(elevation)
    return x, y, z


def linear_array(n_mics: int, spacing: float) -> np.ndarray:
    """Uniform linear array along x, centred on the origin; mic ``m`` at
    ``x = -(m - (M-1)/2) * spacing``.  Returns [M, 3]."""
    loc = np.zeros((n_mics, 3))
    loc[:, 0] = -(np.arange(n_mics) - (n_mics - 1) / 2) * spacing
    return loc


def circular_array(n_mics: int, radius: float) -> np.ndarray:
    """Uniform circular array in the xy plane, mic 0 on +x, with the
    integer degree step ``arange(0, 360, int(360/M))``.  Returns [M, 3]."""
    az = (np.arange(0, 360, int(360 / n_mics)) * np.pi / 180.0)[:n_mics]
    x, y, z = sph2cart(az, 0.0, radius)
    return np.stack([x, y, np.broadcast_to(z, x.shape)], axis=-1)


@dataclasses.dataclass(frozen=True)
class ArrayGeometry:
    """Mic coordinates ``mic_loc`` [M, 3] in metres, sample rate ``fs`` and
    speed of sound ``c``."""

    mic_loc: np.ndarray
    fs: int = DEFAULT_FS
    c: float = SOUND_SPEED

    @property
    def n_mics(self) -> int:
        return int(self.mic_loc.shape[0])

    @staticmethod
    def linear(n_mics: int, spacing: float = 0.032, fs: int = DEFAULT_FS, c: float = SOUND_SPEED) -> "ArrayGeometry":
        return ArrayGeometry(linear_array(n_mics, spacing), fs=fs, c=c)

    @staticmethod
    def circular(n_mics: int, radius: float = 0.032, fs: int = DEFAULT_FS, c: float = SOUND_SPEED) -> "ArrayGeometry":
        return ArrayGeometry(circular_array(n_mics, radius), fs=fs, c=c)
