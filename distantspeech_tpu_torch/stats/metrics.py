"""Beamformer quality metrics: array gain, WNG, DI, beampattern.

Counterpart of ``distantspeech_tpu/stats/metrics.py``: fully broadcast over
azimuths and bins.  The steering vectors and the diffuse coherence are
built on the host (numpy) and moved to the weights' device and dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from distantspeech_tpu_torch.array.coherence import diffuse_coherence
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import steering_vector


def array_gain(weights: torch.Tensor, steer: torch.Tensor, Rvv: torch.Tensor, return_db: bool = False) -> torch.Tensor:
    """G = |w^H a|^2 / |w^H Rvv w| per bin.

    weights, steer: [..., F, C]; Rvv: [..., F, C, C] -> [..., F].
    """
    num = torch.einsum("...i,...i->...", torch.conj(weights), steer)
    den = torch.einsum("...i,...ij,...j->...", torch.conj(weights), Rvv, weights)
    G = num.abs() ** 2 / den.abs()
    if return_db:
        G = 10.0 * torch.log10(G + 1e-6)
    return G


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device).to(like.dtype)


def wng_di(geometry: ArrayGeometry, weights: torch.Tensor, look_angle_deg, n_fft: int, return_db: bool = True):
    """White-noise gain and directivity index of ``weights`` toward a look angle.

    weights: [F, C] -> (wng [F], di [F]).
    """
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    steer = _on(steering_vector(geometry, angle_rad, n_fft), weights)
    fvv = _on(diffuse_coherence(geometry, n_fft), weights)
    di = array_gain(weights, steer, fvv)
    eye = torch.eye(geometry.n_mics, dtype=weights.dtype, device=weights.device).expand(fvv.shape)
    wng = array_gain(weights, steer, eye)
    if return_db:
        wng = 10.0 * torch.log10(wng + 1e-6)
        di = 10.0 * torch.log10(di + 1e-6)
    return wng, di


def beampattern(geometry: ArrayGeometry, weights: torch.Tensor, n_fft: int, n_azimuths: int = 360) -> torch.Tensor:
    """|w^H a(az)| over a full azimuth sweep, in dB.

    weights: [F, C] -> [n_azimuths, F].
    """
    az = np.arange(n_azimuths) * (360.0 / n_azimuths) / 180.0 * np.pi
    angles = np.stack([az, np.zeros_like(az)], axis=-1)
    a = _on(steering_vector(geometry, angles, n_fft), weights)  # [A, F, C]
    resp = torch.einsum("fc,afc->af", torch.conj(weights), a).abs()
    return 20.0 * torch.log10(resp + 1e-12)
