"""Fixed beamformers: delay-and-sum and superdirective.

Counterpart of ``distantspeech_tpu/beamform/fixed.py``: the weights are
designed once on the host (numpy, complex128), and applying them is one
einsum over the whole batched spectrogram.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.array.coherence import diffuse_coherence
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class FixedBeamformerConfig:
    stft: StftConfig = StftConfig(256, 128)
    weight_type: str = "SD"  # 'DS' | 'SD'
    diag_value: float = 1e-3


def fixed_beamformer_weights(
    geometry: ArrayGeometry,
    look_angle_deg,
    cfg: FixedBeamformerConfig = FixedBeamformerConfig(),
) -> np.ndarray:
    """Design DS or superdirective weights on the host.

    DS: w = a / M.  SD: MVDR against the diffuse-field coherence with
    diagonal loading.  Returns [half_bin, M] complex128.
    """
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    a0 = steering_vector(geometry, angle_rad, cfg.stft.n_fft)  # [F, M]
    if cfg.weight_type == "DS":
        return a0 / geometry.n_mics
    if cfg.weight_type == "SD":
        fvv = diffuse_coherence(geometry, cfg.stft.n_fft)
        fvv_inv = np.linalg.inv(fvv + cfg.diag_value * np.eye(geometry.n_mics))
        num = np.einsum("fij,fj->fi", fvv_inv, a0)
        den = np.einsum("fi,fi->f", a0.conj(), num)
        return num / den[:, None]
    raise ValueError(f"unknown weight_type {cfg.weight_type}")


def apply_weights(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y[..., t, f] = sum_c conj(W[f, c]) X[..., c, t, f]: the whole
    spectrogram at once."""
    return torch.einsum("fc,...ctf->...tf", torch.conj(W), X)


def fixed_process(x, W, stft_cfg: StftConfig, device=None) -> torch.Tensor:
    """Offline fixed beamforming of a time-domain batch.

    x: [..., C, S]; W: [F, C] complex weights (an array or a tensor).
    Returns [..., S] on ``device`` (fresh-stream zero carries).
    """
    dev = resolve_device(device)
    X = analysis(torch.as_tensor(x, device=dev), stft_cfg)  # [..., C, T, F]
    Y = apply_weights(torch.as_tensor(W, device=dev).to(X.dtype), X)  # [..., T, F]
    return synthesis(Y, stft_cfg)
