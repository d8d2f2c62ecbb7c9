"""SRP-PHAT steered-response-power DOA.

Counterpart of ``distantspeech_tpu/doa/srp.py``.  The PHAT normaliser
|a* y| equals |y| (|a| = 1), so the per-angle normalisation collapses to
one whitening of the spectrum followed by a [Theta, F, M] x [T, F, M]
contraction.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.noise.mcra import McraConfig, mcra_run
from distantspeech_tpu_torch.ops.cuda_srp import fused_srp_spectrum, pack_grid, phat_whiten
from distantspeech_tpu_torch.transform import StftConfig, analysis


@dataclasses.dataclass(frozen=True)
class SrpConfig:
    n_fft: int = 256
    resolution: int = 1  # degrees

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.n_fft // 2)

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.n_fft, L=65)


def srp_steering_grid(cfg: SrpConfig, geometry: ArrayGeometry) -> np.ndarray:
    """Free-field steering vectors for 0..359 deg: [Theta, F, M] complex."""
    angles = np.arange(0, 360, cfg.resolution, dtype=np.float64)
    look = np.stack([angles, np.zeros_like(angles)], axis=-1) / 180.0 * np.pi
    return steering_vector(geometry, look, cfg.n_fft)


# (config, geometry, device, packed) -> the grid on the device
_GRIDS: dict = {}
_GRIDS_KEPT = 16


def device_grid(cfg: SrpConfig, geometry: ArrayGeometry, device, packed: bool) -> torch.Tensor:
    """``srp_steering_grid`` on ``device``, built and copied once per
    (config, geometry, device): as a complex tensor [Theta, F, M], or
    packed for K10 (``ops.cuda_srp.pack_grid``, [F, 2M, 2 Theta]).  The
    same numbers as building it anew."""
    device = torch.device(device)
    loc = np.ascontiguousarray(geometry.mic_loc, dtype=np.float64)
    key = (cfg, loc.shape, loc.tobytes(), geometry.fs, geometry.c, str(device), packed)
    grid = _GRIDS.get(key)
    if grid is None:
        grid_np = srp_steering_grid(cfg, geometry)
        grid = pack_grid(grid_np, device) if packed else torch.as_tensor(grid_np, device=device)
        if len(_GRIDS) >= _GRIDS_KEPT:
            _GRIDS.pop(next(iter(_GRIDS)))
        _GRIDS[key] = grid
    return grid


def srp_angle_spectrum(Y_tfm: torch.Tensor, grid, phat: bool = True) -> torch.Tensor:
    """Angle spectrum of a spectrogram.  Y_tfm: [T, ..., F, M]; grid:
    [Theta, F, M].  Returns [T, ..., Theta]: sum_f |sum_m a*_theta y_phat|.
    It materialises the [T, ..., Theta, F] steered field."""
    Yw = phat_whiten(Y_tfm) if phat else Y_tfm
    g = torch.conj(torch.as_tensor(grid, device=Y_tfm.device)).to(Y_tfm.dtype)
    return torch.einsum("afm,...fm->...af", g, Yw).abs().sum(dim=-1)


def srp_process(
    x, geometry: ArrayGeometry, cfg: SrpConfig = SrpConfig(), phat: bool = True, backend: str = "scan", device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline SRP-PHAT of a time batch.  x: [..., M, S].

    Returns (angle_spectrum [..., T, Theta], p [..., T, F]), with the MCRA
    speech presence of mic 0 beside the spectrum.

    backend: 'scan' (the einsum of ``srp_angle_spectrum``, which
    materialises the steered field) or 'fused' (kernel K10,
    ``ops.cuda_srp.fused_srp_spectrum``: per-bin steered power accumulated
    on chip).  On a CPU tensor 'fused' runs the kernel's plain version.
    The steering grid is built and copied to the device once per (config,
    geometry) (``device_grid``)."""
    x = torch.as_tensor(x, device=resolve_device(device))
    X = analysis(x, cfg.stft)  # [..., M, T, F]
    Y = torch.movedim(torch.movedim(X, -3, -1), -3, 0)  # [T, ..., F, M]
    if backend == "fused":
        spec = fused_srp_spectrum(Y, None, phat=phat, packed=device_grid(cfg, geometry, Y.device, packed=True))
    elif backend == "scan":
        spec = srp_angle_spectrum(Y, device_grid(cfg, geometry, Y.device, packed=False), phat=phat)
    else:
        raise ValueError(f"backend must be 'scan' or 'fused', got {backend!r}")
    _, p = mcra_run(cfg.mcra, Y[..., 0].abs() ** 2)
    return torch.movedim(spec, 0, -2), torch.movedim(p, 0, -2)
