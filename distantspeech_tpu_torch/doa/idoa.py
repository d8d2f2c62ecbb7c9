"""IDOA spatial speech-presence probability (instantaneous DOA similarity).

Counterpart of ``distantspeech_tpu/doa/idoa.py``: a recursive RTF estimate
B_hat from smoothed cross-spectra, its cosine similarity Delta against a
free-field RTF grid Psi, H0 / Hd Gaussian / exponential likelihoods, and
the posterior p per (bin, direction).

The reference's quirks are kept: the variance recursion's reversed
smoothing weights (var <- (1-avg) var + avg (Delta-mu)^2), the 0.01
variance floor, the broadband beta_n from the mean of mu_Delta over bins
72:128, and the theta grid built by passing the index as degrees.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device, wrapper_input
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import steering_vector


@dataclasses.dataclass(frozen=True)
class IdoaConfig:
    n_fft: int = 512
    n_theta: int = 360  # 360 circular / 180 linear
    alpha: float = 0.02  # RTF smoothing
    beta: float = 7.6

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1


def idoa_rtf_grid(cfg: IdoaConfig, geometry: ArrayGeometry) -> np.ndarray:
    """Free-field RTF grid Psi [F, M-1, Theta]."""
    angles = np.arange(cfg.n_theta, dtype=np.float64)
    look = np.stack([angles, np.zeros_like(angles)], axis=-1) / 180.0 * np.pi
    a = steering_vector(geometry, look, cfg.n_fft)  # [Theta, F, M]
    psi = a[..., 1:] / a[..., :1]
    return np.moveaxis(psi, 0, -1)  # [F, M-1, Theta]


class IdoaState(NamedTuple):
    Y_smooth: torch.Tensor  # [..., F]
    Y_xcorr: torch.Tensor  # [..., F, M-1] complex
    mu_Delta: torch.Tensor  # [..., F, Theta]
    mu_Delta_h0: torch.Tensor
    var_Delta_h0: torch.Tensor
    p: torch.Tensor  # [..., F, Theta]


def idoa_init(cfg: IdoaConfig, n_mics: int, batch_shape=(), dtype=torch.float32, device=None) -> IdoaState:
    dev = resolve_device(device)
    F, Th = cfg.half_bin, cfg.n_theta
    z = torch.zeros((*batch_shape, F, Th), dtype=dtype, device=dev)
    return IdoaState(
        Y_smooth=torch.zeros((*batch_shape, F), dtype=dtype, device=dev),
        Y_xcorr=torch.zeros((*batch_shape, F, n_mics - 1), dtype=dtype.to_complex(), device=dev),
        mu_Delta=z,
        mu_Delta_h0=z,
        var_Delta_h0=torch.full((*batch_shape, F, Th), 0.1, dtype=dtype, device=dev),
        p=z,
    )


def idoa_step(
    cfg: IdoaConfig, psi: torch.Tensor, psi_norm: torch.Tensor, state: IdoaState, X: torch.Tensor
) -> Tuple[IdoaState, torch.Tensor]:
    """One frame.  psi: [F, M-1, Theta]; psi_norm: [F, Theta] = ||psi||;
    X: [..., F, M] complex spectra.  Returns (state, p [..., F, Theta])."""
    a = cfg.alpha
    Y_curr = (X[..., 0] * torch.conj(X[..., 0])).abs()
    Y_xcorr_curr = X[..., 1:] * torch.conj(X[..., :1])

    Y_smooth = (1.0 - a) * state.Y_smooth + a * Y_curr
    Y_xcorr = (1.0 - a) * state.Y_xcorr + a * Y_xcorr_curr
    B_hat = Y_xcorr / Y_smooth[..., None].to(Y_xcorr.dtype)  # [..., F, M-1]

    den = psi_norm * torch.linalg.vector_norm(B_hat, dim=-1)[..., None]  # [..., F, Theta]
    Delta = torch.einsum("fmt,...fm->...ft", torch.conj(psi).to(B_hat.dtype), B_hat).real / (den + 1e-6)

    avg = (1.0 - state.p) * 0.98
    mu_Delta = avg * state.mu_Delta + (1.0 - avg) * Delta

    avg0 = 0.998 + (1.0 - 0.998) * state.p
    mu_h0 = avg0 * state.mu_Delta_h0 + (1.0 - avg0) * Delta
    var_h0 = torch.clamp((1.0 - avg0) * state.var_Delta_h0 + avg0 * (Delta - mu_h0) ** 2, min=0.01)

    beta_n = 1.0 / (1.0 - torch.mean(mu_Delta[..., 72:128, :], dim=-2))  # [..., Theta]

    p_h0 = torch.exp(-((Delta - mu_h0) ** 2) / (2.0 * 0.5**2))
    p_hd = beta_n[..., None, :] * torch.exp(cfg.beta * (Delta - 1.0))
    Lam = p_hd / (p_h0 + 1e-6)
    p = Lam / (1.0 + Lam)

    return IdoaState(Y_smooth=Y_smooth, Y_xcorr=Y_xcorr, mu_Delta=mu_Delta,
                     mu_Delta_h0=mu_h0, var_Delta_h0=var_h0, p=p), p


def idoa_run(cfg: IdoaConfig, geometry: ArrayGeometry, X_tf) -> torch.Tensor:
    """Loop over frames.  X_tf: [T, ..., F, M] (a tensor stays on its
    device; an array goes to the card) -> p [T, ..., F, Theta]."""
    X_tf = wrapper_input(X_tf)
    rdtype = X_tf.real.dtype
    psi_np = idoa_rtf_grid(cfg, geometry)
    psi = torch.as_tensor(psi_np, device=X_tf.device).to(X_tf.dtype)
    psi_norm = torch.as_tensor(np.linalg.norm(psi_np, axis=-2).real, device=X_tf.device).to(rdtype)  # [F, Theta]
    state = idoa_init(cfg, geometry.n_mics, batch_shape=X_tf.shape[1:-2], dtype=rdtype, device=X_tf.device)
    ps = []
    for x in X_tf:
        state, p = idoa_step(cfg, psi, psi_norm, state, x)
        ps.append(p)
    return torch.stack(ps)
