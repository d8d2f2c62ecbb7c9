"""Coherence-based dual-mic gain rules, vectorised over frequency bins.

Counterpart of ``distantspeech_tpu/coherence/weights.py``: five published
gain formulas (Yousefian/Loizou 2012 and 2013, Ji 2017's coherent models),
selected by ``method`` on the host, each an elementwise tensor expression
over the whole ``[..., F]`` coherence.

Kept as in the JAX package: the geometry constant uses fixed fs = 16000,
nfft = 256 and c = 340 whatever the transform size; the gain floor is 0.02,
and a NaN gain becomes the floor after the two clamps (so +inf -> 1 and
-inf -> the floor).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_C = 340.0
_FS = 16000.0
_NFFT = 256.0
_FVV_UPPER = 0.998
_GAIN_FLOOR = 0.02
_EPS = 1e-6


def coherent_gain(Fvv_est: torch.Tensor, Fvv_diffuse, method: int = 3, r: float = 0.032) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gain for one mic pair across all bins.

    Fvv_est: [..., F] complex estimated coherence; Fvv_diffuse: [F] real
    diffuse-model coherence (an array or a tensor).  Returns (G [..., F],
    SNR [..., F]); SNR is only meaningful for method 5 (zero otherwise)."""
    F = Fvv_est.shape[-1]
    raw_real = Fvv_est.real  # methods 1, 2 and 5 read the unclipped real part
    k = torch.arange(F, dtype=raw_real.dtype, device=Fvv_est.device)
    Fn = torch.as_tensor(Fvv_diffuse, device=Fvv_est.device)

    Fy_real = torch.clamp(raw_real, max=_FVV_UPPER)
    Fy_imag = Fvv_est.imag
    Fn = torch.clamp(Fn, max=_FVV_UPPER)
    abs_est = torch.clamp(torch.sqrt(Fy_real**2 + Fy_imag**2), max=_FVV_UPPER)

    DDR = (torch.abs(Fn) ** 2 - abs_est**2) / (abs_est**2 - 1.0)  # eq. 10
    K = DDR / (DDR + 1.0)

    snr = torch.zeros_like(Fy_real)

    if method == 0:
        G = torch.ones_like(Fy_real)
    elif method == 1:
        # Yousefian/Loizou 2012 eq. 15 with low/high-band constants
        low = k <= 16
        alpha_exp = torch.where(low, 16.0, 2.0).to(k.dtype)  # exact in any float type
        Q = torch.where(low, torch.full_like(k, -0.1), torch.full_like(k, -0.3))
        G1 = 1.0 - torch.abs(raw_real) ** alpha_exp
        G2 = torch.where(Fy_imag < Q, 0.5, 1.0).to(k.dtype)
        G = G1 * G2
    elif method == 2:
        # Yousefian 2014 real-coherence rule
        G = (1.0 - raw_real**2 - Fy_imag**2) / (2.0 * (1.0 - raw_real))
    elif method in (3, 4):
        # Ji/Byun/Park 2017 (eqs. 12, 17-22)
        theta_s = np.pi / 2
        constant = 2.0 * np.pi * k * _FS * r / (_NFFT * _C)
        sin_alpha = torch.sin(constant * np.sin(theta_s))
        cos_alpha = torch.cos(constant * np.sin(theta_s))

        A = sin_alpha * K - Fy_imag
        B = cos_alpha * K - Fy_real + Fn * (1.0 - K)  # eq. 20
        Cc = (Fy_real - Fn * (1.0 - K)) * sin_alpha - Fy_imag * cos_alpha
        T = K - cos_alpha * (Fy_real - Fn * (1.0 - K)) - Fy_imag * sin_alpha
        sin_beta = (-B * Cc - A * T) / (A**2 + B**2 + _EPS)  # eq. 21
        if method == 3:
            G = (Fy_imag - sin_beta * K) / (sin_alpha - sin_beta + _EPS)  # eq. 12
        else:
            cos_beta = (A * Cc - B * T) / (A**2 + B**2 + _EPS)  # eq. 22
            A_ = cos_alpha - cos_beta
            B_ = cos_beta + Fn * (1.0 - K)  # eq. 16
            C_ = sin_alpha - sin_beta
            D_ = sin_beta * K
            gamma_sign = torch.where(torch.abs(Fy_imag - sin_alpha) < torch.abs(Fy_imag - sin_beta), 1.0, -1.0).to(k.dtype)
            T_ = torch.clamp(abs_est**2 * (A_**2 + C_**2) - (A_ * D_ - B_ * C_) ** 2, min=_EPS)
            G = -(A_ * B_ + C_ * D_) + gamma_sign * torch.sqrt(T_) / (A_**2 + C_**2 + _EPS)  # eq. 17
    elif method == 5:
        # Yousefian/Loizou 2013 competing-talker SNR rule (unclipped inputs)
        omega_ = 2.0 * np.pi * k / _NFFT * (_FS * r / _C)
        beta_ang = omega_ * np.cos(0.0)  # target endfire
        A = Fy_imag - torch.sin(omega_)
        B = torch.cos(omega_) - raw_real
        Cc = raw_real * torch.sin(omega_) - Fy_imag * torch.cos(omega_)
        T = 1.0 - raw_real * torch.cos(omega_) - Fy_imag * torch.sin(omega_)
        sin_alpha = (-B * Cc + A * T) / (A**2 + B**2 + _EPS)  # eq. 14
        snr = torch.clamp((sin_alpha - Fy_imag) / (Fy_imag - torch.sin(beta_ang) + _EPS), min=_EPS)  # eq. 10
        G = torch.sqrt(snr / (snr + 1.0))
    else:
        raise ValueError(f"unknown method {method}")

    # floor, then the >= 1 clamp, then NaN -> floor (torch.nan_to_num would send +-inf elsewhere)
    G = torch.where(G < _GAIN_FLOOR, _GAIN_FLOOR, G)
    G = torch.where(G >= 1.0, 1.0, G)
    G = torch.where(torch.isnan(G), _GAIN_FLOOR, G)
    return G, snr
