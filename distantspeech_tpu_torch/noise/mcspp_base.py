"""Gaussian-model multichannel speech presence probability (Souden 2010).

Counterpart of ``distantspeech_tpu/noise/mcspp_base.py``: the base
multichannel SPP tracker, and ``McSppOut``, the output both McSpp trackers
share.  One trait is kept: the base method takes the REAL part of the
covariances for the inverse and the xi / gamma statistics, while Phi_yy and
Phi_vv themselves stay complex.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.noise.mcra import McraConfig, McraState, mcra_init, mcra_step
from distantspeech_tpu_torch.stats.linalg import gauss_jordan_inv, matvec, trace_mm, vecmat


@dataclasses.dataclass(frozen=True)
class McSppBaseConfig:
    nfft: int = 256
    n_channels: int = 4
    alpha: float = 0.92  # Phi_yy smoothing
    alpha_d: float = 0.92  # noise pole
    diag: float = 1e-6  # diagonal loading
    q_min: float = 0.01
    q_max: float = 0.99
    p_min: float = 0.01
    p_max: float = 0.99
    pmwf_beta: float = 1.0

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.nfft, L=15)


class McSppBaseState(NamedTuple):
    Phi_yy: torch.Tensor  # [..., F, C, C] complex
    Phi_vv: torch.Tensor  # [..., F, C, C] complex
    p: torch.Tensor  # [..., F]
    mcra: McraState


class McSppOut(NamedTuple):
    p: torch.Tensor  # [..., F] speech presence
    q: torch.Tensor  # [..., F] a-priori absence
    xi: torch.Tensor  # [..., F] prior SNR statistic
    gamma: torch.Tensor  # [..., F] posterior statistic
    w: torch.Tensor  # [..., F, C] PMWF weights


def mcspp_base_init(cfg: McSppBaseConfig, batch_shape=(), cdtype=torch.complex64, device=None) -> McSppBaseState:
    dev = resolve_device(device)
    F, C = cfg.half_bin, cfg.n_channels
    z = torch.zeros((*batch_shape, F, C, C), dtype=cdtype, device=dev)
    rdtype = cdtype.to_real()
    return McSppBaseState(
        Phi_yy=z, Phi_vv=z,
        p=torch.zeros((*batch_shape, F), dtype=rdtype, device=dev),
        mcra=mcra_init(cfg.mcra, batch_shape, dtype=rdtype, device=dev),
    )


def mcspp_base_step(cfg: McSppBaseConfig, state: McSppBaseState, y: torch.Tensor) -> Tuple[McSppBaseState, McSppOut]:
    """One MC-SPP frame.  y: [..., F, C] complex multichannel spectrum."""
    C = y.shape[-1]
    psd_yy = y[..., :, None] * torch.conj(y)[..., None, :]  # [..., F, C, C]
    Phi_yy = cfg.alpha * state.Phi_yy + (1.0 - cfg.alpha) * psd_yy
    Phi_xx = Phi_yy - state.Phi_vv

    eye = torch.eye(C, dtype=psd_yy.real.dtype, device=y.device)
    Pinv = gauss_jordan_inv(state.Phi_vv.real + cfg.diag * eye)  # real
    xi = trace_mm(Pinv, Phi_xx.real)
    # gamma = y^H Pinv Phi_xx Pinv y on real matrices
    Pc = Pinv.to(y.dtype)
    lv = vecmat(torch.conj(y), Pc)
    rv = matvec(Pc, y)
    gamma = torch.sum(lv * matvec(Phi_xx.real.to(y.dtype), rv), dim=-1).real
    xi = torch.clamp(xi, 1e-6, 1e6)
    gamma = torch.clamp(gamma, 1e-6, 1e6)

    # q from MCRA on the reference channel
    power = (y[..., 0] * torch.conj(y[..., 0])).abs()
    mcra_state, (_, p_mcra) = mcra_step(cfg.mcra, state.mcra, power)
    q = torch.clamp(torch.sqrt(1.0 - p_mcra), cfg.q_min, cfg.q_max)

    # posterior SPP
    p = 1.0 / (1.0 + q / (1.0 - q) * (1.0 + xi) * torch.exp(-(gamma / (1.0 + xi))))
    p = torch.clamp(p, cfg.p_min, cfg.p_max)

    # SPP-weighted noise covariance update
    alpha_tilde = (cfg.alpha_d + (1.0 - cfg.alpha_d) * p)[..., None, None]
    Phi_vv = alpha_tilde * state.Phi_vv + (1.0 - alpha_tilde) * psd_yy

    # PMWF weights w = (Pinv Phi_xx u) / (beta + xi)
    w = matvec(Pc, Phi_xx[..., :, 0]) / (cfg.pmwf_beta + xi)[..., None]
    return McSppBaseState(Phi_yy=Phi_yy, Phi_vv=Phi_vv, p=p, mcra=mcra_state), McSppOut(p=p, q=q, xi=xi, gamma=gamma, w=w)


def mcspp_base_run(cfg: McSppBaseConfig, Y_tf: torch.Tensor) -> McSppOut:
    """Loop over frames.  Y_tf: [T, ..., F, C] -> McSppOut of [T, ...] tensors."""
    state = mcspp_base_init(cfg, batch_shape=Y_tf.shape[1:-2], cdtype=Y_tf.dtype, device=Y_tf.device)
    outs = []
    for y in Y_tf:
        state, out = mcspp_base_step(cfg, state, y)
        outs.append(out)
    return McSppOut(*(torch.stack(o) for o in zip(*outs)))
