"""Multichannel OM-LSA postfilter (Cohen / Gannot / Berdugo 2003).

Counterpart of ``distantspeech_tpu/noise/omlsa.py``: the transient
beam-to-reference ratio (TBRR) postfilter of the GSC family.  The beam
power y and the M-1 blocking-matrix reference powers u drive an a-priori
absence probability q, an OM-LSA gain G and an SPP-weighted noise PSD.
The M per-channel MCRA trackers are one batched MCRA state with a leading
channel axis.  Kept as in the reference: zero-padded 3-tap frequency
smoothing, ``alpha_d = 0.85``, the ``beta = 1.47`` noise overestimate, and
a first frame that only seeds the state.  The frame counter is a host
integer, like MCRA's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.noise.mcra import McraConfig, McraState, mcra_init, mcra_step


@dataclasses.dataclass(frozen=True)
class OmlsaConfig:
    nfft: int = 256
    n_channels: int = 4  # M: 1 beam + (M-1) references
    alpha_s: float = 0.8  # zeta smoothing
    alpha_d: float = 0.85  # noise-psd pole
    alpha_xi: float = 0.921  # decision-directed prior-SNR pole
    beta: float = 1.47  # noise-update overestimate
    Bmin: float = 1.66
    eps_tbrr: float = 0.01
    gamma_high: float = 10.0
    gamma_low: float = 1.0
    omega_high: float = 3.0
    omega_low: float = 0.3
    q_min: float = 1e-6
    q_max: float = 0.9999998
    gmin_db: float = -12.0
    cal_weights: bool = True

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1

    @property
    def gmin(self) -> float:
        return 10.0 ** (self.gmin_db / 10.0)

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.nfft)


class OmlsaState(NamedTuple):
    mcra: McraState  # batched [..., M, F] trackers (ch 0 = beam)
    zeta_Y: torch.Tensor  # smoothed beam power      [..., F]
    zeta_U: torch.Tensor  # smoothed reference power [..., M-1, F]
    lambda_d: torch.Tensor  # noise PSD              [..., F]
    gamma: torch.Tensor  # posterior SNR             [..., F]
    G_H1: torch.Tensor  # H1 gain                    [..., F]
    G: torch.Tensor  # OM-LSA gain                   [..., F]
    p: torch.Tensor  # speech presence               [..., F]
    frm_cnt: int


def omlsa_init(cfg: OmlsaConfig, batch_shape=(), dtype=torch.float32, device=None) -> OmlsaState:
    dev = resolve_device(device)
    F, M = cfg.half_bin, cfg.n_channels
    z = torch.zeros((*batch_shape, F), dtype=dtype, device=dev)
    one = torch.ones((*batch_shape, F), dtype=dtype, device=dev)
    return OmlsaState(
        mcra=mcra_init(cfg.mcra, (*batch_shape, M), dtype=dtype, device=dev),
        zeta_Y=one,
        zeta_U=torch.zeros((*batch_shape, M - 1, F), dtype=dtype, device=dev),
        lambda_d=z,
        gamma=one,
        G_H1=one,
        G=one,
        p=z,
        frm_cnt=0,
    )


def _smooth3(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded [0.25, 0.5, 0.25] frequency smoothing."""
    left = torch.nn.functional.pad(x[..., :-1], (1, 0))
    right = torch.nn.functional.pad(x[..., 1:], (0, 1))
    return 0.25 * left + 0.5 * x + 0.25 * right


def omlsa_step(cfg: OmlsaConfig, state: OmlsaState, y: torch.Tensor, u: torch.Tensor):
    """One OM-LSA frame.  y: [..., F] beam power; u: [..., M-1, F] reference
    powers.  Returns (new_state, (lambda_d, p, G))."""
    yu = torch.cat([y[..., None, :], u], dim=-2)  # [..., M, F]
    mcra_state, (mu, _) = mcra_step(cfg.mcra, state.mcra, yu)
    MU_Y, MU_U = mu[..., 0, :], mu[..., 1:, :]

    if state.frm_cnt == 0:  # the first frame only seeds the state
        new_state = state._replace(mcra=mcra_state, zeta_Y=y, zeta_U=u, lambda_d=y, frm_cnt=1)
        return new_state, (new_state.lambda_d, new_state.p, new_state.G)

    zeta_Y = cfg.alpha_s * state.zeta_Y + (1.0 - cfg.alpha_s) * _smooth3(y)
    zeta_U = cfg.alpha_s * state.zeta_U + (1.0 - cfg.alpha_s) * _smooth3(u)

    # Eq. 6: transient beam-to-reference ratio
    omega = torch.clamp(zeta_Y - MU_Y, min=1e-6) / (
        torch.maximum(torch.amax(zeta_U - MU_U, dim=-2), cfg.eps_tbrr * MU_Y) + 1e-6
    )
    omega = torch.clamp(omega, 0.1, 100.0)
    # Eq. 27: posterior SNR at the beam output
    gamma_s = torch.clamp(y / (MU_Y * cfg.Bmin + 1e-6), max=100.0)
    # Eq. 29: a-priori absence probability
    q_cand = torch.maximum(
        (cfg.gamma_high - gamma_s) / (cfg.gamma_high - cfg.gamma_low),
        (cfg.omega_high - omega) / (cfg.omega_high - cfg.omega_low),
    )
    absent = (gamma_s < cfg.gamma_low) | (omega < cfg.omega_low)
    q_hat = torch.clamp(torch.where(absent, torch.ones_like(q_cand), q_cand), cfg.q_min, cfg.q_max)

    gamma = y / torch.clamp(state.lambda_d, min=1e-10)
    # Eq. 30: decision-directed prior SNR from the previous frame's gamma and G_H1
    xi_hat = cfg.alpha_xi * state.G_H1**2 * state.gamma + (1.0 - cfg.alpha_xi) * torch.clamp(gamma - 1.0, min=0.0)
    nu = gamma * xi_hat / (1.0 + xi_hat)
    G_H1 = xi_hat / (1.0 + xi_hat)
    # Eq. 28: speech presence probability
    p = 1.0 / (1.0 + q_hat / (1.0 - q_hat) * (1.0 + xi_hat) * torch.exp(-nu))

    alpha_tilde = cfg.alpha_d + (1.0 - cfg.alpha_d) * p
    lambda_d = alpha_tilde * state.lambda_d + cfg.beta * (1.0 - alpha_tilde) * y
    G = torch.clamp(G_H1**p * cfg.gmin ** (1.0 - p), cfg.gmin, 1.0) if cfg.cal_weights else state.G

    new_state = OmlsaState(
        mcra=mcra_state, zeta_Y=zeta_Y, zeta_U=zeta_U, lambda_d=lambda_d, gamma=gamma,
        G_H1=G_H1, G=G, p=p, frm_cnt=state.frm_cnt + 1,
    )
    return new_state, (lambda_d, p, G)


def omlsa_run(cfg: OmlsaConfig, Y_tf: torch.Tensor, U_tf: torch.Tensor):
    """Loop ``omlsa_step`` over frames.  Y_tf: [T, ..., F]; U_tf:
    [T, ..., M-1, F].  Returns (lambda_d, p, G), each [T, ..., F]."""
    state = omlsa_init(cfg, batch_shape=Y_tf.shape[1:-1], dtype=Y_tf.dtype, device=Y_tf.device)
    outs = []
    for y, u in zip(Y_tf, U_tf):
        state, out = omlsa_step(cfg, state, y, u)
        outs.append(out)
    return tuple(torch.stack(o) for o in zip(*outs))
