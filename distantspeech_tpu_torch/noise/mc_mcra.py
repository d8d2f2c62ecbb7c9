"""MC-MCRA: multichannel MCRA with local absence statistics (Souden 2011).

Counterpart of ``distantspeech_tpu/noise/mc_mcra.py``.  The spatial
covariances are REAL-valued (the real part of each outer product), kept in
[F, C, C].  The a-priori absence q is the local statistic only: the
reference computes global and frame statistics but never applies them.

Per-bin psi / psi_tilde thresholds:
    psi >= 100 or psi_tilde > 100     -> q = 0.01
    elif psi_tilde < M                -> q = 0.99
    else  (100 - psi_tilde)/(100 - M)  clipped to [0.01, 0.99]

The frame counter ``frm_cnt`` is a host integer, the same for every bin
and utterance.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.stats.linalg import gauss_jordan_inv


@dataclasses.dataclass(frozen=True)
class McMcraConfig:
    nfft: int = 256
    n_channels: int = 4
    alpha: float = 0.92  # Phi_yy pole
    alpha_d: float = 0.95  # noise pole
    diag: float = 1e-6
    rel_diag: float = 0.0  # extra loading scaled by tr(Phi_vv)/C.  0 matches
    # the reference (absolute 1e-6 in float64); in float32 a single-snapshot
    # Phi_vv is rank-1 with condition |y|^2/1e-6 and its inverse goes
    # non-finite during warmup: ~1e-5 bounds the condition at ~1/rel_diag.
    psi_0: float = 100.0
    psi_tilde_0: float = 100.0
    q_min: float = 0.01
    q_max: float = 0.99
    warmup_frames: int = 5
    gmin: float = 0.0631

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1


class McMcraState(NamedTuple):
    Phi_yy: torch.Tensor  # [..., F, C, C] real
    Phi_vv: torch.Tensor  # [..., F, C, C] real
    frm_cnt: int


class McMcraOut(NamedTuple):
    p: torch.Tensor  # [..., F]
    q: torch.Tensor  # [..., F] (local statistic)
    xi: torch.Tensor  # [..., F]
    gamma: torch.Tensor  # [..., F]
    G: torch.Tensor  # [..., F] OM-LSA style gain


def mc_mcra_init(cfg: McMcraConfig, batch_shape=(), dtype=torch.float32, device=None) -> McMcraState:
    z = torch.zeros((*batch_shape, cfg.half_bin, cfg.n_channels, cfg.n_channels), dtype=dtype,
                    device=resolve_device(device))
    return McMcraState(Phi_yy=z, Phi_vv=z, frm_cnt=0)


def mc_mcra_step(cfg: McMcraConfig, state: McMcraState, y: torch.Tensor) -> Tuple[McMcraState, McMcraOut]:
    """One frame.  y: [..., F, C] complex spectrum."""
    C = y.shape[-1]
    rdtype = state.Phi_yy.dtype
    eye = torch.eye(C, dtype=rdtype, device=y.device)

    outer = (y[..., :, None] * torch.conj(y)[..., None, :]).real.to(rdtype)  # symmetric
    Phi_yy = cfg.alpha * state.Phi_yy + (1.0 - cfg.alpha) * outer
    Phi_vv = Phi_yy if state.frm_cnt < cfg.warmup_frames else state.Phi_vv
    Phi_xx = Phi_yy - Phi_vv

    load = cfg.diag
    if cfg.rel_diag:
        tr = torch.diagonal(Phi_vv, dim1=-2, dim2=-1).sum(-1) / C
        load = cfg.diag + cfg.rel_diag * tr[..., None, None]
    Pinv = gauss_jordan_inv(Phi_vv + load * eye)

    # traces and quadratic forms as multiply-reduce, as in the JAX package:
    #   tr(Pinv @ Phi_yy) = sum_ij Pinv_ij Phi_yy_ji;  v = Pinv y
    psi_tilde = torch.sum(Pinv * Phi_yy.transpose(-1, -2), dim=(-2, -1))
    xi = torch.clamp(psi_tilde - C, 1e-6, 1e6)

    v = torch.sum(Pinv * y[..., None, :], dim=-1)  # Pinv @ y
    Pxv = torch.sum(Phi_xx * v[..., None, :], dim=-1)  # Phi_xx @ v
    gamma = torch.clamp(torch.sum(torch.conj(v) * Pxv, dim=-1).real, 1e-6, 1e6)

    # local absence statistic
    psi = torch.sum(y * torch.conj(v), dim=-1).real
    q_mid = torch.clamp((cfg.psi_tilde_0 - psi_tilde) / (cfg.psi_tilde_0 - C), cfg.q_min, cfg.q_max)
    q = torch.where(
        (psi >= cfg.psi_0) | (psi_tilde > cfg.psi_tilde_0),
        torch.full_like(q_mid, cfg.q_min),
        torch.where(psi_tilde < C, torch.full_like(q_mid, cfg.q_max), q_mid),
    )

    p = 1.0 / (1.0 + q / (1.0 - q) * (1.0 + xi) * torch.exp(-(gamma / (1.0 + xi))))
    p = torch.clamp(p, 0.01, 0.99)

    alpha_tilde = (cfg.alpha_d + (1.0 - cfg.alpha_d) * p)[..., None, None]
    Phi_vv_new = alpha_tilde * Phi_vv + (1.0 - alpha_tilde) * outer

    # OM-LSA gain with the first two bins zeroed
    G_H1 = xi / (1.0 + xi)
    G = torch.clamp(G_H1**p * cfg.gmin ** (1.0 - p), cfg.gmin, 1.0)
    G[..., :2] = 0.0

    new_state = McMcraState(Phi_yy=Phi_yy, Phi_vv=Phi_vv_new, frm_cnt=state.frm_cnt + 1)
    return new_state, McMcraOut(p=p, q=q, xi=xi, gamma=gamma, G=G)


def mc_mcra_run(cfg: McMcraConfig, Y_tf: torch.Tensor) -> McMcraOut:
    """Loop over frames.  Y_tf: [T, ..., F, C] complex -> McMcraOut [T, ...]."""
    state = mc_mcra_init(cfg, batch_shape=Y_tf.shape[1:-2], dtype=Y_tf.real.dtype, device=Y_tf.device)
    outs = []
    for y in Y_tf:
        state, out = mc_mcra_step(cfg, state, y)
        outs.append(out)
    return McMcraOut(*(torch.stack(o) for o in zip(*outs)))
