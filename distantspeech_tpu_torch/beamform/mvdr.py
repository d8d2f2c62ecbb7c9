"""Online adaptive MVDR with MCRA-gated noise-covariance updates.

Counterpart of ``distantspeech_tpu/beamform/mvdr.py``: one frame is one
vectorised step over all bins (and any utterance batch); the offline entry point
loops the step over frames.  The carried solve is the M-vector
u = (Rvv + load I)^-1 a, not the inverse; the output is
w^H Z = (u^H Z) / conj(a^H u).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.noise.mcra import McraConfig, McraState, mcra_init, mcra_step
from distantspeech_tpu_torch.stats.linalg import ldl_solve
from distantspeech_tpu_torch.stats.psd import rank1_update
from distantspeech_tpu_torch.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class MvdrConfig:
    stft: StftConfig = StftConfig(256, 128)
    alpha_y: float = 0.8  # Ryy smoothing
    alpha_v: float = 0.9998  # Rvv smoothing
    p_vad: float = 0.4  # MCRA covariance gate p < p_vad
    diag: float = 1e-6  # diagonal loading
    rel_diag: float = 0.0  # extra loading rel_diag * tr(Rvv)/M (float32 conditioning guard)
    mcra_L: int = 15  # minima window (real speech wants ~65)
    vad_guard: bool = False  # also gate Rvv on MCRA's raw indicator S/Smin <= delta_s

    @property
    def mcra(self) -> McraConfig:
        return McraConfig(nfft=self.stft.n_fft, L=self.mcra_L)


class MvdrState(NamedTuple):
    Ryy: torch.Tensor  # [..., F, M, M] (kept for state parity; the output never reads it)
    Rvv: torch.Tensor  # [..., F, M, M]
    u: torch.Tensor  # [..., F, M] held solve (Rvv + load I)^-1 a
    mcra: McraState


def mvdr_init(cfg: MvdrConfig, n_mics: int, batch_shape=(), cdtype=torch.complex64, device=None) -> MvdrState:
    dev = resolve_device(device)
    F = cfg.stft.half_bin
    z = torch.zeros((*batch_shape, F, n_mics, n_mics), dtype=cdtype, device=dev)
    u = torch.zeros((*batch_shape, F, n_mics), dtype=cdtype, device=dev)
    return MvdrState(Ryy=z, Rvv=z, u=u, mcra=mcra_init(cfg.mcra, batch_shape, dtype=z.real.dtype, device=dev))


def mvdr_step(cfg: MvdrConfig, steer: torch.Tensor, state: MvdrState, Z: torch.Tensor) -> Tuple[MvdrState, torch.Tensor]:
    """One frame.  steer: [F, M]; Z: [..., F, M].  Returns (state, Yf [..., F])."""
    power = (Z[..., 0] * torch.conj(Z[..., 0])).real
    mcra_state, (_, p) = mcra_step(cfg.mcra, state.mcra, power)

    Ryy = rank1_update(state.Ryy, Z, cfg.alpha_y)

    update = p < cfg.p_vad
    if cfg.vad_guard:
        update = update & (mcra_state.S / (mcra_state.Smin + 1e-6) <= cfg.mcra.delta_s)
    Rvv_cand = rank1_update(state.Rvv, Z, cfg.alpha_v)
    M = Z.shape[-1]
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    load = cfg.diag
    if cfg.rel_diag:
        # the loading follows the trace of the CANDIDATE, before gating
        tr = torch.diagonal(Rvv_cand.real, dim1=-2, dim2=-1).sum(-1) / M
        load = cfg.diag + cfg.rel_diag * tr[..., None, None].to(Z.dtype)
    a = steer.to(Z.dtype)
    u_cand = ldl_solve(Rvv_cand + load * eye, a.expand(Z.shape))
    Rvv = torch.where(update[..., None, None], Rvv_cand, state.Rvv)
    u = torch.where(update[..., None], u_cand, state.u)

    den = torch.sum(torch.conj(a) * u, dim=-1)
    Yf = torch.sum(torch.conj(u) * Z, dim=-1) / torch.conj(den)
    return MvdrState(Ryy=Ryy, Rvv=Rvv, u=u, mcra=mcra_state), Yf


def mvdr_scan(cfg: MvdrConfig, steer: torch.Tensor, state: MvdrState, X: torch.Tensor):
    """Loop the step over the frame axis.  X: [T, ..., F, M].
    Returns (final_state, Y [T, ..., F])."""
    ys = []
    for z in X:
        state, y = mvdr_step(cfg, steer, state, z)
        ys.append(y)
    return state, torch.stack(ys)


def mvdr_process(x, geometry: ArrayGeometry, look_angle_deg=(0.0, 0.0), cfg: MvdrConfig = MvdrConfig(), device=None) -> torch.Tensor:
    """Offline adaptive MVDR.  x: [..., M, S] -> [..., S] on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    X = analysis(x, cfg.stft)  # [..., M, T, F]
    Xt = torch.movedim(torch.movedim(X, -3, -1), -3, 0)  # [T, ..., F, M]
    steer = torch.as_tensor(steering_vector(geometry, angle_rad, cfg.stft.n_fft), dtype=Xt.dtype, device=dev)
    state = mvdr_init(cfg, geometry.n_mics, batch_shape=Xt.shape[1:-2], cdtype=Xt.dtype, device=dev)
    _, Y = mvdr_scan(cfg, steer, state, Xt)
    return synthesis(torch.movedim(Y, 0, -2), cfg.stft)
