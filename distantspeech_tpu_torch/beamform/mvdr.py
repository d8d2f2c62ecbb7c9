"""Online adaptive MVDR with MCRA-gated noise-covariance updates, and the
offline MVDR of a noise-only lead-in.

Counterpart of ``distantspeech_tpu/beamform/mvdr.py``: one frame is one
vectorised step over all bins (and any utterance batch); the offline entry point
loops the step over frames.  The carried solve is the M-vector
u = (Rvv + load I)^-1 a, not the inverse; the output is
w^H Z = (u^H Z) / conj(a^H u).  ``offline_mvdr_weights`` and
``adaptive_mvdr2_process`` estimate Rvv from the first frames with no VAD
and then freeze the weights.
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
from distantspeech_tpu_torch.ops.framing import frame_signal, overlap_add
from distantspeech_tpu_torch.stats.linalg import gauss_jordan_inv, ldl_solve
from distantspeech_tpu_torch.stats.psd import rank1_update
from distantspeech_tpu_torch.stats.weights import mvdr_weights
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


def offline_mvdr_weights(
    X: torch.Tensor, steer, n_est_frames: int = 200, alpha: float = 0.9, diag: float = 1e-6
) -> torch.Tensor:
    """Offline MVDR: recursive Rvv over the first ``n_est_frames`` frames,
    seeded with ones, then fixed weights.

    X: [..., T, F, M] spectrogram; steer: [F, M].  Returns w [..., F, M].
    """
    M = X.shape[-1]
    Rvv = torch.ones((*X.shape[:-3], X.shape[-2], M, M), dtype=X.dtype, device=X.device)
    for t in range(min(int(n_est_frames), X.shape[-3])):
        Rvv = rank1_update(Rvv, X[..., t, :, :], alpha)
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    a = torch.as_tensor(steer, device=X.device).to(X.dtype)
    return mvdr_weights(a, gauss_jordan_inv(Rvv + diag * eye))


def adaptive_mvdr2_process(
    x,
    steer,
    frame_len: int = 256,
    hop: int = 128,
    n_est_frames: int = 200,
    alpha: float = 0.9,
    diag: float = 1e-6,
    device=None,
) -> torch.Tensor:
    """Offline MVDR with frame-tracking weights during estimation.

    Rvv starts at ones; for each of the first ``n_est_frames`` frames the
    frame's rank-1 update is folded in and the MVDR weights recomputed
    before they are applied to that same frame; afterwards the weights
    freeze.  The output is the periodic-Hann window^2-normalised weighted
    overlap-add.

    Rvv is estimated from the raw mixture with no VAD: the estimation window
    must be (near) noise-only, or a coherent target inside it is absorbed
    into Rvv and cancelled.  ``mvdr_process`` is the MCRA-gated online
    variant.

    x: [M, S] time signal; steer: [F, M].  Returns y [out_len] on ``device``.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    M = x.shape[0]
    window = torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_len) / frame_len), dtype=x.dtype,
                             device=dev)
    Z = torch.fft.rfft(frame_signal(x, frame_len, hop) * window, dim=-1)  # [M, T, F]
    Z = torch.movedim(Z, 0, -1)  # [T, F, M]
    T, F = Z.shape[0], Z.shape[1]
    eye = torch.eye(M, dtype=Z.dtype, device=dev)
    a = torch.as_tensor(steer, device=dev).to(Z.dtype).expand(F, M)
    n_est = min(int(n_est_frames), T)

    # the weights track the frames only inside the estimation window; the
    # rest apply the frozen weights in one einsum
    Rvv = torch.ones((F, M, M), dtype=Z.dtype, device=dev)
    H = mvdr_weights(a, gauss_jordan_inv(Rvv + diag * eye))  # applied only if n_est == 0
    Y_est = []
    for z in Z[:n_est]:
        Rvv = rank1_update(Rvv, z, alpha)
        H = mvdr_weights(a, gauss_jordan_inv(Rvv + diag * eye))
        Y_est.append(torch.sum(torch.conj(H) * z, dim=-1))
    Y_rest = torch.einsum("fm,tfm->tf", torch.conj(H), Z[n_est:])
    Y = torch.cat([torch.stack(Y_est), Y_rest]) if Y_est else Y_rest

    # window^2-normalised overlap-add
    yout = overlap_add(torch.fft.irfft(Y, n=frame_len, dim=-1) * window, hop)
    norm = overlap_add((window**2).expand(T, frame_len), hop)
    return yout / torch.where(norm > 1e-10, norm, torch.ones_like(norm))


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
