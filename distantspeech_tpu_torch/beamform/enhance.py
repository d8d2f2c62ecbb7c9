"""Flagship enhancement pipeline: adaptive MVDR + OM-LSA postfilter.

Counterpart of ``distantspeech_tpu/beamform/enhance.py``: the MCRA-gated
adaptive MVDR beamformer followed by the decision-directed OM-LSA gain
``G = clip(G_H1^p gmin^(1-p), gmin, 1)`` on its output, driven by the
MVDR's own MCRA track.  ``enhance_step`` is one frame over all bins and any
utterance batch; ``enhance_scan`` loops it over frames;
``enhance_scan_pallas`` splits the same math into an MCRA pre-scan and the
K1 kernel; ``enhance_process`` picks the backend.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import check_unroll, resolve_device
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig, MvdrState, mvdr_init, mvdr_step
from distantspeech_tpu_torch.noise.mcra import mcra_run
from distantspeech_tpu_torch.ops.cuda_enhance import fused_enhance, fused_enhance_full
from distantspeech_tpu_torch.ops.cuda_mvdr import fused_mvdr_scan
from distantspeech_tpu_torch.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class EnhanceConfig:
    # speech-scale minima window, the raw-indicator covariance guard and the
    # float32 conditioning guard: the flagship defaults
    mvdr: MvdrConfig = MvdrConfig(mcra_L=65, vad_guard=True, rel_diag=1e-5)
    alpha_xi: float = 0.92  # decision-directed pole
    gmin: float = 0.0631  # -24 dB gain floor

    @property
    def stft(self) -> StftConfig:
        return self.mvdr.stft


class EnhanceState(NamedTuple):
    mvdr: MvdrState
    G_H1: torch.Tensor  # [..., F]
    gamma: torch.Tensor  # [..., F]


def enhance_init(cfg: EnhanceConfig, n_mics: int, batch_shape=(), cdtype=torch.complex64, device=None) -> EnhanceState:
    mv = mvdr_init(cfg.mvdr, n_mics, batch_shape, cdtype=cdtype, device=device)
    ones = torch.ones((*batch_shape, cfg.stft.half_bin), dtype=mv.u.real.dtype, device=mv.u.device)
    return EnhanceState(mvdr=mv, G_H1=ones, gamma=ones)


def enhance_step(cfg: EnhanceConfig, steer: torch.Tensor, state: EnhanceState, Z: torch.Tensor) -> Tuple[EnhanceState, torch.Tensor]:
    """One frame: MVDR beamform + OM-LSA gain.  Z: [..., F, M] -> Y [..., F]."""
    mvdr_state, Yf = mvdr_step(cfg.mvdr, steer, state.mvdr, Z)
    lam = torch.clamp(mvdr_state.mcra.lambda_d, min=1e-10)
    p = mvdr_state.mcra.p
    gamma = Yf.abs() ** 2 / lam
    xi = cfg.alpha_xi * state.G_H1**2 * state.gamma + (1.0 - cfg.alpha_xi) * torch.clamp(gamma - 1.0, min=0.0)
    G_H1 = xi / (1.0 + xi)
    G = torch.clamp(G_H1**p * cfg.gmin ** (1.0 - p), cfg.gmin, 1.0)
    return EnhanceState(mvdr=mvdr_state, G_H1=G_H1, gamma=gamma), Yf * G


def enhance_scan(cfg: EnhanceConfig, steer: torch.Tensor, state: EnhanceState, Zt: torch.Tensor, unroll: int = 8):
    """Loop ``enhance_step`` over frames.  Zt: [T, ..., F, M].
    Returns (final_state, Y [T, ..., F]).  ``unroll`` is JAX's scan hint,
    inert here (``_device.check_unroll``)."""
    check_unroll(unroll)
    ys = []
    for z in Zt:
        state, y = enhance_step(cfg, steer, state, z)
        ys.append(y)
    return state, torch.stack(ys)


def enhance_scan_pallas(cfg: EnhanceConfig, steer: torch.Tensor, Zt: torch.Tensor, interpret: bool = False) -> torch.Tensor:
    """``enhance_scan`` as two passes: MCRA over the frames of the mic-0
    power (plain PyTorch), then the gated MVDR and the OM-LSA gain in the
    K1 kernel (``ops.cuda_mvdr.fused_mvdr_scan``; its plain version on a
    CPU tensor).  The covariance gate is ``p < p_vad``, and with
    ``vad_guard`` also ``S / Smin <= delta_s``.

    Zt: [T, B, F, M] (exactly 4-D).  Returns Y [T, B, F].  ``interpret``
    is the JAX package's Pallas interpret flag, unused: the tensor's device
    picks the kernel or its plain version."""
    if Zt.ndim != 4:
        raise ValueError(
            f"enhance_scan_pallas needs Zt of shape [T, B, F, M] (4-D), got {tuple(Zt.shape)}; "
            "add a size-1 batch axis for single utterances, or use backend='scan'"
        )
    mv = cfg.mvdr
    lam, p, sr = mcra_run(mv.mcra, Zt[..., 0].abs() ** 2, return_sr=True)  # [T, B, F]
    gate = p < mv.p_vad
    if mv.vad_guard:
        gate = gate & (sr <= mv.mcra.delta_s)
    return fused_mvdr_scan(
        Zt, gate.to(p.dtype), steer, alpha_v=mv.alpha_v, diag=mv.diag, rel_diag=mv.rel_diag,
        p=p, lam=lam, alpha_xi=cfg.alpha_xi, gmin=cfg.gmin,
    )


def enhance_process(
    x,
    geometry: ArrayGeometry,
    look_angle_deg=(90.0, 0.0),
    cfg: EnhanceConfig = EnhanceConfig(),
    backend: str = "scan",
    inv_mode: str = "ldl",
    device=None,
    t_chunk: int = None,
) -> torch.Tensor:
    """Offline MVDR + OM-LSA of a time-domain batch.  x: [..., M, S] -> [..., S].

    backend: 'scan' (the per-frame step loop, any batch shape), 'pallas'
    (``enhance_scan_pallas``: an MCRA pre-scan, then the K1 CUDA kernel for
    the gated MVDR and OM-LSA; x [B, M, S]), 'fused' (analysis and synthesis
    as matrix products around one CUDA kernel that runs MCRA, the gated
    MVDR and OM-LSA; x [B, M, S]) or 'mega' (the whole pipeline in one CUDA
    kernel, waveform in and out; x [B, M, S]).  On a CPU tensor 'pallas',
    'fused' and 'mega' run the kernels' plain PyTorch version.

    inv_mode ('fused' / 'mega' only; 'pallas' ignores it, as the JAX
    package does, and always solves by LDL^H): 'ldl' refactors the loaded noise
    covariance every frame; 'rank1' switches to Bennett rank-1 LDL^H factor
    updates after a 64-frame exact warmup (see
    ``ops.cuda_mvdr._mvdr_update_rank1``).  ``t_chunk`` sets the warmup
    length and the re-anchor cadence of 'rank1' (default: the largest
    divisor of T that is <= 64, else 64)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    steer_np = steering_vector(geometry, angle_rad, cfg.stft.n_fft)
    if backend in ("fused", "mega"):
        run = fused_enhance_full if backend == "mega" else fused_enhance
        return run(x, steer_np, cfg, t_chunk=t_chunk, inv_mode=inv_mode)
    if backend not in ("scan", "pallas"):
        raise ValueError(f"backend must be 'scan', 'pallas', 'fused' or 'mega', got {backend!r}")
    if backend == "pallas" and x.ndim != 3:
        raise ValueError(f"backend='pallas' needs x of shape [B, M, S], got {tuple(x.shape)}")

    X = analysis(x, cfg.stft)  # [..., M, T, F]
    Zt = torch.movedim(torch.movedim(X, -3, -1), -3, 0)  # [T, ..., F, M]
    steer = torch.as_tensor(steer_np, dtype=Zt.dtype, device=dev)
    if backend == "pallas":
        Y = enhance_scan_pallas(cfg, steer, Zt)
    else:
        state = enhance_init(cfg, geometry.n_mics, batch_shape=Zt.shape[1:-2], cdtype=Zt.dtype, device=dev)
        _, Y = enhance_scan(cfg, steer, state, Zt)
    return synthesis(torch.movedim(Y, 0, -2), cfg.stft)
