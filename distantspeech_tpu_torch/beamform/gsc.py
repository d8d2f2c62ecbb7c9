"""Frequency-domain recursive GSC with an MC-MCRA-gated NLMS canceller.

Counterpart of ``distantspeech_tpu/beamform/gsc.py``: the steering-based
fixed beamformer W = a/(a^H a), the pairwise steering blocking matrix
U_i = a_0* Z_0 - a_{i+1}* Z_{i+1}, a per-bin LMS interference canceller G
gated by (1 - p_spp), and the multiplicative MC-MCRA OM-LSA postfilter
gain.  One frame is one [F]-vectorised step; the offline entry point loops
it over frames (``unroll``, JAX's numerically inert scan hint, is accepted
and unused).

``gsc_process_time`` is the time-domain variant: DC notch, fractional-delay
alignment, mean fixed beamformer, adjacent-difference blocking matrix and a
causal full-rate FLMS canceller.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import check_unroll, resolve_device
from distantspeech_tpu_torch.adaptive.feature import dc_notch, dc_notch_init
from distantspeech_tpu_torch.adaptive.flms import FlmsConfig, flms_init, flms_step
from distantspeech_tpu_torch.array.alignment import time_alignment_filters
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import omega_bins
from distantspeech_tpu_torch.noise.mc_mcra import McMcraConfig, McMcraState, mc_mcra_init, mc_mcra_step
from distantspeech_tpu_torch.ops.fir import fir_filter_offline
from distantspeech_tpu_torch.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class GscConfig:
    n_mics: int = 4
    frame_len: int = 256
    mu: float = 0.01  # canceller stepsize
    normalize_aic: bool = False  # power-normalise the canceller gradient.
    # The reference runs UNNORMALISED LMS (Pest = 1), which diverges on loud
    # broadband input, sooner in complex64.  True enables the reference's own
    # commented-out recursion Pest = rho*Pest + (1-rho)*sum|Z|^2; False
    # matches it exactly.
    rho_pest: float = 0.9
    spp_rel_diag: float = 0.0  # relative diagonal loading for the MC-MCRA
    # Phi_vv inverse (see McMcraConfig.rel_diag), needed for complex64 on
    # near-coherent input; 0 matches the reference.

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.frame_len, self.frame_len // 2)

    @property
    def half_bin(self) -> int:
        return self.frame_len // 2 + 1

    @property
    def mc_mcra(self) -> McMcraConfig:
        return McMcraConfig(nfft=self.frame_len, n_channels=self.n_mics, rel_diag=self.spp_rel_diag)


def gsc_steering(cfg: GscConfig, geometry: ArrayGeometry, angle_rad) -> np.ndarray:
    """Propagation vector a [F, M] from the circular-array delay model
    ``tao = -r cos(el) cos(az - gamma_m) / c``."""
    angle = np.asarray(angle_rad, dtype=np.float64)
    gamma = (np.arange(0, 360, int(360 / cfg.n_mics)) * np.pi / 180.0)[: cfg.n_mics]
    # r is the scalar radius of the (circular) array
    r = float(np.max(np.linalg.norm(geometry.mic_loc[:, :2], axis=-1)))
    tao = -1.0 * r * np.cos(angle[1]) * np.cos(angle[0] - gamma) / geometry.c  # [M]
    omega = omega_bins(cfg.frame_len, geometry.fs)  # [F]
    return np.exp(-1j * omega[:, None] * tao[None, :])  # [F, M]


class GscState(NamedTuple):
    G: torch.Tensor  # canceller weights [..., F, M-1]
    Pest: torch.Tensor  # gradient-normalisation power [..., F] (ones when off)
    spp: McMcraState


def gsc_init(cfg: GscConfig, batch_shape=(), cdtype=torch.complex64, device=None) -> GscState:
    dev = resolve_device(device)
    rdtype = cdtype.to_real()
    return GscState(
        G=torch.zeros((*batch_shape, cfg.half_bin, cfg.n_mics - 1), dtype=cdtype, device=dev),
        Pest=torch.ones((*batch_shape, cfg.half_bin), dtype=rdtype, device=dev),
        spp=mc_mcra_init(cfg.mc_mcra, batch_shape, dtype=rdtype, device=dev),
    )


def gsc_step(cfg: GscConfig, a: torch.Tensor, state: GscState, Z: torch.Tensor) -> Tuple[GscState, torch.Tensor]:
    """One frame.  a: [F, M] propagation vector; Z: [..., F, M] spectra.
    Returns (state, Y [..., F] postfiltered output)."""
    spp_state, spp_out = mc_mcra_step(cfg.mc_mcra, state.spp, Z)

    W = a / torch.sum(a.abs() ** 2, dim=-1, keepdim=True)  # a/(a^H a)
    Yfbf = torch.sum(torch.conj(W) * Z, dim=-1)
    U = torch.conj(a[:, :1]) * Z[..., :1] - torch.conj(a[:, 1:]) * Z[..., 1:]  # blocking matrix [..., F, M-1]

    Y = Yfbf - torch.sum(torch.conj(state.G) * U, dim=-1)
    if cfg.normalize_aic:
        power = torch.sum((Z * torch.conj(Z)).real, dim=-1)
        Pest = cfg.rho_pest * state.Pest + (1.0 - cfg.rho_pest) * power
        Pest = torch.clamp(Pest, min=1e-10)
    else:
        Pest = state.Pest  # stays 1
    G = state.G + (cfg.mu * (1.0 - spp_out.p) / Pest)[..., None] * U * torch.conj(Y)[..., None]

    Y_out = Y * spp_out.G  # OM-LSA postfilter gain
    return GscState(G=G, Pest=Pest, spp=spp_state), Y_out


def gsc_process(
    x, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg: GscConfig = GscConfig(),
    unroll: int = 1, device=None,
) -> torch.Tensor:
    """Offline GSC of a time-domain batch.  x: [..., M, S] -> [..., S] on
    ``device``."""
    check_unroll(unroll)
    x = torch.as_tensor(x, device=resolve_device(device))
    X = analysis(x, cfg.stft)  # [..., M, T, F]
    Zt = torch.movedim(torch.movedim(X, -3, -1), -3, 0)  # [T, ..., F, M]
    a = torch.as_tensor(gsc_steering(cfg, geometry, angle_rad), device=x.device).to(Zt.dtype)
    state = gsc_init(cfg, batch_shape=Zt.shape[1:-2], cdtype=Zt.dtype, device=x.device)
    Y = []
    for z in Zt:
        state, y = gsc_step(cfg, a, state, z)
        Y.append(y)
    return synthesis(torch.stack(Y, dim=-2), cfg.stft)


def gsc_process_time(
    x,
    geometry: ArrayGeometry,
    angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    frame_len: int = 256,
    fir_truncate: int = 30,
    device=None,
) -> torch.Tensor:
    """Time-domain GSC path: DC-notch each mic, fractional-delay time
    alignment, mean fixed beamformer, adjacent-difference blocking matrix,
    causal FLMS interference canceller at full adaptation rate (no SPP
    gating, unlike the TDGSC, whose canceller steps by 1 - p and runs
    non-causal).

    x: [..., M, S] -> [..., S'] on ``device``, S' = frame_len * (S // frame_len).
    """
    x = torch.as_tensor(x, device=resolve_device(device))
    L = frame_len
    M = x.shape[-2]
    _, xn = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype, device=x.device), x, radius=0.98)
    coeffs = torch.as_tensor(time_alignment_filters(geometry, angle_rad), dtype=x.dtype, device=x.device)
    aligned = fir_filter_offline(xn, coeffs)  # [..., M, S]
    fbf = torch.mean(aligned, dim=-2)  # [..., S]
    bm = aligned[..., :-1, :] - aligned[..., 1:, :]  # [..., M-1, S]

    T = x.shape[-1] // L
    aic = FlmsConfig(filter_len=L, n_channels=M - 1)  # causal, defaults
    state = flms_init(aic, batch_shape=x.shape[:-2], dtype=x.dtype, device=x.device)
    out = []
    for t in range(T):
        blk = slice(t * L, (t + 1) * L)
        state, (e, _) = flms_step(aic, state, bm[..., blk], fbf[..., blk], fir_truncate=fir_truncate)
        out.append(e)
    return torch.cat(out, dim=-1)
