"""Complex subband adaptive filters: per-bin NLMS (1ch / multichannel) and RLS.

Counterpart of ``distantspeech_tpu/adaptive/subband.py``.  Each runs one
frame of subband coefficients at a time with a per-bin tap delay line; every
per-bin quantity batches over ``[..., F]``.  Frequency-domain inputs only:
compose with ``distantspeech_tpu_torch.transform`` for a time-domain signal.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.stats.linalg import matvec, vecmat


@dataclasses.dataclass(frozen=True)
class SubbandAfConfig:
    num_bands: int = 512  # n_fft of the analysis transform
    filter_len: int = 2  # taps per bin
    n_channels: int = 1
    mu: float = 0.1
    alpha: float = 0.9  # power-estimate pole
    normalize: bool = True
    forgetting_factor: float = 0.998  # RLS lambda

    @property
    def half_bin(self) -> int:
        return self.num_bands // 2 + 1


class SubbandLmsState(NamedTuple):
    W: torch.Tensor  # [..., F, N] (or [..., F, N, C] multichannel)
    buf: torch.Tensor  # tap delay line, same shape as W
    P: torch.Tensor  # [..., F] power estimate


def subband_lms_init(cfg: SubbandAfConfig, batch_shape=(), cdtype=torch.complex64, device=None) -> SubbandLmsState:
    dev = resolve_device(device)
    F, N, C = cfg.half_bin, cfg.filter_len, cfg.n_channels
    shape = (*batch_shape, F, N) if C == 1 else (*batch_shape, F, N, C)
    z = torch.zeros(shape, dtype=cdtype, device=dev)
    return SubbandLmsState(W=z, buf=z, P=torch.zeros((*batch_shape, F), dtype=cdtype.to_real(), device=dev))


def subband_lms_step(
    cfg: SubbandAfConfig, state: SubbandLmsState, x: torch.Tensor, d: torch.Tensor,
    eps: float = 1e-4, p: Optional[torch.Tensor] = None,
) -> Tuple[SubbandLmsState, torch.Tensor]:
    """One frame of single-channel subband NLMS.  x, d: [..., F] complex.
    ``p`` gates both the output (err = d - y p) and the weight update.
    Returns (new_state, err [..., F])."""
    buf = torch.cat([x[..., None], state.buf[..., :-1]], dim=-1)
    y = torch.sum(torch.conj(state.W) * buf, dim=-1)
    pv = torch.ones_like(d.real) if p is None else p
    err = d - y * pv
    if cfg.normalize:
        P = cfg.alpha * state.P + (1.0 - cfg.alpha) * torch.sum((torch.conj(buf) * buf).real, dim=-1)
        grad = buf * torch.conj(err)[..., None] / (P + eps)[..., None]
    else:
        P = state.P
        grad = buf * torch.conj(err)[..., None]
    W = state.W + 2.0 * cfg.mu * grad * pv[..., None]
    return SubbandLmsState(W=W, buf=buf, P=P), err


def subband_lms_mc_step(
    cfg: SubbandAfConfig, state: SubbandLmsState, x: torch.Tensor, d: torch.Tensor,
    eps: float = 1e-4, p: Optional[torch.Tensor] = None,
) -> Tuple[SubbandLmsState, torch.Tensor]:
    """One frame of multichannel subband NLMS (the GSC canceller).
    x: [..., F, C]; d: [..., F].  The power normalisation averages over
    channels.  Returns (new_state, err [..., F])."""
    buf = torch.cat([x[..., None, :], state.buf[..., :-1, :]], dim=-2)  # [..., F, N, C]
    y = torch.sum(torch.conj(state.W) * buf, dim=(-2, -1))
    pv = torch.ones_like(d.real) if p is None else p
    err = d - y * pv
    if cfg.normalize:
        P = cfg.alpha * state.P + (1.0 - cfg.alpha) * torch.sum((torch.conj(buf) * buf).real, dim=(-2, -1)) / cfg.n_channels
        grad = buf * torch.conj(err)[..., None, None] / (P + eps)[..., None, None]
    else:
        P = state.P
        grad = buf * torch.conj(err)[..., None, None]
    W = state.W + 2.0 * cfg.mu * grad * pv[..., None, None]
    return SubbandLmsState(W=W, buf=buf, P=P), err


class SubbandRlsState(NamedTuple):
    W: torch.Tensor  # [..., F, N]
    buf: torch.Tensor  # [..., F, N]
    P: torch.Tensor  # inverse correlation [..., F, N, N]


def subband_rls_init(cfg: SubbandAfConfig, batch_shape=(), cdtype=torch.complex64, delta: float = 1e-3,
                     device=None) -> SubbandRlsState:
    dev = resolve_device(device)
    F, N = cfg.half_bin, cfg.filter_len
    z = torch.zeros((*batch_shape, F, N), dtype=cdtype, device=dev)
    P = (torch.eye(N, dtype=cdtype, device=dev) / delta).expand(*batch_shape, F, N, N).clone()
    return SubbandRlsState(W=z, buf=z, P=P)


def subband_rls_step(
    cfg: SubbandAfConfig, state: SubbandRlsState, x: torch.Tensor, d: torch.Tensor, mu: float = 0.5
) -> Tuple[SubbandRlsState, torch.Tensor]:
    """One frame of per-bin RLS.  x, d: [..., F] complex.
    Returns (new_state, err [..., F])."""
    lam = cfg.forgetting_factor
    buf = torch.cat([x[..., None], state.buf[..., :-1]], dim=-1)
    err = d - torch.sum(torch.conj(state.W) * buf, dim=-1)
    num = matvec(state.P, buf)  # P u
    den = lam + torch.sum(torch.conj(buf) * num, dim=-1)
    kn = num / den[..., None]
    # P <- (P - kn u^H P) / lam
    uhP = vecmat(torch.conj(buf), state.P)
    P = (state.P - kn[..., :, None] * uhP[..., None, :]) / lam
    W = state.W + 2.0 * mu * torch.conj(err)[..., None] * kn
    return SubbandRlsState(W=W, buf=buf, P=P), err
