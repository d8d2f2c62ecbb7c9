"""Multidelay block frequency-domain adaptive filter (MDF, Soo & Pang 1990).

Counterpart of ``distantspeech_tpu/adaptive/mdf.py``.  A partitioned FLMS:
the filter is split into ``num_block`` blocks of ``block_len`` taps; each
step shifts the newest input-block spectrum into a [..., B, Fb] matrix and
the filtered output is the block sum of X * W.  Optionally proportionate
(speex-style per-block step sizes, ``mdf_adjust_prop``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.ops.delay import delay_samples
from distantspeech_tpu_torch.ops.dft import irdft, rdft


@dataclasses.dataclass(frozen=True)
class MdfConfig:
    filter_len: int = 1024
    num_block: int = 1
    mu: float = 0.01
    alpha: float = 0.8
    constrain: bool = True
    prop: bool = False
    non_causal: bool = False

    @property
    def block_len(self) -> int:
        return self.filter_len // self.num_block

    @property
    def n_fft(self) -> int:
        return 2 * self.block_len

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1


class MdfState(NamedTuple):
    buf: torch.Tensor  # time input buffer [..., n_fft]
    X: torch.Tensor  # block spectra [..., B, Fb], newest block first
    W: torch.Tensor  # block filters [..., B, Fb]
    Pm: torch.Tensor  # per-block powers [..., B, Fb]
    P: torch.Tensor  # smoothed total power [..., Fb]
    d_delay: torch.Tensor  # non-causal carry [..., D]


def _complex(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def mdf_init(cfg: MdfConfig, batch_shape=(), dtype=torch.float32, device=None) -> MdfState:
    dev = resolve_device(device)
    B, Fb = cfg.num_block, cfg.half_bin
    zc = torch.zeros((*batch_shape, B, Fb), dtype=_complex(dtype), device=dev)
    D = cfg.filter_len // 2 if cfg.non_causal else 0
    return MdfState(
        buf=torch.zeros((*batch_shape, cfg.n_fft), dtype=dtype, device=dev),
        X=zc,
        W=zc,
        Pm=torch.zeros((*batch_shape, B, Fb), dtype=dtype, device=dev),
        P=torch.zeros((*batch_shape, Fb), dtype=dtype, device=dev),
        d_delay=torch.zeros((*batch_shape, D), dtype=dtype, device=dev),
    )


def mdf_adjust_prop(W: torch.Tensor) -> torch.Tensor:
    """Speex proportionate per-block step sizes.  W: [..., B, Fb] -> [..., B]."""
    prop = torch.sqrt(torch.sum(W.abs() ** 2, dim=-1))
    prop = prop + 0.1 * torch.clamp(prop, min=1e-6)
    return 0.99 * prop / (1e-6 + torch.sum(prop, dim=-1, keepdim=True))


def _constrain(grad: torch.Tensor, n_fft: int, L: int) -> torch.Tensor:
    """Zero the last L samples of the gradient's impulse response."""
    g1 = irdft(grad, n=n_fft)
    g1[..., -L:] = 0.0
    return rdft(g1, n=n_fft)


def mdf_step(
    cfg: MdfConfig,
    state: MdfState,
    x: torch.Tensor,
    d: torch.Tensor,
    update=True,
    p=1.0,
    fir_truncate: Optional[int] = None,
) -> Tuple[MdfState, Tuple[torch.Tensor, torch.Tensor]]:
    """One block of MDF.  x, d: [..., block_len].  Returns (state,
    (e [..., block_len], w [..., filter_len] concatenated block taps))."""
    L, n_fft = cfg.block_len, cfg.n_fft
    if fir_truncate is not None and cfg.num_block != 1:
        raise ValueError("fir_truncate only supported for num_block == 1 (bit-rotted in the reference otherwise)")

    buf = torch.cat([state.buf[..., L:], x], dim=-1)
    Xm = rdft(buf, n=n_fft)  # [..., Fb]
    X = torch.cat([Xm[..., None, :], state.X[..., :-1, :]], dim=-2)

    Pm = torch.cat([(Xm * Xm.conj()).real[..., None, :], state.Pm[..., :-1, :]], dim=-2)
    P = cfg.alpha * state.P + (1.0 - cfg.alpha) * torch.sum(Pm, dim=-2)

    y = irdft(torch.sum(X * state.W, dim=-2), n=n_fft)[..., -L:]

    d_delay = state.d_delay
    if cfg.non_causal:
        d_delay, d = delay_samples(state.d_delay, d)
    e = d - y

    E = rdft(torch.nn.functional.pad(e, (L, 0)), n=n_fft)
    grad = X.conj() * E[..., None, :] / (P + 1e-6)[..., None, :]
    if cfg.constrain:
        grad = _constrain(grad, n_fft, L)

    gate = torch.as_tensor(update, dtype=P.dtype, device=P.device)
    if cfg.prop:
        W = state.W + gate * mdf_adjust_prop(state.W)[..., :, None] * p * cfg.mu * grad
    else:
        W = state.W + gate * p * 2.0 * cfg.mu * grad

    # concatenated taps: block b occupies [b*L : (b+1)*L]
    w_blocks = irdft(W, n=n_fft)[..., :L]  # [..., B, L]
    w = w_blocks.reshape(*w_blocks.shape[:-2], -1)

    if fir_truncate is not None:
        w_shift = w.clone()
        w_shift[..., :fir_truncate] = 0.0
        w_shift[..., -fir_truncate:] = 0.0
        W = rdft(w_shift, n=n_fft)[..., None, :]

    return MdfState(buf=buf, X=X, W=W, Pm=Pm, P=P, d_delay=d_delay), (e, w)
