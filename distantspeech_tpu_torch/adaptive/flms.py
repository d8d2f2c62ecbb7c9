"""Fast frequency-domain block LMS (overlap-save), multichannel.

Counterpart of ``distantspeech_tpu/adaptive/flms.py``.  One step processes
one hop of samples, batched over channels and any leading axes, with the
same semantics:

- the power estimate P keeps the stored clamp ``P = max(P, 1e-4)``,
  applied at gradient time;
- the gradient constraint zeroes the last ``hop`` samples of the
  time-domain gradient;
- the non-causal mode delays d by filter_len / 2;
- the two-path mode's foreground output (blended on transfer) is what the
  caller receives and what drives the gradient;
- ``fir_truncate`` zeroes the first / last taps of w and re-derives W.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.ops.delay import delay_samples
from distantspeech_tpu_torch.ops.dft import irdft, rdft


@dataclasses.dataclass(frozen=True)
class FlmsConfig:
    filter_len: int = 128
    hop_len: Optional[int] = None
    win_len: Optional[int] = None
    n_channels: int = 1
    mu: float = 0.01
    alpha: float = 0.9  # power-estimate pole
    constrain: bool = True
    non_causal: bool = False
    two_path: bool = False

    @property
    def hop(self) -> int:
        return self.filter_len if self.hop_len is None else self.hop_len

    @property
    def win(self) -> int:
        return 2 * self.filter_len if self.win_len is None else self.win_len

    @property
    def n_fft(self) -> int:
        # smallest power of two > hop + filter_len - 1
        return 2 ** (int(np.log2(self.hop + self.filter_len - 1)) + 1)

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def overlap(self) -> int:
        return self.win - self.hop

    def window(self) -> np.ndarray:
        n = np.arange(self.n_fft)
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / self.n_fft)


class FlmsState(NamedTuple):
    buf: torch.Tensor  # input buffer [..., C, win]
    W: torch.Tensor  # filter spectrum [..., C, Fb] complex
    P: torch.Tensor  # power estimate  [..., Fb]
    foreground: torch.Tensor  # two-path foreground spectrum [..., C, Fb]
    d_delay: torch.Tensor  # non-causal delay carry [..., D]


def flms_init(cfg: FlmsConfig, batch_shape=(), dtype=torch.float32, device=None) -> FlmsState:
    dev = resolve_device(device)
    C = cfg.n_channels
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    W = torch.zeros((*batch_shape, C, cfg.half_bin), dtype=cdtype, device=dev)
    D = cfg.filter_len // 2 if cfg.non_causal else 0
    return FlmsState(
        buf=torch.zeros((*batch_shape, C, cfg.win), dtype=dtype, device=dev),
        W=W,
        P=torch.zeros((*batch_shape, cfg.half_bin), dtype=dtype, device=dev),
        foreground=W,
        d_delay=torch.zeros((*batch_shape, D), dtype=dtype, device=dev),
    )


def flms_set_weights(cfg: FlmsConfig, state: FlmsState, w: torch.Tensor) -> FlmsState:
    """Replace the (single-channel) filter with time-domain taps w [..., L]."""
    W = rdft(w, n=cfg.n_fft)
    return state._replace(W=W[..., None, :] if W.ndim == state.W.ndim - 1 else W)


def flms_step(
    cfg: FlmsConfig,
    state: FlmsState,
    x: torch.Tensor,
    d: torch.Tensor,
    update=True,
    p=1.0,
    fir_truncate: Optional[int] = None,
) -> Tuple[FlmsState, Tuple[torch.Tensor, torch.Tensor]]:
    """One hop of overlap-save FLMS.

    x: [..., C, hop] input block; d: [..., hop] desired block.  ``update`` is
    a bool or a tensor (weight freeze gate); ``p`` the stepsize gate (scalar
    or per-bin [..., Fb], broadcast against [..., C, Fb]).
    Returns (new_state, (e [..., hop], w [..., C, filter_len]))."""
    hop, L, n_fft = cfg.hop, cfg.filter_len, cfg.n_fft

    buf = torch.cat([state.buf[..., hop:], x], dim=-1)  # [..., C, win]
    X = rdft(buf, n=n_fft)  # [..., C, Fb]
    P = cfg.alpha * state.P + (1.0 - cfg.alpha) * torch.sum((X * X.conj()).real, dim=-2)

    y = irdft(torch.sum(X * state.W, dim=-2), n=n_fft)[..., -hop:]

    d_delay = state.d_delay
    if cfg.non_causal:
        d_delay, d = delay_samples(state.d_delay, d)

    e = d - y
    foreground = state.foreground
    if cfg.two_path:
        if hop != L or cfg.overlap != L:
            raise ValueError("two_path requires default hop == filter_len layout")
        y_f = torch.sum(irdft(X * state.foreground, n=n_fft)[..., -L:], dim=-2)
        e_f = d - y_f
        # transfer logic: is the background 3 dB better?
        ratio = torch.sum(e_f.abs(), dim=-1) / (torch.sum(e.abs(), dim=-1) + 1e-6)
        transfer = 10.0 * torch.log10(ratio + 1e-6) > 3.0
        win = torch.as_tensor(cfg.window(), dtype=y.dtype, device=y.device)
        y_blend = win[L:] * y_f + win[:L] * y
        y_out = torch.where(transfer[..., None], y_blend, y_f)
        foreground = torch.where(transfer[..., None, None], state.W, state.foreground)
        e = d - y_out

    # gradient: E = rfft([zeros(overlap); e])
    E = rdft(torch.nn.functional.pad(e, (cfg.overlap, 0)), n=n_fft)  # [..., Fb]
    P = torch.clamp(P, min=1e-4)  # stored clamp
    grad = X.conj() * E[..., None, :] / P[..., None, :]

    if cfg.constrain:
        g1 = irdft(grad, n=n_fft)
        g1[..., -hop:] = 0.0
        grad = rdft(g1, n=n_fft)

    gate = torch.as_tensor(update, dtype=P.dtype, device=P.device)
    W = state.W + gate * p * 2.0 * cfg.mu * grad

    w = irdft(W, n=n_fft)[..., :L]
    if fir_truncate is not None:
        w_shift = w.clone()
        w_shift[..., :fir_truncate] = 0.0
        w_shift[..., L - fir_truncate :] = 0.0
        W = rdft(w_shift, n=n_fft)

    return FlmsState(buf=buf, W=W, P=P, foreground=foreground, d_delay=d_delay), (e, w)
