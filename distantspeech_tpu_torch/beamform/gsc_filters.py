"""GSC-specific FLMS variants: the CCAF-clamped blocking-matrix filter and
the norm-constrained interference canceller.

Counterpart of ``distantspeech_tpu/beamform/gsc_filters.py``.  Both share
the FLMS forward and gradient path (``_forward``) but replace the weight
update:

- no 2x on the step size (W += p mu grad, unlike ``flms_step``);
- BM: the constraint is a time-domain coefficient clamp around the centre
  tap (Hoshuyama CCAF bounds: +-1e-3 away from the n_fft/4 peak,
  ``bm_bounds``) plus zeroing the last hop taps;
- AIC: an optional filter-norm ceiling (``maxnorm`` 0.003) folded into the
  constraint projection.

Both reuse ``FlmsState``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch.adaptive.flms import FlmsConfig, FlmsState
from distantspeech_tpu_torch.ops.delay import delay_samples
from distantspeech_tpu_torch.ops.dft import irdft, rdft


def bm_bounds(n_fft: int, deltax: float = 0.001) -> np.ndarray:
    """Per-tap upper bounds of the BM CCAF clamp, [n_fft // 2]; the lower
    bound is ``-deltax`` everywhere."""
    ub = np.full(n_fft // 2, deltax)
    q = n_fft // 4
    ub[q] = 0.9
    ub[q + 1] = 0.3
    ub[q - 1] = 0.3
    ub[q + 2] = 0.05
    ub[q - 2] = 0.05
    return ub


def _forward(cfg: FlmsConfig, state: FlmsState, x, d):
    """The shared FLMS forward pass and gradient."""
    hop, n_fft = cfg.hop, cfg.n_fft
    buf = torch.cat([state.buf[..., hop:], x], dim=-1)
    X = rdft(buf, n=n_fft)
    P = cfg.alpha * state.P + (1.0 - cfg.alpha) * torch.sum((X * X.conj()).real, dim=-2)
    y = irdft(torch.sum(X * state.W, dim=-2), n=n_fft)[..., -hop:]

    d_delay = state.d_delay
    if cfg.non_causal:
        d_delay, d = delay_samples(state.d_delay, d)
    e = d - y

    E = rdft(torch.nn.functional.pad(e, (cfg.overlap, 0)), n=n_fft)
    P = torch.clamp(P, min=1e-4)
    grad = X.conj() * E[..., None, :] / P[..., None, :]
    return buf, P, e, grad, d_delay


def bm_step(
    cfg: FlmsConfig, state: FlmsState, x: torch.Tensor, d: torch.Tensor, update=True, p=1.0,
) -> Tuple[FlmsState, Tuple[torch.Tensor, torch.Tensor]]:
    """One hop of the adaptive blocking-matrix filter.  x: [..., 1, hop] (the
    fixed-beamformer output); d: [..., hop] (the mic signal).  Returns
    (state, (e [..., hop], w [..., 1, filter_len]))."""
    buf, P, e, grad, d_delay = _forward(cfg, state, x, d)

    gate = torch.as_tensor(update, dtype=P.dtype, device=P.device)
    W = state.W + gate * p * cfg.mu * grad

    if cfg.constrain:
        w_full = irdft(W, n=cfg.n_fft)
        w_full[..., -cfg.hop :] = 0.0
        nb = cfg.n_fft // 2
        ub = torch.as_tensor(bm_bounds(cfg.n_fft), dtype=w_full.dtype, device=w_full.device)
        clamped = torch.minimum(torch.clamp(w_full[..., :nb], min=-0.001), ub)
        W = rdft(torch.cat([clamped, w_full[..., nb:]], dim=-1), n=cfg.n_fft)

    w = irdft(W, n=cfg.n_fft)[..., : cfg.filter_len]
    return FlmsState(buf=buf, W=W, P=P, foreground=state.foreground, d_delay=d_delay), (e, w)


def aic_step(
    cfg: FlmsConfig, state: FlmsState, x: torch.Tensor, d: torch.Tensor,
    update=True, p=1.0, weight_norm: bool = True, maxnorm: float = 0.003,
    fir_truncate: Optional[int] = None,
) -> Tuple[FlmsState, Tuple[torch.Tensor, torch.Tensor]]:
    """One hop of the norm-constrained interference canceller.  x: [..., C,
    hop] blocking-matrix outputs; d: [..., hop] delayed FBF.  Returns
    (state, (e [..., hop], w [..., C, filter_len]))."""
    buf, P, e, grad, d_delay = _forward(cfg, state, x, d)

    gate = torch.as_tensor(update, dtype=P.dtype, device=P.device)
    W = state.W + gate * p * cfg.mu * grad

    if weight_norm:
        norm = torch.sum(W.abs() ** 2, dim=(-2, -1)) / cfg.n_fft / cfg.n_fft
        scale = torch.where(norm > maxnorm, torch.sqrt(maxnorm / norm), torch.ones_like(norm))
    else:
        scale = torch.ones(W.shape[:-2], dtype=P.dtype, device=P.device)

    if cfg.constrain:
        w_full = irdft(W, n=cfg.n_fft) * scale[..., None, None]
        w_full[..., -cfg.hop :] = 0.0
        W = rdft(w_full, n=cfg.n_fft)

    w = irdft(W, n=cfg.n_fft)[..., : cfg.filter_len]
    if fir_truncate is not None:
        w_shift = w.clone()
        w_shift[..., :fir_truncate] = 0.0
        w_shift[..., -fir_truncate:] = 0.0
        W = rdft(w_shift * scale[..., None, None], n=cfg.n_fft)

    return FlmsState(buf=buf, W=W, P=P, foreground=state.foreground, d_delay=d_delay), (e, w)
