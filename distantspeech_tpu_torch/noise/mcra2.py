"""MCRA2 noise estimation (Rangachari & Loizou 2006), vectorised over bins.

Counterpart of ``distantspeech_tpu/noise/mcra2.py``.  Unlike classic MCRA,
minima are tracked continuously (no L-window reset) and p starts at 1 on
the first frame.  The reference's quirks are kept:

- its bin loop runs k = 0 .. F-2, and the frequency smoothing at k = 0
  reads the last bin (numpy wrap-around);
- the minima rule reads the already-updated S (an alias in the
  reference), so the increment term is ``(1-gamma) * S_new``;
- p is clipped to [0, 1], and the last bin's noise PSD is pinned to 1e-8
  before the noise update over all bins.

The frame counter ``frm_cnt`` is a host integer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mcra2Config:
    nfft: int = 256
    alpha_s: float = 0.8
    alpha_d: float = 0.95
    alpha_p: float = 0.2
    delta_s: float = 5.0
    gamma: float = 0.998  # minima-tracking pole
    beta: float = 0.8  # minima-tracking lookback
    b: Tuple[float, float, float] = (0.25, 0.5, 0.25)

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1


class Mcra2State(NamedTuple):
    S: torch.Tensor  # smoothed PSD      [..., F]
    Smin: torch.Tensor  # tracked minimum [..., F]
    p: torch.Tensor  # speech presence    [..., F]
    lambda_d: torch.Tensor  # noise PSD   [..., F]
    frm_cnt: int


def mcra2_init(cfg: Mcra2Config, batch_shape=(), dtype=torch.float32, device=None) -> Mcra2State:
    z = torch.zeros((*batch_shape, cfg.half_bin), dtype=dtype, device=resolve_device(device))
    return Mcra2State(S=z, Smin=z, p=z, lambda_d=z, frm_cnt=0)


def mcra2_step(cfg: Mcra2Config, state: Mcra2State, Y: torch.Tensor) -> Tuple[Mcra2State, Tuple[torch.Tensor, torch.Tensor]]:
    """One MCRA2 frame.  Y: [..., F] noisy power spectrum."""
    F = cfg.half_bin
    lead = torch.arange(F, device=Y.device) <= F - 2  # bins the reference's loop touches

    # frequency smoothing, k = 0 wrapping to the last bin
    left = torch.roll(Y, 1, dims=-1)
    right = torch.cat([Y[..., 1:], Y[..., -1:]], dim=-1)  # k+1; k=F-2 reads Y[F-1]
    Sf = cfg.b[0] * left + cfg.b[1] * Y + cfg.b[2] * right

    if state.frm_cnt == 0:
        # first frame: seed Smin / lambda_d / p on the lead bins, leave S at zero
        S_out = state.S
        Smin_out = torch.where(lead, Y, state.Smin)
        p_out = torch.where(lead, torch.ones_like(Y), state.p)
        lam_pre = torch.where(lead, Y, state.lambda_d)
    else:
        S_new = cfg.alpha_s * state.S + (1.0 - cfg.alpha_s) * Sf
        Smin_track = cfg.gamma * state.Smin + (1.0 - cfg.gamma) * S_new  # the alias quirk
        Smin_new = torch.where(state.Smin < S_new, Smin_track, S_new)
        I = (S_new / (Smin_new + 1e-6) > cfg.delta_s).to(Y.dtype)
        p_new = torch.clamp(cfg.alpha_p * state.p + (1.0 - cfg.alpha_p) * I, 0.0, 1.0)
        S_out = torch.where(lead, S_new, state.S)
        Smin_out = torch.where(lead, Smin_new, state.Smin)
        p_out = torch.where(lead, p_new, state.p)
        lam_pre = state.lambda_d

    lam_pre = lam_pre.clone()
    lam_pre[..., F - 1] = 1e-8
    alpha_tilde = cfg.alpha_d + (1.0 - cfg.alpha_d) * p_out
    lam_out = alpha_tilde * lam_pre + (1.0 - alpha_tilde) * Y

    new_state = Mcra2State(S=S_out, Smin=Smin_out, p=p_out, lambda_d=lam_out, frm_cnt=state.frm_cnt + 1)
    return new_state, (lam_out, p_out)


def mcra2_run(cfg: Mcra2Config, Y_tf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop MCRA2 over a [T, ..., F] power spectrogram -> (lambda_d, p)."""
    state = mcra2_init(cfg, batch_shape=Y_tf.shape[1:-1], dtype=Y_tf.dtype, device=Y_tf.device)
    lams, ps = [], []
    for y in Y_tf:
        state, (lam, p) = mcra2_step(cfg, state, y)
        lams.append(lam)
        ps.append(p)
    return torch.stack(lams), torch.stack(ps)
