"""MCRA noise estimation (Cohen & Berdugo 2002), vectorised over bins.

Counterpart of ``distantspeech_tpu/noise/mcra.py``, with the same bin-edge
semantics:

- only bins 0 .. F-2 are touched by the estimator; bin F-1 keeps p at its
  clipped floor and its noise PSD is pinned to 1e-8 before each update;
- frame 0 seeds Smin / Stmp / lambda_d with the raw power and leaves S at 0;
- the minima window resets when the shared counter ``ell`` is a multiple of
  L at frame start, for every bin of that frame, after which ``ell``
  restarts at 1;
- p is forced to 0 for the first 2L frames and stored clipped to
  [p_min, p_max]; bin 0 gets p = 0 (then clipped) every frame.

The frame counters ``ell`` and ``frm_cnt`` are host integers: they are the
same for every bin and utterance, so the branches on them are host branches.

``mcra_run`` on a CUDA tensor launches the MCRA lane kernel
(``ops/cuda_mcra.py``, ``csrc/mcra.cu``: one thread a lane through every
frame, the counters in closed form), where the JAX package runs one
``lax.scan``; on a CPU tensor it runs ``mcra_run_plain``, the frame loop of
``mcra_step``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.ops import cuda_mcra


@dataclasses.dataclass(frozen=True)
class McraConfig:
    nfft: int = 256
    L: int = 15  # minima-tracking window
    alpha_s: float = 0.8
    alpha_d: float = 0.95
    alpha_p: float = 0.2
    delta_s: float = 5.0
    p_max: float = 0.999
    p_min: float = 1e-3
    b: Tuple[float, float, float] = (0.25, 0.5, 0.25)

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1


class McraState(NamedTuple):
    S: torch.Tensor  # smoothed PSD              [..., F]
    Smin: torch.Tensor  # tracked minimum        [..., F]
    Stmp: torch.Tensor  # window minimum         [..., F]
    p: torch.Tensor  # speech presence (clipped) [..., F]
    lambda_d: torch.Tensor  # noise PSD          [..., F]
    ell: int  # window frame counter
    frm_cnt: int  # total frame counter


def mcra_init(cfg: McraConfig, batch_shape=(), dtype=torch.float32, device=None) -> McraState:
    z = torch.zeros((*batch_shape, cfg.half_bin), dtype=dtype, device=resolve_device(device))
    return McraState(S=z, Smin=z, Stmp=z, p=z, lambda_d=z, ell=1, frm_cnt=0)


def _freq_smooth(Y: torch.Tensor, b) -> torch.Tensor:
    """b[0]*Y[k-1] + b[1]*Y[k] + b[2]*Y[k+1]; edges repeat (unused by MCRA)."""
    left = torch.cat([Y[..., :1], Y[..., :-1]], dim=-1)
    right = torch.cat([Y[..., 1:], Y[..., -1:]], dim=-1)
    return b[0] * left + b[1] * Y + b[2] * right


def mcra_step(cfg: McraConfig, state: McraState, Y: torch.Tensor) -> Tuple[McraState, Tuple[torch.Tensor, torch.Tensor]]:
    """One MCRA frame.  Y: [..., F] noisy power of the reference channel.
    Returns (new_state, (lambda_d, p))."""
    F = cfg.half_bin
    k = torch.arange(F, device=Y.device)
    interior = (k >= 1) & (k <= F - 2)
    lead = k <= F - 2
    reset = state.ell % cfg.L == 0

    if state.frm_cnt == 0:
        # first-frame seeding: S stays, minima and noise PSD take the power
        S_out = state.S
        Smin_out = torch.where(lead, Y, state.Smin)
        Stmp_out = torch.where(lead, Y, state.Stmp)
        p_sel = torch.where(lead, torch.zeros_like(state.p), state.p)
        lam_pre = torch.where(lead, Y, state.lambda_d)
    else:
        S_upd = cfg.alpha_s * state.S + (1.0 - cfg.alpha_s) * _freq_smooth(Y, cfg.b)
        S_out = torch.where(interior, S_upd, state.S)
        Smin1 = torch.minimum(state.Smin, S_out)
        Stmp1 = torch.minimum(state.Stmp, S_out)
        if reset:
            Smin1, Stmp1 = torch.minimum(Stmp1, S_out), S_out
        Smin_out = torch.where(interior, Smin1, state.Smin)
        Stmp_out = torch.where(interior, Stmp1, state.Stmp)

        I = (S_out / (Smin_out + 1e-6) > cfg.delta_s).to(Y.dtype)
        if state.frm_cnt < 2 * cfg.L:
            p_upd = torch.zeros_like(state.p)
        else:
            p_upd = cfg.alpha_p * state.p + (1.0 - cfg.alpha_p) * I
        p_sel = torch.where(interior, p_upd, state.p)
        p_sel[..., 0] = 0.0
        lam_pre = state.lambda_d
    p_out = torch.clamp(p_sel, cfg.p_min, cfg.p_max)

    lam_pre = lam_pre.clone()
    lam_pre[..., F - 1] = 1e-8
    alpha_tilde = cfg.alpha_d + (1.0 - cfg.alpha_d) * p_out
    lam_out = alpha_tilde * lam_pre + (1.0 - alpha_tilde) * Y

    ell_new = state.ell + 1 if (state.frm_cnt == 0 or not reset) else 1
    new_state = McraState(
        S=S_out, Smin=Smin_out, Stmp=Stmp_out, p=p_out, lambda_d=lam_out,
        ell=ell_new, frm_cnt=state.frm_cnt + 1,
    )
    return new_state, (lam_out, p_out)


def mcra_run_plain(cfg: McraConfig, Y_tf: torch.Tensor, return_sr: bool = False):
    """MCRA over a whole spectrogram, frame by frame (``mcra_step``).
    Y_tf: [T, ..., F] power, time-major.  Returns (lambda_d, p), each
    [T, ..., F]; with ``return_sr`` also the raw speech indicator S / Smin
    (the statistic p is filtered from, without the 2L warmup forcing — see
    MvdrConfig.vad_guard)."""
    state = mcra_init(cfg, batch_shape=Y_tf.shape[1:-1], dtype=Y_tf.dtype, device=Y_tf.device)
    outs = []
    for y in Y_tf:
        state, (lam, p) = mcra_step(cfg, state, y)
        outs.append((lam, p, state.S / (state.Smin + 1e-6)) if return_sr else (lam, p))
    return tuple(torch.stack(o) for o in zip(*outs))


def mcra_run(cfg: McraConfig, Y_tf: torch.Tensor, return_sr: bool = False):
    """``mcra_run_plain``'s result: on a CPU tensor that function, on a CUDA
    tensor the MCRA lane kernel (float32), one launch a call."""
    if Y_tf.device.type == "cpu":
        return mcra_run_plain(cfg, Y_tf, return_sr)
    return cuda_mcra.mcra_frames(cfg, Y_tf, _freq_smooth(Y_tf, cfg.b), return_sr)
