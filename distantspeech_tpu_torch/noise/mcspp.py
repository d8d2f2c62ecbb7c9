"""Full multichannel SPP noise tracker (Souden 2011 production variant).

Counterpart of ``distantspeech_tpu/noise/mcspp.py``.  On top of the base
Gaussian-model SPP it keeps every production trait of the reference:

- q from the CDR estimator, ``q = 1 - mccdr(y)``;
- adaptive diagonal loading from the mean of q over the mid band
  ``qband``: high estimated absence, heavier loading;
- a warm start: for the first 10 frames ``Phi_vv = Phi_yy`` and q is
  pinned to 0.99;
- Phi_vv hermitized at the head of the core, and the noise recursion that
  follows reads the hermitized matrix;
- a single repair inverse: bins with xi < 0 get their inverse recomputed
  from Phi_yy (+ the loading for the first 5 frames);
- complex covariance inverses;
- the q >= 1 guard: q == 1 is reachable in float32, where q / (1 - q) is
  inf and inf * exp(-huge) NaN; its limit p = 0 is taken instead;
- PMWF weights with beta = 10.

The frame counter ``frm_cnt`` is a host integer, the same for every bin and
utterance.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.noise.mccdr import McCdrConfig, McCdrState, mccdr_init, mccdr_step
from distantspeech_tpu_torch.noise.mcspp_base import McSppOut
from distantspeech_tpu_torch.stats.linalg import gauss_jordan_inv, matvec, trace_mm, vecmat


@dataclasses.dataclass(frozen=True)
class McSppConfig:
    nfft: int = 256
    n_channels: int = 4
    alpha: float = 0.92  # Phi_yy pole
    alpha_d: float = 0.92  # noise pole
    diag_min: float = 1e-4  # adaptive loading range
    diag_max: float = 1e-1
    warmup_frames: int = 10
    repair_frames: int = 5
    pmwf_beta: float = 10.0

    @property
    def half_bin(self) -> int:
        return self.nfft // 2 + 1

    @property
    def mccdr(self) -> McCdrConfig:
        # the CDR track is the 4-channel one; it reads the first 4 channels
        return McCdrConfig(nfft=self.nfft, n_channels=min(4, self.n_channels))

    @property
    def qband(self) -> Tuple[int, int]:
        """Mid-band bins whose mean q drives the loading."""
        return int(500 * self.nfft / 16000), int(2000 * self.nfft / 16000)

    def qband_mean(self, q: torch.Tensor) -> torch.Tensor:
        """The mean of q [..., F] over ``qband`` (a bin-sharded runner
        overrides it with the all-reduce of its shards' partial sums)."""
        lo, hi = self.qband
        return q[..., lo:hi].mean(dim=-1)


class McSppState(NamedTuple):
    Phi_yy: torch.Tensor  # [..., F, C, C] complex
    Phi_vv: torch.Tensor  # [..., F, C, C] complex
    mccdr: McCdrState
    frm_cnt: int


def mcspp_init(cfg: McSppConfig, batch_shape=(), cdtype=torch.complex64, device=None) -> McSppState:
    dev = resolve_device(device)
    F, C = cfg.half_bin, cfg.n_channels
    z = torch.zeros((*batch_shape, F, C, C), dtype=cdtype, device=dev)
    return McSppState(Phi_yy=z, Phi_vv=z, mccdr=mccdr_init(cfg.mccdr, batch_shape, cdtype=cdtype, device=dev), frm_cnt=0)


def mcspp_step(cfg: McSppConfig, Fn: torch.Tensor, state: McSppState, y: torch.Tensor) -> Tuple[McSppState, McSppOut]:
    """One frame.  Fn: [F] diffuse pair coherence (``cfg.mccdr.fn_pair()``);
    y: [..., F, C] complex.  Returns (new_state, McSppOut)."""
    C = y.shape[-1]
    eye = torch.eye(C, dtype=y.dtype, device=y.device)
    warm = state.frm_cnt < cfg.warmup_frames

    mccdr_state, cdr_p = mccdr_step(cfg.mccdr, Fn, state.mccdr, y[..., : cfg.mccdr.n_channels])
    q = 1.0 - cdr_p

    q_avg = cfg.qband_mean(q)
    diag_value = q_avg * cfg.diag_max + (1.0 - q_avg) * cfg.diag_min  # [...]
    diag = diag_value[..., None, None, None] * eye  # broadcast over bins

    psd_yy = y[..., :, None] * torch.conj(y)[..., None, :]
    Phi_yy = cfg.alpha * state.Phi_yy + (1.0 - cfg.alpha) * psd_yy
    Phi_vv = Phi_yy if warm else state.Phi_vv
    if warm:
        q = torch.full_like(q, 0.99)

    # the estimation core
    Phi_vv = 0.5 * (Phi_vv + torch.conj(Phi_vv.transpose(-1, -2)))
    Phi_xx = Phi_yy - Phi_vv
    Pinv = gauss_jordan_inv(Phi_vv + diag)
    xi = trace_mm(Pinv, Phi_yy).real - C
    neg = xi < 0.0
    # one repair inverse: inv(Phi_yy + diag * 1[frm_cnt < repair_frames])
    repair = gauss_jordan_inv(Phi_yy + diag if state.frm_cnt < cfg.repair_frames else Phi_yy)
    # the unloaded repair of a covariance of lower rank than C (more mics
    # than frames seen) can overflow in float32; such a lane keeps its
    # loaded inverse rather than carry a NaN into the noise recursion
    neg = neg & torch.isfinite(repair).all(dim=-1).all(dim=-1)
    Pinv = torch.where(neg[..., None, None], repair, Pinv)
    xi = torch.clamp(trace_mm(Pinv, Phi_yy).real - C, 1e-6, 1e8)

    # literal y^H Pinv Phi_yy Pinv y - y^H Pinv y (no hermitian assumption on Pinv)
    lv = vecmat(torch.conj(y), Pinv)
    rv = matvec(Pinv, y)
    gamma = (torch.sum(lv * matvec(Phi_yy, rv), dim=-1) - torch.sum(lv * y, dim=-1)).real
    gamma = torch.clamp(gamma, 1e-6, 1e8)

    ratio = q / (1.0 - q) * (1.0 + xi) * torch.exp(-(gamma / (1.0 + xi)))
    p = torch.clamp(torch.where(q >= 1.0, 0.0, 1.0 / (1.0 + ratio)), 0.0, 1.0)

    # noise update
    alpha_tilde = (cfg.alpha_d + (1.0 - cfg.alpha_d) * p)[..., None, None]
    Phi_vv_new = alpha_tilde * Phi_vv + (1.0 - alpha_tilde) * psd_yy

    # PMWF weights, beta = 10
    w = matvec(Pinv, Phi_xx[..., :, 0]) / (cfg.pmwf_beta + xi)[..., None]
    new_state = McSppState(Phi_yy=Phi_yy, Phi_vv=Phi_vv_new, mccdr=mccdr_state, frm_cnt=state.frm_cnt + 1)
    return new_state, McSppOut(p=p, q=q, xi=xi, gamma=gamma, w=w)


def mcspp_run(cfg: McSppConfig, Y_tf: torch.Tensor) -> McSppOut:
    """Loop over frames.  Y_tf: [T, ..., F, C] complex -> McSppOut [T, ...]."""
    Fn = torch.as_tensor(cfg.mccdr.fn_pair(), dtype=Y_tf.real.dtype, device=Y_tf.device)
    state = mcspp_init(cfg, batch_shape=Y_tf.shape[1:-2], cdtype=Y_tf.dtype, device=Y_tf.device)
    outs = []
    for y in Y_tf:
        state, out = mcspp_step(cfg, Fn, state, y)
        outs.append(out)
    return McSppOut(*(torch.stack(o) for o in zip(*outs)))
