"""Speex-style acoustic echo canceller on an MDF core.

Counterpart of ``distantspeech_tpu/adaptive/aec.py``: a two-path
foreground / background MDF with the speex statistical transfer logic
(Davg / Dvar significance tests), echo-leak estimation by spectral linear
regression (Valin 2007, eqs. 19-21), a per-bin optimal step size with
3-tap smoothing, and pre- / de-emphasis around the canceller.

The frame counter ``cnt`` is a host integer: it is the same for every
utterance and mic, so the warm-up rule ``cnt < 5 -> mu = 0.1`` is a host
branch.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device, scalar_on
from distantspeech_tpu_torch.adaptive.feature import EmphasisState, de_emphasis, emphasis_init, pre_emphasis
from distantspeech_tpu_torch.adaptive.mdf import _complex, _constrain, mdf_adjust_prop
from distantspeech_tpu_torch.ops.delay import delay_samples
from distantspeech_tpu_torch.ops.dft import irdft, rdft


@dataclasses.dataclass(frozen=True)
class AecConfig:
    filter_len: int = 1024
    num_block: int = 1
    mu: float = 0.01
    alpha: float = 0.8
    constrain: bool = True
    prop: bool = True
    two_path: bool = True
    non_causal: bool = False
    mu_max: float = 0.1
    gamma: float = 0.8  # Py / Pe pole
    fs: int = 16000

    @property
    def block_len(self) -> int:
        return self.filter_len // self.num_block

    @property
    def n_fft(self) -> int:
        return 2 * self.block_len

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def beta0(self) -> float:
        return (2.0 * self.block_len) / self.fs

    def window(self) -> np.ndarray:
        n = np.arange(self.n_fft)
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / self.n_fft)


@lru_cache(maxsize=None)
def _window_on(cfg: AecConfig, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The foreground cross-fade window on ``device``, copied there once."""
    return torch.as_tensor(cfg.window(), dtype=dtype, device=device)


class AecState(NamedTuple):
    buf: torch.Tensor  # far-end input buffer [..., n_fft]
    X: torch.Tensor  # block spectra [..., B, Fb]
    W: torch.Tensor  # background filter [..., B, Fb]
    foreground: torch.Tensor  # foreground filter [..., B, Fb]
    Pm: torch.Tensor  # [..., B, Fb]
    P: torch.Tensor  # [..., Fb]
    power: torch.Tensor  # smoothed far-end spectrum [..., Fb]
    Py: torch.Tensor  # echo-estimate PSD track [..., Fb]
    Pe: torch.Tensor  # error PSD track [..., Fb]
    Ryy: torch.Tensor  # leak regression accumulators [...]
    Rey: torch.Tensor
    Davg1: torch.Tensor  # transfer-logic statistics [...]
    Davg2: torch.Tensor
    Dvar1: torch.Tensor
    Dvar2: torch.Tensor
    cnt: int  # frame counter
    emph_mic: EmphasisState
    emph_spk: EmphasisState
    d_delay: torch.Tensor


def aec_init(cfg: AecConfig, batch_shape=(), dtype=torch.float32, device=None) -> AecState:
    dev = resolve_device(device)
    B, Fb = cfg.num_block, cfg.half_bin
    zc = torch.zeros((*batch_shape, B, Fb), dtype=_complex(dtype), device=dev)
    zf = torch.zeros((*batch_shape, Fb), dtype=dtype, device=dev)
    s = torch.zeros(batch_shape, dtype=dtype, device=dev)
    one = torch.ones(batch_shape, dtype=dtype, device=dev)
    D = cfg.filter_len // 2 if cfg.non_causal else 0
    return AecState(
        buf=torch.zeros((*batch_shape, cfg.n_fft), dtype=dtype, device=dev),
        X=zc, W=zc, foreground=zc,
        Pm=torch.zeros((*batch_shape, B, Fb), dtype=dtype, device=dev),
        P=zf, power=zf, Py=zf, Pe=zf,
        Ryy=one, Rey=one,
        Davg1=s, Davg2=s, Dvar1=s, Dvar2=s,
        cnt=0,
        emph_mic=emphasis_init(batch_shape, dtype=dtype, device=dev),
        emph_spk=emphasis_init(batch_shape, dtype=dtype, device=dev),
        d_delay=torch.zeros((*batch_shape, D), dtype=dtype, device=dev),
    )


def aec_step(
    cfg: AecConfig, state: AecState, x: torch.Tensor, d: torch.Tensor, update=True
) -> Tuple[AecState, Tuple[torch.Tensor, torch.Tensor]]:
    """One block of echo cancellation.  x: [..., block_len] far-end
    (speaker) block; d: [..., block_len] near-end (mic) block.  Returns
    (state, (out [..., block_len], w [..., filter_len]))."""
    L, n_fft = cfg.block_len, cfg.n_fft

    emph_mic, d = pre_emphasis(state.emph_mic, d)
    emph_spk, x = pre_emphasis(state.emph_spk, x)

    buf = torch.cat([state.buf[..., L:], x], dim=-1)
    Xm = rdft(buf, n=n_fft)
    X = torch.cat([Xm[..., None, :], state.X[..., :-1, :]], dim=-2)

    ss = 0.35 / cfg.num_block
    power = (1.0 - ss) * state.power + ss * Xm.abs() ** 2

    Pm = torch.cat([(Xm * Xm.conj()).real[..., None, :], state.Pm[..., :-1, :]], dim=-2)
    P = cfg.alpha * state.P + (1.0 - cfg.alpha) * torch.sum(Pm, dim=-2)

    Y = torch.sum(X * state.W, dim=-2)  # [..., Fb]
    y_b = irdft(Y, n=n_fft)[..., -L:]
    y_f = irdft(torch.sum(X * state.foreground, dim=-2), n=n_fft)[..., -L:]

    d_delay = state.d_delay
    if cfg.non_causal:
        d_delay, d = delay_samples(state.d_delay, d)

    e_b = d - y_b
    e_f = d - y_f

    Davg1, Davg2, Dvar1, Dvar2 = state.Davg1, state.Davg2, state.Dvar1, state.Dvar2
    foreground = state.foreground
    if cfg.two_path:
        # speex statistical transfer logic
        Sff = torch.sum(e_f.abs() ** 2, dim=-1)
        See = torch.sum(e_b.abs() ** 2, dim=-1)
        Dbf = torch.sum((y_f - y_b).abs() ** 2, dim=-1)
        Davg1 = 0.6 * Davg1 + 0.4 * (Sff - See)
        Davg2 = 0.85 * Davg2 + 0.15 * (Sff - See)
        Dvar1 = 0.36 * Dvar1 + 0.16 * Sff * Dbf
        Dvar2 = 0.7225 * Dvar2 + 0.0225 * Sff * Dbf
        upd = (
            ((Sff - See) * (Sff - See).abs() > Sff * Dbf)
            | (Davg1 * Davg1.abs() > 0.5 * Dvar1)
            | (Davg2 * Davg2.abs() > 0.25 * Dvar2)
        )
        zero = torch.zeros_like(Davg1)
        Davg1 = torch.where(upd, zero, Davg1)
        Davg2 = torch.where(upd, zero, Davg2)
        Dvar1 = torch.where(upd, zero, Dvar1)
        Dvar2 = torch.where(upd, zero, Dvar2)
        foreground = torch.where(upd[..., None, None], state.W, state.foreground)
        win = _window_on(cfg, y_f.dtype, y_f.device)
        y_f = torch.where(upd[..., None], win[L:] * y_f + win[:L] * y_b, y_f)
        out = d - y_f
    else:
        out = e_b

    E = rdft(torch.nn.functional.pad(e_b, (L, 0)), n=n_fft)

    # ---- leak estimation (Valin 2007, eqs. 17-22) ----------------------------
    Yf_sq = (Y * Y.conj()).abs()
    Rf_sq = (E * E.conj()).abs()
    g, g1 = cfg.gamma, 1.0 - cfg.gamma
    Py = g1 * state.Py + g * Yf_sq
    Pe = g1 * state.Pe + g * Rf_sq
    Eh = Rf_sq - Pe
    Yh = Yf_sq - Py
    Pey = torch.sum(Eh * Yh, dim=-1) / (torch.sqrt(torch.sum(Yh**2, dim=-1)) + 1e-6)
    Pyy = torch.sqrt(torch.sum(Yh**2, dim=-1))

    Syy = torch.sum(y_b**2, dim=-1)
    See_b = torch.sum(e_b**2, dim=-1)
    a = cfg.beta0 * torch.clamp(Syy / See_b, max=1.0)
    Ryy = (1.0 - a) * state.Ryy + a * Pyy
    Rey = (1.0 - a) * state.Rey + a * Pey
    leak = Rey / (Ryy + 1e-6)

    mu_opt = leak[..., None] * Y.abs() ** 2 / (E.abs() ** 2 + 1e-3)
    mu_opt = torch.cat([2.0 * mu_opt[..., :2], mu_opt[..., 2:]], dim=-1)
    mu_opt = torch.clamp(mu_opt, 1e-3, cfg.mu_max)
    mu_pad = torch.nn.functional.pad(mu_opt, (1, 1))  # 3-tap 'same' smoothing
    mu_opt = 0.25 * mu_pad[..., :-2] + 0.5 * mu_pad[..., 1:-1] + 0.25 * mu_pad[..., 2:]
    if state.cnt < 5:
        mu_opt = torch.full_like(mu_opt, 0.1)

    grad = X.conj() * E[..., None, :] / (P + 1e-6)[..., None, :]
    if cfg.constrain:
        grad = _constrain(grad, n_fft, L)

    gate = scalar_on(update, P.dtype, P.device)
    if cfg.prop:
        W = state.W + gate * mdf_adjust_prop(state.W)[..., :, None] * mu_opt[..., None, :] * grad
    else:
        W = state.W + gate * mu_opt[..., None, :] * grad

    w_blocks = irdft(W, n=n_fft)[..., :L]
    w = w_blocks.reshape(*w_blocks.shape[:-2], -1)

    emph_mic, out = de_emphasis(emph_mic, out)

    new_state = AecState(
        buf=buf, X=X, W=W, foreground=foreground, Pm=Pm, P=P, power=power,
        Py=Py, Pe=Pe, Ryy=Ryy, Rey=Rey,
        Davg1=Davg1, Davg2=Davg2, Dvar1=Dvar1, Dvar2=Dvar2,
        cnt=state.cnt + 1, emph_mic=emph_mic, emph_spk=emph_spk, d_delay=d_delay,
    )
    return new_state, (out, w)
