"""dios_ssp (athena-signal) GSC: partitioned-FLMS ABM and AIC.

Counterpart of ``distantspeech_tpu/beamform/dios_gsc.py``.  Both modules
take 16-sample segments (fftsize / (2 sigsoverlap)), buffer them into
fftsize-sample blocks and run constrained overlap-save FLMS with external
step-size / freeze controls (ctrl_abm, ctrl_aic):

- ABM: a filter a channel, initialised to a free-field sync-delay impulse,
  its taps clamped around the centre tap; adapts every second segment
  (fftoverlap = 2);
- AIC: a multichannel sum filter with norm ceiling 0.003; adapts every
  segment (fftoverlap = 4), a 72-sample causality delay on the FBF path.

The ABM's segment counter ``count`` is a host int, as the port's MCRA frame
counters are: the block runs only on the segments that adapt (the same
numbers as computing it every segment and selecting), and the output is a
host-indexed slice.  ``dios_gsc_process`` steps segment pairs, as JAX's
``dios_gsc_process`` does, with the alignment FIR and the FBF mean (which
read no ABM / AIC state) run over the whole signal before the pair loop.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.ops.dft import irdft, rdft
from distantspeech_tpu_torch.ops.fir import fir_block_taps


@dataclasses.dataclass(frozen=True)
class DiosGscConfig:
    n_mics: int = 4
    fftsize: int = 128
    sigsoverlap: int = 4
    abm_fftoverlap: int = 2
    aic_fftoverlap: int = 4
    abm_syncdly: int = 32
    aic_syncdly: int = 72
    forgetfactor: float = 0.99
    stepsize: float = 0.5
    threshdiv0: float = 0.0001
    rate: int = 16000
    tconst_freezing: float = 100.0
    aic_lambda: float = 0.944750
    aic_mu: float = 0.033150
    aic_delta_con: float = 0.0001
    aic_maxnorm: float = 0.003

    @property
    def half_bin(self) -> int:
        return self.fftsize // 2 + 1

    @property
    def seg(self) -> int:
        """Input segment length fed per call (16 for the defaults)."""
        return self.fftsize // (2 * self.sigsoverlap)

    @property
    def abm_lambda(self) -> float:
        return self.forgetfactor * (1.0 - 1.0 / (3.0 * self.fftsize)) ** (
            self.fftsize / (2 * self.abm_fftoverlap)
        )

    @property
    def abm_mu(self) -> float:
        return 2.0 * self.stepsize * (1.0 - self.abm_lambda)

    @property
    def abm_nu(self) -> float:
        return 1.0 - np.exp(-self.fftsize / (2 * self.abm_fftoverlap * self.tconst_freezing * self.rate))

    def abm_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Upper / lower tap clamps (host arrays)."""
        n = self.fftsize
        ub = np.full(n // 2, 0.001)
        lb = np.full(n // 2, -0.001)
        q = n // 4
        ub[q] = 1.3
        if self.n_mics > 2:
            ub[q + 1] = 0.6
            ub[q - 1] = 0.6
            ub[q + 2] = 0.15
            ub[q - 2] = 0.15
        else:
            ub[q] = 1.1
            ub[q + 1] = 0.7
            ub[q - 1] = 0.7
            ub[q + 2] = 0.3
            ub[q - 2] = 0.3
            ub[q + 3] = 0.1
            ub[q - 3] = 0.1
        return ub, lb


@lru_cache(maxsize=None)
def _abm_clamps(cfg: DiosGscConfig, dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ABM's tap clamps as full-length [fftsize] bounds on ``device``,
    copied once: ``abm_bounds()`` at the clamped taps (1 .. q-3, n/2 - 1 ..
    n/2 - (q-3), and 0), +-inf at the others, which the clamp then leaves as
    they are (the upper half is zeroed before it)."""
    n = cfg.fftsize
    ub, lb = cfg.abm_bounds()
    limit = n // 4 - 3
    idx = np.concatenate([np.arange(1, limit + 1), n // 2 - np.arange(1, limit + 1), [0]])
    lo, hi = np.full(n, -np.inf), np.full(n, np.inf)
    lo[idx], hi[idx] = lb[idx], ub[idx]
    return torch.as_tensor(lo, dtype=dtype, device=device), torch.as_tensor(hi, dtype=dtype, device=device)


def _delayline(dline: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dline' = [dline tail | x], keeping the total length."""
    return torch.cat([dline[..., x.shape[-1]:], x], dim=-1)


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


class DiosAbmState(NamedTuple):
    Xdline: torch.Tensor  # [..., M, fft]
    xrefdline: torch.Tensor  # [..., fft/2 + syncdly]
    hf: torch.Tensor  # [..., M, Fb]
    sf: torch.Tensor  # [..., M, Fb]
    E: torch.Tensor  # pending output segments [..., M, fft/(2*fftoverlap)]
    count: int  # segment counter (host int)


def dios_abm_init(cfg: DiosGscConfig, batch_shape=(), dtype=torch.float64, device=None) -> DiosAbmState:
    dev = resolve_device(device)
    M, n, Fb = cfg.n_mics, cfg.fftsize, cfg.half_bin
    imp = np.zeros(n)
    imp[cfg.abm_syncdly] = 1.0  # free-field init: the sync-delay impulse
    hf0 = torch.as_tensor(np.fft.rfft(imp), dtype=_complex_of(dtype), device=dev)
    return DiosAbmState(
        Xdline=torch.zeros((*batch_shape, M, n), dtype=dtype, device=dev),
        xrefdline=torch.zeros((*batch_shape, n // 2 + cfg.abm_syncdly), dtype=dtype, device=dev),
        hf=hf0.expand(*batch_shape, M, Fb).clone(),
        sf=torch.zeros((*batch_shape, M, Fb), dtype=dtype, device=dev),
        E=torch.zeros((*batch_shape, M, n // (2 * cfg.abm_fftoverlap)), dtype=dtype, device=dev),
        count=0,
    )


def _abm_block(cfg: DiosGscConfig, state: DiosAbmState, ctrl_abm, ctrl_aic):
    """One ABM data block, all channels batched: (sf, E, hf)."""
    n = cfg.fftsize
    xfref = rdft(state.Xdline)  # [..., M, Fb]
    pxf = torch.abs(xfref) ** 2
    sf = cfg.abm_lambda * state.sf + (1.0 - cfg.abm_lambda) * pxf
    pftmp = torch.where(sf < cfg.threshdiv0, 1.0 / cfg.threshdiv0, 1.0 / sf)
    muf = cfg.abm_mu * pftmp * ctrl_abm
    nuf = (ctrl_aic * cfg.abm_nu).to(xfref.dtype)

    y = irdft(xfref * state.hf, n=n)
    e_tail = state.xrefdline[..., None, : n // 2] - y[..., n // 2 :]
    e = torch.cat([torch.zeros_like(e_tail), e_tail], dim=-1)  # [0 | new]
    E = e[..., n - n // (2 * cfg.abm_fftoverlap) :]

    ef = rdft(e)
    hf = state.hf + torch.conj(xfref) * ef * muf.to(xfref.dtype)
    hf = hf - hf * nuf

    # circular correlation constraint, then the coefficient clamps
    w = irdft(hf, n=n)  # a fresh tensor: written in place, no state aliases it
    w[..., n // 2 :] = 0.0
    lo, hi = _abm_clamps(cfg, w.dtype, w.device)
    return sf, E, rdft(torch.clamp(w, lo, hi))


def dios_abm_step(
    cfg: DiosGscConfig, state: DiosAbmState, X: torch.Tensor, xref: torch.Tensor,
    ctrl_abm: torch.Tensor, ctrl_aic: torch.Tensor,
) -> Tuple[DiosAbmState, torch.Tensor]:
    """One 16-sample segment.  X: [..., M, seg] steering outputs; xref:
    [..., seg] FBF; ctrl_*: [..., Fb].  Returns (state, out [..., seg, M])."""
    xrefdline = _delayline(state.xrefdline, xref)
    Xdline = _delayline(state.Xdline, X)
    st = state._replace(Xdline=Xdline, xrefdline=xrefdline)
    if state.count == cfg.sigsoverlap // cfg.abm_fftoverlap - 1:
        sf, E, hf = _abm_block(cfg, st, ctrl_abm, ctrl_aic)
        st = st._replace(sf=sf, E=E, hf=hf, count=0)
    else:
        st = st._replace(count=state.count + 1)
    seg = cfg.seg
    start = min(st.count * seg, st.E.shape[-1] - seg)  # clamped, as a dynamic slice is
    return st, torch.movedim(st.E[..., start : start + seg], -1, -2)


class DiosAicState(NamedTuple):
    Xdline: torch.Tensor  # [..., M, fft]
    xrefdline: torch.Tensor  # [..., fft/2 + 72]
    Hf: torch.Tensor  # [..., M, Fb]
    sf: torch.Tensor  # [..., Fb]


def dios_aic_init(cfg: DiosGscConfig, batch_shape=(), dtype=torch.float64, device=None) -> DiosAicState:
    dev = resolve_device(device)
    M, n, Fb = cfg.n_mics, cfg.fftsize, cfg.half_bin
    return DiosAicState(
        Xdline=torch.zeros((*batch_shape, M, n), dtype=dtype, device=dev),
        xrefdline=torch.zeros((*batch_shape, n // 2 + cfg.aic_syncdly), dtype=dtype, device=dev),
        Hf=torch.zeros((*batch_shape, M, Fb), dtype=_complex_of(dtype), device=dev),
        sf=torch.zeros((*batch_shape, Fb), dtype=dtype, device=dev),
    )


def dios_aic_step(
    cfg: DiosGscConfig, state: DiosAicState, X: torch.Tensor, xref: torch.Tensor,
    ctrl_abm: torch.Tensor, ctrl_aic: torch.Tensor,
) -> Tuple[DiosAicState, torch.Tensor]:
    """One 16-sample segment (fftoverlap = 4: adapts every call).
    X: [..., M, seg] ABM outputs; xref: [..., seg] FBF.  Returns
    (state, out [..., seg])."""
    n = cfg.fftsize
    Xdline = _delayline(state.Xdline, X)
    xrefdline = _delayline(state.xrefdline, xref)

    Xf = rdft(Xdline)  # [..., M, Fb]
    pXf = torch.sum(torch.abs(Xf) ** 2, dim=-2)
    yhf = torch.sum(state.Hf * Xf, dim=-2)
    y = irdft(yhf, n=n)
    e_tail = xrefdline[..., : n // 2] - y[..., n // 2 :]
    e = torch.cat([torch.zeros_like(e_tail), e_tail], dim=-1)
    out = e[..., n - cfg.seg :]

    ef = rdft(e)
    sf = cfg.aic_lambda * state.sf + (1.0 - cfg.aic_lambda) * pXf
    sftmp = torch.where(sf < cfg.aic_delta_con, 1.0 / cfg.aic_delta_con, 1.0 / sf)
    muf = (cfg.aic_mu * sftmp * ctrl_aic).to(Xf.dtype)
    nuf = (ctrl_abm * 1e-5).to(Xf.dtype)  # nu = 1e-5

    Hf = state.Hf + torch.conj(Xf) * ef[..., None, :] * muf[..., None, :]
    norm = torch.sum(torch.abs(Hf) ** 2, dim=(-2, -1)) / (n * n)
    scale = torch.where(norm > cfg.aic_maxnorm, torch.sqrt(cfg.aic_maxnorm / norm), 1.0)

    Hf = Hf - Hf * nuf[..., None, :]
    w = irdft(Hf, n=n)  # a fresh tensor: written in place, no state aliases it
    w[..., n // 2 :] = 0.0
    Hf = rdft(w * scale[..., None, None])
    return DiosAicState(Xdline=Xdline, xrefdline=xrefdline, Hf=Hf, sf=sf), out


class DiosGscState(NamedTuple):
    abm: DiosAbmState
    aic: DiosAicState
    fir_cache: torch.Tensor  # time-alignment FIR tail [..., M, K-1]


def dios_gsc_process(x, coeffs, cfg: DiosGscConfig = DiosGscConfig(), ctrl_abm=None, ctrl_aic=None, device=None):
    """The composed dios_ssp GSC: per 16-sample segment, fractional-delay
    time alignment, FBF = the channel mean, ABM, AIC.  x: [..., M, S];
    coeffs: [M, K] alignment FIR bank
    (``array.alignment.time_alignment_filters``); ctrl_*: optional
    [T_seg, Fb] step-size controls (default all ones).

    Returns (aic_out [..., S'], bm_out [..., S', M]) on ``device``, with
    S' = seg * T_seg and T_seg the even number of whole segments.

    The loop steps segment pairs, the ABM's processing cadence
    (sigsoverlap / abm_fftoverlap = 2): segment A only pushes into the
    delay lines and emits the pending E tail, segment B pushes and runs
    one ABM block.  The alignment FIR and the FBF mean read no ABM / AIC
    state, so they run over the whole signal first, in the same
    fftsize / 4-sample blocks and from the same block-Toeplitz matrix as a
    pair step would."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    seg = cfg.seg
    T = x.shape[-1] // (2 * seg) * 2
    ones = lambda: torch.ones((T, cfg.half_bin), dtype=x.dtype, device=dev)
    ctrl_abm = ones() if ctrl_abm is None else torch.as_tensor(ctrl_abm, device=dev)[:T]
    ctrl_aic = ones() if ctrl_aic is None else torch.as_tensor(ctrl_aic, device=dev)[:T]

    coeffs = torch.as_tensor(coeffs, device=dev).to(x.dtype)
    K = coeffs.shape[-1]
    taps2 = fir_block_taps(coeffs, 2 * seg)  # [M, K-1+2 seg, 2 seg]
    # every pair's FIR window [K-1 carried samples | its 2 seg samples], from a zero cache
    xp = torch.nn.functional.pad(x[..., : T * seg], (K - 1, 0))
    windows = xp.unfold(-1, K - 1 + 2 * seg, 2 * seg)  # [..., M, T/2, K-1+2 seg]
    aligned = torch.einsum("...cnw,cwo->...cno", windows, taps2)  # [..., M, T/2, 2 seg]
    fbf = torch.mean(aligned, dim=-3)  # [..., T/2, 2 seg]

    batch = x.shape[:-2]
    abm = dios_abm_init(cfg, batch, dtype=x.dtype, device=dev)
    aic = dios_aic_init(cfg, batch, dtype=x.dtype, device=dev)
    outs, bms = [], []
    for al2, fbf2, ca, ci in zip(aligned.unbind(-2), fbf.unbind(-2), ctrl_abm.view(T // 2, 2, -1).unbind(0),
                                 ctrl_aic.view(T // 2, 2, -1).unbind(0)):
        # segment A (count 0 -> 1): push only; the output is the pending E tail
        bmA = abm.E[..., seg:]  # [..., M, seg]
        aic, outA = dios_aic_step(cfg, aic, bmA, fbf2[..., :seg], ca[0], ci[0])
        # segment B (count 1 -> 0): both pushes, then one ABM block
        abm = abm._replace(Xdline=_delayline(abm.Xdline, al2), xrefdline=_delayline(abm.xrefdline, fbf2))
        sf, E, hf = _abm_block(cfg, abm, ca[1], ci[1])
        abm = abm._replace(sf=sf, E=E, hf=hf, count=0)
        bmB = E[..., :seg]
        aic, outB = dios_aic_step(cfg, aic, bmB, fbf2[..., seg:], ca[1], ci[1])
        outs += [outA, outB]
        bms += [bmA, bmB]
    out = torch.cat(outs, dim=-1)  # [..., T seg]
    bm = torch.movedim(torch.cat(bms, dim=-1), -2, -1)  # [..., T seg, M]
    return out, bm
