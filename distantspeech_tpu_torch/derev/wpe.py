"""Adaptive multichannel RLS-WPE dereverberation in the subband domain.

Counterpart of ``distantspeech_tpu/derev/wpe.py``: the variance-normalised
RLS recursion over a D-frame-delayed [bin, C*N] regressor, a per-channel
prediction-filter update, and the prediction error as the dereverberated
output.  One frame is one vectorised step over all bins and utterances; the
offline entry points loop it over frames on the CPU, and on a card run the
whole recursion as one kernel (``csrc/wpe.cu``).

Structure per frame:
    X  = [taps of the D-frame-delayed spectra]   [..., F, C*N]
    e  = d - W^H X                                (late reverb removed)
    s2 = 0.98 s2 + 0.02 |d|^2/C                   (PSD normaliser)
    kn = P X / (lambda * s2 + X^H P X)
    P <- (P - kn (X^H P)) / lambda
    W <- W + e* kn  per channel
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device, wrapper_input
from distantspeech_tpu_torch.ops.cuda_wpe import wpe_frames
from distantspeech_tpu_torch.runtime.profiling import count
from distantspeech_tpu_torch.stats.linalg import matvec, vecmat
from distantspeech_tpu_torch.transform.subband import SubbandConfig, subband_analysis, subband_synthesis


@dataclasses.dataclass(frozen=True)
class WpeConfig:
    num_bands: int = 512
    hop: int = 128
    n_channels: int = 2
    filter_len: int = 2  # taps per bin per channel
    delay: int = 4  # prediction delay in frames
    forgetting_factor: float = 0.998
    alpha_var: float = 0.98
    p_init: float = 1e-3  # P starts small, as in the reference

    @property
    def half_bin(self) -> int:
        return self.num_bands // 2 + 1

    @property
    def subband(self) -> SubbandConfig:
        return SubbandConfig(n_fft=self.num_bands, hop=self.hop)


class WpeState(NamedTuple):
    W: torch.Tensor  # prediction filters [..., F, C, C*N]
    buf: torch.Tensor  # delayed-regressor taps [..., F, C, N]
    P: torch.Tensor  # inverse correlation [..., F, C*N, C*N]
    var: torch.Tensor  # PSD normaliser [..., F]


def wpe_init(cfg: WpeConfig, batch_shape=(), cdtype=torch.complex64, device=None) -> WpeState:
    dev = resolve_device(device)
    F, C, N = cfg.half_bin, cfg.n_channels, cfg.filter_len
    eye = torch.eye(C * N, dtype=cdtype, device=dev) * cfg.p_init
    return WpeState(
        W=torch.zeros((*batch_shape, F, C, C * N), dtype=cdtype, device=dev),
        buf=torch.zeros((*batch_shape, F, C, N), dtype=cdtype, device=dev),
        P=eye.expand(*batch_shape, F, C * N, C * N).clone(),
        var=torch.zeros((*batch_shape, F), dtype=cdtype.to_real(), device=dev),
    )


def wpe_step(cfg: WpeConfig, state: WpeState, d: torch.Tensor, x_delayed: torch.Tensor) -> Tuple[WpeState, torch.Tensor]:
    """One frame.  d: [..., F, C] current spectra; x_delayed: [..., F, C]
    spectra delayed by ``cfg.delay`` frames.  Returns (state, e [..., F, C])."""
    lam = cfg.forgetting_factor
    C, N = cfg.n_channels, cfg.filter_len

    buf = torch.cat([x_delayed[..., None], state.buf[..., :-1]], dim=-1)  # [..., F, C, N]
    X = buf.reshape(*buf.shape[:-2], C * N)  # [..., F, C*N]

    e = d - matvec(torch.conj(state.W), X)

    var_n = torch.sum(torch.conj(d) * d, dim=-1).abs() / C
    var = cfg.alpha_var * state.var + (1.0 - cfg.alpha_var) * var_n

    num = matvec(state.P, X)  # P X
    den = lam * var.to(num.dtype) + torch.sum(torch.conj(X) * num, dim=-1)
    kn = num / den[..., None]
    XhP = vecmat(torch.conj(X), state.P)
    P = (state.P - kn[..., :, None] * XhP[..., None, :]) / lam

    W = state.W + torch.conj(e)[..., :, None] * kn[..., None, :]
    return WpeState(W=W, buf=buf, P=P, var=var), e


def _recursion(cfg: WpeConfig, D_tf: torch.Tensor, constrain=None) -> torch.Tensor:
    """The frame loop of ``wpe_run`` from a fresh state: ``wpe_step`` over
    the frames of D_tf [T, ..., F, C] and of their spectra ``cfg.delay``
    frames back; ``constrain`` is ``wpe_run``'s."""
    state = wpe_init(cfg, batch_shape=D_tf.shape[1:-2], cdtype=D_tf.dtype, device=D_tf.device)
    state = constrain(state) if constrain else state
    delayed = torch.cat([torch.zeros_like(D_tf[: cfg.delay]), D_tf[: -cfg.delay]], dim=0)
    es = []
    for d, xd in zip(D_tf, delayed):
        state, e = wpe_step(cfg, state, d, xd)
        state = constrain(state) if constrain else state
        es.append(e)
    return torch.stack(es)


def wpe_run(cfg: WpeConfig, D_tf, constrain=None) -> torch.Tensor:
    """Loop WPE over a subband spectrogram.

    D_tf: [T, ..., F, C] time-major spectra (a tensor stays on its device;
    an array goes to the card).  Returns e: [T, ..., F, C].  ``constrain``
    (optional) maps WpeState -> WpeState and is applied to the initial state
    and to every frame's state: the hook for a runner that places the P
    recursion's shards.  On a card without ``constrain`` the recursion is
    one kernel launch (``ops.cuda_wpe.wpe_frames``, ``csrc/wpe.cu``; complex64
    within its range, else it raises); on the CPU, or with ``constrain``, it
    is the frame loop (``_recursion``).  Counts the frames stepped
    (``wpe.frames``).
    """
    D_tf = wrapper_input(D_tf)
    count("wpe.frames", D_tf.shape[0])
    if D_tf.device.type == "cuda" and constrain is None:
        return wpe_frames(cfg, D_tf)
    return _recursion(cfg, D_tf, constrain)


def wpe_process(x, cfg: WpeConfig, device=None) -> torch.Tensor:
    """Offline dereverberation of a time-domain batch.

    x: [..., C, S] multichannel time signal -> [..., S] dereverberated
    reference channel (a subband round trip) on ``device``.
    """
    x = torch.as_tensor(x, device=resolve_device(device))
    Y = subband_analysis(x, cfg.subband)  # [..., C, T, F]
    D_tf = torch.movedim(torch.movedim(Y, -3, -1), -3, 0)  # [T, ..., F, C]
    e = wpe_run(cfg, D_tf)  # [T, ..., F, C]
    return subband_synthesis(torch.movedim(e[..., 0], 0, -2), cfg.subband)
