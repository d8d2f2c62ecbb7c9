"""Oversampled Nyquist(M) subband analysis / synthesis filterbank.

Counterpart of ``distantspeech_tpu/transform/subband.py``.  Analysis is a
polyphase decimated filterbank: each frame of ``win_len = m * n_fft``
samples is time-reversed, windowed by the analysis prototype h, folded into
``n_fft`` samples (the sum of m segments) and rfft'd, all frames and
channels in one product.

Synthesis runs a time-delay line the length of the synthesis prototype:
each frame's windowed inverse is added to the line shifted by one hop, and
the oldest hop leaves as output (``subband_synthesis_step``, the streaming
form).  The offline ``subband_synthesis`` computes the same sums without a
frame loop: with each frame's windowed inverse padded on the left to
R = ceil(win_len / hop) whole hops, output hop t is the sum over k < R of
block R - 1 - k of frame t - k, added oldest first, as the delay line adds
them.

Scaling as in the JAX package: synthesis multiplies by ``n_fft`` (the
reference's ``n_fft * hop`` then ``/ hop``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.ops.dft import irdft, rdft
from distantspeech_tpu_torch.ops.framing import frame_signal
from distantspeech_tpu_torch.transform.filterbank_design import nyquist_prototypes


@dataclasses.dataclass(frozen=True)
class SubbandConfig:
    """Static filterbank parameters (hashable; prototypes designed lazily)."""

    n_fft: int = 256
    hop: int = 128
    m: int = 2  # prototype length factor

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def r(self) -> int:
        # decimation exponent derived from hop, as in the JAX package
        return int(self.n_fft / self.hop / 2)

    @property
    def win_len(self) -> int:
        return self.n_fft * self.m

    @property
    def overlap(self) -> int:
        return self.win_len - self.hop

    def prototypes(self) -> Tuple[np.ndarray, np.ndarray]:
        return nyquist_prototypes(self.n_fft, self.m, self.r)


def _prototype(cfg: SubbandConfig, which: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(cfg.prototypes()[which], dtype=like.real.dtype, device=like.device)


def subband_analysis_frames(x: torch.Tensor, cfg: SubbandConfig, h: torch.Tensor) -> torch.Tensor:
    """Analysis of a padded signal with no implicit carry.

    x: [..., samples] -> Y: [..., T, half_bin] with
    T = (samples - overlap) // hop.
    """
    frames = frame_signal(x, cfg.win_len, cfg.hop)  # [..., T, win]
    windowed = torch.flip(frames, dims=(-1,)) * h
    folded = windowed.reshape(*windowed.shape[:-1], cfg.m, cfg.n_fft).sum(dim=-2)
    return rdft(folded)


def subband_analysis(x: torch.Tensor, cfg: SubbandConfig) -> torch.Tensor:
    """Offline analysis from the zero ``previous_input`` state.

    x: [..., hop * T] -> [..., T, half_bin].
    """
    return subband_analysis_frames(torch.nn.functional.pad(x, (cfg.overlap, 0)), cfg, _prototype(cfg, 0, x))


def subband_analysis_stream(
    carry: torch.Tensor, chunk: torch.Tensor, cfg: SubbandConfig, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming analysis step; carry: [..., overlap] input tail."""
    x = torch.cat([carry, chunk], dim=-1)
    return x[..., -cfg.overlap :], subband_analysis_frames(x, cfg, h)


def _windowed_inverse(Y: torch.Tensor, cfg: SubbandConfig, g: torch.Tensor) -> torch.Tensor:
    """irfft of each frame, tiled m times and windowed by g: [..., win_len]."""
    y = irdft(Y, n=cfg.n_fft)
    return y.repeat(*(1,) * (y.ndim - 1), cfg.m) * g


def subband_synthesis_step(
    tdl: torch.Tensor, Y_frame: torch.Tensor, cfg: SubbandConfig, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame of polyphase synthesis.

    tdl: [..., win_len] delay-line carry; Y_frame: [..., half_bin].
    Returns (tdl', y [..., hop]) with the net n_fft scaling.
    """
    y_win = _windowed_inverse(Y_frame, cfg, g)
    shifted = torch.cat([torch.zeros_like(tdl[..., : cfg.hop]), tdl[..., : -cfg.hop]], dim=-1)
    tdl = shifted + y_win
    out = cfg.n_fft * torch.flip(tdl[..., -cfg.hop :], dims=(-1,))
    return tdl, out


def subband_synthesis(Y: torch.Tensor, cfg: SubbandConfig) -> torch.Tensor:
    """Offline synthesis from the zero tdl state.

    Y: [..., T, half_bin] -> [..., hop * T].  The delay line's sums, formed
    for all frames at once (see the module docstring).
    """
    g = _prototype(cfg, 1, Y)
    T, hop = Y.shape[-2], cfg.hop
    R = -(-cfg.win_len // hop)
    # left zeros make the windowed inverse R whole hops; they sit where the
    # line's head would take zeros in, so every block keeps its place
    y_win = torch.nn.functional.pad(_windowed_inverse(Y, cfg, g), ((-cfg.win_len) % hop, 0))
    blocks = y_win.reshape(*Y.shape[:-1], R, hop)  # [..., T, R, hop]
    out = torch.zeros((*Y.shape[:-1], hop), dtype=g.dtype, device=Y.device)
    for k in range(min(R, T) - 1, -1, -1):  # frame t - k's block R - 1 - k, oldest first
        out[..., k:, :] += blocks[..., : T - k, R - 1 - k, :]
    out = cfg.n_fft * torch.flip(out, dims=(-1,))
    return out.reshape(*out.shape[:-2], T * hop)


def subband_synthesis_init(batch_shape, cfg: SubbandConfig, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, cfg.win_len), dtype=dtype, device=resolve_device(device))
