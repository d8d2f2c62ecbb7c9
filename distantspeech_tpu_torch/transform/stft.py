"""Batched STFT / ISTFT with the reference's streaming semantics.

Counterpart of ``distantspeech_tpu/transform/stft.py``.  Two quirks are kept
exactly:

- synthesis does not divide by the window-sum-square envelope; it scales
  the overlap-added signal by ``hop / W0`` with ``W0 = sum(window**2)``;
- chunked processing carries ``overlap = n_fft - hop`` samples of input
  (prepended before framing) and of output tail (added into the next
  chunk's head).

The windowed DFT is one real matrix product against [cos | sin] columns
(the sin columns of k=0 and, for even n_fft, k=F-1 are structural zeros and
are dropped), in the input's dtype.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.ops.framing import frame_signal, overlap_add


def sqrt_hann_window(n_fft: int) -> np.ndarray:
    """Square root of the periodic Hann window, length n_fft."""
    k = np.arange(n_fft)
    return np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft))


@dataclasses.dataclass(frozen=True)
class StftConfig:
    n_fft: int = 256
    hop: int = 128
    window_key: str = "sqrt_hann"

    @property
    def half_bin(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def overlap(self) -> int:
        return self.n_fft - self.hop

    @property
    def window(self) -> np.ndarray:
        if self.window_key != "sqrt_hann":
            raise ValueError(f"unknown window {self.window_key}")
        return sqrt_hann_window(self.n_fft)

    @property
    def w0(self) -> float:
        """Sum of squared window samples."""
        return float(np.sum(self.window**2))

    @property
    def synthesis_gain(self) -> float:
        """hop / W0 output scale of the reference synthesis."""
        return self.hop / self.w0


def _dft_matrices(cfg: StftConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed forward rDFT as two real matrices [n_fft, F]: Y = f @ (C + iS)."""
    n = np.arange(cfg.n_fft)[:, None]
    k = np.arange(cfg.half_bin)[None, :]
    ang = -2.0 * np.pi * n * k / cfg.n_fft
    w = cfg.window[:, None]
    return np.cos(ang) * w, np.sin(ang) * w


def _idft_matrices(cfg: StftConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed inverse rDFT [F, n_fft]: frames = Yr @ A + Yi @ B (hermitian
    bin weights, 1/N scale and the synthesis window folded in)."""
    k = np.arange(cfg.half_bin)[:, None]
    n = np.arange(cfg.n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / cfg.n_fft
    scale = np.full((cfg.half_bin, 1), 2.0)
    scale[0] = 1.0
    if cfg.n_fft % 2 == 0:
        scale[-1] = 1.0
    w = cfg.window[None, :]
    return np.cos(ang) * scale * w / cfg.n_fft, -np.sin(ang) * scale * w / cfg.n_fft


def _sin_hi(cfg: StftConfig) -> int:
    """One past the last sin column/row kept (k=F-1 is dropped for even n_fft)."""
    return cfg.half_bin - 1 if cfg.n_fft % 2 == 0 else cfg.half_bin


@lru_cache(maxsize=None)
def _matrix_on(cfg: StftConfig, inverse: bool, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The packed windowed (inverse) rDFT matrix of ``stft_frames`` /
    ``istft_frames`` on ``device``, copied there once (a frame loop calls
    them every step, and each copy from the host waits for the device)."""
    hi = _sin_hi(cfg)
    if inverse:
        A, B = _idft_matrices(cfg)
        m = np.concatenate([A, B[1:hi]], axis=0)
    else:
        C, S = _dft_matrices(cfg)
        m = np.concatenate([C, S[:, 1:hi]], axis=1)
    return torch.as_tensor(m, dtype=dtype, device=device)


def stft_frames(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Left-aligned STFT, no implicit padding: [..., samples] -> complex
    [..., T, half_bin] with T = 1 + (samples - n_fft) // hop."""
    F = cfg.half_bin
    hi = _sin_hi(cfg)
    CS = _matrix_on(cfg, False, x.dtype, x.device)
    if cfg.n_fft == 2 * cfg.hop:
        # 50% overlap: frame t is hop-blocks (t, t+1) — two half-frame
        # products instead of materialising the overlapping frames
        T = 1 + (x.shape[-1] - cfg.n_fft) // cfg.hop
        blocks = x[..., : (T + 1) * cfg.hop].reshape(*x.shape[:-1], T + 1, cfg.hop)
        Y = blocks[..., :-1, :] @ CS[: cfg.hop] + blocks[..., 1:, :] @ CS[cfg.hop :]
    else:
        Y = frame_signal(x, cfg.n_fft, cfg.hop) @ CS
    zero = torch.zeros_like(Y[..., :1])
    tail = [zero] if hi == F - 1 else []
    return torch.complex(Y[..., :F], torch.cat([zero, Y[..., F:], *tail], dim=-1))


def istft_frames(Y: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Windowed inverse frames + overlap-add, unnormalised:
    complex [..., T, half_bin] -> [..., n_fft + hop * (T - 1)]."""
    hi = _sin_hi(cfg)
    Yr = Y.real
    AB = _matrix_on(cfg, True, Yr.dtype, Yr.device)
    frames = torch.cat([Yr, Y.imag[..., 1:hi]], dim=-1) @ AB
    return overlap_add(frames, cfg.hop)


def analysis(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Offline analysis, fresh-stream semantics: ``overlap`` zeros are
    prepended so x of length hop * T yields T frames.
    [..., hop * T] -> complex [..., T, half_bin]."""
    return stft_frames(torch.nn.functional.pad(x, (cfg.overlap, 0)), cfg)


def synthesis(Y: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Offline synthesis from the zero output state: the overlap-added
    signal truncated to hop * T samples and scaled by hop / W0.
    complex [..., T, half_bin] -> [..., hop * T]."""
    n_frames = Y.shape[-2]
    y = istft_frames(Y, cfg)
    return y[..., : cfg.hop * n_frames] * cfg.synthesis_gain


def stft_stream(carry: torch.Tensor, chunk: torch.Tensor, cfg: StftConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming analysis step.  carry: [..., overlap] previous input
    tail; chunk: [..., hop * J].  Returns (new_carry, Y [..., J, half_bin])."""
    x = torch.cat([carry, chunk], dim=-1)
    return x[..., -cfg.overlap :], stft_frames(x, cfg)


def istft_stream(carry: torch.Tensor, Y: torch.Tensor, cfg: StftConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming synthesis step.  carry: [..., overlap] previous output
    tail; Y: [..., J, half_bin].  Returns (new_carry, y [..., hop * J])."""
    y = istft_frames(Y, cfg)
    y[..., : cfg.overlap] += carry
    return y[..., -cfg.overlap :], y[..., : -cfg.overlap] * cfg.synthesis_gain


def stft_init_carry(batch_shape, cfg: StftConfig, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, cfg.overlap), dtype=dtype, device=resolve_device(device))


def magphase(D: torch.Tensor, power: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a complex spectrogram into magnitude**power and unit phase."""
    return torch.abs(D) ** power, torch.exp(1j * torch.angle(D))
