"""Batched image-source room simulation on the card (the gpuRIR analogue).

Counterpart of ``distantspeech_tpu/sim/ism.py``: the Allen-Berkley
image-source model as one batched tensor program in float32.

- The image lattice of a shoebox is ``(2 (2N + 1))^3`` positions whose
  reflection counts are constants given ``max_order``; images beyond order
  N stay in the tensor with amplitude 0 (static shapes).
- The band-limited impulse of each image, ``amp * hann(u) * sinc(u - frac)``
  on its ``sinc_width``-sample support, is evaluated densely over the whole
  time axis and masked: no scatter, just elementwise work, vectorised over
  sources and mics and accumulated over blocks of ``block`` images (JAX
  maps over sources and scans over the blocks).
- Sources are taken in groups so that one block's [sources, M, block, L]
  temporaries stay under ``_MAX_ELEMS`` elements.
- The numbers follow ``sim.room.image_source_rir`` (the host path) to
  float32 rounding: the same Hann samples at integer offsets from
  ``floor(delay)``, the same sinc centred at the fractional delay, the same
  ``1 / (4 pi max(d, 1e-2))`` spreading.
"""

from __future__ import annotations

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.sim.room import RoomConfig

_MAX_ELEMS = 1 << 26  # elements of one [sources, M, block, L] temporary


def _axis_reflections(max_order: int) -> np.ndarray:
    """Per-axis reflection counts for the (even, odd) parity images."""
    n = np.arange(-max_order, max_order + 1)
    return np.concatenate([2 * np.abs(n), np.abs(2 * n - 1)])


def default_rir_length(cfg: RoomConfig, sinc_width: int = 81) -> int:
    """Upper bound on the RIR length for ``cfg`` (host-side)."""
    if cfg.rir_length is not None:
        return int(cfg.rir_length)
    reach = (2 * cfg.max_order + 1) * np.linalg.norm(cfg.size)
    return int(np.ceil(reach / cfg.c * cfg.fs)) + sinc_width + 1


def _axis_positions(x: torch.Tensor, L_ax: float, max_order: int) -> torch.Tensor:
    """Image coordinates along one axis: x [B] -> [B, 2 (2N + 1)]."""
    n = torch.arange(-max_order, max_order + 1, dtype=x.dtype, device=x.device)
    return torch.cat([2.0 * n * L_ax + x[:, None], 2.0 * n * L_ax - x[:, None]], dim=-1)


def _rir_group(srcs: torch.Tensor, mics: torch.Tensor, gain: torch.Tensor, cfg: RoomConfig, L: int,
               sinc_width: int, block: int) -> torch.Tensor:
    """RIRs of a group of sources: srcs [B, 3], mics [M, 3] -> [B, M, L]."""
    N = cfg.max_order
    px = _axis_positions(srcs[:, 0], cfg.size[0], N)
    py = _axis_positions(srcs[:, 1], cfg.size[1], N)
    pz = _axis_positions(srcs[:, 2], cfg.size[2], N)
    B, nx, ny, nz = px.shape[0], px.shape[1], py.shape[1], pz.shape[1]
    P = torch.stack([
        px[:, :, None, None].expand(B, nx, ny, nz),
        py[:, None, :, None].expand(B, nx, ny, nz),
        pz[:, None, None, :].expand(B, nx, ny, nz),
    ], dim=-1).reshape(B, -1, 3)  # [B, I, 3]

    d = torch.linalg.norm(P[:, None, :, :] - mics[None, :, None, :], dim=-1)  # [B, M, I]
    amp = gain / (4.0 * np.pi * torch.clamp(d, min=1e-2))
    delay = d * (cfg.fs / cfg.c)  # fractional samples: d / c * fs as one product, as XLA compiles it

    I = P.shape[1]
    Ip = int(np.ceil(I / block) * block)
    amp = torch.nn.functional.pad(amp, (0, Ip - I)).reshape(B, mics.shape[0], Ip // block, block)
    delay = torch.nn.functional.pad(delay, (0, Ip - I)).reshape(B, mics.shape[0], Ip // block, block)

    half = sinc_width // 2
    t = torch.arange(L, dtype=torch.float32, device=srcs.device)
    rir = torch.zeros((B, mics.shape[0], L), dtype=torch.float32, device=srcs.device)
    for a, dl in zip(amp.unbind(-2), delay.unbind(-2)):  # [B, M, block] each
        di = torch.floor(dl)
        frac = dl - di
        u = t - di[..., None]  # [B, M, block, L] integer offsets
        inside = (u >= -half) & (u <= half)
        # np.hanning(W) sampled at the integer offset u + half from the window's start
        hann = 0.5 * (1.0 - torch.cos(2.0 * np.pi * (u + half) / (sinc_width - 1)))
        taps = a[..., None] * hann * torch.sinc(u - frac[..., None])
        rir = rir + torch.sum(torch.where(inside, taps, 0.0), dim=2)
    return rir


def batched_rir(
    srcs,
    mics,
    cfg: RoomConfig = RoomConfig(),
    rir_length: int | None = None,
    sinc_width: int = 81,
    block: int = 64,
    device=None,
) -> torch.Tensor:
    """RIRs for every (source, mic) pair.  srcs: [B, 3] source positions;
    mics: [M, 3] -> rir [B, M, L] float32 on ``device`` (L:
    ``default_rir_length(cfg)`` unless given)."""
    dev = resolve_device(device)
    L = rir_length or default_rir_length(cfg, sinc_width)
    N = cfg.max_order
    srcs = torch.as_tensor(srcs, device=dev).to(torch.float32)
    mics = torch.as_tensor(mics, device=dev).to(torch.float32)

    # the reflection counts are constants of the lattice
    r_ax = _axis_reflections(N).astype(np.float32)
    R = (r_ax[:, None, None] + r_ax[None, :, None] + r_ax[None, None, :]).reshape(-1)
    gain = torch.as_tensor(np.where(R <= N, float(cfg.reflection) ** R, 0.0).astype(np.float32), device=dev)

    group = max(1, _MAX_ELEMS // (mics.shape[0] * block * L))
    return torch.cat([_rir_group(srcs[i : i + group], mics, gain, cfg, L, sinc_width, block)
                      for i in range(0, srcs.shape[0], group)])


def batched_propagation(
    signals,
    srcs,
    mics,
    cfg: RoomConfig = RoomConfig(),
    rir_length: int | None = None,
    sinc_width: int = 81,
    device=None,
) -> torch.Tensor:
    """Convolve each dry source with its RIRs by FFT.  signals: [B, S];
    srcs: [B, 3]; mics: [M, 3] -> wet [B, M, S] on ``device``."""
    dev = resolve_device(device)
    rir = batched_rir(srcs, mics, cfg, rir_length=rir_length, sinc_width=sinc_width, device=dev)
    signals = torch.as_tensor(signals, device=dev)
    S = signals.shape[-1]
    n = S + rir.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    X = torch.fft.rfft(signals, n=nfft, dim=-1)  # [B, F]
    H = torch.fft.rfft(rir, n=nfft, dim=-1)  # [B, M, F]
    y = torch.fft.irfft(X[:, None, :] * H, n=nfft, dim=-1)
    return y[..., :S]
