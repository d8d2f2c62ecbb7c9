"""What the scenes share: the seeded generator and the fractional delay
of a source to each mic."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.plain import delays_s

_SEED_BITS = 48


def generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` for pool batch ``index`` (< 256) of ``seed``
    (any whole number; its low 48 bits count)."""
    if not 0 <= index < 256:
        raise ValueError(f"pool index must be in [0, 256), got {index}")
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed % (1 << _SEED_BITS)) << 8) | index)
    return gen


def toward_mics(src: torch.Tensor, cfg: dict) -> torch.Tensor:
    """A far-field source [B, S] as each mic hears it from the look
    direction: [B, M, S], mic m delayed by its arrival time tau_m (in
    frequency, over a zero-padded length, so nothing wraps into the
    signal)."""
    B, S = src.shape
    fs = cfg["array"]["fs"]
    tau = delays_s(cfg["array"], cfg["look_deg"])  # [M] seconds, either sign
    pad = 2 * int(np.ceil(np.abs(tau).max() * fs)) + 16
    n = S + pad
    omega = 2 * np.pi * np.fft.rfftfreq(n, 1.0 / fs)
    shift = torch.as_tensor(np.exp(-1j * omega[None, :] * tau[:, None]), dtype=torch.complex64, device=src.device)
    spec = torch.fft.rfft(torch.nn.functional.pad(src, (pad // 2, pad - pad // 2)), n)  # [B, n // 2 + 1]
    return torch.fft.irfft(spec[:, None, :] * shift, n)[..., pad // 2 : pad // 2 + S]
