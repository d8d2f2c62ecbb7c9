"""A speech-like burst from the look direction in independent noise.

The target is white noise under a 1.3 Hz on/off envelope of random phase
(so MCRA sees speech come and go), delayed to each mic by its far-field
arrival time from the configuration's look direction (a fractional delay,
applied in frequency); every mic adds independent white noise at
``snr_db`` against the target's mean power over the batch.  Everything is
drawn on ``device`` from a generator seeded with (seed, index).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.draw import generator, toward_mics


def make(seed: int, index: int, traffic: dict, cfg: dict, device) -> dict:
    """Pool batch ``index``: {"x": [B, M, S] float32}."""
    B, M = traffic["batch"], cfg["array"]["n_mics"]
    fs = cfg["array"]["fs"]
    S = int(round(traffic["utterance_s"] * fs))
    p = traffic["scene"]
    gen = generator(seed, index, device)
    phase = torch.rand((B, 1), generator=gen, device=device) * (2 * np.pi)
    t = torch.arange(S, device=device) / fs
    env = (torch.sin(2 * np.pi * p["burst_hz"] * t + phase) > 0).float()
    tgt = env * torch.randn((B, S), generator=gen, device=device)
    noise = torch.randn((B, M, S), generator=gen, device=device)
    noise *= torch.sqrt(torch.mean(tgt**2) / 10 ** (p["snr_db"] / 10))
    return {"x": (toward_mics(tgt, cfg) + noise).contiguous()}
