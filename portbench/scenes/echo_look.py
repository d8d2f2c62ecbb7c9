"""An echo scene: a far end played into the room, its echo, and a target
from the look direction.

The far end is white noise x 0.5; its echo runs through one 256-tap
decaying path (white taps under exp(-n / 40)) and reaches every mic alike;
the target is white noise x 0.5 under a 1.3 Hz on/off envelope of random
phase, delayed to each mic by its far-field arrival time from the
configuration's look direction; every mic adds independent white noise x
0.05.  Everything is drawn on ``device`` from a generator seeded with
(seed, index).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.draw import generator, toward_mics


def make(seed: int, index: int, traffic: dict, cfg: dict, device) -> dict:
    """Pool batch ``index``: {"x": [B, M, S], "far": [B, S]}, float32."""
    B, M = traffic["batch"], cfg["array"]["n_mics"]
    fs = cfg["array"]["fs"]
    S = int(round(traffic["utterance_s"] * fs))
    p = traffic["scene"]
    gen = generator(seed, index, device)
    far = torch.randn((B, S), generator=gen, device=device) * p["far_gain"]
    n_ir = p["echo_taps"]
    ir = torch.randn(n_ir, generator=gen, device=device) * torch.exp(-torch.arange(n_ir, device=device) / p["echo_decay"])
    n = S + n_ir - 1
    echo = torch.fft.irfft(torch.fft.rfft(far, n) * torch.fft.rfft(ir, n), n)[:, :S]
    phase = torch.rand((B, 1), generator=gen, device=device) * (2 * np.pi)
    t = torch.arange(S, device=device) / fs
    env = (torch.sin(2 * np.pi * p["burst_hz"] * t + phase) > 0).float()
    tgt = env * torch.randn((B, S), generator=gen, device=device) * p["target_gain"]
    noise = torch.randn((B, M, S), generator=gen, device=device) * p["noise_gain"]
    x = echo[:, None] + toward_mics(tgt, cfg) + noise
    return {"x": x.contiguous(), "far": far.contiguous()}
