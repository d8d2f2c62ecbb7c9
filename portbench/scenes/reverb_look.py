"""A far-field talker in a reverberant room, as the REVERB challenge's
simulated data (SimData) places one: three rooms, a near and a far
distance.

Per utterance, drawn on ``device`` from a generator seeded with (seed,
index): the source is white noise under a ``burst_hz`` on/off envelope of
random phase (``look_burst``'s speech-like burst) at an azimuth on a 1 deg
grid, elevation 0, delayed to each mic by its far-field arrival time (a
fractional delay, in frequency).  T60 is drawn from ``t60_s`` and the
direct-to-reverberant ratio from ``drr_db``.  Each mic hears the source
through its own room response: a unit direct path, then from
``tail_from_ms`` on white noise under an exponential decay that falls 60 dB
in T60, scaled so that the direct path's energy over the tail's is the DRR.
Each mic adds independent white noise ``snr_db`` below the utterance's
reverberant signal (its mean power over the mics).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.draw import generator
from portbench.reference.plain import mic_positions


def draw(gen: torch.Generator, B: int, p: dict, device) -> dict:
    """Each utterance's azimuth (deg), T60 (s) and DRR (dB), [B] float64."""
    pick = lambda values: torch.as_tensor(values, dtype=torch.float64, device=device)[  # noqa: E731
        torch.randint(len(values), (B,), generator=gen, device=device)]
    az = torch.randint(360, (B,), generator=gen, device=device).to(torch.float64)
    return {"az_deg": az, "t60_s": pick(p["t60_s"]), "drr_db": pick(p["drr_db"])}


def responses(gen: torch.Generator, t60_s: torch.Tensor, drr_db: torch.Tensor, M: int, p: dict, fs: int) -> torch.Tensor:
    """Room responses [B, M, L] float32, L the longest T60's samples."""
    lengths = torch.round(t60_s * fs)  # [B]
    L = int(round(max(p["t60_s"]) * fs))
    n = torch.arange(L, dtype=torch.float64, device=t60_s.device)
    decay = torch.exp(-n * np.log(1e3) / lengths[:, None]) * ((n >= p["tail_from_ms"] * fs / 1e3) & (n < lengths[:, None]))
    h = torch.randn((len(t60_s), M, L), generator=gen, device=t60_s.device, dtype=torch.float64) * decay[:, None]
    h *= torch.sqrt(10 ** (-drr_db[:, None, None] / 10) / torch.sum(h**2, dim=-1, keepdim=True))
    h[..., 0] = 1.0
    return h.float()


def far_field(src: torch.Tensor, az_deg: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Sources [B, S] as each mic hears them from azimuths [B] (deg),
    elevation 0: [B, M, S], mic m delayed by -(r_m . u) / c, in frequency
    over a zero-padded length so that nothing wraps into the signal."""
    array = cfg["array"]
    B, S = src.shape
    fs = array["fs"]
    r = torch.as_tensor(mic_positions(array)[:, :2], device=src.device)  # [M, 2]
    az = torch.deg2rad(az_deg)
    tau = -(torch.stack([torch.cos(az), torch.sin(az)], dim=-1) @ r.T) / array["sound_speed"]  # [B, M]
    radius = float(np.max(np.linalg.norm(mic_positions(array), axis=-1)))
    pad = 2 * int(np.ceil(radius / array["sound_speed"] * fs)) + 16
    n = S + pad
    omega = 2 * np.pi * torch.fft.rfftfreq(n, 1.0 / fs, dtype=torch.float64, device=src.device)
    shift = torch.exp(-1j * omega * tau[..., None]).to(torch.complex64)  # [B, M, n // 2 + 1]
    spec = torch.fft.rfft(torch.nn.functional.pad(src, (pad // 2, pad - pad // 2)), n)
    return torch.fft.irfft(spec[:, None, :] * shift, n)[..., pad // 2 : pad // 2 + S]


def parts(seed: int, index: int, traffic: dict, cfg: dict, device) -> dict:
    """Pool batch ``index`` in parts: the reverberant talker "clean" and the
    mics' noise [B, M, S] float32, the room responses "h", and the draws."""
    B, M = traffic["batch"], cfg["array"]["n_mics"]
    fs = cfg["array"]["fs"]
    S = int(round(traffic["utterance_s"] * fs))
    p = traffic["scene"]
    gen = generator(seed, index, device)
    drawn = draw(gen, B, p, device)
    phase = torch.rand((B, 1), generator=gen, device=device) * (2 * np.pi)
    t = torch.arange(S, device=device) / fs
    env = (torch.sin(2 * np.pi * p["burst_hz"] * t + phase) > 0).float()
    src = env * torch.randn((B, S), generator=gen, device=device)
    h = responses(gen, drawn["t60_s"], drawn["drr_db"], M, p, fs)
    n = S + h.shape[-1] - 1
    clean = torch.fft.irfft(torch.fft.rfft(far_field(src, drawn["az_deg"], cfg), n) * torch.fft.rfft(h, n), n)[..., :S]
    noise = torch.randn((B, M, S), generator=gen, device=device)
    noise *= torch.sqrt(torch.mean(clean**2, dim=(1, 2), keepdim=True) / 10 ** (p["snr_db"] / 10))
    return dict(drawn, clean=clean, noise=noise, h=h)


def make(seed: int, index: int, traffic: dict, cfg: dict, device) -> dict:
    """Pool batch ``index``: {"x": [B, M, S] float32}."""
    q = parts(seed, index, traffic, cfg, device)
    return {"x": (q["clean"] + q["noise"]).contiguous()}
