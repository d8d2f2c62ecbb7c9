"""Shared helpers for the example scripts: scene synthesis, metrics and the
device choice.

Twin of ``examples/_common.py`` for the PyTorch port: every demo
synthesizes its scene with the image-source simulator so the examples run
anywhere, and each accepts ``--wav path`` to process a real multichannel
recording instead.  The demos run on the CUDA card; ``--cpu`` runs them on
the CPU.
"""

import argparse
import os
import sys

import numpy as np

# run from anywhere: the package lives in the repo root above examples_torch/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def speech_like(fs: int, dur: float, seed: int = 0) -> np.ndarray:
    """Amplitude-modulated filtered noise: nonstationary, speech-band."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * dur)) / fs
    env = (np.sin(2 * np.pi * 0.7 * t + 0.5) > -0.3).astype(float)
    k = np.hanning(9)
    x = np.convolve(rng.standard_normal(len(t)), k / k.sum(), "same") * env
    return x.astype(np.float32)


def make_scene(n_mics=4, spacing=0.032, fs=16000, dur=4.0, snr=20.0, sir=10.0,
               source_angle=90.0, interf_angle=20.0, seed=0):
    """Reverberant multichannel mixture + geometry + dry source."""
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.sim import RoomConfig, generate_scene

    rng = np.random.default_rng(seed + 1)
    src = speech_like(fs, dur, seed)
    geom = ArrayGeometry.linear(n_mics, spacing, fs=fs)
    mix = generate_scene(
        src, geom.mic_loc, interference=rng.standard_normal(len(src)),
        source_angle=source_angle, source_distance=2.0,
        interf_angle=interf_angle, interf_distance=2.0,
        snr=snr, sir=sir, cfg=RoomConfig(max_order=1), seed=seed + 2,
    ).astype(np.float32)
    return mix, geom, src


def si_sdr(est, ref: np.ndarray, search_shift: int = 400) -> float:
    """Scale-invariant SDR in dB, maximised over small alignment shifts."""
    from distantspeech_tpu_torch.stats.evaluation import si_sdr as _si_sdr

    est = host(est)
    return max(_si_sdr(est[l:], ref[: len(ref) - l]) for l in range(0, search_shift, 8))


def host(a) -> np.ndarray:
    """A tensor (on any device) or an array as a host array."""
    import torch

    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def device_args(p: argparse.ArgumentParser) -> argparse.Namespace:
    """Parse with ``--cpu``; ``args.device`` is the CPU or the CUDA card
    (which raises when there is none)."""
    from distantspeech_tpu_torch import resolve_device

    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    args = p.parse_args()
    args.device = resolve_device("cpu" if args.cpu else None)
    return args


def demo_args(description: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--wav", default=None, help="multichannel wav to process instead of the synthetic scene")
    p.add_argument("--save", default=None, help="write the enhanced output here")
    return device_args(p)


def load_or_make(args, **scene_kw):
    """Either load ``--wav`` (channels-first) or synthesize a scene."""
    if args.wav:
        from distantspeech_tpu_torch.array.geometry import ArrayGeometry
        from distantspeech_tpu_torch.runtime.io import load_audio

        x = load_audio(args.wav)
        if x.ndim == 1:
            x = x[None]
        elif x.shape[0] > x.shape[1]:  # wav files are [S, C]
            x = x.T
        geom = ArrayGeometry.linear(x.shape[0], scene_kw.get("spacing", 0.032))
        return np.ascontiguousarray(x, dtype=np.float32), geom, None
    mix, geom, src = make_scene(**scene_kw)
    return mix, geom, src


def maybe_save(args, y, fs: int = 16000):
    if args.save:
        from distantspeech_tpu_torch.runtime.io import save_audio

        y = host(y)
        save_audio(args.save, y / (np.max(np.abs(y)) + 1e-9) * 0.9, fs=fs)
        print(f"wrote {args.save}")
