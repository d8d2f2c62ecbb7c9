"""Audio file I/O.

Counterpart of ``distantspeech_tpu/runtime/io.py``, copied: pure numpy and
``scipy.io.wavfile``, no tensor.  int16 wavs normalise to [-1, 1) by the
int16 max in ``load_audio`` and by 32768 in ``load_wav_dir``, as in the
JAX package; pcm files are raw little-endian int16 / 32768; directory
loaders stack per-channel files into [M, L] truncated to the shortest.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
from scipy.io import wavfile


def find_files(filepath: str, file_type: str) -> List[str]:
    """All files under ``filepath`` ending with ``file_type``, sorted."""
    return [os.path.join(filepath, n) for n in sorted(os.listdir(filepath)) if n.endswith(file_type)]


def load_audio(filename: str) -> np.ndarray:
    """Read one wav; int16 scaled by 1/32767."""
    _, audio = wavfile.read(filename)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / float(np.iinfo(np.int16).max)
    return audio


def save_audio(filename: str, audio: np.ndarray, fs: int = 16000) -> None:
    """Write float audio as an int16 wav; audio [S] or [S, C]."""
    if not filename.endswith(".wav"):
        filename = filename + ".wav"
    wavfile.write(filename, fs, (np.asarray(audio) * np.iinfo(np.int16).max).astype(np.int16))


def pcmread(filepath: str) -> np.ndarray:
    """Raw int16 pcm -> float in [-1, 1)."""
    return np.memmap(filepath, dtype="h", mode="r") / 32768.0


def load_pcm(filepath: str) -> np.ndarray:
    """Stack all .pcm files in a directory into [M, L]."""
    names = find_files(filepath, ".pcm")
    data = [pcmread(n) for n in names]
    L = len(data[0])
    return np.stack([d[:L] for d in data], axis=0)


def load_wav_dir(filepath: str) -> Tuple[np.ndarray, int]:
    """Stack all .wav files in a directory into [M, L_min]; int16 / 32768."""
    names = find_files(filepath, ".wav")
    chans = []
    sr = 16000
    for n in names:
        sr, x = wavfile.read(n)
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        chans.append(np.asarray(x, dtype=np.float64))
    L = min(len(c) for c in chans)
    return np.stack([c[:L] for c in chans], axis=0), sr
