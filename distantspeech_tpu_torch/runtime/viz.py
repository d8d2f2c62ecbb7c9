"""Debug plotting (mesh / pmesh / visual).

Counterpart of ``distantspeech_tpu/runtime/viz.py``, on matplotlib's Agg
backend.  Each function takes tensors or arrays (a tensor is detached and
copied to the host first) and returns the figure, or None when matplotlib
is unavailable; ``save`` writes it to a file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:  # pragma: no cover - matplotlib is an optional dependency
        return None


def _host(a) -> Optional[np.ndarray]:
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a)


def mesh(data, title: str = "", save: Optional[str] = None):
    """3-D surface of a [F, T] matrix."""
    plt = _plt()
    if plt is None:
        return None
    data = _host(data)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    F, T = data.shape
    X, Y = np.meshgrid(np.arange(T), np.arange(F))
    ax.plot_surface(X, Y, data, cmap="viridis")
    ax.set_title(title)
    if save:
        fig.savefig(save)
    plt.close(fig)
    return fig


def pmesh(data, title: str = "", save: Optional[str] = None):
    """Pseudocolour image of a [F, T] matrix."""
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots()
    im = ax.pcolormesh(_host(data), shading="auto")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    if save:
        fig.savefig(save)
    plt.close(fig)
    return fig


def visual(x, y=None, fs: int = 16000, save: Optional[str] = None):
    """Waveform (+ enhanced) and spectrogram panel."""
    plt = _plt()
    if plt is None:
        return None
    x, y = _host(x), _host(y)
    n = 2 if y is None else 3
    fig, axes = plt.subplots(n, 1, figsize=(10, 2.5 * n))
    axes[0].plot(np.arange(len(x)) / fs, x)
    axes[0].set_title("input")
    if y is not None:
        axes[1].plot(np.arange(len(y)) / fs, y)
        axes[1].set_title("output")
    spec_ax = axes[-1]
    spec_ax.specgram(y if y is not None else x, Fs=fs, NFFT=256, noverlap=128)
    spec_ax.set_title("spectrogram")
    fig.tight_layout()
    if save:
        fig.savefig(save)
    plt.close(fig)
    return fig
