"""Griffin-Lim phase reconstruction on the framework's STFT.

Counterpart of ``distantspeech_tpu/transform/griffin_lim.py``: iterate
synthesise -> re-analyse -> restore the known magnitude, batched over the
leading axes.  As in the JAX package, without ``init_phase`` the magnitude
is cast to complex64 whatever its precision, so that loop runs in
complex64; with ``init_phase`` it keeps the magnitude's precision.
"""

from __future__ import annotations

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.transform.stft import StftConfig, analysis, synthesis


def griffin_lim(mag, cfg: StftConfig = StftConfig(256, 128), n_iter: int = 50, init_phase=None,
                device=None) -> torch.Tensor:
    """Reconstruct a signal from an STFT magnitude.  mag: [..., T, F].
    Returns y [..., hop * T] on ``device``.  ``init_phase``: optional
    [..., T, F] complex initialisation (default: zero phase)."""
    dev = resolve_device(device)
    mag = torch.as_tensor(mag, device=dev)
    if init_phase is None:
        X = mag.to(torch.complex64)
    else:
        init_phase = torch.as_tensor(init_phase, device=dev)
        X = mag * init_phase / torch.clamp(torch.abs(init_phase), min=1e-12)
    for _ in range(n_iter):
        Y = analysis(synthesis(X, cfg), cfg)
        phase = Y / torch.clamp(torch.abs(Y), min=1e-12).to(Y.dtype)
        X = mag.to(Y.dtype) * phase
    return synthesis(X, cfg)
