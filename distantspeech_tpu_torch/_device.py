"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card.  The CPU
is used only when a caller asks for it (``device="cpu"``, as the tests do);
a missing card is an error, never a silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def wrapper_input(x) -> torch.Tensor:
    """A kernel wrapper's input: a tensor stays where it is; anything else
    goes to ``resolve_device()``, the card."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device())
