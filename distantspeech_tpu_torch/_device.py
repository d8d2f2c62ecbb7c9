"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card.  The CPU
is used only when a caller asks for it (``device="cpu"``, as the tests do);
a missing card is an error, never a silent fallback.  ``check_unroll``
vets the JAX scan hint that the entry points accept at JAX's position.
"""

from __future__ import annotations

import operator

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


def check_unroll(unroll) -> None:
    """JAX's ``lax.scan`` unroll hint, taken at JAX's position so that calls
    written for the JAX package run unchanged.  It is numerically inert and
    unused here (the frame loops run eagerly), but a value JAX would refuse
    is refused, so that a ``backend`` passed in its old place fails loudly."""
    try:
        operator.index(unroll)
    except TypeError:
        raise TypeError(f"unroll must be an int or a bool, got {unroll!r}; pass backend= by keyword") from None


def wrapper_input(x) -> torch.Tensor:
    """A kernel wrapper's input: a tensor stays where it is; anything else
    goes to ``resolve_device()``, the card."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device())
