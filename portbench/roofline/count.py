"""Counting the elementwise operations a plain function executes."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

OP_NAMES = {
    "add", "sub", "mul", "div", "where", "minimum", "maximum", "clamp", "exp", "log", "lt", "le", "gt", "sqrt",
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__", "__truediv__", "__rtruediv__",
    "__neg__", "__gt__", "__lt__", "__le__", "__and__", "__or__", "__pow__", "__rpow__",
}
REDUCTIONS = {"sum", "amax"}


class _Count(TorchFunctionMode):
    def __init__(self, per_element: bool):
        super().__init__()
        self.n, self.per_element = 0, per_element

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name in OP_NAMES:
            self.n += out.numel() if self.per_element and isinstance(out, torch.Tensor) else 1
        elif self.per_element and name in REDUCTIONS:
            self.n += args[0].numel()
        return out


def counted(fn, *args, per_element: bool = False, **kw) -> int:
    """Run ``fn`` and count the elementwise torch operations it executes:
    one a call, or (``per_element``) one an output element, a reduction
    one an input element.  Matrix products are not counted: the bounds
    count each transform as a real FFT instead."""
    mode = _Count(per_element)
    with mode:
        fn(*args, **kw)
    return mode.n


def frame_ops(run, T: int) -> int:
    """Elementwise operations of the last of T frames of a frame loop,
    counted per element: ``run(n)`` runs it over n frames."""
    return counted(run, T, per_element=True) - counted(run, T - 1, per_element=True)
