"""K10's share of its roofline (``roofline/k10.py``, the products at the
tensor cores' 3xTF32 rate) in the traced stretch."""

from portbench.metrics._kernels import roofline_pct


def read(ctx: dict):
    return roofline_pct(ctx, "k10")
