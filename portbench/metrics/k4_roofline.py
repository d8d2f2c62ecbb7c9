"""K4's share of its roofline (``roofline/k4.py``) in the traced stretch."""

from portbench.metrics._kernels import roofline_pct


def read(ctx: dict):
    return roofline_pct(ctx, "k4")
