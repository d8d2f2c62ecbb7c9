"""K7's share of its roofline (``roofline/k7.py``) in the traced stretch."""

from portbench.metrics._kernels import roofline_pct


def read(ctx: dict):
    return roofline_pct(ctx, "k7")
