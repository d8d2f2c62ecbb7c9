"""K5's (with the postfilter) share of its roofline (``roofline/k5pf.py``) in the traced stretch."""

from portbench.metrics._kernels import roofline_pct


def read(ctx: dict):
    return roofline_pct(ctx, "k5pf")
