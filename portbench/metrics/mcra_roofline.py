"""The MCRA lane kernel's share of its roofline (``roofline/mcra.py``) in the traced stretch."""

from portbench.metrics._kernels import roofline_pct


def read(ctx: dict):
    return roofline_pct(ctx, "mcra")
