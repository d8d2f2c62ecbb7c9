"""Device milliseconds a call of the full stack's torch front end: the union
of the device operations inside the shadows of the spans around the AEC's
pre-emphasis, K6's inputs, K5's front end and K5's inputs, in the span
stretch (``harness/spans.py``)."""

from portbench.harness import spans

FRONT_END = ("ds.k7.prepare", "ds.k6.inputs", "ds.k5.front_end", "ds.k5.kernel_inputs")


def read(ctx: dict):
    tr = spans.stretch(ctx)
    busy = tr.shadow_busy(FRONT_END) if tr is not None else 0.0
    return 1e3 * busy / tr.calls if busy > 0 else None
