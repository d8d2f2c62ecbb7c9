"""Device milliseconds a call of WPE's recursion: the union of the device
operations inside the shadow of the program's ``ds.wpe_srp.wpe`` span, in
the span stretch (``harness/spans.py``)."""

from portbench.harness import spans

WPE = "ds.wpe_srp.wpe"


def read(ctx: dict):
    tr = spans.stretch(ctx)
    busy = tr.shadow_busy([WPE]) if tr is not None else 0.0
    return 1e3 * busy / tr.calls if busy > 0 else None
