"""Host milliseconds a call in the program's ``ds.wpe_srp.wpe`` span (the
host's issue of WPE's recursion: on a card one CUDA graph's launch), in the
span stretch (``harness/spans.py``)."""

from portbench.harness import spans
from portbench.metrics.wpe_device_ms import WPE


def read(ctx: dict):
    tr = spans.stretch(ctx)
    seconds = tr.span_seconds(WPE).get(WPE, 0.0) if tr is not None else 0.0
    return 1e3 * seconds / tr.calls if seconds > 0 else None
