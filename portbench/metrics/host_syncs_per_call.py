"""Blocking host<->device operations a call: the program's ``host_sync.*``
counters over the span stretch (``harness/spans.py``) over its calls."""

from portbench.harness import spans


def read(ctx: dict):
    tr = spans.stretch(ctx)
    if tr is None:
        return None
    return sum(v for k, v in tr.counters.items() if k.startswith("host_sync.")) / tr.calls
