"""Host milliseconds a call in the program's ``ds.prep.*`` spans (the
steering planes, the alignment filters: built on the host and copied to the
device), in the span stretch (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx: dict):
    tr = spans.stretch(ctx)
    prep = tr.span_seconds("ds.prep.") if tr is not None else {}
    return 1e3 * sum(prep.values()) / tr.calls if prep else None
