"""The share of the span stretch (``harness/spans.py``, its host-clock
length) in which the device sat idle inside a call's entry span shadow:
from the call's first device operation to its last.  The rest of the idle
share lies between calls (before the first operation of one, after the last
of the one before)."""

from portbench.harness import spans


def read(ctx: dict):
    tr = spans.stretch(ctx)
    if tr is None or not tr.entry_extents():
        return None
    return 100.0 * tr.inner_idle() / tr.wall_s
