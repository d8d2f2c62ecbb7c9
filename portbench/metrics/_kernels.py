"""What the kernel readers share: a kernel's device seconds in the traced
stretch, and its share of its roofline there.  The configuration file maps
each of its kernels (by the name the trace gives it) to its count under
``roofline/``."""

from __future__ import annotations

import re
import sys

from portbench.harness.spec import module
from portbench.roofline.peaks import bound_s


def matcher(kernel: str):
    """Accepts the trace names of a kernel, its template arguments and
    signature included (``void aec_kernel<512>(float const*, ...)``)."""
    pat = re.compile(rf"(^|[\s:]){re.escape(kernel)}\b")
    return lambda name: bool(pat.search(name))


def work(ctx: dict, count: str, b: int):
    """(operations, bytes) of one launch of the kernel counted by
    ``roofline/<count>.py`` on pool batch b, worked out once a run."""
    cache = ctx.setdefault("work", {})
    if (count, b) not in cache:
        cache[count, b] = module("roofline", count).work(ctx["pool"][b], ctx["cell"].config)
    return cache[count, b]


def roofline_pct(ctx: dict, count: str):
    """100 x (the least seconds of the traced launches) / (the kernel's
    device seconds in them), or None where the trace holds no launch of it.
    ``count`` names the kernel's module under roofline/.  A launch's least
    seconds are the mean over the traced calls' batches: the profiler, when
    it records the device's activity alone, at times loses the record of
    the stretch's last launch, so a launch short of one a call is allowed."""
    tr = ctx["trace"]
    kernel = next(k for k, c in ctx["cell"].config["kernels"].items() if c == count)
    seconds, launches = tr.op_seconds(matcher(kernel))
    if launches == 0:
        return None
    if not tr.calls - max(2, tr.calls // 100) <= launches <= tr.calls:
        raise RuntimeError(f"{kernel}: {launches} launches in {tr.calls} traced calls; one a call expected")
    if launches < tr.calls:
        print(f"{kernel}: {launches} launch records in {tr.calls} traced calls", file=sys.stderr, flush=True)
    least = {b: bound_s(*work(ctx, count, b)) for b in set(tr.batches)}
    return 100.0 * launches * sum(least[b] for b in tr.batches) / len(tr.batches) / seconds
