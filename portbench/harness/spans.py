"""The program's own spans and counters in a profiled stretch, and what the
``program_span`` and ``program_counter`` readers compute from them.

The program opens ``ds.*`` spans (``runtime.profiling.span``) at the
boundaries of its layers: an entry point, its host preparation
(``ds.prep.*``), the inputs of each kernel and each launch.  The profiler
puts them on the same timeline as the device's operations, and gives each
span a shadow on the device: the interval from the first to the last device
operation that the span launched while it was the innermost span.  The
program also counts, in one registry, each kernel launch (``launch.*``) and
each blocking host<->device operation (``host_sync.*``).

A stretch here is a third profiled stretch after the window, besides the two
of ``tracing.py``, whose device-only stretch records no span: the profiler
records the host's user scope alone (the ``record_function`` ranges, no aten
operation) and the device's activity.  It runs once a run, made by the
first reader that asks for it, and only where the program has the counter
registry: a program that predates the spans has none, and every reader of
them then finds nothing.

A shadow is put down to the call whose span launched it (the profiler gives
a span and its shadow one id).  The host's and the device's timestamps
drift apart within a stretch (on an H100, by 0.02-0.3 ms and up to 2.5 ms
over a 2 s stretch).  So the device's idle gaps are put down to
host spans only after each call's device operations are moved by that
call's own offset, measured at its end: the harness's synchronisation
returns just after the call's last device operation ends.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import statistics
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from portbench.harness.tracing import Trace

ENTRY_PREFIX = "ds."  # the program's spans
CALL, SYNC = "portbench.call", "portbench.sync"  # the harness's spans around one call and the wait after it
EPS = 1e-9  # s: a shadow's ends are its operations' own


@dataclasses.dataclass
class SpanTrace(Trace):
    """A stretch whose ``host_ops`` hold the spans (and the CUDA runtime's
    calls on a card), with each span's device shadow and the program's
    counter deltas over the stretch."""

    # (span name, start s, end s, the traced call it belongs to), sorted by start
    shadows: List[Tuple[str, float, float, int]] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def span_seconds(self, prefix: str = ENTRY_PREFIX) -> Dict[str, float]:
        """Host seconds in the spans whose names start with ``prefix``, by name."""
        out: Dict[str, float] = {}
        for name, lo, hi in self.host_ops:
            if name.startswith(prefix):
                out[name] = out.get(name, 0.0) + (hi - lo)
        return out

    def _within(self, intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
        """The device operations that lie inside any of ``intervals``, once each, sorted by start."""
        starts = [lo for _, lo, _ in self.device_ops]
        picked = set()
        for lo, hi in intervals:
            j = bisect.bisect_left(starts, lo - EPS)
            while j < len(starts) and starts[j] < hi + EPS:
                if self.device_ops[j][2] <= hi + EPS:
                    picked.add(j)
                j += 1
        return [self.device_ops[j][1:] for j in sorted(picked)]

    def shadow_busy(self, names: Iterable[str]) -> float:
        """Device seconds covered by the operations inside the shadows of the
        spans ``names`` (the union of their intervals)."""
        names = set(names)
        return _union(self._within((lo, hi) for name, lo, hi, _ in self.shadows if name in names))

    def _extents(self) -> Dict[int, Tuple[float, float]]:
        ext: Dict[int, Tuple[float, float]] = {}
        for name, lo, hi, i in self.shadows:
            if name.startswith(ENTRY_PREFIX) and i >= 0:
                a, b = ext.get(i, (lo, hi))
                ext[i] = (min(a, lo), max(b, hi))
        return ext

    def entry_extents(self) -> List[Tuple[float, float]]:
        """For each traced call, the entry span's device shadow: from the first
        to the last device operation of any ``ds.`` span of the call (a span's
        own shadow leaves out what its inner spans launched)."""
        ext = self._extents()
        return [ext[i] for i in sorted(ext)]

    def clock_offsets(self) -> List[Tuple[float, float]]:
        """For each call, (its first device operation's start, the seconds by
        which the device's timestamps run ahead of the host's there): the
        call's last device operation's end less the end of the harness's
        synchronisation after it, as the median over the call and its two
        neighbours on each side (the drift is smooth; a stretch's last call
        at times reads milliseconds off)."""
        syncs = sorted(hi for name, _, hi in self.host_ops if name == SYNC)
        ext = self._extents()
        calls = [i for i in sorted(ext) if i < len(syncs)]
        ahead = [ext[i][1] - syncs[i] for i in calls]
        return [(ext[i][0], statistics.median(ahead[max(k - 2, 0):k + 3])) for k, i in enumerate(calls)]

    def inner_idle(self) -> float:
        """Device seconds idle inside the entry span's device shadows."""
        return sum((hi - lo) - _union(_clip(self._within([(lo, hi)]), lo, hi)) for lo, hi in self.entry_extents())

    def idle_by_span(self, top: int = 10) -> list:
        """The device's idle time by the innermost ``ds.`` or ``portbench.``
        span covering each idle gap's middle, [[name, seconds], ...]."""
        spans = [e for e in self.host_ops if e[0].startswith((ENTRY_PREFIX, "portbench."))]
        offsets = self.clock_offsets()
        starts = [t for t, _ in offsets]

        def host_time(t: float) -> float:  # by the offset of the call that holds t, or of the call before it
            return t - offsets[max(bisect.bisect_right(starts, t) - 1, 0)][1] if offsets else t

        dev = [(name, host_time(lo), host_time(lo) + (hi - lo)) for name, lo, hi in self.device_ops]
        return dataclasses.replace(self, host_ops=spans, device_ops=dev).idle_by_host(top)


def _clip(ops: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in ops]


def _union(ops: List[Tuple[float, float]]) -> float:
    """Seconds covered by the intervals, sorted by start."""
    busy, end = 0.0, float("-inf")
    for lo, hi in ops:
        lo = max(lo, end)
        busy, end = busy + max(hi - lo, 0.0), max(end, hi)
    return busy


@contextlib.contextmanager
def _user_scope_only():
    """While a profiler starts in this block, its host callbacks fire for
    ``record_function`` ranges alone (``torch.profiler`` takes no scope, its
    enabling function does)."""
    from torch.autograd import profiler as ap

    enable = ap._enable_profiler
    ap._enable_profiler = functools.partial(enable, scopes={torch._C._profiler.RecordScope.USER_SCOPE})
    try:
        yield
    finally:
        ap._enable_profiler = enable


def profile_spans(call: Callable, pool: list, seconds: float, first: int, device,
                  counters: Callable[[], Dict[str, int]]) -> SpanTrace:
    """Run the closed loop under ``torch.profiler`` for ``seconds`` (host
    clock), recording the spans and the device's activity; return the
    stretch with the spans' shadows and the counters' deltas over it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    act = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with _user_scope_only(), profile(activities=act):  # the profiler's own start-up, outside the stretch
        call(pool[first % len(pool)])
        sync()
    batches = []
    with _user_scope_only(), profile(activities=act) as prof:
        before = counters()
        t0 = time.perf_counter()
        i = first
        while True:
            b = i % len(pool)
            with record_function(CALL):
                call(pool[b])
            with record_function(SYNC):
                sync()
            batches.append(b)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        after = counters()
    dev, host, shadows, span_ids = [], [], [], {}
    for e in prof.events():
        lo, hi = e.time_range.start / 1e6, e.time_range.end / 1e6
        if hi <= lo:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            (shadows if e.is_user_annotation else dev).append((e.name, lo, hi, e.id))
        else:
            host.append((e.name, lo, hi))
            if e.is_user_annotation:
                span_ids[e.id] = lo
    calls = sorted(lo for name, lo, _ in host if name == CALL)
    at = lambda t: bisect.bisect_right(calls, t) - 1  # noqa: E731  (the call running at host time t)
    # a shadow's call is its span's, found by their shared id; failing that, the call its start falls in
    unmatched = sum(i not in span_ids for _, _, _, i in shadows)
    if unmatched:
        print(f"spans: {unmatched} of {len(shadows)} shadows have no span of their id", file=sys.stderr, flush=True)
    shadows = sorted(((name, lo, hi, at(span_ids.get(i, lo))) for name, lo, hi, i in shadows), key=lambda e: e[1])
    dev = sorted(((name, lo, hi) for name, lo, hi, _ in dev), key=lambda e: e[1])
    everything = dev + host
    if not everything:
        raise RuntimeError(f"the profiler recorded no event in {len(batches)} calls")
    deltas = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return SpanTrace(device_ops=dev, host_ops=host, t0=min(e[1] for e in everything),
                     t1=max(e[2] for e in everything), calls=len(batches), batches=batches, wall_s=wall,
                     shadows=shadows, counters=deltas)


def stretch(ctx: dict) -> Optional[SpanTrace]:
    """The run's span stretch, made on the first call and kept in ``ctx``;
    None where the program has no counter registry (nor spans)."""
    if "span_trace" not in ctx:
        ctx["span_trace"] = _make(ctx)
    return ctx["span_trace"]


def _make(ctx: dict) -> Optional[SpanTrace]:
    from portbench.entries import _program
    from portbench.harness.runner import TRACE_SECONDS, log

    if _program.counters() is None:
        return None
    cell, pool = ctx["cell"], ctx["pool"]
    device = next(iter(pool[0].values())).device
    call = cell.entry().load(cell.config, device)
    first = ctx["window"]["calls"] + ctx["trace"].calls
    tr = profile_spans(call, pool, TRACE_SECONDS, first, device, _program.counters)
    inner = tr.inner_idle()
    ahead = [1e6 * d for _, d in tr.clock_offsets()] or [0.0]
    log(f"spans: {tr.calls} calls in {tr.wall_s:.4f} s, {1e3 * tr.wall_s / tr.calls:.4f} ms a call; device idle "
        f"{100.0 * (1.0 - tr.busy() / tr.wall_s):.3f}% of the stretch, {100.0 * inner / tr.wall_s:.3f}% inside "
        f"the entry span; device clock - host clock, us: first call {ahead[0]:.1f}, median "
        f"{statistics.median(ahead):.1f}, last call {ahead[-1]:.1f}; counters {tr.counters}; "
        f"idle by program span {tr.idle_by_span()}")
    return tr
