"""A profiled stretch of calls, reduced to what the per-layer readers and
the result line need.

The reduction follows the port's ``scripts/path_times.py::trace_summary``:
the device is busy where the union of the device operations' intervals
covers the stretch.  A traced run profiles two stretches.  The first
records the device's activity alone, which adds little to a call: the
busy time, the idle share over the stretch's host-clock length and the
kernels' times come from it.  The second records the host's activity too
(every aten op, which slows each call), and each idle gap on the device
there is put down to what the host was doing at its middle: the innermost
host event that covers it.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, List, Tuple

import torch


@dataclasses.dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]]  # (name, start s, end s), sorted by start
    host_ops: List[Tuple[str, float, float]]
    t0: float
    t1: float
    calls: int  # calls in the stretch
    batches: List[int]  # the pool batch of each call
    wall_s: float  # host clock from the first call's issue to the last call's outputs: the stretch's length

    def busy(self, keep: Callable[[str], bool] = lambda name: True) -> float:
        """Seconds in which a device operation that ``keep`` accepts ran."""
        busy, end = 0.0, self.t0
        for name, lo, hi in self.device_ops:
            if keep(name):
                lo = max(lo, end)
                busy, end = busy + max(hi - lo, 0.0), max(end, hi)
        return busy

    def op_seconds(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Summed duration and count of the device operations ``match`` accepts."""
        ds = [hi - lo for name, lo, hi in self.device_ops if match(name)]
        return sum(ds), len(ds)

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the device inside the window."""
        out, end = [], self.t0
        for _, lo, hi in self.device_ops:
            if lo > end:
                out.append((end, lo))
            end = max(end, hi)
        if self.t1 > end:
            out.append((end, self.t1))
        return out

    def _innermost(self, points: List[float]) -> List[str]:
        """For each of the ascending ``points``, the name of the host event
        that covers it and started last (host events nest, so that is the
        innermost), or "(no host event)"."""
        host = sorted(self.host_ops, key=lambda e: e[1])
        active, j, names = [], 0, []
        for t in points:
            while j < len(host) and host[j][1] <= t:
                heapq.heappush(active, (-host[j][1], j))
                j += 1
            while active and host[active[0][1]][2] < t:
                heapq.heappop(active)
            names.append(host[active[0][1]][0] if active else "(no host event)")
        return names

    def top_ops(self, top: int = 10) -> list:
        """The device operations that took most time, [[name, seconds], ...]."""
        by_op = {}
        for name, lo, hi in self.device_ops:
            by_op[name] = by_op.get(name, 0.0) + (hi - lo)
        return _rank(by_op, top)

    def idle_by_host(self, top: int = 10) -> list:
        """The device's idle time by what the host was doing, [[name, seconds], ...]."""
        by_host = {}
        gaps = self.gaps()
        for (lo, hi), name in zip(gaps, self._innermost([0.5 * (lo + hi) for lo, hi in gaps])):
            by_host[name] = by_host.get(name, 0.0) + (hi - lo)
        return _rank(by_host, top)


def _rank(seconds: dict, top: int) -> list:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:top]]


def profile_calls(call: Callable, pool: list, seconds: float, first: int, device, host: bool) -> Trace:
    """Run the closed loop under ``torch.profiler`` for ``seconds`` (host
    clock), the calls on pool batches first, first + 1, ...; return the
    reduced trace.  ``host`` records the host's activity besides the
    device's (off a card, the host's alone)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    act = ([ProfilerActivity.CPU] if host or not on_card else []) + ([ProfilerActivity.CUDA] if on_card else [])
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with profile(activities=act):  # the profiler's own start-up, outside the stretch
        call(pool[first % len(pool)])
        sync()
    batches = []
    with profile(activities=act) as prof:
        t0 = time.perf_counter()
        i = first
        while True:
            b = i % len(pool)
            with record_function("portbench.call"):
                call(pool[b])
            with record_function("portbench.sync"):
                sync()
            batches.append(b)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        lo, hi = e.time_range.start / 1e6, e.time_range.end / 1e6
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if hi <= lo or (on_device and getattr(e, "is_user_annotation", False)):  # a range's shadow on the device
            continue
        (dev if on_device else host).append((e.name, lo, hi))
    dev.sort(key=lambda e: e[1])
    everything = dev + host
    if not everything or (on_card and not dev):
        raise RuntimeError(f"the profiler recorded {len(dev)} device and {len(host)} host events in {len(batches)} calls")
    return Trace(device_ops=dev, host_ops=host, t0=min(e[1] for e in everything), t1=max(e[2] for e in everything),
                 calls=len(batches), batches=batches, wall_s=wall)
