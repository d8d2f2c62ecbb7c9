"""Timing helpers (counterpart of ``distantspeech_tpu/runtime/profiling.py``).

- ``Timer``: host wall-clock bracketing with audio-seconds/s accounting;
- ``slope_per_iter``: per-iteration cost as the median slope over several
  iteration pairs, refusing to report a non-positive or implausible slope;
- ``benchmark``: device time of a CUDA function, measured with CUDA events
  around runs of many calls.  It needs a card: a CPU time is not a device
  time, so there is no CPU fallback;
- ``trace``: a ``torch.profiler`` trace of a block, written as a Chrome
  trace;
- ``stage_metrics``: a per-stage report of energies and speech presence;
- ``span``: a ``torch.profiler`` user range around a stage of an entry
  point, opened only while a profiler runs;
- ``count`` / ``counters`` / ``reset_counters``: the program's one registry
  of event counts (``launch.<kernel>`` for each kernel launch,
  ``host_sync.<site>`` for each blocking host<->device operation).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

_profiling = torch._C._autograd._profiler_enabled
_enter_range = torch._C._autograd._record_function_with_args_enter
_exit_range = torch._C._autograd._record_function_with_args_exit
_NO_SPAN = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}


class _Range:
    """The user-scope range that ``torch.profiler.record_function`` opens,
    opened directly: ``record_function`` goes through two operator calls,
    8-9 us of host time on an H100's host even where no profiler callback
    records it (the device-only profiler), against 3 us here."""

    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = _enter_range(self.name)

    def __exit__(self, *exc):
        _exit_range(self.handle)


def span(name: str):
    """A ``torch.profiler`` user range ``name`` (what ``record_function``
    records) while a profiler runs; else one shared null context, so that a
    span costs a check when nothing records it."""
    return _Range(name) if _profiling() else _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of every counter counted since the last reset."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


@dataclass
class Timer:
    name: str = "stage"
    audio_seconds: float = 0.0
    elapsed: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.elapsed if self.elapsed else float("inf")


class TimingError(RuntimeError):
    """A throughput measurement could not be made trustworthy."""


def slope_per_iter(
    run: Callable[[int], float],
    pairs=((1, 4), (2, 6), (3, 8)),
    retries: int = 2,
    min_per_iter: float = 0.0,
    log: Optional[Callable[[str], None]] = None,
) -> tuple:
    """Median of ``(run(n2) - run(n1)) / (n2 - n1)`` over the pairs, where
    ``run(n)`` executes and synchronises n iterations and returns seconds.
    The slope cancels the fixed overhead of a run.  Any non-positive or
    non-finite slope, or a median below ``min_per_iter``, restarts the
    measurement; after ``retries`` restarts it raises ``TimingError``.
    Returns ``(per_iter_seconds, n_retries)``."""
    if len(pairs) < 3:
        raise ValueError(f"need >= 3 iteration pairs for a robust median, got {len(pairs)}")
    last = None
    for attempt in range(retries + 1):
        slopes = []
        for n1, n2 in pairs:
            t1, t2 = run(n1), run(n2)
            slopes.append((t2 - t1) / (n2 - n1))
        per = float(np.median(slopes))
        if all(np.isfinite(s) and s > 0.0 for s in slopes) and per >= min_per_iter:
            return per, attempt
        last = slopes
        if log is not None:
            log(f"slope_per_iter retry {attempt + 1}/{retries}: slopes={['%.3g' % s for s in slopes]}")
    raise TimingError(
        f"unreliable timing after {retries + 1} attempts: slopes={last} "
        f"(min_per_iter={min_per_iter:.3g}s); refusing to report a throughput"
    )


def cuda_seconds(fn: Callable, *args, n: int = 1) -> float:
    """Device seconds of ``n`` back-to-back calls of ``fn(*args)``, from CUDA
    events on the current stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_seconds needs a CUDA device")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def benchmark(fn: Callable, *args, iters: int = 8, warmup: int = 2) -> Dict[str, float]:
    """Device time per call of ``fn(*args)`` (CUDA events, slope over
    iteration pairs).  Returns {'per_call_s', 'calls_per_s', 'retries'}."""
    if not torch.cuda.is_available():
        raise RuntimeError("benchmark measures device time and needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    base = max(1, iters // 4)
    pairs = ((base, iters), (base + 1, iters + base), (base + 2, iters + 2 * base))
    per, retries = slope_per_iter(lambda n: cuda_seconds(fn, *args, n=n), pairs=pairs)
    return {"per_call_s": per, "calls_per_s": 1.0 / per, "retries": float(retries)}


@contextlib.contextmanager
def trace(logdir: str = "profiler-trace"):
    """``torch.profiler`` trace (CPU, and CUDA where there is a card) around a
    block, written as a Chrome trace into ``logdir``; yields the profiler
    (its ``key_averages()`` are the sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def stage_metrics(name: str, signal_in: np.ndarray, signal_out: np.ndarray, p: Optional[np.ndarray] = None) -> Dict:
    """Structured per-stage report: energies, crude SNR-gain proxy, SPP stats."""
    ein = float(np.mean(np.square(signal_in)))
    eout = float(np.mean(np.square(signal_out)))
    m: Dict[str, Any] = {
        "stage": name,
        "energy_in": ein,
        "energy_out": eout,
        "energy_ratio_db": 10.0 * np.log10(eout / ein) if ein > 0 else float("-inf"),
    }
    if p is not None:
        m["p_mean"] = float(np.mean(p))
        m["p_active_frac"] = float(np.mean(p > 0.5))
    return m
