"""One run of a cell: set-up, the measured window, the correctness check,
and, with tracing, a profiled stretch and the per-layer readers.

The loop is closed with one caller, as a batch job or an ASR front end that
waits for its enhanced batch: call the entry point on the next batch of a
pool of distinct batches made on the device from the seed, wait for its
outputs on the device, issue the next call.  The outputs stay on the
device.  Each call's latency runs from an event recorded on the stream as
the call is issued to one recorded after it returns, both on the device's
clock; a call's host-clock time is printed beside it.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np
import torch

from portbench.harness import checks
from portbench.harness.spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "distantspeech_tpu")
TRACE_SECONDS = 2.0  # the profiled stretch after the window of a traced run
WARM_CALLS = 3


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def make_pool(cell: Cell, seed: int, device) -> list:
    scene = cell.scene()
    return [scene.make(seed, i, cell.traffic, cell.config, device) for i in range(cell.traffic["pool"])]


def nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    return sum(nbytes(v) for v in tree)


class Reservoir:
    """A uniform sample of k items from a stream of unknown length, drawn
    from the seed (Vitter's algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, np.random.default_rng(seed % (1 << 63)), []

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.items.append((i, item))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.items[j] = (i, item)


class Stopwatch:
    """Per-call latency: CUDA events on the card, the host clock elsewhere
    (the CPU runs only in the harness's own tests)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def start(self):
        if self.cuda:
            self.ev[0].record()
        self.t = time.perf_counter()

    def stop(self) -> float:
        """Wait for the device; the call's milliseconds."""
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            return self.ev[0].elapsed_time(self.ev[1])
        return (time.perf_counter() - self.t) * 1e3


def window(call, pool: list, seconds: float, sampler: Reservoir, device) -> dict:
    """The closed loop for ``seconds`` of the host clock: calls, their
    latencies (ms, device clock), the host time from issue to return (ms),
    the host time from issue to the outputs' arrival (ms), the window."""
    watch = Stopwatch(device)
    lat, host_entry, host_call = [], [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        watch.start()
        out = call(pool[i % len(pool)])
        t_ret = time.perf_counter()
        lat.append(watch.stop())
        t_done = time.perf_counter()
        host_entry.append((t_ret - watch.t) * 1e3)
        host_call.append((t_done - watch.t) * 1e3)
        sampler.offer(i, out)
        del out
        i += 1
        if t_done - t0 >= seconds:
            break
    return dict(calls=i, window_s=t_done - t0, lat_ms=lat, host_entry_ms=host_entry, host_call_ms=host_call)


def p95(values) -> float:
    return float(np.percentile(values, 95))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", call=None) -> dict:
    """One run; returns the result line as a dict.  ``call`` replaces the
    entry point (the harness's tests break the timed path with it)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state float32, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    entry = cell.entry().load(cell.config, device)
    call = entry if call is None else call(entry)
    pool = make_pool(cell, seed, device)
    pool_bytes = nbytes(pool)
    if on_card:  # the peak from here on: the pool and the program's own work, not the scene's scratch
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(WARM_CALLS):
        call(pool[i % len(pool)])
    if on_card:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s()

    sampler = Reservoir(cell.checks["calls"], seed)
    w = window(call, pool, seconds, sampler, device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: modules of JAX or the JAX package were loaded: {found}")
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) if on_card else 0
    held = sum(nbytes(out) for _, out in sampler.items)
    work_mib = (torch.cuda.max_memory_allocated(device) - pool_bytes - held) / 2**20 if on_card else None

    audio = w["calls"] * cell.audio_s_per_call
    e2e = {"audio_s_per_s": (audio / w["window_s"], "audio-s/s"), "call_ms_p95": (p95(w["lat_ms"]), "ms"),
           "setup_s": (setup_s, "s")}
    log(f"window {w['window_s']:.3f} s, {w['calls']} calls of {cell.traffic['batch']} x {cell.utterance_s} s; "
        f"call ms (device clock) median {statistics.median(w['lat_ms']):.4f} p95 {p95(w['lat_ms']):.4f} "
        f"n {len(w['lat_ms'])}; host clock median {statistics.median(w['host_call_ms']):.4f} "
        f"p95 {p95(w['host_call_ms']):.4f}; entry host ms median {statistics.median(w['host_entry_ms']):.4f}; "
        f"setup {setup_s:.3f} s; pool {pool_bytes / 2**20:.1f} MiB")
    result = {"correct": False, "attempted": w["calls"], "failed": 0}
    if trace:
        tr, host_tr = profile(call, pool, w, device)
        ctx = dict(cell=cell, pool=pool, trace=tr, window=w, host_entry_ms=w["host_entry_ms"], work_mib=work_mib)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]][0]), "unit": e2e[m["name"]][1]}
                             for m in cell.end_to_end}
    result["device"] = device_info(device, peak)
    if trace:
        result["device"].update(busy_s=tr.busy(), window_s=tr.wall_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": host_tr.idle_by_host()}
        del tr, host_tr, ctx

    samples = sampler.items
    del sampler, call, entry
    verdict = checks.judge(cell, pool, samples)
    result["correct"] = verdict["correct"]
    result["failed"] = verdict["failed"]
    result["checks"] = verdict["numbers"]
    return result


def profile(call, pool, w: dict, device):
    """The two profiled stretches after the window ``w``: the device's
    activity alone, then the host's with it.  Prints each stretch's
    host-clock time a call beside the window's, which is what the profiler
    adds to a call."""
    from portbench.harness.tracing import profile_calls

    tr = profile_calls(call, pool, TRACE_SECONDS, w["calls"], device, host=False)
    host_tr = profile_calls(call, pool, TRACE_SECONDS, w["calls"] + tr.calls, device, host=True)
    ms = lambda seconds, calls: 1e3 * seconds / calls
    log(f"traced {tr.calls} calls in {tr.wall_s:.4f} s, the device's activity alone: {ms(tr.wall_s, tr.calls):.4f} "
        f"ms a call, device busy {tr.busy():.4f} s; {host_tr.calls} calls in {host_tr.wall_s:.4f} s with the "
        f"host's activity: {ms(host_tr.wall_s, host_tr.calls):.4f} ms a call; the window "
        f"{ms(w['window_s'], w['calls']):.4f} ms a call")
    return tr, host_tr


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1, "memory_peak_bytes": int(peak)}
