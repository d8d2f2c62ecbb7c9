"""The port's spans and counters (``runtime.profiling``): a span is a shared
null context unless a profiler runs; under one, the two benchmarked entry
points record their ``ds.`` spans, nested as the layers are; the plain
versions that CPU tensors run count nothing.  The tests marked ``card``
run one call of each path on the card: the exact counts, and the spans on
the device trace's clock.  On the card, which has no JAX (imported by this
folder's conftest.py), run them with
``python -m pytest --noconftest tests/test_torch_tracing.py -m card``."""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process
from distantspeech_tpu_torch.runtime import profiling
from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process
from distantspeech_tpu_torch.runtime.profiling import count, counters, reset_counters, span


def _enhance(x):
    return enhance_process(x, ArrayGeometry.linear(x.shape[1], 0.032), (90.0, 0.0), EnhanceConfig(), backend="mega",
                           inv_mode="rank1", device=x.device)


def _full_stack(x):
    return full_stack_process(x, x[:, 0], ArrayGeometry.linear(4, 0.032), (np.pi / 2, 0.0), FullStackConfig(n_mics=4),
                              backend="fused", device=x.device)


def _input(path, device):
    """One utterance: 2 mics x 6 hops of 128 for the enhancer, 4 mics x 6 frames of 256 for the full stack."""
    shape = (1, 2, 128 * 6) if path == "enhance_mega" else (1, 4, 256 * 6)
    return torch.as_tensor(np.random.default_rng(0).standard_normal(shape).astype(np.float32), device=device)


# the spans each path's CPU run passes through, and each one's innermost ds. parent
PATHS = {
    "enhance_mega": (_enhance, {"ds.enhance_process": None, "ds.prep.steering": "ds.enhance_process"}),
    "full_stack_fused": (_full_stack, {
        "ds.full_stack_process": None, "ds.k7.prepare": "ds.full_stack_process",
        "ds.k6.inputs": "ds.full_stack_process", "ds.k5.front_end": "ds.full_stack_process",
        "ds.prep.alignment": "ds.k5.front_end", "ds.k5.kernel_inputs": "ds.full_stack_process",
    }),
}


def test_without_a_profiler_a_span_is_the_shared_null_context():
    assert span("ds.a") is span("ds.b") is profiling._NO_SPAN
    with span("ds.a") as inside:
        assert inside is None


def test_under_a_profiler_a_span_is_a_user_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("ds.a"):
            with torch.profiler.record_function("ds.b"):
                pass
    assert span("ds.a") is profiling._NO_SPAN
    # the same kind of event as record_function's, with its nesting
    events = {e.name: e for e in prof.events()}
    assert set(events) == {"ds.a", "ds.b"} and all(e.is_user_annotation for e in events.values())
    assert events["ds.b"].cpu_parent is events["ds.a"]


def test_counters_count_until_reset_and_snapshot():
    reset_counters()
    count("launch.k")
    count("host_sync.site", 2)
    snap = counters()
    count("launch.k")
    assert snap == {"launch.k": 1, "host_sync.site": 2} and counters() == {"launch.k": 2, "host_sync.site": 2}
    reset_counters()
    assert counters() == {}


def _ds_parent(event):
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith("ds."):
        parent = parent.cpu_parent
    return parent.name if parent is not None else None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cpu_paths_record_their_spans_nested_and_count_nothing(path):
    run, want = PATHS[path]
    x = _input(path, "cpu")
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(x)
    got = {}
    for e in prof.events():
        if e.name.startswith("ds."):
            got.setdefault(e.name, set()).add(_ds_parent(e))
    assert got == {name: {parent} for name, parent in want.items()}
    assert counters() == {}  # no launch.* and no host_sync.* from CPU tensors


# one call's counts on the card: each kernel once, each blocking copy once
CARD_COUNTS = {
    "enhance_mega": {"launch.fused_enhance_full": 1, "host_sync.prep.steering": 1},
    "full_stack_fused": {"launch.fused_aec": 1, "launch.fused_kws": 1, "launch.gsc_front": 1,
                         "launch.fused_tdgsc": 1, "host_sync.prep.alignment": 1},
}


@pytest.mark.card
@pytest.mark.parametrize("path", sorted(PATHS))
def test_one_call_on_the_card_counts_each_launch_and_each_host_sync(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run, x = PATHS[path][0], _input(path, "cuda")
    run(x)  # the first call copies the cached constants to the card
    torch.cuda.synchronize()
    reset_counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert counters() == CARD_COUNTS[path]
    assert len(syncs) == sum(v for k, v in counters().items() if k.startswith("host_sync.")), [
        f"{w.filename}:{w.lineno}" for w in syncs]


# each launch span's kernel, and the other device operations its launch may make (K6 zeroes its FIFO)
LAUNCH_KERNELS = {
    "enhance_mega": {"ds.k4.launch": "fused_enhance_full_kernel"},
    "full_stack_fused": {"ds.k7.launch": "aec_kernel", "ds.k6.launch": "kws_kernel", "ds.k5.launch": "tdgsc_kernel"},
}


@pytest.mark.card
@pytest.mark.parametrize("path", sorted(PATHS))
def test_on_the_card_a_launch_span_starts_before_its_kernel_and_its_shadow_covers_it(path):
    """The spans share the device trace's clock, up to one offset for the
    whole profiled stretch (seen up to 0.17 ms), measured at the call's end:
    the host's synchronisation returns just after the device's last
    operation ends.  Each launch span starts on the host before its kernel
    starts on the device, and its device shadow spans exactly what it
    launched (its kernel, and a fill where it zeroes a scratch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run, x = PATHS[path][0], _input(path, "cuda")
    run(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(x)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in on_card if not e.is_user_annotation]
    sync_end = max(e.time_range.end for e in events if e.name == "cudaDeviceSynchronize")
    ahead = max(e.time_range.end for e in ops) - sync_end  # us the device's clock runs ahead
    for name, kernel in LAUNCH_KERNELS[path].items():
        (host,) = [e for e in events if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
        (k,) = [e for e in ops if kernel in e.name]
        (shadow,) = [e for e in on_card if e.is_user_annotation and e.name == name]
        assert host.time_range.start < k.time_range.start - ahead, (name, host.time_range, k.time_range, ahead)
        inside = [e for e in ops if shadow.time_range.start <= e.time_range.start
                  and e.time_range.end <= shadow.time_range.end]
        assert k in inside and all(e is k or "fill" in e.name.lower() or "memset" in e.name.lower() for e in inside), [
            e.name for e in inside]
        assert shadow.time_range.start == min(e.time_range.start for e in inside)
        assert shadow.time_range.end == max(e.time_range.end for e in inside)
