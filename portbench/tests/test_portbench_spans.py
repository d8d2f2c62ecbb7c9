"""The span stretch's reductions and the four readers of the program's spans
and counters, on a hand-built stretch; each reader finds nothing where its
spans or counters are missing."""

import dataclasses

import pytest
import torch

from portbench.harness import spans
from portbench.harness.spans import SpanTrace
from portbench.metrics import front_end_device_ms, host_syncs_per_call, inner_idle_pct, prep_host_ms

READERS = (prep_host_ms, host_syncs_per_call, front_end_device_ms, inner_idle_pct)


def stretch(ahead: float = 0.0, **kw) -> SpanTrace:
    """Two calls of the full stack over 10 s of host clock, the device's
    timestamps ``ahead`` of the host's.

    Call 1 (host 0-4, its wait 4-4.5): the front end launches 0.8-0.9 and
    2.0-2.5 itself and, in its alignment span, the copy 1.0-1.5; the entry
    span launches the kernel 3.0-4.5.  Call 2 (host 5-7.5, its wait 7.5-8):
    the alignment copy 6.0-6.5, K6's inputs 6.6-6.8, the kernel 7.0-8.0."""
    host = [
        ("portbench.call", 0.0, 4.0), ("ds.full_stack_process", 0.1, 3.9), ("ds.k5.front_end", 0.2, 2.0),
        ("ds.prep.alignment", 0.3, 0.5), ("portbench.sync", 4.0, 4.5),
        ("portbench.call", 5.0, 7.5), ("ds.full_stack_process", 5.1, 7.4), ("ds.prep.alignment", 5.2, 5.4),
        ("ds.k6.inputs", 5.5, 5.6), ("portbench.sync", 7.5, 8.0),
    ]
    dev = [("notch", 0.8, 0.9), ("copy", 1.0, 1.5), ("fir", 2.0, 2.5), ("kernel", 3.0, 4.5),
           ("copy", 6.0, 6.5), ("cat", 6.6, 6.8), ("kernel", 7.0, 8.0)]
    shadows = [("ds.k5.front_end", 0.8, 2.5, 0), ("ds.prep.alignment", 1.0, 1.5, 0),
               ("ds.full_stack_process", 3.0, 4.5, 0), ("ds.prep.alignment", 6.0, 6.5, 1),
               ("ds.k6.inputs", 6.6, 6.8, 1), ("ds.full_stack_process", 7.0, 8.0, 1)]
    args = dict(device_ops=[(n, lo + ahead, hi + ahead) for n, lo, hi in dev], host_ops=host, t0=0.0, t1=8.0,
                calls=2, batches=[0, 1], wall_s=10.0,
                shadows=[(n, lo + ahead, hi + ahead, i) for n, lo, hi, i in shadows],
                counters={"host_sync.prep.alignment": 2, "launch.fused_aec": 2})
    args.update(kw)
    return SpanTrace(**args)


@pytest.mark.parametrize("ahead", [0.0, 0.3, -0.2])
def test_the_reductions_by_hand(ahead):
    tr = stretch(ahead)
    assert [d for _, d in tr.clock_offsets()] == [pytest.approx(ahead)] * 2
    assert tr.span_seconds("ds.prep.") == {"ds.prep.alignment": pytest.approx(0.4)}
    # the front end's own shadow holds its alignment copy: 0.1 + 0.5 + 0.5, then K6's inputs 0.2
    assert tr.shadow_busy(front_end_device_ms.FRONT_END) == pytest.approx(1.3)
    assert tr.entry_extents() == [(pytest.approx(0.8 + ahead), pytest.approx(4.5 + ahead)),
                                  (pytest.approx(6.0 + ahead), pytest.approx(8.0 + ahead))]
    # idle inside: 3.7 - 2.6 and 2.0 - 1.7
    assert tr.inner_idle() == pytest.approx(1.4)
    # with the offset taken out, each gap goes to the span that covers its middle and started last: 0-0.8
    # and 4.5-6.0 to the alignment, 0.9-1.0 and 1.5-2.0 to the front end, 2.5-3.0, 6.5-6.6, 6.8-7.0 to the entry
    assert dict(tr.idle_by_span()) == {"ds.prep.alignment": pytest.approx(2.3), "ds.k5.front_end": pytest.approx(0.6),
                                       "ds.full_stack_process": pytest.approx(0.8)}


def test_the_readers_by_hand():
    ctx = {"span_trace": stretch()}
    assert prep_host_ms.read(ctx) == pytest.approx(1e3 * 0.4 / 2)
    assert host_syncs_per_call.read(ctx) == pytest.approx(1.0)
    assert front_end_device_ms.read(ctx) == pytest.approx(1e3 * 1.3 / 2)
    assert inner_idle_pct.read(ctx) == pytest.approx(100.0 * 1.4 / 10.0)


def test_the_readers_find_nothing_without_the_program_s_spans_or_counters():
    for reader in READERS:
        assert reader.read({"span_trace": None}) is None
    bare = stretch(host_ops=[("portbench.call", 0.0, 4.0), ("portbench.call", 5.0, 9.0)], shadows=[], counters={})
    ctx = {"span_trace": bare}
    assert prep_host_ms.read(ctx) is None and front_end_device_ms.read(ctx) is None
    assert inner_idle_pct.read(ctx) is None
    assert host_syncs_per_call.read(ctx) == 0.0  # the registry is there and counted no sync


def test_no_stretch_where_the_program_has_no_registry(monkeypatch):
    from portbench.entries import _program

    monkeypatch.setattr(_program, "counters", lambda: None)
    ctx = {}
    assert spans.stretch(ctx) is None and ctx == {"span_trace": None}


def test_a_stretch_on_the_cpu_records_the_spans_and_the_counters():
    counts = {"host_sync.x": 0}

    def call(batch):
        with torch.profiler.record_function("ds.entry"):
            with torch.profiler.record_function("ds.prep.x"):
                counts["host_sync.x"] += 1
            return batch["x"] * 2

    tr = spans.profile_spans(call, [{"x": torch.ones(3)}], 0.05, 0, "cpu", lambda: dict(counts))
    assert tr.calls >= 1 and tr.counters == {"host_sync.x": tr.calls}
    assert set(tr.span_seconds()) == {"ds.entry", "ds.prep.x"} and not tr.device_ops and not tr.shadows
    # the user scope alone: no aten operation on the host
    assert {name for name, _, _ in tr.host_ops} == {"ds.entry", "ds.prep.x", "portbench.call", "portbench.sync"}


def test_one_call_off_the_drift_takes_its_neighbours_offset():
    """A call whose end reads far off (a stretch's last call at times does)
    is moved by the median of its neighbours' offsets."""
    tr = stretch()
    host = [(n, lo, 7.5 + 2.0 if (n, lo) == ("portbench.sync", 7.5) else hi) for n, lo, hi in tr.host_ops]
    calls = [("portbench.call", 10.0 + k, 10.5 + k) for k in range(3)] + [
        ("portbench.sync", 10.5 + k, 11.0 + k) for k in range(3)]
    shadows = tr.shadows + [("ds.full_stack_process", 10.2 + k, 11.0 + k, 2 + k) for k in range(3)]
    tr = dataclasses.replace(tr, host_ops=host + calls, shadows=shadows)
    # call 2 waits 1.5 s past its last operation: -1.5 s on its own, 0 as the median of its neighbours
    assert [d for _, d in tr.clock_offsets()] == [0.0, 0.0, 0.0, 0.0, 0.0]
