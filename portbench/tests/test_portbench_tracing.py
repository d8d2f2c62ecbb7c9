"""The reduction of a profiled stretch, and a traced run on the CPU."""

import pytest

from portbench.harness import runner, spec
from portbench.harness.tracing import Trace
from portbench.tests.test_portbench_run import small


def stretch():
    """Two calls: device ops a (0-2), b (1-3) and a (5-6); the host in
    call (0-4, 4.5-7) and, nested, sync (3-4)."""
    return Trace(device_ops=[("a", 0.0, 2.0), ("b", 1.0, 3.0), ("a", 5.0, 6.0)],
                 host_ops=[("call", 0.0, 4.0), ("sync", 3.0, 4.0), ("call", 4.5, 7.0)],
                 t0=0.0, t1=7.0, calls=2, batches=[0, 1], wall_s=8.0)


def test_busy_is_the_union_of_the_device_intervals():
    tr = stretch()
    assert tr.busy() == pytest.approx(4.0)
    assert tr.busy(lambda name: name == "a") == pytest.approx(3.0)
    assert tr.op_seconds(lambda name: name == "a") == (pytest.approx(3.0), 2)


def test_gaps_are_put_down_to_the_innermost_host_event():
    tr = stretch()
    assert tr.gaps() == [(3.0, 5.0), (6.0, 7.0)]
    assert tr.top_ops() == [["a", pytest.approx(3.0)], ["b", pytest.approx(2.0)]]
    # the gap 3-5 has its middle at 4: sync (3-4) and the first call cover it, sync started last
    assert dict((k, v) for k, v in tr.idle_by_host()) == {"sync": pytest.approx(2.0), "call": pytest.approx(1.0)}


@pytest.mark.parametrize("cell", ["ami8.mega.b16", "respeaker4.fused.b16"])
def test_a_traced_run_on_the_cpu(cell):
    result = runner.run(small(cell), 2**31 + 5, 0.3, True, device="cpu")
    c = spec.load_cell(cell)
    assert set(result["metrics"]) <= {m["name"] for m in c.per_layer}
    assert "entry_host_ms" in result["metrics"]
    assert result["device"]["window_s"] > 0 and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["breakdown"]["idle_gaps"] and list(result)[-1] == "checks"


def kernel_trace(launches: int, calls: int) -> Trace:
    ops = [(f"void tdgsc_kernel<3, true>(float const*)", 0.01 * i, 0.01 * i + 0.004) for i in range(launches)]
    return Trace(device_ops=ops, host_ops=[], t0=0.0, t1=0.01 * calls, calls=calls, batches=[i % 2 for i in range(calls)],
                 wall_s=0.01 * calls)


@pytest.mark.parametrize("launches, calls", [(200, 200), (199, 200)])
def test_a_roofline_share_is_per_launch(launches, calls):
    from types import SimpleNamespace

    from portbench.metrics._kernels import roofline_pct
    from portbench.roofline.peaks import bound_s

    cell = SimpleNamespace(config={"kernels": {"tdgsc_kernel": "k5pf"}})
    work = {("k5pf", 0): (1e9, 1e6), ("k5pf", 1): (3e9, 1e6)}
    ctx = dict(trace=kernel_trace(launches, calls), cell=cell, work=work)
    least = (bound_s(1e9, 1e6) + bound_s(3e9, 1e6)) / 2
    assert roofline_pct(ctx, "k5pf") == pytest.approx(100.0 * least / 0.004)


def test_a_roofline_share_refuses_launches_that_do_not_match_the_calls():
    from types import SimpleNamespace

    from portbench.metrics._kernels import roofline_pct

    cell = SimpleNamespace(config={"kernels": {"tdgsc_kernel": "k5pf"}})
    for launches, calls in ((190, 200), (201, 200)):
        ctx = dict(trace=kernel_trace(launches, calls), cell=cell, work={("k5pf", 0): (1e9, 1e6), ("k5pf", 1): (1e9, 1e6)})
        with pytest.raises(RuntimeError):
            roofline_pct(ctx, "k5pf")
