"""The port's streaming driver on the CPU: every stream factory against the
JAX package's on the same seeded chunks, within the bar of JAX's own
streaming-vs-offline test for that factory; each stream against the port's
offline path; the overflow contract under a fake clock; and a steady chunk
that moves no host data to the device."""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.runtime import streaming as jst
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.runtime import streaming as tst

M = 4
# JAX's bars (tests/test_runtime_stream.py): absolute, or relative to max |want| ("scale")
BARS = {"enhance": (1e-5, False), "gsc": (1e-4, True), "fdgsc": (1e-4, True), "subband_gsc": (1e-4, True),
        "wpe": (1e-4, True), "tdgsc": (1e-6, False), "full_stack": (1e-6, False)}
FACTORIES = sorted(tst.STREAM_FACTORIES)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests add no parallel work of their own to
    a run that spreads files over workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(name, chunk, n_chunks, seed):
    """0.1-scaled standard normal: M mic rows, or M - 1 mics and the far-end row for the full stack."""
    return (np.random.default_rng(seed).standard_normal((M, chunk * n_chunks)) * 0.1).astype(np.float32)


def _mics(name):
    return M - 1 if name == "full_stack" else M


def _assert_within(name, got, want):
    bar, scaled = BARS[name]
    n = min(len(got), len(want))
    atol = bar * max(float(np.max(np.abs(want[:n]))), 1e-9) if scaled else bar
    np.testing.assert_allclose(got[:n], want[:n], atol=atol, rtol=0)


def test_factories_match_jax_registry():
    assert FACTORIES == sorted(jst.STREAM_FACTORIES)


@pytest.mark.parametrize("name", FACTORIES)
def test_stream_matches_jax(name):
    """512-sample chunks (a multiple of every factory's frame length here), 4 of them."""
    chunk, n_chunks = 512, 4
    x = _input(name, chunk, n_chunks, seed=3)
    jproc = jst.STREAM_FACTORIES[name](JGeometry.linear(_mics(name), 0.032), (90.0, 0.0), chunk_size=chunk)
    tproc = tst.STREAM_FACTORIES[name](TGeometry.linear(_mics(name), 0.032), (90.0, 0.0), chunk_size=chunk,
                                       device="cpu")
    want = jproc.run(jst.wav_chunks(x, chunk))
    got = tproc.run(tst.wav_chunks(x, chunk))
    assert got.shape == want.shape == (chunk * n_chunks,) and got.dtype == np.float32
    _assert_within(name, got, want)
    assert tproc.chunks == n_chunks and len(tproc.latencies) == n_chunks


def _offline(name, x, geom):
    from distantspeech_tpu_torch.beamform import (
        FdGscConfig, GscConfig, SubbandGscConfig, TdGscConfig, fdgsc_process, gsc_process, subband_gsc_process,
        tdgsc_process,
    )
    from distantspeech_tpu_torch.beamform.enhance import enhance_process
    from distantspeech_tpu_torch.derev import WpeConfig, wpe_process
    from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process

    ang = (np.pi / 2, 0.0)
    if name == "enhance":
        return enhance_process(x, geom, (90.0, 0.0), device="cpu")
    if name == "gsc":
        return gsc_process(x, geom, ang, GscConfig(n_mics=M, normalize_aic=True, spp_rel_diag=1e-5), device="cpu")
    if name == "fdgsc":
        return fdgsc_process(x, geom, ang, FdGscConfig(n_mics=M), device="cpu")[0]
    if name == "subband_gsc":
        return subband_gsc_process(x, geom, ang, SubbandGscConfig(n_mics=M), device="cpu")[0]
    if name == "wpe":
        return wpe_process(x, WpeConfig(n_channels=M), device="cpu")
    if name == "tdgsc":
        return tdgsc_process(x, geom, ang, TdGscConfig(n_mics=M), device="cpu")[0]
    return full_stack_process(x[:-1], x[-1], geom, ang, FullStackConfig(n_mics=M - 1), device="cpu")[0]


@pytest.mark.parametrize("name", FACTORIES)
def test_stream_matches_port_offline(name):
    """What phase 18 of chip_smoke.py holds on the card, at a CPU size."""
    chunk, n_chunks = 1024, 2
    x = _input(name, chunk, n_chunks, seed=5)
    geom = TGeometry.linear(_mics(name), 0.032)
    got = tst.STREAM_FACTORIES[name](geom, (90.0, 0.0), chunk_size=chunk, device="cpu").run(tst.wav_chunks(x, chunk))
    _assert_within(name, got, _offline(name, x, geom).numpy())


class _FakeClock:
    """perf_counter stub advancing a fixed dt per call."""

    def __init__(self, dt):
        self.dt = dt
        self.t = 0.0

    def __call__(self):
        self.t += self.dt
        return self.t


def _identity_proc(chunk_size, fs=16000):
    return tst.StreamingProcessor(lambda s, c: (s, c), (), chunk_size=chunk_size, fs=fs, device="cpu")


def test_overflow_contract(monkeypatch):
    """A chunk slower than chunk_size / fs counts as an overflow; the report
    leaves the warmup chunks out of ``overflows`` (JAX's test, on the port)."""
    x = np.zeros((2, 1024 * 5), dtype=np.float32)

    monkeypatch.setattr(tst.time, "perf_counter", _FakeClock(0.100))  # 100 ms > the 64 ms budget
    proc = _identity_proc(1024)
    proc.run(tst.wav_chunks(x, 1024))
    assert proc.chunks == 5 and proc.overflows == 5
    report = proc.latency_report(skip_warmup=1)
    assert report["overflows"] == 4 and report["overflows_incl_warmup"] == 5
    assert report["warmup_excluded"] == 1

    monkeypatch.setattr(tst.time, "perf_counter", _FakeClock(0.001))
    proc = _identity_proc(1024)
    out = proc.run(tst.wav_chunks(x, 1024))
    assert out.shape == x.shape and proc.chunks == 5 and proc.overflows == 0
    report = proc.latency_report(skip_warmup=1)
    assert report["chunks"] == 5 and report["overflows"] == 0
    assert abs(report["budget_ms"] - 64.0) < 1e-9
    assert abs(report["p50_ms"] - 1.0) < 0.2 and abs(report["max_ms"] - 1.0) < 0.2
    assert report["realtime_factor"] > 50
    # the skip is capped so one chunk remains
    assert proc.latency_report(skip_warmup=10)["warmup_excluded"] == 4


def test_latency_report_keys_match_jax():
    x = np.zeros((2, 1024 * 3), dtype=np.float32)
    jproc = jst.StreamingProcessor(lambda s, c: (s, c), (), chunk_size=1024)
    jproc.run(jst.wav_chunks(x, 1024))
    proc = _identity_proc(1024)
    proc.run(tst.wav_chunks(x, 1024))
    assert list(proc.latency_report(2)) == list(jproc.latency_report(2))


def test_sink_and_chunk_size_checks():
    proc = _identity_proc(256)
    got = []
    assert proc.run(tst.wav_chunks(np.ones((1, 1000), np.float32), 256), sink=got.append) is None
    assert len(got) == 3 and all(o.shape == (1, 256) for o in got)  # the tail is dropped
    with pytest.raises(ValueError, match="multiple of hop"):
        tst.make_enhance_stream(TGeometry.linear(M, 0.032), chunk_size=1000, device="cpu")
    with pytest.raises(ValueError, match="multiple of frame_len"):
        tst.make_tdgsc_stream(TGeometry.linear(M, 0.032), chunk_size=1000, device="cpu")


class _HostTraffic(TorchFunctionMode):
    """Counts the calls that move host data to the device or read the device
    from the host: each is a synchronous transfer on the card.  A Python
    number set into a 0-d view is one too (PyTorch copies it from the host
    where the view has the scalar's shape, and fills otherwise)."""

    MAKES = {"as_tensor", "tensor", "from_numpy"}  # a host value made a tensor (not a tensor passed through)
    READS = {"item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        self.n += name in self.READS or (name in self.MAKES and not isinstance(args[0], torch.Tensor))
        if name == "__setitem__" and not isinstance(args[2], torch.Tensor):
            self.n += args[0][args[1]].dim() == 0  # the mode is off inside its own handler
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", FACTORIES)
def test_steady_chunk_moves_no_host_data(name):
    """After the first chunk, a step copies no constant to the device and
    reads nothing back: the DFT matrices, windows, bounds and gates are on
    the device, and the frame counters are host ints."""
    proc = tst.STREAM_FACTORIES[name](TGeometry.linear(_mics(name), 0.032), (90.0, 0.0), chunk_size=1024,
                                      device="cpu")
    x = torch.as_tensor(_input(name, 1024, 1, seed=7))
    proc.state, _ = proc.step(proc.state, x)
    mode = _HostTraffic()
    with mode:
        proc.state, y = proc.step(proc.state, x)
    assert mode.n == 0 and y.shape == (1024,)
