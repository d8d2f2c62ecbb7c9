"""The cell ``reverb8.wpe_srp.b8``: it resolves from its files; its scene
is seeded and has the T60, DRR and SNR it draws; its counts; its readers
on a hand-built stretch; a small run on the CPU, sound and broken; and the
TF32 control fails its limits."""

import math

import numpy as np
import pytest
import torch

from portbench.harness import checks, runner, spec
from portbench.harness.spans import SpanTrace
from portbench.metrics import wpe_device_ms, wpe_host_ms, wpe_roofline
from portbench.reference.plain import Precision
from portbench.roofline import k10, mcra, peaks, wpe
from portbench.tests.test_portbench_run import altered_answer, altered_blocks, half_batch

CELL = "reverb8.wpe_srp.b8"
NEW = {"wpe_device_ms", "wpe_host_ms", "wpe_roofline", "k10_roofline", "mcra_roofline"}
SHARED = {"entry_host_ms", "device_idle_pct", "work_mem_mib", "host_syncs_per_call", "inner_idle_pct"}


def test_the_cell_resolves_with_its_configuration_at_published_widths():
    c = spec.load_cell(CELL)
    assert c.chips == 1 and c.config["name"] == "reverb8_wpe_srp" and c.config["reduced"] == []
    w = c.config["wpe"]
    assert (w["num_bands"], w["hop"], w["n_channels"], w["filter_len"], w["delay"], w["forgetting_factor"]) == (
        512, 128, 8, 10, 3, 0.9999)
    assert c.config["kernels"] == {"srp_kernel": "k10", "mcra_kernel": "mcra"}
    assert {m["name"] for m in c.per_layer} == NEW | SHARED
    assert {m["name"] for m in c.end_to_end} == {"audio_s_per_s", "call_ms_p95", "setup_s"}
    t = c.traffic
    pool_bytes = t["pool"] * t["batch"] * c.config["array"]["n_mics"] * t["utterance_s"] * c.config["array"]["fs"] * 4
    assert pool_bytes >= 4 * 50e6 and c.checks["calls"] >= 1


def small(batch=2, seconds=0.5):
    c = spec.load_cell(CELL)
    c.traffic.update(batch=batch, utterance_s=seconds)
    return c


def test_the_scene_is_seeded():
    c = small()
    seed = 2**31 + 4321
    a, b = (c.scene().make(seed, 1, c.traffic, c.config, "cpu")["x"] for _ in range(2))
    assert a.dtype == torch.float32 and a.shape == (2, 8, 8000) and torch.equal(a, b)
    assert not torch.equal(a, c.scene().make(seed + 1, 1, c.traffic, c.config, "cpu")["x"])
    assert not torch.equal(a, c.scene().make(seed, 2, c.traffic, c.config, "cpu")["x"])


@pytest.mark.parametrize("seed", [1, 2**31 + 77])
def test_the_scene_has_the_t60_drr_and_snr_it_draws(seed):
    c = small(batch=6)
    p, fs = c.traffic["scene"], c.config["array"]["fs"]
    q = c.scene().parts(seed, 0, c.traffic, c.config, "cpu")
    assert set(q["t60_s"].tolist()) <= set(p["t60_s"]) and set(q["drr_db"].tolist()) <= set(p["drr_db"])
    assert ((q["az_deg"] >= 0) & (q["az_deg"] < 360) & (q["az_deg"] == q["az_deg"].round())).all()
    h = q["h"].double()
    for b in range(6):
        L = round(float(q["t60_s"][b]) * fs)
        tail = h[b, :, 1:]
        assert (h[b, :, 0] == 1).all() and (tail[:, : round(p["tail_from_ms"] * fs / 1e3) - 1] == 0).all()
        assert (tail[:, L - 1 :] == 0).all() and (tail[:, L - 2] != 0).all()
        drr = 10 * torch.log10(1.0 / tail.pow(2).sum(-1))
        assert torch.allclose(drr, q["drr_db"][b].expand(8), atol=1e-4)
        # energy falls 60 dB in T60: 30 dB from the first tenth to the sixth tenth, over 8 mics
        e = lambda lo: tail[:, int(lo * L) : int((lo + 0.1) * L)].pow(2).mean()  # noqa: E731
        assert abs(10 * math.log10(e(0.1) / e(0.6)) - 30.0) < 1.5
        snr = 10 * torch.log10(q["clean"][b].pow(2).mean() / q["noise"][b].pow(2).mean())
        assert abs(float(snr) - p["snr_db"]) < 0.1


def test_the_counts_at_the_cells_size():
    cfg = spec.load_cell(CELL).config
    batch = {"x": torch.zeros(8, 8, 64000)}
    ops, nbytes = wpe.work(batch, cfg)
    # K = 80: P X 6400, X^H P X 80, half the update 3240, e and W's update 640 each: 11,000 complex
    # multiply-adds an (utterance, bin, frame), 8 x 257 x 500 of them
    assert ops == 8 * 11000 * 8 * 257 * 500 and round(ops / 1e9, 1) == 90.5
    assert nbytes == 8 * (2 * 8 * 500 * 257 * 8 + 8 * 257 * (80 * 80 + 8 * 80))
    assert 1.35e-3 < peaks.bound_s(ops, nbytes) < 1.351e-3  # by operations
    ops, nbytes = k10.work(batch, cfg)  # the kernel table's 0.0721 ms, by the tensor cores' products
    assert peaks.bound_s(ops, nbytes) == pytest.approx(3 * 2 * 4000 * 129 * 720 * 16 / 495e12)
    ops, nbytes = mcra.work(batch, cfg)
    assert nbytes == 16 * 4000 * 129 and 10 < ops / (4000 * 129) < 60


def stretch(**kw) -> SpanTrace:
    """Two calls: WPE's span on the host 1.0-3.0 and 6.0-8.5, its device
    shadows 1.5-3.5 (0.5 idle inside: 0.4 + 1.1) and 6.5-8.8 (all busy)."""
    host = [("portbench.call", 0.0, 4.0), ("ds.wpe_srp_process", 0.1, 3.9), ("ds.wpe_srp.wpe", 1.0, 3.0),
            ("portbench.sync", 4.0, 4.5), ("portbench.call", 5.0, 9.0), ("ds.wpe_srp_process", 5.1, 8.9),
            ("ds.wpe_srp.wpe", 6.0, 8.5), ("portbench.sync", 9.0, 9.5)]
    dev = [("mul", 1.5, 1.9), ("sum", 2.0, 2.5), ("mul", 2.5, 3.5), ("mul", 6.5, 8.8)]
    shadows = [("ds.wpe_srp.wpe", 1.5, 3.5, 0), ("ds.wpe_srp.wpe", 6.5, 8.8, 1)]
    args = dict(device_ops=dev, host_ops=host, t0=0.0, t1=9.5, calls=2, batches=[0, 1], wall_s=10.0, shadows=shadows,
                counters={"wpe.frames": 1000, "host_sync.subband.prototype": 4})
    args.update(kw)
    return SpanTrace(**args)


def test_the_wpe_readers_by_hand():
    cell = spec.load_cell(CELL)
    pool = [{"x": torch.zeros(8, 8, 64000)}] * 2
    ctx = {"span_trace": stretch(), "cell": cell, "pool": pool}
    busy = 0.4 + 1.5 + 2.3
    assert wpe_device_ms.read(ctx) == pytest.approx(1e3 * busy / 2)
    assert wpe_host_ms.read(ctx) == pytest.approx(1e3 * 4.5 / 2)
    assert wpe_roofline.read(ctx) == pytest.approx(100 * 2 * peaks.bound_s(*wpe.work(pool[0], cell.config)) / busy)
    bare = {"span_trace": stretch(host_ops=[("portbench.call", 0.0, 4.0)], shadows=[], counters={}),
            "cell": cell, "pool": pool}
    for reader in (wpe_device_ms, wpe_host_ms, wpe_roofline):
        assert reader.read({"span_trace": None}) is None and reader.read(bare) is None


def small_cell():
    """The cell at a size the CPU runs: 2 x 8 mics x 1.2 s, 64 bands / hop 16, 3 taps."""
    c = small(batch=2, seconds=1.2)
    c.traffic["pool"] = 2
    c.config["wpe"].update(num_bands=64, hop=16, filter_len=3)
    c.checks["calls"] = 2
    return c


def presence_a_frame_late(entry):
    """Every utterance's p one frame late where it is produced (its first
    frame repeated); y and the spectrum left alone."""
    def call(batch):
        out = entry(batch)
        p = out["p"]
        p[:, 1:] = p[:, :-1].clone()
        return out
    return call


def presence_not_finite(entry):
    """Utterance 0's p not a number where it is produced; y and the
    spectrum left alone."""
    def call(batch):
        out = entry(batch)
        out["p"][0] = float("nan")
        return out
    return call


@pytest.mark.parametrize("fault", [None, half_batch, altered_answer, altered_blocks, presence_a_frame_late,
                                   presence_not_finite],
                         ids=["sound", "half_batch", "altered_answer", "altered_blocks", "presence_a_frame_late",
                              "presence_not_finite"])
def test_faults_make_a_small_run_incorrect(fault):
    result = runner.run(small_cell(), 2**31 + 99, 0.5, False, device="cpu", call=fault)
    assert result["correct"] == (fault is None), result["checks"]


def test_the_control_fails_the_cells_limits():
    """The TF32 control at the cell's widths, on one 1.2 s utterance."""
    c = small(batch=1, seconds=1.2)
    batch = c.scene().make(5, 0, c.traffic, c.config, "cpu")
    got = checks.control_numbers(c, [batch], [(0, None)], Precision(c.config["control"]))[0]
    limits = c.checks["limits"]
    assert any(not got[n] <= lim for n, lim in limits.items()), (got, limits)
    assert np.isfinite(list(got.values())).all()
