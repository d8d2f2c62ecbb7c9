"""The ``reverb8_wpe_srp`` deployment (``portbench/configs/reverb8_wpe_srp.json``):
``doa.wpe_srp_process`` with ``return_dereverb`` against the plain
reference ``portbench/reference/reverb8_wpe_srp.py`` in float64 on the CPU,
at 4 mics, 64 bands / hop 16, 3 taps and 1.2 s of ``scenes/reverb_look.py``
(150 SRP frames: MCRA's presence leaves its 2 L = 130 frames of forced
absence); the reference's Nyquist(M) prototypes against the program's; and
the call's spans and counters; a CPU tensor takes the frame loop, and the
kernel's wrapper refuses what lies outside its range before any launch.
The tests marked ``card`` hold WPE's kernel (``csrc/wpe.cu``) to the float32
frame loop and to the float64 recursion, count one call's launches and
blocking copies, and hold the cell's outputs with the shared subband
prototypes to those with fresh copies, on the card:
``python -m pytest --noconftest tests/test_torch_reverb8.py -m card``."""

import copy
import dataclasses
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.derev import wpe
from distantspeech_tpu_torch.derev.wpe import WpeConfig
from distantspeech_tpu_torch.doa.srp import SrpConfig
from distantspeech_tpu_torch.doa.wpe_srp import wpe_analysis, wpe_srp_process
from distantspeech_tpu_torch.runtime.profiling import counters, reset_counters
from distantspeech_tpu_torch.transform import subband
from distantspeech_tpu_torch.transform.filterbank_design import nyquist_prototypes
from portbench.entries import reverb8_wpe_srp as entry
from portbench.reference import reverb8_wpe_srp as reference
from portbench.scenes import reverb_look

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/reverb8_wpe_srp.json").read_text())
TRAFFIC = json.loads((ROOT / "portbench/traffic/reverb8.wpe_srp.b8.json").read_text())
STAGES = ("ds.wpe_srp.analysis", "ds.wpe_srp.wpe", "ds.wpe_srp.synthesis", "ds.wpe_srp.srp")


def _small(M=4):
    cfg = copy.deepcopy(CONFIG)
    cfg["array"]["n_mics"] = M
    cfg["wpe"].update(num_bands=64, hop=16, n_channels=M, filter_len=3)
    w = cfg["wpe"]
    wcfg = WpeConfig(num_bands=w["num_bands"], hop=w["hop"], n_channels=M, filter_len=w["filter_len"],
                     delay=w["delay"], forgetting_factor=w["forgetting_factor"], alpha_var=w["alpha_var"],
                     p_init=w["p_init"])
    return cfg, wcfg, ArrayGeometry.circular(M, cfg["array"]["radius_m"])


def _scene(cfg, B=2, seconds=1.2, seed=2**31 + 18, device="cpu"):
    traffic = dict(TRAFFIC, batch=B, utterance_s=seconds)
    return reverb_look.make(seed, 0, traffic, cfg, device)["x"]


def test_program_matches_the_reference_in_float64():
    cfg, wcfg, geom = _small()
    x = _scene(cfg).double()
    want = reference.run({"x": x}, cfg)
    spec, p, y = wpe_srp_process(x, geom, wcfg, SrpConfig(), backend="scan", device="cpu", return_dereverb=True)
    for name, got in (("y", y), ("spectrum", spec), ("p", p)):
        assert got.dtype == torch.float64 and got.shape == want[name].shape, name
        assert float((got - want[name]).abs().max() / want[name].abs().max()) < 1e-10, name
    assert y.shape == x.shape and float(p.max()) > 0.5  # presence rose past its forced absence
    two = wpe_srp_process(x, geom, wcfg, SrpConfig(), backend="scan", device="cpu")
    assert len(two) == 2 and torch.equal(two[0], spec) and torch.equal(two[1], p)


@pytest.mark.parametrize("M,m,r", [(64, 2, 2), (512, 2, 2)])
def test_reference_prototypes_equal_the_programs(M, m, r):
    h, g = reference.prototypes(*reference.bank({"num_bands": M, "hop": M // (2 * r), "m": m}))
    ph, pg = nyquist_prototypes(M, m, r)
    for got, want in ((h, ph), (g, pg)):
        assert got.shape == want.shape and np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


def _ds_parent(event):
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith("ds."):
        parent = parent.cpu_parent
    return parent.name if parent is not None else None


def test_a_call_opens_its_spans_and_counts_its_frames():
    cfg, wcfg, geom = _small(M=2)
    x = _scene(cfg, B=1, seconds=0.128)
    T = x.shape[-1] // wcfg.hop
    subband._prototype_on.cache_clear()
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            wpe_srp_process(x, geom, wcfg, SrpConfig(), backend="fused", device="cpu", return_dereverb=True)
    got = {}
    for e in prof.events():
        if e.name.startswith("ds."):
            got.setdefault(e.name, []).append(_ds_parent(e))
    assert got == {"ds.wpe_srp_process": [None] * 2, **{s: ["ds.wpe_srp_process"] * 2 for s in STAGES}}
    # the second call takes both prototypes from the cache; no launch.* or host_sync.* from CPU tensors
    assert counters() == {"wpe.frames": 2 * T, "cache.subband.prototype.hit": 2}


@pytest.mark.card
def test_one_call_on_the_card_counts_each_launch_and_each_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, wcfg, geom = _small()
    x = _scene(cfg, B=1, seconds=0.5, device="cuda")
    run = lambda: wpe_srp_process(x, geom, wcfg, SrpConfig(), backend="fused", return_dereverb=True)  # noqa: E731
    launches = {"wpe.frames": x.shape[-1] // wcfg.hop, "launch.wpe_run": 1, "launch.fused_srp_spectrum": 1,
                "launch.mcra_run": 1}

    def counted_call():
        torch.cuda.synchronize()
        reset_counters()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return [f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing CUDA operation" in str(w.message)]

    run()  # the first call builds the kernels and copies the steering grid and the subband prototypes
    syncs = counted_call()  # both prototypes from the cache: nothing waits for the card
    assert counters() == {**launches, "cache.subband.prototype.hit": 2} and syncs == [], syncs
    subband._prototype_on.cache_clear()  # fresh keys: each prototype's one copy from the host
    syncs = counted_call()
    assert counters() == {**launches, "host_sync.subband.prototype": 2} and len(syncs) == 2, syncs


@pytest.mark.card
def test_the_cells_outputs_with_shared_prototypes_are_those_with_fresh_copies(monkeypatch):
    """The cell's call (its batch and utterances, through the benchmark's
    entry) with the shared prototypes and with prototypes copied afresh on
    every call: the same kernels on the same numbers, equal to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    call = entry.load(CONFIG, "cuda")
    x = _scene(CONFIG, B=TRAFFIC["batch"], seconds=TRAFFIC["utterance_s"], seed=2**31 + 21, device="cuda")
    call({"x": x})  # fills the cache
    shared = call({"x": x})
    monkeypatch.setattr(subband, "_prototype", lambda cfg, which, like: torch.as_tensor(
        cfg.prototypes()[which], dtype=like.real.dtype, device=like.device))
    fresh = call({"x": x})
    assert shared.keys() == fresh.keys() and all(torch.equal(shared[k], fresh[k]) for k in shared)


def _cell_wpe():
    w = CONFIG["wpe"]
    return WpeConfig(num_bands=w["num_bands"], hop=w["hop"], n_channels=w["n_channels"], filter_len=w["filter_len"],
                     delay=w["delay"], forgetting_factor=w["forgetting_factor"], alpha_var=w["alpha_var"],
                     p_init=w["p_init"])


def _gap(got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    return float((got - want).abs().max() / want.abs().max())


# The kernel against the float32 frame loop: both hold float64 to ~4e-7 of
# max|e| over the cell's 500 frames (PERF.md §6), in different orders of
# rounding (P's Hermitian half in registers, its shares of P X summed by rows,
# against full-matrix torch products), so they may part by their sum; 2e-6
# leaves that room twice over, where a wrong tap, frame or update parts them
# by 1e-2 or more.
KERNEL_VS_LOOP = 2e-6
KERNEL_VS_FLOAT64 = 1e-5  # and at most 3x the frame loop's own gap to float64


@pytest.mark.card
def test_the_kernel_is_the_frame_loop_at_the_cells_widths():
    """At the configuration's widths (8 ch x 10 taps, 512 bands / hop 128), 2
    utterances of 117, 50, 41 and 500 frames (the cell's): the kernel's e
    against the float32 frame loop and against the float64 recursion, one
    launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wcfg = _cell_wpe()
    for seed, frames in ((1, 117), (2, 50), (3, 41), (4, 500)):
        x = _scene(CONFIG, seconds=frames * wcfg.hop / 16000, seed=seed, device="cuda")
        D = wpe_analysis(x, wcfg)
        reset_counters()
        got = wpe.wpe_run(wcfg, D)
        assert counters() == {"wpe.frames": frames, "launch.wpe_run": 1}
        loop, f64 = wpe._recursion(wcfg, D), wpe._recursion(wcfg, D.to(torch.complex128))
        assert D.shape[0] == frames and got.shape == D.shape and got.is_contiguous()
        to_loop, to_f64, loop_f64 = _gap(got, loop), _gap(got, f64), _gap(loop, f64)
        assert to_loop < KERNEL_VS_LOOP, (frames, to_loop)
        assert to_f64 < KERNEL_VS_FLOAT64 and to_f64 <= 3 * loop_f64, (frames, to_f64, loop_f64)


@pytest.mark.card
def test_the_kernel_steps_on_its_inputs_card_whichever_card_is_current():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    wcfg = dataclasses.replace(_cell_wpe(), num_bands=64, hop=16)
    D = wpe_analysis(_scene(CONFIG, seconds=0.25, seed=5, device="cuda:1"), wcfg)
    want = wpe._recursion(wcfg, D)
    with torch.cuda.device(0):
        got = wpe.wpe_run(wcfg, D)
    assert got.device == D.device and _gap(got, want) < KERNEL_VS_LOOP


def test_a_cpu_tensor_takes_the_frame_loop():
    wcfg = dataclasses.replace(_cell_wpe(), num_bands=16, hop=4, n_channels=3, filter_len=2)
    D = torch.randn((20, 2, wcfg.half_bin, 3), dtype=torch.complex64, generator=torch.Generator().manual_seed(7))
    reset_counters()
    got = wpe.wpe_run(wcfg, D)
    assert counters() == {"wpe.frames": D.shape[0]} and torch.equal(got, wpe._recursion(wcfg, D))


_OUTSIDE = {
    "taps above 160": (dict(n_channels=16, filter_len=11), torch.complex64, None),
    "channels above 32": (dict(n_channels=33, filter_len=1), torch.complex64, None),
    "delay 0": (dict(delay=0), torch.complex64, None),
    "delay + taps above 200": (dict(delay=191), torch.complex64, None),
    "complex128": ({}, torch.complex128, None),
    "float64": ({}, torch.float64, None),
    "last dim not C": ({}, torch.complex64, 7),
}


@pytest.mark.parametrize("case", sorted(_OUTSIDE))
def test_a_shape_outside_the_kernels_range_raises_before_any_launch(case, monkeypatch):
    """The kernel's wrapper checks the configuration, the dtype and the shape
    before the device, so a CPU tensor shows what a CUDA one meets: a
    ``ValueError`` naming the range, the dtype or the shape, and no library
    loaded."""
    from distantspeech_tpu_torch.ops import _build, cuda_wpe

    def no_load(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(_build, "load", no_load)
    widths, dtype, last = _OUTSIDE[case]
    wcfg = dataclasses.replace(_cell_wpe(), num_bands=8, hop=2, **widths)
    C = last or wcfg.n_channels
    D = torch.zeros((5, 2, wcfg.half_bin, C), dtype=dtype)
    with pytest.raises(ValueError, match="range|n_channels|complex64|F = "):
        cuda_wpe.wpe_frames(wcfg, D)
