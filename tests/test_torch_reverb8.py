"""The ``reverb8_wpe_srp`` deployment (``portbench/configs/reverb8_wpe_srp.json``):
``doa.wpe_srp_process`` with ``return_dereverb`` against the plain
reference ``portbench/reference/reverb8_wpe_srp.py`` in float64 on the CPU,
at 4 mics, 64 bands / hop 16, 3 taps and 1.2 s of ``scenes/reverb_look.py``
(150 SRP frames: MCRA's presence leaves its 2 L = 130 frames of forced
absence); the reference's Nyquist(M) prototypes against the program's; and
the call's spans and counters.  The tests marked ``card`` hold the CUDA
graph of the recursion to its frame loop and count one call's launches and
blocking copies on the card:
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
from distantspeech_tpu_torch.transform.filterbank_design import nyquist_prototypes
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
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            wpe_srp_process(x, geom, wcfg, SrpConfig(), backend="fused", device="cpu", return_dereverb=True)
    got = {}
    for e in prof.events():
        if e.name.startswith("ds."):
            got.setdefault(e.name, []).append(_ds_parent(e))
    assert got == {"ds.wpe_srp_process": [None] * 2, **{s: ["ds.wpe_srp_process"] * 2 for s in STAGES}}
    assert counters() == {"wpe.frames": 2 * T}  # and no launch.* or host_sync.* from CPU tensors


@pytest.mark.card
def test_one_call_on_the_card_counts_each_launch_and_each_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, wcfg, geom = _small()
    x = _scene(cfg, B=1, seconds=0.5, device="cuda")
    run = lambda: wpe_srp_process(x, geom, wcfg, SrpConfig(), backend="fused", return_dereverb=True)  # noqa: E731
    run()  # the first call builds the kernels and copies the steering grid
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
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert counters() == {"wpe.frames": x.shape[-1] // wcfg.hop, "launch.fused_srp_spectrum": 1,
                          "launch.mcra_run": 1, "host_sync.subband.prototype": 2}
    assert len(syncs) == 2, [f"{w.filename}:{w.lineno}" for w in syncs]


def _cell_wpe():
    w = CONFIG["wpe"]
    return WpeConfig(num_bands=w["num_bands"], hop=w["hop"], n_channels=w["n_channels"], filter_len=w["filter_len"],
                     delay=w["delay"], forgetting_factor=w["forgetting_factor"], alpha_var=w["alpha_var"],
                     p_init=w["p_init"])


@pytest.mark.card
def test_the_graphed_recursion_is_the_frame_loop_on_the_card():
    """At the configuration's widths (8 ch x 10 taps, 512 bands / hop 128),
    2 utterances of lengths that end inside a block, fill blocks exactly
    and fall short of one: one graph serves them all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wcfg = _cell_wpe()
    K = wpe.GRAPH_FRAMES
    for seed, frames in ((1, 2 * K + 17), (2, K), (3, K - 9), (4, 3 * K)):  # the capture, then replays
        x = _scene(CONFIG, seconds=(3 * K + 1) * wcfg.hop / 16000, seed=seed, device="cuda")
        D = wpe_analysis(x[..., : frames * wcfg.hop], wcfg)
        assert D.shape[0] == frames and torch.equal(wpe.wpe_run(wcfg, D), wpe._recursion(wcfg, D)), frames
    assert len([k for k in wpe._GRAPHS if k[0] == wcfg]) == 1


@pytest.mark.card
def test_the_graph_steps_on_its_inputs_card_whichever_card_is_current():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    wcfg = dataclasses.replace(_cell_wpe(), num_bands=64, hop=16)
    x = _scene(CONFIG, seconds=0.25, seed=5, device="cuda:1")
    D = wpe_analysis(x, wcfg)
    want = wpe._recursion(wcfg, D)
    with torch.cuda.device(0):
        for seed in (5, 6):  # the capture, then a replay on another input
            D = wpe_analysis(_scene(CONFIG, seconds=0.25, seed=seed, device="cuda:1"), wcfg)
            got = wpe.wpe_run(wcfg, D)
            assert got.device == D.device and torch.equal(got, wpe._recursion(wcfg, D))
    assert torch.equal(wpe.wpe_run(wcfg, wpe_analysis(x, wcfg)), want)
