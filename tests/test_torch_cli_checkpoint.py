"""The port's CLI and checkpoints on the CPU: ``run`` against JAX's ``run``
on the eight pipelines JAX's own CLI test lists, the other choices finite,
``--stream`` with an unaligned tail, the unsupported-stream refusal; the
checkpoint round trip in float64, a checkpoint written by either package
resumed in the other, and the .npz leaf layout of every stream's state
against JAX's."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.runtime import checkpoint as jck
from distantspeech_tpu.runtime import cli as jcli
from distantspeech_tpu.runtime import streaming as jst
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.runtime import checkpoint as tck
from distantspeech_tpu_torch.runtime import cli as tcli
from distantspeech_tpu_torch.runtime import streaming as tst
from distantspeech_tpu_torch.runtime.io import load_audio, save_audio

JAX_TESTED = ["fixed_ds", "mvdr", "enhance", "pmwf", "tdgsc", "dios_gsc", "mccowan", "binaural"]
OTHERS = ["fixed_sd", "gsc", "gsc_time", "fdgsc", "subband_gsc", "wpe", "kws"]
CLI_BAR = 1e-4  # max |port - JAX| / max |JAX| of the returned y, before the wav's normalisation


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests add no parallel work of their own to
    a run that spreads files over workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(d, S=256 * 12, seed=0):
    x = np.random.default_rng(seed).standard_normal((S, 4)) * 0.1
    path = os.path.join(d, "in.wav")
    save_audio(path, x)
    return path


def test_cli_full_stack_streams_only(tmp_path):
    inp = _wav(str(tmp_path))
    outp = str(tmp_path / "out.wav")
    with pytest.raises(SystemExit, match="--stream only"):
        tcli.run(tcli.build_parser().parse_args([inp, outp, "--pipeline", "full_stack", "--cpu"]))
    y = tcli.run(tcli.build_parser().parse_args([inp, outp, "--pipeline", "full_stack", "--stream", "--chunk", "512",
                                                 "--cpu"]))
    assert y.shape == (256 * 12,) and np.isfinite(y).all()


@pytest.mark.parametrize("pipeline", JAX_TESTED)
def test_cli_matches_jax(pipeline, tmp_path):
    inp = _wav(str(tmp_path))
    argv = [inp, str(tmp_path / "out.wav"), "--pipeline", pipeline, "--array", "circular"]
    want = np.asarray(jcli.run(jcli.build_parser().parse_args(argv)), np.float64)
    got = tcli.run(tcli.build_parser().parse_args(argv + ["--cpu"]))
    assert got.shape == want.shape and np.isfinite(got).all()
    gap = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    assert gap <= CLI_BAR, gap
    out = load_audio(str(tmp_path / "out.wav"))
    assert np.isfinite(out).all() and out.shape == got.shape


@pytest.mark.parametrize("pipeline", OTHERS)
def test_cli_other_pipelines(pipeline, tmp_path):
    inp = _wav(str(tmp_path))
    outp = str(tmp_path / "out.wav")
    y = tcli.run(tcli.build_parser().parse_args([inp, outp, "--pipeline", pipeline, "--cpu"]))
    assert y.shape == (256 * 12,) and np.isfinite(y).all() and os.path.exists(outp)


def test_cli_stream_unaligned_tail_matches_jax(tmp_path):
    S = 1024 * 6 + 300  # not chunk-aligned: the tail is zero-padded, then trimmed
    x = (np.random.default_rng(8).standard_normal((S, 4)) * 0.1).astype(np.float32)
    inp, outp = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    save_audio(inp, x)
    argv = [inp, outp, "--pipeline", "enhance", "--stream"]
    want = jcli.run(jcli.build_parser().parse_args(argv))
    y = tcli.run(tcli.build_parser().parse_args(argv + ["--cpu"]))
    assert y.shape == (S,) and np.isfinite(y).all()
    np.testing.assert_allclose(y, want, atol=1e-5, rtol=0)  # JAX's stream-vs-offline bar for enhance
    with open(outp + ".latency.json") as f:
        report = json.load(f)
    assert report["chunks"] == 7 and report["budget_ms"] == 64.0
    assert report["p50_ms"] is not None and report["realtime_factor"] is not None
    out = load_audio(outp)
    assert np.isfinite(out).all() and out.shape == (S,)


def test_cli_stream_rejects_unsupported_pipeline(tmp_path):
    inp = str(tmp_path / "in.wav")
    save_audio(inp, np.zeros((2048, 2), dtype=np.float32))
    args = tcli.build_parser().parse_args([inp, str(tmp_path / "o.wav"), "--pipeline", "mccowan", "--stream",
                                           "--cpu"])
    with pytest.raises(SystemExit):
        tcli.run(args)


def test_checkpoint_roundtrip_resumes_stream(tmp_path):
    """JAX's test on the port: save a mid-stream float64 MVDR state, restore
    it into a fresh template, and the continuation matches to 1e-12."""
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig, mvdr_init, mvdr_step

    cfg = MvdrConfig()
    steer = torch.as_tensor(steering_vector(TGeometry.linear(4, 0.032), (np.pi / 2, 0), 256), dtype=torch.complex128)
    rng = np.random.default_rng(1)
    Z = torch.as_tensor(rng.standard_normal((20, 129, 4)) + 1j * rng.standard_normal((20, 129, 4)))

    state = mvdr_init(cfg, 4, cdtype=torch.complex128, device="cpu")
    for t in range(10):
        state, _ = mvdr_step(cfg, steer, state, Z[t])
    path = str(tmp_path / "ckpt.npz")
    tck.save_state(path, state)
    restored = tck.load_state(path, mvdr_init(cfg, 4, cdtype=torch.complex128, device="cpu"))
    assert restored.mcra.frm_cnt == 10 and type(restored.mcra.frm_cnt) is int and type(restored.mcra.ell) is int
    assert restored.Rvv.dtype == torch.complex128 and restored.mcra.p.dtype == torch.float64
    for t in range(10, 20):
        state, y1 = mvdr_step(cfg, steer, state, Z[t])
        restored, y2 = mvdr_step(cfg, steer, restored, Z[t])
        np.testing.assert_allclose(y2.numpy(), y1.numpy(), rtol=1e-12)


def test_checkpoint_refuses_a_leaf_count_mismatch(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    tck.save_state(path, (torch.zeros(3), 1))
    with pytest.raises(ValueError, match="checkpoint has 2 leaves, template has 3"):
        tck.load_state(path, (torch.zeros(3), 1, torch.zeros(2)))


def test_checkpoint_leaf_order_follows_jax():
    """NamedTuple fields in order, dict entries by sorted key, None dropped;
    host ints as leaves: the same order as ``jax.tree.leaves``."""
    from typing import NamedTuple

    class S(NamedTuple):
        b: object
        a: object

    tree = S(b={"z": 1, "a": (2, None)}, a=[3, None, 4])
    jtree = S(b={"z": 1, "a": (2, None)}, a=[3, None, 4])
    assert tck._leaves(tree) == jax.tree.leaves(jtree) == [2, 1, 3, 4]
    rebuilt = tck._rebuild(tree, iter([20, 10, 30, 40]))
    assert rebuilt == S(b={"z": 10, "a": (20, None)}, a=[30, None, 40])


@pytest.mark.parametrize("name", sorted(tst.STREAM_FACTORIES))
def test_stream_state_layout_matches_jax(name):
    """Every stream's carry flattens to JAX's leaves: count, shapes, dtypes
    (a host int against JAX's int32 scalar)."""
    M = 3 if name == "full_stack" else 4
    jleaves = jax.tree.leaves(jst.STREAM_FACTORIES[name](JGeometry.linear(M, 0.032), chunk_size=512).state)
    tleaves = tck._leaves(tst.STREAM_FACTORIES[name](TGeometry.linear(M, 0.032), chunk_size=512, device="cpu").state)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        if isinstance(t, int):
            assert j.shape == () and j.dtype == np.int32
        else:
            assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[1] == str(j.dtype)


STREAM_ARGS = {"enhance": dict(chunk=512, M=4, bar=1e-5), "full_stack": dict(chunk=512, M=3, bar=1e-6)}


def _stream_pair(name, x, cut, saver, loader, path):
    """Run JAX's and the port's stream of ``name`` on x: one package runs the
    first ``cut`` chunks and ``saver`` writes its state; a fresh processor of
    the other package restores it with ``loader`` and runs the rest.
    Returns (uninterrupted output of the second package, resumed tail)."""
    a = STREAM_ARGS[name]
    make_j = lambda: jst.STREAM_FACTORIES[name](JGeometry.linear(a["M"], 0.032), chunk_size=a["chunk"])
    make_t = lambda: tst.STREAM_FACTORIES[name](TGeometry.linear(a["M"], 0.032), chunk_size=a["chunk"], device="cpu")
    chunks = list(tst.wav_chunks(x, a["chunk"]))
    first, second = (make_j, make_t) if saver is jck.save_state else (make_t, make_j)
    p1 = first()
    p1.run(chunks[:cut])
    saver(path, p1.state)
    whole = second().run(chunks)
    p2 = second()
    p2.state = loader(path, p2.state)
    return whole[cut * a["chunk"]:], p2.run(chunks[cut:])


@pytest.mark.parametrize("name", sorted(STREAM_ARGS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_cross_loads(name, direction, tmp_path):
    """A stream saved mid-way by one package resumes in the other; the
    continuation is within the factory's streaming bar of the other
    package's uninterrupted stream (the host ints and the leaf order hold)."""
    a = STREAM_ARGS[name]
    x = (np.random.default_rng(11).standard_normal((a["M"] + (name == "full_stack"), a["chunk"] * 6)) * 0.1).astype(
        np.float32)
    saver, loader = (jck.save_state, tck.load_state) if direction == "jax_to_port" else (tck.save_state, jck.load_state)
    want, got = _stream_pair(name, x, 3, saver, loader, str(tmp_path / "ckpt.npz"))
    assert got.shape == want.shape == (3 * a["chunk"],)
    np.testing.assert_allclose(got, want, atol=a["bar"], rtol=0)
