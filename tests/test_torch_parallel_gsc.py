"""The port's sharded frequency-domain GSC (``make_sharded_gsc``) and
subband GSC (``make_sharded_subband_gsc``) across a gloo world of 4 CPU
processes, against the JAX runners of the same name at the same mesh
shapes on JAX's CPU mesh (``jax.devices()[:4]``), in float64 on both sides
at the bar of the port's unsharded tests (1e-9 of max|y|), and against the
port's own unsharded path on the same ranks.

Over fb = 4 the GSC's 129 bins split 33 a rank, and a rank past the first
works on two bins below its own (the MC-MCRA gain zeroes the first two
bins it is given).  The subband GSC all-reduces McSpp's mid-band q sum and
gathers its BM and AIC errors over fb every block; a config whose band
spans three ranks, with q moving, checks the all-reduce."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_world as world  # noqa: E402

RECURSION = 1e-9
# the runners' constants are JAX's runners': the GSC's steering vector
# complex64 and the subband GSC's alignment filters float32, where
# gsc_process and subband_gsc_process keep them in float64; the float64
# output keeps that rounding (JAX's own runner is 7.9e-9 from its
# subband_gsc_process on this input)
CONST32 = 1e-7
MESHES = ((1, 4), (2, 2))
CASES = [f"{f}@{a}x{b}" for f in ("gsc", "subband_gsc", "subband_gsc_wide") for a, b in MESHES]
CASES.append("subband_gsc_wide@4x1")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return world.run_world(4, CASES, tmp_path_factory.mktemp("parallel_gsc"))


def _jax_mesh(shape):
    from distantspeech_tpu.parallel import make_mesh

    return make_mesh(*shape, devices=jax.devices()[:4])


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


def _same_on_every_rank(res):
    for r in res[1:]:
        np.testing.assert_array_equal(r["y"], res[0]["y"])


def _geom():
    from distantspeech_tpu.array.geometry import ArrayGeometry

    return ArrayGeometry.circular(4, 0.032)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_gsc_matches_jax(ranks, shape):
    from distantspeech_tpu.beamform.gsc import GscConfig
    from distantspeech_tpu.parallel.sharded import make_sharded_gsc

    res = ranks[f"gsc@{shape[0]}x{shape[1]}"]
    _same_on_every_rank(res)
    run = make_sharded_gsc(_jax_mesh(shape), _geom(), world.ANGLE, GscConfig(n_mics=4, frame_len=256))
    want = np.asarray(run(jnp.asarray(world.inputs("gsc"))))
    assert res[0]["y"].dtype == np.float64 and res[0]["y"].shape == want.shape
    assert _rel(res[0]["y"], want) <= RECURSION


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_gsc_matches_unsharded(ranks, shape):
    r = ranks[f"gsc@{shape[0]}x{shape[1]}"][0]
    assert _rel(r["y"], r["single"]) <= CONST32


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_subband_gsc_matches_jax(ranks, shape):
    from distantspeech_tpu.beamform.subband_gsc import SubbandGscConfig
    from distantspeech_tpu.parallel import make_sharded_subband_gsc

    res = ranks[f"subband_gsc@{shape[0]}x{shape[1]}"]
    _same_on_every_rank(res)
    run = make_sharded_subband_gsc(_jax_mesh(shape), _geom(), world.ANGLE, SubbandGscConfig(n_mics=4, frame_len=128))
    want = np.asarray(run(jnp.asarray(world.inputs("subband_gsc"))))
    assert res[0]["y"].dtype == np.float64 and res[0]["y"].shape == want.shape
    assert _rel(res[0]["y"], want) <= RECURSION


@pytest.mark.parametrize("family", ["subband_gsc", "subband_gsc_wide"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_subband_gsc_matches_unsharded(ranks, family, shape):
    res = ranks[f"{family}@{shape[0]}x{shape[1]}"]
    _same_on_every_rank(res)
    assert _rel(res[0]["y"], res[0]["single"]) <= CONST32


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_subband_gsc_mid_band_all_reduce(ranks, shape):
    """The wide-band config split over bins against the same runner with
    every bin on each rank (the 4x1 mesh): only the all-reduced mid-band
    mean of q and the bin gathers differ."""
    want = ranks["subband_gsc_wide@4x1"][0]["y"]
    assert _rel(ranks[f"subband_gsc_wide@{shape[0]}x{shape[1]}"][0]["y"], want) <= RECURSION
