"""The port's batch-parallel kernel runners across a gloo world of 4 CPU
processes, where the wrappers run their kernels' plain versions:
``make_sharded_enhance_mega`` (K4) and ``make_sharded_tdgsc_fused`` (K5),
each against the JAX runner of the same name at the same mesh shape on
JAX's CPU mesh (``jax.devices()[:4]``, the Pallas kernels in interpret
mode), in float32: TDGSC at the 1e-5 absolute of JAX's own
``tests/test_parallel.py``, mega within twice JAX's own float32 gap to
float64 (JAX's 1e-5 holds one kernel to itself).  Each also matches the
port's unsharded kernel call on the same ranks at 1e-5."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_world as world  # noqa: E402

MEGA_MESHES = ((2, 2), (4, 1))
CASES = [f"mega@{a}x{b}" for a, b in MEGA_MESHES] + ["tdgsc@2x2"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return world.run_world(4, CASES, tmp_path_factory.mktemp("parallel_batch"))


def _jax_mesh(shape):
    from distantspeech_tpu.parallel import make_mesh

    return make_mesh(*shape, devices=jax.devices()[:4])


def _geom():
    from distantspeech_tpu.array.geometry import ArrayGeometry

    return ArrayGeometry.linear(4, 0.032)


def _same_on_every_rank(res, keys=("y",)):
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k])


@pytest.fixture(scope="module")
def mega_float64():
    """JAX's float64 scan on the mega input: the reference both float32
    kernels are measured from."""
    from distantspeech_tpu.beamform.enhance import EnhanceConfig, enhance_process

    return np.asarray(enhance_process(jnp.asarray(world.inputs("mega").astype(np.float64)), _geom(), (90.0, 0.0),
                                      EnhanceConfig()))


@pytest.mark.parametrize("shape", MEGA_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_mega_matches_jax_and_unsharded(ranks, mega_float64, shape):
    """Against JAX's runner, within twice JAX's own float32 gap to its
    float64 scan, not JAX's 1e-5 between two runs of one kernel: four frames
    leave the guarded covariance rank-deficient, and JAX's float32 kernel
    lies 6.2e-5 from float64 here (max|y| 0.25), so no two float32
    implementations meet 1e-5.  Against the port's unsharded K4 at 1e-5."""
    from distantspeech_tpu.beamform.enhance import EnhanceConfig
    from distantspeech_tpu.parallel import make_sharded_enhance_mega

    res = ranks[f"mega@{shape[0]}x{shape[1]}"]
    _same_on_every_rank(res)
    want = np.asarray(make_sharded_enhance_mega(_jax_mesh(shape), _geom(), (90.0, 0.0), EnhanceConfig())(
        jnp.asarray(world.inputs("mega"))))
    assert res[0]["y"].dtype == np.float32 and res[0]["y"].shape == want.shape
    jax_gap = np.max(np.abs(want - mega_float64))
    assert np.max(np.abs(res[0]["y"] - mega_float64)) <= 2 * jax_gap
    assert np.max(np.abs(res[0]["y"] - want)) <= 2 * jax_gap
    np.testing.assert_allclose(res[0]["y"], res[0]["single"], atol=1e-5)


def test_sharded_tdgsc_fused_matches_jax_and_unsharded(ranks):
    from distantspeech_tpu.beamform.tdgsc import TdGscConfig
    from distantspeech_tpu.parallel import make_sharded_tdgsc_fused

    res = ranks["tdgsc@2x2"]
    _same_on_every_rank(res, ("y", "p", "bm"))
    want = make_sharded_tdgsc_fused(_jax_mesh((2, 2)), _geom(), world.ANGLE, TdGscConfig(n_mics=4))(
        jnp.asarray(world.inputs("tdgsc")))
    r = res[0]
    assert r["y"].shape == want[0].shape and r["p"].shape == want[1].shape and r["bm"].shape == want[2].shape
    np.testing.assert_allclose(r["y"], np.asarray(want[0]), atol=1e-5)
    for k in ("y", "p", "bm"):
        np.testing.assert_allclose(r[k], r[f"single_{k}" if k != "y" else "single"], atol=1e-5)
