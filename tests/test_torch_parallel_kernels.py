"""The port's sharded flagship fast path, ``make_sharded_enhance_pallas``
(the MCRA pre-scan and K1 on each bin shard), across a gloo world of 4 CPU
processes, where the wrappers run their kernels' plain versions: against
the JAX runner of the same name at the same mesh shape on JAX's CPU mesh
(``jax.devices()[:4]``, the Pallas kernel in interpret mode), in float32,
at the tolerance JAX's own ``tests/test_parallel.py`` uses for this runner
(rtol 2e-3 / atol 2e-4, as against ``enhance_process``), and the direct
check of K2, K4 and the sharded path at 2e-5 x max|y|.  Each also matches
the port's unsharded path on the same ranks.  The (1, 4) mesh pads 129
bins to 4 x 33: the last rank's padded bins carry gate 0, steer 1, lam 1."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_world as world  # noqa: E402

PALLAS_MESHES = ((1, 4), (2, 2), (4, 1))
CASES = [f"pallas@{a}x{b}" for a, b in PALLAS_MESHES] + ["direct@2x2"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return world.run_world(4, CASES, tmp_path_factory.mktemp("parallel_kernels"))


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


@pytest.mark.parametrize("shape", PALLAS_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_pallas_matches_jax(ranks, shape):
    from distantspeech_tpu.beamform.enhance import EnhanceConfig
    from distantspeech_tpu.parallel import make_sharded_enhance_pallas

    res = ranks[f"pallas@{shape[0]}x{shape[1]}"]
    _same_on_every_rank(res)
    run = make_sharded_enhance_pallas(_jax_mesh(shape), _geom(), (90.0, 0.0), EnhanceConfig(), interpret=True)
    want = np.asarray(run(jnp.asarray(world.inputs("pallas"))))
    assert res[0]["y"].dtype == np.float32 and res[0]["y"].shape == want.shape
    np.testing.assert_allclose(res[0]["y"], want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("shape", PALLAS_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_pallas_matches_unsharded(ranks, shape):
    """Against ``enhance_process``'s scan at JAX's bar, and its ``pallas``
    backend (the same MCRA and K1 plain versions on all bins at once) to
    float32 rounding."""
    r = ranks[f"pallas@{shape[0]}x{shape[1]}"][0]
    np.testing.assert_allclose(r["y"], r["single"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(r["y"], r["pallas"], rtol=0, atol=1e-6 * np.max(np.abs(r["pallas"])))


@pytest.mark.parametrize("i", range(len(world.DIRECT_CFGS)), ids=lambda i: "rel_diag={},p_vad={}".format(
    *world.DIRECT_CFGS[i]))
def test_fused_vs_sharded_fused_direct(ranks, i):
    """The direct check of JAX's test: K2's and K4's plain versions and the
    sharded pallas path (MCRA pre-scan + K1) agree on one input, swept over
    the guard configs and the gate threshold."""
    res = ranks["direct@2x2"]
    _same_on_every_rank(res, (f"y{i}",))
    a, b, c = (res[0][f"{k}{i}"] for k in ("fused", "full", "y"))
    scale = np.max(np.abs(a))
    np.testing.assert_allclose(b, a, atol=2e-5 * scale)
    np.testing.assert_allclose(c, a, atol=2e-5 * scale)
