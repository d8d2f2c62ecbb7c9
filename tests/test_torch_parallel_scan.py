"""The port's sharded flagship scan (``parallel.make_sharded_enhance``) and
sharded WPE (``make_sharded_wpe``) across a gloo world of 4 CPU processes,
against the JAX package's runners of the same name at the same mesh shapes
on its CPU mesh (``jax.devices()[:4]``), in float64 on both sides, at the
bar of the port's unsharded tests of those pipelines (1e-9 of max|y|); and
against the port's own unsharded path on the same ranks.  n_fft 256 gives
F = 129 bins, so the (1, 4) mesh pads them to 4 x 33: global bin 0 sits on
the first rank and bin 128 on the last, each with MCRA's edge treatment,
and the one-bin halos cross the ranks' borders."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_world as world  # noqa: E402

RECURSION = 1e-9
ENHANCE_MESHES = ((1, 4), (2, 2), (4, 1))
WPE_MESHES = ((1, 4), (2, 2), (4, 1))
CASES = [f"enhance@{a}x{b}" for a, b in ENHANCE_MESHES] + [f"wpe@{a}x{b}" for a, b in WPE_MESHES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return world.run_world(4, CASES, tmp_path_factory.mktemp("parallel_scan"))


def _jax_mesh(shape):
    from distantspeech_tpu.parallel import make_mesh

    return make_mesh(*shape, devices=jax.devices()[:4])


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


def _same_on_every_rank(res):
    for r in res[1:]:
        np.testing.assert_array_equal(r["y"], res[0]["y"])


@pytest.mark.parametrize("shape", ENHANCE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_enhance_matches_jax(ranks, shape):
    from distantspeech_tpu.array.geometry import ArrayGeometry
    from distantspeech_tpu.beamform.enhance import EnhanceConfig
    from distantspeech_tpu.parallel import make_sharded_enhance

    res = ranks[f"enhance@{shape[0]}x{shape[1]}"]
    _same_on_every_rank(res)
    x = world.inputs("enhance")
    want = np.asarray(make_sharded_enhance(_jax_mesh(shape), ArrayGeometry.linear(4, 0.032), (90.0, 0.0),
                                           EnhanceConfig())(jnp.asarray(x)))
    assert res[0]["y"].dtype == np.float64 and res[0]["y"].shape == want.shape
    assert _rel(res[0]["y"], want) <= RECURSION


@pytest.mark.parametrize("shape", ENHANCE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_enhance_matches_unsharded(ranks, shape):
    """Against ``enhance_process`` on the same rank: the same operations
    but on the complex128 steering vector where the runner takes JAX's
    complex64 one."""
    r = ranks[f"enhance@{shape[0]}x{shape[1]}"][0]
    assert _rel(r["y"], r["single"]) <= RECURSION


@pytest.mark.parametrize("shape", WPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_wpe_matches_jax(ranks, shape):
    from distantspeech_tpu.derev.wpe import WpeConfig
    from distantspeech_tpu.parallel import make_sharded_wpe

    res = ranks[f"wpe@{shape[0]}x{shape[1]}"]
    _same_on_every_rank(res)
    cfg = WpeConfig(num_bands=64, hop=32, n_channels=2, filter_len=2, delay=2)
    want = np.asarray(make_sharded_wpe(_jax_mesh(shape), cfg)(jnp.asarray(world.inputs("wpe"))))
    assert res[0]["y"].dtype == np.float64 and res[0]["y"].shape == want.shape
    assert _rel(res[0]["y"], want) <= RECURSION


@pytest.mark.parametrize("shape", WPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_wpe_matches_unsharded(ranks, shape):
    r = ranks[f"wpe@{shape[0]}x{shape[1]}"][0]
    assert _rel(r["y"], r["single"]) <= RECURSION
