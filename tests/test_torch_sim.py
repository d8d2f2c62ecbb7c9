"""Port parity for ``sim/room.py`` (a host NumPy copy: every function
bit-equal to the JAX package's) and ``sim/ism.py`` (``batched_rir``,
``batched_propagation``, float32 by construction) against JAX's jitted
twins to 1e-5 of the output's scale, and against the host image-source
model at JAX's own tolerances (``tests/test_runtime_sim.py``): 2e-4 of the
scale for the RIRs, 5e-4 for the propagated signals.  The batched RIR is
also checked with its sources taken in several groups."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu import sim as jsim
from distantspeech_tpu_torch import sim as tsim
from distantspeech_tpu_torch.sim import ism as tism

MICS = np.array([[2.5, 1.5, 0.5], [2.53, 1.5, 0.5], [2.56, 1.5, 0.5]])
SRCS = np.array([[3.5, 1.5, 0.5], [1.2, 2.1, 0.8], [4.1, 0.7, 1.2], [2.0, 1.0, 2.0]])


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.max(np.abs(want)))


def test_room_functions_bit_equal():
    for cfg_kw in ({}, dict(max_order=1, energy_absorption=0.3), dict(rir_length=700)):
        jc, tc = jsim.RoomConfig(**cfg_kw), tsim.RoomConfig(**cfg_kw)
        assert jc.reflection == tc.reflection and jsim.sabine_rt60(jc) == tsim.sabine_rt60(tc)
        np.testing.assert_array_equal(tsim.image_source_rir(SRCS[1], MICS, tc), jsim.image_source_rir(SRCS[1], MICS, jc))
    cfg_j, cfg_t = jsim.RoomConfig(max_order=1), tsim.RoomConfig(max_order=1)
    np.testing.assert_array_equal(tsim.hybrid_rir(SRCS[0], MICS, cfg_t, seed=3), jsim.hybrid_rir(SRCS[0], MICS, cfg_j, seed=3))
    sig = np.random.default_rng(0).standard_normal(3000)
    for tail in (False, True):
        np.testing.assert_array_equal(tsim.simulate_propagation(sig, SRCS[2], MICS, cfg_t, diffuse_tail=tail),
                                      jsim.simulate_propagation(sig, SRCS[2], MICS, cfg_j, diffuse_tail=tail))
    mics = MICS - MICS.mean(axis=0)
    np.testing.assert_array_equal(tsim.generate_scene(sig, mics, snr=20, sir=10, cfg=cfg_t, seed=5),
                                  jsim.generate_scene(sig, mics, snr=20, sir=10, cfg=cfg_j, seed=5))
    assert tsim.default_rir_length(cfg_t) == jsim.default_rir_length(cfg_j)


@pytest.mark.parametrize("max_elems", [None, 3 * 1600 * 64])
def test_batched_rir(max_elems, monkeypatch):
    if max_elems is not None:  # one source a group
        monkeypatch.setattr(tism, "_MAX_ELEMS", max_elems)
    cfg_kw = dict(max_order=2, rir_length=1600)
    want = np.asarray(jsim.batched_rir(jnp.asarray(SRCS), jnp.asarray(MICS), jsim.RoomConfig(**cfg_kw)))
    got = tsim.batched_rir(SRCS, MICS, tsim.RoomConfig(**cfg_kw), device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 3, 1600)
    _close(got, want, 1e-5)
    for b in range(4):
        _close(got[b], tsim.image_source_rir(SRCS[b], MICS, tsim.RoomConfig(**cfg_kw)), 2e-4)


def test_batched_propagation():
    cfg_kw = dict(max_order=1, rir_length=900)
    sig = np.random.default_rng(4).standard_normal((2, 4000)).astype(np.float32)
    mics, srcs = MICS[:2], SRCS[:2]
    want = np.asarray(jsim.batched_propagation(jnp.asarray(sig), jnp.asarray(srcs), jnp.asarray(mics),
                                               jsim.RoomConfig(**cfg_kw)))
    got = tsim.batched_propagation(sig, srcs, mics, tsim.RoomConfig(**cfg_kw), device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2, 4000)
    _close(got, want, 1e-5)
    for b in range(2):
        _close(got[b], tsim.simulate_propagation(sig[b], srcs[b], mics, tsim.RoomConfig(**cfg_kw)), 5e-4)
