"""Port parity of the flagship scan path (``enhance_process(backend='scan')``)
against ``distantspeech_tpu``, float64 on the CPU, and a mid-utterance
handover of the JAX state into the port."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.array.steering import steering_vector as jsteering
from distantspeech_tpu.beamform import enhance as jenh
from distantspeech_tpu.beamform.mvdr import MvdrConfig as JMvdrConfig
from distantspeech_tpu.transform import analysis as janalysis
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import enhance as tenh
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig as TMvdrConfig

TOL = 1e-9
M = 4


def _scene(B, S, seed):
    rng = np.random.default_rng(seed)
    env = np.sin(2 * np.pi * 1.3 * np.arange(S) / 16000) > 0
    return 0.3 * rng.standard_normal((B, M, S)) + (env * rng.standard_normal(S))[None, None]


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(np.asarray(want))))


@pytest.mark.parametrize(
    "kw,frames",
    [
        (dict(mcra_L=15), 80),  # guard off, L=15: the reference-exact config
        (None, 160),  # EnhanceConfig() defaults: L=65, vad_guard, rel_diag=1e-5; T >= 2L
    ],
)
def test_enhance_scan_matches_jax(kw, frames):
    """In float64 the guard's S/Smin threshold sees the same values on both
    sides (to ~1e-15), so no decision flips and the tight tolerance holds
    for the guarded default config too."""
    x = _scene(2, 128 * frames, seed=frames)
    cfg_j = jenh.EnhanceConfig() if kw is None else jenh.EnhanceConfig(mvdr=JMvdrConfig(**kw))
    cfg_t = tenh.EnhanceConfig() if kw is None else tenh.EnhanceConfig(mvdr=TMvdrConfig(**kw))
    want = jenh.enhance_process(jnp.asarray(x), JGeometry.linear(M, 0.032), (90.0, 0.0), cfg_j)
    got = tenh.enhance_process(x, TGeometry.linear(M, 0.032), (90.0, 0.0), cfg_t, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float64
    assert _rel(got, want) <= TOL


def _as_dict(state):
    """A JAX state NamedTuple as nested dicts of numpy arrays."""
    if hasattr(state, "_asdict"):
        return {k: _as_dict(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def test_handover_mid_utterance():
    """JAX runs the first 50 frames; its config and state carry into the port,
    which runs the rest; the spliced output equals JAX's full run."""
    cfg_j = jenh.EnhanceConfig()
    cfg_t = convert.enhance_config_from_dict(dataclasses.asdict(cfg_j))
    assert cfg_t == tenh.EnhanceConfig()
    x = _scene(2, 128 * 140, seed=7)
    steer = jsteering(JGeometry.linear(M, 0.032), np.array([np.pi / 2, 0.0]), 256)
    X = janalysis(jnp.asarray(x), cfg_j.stft)
    Zt = np.asarray(jnp.moveaxis(jnp.moveaxis(X, -3, -1), -3, 0))  # [T, B, F, M]
    state0 = jenh.enhance_init(cfg_j, M, batch_shape=(2,), cdtype=jnp.complex128)
    _, Y_full = jenh.enhance_scan(cfg_j, jnp.asarray(steer), state0, jnp.asarray(Zt))
    state50, Y_head = jenh.enhance_scan(cfg_j, jnp.asarray(steer), state0, jnp.asarray(Zt[:50]))

    st = convert.enhance_state_from_numpy(_as_dict(state50), device="cpu")
    assert st.mvdr.mcra.frm_cnt == 50
    _, Y_tail = tenh.enhance_scan(cfg_t, torch.as_tensor(steer), st, torch.as_tensor(Zt[50:]))
    Y = np.concatenate([np.asarray(Y_head), Y_tail.numpy()])
    assert _rel(Y, Y_full) <= TOL
