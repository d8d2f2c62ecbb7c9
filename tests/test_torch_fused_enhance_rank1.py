"""inv_mode='rank1' of the port's fused paths past the warmup: S = 128*160
frames with t_chunk=16 is 4 warm chunks (64 frames of exact LDL^H) and 6
steady chunks of Bennett factor updates, with the rel_diag loading
re-anchored at the start of 5 of them.  Compared with the JAX mega kernel
(Pallas interpreter) at the same t_chunk."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distantspeech_tpu.beamform import enhance as jenh
from distantspeech_tpu.beamform.mvdr import MvdrConfig as JMvdrConfig
from distantspeech_tpu.ops.pallas_enhance import fused_enhance_full as j_full
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.beamform import enhance as tenh
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig as TMvdrConfig
from distantspeech_tpu_torch.ops import cuda_enhance as ce

B, M, T, TC = 8, 4, 160, 16


@pytest.mark.parametrize(
    "vad_guard,tol",
    [
        (False, 1e-3),  # the tight gate: only float32 rounding separates the two
        # the guard thresholds the raw ratio S/Smin, so an ulp of difference
        # can flip a lane's hold/update decision: decision-flip tolerance
        (True, 2e-2),
    ],
)
def test_rank1_steady_path_matches_jax(monkeypatch, vad_guard, tol):
    kw = dict(mcra_L=15, rel_diag=1e-5, vad_guard=vad_guard)
    rng = np.random.default_rng(5)
    S = 128 * T
    env = np.sin(2 * np.pi * 1.3 * np.arange(S) / 16000) > 0
    x = (0.3 * rng.standard_normal((B, M, S)) + (env * rng.standard_normal(S))[None, None]).astype(np.float32)
    steer = steering_vector(ArrayGeometry.linear(M, 0.032), np.array([np.pi / 2, 0.0]), 256).astype(np.complex64)
    cfg = tenh.EnhanceConfig(mvdr=TMvdrConfig(**kw))

    calls = {"refresh": 0, "factor": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ce, "_refresh_loading", spy("refresh", ce._refresh_loading))
    monkeypatch.setattr(ce, "_ldl_factor_into", spy("factor", ce._ldl_factor_into))
    got = ce.fused_enhance_plain(torch.as_tensor(x), steer, cfg, t_chunk=TC, inv_mode="rank1").numpy()
    assert ce._warm_chunks(TC) == 4
    assert calls == {"refresh": 5, "factor": 1}  # one handover, re-anchors at chunks 5..9

    ldl = ce.fused_enhance_plain(torch.as_tensor(x), steer, cfg, t_chunk=TC, inv_mode="ldl").numpy()
    assert not np.array_equal(got, ldl)  # the steady path ran: rank1 is not the LDL run

    want = np.asarray(j_full(jnp.asarray(x), steer, jenh.EnhanceConfig(mvdr=JMvdrConfig(**kw)),
                             interpret=True, t_chunk=TC, inv_mode="rank1"))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))
