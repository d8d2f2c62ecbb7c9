"""Port parity for ``beamform/dios_gsc.py`` against its ``distantspeech_tpu``
twin in float64 on the CPU, to 1e-9 of the output's scale: ``dios_abm_step``
and ``dios_aic_step`` over 40 segments of a batch of two with random
step-size controls (every output, then the final state; the port's segment
counter is a host int); ``dios_gsc_process`` at 4 mics x 0.25 s with and
without controls; the port's own segment-at-a-time composition of the two
steps against its pair-stepped ``dios_gsc_process`` (the twin of
``tests/test_dios_gsc.py::test_dios_process_pairing``); and the hand-over:
JAX's steps for 21 segments (an odd count, so the ABM's counter is 1 mid
pair), ``DiosGscState`` carried across by ``convert.dios_gsc_state_from_numpy``
(the counter as an int), the port's steps for the rest, against JAX's
``dios_gsc_process`` over the whole signal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.alignment import time_alignment_filters
from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import dios_gsc as jd
from distantspeech_tpu.ops.fir import fir_filter_block as jfir
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.beamform import dios_gsc as td
from distantspeech_tpu_torch.ops.fir import fir_filter_block as tfir

TOL = 1e-9
CFG_J, CFG_T = jd.DiosGscConfig(), td.DiosGscConfig()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1e-300))


def _state_dict(s):
    return {k: _state_dict(v) for k, v in s._asdict().items()} if hasattr(s, "_asdict") else np.array(s)


def _coeffs():
    return np.asarray(time_alignment_filters(JGeometry.linear(4, 0.032), (np.pi / 2, 0.0)), dtype=np.float64)


def _segments(n_seg=40, B=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_seg, B, 4, CFG_J.seg))
    xref = rng.standard_normal((n_seg, B, CFG_J.seg)) * 0.5
    ctrl_abm = rng.uniform(0.0, 1.0, (n_seg, CFG_J.half_bin))
    ctrl_aic = rng.uniform(0.0, 1.0, (n_seg, CFG_J.half_bin))
    return X, xref, ctrl_abm, ctrl_aic


@pytest.mark.parametrize("module", ["abm", "aic"])
def test_dios_steps(module):
    X, xref, ca, ci = _segments()
    jinit, jstep = getattr(jd, f"dios_{module}_init"), jax.jit(getattr(jd, f"dios_{module}_step"), static_argnums=0)
    tinit, tstep = getattr(td, f"dios_{module}_init"), getattr(td, f"dios_{module}_step")
    js, ts = jinit(CFG_J, (2,)), tinit(CFG_T, (2,), device="cpu")
    want, got = [], []
    for n in range(X.shape[0]):
        js, oj = jstep(CFG_J, js, *(jnp.asarray(a[n]) for a in (X, xref, ca, ci)))
        ts, ot = tstep(CFG_T, ts, *(torch.as_tensor(a[n]) for a in (X, xref, ca, ci)))
        want.append(np.asarray(oj))
        got.append(ot)
    _close(torch.stack(got), np.stack(want))  # every segment, to the scale of the whole run
    for name in ts._fields:
        if name == "count":
            assert isinstance(ts.count, int) and ts.count == int(js.count)
        else:
            _close(getattr(ts, name), getattr(js, name))


@pytest.mark.parametrize("controls", [False, True])
def test_dios_gsc_process(controls):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 4000))
    ctrl = [rng.uniform(0.0, 1.0, (250, CFG_J.half_bin)) for _ in range(2)] if controls else [None, None]
    oj, bj = jd.dios_gsc_process(jnp.asarray(x), jnp.asarray(_coeffs()), CFG_J,
                                 *(None if c is None else jnp.asarray(c) for c in ctrl))
    ot, bt = td.dios_gsc_process(x, _coeffs(), CFG_T, *ctrl, device="cpu")
    _close(ot, oj)
    _close(bt, bj)


def _port_segments(x, coeffs, state, start, stop, ctrl):
    """The port's steps, one segment at a time, from ``state``."""
    seg, ones = CFG_T.seg, torch.ones(CFG_T.half_bin, dtype=torch.float64)
    abm, aic, cache = state
    outs = []
    for t in range(start, stop):
        cache, aligned = tfir(cache, torch.as_tensor(x[..., t * seg : (t + 1) * seg]), torch.as_tensor(coeffs))
        fbf = torch.mean(aligned, dim=-2)
        ca = ones if ctrl is None else torch.as_tensor(ctrl[0][t])
        ci = ones if ctrl is None else torch.as_tensor(ctrl[1][t])
        abm, bm = td.dios_abm_step(CFG_T, abm, aligned, fbf, ca, ci)
        aic, out = td.dios_aic_step(CFG_T, aic, torch.movedim(bm, -1, -2), fbf, ca, ci)
        outs.append(out)
    return td.DiosGscState(abm=abm, aic=aic, fir_cache=cache), torch.cat(outs, dim=-1)


def test_dios_process_pairing():
    """The pair-stepped process composes dios_abm_step / dios_aic_step, one
    segment at a time."""
    rng = np.random.default_rng(2)
    T = 40
    x = rng.standard_normal((4, T * CFG_T.seg))
    out, _ = td.dios_gsc_process(x, _coeffs(), CFG_T, device="cpu")
    state = td.DiosGscState(abm=td.dios_abm_init(CFG_T, device="cpu"), aic=td.dios_aic_init(CFG_T, device="cpu"),
                            fir_cache=torch.zeros((4, _coeffs().shape[-1] - 1), dtype=torch.float64))
    _, want = _port_segments(x, _coeffs(), state, 0, T, None)
    _close(out, want)


@pytest.mark.parametrize("controls", [False, True])
def test_dios_state_hand_over(controls):
    rng = np.random.default_rng(3)
    T, half = 60, 21
    x = rng.standard_normal((2, 4, T * CFG_J.seg))
    ctrl = [rng.uniform(0.0, 1.0, (T, CFG_J.half_bin)) for _ in range(2)] if controls else None
    coeffs = _coeffs()
    want, _ = jd.dios_gsc_process(jnp.asarray(x), jnp.asarray(coeffs), CFG_J,
                                  *((None, None) if ctrl is None else (jnp.asarray(c) for c in ctrl)))

    abm_step, aic_step = (jax.jit(f, static_argnums=0) for f in (jd.dios_abm_step, jd.dios_aic_step))
    seg, ones = CFG_J.seg, jnp.ones(CFG_J.half_bin)
    abm, aic = jd.dios_abm_init(CFG_J, (2,)), jd.dios_aic_init(CFG_J, (2,))
    cache = jnp.zeros((2, 4, coeffs.shape[-1] - 1))
    for t in range(half):
        cache, aligned = jfir(cache, jnp.asarray(x[..., t * seg : (t + 1) * seg]), jnp.asarray(coeffs))
        fbf = jnp.mean(aligned, axis=-2)
        ca, ci = (ones, ones) if ctrl is None else (jnp.asarray(ctrl[0][t]), jnp.asarray(ctrl[1][t]))
        abm, bm = abm_step(CFG_J, abm, aligned, fbf, ca, ci)
        aic, _ = aic_step(CFG_J, aic, jnp.moveaxis(bm, -1, -2), fbf, ca, ci)
    ts = convert.dios_gsc_state_from_numpy(_state_dict(jd.DiosGscState(abm=abm, aic=aic, fir_cache=cache)), "cpu")
    assert isinstance(ts.abm.count, int) and ts.abm.count == 1
    _, got = _port_segments(x, coeffs, ts, half, T, ctrl)
    _close(got, np.asarray(want)[..., half * seg :])


def test_dios_config_from_dict():
    kw = dict(n_mics=2, fftsize=256, aic_maxnorm=0.004)
    cfg = convert.dios_gsc_config_from_dict(kw)
    assert cfg == td.DiosGscConfig(**kw) and cfg.seg == jd.DiosGscConfig(**kw).seg
    for a, b in zip(cfg.abm_bounds(), jd.DiosGscConfig(**kw).abm_bounds()):
        np.testing.assert_array_equal(a, b)
