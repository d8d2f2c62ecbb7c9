"""Port parity for ``stats/weights.py`` (all nine formulas), ``stats/metrics.py``
(``array_gain``, ``wng_di``, ``beampattern``), ``stats/evaluation.py`` and
``beamform/ccaf.py`` (the port's numpy copies): each against its
``distantspeech_tpu`` twin in float64 on the CPU, to 1e-10 of the output's
scale (closed forms).  ``gev_weights`` is compared up to a unit phase per
bin, the freedom an eigensolver has.  Also: every Config dataclass of the
slice matches JAX's field for field, defaults included."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import ccaf as jccaf
from distantspeech_tpu.stats import evaluation as jev, metrics as jmet, weights as jw
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import ccaf as tccaf
from distantspeech_tpu_torch.stats import evaluation as tev, metrics as tmet, weights as tw

TOL = 1e-10  # closed forms, float64


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1e-300))


def _cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _psd(rng, F, M, load=1.0):
    A = _cplx(rng, (F, M, M))
    return A @ np.conj(np.swapaxes(A, -1, -2)) + load * np.eye(M)


T_ = torch.as_tensor
J_ = jnp.asarray


def case_diag_load_inv(rng):
    R = _psd(rng, 65, 4)
    _close(tw.diag_load_inv(T_(R), 1e-2), jw.diag_load_inv(J_(R), 1e-2))


def case_mvdr_weights(rng):
    a, Ri = _cplx(rng, (2, 65, 4)), np.linalg.inv(_psd(rng, 65, 4))
    _close(tw.mvdr_weights(T_(a), T_(Ri)), jw.mvdr_weights(J_(a), J_(Ri)))


def case_ds_weights(rng):
    a = _cplx(rng, (65, 3))
    _close(tw.ds_weights(T_(a)), jw.ds_weights(J_(a)))


def case_pmwf_weights(rng):
    xi, Rxx, Ri = rng.uniform(0.01, 10.0, 129), _psd(rng, 129, 4), np.linalg.inv(_psd(rng, 129, 4))
    for beta in (1.0, 10.0):
        _close(tw.pmwf_weights(T_(xi), T_(Rxx), T_(Ri), beta), jw.pmwf_weights(J_(xi), J_(Rxx), J_(Ri), beta))


def case_tfgsc_weights(rng):
    Ri, Ryy = np.linalg.inv(_psd(rng, 65, 4)), _psd(rng, 65, 4)
    _close(tw.tfgsc_weights(T_(Ri), T_(Ryy)), jw.tfgsc_weights(J_(Ri), J_(Ryy)))


def case_blind_analytic_normalization(rng):
    w, Rvv = _cplx(rng, (129, 4)), _psd(rng, 129, 4)
    for eps in (0.0, 1e-3):
        _close(tw.blind_analytic_normalization(T_(w), T_(Rvv), eps), jw.blind_analytic_normalization(J_(w), J_(Rvv), eps))


def case_gev_weights(rng):
    Rxx, Rvv = _psd(rng, 65, 4), _psd(rng, 65, 4)
    got = tw.gev_weights(T_(Rxx), T_(Rvv)).numpy()
    want = np.asarray(jw.gev_weights(J_(Rxx), J_(Rvv)))
    phase = np.exp(1j * np.angle(np.einsum("fm,fm->f", got.conj(), want)))
    _close(got * phase[:, None], want)
    n = np.einsum("fa,fab,fb->f", got.conj(), Rvv, got)  # the normalisation w^H Rvv w = 1
    np.testing.assert_allclose(n, 1.0, rtol=0, atol=TOL)


def case_phase_correction(rng):
    w = _cplx(rng, (2, 65, 4))
    _close(tw.phase_correction(T_(w)), jw.phase_correction(J_(w)))


def case_pca_steering(rng):
    Rxx = _psd(rng, 129, 4)
    _close(tw.pca_steering(T_(Rxx)), jw.pca_steering(J_(Rxx)))
    a = np.exp(1j * rng.uniform(-np.pi, np.pi, (65, 6)))  # a rank-1 covariance gives back its direction
    R1 = 4.0 * a[..., :, None] * np.conj(a[..., None, :]) + 1e-6 * np.eye(6)
    _close(tw.pca_steering(T_(R1)), jw.pca_steering(J_(R1)))


def case_array_gain(rng):
    w, a, Rvv = _cplx(rng, (129, 4)), _cplx(rng, (129, 4)), _psd(rng, 129, 4)
    for db in (False, True):
        _close(tmet.array_gain(T_(w), T_(a), T_(Rvv), db), jmet.array_gain(J_(w), J_(a), J_(Rvv), db))


GEOMS = (("circular", 4, 0.032), ("linear", 4, 0.032), ("linear", 8, 0.05))


def _geoms(kind, M, d):
    return getattr(TGeometry, kind)(M, d), getattr(JGeometry, kind)(M, d)


def case_wng_di(rng):
    for kind, M, d in GEOMS:
        tg, jg = _geoms(kind, M, d)
        W = _cplx(rng, (129, M))
        for db in (True, False):
            for g, w in zip(tmet.wng_di(tg, T_(W), (60.0, 0.0), 256, db), jmet.wng_di(jg, J_(W), (60.0, 0.0), 256, db)):
                _close(g, w)


def case_beampattern(rng):
    for kind, M, d in GEOMS:
        tg, jg = _geoms(kind, M, d)
        W = _cplx(rng, (129, M))
        _close(tmet.beampattern(tg, T_(W), 256), jmet.beampattern(jg, J_(W), 256))
        _close(tmet.beampattern(tg, T_(W), 256, 72), jmet.beampattern(jg, J_(W), 256, 72))


def case_evaluation(rng):
    ref = rng.standard_normal(3000)
    est = np.roll(ref, 37) * 0.7 + 0.2 * rng.standard_normal(3000)
    for name in ("si_sdr", "snr_db", "segmental_snr_db"):
        assert getattr(tev, name)(est, ref) == getattr(jev, name)(est, ref)
    assert tev.best_aligned_si_sdr(est[:600], ref[:600], 64) == jev.best_aligned_si_sdr(est[:600], ref[:600], 64)
    for name in ("pesq_score", "stoi_score"):
        try:
            want = getattr(jev, name)(ref, est)
        except ImportError as e:
            with pytest.raises(ImportError, match=str(e).split(";")[0]):
                getattr(tev, name)(ref, est)
        else:
            assert getattr(tev, name)(ref, est) == want


def case_ccafbounds(rng):
    m = rng.standard_normal((3, 4)) * 0.05
    for kw in ({}, {"p": 129, "order": 256}, {"fs": 8000, "c": 340.0, "p": 3, "order": 17}):
        for g, w in zip(tccaf.ccafbounds(m, **kw), jccaf.ccafbounds(m, **kw)):
            np.testing.assert_array_equal(g, w)


CASES = {n[5:]: f for n, f in sorted(globals().items()) if n.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    CASES[name](np.random.default_rng(sorted(CASES).index(name)))


def _config_pairs():
    from distantspeech_tpu import beamform as jb, derev as jd, doa as jdoa, noise as jn, transform as jt
    from distantspeech_tpu_torch import beamform as tb, derev as td, doa as tdoa, noise as tn, transform as tt

    return [(getattr(tm, n), getattr(jm, n)) for tm, jm, names in (
        (tb, jb, ("FixedBeamformerConfig", "GscConfig", "PmwfConfig")),
        (tn, jn, ("McMcraConfig", "Mcra2Config")),
        (td, jd, ("WpeConfig",)),
        (tt, jt, ("SubbandConfig",)),
        (tdoa, jdoa, ("IdoaConfig",)),
    ) for n in names]


@pytest.mark.parametrize("i", range(8))
def test_config_fields_match_jax(i):
    tcls, jcls = _config_pairs()[i]
    tf, jf = dataclasses.fields(tcls), dataclasses.fields(jcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(dataclasses.astuple(tcls()), dataclasses.astuple(jcls())):
        assert a == b
    props = sorted(n for n, v in vars(jcls).items() if isinstance(v, property))
    assert props == sorted(n for n, v in vars(tcls).items() if isinstance(v, property))
