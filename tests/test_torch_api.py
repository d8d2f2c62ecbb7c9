"""Port parity for public functions of modules the port already had:
``cart2sph``, ``magphase``, ``update_psd`` / ``update_csd`` (with
``_pair_indices``), ``diag_loaded_inv``, ``stage_metrics`` and the ``axis``
argument of ``rdft`` / ``irdft``, each against its ``distantspeech_tpu``
twin in float64 on the CPU, to 1e-12 of the output scale; and ``trace`` on
``torch.profiler``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array import geometry as jgeo
from distantspeech_tpu.ops import dft as jdft
from distantspeech_tpu.runtime import profiling as jprof
from distantspeech_tpu.stats import linalg as jlin, psd as jpsd
from distantspeech_tpu.transform import stft as jstft
from distantspeech_tpu_torch.array import geometry as tgeo
from distantspeech_tpu_torch.ops import dft as tdft
from distantspeech_tpu_torch.runtime import profiling as tprof
from distantspeech_tpu_torch.stats import linalg as tlin, psd as tpsd
from distantspeech_tpu_torch.transform import stft as tstft

TOL = 1e-12


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.max(np.abs(want)), 1e-300))


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def case_cart2sph(rng):
    xyz = rng.standard_normal((3, 7))
    for got, want in zip(tgeo.cart2sph(*xyz), jgeo.cart2sph(*xyz)):
        _close(got, want)


def case_magphase(rng):
    D = _complex(rng, (2, 9, 5))
    for power in (1, 2):
        mag, ph = tstft.magphase(torch.as_tensor(D), power)
        jmag, jph = jstft.magphase(jnp.asarray(D), power)
        _close(mag, jmag)
        _close(ph, jph)


def case_update_psd(rng):
    Z, P = _complex(rng, (2, 9, 4)), rng.random((2, 9, 4))
    _close(tpsd.update_psd(torch.as_tensor(Z), torch.as_tensor(P), 0.7), jpsd.update_psd(jnp.asarray(Z), jnp.asarray(P), 0.7))


def case_update_csd(rng):
    C = 5
    Z, P = _complex(rng, (2, 9, C)), _complex(rng, (2, 9, C * (C - 1) // 2))
    for got, want in zip(tpsd._pair_indices(C), jpsd._pair_indices(C)):
        np.testing.assert_array_equal(got, want)
    _close(tpsd.update_csd(torch.as_tensor(Z), torch.as_tensor(P)), jpsd.update_csd(jnp.asarray(Z), jnp.asarray(P)))


def case_diag_loaded_inv(rng):
    X = _complex(rng, (3, 4, 6))
    A = X @ np.conj(np.swapaxes(X, -1, -2)) / 6  # hermitian, positive semi-definite
    _close(tlin.diag_loaded_inv(torch.as_tensor(A), 1e-2), jlin.diag_loaded_inv(jnp.asarray(A), 1e-2))


def case_dft_axis(rng):
    x = rng.standard_normal((2, 3, 16))
    for n in (None, 12, 20, 4096):
        for axis in (-1, x.ndim - 1):
            X = tdft.rdft(torch.as_tensor(x), n=n, axis=axis)
            _close(X, jdft.rdft(jnp.asarray(x), n=n, axis=axis))
            _close(tdft.irdft(X, n=n, axis=axis), jdft.irdft(jnp.asarray(X.numpy()), n=n, axis=axis))
    with pytest.raises(ValueError):
        tdft.rdft(torch.as_tensor(x), axis=0)
    with pytest.raises(ValueError):
        tdft.irdft(torch.as_tensor(_complex(rng, (2, 9))), axis=0)


def case_stage_metrics(rng):
    a, b, p = rng.standard_normal(400), 0.5 * rng.standard_normal(400), rng.random((10, 5))
    for args in ((a, b), (a, b, p)):
        got, want = tprof.stage_metrics("stage", *args), jprof.stage_metrics("stage", *args)
        assert got.keys() == want.keys()
        for k in want:
            if k == "stage":
                assert got[k] == want[k]
            else:
                _close(got[k], want[k])


CASES = {f.__name__[5:]: f for f in (case_cart2sph, case_magphase, case_update_psd, case_update_csd,
                                     case_diag_loaded_inv, case_dft_axis, case_stage_metrics)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    CASES[name](np.random.default_rng(sorted(CASES).index(name)))


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert "traceEvents" in json.loads((tmp_path / "trace.json").read_text())
