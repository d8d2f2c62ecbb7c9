"""Port parity for ``adaptive/nlms.py``, ``transform/multirate.py`` and
``transform/griffin_lim.py`` against their ``distantspeech_tpu`` twins on
the CPU:

- NLMS (normalised or not), block LMS and RLS at L = 16 taps x 400 samples
  of a batch of two, in float64, errors and weights to 1e-9 of the scale;
  the hand-over of ``RlsState`` and ``BlockLmsState`` (its counter a host
  int, carried mid block) through ``convert``: JAX for half the samples,
  the port for the rest, against JAX's whole run;
- ``awgn``, ``low_pass``, ``resample`` and ``frac_delay`` (host NumPy /
  SciPy copies) bit-equal; ``overlap_save`` to 1e-12 of the scale;
- ``griffin_lim`` on both branches: with ``init_phase`` (float64 kept) to
  1e-9 after 8 iterations; without it (the loop in complex64, as JAX casts
  the magnitude) to 1e-5 after 2 iterations and, after 8, within JAX's own
  complex64-vs-complex128 gap on the same input (the iteration amplifies
  float32 rounding, so that gap is about 1e-3 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.adaptive import nlms as jn
from distantspeech_tpu.transform import griffin_lim as jgl, multirate as jmr
from distantspeech_tpu.transform.stft import StftConfig as JStft, analysis as janalysis
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.adaptive import nlms as tn
from distantspeech_tpu_torch.transform import griffin_lim as tgl, multirate as tmr
from distantspeech_tpu_torch.transform.stft import StftConfig as TStft

TOL = 1e-9
L, N = 16, 400


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1e-300))


def _system(seed=0):
    """x [2, N] white input, d [2, N] its response through a random 16-tap
    filter plus a little noise."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, N))
    h = rng.standard_normal(L) * 0.3
    d = np.stack([np.convolve(xi, h)[:N] for xi in x]) + 0.01 * rng.standard_normal((2, N))
    return x, d


@pytest.mark.parametrize("normalize", [True, False])
def test_nlms_filter(normalize):
    x, d = _system()
    mu = 0.1 if normalize else 0.01
    ej, wj = jn.nlms_filter(jnp.asarray(x), jnp.asarray(d), L, mu=mu, normalize=normalize)
    et, wt = tn.nlms_filter(x, d, L, mu=mu, normalize=normalize, device="cpu")
    _close(et, ej)
    _close(wt, wj)


def test_rls_filter():
    x, d = _system(1)
    ej, wj = jn.rls_filter(jnp.asarray(x), jnp.asarray(d), L)
    et, wt = tn.rls_filter(x, d, L, device="cpu")
    _close(et, ej)
    _close(wt, wj)


def _state_dict(s):
    return {k: np.array(v) for k, v in s._asdict().items()}


@pytest.mark.parametrize("kind", ["block_lms", "rls"])
def test_state_hand_over(kind):
    """JAX's steps over the first 203 samples (mid block for block LMS, whose
    block is 8), the state carried across, the port's steps over the rest:
    JAX's whole run, sample for sample."""
    x, d = _system(2)
    if kind == "block_lms":
        jinit = lambda: jn.block_lms_init(L, 8, (2,), dtype=jnp.float64)
        jstep, tstep, conv = jn.block_lms_step, tn.block_lms_step, convert.block_lms_state_from_numpy
    else:
        jinit = lambda: jn.rls_init(L, batch_shape=(2,), dtype=jnp.float64)
        jstep, tstep, conv = jn.rls_step, tn.rls_step, convert.rls_state_from_numpy
    step = jax.jit(jstep)
    _, e_all = jax.lax.scan(lambda s, xd: step(s, xd[0], xd[1]), jinit(), (jnp.asarray(x.T), jnp.asarray(d.T)))
    half = 203
    js = jinit()
    for n in range(half):
        js, _ = step(js, jnp.asarray(x[:, n]), jnp.asarray(d[:, n]))
    ts = conv(_state_dict(js), "cpu")
    if kind == "block_lms":
        assert isinstance(ts.counter, int) and ts.counter == int(js.counter) == 3  # 3 samples into a block
    errs = []
    for n in range(half, N):
        ts, e = tstep(ts, torch.as_tensor(x[:, n]), torch.as_tensor(d[:, n]))
        errs.append(e)
    _close(torch.stack(errs), np.asarray(e_all)[half:])


def test_block_lms_steps():
    x, d = _system(3)
    js, ts = jn.block_lms_init(L, 8, (2,), dtype=jnp.float64), tn.block_lms_init(L, 8, (2,), torch.float64, "cpu")
    step = jax.jit(jn.block_lms_step)
    want, got = [], []
    for n in range(N):
        js, ej = step(js, jnp.asarray(x[:, n]), jnp.asarray(d[:, n]))
        ts, et = tn.block_lms_step(ts, torch.as_tensor(x[:, n]), torch.as_tensor(d[:, n]))
        want.append(np.asarray(ej))
        got.append(et)
    _close(torch.stack(got), np.stack(want))
    _close(ts.w, js.w)
    assert ts.counter == int(js.counter)


def test_nlms_state_converts():
    js = jn.NlmsState(w=jnp.arange(4.0), buf=jnp.ones(4))
    ts = convert.nlms_state_from_numpy(_state_dict(js), "cpu")
    assert torch.equal(ts.w, torch.arange(4.0, dtype=torch.float64)) and torch.equal(ts.buf, torch.ones(4, dtype=torch.float64))


def test_host_helpers_bit_equal():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(1000)
    np.testing.assert_array_equal(tn.awgn(x, 10.0), jn.awgn(x, 10.0))
    np.testing.assert_array_equal(tn.awgn(x, 3.0, seed=11), jn.awgn(x, 3.0, seed=11))
    np.testing.assert_array_equal(tmr.low_pass(41, 0.25), jmr.low_pass(41, 0.25))
    for p, q in ((3, 2), (2, 3), (4, 6)):
        np.testing.assert_array_equal(tmr.resample(x, p, q), jmr.resample(x, p, q))
    for delta, n in ((0.3, 8), (2.7, 12)):
        np.testing.assert_array_equal(tmr.frac_delay(delta, n), jmr.frac_delay(delta, n))


@pytest.mark.parametrize("stride,pad_start", [(4, True), (16, True), (4, False)])
def test_overlap_save(stride, pad_start):
    rng = np.random.default_rng(5)
    x, f = rng.standard_normal((2, 3, 1000)), rng.standard_normal(31)
    want = jmr.overlap_save(jnp.asarray(x), jnp.asarray(f), stride, pad_start)
    _close(tmr.overlap_save(x, f, stride, pad_start, device="cpu"), want, 1e-12)


def _magnitude(seed=6):
    x = np.random.default_rng(seed).standard_normal((3, 2048))
    return np.abs(np.asarray(janalysis(jnp.asarray(x), JStft())))  # [3, T, F] float64


def test_griffin_lim_init_phase():
    mag = _magnitude()
    phase = np.exp(1j * np.random.default_rng(7).uniform(-np.pi, np.pi, mag.shape))
    want = jgl.griffin_lim(jnp.asarray(mag), JStft(), 8, jnp.asarray(phase))
    got = tgl.griffin_lim(mag, TStft(), 8, phase, device="cpu")
    assert got.dtype == torch.float64
    _close(got, want)


@pytest.mark.parametrize("n_iter", [2, 8])
def test_griffin_lim_zero_phase(n_iter):
    mag = _magnitude()
    want = np.asarray(jgl.griffin_lim(jnp.asarray(mag), JStft(), n_iter))
    got = tgl.griffin_lim(mag, TStft(), n_iter, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == np.float32
    if n_iter == 2:
        tol = 1e-5
    else:  # JAX's own complex64 run against the same loop in complex128 (init_phase = 1 keeps float64)
        want64 = np.asarray(jgl.griffin_lim(jnp.asarray(mag), JStft(), n_iter, jnp.ones(mag.shape, jnp.complex128)))
        tol = float(np.max(np.abs(want - want64)) / np.max(np.abs(want64)))
    _close(got, want, tol)
