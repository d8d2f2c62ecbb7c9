"""Port parity for ``coherence/weights.py`` (``coherent_gain``),
``coherence/enhance.py`` (``binaural_step``, ``binaural_process``) and
``postfilter/mccowan.py`` (``mccowan_gain``, ``mccowan_process`` behind the
DS ``fixed_process``), each against its ``distantspeech_tpu`` twin in
float64 on the CPU, to 1e-9 of the output's scale (the largest finite
|value| of JAX's output).  ``coherent_gain`` runs every method on
coherences that include exact +-1, 0, NaN and +-inf components, so that
the rules' divisions give NaN and +-inf gains before the clamps.
``binaural_process`` runs methods 3 and 5 (method 2 divides by 1 - Re, which
is a rounding residue at the bins where the estimate is exactly +-1, so
its process output follows the last bit of the PSDs).  And the hand-over:
JAX's ``binaural_step`` for half the frames, its ``MscState`` carried across
by ``convert.msc_state_from_numpy``, the port for the rest, against JAX's
whole run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import fixed as jfixed
from distantspeech_tpu.coherence import enhance as jenh, msc as jmsc, weights as jw
from distantspeech_tpu.postfilter import mccowan as jmc
from distantspeech_tpu.transform import analysis as janalysis
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.array.coherence import diffuse_coherence
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import fixed as tfixed
from distantspeech_tpu_torch.coherence import enhance as tenh, weights as tw
from distantspeech_tpu_torch.postfilter import mccowan as tmc

TOL = 1e-9


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    finite = np.isfinite(want)
    scale = max(np.max(np.abs(want[finite])), 1e-300) if finite.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _coherences(F=129, seed=0):
    """[4, F] complex estimates: three rows of random coherences inside and
    around the unit circle, and a row of edge entries: method 2 divides by
    2 (1 - Re), so Re = 1 gives 0/0 = NaN and -x/0 = -inf, and an
    overflowing numerator over 1 - Re = -ulp gives +inf; and NaN and +-inf
    components."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(0.0, 1.2, (3, F))
    est = mag * np.exp(1j * rng.uniform(-np.pi, np.pi, (3, F)))
    edge = np.array([1.0, 1.0 + 0.5j, -1.0, 0.0, 1j, np.nan, np.inf, -np.inf, 1j * np.inf, -1j * np.inf,
                     complex(np.nan, 0.3), complex(0.999, 0.0), complex(0.998, 1e-9), 10.0 + 10.0j,
                     complex(1.0 + 2.0**-52, 1e200)], dtype=complex)  # the last: method 2's G is +inf
    row = np.resize(edge, F)
    return np.concatenate([est, row[None]], axis=0)


@pytest.mark.parametrize("method", [0, 1, 2, 3, 4, 5])
def test_coherent_gain(method):
    est = _coherences()
    Fn = diffuse_coherence(TGeometry.linear(2, 0.032), 256)[:, 0, 1]
    with np.errstate(all="ignore"):
        Gj, snrj = jw.coherent_gain(jnp.asarray(est), jnp.asarray(Fn), method=method)
    Gt, snrt = tw.coherent_gain(torch.as_tensor(est), torch.as_tensor(Fn), method=method)
    Gj = np.asarray(Gj)
    assert not np.isnan(Gj).any() and Gj.min() >= 0.02 and Gj.max() <= 1.0
    _close(Gt, Gj)
    _close(snrt, snrj)


def test_coherent_gain_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        tw.coherent_gain(torch.zeros(3, dtype=torch.complex128), np.zeros(3), method=6)


def _noisy_pair(B=2, S=8000, seed=1):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, S))
    return np.stack([src, np.roll(src, 1, axis=-1)], axis=1) + 0.5 * rng.standard_normal((B, 2, S))


@pytest.mark.parametrize("method", [3, 5])
def test_binaural_process(method):
    x = _noisy_pair()
    yj, snrj = jenh.binaural_process(jnp.asarray(x), JGeometry.linear(2, 0.032), jenh.BinauralConfig(method=method))
    yt, snrt = tenh.binaural_process(x, TGeometry.linear(2, 0.032), tenh.BinauralConfig(method=method), device="cpu")
    _close(yt, yj)
    _close(snrt, snrj)


def test_binaural_state_hand_over():
    """JAX's binaural_step over the first half of the frames, its MscState
    carried across, the port's binaural_step over the rest: JAX's whole run,
    frame for frame."""
    kw = dict(method=5)
    jcfg, tcfg = jenh.BinauralConfig(**kw), convert.binaural_config_from_dict(kw)
    Fn = diffuse_coherence(TGeometry.linear(2, 0.032), 256)[:, 0, 1]
    X = np.asarray(janalysis(jnp.asarray(_noisy_pair(S=4096)), jcfg.stft))  # [B, 2, T, F]
    Zt = np.array(np.moveaxis(np.moveaxis(X, -3, -1), -3, 0))  # [T, B, F, 2]
    step = jax.jit(lambda s, z: jenh.binaural_step(jcfg, jnp.asarray(Fn), s, z))
    init = lambda: jmsc.msc_init(2, jcfg.half_bin, batch_shape=(2,), cdtype=jnp.complex128)
    _, (Y_all, snr_all) = jax.lax.scan(step, init(), jnp.asarray(Zt))
    half = Zt.shape[0] // 2
    js = init()
    for z in Zt[:half]:
        js, _ = step(js, jnp.asarray(z))
    ts = convert.msc_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    Y, snr = [], []
    for z in Zt[half:]:
        ts, (y, s) = tenh.binaural_step(tcfg, torch.as_tensor(Fn), ts, torch.as_tensor(z))
        Y.append(y)
        snr.append(s)
    _close(torch.stack(Y), np.asarray(Y_all)[half:])
    _close(torch.stack(snr), np.asarray(snr_all)[half:])


def _ds_scene(B=2, M=4, S=8000, seed=2):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, S))
    return src[:, None, :] + 0.7 * rng.standard_normal((B, M, S))


def test_mccowan_gain():
    """mccowan_gain frame by frame from the same spectra and state."""
    cfg = dict(n_mics=4)
    jcfg, tcfg = jmc.McCowanConfig(**cfg), convert.mccowan_config_from_dict(cfg)
    i, j = jmsc.pair_indices(4)
    fvv = diffuse_coherence(TGeometry.linear(4, 0.032), 256)[:, i, j]
    X = np.asarray(janalysis(jnp.asarray(_ds_scene(S=4096)), jcfg.stft))
    Zt = np.array(np.moveaxis(np.moveaxis(X, -3, -1), -3, 0))
    js = jmsc.msc_init(4, jcfg.half_bin, batch_shape=(2,), cdtype=jnp.complex128)
    ts = convert.msc_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    for z in Zt:
        js, wj = jmc.mccowan_gain(jcfg, jnp.asarray(fvv), js, jnp.asarray(z))
        ts, wt = tmc.mccowan_gain(tcfg, torch.as_tensor(fvv), ts, torch.as_tensor(z))
        _close(wt, wj)
    _close(ts.Pxij, js.Pxij)


def test_mccowan_process_behind_ds():
    """The JAX benchmark's McCowan row: DS fixed_process, then McCowan."""
    x = _ds_scene()
    fcfg_j, fcfg_t = jfixed.FixedBeamformerConfig(weight_type="DS"), tfixed.FixedBeamformerConfig(weight_type="DS")
    Wj = jfixed.fixed_beamformer_weights(JGeometry.linear(4, 0.032), (90.0, 0.0), fcfg_j)
    Wt = tfixed.fixed_beamformer_weights(TGeometry.linear(4, 0.032), (90.0, 0.0), fcfg_t)
    dsj = jfixed.fixed_process(jnp.asarray(x), jnp.asarray(Wj), fcfg_j.stft)
    dst = tfixed.fixed_process(x, Wt, fcfg_t.stft, device="cpu")
    want = jmc.mccowan_process(jnp.asarray(x), dsj, JGeometry.linear(4, 0.032), jmc.McCowanConfig(n_mics=4))
    got = tmc.mccowan_process(x, dst, TGeometry.linear(4, 0.032), tmc.McCowanConfig(n_mics=4), device="cpu")
    _close(got, want)
