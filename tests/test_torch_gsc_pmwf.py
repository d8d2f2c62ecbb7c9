"""Port parity for ``noise/mc_mcra.py``, ``beamform/gsc.py`` (``gsc_steering``,
``gsc_process``, ``gsc_process_time``), ``noise/mcra2.py`` and
``beamform/pmwf.py`` (McSpp and McSppBase), each against its
``distantspeech_tpu`` twin in float64 on the CPU, to 1e-9 of the output's
scale (recursions), with the JAX tests' cases: the circular 4-mic array,
MCRA2 at nfft 256 and 320, the GSC's guard settings in float32.  And the
hand-over: JAX's GSC for half the frames, its state carried across by
``convert.gsc_state_from_numpy``, the port for the rest, against JAX's
whole run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import gsc as jgsc, pmwf as jpmwf
from distantspeech_tpu.noise import mc_mcra as jmc, mcra2 as jm2
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import gsc as tgsc, pmwf as tpmwf
from distantspeech_tpu_torch.noise import mc_mcra as tmc, mcra2 as tm2

RECURSION = 1e-9
ANGLE = (197.0 / 180.0 * np.pi, 0.0)


def _close(got, want, tol=RECURSION):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1e-300))


def _geoms(kind="circular", M=4):
    return getattr(TGeometry, kind)(M, 0.032, c=343.0), getattr(JGeometry, kind)(M, 0.032, c=343.0)


def _scene(M=4, S=16000, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(S)
    return np.stack([np.roll(src, m) + 0.3 * rng.standard_normal(S) for m in range(M)], axis=0)


def _complex_fixture(T=100, nfft=256, C=4, seed=2):
    """Multichannel spectra with a coherent burst over frames 0.3 T - 0.8 T."""
    rng = np.random.default_rng(seed)
    F = nfft // 2 + 1
    y = (rng.standard_normal((T, F, C)) + 1j * rng.standard_normal((T, F, C))) / np.sqrt(2)
    src = (rng.standard_normal((T, F, 1)) + 1j * rng.standard_normal((T, F, 1))) / np.sqrt(2)
    y[int(T * 0.3) : int(T * 0.8)] += 6.0 * src[int(T * 0.3) : int(T * 0.8)]
    return y


@pytest.mark.parametrize("rel_diag", [0.0, 1e-5])
def test_mc_mcra_run(rel_diag):
    y = _complex_fixture()
    got = tmc.mc_mcra_run(tmc.McMcraConfig(rel_diag=rel_diag), torch.as_tensor(y))
    want = jmc.mc_mcra_run(jmc.McMcraConfig(rel_diag=rel_diag), jnp.asarray(y))
    for name in got._fields:
        _close(getattr(got, name), getattr(want, name))


def _spectrum_fixture(T=160, nfft=256, seed=0):
    rng = np.random.default_rng(seed)
    F = nfft // 2 + 1
    burst = np.zeros((T, F))
    burst[int(T * 0.4) : int(T * 0.7), 10:60] = 40.0 * rng.rayleigh(1.0, size=(int(T * 0.7) - int(T * 0.4), 50)) ** 2
    return rng.rayleigh(1.0, size=(T, F)) ** 2 + burst


@pytest.mark.parametrize("nfft", [256, 320])
def test_mcra2_run(nfft):
    Y = _spectrum_fixture(nfft=nfft)
    for g, w in zip(tm2.mcra2_run(tm2.Mcra2Config(nfft=nfft), torch.as_tensor(Y)),
                    jm2.mcra2_run(jm2.Mcra2Config(nfft=nfft), jnp.asarray(Y))):
        _close(g, w)


def test_mcra2_state_hand_over():
    """JAX's MCRA2 over the first 70 frames, its state carried across, the
    port over the rest: JAX's whole run."""
    Y = _spectrum_fixture()
    jcfg, tcfg = jm2.Mcra2Config(), tm2.Mcra2Config()
    js = jm2.mcra2_init(jcfg, dtype=jnp.float64)
    for y in Y[:70]:
        js, _ = jm2.mcra2_step(jcfg, js, jnp.asarray(y))
    ts = convert.mcra2_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    lams = []
    for y in Y[70:]:
        ts, (lam, _) = tm2.mcra2_step(convert.mcra2_config_from_dict(vars(jcfg)), ts, torch.as_tensor(y))
        lams.append(lam)
    _close(torch.stack(lams), jm2.mcra2_run(jcfg, jnp.asarray(Y))[0][70:])


def test_gsc_steering():
    for kind in ("circular", "linear"):
        tg, jg = _geoms(kind)
        np.testing.assert_array_equal(tgsc.gsc_steering(tgsc.GscConfig(), tg, ANGLE),
                                      jgsc.gsc_steering(jgsc.GscConfig(), jg, ANGLE))


@pytest.mark.parametrize("guards", [False, True])
@pytest.mark.parametrize("kind", ["circular", "linear"])
def test_gsc_process(kind, guards):
    tg, jg = _geoms(kind)
    kw = dict(n_mics=4, frame_len=256, normalize_aic=guards, spp_rel_diag=1e-5 if guards else 0.0)
    x = _scene(S=256 * 24, seed=2) * (1.0 if guards else 0.1)  # the reference's LMS diverges on unit input
    got = tgsc.gsc_process(x, tg, ANGLE, tgsc.GscConfig(**kw), device="cpu")
    _close(got, jgsc.gsc_process(jnp.asarray(x), jg, ANGLE, jgsc.GscConfig(**kw)))


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_gsc_process_time(scale):
    tg, jg = _geoms()
    x = _scene(S=256 * 16, seed=6) * scale
    got = tgsc.gsc_process_time(x, tg, ANGLE, device="cpu")
    assert got.shape == (256 * 16,)
    _close(got, jgsc.gsc_process_time(jnp.asarray(x), jg, ANGLE))


def test_gsc_guards_stay_finite_in_float32():
    """The unnormalised canceller diverges on loud broadband input; with the
    bench's guards the float32 path stays finite on loud white noise and on
    a near-coherent target."""
    rng = np.random.default_rng(0)
    geom = TGeometry.linear(4, 0.032)
    cfg = tgsc.GscConfig(n_mics=4, normalize_aic=True, spp_rel_diag=1e-5)
    burst = rng.standard_normal(16000)
    for x in (rng.standard_normal((4, 16000)), np.tile(burst, (4, 1)) + 0.3 * rng.standard_normal((4, 16000))):
        y = tgsc.gsc_process(x.astype(np.float32), geom, (np.pi / 2, 0.0), cfg, device="cpu")
        assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())


def _as_dict(s):
    return {k: _as_dict(v) for k, v in s._asdict().items()} if hasattr(s, "_asdict") else np.asarray(s)


@pytest.mark.parametrize("guards", [False, True])
def test_gsc_state_hand_over(guards):
    """JAX's GSC over the first half of the frames, its state (with the
    MC-MCRA state nested) carried across, the port over the rest: JAX's
    whole run, frame for frame."""
    kw = dict(n_mics=4, frame_len=128, normalize_aic=guards, spp_rel_diag=1e-5 if guards else 0.0)
    jcfg, tcfg = jgsc.GscConfig(**kw), convert.gsc_config_from_dict(kw)
    tg, jg = _geoms()
    a = jgsc.gsc_steering(jcfg, jg, ANGLE)
    rng = np.random.default_rng(4)
    Z = (rng.standard_normal((40, 65, 4)) + 1j * rng.standard_normal((40, 65, 4))) * 0.2
    step = jax.jit(lambda s, z: jgsc.gsc_step(jcfg, jnp.asarray(a), s, z))
    _, Y_all = jax.lax.scan(step, jgsc.gsc_init(jcfg, cdtype=jnp.complex128), jnp.asarray(Z))
    js = jgsc.gsc_init(jcfg, cdtype=jnp.complex128)
    for z in Z[:20]:
        js, _ = step(js, jnp.asarray(z))
    ts = convert.gsc_state_from_numpy(_as_dict(js), "cpu")
    assert isinstance(ts.spp.frm_cnt, int) and ts.spp.frm_cnt == 20
    at = torch.as_tensor(tgsc.gsc_steering(tcfg, tg, ANGLE))
    Y = []
    for z in Z[20:]:
        ts, y = tgsc.gsc_step(tcfg, at, ts, torch.as_tensor(z))
        Y.append(y)
    _close(torch.stack(Y), np.asarray(Y_all)[20:])


@pytest.mark.parametrize("full,omlsa_gain", [(True, True), (True, False), (False, True), (False, False)])
def test_pmwf_process(full, omlsa_gain):
    tg, jg = _geoms()
    x = _scene(S=128 * 40, seed=5) * 0.5
    kw = dict(n_mics=4, frame_len=128, full=full, omlsa_gain=omlsa_gain)
    got = tpmwf.pmwf_process(x, tg, convert.pmwf_config_from_dict(kw), device="cpu")
    _close(got, jpmwf.pmwf_process(jnp.asarray(x), jg, jpmwf.PmwfConfig(**kw)))
