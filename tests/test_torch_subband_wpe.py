"""Port parity for ``transform/filterbank_design.py`` (the port's numpy copy),
``transform/subband.py`` and ``derev/wpe.py``, each against its
``distantspeech_tpu`` twin in float64 on the CPU, with the JAX tests' cases
(the design at M=32, multichannel analysis, streaming synthesis, offline
against streaming), WPE at 64 bands / hop 16: 1e-10 of the output's scale
for the closed forms (design, analysis, synthesis), 1e-9 for the WPE
recursion.  The hand-over: JAX's WPE for half the frames, its state carried
across by ``convert.wpe_state_from_numpy``, the port for the rest, against
JAX's whole run.  And BASELINE config 4 (``doa.wpe_srp_process``, WPE ->
SRP-PHAT) at B=1 x 8 mics x 0.5 s in float32 with ``backend="fused"`` (on
the CPU, kernel K10's plain version), against JAX's chain with its Pallas
``fused_srp_spectrum`` in interpret mode: K10's 1e-4 gate on the spectrum
and the same pick."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.derev import wpe as jwpe
from distantspeech_tpu.doa import srp as jsrp
from distantspeech_tpu.ops import pallas_srp
from distantspeech_tpu.transform import analysis as janalysis, filterbank_design as jfd, subband as jsb
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.derev import wpe as twpe
from distantspeech_tpu_torch.doa import wpe_srp
from distantspeech_tpu_torch.ops import cuda_mcra, cuda_srp
from distantspeech_tpu_torch.transform import filterbank_design as tfd, subband as tsb

CLOSED, RECURSION, SRP_GATE = 1e-10, 1e-9, 1e-4


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1e-300))


@pytest.mark.parametrize("M,m,D", [(32, 2, 16), (64, 2, 16), (16, 1, 4)])
def test_design(M, m, D):
    h, beta = tfd.design_analysis_prototype(M, m, D)
    jh, jbeta = jfd.design_analysis_prototype(M, m, D)
    _close(h, jh, CLOSED)
    assert abs(beta - jbeta) <= CLOSED * abs(jbeta)
    g, eps = tfd.design_synthesis_prototype(h, M, m, D)
    jg, jeps = jfd.design_synthesis_prototype(jh, M, m, D)
    _close(g, jg, CLOSED)
    assert abs(eps - jeps) <= CLOSED * max(abs(jeps), 1e-300)


def test_prototype_cache_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.setattr(tfd, "_CACHE_DIR", str(tmp_path))
    h, g = tfd.nyquist_prototypes(64, 2, 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["nyquist-M64-m2-r2.npz"]
    h2, g2 = tfd.nyquist_prototypes(64, 2, 2)  # from the cache
    np.testing.assert_array_equal(h, h2)
    np.testing.assert_array_equal(g, g2)
    jh, jg = jfd.nyquist_prototypes(64, 2, 2)
    _close(h, jh, CLOSED)
    _close(g, jg, CLOSED)
    assert tfd._CACHE_DIR != jfd._CACHE_DIR


# n_fft / hop a power of two (SubbandConfig.r = n_fft / hop / 2), and one
# config whose hop does not divide win_len (the synthesis' frame loop)
CONFIGS = [(64, 32), (64, 16), (128, 32), (64, 24)]


@pytest.mark.parametrize("n_fft,hop", CONFIGS)
def test_analysis_and_synthesis(n_fft, hop):
    cfg, jcfg = tsb.SubbandConfig(n_fft, hop), jsb.SubbandConfig(n_fft, hop)
    x = np.random.default_rng(0).standard_normal((2, 3, hop * 20))
    Y = tsb.subband_analysis(torch.as_tensor(x), cfg)
    jY = np.asarray(jsb.subband_analysis(jnp.asarray(x), jcfg))
    _close(Y, jY, CLOSED)
    _close(tsb.subband_synthesis(torch.as_tensor(jY), cfg), jsb.subband_synthesis(jnp.asarray(jY), jcfg), CLOSED)


def test_streaming_matches_jax_and_offline():
    """Chunk by chunk through the streaming analysis and the per-frame
    synthesis step, beside JAX's; the concatenation equals the offline
    transforms."""
    n_fft, hop = 64, 32
    cfg, jcfg = tsb.SubbandConfig(n_fft, hop), jsb.SubbandConfig(n_fft, hop)
    x = np.random.default_rng(1).standard_normal(hop * 30)
    h, g = (torch.as_tensor(p) for p in cfg.prototypes())
    jh, jg = (jnp.asarray(p) for p in jcfg.prototypes())
    carry, jcarry = torch.zeros(cfg.overlap, dtype=torch.float64), jnp.zeros(jcfg.overlap)
    tdl = tsb.subband_synthesis_init((), cfg, dtype=torch.float64, device="cpu")
    jtdl = jsb.subband_synthesis_init((), jcfg, dtype=jnp.float64)
    Ys, ys = [], []
    for i in range(0, len(x), hop * 3):
        carry, Y = tsb.subband_analysis_stream(carry, torch.as_tensor(x[i : i + hop * 3]), cfg, h)
        jcarry, jY = jsb.subband_analysis_stream(jcarry, jnp.asarray(x[i : i + hop * 3]), jcfg, jh)
        _close(Y, jY, CLOSED)
        for f in range(Y.shape[0]):
            tdl, y = tsb.subband_synthesis_step(tdl, Y[f], cfg, g)
            jtdl, jy = jsb.subband_synthesis_step(jtdl, jnp.asarray(Y[f].numpy()), jcfg, jg)
            _close(y, jy, CLOSED)
            _close(tdl, jtdl, CLOSED)
            ys.append(y)
        Ys.append(Y)
    Y_off = tsb.subband_analysis(torch.as_tensor(x), cfg)
    _close(torch.cat(Ys), Y_off, CLOSED)
    _close(torch.cat(ys), tsb.subband_synthesis(Y_off, cfg), CLOSED)


def _wpe_cfgs(**kw):
    kw = {"num_bands": 64, "hop": 16, "n_channels": 2, "filter_len": 2, "delay": 2, **kw}
    return convert.wpe_config_from_dict(kw), jwpe.WpeConfig(**kw)


def _reverberant(C, S, seed):
    rng = np.random.default_rng(seed)
    dry = rng.standard_normal(S) * (rng.uniform(size=S) > 0.6)
    rirs = [np.r_[1.0, rng.standard_normal(199) * np.exp(-np.arange(1, 200) / 40.0)] for _ in range(C)]
    return np.stack([np.convolve(dry, r)[:S] for r in rirs]) * 0.3


@pytest.mark.parametrize("kw", [{}, {"n_channels": 3, "filter_len": 3, "delay": 1}])
def test_wpe_run_and_process(kw):
    cfg, jcfg = _wpe_cfgs(**kw)
    x = _reverberant(cfg.n_channels, 16 * 80, seed=8)
    Y = tsb.subband_analysis(torch.as_tensor(x), cfg.subband)
    D = torch.movedim(torch.movedim(Y, -3, -1), -3, 0)  # [T, F, C]
    _close(twpe.wpe_run(cfg, D), jwpe.wpe_run(jcfg, jnp.asarray(D.numpy())), RECURSION)
    xb = np.stack([x, _reverberant(cfg.n_channels, 16 * 80, seed=9)])  # a batch of two
    got = twpe.wpe_process(xb, cfg, device="cpu")
    assert got.shape == (2, 16 * 80) and got.dtype == torch.float64
    _close(got, jwpe.wpe_process(jnp.asarray(xb), jcfg), RECURSION)


def test_wpe_constrain_hook_sees_every_state():
    cfg, _ = _wpe_cfgs()
    D = torch.as_tensor(np.random.default_rng(3).standard_normal((9, 33, 2)) + 0j)
    seen = []
    e = twpe.wpe_run(cfg, D, constrain=lambda s: seen.append(s) or s)
    assert len(seen) == 10 and torch.equal(e, twpe.wpe_run(cfg, D))


def test_wpe_state_hand_over():
    """JAX's WPE over the first half of the frames, its state carried across,
    the port over the rest: JAX's whole run, frame for frame."""
    cfg, jcfg = _wpe_cfgs()
    x = _reverberant(2, 16 * 60, seed=5)
    D = np.moveaxis(np.moveaxis(np.asarray(jsb.subband_analysis(jnp.asarray(x), jcfg.subband)), -3, -1), -3, 0)
    delayed = np.concatenate([np.zeros_like(D[: cfg.delay]), D[: -cfg.delay]])
    half = D.shape[0] // 2
    js, _ = jax.lax.scan(lambda s, dd: jwpe.wpe_step(jcfg, s, dd[0], dd[1]), jwpe.wpe_init(jcfg, cdtype=jnp.complex128),
                         (jnp.asarray(D[:half]), jnp.asarray(delayed[:half])))
    ts = convert.wpe_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    es = []
    for d, xd in zip(D[half:], delayed[half:]):
        ts, e = twpe.wpe_step(cfg, ts, torch.as_tensor(d), torch.as_tensor(xd))
        es.append(e)
    _close(torch.stack(es), np.asarray(jwpe.wpe_run(jcfg, jnp.asarray(D)))[half:], RECURSION)


def test_wpe_srp_chain_matches_jax_float32():
    """BASELINE config 4 at B=1 x 8 mics x 0.5 s, float32: the port's
    ``wpe_srp_process(..., backend="fused")`` against JAX's chain (the
    benchmark's ``_wpe_srp``) with the Pallas kernel in interpret mode.

    The dereverberated signals agree to float32 rounding (< 1e-5 of max).
    The spectra are held to K10's 1e-4 from the subband filterbank's latency
    on (win_len - hop samples, 7 SRP frames): before it the synthesis
    emits only the filterbank's start-up residue, whose rounding PHAT
    whitens to unit magnitude (JAX's own float32 chain is 3e-3 from its
    float64 chain in those frames).  K10's plain version is held to the
    Pallas kernel on the same input over every frame."""
    S = 8000 // 128 * 128
    x = np.stack([_reverberant(8, S, seed=11)]).astype(np.float32) * 3
    tgeom, jgeom = TGeometry.linear(8, 0.032), JGeometry.linear(8, 0.032)
    jcfg, scfg = jwpe.WpeConfig(n_channels=8), jsrp.SrpConfig()
    for mod in (cuda_srp, cuda_mcra):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    spec, p = wpe_srp.wpe_srp_process(x, tgeom, backend="fused", device="cpu")
    assert cuda_srp.LAUNCHES == {"fused_srp_spectrum": 0} and cuda_mcra.LAUNCHES == {"mcra_run": 0}

    Y = jsb.subband_analysis(jnp.asarray(x), jcfg.subband)  # the benchmark's _wpe_srp
    e = jwpe.wpe_run(jcfg, jnp.moveaxis(jnp.moveaxis(Y, -3, -1), -3, 0))
    yc = jsb.subband_synthesis(jnp.moveaxis(e, 0, -2).swapaxes(-1, -3), jcfg.subband)
    assert yc.dtype == jnp.float32
    yt = wpe_srp.wpe_dereverb_all(torch.as_tensor(x), twpe.WpeConfig(n_channels=8))
    _close(yt, yc, 1e-5)

    grid = jsrp.srp_steering_grid(scfg, jgeom)
    pallas = lambda y: np.moveaxis(np.asarray(pallas_srp.fused_srp_spectrum(
        jnp.moveaxis(jnp.moveaxis(janalysis(jnp.asarray(y), scfg.stft), -3, -1), -3, 0), grid, interpret=True)), 0, -2)
    want = pallas(yc)
    assert spec.dtype == torch.float32 and spec.shape == want.shape == (1, S // 128, 360)
    _close(spec, pallas(yt.numpy()), SRP_GATE)  # K10's plain version, every frame
    lat = -(-(jcfg.subband.win_len - jcfg.hop) // scfg.stft.hop)
    got, want = spec.numpy()[:, lat:], want[:, lat:]
    assert np.max(np.abs(got - want)) < SRP_GATE * np.max(np.abs(want))
    half_t, half_j = got[..., :181], want[..., :181]  # a linear array's mirror pairs tie
    top2 = np.sort(half_j, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > SRP_GATE * np.max(np.abs(want))
    assert clear.sum() > 0 and (half_t.argmax(-1) == half_j.argmax(-1))[clear].all()
    assert int(spec.sum(dim=(0, 1))[:181].argmax()) == int(want.sum(axis=(0, 1))[:181].argmax())
