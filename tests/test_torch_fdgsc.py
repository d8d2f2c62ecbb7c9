"""The port's frequency-domain GSC on the CPU: ``bm_step`` / ``aic_step``
and ``fdgsc_process(backend="scan")`` (postfilter off and on) against the
JAX package in float64, ``fused_fdgsc_plain`` (the plain version of kernel
K8, ``csrc/fdgsc.cu``) against the JAX Pallas kernel in interpret mode in
float32, the ``fused`` backend's routing of CPU tensors, and a mid-run
handover of the JAX state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.adaptive import flms as jflms
from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import fdgsc as jf, gsc_filters as jg
from distantspeech_tpu.ops.pallas_flms import fused_fdgsc as j_fused
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.adaptive import flms as tflms
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.beamform import fdgsc as tf, gsc_filters as tg
from distantspeech_tpu_torch.ops import cuda_flms as cf

ANG = (np.pi / 2, 0.0)
B, M, T = 8, 4, 20


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-300))


def _scene(Bn, S, seed, dtype=np.float32):
    """Independent noise per mic and, over frames 8-14, a loud burst from
    broadside (identical on every mic): after MCRA's forced start, p rises
    across the mid band, and with a short MCRA window the low bins pin."""
    rng = np.random.default_rng(seed)
    n = np.arange(S)
    env = ((n >= 8 * 256) & (n < 15 * 256)).astype(np.float64)
    tgt = rng.standard_normal((Bn, 1, S)) * env * 10.0
    return (tgt + rng.standard_normal((Bn, M, S))).astype(dtype)


def _short_mcra(base):
    """``base`` (JAX's or the port's FdGscConfig) with MCRA's window cut to
    L=3: MCRA holds p = 0 for its first 2L frames (120 by default), so only
    a short window lets p, and the low-bin pinning, move within 20 frames."""

    class Short(base):
        @property
        def mcra(self):
            return dataclasses.replace(super().mcra, L=3)

    return Short


def test_bm_and_aic_steps_match_jax_float64():
    L, hop = 64, 64
    rng = np.random.default_rng(0)
    bm_kw = dict(filter_len=L, mu=0.1, alpha=0.9)
    aic_kw = dict(filter_len=L, n_channels=3, mu=0.1, alpha=0.9)
    sbj, sbt = jflms.flms_init(jflms.FlmsConfig(**bm_kw), (2, 3), dtype=jnp.float64), \
        tflms.flms_init(tflms.FlmsConfig(**bm_kw), (2, 3), dtype=torch.float64, device="cpu")
    saj, sat = jflms.flms_init(jflms.FlmsConfig(**aic_kw), (2,), dtype=jnp.float64), \
        tflms.flms_init(tflms.FlmsConfig(**aic_kw), (2,), dtype=torch.float64, device="cpu")
    for t in range(10):
        x = rng.standard_normal((2, 3, 1, hop))
        d = x[..., 0, :] * 0.7 + 0.1 * rng.standard_normal((2, 3, hop))
        sbj, (ej, wj) = jg.bm_step(jflms.FlmsConfig(**bm_kw), sbj, jnp.asarray(x), jnp.asarray(d))
        sbt, (et, wt) = tg.bm_step(tflms.FlmsConfig(**bm_kw), sbt, torch.as_tensor(x), torch.as_tensor(d))
        assert _rel(et, ej) <= 1e-9 and _rel(wt, wj) <= 1e-9
        # a large step so the norm ceiling binds; a per-utterance gate
        p = rng.uniform(0.5, 1.5, (2, 1, 1))
        xa, da = rng.standard_normal((2, 3, hop)), rng.standard_normal((2, hop))
        kw = dict(p=p, maxnorm=1e-4, fir_truncate=4 if t % 2 else None)
        saj, (ej, wj) = jg.aic_step(jflms.FlmsConfig(**aic_kw), saj, jnp.asarray(xa), jnp.asarray(da), **kw)
        sat, (et, wt) = tg.aic_step(tflms.FlmsConfig(**aic_kw), sat, torch.as_tensor(xa), torch.as_tensor(da),
                                    **{**kw, "p": torch.as_tensor(p)})
        assert _rel(et, ej) <= 1e-9 and _rel(wt, wj) <= 1e-9
    np.testing.assert_array_equal(tg.bm_bounds(128), jg.bm_bounds(128))


@pytest.mark.parametrize("postfilter", [False, True], ids=["core_short_mcra", "postfilter"])
def test_scan_matches_jax_float64(postfilter):
    """The core with a short MCRA window, so that the low-bin pinning fires;
    the postfilter with the default one."""
    x = _scene(2, T * 256, 1, np.float64)
    cj, ct = (jf.FdGscConfig, tf.FdGscConfig) if postfilter else (_short_mcra(jf.FdGscConfig), _short_mcra(tf.FdGscConfig))
    want = jf.fdgsc_process(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, cj(n_mics=M, postfilter=postfilter))
    got = tf.fdgsc_process(x, TGeometry.linear(M, 0.032), ANG, ct(n_mics=M, postfilter=postfilter), device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and _rel(g, w) <= 1e-9
    if not postfilter:
        pinned = got[1][..., 32:128].mean(-1) > 0.8
        assert 0 < int(pinned.sum()) < pinned.numel()
        assert bool((got[1][..., :32][pinned] >= 0.8).all())


@pytest.fixture(scope="module")
def fused_case():
    """White noise on every mic, the JAX kernel's own test scene."""
    x = np.random.default_rng(2).standard_normal((B, M, T * 256)).astype(np.float32)
    want = j_fused(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, jf.FdGscConfig(n_mics=M), interpret=True)
    got = cf.fused_fdgsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, tf.FdGscConfig(n_mics=M))
    return x, tuple(np.asarray(w) for w in want), tuple(g.numpy() for g in got)


def test_fused_plain_matches_pallas_interpret(fused_case):
    """float32, B=8 x 4 x 20 frames: the tolerances the JAX kernel is held to."""
    _, (o1, p1, bm1), (o2, p2, bm2) = fused_case
    assert o2.dtype == np.float32 and p2.shape == (B, T, 257) and bm2.shape == (B, M, T * 256)
    assert _rel(o2, o1) < 1e-5
    np.testing.assert_allclose(p2, p1, atol=1e-6)
    assert _rel(bm2, bm1) < 1e-5


def test_fused_plain_matches_pallas_interpret_with_pinning():
    """With a short MCRA window p moves within 20 frames, so the kernel's
    low-bin pinning and its p-driven AIC step meet the JAX kernel: float32,
    B=8 x 4 x 20 frames on the burst scene, where the JAX kernel stays within
    these tolerances of float64."""
    x = _scene(B, T * 256, 3)
    want = j_fused(jnp.asarray(x), JGeometry.linear(M, 0.032), ANG, _short_mcra(jf.FdGscConfig)(n_mics=M), interpret=True)
    got = cf.fused_fdgsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, _short_mcra(tf.FdGscConfig)(n_mics=M))
    (o1, p1, bm1), (o2, p2, bm2) = (np.asarray(w) for w in want), (g.numpy() for g in got)
    assert _rel(o2, o1) < 1e-5
    np.testing.assert_allclose(p2, p1, atol=1e-6)
    assert _rel(bm2, bm1) < 1e-5
    pinned = p2[..., 32:128].mean(-1) > 0.8
    assert 0 < int(pinned.sum()) < pinned.size
    assert bool((p2[..., :32][pinned] >= 0.8).all()) and bool((p1[..., :32][pinned] >= 0.8).all())


def test_fused_plain_float32_on_a_burst():
    """On the burst scene the float32 plain version stays within 1e-5 of its
    float64 result (the JAX kernel in interpret mode strays 7.6e-4 from it
    there, after the burst ends, so the scene is not used against JAX)."""
    x = _scene(2, T * 256, 2)
    run = lambda a: cf.fused_fdgsc_plain(torch.as_tensor(a), TGeometry.linear(M, 0.032), ANG, tf.FdGscConfig(n_mics=M))
    for g, w in zip(run(x), run(x.astype(np.float64))):
        assert g.dtype == torch.float32 and _rel(g, w) < 1e-5


def test_fused_plain_matches_the_scan_float64():
    """In float64 the kernel's plain version is the ``fdgsc_step`` loop; with
    a short MCRA window the low bins are pinned on some frames."""
    x = _scene(2, T * 256, 2, np.float64)
    cfg = _short_mcra(tf.FdGscConfig)(n_mics=M)
    got = cf.fused_fdgsc_plain(torch.as_tensor(x), TGeometry.linear(M, 0.032), ANG, cfg)
    want = tf.fdgsc_process(x, TGeometry.linear(M, 0.032), ANG, cfg, device="cpu")
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9
    pinned = (got[1][..., 32:128].mean(-1) > 0.8)
    assert 0 < int(pinned.sum()) < pinned.numel()


def test_fused_backend_runs_the_plain_version_on_cpu():
    x = torch.as_tensor(_scene(3, 256 * 6 + 100, 5))  # any B; a sub-frame tail is dropped
    cfg = tf.FdGscConfig(n_mics=M)
    cf.LAUNCHES["fused_fdgsc"] = 0
    got = tf.fdgsc_process(x, TGeometry.linear(M, 0.032), ANG, cfg, backend="fused", device="cpu")
    want = cf.fused_fdgsc_plain(x, TGeometry.linear(M, 0.032), ANG, cfg)
    assert cf.LAUNCHES["fused_fdgsc"] == 0
    assert got[0].shape == (3, 256 * 6) and got[1].shape == (3, 6, 257) and got[2].shape == (3, M, 256 * 6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="postfilter"):
        tf.fdgsc_process(x, TGeometry.linear(M, 0.032), ANG, tf.FdGscConfig(n_mics=M, postfilter=True),
                         backend="fused", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tf.fdgsc_process(x, TGeometry.linear(M, 0.032), ANG, cfg, backend="pallas", device="cpu")


def _as_dict(state):
    if hasattr(state, "_asdict"):
        return {k: _as_dict(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def test_handover_mid_run():
    """JAX runs 3 frames with the postfilter in float64; its config and
    state carry into the port, whose next ``fdgsc_step`` gives JAX's next
    output."""
    cj = jf.FdGscConfig(n_mics=M, postfilter=True)
    ct = convert.fdgsc_config_from_dict(dataclasses.asdict(cj))
    assert ct == tf.FdGscConfig(n_mics=M, postfilter=True)
    rng = np.random.default_rng(6)
    x, al = rng.standard_normal((4, 2, M, 256)), rng.standard_normal((4, 2, M, 256))
    sj = jf.fdgsc_init(cj, (2,), dtype=jnp.float64)
    step = jax.jit(jf.fdgsc_step, static_argnums=0)
    for t in range(3):
        sj, _ = step(cj, sj, jnp.asarray(x[t]), jnp.asarray(al[t]))
    _, want = step(cj, sj, jnp.asarray(x[3]), jnp.asarray(al[3]))
    st = convert.fdgsc_state_from_numpy(_as_dict(sj), device="cpu")
    assert st.mcra.frm_cnt == 3 and st.omlsa.frm_cnt == 3 and st.bm.W.shape == (2, M, 1, 257)
    _, got = tf.fdgsc_step(ct, st, torch.as_tensor(x[3]), torch.as_tensor(al[3]))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9
