"""Port parity: geometry, steering, framing and the STFT of
``distantspeech_tpu_torch`` against ``distantspeech_tpu``, float64 on the
CPU, to 1e-12 of the signal scale (the two differ only in summation order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distantspeech_tpu.array import geometry as jgeo, steering as jst
from distantspeech_tpu.ops import framing as jfr
from distantspeech_tpu.transform import stft as jstft
from distantspeech_tpu_torch.array import geometry as tgeo, steering as tst
from distantspeech_tpu_torch.ops import framing as tfr
from distantspeech_tpu_torch.transform import stft as tstft

TOL = 1e-12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1e-300))


@pytest.mark.parametrize("layout", ["linear", "circular"])
def test_geometry_and_steering(layout):
    jg = getattr(jgeo.ArrayGeometry, layout)(6, 0.04)
    tg = getattr(tgeo.ArrayGeometry, layout)(6, 0.04)
    np.testing.assert_array_equal(tg.mic_loc, jg.mic_loc)
    angles = np.array([[np.pi / 2, 0.0], [0.3, 0.2], [2.0, -0.4]])
    _close(tst.compute_tau(tg, angles, normalize=True), jst.compute_tau(jg, angles, normalize=True))
    _close(tst.omega_bins(512, 16000), jst.omega_bins(512, 16000))
    _close(tst.steering_vector(tg, angles, 256), jst.steering_vector(jg, angles, 256))


@pytest.mark.parametrize("frame_len,hop", [(256, 128), (256, 64), (200, 75)])
def test_framing(frame_len, hop):
    x = np.random.default_rng(0).standard_normal((2, 3, 2000))
    fj = np.asarray(jfr.frame_signal(jnp.asarray(x), frame_len, hop))
    ft = tfr.frame_signal(torch.as_tensor(x), frame_len, hop).numpy()
    np.testing.assert_array_equal(ft, fj)
    _close(tfr.overlap_add(torch.as_tensor(fj.copy()), hop).numpy(), jfr.overlap_add(jnp.asarray(fj), hop))


@pytest.mark.parametrize("n_fft,hop", [(256, 128), (256, 64), (255, 85)])
def test_analysis_synthesis(n_fft, hop):
    cfg_j, cfg_t = jstft.StftConfig(n_fft, hop), tstft.StftConfig(n_fft, hop)
    assert cfg_t.synthesis_gain == cfg_j.synthesis_gain
    x = np.random.default_rng(1).standard_normal((2, 4, hop * 30))
    Yj = np.asarray(jstft.analysis(jnp.asarray(x), cfg_j))
    Yt = tstft.analysis(torch.as_tensor(x), cfg_t)
    _close(Yt.numpy(), Yj)
    _close(tstft.synthesis(Yt, cfg_t).numpy(), jstft.synthesis(jnp.asarray(Yj), cfg_j))


def test_stream_carries_match_jax_and_offline():
    """Chunked streaming with explicit carries equals JAX's streaming and the
    offline analysis / synthesis."""
    cfg_j, cfg_t = jstft.StftConfig(), tstft.StftConfig()
    hop = cfg_t.hop
    x = np.random.default_rng(2).standard_normal((3, hop * 24))
    cj = jstft.stft_init_carry((3,), cfg_j, dtype=jnp.float64)
    ct = tstft.stft_init_carry((3,), cfg_t, dtype=torch.float64, device="cpu")
    ocj, oct_ = cj, ct
    ys_j, ys_t, Ys_t = [], [], []
    for lo, hi in ((0, 5), (5, 6), (6, 24)):
        chunk = x[:, lo * hop : hi * hop]
        cj, Yj = jstft.stft_stream(cj, jnp.asarray(chunk), cfg_j)
        ct, Yt = tstft.stft_stream(ct, torch.as_tensor(chunk), cfg_t)
        _close(ct.numpy(), cj)
        _close(Yt.numpy(), Yj)
        ocj, yj = jstft.istft_stream(ocj, Yj, cfg_j)
        oct_, yt = tstft.istft_stream(oct_, Yt, cfg_t)
        _close(oct_.numpy(), ocj)
        _close(yt.numpy(), yj)
        ys_j.append(np.asarray(yj))
        ys_t.append(yt.numpy())
        Ys_t.append(Yt)
    offline = tstft.analysis(torch.as_tensor(x), cfg_t)
    _close(torch.cat(Ys_t, dim=-2).numpy(), offline.numpy())
    _close(np.concatenate(ys_t, -1), tstft.synthesis(offline, cfg_t).numpy())
    _close(np.concatenate(ys_t, -1), np.concatenate(ys_j, -1))
