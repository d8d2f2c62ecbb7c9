"""The TDGSC front end's kernel (``ops.cuda_flms.gsc_front``,
``csrc/gsc_front.cu``).

On the CPU: the host side of its wrapper, the notch's coupled realization
and the table of chunk maps it hands the kernel, held to the float64
recurrence, and the validation that raises before a launch.  (The kernel's
source itself is rehearsed on the CPU in ``test_torch_csrc_rehearsal.py``.)

The tests marked ``card`` hold the kernel to its plain version, the torch
front end (``front_end`` + ``_kernel_inputs``) run on the card in float32,
at the benchmark's shapes and beside them, and check that the full stack's
card path runs nothing between K6 and K5 but the alignment taps' copy and
this kernel.  This file imports no JAX; on the card run it with
``python -m pytest --noconftest tests/test_torch_gsc_front.py -m card``."""

import numpy as np
import pytest
import torch

from distantspeech_tpu_torch.adaptive.feature import dc_notch, dc_notch_init
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig
from distantspeech_tpu_torch.ops import cuda_flms as cf


def _coupled_run(x: np.ndarray, s=(0.0, 0.0)):
    """``notch_coupled``'s system run sample by sample in float64 from the
    state s: (outputs, end state)."""
    A, b, c, dd = cf.notch_coupled()
    s = np.array(s, dtype=np.float64)
    y = np.empty_like(x)
    for n, xn in enumerate(x):
        y[n] = c @ s + dd * xn
        s = A @ s + b * xn
    return y, s


def test_the_coupled_notch_is_dc_notch():
    """The same filter as speex's companion form (``dc_notch``, evaluated
    blocked) from the zero state, to float64 rounding; its poles are those of
    the companion matrix."""
    x = np.random.default_rng(0).standard_normal(1500) + 0.5
    want = dc_notch(dc_notch_init((), dtype=torch.float64, device="cpu"), torch.as_tensor(x), radius=cf.NOTCH_RADIUS)[1]
    got, _ = _coupled_run(x)
    assert np.max(np.abs(got - want.numpy())) < 1e-12 * np.max(np.abs(want.numpy()))
    A = cf.notch_coupled()[0]
    r = cf.NOTCH_RADIUS
    den2 = r * r + 0.7 * (1.0 - r) ** 2
    assert A[0, 0] == pytest.approx(r) and A[1, 1] == pytest.approx(r) and A[0, 1] == pytest.approx(-A[1, 0])
    assert A[0, 0] ** 2 + A[0, 1] ** 2 == pytest.approx(den2)


def test_the_chunk_table_is_the_float64_recurrence():
    """Row k of the table is the zero-input state map over k chunks of
    NOTCH_CHUNK samples, run sample by sample; and a chunk's map from any
    state is that power plus its zero-state end state, which the kernel's
    scan composes."""
    table = cf.notch_chunk_powers()
    assert table.shape == (cf.NOTCH_POWERS, 4)
    for k in range(cf.NOTCH_POWERS):
        cols = [_coupled_run(np.zeros(cf.NOTCH_CHUNK * k), s)[1] for s in ((1.0, 0.0), (0.0, 1.0))]
        np.testing.assert_allclose(table[k].reshape(2, 2), np.stack(cols, axis=1), rtol=0, atol=1e-13)
    rng = np.random.default_rng(1)
    x, s = rng.standard_normal(cf.NOTCH_CHUNK * 5), rng.standard_normal(2)
    _, end = _coupled_run(x, s)
    _, zero = _coupled_run(x)
    np.testing.assert_allclose(end, table[5].reshape(2, 2) @ s + zero, rtol=0, atol=1e-12)


def test_the_params_mirror_the_kernel_struct():
    """``GscFrontParams`` in csrc/gsc_front.cu: ten floats, the notch's
    coupled form and 1 / M."""
    p = cf._gsc_front_params(3)
    A, b, c, dd = cf.notch_coupled()
    assert [f for f, _ in p._fields_] == ["a00", "a01", "a10", "a11", "b0", "b1", "c0", "c1", "dd", "inv_m"]
    assert (p.a01, p.b1, p.c0, p.dd) == pytest.approx((A[0, 1], b[1], c[0], dd), rel=1e-7)
    assert p.inv_m == pytest.approx(1 / 3, rel=1e-7)


@pytest.mark.parametrize("bad", ["float64", "one_mic", "ragged", "strided_samples"])
def test_the_device_path_refuses_before_a_launch(bad):
    """A tensor that is not on the CPU takes the kernel's path, which raises
    on what the kernel does not take before it copies or launches anything
    (a meta tensor stands for the card's here)."""
    cfg = TdGscConfig(n_mics=4)
    shape = {"one_mic": (2, 1, 512), "ragged": (2, 4, 600)}.get(bad, (2, 4, 512))
    x = torch.empty(shape, dtype=torch.float64 if bad == "float64" else torch.float32, device="meta")
    if bad == "strided_samples":
        x = torch.empty((2, 4, 1024), device="meta")[..., ::2]
    with pytest.raises(ValueError, match="gsc_front"):
        cf.gsc_front(x, ArrayGeometry.linear(4, 0.032), (np.pi / 2, 0.0), cfg)


def test_the_cpu_path_is_the_plain_front_end():
    """On the CPU ``gsc_front`` is ``front_end`` + ``_kernel_inputs``, each
    output contiguous, up only with the postfilter."""
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 3, 256 * 4)), dtype=torch.float32)
    geom, look = ArrayGeometry.linear(3, 0.032), (0.4, 0.0)
    for pf in (False, True):
        cfg = TdGscConfig(n_mics=3, postfilter=pf)
        bm, d, yp, up = cf.gsc_front(x, geom, look, cfg)
        fbf, bm_want = cf.front_end(x, geom, look, cfg)
        d_want, yp_want, up_want = cf._kernel_inputs(fbf, bm_want, cfg)
        assert torch.equal(bm, bm_want) and torch.equal(d, d_want) and torch.equal(yp, yp_want)
        assert (up is None) == (not pf) and (up is None or torch.equal(up, up_want))
        assert all(a.is_contiguous() for a in (bm, d, yp) + ((up,) if pf else ()))


# ---- on the card -------------------------------------------------------------

# (B, M, array, look, seconds, Lf, postfilter): the benchmark's two respeaker4
# shapes (ReSpeaker's 4-mic circle, r 0.032 m, at 197 degrees; K = 84), one
# utterance, 2, 3 and 8 mics on a linear array steered off broadside (8: K =
# 92 > 84, a tile of 1024), Lf = 128, the postfilter off, and 16 mics (the
# buffers in a global scratch; 1 s, cut to whole frames: a strided view)
CARD_SHAPES = {
    "b128": (128, 4, "circular", 197.0, 4, 256, True),
    "b16": (16, 4, "circular", 197.0, 4, 256, True),
    "b1": (1, 4, "circular", 197.0, 4, 256, True),
    "m2": (8, 2, "linear", 23.0, 2, 256, True),
    "m3": (8, 3, "linear", 23.0, 2, 256, True),
    "m8": (8, 8, "linear", 23.0, 2, 256, True),
    "lf128": (8, 4, "circular", 197.0, 2, 128, True),
    "core": (16, 4, "circular", 197.0, 4, 256, False),
    "m16": (4, 16, "linear", 23.0, 1, 256, True),
}


def _card_input(B, M, array, look_deg, seconds, seed=0):
    """A burst from the look direction on every mic over a DC offset, with
    noise on each (float32 on the card)."""
    rng = np.random.default_rng(seed)
    S = seconds * 16000
    env = np.repeat(rng.random((B, S // 512 + 1)) < 0.5, 512, axis=1)[:, :S]
    src = env * rng.standard_normal((B, S)) + 0.3
    x = np.stack([np.roll(src, m, axis=1) for m in range(M)], axis=1) + 0.2 * rng.standard_normal((B, M, S))
    geom = ArrayGeometry.circular(M, 0.032) if array == "circular" else ArrayGeometry.linear(M, 0.032)
    return torch.as_tensor(x, dtype=torch.float32, device="cuda"), geom, (np.deg2rad(look_deg), 0.0)


def _gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_on_the_card_the_kernel_is_the_plain_front_end(shape):
    """Each output against the plain version on the card, relative to its
    max|.|: bm and d within 1e-5 (the notch run sample by sample in its
    coupled form against its blocked products, and a direct FIR against a
    block-Toeplitz product: float32 rounding in another order, 1e-6 in the
    CPU rehearsal), the powers within 1e-4 (an FFT against a dense DFT
    product, squared)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, M, array, look_deg, seconds, Lf, pf = CARD_SHAPES[shape]
    x, geom, look = _card_input(B, M, array, look_deg, seconds)
    cfg = TdGscConfig(n_mics=M, frame_len=Lf, postfilter=pf)
    x = cf._check(x, cfg)  # whole frames: at 16 mics (1 s) a strided view
    from distantspeech_tpu_torch.runtime.profiling import counters, reset_counters

    reset_counters()
    got = cf.gsc_front(x, geom, look, cfg)
    assert counters() == {"launch.gsc_front": 1, "host_sync.prep.alignment": 1}
    fbf, bm = cf.front_end(x, geom, look, cfg)
    want = (bm, *cf._kernel_inputs(fbf, bm, cfg))
    torch.cuda.synchronize()
    for name, g, w, tol in zip(("bm", "d", "yp", "up"), got, want, (1e-5, 1e-5, 1e-4, 1e-4)):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        assert _gap(g, w) < tol, f"{shape} {name}: {_gap(g, w):.3e} of max|{name}|"


@pytest.mark.card
def test_on_the_card_between_k6_and_k5_only_the_taps_copy_and_the_kernel_run():
    """The full stack's card path, one warm call profiled: between K6's
    kernel and K5's the device runs the alignment taps' copy from the host
    and the front end's kernel, nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process

    x, geom, look = _card_input(4, 4, "circular", 197.0, 1)

    def call():
        return full_stack_process(x, x[:, 0], geom, look, FullStackConfig(n_mics=4, postfilter=True),
                                  backend="fused", device=x.device)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation), key=lambda e: e.time_range.start)  # no span shadows
    names = [e.name for e in ops]
    k6 = next(i for i, n in enumerate(names) if "kws_kernel" in n)
    k5 = next(i for i, n in enumerate(names) if "tdgsc_kernel" in n)
    between = names[k6 + 1:k5]
    assert len(between) == 2 and "memcpy" in between[0].lower() and "gsc_front_kernel" in between[1], between
