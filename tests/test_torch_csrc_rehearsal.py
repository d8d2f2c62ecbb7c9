"""K5 (csrc/flms.cu, core and postfilter), K8 (csrc/fdgsc.cu), K7
(csrc/aec.cu), K4 (csrc/enhance.cu's mega kernel) and K2 (its lane kernel),
K9 (csrc/sgsc.cu), K1 (csrc/mvdr.cu), K6 (csrc/kws.cu), K10 (csrc/srp.cu),
the MCRA lane kernel (csrc/mcra.cu), the TDGSC front end
(csrc/gsc_front.cu) and WPE's recursion (csrc/wpe.cu) rehearsed on the CPU: each source compiled
with g++ against the fiber shim in ``tests/torch_cuda_shim``,
launched on CPU buffers through its wrapper's own marshalling function
(the g++ build loaded in place of the nvcc one by ``_build.swapped``) and
held to the kernel's plain version at 1e-4 of max|out| (bm likewise, p
absolutely).  K5 and K8
run B=2 x T=6 frames at Lf=256 and 128 with 4 mics, and at Lf=128 with 2,
3, 6 and 8 (K5's C = 1, 2, 5 and 7), and with the channel count a run-time
argument at 12 mics (Lf=128), 16 (K5 with the postfilter) and 20 (K8) at
Lf=256, whose buffers lie in a global scratch, with MCRA's window cut to L=1
so that p moves within the 6 frames.  K7 runs 8 frames of an echo scene at
num_block 1 and 2, hop 256 and 128, and 1, 2, 4 and 8 mics (and 9, two
blocks an utterance, at B=2; and 3, an idle mic group), with the transfer
logic firing.  K4 runs B=2 x 80 frames, the guard off, in rank-1 mode with
8-frame chunks (64 frames of LDL^H warmup, the Bennett path, a re-anchor at
frame 72): at n_fft 256 with 2, 3, 4, 6 and 8 mics (and 8 in LDL^H mode),
at 512 with 2, 3 and 4 (lane states in registers) and 6 and 8 (in shared
memory), and at 1024 with 2 (shared memory) and 8 (a global scratch); its
general variant (mixed-radix transforms) at n_fft 768 with 4 mics, 1280
with 3, 2048 with 2 and 10 (its spectra in a global scratch too) and 256
with 12 (memory lanes); K2 (a thread pair a lane, its rows split) at
n_fft 64 with 2, 3, 4 and 8 mics over 74 frames in chunks of 6 (the
handover after frame 65, a re-anchor at 72), the gate changing from frame
to frame, in LDL^H mode at 8, and at n_fft 256 over K4's frames at 12
mics (4 threads a lane, one utterance) and 28 (memory lanes in a global
scratch).  K10 runs 45 rows x 5 bins at 360
angles with 2, 3, 8 and 12 mics (one, two and, at 12, 2 x 2 k-steps a bin)
and 37 angles at 3 mics (4-byte copies of the grid), through the shim's
warp-level mma.sync m16n8k8 TF32.  K9
runs B=2 x 16 frames at Lf=128 and 64 in the default config and with
McSpp's MCRA window cut to L=3, so that p moves.  The MCRA lane kernel runs
20 frames of bursty power at F=129 and 257 with L=3, with and without
S / Smin.  K1 runs B=2 x 2 bins x 6 frames with and without the gain at 2,
3, 8 and 12 mics (frame-parallel), and 20 and 33 (by mic columns, one and
two a thread; 20 with the gain only).  K6 runs B=2 x 12
frames at Lf 256 and 128 with the defer cut so that its tap FIFO wraps,
and with Dn = 2 and 1, its gap taken against max|d| (the output is the
residual the cleaner leaves); before the FIFO wraps its output must be d
to the bit.  The TDGSC front end runs B=2 utterances of three tiles or
more (the last partial) at the cells' 4 mics with and without the
postfilter and from a strided view, at 2, 3 and 8 mics on a linear array
(K > 84 at 8), at 16 mics and at Lf=2048 (its buffers in a global scratch),
and at Lf=2048 and 2 with 3 mics; bm and d are held to 1e-5 of their max,
the powers to 1e-4.  WPE's recursion (csrc/wpe.cu) runs an AR spectrogram
at K = 4 and 6 (several states a block, a ragged last block, 40 frames: not a
multiple of its 16-frame prefetch chunk), at the cell's K = 80 over 37 frames
and over 9 (fewer than delay + N) and at K = 160 (two tiles a thread), held
to the frame loop at 1e-6 of max|e|.  The launches run in child processes
(one per kernel family, at once) with a time limit (``rehearse.py``);
mismatched barriers abort the child (the shim finds a block whose threads
all wait) and fail the test.  The refusal tests bind the g++ builds in
this process through ``_build.SIGNATURES`` (``_build.open_library``): the
launchers refuse before any launch."""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import pytest

from distantspeech_tpu_torch.ops import _build

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_cuda_shim"))
import rehearse  # noqa: E402

TOL = 1e-4
# the child processes, one per group of cases, run at once, each on one
# core (the shim's fibers take turns on the launching thread), awaited in
# this order, each with its own time limit
GROUPS = (("k5", "k8", "mcra"), ("k7",), ("k4-rank1-256", "k4-ldl-256"), ("k4-rank1-512", "k4-rank1-1024"), ("k9",),
          ("k1",), ("k6", "k10"), ("k2-rank1-256-m28",), ("k2-rank1-64", "k2-ldl-64"),
          ("k4-rank1-768", "k4-rank1-1280", "k4-rank1-2048"), ("k2-rank1-256-m12",), ("front",), ("wpe",))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    why = rehearse.compiler_ready()
    if why is not None:
        pytest.skip(why)
    return rehearse.build(sorted(set(rehearse.LIBRARIES.values())), tmp_path_factory.mktemp("csrc_rehearsal"))


@pytest.fixture(scope="module")
def gaps(libs):
    lib_dir = str(libs["flms"].parent)
    runs = [subprocess.Popen([sys.executable, rehearse.__file__, lib_dir, *group], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for group in GROUPS]
    res = {}
    for run in runs:
        out, err = run.communicate(timeout=400)
        assert run.returncode == 0, err[-4000:]
        res.update(json.loads(out.strip().splitlines()[-1]))
    return res


@pytest.mark.parametrize("case", [rehearse.case_name(*c) for c in rehearse.CASES])
def test_kernel_source_matches_plain_version(gaps, case):
    g = gaps[case]
    assert g["err"] == 0, f"{case}: the launcher returned CUDA error {g['err']}"
    if case.startswith("front"):
        # bm and d to 1e-5 of their max (the coupled notch run sample by
        # sample and a direct FIR against blocked products: ~1e-6 apart, each
        # as far from float64), the powers to 1e-4 (an FFT against a dense
        # DFT product, squared)
        for name, tol in (("bm", 1e-5), ("d", 1e-5), ("yp", 1e-4), ("up", 1e-4)):
            assert g.get(name, 0.0) < tol, f"{case}: {name} {g.get(name):.3e} of max|{name}| from the plain version"
        assert ("up" in g) == ("-core-" not in case)
        assert (g["scratch_floats"] > 0) == (case in ("front-pf-256-m16", "front-pf-2048")), g["scratch_floats"]
        assert case.endswith(("-256", "-256-m16", "-128-m2", "-128-m3", "-2-m3", "-2048-m3", "-2048")) or g["K"] > 84
        return
    if case.startswith("wpe"):
        # the same recursion in float32 in another order (P's Hermitian half
        # in registers, the shares of P X summed by rows): ~1e-7 apart over
        # these frames
        assert g["out"] < 1e-6, f"{case}: e {g['out']:.3e} of max|e| from the frame loop"
        assert g["moved"] > 0.05, f"{case}: e stayed at d ({g['moved']:.3e}), so the prediction did nothing"
        if case.endswith(("-m2", "-m3")):
            assert g["states_per_block"] > 1 and g["ragged"], g
        assert g["tiles_per_thread"] == (2 if case.endswith("-m16") else 1), g
        return
    # K6 with Dn = 1 outputs the ANC's own error, whose float32 trajectory
    # through the 1 / P normalisation of the first frames' weak bins parts
    # from the plain version's DFT products by ~1.5e-4 of max|d| (the design
    # it replaced, to the digit; the plain version itself is 2e-5 from
    # float64): held to K6's gate on the card
    tol = 1e-3 if case == "k6-dn1-256" else TOL
    assert g["out"] < tol, f"{case}: out {g['out']:.3e} of max|out| from the plain version"
    assert g.get("bm", 0.0) < TOL, f"{case}: bm {g.get('bm'):.3e} of max|bm| from the plain version"
    if case.endswith(("-m16", "-m20", "-m28")) or case == "k4-rank1-2048-m10":
        assert g["scratch_floats"] > 0, f"{case}: expected the block's buffers in a global scratch"
    if case.startswith(("k1", "k10")):
        return
    if case.startswith("k6"):
        assert g["cleaned"] > 0.1, f"{case}: the cleaner never acted ({g['cleaned']:.3e}), so the FIFO did not wrap"
        assert g["exact_passthrough"], f"{case}: before the FIFO wraps the output is not d to the bit"
        return
    if case.startswith(("k5", "k8", "k9", "mcra")):
        assert g["p"] < TOL, f"{case}: p {g['p']:.3e} from the plain version"
        assert g["p_moves"] > 0.1, f"{case}: p stayed put ({g['p_moves']:.3e}), so the gate was not exercised"
        if case.startswith("mcra"):
            assert g.get("sr", 0.0) < TOL and g.get("sr_untouched", True), f"{case}: S / Smin {g}"
        if case.startswith("k9"):
            assert g["flips"] == 0, f"{case}: {g['flips']} repair or MCRA decisions differ from the plain version's"
            assert g["repairs"] > 0, f"{case}: the xi < 0 repair never ran"
    elif case.startswith("k7"):
        assert g["flips"] == 0, f"{case}: {g['flips']} transfer decisions differ from the plain version's"
        assert g["transfers"] > 0, f"{case}: the transfer logic never fired"
        if case.endswith("-m9"):
            assert g["mics_per_block"] < 9, f"{case}: expected more than one block an utterance"
    else:
        assert g["open_steady"] > 0, f"{case}: no covariance update after the warmup, so the Bennett path did not run"
        if case.startswith("k2"):
            assert g["gate_changes"] > 0, f"{case}: the gate never changed, so no held u came from an earlier frame"


def test_shim_refuses_what_the_card_refuses(libs):
    """A launch over the card's shared-memory limit fails in the shim as on
    the card (K5 at C=7 with the postfilter and Lf=2048 needs more than a
    Hopper block's 227 KB), and the launcher refuses a C below 1 (one mic),
    an Lf that is not a power of two, and a C above 7 whose buffers need a
    global scratch (C = 31 with the postfilter at Lf=256) when it is given
    none."""
    fn = _build.open_library("flms", libs["flms"]).fused_tdgsc_launch
    buf, params = (ctypes.c_float * 8)(), (ctypes.c_float * 64)()
    a, pp = ctypes.addressof(buf), ctypes.addressof(params)
    too_big, bad_c, no_c, bad_lf = (fn(a, a, a, a, a, a, a, None, 7, 1, 1, 2048, pp, None),
                                    fn(a, a, a, a, a, a, a, None, 31, 1, 1, 256, pp, None),
                                    fn(a, a, a, None, a, a, a, None, 0, 1, 1, 256, pp, None),
                                    fn(a, a, a, None, a, a, a, None, 3, 1, 1, 96, pp, None))
    assert too_big != 0 and bad_c != 0 and no_c != 0 and bad_lf != 0


def test_launchers_refuse_shapes_just_outside_their_ranges(libs):
    """The launchers of K4 (M >= 2, n_fft a multiple of 256), K8 (M >= 2)
    and K9 (frame_len 64, 128 or 256) refuse what lies just outside, before
    any launch; the shapes just inside need (K4 at 1024 with 8 mics, at 256
    with 9 and at 768 and 2048 with 2: the general variant keeps its lane
    states there) or do not need (256 with 8) a global scratch, and a launch
    that needs one refuses to run without it."""
    enh, fd, sg = (_build.open_library(n, libs[n]) for n in ("enhance", "fdgsc", "sgsc"))
    buf, params = (ctypes.c_float * 8)(), (ctypes.c_float * 64)()
    a, pp = ctypes.addressof(buf), ctypes.addressof(params)
    k4, k8, k9 = enh.fused_enhance_full_launch, fd.fused_fdgsc_launch, sg.fused_sgsc_launch
    refused = [enh.fused_enhance_full_scratch_floats(m, n) for m, n in ((1, 256), (2, 384), (2, 128))]
    scratch = [enh.fused_enhance_full_scratch_floats(m, n) for m, n in ((8, 256), (8, 1024), (9, 256), (2, 768),
                                                                        (2, 2048))]
    k4_bad = [k4(a, a, a, a, None, m, 1, n, 1, 1.0, pp, None) for m, n in ((1, 256), (2, 384), (2, 128))]
    k4_no_scratch = [k4(a, a, a, a, None, m, 1, n, 1, 1.0, pp, None) for m, n in ((8, 1024), (9, 256), (2, 768))]
    k8_bad = [k8(a, a, a, a, a, a, a, a, None, m, 1, 1, 256, pp, None) for m in (1, 40)]
    k9_bad = [k9(a, a, a, a, a, a, a, 1, 1, lf, pp, None) for lf in (32, 512)]
    assert refused == [-1] * 3 and scratch[0] == 0 and all(n > 0 for n in scratch[1:])
    assert all(e != 0 for e in k4_bad + k4_no_scratch + k8_bad + k9_bad)


def test_the_front_end_launcher_refuses_what_it_does_not_take(libs):
    """The TDGSC front end's launcher refuses one mic, an Lf that is not a
    power of two from 2 to 2048, no taps, no utterance and no frame, and a
    shape whose buffers need a global scratch (16 mics at Lf=256) when it is
    given none; its scratch is 0 at the cells' shape."""
    lib = _build.open_library("gsc_front", libs["gsc_front"])
    buf, params = (ctypes.c_float * 8)(), (ctypes.c_float * 16)()
    a, pp = ctypes.addressof(buf), ctypes.addressof(params)
    sc, fn = lib.gsc_front_scratch_floats, lib.gsc_front_launch
    shapes = ((1, 1, 256, 84), (4, 1, 96, 84), (4, 1, 4096, 84), (4, 1, 256, 0), (4, 0, 256, 84))
    refused, sizes = [sc(*s) for s in shapes], [sc(4, 128, 256, 84), sc(16, 1, 256, 84)]
    bad = [fn(a, 0, 0, a, a, a, a, a, a, a, None, b, m, 1, lf, k, pp, None) for m, b, lf, k in shapes]
    no_frame = fn(a, 0, 0, a, a, a, a, a, a, a, None, 1, 4, 0, 256, 84, pp, None)
    no_scratch = fn(a, 0, 0, a, a, a, a, a, a, a, None, 1, 16, 1, 256, 84, pp, None)
    assert refused == [-1] * 5 and sizes[0] == 0 and sizes[1] > 0
    assert all(e != 0 for e in bad + [no_frame, no_scratch])


def test_k2_and_k10_launchers_refuse_what_they_do_not_take(libs):
    """K10's launcher refuses fewer than 2 mics and an empty row, bin or
    angle range, and K2's fewer than 2 mics and, where its memory lanes
    need one (28 mics), a missing scratch, before any launch."""
    k10 = _build.open_library("srp", libs["srp"]).fused_srp_launch
    k2 = _build.open_library("enhance", libs["enhance"]).fused_enhance_launch
    buf, params = (ctypes.c_float * 8)(), (ctypes.c_float * 64)()
    a, pp = ctypes.addressof(buf), ctypes.addressof(params)
    k10_bad = [k10(a, a, a, r, f, m, th, None) for r, f, m, th in ((1, 1, 1, 1), (0, 1, 2, 1), (1, 0, 2, 1),
                                                                    (1, 1, 2, 0))]
    k2_bad = [k2(a, a, a, a, None, m, 1, 1, 1, pp, None) for m in (1, 28)]
    assert all(e != 0 for e in k10_bad + k2_bad)


def test_the_wpe_launcher_refuses_what_it_does_not_take(libs):
    """WPE's launcher refuses C N above 160 (16 channels x 11 taps), more than
    32 channels (33 x 1), no channel, no tap, a delay of 0, delay + N above
    200, and no frame, utterance or bin, before any launch, and its shape
    query refuses the same widths; just inside (16 x 10, 32 x 5, delay + N =
    200) it takes them, the cell's widths one state a block of 224 threads,
    K = 4 sixteen states a block."""
    lib = _build.open_library("wpe", libs["wpe"])
    buf, params = (ctypes.c_float * 8)(), (ctypes.c_float * 8)()
    a, pp = ctypes.addressof(buf), ctypes.addressof(params)
    fn = lib.wpe_launch

    def shape(c, n, d):
        v = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()]
        ok = lib.wpe_shape(c, n, d, *(ctypes.byref(x) for x in v))
        return [ok] + [x.value for x in v[:3]]

    widths = ((16, 11, 3), (33, 1, 3), (0, 10, 3), (8, 0, 3), (8, 10, 0), (8, 10, 191))
    inside = ((16, 10, 3), (32, 5, 3), (8, 10, 190), (8, 10, 3), (2, 2, 2))
    bad_widths = [fn(a, 1, 1, 1, 1, a, 4, 1, 3, c, n, d, pp, None) for c, n, d in widths]
    bad_sizes = [fn(a, 1, 1, 1, 1, a, t, b, f, 8, 10, 3, pp, None) for t, b, f in ((0, 1, 3), (4, 0, 3), (4, 1, 0))]
    refused, taken = [shape(*w)[0] for w in widths], [shape(*w) for w in inside]
    assert all(e != 0 for e in bad_widths + bad_sizes) and refused == [-1] * 6
    assert [t[0] for t in taken] == [0] * 5
    assert taken[3][1:] == [224, 1, 1] and taken[4][1:3] == [8, 16] and taken[0][3] == 2
