"""K5 (csrc/flms.cu, core and postfilter), K8 (csrc/fdgsc.cu), K7
(csrc/aec.cu), K4 (csrc/enhance.cu's mega kernel), K9 (csrc/sgsc.cu) and the
MCRA lane kernel (csrc/mcra.cu) rehearsed on the CPU: each source compiled
with g++ against the thread-and-barrier shim in ``tests/torch_cuda_shim``,
launched through its C launcher on CPU buffers and held to the kernel's
plain version at 1e-4 of max|out| (bm likewise, p absolutely).  K5 and K8
run B=2 x T=6 frames at Lf=256 and 128 with 4 mics, and at Lf=128 with 2,
3, 6 and 8 (K5's C = 1, 2, 5 and 7), with MCRA's window cut to L=1 so that
p moves within the 6 frames.  K7 runs 8 frames of an echo scene at
num_block 1 and 2, hop 256 and 128, and 1, 2, 4 and 8 mics (and 9, two
blocks an utterance, at B=2; and 3, an idle mic group), with the transfer
logic firing.  K4 runs B=2 x 80 frames, the guard off, in rank-1 mode with
8-frame chunks (64 frames of LDL^H warmup, the Bennett path, a re-anchor at
frame 72): at n_fft 256 with 2, 3, 4, 6 and 8 mics (and 8 in LDL^H mode),
at 512 with 2, 3 and 4 (lane states in registers) and 6 and 8 (in shared
memory), and at 1024 with 2 (shared memory) and 8 (a global scratch).  K9
runs B=2 x 16 frames at Lf=128 and 64 in the default config and with
McSpp's MCRA window cut to L=3, so that p moves.  The MCRA lane kernel runs
20 frames of bursty power at F=129 and 257 with L=3, with and without
S / Smin.  The launches run in child processes (one per kernel family, at
once) with a time limit (``rehearse.py``), so mismatched barriers fail the
test instead of hanging it."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_cuda_shim"))
import rehearse  # noqa: E402

TOL = 1e-4
# the child processes, one per group of cases, run at once
GROUPS = (("k5", "k8", "mcra"), ("k7",), ("k4-rank1-256", "k4-ldl-256"), ("k4-rank1-512", "k4-rank1-1024"), ("k9",))


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
    assert g["out"] < TOL, f"{case}: out {g['out']:.3e} of max|out| from the plain version"
    assert g.get("bm", 0.0) < TOL, f"{case}: bm {g.get('bm'):.3e} of max|bm| from the plain version"
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


def test_shim_refuses_what_the_card_refuses(libs):
    """A launch over the card's shared-memory limit fails in the shim as on
    the card (K5 at C=7 with the postfilter and Lf=2048 needs more than a
    Hopper block's 227 KB), and the launcher refuses a C just outside the
    1 .. 7 it is built for (8 and 0: 9 mics and 1) and an Lf that is not a
    power of two."""
    code = (
        "import ctypes, sys\n"
        f"lib = ctypes.CDLL({str(libs['flms'])!r})\n"
        "fn = lib.fused_tdgsc_launch\n"
        "fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2\n"
        "params = (ctypes.c_float * 64)()\n"
        "buf = (ctypes.c_float * 8)()\n"
        "a = ctypes.addressof(buf)\n"
        "print(fn(a, a, a, a, a, a, a, 7, 1, 1, 2048, ctypes.addressof(params), None),"
        " fn(a, a, a, None, a, a, a, 8, 1, 1, 256, ctypes.addressof(params), None),"
        " fn(a, a, a, None, a, a, a, 0, 1, 1, 256, ctypes.addressof(params), None),"
        " fn(a, a, a, None, a, a, a, 3, 1, 1, 96, ctypes.addressof(params), None))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr[-2000:]
    too_big, bad_c, no_c, bad_lf = (int(v) for v in run.stdout.split())
    assert too_big != 0 and bad_c != 0 and no_c != 0 and bad_lf != 0


def test_launchers_refuse_shapes_just_outside_their_ranges(libs):
    """The launchers of K4 (M 2 to 8, n_fft 256, 512 or 1024), K8 (M 2 to 8)
    and K9 (frame_len 64, 128 or 256) refuse what lies just outside, before
    any launch; the shapes just inside need (K4 at 1024 with 8 mics) or do
    not need (256 with 8) a global scratch."""
    code = (
        "import ctypes\n"
        f"enh, fd, sg = (ctypes.CDLL(p) for p in {[str(libs[n]) for n in ('enhance', 'fdgsc', 'sgsc')]!r})\n"
        "params = (ctypes.c_float * 64)()\n"
        "buf = (ctypes.c_float * 8)()\n"
        "a, pp = ctypes.addressof(buf), ctypes.addressof(params)\n"
        "enh.fused_enhance_full_scratch_floats.argtypes = [ctypes.c_int] * 2\n"
        "k4 = enh.fused_enhance_full_launch\n"
        "k4.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 2\n"
        "k8 = fd.fused_fdgsc_launch\n"
        "k8.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2\n"
        "k9 = sg.fused_sgsc_launch\n"
        "k9.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2\n"
        "print([enh.fused_enhance_full_scratch_floats(m, n) for m, n in ((1, 256), (9, 256), (2, 768), (2, 2048),"
        " (8, 256), (8, 1024))],"
        " [k4(a, a, a, a, None, m, 1, n, 1, 1.0, pp, None) for m, n in ((1, 256), (9, 256), (2, 768), (2, 2048))],"
        " [k4(a, a, a, a, None, 8, 1, 1024, 1, 1.0, pp, None)],"
        " [k8(a, a, a, a, a, a, a, a, m, 1, 1, 256, pp, None) for m in (1, 9)],"
        " [k9(a, a, a, a, a, a, a, 1, 1, lf, pp, None) for lf in (32, 512)], sep=';')\n"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr[-2000:]
    scratch, k4_bad, k4_no_scratch, k8_bad, k9_bad = (json.loads(v) for v in run.stdout.strip().split(";"))
    assert scratch[:4] == [-1] * 4 and scratch[4] == 0 and scratch[5] > 0
    assert all(e != 0 for e in k4_bad + k4_no_scratch + k8_bad + k9_bad)
