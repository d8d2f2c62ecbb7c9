"""K5 (csrc/flms.cu, core and postfilter), K8 (csrc/fdgsc.cu), K7
(csrc/aec.cu) and K4 (csrc/enhance.cu's mega kernel) rehearsed on the CPU:
each source compiled with g++ against the thread-and-barrier shim in
``tests/torch_cuda_shim``, launched through its C launcher on CPU buffers
and held to the kernel's plain version at 1e-4 of max|out| (bm likewise, p
absolutely).  K5 and K8 run B=2 x T=6 frames at Lf=256 and 128 with 4 mics,
and at Lf=128 with 2 and 8 (K5's C = 1 and 7, K8's M = 2 and 8), with
MCRA's window cut to L=1 so that p moves within the 6 frames.  K7 runs 8
frames of an echo scene at num_block 1 and 2, hop 256 and 128, and 1, 2, 4
and 8 mics (and 9, two blocks an utterance, at B=2; and 3, an idle mic
group), with the transfer logic firing.  K4 runs B=2 x 80 frames, the
guard off: at n_fft 256 with 2, 4 and 8 mics in rank-1 mode with 8-frame
chunks (64 frames of LDL^H warmup, the Bennett path, a re-anchor at frame
72) and with 8 in LDL^H mode, and at n_fft 512 with 2 and 4.  The launches run in child processes (one per kernel family, at once)
with a time limit (``rehearse.py``), so mismatched barriers fail the test
instead of hanging it."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / "torch_cuda_shim"))
import rehearse  # noqa: E402

TOL = 1e-4


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
                             stderr=subprocess.PIPE, text=True) for group in (("k5", "k8"), ("k7",), ("k4",))]
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
    if case.startswith(("k5", "k8")):
        assert g["p"] < TOL, f"{case}: p {g['p']:.3e} from the plain version"
        assert g["p_moves"] > 0.1, f"{case}: MCRA's p stayed put ({g['p_moves']:.3e}), so the gate was not exercised"
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
    Hopper block's 227 KB), and the launcher refuses a C it is not built for
    and an Lf that is not a power of two."""
    code = (
        "import ctypes, sys\n"
        f"lib = ctypes.CDLL({str(libs['flms'])!r})\n"
        "fn = lib.fused_tdgsc_launch\n"
        "fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2\n"
        "params = (ctypes.c_float * 64)()\n"
        "buf = (ctypes.c_float * 8)()\n"
        "a = ctypes.addressof(buf)\n"
        "print(fn(a, a, a, a, a, a, a, 7, 1, 1, 2048, ctypes.addressof(params), None),"
        " fn(a, a, a, None, a, a, a, 5, 1, 1, 256, ctypes.addressof(params), None),"
        " fn(a, a, a, None, a, a, a, 3, 1, 1, 96, ctypes.addressof(params), None))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr[-2000:]
    too_big, bad_c, bad_lf = (int(v) for v in run.stdout.split())
    assert too_big != 0 and bad_c != 0 and bad_lf != 0
