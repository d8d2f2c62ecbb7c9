"""Rehearse the port's FLMS-family CUDA kernels on the CPU.

``build`` compiles ``distantspeech_tpu_torch/csrc/<name>.cu`` with g++
(C++20) against the shim header beside this file (``cuda_runtime.h``: one
std::thread per CUDA thread, std::barrier for the block, warp and named
barriers) into a shared library with the same C launcher as the nvcc build.
Run as a script, it launches K5 (``flms``) and K8 (``fdgsc``) from such
libraries on CPU buffers and prints, as one JSON object, each case's gaps to
the kernel's plain version:

    python tests/torch_cuda_shim/rehearse.py LIB_DIR

The launches run in this separate process so that a kernel whose barriers
do not match cannot hang the caller: the caller gives it a time limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CSRC = ROOT / "distantspeech_tpu_torch" / "csrc"
FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas")
B, T = 2, 6  # utterances and frames of every case
# (kernel, variant, Lf, mics): every kernel at 4 mics and both frame lengths,
# and at Lf=128 the other channel counts the launchers are built for (K5's
# C = mics - 1 = 1 and 7, K8's M = 2 and 8)
CASES = [(kernel, variant, Lf, 4) for Lf in (256, 128) for kernel, variant in
         (("k5", "core"), ("k5", "postfilter"), ("k8", "core"))]
CASES += [(kernel, variant, 128, mics) for mics in (2, 8) for kernel, variant in
          (("k5", "core"), ("k5", "postfilter"), ("k8", "core"))]


def case_name(kernel: str, variant: str, Lf: int, mics: int) -> str:
    return f"{kernel}-{variant}-{Lf}" + ("" if mics == 4 else f"-m{mics}")


def rewrite(source: str) -> str:
    """The two constructs g++ cannot parse: the ``<<<grid, block, smem,
    stream>>>`` launch and ``extern __shared__``."""
    source = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", r"shim::launch(\2, [&] { \1(\3); });", source)
    return re.sub(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];", r"\1* \2 = static_cast<\1*>(shim::dynamic_smem());",
                  source)


def compiler_ready() -> str | None:
    """Why the rehearsal cannot run here (no g++, or no C++20 <barrier>), or None."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found"
    probe = subprocess.run([gxx, "-std=c++20", "-fsyntax-only", "-x", "c++", "-"], input="#include <barrier>\n",
                           capture_output=True, text=True)
    return None if probe.returncode == 0 else "g++ has no C++20 <barrier>"


def build(names, out_dir: Path) -> dict:
    """Compile csrc/<name>.cu for each name, all at once; {name: library}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out_dir / f"{name}.cpp"
        src.write_text(rewrite((CSRC / f"{name}.cu").read_text()))
        lib = out_dir / f"lib{name}.so"
        cmd = ["g++", *FLAGS, "-I", str(HERE), "-I", str(CSRC), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log}")
    if failed:
        raise RuntimeError("g++ failed:\n" + "\n".join(failed))
    return {name: lib for name, (lib, _) in procs.items()}


def _short_mcra(base):
    """``base`` with MCRA's window cut to L=1, so that p moves from frame 2
    on (MCRA holds p = 0 for its first 2L frames)."""

    class Short(base):
        @property
        def mcra(self):
            return dataclasses.replace(super().mcra, L=1)

    return Short


def _gap(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def run_k5(lib, variant: str, Lf: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig
    from distantspeech_tpu_torch.ops import cuda_flms as cf

    cfg = _short_mcra(TdGscConfig)(n_mics=mics, frame_len=Lf, postfilter=variant == "postfilter")
    C, F, S = cfg.n_mics - 1, Lf + 1, T * Lf
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).contiguous()
    bm, d = f32(rng.standard_normal((B, C, S))), f32(rng.standard_normal((B, S)))
    yp = f32(rng.gamma(1.0, 1.0, (B, T, F)) * rng.uniform(0.2, 5.0, (B, T, 1)))
    up = f32(rng.gamma(1.0, 1.0, (B, C, T, F))) if cfg.postfilter else None
    out, p = torch.full((B, S), float("nan")), torch.full((B, T, F), float("nan"))
    params = cf._tdgsc_params(cfg)
    fn = lib.fused_tdgsc_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    err = fn(bm.data_ptr(), d.data_ptr(), yp.data_ptr(), up.data_ptr() if up is not None else None,
             cf._tables(2 * Lf, torch.device("cpu")).data_ptr(), out.data_ptr(), p.data_ptr(), C, B, T, Lf,
             ctypes.addressof(params), None)
    want, p_want = cf.tdgsc_frames_plain(bm, d, yp, up, cfg)
    return {"err": err, "out": _gap(out, want), "p": float((p - p_want).abs().max()),
            "p_moves": float(p_want.max() - p_want.min())}


def run_k8(lib, Lf: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig
    from distantspeech_tpu_torch.ops import cuda_flms as cf

    cfg = _short_mcra(FdGscConfig)(n_mics=mics, frame_len=Lf)
    M, F, S = cfg.n_mics, Lf + 1, T * Lf
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).contiguous()
    fbf = rng.standard_normal((B, S))
    dbm = f32(fbf[:, None] + 0.3 * rng.standard_normal((B, M, S)))
    daic = f32(np.pad(fbf, ((0, 0), (Lf, 0)))[:, :S])
    fbf = f32(fbf)
    yp = f32(rng.gamma(1.0, 1.0, (B, T, F)) * rng.uniform(0.2, 5.0, (B, T, 1)))
    out, p, bm = torch.full((B, S), float("nan")), torch.full((B, T, F), float("nan")), torch.full((B, M, S), float("nan"))
    params = cf._fdgsc_params(cfg)
    fn = lib.fused_fdgsc_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    err = fn(fbf.data_ptr(), dbm.data_ptr(), daic.data_ptr(), yp.data_ptr(),
             cf._fdgsc_tables(2 * Lf, torch.device("cpu")).data_ptr(), out.data_ptr(), p.data_ptr(), bm.data_ptr(),
             M, B, T, Lf, ctypes.addressof(params), None)
    want, p_want, bm_want = cf.fdgsc_frames_plain(fbf, dbm, daic, yp, cfg)
    return {"err": err, "out": _gap(out, want), "bm": _gap(bm, bm_want), "p": float((p - p_want).abs().max()),
            "p_moves": float(p_want.max() - p_want.min())}


def main(lib_dir: str) -> None:
    sys.path.insert(0, str(ROOT))
    libs = {name: ctypes.CDLL(str(Path(lib_dir) / f"lib{name}.so")) for name in ("flms", "fdgsc")}
    res = {}
    for i, (kernel, variant, Lf, mics) in enumerate(CASES):
        key = case_name(kernel, variant, Lf, mics)
        res[key] = (run_k5(libs["flms"], variant, Lf, mics, seed=i) if kernel == "k5" else
                    run_k8(libs["fdgsc"], Lf, mics, seed=i))
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1])
