"""Rehearse the port's FLMS-family CUDA kernels on the CPU.

``build`` compiles ``distantspeech_tpu_torch/csrc/<name>.cu`` with g++
(C++20) against the shim header beside this file (``cuda_runtime.h``: one
std::thread per CUDA thread, std::barrier for the block, warp and named
barriers) into a shared library with the same C launcher as the nvcc build.
Run as a script, it launches K5 (``flms``), K8 (``fdgsc``), K7 (``aec``)
or K4 (``enhance``, the mega kernel) from such libraries on CPU buffers and
prints, as one JSON object, each case's gaps to the kernel's plain version:

    python tests/torch_cuda_shim/rehearse.py LIB_DIR [KERNEL ...]

(every kernel's cases, or those of the kernels named: k5, k8, k7, k4).

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
B, T = 2, 6  # utterances and frames of every K5 and K8 case
# K7: enough frames for the transfer logic to fire; one utterance, two for
# the 9-mic case (two blocks an utterance, so both block indices vary)
K7_FRAMES = 8
# K4: 8-frame chunks, so that rank-1 runs 8 warm chunks (64 frames of exact
# LDL^H), then the Bennett path, and re-anchors its loading at frame 72
K4_FRAMES, K4_T_CHUNK = 80, 8
# (kernel, variant, size, mics).  K5 and K8 (size = Lf): every kernel at 4
# mics and both frame lengths, and at Lf=128 the other channel counts the
# launchers are built for (K5's C = mics - 1 = 1 and 7, K8's M = 2 and 8).
CASES = [(kernel, variant, Lf, 4) for Lf in (256, 128) for kernel, variant in
         (("k5", "core"), ("k5", "postfilter"), ("k8", "core"))]
CASES += [(kernel, variant, 128, mics) for mics in (2, 8) for kernel, variant in
          (("k5", "core"), ("k5", "postfilter"), ("k8", "core"))]
# K7 (variant = num_block, size = hop): both filter splits at both hops and
# 1, 2, 4 and 8 mics; 3 mics leave a mic group of the block idle, and 9 at
# hop 256 take two blocks an utterance
CASES += [("k7", f"nb{nb}", hop, mics) for nb in (1, 2) for hop in (256, 128) for mics in (1, 2, 4, 8)]
CASES += [("k7", "nb2", 256, 9), ("k7", "nb2", 128, 3)]
# K4 (variant = inv_mode, size = n_fft): the three mic counts in rank-1 mode
# at n_fft 256, 8 mics in per-frame LDL^H, and n_fft 512 (two bins a lane
# thread) at 2 and 4 mics
CASES += [("k4", "rank1", 256, mics) for mics in (2, 4, 8)] + [("k4", "ldl", 256, 8)]
CASES += [("k4", "rank1", 512, mics) for mics in (2, 4)]
LIBRARIES = {"k5": "flms", "k8": "fdgsc", "k7": "aec", "k4": "enhance"}


def case_name(kernel: str, variant: str, size: int, mics: int) -> str:
    return f"{kernel}-{variant}-{size}" + ("" if mics == 4 else f"-m{mics}")


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


def run_k7(lib, NB: int, hop: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.adaptive.aec import AecConfig
    from distantspeech_tpu_torch.ops import cuda_aec as ca

    cfg = AecConfig(filter_len=NB * hop, num_block=NB)
    T7, B7 = K7_FRAMES, 2 if mics > 8 else 1
    S = T7 * hop
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).contiguous()
    far = rng.standard_normal((B7, S)) * 0.5
    ir = rng.standard_normal((mics, hop // 2)) * np.exp(-np.arange(hop // 2) / (hop / 16))
    echo = np.stack([np.stack([np.convolve(far[b], ir[m])[:S] for m in range(mics)]) for b in range(B7)])
    x = echo * rng.uniform(0.5, 2.0, (B7, mics, 1)) + 0.05 * rng.standard_normal((B7, mics, S))
    farp, xp = (a.contiguous() for a in ca._prepare(f32(far), f32(x), cfg))
    out, upd = torch.full((B7, mics, S), float("nan")), torch.full((B7, mics, T7), float("nan"))
    params = ca._aec_params(cfg)
    fn = lib.fused_aec_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    err = fn(farp.data_ptr(), xp.data_ptr(), ca._tables(cfg.n_fft, torch.device("cpu")).data_ptr(), out.data_ptr(),
             upd.data_ptr(), NB, B7, mics, T7, hop, ctypes.addressof(params), None)
    want, u_want = ca.aec_frames_plain(farp, xp, cfg, decisions=True)
    layout = lib.fused_aec_layout
    layout.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    smem = ctypes.c_longlong()
    per_block = layout(NB, hop, mics, ctypes.byref(smem))
    return {"err": err, "out": _gap(out, want), "flips": int(((upd > 0.5) != u_want).sum()),
            "transfers": int(u_want.sum()), "mics_per_block": per_block, "smem_bytes": smem.value}


def open_steady(x, cfg, t_chunk: int) -> int:
    """Lane-frames whose covariance gate opens after the rank-1 warmup (the
    gate depends on MCRA alone; the guard is off)."""
    from distantspeech_tpu_torch.noise.mcra import mcra_run
    from distantspeech_tpu_torch.ops.cuda_enhance import _warm_chunks
    from distantspeech_tpu_torch.transform import analysis

    X0 = analysis(x[:, 0], cfg.stft)  # [B, T, F]
    _, p = mcra_run(cfg.mvdr.mcra, (X0.abs() ** 2).transpose(0, 1).contiguous())
    return int((p < cfg.mvdr.p_vad)[_warm_chunks(t_chunk) * t_chunk:].sum())


def run_k4(lib, mics: int, inv_mode: str, n_fft: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig
    from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig
    from distantspeech_tpu_torch.ops import cuda_enhance as ce
    from distantspeech_tpu_torch.transform.stft import StftConfig

    # the guard off (no decision of the kernel's can part from the plain
    # version's); rel_diag on, so that rank-1 re-anchors its loading
    cfg = EnhanceConfig(mvdr=MvdrConfig(stft=StftConfig(n_fft, n_fft // 2), vad_guard=False, rel_diag=1e-5))
    hop, T4, tc = cfg.stft.hop, K4_FRAMES, K4_T_CHUNK
    rng = np.random.default_rng(seed)
    env = np.repeat(rng.random((B, T4)) < 0.5, hop, axis=1)  # speech-like bursts that MCRA sees come and go
    x = env[:, None] * rng.standard_normal((B, 1, T4 * hop)) + 0.3 * rng.standard_normal((B, mics, T4 * hop))
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    steer = steering_vector(ArrayGeometry.linear(mics, 0.032), np.array([np.pi / 2, 0.0]), cfg.stft.n_fft)
    _, planes, _ = ce._prepare(x, steer.astype(np.complex64), cfg, tc, inv_mode)
    y = torch.full((B, T4 * hop), float("nan"))
    params = ce._lane_params(cfg, mics, tc, inv_mode)
    fn = lib.fused_enhance_full_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), ce._dft_tables(cfg.stft, torch.device("cpu")).data_ptr(), planes.data_ptr(), y.data_ptr(),
             mics, B, cfg.stft.n_fft, T4, cfg.stft.synthesis_gain, ctypes.addressof(params), None)
    want = ce.fused_enhance_plain(x, steer.astype(np.complex64), cfg, tc, inv_mode)
    return {"err": err, "out": _gap(y, want), "open_steady": open_steady(x, cfg, tc)}


def main(lib_dir: str, kernels=()) -> None:
    sys.path.insert(0, str(ROOT))
    kernels = set(kernels or LIBRARIES)
    libs = {k: ctypes.CDLL(str(Path(lib_dir) / f"lib{LIBRARIES[k]}.so")) for k in kernels}
    res = {}
    for i, (kernel, variant, size, mics) in enumerate(CASES):
        if kernel not in kernels:
            continue
        lib = libs[kernel]
        if kernel == "k5":
            g = run_k5(lib, variant, size, mics, seed=i)
        elif kernel == "k8":
            g = run_k8(lib, size, mics, seed=i)
        elif kernel == "k7":
            g = run_k7(lib, int(variant[2:]), size, mics, seed=i)
        else:
            g = run_k4(lib, mics, variant, size, seed=i)
        res[case_name(kernel, variant, size, mics)] = g
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
