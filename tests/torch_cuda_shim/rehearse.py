"""Rehearse the port's FLMS-family CUDA kernels on the CPU.

``build`` compiles ``distantspeech_tpu_torch/csrc/<name>.cu`` with g++
(C++20) against the shim header beside this file (``cuda_runtime.h``: a
fiber per CUDA thread, the block's fibers taking turns at its block, warp
and named barriers) into a shared library with the same C launcher as the nvcc build.
Run as a script, it launches K5 (``flms``), K8 (``fdgsc``), K7 (``aec``),
K4 and K2 (``enhance``), K9 (``sgsc``), K1 (``mvdr``), K6 (``kws``), K10
(``srp``), the MCRA lane kernel (``mcra``), the TDGSC front end
(``gsc_front``) or WPE's recursion (``wpe``) from such libraries on CPU
buffers and prints, as one JSON object, each case's gaps to the kernel's
plain version.  Each case loads its library in place of the nvcc build
(``_build.swapped``, which types it from ``_build.SIGNATURES``) and calls
the wrapper's own marshalling function (``cuda_flms._tdgsc_launch``, ...)
with stream None, so that the arguments the card gets are the ones
rehearsed:

    python tests/torch_cuda_shim/rehearse.py LIB_DIR [KERNEL ...]

(every kernel's cases, or those of the kernels named, k5, k8, k7, k4, k2,
k9, k1, k6, k10, mcra, front, wpe, or of the cases whose names start with a given
prefix and a dash, such as k4-rank1-256).

The launches run in this separate process so that a kernel whose barriers
do not match cannot hang the caller: the caller gives it a time limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import platform
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
CASES += [(kernel, variant, 128, mics) for mics in (2, 8, 3, 6) for kernel, variant in
          (("k5", "core"), ("k5", "postfilter"), ("k8", "core"))]
# above 8 mics, the channel count a run-time argument: 12 mics at Lf=128
# (in shared memory), and 16 at Lf=256 with the postfilter and 20 with K8
# (their buffers in a global scratch)
CASES += [("k5", "core", 128, 12), ("k5", "postfilter", 128, 12), ("k8", "core", 128, 12)]
CASES += [("k5", "postfilter", 256, 16), ("k8", "core", 256, 20)]
# K7 (variant = num_block, size = hop): both filter splits at both hops and
# 1, 2, 4 and 8 mics; 3 mics leave a mic group of the block idle, and 9 at
# hop 256 take two blocks an utterance
CASES += [("k7", f"nb{nb}", hop, mics) for nb in (1, 2) for hop in (256, 128) for mics in (1, 2, 4, 8)]
CASES += [("k7", "nb2", 256, 9), ("k7", "nb2", 128, 3)]
# K4 (variant = inv_mode, size = n_fft): rank-1 mode at n_fft 256 with 2, 3,
# 4, 6 and 8 mics (an odd M's last mic pair holds one mic), 8 mics in
# per-frame LDL^H, n_fft 512 with the lane states in registers (two bins a
# lane thread: 2, 3 and 4 mics) and in shared memory (6 and 8), and 1024
# with them in shared memory (2 mics) and in a global scratch (8)
CASES += [("k4", "rank1", 256, mics) for mics in (2, 3, 4, 6, 8)] + [("k4", "ldl", 256, 8)]
CASES += [("k4", "rank1", 512, mics) for mics in (2, 3, 4, 6, 8)]
CASES += [("k4", "rank1", 1024, mics) for mics in (2, 8)]
# the mega kernel's general variant: mixed-radix transforms at n_fft 768
# (8 8 4 3) and 1280 (8 8 4 5), 2048 (more bins than threads), and 12 mics
# (memory lanes in a global scratch)
CASES += [("k4", "rank1", 768, 4), ("k4", "rank1", 1280, 3), ("k4", "rank1", 2048, 2), ("k4", "rank1", 256, 12)]
# and at 2048 with 10 mics, where its spectra outgrow shared memory too
CASES += [("k4", "rank1", 2048, 10)]
# K2 (enhance.cu's lane kernel) above 8 mics, rank-1 at n_fft 256: 12 mics
# (4 threads a lane, its state in registers) and, the last case, 28 (its
# memory lanes in a global scratch)
CASES += [("k2", "rank1", 256, 12)]
# K9 (variant = config, size = Lf): the default config and McSpp's MCRA
# window cut to L=3 (so that p moves within the frames), at Lf=128 (one warp
# a transform) and 256 (two)
K9_FRAMES = 12
CASES += [("k9", variant, Lf, 4) for variant in ("default", "short") for Lf in (128, 256)]
# the MCRA lane kernel (variant: with or without S / Smin, size = F): a
# window of L = 3 at F = 129 and 257, so that p moves and the minima reset
CASES += [("mcra", variant, F, 1) for variant in ("sr", "nosr") for F in (129, 257)]
# K6 (variant = defer, size = Lf): B=2 x 12 frames with the defer cut so
# that the FIFO wraps (Dn = 4 at Lf 256, 7 at 128), Dn = 2 (the slot read
# for the next frame is the one written the frame before), and Dn = 1,
# where the cleaner runs the ANC's own taps
K6_FRAMES = 12
K6_DEFER = {"wrap": 0.05, "dn2": 0.02, "dn1": 0.0}
CASES += [("k6", "wrap", Lf, 2) for Lf in (256, 128)] + [("k6", "dn2", 256, 2), ("k6", "dn1", 256, 2)]
# K1 (variant = gain or none, size = mics): B=2 x 2 bins x 6 frames (the
# last block of 4 frames partial), a gate open on ~70% of the lane-frames,
# at 2, 3 and 8 mics (the frame-parallel layout: 4 threads a lane, a frame
# each), 12 (the column layout, a group of 16 threads with 4 idle columns)
# and 33 (32 threads a lane, two columns a thread; ~1,300 shuffles a frame,
# each a barrier of the shim's 32 warp threads, so the case stays small)
K1_FRAMES, K1_BINS = 6, 2
CASES += [("k1", variant, mics, mics) for variant in ("gain", "none") for mics in (2, 3, 8, 12, 33)]
# Last, so that the cases before keep their seeds: K2 with its memory lanes
# in a global scratch (28 mics), and K1 by mic columns with one column a
# thread (20 mics; 33 takes two)
CASES += [("k2", "rank1", 256, 28), ("k1", "gain", 20, 20)]
# K2 up to 8 mics (a thread pair a lane, its rows split): rank-1 at n_fft 64
# (33 bins: the first, the interior and the last) with 2, 3, 4 and 8 mics
# over K2_FRAMES frames in chunks of K2_T_CHUNK: 11 warm chunks (66 frames
# of exact LDL^H), the handover after frame 65 and a re-anchor at frame 72;
# and LDL^H mode at 8.  (Each of the kernel's shuffles is a barrier of 32
# threads in the shim, so the lanes are few.)
K2_FRAMES, K2_T_CHUNK = 74, 6
CASES += [("k2", "rank1", 64, mics) for mics in (2, 3, 4, 8)] + [("k2", "ldl", 64, 8)]
# K10 (variant = the angles, size = mics): K10_ROWS rows (a block of 32 and
# a partial one) x K10_BINS bins, 360 angles (the grid's rows by 16-byte
# copies) at 2, 3 and 8 mics (one and two k-steps a bin) and 12 (a bin in two
# steps of the ring, two blocks of angles), and 37 angles at 3 mics (4-byte
# copies, a partial column tile)
K10_ROWS, K10_BINS = 45, 5
CASES += [("k10", "t360", mics, mics) for mics in (2, 3, 8, 12)] + [("k10", "t37", 3, 3)]
# The TDGSC front end (csrc/gsc_front.cu; variant: with the postfilter's
# powers, without, or the mics a strided view whose rows are not 16-byte
# aligned; size = Lf): B=2 utterances of FRONT_FRAMES[Lf] frames, three
# tiles or more with the last one partial (at Lf=2 its last notch chunk
# too), at 4 mics (the cells' shape), 2, 3 and 8 (a tile of 1024) on a
# linear array steered off broadside so that K > 84, 16 at Lf=256 and 4 at
# Lf=2048 (the buffers in a global scratch), 3 at Lf=2048 (4096-point
# transforms of 8 warps) and 3 at Lf=2.
FRONT_FRAMES = {2: 1100, 128: 36, 256: 20, 2048: 3}
CASES += [("front", "pf", 256, 4), ("front", "core", 256, 4), ("front", "strided", 256, 4)]
CASES += [("front", "pf", 128, mics) for mics in (2, 3, 8)]
CASES += [("front", "pf", 256, 16), ("front", "pf", 2048, 4), ("front", "core", 2048, 3), ("front", "pf", 2, 3)]
# WPE's recursion (csrc/wpe.cu; variant = taps a channel, size = frames, mics =
# channels) on an AR spectrogram whose channels each echo themselves `delay`
# frames later, so that the prediction has something to find: K = 4 (2 x 2
# taps, 16 states a block of 8-thread groups) and K = 6 (3 x 2, padded to 8)
# over 3 utterances x 9 bins (27 states: a ragged last block), 40 frames (not
# a multiple of the 16-frame prefetch chunk); the cell's K = 80 (8 x 10) over
# 37 frames and over 9, fewer than delay + N; and K = 160 (16 x 10, two tiles a
# thread), 1 utterance x 3 bins; and K = 20 (4 x 5: two 64-thread groups a
# block, the error sums on a warp of their own)
CASES += [("wpe", "n2", 40, 2), ("wpe", "n2", 40, 3), ("wpe", "n10", 37, 8), ("wpe", "n10", 9, 8),
          ("wpe", "n10", 20, 16), ("wpe", "n5", 40, 4)]
LIBRARIES = {"k1": "mvdr", "k2": "enhance", "k5": "flms", "k8": "fdgsc", "k7": "aec", "k4": "enhance", "k9": "sgsc",
             "mcra": "mcra", "k6": "kws", "k10": "srp", "front": "gsc_front", "wpe": "wpe"}


# a case (kernel, variant, size, mics) runs in run_<kernel>(variant, size, mics, seed)
def case_name(kernel: str, variant: str, size: int, mics: int) -> str:
    return f"{kernel}-{variant}-{size}" + ("" if mics in (4, 1) or kernel in ("k6", "k1", "k10") else f"-m{mics}")


def rewrite(source: str) -> str:
    """The two constructs g++ cannot parse: the ``<<<grid, block, smem,
    stream>>>`` launch (its arguments may span lines) and ``extern
    __shared__``."""
    source = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", r"shim::launch(\2, [&] { \1(\3); });", source,
                    flags=re.S)
    return re.sub(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];", r"\1* \2 = static_cast<\1*>(shim::dynamic_smem());",
                  source)


def compiler_ready() -> str | None:
    """Why the rehearsal cannot run here (not x86-64, whose context switch
    the shim writes in assembly; no g++; or one without C++20), or None."""
    if platform.machine() not in ("x86_64", "AMD64"):
        return f"the shim's fibers switch stacks in x86-64 assembly, not on {platform.machine()}"
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found"
    probe = subprocess.run([gxx, "-std=c++20", "-fsyntax-only", "-I", str(HERE), "-x", "c++", "-"],
                           input="#include <cuda_runtime.h>\n", capture_output=True, text=True)
    return None if probe.returncode == 0 else f"g++ cannot compile the shim: {probe.stderr[-500:]}"


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


def _nan(t):
    """``t`` (a scratch buffer, or None) filled with NaN, so that a read of
    a word the kernel did not write shows."""
    return t.fill_(float("nan")) if t is not None else None


def _floats(t) -> int:
    return t.numel() if t is not None else 0


def _gap(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def run_k5(variant: str, Lf: int, mics: int, seed: int) -> dict:
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
    scratch = _nan(cf._scratch("flms", bm.device, C, B, Lf, int(cfg.postfilter)))
    err = cf._tdgsc_launch(bm, d, yp, up, cfg, out, p, scratch, None)
    want, p_want = cf.tdgsc_frames_plain(bm, d, yp, up, cfg)
    return {"err": err, "out": _gap(out, want), "p": float((p - p_want).abs().max()),
            "p_moves": float(p_want.max() - p_want.min()), "scratch_floats": _floats(scratch)}


def run_k8(variant: str, Lf: int, mics: int, seed: int) -> dict:
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
    scratch = _nan(cf._scratch("fdgsc", dbm.device, M, B, Lf))
    err = cf._fdgsc_launch(fbf, dbm, daic, yp, cfg, out, p, bm, scratch, None)
    want, p_want, bm_want = cf.fdgsc_frames_plain(fbf, dbm, daic, yp, cfg)
    return {"err": err, "out": _gap(out, want), "bm": _gap(bm, bm_want), "p": float((p - p_want).abs().max()),
            "p_moves": float(p_want.max() - p_want.min()), "scratch_floats": _floats(scratch)}


def run_k7(variant: str, hop: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.adaptive.aec import AecConfig
    from distantspeech_tpu_torch.ops import cuda_aec as ca

    NB = int(variant[2:])
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
    err = ca._launch(farp, xp, cfg, out, upd, None)
    want, u_want = ca.aec_frames_plain(farp, xp, cfg, decisions=True)
    per_block, smem = ca.launch_layout(cfg, mics)
    return {"err": err, "out": _gap(out, want), "flips": int(((upd > 0.5) != u_want).sum()),
            "transfers": int(u_want.sum()), "mics_per_block": per_block, "smem_bytes": smem}


def run_k1(variant: str, size: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.ops import cuda_mvdr as cm

    T1, F, M, gain = K1_FRAMES, K1_BINS, mics, variant == "gain"
    rng = np.random.default_rng(seed)
    cplx = lambda *s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    Z = torch.as_tensor((cplx(T1, B, F, M) + 2.0 * cplx(T1, B, F, 1)).astype(np.complex64))
    gate = rng.random((T1, B, F)) < 0.7
    gate[0] = True  # u = 0 until a first update, and y = 0 / 0
    gate = torch.as_tensor(gate.astype(np.float32))
    steer = torch.as_tensor(np.exp(1j * rng.uniform(0, 2 * np.pi, (F, M))).astype(np.complex64))
    pl = [torch.as_tensor(a, dtype=torch.float32) for a in (rng.random((T1, B, F)), rng.gamma(1.0, 1.0, (T1, B, F)))]
    p, lam = pl if gain else (None, None)
    kw = dict(alpha_v=0.9, diag=1e-6, rel_diag=1e-5, alpha_xi=0.92, gmin=0.0631)
    Y = torch.full((T1, B, F, 2), float("nan"))
    Zf, sv = torch.view_as_real(Z).contiguous(), torch.view_as_real(steer).contiguous()
    err = cm._launch(Zf, gate, p, lam, sv, Y, stream=None, **kw)
    want = cm.fused_mvdr_scan_plain(Z, gate, steer, p=p, lam=lam, **kw)
    return {"err": err, "out": _gap(Y, torch.view_as_real(want))}


def run_k6(variant: str, Lf: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.kws.dual_mic import DualMicKwsConfig
    from distantspeech_tpu_torch.ops import cuda_flms as cf

    cfg = DualMicKwsConfig(frame_len=Lf, defer_seconds=K6_DEFER[variant])
    T6, S = K6_FRAMES, K6_FRAMES * Lf
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, S + Lf))
    # mic 1 hears mic 0's source through a short filter, plus its own noise
    x = np.stack([src[:, Lf:], 0.8 * src[:, Lf - 3:-3] + 0.3 * src[:, Lf - 7:-7]
                  + 0.1 * rng.standard_normal((B, S))], axis=1)
    x0, d = (a.contiguous() for a in cf._kws_inputs(torch.as_tensor(x, dtype=torch.float32), cfg))
    fifo = torch.zeros((B, cfg.delay_frames_n, Lf))
    out = torch.full((B, S), float("nan"))
    err = cf._kws_launch(x0, d, cfg, fifo, out, None)
    want = cf.kws_frames_plain(x0, d, cfg)
    # the cleaner's share of the output: where it is 0, out is d to the bit
    cleaned = float((want - d).abs().max() / d.abs().max())
    # the gap is taken against max|d|, the scale the transforms round at: the
    # output d - c is the small residual where the cleaner cancels well (with
    # Dn = 1 it is the ANC's own error)
    # before the FIFO has wrapped the cleaner's taps are zeros: out is d to the bit
    head = min(cfg.delay_frames_n, T6) * Lf
    return {"err": err, "out": float((out - want).abs().max() / d.abs().max()), "dn": cfg.delay_frames_n,
            "cleaned": cleaned,
            "exact_passthrough": bool(torch.equal(out[:, :head], d[:, :head]))}


def _gate(x, cfg):
    """The covariance gate [T, B, F] of input x (the guard is off): p < p_vad
    from the port's MCRA on mic 0."""
    from distantspeech_tpu_torch.noise.mcra import mcra_run
    from distantspeech_tpu_torch.transform import analysis

    X0 = analysis(x[:, 0], cfg.stft)  # [B, T, F]
    _, p = mcra_run(cfg.mvdr.mcra, (X0.abs() ** 2).transpose(0, 1).contiguous())
    return p < cfg.mvdr.p_vad


def open_steady(x, cfg, t_chunk: int) -> int:
    """Lane-frames whose covariance gate opens after the rank-1 warmup (the
    gate depends on MCRA alone; the guard is off)."""
    from distantspeech_tpu_torch.ops.cuda_enhance import _warm_chunks

    return int(_gate(x, cfg)[_warm_chunks(t_chunk) * t_chunk:].sum())


def gate_changes(x, cfg) -> int:
    """Lane-frames whose covariance gate differs from the frame before: the
    held u of a closed frame then comes from an earlier open one."""
    gate = _gate(x, cfg)
    return int((gate[1:] != gate[:-1]).sum())


def _enhance_case(mics: int, inv_mode: str, n_fft: int, seed: int, frames: int = K4_FRAMES, t_chunk: int = K4_T_CHUNK,
                  batch: int = B):
    """K2's and K4's inputs: ``batch`` utterances x ``frames`` frames of
    speech-like bursts over noise, the guard off (no decision of the
    kernel's can part from the plain version's), rel_diag on (so that
    rank-1 re-anchors its loading); (cfg, x, steer, steering planes)."""
    import numpy as np
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig
    from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig
    from distantspeech_tpu_torch.ops import cuda_enhance as ce
    from distantspeech_tpu_torch.transform.stft import StftConfig

    cfg = EnhanceConfig(mvdr=MvdrConfig(stft=StftConfig(n_fft, n_fft // 2), vad_guard=False, rel_diag=1e-5))
    hop, T4 = cfg.stft.hop, frames
    rng = np.random.default_rng(seed)
    env = np.repeat(rng.random((batch, T4)) < 0.5, hop, axis=1)  # speech-like bursts that MCRA sees come and go
    x = env[:, None] * rng.standard_normal((batch, 1, T4 * hop)) + 0.3 * rng.standard_normal((batch, mics, T4 * hop))
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    steer = steering_vector(ArrayGeometry.linear(mics, 0.032), np.array([np.pi / 2, 0.0]), n_fft).astype(np.complex64)
    _, planes, _ = ce._prepare(x, steer, cfg, t_chunk, inv_mode)
    return cfg, x, steer, planes


def run_k4(inv_mode: str, n_fft: int, mics: int, seed: int) -> dict:
    import torch

    from distantspeech_tpu_torch.ops import _build
    from distantspeech_tpu_torch.ops import cuda_enhance as ce

    cfg, x, steer, planes = _enhance_case(mics, inv_mode, n_fft, seed)
    y = torch.full((B, K4_FRAMES * cfg.stft.hop), float("nan"))
    n_scratch = _build.load("enhance").fused_enhance_full_scratch_floats(mics, n_fft)
    scratch = torch.full((B * n_scratch,), float("nan")) if n_scratch > 0 else None
    err = ce._full_launch(x, planes, cfg, K4_T_CHUNK, inv_mode, y, scratch, None)
    want = ce.fused_enhance_plain(x, steer, cfg, K4_T_CHUNK, inv_mode)
    return {"err": err, "out": _gap(y, want), "open_steady": open_steady(x, cfg, K4_T_CHUNK),
            "scratch_floats": n_scratch}


def run_k2(inv_mode: str, n_fft: int, mics: int, seed: int) -> dict:
    """K2: up to 8 mics over K2_FRAMES frames in chunks of K2_T_CHUNK, above
    over K4's; one utterance where 9 to 16 mics run 4 threads a lane (each
    of their shuffles a barrier of 32 threads in the shim), two else."""
    import torch

    from distantspeech_tpu_torch.ops import _build
    from distantspeech_tpu_torch.ops import cuda_enhance as ce

    frames, tc = (K2_FRAMES, K2_T_CHUNK) if mics <= 8 else (K4_FRAMES, K4_T_CHUNK)
    nb = 1 if 8 < mics <= 16 else B
    cfg, x, _, planes = _enhance_case(mics, inv_mode, n_fft, seed, frames, tc, nb)
    Z = ce._analysis_planes(x, cfg.stft)
    Sf = ce._smoothed_power(Z, cfg.mvdr.mcra.b).contiguous()
    F = cfg.stft.half_bin
    Y = torch.full((frames, 2, nb, F), float("nan"))
    n_scratch = _build.load("enhance").fused_enhance_scratch_floats(mics, nb, F)
    scratch = torch.full((n_scratch,), float("nan")) if n_scratch > 0 else None
    err = ce._lanes_launch(Z, Sf, planes, cfg, tc, inv_mode, Y, scratch, None)
    want = ce.enhance_lanes_plain(Z, Sf, planes, cfg, tc, inv_mode)
    return {"err": err, "out": _gap(Y, want), "open_steady": open_steady(x, cfg, tc),
            "gate_changes": gate_changes(x, cfg), "scratch_floats": n_scratch}


def run_k10(variant: str, size: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.ops import cuda_srp as cr

    R, F, Theta = K10_ROWS, K10_BINS, int(variant[1:])
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((R, F, mics)) + 1j * rng.standard_normal((R, F, mics))
    y2 = torch.as_tensor(np.concatenate([y.real, y.imag], axis=-1) / np.abs(y).max(), dtype=torch.float32).contiguous()
    grid = np.exp(1j * rng.uniform(0, 2 * np.pi, (Theta, F, mics))).astype(np.complex64)
    G = cr.pack_grid(grid, torch.device("cpu"))
    out = torch.full((R, Theta), float("nan"))
    err = cr._launch(y2, G, out, None)
    return {"err": err, "out": _gap(out, cr.srp_spectrum_plain(y2, G))}


def run_k9(variant: str, Lf: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from chip_smoke import short_mcra_sgsc
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig
    from distantspeech_tpu_torch.ops import cuda_sgsc as cs

    # McSpp's MCRA window cut to L=3, so that q moves within K9_FRAMES
    base = short_mcra_sgsc(SubbandGscConfig) if variant == "short" else SubbandGscConfig
    cfg = base(n_mics=4, frame_len=Lf)
    T9, F = K9_FRAMES, Lf + 1
    rng = np.random.default_rng(seed)
    env = np.repeat(rng.random((B, T9)) < 0.5, Lf, axis=1)  # speech-like bursts, the same on every mic
    x = env[:, None] * rng.standard_normal((B, 1, T9 * Lf)) + 0.3 * rng.standard_normal((B, 4, T9 * Lf))
    x = torch.as_tensor(x, dtype=torch.float32)
    sig, sf = (a.contiguous() for a in cs.front_end(x, ArrayGeometry.linear(4, 0.032), (np.pi / 2, 0.0), cfg))
    S = sig.shape[-1]
    out, p, bm = torch.full((B, S), float("nan")), torch.full((B, T9, F), float("nan")), torch.full((B, 4, S), float("nan"))
    dec = torch.full((B, T9, F), 255, dtype=torch.uint8)
    err = cs._launch(sig, sf, cfg, out, p, bm, dec, None)
    want, p_want, bm_want, dec_want = cs.subband_gsc_frames_plain(sig, sf, cfg, decisions=True)
    return {"err": err, "out": _gap(out, want), "bm": _gap(bm, bm_want), "p": float((p - p_want).abs().max()),
            "p_moves": float(p_want.max() - p_want.min()), "flips": int((dec != dec_want).sum()),
            "repairs": int((dec_want & cs.REPAIR).sum())}


def run_front(variant: str, Lf: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig
    from distantspeech_tpu_torch.ops import cuda_flms as cf

    cfg = TdGscConfig(n_mics=mics, frame_len=Lf, postfilter=variant != "core")
    T = FRONT_FRAMES[Lf]
    S, F, C = T * Lf, Lf + 1, mics - 1
    geom, look = ArrayGeometry.linear(mics, 0.032), (0.4, 0.0)
    rng = np.random.default_rng(seed)
    # a burst from the look direction on every mic (a DC offset under it, so
    # that the notch works), and noise on each
    env = np.repeat(rng.random((B, -(-S // 512))) < 0.5, 512, axis=1)[:, :S]
    src = env * rng.standard_normal((B, S)) + 0.3
    xs = np.stack([np.roll(src, m, axis=1) for m in range(mics)], axis=1) + 0.2 * rng.standard_normal((B, mics, S))
    x = torch.as_tensor(xs, dtype=torch.float32)
    if variant == "strided":  # rows S + 3 floats apart
        wide = torch.full((B, mics, S + 3), float("nan"))
        wide[..., :S] = x
        x = wide[..., :S]
    want = cf.gsc_front(x.contiguous(), geom, look, cfg)
    taps = cf._alignment_taps(x, geom, look).contiguous()
    K = taps.shape[-1]
    bm, d = torch.full((B, C, S), float("nan")), torch.full((B, S), float("nan"))
    yp = torch.full((B, T, F), float("nan"))
    up = torch.full((B, C, T, F), float("nan")) if cfg.postfilter else None
    scratch = _nan(cf._scratch("gsc_front", x.device, mics, B, Lf, K))
    err = cf._gsc_front_launch(x, taps, cfg, bm, d, yp, up, scratch, None)
    got = (bm, d, yp, up)
    res = {"err": err, "K": K, "scratch_floats": _floats(scratch)}
    for name, g, w in zip(("bm", "d", "yp", "up"), got, want):
        if w is not None:
            res[name] = _gap(g, w)
    return res


def run_mcra(variant: str, F: int, mics: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.noise import mcra as nm

    cfg = dataclasses.replace(nm.McraConfig(nfft=2 * (F - 1)), L=3)
    T, lanes, return_sr = 20, 3, variant == "sr"
    rng = np.random.default_rng(seed)
    # noise power with bursts of speech-like power in some frames and bins
    Y = rng.gamma(1.0, 1.0, (T, lanes, F)) * (1.0 + 30.0 * (rng.random((T, lanes, 1)) < 0.4))
    Y = torch.as_tensor(Y, dtype=torch.float32).contiguous()
    Sf = nm._freq_smooth(Y, cfg.b).contiguous()
    outs = [torch.full_like(Y, float("nan")) for _ in range(3)]
    err = nm.cuda_mcra._launch(cfg, Y, Sf, outs[0], outs[1], outs[2] if return_sr else None, None)
    want = nm.mcra_run_plain(cfg, Y, return_sr=True)
    res = {"err": err, "out": _gap(outs[0], want[0]), "p": float((outs[1] - want[1]).abs().max()),
           "p_moves": float(want[1].max() - want[1].min())}
    if return_sr:
        res["sr"] = _gap(outs[2], want[2])
    else:
        res["sr_untouched"] = bool(torch.isnan(outs[2]).all())
    return res


def run_wpe(variant: str, frames: int, channels: int, seed: int) -> dict:
    import numpy as np
    import torch

    from distantspeech_tpu_torch.derev import wpe as dw
    from distantspeech_tpu_torch.ops import _build
    from distantspeech_tpu_torch.ops import cuda_wpe as cw

    taps = int(variant[1:])
    small = channels * taps <= 20
    nb, bands, delay = (3, 16, 2) if small else (1, 4, 3)
    cfg = dw.WpeConfig(num_bands=bands, hop=bands // 4, n_channels=channels, filter_len=taps, delay=delay,
                       forgetting_factor=0.99)
    F = cfg.half_bin
    rng = np.random.default_rng(seed)
    # [NB, C, T, F], as subband_analysis lays it out: innovations plus each
    # channel's own echo `delay` frames back
    y = rng.standard_normal((nb, channels, frames, F)) + 1j * rng.standard_normal((nb, channels, frames, F))
    for t in range(delay, frames):
        y[:, :, t] += 0.7 * y[:, :, t - delay]
    D = torch.movedim(torch.movedim(torch.as_tensor(y.astype(np.complex64)), -3, -1), -3, 0)  # [T, NB, F, C], strided
    e = torch.full((frames, nb, F, channels), complex(float("nan"), float("nan")), dtype=torch.complex64)
    shape = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()]
    ok = _build.load("wpe").wpe_shape(channels, taps, delay, *(ctypes.byref(v) for v in shape))
    err = cw._launch(cfg, D, e, None)
    want = dw._recursion(cfg, D)
    group, states, tpt = (v.value for v in shape[:3])
    return {"err": err or ok, "out": _gap(torch.view_as_real(e), torch.view_as_real(want)),
            "moved": _gap(torch.view_as_real(want), torch.view_as_real(D)), "group": group,
            "states_per_block": states, "tiles_per_thread": tpt, "ragged": (nb * F) % states != 0}


def main(lib_dir: str, kernels=()) -> None:
    sys.path.insert(0, str(ROOT))
    from distantspeech_tpu_torch.ops import _build

    picks = tuple(kernels or LIBRARIES)  # kernel names, or prefixes of case names
    res = {}
    for i, (kernel, variant, size, mics) in enumerate(CASES):
        name = case_name(kernel, variant, size, mics)
        if kernel not in picks and not any(name == pick or name.startswith(f"{pick}-") for pick in picks):
            continue
        lib = LIBRARIES[kernel]
        with _build.swapped(lib, Path(lib_dir) / f"lib{lib}.so"):
            res[name] = globals()[f"run_{kernel}"](variant, size, mics, seed=i)
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
