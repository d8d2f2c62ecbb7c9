#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it.

    python3 chip_smoke.py [--parent DIR]

Phases; any failure exits nonzero, and nothing is printed as a result:

1. the card: its name and power limit from nvidia-smi;
2. build every kernel from ``distantspeech_tpu_torch/csrc`` with nvcc for
   sm_90a into ``build/kernels/``; print the build time and ptxas's
   register and spill report, per entry function;
3. kernel vs plain on the card, float32, B=8 x 8 mics x 1 s, the same
   t_chunk on both sides (T=125 -> t_chunk 25: 3 warm chunks, then the
   Bennett path and one re-anchor): both kernels in 'ldl' and 'rank1' mode
   with the guard off (< 1e-3 of max|y|) and the benched config (< 2e-2,
   the vad_guard decision-flip tolerance: the guard thresholds a raw ratio,
   so an ulp of difference can flip a lane's hold/update decision);
   ``fused_enhance_full`` at n_fft=512 (two bins a lane thread) with 2 and
   4 mics, B=4 x 2 s, guard off (< 1e-3); both kernels at 3 and 6 mics, and
   ``fused_enhance_full`` at n_fft 512 with 8 mics and 1024 with 2, 4 and 8
   (lane states in shared memory or a global scratch), guard off, 125
   frames (< 1e-3), with K4's time at each of these shapes at the main
   size; and the benched kernel against the port's own per-frame scan path
   (float64, B=2) with the same two gates as bench.py;
4. the main path at full size, through the user entry point:
   ``enhance_process(x, ArrayGeometry.linear(8, 0.032), (90, 0),
   EnhanceConfig(), backend="mega", inv_mode="rank1")`` on B=64 x 8 mics x
   4 s of a synthesised broadside scene, with launch counts reset just
   before and read just after: finite, right shape, the kernel launched,
   output SNR above input SNR; then the same for ``backend="fused"``;
5. kernel vs plain at the main path's shapes (T=500 -> t_chunk 50: 2 warm
   chunks, 8 steady ones, re-anchors at other frames than at the gate
   size, and a 129-block lane grid, a thread pair a lane): the main path's own
   outputs against the plain version with the benched config (< 2e-2), and
   both kernels again with the guard off (< 1e-3);
6. CUDA-event timing at full size of both kernels (rank1 and ldl), of the
   'fused' wrapper and its stages, and of each kernel's plain version
   (median of 3 calls after a warm-up); the lane kernel's (K2's) chain
   floor and the operations one thread issues a frame in each layout
   tried;
7. kernel K1 (``fused_mvdr_scan``, ``csrc/mvdr.cu``): both variants against
   the plain version at B=8 x 8 mics x 1 s with the same gate, p and
   lambda_d fed to both, guard off and benched, and at 3 and 6 mics (< 1e-4
   of max|Y|); the ``pallas`` path at full size through ``enhance_process(x,
   ArrayGeometry.linear(8, 0.032), (90, 0), EnhanceConfig(),
   backend="pallas")`` on B=64 x 8 x 4 s (one launch each of the MCRA lane
   kernel and K1, finite, output SNR above mic 0's), and the gain-free
   variant through ``fused_mvdr_scan`` itself; both held to the plain
   version again at that size; timings; the MCRA lane kernel
   (``noise.mcra.mcra_run``, ``csrc/mcra.cu``) against ``mcra_run_plain`` at
   the gate size and on the pallas path's input (lambda_d, S / Smin and p
   < 1e-3, or < 2e-2 where a thresholded S / Smin > delta_s decision
   flipped, the flips printed), its time and bound;
8. kernel K5 (``fused_tdgsc``, ``csrc/flms.cu``): core, ``vad_guard`` and
   ``postfilter`` against the plain version at B=8 x 4 mics x 1 s (< 1e-3
   of max|out|, < 2e-2 with the guard), core and postfilter at 3 and 6 mics
   (< 1e-3); the time-domain GSC at full size
   through ``tdgsc_process(x, ArrayGeometry.linear(4, 0.032), (pi/2, 0),
   TdGscConfig(n_mics=4[, postfilter=True]), backend="fused")`` on B=128 x
   4 x 4 s (one K5 launch each, finite, output SNR above mic 0's), held to
   the plain version again at that size; timings, with the kernel's time a
   frame;
9. kernels K7 (``fused_aec``, ``csrc/aec.cu``), K6 (``fused_kws``,
   ``csrc/kws.cu``) and K8 (``fused_fdgsc``, ``csrc/fdgsc.cu``) against
   their plain versions at B=8 x 4 mics (K7 and K8 on 1 s, K6 on 2 s so its
   94-slot tap FIFO wraps; < 1e-3 of max|out|, with the count of flipped
   decisions printed), K8 at 3 and 6 mics likewise, and
   ``full_stack_process(backend="fused")`` against
   its ``scan`` path in float64 at B=2 x 1 s (< 2e-2);
10. the full streaming stack (B3) at full size through
   ``full_stack_process(x, far, ArrayGeometry.linear(4, 0.032), (pi/2, 0),
   FullStackConfig(n_mics=4), backend="fused")`` on B=128 x 4 x 4 s of an
   echo scene (one launch each of K7, K6 and K5; finite; the AEC's echo
   return loss enhancement on mic 0 above 10 dB; output SNR above mic 0's),
   each kernel and the whole chain held to the plain versions at that size;
   timings of each stage and of the path;
11. the FDGSC (B4) at full size through ``fdgsc_process(x,
   ArrayGeometry.linear(4, 0.032), (pi/2, 0), FdGscConfig(n_mics=4),
   backend="fused")`` on B=128 x 4 x 4 s (one K8 launch, finite, output SNR
   above mic 0's), held to the plain version at that size, K8's and the
   float32 plain version's gaps to the float64 plain version printed;
   timings, with the kernel's time a frame;
12. kernel K9 (``fused_subband_gsc``, ``csrc/sgsc.cu``) against its plain
   version at B=8 x 4 mics x 1 s with the default config, the AIC guards
   and a short MCRA window (L=3): out and bm < 1e-3 of max, p < 2e-3
   absolute in every utterance with no flipped decision (the xi < 0 repair,
   MCRA's S/Smin > delta_s), out and bm < 2e-2 in the others, the flips
   printed; the ``fused`` path against its float64 ``scan`` at B=2 x 1 s
   (< 2e-2); the subband GSC (B5) at full size through
   ``subband_gsc_process(x, ArrayGeometry.linear(4, 0.032), (pi/2, 0),
   SubbandGscConfig(n_mics=4), backend="fused")`` on B=128 x 4 x 4 s (one
   K9 launch, finite, output SNR above mic 0's), held to the plain version
   again at that size as at the gate size, with the kernel's and the float32
   plain version's gaps to the float64 plain version printed; timings;
13. kernel K10 (``fused_srp_spectrum``, ``csrc/srp.cu``) against its plain
   version and the einsum path at B=2 x 8 mics x 1 s and at full size
   (< 1e-4 of max; the same angle picked over 0..180 degrees wherever the
   top two differ by more than 1e-4 of max), and against its plain version
   at 3 and 6 mics; SRP-PHAT (B6) through ``srp_process(x,
   ArrayGeometry.linear(8, 0.032), SrpConfig(), backend="fused")`` on B=8 x
   8 x 4 s of a source reaching mic m m samples late (one launch each of K10
   and the MCRA lane kernel, which is held to its plain version on that
   input; the summed spectrum's pick within 3 degrees of
   arccos(c / (0.032 fs)) or its mirror); timings; its bound with the
   products on the tensor cores in 3xTF32, beside the FP32 bound;
14. the shapes beyond 8 mics and beyond the powers of two: K1 at 12, 16
   and 32 mics, K2 and K4 at 16, K5 (core and postfilter), K8 and K10 at 12
   and 16, each against its plain version at its gate size and tolerance,
   and timed at its main path's size; then a record for each new
   instantiation (12 mics through ``pallas``, ``fused``, ``mega``, the
   TDGSC, the FDGSC and SRP-PHAT; ``mega`` at n_fft 768, 1280 and 2048 with
   8 mics), each through its own path at its main path's size (B=64 x 4 s
   for K1, K2 and K4, B=128 for K5 and K8, B=8 for K10) with the launch
   counts reset just before and read just after, held to its plain version
   on that path's input (K2 and K4 also with the guard off, < 1e-3), timed,
   with its bound from that input;
15. the JAX package's parity protocol (``benchmarks/pipelines.py``'s gates:
   B=2 utterances of standard normal noise, the first draw of seed 1, 16384
   samples a mic; the fused path against the float32 ``scan`` on the card)
   for all nine rows (``enhance_pallas``, ``enhance_fused``,
   ``enhance_mega``, ``tdgsc_fused``, ``fdgsc_fused``,
   ``subband_gsc_fused``, ``full_stack_fused``, ``kws_fused``,
   ``srp_fused``), each printed beside its JAX ``gate_rel`` and held to it,
   or, where the port cannot meet it, to the JAX harness's own tolerance
   (``GATE_ROWS``); with each row's plain version's gaps, the full stack's
   stages and K6 built without fused multiply-adds; ``kws_fused``'s input
   is shorter than K6's tap FIFO, which the row says, and a companion line
   runs it with the defer cut so that the FIFO wraps (< 1e-3);
16. BASELINE configs 1, 2 and 4: B7 (WPE -> SRP-PHAT) at full size through
   ``doa.wpe_srp_process(x, ArrayGeometry.linear(8, 0.032),
   WpeConfig(n_channels=8), SrpConfig(), backend="fused")`` on B=8 x 8 mics
   x 4 s of phase 13's scene made reverberant (``reverb_scene``: RT60 0.4
   s, DRR 0 dB), with launch counts reset just before and read just after
   (one launch each of K10 and the MCRA lane kernel; finite; the summed
   spectrum's pick within 3 degrees of the true angle or its mirror), K10
   held to its plain version on B7's own input (< 1e-4), the path and its
   stages (subband analysis, WPE, synthesis, SRP) timed, with WPE's torch
   calls a frame; the card's float32 WPE against the same code in float64
   on the CPU at B=2 x 1 s (< 2e-2 of max|e|); then, once each through its
   entry point at the JAX benchmark's size (``SLICE_E_B``), finite and
   timed in audio-s/s: ``fixed_process`` SD and DS (B=8 x 4 mics; DS's
   output SNR above mic 0's on the white-noise scene), the offline
   ``adaptive_mvdr2_process`` (one 8-mic utterance whose first 200 frames
   are noise only; output SNR above mic 0's after them), ``gsc_process``
   with the benchmark's guards (B=32 x 4) and ``pmwf_process`` (B=128 x 4),
   each output SNR above mic 0's, ``wpe_process`` (B=8 x 2) and
   ``idoa_run`` (B=8 x 4, n_fft 512, p within [0, 1]);
17. with ``--parent DIR`` (a checkout of the parent commit), K2 and K10
   alone and the flagship ``fused`` path and B6, timed in the parent and in
   this tree in turns (``scripts/path_times.py``);
18. the ``kernels`` JSON line, the card line, and the final JSON line.

K1, K2 and K6 also print a chain floor beside their bound: T frames times
the longest dependent chain of one frame on the kernel's layout, counted
from its code, at 4 cycles an operation and the card's maximum SM clock.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

FS = 16000
H100_FP32_FLOPS = 67e12  # NVIDIA H100 SXM data sheet, float32 outside the tensor cores
H100_TF32_FLOPS = 495e12  # the same, TF32 on the tensor cores (dense)
H100_HBM_BYTES = 3.35e12  # bytes/s
TIGHT, FLIP = 1e-3, 2e-2  # kernel gates (bench.py's two gates)
K1_GATE = 1e-4  # K1 and its plain version see the same gate: no decision can flip
SRP_GATE = 1e-4  # K10: a sum of magnitudes, no decision inside


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def scene(B, M, S, seed, snr_db=0.0):
    """Broadside scene: a speech-like burst (white noise under a 1.3 Hz
    on/off envelope, so MCRA sees speech come and go) identical on every
    mic, plus independent white noise per mic at ``snr_db`` (over the whole
    utterance).  Returns (x [B, M, S] float32, envelope [B, S])."""
    rng = np.random.default_rng(seed)
    t = np.arange(S) / FS
    env = (np.sin(2 * np.pi * 1.3 * t + rng.uniform(0, 2 * np.pi, (B, 1))) > 0).astype(np.float64)
    tgt = env * rng.standard_normal((B, S))
    noise = rng.standard_normal((B, M, S)) * np.sqrt(np.mean(tgt**2) / 10 ** (snr_db / 10))
    return (tgt[:, None, :] + noise).astype(np.float32), env


def segments(env, delay, start=FS, margin=512):
    """(on, off) masks [B, S]: where the target envelope, delayed by
    ``delay`` samples, is on / off for ``margin`` samples either side, after
    ``start``."""
    on = np.zeros_like(env)
    on[:, delay:] = env[:, : env.shape[1] - delay]

    def eroded(mask):
        c = np.concatenate([np.zeros((mask.shape[0], 1)), np.cumsum(mask, axis=1)], axis=1)
        w = 2 * margin + 1
        full = np.zeros(mask.shape, dtype=bool)
        full[:, margin : mask.shape[1] - margin] = (c[:, w:] - c[:, :-w]) == w
        full[:, :start] = False
        return full

    return eroded(on), eroded(1.0 - on)


def segment_snr_db(y, env, delay, start=FS, margin=512):
    """SNR from target-on and target-off segments: 10 log10((P_on - P_off) /
    P_off), mean over utterances, where P_on / P_off is the mean power of y
    in the ``segments`` after ``start`` (MCRA's 2L = 1.04 s of forced
    adaptation).  A time-varying postfilter gain is part of the output here,
    not an error, as it would be in a projection SNR."""
    on_m, off_m = segments(env, delay, start, margin)
    snr = []
    for b in range(y.shape[0]):
        p_on, p_off = np.mean(y[b, on_m[b]] ** 2), np.mean(y[b, off_m[b]] ** 2)
        snr.append(10 * np.log10(max(p_on - p_off, 1e-30) / p_off))
    return float(np.mean(snr))


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max()), float((a - b).abs().max())


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")
    print(f"ok: {msg}", flush=True)


OP_NAMES = {
    "add", "sub", "mul", "div", "where", "minimum", "maximum", "clamp", "exp", "log", "lt", "le", "gt", "sqrt",
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__", "__truediv__", "__rtruediv__",
    "__neg__", "__gt__", "__lt__", "__le__", "__and__", "__or__", "__pow__", "__rpow__",
}
REDUCTIONS = {"sum", "amax"}


def counted(fn, *args, per_element=False, **kw):
    """Run ``fn`` and count the elementwise torch operations it executes:
    one per call, or (``per_element``) one per output element, with a
    reduction counted once per input element."""
    import torch
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "")
            if name in OP_NAMES:
                self.n += out.numel() if per_element and isinstance(out, torch.Tensor) else 1
            elif per_element and name in REDUCTIONS:
                self.n += args[0].numel()
            return out

    mode = Count()
    with mode:
        fn(*args, **kw)
    return mode.n


def lane_ops(M):
    """Arithmetic operations per lane-frame of the recursion, counted by
    running the plain version (the kernels unroll the same code) on one
    lane and tallying every elementwise op it executes.  Returns
    {'open_ldl', 'open_rank1', 'closed'}: a frame whose covariance gate is
    open in the warmup (LDL) or steady (Bennett) phase, and one whose gate
    is closed (the kernels then skip the update and the solve)."""
    import torch

    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig
    from distantspeech_tpu_torch.ops import cuda_enhance, cuda_mvdr

    cfg = EnhanceConfig()
    rng = np.random.default_rng(0)
    # F = 3 lanes (first, interior, last bin): every op is elementwise over
    # the lanes, so one counted call is one op per lane.  The last frame is
    # past MCRA's 2L forcing and inside a steady rank-1 chunk.
    T, tc = 2 * cfg.mvdr.mcra_L + 8, 64
    Z = torch.as_tensor(rng.standard_normal((T, M, 2, 1, 3)))
    Sf = torch.as_tensor(rng.random((T, 1, 3)))
    planes = torch.as_tensor(rng.standard_normal((M, 2, 3)))
    frame = {}
    for inv_mode in ("ldl", "rank1"):
        run = lambda n: cuda_enhance.enhance_lanes_plain(Z[:n], Sf[:n], planes, cfg, tc, inv_mode)
        frame[inv_mode] = counted(run, T) - counted(run, T - 1)
    # the plain version computes the update for every lane and selects by the
    # gate; the kernels branch, so split the update out of the frame count
    z = [torch.ones(1, 3, dtype=torch.float64) for _ in range(M)]
    R = lambda: [[z[0].clone() for _ in range(M)] for _ in range(M)]
    update = {}
    for gate in (None, z[0] > 0):
        update["ldl", gate is None] = counted(
            cuda_mvdr._mvdr_update_ldl, z, z, gate, z, z, R(), R(), list(z), list(z), M, 0.9998, 1e-6, 1e-5)
        update["rank1", gate is None] = counted(
            cuda_mvdr._mvdr_update_rank1, z, z, gate, z, z, R(), R(), list(z), list(z), M, 0.9998, Ld=z[0])
    closed = frame["ldl"] - update["ldl", False]
    return {"open_ldl": closed + update["ldl", True],
            "open_rank1": frame["rank1"] - update["rank1", False] + update["rank1", True],
            "closed": closed}


def open_lane_frames(x, cfg, t_chunk):
    """Count the lane-frames whose covariance gate opens, split into the
    warmup (LDL) and steady (Bennett) phases of inv_mode='rank1', from the
    port's MCRA on this input (the gate depends on MCRA alone)."""
    import torch

    from distantspeech_tpu_torch.noise.mcra import mcra_run
    from distantspeech_tpu_torch.ops.cuda_enhance import _warm_chunks
    from distantspeech_tpu_torch.transform import analysis

    X0 = analysis(x[:, 0], cfg.stft)  # [B, T, F]
    _, p, sr = mcra_run(cfg.mvdr.mcra, (X0.abs() ** 2).transpose(0, 1).contiguous(), return_sr=True)
    gate = p < cfg.mvdr.p_vad
    if cfg.mvdr.vad_guard:
        gate = gate & (sr <= cfg.mvdr.mcra.delta_s)
    warm = _warm_chunks(t_chunk) * t_chunk
    return int(gate[:warm].sum()), int(gate[warm:].sum()), int(gate.numel())


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of the parent commit, whose K2 and K10 (and the flagship fused path "
                                     "and B6) are timed beside this tree's at the end, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distantspeech_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 analysis/synthesis products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}", flush=True)
    for name, lib in libs.items():
        entry = ""
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {entry}: {line.strip()}")

    dev = torch.device("cuda")
    kernels = smoke(dev, card, B=64, seconds=4)
    kernels += smoke_k1(dev, card, B=64, seconds=4)
    kernels += smoke_k5(dev, card, B=128, seconds=4)
    kernels += smoke_slice_c(dev, card, B=128, seconds=4)
    kernels += smoke_k9(dev, card, B=128, seconds=4)
    kernels += smoke_k10(dev, card, B=8, seconds=4)
    kernels += smoke_wide(dev, card, seconds=4)
    smoke_gate_rel(dev, card)
    smoke_slice_e(dev, card, seconds=4)
    if args.parent:
        parent_times(args.parent)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def parent_times(parent: str) -> None:
    """K2 and K10 alone and the paths that run them (the flagship ``fused``,
    B6) at their main sizes, in the parent checkout and in this tree, by
    ``scripts/path_times.py`` in its own process each, in turns (parent,
    tree, tree, parent); printed."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "scripts", "path_times.py")
    ms = {}
    for root in (parent, here, here, parent):
        out = subprocess.run([sys.executable, script, "--root", root, "--paths", "K2", "K10", "flagship fused", "B6"],
                             capture_output=True, text=True, check=True, timeout=900)
        for name, v in json.loads(out.stdout.strip().splitlines()[-1])["ms"].items():
            ms.setdefault((name, root == parent), []).append(v)
    for name in ("K2", "K10", "flagship fused", "B6"):
        print(f"{name} at its main size: this tree {', '.join(f'{v:.3f}' for v in ms[name, False])} ms, the parent "
              f"{', '.join(f'{v:.3f}' for v in ms[name, True])} ms [{card_line()}]", flush=True)


def bound(nbytes, nops):
    """The least time the card could take: (ms, 'bytes' or 'operations')."""
    tb, to = nbytes / H100_HBM_BYTES, float(nops) / H100_FP32_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb > to else "operations")


FP32_DEP_CYCLES = 4  # cycles from a float32 operation to one that depends on it, on an H100 SM


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi), for the chain floors."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def chain_ms(T: int, dep_ops: int) -> float:
    """The chain floor of a frame recursion: T frames, each dep_ops
    dependent float32 operations long, at FP32_DEP_CYCLES a step and the
    card's maximum SM clock."""
    return T * dep_ops * FP32_DEP_CYCLES / (sm_clock_mhz() * 1e6) * 1e3


def k6_chain_ops(logN: int) -> int:
    """Dependent float32 operations on one frame's longest chain in
    csrc/kws.cu, counted from its code: the chain's 4 transforms (the tap
    spectrum, the inverse of the ANC output, the error transform, the gradient
    inverse), log2 N radix-2 stages each, a twiddle product and a
    butterfly sum (3) a stage; and between them the product X Wz into the
    inverse's spectrum (3), e = d - y / N (2), the gradient conj(X) E / P into
    its spectrum (4) and the tap update (3).  Barriers and shared-memory
    latency are not counted, so the floor lies below any run."""
    return 4 * 3 * logN + 3 + 2 + 4 + 3


def timed_ms(fn, *args, n: int = 3) -> float:
    """Median device ms of n calls (CUDA events) after a warm-up call, for
    the kernels too slow for ``benchmark``'s iteration pairs."""
    fn(*args)
    return float(np.median([timed_once(fn, *args)[1] for _ in range(n)]))


def timed_once(fn, *args):
    """One call on the card: (result, device ms from CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def smoke(dev, card: str, B: int, seconds: int) -> list:
    """Phases 3-6 on ``dev`` with the main path at B utterances x 8 mics x
    ``seconds``; returns the two flagship kernels' records."""
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process
    from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig
    from distantspeech_tpu_torch.ops import cuda_enhance as ce
    from distantspeech_tpu_torch.runtime.profiling import benchmark, cuda_seconds
    from distantspeech_tpu_torch.transform.stft import StftConfig

    tag = f"[{card}]"
    # ---- 3. kernel vs plain ----------------------------------------------------
    M = 8
    geom = ArrayGeometry.linear(M, 0.032)
    look = (90.0, 0.0)
    bench_cfg = EnhanceConfig()
    nog_cfg = EnhanceConfig(mvdr=MvdrConfig(**{**bench_cfg.mvdr.__dict__, "vad_guard": False}))
    steer = steering_vector(geom, np.asarray(look) / 180.0 * np.pi, bench_cfg.stft.n_fft).astype(np.complex64)
    xg = torch.as_tensor(scene(8, M, FS, seed=1)[0], device=dev)
    T_g = FS // bench_cfg.stft.hop
    tc_g = ce._pick_t_chunk(T_g) or 64
    print(f"gate input: B=8 M={M} T={T_g} t_chunk={tc_g} warm_chunks={ce._warm_chunks(tc_g)}", flush=True)
    outs = {}
    plain_gate_s = None
    for cname, cfg in (("guard off", nog_cfg), ("benched", bench_cfg)):
        for mode in ("ldl", "rank1"):
            if cname == "benched" and mode == "ldl":
                continue
            t1 = time.perf_counter()
            want = ce.fused_enhance_plain(xg, steer, cfg, tc_g, mode)
            torch.cuda.synchronize()
            if plain_gate_s is None:
                plain_gate_s = time.perf_counter() - t1
            tol = FLIP if cname == "benched" else TIGHT
            for kname, fn in (("fused_enhance", ce.fused_enhance), ("fused_enhance_full", ce.fused_enhance_full)):
                got = fn(xg, steer, cfg, tc_g, mode)
                torch.cuda.synchronize()
                check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{kname} {mode} {cname}: finite {tuple(got.shape)}")
                rel, mx = rel_err(got, want)
                outs[(kname, mode, cname)] = got
                check(rel < tol, f"{kname} {mode} {cname} vs plain: rel {rel:.3e} (max abs {mx:.3e}) < {tol:g}")
    print(f"plain version at the gate size (B=8, 1 s, ldl): {plain_gate_s * 1e3:.1f} ms wall {tag}", flush=True)
    for kname in ("fused_enhance", "fused_enhance_full"):
        rel, _ = rel_err(outs[(kname, "rank1", "guard off")], outs[(kname, "ldl", "guard off")])
        check(rel > 0, f"{kname} rank1 differs from ldl (rel {rel:.3e}): the Bennett path ran")

    # n_fft 512 (two bins a lane thread, 2 and 4 mics), guard off, B=4 x 2 s:
    # T=125 -> t_chunk 25, 3 warm chunks, the Bennett path and one re-anchor
    for M5 in (2, 4):
        c512 = EnhanceConfig(mvdr=MvdrConfig(**{**nog_cfg.mvdr.__dict__, "stft": StftConfig(512, 256)}))
        x5 = torch.as_tensor(scene(4, M5, 2 * FS, seed=3)[0], device=dev)
        st5 = steering_vector(ArrayGeometry.linear(M5, 0.032), np.asarray(look) / 180.0 * np.pi, 512).astype(np.complex64)
        want = ce.fused_enhance_plain(x5, st5, c512, 25, "rank1")
        got = ce.fused_enhance_full(x5, st5, c512, 25, "rank1")
        rel, mx = rel_err(got, want)
        check(bool(torch.isfinite(got).all()) and rel < TIGHT,
              f"fused_enhance_full rank1 guard off, n_fft=512, M={M5} vs plain: rel {rel:.3e} (max abs {mx:.3e}) < {TIGHT:g}")

    # the mic counts between, 3 and 6, through both kernels at n_fft 256, and
    # K4's larger transforms: n_fft 512 with 8 mics (the lane states in
    # shared memory) and 1024 with 2, 4 and 8 (shared memory; a global
    # scratch at 8); guard off, B=4, T=125 frames (t_chunk 25: 3 warm
    # chunks, the Bennett path, a re-anchor); K4's time at each of these
    # shapes at the main size (B=64 x 4 s), beside the 256-point time
    shape_ms = {}
    for nfft, Ms, both in ((256, 3, True), (256, 6, True), (512, 8, False), (1024, 2, False), (1024, 4, False),
                           (1024, 8, False)):
        cs_ = EnhanceConfig(mvdr=MvdrConfig(**{**nog_cfg.mvdr.__dict__, "stft": StftConfig(nfft, nfft // 2)}))
        xs_ = torch.as_tensor(scene(4, Ms, 125 * nfft // 2, seed=3)[0], device=dev)
        st_ = steering_vector(ArrayGeometry.linear(Ms, 0.032), np.asarray(look) / 180.0 * np.pi, nfft).astype(np.complex64)
        want = ce.fused_enhance_plain(xs_, st_, cs_, 25, "rank1")
        for kname, fn in (("fused_enhance", ce.fused_enhance), ("fused_enhance_full", ce.fused_enhance_full)):
            if kname == "fused_enhance" and not both:
                continue
            got = fn(xs_, st_, cs_, 25, "rank1")
            torch.cuda.synchronize()
            rel, mx = rel_err(got, want)
            check(bool(torch.isfinite(got).all()) and rel < TIGHT,
                  f"{kname} rank1 guard off, n_fft={nfft}, M={Ms} vs plain: rel {rel:.3e} (max abs {mx:.3e}) < {TIGHT:g}")
        if (nfft, Ms) != (256, 3):
            xm = torch.as_tensor(scene(B, Ms, seconds * FS, seed=2)[0], device=dev)
            tm = ce._pick_t_chunk(seconds * FS // (nfft // 2)) or 64
            shape_ms[(nfft, Ms)] = benchmark(ce.fused_enhance_full, xm, st_, cs_, tm, "rank1")["per_call_s"] * 1e3
            del xm
    print("fused_enhance_full rank1 guard off at B=" + f"{B} x {seconds} s, ms/call: "
          + ", ".join(f"n_fft {n} M={m} {v:.3f}" for (n, m), v in shape_ms.items()) + f" {tag}", flush=True)

    x2 = xg[:2].contiguous()
    for cname, cfg, tol in (("guard off", nog_cfg, TIGHT), ("benched", bench_cfg, FLIP)):
        ref = enhance_process(x2.double(), geom, look, cfg, backend="scan", device=dev).float()
        got = ce.fused_enhance_full(x2, steer, cfg, tc_g, "rank1")
        rel, _ = rel_err(got, ref)
        check(rel < tol, f"fused_enhance_full rank1 {cname} vs the scan path (B=2): rel {rel:.3e} < {tol:g}")

    # ---- 4. the main path at full size -------------------------------------------
    S = seconds * FS
    xs, env = scene(B, M, S, seed=2)
    x = torch.as_tensor(xs, device=dev)
    snr_in = segment_snr_db(xs[:, 0], env, 0)
    launches = {}
    outputs = {}
    for backend, kname in (("mega", "fused_enhance_full"), ("fused", "fused_enhance")):
        for k in ce.LAUNCHES:
            ce.LAUNCHES[k] = 0
        y = enhance_process(x, geom, look, EnhanceConfig(), backend=backend, inv_mode="rank1")
        torch.cuda.synchronize()
        launches[kname] = ce.LAUNCHES[kname]
        check(ce.LAUNCHES[kname] > 0, f"backend={backend} launched {kname} {ce.LAUNCHES[kname]} time(s): {dict(ce.LAUNCHES)}")
        check(tuple(y.shape) == (B, S) and bool(torch.isfinite(y).all()), f"backend={backend}: finite output {tuple(y.shape)}")
        snr_out = segment_snr_db(y.cpu().numpy(), env, bench_cfg.stft.hop)  # the STFT delays by one hop
        check(snr_out > snr_in, f"backend={backend}: output SNR {snr_out:.2f} dB > input SNR {snr_in:.2f} dB (mic 0)")
        outputs[backend] = y
    rel, _ = rel_err(outputs["fused"], outputs["mega"])
    print(f"fused vs mega at full size, benched config: rel {rel:.3e}", flush=True)

    # ---- 5. kernel vs plain at the main path's shapes ------------------------------
    # T=500 -> t_chunk 50: 2 warm chunks, then 8 steady chunks with re-anchors,
    # and a 65-block lane grid; the benched config checks the main path's own
    # output, and a guard-off run holds both kernels to the tight gate
    cfg = bench_cfg
    steer = torch.as_tensor(steer, device=dev)  # on the card: no host copy inside the timed calls
    T = S // cfg.stft.hop
    tc = ce._pick_t_chunk(T) or 64
    print(f"main-path input: B={B} M={M} T={T} t_chunk={tc} warm_chunks={ce._warm_chunks(tc)}", flush=True)
    xt, planes, _ = ce._prepare(x, steer, cfg, tc, "rank1")
    Z = ce._analysis_planes(xt, cfg.stft)
    Sf = ce._smoothed_power(Z, cfg.mvdr.mcra.b).contiguous()
    main_err = {}
    for cname, c, tol in (("benched", bench_cfg, FLIP), ("guard off", nog_cfg, TIGHT)):
        want_full = ce.fused_enhance_plain(x, steer, c, tc, "rank1")
        want_lanes = ce.enhance_lanes_plain(Z, Sf, planes, c, tc, "rank1")
        if cname == "benched":
            pairs = (("fused_enhance_full", outputs["mega"], want_full), ("fused wrapper", outputs["fused"], want_full))
        else:
            pairs = (("fused_enhance_full", ce.fused_enhance_full(x, steer, c, tc, "rank1"), want_full),)
        pairs += (("fused_enhance", ce.enhance_lanes(Z, Sf, planes, c, tc, "rank1"), want_lanes),)
        torch.cuda.synchronize()
        for kname, got, want in pairs:
            check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{kname} rank1 {cname}, full size: finite {tuple(got.shape)}")
            rel, mx = rel_err(got, want)
            main_err[(kname, cname)] = mx
            check(rel < tol, f"{kname} rank1 {cname} vs plain at full size: rel {rel:.3e} (max abs {mx:.3e}) < {tol:g}")

    # ---- 6. timing -------------------------------------------------------------
    audio_s = B * S / FS
    times = {}
    for mode in ("rank1", "ldl"):
        per = benchmark(ce.fused_enhance_full, x, steer, cfg, tc, mode)["per_call_s"]
        times[("fused_enhance_full", mode)] = per
        print(f"fused_enhance_full {mode}: {per * 1e3:.3f} ms/call, {per * 1e6 / T:.2f} us a frame, "
              f"{audio_s / per:.0f} audio-s/s (B={B}, M={M}, {S // FS} s) {tag}", flush=True)
    per = benchmark(ce.fused_enhance, x, steer, cfg, tc, "rank1")["per_call_s"]
    print(f"fused_enhance wrapper rank1 (matmuls + kernel): {per * 1e3:.3f} ms/call, {audio_s / per:.0f} audio-s/s {tag}", flush=True)
    for mode in ("rank1", "ldl"):
        per = benchmark(ce.enhance_lanes, Z, Sf, planes, cfg, tc, mode)["per_call_s"]
        times[("fused_enhance", mode)] = per
        print(f"fused_enhance kernel {mode}: {per * 1e3:.3f} ms/call, {audio_s / per:.0f} audio-s/s {tag}", flush=True)
    Y = ce.enhance_lanes(Z, Sf, planes, cfg, tc, "rank1")
    stages = (
        ("analysis products + smoothing", lambda: ce._smoothed_power(ce._analysis_planes(xt, cfg.stft), cfg.mvdr.mcra.b).contiguous()),
        ("synthesis product + overlap-add", lambda: ce._synthesis_planes(Y, cfg.stft)),
    )
    for name, fn in stages:
        per = benchmark(fn)["per_call_s"]
        print(f"fused_enhance wrapper stage, {name}: {per * 1e3:.3f} ms/call {tag}", flush=True)
    # the plain versions ran once above at this size (their warm-up); median of 3 more
    plain = {
        "fused_enhance_full": ("fused_enhance_plain", ce.fused_enhance_plain, (x, steer, cfg, tc, "rank1")),
        "fused_enhance": ("enhance_lanes_plain", ce.enhance_lanes_plain, (Z, Sf, planes, cfg, tc, "rank1")),
    }
    plain_s = {}
    for kname, (pname, fn, args) in plain.items():
        runs = [cuda_seconds(fn, *args) for _ in range(3)]
        plain_s[kname] = float(np.median(runs))
        print(f"plain {pname} rank1 (full size, median of {[round(r * 1e3, 1) for r in runs]} ms): "
              f"{plain_s[kname] * 1e3:.1f} ms {tag}", flush=True)

    # ---- bounds: bytes moved once, and the operations this input needs -------------
    b_full, by_full, b_lanes, by_lanes = enhance_bounds(x, cfg, tc, Z, Sf, planes)

    # ---- the lane kernel's chain floor, and the operations one thread issues
    # an open steady frame in each layout tried (PERF.md gives their times)
    issued = k2_issued_ops(M)
    print("fused_enhance operations one thread issues an open steady rank-1 frame: "
          + ", ".join(f"{name} {issued[g]:.0f}" for g, name in (
              (-2, "a thread pair, rows split (runs)"), (-4, "4 threads, rows split"),
              (4, "4 frame-parallel"), (1, "1 thread a lane (the first design)"))), flush=True)
    print(f"chain floor fused_enhance: {chain_ms(T, k2_chain_ops(M)):.4f} ms (T={T} frames x {k2_chain_ops(M):g} "
          f"dependent operations of an open-gate steady frame at {FP32_DEP_CYCLES} cycles each, "
          f"{sm_clock_mhz():.0f} MHz); bound {b_lanes:.4f} ms by {by_lanes} {tag}", flush=True)

    return [
        {"name": "fused_enhance_full", "route": "cuda", "source": "distantspeech_tpu_torch/csrc/enhance.cu",
         "replaces": "distantspeech_tpu/ops/pallas_enhance.py:391", "launches": launches["fused_enhance_full"],
         "max_abs_err": main_err[("fused_enhance_full", "benched")],
         "ms": times[("fused_enhance_full", "rank1")] * 1e3, "plain_ms": plain_s["fused_enhance_full"] * 1e3,
         "bound_ms": b_full, "bound_by": by_full, "library_ms": None},
        {"name": "fused_enhance", "route": "cuda", "source": "distantspeech_tpu_torch/csrc/enhance.cu",
         "replaces": "distantspeech_tpu/ops/pallas_enhance.py:123", "launches": launches["fused_enhance"],
         "max_abs_err": main_err[("fused_enhance", "benched")],
         "ms": times[("fused_enhance", "rank1")] * 1e3, "plain_ms": plain_s["fused_enhance"] * 1e3,
         "bound_ms": b_lanes, "bound_by": by_lanes, "library_ms": None},
    ]


def enhance_bounds(x, cfg, tc, Z, Sf, planes, label=""):
    """The bounds of K4 (waveform in and out) and K2 (spectra in and out) on
    x [B, M, S] with its spectra Z, Sf and steering planes: bytes moved
    once, and the operations this input needs (the lane frames whose gate
    opens, from the port's MCRA); printed, and returned as (K4 ms, by,
    K2 ms, by)."""
    B, M, S = x.shape
    T = S // cfg.stft.hop
    ops = lane_ops(M)
    n_warm, n_steady, n_lanes = open_lane_frames(x, cfg, tc)
    lane_total = (n_warm * ops["open_ldl"] + n_steady * ops["open_rank1"]
                  + (n_lanes - n_warm - n_steady) * ops["closed"])
    N, hop = cfg.stft.n_fft, cfg.stft.hop
    # a windowed real N-point transform needs ~2.5 N log2 N operations as a
    # real FFT, plus N window products: one per mic and frame for the
    # analysis, one per frame for the synthesis, which also scales and
    # overlap-adds hop samples
    fft_ops = 2.5 * N * np.log2(N) + N
    dft_ops = B * M * T * fft_ops + B * T * (fft_ops + 2 * hop)
    gemm_ops = 2 * B * M * T * N * N + 2 * B * T * N * N  # the dense products the JAX package and K4 do
    print(f"lane ops per lane-frame (M={M}): {ops}; open gates: {n_warm} warm + {n_steady} steady "
          f"of {n_lanes} lane-frames", flush=True)

    full_bytes = 4 * (x.numel() + B * S)
    lanes_bytes = 4 * (Z.numel() + Sf.numel() + planes.numel() + 2 * T * B * cfg.stft.half_bin)
    b_full, by_full = bound(full_bytes, dft_ops + lane_total)
    b_lanes, by_lanes = bound(lanes_bytes, lane_total)
    print(f"bound fused_enhance_full{label}: {b_full:.4f} ms by {by_full} ({full_bytes} B, "
          f"{dft_ops + lane_total:.4g} ops with the DFTs as real FFTs; with them as dense products, "
          f"{gemm_ops + lane_total:.4g} ops, {bound(full_bytes, gemm_ops + lane_total)[0]:.4f} ms)")
    print(f"bound fused_enhance kernel{label}: {b_lanes:.4f} ms by {by_lanes} ({lanes_bytes} B, {lane_total:.4g} ops)")
    return b_full, by_full, b_lanes, by_lanes


def k1_lane_ops(M, gain: bool):
    """Operations per lane-frame of K1, counted like ``lane_ops`` on its
    plain version: {'open', 'closed'} (the kernel skips the update and the
    solve where the gate is closed; the plain version selects)."""
    import torch

    from distantspeech_tpu_torch.ops import cuda_mvdr

    rng = np.random.default_rng(0)
    T = 3
    Z = torch.as_tensor(rng.standard_normal((T, 1, 3, M)) + 1j * rng.standard_normal((T, 1, 3, M)))
    gate = torch.ones((T, 1, 3))
    steer = torch.as_tensor(np.exp(1j * rng.uniform(0, 6, (3, M))))
    pl = torch.full((T, 1, 3), 0.5)
    run = lambda n: cuda_mvdr.fused_mvdr_scan_plain(Z[:n], gate[:n], steer, 0.9998, 1e-6, 1e-5,
                                                    *((pl[:n], pl[:n]) if gain else (None, None)))
    frame = counted(run, T) - counted(run, T - 1)
    z = [torch.ones(1, 3, dtype=torch.float64) for _ in range(M)]
    R = lambda: [[z[0].clone() for _ in range(M)] for _ in range(M)]
    upd = {g is None: counted(cuda_mvdr._mvdr_update_ldl, z, z, g, z, z, R(), R(), list(z), list(z), M, 0.9998, 1e-6, 1e-5)
           for g in (None, z[0] > 0)}
    closed = frame - upd[False]
    return {"open": closed + upd[True], "closed": closed}


def k1_bound(name, Zt, gate, steer, gain: bool):
    """K1's bound on spectra Zt [T, B, F, M] and its gate: bytes moved once,
    operations of this run's gate; printed, and returned as (ms, by)."""
    M = Zt.shape[-1]
    ops = k1_lane_ops(M, gain)
    n_open = int(gate.sum())
    n_lanes = gate.numel()
    nbytes = Zt.numel() * 8 + n_lanes * 4 * (3 if gain else 1) + steer.numel() * 8 + n_lanes * 8
    nops = n_open * ops["open"] + (n_lanes - n_open) * ops["closed"]
    b, by = bound(nbytes, nops)
    print(f"bound {name}: {b:.4f} ms by {by} ({nbytes} B, {nops:.4g} ops; {ops} per lane-frame, "
          f"{n_open} of {n_lanes} lane-frames open)", flush=True)
    return b, by


def k1_chain_ops(M: int, gain: bool) -> float:
    """Dependent float32 operations on the longest chain of one open-gate
    frame in csrc/mvdr.cu, counted from its code.  Up to 16 mics (the
    frame-parallel layout, 4 frames solved at once): every frame's rank-1
    update of an entry (4) and the gain's carry (5), plus a quarter of one
    frame's solve, which runs beside three others: the LDL^H factorisation
    (column j: its diagonal's j subtractions, 1 / D_j and the scale, M (M -
    1) / 2 + 2 M), the forward and back solves (M (M + 1) / 2 each), the
    scale by 1 / D (1) and the output's running sums and division (M + 5).
    Above 16 (the column layout, G threads a lane): the update (4); the
    trace's reduction, its scale and the loading (log2 G + 2); per
    factorisation step the owner's 1 / D_k and L[:, k] (2) and a later
    column's term L[i][k] conj(L[c][k]) D_k subtracted (4); v's scaling
    (1); the back solve, M (M - 1) / 2 terms of a complex product and a
    subtraction (3 each); the output's terms, their reduction, |den|^2, the
    division and the product (7 + log2 G); the gain (16).  Shuffles, loads
    and barriers are not counted, so the floor lies below any run."""
    if M <= 16:
        solve = M * (M - 1) // 2 + 2 * M + M * (M + 1) + 1 + M + 5
        return 4 + (5 if gain else 0) + solve / 4
    G = min(32, 1 << (M - 1).bit_length())
    lg = G.bit_length() - 1
    return 4 + (lg + 2) + 6 * M + 1 + 3 * M * (M - 1) // 2 + (7 + lg) + (16 if gain else 0)


def k1_chain_ms(T: int, M: int, gain: bool) -> float:
    return chain_ms(T, k1_chain_ops(M, gain))


def k2_chain_ops(M: int) -> float:
    """Dependent float32 operations on the longest chain of one open-gate
    steady rank-1 frame in csrc/enhance.cu's lane kernel up to 8 mics (a
    thread pair a lane, its rows split), counted from its code: MCRA's
    recursion from its state to the gate (S's smoothing 2, the minima 2,
    S / Smin and its threshold 3, p's recursion and clamp 5, the gate 1:
    13); Bennett's column chain through sig, d_j and 1 / d_j (3 a column,
    the reciprocal and its Newton step counted as one); the forward solve,
    v_k settling after its last term, a complex multiply-subtract (2 a
    row), the scale by 1 / D (1), and the back solve, each u_i the pair's
    sum of its terms and a subtraction (2 a row); the output, a thread's
    M / 2 running terms, the pair's sum, |den|^2, its reciprocal and the
    product (M / 2 + 5); and the gain's (G_H1, gamma) carry (5).  Shuffles
    and loads are not counted, so the floor lies below any run."""
    return 13 + 3 * M + 2 * M + 1 + 2 * M + M / 2 + 5 + 5


def k2_issued_ops(M: int) -> dict:
    """Operations one thread issues for an open-gate steady rank-1 frame in
    each layout of the lane kernel tried, counted like ``lane_ops`` on the plain versions: one thread a lane (1),
    the whole frame; frame-parallel on 4 threads (4), the frame less the
    3/4 of its solve and output that the group's other threads take; G
    threads a lane with its rows split (-G), the frame less (G - 1) / G of
    Bennett's row updates (all but the 11 scalar operations of each column,
    which every thread runs), of the solve and of the output; {code:
    operations}."""
    import torch

    from distantspeech_tpu_torch.ops import cuda_mvdr

    z = [torch.ones(1, 3, dtype=torch.float64) for _ in range(M)]
    L = lambda: [[z[0].clone() for _ in range(M)] for _ in range(M)]
    solve = counted(cuda_mvdr._ldl_solve_factors, L(), L(), z, z, z, M)
    output = counted(cuda_mvdr._mvdr_output, z, z, z, z, z, z, M)
    bennett = counted(cuda_mvdr._mvdr_update_rank1, z, z, None, z, z, L(), L(), list(z), list(z), M, 0.9998) - solve
    frame = lane_ops(M)["open_rank1"]
    split = bennett - 11 * M + solve + output
    return {1: frame, 4: frame - 3 / 4 * (solve + output), -2: frame - split / 2, -4: frame - 3 / 4 * split}


def k10_bound(name, y2, G, M):
    """K10's bound on rows y2 [R, F, 2M] and grid G [F, 2M, 2 Theta]: bytes
    moved once; the products as the kernel runs them, 3xTF32 (three
    tensor-core multiply-adds a product) at the card's TF32 rate; the
    magnitudes (c0^2 + c1^2, the root and the sum: 4 float32 operations a
    (row, bin, angle)) at its FP32 rate; printed beside the FP32 bound of the
    first design (8M + 5 operations a (row, bin, angle)), and returned as
    (ms, by)."""
    R, F, _ = y2.shape
    Theta = G.shape[-1] // 2
    nbytes = 4 * (y2.numel() + G.numel() + R * Theta)
    t_bytes = nbytes / H100_HBM_BYTES
    t_tc = 3 * 2 * R * F * (2 * Theta) * (2 * M) / H100_TF32_FLOPS
    t_fp = 4 * R * F * Theta / H100_FP32_FLOPS
    b_ms = max(t_bytes, t_tc, t_fp) * 1e3
    by = "bytes" if t_bytes >= max(t_tc, t_fp) else "operations"
    fp32_ms, fp32_by = bound(nbytes, R * F * Theta * (8 * M + 5))
    print(f"bound {name}: {b_ms:.4f} ms by {by} (tensor cores {t_tc * 1e3:.4f} ms for the 3xTF32 products at "
          f"{H100_TF32_FLOPS / 1e12:.0f} TFLOP/s, magnitudes {t_fp * 1e3:.4f} ms at {H100_FP32_FLOPS / 1e12:.0f}, "
          f"{nbytes} B {t_bytes * 1e3:.4f} ms); FP32 bound (8M + 5 a (row, bin, angle)): {fp32_ms:.4f} ms by "
          f"{fp32_by}", flush=True)
    return b_ms, by


def k1_inputs(x, cfg):
    """What ``enhance_scan_pallas`` hands K1: spectra, gate, p, lambda_d."""
    import torch

    from distantspeech_tpu_torch.noise.mcra import mcra_run
    from distantspeech_tpu_torch.transform import analysis

    Zt = torch.movedim(torch.movedim(analysis(x, cfg.stft), -3, -1), -3, 0).contiguous()
    lam, p, sr = mcra_run(cfg.mvdr.mcra, Zt[..., 0].abs() ** 2, return_sr=True)
    gate = p < cfg.mvdr.p_vad
    if cfg.mvdr.vad_guard:
        gate = gate & (sr <= cfg.mvdr.mcra.delta_s)
    return Zt, gate.float(), p, lam


def smoke_k1(dev, card: str, B: int, seconds: int) -> list:
    """Phase 7: kernel K1 at the gate size and on the ``pallas`` path."""
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process
    from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig
    from distantspeech_tpu_torch.noise.mcra import mcra_run, mcra_run_plain
    from distantspeech_tpu_torch.ops import _build
    from distantspeech_tpu_torch.ops import cuda_mvdr as cm
    from distantspeech_tpu_torch.runtime.profiling import benchmark

    tag = f"[{card}]"
    M = 8
    geom = ArrayGeometry.linear(M, 0.032)
    look = (90.0, 0.0)
    bench_cfg = EnhanceConfig()
    nog_cfg = EnhanceConfig(mvdr=MvdrConfig(**{**bench_cfg.mvdr.__dict__, "vad_guard": False}))
    steer = torch.as_tensor(steering_vector(geom, np.asarray(look) / 180.0 * np.pi, bench_cfg.stft.n_fft)
                            .astype(np.complex64), device=dev)

    def k1_args(cfg, gain, Zt, gate, p, lam):
        mv = cfg.mvdr
        return (Zt, gate, steer, mv.alpha_v, mv.diag, mv.rel_diag, p if gain else None, lam if gain else None,
                cfg.alpha_xi, cfg.gmin)

    def y_rel(got, want):
        return rel_err(torch.view_as_real(got), torch.view_as_real(want))

    # ---- gate size: both variants, guard off and benched, same gate on both sides
    xg = torch.as_tensor(scene(8, M, FS, seed=1)[0], device=dev)
    for cname, cfg in (("guard off", nog_cfg), ("benched", bench_cfg)):
        ins = k1_inputs(xg, cfg)
        for gain in (False, True):
            args = k1_args(cfg, gain, *ins)
            got = cm.fused_mvdr_scan(*args)
            want = cm.fused_mvdr_scan_plain(*args)
            torch.cuda.synchronize()
            rel, mx = y_rel(got, want)
            check(bool(torch.isfinite(torch.view_as_real(got)).all()), f"fused_mvdr_scan gain={gain} {cname}: finite")
            check(rel < K1_GATE, f"fused_mvdr_scan gain={gain} {cname} vs plain (B=8, 1 s): rel {rel:.3e} "
                                 f"(max abs {mx:.3e}) < {K1_GATE:g}")

    # the mic counts between: 3 and 6, B=8 x 1 s, the gate of the benched
    # config and its p and lambda_d on both sides
    for Ms in (3, 6):
        xm = torch.as_tensor(scene(8, Ms, FS, seed=1)[0], device=dev)
        stm = torch.as_tensor(steering_vector(ArrayGeometry.linear(Ms, 0.032), np.asarray(look) / 180.0 * np.pi,
                                              bench_cfg.stft.n_fft).astype(np.complex64), device=dev)
        Zm, gm, pm, lm = k1_inputs(xm, bench_cfg)
        mv = bench_cfg.mvdr
        args = (Zm, gm, stm, mv.alpha_v, mv.diag, mv.rel_diag, pm, lm, bench_cfg.alpha_xi, bench_cfg.gmin)
        rel, mx = y_rel(cm.fused_mvdr_scan(*args), cm.fused_mvdr_scan_plain(*args))
        check(rel < K1_GATE, f"fused_mvdr_scan gain=True benched, M={Ms} vs plain (B=8, 1 s): rel {rel:.3e} "
                             f"(max abs {mx:.3e}) < {K1_GATE:g}")

    # ---- why csrc/mvdr.cu is built with -fmad=false: the same source with
    # fused multiply-adds, benched config, against the same plain output
    lib = _build.BUILD_DIR / "mvdr-fmad.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(_build.CSRC / "mvdr.cu")]
    subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=300)
    args = k1_args(bench_cfg, True, *k1_inputs(xg, bench_cfg))
    built = _build._loaded.pop("mvdr", None)
    _build._loaded["mvdr"] = ctypes.CDLL(str(lib))
    got = cm.fused_mvdr_scan(*args)
    torch.cuda.synchronize()
    _build._loaded["mvdr"] = built if built is not None else _build.load("mvdr")
    rel, _ = y_rel(got, cm.fused_mvdr_scan_plain(*args))
    print(f"fused_mvdr_scan built with fused multiply-adds, benched (B=8, 1 s): rel {rel:.3e} to the plain version", flush=True)

    # ---- the pallas path at full size, through the user entry points
    S = seconds * FS
    xs, env = scene(B, M, S, seed=2)
    x = torch.as_tensor(xs, device=dev)
    snr_in = segment_snr_db(xs[:, 0], env, 0)
    reset_launches()
    y = enhance_process(x, geom, look, bench_cfg, backend="pallas")
    torch.cuda.synchronize()
    counts = launch_counts()
    launches_gain, launches_mcra = counts["fused_mvdr_scan"], counts["mcra_run"]
    check(launches_gain == 1 and launches_mcra == 1 and sum(counts.values()) == 2,
          f"backend=pallas launched K1 and the MCRA lane kernel once each: {counts}")
    check(tuple(y.shape) == (B, S) and bool(torch.isfinite(y).all()), f"backend=pallas: finite output {tuple(y.shape)}")
    snr_out = segment_snr_db(y.cpu().numpy(), env, bench_cfg.stft.hop)
    check(snr_out > snr_in, f"backend=pallas: output SNR {snr_out:.2f} dB > input SNR {snr_in:.2f} dB (mic 0)")
    ins = k1_inputs(x, bench_cfg)
    Zt = ins[0]
    T, _, F, _ = Zt.shape
    print(f"K1 main-path input: T={T} B={B} F={F} M={M}", flush=True)
    cm.LAUNCHES["fused_mvdr_scan"] = 0
    y_nogain = cm.fused_mvdr_scan(*k1_args(bench_cfg, False, *ins))
    torch.cuda.synchronize()
    launches_nogain = cm.LAUNCHES["fused_mvdr_scan"]
    check(launches_nogain == 1, f"fused_mvdr_scan (no gain) launched {launches_nogain} time(s)")

    # ---- both variants against the plain version at full size (the plain
    # call, timed once, is also the plain time); then the kernels' times
    results, plain_ms, err, times = {}, {}, {}, {}
    for gain in (True, False):
        args = k1_args(bench_cfg, gain, *ins)
        got = cm.fused_mvdr_scan(*args) if gain else y_nogain
        want, plain_ms[gain] = timed_once(cm.fused_mvdr_scan_plain, *args)
        rel, err[gain] = y_rel(got, want)
        check(bool(torch.isfinite(torch.view_as_real(got)).all()), f"fused_mvdr_scan gain={gain}, full size: finite")
        check(rel < K1_GATE, f"fused_mvdr_scan gain={gain} benched vs plain at full size: rel {rel:.3e} "
                             f"(max abs {err[gain]:.3e}) < {K1_GATE:g}")
        times[gain] = benchmark(cm.fused_mvdr_scan, *args)["per_call_s"] * 1e3
        print(f"fused_mvdr_scan gain={gain}: {times[gain]:.3f} ms/call (B={B}, M={M}, {seconds} s); "
              f"plain {plain_ms[gain]:.1f} ms {tag}", flush=True)
    t_path = benchmark(enhance_process, x, geom, look, bench_cfg, "pallas")["per_call_s"]
    print(f"backend=pallas end to end: {t_path * 1e3:.3f} ms/call, {B * S / FS / t_path:.0f} audio-s/s {tag}", flush=True)

    # ---- bounds: bytes moved once, operations of this run's gate; and the
    # chain floor of the new layout
    recs = []
    for gain, name in ((True, "fused_mvdr_scan"), (False, "fused_mvdr_scan (no gain)")):
        b, by = k1_bound(name, Zt, ins[1], steer, gain)
        print(f"chain floor {name}: {k1_chain_ms(T, M, gain):.4f} ms (T={T} frames x {k1_chain_ops(M, gain):g} "
              f"dependent operations of an open-gate frame at {FP32_DEP_CYCLES} cycles each, {sm_clock_mhz():.0f} "
              f"MHz) {tag}", flush=True)
        recs.append({"name": name, "route": "cuda", "source": "distantspeech_tpu_torch/csrc/mvdr.cu",
                     "replaces": "distantspeech_tpu/ops/pallas_mvdr.py:" + ("373" if gain else "346"),
                     "launches": launches_gain if gain else launches_nogain, "max_abs_err": err[gain],
                     "ms": times[gain], "plain_ms": plain_ms[gain], "bound_ms": b, "bound_by": by, "library_ms": None})

    # ---- the MCRA lane kernel (csrc/mcra.cu; the JAX package's lax.scan,
    # not a TPU kernel): at the gate size and on the pallas path's own input
    mc = bench_cfg.mvdr.mcra
    Yg = k1_inputs(xg, bench_cfg)[0][..., 0].abs() ** 2
    hold_mcra(mc, Yg, "(B=8, 1 s)")
    Y1 = (Zt[..., 0].abs() ** 2).contiguous()
    mcra_err, mcra_plain_ms = hold_mcra(mc, Y1, f"on the pallas path's input (B={B}, {seconds} s)")
    mcra_ms = benchmark(mcra_run, mc, Y1, True)["per_call_s"] * 1e3
    # bound: the power and its smoothing in, lambda_d, p and S / Smin out, once
    # each; operations: the plain frame's elementwise work per lane
    Ys = Y1[:8, :1].double().cpu()
    ops_lf = frame_ops(lambda n: mcra_run_plain(mc, Ys[:n], True), 8) / Ys[0].numel()
    nbytes = 4 * 5 * Y1.numel()
    b, by = bound(nbytes, ops_lf * Y1.numel())
    print(f"mcra_run (the MCRA lane kernel) on the pallas path's input [{', '.join(map(str, Y1.shape))}]: {mcra_ms:.3f} "
          f"ms/call; plain {mcra_plain_ms:.1f} ms; bound {b:.4f} ms by {by} ({nbytes} B, {ops_lf:.0f} ops a lane-frame) "
          f"{tag}", flush=True)
    recs.append({"name": "mcra_run", "route": "cuda", "source": "distantspeech_tpu_torch/csrc/mcra.cu",
                 "replaces": "distantspeech_tpu/noise/mcra.py:161", "launches": launches_mcra, "max_abs_err": mcra_err,
                 "ms": mcra_ms, "plain_ms": mcra_plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None})
    return recs


def hold_mcra(mc, Y, where):
    """The MCRA lane kernel against ``mcra_run_plain`` on the power Y
    [T, ..., F]: lambda_d and S / Smin within the tight gate of their max, p
    absolutely, unless a thresholded decision (S / Smin > delta_s) flipped,
    then within the decision-flip gate; the flips printed.  Returns (p's max
    abs error, the plain version's ms)."""
    import torch

    from distantspeech_tpu_torch.noise.mcra import mcra_run, mcra_run_plain

    (wl, wp, wsr), plain_ms = timed_once(mcra_run_plain, mc, Y, True)
    lam, p, sr = mcra_run(mc, Y, True)
    torch.cuda.synchronize()
    tol = gate_flips(f"mcra_run {where}", int(((sr > mc.delta_s) != (wsr > mc.delta_s)).sum()), wsr.numel(),
                     "S / Smin > delta_s decisions")
    check(all(bool(torch.isfinite(a).all()) for a in (lam, p, sr)), f"mcra_run {where}: finite {tuple(p.shape)}")
    rl, rs, dp = rel_err(lam, wl)[0], rel_err(sr, wsr)[0], float((p - wp).abs().max())
    check(rl < tol and rs < tol and dp < tol, f"mcra_run {where} vs plain: lambda_d rel {rl:.3e}, S / Smin rel "
                                              f"{rs:.3e}, p max abs {dp:.3e}, all < {tol:g}")
    return dp, plain_ms


def k5_frame_ops(cfg):
    """Elementwise operations per utterance-frame of K5 apart from its
    transforms, counted per element on the plain version's frame loop (one
    utterance, a frame past the first)."""
    import torch

    from distantspeech_tpu_torch.ops import cuda_flms as cf

    rng = np.random.default_rng(0)
    C, Lf, T = cfg.n_mics - 1, cfg.frame_len, 3
    F = Lf + 1
    bm = torch.as_tensor(rng.standard_normal((1, C, T * Lf)))
    d = torch.as_tensor(rng.standard_normal((1, T * Lf)))
    yp = torch.as_tensor(rng.random((1, T, F)))
    up = torch.as_tensor(rng.random((1, C, T, F))) if cfg.postfilter else None
    run = lambda n: cf.tdgsc_frames_plain(bm[..., : n * Lf], d[..., : n * Lf], yp[:, :n],
                                          up[:, :, :n] if up is not None else None, cfg)
    return counted(run, T, per_element=True) - counted(run, T - 1, per_element=True)


def smoke_k5(dev, card: str, B: int, seconds: int) -> list:
    """Phase 8: kernel K5 at the gate size and on the time-domain GSC path."""
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, tdgsc_process
    from distantspeech_tpu_torch.ops import cuda_flms as cf
    from distantspeech_tpu_torch.runtime.profiling import benchmark

    tag = f"[{card}]"
    M = 4
    geom = ArrayGeometry.linear(M, 0.032)
    look = (np.pi / 2, 0.0)
    cfgs = {"core": TdGscConfig(n_mics=M), "vad_guard": TdGscConfig(n_mics=M, vad_guard=True),
            "postfilter": TdGscConfig(n_mics=M, postfilter=True)}

    def frame_inputs(x, cfg):
        """What ``fused_tdgsc`` hands the kernel."""
        fbf, bm = cf.front_end(cf._check(x, cfg), geom, look, cfg)
        bm = bm.contiguous()
        return (bm, *(a.contiguous() if a is not None else None for a in cf._kernel_inputs(fbf, bm, cfg)))

    # ---- gate size
    xg = torch.as_tensor(scene(8, M, FS, seed=3)[0], device=dev)
    for cname, cfg in cfgs.items():
        tol = FLIP if cfg.vad_guard else TIGHT
        ins = frame_inputs(xg, cfg)
        (got, p), (want, p_want) = cf.tdgsc_frames(*ins, cfg), cf.tdgsc_frames_plain(*ins, cfg)
        torch.cuda.synchronize()
        rel, mx = rel_err(got, want)
        check(bool(torch.isfinite(got).all()), f"fused_tdgsc {cname}: finite {tuple(got.shape)}")
        check(rel < tol, f"fused_tdgsc {cname} vs plain (B=8, 1 s): rel {rel:.3e} (max abs {mx:.3e}) < {tol:g}; "
                         f"p max abs {float((p - p_want).abs().max()):.3e}")

    # the mic counts between: 3 and 6 (C = 2 and 5, an even C and an odd
    # one), core and postfilter, B=8 x 1 s
    for Ms in (3, 6):
        gm = ArrayGeometry.linear(Ms, 0.032)
        xm = torch.as_tensor(scene(8, Ms, FS, seed=3)[0], device=dev)
        for pf in (False, True):
            cm_ = TdGscConfig(n_mics=Ms, postfilter=pf)
            fbf, bmm = cf.front_end(cf._check(xm, cm_), gm, look, cm_)
            bmm = bmm.contiguous()
            ins = (bmm, *(a.contiguous() if a is not None else None for a in cf._kernel_inputs(fbf, bmm, cm_)))
            (got, p), (want, p_want) = cf.tdgsc_frames(*ins, cm_), cf.tdgsc_frames_plain(*ins, cm_)
            torch.cuda.synchronize()
            rel, mx = rel_err(got, want)
            check(bool(torch.isfinite(got).all()) and rel < TIGHT,
                  f"fused_tdgsc {'postfilter' if pf else 'core'}, M={Ms} vs plain (B=8, 1 s): rel {rel:.3e} "
                  f"(max abs {mx:.3e}) < {TIGHT:g}; p max abs {float((p - p_want).abs().max()):.3e}")

    # ---- the time-domain GSC at full size, through tdgsc_process
    S = seconds * FS
    xs, env = scene(B, M, S, seed=4)
    x = torch.as_tensor(xs, device=dev)
    snr_in = segment_snr_db(xs[:, 0], env, 0)
    recs = []
    for cname, name in (("core", "fused_tdgsc"), ("postfilter", "fused_tdgsc (postfilter)")):
        cfg = cfgs[cname]
        cf.LAUNCHES["fused_tdgsc"] = 0
        out, p, bm = tdgsc_process(x, geom, look, cfg, backend="fused")
        torch.cuda.synchronize()
        launches = cf.LAUNCHES["fused_tdgsc"]
        check(launches == 1, f"tdgsc_process fused {cname} launched fused_tdgsc {launches} time(s)")
        T = S // cfg.frame_len
        check(tuple(out.shape) == (B, T * cfg.frame_len) and tuple(p.shape) == (B, T, cfg.half_bin)
              and bool(torch.isfinite(out).all()) and bool(torch.isfinite(p).all()),
              f"tdgsc_process fused {cname}: finite out {tuple(out.shape)}, p {tuple(p.shape)}")
        # delay: the alignment filters' 40 samples plus the non-causal 128;
        # the postfilter's STFT round trip adds a hop
        delay = 40 + cfg.frame_len // 2 + (cfg.frame_len if cfg.postfilter else 0)
        snr_out = segment_snr_db(out.cpu().numpy(), env[:, : out.shape[1]], delay)
        check(snr_out > snr_in, f"tdgsc_process fused {cname}: output SNR {snr_out:.2f} dB > input SNR {snr_in:.2f} dB (mic 0)")
        ins = frame_inputs(x, cfg)
        (want, p_want), plain_ms = timed_once(cf.tdgsc_frames_plain, *ins, cfg)
        rel, mx = rel_err(out, want)
        # the postfilter thresholds raw ratios (OM-LSA's absence decision
        # gamma_s < gamma_low | omega < omega_low), so over 8.2M bin-frames a
        # last-bit difference between an FFT and a dense DFT can flip one:
        # bench.py's decision-flip gate; the float64 plain version shows
        # whether the kernel strays further from exact than the plain one
        tol = FLIP if cfg.postfilter else TIGHT
        check(rel < tol, f"fused_tdgsc {cname} at full size vs plain: rel {rel:.3e} (max abs {mx:.3e}) < {tol:g}; "
                         f"p max abs {float((p - p_want).abs().max()):.3e}")
        want64 = cf.tdgsc_frames_plain(*(a.double() if a is not None else None for a in ins), cfg)[0]
        print(f"fused_tdgsc {cname} at full size against the float64 plain version: kernel rel "
              f"{rel_err(out, want64)[0]:.3e}, float32 plain rel {rel_err(want, want64)[0]:.3e}", flush=True)
        ms = benchmark(cf.tdgsc_frames, *ins, cfg)["per_call_s"] * 1e3
        t_path = benchmark(tdgsc_process, x, geom, look, cfg, "fused")["per_call_s"]
        print(f"{name}: kernel {ms:.3f} ms/call, {ms * 1e3 / T:.2f} us a frame; tdgsc_process fused "
              f"{t_path * 1e3:.3f} ms/call, {B * S / FS / t_path:.0f} audio-s/s (B={B}, M={M}, {seconds} s); "
              f"plain {plain_ms:.1f} ms {tag}", flush=True)

        # bound: bytes of the kernel's inputs and outputs; operations: each
        # 512-point transform at a real FFT's 2.5 N log2 N + N, 5C + 2 per
        # frame (2 more with the postfilter), plus the per-bin elementwise work
        C, N = M - 1, 2 * cfg.frame_len
        nbytes = 4 * (sum(a.numel() for a in ins if a is not None) + out.numel() + p.numel())
        n_fft = 5 * C + 2 + (2 if cfg.postfilter else 0)
        fft_ops = B * T * n_fft * (2.5 * N * np.log2(N) + N)
        elem_ops = B * T * k5_frame_ops(cfg)
        b, by = bound(nbytes, fft_ops + elem_ops)
        print(f"bound {name}: {b:.4f} ms by {by} ({nbytes} B; {fft_ops:.4g} transform + {elem_ops:.4g} "
              f"elementwise ops)", flush=True)
        recs.append({"name": name, "route": "cuda", "source": "distantspeech_tpu_torch/csrc/flms.cu",
                     "replaces": "distantspeech_tpu/ops/pallas_flms.py:" + ("715" if cfg.postfilter else "164"),
                     "launches": launches, "max_abs_err": mx, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "library_ms": None})
    return recs


def echo_scene(B, M, S, seed):
    """The full stack's scene: a far end of white noise x 0.5; its echo
    through one 256-tap decaying path (randn exp(-n/40)), the same on every
    mic; the 1.3 Hz on/off target burst (as in ``scene``) x 0.5 on every mic;
    independent noise x 0.05 per mic.  Returns (far [B, S], x [B, M, S], both
    float32, and the target envelope [B, S])."""
    rng = np.random.default_rng(seed)
    far = rng.standard_normal((B, S)) * 0.5
    ir = rng.standard_normal(256) * np.exp(-np.arange(256) / 40.0)
    n = S + 255
    echo = np.fft.irfft(np.fft.rfft(far, n) * np.fft.rfft(ir, n), n)[:, :S]
    t = np.arange(S) / FS
    env = (np.sin(2 * np.pi * 1.3 * t + rng.uniform(0, 2 * np.pi, (B, 1))) > 0).astype(np.float64)
    tgt = env * rng.standard_normal((B, S)) * 0.5
    x = (echo + tgt)[:, None, :] + 0.05 * rng.standard_normal((B, M, S))
    return far.astype(np.float32), x.astype(np.float32), env


def erle_db(x0, e0, env, start=FS, margin=512):
    """Echo return loss enhancement of an echo canceller's output e0 on its
    input x0 (both [B, S]): 10 log10(mean x0^2 / mean e0^2) over the
    target-off ``segments`` after ``start``, mean over utterances."""
    _, off = segments(env, 0, start, margin)
    return float(np.mean([10 * np.log10(np.mean(x0[b, off[b]] ** 2) / np.mean(e0[b, off[b]] ** 2))
                          for b in range(x0.shape[0])]))


def kernel_modules():
    from distantspeech_tpu_torch.ops import cuda_aec, cuda_enhance, cuda_flms, cuda_mcra, cuda_mvdr, cuda_sgsc, cuda_srp

    return cuda_aec, cuda_enhance, cuda_flms, cuda_mcra, cuda_mvdr, cuda_sgsc, cuda_srp


def reset_launches():
    """Every kernel's launch count to 0."""
    for mod in kernel_modules():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def launch_counts() -> dict:
    return {k: v for mod in kernel_modules() for k, v in mod.LAUNCHES.items()}


def frame_ops(run, T):
    """Elementwise operations of one frame of a plain version's frame loop,
    counted per element: ``run(n)`` runs it over n frames."""
    return counted(run, T, per_element=True) - counted(run, T - 1, per_element=True)


def pin_flips(p, p_want):
    """K8's frames whose low-bin pinning decision (mean p over bins 32..127
    above 0.8; those bins are never pinned) differs."""
    return int(((p[..., 32:128].mean(-1) > 0.8) != (p_want[..., 32:128].mean(-1) > 0.8)).sum())


def gate_flips(name, flips, total, what):
    """The gate of a kernel whose plain version can take another discrete
    decision: the tight gate, unless decisions flipped (then the
    decision-flip gate)."""
    print(f"{name}: {flips} of {total} {what} differ from the plain version's", flush=True)
    return FLIP if flips else TIGHT


def smoke_slice_c(dev, card: str, B: int, seconds: int) -> list:
    """Phases 9-11: kernels K7, K6 and K8 at the gate size, the full stack
    (B3) and the FDGSC (B4) at full size."""
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig, fdgsc_process
    from distantspeech_tpu_torch.ops import cuda_aec as ca, cuda_flms as cf
    from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process
    from distantspeech_tpu_torch.runtime.profiling import benchmark

    tag = f"[{card}]"
    M = 4
    geom = ArrayGeometry.linear(M, 0.032)
    look = (np.pi / 2, 0.0)
    fcfg = FullStackConfig(n_mics=M)
    acfg, kcfg, gcfg = fcfg.aec, fcfg.kws, fcfg.gsc
    dcfg = FdGscConfig(n_mics=M)
    Dn = kcfg.delay_frames_n
    t_phase = time.perf_counter()

    def aec_inputs(far, x):
        return tuple(a.contiguous() for a in ca._prepare(far, x, acfg))

    def kws_inputs(x2):
        return tuple(a.contiguous() for a in cf._kws_inputs(cf._kws_check(x2, kcfg), kcfg))

    def fdgsc_inputs(x):
        return tuple(a.contiguous() for a in cf.fdgsc_front_end(cf._fdgsc_check(x, dcfg), geom, look, dcfg))

    def tdgsc_inputs(x):
        fbf, bm = cf.front_end(cf._check(x, gcfg), geom, look, gcfg)
        bm = bm.contiguous()
        return (bm, *(a.contiguous() for a in cf._kernel_inputs(fbf, bm, gcfg)))

    def hold_aec(farp, xp, where):
        """K7 against its plain version; returns (out, max abs err, plain ms).
        Each (utterance, mic) row is its own recursion: the rows whose
        transfer decisions all agree with the plain version's are held at the
        tight gate, only the others at the decision-flip gate."""
        (want, uw), plain_ms = timed_once(ca.aec_frames_plain, farp, xp, acfg, True)
        got, ug = ca.aec_frames(farp, xp, acfg, decisions=True)
        torch.cuda.synchronize()
        # the transfer logic thresholds raw energy sums (speex's Davg / Dvar
        # tests): where a last-bit difference between an FFT and a dense DFT
        # flips a decision, that row's output may part from the plain one's
        flipped = (ug != uw).any(-1)  # [B, M]
        print(f"fused_aec {where}: {int((ug != uw).sum())} of {uw.numel()} transfer decisions differ from the plain "
              f"version's, in {int(flipped.sum())} of {flipped.numel()} (utterance, mic) rows", flush=True)
        gap = (got.double() - want.double()).abs().amax(-1)  # [B, M]
        scale = float(want.double().abs().max())
        rel_same = float(gap[~flipped].max()) / scale if bool((~flipped).any()) else 0.0
        rel_flip = float(gap[flipped].max()) / scale if bool(flipped.any()) else 0.0
        check(bool(torch.isfinite(got).all()), f"fused_aec {where}: finite {tuple(got.shape)}")
        check(rel_same < TIGHT, f"fused_aec {where} vs plain, rows with no flipped decision: rel {rel_same:.3e} < {TIGHT:g}")
        check(rel_flip < FLIP, f"fused_aec {where} vs plain, rows with a flipped decision: rel {rel_flip:.3e} < {FLIP:g}")
        return got, float(gap.max()), plain_ms

    def hold_kws(x0, d, where):
        want, plain_ms = timed_once(cf.kws_frames_plain, x0, d, kcfg)
        got = cf.kws_frames(x0, d, kcfg)
        torch.cuda.synchronize()
        rel, mx = rel_err(got, want)
        check(bool(torch.isfinite(got).all()), f"fused_kws {where}: finite {tuple(got.shape)}")
        check(rel < TIGHT, f"fused_kws {where} vs plain: rel {rel:.3e} (max abs {mx:.3e}) < {TIGHT:g}")
        return got, mx, plain_ms

    def hold_fdgsc(ins, where, outs=None):
        (wo, wp, wb), plain_ms = timed_once(cf.fdgsc_frames_plain, *ins, dcfg)
        o, p, bm = outs if outs is not None else cf.fdgsc_frames(*ins, dcfg)
        torch.cuda.synchronize()
        # the pinning thresholds a mean of p: where it flips, the
        # decision-flip gate applies
        tol = gate_flips(f"fused_fdgsc {where}", pin_flips(p, wp), wp.shape[0] * wp.shape[1], "low-bin pinning decisions")
        rel, mx = rel_err(o, wo)
        rel_bm, _ = rel_err(bm, wb)
        dp = float((p - wp).abs().max())
        check(all(bool(torch.isfinite(a).all()) for a in (o, p, bm)), f"fused_fdgsc {where}: finite")
        check(rel < tol and rel_bm < tol and dp < tol,
              f"fused_fdgsc {where} vs plain: out rel {rel:.3e} (max abs {mx:.3e}), bm rel {rel_bm:.3e}, "
              f"p max abs {dp:.3e}, all < {tol:g}")
        return mx, plain_ms, (wo, wp, wb)

    # ---- 9. the kernels at the gate size (B=8, 4 mics) -----------------------
    far, x, _ = echo_scene(8, M, 2 * FS, seed=6)
    far, x = torch.as_tensor(far, device=dev), torch.as_tensor(x, device=dev)
    hold_aec(*aec_inputs(far[:, :FS], x[..., :FS]), "(B=8, 1 s)")
    x0, d = kws_inputs(x[:, :2])
    T2 = x0.shape[-1] // kcfg.frame_len
    check(T2 > Dn, f"fused_kws gate input: T={T2} frames > the FIFO's Dn={Dn} slots (it wraps)")
    hold_kws(x0, d, "(B=8, 2 s)")
    xg = torch.as_tensor(scene(8, M, FS, seed=7)[0], device=dev)
    hold_fdgsc(fdgsc_inputs(xg), "(B=8, 1 s)")
    # the mic counts between: 3 and 6 (an odd M's last pair half empty)
    for Ms in (3, 6):
        cm_ = FdGscConfig(n_mics=Ms)
        xm = torch.as_tensor(scene(8, Ms, FS, seed=7)[0], device=dev)
        ins = tuple(a.contiguous() for a in cf.fdgsc_front_end(cf._fdgsc_check(xm, cm_), ArrayGeometry.linear(Ms, 0.032),
                                                                look, cm_))
        (wo, wp, wb), (o, p, bm) = cf.fdgsc_frames_plain(*ins, cm_), cf.fdgsc_frames(*ins, cm_)
        torch.cuda.synchronize()
        tol = gate_flips(f"fused_fdgsc M={Ms} (B=8, 1 s)", pin_flips(p, wp), wp.shape[0] * wp.shape[1],
                         "low-bin pinning decisions")
        rel, mx = rel_err(o, wo)
        rel_bm, dp = rel_err(bm, wb)[0], float((p - wp).abs().max())
        check(all(bool(torch.isfinite(a).all()) for a in (o, p, bm)) and rel < tol and rel_bm < tol and dp < tol,
              f"fused_fdgsc M={Ms} vs plain (B=8, 1 s): out rel {rel:.3e} (max abs {mx:.3e}), bm rel {rel_bm:.3e}, "
              f"p max abs {dp:.3e}, all < {tol:g}")
    got = full_stack_process(x[:2, :, :FS], far[:2, :FS], geom, look, fcfg, backend="fused")
    ref = full_stack_process(x[:2, :, :FS].double(), far[:2, :FS].double(), geom, look, fcfg, backend="scan", device=dev)
    torch.cuda.synchronize()
    for name, g, r in zip(("enhanced", "kws_clean"), got, ref):
        rel, _ = rel_err(g, r)
        check(rel < FLIP, f"full_stack_process fused vs the float64 scan path (B=2, 1 s), {name}: rel {rel:.3e} < {FLIP:g}")
    print(f"full_stack_process fused vs the float64 scan path: p max abs {float((got[2] - ref[2]).abs().max()):.3e}",
          flush=True)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 10. the full stack (B3) at full size ---------------------------------
    t_phase = time.perf_counter()
    S = seconds * FS
    far_np, x_np, env = echo_scene(B, M, S, seed=8)
    far, x = torch.as_tensor(far_np, device=dev), torch.as_tensor(x_np, device=dev)
    reset_launches()
    out, kws_clean, p = full_stack_process(x, far, geom, look, fcfg, backend="fused")
    torch.cuda.synchronize()
    counts = launch_counts()
    check({k: counts[k] for k in ("fused_aec", "fused_kws", "fused_tdgsc")} == {"fused_aec": 1, "fused_kws": 1, "fused_tdgsc": 1}
          and sum(counts.values()) == 3, f"full_stack_process fused launched K7, K6 and K5 once each: {counts}")
    launches = dict(counts)
    T = S // fcfg.frame_len
    Sp = T * fcfg.frame_len
    check(tuple(out.shape) == (B, Sp) and tuple(kws_clean.shape) == (B, Sp) and tuple(p.shape) == (B, T, gcfg.half_bin)
          and all(bool(torch.isfinite(a).all()) for a in (out, kws_clean, p)),
          f"full_stack_process fused: finite out {tuple(out.shape)}, kws {tuple(kws_clean.shape)}, p {tuple(p.shape)}")
    farp, xp = aec_inputs(far, x)
    echo_free, aec_err, aec_plain_ms = hold_aec(farp, xp, f"(B={B}, {seconds} s)")
    erle = erle_db(x_np[:, 0, :Sp], echo_free[:, 0].cpu().numpy(), env[:, :Sp])
    check(erle > 10.0, f"fused_aec: echo return loss enhancement on mic 0 (target off, after 1 s) {erle:.2f} dB > 10 dB")
    snr_in = segment_snr_db(x_np[:, 0], env, 0)
    delay = 40 + gcfg.frame_len // 2 + gcfg.frame_len  # alignment, non-causal FLMS, the postfilter's STFT
    snr_out = segment_snr_db(out.cpu().numpy(), env[:, :Sp], delay)
    check(snr_out > snr_in, f"full stack: output SNR {snr_out:.2f} dB > mic 0's {snr_in:.2f} dB (the echo counts as noise)")
    x0, d = kws_inputs(echo_free[:, :2])
    _, kws_err, kws_plain_ms = hold_kws(x0, d, f"on K7's output (B={B}, {seconds} s)")
    ef_plain = ca.aec_frames_plain(farp, xp, acfg)
    chain = (cf.fused_tdgsc_plain(ef_plain, geom, look, gcfg)[0], cf.fused_kws_plain(ef_plain[:, :2], kcfg))
    for name, g, w in zip(("enhanced", "kws_clean"), (out, kws_clean), chain):
        rel, _ = rel_err(g, w)
        check(rel < FLIP, f"full stack fused chain vs the plain chain, {name}: rel {rel:.3e} < {FLIP:g}")
    ins5 = tdgsc_inputs(echo_free)
    stages = (
        ("pre-emphasis", lambda: aec_inputs(far, x)),
        ("K7 fused_aec", lambda: ca.aec_frames(farp, xp, acfg)),
        ("KWS inputs", lambda: kws_inputs(echo_free[:, :2])),
        ("K6 fused_kws", lambda: cf.kws_frames(x0, d, kcfg)),
        ("TDGSC front end and STFT powers", lambda: tdgsc_inputs(echo_free)),
        ("K5 fused_tdgsc (postfilter)", lambda: cf.tdgsc_frames(*ins5, gcfg)),
    )
    ms = {}
    for name, fn in stages:
        ms[name] = benchmark(fn)["per_call_s"] * 1e3
        print(f"B3 stage {name}: {ms[name]:.3f} ms/call {tag}", flush=True)
    print(f"fused_aec: {ms['K7 fused_aec'] * 1e3 / T:.2f} us a frame; launch layout at hop {acfg.block_len}, "
          f"num_block {acfg.num_block} (mics a block, shared memory): "
          + ", ".join(f"M={m}: {ca.launch_layout(acfg, m)}" for m in (1, 2, 4, 8, 9)), flush=True)
    t_path = benchmark(full_stack_process, x, far, geom, look, fcfg, "fused")["per_call_s"]
    print(f"full_stack_process fused end to end: {t_path * 1e3:.3f} ms/call, {B * S / FS / t_path:.0f} audio-s/s "
          f"(B={B}, M={M}, {seconds} s); plain K7 {aec_plain_ms:.1f} ms, K6 {kws_plain_ms:.1f} ms {tag}", flush=True)

    # bounds: each transform at a real FFT's 2.5 N log2 N + N; the elementwise
    # work of a frame counted per element on the plain version.  K7's mics
    # share one far end: its analysis and power P are counted once per
    # utterance-frame (the plain version at M = 1 and M = 2 separates the
    # far end's work from a mic's)
    N = 2 * fcfg.frame_len
    fft_ops = 2.5 * N * np.log2(N) + N
    L = fcfg.frame_len
    f1, x2 = torch.as_tensor(far_np[:1, : 3 * L]).double(), torch.as_tensor(x_np[:1, :2, : 3 * L]).double()
    k7_m1, k7_m2 = (frame_ops(lambda n: ca.aec_frames_plain(f1[:, : n * L], x2[:, :m, : n * L], acfg), 3) for m in (1, 2))
    k7_mic = k7_m2 - k7_m1
    k7_far = k7_m1 - k7_mic
    print(f"fused_aec elementwise ops per frame: {k7_far} for the far end, {k7_mic} for each mic", flush=True)
    k6_ops = frame_ops(lambda n: cf.kws_frames_plain(x2[:, 0, : n * L], f1[:, : n * L], kcfg), 3)
    recs = []
    for name, src, line, nfft, elem, nbytes, err, ms_k, plain_ms in (
        ("fused_aec", "aec.cu", "pallas_aec.py:47", B * T * (1 + M * (3 + 2 * acfg.num_block)),
         B * T * (k7_far + M * k7_mic), 4 * (farp.numel() + 2 * xp.numel()), aec_err, ms["K7 fused_aec"], aec_plain_ms),
        ("fused_kws", "kws.cu", "pallas_flms.py:907", B * T * 7, B * T * k6_ops,
         4 * 3 * x0.numel(), kws_err, ms["K6 fused_kws"], kws_plain_ms),
    ):
        b_ms, by = bound(nbytes, nfft * fft_ops + elem)
        print(f"bound {name}: {b_ms:.4f} ms by {by} ({nbytes} B; {nfft * fft_ops:.4g} transform + {elem:.4g} "
              f"elementwise ops)", flush=True)
        recs.append({"name": name, "route": "cuda", "source": f"distantspeech_tpu_torch/csrc/{src}",
                     "replaces": f"distantspeech_tpu/ops/{line}", "launches": launches[name], "max_abs_err": err,
                     "ms": ms_k, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None})
    logN = int(np.log2(N))
    print(f"chain floor fused_kws: {chain_ms(T, k6_chain_ops(logN)):.4f} ms (T={T} frames x {k6_chain_ops(logN)} "
          f"dependent operations at {FP32_DEP_CYCLES} cycles each, {sm_clock_mhz():.0f} MHz) {tag}", flush=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 11. the FDGSC (B4) at full size ---------------------------------------
    t_phase = time.perf_counter()
    xs, env = scene(B, M, S, seed=4)
    x = torch.as_tensor(xs, device=dev)
    reset_launches()
    outs = fdgsc_process(x, geom, look, dcfg, backend="fused")
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["fused_fdgsc"] == 1 and sum(counts.values()) == 1, f"fdgsc_process fused launched K8 once: {counts}")
    o, p, bm = outs
    check(tuple(o.shape) == (B, Sp) and tuple(p.shape) == (B, T, dcfg.half_bin) and tuple(bm.shape) == (B, M, Sp)
          and all(bool(torch.isfinite(a).all()) for a in outs),
          f"fdgsc_process fused: finite out {tuple(o.shape)}, p {tuple(p.shape)}, bm {tuple(bm.shape)}")
    snr_in = segment_snr_db(xs[:, 0], env, 0)
    snr_out = segment_snr_db(o.cpu().numpy(), env[:, :Sp], 40 + dcfg.frame_len)  # alignment, the FBF's causality delay
    check(snr_out > snr_in, f"fdgsc_process fused: output SNR {snr_out:.2f} dB > mic 0's {snr_in:.2f} dB")
    ins8 = fdgsc_inputs(x)
    k8_err, k8_plain_ms, w32 = hold_fdgsc(ins8, f"(B={B}, {seconds} s)", outs)
    k8_ms = benchmark(cf.fdgsc_frames, *ins8, dcfg)["per_call_s"] * 1e3
    t_path = benchmark(fdgsc_process, x, geom, look, dcfg, True, "fused")["per_call_s"]
    print(f"fused_fdgsc: kernel {k8_ms:.3f} ms/call, {k8_ms * 1e3 / T:.2f} us a frame; fdgsc_process fused "
          f"{t_path * 1e3:.3f} ms/call, {B * S / FS / t_path:.0f} audio-s/s (B={B}, M={M}, {seconds} s); "
          f"plain {k8_plain_ms:.1f} ms {tag}", flush=True)
    w64 = cf.fdgsc_frames_plain(*(a.double() for a in ins8), dcfg)
    print("fused_fdgsc at full size against the float64 plain version (out, bm): kernel rel "
          f"{rel_err(o, w64[0])[0]:.3e}, {rel_err(bm, w64[2])[0]:.3e}; float32 plain rel "
          f"{rel_err(w32[0], w64[0])[0]:.3e}, {rel_err(w32[2], w64[2])[0]:.3e}", flush=True)
    c1 = tuple(a[:1].double().cpu() for a in ins8)
    k8_ops = frame_ops(lambda n: cf.fdgsc_frames_plain(c1[0][:, : n * L], c1[1][..., : n * L], c1[2][:, : n * L],
                                                      c1[3][:, :n], dcfg), 3)
    nbytes = 4 * (sum(a.numel() for a in ins8) + o.numel() + p.numel() + bm.numel())
    nfft = B * T * (3 + 7 * M)
    b_ms, by = bound(nbytes, nfft * fft_ops + B * T * k8_ops)
    print(f"bound fused_fdgsc: {b_ms:.4f} ms by {by} ({nbytes} B; {nfft * fft_ops:.4g} transform + "
          f"{B * T * k8_ops:.4g} elementwise ops)", flush=True)
    recs.append({"name": "fused_fdgsc", "route": "cuda", "source": "distantspeech_tpu_torch/csrc/fdgsc.cu",
                 "replaces": "distantspeech_tpu/ops/pallas_flms.py:415", "launches": counts["fused_fdgsc"],
                 "max_abs_err": k8_err, "ms": k8_ms, "plain_ms": k8_plain_ms, "bound_ms": b_ms, "bound_by": by,
                 "library_ms": None})
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return recs


def short_mcra_sgsc(base):
    """``base`` (a SubbandGscConfig class) with the McSpp CDR's MCRA window
    cut to L=3: MCRA holds its p at p_min for the first 2L frames (130 by
    default), so only a short window lets the CDR-driven q move within 1 s."""
    import dataclasses

    from distantspeech_tpu_torch.noise.mccdr import McCdrConfig
    from distantspeech_tpu_torch.noise.mcspp import McSppConfig

    class Cdr(McCdrConfig):
        @property
        def mcra(self):
            return dataclasses.replace(super().mcra, L=3)

    class Spp(McSppConfig):
        @property
        def mccdr(self):
            return Cdr(nfft=self.nfft, n_channels=min(4, self.n_channels))

    class Short(base):
        @property
        def spp(self):
            return Spp(nfft=self.frame_len * 2, n_channels=self.n_mics)

    return Short


def smoke_k9(dev, card: str, B: int, seconds: int) -> list:
    """Phase 12: kernel K9 at the gate size and on the subband GSC path (B5)."""
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig, subband_gsc_process
    from distantspeech_tpu_torch.ops import cuda_sgsc as cs
    from distantspeech_tpu_torch.runtime.profiling import benchmark

    tag = f"[{card}]"
    t_phase = time.perf_counter()
    M = 4
    geom = ArrayGeometry.linear(M, 0.032)
    look = (np.pi / 2, 0.0)
    cfg = SubbandGscConfig(n_mics=M)
    cfgs = {"default": cfg, "guards": SubbandGscConfig(n_mics=M, aic_warmup_frames=4, aic_freeze_thresh=0.5),
            "short MCRA": short_mcra_sgsc(SubbandGscConfig)(n_mics=M)}

    def inputs(x, c):
        return tuple(a.contiguous() for a in cs.front_end(cs._check(x, c), geom, look, c))

    def hold(got, want, where, want64=None):
        """K9 against its plain version, both with their decisions: every
        utterance whose decisions (the xi < 0 repair, MCRA's S/Smin >
        delta_s) all agree at the tight gate, out and bm < 1e-3 of max and
        p < 2e-3 absolute; the others, where a flipped threshold may part the
        recursions, out and bm at the decision-flip gate.  With ``want64``,
        the plain version in float64, also prints how far the kernel and the
        float32 plain version each lie from it.  Returns the max abs error of
        out against the float32 plain version."""
        (o, p, bm, dec), (wo, wp, wb, wd) = got, want
        flipped = (dec != wd).flatten(1).any(-1)  # [B]
        print(f"fused_subband_gsc {where}: {int((dec != wd).sum())} of {wd.numel()} decisions differ from the plain "
              f"version's, in {int(flipped.sum())} of {flipped.numel()} utterances; the plain version took "
              f"{int((wd & cs.REPAIR).sum())} repairs", flush=True)
        check(all(bool(torch.isfinite(a).all()) for a in (o, p, bm)), f"fused_subband_gsc {where}: finite")
        gap = lambda a, b: (a.double() - b.double()).flatten(1).abs().amax(-1)  # [B]
        scale = (float(wo.double().abs().max()), float(wb.double().abs().max()), 1.0)
        tight = (TIGHT, TIGHT, 2e-3)
        names = ("out rel", "bm rel", "p abs")
        g32 = [gap(a, b) / s for a, b, s in zip((o, bm, p), (wo, wb, wp), scale)]
        rows = ~flipped
        if bool(flipped.any()):
            mx = [float(g[flipped].max()) for g in g32]
            check(mx[0] < FLIP and mx[1] < FLIP, f"fused_subband_gsc {where} vs plain, utterances with a flipped "
                                                 f"decision: out rel {mx[0]:.3e}, bm rel {mx[1]:.3e} < {FLIP:g}; "
                                                 f"p max abs {mx[2]:.3e}")
        if not bool(rows.any()):
            return float(gap(o, wo).max())
        mx = [float(g[rows].max()) for g in g32]
        msg = ", ".join(f"{n} {m:.3e}" for n, m in zip(names, mx))
        check(all(m < t for m, t in zip(mx, tight)), f"fused_subband_gsc {where} vs plain, utterances with no "
                                                     f"flipped decision: {msg} (< 1e-3, 1e-3, 2e-3)")
        if want64 is not None:
            o64, p64, b64 = (a.double() for a in want64)
            s64 = (float(o64.abs().max()), float(b64.abs().max()), 1.0)
            far = [[float(gap(a, b).max()) / s for a, b, s in zip(side, (o64, b64, p64), s64)]
                   for side in ((o, bm, p), (wo, wb, wp))]
            print(f"fused_subband_gsc {where} vs the float64 plain version (out rel, bm rel, p abs): kernel "
                  f"{far[0][0]:.3e}, {far[0][1]:.3e}, {far[0][2]:.3e}; float32 plain {far[1][0]:.3e}, "
                  f"{far[1][1]:.3e}, {far[1][2]:.3e}", flush=True)
        return float(gap(o, wo).max())

    # ---- the gate size: B=8 x 4 x 1 s
    xg = torch.as_tensor(scene(8, M, FS, seed=10)[0], device=dev)
    for cname, c in cfgs.items():
        ins = inputs(xg, c)
        got, want = cs.subband_gsc_frames(*ins, c, decisions=True), cs.subband_gsc_frames_plain(*ins, c, decisions=True)
        torch.cuda.synchronize()
        hold(got, want, f"{cname} (B=8, 1 s)")
        p = want[1]
        print(f"fused_subband_gsc {cname}: plain p in (0.05, 0.95) on {int(((p > 0.05) & (p < 0.95)).sum())} of "
              f"{p.numel()} lane-frames", flush=True)
    x2 = xg[:2].contiguous()
    got = subband_gsc_process(x2, geom, look, cfg, backend="fused")
    ref = subband_gsc_process(x2.double(), geom, look, cfg, backend="scan", device=dev)
    torch.cuda.synchronize()
    for name, g, r in zip(("out", "p", "bm"), got, ref):
        rel, mx = rel_err(g, r)
        if name == "p":
            print(f"subband_gsc_process fused vs the float64 scan path (B=2, 1 s): p max abs {mx:.3e}", flush=True)
        else:
            check(rel < FLIP, f"subband_gsc_process fused vs the float64 scan path (B=2, 1 s), {name}: rel {rel:.3e} < {FLIP:g}")

    # ---- B5: the subband GSC at full size, through subband_gsc_process
    S = seconds * FS
    xs, env = scene(B, M, S, seed=11)
    x = torch.as_tensor(xs, device=dev)
    reset_launches()
    outs = subband_gsc_process(x, geom, look, cfg, backend="fused")
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["fused_subband_gsc"] == 1 and sum(counts.values()) == 1,
          f"subband_gsc_process fused launched K9 once: {counts}")
    o, p, bm = outs
    L = cfg.frame_len
    T = S // L
    Sp = T * L
    check(tuple(o.shape) == (B, Sp) and tuple(p.shape) == (B, T, cfg.half_bin) and tuple(bm.shape) == (B, M, Sp)
          and all(bool(torch.isfinite(a).all()) for a in outs),
          f"subband_gsc_process fused: finite out {tuple(o.shape)}, p {tuple(p.shape)}, bm {tuple(bm.shape)}")
    snr_in = segment_snr_db(xs[:, 0], env, 0)
    # the path's delay: the alignment filters' 40 samples, the AIC's desired
    # signal (the FBF one frame late) and the STFT round trip's one frame
    snr_out = segment_snr_db(o.cpu().numpy(), env[:, :Sp], 40 + 2 * L)
    check(snr_out > snr_in, f"subband_gsc_process fused: output SNR {snr_out:.2f} dB > mic 0's {snr_in:.2f} dB")
    ins = inputs(x, cfg)
    want, plain_ms = timed_once(cs.subband_gsc_frames_plain, *ins, cfg, True)
    got = cs.subband_gsc_frames(*ins, cfg, decisions=True)
    want64 = cs.subband_gsc_frames_plain(*(a.double() for a in ins), cfg)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got[:3], outs)), "K9 with its decisions returns the main path's outputs")
    err = hold(got, want, f"(B={B}, {seconds} s)", want64)
    n_repair = int((got[3] & cs.REPAIR).sum())

    # ---- times
    ms = benchmark(cs.subband_gsc_frames, *ins, cfg)["per_call_s"] * 1e3
    fe_ms = benchmark(inputs, x, cfg)["per_call_s"] * 1e3
    t_path = benchmark(subband_gsc_process, x, geom, look, cfg, "fused")["per_call_s"]
    print(f"fused_subband_gsc: kernel {ms:.3f} ms/call; front end (notch, alignment FIR, FBF, Sf) {fe_ms:.3f} ms; "
          f"subband_gsc_process fused {t_path * 1e3:.3f} ms/call, {B * S / FS / t_path:.0f} audio-s/s (B={B}, M={M}, "
          f"{seconds} s); plain {plain_ms:.1f} ms {tag}", flush=True)

    # ---- bound: 14 transforms per utterance-frame, and the elementwise work
    # of the plain frame counted per element: one inverse a lane-frame, and
    # the repair (an inverse and its trace) only on the lane-frames that took it
    N = 2 * L
    F = cfg.half_bin
    c1 = tuple(a[:1].double().cpu() for a in ins)
    n = 12  # a frame past the warm start and the repair loading
    run = lambda k, dec=False: cs.subband_gsc_frames_plain(c1[0][..., : k * L], c1[1][:, :k], cfg, dec)
    f_ops = frame_ops(run, n)  # frame n - 1 of utterance 0, its own repairs included
    r_n = int((run(n, True)[3][0, n - 1] & cs.REPAIR).sum())
    hd, ho, hf = (torch.ones((F,) + shape, dtype=torch.float64) for shape in ((4,), (6,), (4, 4)))
    rep_ops = counted(cs._repair, hd, ho, ho, hf, hf, 1.0, per_element=True) // F  # one lane's repair
    elem = B * T * (f_ops - r_n * rep_ops) + n_repair * rep_ops
    fft_ops = B * T * 14 * (2.5 * N * np.log2(N) + N)
    nbytes = 4 * (sum(a.numel() for a in ins) + o.numel() + p.numel() + bm.numel()) + p.numel()
    b_ms, by = bound(nbytes, fft_ops + elem)
    print(f"bound fused_subband_gsc: {b_ms:.4f} ms by {by} ({nbytes} B; {fft_ops:.4g} transform + {elem:.4g} "
          f"elementwise ops; {f_ops} a frame with {r_n} repairs, {rep_ops} a lane's repair, {n_repair} repairs)", flush=True)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return [{"name": "fused_subband_gsc", "route": "cuda", "source": "distantspeech_tpu_torch/csrc/sgsc.cu",
             "replaces": "distantspeech_tpu/ops/pallas_sgsc.py:155", "launches": counts["fused_subband_gsc"],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None}]


def doa_scene(B, M, S, seed):
    """A white-noise source that reaches mic m m samples after mic 0, plus
    independent noise per mic at -20 dB.  Returns x [B, M, S] float32."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((B, S + M))
    x = np.stack([s[:, M - m : M - m + S] for m in range(M)], axis=1)
    return (x + 0.1 * rng.standard_normal((B, M, S))).astype(np.float32)


def smoke_k10(dev, card: str, B: int, seconds: int) -> list:
    """Phase 13: kernel K10 at the gate size and on the SRP-PHAT path (B6)."""
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.doa.srp import SrpConfig, srp_angle_spectrum, srp_process, srp_steering_grid
    from distantspeech_tpu_torch.ops import cuda_srp as cr
    from distantspeech_tpu_torch.runtime.profiling import benchmark
    from distantspeech_tpu_torch.transform import analysis

    tag = f"[{card}]"
    t_phase = time.perf_counter()
    M = 8
    geom = ArrayGeometry.linear(M, 0.032)
    cfg = SrpConfig()
    grid = torch.as_tensor(srp_steering_grid(cfg, geom), device=dev)
    G = cr.pack_grid(grid, dev)

    def spectra(x):
        return torch.movedim(torch.movedim(analysis(x, cfg.stft), -3, -1), -3, 0)  # [T, B, F, M]

    def hold(Y, where):
        """K10 against its plain version and the einsum path; returns (rows,
        spectrum, max abs error, plain ms)."""
        y2 = cr.whitened_rows(Y).contiguous()
        got = cr.srp_spectrum(y2, G)
        want, plain_ms = timed_once(cr.srp_spectrum_plain, y2, G)
        lib = srp_angle_spectrum(Y, grid).reshape(-1, grid.shape[0])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"fused_srp_spectrum {where}: finite {tuple(got.shape)}")
        for name, ref in (("its plain version", want), ("the einsum path", lib)):
            rel, mx = rel_err(got, ref)
            # the linear array cannot tell a from 360 - a (their steering
            # vectors are equal), so picks are compared over 0..180 degrees
            half = ref[:, :181]
            top2 = half.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * float(ref.abs().max())
            same = bool((got[:, :181].argmax(-1) == half.argmax(-1))[clear].all())
            check(rel < SRP_GATE and same, f"fused_srp_spectrum {where} vs {name}: rel {rel:.3e} (max abs {mx:.3e}) "
                                           f"< {SRP_GATE:g}; the same pick (0..180 deg) in all {int(clear.sum())} of "
                                           f"{clear.numel()} rows whose top two differ by more than 1e-4 of max")
            if name == "its plain version":
                err = mx
        return y2, got, err, plain_ms

    # ---- the gate size: B=2 x 8 x 1 s of white noise
    hold(spectra(torch.as_tensor(np.random.default_rng(12).standard_normal((2, M, FS)).astype(np.float32),
                                 device=dev)), "(B=2, 1 s)")
    # the mic counts between: 3 and 6
    for Ms in (3, 6):
        Gm = cr.pack_grid(torch.as_tensor(srp_steering_grid(cfg, ArrayGeometry.linear(Ms, 0.032)), device=dev), dev)
        xm = np.random.default_rng(12).standard_normal((2, Ms, FS)).astype(np.float32)
        ym = cr.whitened_rows(spectra(torch.as_tensor(xm, device=dev))).contiguous()
        rel, mx = rel_err(cr.srp_spectrum(ym, Gm), cr.srp_spectrum_plain(ym, Gm))
        check(rel < SRP_GATE, f"fused_srp_spectrum M={Ms} vs its plain version (B=2, 1 s): rel {rel:.3e} "
                              f"(max abs {mx:.3e}) < {SRP_GATE:g}")

    # ---- B6: SRP-PHAT at full size, through srp_process
    S = seconds * FS
    x = torch.as_tensor(doa_scene(B, M, S, seed=13), device=dev)
    reset_launches()
    spec, p = srp_process(x, geom, cfg, backend="fused")
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["fused_srp_spectrum"] == 1 and counts["mcra_run"] == 1 and sum(counts.values()) == 2,
          f"srp_process fused launched K10 and the MCRA lane kernel once each: {counts}")
    T = S // cfg.stft.hop
    check(tuple(spec.shape) == (B, T, 360) and tuple(p.shape) == (B, T, cfg.stft.half_bin)
          and bool(torch.isfinite(spec).all()) and bool(torch.isfinite(p).all()),
          f"srp_process fused: finite spectrum {tuple(spec.shape)}, p {tuple(p.shape)}")
    true_deg = float(np.degrees(np.arccos(geom.c / (0.032 * geom.fs))))
    pick = int(spec.sum(dim=(0, 1)).argmax())
    off = min(abs(pick - a) for a in (true_deg, 360.0 - true_deg))
    check(off <= 3.0, f"srp_process fused: the summed spectrum picks {pick} deg, {off:.2f} deg from "
                      f"{true_deg:.2f} deg or its mirror (<= 3)")
    Y = spectra(x)
    y2, got, err, plain_ms = hold(Y, f"(B={B}, {seconds} s)")
    hold_mcra(cfg.mcra, (Y[..., 0].abs() ** 2).contiguous(), f"on the SRP path's input (B={B}, {seconds} s)")
    check(torch.equal(got.reshape(T, B, -1).movedim(0, 1), spec), "K10 on the main path's rows returns its spectrum")

    # ---- times.  The library call is the einsum path on the same whitened
    # spectrum (phat=False): the function the kernel computes on y2.  Both
    # again with the whitening, as srp_process calls them.
    ms = benchmark(cr.srp_spectrum, y2, G)["per_call_s"] * 1e3
    lib_ms = benchmark(srp_angle_spectrum, cr.phat_whiten(Y), grid, False)["per_call_s"] * 1e3
    fused_ms = benchmark(cr.fused_srp_spectrum, Y, grid.cpu().numpy())["per_call_s"] * 1e3
    einsum_ms = benchmark(srp_angle_spectrum, Y, grid)["per_call_s"] * 1e3
    t_path = benchmark(srp_process, x, geom, cfg, True, "fused")["per_call_s"]
    print(f"fused_srp_spectrum: kernel {ms:.3f} ms/call, the einsum path {lib_ms:.3f} ms on the same whitened "
          f"spectrum; with the whitening (and the grid packing) fused_srp_spectrum {fused_ms:.3f} ms, the einsum "
          f"path {einsum_ms:.3f} ms; srp_process fused {t_path * 1e3:.3f} ms/call, {B * S / FS / t_path:.0f} "
          f"audio-s/s (B={B}, M={M}, {seconds} s; its MCRA track is the MCRA lane kernel over {T} frames); plain "
          f"{plain_ms:.1f} ms {tag}", flush=True)

    # ---- bound: the products on the tensor cores in 3xTF32, the magnitudes in
    # float32; beside it the FP32 bound (8M + 5 a (row, bin, angle))
    b_ms, by = k10_bound("fused_srp_spectrum", y2, G, M)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return [{"name": "fused_srp_spectrum", "route": "cuda", "source": "distantspeech_tpu_torch/csrc/srp.cu",
             "replaces": "distantspeech_tpu/ops/pallas_srp.py:29", "launches": counts["fused_srp_spectrum"],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
             "library_ms": lib_ms}]


def smoke_wide(dev, card: str, seconds: int) -> list:
    """Phase 14: the shapes beyond 8 mics and beyond the powers of two.
    Gates, each kernel against its plain version: K1 at 12, 16 and 32 mics
    (the benched config's gate, p and lambda_d on both sides, B=8 x 1 s,
    < 1e-4); K2 and K4 at 16 mics (guard off, rank1, B=4 x 125 frames,
    < 1e-3); K5 (core and postfilter) and K8 at 12 and 16 mics and K10 at 12
    and 16 (their gate sizes and tolerances); times of the shapes without a
    record at their main paths' sizes.  Then a record for each new
    instantiation, through its own path at its main path's size (``pallas``,
    ``fused`` and ``mega`` at 12 mics and ``mega`` at n_fft 768, 1280 and
    2048 with 8: B=64 x ``seconds``; the TDGSC and FDGSC at 12 mics: B=128;
    SRP-PHAT at 12 mics: B=8), launch counts reset just before and read just
    after, held to its plain version on that path's input (K2 and K4 with
    the benched config at 2e-2 and with the guard off at 1e-3), timed, with
    its bound from that input."""
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process
    from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig, fdgsc_process
    from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, tdgsc_process
    from distantspeech_tpu_torch.doa.srp import SrpConfig, srp_angle_spectrum, srp_process, srp_steering_grid
    from distantspeech_tpu_torch.ops import cuda_enhance as ce
    from distantspeech_tpu_torch.ops import cuda_flms as cf
    from distantspeech_tpu_torch.ops import cuda_mvdr as cm
    from distantspeech_tpu_torch.ops import cuda_srp as cr
    from distantspeech_tpu_torch.transform import analysis
    from distantspeech_tpu_torch.transform.stft import StftConfig

    tag = f"[{card}]"
    t_phase = time.perf_counter()
    look_deg, look = (90.0, 0.0), (np.pi / 2, 0.0)
    bench_cfg = EnhanceConfig()
    nog = {**bench_cfg.mvdr.__dict__, "vad_guard": False}
    S = seconds * FS

    def steer_for(M, n_fft):
        return steering_vector(ArrayGeometry.linear(M, 0.032), np.asarray(look_deg) / 180.0 * np.pi,
                               n_fft).astype(np.complex64)

    def enh_cfg(n_fft, guard=True):
        mv = {**bench_cfg.mvdr.__dict__, "stft": StftConfig(n_fft, n_fft // 2)}
        if not guard:
            mv["vad_guard"] = False
        return EnhanceConfig(mvdr=MvdrConfig(**mv))

    def k1_args(Zt, gate, p, lam, steer, gain=True):
        mv = bench_cfg.mvdr
        return (Zt, gate, steer, mv.alpha_v, mv.diag, mv.rel_diag, p if gain else None, lam if gain else None,
                bench_cfg.alpha_xi, bench_cfg.gmin)

    def y_rel(got, want):
        return rel_err(torch.view_as_real(got), torch.view_as_real(want))

    def k5_inputs(x, cfg, geom):
        fbf, bm = cf.front_end(cf._check(x, cfg), geom, look, cfg)
        bm = bm.contiguous()
        return (bm, *(a.contiguous() if a is not None else None for a in cf._kernel_inputs(fbf, bm, cfg)))

    def k8_inputs(x, cfg, geom):
        return tuple(a.contiguous() for a in cf.fdgsc_front_end(cf._fdgsc_check(x, cfg), geom, look, cfg))

    def srp_rows(x, geom, cfg):
        Y = torch.movedim(torch.movedim(analysis(x, cfg.stft), -3, -1), -3, 0)
        return cr.whitened_rows(Y).contiguous(), cr.pack_grid(srp_steering_grid(cfg, geom), dev)

    times = []

    # ---- K1 at 12, 16 and 32 mics (12 timed with its record below)
    for Ms in (12, 16, 32):
        stm = torch.as_tensor(steer_for(Ms, 256), device=dev)
        args = k1_args(*k1_inputs(torch.as_tensor(scene(8, Ms, FS, seed=1)[0], device=dev), bench_cfg), stm)
        rel, mx = y_rel(cm.fused_mvdr_scan(*args), cm.fused_mvdr_scan_plain(*args))
        check(rel < K1_GATE, f"fused_mvdr_scan gain=True benched, M={Ms} vs plain (B=8, 1 s): rel {rel:.3e} "
                             f"(max abs {mx:.3e}) < {K1_GATE:g}")
        if Ms != 12:
            big = k1_args(*k1_inputs(torch.as_tensor(scene(64, Ms, S, seed=2)[0], device=dev), bench_cfg), stm)
            times.append((f"fused_mvdr_scan M={Ms} (B=64 x {seconds} s)", timed_ms(cm.fused_mvdr_scan, *big)))
            del big

    # ---- K2 and K4 at 16 mics (guard off, rank1, B=4 x 125 frames, < 1e-3);
    # 12 mics and K4 at n_fft 768, 1280 and 2048 are held on their records'
    # inputs below
    cs_ = enh_cfg(256, guard=False)
    xs_ = torch.as_tensor(scene(4, 16, 125 * 128, seed=3)[0], device=dev)
    st_ = steer_for(16, 256)
    want = ce.fused_enhance_plain(xs_, st_, cs_, 25, "rank1")
    for kname, fn in (("fused_enhance", ce.fused_enhance), ("fused_enhance_full", ce.fused_enhance_full)):
        got = fn(xs_, st_, cs_, 25, "rank1")
        torch.cuda.synchronize()
        rel, mx = rel_err(got, want)
        check(bool(torch.isfinite(got).all()) and rel < TIGHT,
              f"{kname} rank1 guard off, n_fft=256, M=16 vs plain: rel {rel:.3e} (max abs {mx:.3e}) < {TIGHT:g}")
    xm = torch.as_tensor(scene(64, 16, S, seed=2)[0], device=dev)
    tm = ce._pick_t_chunk(S // 128) or 64
    c_main = enh_cfg(256)
    times.append((f"fused_enhance_full n_fft=256 M=16 (B=64 x {seconds} s)",
                  timed_ms(ce.fused_enhance_full, xm, st_, c_main, tm, "rank1")))
    xt, planes, _ = ce._prepare(xm, st_, c_main, tm, "rank1")
    Z = ce._analysis_planes(xt, c_main.stft)
    Sf = ce._smoothed_power(Z, c_main.mvdr.mcra.b).contiguous()
    times.append((f"fused_enhance kernel M=16 (B=64 x {seconds} s)",
                  timed_ms(ce.enhance_lanes, Z, Sf, planes, c_main, tm, "rank1")))
    del Z, Sf, xt, xm

    # ---- K5 (core and postfilter) and K8 at 12 and 16 mics (12 timed with
    # their records below)
    for Ms in (12, 16):
        gm = ArrayGeometry.linear(Ms, 0.032)
        xm = torch.as_tensor(scene(8, Ms, FS, seed=3)[0], device=dev)
        xbig = torch.as_tensor(scene(128, Ms, S, seed=4)[0], device=dev) if Ms != 12 else None
        for pf in (False, True):
            c5 = TdGscConfig(n_mics=Ms, postfilter=pf)
            ins = k5_inputs(xm, c5, gm)
            (got, p), (want, p_want) = cf.tdgsc_frames(*ins, c5), cf.tdgsc_frames_plain(*ins, c5)
            torch.cuda.synchronize()
            rel, mx = rel_err(got, want)
            check(bool(torch.isfinite(got).all()) and rel < TIGHT,
                  f"fused_tdgsc {'postfilter' if pf else 'core'}, M={Ms} vs plain (B=8, 1 s): rel {rel:.3e} "
                  f"(max abs {mx:.3e}) < {TIGHT:g}; p max abs {float((p - p_want).abs().max()):.3e}")
            if xbig is not None or pf:
                xt5 = xbig if xbig is not None else torch.as_tensor(scene(128, Ms, S, seed=4)[0], device=dev)
                times.append((f"fused_tdgsc {'postfilter' if pf else 'core'} M={Ms} (B=128 x {seconds} s)",
                              timed_ms(cf.tdgsc_frames, *k5_inputs(xt5, c5, gm), c5)))
        c8 = FdGscConfig(n_mics=Ms)
        ins = k8_inputs(xm, c8, gm)
        (o, p, bm), (wo, wp, wb) = cf.fdgsc_frames(*ins, c8), cf.fdgsc_frames_plain(*ins, c8)
        torch.cuda.synchronize()
        tol = gate_flips(f"fused_fdgsc M={Ms} (B=8, 1 s)", pin_flips(p, wp), wp.shape[0] * wp.shape[1],
                         "low-bin pinning decisions")
        rel, mx = rel_err(o, wo)
        rel_bm = rel_err(bm, wb)[0]
        check(all(bool(torch.isfinite(a).all()) for a in (o, p, bm)) and rel < tol and rel_bm < tol,
              f"fused_fdgsc M={Ms} vs plain (B=8, 1 s): out rel {rel:.3e} (max abs {mx:.3e}), bm rel {rel_bm:.3e}, "
              f"p max abs {float((p - wp).abs().max()):.3e}, all < {tol:g}")
        if xbig is not None:
            times.append((f"fused_fdgsc M={Ms} (B=128 x {seconds} s)",
                          timed_ms(cf.fdgsc_frames, *k8_inputs(xbig, c8, gm), c8)))
        del xbig

    # ---- K10 at 12 and 16 mics (12 timed with its record below)
    scfg = SrpConfig()
    for Ms in (12, 16):
        gm = ArrayGeometry.linear(Ms, 0.032)
        xm = torch.as_tensor(np.random.default_rng(12).standard_normal((2, Ms, FS)).astype(np.float32), device=dev)
        y2, G = srp_rows(xm, gm, scfg)
        rel, mx = rel_err(cr.srp_spectrum(y2, G), cr.srp_spectrum_plain(y2, G))
        check(rel < SRP_GATE, f"fused_srp_spectrum M={Ms} vs its plain version (B=2, 1 s): rel {rel:.3e} "
                              f"(max abs {mx:.3e}) < {SRP_GATE:g}")
        if Ms != 12:
            y2b, Gb = srp_rows(torch.as_tensor(doa_scene(8, Ms, S, seed=13), device=dev), gm, scfg)
            times.append((f"fused_srp_spectrum M={Ms} (B=8 x {seconds} s)", timed_ms(cr.srp_spectrum, y2b, Gb)))
    for name, ms in times:
        print(f"wide shape time, {name}: {ms:.3f} ms/call (median of 3) {tag}", flush=True)
    print(f"phase 14 gates and times: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- the records: each new instantiation through its own path at its
    # main path's size (K1, K2, K4: B=64; K5, K8: B=128; K10: B=8)
    recs = []

    def record(name, src, line, launches, err, ms, plain_ms, b_ms, by, library_ms=None):
        recs.append({"name": name, "route": "cuda", "source": f"distantspeech_tpu_torch/csrc/{src}",
                     "replaces": f"distantspeech_tpu/ops/{line}", "launches": launches, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms})

    def path(name, run, kernel, other=()):
        """Run a path with the counts reset just before and read just
        after; it must launch ``kernel`` once (and ``other`` once each)."""
        reset_launches()
        out = run()
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {kernel: 1, **{k: 1 for k in other}}
        check({k: counts[k] for k in want} == want and sum(counts.values()) == len(want),
              f"{name} launched {', '.join(want)} once each: {counts}")
        return out, counts[kernel]

    M, B = 12, 64
    geom, steer = ArrayGeometry.linear(M, 0.032), torch.as_tensor(steer_for(M, 256), device=dev)
    x = torch.as_tensor(scene(B, M, S, seed=2)[0], device=dev)
    # pallas (K1)
    y, n = path(f"enhance_process pallas, 12 mics (B={B})",
                lambda: enhance_process(x, geom, look_deg, bench_cfg, backend="pallas"), "fused_mvdr_scan", ("mcra_run",))
    check(bool(torch.isfinite(y).all()), f"enhance_process pallas, 12 mics: finite {tuple(y.shape)}")
    ins = k1_inputs(x, bench_cfg)
    args = k1_args(*ins, steer)
    got = cm.fused_mvdr_scan(*args)
    want, plain_ms = timed_once(cm.fused_mvdr_scan_plain, *args)
    rel, mx = y_rel(got, want)
    check(rel < K1_GATE, f"fused_mvdr_scan M=12 on its path's input (B={B}, {seconds} s) vs plain: rel {rel:.3e} "
                         f"(max abs {mx:.3e}) < {K1_GATE:g}")
    b_ms, by = k1_bound("fused_mvdr_scan [M=12]", ins[0], ins[1], steer, True)
    T = ins[0].shape[0]
    print(f"chain floor fused_mvdr_scan [M=12]: {k1_chain_ms(T, M, True):.4f} ms (T={T} x {k1_chain_ops(M, True):g}) "
          f"{tag}", flush=True)
    record("fused_mvdr_scan [M=12]", "mvdr.cu", "pallas_mvdr.py:373", n, mx, timed_ms(cm.fused_mvdr_scan, *args),
           plain_ms, b_ms, by)
    del ins, args, got, want

    # fused (K2) and mega (K4) at 12 mics, and mega at n_fft 768, 1280, 2048
    # with 8: the path's own output against the plain version with the
    # benched config (< 2e-2, where a guard decision can flip), and the
    # kernel against it again with the guard off (< 1e-3)
    for nfft, Ms, backend, kname in ((256, 12, "fused", "fused_enhance"), (256, 12, "mega", "fused_enhance_full"),
                                     (768, 8, "mega", "fused_enhance_full"), (1280, 8, "mega", "fused_enhance_full"),
                                     (2048, 8, "mega", "fused_enhance_full")):
        cfg, c_nog = enh_cfg(nfft), enh_cfg(nfft, guard=False)
        gm = ArrayGeometry.linear(Ms, 0.032)
        xm = x if Ms == M else torch.as_tensor(scene(B, Ms, S, seed=2)[0], device=dev)
        st_ = torch.as_tensor(steer_for(Ms, nfft), device=dev)
        label = f" [M={Ms}]" if nfft == 256 else f" [n_fft={nfft}, M={Ms}]"
        y, n = path(f"enhance_process {backend}{label} (B={B})",
                    lambda: enhance_process(xm, gm, look_deg, cfg, backend=backend, inv_mode="rank1"), kname)
        check(bool(torch.isfinite(y).all()), f"enhance_process {backend}{label}: finite {tuple(y.shape)}")
        tc = ce._pick_t_chunk(S // cfg.stft.hop) or 64
        xt, planes, _ = ce._prepare(xm, st_, cfg, tc, "rank1")
        Z = ce._analysis_planes(xt, cfg.stft)
        Sf = ce._smoothed_power(Z, cfg.mvdr.mcra.b).contiguous()
        if kname == "fused_enhance":
            run = lambda c: ce.enhance_lanes(Z, Sf, planes, c, tc, "rank1")
            plain = lambda c: ce.enhance_lanes_plain(Z, Sf, planes, c, tc, "rank1")
            got = run(cfg)
        else:
            run = lambda c: ce.fused_enhance_full(xm, st_, c, tc, "rank1")
            plain = lambda c: ce.fused_enhance_plain(xm, st_, c, tc, "rank1")
            got = y
        want, plain_ms = timed_once(plain, cfg)
        rel, mx = rel_err(got, want)
        check(rel < FLIP, f"{kname}{label} on its path's input (B={B}, {seconds} s, benched) vs plain: rel {rel:.3e} "
                          f"(max abs {mx:.3e}) < {FLIP:g}")
        got_n, want_n = run(c_nog), plain(c_nog)
        torch.cuda.synchronize()
        rel_n, mx_n = rel_err(got_n, want_n)
        check(bool(torch.isfinite(got_n).all()) and rel_n < TIGHT,
              f"{kname}{label} on its path's input (B={B}, {seconds} s, guard off) vs plain: rel {rel_n:.3e} "
              f"(max abs {mx_n:.3e}) < {TIGHT:g}")
        b_full, by_full, b_lanes, by_lanes = enhance_bounds(xm, cfg, tc, Z, Sf, planes, label)
        b_ms, by = (b_lanes, by_lanes) if kname == "fused_enhance" else (b_full, by_full)
        record(kname + label, "enhance.cu", "pallas_enhance.py:" + ("123" if kname == "fused_enhance" else "391"), n,
               mx, timed_ms(run, cfg), plain_ms, b_ms, by)
        del Z, Sf, xt, got, want, got_n, want_n

    # the TDGSC (K5) and the FDGSC (K8) at 12 mics
    B = 128
    xs = torch.as_tensor(scene(B, M, S, seed=4)[0], device=dev)
    c5 = TdGscConfig(n_mics=M)
    (out, p, _), n = path(f"tdgsc_process fused [M=12] (B={B})", lambda: tdgsc_process(xs, geom, look, c5, backend="fused"),
                          "fused_tdgsc")
    ins = k5_inputs(xs, c5, geom)
    (want, _), plain_ms = timed_once(cf.tdgsc_frames_plain, *ins, c5)
    rel, mx = rel_err(out, want)
    check(bool(torch.isfinite(out).all()) and rel < TIGHT,
          f"fused_tdgsc [M=12] on its path (B={B}, {seconds} s) vs plain: rel {rel:.3e} (max abs {mx:.3e}) < {TIGHT:g}")
    T, Lf = S // c5.frame_len, c5.frame_len
    N = 2 * Lf
    fft_ops = 2.5 * N * np.log2(N) + N
    nbytes = 4 * (sum(a.numel() for a in ins if a is not None) + out.numel() + p.numel())
    b_ms, by = bound(nbytes, B * T * (5 * (M - 1) + 2) * fft_ops + B * T * k5_frame_ops(c5))
    print(f"bound fused_tdgsc [M=12]: {b_ms:.4f} ms by {by}", flush=True)
    record("fused_tdgsc [M=12]", "flms.cu", "pallas_flms.py:164", n, mx, timed_ms(cf.tdgsc_frames, *ins, c5), plain_ms,
           b_ms, by)

    c8 = FdGscConfig(n_mics=M)
    (o, p, bm), n = path(f"fdgsc_process fused [M=12] (B={B})", lambda: fdgsc_process(xs, geom, look, c8, backend="fused"),
                         "fused_fdgsc")
    ins = k8_inputs(xs, c8, geom)
    (wo, wp, wb), plain_ms = timed_once(cf.fdgsc_frames_plain, *ins, c8)
    tol = gate_flips(f"fused_fdgsc [M=12] (B={B}, {seconds} s)", pin_flips(p, wp), wp.shape[0] * wp.shape[1],
                     "low-bin pinning decisions")
    rel, mx = rel_err(o, wo)
    check(bool(torch.isfinite(o).all()) and rel < tol,
          f"fused_fdgsc [M=12] on its path (B={B}, {seconds} s) vs plain: rel {rel:.3e} (max abs {mx:.3e}) < {tol:g}")
    c1 = tuple(a[:1].double().cpu() for a in ins)
    k8_ops = frame_ops(lambda n_: cf.fdgsc_frames_plain(c1[0][:, : n_ * Lf], c1[1][..., : n_ * Lf],
                                                        c1[2][:, : n_ * Lf], c1[3][:, :n_], c8), 3)
    nbytes = 4 * (sum(a.numel() for a in ins) + o.numel() + p.numel() + bm.numel())
    b_ms, by = bound(nbytes, B * T * (3 + 7 * M) * fft_ops + B * T * k8_ops)
    print(f"bound fused_fdgsc [M=12]: {b_ms:.4f} ms by {by}", flush=True)
    record("fused_fdgsc [M=12]", "fdgsc.cu", "pallas_flms.py:415", n, mx, timed_ms(cf.fdgsc_frames, *ins, c8), plain_ms,
           b_ms, by)
    del xs, ins

    # SRP-PHAT (K10) at 12 mics
    B = 8
    xd = torch.as_tensor(doa_scene(B, M, S, seed=13), device=dev)
    (spec, _), n = path("srp_process fused [M=12]", lambda: srp_process(xd, geom, scfg, backend="fused"),
                        "fused_srp_spectrum", ("mcra_run",))
    y2, G = srp_rows(xd, geom, scfg)
    got = cr.srp_spectrum(y2, G)
    want, plain_ms = timed_once(cr.srp_spectrum_plain, y2, G)
    rel, mx = rel_err(got, want)
    check(bool(torch.isfinite(spec).all()) and rel < SRP_GATE,
          f"fused_srp_spectrum [M=12] on its path (B={B}, {seconds} s) vs plain: rel {rel:.3e} (max abs {mx:.3e}) "
          f"< {SRP_GATE:g}")
    b_ms, by = k10_bound("fused_srp_spectrum [M=12]", y2, G, M)
    # the library call: the einsum path on the same whitened spectrum, as phase 13's
    Yd = torch.movedim(torch.movedim(analysis(xd, scfg.stft), -3, -1), -3, 0)
    lib_ms = timed_ms(srp_angle_spectrum, cr.phat_whiten(Yd), torch.as_tensor(srp_steering_grid(scfg, geom), device=dev),
                      False)
    record("fused_srp_spectrum [M=12]", "srp.cu", "pallas_srp.py:29", n, mx, timed_ms(cr.srp_spectrum, y2, G), plain_ms,
           b_ms, by, lib_ms)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return recs


# The JAX package's on-device parity rows (benchmarks/pipelines.py:214-266,
# PIPELINES_r05.json): row -> (mics, its JAX gate_rel, the JAX harness's own
# tolerance, the gate the port is held to).  A row is held to its JAX bar
# where the port meets it, else to the harness tolerance (PERF.md section 7
# gives each such row's cause: for enhance_pallas and enhance_fused, the
# guarded config's float32 rounding, ~1e-3 of the output between any two
# float32 paths whose operations run in another order, kernel or not).
GATE_ROWS = {
    "enhance_pallas": (8, 1.11e-06, 2e-2, 2e-2),
    "enhance_fused": (8, 9.804e-05, 2e-2, 2e-2),
    "enhance_mega": (8, 1.94056e-03, 2e-2, 1.94056e-03),
    "tdgsc_fused": (4, 1.4e-07, 2e-2, 1.4e-07),
    "fdgsc_fused": (4, 3.3e-07, 2e-2, 3.3e-07),
    "subband_gsc_fused": (4, 1.18e-06, 2e-2, 1.18e-06),
    "full_stack_fused": (4, 5.6e-06, 2e-2, 5.6e-06),
    "kws_fused": (2, 0.0, 1e-3, 0.0),
    "srp_fused": (8, 7.9935e-04, 1e-3, 7.9935e-04),
}


def smoke_gate_rel(dev, card: str) -> None:
    """Phase 15: the JAX package's on-device parity protocol
    (benchmarks/pipelines.py's gates) on the port, every row: B=2
    utterances of standard normal noise (the first draw of seed 1, 16384
    samples a mic), the fused path against the float32 ``scan`` path on the
    card, rel = max |fused - scan| / max |scan| of the first output, printed
    beside the row's JAX ``gate_rel`` and held to ``GATE_ROWS``' gate.  Each
    row also prints its fused path's plain version (the same entry point on a
    CPU copy of the input) against the scan and against the kernel path, so
    that a gap splits into the algorithm's float32 rounding and the
    kernel's; ``full_stack_fused`` prints its stages; ``kws_fused``, whose
    input is shorter than its tap FIFO, says so and runs again with the
    defer cut so that the FIFO wraps (held to the tight gate), and with
    csrc/kws.cu built without fused multiply-adds."""
    import torch

    from distantspeech_tpu_torch.adaptive.aec import aec_init, aec_step
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process
    from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig, fdgsc_process
    from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig, subband_gsc_process
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, tdgsc_process
    from distantspeech_tpu_torch.doa.srp import srp_process
    from distantspeech_tpu_torch.kws.dual_mic import DualMicKwsConfig, kws_process
    from distantspeech_tpu_torch.ops import _build
    from distantspeech_tpu_torch.ops import cuda_aec as ca
    from distantspeech_tpu_torch.ops import cuda_flms as cf
    from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process

    t_phase = time.perf_counter()
    Sg = 16384
    draws = {M: torch.as_tensor(np.random.default_rng(1).standard_normal((2, M, Sg)).astype(np.float32), device=dev)
             for M in (2, 4, 8)}
    geom4, geom8 = ArrayGeometry.linear(4, 0.032), ArrayGeometry.linear(8, 0.032)
    ang, look8 = (np.pi / 2, 0.0), (90.0, 0.0)
    first = lambda out: out[0] if isinstance(out, tuple) else out
    enh = lambda **kw: lambda x, device=None: enhance_process(x, geom8, look8, EnhanceConfig(), device=device, **kw)
    rows = {  # row -> (the scan path, the fused path), each f(x, device)
        "enhance_pallas": (enh(), enh(backend="pallas")),
        "enhance_fused": (enh(), enh(backend="fused")),
        "enhance_mega": (enh(), enh(backend="mega", inv_mode="rank1")),
        "tdgsc_fused": tuple(lambda x, device=None, b=b: tdgsc_process(x, geom4, ang, TdGscConfig(n_mics=4), b, device)
                             for b in ("scan", "fused")),
        "fdgsc_fused": tuple(lambda x, device=None, b=b: fdgsc_process(x, geom4, ang, FdGscConfig(n_mics=4), True, b,
                                                                       device) for b in ("scan", "fused")),
        "subband_gsc_fused": tuple(lambda x, device=None, b=b: subband_gsc_process(x, geom4, ang,
                                                                                   SubbandGscConfig(n_mics=4), b, device)
                                   for b in ("scan", "fused")),
        "full_stack_fused": tuple(lambda x, device=None, b=b: full_stack_process(x, x[:, 0], geom4, ang,
                                                                                 FullStackConfig(), b, device)
                                  for b in ("scan", "fused")),
        "kws_fused": (lambda x, device=None: kws_process(x, DualMicKwsConfig(), device),
                      lambda x, device=None: cf.fused_kws(x, DualMicKwsConfig())),
        "srp_fused": tuple(lambda x, device=None, b=b: srp_process(x, geom8, backend=b, device=device)
                           for b in ("scan", "fused")),
    }
    gaps = {}
    for name, (scan_fn, fused_fn) in rows.items():
        M, bar, tol, gate = GATE_ROWS[name]
        x = draws[M]
        ref = first(scan_fn(x, device=dev)).float()
        got = first(fused_fn(x, device=dev))
        plain = first(fused_fn(x.cpu(), device="cpu")).to(dev)
        torch.cuda.synchronize()
        r, r_plain, r_kernel = rel_err(got, ref)[0], rel_err(plain, ref)[0], rel_err(got, plain)[0]
        gaps[name] = r
        where = "its JAX bar" if gate == bar else f"the JAX harness tolerance (its JAX bar {bar:.3g} is not met)"
        print(f"gate_rel {name} ({M} mics, B=2, float32 scan on the card): {r:.3e}; JAX gate_rel {bar:.3g}, held to "
              f"{gate:g} ({where}); the plain version on the CPU {r_plain:.3e} from the scan, the kernel path "
              f"{r_kernel:.3e} from the plain version", flush=True)

    # full_stack_fused by stage: K7 -> K6 -> K5 pf against the per-frame scan,
    # the far end mic 0 itself (as the JAX protocol feeds it)
    x = draws[4]
    far = x[:, 0].contiguous()
    fcfg = FullStackConfig()
    ref = full_stack_process(x, far, geom4, ang, fcfg, backend="scan", device=dev)
    L = fcfg.frame_len
    T = Sg // L
    st = aec_init(fcfg.aec, (2, 4), device=dev)
    echo_scan = []
    for t in range(T):
        blk = slice(t * L, (t + 1) * L)
        st, (e, _) = aec_step(fcfg.aec, st, far[:, None, blk].expand(2, 4, L), x[..., blk])
        echo_scan.append(e)
    echo_scan = torch.cat(echo_scan, dim=-1)
    farp, xp = (a.contiguous() for a in ca._prepare(far, x, fcfg.aec))
    echo_k7, ug = ca.aec_frames(farp, xp, fcfg.aec, decisions=True)
    _, uw = ca.aec_frames_plain(farp, xp, fcfg.aec, decisions=True)
    # K6 and K5 alone: fed the scan's echo-free mics
    kws_alone = cf.fused_kws(echo_scan[:, :2], fcfg.kws)
    enh_alone = cf.fused_tdgsc(echo_scan, geom4, ang, fcfg.gsc)[0]
    torch.cuda.synchronize()
    print(f"gate_rel full_stack_fused by stage, against the scan's: K7's echo-free mics "
          f"{rel_err(echo_k7, echo_scan)[0]:.3e}, K6 alone {rel_err(kws_alone, ref[1])[0]:.3e}, K5 pf alone "
          f"{rel_err(enh_alone, ref[0])[0]:.3e}; K7's transfer decisions: {int((ug != uw).sum())} of {uw.numel()} "
          f"differ from its plain version's", flush=True)

    # kws_fused's row guards the pass-through only: the protocol input is
    # shorter than the FIFO, so the cleaner's deferred taps are all zero.
    # Its companion runs the same input with the defer cut so that the
    # FIFO wraps, held to the tight gate.
    kcfg = DualMicKwsConfig()
    T2 = Sg // kcfg.frame_len
    print(f"gate_rel kws_fused: T={T2} frames < the FIFO's Dn={kcfg.delay_frames_n} slots, so its "
          f"{gaps['kws_fused']:.3e} guards only the pass-through (the cleaner's taps are all zero)", flush=True)
    short = DualMicKwsConfig(defer_seconds=0.5)
    check(short.delay_frames_n < T2, f"kws_fused companion: Dn={short.delay_frames_n} < T={T2} (the FIFO wraps)")
    got, ref = cf.fused_kws(draws[2], short), kws_process(draws[2], short, dev)
    torch.cuda.synchronize()
    r_short = rel_err(got, ref)[0]
    check(r_short < TIGHT, f"gate_rel kws_fused with defer_seconds={short.defer_seconds} (Dn={short.delay_frames_n}, "
                           f"the FIFO wraps), against the float32 scan on the card: {r_short:.3e} < {TIGHT:g}")

    # kws_fused with csrc/kws.cu built without fused multiply-adds (as K1's
    # and K9's sources are), against the same scan
    lib = _build.BUILD_DIR / "kws-nofmad.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-fmad=false", "-I", str(_build.CSRC), "-o", str(lib),
           str(_build.CSRC / "kws.cu")]
    subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=300)
    built = _build._loaded.pop("kws", None)
    _build._loaded["kws"] = ctypes.CDLL(str(lib))
    got = cf.fused_kws(draws[2], DualMicKwsConfig())
    torch.cuda.synchronize()
    _build._loaded["kws"] = built if built is not None else _build.load("kws")
    ref = kws_process(draws[2], DualMicKwsConfig(), dev)
    print(f"gate_rel kws_fused with csrc/kws.cu built with -fmad=false: {rel_err(got, ref)[0]:.3e} (built as "
          f"shipped: {gaps['kws_fused']:.3e})", flush=True)
    for name, r in gaps.items():
        M, bar, tol, gate = GATE_ROWS[name]
        check(np.isfinite(r) and r <= gate if gate == 0.0 else np.isfinite(r) and r < gate,
              f"gate_rel {name}: {r:.3e} within {gate:g} ({'its JAX bar' if gate == bar else 'the JAX harness tolerance'})")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)


def reverb_scene(B, M, S, seed, rt60=0.4, drr_db=0.0):
    """Phase 13's ``doa_scene`` made reverberant on the host: each mic's
    signal convolved with its own seeded room response, a unit direct path
    and, from 2 ms on, white noise under an exponential decay that falls 60
    dB in ``rt60`` seconds, scaled to a direct-to-reverberant ratio of
    ``drr_db``.  Returns x [B, M, S] float32."""
    x = doa_scene(B, M, S, seed).astype(np.float64)
    rng = np.random.default_rng(seed + 1)
    L = int(rt60 * FS)
    n = np.arange(L)
    h = rng.standard_normal((B, M, L)) * np.exp(-n * np.log(1e3) / L) * (n >= FS // 500)
    h *= np.sqrt(10 ** (-drr_db / 10) / np.sum(h**2, axis=-1, keepdims=True))
    h[..., 0] = 1.0
    nfft = 1 << int(np.ceil(np.log2(S + L - 1)))
    return np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(h, nfft), nfft)[..., :S].astype(np.float32)


def lead_in_scene(M, S, lead, seed):
    """``scene``'s burst on one utterance with the target silent for the
    first ``lead`` samples, white noise on every mic at the target's mean
    power.  Returns (x [1, M, S] float32, envelope [1, S])."""
    rng = np.random.default_rng(seed)
    t = np.arange(S)
    env = ((np.sin(2 * np.pi * 1.3 * t / FS) > 0) & (t >= lead)).astype(np.float64)[None]
    tgt = env * rng.standard_normal((1, S))
    noise = rng.standard_normal((1, M, S)) * np.sqrt(np.mean(tgt**2))
    return (tgt[:, None] + noise).astype(np.float32), env


def torch_calls(fn, *args) -> int:
    """The torch functions ``fn(*args)`` calls (each launches at most about
    one kernel on the card; views launch none)."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn(*args)
    return Count.n


# phase 16's utterance counts: the JAX benchmark's sizes (PIPELINES_r05.json)
SLICE_E_B = {"B7": 8, "fixed": 8, "gsc": 32, "pmwf": 128, "wpe": 8, "idoa": 8}


def smoke_slice_e(dev, card: str, seconds: int) -> None:
    """Phase 16: BASELINE configs 1, 2 and 4 on the card.  B7 (WPE -> SRP-PHAT,
    ``doa.wpe_srp_process``) at full size with its launch counts, K10 held to
    its plain version on B7's own input, the stages timed; the card's float32
    WPE against the same code in float64 on the CPU; then the fixed
    beamformers, the offline MVDR, the GSC, the PMWF, WPE and IDOA once each
    through their entry points at the JAX benchmark's sizes."""
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform import (
        FixedBeamformerConfig, GscConfig, PmwfConfig, adaptive_mvdr2_process, fixed_beamformer_weights,
        fixed_process, gsc_process, pmwf_process,
    )
    from distantspeech_tpu_torch.derev import WpeConfig, wpe_init, wpe_process, wpe_run, wpe_step
    from distantspeech_tpu_torch.doa import IdoaConfig, SrpConfig, idoa_run, srp_process, wpe_srp_process
    from distantspeech_tpu_torch.doa.wpe_srp import wpe_analysis, wpe_synthesis
    from distantspeech_tpu_torch.doa.srp import device_grid
    from distantspeech_tpu_torch.ops import cuda_srp as cr
    from distantspeech_tpu_torch.runtime.profiling import benchmark
    from distantspeech_tpu_torch.transform import StftConfig, analysis

    tag = f"[{card}]"
    t_phase = time.perf_counter()
    S = seconds * FS
    on = lambda a: torch.as_tensor(a, device=dev)

    def run_path(name, audio_s, fn, *args, n=2):
        """One call whose output is checked, then the median of ``n`` more
        (CUDA events): (output, ms)."""
        out, _ = timed_once(fn, *args)
        ms = float(np.median([timed_once(fn, *args)[1] for _ in range(n)]))
        print(f"{name}: {ms:.3f} ms/call, {audio_s / ms * 1e3:.1f} audio-s/s {tag}", flush=True)
        return out, ms

    # ---- B7: BASELINE config 4 at full size, B=8 x 8 mics, through wpe_srp_process
    B, M = SLICE_E_B["B7"], 8
    geom8 = ArrayGeometry.linear(M, 0.032)
    cfg, scfg = WpeConfig(n_channels=M), SrpConfig()
    x = on(reverb_scene(B, M, S, seed=16))
    reset_launches()
    spec, p = wpe_srp_process(x, geom8, cfg, scfg, backend="fused")
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["fused_srp_spectrum"] == 1 and counts["mcra_run"] == 1 and sum(counts.values()) == 2,
          f"B7 wpe_srp_process fused launched K10 and the MCRA lane kernel once each: {counts}")
    T = S // scfg.stft.hop
    check(tuple(spec.shape) == (B, T, 360) and tuple(p.shape) == (B, T, scfg.stft.half_bin)
          and bool(torch.isfinite(spec).all()) and bool(torch.isfinite(p).all()),
          f"B7: finite spectrum {tuple(spec.shape)}, p {tuple(p.shape)}")
    true_deg = float(np.degrees(np.arccos(geom8.c / (0.032 * geom8.fs))))
    pick = int(spec.sum(dim=(0, 1)).argmax())
    off = min(abs(pick - a) for a in (true_deg, 360.0 - true_deg))
    check(off <= 3.0, f"B7: the summed spectrum picks {pick} deg, {off:.2f} deg from {true_deg:.2f} deg or its "
                      f"mirror (<= 3; RT60 0.4 s, DRR 0 dB)")
    D = wpe_analysis(x, cfg)  # [T_wpe, B, F, C]
    e = wpe_run(cfg, D)
    y = wpe_synthesis(e, cfg)
    Ys = torch.movedim(torch.movedim(analysis(y, scfg.stft), -3, -1), -3, 0)
    y2 = cr.whitened_rows(Ys).contiguous()
    G = device_grid(scfg, geom8, dev, packed=True)
    got, want = cr.srp_spectrum(y2, G), cr.srp_spectrum_plain(y2, G)
    rel, mx = rel_err(got, want)
    check(rel < SRP_GATE, f"fused_srp_spectrum on B7's input (B={B}, {seconds} s) vs its plain version: rel "
                          f"{rel:.3e} (max abs {mx:.3e}) < {SRP_GATE:g}")

    audio = B * S / FS
    # host-launched: its times move between calls, so the medians of 5
    _, path_ms = run_path(f"B7 wpe_srp_process fused (B={B}, M={M}, {seconds} s)", audio, wpe_srp_process, x, geom8,
                          cfg, scfg, True, "fused", n=5)
    stages = {
        "subband analysis": (wpe_analysis, x, cfg),
        "WPE (wpe_run)": (wpe_run, cfg, D),
        "subband synthesis": (wpe_synthesis, e, cfg),
        "srp_process fused (STFT, whitening, K10, MCRA lanes)": (srp_process, y, geom8, scfg, True, "fused"),
    }
    for name, (fn, *a) in stages.items():
        ms = timed_ms(fn, *a, n=5)
        print(f"B7 stage {name}: {ms:.3f} ms ({100 * ms / path_ms:.1f}% of the path) {tag}", flush=True)
    k10_ms = benchmark(cr.srp_spectrum, y2, G)["per_call_s"] * 1e3
    T_wpe = D.shape[0]
    calls = torch_calls(wpe_step, cfg, wpe_init(cfg, (B,), device=dev), D[0], D[0])
    print(f"B7: K10 {k10_ms:.3f} ms ({100 * k10_ms / path_ms:.2f}% of the path); WPE {T_wpe} frames, {calls} torch "
          f"calls a frame ({calls * T_wpe} in the frame loop) {tag}", flush=True)

    # ---- the card's float32 WPE against the same code in float64 on the CPU, B=2 x 1 s
    x2 = x[:2, :, :FS]
    e32 = wpe_run(cfg, wpe_analysis(x2, cfg))
    e64 = wpe_run(cfg, wpe_analysis(x2.cpu().double(), cfg))
    diff = (e32.cpu().to(e64.dtype) - e64).abs().max()
    gap, mx = float(diff / e64.abs().max()), float(diff)
    check(gap < FLIP, f"WPE float32 on the card vs float64 on the CPU (B=2, 8 mics, 1 s, {e64.shape[0]} frames): "
                      f"{gap:.3e} of max|e| (max abs {mx:.3e}) < {FLIP:g}")

    # ---- config 1: the fixed beamformers, B=8 x 4 mics, on the broadside white-noise scene
    geom4 = ArrayGeometry.linear(4, 0.032)
    Bf = SLICE_E_B["fixed"]
    xs, env = scene(Bf, 4, S, seed=17)
    snr_in = segment_snr_db(xs[:, 0], env, 0)
    for wt in ("SD", "DS"):
        fcfg = FixedBeamformerConfig(weight_type=wt)
        W = fixed_beamformer_weights(geom4, (90.0, 0.0), fcfg)
        out, _ = run_path(f"fixed_process {wt} (B={Bf}, M=4, {seconds} s)", Bf * S / FS, fixed_process, on(xs), W,
                          fcfg.stft)
        check(tuple(out.shape) == (Bf, S) and bool(torch.isfinite(out).all()), f"fixed_process {wt}: finite {tuple(out.shape)}")
        snr = segment_snr_db(out.cpu().numpy(), env, fcfg.stft.hop)
        if wt == "DS":
            check(snr > snr_in, f"fixed_process DS: output SNR {snr:.2f} dB above mic 0's {snr_in:.2f} dB")
        else:
            print(f"fixed_process SD: output SNR {snr:.2f} dB, mic 0 {snr_in:.2f} dB (superdirective weights "
                  f"amplify white noise at low frequencies: no gate)", flush=True)

    # ---- config 2: the offline MVDR on one 8 x 4 s utterance, its first 200 frames noise only
    lead = 200 * 128
    xm, env = lead_in_scene(8, S, lead, seed=18)
    steer = steering_vector(geom8, np.array([np.pi / 2, 0.0]), 256)
    out, _ = run_path(f"adaptive_mvdr2_process (1 x 8 mics x {seconds} s)", S / FS, adaptive_mvdr2_process, on(xm[0]),
                      steer)
    check(tuple(out.shape) == (S,) and bool(torch.isfinite(out).all()), f"adaptive_mvdr2_process: finite {tuple(out.shape)}")
    snr_in, snr = segment_snr_db(xm[:, 0], env, 0, start=lead), segment_snr_db(out.cpu().numpy()[None], env, 0, start=lead)
    check(snr > snr_in, f"adaptive_mvdr2_process: output SNR {snr:.2f} dB above mic 0's {snr_in:.2f} dB after the "
                        f"estimation window")

    # ---- the GSC (B=32) with the benchmark's guards, and the PMWF (B=128), 4 mics
    look = (np.pi / 2, 0.0)
    for name, Bp, fn, extra in (
        ("gsc_process", SLICE_E_B["gsc"], gsc_process, (look, GscConfig(n_mics=4, normalize_aic=True, spp_rel_diag=1e-5))),
        ("pmwf_process", SLICE_E_B["pmwf"], pmwf_process, (PmwfConfig(n_mics=4),)),
    ):
        xs, env = scene(Bp, 4, S, seed=19)
        snr_in = segment_snr_db(xs[:, 0], env, 0)
        out, _ = run_path(f"{name} (B={Bp}, M=4, {seconds} s)", Bp * S / FS, fn, on(xs), geom4, *extra)
        check(tuple(out.shape) == (Bp, S) and bool(torch.isfinite(out).all()), f"{name}: finite {tuple(out.shape)}")
        snr = segment_snr_db(out.cpu().numpy(), env, extra[-1].stft.hop)  # the STFT delays by one hop
        check(snr > snr_in, f"{name}: output SNR {snr:.2f} dB above mic 0's {snr_in:.2f} dB")

    # ---- WPE (B=8 x 2 mics) and IDOA (B=8 x 4 mics, n_fft 512)
    Bw, Bi = SLICE_E_B["wpe"], SLICE_E_B["idoa"]
    out, _ = run_path(f"wpe_process (B={Bw}, M=2, {seconds} s)", Bw * S / FS, wpe_process,
                      on(reverb_scene(Bw, 2, S, seed=20)), WpeConfig(n_channels=2))
    check(tuple(out.shape) == (Bw, S) and bool(torch.isfinite(out).all()), f"wpe_process: finite {tuple(out.shape)}")
    icfg = IdoaConfig()
    Xi = analysis(on(doa_scene(Bi, 4, S, seed=21)), StftConfig(icfg.n_fft, icfg.n_fft // 2))
    Xi = torch.movedim(torch.movedim(Xi, -3, -1), -3, 0)  # [T, B, F, M]
    out, _ = run_path(f"idoa_run (B={Bi}, M=4, {seconds} s, {Xi.shape[0]} frames)", Bi * S / FS, idoa_run, icfg, geom4,
                      Xi)
    check(tuple(out.shape) == (Xi.shape[0], Bi, icfg.half_bin, icfg.n_theta) and bool(torch.isfinite(out).all())
          and float(out.min()) >= 0.0 and float(out.max()) <= 1.0, f"idoa_run: finite p in [0, 1], {tuple(out.shape)}")
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
