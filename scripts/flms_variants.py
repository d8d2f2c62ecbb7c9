#!/usr/bin/env python3
"""Time K5 (``csrc/flms.cu``, core and postfilter) and K8 (``csrc/fdgsc.cu``)
as built from this tree against variants of their sources, on one CUDA card.

    python3 scripts/flms_variants.py [--edit NAME ...] [--alt CSRC_DIR ...]

A variant is a named edit of a copy of this tree's ``csrc/`` (``EDITS``):

- ``t256``: 256 threads a block instead of 512;
- ``block-r8``: each transform batch run by the whole block instead of one
  warp (or warp pair) a sequence, with a block barrier after each radix-8
  pass (two more a batch at N = 512);
- ``block-r2``: the same with radix-2 passes, a block barrier after each of
  the log2 N stages (eight more a batch at N = 512: the barrier count of the
  block-wide ``fft_stages`` design);

or another ``csrc`` directory (``--alt``, labelled by its name).  The tree and
every variant are compiled with nvcc for sm_90a into ``build/flms_variants/``
(all compiles at once; ptxas's registers and spills printed per entry
function), held to the plain versions at B=8 x 4 mics x 1 s and at the main
paths' B=128 x 4 x 4 s with ``chip_smoke.py``'s gates (1e-3 of max|out|; the
postfilter at full size 2e-2), then timed with CUDA events in turns (first to
last, then last to first).  Prints one JSON line of the medians; exits
nonzero if a build fails or a gate does not hold.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "distantspeech_tpu_torch" / "csrc"
OUT = ROOT / "build" / "flms_variants"
FS = 16000

# fft_batch run by the whole block: every butterfly of a pass over the batch's
# sequences, a block barrier between passes of STEP radix-2 stages
_BLOCK_BATCH = """__device__ void fft_batch(float2* a, int nseq, int N, int logN, const float2* tw) {
  for (int s0 = 1; s0 <= logN; s0 += STEP) {
    const int k = min(logN - s0 + 1, STEP), nb = N >> k;
    for (int i = threadIdx.x; i < nseq * nb; i += kFrameThreads) {
      const int q = i / nb, b = i - q * nb;
      if (k == 3)
        fft_pass<3, kInv>(a + (size_t)q * N, logN, s0, tw, b, nb);
      else if (k == 2)
        fft_pass<2, kInv>(a + (size_t)q * N, logN, s0, tw, b, nb);
      else
        fft_pass<1, kInv>(a + (size_t)q * N, logN, s0, tw, b, nb);
    }
    if (s0 + STEP <= logN) __syncthreads();
  }
}
"""
_BATCH = re.compile(r"__device__ void fft_batch\(.*?\n}\n", re.S)


def _threads(src: str) -> str:
    old = "constexpr int kFrameThreads = 512;"
    if old not in src:
        raise RuntimeError("flms_fft.cuh: no 512-thread constant to edit")
    return src.replace(old, "constexpr int kFrameThreads = 256;")


def _block_batch(step: int):
    def edit(src: str) -> str:
        out, n = _BATCH.subn(lambda _: _BLOCK_BATCH.replace("STEP", str(step)), src)
        if n != 1:
            raise RuntimeError("flms_fft.cuh: no fft_batch to replace")
        return out

    return edit


EDITS = {"t256": _threads, "block-r8": _block_batch(3), "block-r2": _block_batch(1)}


def make_variant(name: str, out_dir: Path) -> Path:
    """A copy of csrc/ under out_dir with edit ``name`` applied to flms_fft.cuh."""
    dst = out_dir / name / "src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    hdr = dst / "flms_fft.cuh"
    hdr.write_text(EDITS[name](hdr.read_text()))
    return dst


def build(variants):
    """nvcc every (source, variant) at once; variants {label: csrc dir};
    returns {(name, label): library}."""
    from distantspeech_tpu_torch.ops import _build

    procs = {}
    for label, csrc in variants.items():
        out = OUT / label
        out.mkdir(parents=True, exist_ok=True)
        for name in ("flms", "fdgsc"):
            lib = out / f"{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(name, ()),
                   "-I", str(csrc), "-o", str(lib), str(Path(csrc) / f"{name}.cu")]
            procs[name, label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        entry = None
        for line in log.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                print(f"ptxas {key[0]} {key[1]} {entry}: {line.strip()}", flush=True)
        libs[key] = lib
    return libs


def use(libs, label):
    """Point the K5/K8 wrappers at variant label's libraries."""
    from distantspeech_tpu_torch.ops import _build

    for name in ("flms", "fdgsc"):
        _build._loaded[name] = ctypes.CDLL(str(libs[name, label]))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--edit", nargs="*", default=[], choices=sorted(EDITS), help="named edits of this tree's csrc/")
    ap.add_argument("--alt", nargs="*", default=[], help="other csrc directories")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flms_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig
    from distantspeech_tpu_torch.ops import cuda_flms as cf
    from distantspeech_tpu_torch.runtime.profiling import benchmark

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    variants = {"tree": CSRC}
    variants.update({name: make_variant(name, OUT) for name in args.edit})
    variants.update({Path(d).resolve().name: Path(d).resolve() for d in args.alt})
    labels = list(variants)
    libs = build(variants)
    dev = torch.device("cuda")
    M = 4
    geom, look = ArrayGeometry.linear(M, 0.032), (np.pi / 2, 0.0)
    k5 = {"core": TdGscConfig(n_mics=M), "postfilter": TdGscConfig(n_mics=M, postfilter=True)}
    k8 = FdGscConfig(n_mics=M)

    def k5_inputs(x, cfg):
        fbf, bm = cf.front_end(cf._check(x, cfg), geom, look, cfg)
        bm = bm.contiguous()
        return (bm, *(a.contiguous() if a is not None else None for a in cf._kernel_inputs(fbf, bm, cfg)))

    def k8_inputs(x):
        return tuple(a.contiguous() for a in cf.fdgsc_front_end(cf._fdgsc_check(x, k8), geom, look, k8))

    cases = {}
    for size, (B, sec) in (("gate", (8, 1)), ("full", (128, 4))):
        x = torch.as_tensor(cs.scene(B, M, sec * FS, seed=4 if size == "full" else 3)[0], device=dev)
        for cname, cfg in k5.items():
            ins = k5_inputs(x, cfg)
            cases[f"K5 {cname}", size] = (cf.tdgsc_frames, ins, cfg, cf.tdgsc_frames_plain(*ins, cfg))
        ins = k8_inputs(x)
        cases["K8", size] = (cf.fdgsc_frames, ins, k8, cf.fdgsc_frames_plain(*ins, k8))
    torch.cuda.synchronize()

    ok = True
    for label in labels:
        use(libs, label)
        for (name, size), (fn, ins, cfg, want) in cases.items():
            got = fn(*ins, cfg)
            torch.cuda.synchronize()
            tol = cs.FLIP if (size == "full" and name == "K5 postfilter") else cs.TIGHT
            rel = max(cs.rel_err(g, w)[0] for g, w in zip(got, want))
            good = rel < tol and all(bool(torch.isfinite(g).all()) for g in got)
            ok = ok and good
            print(f"{'ok' if good else 'FAILED'}: {label} {name} ({size}) vs plain: rel {rel:.3e} < {tol:g}", flush=True)

    times = {(label, name): [] for label in labels for name, size in cases if size == "full"}
    for order in (labels, labels[::-1]):
        for label in order:
            use(libs, label)
            for (name, size), (fn, ins, cfg, _) in cases.items():
                if size == "full":
                    times[label, name].append(benchmark(fn, *ins, cfg)["per_call_s"] * 1e3)
    med = {}
    for (label, name), v in times.items():
        med[f"{name} {label}"] = float(np.median(v))
        print(f"{name} {label}: {med[f'{name} {label}']:.3f} ms/call (B=128, M=4, 4 s; runs {v}) [{card}]", flush=True)
    print(json.dumps({"card": card, "ms": med}))
    return 0 if ok else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
