#!/usr/bin/env python3
"""Time K2 (``csrc/enhance.cu``'s lane kernel) and K10 (``csrc/srp.cu``) as
built from this tree against named edits of copies of their sources, on one
CUDA card.

    python3 scripts/lane_variants.py [--edit NAME ...]

A variant is a named edit of a copy of this tree's ``csrc/`` (``EDITS``,
each a literal replacement that must match once):

- ``k2-rows4``: K2 up to 8 mics on 4 threads a lane, its rows split,
  instead of a thread pair;
- ``k2-ieee``: K2's reciprocals (of Bennett's d'_j, the factorisation's
  D_j, the output's |a^H u|^2 and the gain's two divisors) by IEEE division
  (whose slow-path branch splits the code around it) instead of MUFU.RCP
  and a Newton step;
- ``k2-ieeegain``: the same for the gain's two divisors alone;
- ``k10-nobreak``: K10's warps compute every column tile of the block's
  angle range, those past Theta (zeros) too, instead of stopping at Theta;
- ``k10-batch``: K10's warps issue every column tile's products of a bin
  before any magnitude (no early stop), so that the tiles' mma chains
  overlap;
- ``k10-acc2``: K10 accumulates the 3xTF32 small products (lo hi + hi lo)
  and the big one (hi hi) in two fragments, added before the magnitude;
- ``k10-cvt``: K10 rounds to TF32 with the ``cvt.rna.tf32.f32``
  instruction instead of its integer equivalent;
- ``k10-lotrunc``: K10 rounds hi to TF32 and hands lo = x - hi to the
  tensor cores as it is (they read its top 19 bits: truncation).

The tree and every variant are compiled with nvcc for sm_90a into
``build/lane_variants/`` (all compiles at once; ptxas's registers and spills
printed per entry function), held to the plain versions (K2 at B=8 x 8 mics
x 1 s with the guard off, 1e-3 of max|out|; K10 on B6's rows, 1e-4), then
timed at the main sizes (K2 on the flagship's spectra, B=64 x 8 x 4 s; K10
on B6's, B=8 x 8 x 4 s) with CUDA events in turns (first to last, then last
to first).  Prints one JSON line of the medians; exits nonzero if a build
fails or a gate does not hold.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "distantspeech_tpu_torch" / "csrc"
OUT = ROOT / "build" / "lane_variants"
FS = 16000

_SRP_TILE = """#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const int nt = warp + kWarps * j;  // the column tile: angles a0 + 4 nt .. + 3
      if (a0 + 4 * nt >= Theta) break;   // the same for the whole warp
"""
_SRP_BATCH_OLD = """        if (!kChunked || c == nc - 1) {
          acc[i][j][0] += sqrtf(d[0] * d[0] + d[1] * d[1]);
          acc[i][j][1] += sqrtf(d[2] * d[2] + d[3] * d[3]);
        }
      }
    }
"""
_SRP_BATCH_NEW = """      }
    }
    if (!kChunked || c == nc - 1) {
#pragma unroll
      for (int j = 0; j < TW; ++j)
#pragma unroll
        for (int i = 0; i < kRowTiles; ++i) {
          const float(&d)[4] = C[i][j];
          acc[i][j][0] += sqrtf(d[0] * d[0] + d[1] * d[1]);
          acc[i][j][1] += sqrtf(d[2] * d[2] + d[3] * d[3]);
        }
    }
"""
_SRP_ACC_OLD = """#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma_m16n8k8_tf32(d, al[i][ks], bh[ks]);
          mma_m16n8k8_tf32(d, ah[i][ks], bl[ks]);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_m16n8k8_tf32(d, ah[i][ks], bh[ks]);
"""
_SRP_ACC_NEW = """        float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma_m16n8k8_tf32(e, al[i][ks], bh[ks]);
          mma_m16n8k8_tf32(e, ah[i][ks], bl[ks]);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_m16n8k8_tf32(d, ah[i][ks], bh[ks]);
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q] += e[q];
"""

_CVT = "__device__ __forceinline__ uint32_t cvt_rna_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }\n"
_CVT_PTX = """__device__ __forceinline__ uint32_t cvt_rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
"""
_SPLIT_LO = "  lo = cvt_rna_tf32(x - __uint_as_float(hi));\n"

# name -> [(the source it edits, old, new)]
EDITS = {
    "k2-rows4": [("enhance.cu", "constexpr int kLaneGroup8 = 2;", "constexpr int kLaneGroup8 = 4;")],
    "k2-ieeegain": [("enhance.cu", "* rcp_nr(fmaxf(lam, 1e-10f));", "/ fmaxf(lam, 1e-10f);"),
                    ("enhance.cu", "xi_ * rcp_nr(1.f + xi_);", "xi_ / (1.f + xi_);")],
    "k2-ieee": [("enhance.cu", "  const float r = __fdividef(1.f, x);\n  return fmaf(r, fmaf(-x, r, 1.f), r);\n",
                 "  return 1.f / x;\n")],
    "k10-nobreak": [("srp.cu", _SRP_TILE, _SRP_TILE.replace("      if (a0 + 4 * nt >= Theta) break;   // the same for the whole warp\n", ""))],
    "k10-batch": [("srp.cu", _SRP_TILE, _SRP_TILE.replace("      if (a0 + 4 * nt >= Theta) break;   // the same for the whole warp\n", "")),
                  ("srp.cu", _SRP_BATCH_OLD, _SRP_BATCH_NEW)],
    "k10-acc2": [("srp.cu", _SRP_ACC_OLD, _SRP_ACC_NEW)],
    "k10-cvt": [("srp.cu", _CVT, _CVT_PTX)],
    "k10-lotrunc": [("srp.cu", _SPLIT_LO, "  lo = __float_as_uint(x - __uint_as_float(hi));\n")],
}
LIBS = ("enhance", "srp")


def make_variant(name: str, out_dir: Path) -> Path:
    """A copy of csrc/ under out_dir with edit ``name`` applied."""
    dst = out_dir / name / "src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    for f, old, new in EDITS[name]:
        src = (dst / f).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to edit is not in {f} exactly once")
        (dst / f).write_text(src.replace(old, new))
    return dst


def build(variants):
    """nvcc every (source, variant) at once; variants {label: csrc dir};
    returns {(name, label): library}."""
    from distantspeech_tpu_torch.ops import _build

    procs = {}
    for label, csrc in variants.items():
        out = OUT / label
        out.mkdir(parents=True, exist_ok=True)
        for name in LIBS:
            lib = out / f"{name}.so"
            procs[name, label] = (lib, _build.start_nvcc(name, lib, csrc=csrc))
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
            elif ("registers" in line or "spill" in line) and entry and ("rows_kernelILi8E" in entry
                                                                         or "srp" in entry):
                print(f"ptxas {key[0]} {key[1]} {entry}: {line.strip()}", flush=True)
        libs[key] = lib
    return libs


def use(libs, label) -> contextlib.ExitStack:
    """A context in which the K2 and K10 wrappers run variant label's
    libraries."""
    from distantspeech_tpu_torch.ops import _build

    stack = contextlib.ExitStack()
    for name in LIBS:
        stack.enter_context(_build.swapped(name, libs[name, label]))
    return stack


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--edit", nargs="*", default=[], choices=sorted(EDITS), help="named edits of this tree's csrc/")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lane_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig
    from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig
    from distantspeech_tpu_torch.doa.srp import SrpConfig, srp_steering_grid
    from distantspeech_tpu_torch.ops import cuda_enhance as ce
    from distantspeech_tpu_torch.ops import cuda_srp as cr
    from distantspeech_tpu_torch.runtime.profiling import benchmark
    from distantspeech_tpu_torch.transform import analysis

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    variants = {"tree": CSRC}
    variants.update({name: make_variant(name, OUT) for name in args.edit})
    labels = list(variants)
    libs = build(variants)
    dev = torch.device("cuda")
    M = 8
    bench = EnhanceConfig()
    nog = EnhanceConfig(mvdr=MvdrConfig(**{**bench.mvdr.__dict__, "vad_guard": False}))
    steer = steering_vector(ArrayGeometry.linear(M, 0.032), np.array([np.pi / 2, 0.0]), 256).astype(np.complex64)

    def lanes(B, seconds, seed, cfg, tc):
        x = torch.as_tensor(cs.scene(B, M, seconds * FS, seed=seed)[0], device=dev)
        xt, planes, _ = ce._prepare(x, steer, cfg, tc, "rank1")
        Z = ce._analysis_planes(xt, cfg.stft)
        return Z, ce._smoothed_power(Z, cfg.mvdr.mcra.b).contiguous(), planes

    srp_cfg = SrpConfig()
    Y = torch.movedim(torch.movedim(analysis(torch.as_tensor(cs.doa_scene(8, M, 4 * FS, seed=13), device=dev),
                                             srp_cfg.stft), -3, -1), -3, 0)
    y2 = cr.whitened_rows(Y).contiguous()
    G = cr.pack_grid(srp_steering_grid(srp_cfg, ArrayGeometry.linear(M, 0.032)), dev)
    gate_k2 = (*lanes(8, 1, 1, nog, 25), nog, 25, "rank1")
    main_k2 = (*lanes(64, 4, 2, bench, 50), bench, 50, "rank1")
    want_k2 = ce.enhance_lanes_plain(*gate_k2)
    want_k10 = cr.srp_spectrum_plain(y2, G)
    torch.cuda.synchronize()

    ok = True
    for label in labels:
        with use(libs, label):
            for name, got, want, tol in (("K2", ce.enhance_lanes(*gate_k2), want_k2, cs.TIGHT),
                                         ("K10", cr.srp_spectrum(y2, G), want_k10, cs.SRP_GATE)):
                torch.cuda.synchronize()
                rel = cs.rel_err(got, want)[0]
                good = rel < tol and bool(torch.isfinite(got).all())
                ok = ok and good
                print(f"{'ok' if good else 'FAILED'}: {label} {name} vs plain: rel {rel:.3e} < {tol:g}", flush=True)

    cases = {"K2": (ce.enhance_lanes, main_k2), "K10": (cr.srp_spectrum, (y2, G))}
    times = {(label, name): [] for label in labels for name in cases}
    for order in (labels, labels[::-1]):
        for label in order:
            with use(libs, label):
                for name, (fn, a) in cases.items():
                    times[label, name].append(benchmark(fn, *a)["per_call_s"] * 1e3)
    med = {}
    for (label, name), v in times.items():
        med[f"{name} {label}"] = float(np.median(v))
        print(f"{name} {label}: {med[f'{name} {label}']:.3f} ms/call (runs {v}) [{card}]", flush=True)
    print(json.dumps({"card": card, "ms": med}))
    return 0 if ok else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
