#!/usr/bin/env python3
"""Time, once each, the end-to-end paths of the port's kernels, and some of
its kernels alone, in one tree.

    python3 scripts/path_times.py [--root DIR] [--paths NAME ...]

``--root`` is the checkout whose ``distantspeech_tpu_torch`` and
``chip_smoke.py`` are imported (default: the one holding this script), so
that two versions of the port can be timed in turns, each in its own
process, from one copy of this script.  The paths are those of
``chip_smoke.py`` at its main size, on its seeded scenes: the flagship
``enhance_process`` with ``backend="mega"`` (K4) and ``"fused"`` (K2), both
``inv_mode="rank1"``, and B1 (``backend="pallas"``: the MCRA lane kernel,
K1), at B=64 x 8 mics x 4 s; B2 (TDGSC ``fused``, core and postfilter), B3
(``full_stack_process`` ``fused``: K7, K6, K5), B4 (FDGSC ``fused``) and B5
(the subband GSC ``fused``: its front end, K9), all at B=128 x 4 mics x
4 s; B6 (``doa.srp_process`` ``fused``: the STFT, K10, the MCRA lane
kernel) at B=8 x 8 mics x 4 s.  The kernels alone: K6 (``fused_kws``) on
the kws inputs of mics 0/1 of B3's echo scene; K1 (``fused_mvdr_scan``),
with and without the OM-LSA gain, on B1's spectra, gate and MCRA tracks,
and with the gain at 12, 16 and 32 mics (``K1 M=12`` ...); K2
(``fused_enhance``'s lane kernel) on the flagship's spectra at 8 mics
(``K2``) and at 12 and 16 (``K2 M=12`` ...), all at B=64 x 4 s; K10 (``fused_srp_spectrum``) on B6's whitened spectrum and
at 12 and 16 mics (``K10 M=12`` ...), B=8 x 4 s; as ``chip_smoke.py``
builds them.  ``--paths`` picks some of
them by name (default: the paths, not the kernels alone).  Each is timed
with CUDA events (``runtime.profiling.benchmark``).  Prints
one JSON line: {"root", "card", "ms": {path: ms a call}}.  Paired timing of
two trees, in turns, each run its own process:

    for i in $(seq 10); do python3 scripts/path_times.py --root PARENT; python3 scripts/path_times.py; done
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--paths", nargs="*", help="the paths to time (default: all)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    import torch

    if not torch.cuda.is_available():
        print("path_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process
    from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig, fdgsc_process
    from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig, subband_gsc_process
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, tdgsc_process
    from distantspeech_tpu_torch.doa.srp import SrpConfig, srp_process, srp_steering_grid
    from distantspeech_tpu_torch.noise.mcra import mcra_run
    from distantspeech_tpu_torch.ops import cuda_enhance as ce
    from distantspeech_tpu_torch.ops import cuda_flms as cf
    from distantspeech_tpu_torch.ops import cuda_mvdr as cm
    from distantspeech_tpu_torch.ops import cuda_srp as cr
    from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process
    from distantspeech_tpu_torch.runtime.profiling import benchmark
    from distantspeech_tpu_torch.transform import analysis

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, M, S = 128, 4, 4 * cs.FS
    geom, look = ArrayGeometry.linear(M, 0.032), (np.pi / 2, 0.0)
    geom8, look8 = ArrayGeometry.linear(8, 0.032), (90.0, 0.0)
    on = lambda a: torch.as_tensor(a, device=dev)
    x = lambda: on(cs.scene(B, M, S, seed=4)[0])
    echo = lambda: [on(a) for a in cs.echo_scene(B, M, S, seed=8)[:2]]

    def k6():
        kcfg = FullStackConfig(n_mics=M).kws
        xe = echo()[1]
        return (cf.kws_frames, *(a.contiguous() for a in cf._kws_inputs(cf._kws_check(xe[:, :2], kcfg), kcfg)), kcfg)

    def k1(Mk, gain=True):
        cfg, mv = EnhanceConfig(), EnhanceConfig().mvdr
        Zt = torch.movedim(torch.movedim(analysis(on(cs.scene(64, Mk, S, seed=2)[0]), cfg.stft), -3, -1), -3, 0)
        Zt = Zt.contiguous()
        lam, p, sr = mcra_run(mv.mcra, Zt[..., 0].abs() ** 2, return_sr=True)
        gate = ((p < mv.p_vad) & (sr <= mv.mcra.delta_s)).float()
        steer = on(steering_vector(ArrayGeometry.linear(Mk, 0.032), np.array([np.pi / 2, 0.0]), 256)
                   .astype(np.complex64))
        return (cm.fused_mvdr_scan, Zt, gate, steer, mv.alpha_v, mv.diag, mv.rel_diag, p if gain else None,
                lam if gain else None, cfg.alpha_xi, cfg.gmin)

    def k2(Mk):
        cfg = EnhanceConfig()
        steer = on(steering_vector(ArrayGeometry.linear(Mk, 0.032), np.array([np.pi / 2, 0.0]), 256)
                   .astype(np.complex64))
        tc = ce._pick_t_chunk(S // cfg.stft.hop) or 64
        xt, planes, _ = ce._prepare(on(cs.scene(64, Mk, S, seed=2)[0]), steer, cfg, tc, "rank1")
        Z = ce._analysis_planes(xt, cfg.stft)
        return (ce.enhance_lanes, Z, ce._smoothed_power(Z, cfg.mvdr.mcra.b).contiguous(), planes, cfg, tc, "rank1")

    def k10(Mk):
        cfg = SrpConfig()
        Y = torch.movedim(torch.movedim(analysis(on(cs.doa_scene(8, Mk, S, seed=13)), cfg.stft), -3, -1), -3, 0)
        grid = srp_steering_grid(cfg, ArrayGeometry.linear(Mk, 0.032))
        return (cr.srp_spectrum, cr.whitened_rows(Y).contiguous(), cr.pack_grid(grid, dev))

    paths = {
        "flagship mega": lambda: (enhance_process, on(cs.scene(64, 8, S, seed=2)[0]), geom8, look8, EnhanceConfig(),
                                  "mega", "rank1"),
        "flagship fused": lambda: (enhance_process, on(cs.scene(64, 8, S, seed=2)[0]), geom8, look8, EnhanceConfig(),
                                   "fused", "rank1"),
        "B1": lambda: (enhance_process, on(cs.scene(64, 8, S, seed=2)[0]), geom8, look8, EnhanceConfig(), "pallas"),
        "B2 core": lambda: (tdgsc_process, x(), geom, look, TdGscConfig(n_mics=M), "fused"),
        "B2 pf": lambda: (tdgsc_process, x(), geom, look, TdGscConfig(n_mics=M, postfilter=True), "fused"),
        "B3": lambda: (full_stack_process, *echo()[::-1], geom, look, FullStackConfig(n_mics=M), "fused"),
        "B4": lambda: (fdgsc_process, x(), geom, look, FdGscConfig(n_mics=M), True, "fused"),
        "B5": lambda: (subband_gsc_process, on(cs.scene(B, M, S, seed=11)[0]), geom, look,
                       SubbandGscConfig(n_mics=M), "fused"),
        "B6": lambda: (srp_process, on(cs.doa_scene(8, 8, S, seed=13)), geom8, SrpConfig(), True, "fused"),
    }
    kernels = {
        "K6": k6,
        "K1": lambda: k1(8),
        "K1 no gain": lambda: k1(8, gain=False),
        **{f"K1 M={m}": (lambda m=m: k1(m)) for m in (12, 16, 32)},
        "K2": lambda: k2(8),
        **{f"K2 M={m}": (lambda m=m: k2(m)) for m in (12, 16)},
        "K10": lambda: k10(8),
        **{f"K10 M={m}": (lambda m=m: k10(m)) for m in (12, 16)},
    }
    ms = {}
    for name in args.paths or list(paths):
        fn, *a = {**paths, **kernels}[name]()
        ms[name] = benchmark(fn, *a)["per_call_s"] * 1e3
        del a
    print(json.dumps({"root": str(root), "card": cs.card_line(), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
