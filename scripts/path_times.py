#!/usr/bin/env python3
"""Time, once each, the end-to-end paths that run K4, K5, K7 and K8, in one tree.

    python3 scripts/path_times.py [--root DIR]

``--root`` is the checkout whose ``distantspeech_tpu_torch`` and
``chip_smoke.py`` are imported (default: the one holding this script), so
that two versions of the port can be timed in turns, each in its own
process, from one copy of this script.  The paths are those of
``chip_smoke.py`` at its main size, on its seeded scenes: the flagship
``enhance_process`` with ``backend="mega"`` (K4) and ``"fused"`` (K2), both
``inv_mode="rank1"``, at B=64 x 8 mics x 4 s; B2 (TDGSC ``fused``, core and
postfilter), B3 (``full_stack_process`` ``fused``: K7, K6, K5) and B4
(FDGSC ``fused``), all at B=128 x 4 mics x 4 s.  Each is timed with CUDA
events (``runtime.profiling.benchmark``).  Prints one JSON line:
{"root", "card", "ms": {path: ms a call}}.  Paired timing of two trees, in
turns, each run its own process:

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
    root = Path(ap.parse_args().root).resolve()
    import torch

    if not torch.cuda.is_available():
        print("path_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process
    from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig, fdgsc_process
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, tdgsc_process
    from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process
    from distantspeech_tpu_torch.runtime.profiling import benchmark

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, M, S = 128, 4, 4 * cs.FS
    geom, look = ArrayGeometry.linear(M, 0.032), (np.pi / 2, 0.0)
    x = torch.as_tensor(cs.scene(B, M, S, seed=4)[0], device=dev)
    far, xe, _ = cs.echo_scene(B, M, S, seed=8)
    far, xe = torch.as_tensor(far, device=dev), torch.as_tensor(xe, device=dev)
    x8 = torch.as_tensor(cs.scene(64, 8, S, seed=2)[0], device=dev)
    geom8, look8 = ArrayGeometry.linear(8, 0.032), (90.0, 0.0)
    paths = {
        "flagship mega": (enhance_process, x8, geom8, look8, EnhanceConfig(), "mega", "rank1"),
        "flagship fused": (enhance_process, x8, geom8, look8, EnhanceConfig(), "fused", "rank1"),
        "B2 core": (tdgsc_process, x, geom, look, TdGscConfig(n_mics=M), "fused"),
        "B2 pf": (tdgsc_process, x, geom, look, TdGscConfig(n_mics=M, postfilter=True), "fused"),
        "B3": (full_stack_process, xe, far, geom, look, FullStackConfig(n_mics=M), "fused"),
        "B4": (fdgsc_process, x, geom, look, FdGscConfig(n_mics=M), True, "fused"),
    }
    ms = {name: benchmark(fn, *args)["per_call_s"] * 1e3 for name, (fn, *args) in paths.items()}
    print(json.dumps({"root": str(root), "card": cs.card_line(), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
