#!/usr/bin/env python3
"""Time the sharded runners over the cards of one host against one card.

    python3 -c "from distantspeech_tpu_torch.ops import _build; _build.build()"
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 scripts/multichip_times.py [--out FILE]

Build the kernels once first: the ranks load them.  Every rank joins the
process group that ``torch.distributed.run`` sets up (NCCL; with ``--cpu``
gloo on the CPU at 0.25 s an utterance, a rehearsal of the same code).
For each ('dp', 'fb') mesh shape that fills the world (1xN, Nx1 and, for
N even, 2xN/2) it drives each runner of ``chip_smoke.py`` phase 19 at that
phase's sizes (``SLICE_G2_SIZES``): every rank gets the whole batch and
returns the whole result.  Rank 0 also runs the runner's unsharded twin
on its own card, alone, while the other ranks wait.  Per runner and mesh:
the kernels one sharded call launches on rank 0; the sharded result's gap
to the twin's; ms/call of each, timed in turns (twin, sharded, sharded,
twin; three turns for the kernel runners and WPE), audio-s/s, the speedup
over one card and that speedup over N; the collectives of one call
(``parallel.scaling.collective_stats``, and the result's gathers).  Then
``runner_collectives()`` and ``measure_scaling()`` (the flagship scan, B=8
a dp rank, 8 mics, 0.25 s).  Rank 0 prints one JSON line, the card line
before it, and writes the JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
# of max|twin|: the same operations on other bins or rows, a float32 rounding apart, which the guarded
# flagship config (vad_guard thresholds a raw ratio) can turn into a flipped hold/update decision
GAP_BARS = {"enhance": 2e-2, "pallas": 2e-2}
GAP_BAR = 1e-3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU, 0.25 s an utterance (a rehearsal)")
    ap.add_argument("--out", default=None, help="write the JSON here (rank 0)")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    import torch.distributed as dist

    from distantspeech_tpu_torch.parallel import make_mesh
    from distantspeech_tpu_torch.parallel._shard import device_of, recording
    from distantspeech_tpu_torch.parallel.scaling import _stats, collective_stats, measure_scaling, runner_collectives

    if not args.cpu and not torch.cuda.is_available():
        print("multichip_times: no CUDA device", file=sys.stderr)
        return 2
    dist.init_process_group("gloo" if args.cpu else "nccl")
    rank, n = dist.get_rank(), dist.get_world_size()
    devices = ["cpu"] * n if args.cpu else None
    if args.cpu:
        torch.set_num_threads(1)
    seconds = 0.25 if args.cpu else None

    def sync():
        if not args.cpu:
            torch.cuda.synchronize()

    def timed(fn, x, alone: bool) -> float:
        """ms of one call on rank 0: ``alone``, the other ranks wait."""
        dist.barrier()
        sync()
        ms = float("nan")
        if rank == 0 or not alone:
            t0 = time.perf_counter()
            fn(x)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        dist.barrier()
        return ms

    shapes = [(1, n), (n, 1)] + ([(2, n // 2)] if n % 2 == 0 and n > 2 else [])
    report = {"world": n, "backend": dist.get_backend(), "runners": {}}
    for shape in shapes:
        mesh = make_mesh(*shape, devices=devices)
        dev = device_of(mesh)
        for name, (run, twin, seed, kernels) in cs.slice_g2_runners(mesh, dev).items():
            x, audio_s = cs.slice_g2_input(name, seed, dev, seconds)
            cs.reset_launches()
            with recording() as log:
                got = run(x)
            sync()
            launched = {k: v for k, v in cs.launch_counts().items() if v}
            entry = {"launched": launched}
            if not args.cpu and launched != kernels:
                raise RuntimeError(f"{name} at {shape} launched {launched}, want {kernels}")
            if rank == 0:
                want = twin(x)
                pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
                gaps = [float((g.double() - w.double()).abs().max() / w.double().abs().max()) for g, w in pairs]
                bar = GAP_BARS.get(name, GAP_BAR)
                if max(gaps) > bar:
                    raise RuntimeError(f"{name} at {shape}: gaps to the unsharded twin {gaps} > {bar}")
                entry["gap"] = max(gaps)
            t_twin, t_run = [], []
            for _ in range(3 if name in ("mega", "pallas", "tdgsc", "wpe") else 1):
                for fn, acc, alone in ((twin, t_twin, True), (run, t_run, False), (run, t_run, False),
                                       (twin, t_twin, True)):
                    acc.append(timed(fn, x, alone))
            ms_twin, ms_run = float(np.median(t_twin)), float(np.median(t_run))
            entry.update(ms=ms_run, twin_ms=ms_twin, audio_s_per_s=audio_s / ms_run * 1e3,
                         twin_audio_s_per_s=audio_s / ms_twin * 1e3, speedup=ms_twin / ms_run,
                         efficiency=ms_twin / ms_run / n, turns=[round(t, 3) for t in t_run],
                         twin_turns=[round(t, 3) for t in t_twin], collectives=collective_stats(log),
                         output=_stats([e for e in log if e["where"] == "output"]))
            report["runners"][f"{name}@{shape[0]}x{shape[1]}"] = entry
            if rank == 0:
                print(f"{name} {shape[0]}x{shape[1]}: sharded {ms_run:.3f} ms, one card {ms_twin:.3f} ms, speedup "
                      f"{ms_twin / ms_run:.3f} (efficiency {ms_twin / ms_run / n:.3f}), gap {entry['gap']:.3e}, "
                      f"launched {launched}, collectives {entry['collectives']}", flush=True)
    report["runner_collectives"] = runner_collectives(device=devices[0] if devices else None)
    report["measure_scaling"] = measure_scaling(seconds=0.25, iters=3, device=devices[0] if devices else None)
    if rank == 0:
        card = "cpu" if args.cpu else subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        report["card"] = card
        text = json.dumps(report)
        if args.out:
            Path(args.out).write_text(text)
        print(card)
        print(text)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
