"""Scaling harness: audio-seconds/s across mesh shapes.

Counterpart of ``distantspeech_tpu/parallel/scaling.py``.  It measures the
sharded flagship scan at the ('dp', 'fb') mesh shapes that fill the world
of processes this call runs in (``parallel.mesh``): one card alone, or N
ranks under ``torchrun --nproc-per-node N``.

Beyond raw throughput, each shape reports:

- ``efficiency`` (with a 1x1 baseline in the same call, so in a world of
  one): for dp (weak scaling, batch grows with devices) the per-device
  throughput relative to 1x1; for fb (strong scaling) the speedup over 1x1
  divided by devices.
- ``collectives``: count and payload bytes of every collective the call
  issued, split into once a call and once a frame, from the runners' own
  record (``parallel._shard``).  This stands in for the compiled HLO that
  JAX's ``collective_stats`` reads; the gathers that hand every rank the
  whole result (JAX leaves its output sharded) are reported apart, as
  ``output``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig
from distantspeech_tpu_torch.parallel._shard import device_of, recording, world_max
from distantspeech_tpu_torch.parallel.mesh import make_mesh
from distantspeech_tpu_torch.parallel.sharded import make_sharded_enhance
from distantspeech_tpu_torch.runtime.profiling import slope_per_iter


def _stats(entries) -> Dict[str, Dict[str, int]]:
    out: Dict[str, Dict[str, int]] = {}
    steps = {e["step"] for e in entries if e["where"] == "frame"}
    for e in entries:
        slot = out.setdefault(e["op"], {"count": 0, "bytes": 0, "count_per_step": 0, "bytes_per_step": 0})
        if e["where"] == "frame":
            slot["count_per_step"] += 1
            slot["bytes_per_step"] += e["bytes"]
        else:
            slot["count"] += 1
            slot["bytes"] += e["bytes"]
    for slot in out.values():  # frame totals -> one frame's
        for key in ("count_per_step", "bytes_per_step"):
            if slot[key]:
                slot[key] = slot[key] // len(steps) if slot[key] % len(steps) == 0 else slot[key] / len(steps)
    return out


def collective_stats(log) -> Dict[str, Dict[str, int]]:
    """Count the collectives of one call and their payload bytes, from the
    log ``parallel._shard.recording()`` collected (in JAX's place of the
    compiled HLO text).

    Ops issued inside the frame loop are reported per frame as
    ``count_per_step`` / ``bytes_per_step``; the rest, once a call, as
    ``count`` / ``bytes``.  ``bytes`` is the payload of the op's result.
    The gathers of the result itself (``where == "output"``) are left out,
    as JAX's program holds none."""
    return _stats([e for e in log if e["where"] != "output"])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_scaling(
    mesh_shapes: Optional[List[Tuple[int, int]]] = None,
    batch_per_dp: int = 8,
    n_mics: int = 8,
    seconds: float = 4.0,
    fs: int = 16000,
    iters: int = 6,
    with_collectives: bool = True,
    device=None,
) -> List[Dict]:
    """Run the sharded flagship scan at each mesh shape that fills the
    world; returns metric dicts.  ``device`` is one rank's device type
    (``None``: the cards; ``"cpu"``: a gloo world).

    ``efficiency`` semantics: dp scales the batch (weak scaling), so it is
    per-device throughput over the 1x1 baseline; fb splits a fixed problem
    (strong scaling), so it is speedup/devices.  A world of N ranks can
    only form meshes of N, so the 1x1 baseline (and with it
    ``efficiency``) comes from a world of one."""
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_shapes is None:
        mesh_shapes = [(1, 1)]
        if n_dev > 1:
            mesh_shapes += [(1, n_dev), (n_dev, 1)]
            if n_dev % 2 == 0:
                mesh_shapes.append((2, n_dev // 2))

    geom = ArrayGeometry.linear(n_mics, 0.032, fs=fs)
    S = int(fs * seconds) // 128 * 128
    results = []
    base_tput = None
    for (dp, fb) in mesh_shapes:
        if dp * fb != n_dev:
            continue
        mesh = make_mesh(dp, fb, devices=None if device is None else [device] * n_dev)
        run = make_sharded_enhance(mesh, geom, (90.0, 0.0), EnhanceConfig())
        B = batch_per_dp * dp
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.standard_normal((B, n_mics, S)).astype(np.float32), device=device_of(mesh))

        def timed(n):
            t0 = time.perf_counter()
            for _ in range(n):
                y = run(x)
            _sync(y.device)
            # the slowest rank's time, on every rank: a retry then happens on all ranks or none
            return world_max(time.perf_counter() - t0, mesh)

        timed(1)
        timed(1)
        n1 = max(1, iters // 3)
        per, _ = slope_per_iter(
            timed,
            pairs=((n1, iters), (n1 + 1, iters + 1), (n1 + 2, iters + 2)),
            min_per_iter=B * seconds / 1.0e6,
        )
        tput = B * seconds / per
        entry = {
            "mesh": f"{dp}x{fb}",
            "devices": dp * fb,
            "batch": B,
            "audio_seconds_per_s": tput,
        }
        if base_tput is None and dp * fb == 1:
            base_tput = tput
        if base_tput is not None:
            entry["efficiency"] = round(tput / (base_tput * dp * fb), 3)
            entry["scaling_mode"] = (
                "baseline" if dp * fb == 1
                else "weak(dp)" if fb == 1
                else "strong(fb)" if dp == 1
                else "mixed"
            )
        if with_collectives:
            with recording() as log:
                run(x)
            entry["collectives"] = collective_stats(log)
        results.append(entry)
    return results


def runner_collectives(n_mics: int = 4, fs: int = 16000, device=None) -> Dict[str, Dict]:
    """The collectives of every sharded runner at JAX's sizes, on a mesh of
    the whole world (dp = 2 where the world is even, the rest fb): the
    batch-dp runners (mega, fused TDGSC) must show none; the fb-sharded
    runners show their bin gathers (and the subband GSC its per-frame
    exchanges).  Each entry also gives the gathers of the result
    (``output``).  ``device`` as in ``measure_scaling``."""
    from distantspeech_tpu_torch.beamform.gsc import GscConfig
    from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig
    from distantspeech_tpu_torch.derev.wpe import WpeConfig
    from distantspeech_tpu_torch.parallel.sharded import (
        make_sharded_enhance_mega, make_sharded_enhance_pallas, make_sharded_gsc,
        make_sharded_subband_gsc, make_sharded_tdgsc_fused, make_sharded_wpe,
    )

    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    dp = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_mesh(dp, n_dev // dp, devices=None if device is None else [device] * n_dev)
    geom = ArrayGeometry.linear(n_mics, 0.032, fs=fs)
    ang = (197.0 / 180.0 * np.pi, 0.0)
    rng = np.random.default_rng(0)

    def x_of(B, C, S):
        return rng.standard_normal((B, C, S)).astype(np.float32)

    cases = {
        "enhance_scan": (make_sharded_enhance(mesh, geom, (90.0, 0.0), EnhanceConfig()),
                         x_of(2 * dp, n_mics, 128 * 8)),
        "enhance_pallas": (make_sharded_enhance_pallas(mesh, geom, (90.0, 0.0), EnhanceConfig()),
                           x_of(2 * dp, n_mics, 128 * 8)),
        "enhance_mega": (make_sharded_enhance_mega(mesh, geom, (90.0, 0.0), EnhanceConfig()),
                         x_of(8 * n_dev, n_mics, 128 * 4)),
        "tdgsc_fused": (make_sharded_tdgsc_fused(mesh, geom, ang, TdGscConfig(n_mics=n_mics)),
                        x_of(8 * n_dev, n_mics, 256 * 3)),
        "wpe": (make_sharded_wpe(mesh, WpeConfig(num_bands=64, hop=32, n_channels=2, filter_len=2, delay=2)),
                x_of(2 * dp, 2, 32 * 12)),
        "subband_gsc": (make_sharded_subband_gsc(mesh, geom, ang, SubbandGscConfig(n_mics=n_mics, frame_len=128)),
                        x_of(2 * dp, n_mics, 128 * 3)),
        "gsc": (make_sharded_gsc(mesh, geom, ang, GscConfig(n_mics=n_mics)),
                x_of(2 * dp, n_mics, 128 * 3)),
    }
    out = {}
    for name, (run, x) in cases.items():
        with recording() as log:
            run(x)
        out[name] = {"mesh": f"{dp}x{n_dev // dp}", "collectives": collective_stats(log),
                     "output": _stats([e for e in log if e["where"] == "output"])}
    return out


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description="The sharded runners' scaling and collectives, in the world this "
                                             "process belongs to (torchrun --nproc-per-node N for N cards).")
    ap.add_argument("--out", default=None, help="write the JSON artifact here")
    ap.add_argument("--cpu", action="store_true", help="a gloo world on the CPU")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else None
    if dist.is_torchelastic_launched() and not dist.is_initialized():
        dist.init_process_group("gloo" if args.cpu else "nccl")
    results = measure_scaling(device=dev)
    runners = runner_collectives(device=dev)
    n = dist.get_world_size()
    kind = "cpu" if args.cpu else torch.cuda.get_device_name()
    artifact = {
        "platform": f"{kind}-{n}dev",
        "note": ("mesh-shape sweep; efficiency is throughput / (1x1 baseline * devices), measured in a world of "
                 "one; collectives are the runners' recorded collectives of one call, count and result bytes, "
                 "ops inside the frame loop per frame; output = the gathers of the result"),
        "results": results,
        "runner_collectives": runners,
    }
    if dist.get_rank() == 0:
        text = json.dumps(artifact, indent=1)
        print(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
