"""A gloo world of CPU processes for the tests of the port's sharded runners.

``run_world(n, cases, tmp)`` starts n processes of this file, joined through
a ``file://`` store under ``tmp`` (no network), each with one torch thread;
every rank runs every named case of ``CASES`` in that one world and saves
its outputs; the caller gets ``{case: [rank 0's outputs, rank 1's, ...]}``.
A rank that fails or a collective that hangs past the time limit fails the
call instead of stalling it.

Each case's inputs come from ``inputs(name)`` (seeded numpy), so the test
process can hand the same arrays to the JAX runners.  The port side imports
torch and the port only.

    python tests/torch_parallel_world.py RANK N INIT_FILE OUT_DIR CASE ...
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ANGLE = (197.0 / 180.0 * np.pi, 0.0)


def inputs(name: str) -> np.ndarray:
    """The seeded input of a case family, at the sizes of the JAX package's
    ``tests/test_parallel.py`` (float64 for the scan runners)."""
    if name == "enhance":
        return np.random.default_rng(0).standard_normal((4, 4, 128 * 24))
    if name == "gsc":
        return np.random.default_rng(2).standard_normal((4, 4, 256 * 8)) * 0.1
    if name == "wpe":
        return np.random.default_rng(4).standard_normal((4, 2, 32 * 40)) * 0.1
    if name == "subband_gsc":
        return np.random.default_rng(5).standard_normal((4, 4, 128 * 6)) * 0.1
    if name == "subband_gsc_wide":
        return np.random.default_rng(5).standard_normal((4, 4, 128 * 24)) * 0.1
    if name == "pallas":
        return np.random.default_rng(3).standard_normal((4, 4, 128 * 16)).astype(np.float32)
    if name == "direct":
        rng = np.random.default_rng(11)
        B, M, S = 8, 4, 128 * 16
        env = (np.sin(2 * np.pi * 1.7 * np.arange(S) / 16000) > 0).astype(np.float32)
        return (0.3 * rng.standard_normal((B, M, S)) + env * rng.standard_normal(S)).astype(np.float32)
    if name == "mega":
        return np.random.default_rng(6).standard_normal((64, 4, 128 * 4)).astype(np.float32)
    if name == "tdgsc":
        return np.random.default_rng(7).standard_normal((64, 4, 256 * 4)).astype(np.float32)
    raise KeyError(name)


# (rel_diag, p_vad) of the direct check, as in the JAX test
DIRECT_CFGS = ((0.0, 0.4), (1e-3, 0.4), (0.0, 0.8))


def wide_band_sgsc():
    """A SubbandGscConfig whose McSpp averages q over 200-6000 Hz (bins 3
    to 95 of 129), so that the mid-band mean spans three of four bin
    shards (the default 500-2000 Hz band lies on the first), with the
    McCDR's MCRA window cut to L=3, so that q moves after 6 blocks (with the
    default L=65 the CDR holds q at 1 for 130 blocks)."""
    from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig
    from distantspeech_tpu_torch.noise.mccdr import McCdrConfig
    from distantspeech_tpu_torch.noise.mcspp import McSppConfig

    class Cdr(McCdrConfig):
        @property
        def mcra(self):
            return dataclasses.replace(super().mcra, L=3)

    class WideSpp(McSppConfig):
        @property
        def qband(self):
            return int(200 * self.nfft / 16000), int(6000 * self.nfft / 16000)

        @property
        def mccdr(self):
            return Cdr(nfft=self.nfft, n_channels=min(4, self.n_channels))

    class WideSgsc(SubbandGscConfig):
        @property
        def spp(self):
            return WideSpp(nfft=self.frame_len * 2, n_channels=self.n_mics)

    return WideSgsc


def _mesh(shape):
    from distantspeech_tpu_torch.parallel import make_mesh

    import torch.distributed as dist

    return make_mesh(*shape, devices=["cpu"] * dist.get_world_size())


def _case(name: str) -> dict:
    """Run one case on this rank: the sharded runner's output (and, where
    the case says, the port's unsharded path on the same rank)."""
    import torch

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.parallel import sharded

    family, _, shape = name.partition("@")
    shape = tuple(int(v) for v in shape.split("x")) if shape else None
    cpu = dict(device="cpu")
    out = {}
    if family == "enhance":
        from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process

        x, geom = inputs("enhance"), ArrayGeometry.linear(4, 0.032)
        out["y"] = sharded.make_sharded_enhance(_mesh(shape), geom, (90.0, 0.0), EnhanceConfig())(x)
        out["single"] = enhance_process(x, geom, (90.0, 0.0), EnhanceConfig(), **cpu)
    elif family == "gsc":
        from distantspeech_tpu_torch.beamform.gsc import GscConfig, gsc_process

        x, geom, cfg = inputs("gsc"), ArrayGeometry.circular(4, 0.032), GscConfig(n_mics=4, frame_len=256)
        out["y"] = sharded.make_sharded_gsc(_mesh(shape), geom, ANGLE, cfg)(x)
        out["single"] = gsc_process(x, geom, ANGLE, cfg, **cpu)
    elif family == "wpe":
        from distantspeech_tpu_torch.derev.wpe import WpeConfig, wpe_process

        x, cfg = inputs("wpe"), WpeConfig(num_bands=64, hop=32, n_channels=2, filter_len=2, delay=2)
        out["y"] = sharded.make_sharded_wpe(_mesh(shape), cfg)(x)
        out["single"] = wpe_process(x, cfg, **cpu)
    elif family == "subband_gsc":
        from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig, subband_gsc_process

        x, geom, cfg = inputs("subband_gsc"), ArrayGeometry.circular(4, 0.032), SubbandGscConfig(n_mics=4, frame_len=128)
        out["y"] = sharded.make_sharded_subband_gsc(_mesh(shape), geom, ANGLE, cfg)(x)
        out["single"] = subband_gsc_process(x, geom, ANGLE, cfg, **cpu)[0]
    elif family == "subband_gsc_wide":
        from distantspeech_tpu_torch.beamform.subband_gsc import subband_gsc_process

        x, geom = inputs("subband_gsc_wide"), ArrayGeometry.circular(4, 0.032)
        cfg = wide_band_sgsc()(n_mics=4, frame_len=128)
        out["y"] = sharded.make_sharded_subband_gsc(_mesh(shape), geom, ANGLE, cfg)(x)
        out["single"] = subband_gsc_process(x, geom, ANGLE, cfg, **cpu)[0]
    elif family == "pallas":
        from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process

        x, geom = inputs("pallas"), ArrayGeometry.linear(4, 0.032)
        out["y"] = sharded.make_sharded_enhance_pallas(_mesh(shape), geom, (90.0, 0.0), EnhanceConfig())(x)
        out["single"] = enhance_process(x, geom, (90.0, 0.0), EnhanceConfig(), **cpu)
        out["pallas"] = enhance_process(x, geom, (90.0, 0.0), EnhanceConfig(), backend="pallas", **cpu)
    elif family == "direct":
        from distantspeech_tpu_torch.array.steering import steering_vector
        from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig
        from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig
        from distantspeech_tpu_torch.ops.cuda_enhance import fused_enhance, fused_enhance_full

        x, geom = torch.as_tensor(inputs("direct")), ArrayGeometry.linear(4, 0.032)
        steer = steering_vector(geom, np.array([np.pi / 2, 0.0]), 256).astype(np.complex64)
        for i, (rel_diag, p_vad) in enumerate(DIRECT_CFGS):
            cfg = EnhanceConfig(mvdr=MvdrConfig(mcra_L=15, rel_diag=rel_diag, p_vad=p_vad))
            out[f"fused{i}"] = fused_enhance(x, steer, cfg)
            out[f"full{i}"] = fused_enhance_full(x, steer, cfg)
            out[f"y{i}"] = sharded.make_sharded_enhance_pallas(_mesh(shape), geom, (90.0, 0.0), cfg)(x)
    elif family == "mega":
        from distantspeech_tpu_torch.array.steering import steering_vector
        from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig
        from distantspeech_tpu_torch.ops.cuda_enhance import fused_enhance_full

        x, geom = inputs("mega"), ArrayGeometry.linear(4, 0.032)
        out["y"] = sharded.make_sharded_enhance_mega(_mesh(shape), geom, (90.0, 0.0), EnhanceConfig())(x)
        steer = steering_vector(geom, np.array([np.pi / 2, 0.0]), 256).astype(np.complex64)
        out["single"] = fused_enhance_full(torch.as_tensor(x), steer, EnhanceConfig())
    elif family == "tdgsc":
        from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig
        from distantspeech_tpu_torch.ops.cuda_flms import fused_tdgsc

        x, geom, cfg = inputs("tdgsc"), ArrayGeometry.linear(4, 0.032), TdGscConfig(n_mics=4)
        out["y"], out["p"], out["bm"] = sharded.make_sharded_tdgsc_fused(_mesh(shape), geom, ANGLE, cfg)(x)
        out["single"], out["single_p"], out["single_bm"] = fused_tdgsc(torch.as_tensor(x), geom, ANGLE, cfg)
    elif family == "collectives":
        from distantspeech_tpu_torch.parallel.scaling import runner_collectives

        import json

        out["json"] = np.asarray(json.dumps(runner_collectives(device="cpu")))
    elif family == "scaling":
        from distantspeech_tpu_torch.parallel.scaling import measure_scaling

        import json

        res = measure_scaling(batch_per_dp=2, n_mics=4, seconds=0.064, iters=3, device="cpu")
        out["json"] = np.asarray(json.dumps(res))
    elif family == "mesh_errors":
        out["json"] = np.asarray(_mesh_errors())
    else:
        raise KeyError(name)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


def _mesh_errors() -> str:
    """What ``make_mesh`` refuses in a world of n: a shape that does not
    fill it, a device list of another length, and the backend of the other
    device type."""
    import json
    from unittest import mock

    import torch.distributed as dist

    from distantspeech_tpu_torch.parallel import batch_sharding, make_mesh

    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.parallel import make_sharded_enhance, make_sharded_enhance_mega

    n = dist.get_world_size()
    said = {}
    mesh = make_mesh(2, n // 2, devices=["cpu"] * n)
    geom = ArrayGeometry.linear(4, 0.032)
    for key, call in {
        "shape": lambda: make_mesh(n, 2, devices=["cpu"] * n),
        "devices": lambda: make_mesh(devices=["cpu"] * (n + 1)),
        "backend": lambda: make_mesh(devices=["cuda"] * n),  # with a card present (patched): the gloo group refuses
        "mega_batch": lambda: make_sharded_enhance_mega(mesh, geom)(np.zeros((8 * n + 4, 4, 512), np.float32)),
        "dp_batch": lambda: make_sharded_enhance(mesh, geom)(np.zeros((3, 4, 512))),
    }.items():
        try:
            with mock.patch("torch.cuda.is_available", lambda: key == "backend"):
                call()
            said[key] = None
        except (ValueError, RuntimeError) as e:
            said[key] = f"{type(e).__name__}: {e}"
    mesh = make_mesh(devices=["cpu"] * n)
    said["default"] = [list(mesh.mesh_dim_names), list(mesh.shape)]
    said["placements"] = [repr(p) for p in batch_sharding(mesh, 3)]
    return json.dumps(said)


def main(rank: int, world: int, init_file: str, out_dir: str, cases) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    for name in cases:
        t0 = time.perf_counter()
        out = _case(name)
        out["seconds"] = np.asarray(time.perf_counter() - t0)
        np.savez(Path(out_dir) / f"{name}-{rank}.npz", **out)
    dist.destroy_process_group()


def run_world(n: int, cases, tmp: Path, timeout: float = 240.0) -> dict:
    """Run ``cases`` in a gloo world of n processes; {case: [per-rank dict]}."""
    tmp.mkdir(parents=True, exist_ok=True)
    init = tmp / "init"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(n), str(init), str(tmp), *cases],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    errors = []
    try:
        for r, proc in enumerate(procs):
            try:
                _, err = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r} still running after {timeout:.0f} s (a collective that hangs?)")
                break
            if proc.returncode != 0:
                errors.append(f"rank {r} exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("\n".join(errors))
    return {c: [dict(np.load(tmp / f"{c}-{r}.npz")) for r in range(n)] for c in cases}


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5:])
