"""Driver entry points of the port: a one-card forward step and the
multi-card dry-run.

Counterpart of the JAX repository's ``__graft_entry__.py``:

- ``entry()`` returns the flagship forward step (8-mic adaptive MVDR +
  OM-LSA, the ``scan`` backend) and example arguments;
- ``dryrun_multichip(n)`` builds an n-rank ('dp', 'fb') mesh and runs one
  call of every sharded runner (utterance data parallel x frequency-bin
  model parallel, and the batch-parallel kernel runners) on JAX's tiny
  shapes.  On cards it needs n of them, one process each (NCCL); with
  ``device="cpu"`` the n ranks are CPU processes joined by gloo.  With
  n = 1 it runs in this process.

    python -m distantspeech_tpu_torch.graft_entry [--cpu] [--dryrun N]
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from distantspeech_tpu_torch._device import resolve_device

ANGLE = (197.0 / 180.0 * np.pi, 0.0)
DRYRUN_TIMEOUT_S = 600.0  # all ranks of a multi-process dry-run


def entry(device=None):
    """The flagship forward step f(x [B, 8, S]) -> [B, S] on ``device`` (the
    card by default) and its example input, (f, (x,))."""
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_init, enhance_scan
    from distantspeech_tpu_torch.transform import analysis, synthesis

    dev = resolve_device(device)
    geom = ArrayGeometry.linear(8, 0.032)
    cfg = EnhanceConfig()
    angle = np.array([90.0, 0.0]) / 180.0 * np.pi
    steer = np.asarray(steering_vector(geom, angle, cfg.stft.n_fft), dtype=np.complex64)

    def forward(x):
        x = torch.as_tensor(x, device=dev)
        X = analysis(x, cfg.stft)  # [B, M, T, F]
        Zt = torch.movedim(torch.movedim(X, -3, -1), -3, 0)
        state = enhance_init(cfg, geom.n_mics, batch_shape=Zt.shape[1:-2], cdtype=Zt.dtype, device=dev)
        _, Y = enhance_scan(cfg, torch.as_tensor(steer, device=dev).to(Zt.dtype), state, Zt)
        return synthesis(torch.movedim(Y, 0, -2), cfg.stft)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 128 * 32)).astype(np.float32)
    return forward, (x,)


def _dryrun_steps(n_devices: int, device) -> None:
    """``__graft_entry__.dryrun_multichip``'s steps in this rank, at JAX's
    shapes: every runner once, its output's shape checked."""
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig
    from distantspeech_tpu_torch.beamform.gsc import GscConfig
    from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig
    from distantspeech_tpu_torch.derev.wpe import WpeConfig
    from distantspeech_tpu_torch.parallel import (
        make_mesh, make_sharded_enhance, make_sharded_enhance_mega, make_sharded_enhance_pallas, make_sharded_gsc,
        make_sharded_subband_gsc, make_sharded_tdgsc_fused, make_sharded_wpe,
    )

    def expect(y, shape):
        if tuple(y.shape) != shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"dryrun: got {tuple(y.shape)} (finite: {bool(torch.isfinite(y).all())}), want {shape}")

    n_dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_fb = n_devices // n_dp
    mesh = make_mesh(n_dp, n_fb, devices=None if device is None else [device] * n_devices)

    geom = ArrayGeometry.linear(4, 0.032)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2 * n_dp, 4, 128 * 8)).astype(np.float32)
    expect(make_sharded_enhance(mesh, geom, (90.0, 0.0), EnhanceConfig())(x), (2 * n_dp, 128 * 8))
    # the MCRA pre-scan and K1 on each bin shard
    expect(make_sharded_enhance_pallas(mesh, geom, (90.0, 0.0), EnhanceConfig())(x), (2 * n_dp, 128 * 8))

    # the state-heavy pipelines: bin-sharded RLS-WPE and the subband GSC
    wcfg = WpeConfig(num_bands=64, hop=32, n_channels=2, filter_len=2, delay=2)
    xw = rng.standard_normal((2 * n_dp, 2, 32 * 12)).astype(np.float32)
    expect(make_sharded_wpe(mesh, wcfg)(xw), (2 * n_dp, 32 * 12))
    gcfg = SubbandGscConfig(n_mics=4, frame_len=128)
    xg = (rng.standard_normal((2 * n_dp, 4, 128 * 3)) * 0.1).astype(np.float32)
    expect(make_sharded_subband_gsc(mesh, geom, ANGLE, gcfg)(xg), (2 * n_dp, 128 * 3))
    # the frequency-domain GSC (MC-MCRA state sharded over (dp, fb))
    expect(make_sharded_gsc(mesh, geom, ANGLE, GscConfig(n_mics=4))(xg), (2 * n_dp, 128 * 3))

    # K4 in rank-1 mode, batch-sharded over every mesh axis: 96 frames, so
    # the Bennett steady branch and its re-anchor run after the warmup
    B6 = 8 * n_devices
    x6 = rng.standard_normal((B6, 4, 128 * 96)).astype(np.float32)
    expect(make_sharded_enhance_mega(mesh, geom, (90.0, 0.0), EnhanceConfig(), inv_mode="rank1")(x6), (B6, 128 * 96))
    # K5, likewise batch-sharded
    x7 = rng.standard_normal((B6, 4, 256 * 3)).astype(np.float32)
    y7, _, _ = make_sharded_tdgsc_fused(mesh, geom, cfg=TdGscConfig(n_mics=4))(x7)
    expect(y7, (B6, 256 * 3))


def _rank_main(rank: int, n_devices: int, device, init_file: str) -> None:
    torch.set_num_threads(1)
    backend = "gloo" if device == "cpu" else "nccl"
    if device is None:
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=n_devices)
    try:
        _dryrun_steps(n_devices, device)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One call of every sharded runner over an n-rank mesh (module doc).
    Raises if a rank fails or the ranks outlast ``DRYRUN_TIMEOUT_S``."""
    if device is None:
        resolve_device(None)
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards, found "
                               f"{torch.cuda.device_count()}")
    elif torch.device(device).type != "cpu":
        raise ValueError(f"device must be None (the cards) or 'cpu', got {device!r}")
    else:
        device = "cpu"
    if n_devices == 1:
        _dryrun_steps(1, device)
        return
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, device, init)) for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if failed:
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {failed} failed or timed out")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo ranks) instead of the cards")
    ap.add_argument("--dryrun", type=int, default=0, help="run dryrun_multichip over this many ranks")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else None
    if args.dryrun:
        dryrun_multichip(args.dryrun, device=dev)
        print(f"dryrun_multichip({args.dryrun}) ok")
    else:
        fn, fargs = entry(dev)
        out = fn(*fargs)
        print("entry ok", tuple(out.shape))
