"""Device-mesh construction for multi-card processing.

Counterpart of ``distantspeech_tpu/parallel/mesh.py``, on
``torch.distributed``: one process per device, and a ``DeviceMesh`` over
the whole world with the framework's two parallel axes

- ``dp``: data parallel over utterances;
- ``fb``: frequency-bin model parallel.  Every per-bin recursion of the
  package is independent over bins; only the MCRA 3-tap frequency
  smoothing (a 1-bin halo), global bin indices (MCRA's edge bins, the
  MC-MCRA gain's first two bins) and McSpp's mid-band mean of q cross
  bins.  The runners of ``parallel.sharded`` handle each explicitly.

The frame axis is recursive and never sharded.

CUDA devices run the NCCL backend and the CPU runs gloo; neither stands in
for the other.  Without a process group, ``make_mesh`` makes a world of one
from a local store (no network), so one card is used as JAX's one device
is.  Start N processes (``torchrun --nproc-per-node N``) for N cards.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from distantspeech_tpu_torch._device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _world_device(devices) -> torch.device:
    """This rank's card: ``devices[rank]``, or, where that names no index,
    the card of its local rank."""
    rank = dist.get_rank()
    if devices is not None and devices[rank].index is not None:
        return devices[rank]
    local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def make_mesh(n_dp: Optional[int] = None, n_fb: Optional[int] = None, devices=None) -> DeviceMesh:
    """Build a ('dp', 'fb') mesh over the processes of the world.

    With no arguments: every device goes to ``fb`` (bin sharding); pass
    ``n_dp`` to split utterance data-parallelism off the front.  ``devices``
    lists one device a rank (``["cpu"] * 4`` for a gloo world on the CPU);
    ``None`` means each rank's card, and raises where there is none.
    """
    if devices is None:
        resolve_device(None)
        device_type = "cuda"
    else:
        devices = [torch.device(d) for d in devices]
        types = {d.type for d in devices}
        if len(types) != 1 or not types <= set(BACKENDS):
            raise ValueError(f"a mesh takes devices of one type, cuda or cpu, got {sorted(types)}")
        device_type = types.pop()
        if device_type == "cuda":
            resolve_device("cuda")
    backend = BACKENDS[device_type]
    if not dist.is_initialized():
        if devices is not None and len(devices) != 1:
            raise ValueError(f"no process group for {len(devices)} devices: start one process a device "
                             "(torchrun --nproc-per-node N) and call make_mesh in each")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, but {device_type} devices need {backend}")
    n = dist.get_world_size()
    if devices is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a world of {n} processes")
    if n_dp is None and n_fb is None:
        n_dp, n_fb = 1, n
    elif n_dp is None:
        n_dp = n // n_fb
    elif n_fb is None:
        n_fb = n // n_dp
    if n_dp * n_fb != n:
        raise ValueError(f"mesh {n_dp}x{n_fb} != {n} devices")
    if device_type == "cuda":
        torch.cuda.set_device(_world_device(devices))
    return DeviceMesh(device_type, torch.arange(n).reshape(n_dp, n_fb), mesh_dim_names=("dp", "fb"))


def batch_sharding(mesh: DeviceMesh, ndim: int):
    """The DTensor placements of a time-domain batch [B, ..., S] on the mesh:
    utterances sharded over ``dp``, replicated over ``fb``."""
    if ndim < 1:
        raise ValueError(f"a batch has at least one axis, got ndim={ndim}")
    return tuple(Shard(0) if name == "dp" else Replicate() for name in mesh.mesh_dim_names)
