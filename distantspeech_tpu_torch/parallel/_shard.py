"""The shard helpers of the sharded runners: where a rank sits on the mesh,
its share of the batch and of the bins, and every collective the runners
issue, each one recorded.

JAX annotates shardings and XLA inserts the collectives; here every
cross-rank exchange is a ``torch.distributed`` call made from this module,
and each appends ``{"op", "bytes", "where", "axis", "step"}`` to the logs
that ``recording()`` has open:

- ``op``: JAX's HLO name (``all-gather``, ``all-reduce``);
- ``bytes``: the payload of the op's result, as JAX's ``collective_stats``
  counts it (an all-gather's gathered tensor);
- ``where``: ``"call"`` (once a call), ``"frame"`` (inside the frame loop,
  ``step`` its frame) or ``"output"`` (the gathers that hand every rank the
  whole result: JAX leaves its output sharded, so its program holds none);
- ``axis``: the mesh axis, ``"fb"`` or ``"dp"``.

An exchange over an axis of size 1 moves nothing and is neither issued
nor recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List

import torch
import torch.distributed as dist

_LOGS: List[list] = []


@contextlib.contextmanager
def recording():
    """Collect the log of every collective issued inside the block."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _record(op: str, nbytes: int, where: str, axis: str, step) -> None:
    for log in _LOGS:
        log.append({"op": op, "bytes": int(nbytes), "where": where, "axis": axis, "step": step})


def device_of(mesh) -> torch.device:
    """This rank's device: the CPU of a gloo mesh, the current card of an
    NCCL one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def _as_real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def gather(t: torch.Tensor, mesh, axis: str, dim: int, where: str = "call", step=None) -> torch.Tensor:
    """The shards of ``t`` over the mesh axis, concatenated along ``dim`` in
    the axis' order (every shard has ``t``'s shape)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    src = _as_real(t.contiguous())
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.get_group(axis))
    if t.is_complex():
        parts = [torch.view_as_complex(p) for p in parts]
    out = torch.cat(parts, dim=dim)
    _record("all-gather", out.numel() * out.element_size(), where, axis, step)
    return out


def all_reduce_sum(t: torch.Tensor, mesh, axis: str, where: str = "frame", step=None) -> torch.Tensor:
    """The sum of ``t`` over the mesh axis, on every rank of it."""
    if axis_size(mesh, axis) == 1:
        return t
    out = t.clone()
    dist.all_reduce(_as_real(out), group=mesh.get_group(axis))
    _record("all-reduce", out.numel() * out.element_size(), where, axis, step)
    return out


def world_max(value: float, mesh) -> float:
    """The largest of every rank's ``value``: a harness's timing, agreed on
    so that every rank takes the same decisions and so issues the same
    collectives.  Not a runner's exchange, so not recorded."""
    if mesh.size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device_of(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def batch_rows(B: int, mesh, axes) -> slice:
    """This rank's utterances of a batch of B split over ``axes`` (the first
    axis outermost).  B must divide evenly."""
    n = math.prod(axis_size(mesh, a) for a in axes)
    if B % n:
        raise ValueError(f"a batch of {B} utterances does not split over {'x'.join(axes)} = {n} ranks")
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
    rows = B // n
    return slice(idx * rows, (idx + 1) * rows)


def gather_batch(t: torch.Tensor, mesh, axes, dim: int = 0, where: str = "output") -> torch.Tensor:
    """Undo ``batch_rows``: gather over the last axis first, then outwards."""
    for a in reversed(axes):
        t = gather(t, mesh, a, dim, where)
    return t


@dataclasses.dataclass(frozen=True)
class BinShard:
    """Rank ``j``'s share of F bins over ``n`` fb ranks.

    The bins pad up to a multiple of n (``size`` a rank, as the Pallas
    runner does); rank j owns global bins [lo, hi), which may be fewer than
    ``size`` on the last ranks.  Its working range [elo, ehi) adds up to
    ``left`` / ``right`` halo bins where they exist: a step that reads a
    neighbouring bin (MCRA's 3-tap smoothing) or a global bin index runs on
    the working range, and only the owned bins are kept."""

    F: int
    n: int
    j: int
    left: int = 0
    right: int = 0

    def __post_init__(self):
        if (self.n - 1) * self.size >= self.F:
            raise ValueError(f"{self.F} bins do not give each of {self.n} fb ranks a bin")

    @property
    def size(self) -> int:
        return -(-self.F // self.n)

    @property
    def lo(self) -> int:
        return self.j * self.size

    @property
    def hi(self) -> int:
        return min(self.lo + self.size, self.F)

    @property
    def elo(self) -> int:
        return max(self.lo - self.left, 0)

    @property
    def ehi(self) -> int:
        return min(self.hi + self.right, self.F)

    @property
    def width(self) -> int:
        """Bins of the working range."""
        return self.ehi - self.elo

    def work(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The working range of a tensor that holds all F bins."""
        return t.narrow(dim, self.elo, self.width)

    def own(self, t: torch.Tensor, dim: int, value: float = 0.0) -> torch.Tensor:
        """The owned bins of a tensor on the working range, padded with
        ``value`` to ``size``."""
        t = t.narrow(dim, self.lo - self.elo, self.hi - self.lo)
        pad = self.size - (self.hi - self.lo)
        if pad:
            shape = list(t.shape)
            shape[dim] = pad
            t = torch.cat([t, t.new_full(shape, value)], dim=dim)
        return t

    def gather(self, t: torch.Tensor, mesh, dim: int, where: str = "call", step=None) -> torch.Tensor:
        """Every rank's owned bins (``own``'s output), all F of them."""
        return gather(t, mesh, "fb", dim, where, step).narrow(dim, 0, self.F)


def bin_shard(mesh, F: int, left: int = 0, right: int = 0) -> BinShard:
    return BinShard(F, axis_size(mesh, "fb"), axis_index(mesh, "fb"), left, right)


def take_bins(tree, shard: BinShard, f_axis: int = 1):
    """The working range of every tensor leaf of a state whose bin axis is
    ``f_axis``; leaves with no such axis (host frame counters) stay."""
    if isinstance(tree, torch.Tensor):
        return shard.work(tree, f_axis) if tree.ndim > f_axis else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(take_bins(leaf, shard, f_axis) for leaf in tree))
    return tree
