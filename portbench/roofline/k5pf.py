"""K5 with the postfilter, ``tdgsc_kernel``: the GSC frame recursion of
``respeaker4_full_stack`` (MCRA, the FLMS canceller, OM-LSA-multi and the
STFT round trip).

Bytes: the blocking-matrix signals, the delayed beam, the beam's and the
blocking matrix's STFT powers read once, the output and p written once.
Operations: 5 C + 4 transforms a frame (C = M - 1) as real FFTs, plus the
elementwise work of a frame as the reference's loop counts it, per
element.  Divided by the peaks of ``peaks.py``.
"""

from __future__ import annotations

import json
import functools

import torch

from portbench.reference import respeaker4_full_stack as ref
from portbench.reference.plain import Precision
from portbench.roofline.count import frame_ops
from portbench.roofline.peaks import real_fft_ops


@functools.lru_cache(maxsize=None)
def _elementwise(C: int, cfg_key: str) -> int:
    cfg = json.loads(cfg_key)
    L = cfg["frame_len"]
    F = L + 1
    gen = torch.Generator().manual_seed(0)
    bm = torch.randn((1, C, 3 * L), generator=gen, dtype=torch.float64)
    d = torch.randn((1, 3 * L), generator=gen, dtype=torch.float64)
    yp = torch.rand((1, 3, F), generator=gen, dtype=torch.float64) + 0.5
    up = torch.rand((1, C, 3, F), generator=gen, dtype=torch.float64) + 0.5
    run = lambda n: ref.tdgsc_frames(bm[..., : n * L], d[..., : n * L], yp[:, :n], up[:, :, :n], cfg, Precision())
    return frame_ops(run, 3)


def work(batch: dict, cfg: dict):
    """(operations, bytes) of one launch on the batch {"x": [B, M, S], ...}."""
    B, M, S = batch["x"].shape
    L = cfg["frame_len"]
    C, T, F = M - 1, S // L, L + 1
    elem = _elementwise(C, json.dumps(cfg, sort_keys=True))
    ops = B * T * (5 * C + 4) * real_fft_ops(2 * L) + B * T * elem
    nbytes = 4 * (B * C * T * L + B * T * L + B * T * F + B * C * T * F + B * T * L + B * T * F)
    return ops, nbytes

