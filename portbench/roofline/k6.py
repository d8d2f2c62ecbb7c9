"""K6, ``kws_kernel``: the KWS cleaner's frame recursion of
``respeaker4_full_stack`` on mics 0 and 1.

Bytes: the ANC input, the delayed desired mic and the output, once each.
Operations: 7 transforms a frame as real FFTs, plus the elementwise work
of a frame as the reference's loop counts it, per element.  Divided by
the peaks of ``peaks.py``.
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
def _elementwise(cfg_key: str) -> int:
    cfg = json.loads(cfg_key)
    L = cfg["frame_len"]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 1, 3 * L), generator=gen, dtype=torch.float64)
    return frame_ops(lambda n: ref.kws(x[0, :, : n * L], x[1, :, : n * L], cfg, Precision()), 3)


def work(batch: dict, cfg: dict):
    """(operations, bytes) of one launch on the batch {"x": [B, M, S], ...}."""
    B, _, S = batch["x"].shape
    L = cfg["frame_len"]
    T = S // L
    ops = B * T * 7 * real_fft_ops(2 * L) + B * T * _elementwise(json.dumps(cfg, sort_keys=True))
    return ops, 4 * 3 * B * T * L

