"""K7, ``aec_kernel``: the AEC frame recursion of ``respeaker4_full_stack``
over whole utterances, the mics of an utterance sharing its far end.

Bytes: the pre-emphasised far end and mics read once, the echo-free mics
written once.  Operations: each transform as a real FFT, 1 + M (3 + 2
num_block) a frame (the far end's analysis once an utterance-frame), plus
the elementwise work of a frame as the reference's loop counts it, per
element, the far end's share apart from each mic's.  Divided by the peaks
of ``peaks.py``.
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
def _elementwise(cfg_key: str):
    """(the far end's, one mic's) elementwise operations a frame."""
    cfg = json.loads(cfg_key)
    hop = cfg["aec"]["filter_len"] // cfg["aec"]["num_block"]
    gen = torch.Generator().manual_seed(0)
    far = torch.randn((1, 3 * hop), generator=gen, dtype=torch.float64)
    x = torch.randn((1, 2, 3 * hop), generator=gen, dtype=torch.float64)
    m1, m2 = (frame_ops(lambda n: ref.aec(far[:, : n * hop], x[:, :m, : n * hop], cfg, Precision()), 3) for m in (1, 2))
    return m1 - (m2 - m1), m2 - m1


def work(batch: dict, cfg: dict):
    """(operations, bytes) of one launch on the batch {"x": [B, M, S], ...}."""
    B, M, S = batch["x"].shape
    a = cfg["aec"]
    hop = a["filter_len"] // a["num_block"]
    T = S // hop
    far_ops, mic_ops = _elementwise(json.dumps(cfg, sort_keys=True))
    ops = B * T * (1 + M * (3 + 2 * a["num_block"])) * real_fft_ops(2 * hop) + B * T * (far_ops + M * mic_ops)
    return ops, 4 * (B * T * hop + 2 * B * M * T * hop)

