"""The MCRA lane kernel, ``mcra_kernel``: MCRA over mic 0's STFT power in
``reverb8_wpe_srp``, one lane an (utterance, bin), every frame.

Bytes: the power and its 3-tap smoothing in, the noise PSD and the speech
presence out, float32, once each.  Operations: a steady frame's
elementwise work (past the 2 L frames of forced absence, not a window
restart) as the reference's ``plain.mcra_frame`` counts it, per lane.
Divided by the peaks of ``peaks.py``.
"""

from __future__ import annotations

import functools
import json

import torch

from portbench.reference.plain import bin_masks, mcra_frame, mcra_state
from portbench.roofline.count import frame_ops


@functools.lru_cache(maxsize=None)
def _lane_ops(cfg_key: str) -> float:
    cfg = json.loads(cfg_key)
    mc, F = cfg["mcra"], cfg["srp"]["n_fft"] // 2 + 1
    T = 2 * mc["L"] + 2
    power = torch.rand((T, 1, F), generator=torch.Generator().manual_seed(0), dtype=torch.float64)

    def run(n):
        st, bins = mcra_state((1, F), power[0]), bin_masks(F, power.device)
        for t in range(n):
            mcra_frame(t, power[t], power[t], st, bins, mc)

    return frame_ops(run, T) / F


def work(batch: dict, cfg: dict):
    """(operations, bytes) of one launch on the batch {"x": [B, M, S]}."""
    B, _, S = batch["x"].shape
    lanes = B * (S // cfg["srp"]["hop"]) * (cfg["srp"]["n_fft"] // 2 + 1)
    return _lane_ops(json.dumps(cfg, sort_keys=True)) * lanes, 4 * 4 * lanes
