"""K4, ``fused_enhance_full_kernel``: the whole of ``ami8_mvdr_omlsa`` in
one kernel, waveform in and waveform out.

Bytes: the waveform read once and the output written once.  Operations:
each analysis transform (M a frame) and each synthesis transform (one a
frame, with hop scalings and overlap-adds) as a real FFT, plus the lanes'
recursion as the reference's frame counts it, where the covariance gate of
this input is open or closed (a closed lane skips the update and the
solve).  Divided by the peaks of ``peaks.py``.
"""

from __future__ import annotations

import copy
import functools
import json

import torch

from portbench.reference import ami8_mvdr_omlsa as ref
from portbench.reference.plain import bin_masks, dft, freq_smooth, mcra_frame, mcra_state, sqrt_hann
from portbench.roofline.count import counted
from portbench.roofline.peaks import real_fft_ops


@functools.lru_cache(maxsize=None)
def _lane_ops(M: int, cfg_key: str) -> dict:
    """Elementwise operations a lane-frame, counted by running the
    reference's frame on 3 lanes (first, interior and last bin) of one
    utterance past MCRA's forcing: {"open_ldl", "open_rank1", "closed"}."""
    cfg = json.loads(cfg_key)
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.rand(s, generator=gen, dtype=torch.float64) + 0.5
    t = 2 * cfg["mcra"]["L"] + 9  # steady, and not a chunk start at t_chunk 64
    frame = {}
    for mode in ("ldl", "rank1"):
        c = dict(copy.deepcopy(cfg), inv_mode=mode, t_chunk=64)
        st = ref.lane_state(M, rnd(1, 3))
        st["Rr"] = [[rnd(1, 3) for _ in range(M)] for _ in range(M)]
        st["Ri"] = [[rnd(1, 3) for _ in range(M)] for _ in range(M)]
        st["Ld"] = rnd(1, 3)
        st["mcra"] = {k: rnd(1, 3) for k in st["mcra"]}
        frame[mode] = counted(ref.frame, t, rnd(M, 2, 1, 3), rnd(1, 3), rnd(M, 2, 3), st, bin_masks(3, "cpu"), c)
    z = [rnd(1, 3) for _ in range(M)]
    R = lambda: [[rnd(1, 3) for _ in range(M)] for _ in range(M)]
    mv = cfg["mvdr"]
    upd = {}
    for gate in (None, z[0] > 0):
        upd["ldl", gate is None] = counted(ref._update_ldl, z, z, gate, z, z, R(), R(), list(z), list(z), M,
                                           mv["alpha_v"], mv["diag"], mv["rel_diag"])
        upd["rank1", gate is None] = counted(ref._update_rank1, z, z, gate, z, z, R(), R(), list(z), list(z), M,
                                             mv["alpha_v"], z[0])
    closed = frame["ldl"] - upd["ldl", False]
    return {"open_ldl": closed + upd["ldl", True],
            "open_rank1": frame["rank1"] - upd["rank1", False] + upd["rank1", True], "closed": closed}


def lane_ops(M: int, cfg: dict) -> dict:
    return _lane_ops(M, json.dumps(cfg, sort_keys=True))


def open_gates(x: torch.Tensor, cfg: dict):
    """Lane-frames whose covariance gate opens in the warm-up (exact LDL^H)
    and the steady (rank-1) phases, and all lane-frames, from the
    reference's MCRA on mic 0 of x [B, M, S]."""
    n_fft, hop = cfg["stft"]["n_fft"], cfg["stft"]["hop"]
    mv, mc = cfg["mvdr"], cfg["mcra"]
    x0 = x[:, 0].to(torch.float64)
    B, S = x0.shape
    T, F = S // hop, n_fft // 2 + 1
    C, Sn = (torch.as_tensor(m, device=x.device) for m in dft(n_fft, sqrt_hann(n_fft)))
    blocks = torch.nn.functional.pad(x0[:, : T * hop], (hop, 0)).reshape(B, T + 1, hop)
    re = blocks[:, :-1] @ C[:hop] + blocks[:, 1:] @ C[hop:]
    im = blocks[:, :-1] @ Sn[:hop] + blocks[:, 1:] @ Sn[hop:]
    Y = (re * re + im * im).transpose(0, 1)  # [T, B, F]
    Sf = freq_smooth(Y, mc["b"])
    st, bins = mcra_state((B, F), Y), bin_masks(F, x.device)
    warm = max(1, -(-ref.WARM_FRAMES // cfg["t_chunk"])) * cfg["t_chunk"] if cfg["inv_mode"] == "rank1" else T
    n_warm = n_steady = 0
    for t in range(T):
        p, _, sr = mcra_frame(t, Y[t], Sf[t], st, bins, mc)
        gate = p < mv["p_vad"]
        if mv["vad_guard"]:
            gate = gate & (sr <= mc["delta_s"])
        n = int(gate.sum())
        n_warm, n_steady = (n_warm + n, n_steady) if t < warm else (n_warm, n_steady + n)
    return n_warm, n_steady, B * T * F


def work(batch: dict, cfg: dict):
    """(operations, bytes) of one launch on the batch {"x": [B, M, S]}."""
    x = batch["x"]
    B, M, S = x.shape
    n_fft, hop = cfg["stft"]["n_fft"], cfg["stft"]["hop"]
    T = S // hop
    ops = lane_ops(M, cfg)
    n_warm, n_steady, n_lanes = open_gates(x, cfg)
    lanes = n_warm * ops["open_ldl"] + n_steady * ops["open_rank1"] + (n_lanes - n_warm - n_steady) * ops["closed"]
    transforms = B * M * T * real_fft_ops(n_fft) + B * T * (real_fft_ops(n_fft) + 2 * hop)
    return transforms + lanes, 4 * (x.numel() + B * T * hop)
