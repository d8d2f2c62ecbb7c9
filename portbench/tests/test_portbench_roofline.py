"""Each roofline count against a count by hand at a tiny shape."""

import math

import torch

from portbench.harness import spec
from portbench.roofline import k4, k5pf, k6, k7, peaks
from portbench.roofline.count import counted, frame_ops

RS = spec.load_cell("respeaker4.fused.b16").config
AMI = spec.load_cell("ami8.mega.b16").config


def fft(n):
    return 2.5 * n * math.log2(n) + n


def test_counter_counts_elementwise_calls_and_elements():
    a, b = torch.ones(2, 3), torch.ones(2, 3)
    f = lambda: torch.clamp(a * b + a, min=0.0).sum()
    assert counted(f) == 3  # mul, add, clamp; the matrix products and reductions are not calls counted
    assert counted(f, per_element=True) == 3 * 6 + 6  # and the sum, one an input element


def test_peaks_and_bound():
    assert peaks.real_fft_ops(256) == 2.5 * 256 * 8 + 256
    assert peaks.bound_s(67e12, 0) == 1.0 and peaks.bound_s(0, 3.35e12) == 1.0


def test_k6_by_hand():
    L = RS["frame_len"]
    F = L + 1
    # a frame: the power recursion 7F, two filtered outputs 6F each, the error L, the
    # gradient 8F, the tap step 2L, the cleaned output L, and the input's analysis
    # (two half-frame products added) 2L
    elem = 7 * F + 6 * F + L + 8 * F + 2 * L + 6 * F + L + 2 * L
    assert k6._elementwise(k6.json.dumps(RS, sort_keys=True)) == elem
    B, S = 3, 5 * L
    ops, nbytes = k6.work({"x": torch.zeros(B, 4, S)}, RS)
    assert ops == B * 5 * (7 * fft(2 * L) + elem) and nbytes == 4 * 3 * B * S


def test_k7_by_hand_apart_from_its_frame():
    hop = RS["aec"]["filter_len"] // RS["aec"]["num_block"]
    far, mic = k7._elementwise(k7.json.dumps(RS, sort_keys=True))
    assert far > 0 and mic > far
    B, M, T = 2, 4, 7
    ops, nbytes = k7.work({"x": torch.zeros(B, M, T * hop)}, RS)
    assert ops == B * T * (1 + M * (3 + 2 * 2)) * fft(2 * hop) + B * T * (far + M * mic)
    assert nbytes == 4 * (B * T * hop + 2 * B * M * T * hop)


def test_k5pf_by_hand_apart_from_its_frame():
    L = RS["frame_len"]
    F, C, B, T = L + 1, 3, 2, 6
    elem = k5pf._elementwise(C, k5pf.json.dumps(RS, sort_keys=True))
    ops, nbytes = k5pf.work({"x": torch.zeros(B, C + 1, T * L)}, RS)
    assert ops == B * T * (5 * C + 4) * fft(2 * L) + B * T * elem
    assert nbytes == 4 * B * T * (C * L + L + F + C * F + L + F)  # bm, d, yp, up in; out, p out


def test_k4_by_hand_apart_from_its_lanes():
    B, M, T, hop = 2, 8, 140, AMI["stft"]["hop"]
    x = torch.randn(B, M, T * hop, generator=torch.Generator().manual_seed(0))
    ops = k4.lane_ops(M, AMI)
    assert ops["open_ldl"] > ops["open_rank1"] > ops["closed"] > 0
    n_warm, n_steady, n_lanes = k4.open_gates(x, AMI)
    assert n_lanes == B * T * 129 and 0 < n_warm + n_steady <= n_lanes
    total, nbytes = k4.work({"x": x}, AMI)
    lanes = n_warm * ops["open_ldl"] + n_steady * ops["open_rank1"] + (n_lanes - n_warm - n_steady) * ops["closed"]
    assert total == B * M * T * fft(256) + B * T * (fft(256) + 2 * hop) + lanes
    assert nbytes == 4 * (B * M * T * hop + B * T * hop)  # the waveform in, the output out


def test_frame_ops_is_the_last_frames_work():
    run = lambda n: [torch.ones(5) * 2.0 for _ in range(n)]
    assert frame_ops(run, 4) == 5
