"""K10, ``srp_kernel``: the SRP-PHAT angle spectrum of ``reverb8_wpe_srp``
over the whitened STFT rows (every frame of every utterance) and the 1 deg
grid.

The kernel's products run on the tensor cores in 3xTF32: per (row, bin),
[Re | Im] of the row (2M values) times the packed grid (2M x 2 Theta),
three TF32 multiply-adds a product, at the card's dense TF32 rate; the
magnitudes (c0^2 + c1^2, the root and the sum: 4 operations a (row, bin,
angle)) run at its FP32 rate.  The two units work side by side, so the
least time is the larger of the two, and ``work`` returns it as operations
at the FP32 rate of ``peaks.py`` (the tensor cores' time times the FP32
peak), which ``bound_s`` divides by that peak.  An FP32 count of the
products would put the bound 2.7 times higher and let a faster K10 read
over 100%.  Bytes: the rows and the grid read once, the spectrum written
once, float32.
"""

from __future__ import annotations

from portbench.roofline.peaks import FP32_FLOPS

TF32_FLOPS = 495e12  # dense TF32 on the tensor cores, operations/s (NVIDIA's H100 SXM data sheet)


def work(batch: dict, cfg: dict):
    """(FP32-equivalent operations, bytes) of one launch on the batch {"x": [B, M, S]}."""
    B, M, S = batch["x"].shape
    s = cfg["srp"]
    R, F, Theta = B * (S // s["hop"]), s["n_fft"] // 2 + 1, 360 // s["resolution_deg"]
    tensor_core_s = 3 * 2 * R * F * (2 * Theta) * (2 * M) / TF32_FLOPS
    magnitudes = 4 * R * F * Theta
    return max(tensor_core_s * FP32_FLOPS, magnitudes), 4 * (R * F * 2 * M + F * 2 * M * 2 * Theta + R * Theta)
