"""WPE's RLS recursion in ``reverb8_wpe_srp`` (``derev.wpe.wpe_run``, a
torch frame loop): the least time of a call's recursion.

Operations, per (utterance, bin, frame), as complex multiply-adds of 8 real
operations each, with C channels and K = C x filter_len taps in the
regressor X: P X once (K^2; X^H P is its conjugate transpose, as P is
Hermitian); X^H (P X) (K); the Hermitian half of the rank-1 update
P - k (X^H P) (K (K + 1) / 2); e = d - W^H X (C K); the filter update
W + e* k (C K).  The normaliser, the gain's division and the division by
lambda are left out.  Bytes: the spectra in and the errors out, complex64,
once each, and the state (P and W) once.  Divided by the peaks of
``peaks.py``.
"""

from __future__ import annotations


def work(batch: dict, cfg: dict):
    """(operations, bytes) of one call's recursion on the batch {"x": [B, C, S]}."""
    B, C, S = batch["x"].shape
    w = cfg["wpe"]
    K = C * w["filter_len"]
    F, T = w["num_bands"] // 2 + 1, S // w["hop"]
    complex_macs = K * K + K + K * (K + 1) // 2 + 2 * C * K
    return 8 * complex_macs * B * F * T, 8 * (2 * B * T * F * C + B * F * (K * K + C * K))
