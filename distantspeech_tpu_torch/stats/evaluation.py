"""Signal-quality evaluation metrics.

Counterpart of ``distantspeech_tpu/stats/evaluation.py``, a numpy copy:
these score outputs on the host after they leave the device.  The
objective metrics are always available; the perceptual ones wrap optional
packages (``pesq``, ``pystoi``) and raise ``ImportError`` when they are
absent.
"""

from __future__ import annotations

import numpy as np


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR in dB (Le Roux et al. 2019), mean-removed."""
    n = min(len(est), len(ref))
    est = np.asarray(est[:n], dtype=np.float64)
    ref = np.asarray(ref[:n], dtype=np.float64)
    est = est - est.mean()
    ref = ref - ref.mean()
    a = float(np.dot(est, ref) / np.maximum(np.dot(ref, ref), 1e-20))
    num = np.sum((a * ref) ** 2)
    den = np.maximum(np.sum((est - a * ref) ** 2), 1e-20)
    return float(10.0 * np.log10(np.maximum(num, 1e-20) / den))


def best_aligned_si_sdr(est: np.ndarray, ref: np.ndarray, max_lag: int = 1024) -> float:
    """SI-SDR maximised over a two-sided lag search: enhanced outputs lag
    their references by an unknown pipeline-dependent number of samples
    (RIR delay + transform latency), and trimming conventions can also make
    the estimate lead.  Lags that would leave no overlap are skipped.

    ``max_lag`` must cover the largest pipeline latency being scored: the
    subband GSC delays its FBF path by a full frame before the AIC and the
    n_fft=512 STFT round trip adds another 256, so its output lags ~512
    samples; a merely delayed output scored at a lag that does not cover it
    reads as decorrelated."""
    n = min(len(est), len(ref))
    best = -np.inf
    for l in range(min(max_lag, n)):
        # est delayed by l samples relative to ref ...
        best = max(best, si_sdr(est[l:], ref[: len(ref) - l] if l else ref))
        # ... and est leading ref by l samples
        if l:
            best = max(best, si_sdr(est[: len(est) - l], ref[l:]))
    return best


def snr_db(signal: np.ndarray, noise: np.ndarray) -> float:
    """Energy ratio in dB of aligned signal/noise components."""
    n = min(len(signal), len(noise))
    return float(
        10.0
        * np.log10(
            np.maximum(np.sum(np.asarray(signal[:n], np.float64) ** 2), 1e-20)
            / np.maximum(np.sum(np.asarray(noise[:n], np.float64) ** 2), 1e-20)
        )
    )


def segmental_snr_db(est: np.ndarray, ref: np.ndarray, frame: int = 256, floor=(-10.0, 35.0)) -> float:
    """Mean per-frame SNR in dB, clamped to ``floor`` like classic segSNR."""
    n = min(len(est), len(ref)) // frame * frame
    e = np.asarray(est[:n], np.float64).reshape(-1, frame)
    r = np.asarray(ref[:n], np.float64).reshape(-1, frame)
    num = np.sum(r**2, axis=1)
    den = np.maximum(np.sum((e - r) ** 2, axis=1), 1e-20)
    seg = 10.0 * np.log10(np.maximum(num, 1e-20) / den)
    return float(np.mean(np.clip(seg, *floor)))


def pesq_score(ref: np.ndarray, est: np.ndarray, fs: int = 16000) -> float:
    """PESQ (wide band) via the optional ``pesq`` package."""
    try:
        from pesq import pesq
    except ImportError as e:
        raise ImportError("pesq is not installed; use si_sdr/segmental_snr_db instead") from e
    return float(pesq(fs, np.asarray(ref), np.asarray(est), "wb"))


def stoi_score(ref: np.ndarray, est: np.ndarray, fs: int = 16000, extended: bool = False) -> float:
    """STOI via the optional ``pystoi`` package."""
    try:
        from pystoi import stoi
    except ImportError as e:
        raise ImportError("pystoi is not installed; use si_sdr/segmental_snr_db instead") from e
    return float(stoi(np.asarray(ref), np.asarray(est), fs, extended=extended))
