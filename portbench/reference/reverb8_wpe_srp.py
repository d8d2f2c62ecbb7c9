"""Plain reference of ``reverb8_wpe_srp``: RLS-WPE dereverberation of every
mic in an oversampled subband domain, then SRP-PHAT localisation and MCRA
on the dereverberated signals.

Per batch x [B, C, S], everything worked out from the configuration file:

1. The Nyquist(M) prototype pair (Kumatani, McDonough, Raj et al., "Filter
   bank design based on minimization of individual aliasing terms for
   minimum mutual information subband adaptive beamforming", ICASSP 2008),
   designed as upstream's ``design_nyquist_filter.py`` designs it, for
   M = ``num_bands`` bands, length factor m and D = M / 2^r with
   r = floor(M / (2 hop)).  Analysis h [m M]: the eigenvector of the
   smallest eigenvalue of the aliasing matrix C (taps k with k % M == 0,
   k != m M / 2, held at zero).  Synthesis g [m M]: the least residual
   aliasing g^T P g under the constraints H g = C0, g = P^-1 H^T (H P^-1
   H^T)^-1 C0.
2. Analysis: frame t is the m M samples that end with hop block t (zeros
   before the signal), time reversed, windowed by h, folded into M samples
   (the sum of its m segments), then a real DFT.
3. RLS-WPE on every channel (upstream ``dereverberation/awpe.py:129-196``):
   per bin, the regressor X stacks each channel's last ``filter_len``
   spectra from ``delay`` frames back; e = d - W^H X;
   s2 = alpha_var s2 + (1 - alpha_var) |d|^2 / C; k = P X / (lambda s2 +
   X^H P X); P <- (P - k X^H P) / lambda; W <- W + e* k; P starts at
   p_init I.  The output is e.
4. Synthesis, the delay line of the polyphase bank: each frame's inverse
   real DFT, tiled m times and windowed by g, is added to the line shifted
   by one hop; the oldest hop leaves, reversed and scaled by M.
5. SRP-PHAT: the sqrt-Hann STFT (n_fft / hop of ``srp``, hop-aligned
   frames from a zero history) of every dereverberated mic, PHAT whitening
   Y / (|Y| + eps), and for each azimuth 0, 1, ..., 359 deg at elevation 0
   the sum over bins of |sum_m conj(a_theta,k,m) Y_k,m|.
6. MCRA (Cohen and Berdugo 2002, ``plain.mcra_frame``) on mic 0's power of
   that STFT.

Every complex quantity is a pair of real tensors, so that the same code
runs in float64 and in the controls' lower precisions, and every matrix
product goes through ``Precision.mm``.

Departures from the descriptions: the prototypes are designed in float64
on the host whatever ``prec`` is, as a deployment designs them once; the
analysis prototype's eigenvector is signed so that it has a positive tap;
upstream's fall-backs for a rank-deficient C or P (null-space designs) are
left out and refused, as C and P have full rank at every bank used here
(512 bands with D 128, 64 with D 16 or 32); the denominator of the WPE
gain keeps the imaginary part that rounding leaves in X^H P X, as the
program does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.plain import (
    Precision, bin_masks, delays_s, dft, freq_smooth, idft, mcra_frame, mcra_state, sqrt_hann,
)

# ---- the Nyquist(M) prototypes ---------------------------------------------------


def _full_rank(A: np.ndarray, what: str) -> None:
    if np.linalg.matrix_rank(A) != len(A):
        raise ValueError(f"{what} is rank-deficient: upstream's null-space design is not reproduced here")


def analysis_prototype(M: int, m: int, D: int) -> np.ndarray:
    """h [m M]: the analysis prototype of least inband aliasing."""
    L = M * m
    md = L / 2 if m != 1 else 0
    d = np.arange(L)[None, :] - np.arange(L)[:, None]  # j - i
    factor = np.where(d % D == 0, D - 1.0, -1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        C = np.where(d == 0, factor / D, factor * np.sin(np.pi * d / D) / (np.pi * d))
    free = (np.arange(L) == md) | (np.arange(L) % M != 0)
    Cf = C[np.ix_(free, free)]
    _full_rank(Cf, "the aliasing matrix C")
    val, vec = np.linalg.eig(Cf)
    v = vec[:, np.argmin(val)]
    v = v if np.any(v > 0) else -v
    h = np.zeros(L)
    h[free] = np.real(v)
    return h


def synthesis_prototype(h: np.ndarray, M: int, m: int, D: int) -> np.ndarray:
    """g [m M]: the synthesis prototype of least residual aliasing for h."""
    L = len(h)
    lag = np.arange(L)[:, None] - np.arange(L)[None, :]  # i - j
    acorr = np.correlate(h, h, mode="full")  # lags -(L-1) .. L-1
    factor = np.where(lag % D == 0, D - 1.0, -1.0)
    P = M / float(D * D) * factor * acorr[lag + L - 1]
    rows = 2 * m - 1
    H = np.zeros((rows, L))
    for r in range(rows):  # row r: h reversed, ending at tap (r + 1) M - 1
        hi, lo = min(max((r + 1) * M, 1), L), min(max((r + 1) * M - L + 1, 1), L)
        for j in range(lo - 1, hi):
            H[r, j] = h[hi + lo - 2 - j]
    C0 = np.zeros((rows, 1))
    C0[m - 1, 0] = D / M
    _full_rank(P, "the residual aliasing matrix P")
    Pinv = np.linalg.inv(P)
    return (Pinv @ H.T @ np.linalg.inv(H @ Pinv @ H.T) @ C0)[:, 0]


@functools.lru_cache(maxsize=4)
def prototypes(M: int, m: int, D: int):
    """(h, g), each [m M] float64; designed once a process."""
    h = analysis_prototype(M, m, D)
    return h, synthesis_prototype(h, M, m, D)


def bank(wpe: dict):
    """(M, m, D) of the configuration's subband bank."""
    M, hop = wpe["num_bands"], wpe["hop"]
    return M, wpe["m"], max(M // 2 ** int(M / hop / 2), 1)


# ---- complex arithmetic on pairs of real tensors -------------------------------------


def cmm(ar, ai, br, bi, prec: Precision):
    """(a @ b) of complex a = ar + i ai and b = br + i bi."""
    return prec.mm(ar, br) - prec.mm(ai, bi), prec.mm(ar, bi) + prec.mm(ai, br)


def cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


# ---- the stages --------------------------------------------------------------------


def analysis(x, h, M: int, m: int, hop: int, prec: Precision):
    """x [..., S] -> the subband spectra (re, im) [..., T, M / 2 + 1], T = S / hop."""
    L = M * m
    T = x.shape[-1] // hop
    xp = torch.nn.functional.pad(x, (L - hop, 0))
    frames = xp.unfold(-1, L, hop)[..., :T, :]  # frame t ends with hop block t
    folded = (frames.flip(-1) * prec.tensor(h, x.device)).reshape(*frames.shape[:-1], m, M).sum(dim=-2)
    Cm, Sm = dft(M)
    return prec.mm(folded, prec.tensor(Cm, x.device)), prec.mm(folded, prec.tensor(Sm, x.device))


def synthesis(Er, Ei, g, M: int, m: int, hop: int, prec: Precision):
    """Subband spectra (re, im) [..., T, M / 2 + 1] -> [..., T hop]."""
    A, Bm = idft(M)
    frames = prec.mm(Er, prec.tensor(A, Er.device)) + prec.mm(Ei, prec.tensor(Bm, Er.device))  # [..., T, M]
    windowed = frames.repeat(*(1,) * (frames.ndim - 1), m) * prec.tensor(g, Er.device)  # [..., T, m M]
    T = frames.shape[-2]
    line = Er.new_zeros((*Er.shape[:-2], M * m))
    out = []
    for t in range(T):
        line = torch.cat([line.new_zeros((*line.shape[:-1], hop)), line[..., :-hop]], dim=-1) + windowed[..., t, :]
        out.append(M * line[..., -hop:].flip(-1))
    return torch.cat(out, dim=-1)


def wpe(Dr, Di, w: dict, prec: Precision):
    """RLS-WPE: spectra (re, im) [B, C, T, F] -> the prediction errors, the
    same shape."""
    B, C, T, F = Dr.shape
    N, delay, lam, alpha = w["filter_len"], w["delay"], w["forgetting_factor"], w["alpha_var"]
    K = C * N
    dr, di = Dr.permute(2, 0, 3, 1), Di.permute(2, 0, 3, 1)  # [T, B, F, C]
    zero = Dr.new_zeros((B, F, C))
    Pr = (torch.eye(K, dtype=Dr.dtype, device=Dr.device) * w["p_init"]).expand(B, F, K, K)
    Pi = Dr.new_zeros((B, F, K, K))
    Wr, Wi = Dr.new_zeros((B, F, C, K)), Dr.new_zeros((B, F, C, K))
    br, bi = Dr.new_zeros((B, F, C, N)), Dr.new_zeros((B, F, C, N))
    s2 = Dr.new_zeros((B, F))
    er, ei = torch.empty_like(dr), torch.empty_like(di)
    for t in range(T):
        xr, xi = (dr[t - delay], di[t - delay]) if t >= delay else (zero, zero)
        br = torch.cat([xr[..., None], br[..., :-1]], dim=-1)  # channel c's taps, newest first
        bi = torch.cat([xi[..., None], bi[..., :-1]], dim=-1)
        Xr, Xi = br.reshape(B, F, K, 1), bi.reshape(B, F, K, 1)
        yr, yi = cmm(Wr, -Wi, Xr, Xi, prec)  # W^H X per channel: [B, F, C, 1]
        er[t], ei[t] = dr[t] - yr[..., 0], di[t] - yi[..., 0]
        s2 = alpha * s2 + (1.0 - alpha) * (dr[t] ** 2 + di[t] ** 2).sum(dim=-1) / C
        nr, ni = cmm(Pr, Pi, Xr, Xi, prec)  # P X: [B, F, K, 1]
        qr, qi = cmm(Xr.transpose(-1, -2), -Xi.transpose(-1, -2), nr, ni, prec)  # X^H P X: [B, F, 1, 1]
        den_r, den_i = lam * s2[..., None, None] + qr, qi
        mag = den_r**2 + den_i**2
        kr, ki = (nr * den_r + ni * den_i) / mag, (ni * den_r - nr * den_i) / mag  # P X / den
        hr, hi = cmm(Xr.transpose(-1, -2), -Xi.transpose(-1, -2), Pr, Pi, prec)  # X^H P: [B, F, 1, K]
        ur, ui = cmul(kr, ki, hr, hi)  # the outer product k (X^H P): [B, F, K, K]
        Pr, Pi = (Pr - ur) / lam, (Pi - ui) / lam
        gr, gi = cmul(er[t][..., :, None], -ei[t][..., :, None], kr.transpose(-1, -2), ki.transpose(-1, -2))
        Wr, Wi = Wr + gr, Wi + gi  # W[c] += e_c* k
    return er.permute(1, 3, 0, 2), ei.permute(1, 3, 0, 2)


def stft(y, n_fft: int, hop: int, prec: Precision):
    """Hop-aligned sqrt-Hann frames from a zero history: y [..., S] ->
    (re, im) [..., S / hop, n_fft / 2 + 1]."""
    T = y.shape[-1] // hop
    frames = torch.nn.functional.pad(y, (n_fft - hop, 0)).unfold(-1, n_fft, hop)[..., :T, :]
    Cm, Sm = dft(n_fft, sqrt_hann(n_fft))
    return prec.mm(frames, prec.tensor(Cm, y.device)), prec.mm(frames, prec.tensor(Sm, y.device))


def srp_phat(Yr, Yi, array: dict, s: dict, prec: Precision):
    """Spectra (re, im) [B, C, T, F] -> the angle spectrum [B, T, Theta]."""
    B, C, T, F = Yr.shape
    mag = torch.sqrt(Yr**2 + Yi**2) + s["phat_eps"]
    wr, wi = (Yr / mag, Yi / mag) if s["phat"] else (Yr, Yi)
    angles = np.arange(0, 360, s["resolution_deg"], dtype=np.float64)
    omega = 2.0 * np.pi * np.arange(F) * array["fs"] / s["n_fft"]  # [F]
    tau = np.stack([delays_s(array, (a, 0.0)) for a in angles])  # [Theta, C]
    phase = omega[:, None, None] * tau[None]  # [F, Theta, C]: a = exp(-i phase)
    ar, ai = prec.tensor(np.cos(phase), Yr.device), prec.tensor(-np.sin(phase), Yr.device)
    rows_r = wr.permute(3, 0, 2, 1).reshape(F, B * T, C)  # [F, rows, C]
    rows_i = wi.permute(3, 0, 2, 1).reshape(F, B * T, C)
    out = Yr.new_zeros((B * T, len(angles)))
    for k in range(F):  # conj(a) . y = (ar yr + ai yi) + i (ar yi - ai yr)
        zr = prec.mm(rows_r[k], ar[k].T) + prec.mm(rows_i[k], ai[k].T)
        zi = prec.mm(rows_i[k], ar[k].T) - prec.mm(rows_r[k], ai[k].T)
        out = out + torch.sqrt(zr**2 + zi**2)
    return out.reshape(B, T, len(angles))


def mcra(power, mc: dict):
    """MCRA's speech presence on lanes of power [B, T, F] -> p [B, T, F]."""
    B, T, F = power.shape
    Sf = freq_smooth(power, mc["b"])
    st, bins = mcra_state((B, F), power), bin_masks(F, power.device)
    return torch.stack([mcra_frame(t, power[:, t], Sf[:, t], st, bins, mc)[0] for t in range(T)], dim=1)


def run(inputs: dict, cfg: dict, prec: Precision = Precision()) -> dict:
    """inputs {"x": [B, C, S]} -> {"y": [B, C, S], "spectrum": [B, S / hop, Theta],
    "p": [B, S / hop, n_fft / 2 + 1]} in ``prec``."""
    w, s = cfg["wpe"], cfg["srp"]
    x = inputs["x"].to(prec.dtype)
    M, m, D = bank(w)
    h, g = prototypes(M, m, D)
    hop = w["hop"]
    x = x[..., : x.shape[-1] // hop * hop]
    Dr, Di = analysis(x, h, M, m, hop, prec)  # [B, C, T, F]
    Er, Ei = wpe(Dr, Di, w, prec)
    y = synthesis(Er, Ei, g, M, m, hop, prec)
    Yr, Yi = stft(y, s["n_fft"], s["hop"], prec)
    spectrum = srp_phat(Yr, Yi, cfg["array"], s, prec)
    p = mcra(Yr[:, 0] ** 2 + Yi[:, 0] ** 2, cfg["mcra"])
    return {"y": y, "spectrum": spectrum, "p": p}
