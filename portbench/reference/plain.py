"""Plain building blocks shared by the references: precision, array
geometry, DFT matrices, MCRA, causal FIR and overlap-add.

Everything here is plain PyTorch or NumPy written from the published
descriptions the configurations name (the sqrt-Hann STFT with the hop / W0
synthesis scale, Cohen and Berdugo's MCRA, far-field steering).  It imports
nothing of the program under test: a reference works out every table,
filter and steering vector itself from the configuration file.

``Precision`` selects how a reference computes.  ``float64`` is the
reference.  The others are the controls, the reference in a lower
precision: ``bfloat16`` (every tensor in bfloat16) and ``tf32`` (float32,
with the operands of every matrix product rounded to TF32's 10-bit
mantissa, round to nearest, ties away, and the products accumulated in
float32, as the tensor cores do).  TF32 is emulated, so that a control runs
the same on any device and never depends on a global switch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PRECISIONS = ("float64", "tf32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "float64"

    def __post_init__(self):
        if self.name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.name!r}")

    @property
    def dtype(self) -> torch.dtype:
        return {"float64": torch.float64, "bfloat16": torch.bfloat16}.get(self.name, torch.float32)

    def tensor(self, a, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a, device=device).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in this precision."""
        if self.name == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        return a @ b


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# ---- array geometry ----------------------------------------------------------


def mic_positions(array: dict) -> np.ndarray:
    """[M, 3] metres for a configuration's ``array`` entry.  A circular array
    lies in the xy plane with mic 0 on +x, the mics at whole-degree steps of
    int(360 / M) counter-clockwise."""
    if array["kind"] != "circular":
        raise ValueError(f"unknown array kind {array['kind']!r}")
    M, r = array["n_mics"], array["radius_m"]
    az = np.deg2rad(np.arange(0, 360, int(360 / M))[:M])
    return np.stack([r * np.cos(az), r * np.sin(az), np.zeros(M)], axis=-1)


def delays_s(array: dict, look_deg) -> np.ndarray:
    """Far-field arrival time of each mic relative to the origin, seconds [M]:
    -(r_m . u) / c for the unit vector u towards (azimuth, elevation)."""
    az, el = np.deg2rad(np.asarray(look_deg, dtype=np.float64))
    u = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    return -(mic_positions(array) @ u) / array["sound_speed"]


def steering(array: dict, look_deg, n_fft: int) -> np.ndarray:
    """a[k, m] = exp(-i omega_k tau_m), [n_fft / 2 + 1, M] complex128."""
    omega = 2.0 * np.pi * np.arange(n_fft // 2 + 1) * array["fs"] / n_fft
    return np.exp(-1j * omega[:, None] * delays_s(array, look_deg)[None, :])


def alignment_filters(array: dict, look_deg) -> np.ndarray:
    """Windowed-sinc fractional-delay filters that delay every mic to the
    latest arrival: [M, K] with K = 81 + ceil(largest delay in samples)."""
    tau = delays_s(array, look_deg)
    d = (tau.max() - tau) * array["fs"]
    d = d - d.min()
    L = 81
    K = L + int(np.ceil(d).max())
    taps = np.zeros((len(d), K))
    n = np.arange(L)
    for m, dm in enumerate(d):
        di = int(np.floor(dm))
        taps[m, di : di + L] = np.hanning(L) * np.sinc(n - (dm - di) - (L - 1) / 2)
    return taps


# ---- transforms ----------------------------------------------------------------


def sqrt_hann(n: int) -> np.ndarray:
    return np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n))


def synthesis_gain(n_fft: int, hop: int) -> float:
    """The reference synthesis scale hop / sum(window^2)."""
    return hop / float(np.sum(sqrt_hann(n_fft) ** 2))


def dft(n_fft: int, window=None):
    """Forward real DFT as [n_fft, F] cosine and sine matrices (X = x @ (C + iS)),
    the window folded in; the structural zeros of bins 0 and F-1 exact."""
    F = n_fft // 2 + 1
    ang = -2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(F)[None, :] / n_fft
    w = np.ones(n_fft) if window is None else window
    C, S = np.cos(ang) * w[:, None], np.sin(ang) * w[:, None]
    S[:, 0] = S[:, F - 1] = 0.0
    return C, S


def idft(n_fft: int, window=None):
    """Inverse real DFT as [F, n_fft] matrices (x = Xr @ A + Xi @ B): the
    hermitian bin weights, 1 / N and the window folded in."""
    F = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(F)[:, None] * np.arange(n_fft)[None, :] / n_fft
    scale = np.full((F, 1), 2.0 / n_fft)
    scale[0] = scale[-1] = 1.0 / n_fft
    w = np.ones(n_fft) if window is None else window
    A, Bm = np.cos(ang) * scale * w[None, :], -np.sin(ang) * scale * w[None, :]
    Bm[0] = Bm[F - 1] = 0.0
    return A, Bm


def packed_dft(n_fft: int, window=None):
    """The real DFT in the packed layout [re 0..F-1 | im 1..F-2]: (CS [n_fft,
    n_fft], AB [n_fft, n_fft]) with x @ CS the packed spectrum and
    packed @ AB the inverse."""
    C, S = dft(n_fft, window)
    A, Bm = idft(n_fft, window)
    F = n_fft // 2 + 1
    return np.concatenate([C, S[:, 1 : F - 1]], axis=1), np.concatenate([A, Bm[1 : F - 1]], axis=0)


def unpack(Z: torch.Tensor, F: int):
    """Packed [..., n_fft] -> (re, im) [..., F] with exact zero imaginary
    parts at bins 0 and F-1."""
    zero = torch.zeros_like(Z[..., :1])
    return Z[..., :F], torch.cat([zero, Z[..., F:], zero], dim=-1)


def pack(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.cat([re, im[..., 1:-1]], dim=-1)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., T, n] frames, n a multiple of hop -> [..., n + hop (T - 1)]."""
    *lead, T, n = frames.shape
    y = frames.new_zeros((*lead, n + hop * (T - 1)))
    for j in range(n // hop):
        y[..., j * hop : j * hop + T * hop] += frames[..., j * hop : (j + 1) * hop].reshape(*lead, T * hop)
    return y


def fir(x: torch.Tensor, taps: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Causal FIR from a zero state, y[n] = sum_j taps[c, j] x[c, n - j]:
    x [..., C, S], taps [C, K] (or [K] for every channel).  Blocks of Lb >=
    K - 1 samples, each output block a product of the two blocks before it
    with a Toeplitz matrix, one product a channel."""
    *lead, C, S = x.shape
    taps = taps.expand(C, -1) if taps.ndim == 1 else taps
    K = taps.shape[-1]
    Lb = 128
    while Lb < K - 1:
        Lb *= 2
    nblk = -(-S // Lb)
    xc = x.movedim(-2, 0).reshape(C, -1, S)  # [C, N, S]
    xb = torch.nn.functional.pad(xc, (Lb, nblk * Lb - S)).reshape(C, -1, nblk + 1, Lb)
    win = torch.cat([xb[..., :-1, Lb - (K - 1) :], xb[..., 1:, :]], dim=-1).reshape(C, -1, K - 1 + Lb)
    d = torch.arange(K - 1 + Lb, device=x.device)[:, None] - torch.arange(Lb, device=x.device)[None, :]
    lag = (K - 1) - d  # window row i holds x[o + i - (K-1)]: lag (K-1) - (i - o)
    T = torch.where((lag >= 0) & (lag < K), taps[:, lag.clamp(0, K - 1)], torch.zeros((), dtype=taps.dtype, device=x.device))
    y = prec.mm(win, T).reshape(C, -1, nblk * Lb)[..., :S]  # [C, N, S]
    return y.reshape(C, *lead, S).movedim(0, -2)


# ---- MCRA (Cohen & Berdugo 2002) -------------------------------------------------


def freq_smooth(Y: torch.Tensor, b) -> torch.Tensor:
    """b0 Y[k-1] + b1 Y[k] + b2 Y[k+1], the edges repeated."""
    left = torch.cat([Y[..., :1], Y[..., :-1]], dim=-1)
    right = torch.cat([Y[..., 1:], Y[..., -1:]], dim=-1)
    return b[0] * left + b[1] * Y + b[2] * right


def bin_masks(F: int, device):
    """MCRA's bin classes (interior, lead, first, last) as [F] masks: only
    bins 0 .. F-2 are tracked, and bin 0's presence is forced to 0."""
    k = torch.arange(F, device=device)
    return (k >= 1) & (k <= F - 2), k <= F - 2, k == 0, k == F - 1


def mcra_state(shape, like: torch.Tensor) -> dict:
    z = like.new_zeros(shape)
    return dict(S=z, Smin=z, Stmp=z, P=z, Lam=z)


def mcra_frame(t: int, Yp, Sf_t, st: dict, bins, mc: dict):
    """MCRA at frame t on lanes [..., F] (power Yp, its cross-bin smoothing
    Sf_t): frame 0 seeds the minima and the noise PSD with the power; the
    minima window restarts at t % L == L - 1; presence is forced to 0 for
    t < 2L; bin F-1's noise PSD is pinned to 1e-8 before each update.
    Updates ``st``; returns (p, lambda_d, S / Smin)."""
    interior, lead, first, last = bins
    if t == 0:
        S = st["S"]
        Smin = torch.where(lead, Yp, st["Smin"])
        Stmp = torch.where(lead, Yp, st["Stmp"])
        p_sel = torch.where(lead, torch.zeros_like(Yp), st["P"])
        lam_pre = torch.where(lead, Yp, st["Lam"])
    else:
        S = torch.where(interior, mc["alpha_s"] * st["S"] + (1.0 - mc["alpha_s"]) * Sf_t, st["S"])
        Smin1 = torch.minimum(st["Smin"], S)
        Stmp1 = torch.minimum(st["Stmp"], S)
        if t % mc["L"] == mc["L"] - 1:
            Smin1, Stmp1 = torch.minimum(Stmp1, S), S
        Smin = torch.where(interior, Smin1, st["Smin"])
        Stmp = torch.where(interior, Stmp1, st["Stmp"])
        if t < 2 * mc["L"]:
            p_upd = torch.zeros_like(Yp)
        else:
            ind = (S / (Smin + 1e-6) > mc["delta_s"]).to(Yp.dtype)
            p_upd = mc["alpha_p"] * st["P"] + (1.0 - mc["alpha_p"]) * ind
        p_sel = torch.where(first, torch.zeros_like(Yp), torch.where(interior, p_upd, st["P"]))
        lam_pre = st["Lam"]
    p = torch.clamp(p_sel, mc["p_min"], mc["p_max"])
    lam_pre = torch.where(last, torch.full_like(lam_pre, 1e-8), lam_pre)
    alpha_t = mc["alpha_d"] + (1.0 - mc["alpha_d"]) * p
    lam = alpha_t * lam_pre + (1.0 - alpha_t) * Yp
    st.update(S=S, Smin=Smin, Stmp=Stmp, P=p, Lam=lam)
    return p, lam, S / (Smin + 1e-6)
