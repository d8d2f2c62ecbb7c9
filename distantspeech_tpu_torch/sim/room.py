"""Shoebox room simulation: image-source RIRs and SNR / SIR scene mixing.

Counterpart of ``distantspeech_tpu/sim/room.py``, which is host NumPy (a
copy, so that the port imports nothing of the JAX package): a vectorised
Allen-Berkley image-source model (every image up to ``max_order`` in one
tensor expression, band-limited fractional delays by windowed sinc,
1 / (4 pi d) spreading, reflection coefficients from the energy
absorption), an optional stochastic diffuse tail, and the SNR / SIR
mixing.  Fixture generation, not a hot path: ``sim.ism`` is the batched
torch version for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RoomConfig:
    size: Tuple[float, float, float] = (5.0, 3.0, 3.0)
    fs: int = 16000
    c: float = 343.0
    max_order: int = 3
    energy_absorption: float = 0.7
    rir_length: Optional[int] = None  # samples; default covers the longest image path

    @property
    def reflection(self) -> float:
        """Amplitude reflection coefficient from the energy absorption."""
        return float(np.sqrt(1.0 - self.energy_absorption))


def image_source_rir(
    src: np.ndarray, mics: np.ndarray, cfg: RoomConfig = RoomConfig(), sinc_width: int = 81
) -> np.ndarray:
    """RIRs from one source to each mic.  src: [3]; mics: [M, 3] -> [M, L].

    Vectorised Allen-Berkley: image positions over (order, parity) pairs per
    axis, amplitude beta^(#reflections) / (4 pi d), band-limited impulses.
    """
    src = np.asarray(src, dtype=np.float64)
    mics = np.asarray(mics, dtype=np.float64)
    Lx, Ly, Lz = cfg.size
    N = cfg.max_order

    n = np.arange(-N, N + 1)
    # per-axis image coordinates and reflection counts for both parities
    def axis_images(x_s, L_ax):
        pos = np.concatenate([2.0 * n * L_ax + x_s, 2.0 * n * L_ax - x_s])
        refl = np.concatenate([2 * np.abs(n), np.abs(2 * n - 1)])
        return pos, refl

    px, rx = axis_images(src[0], Lx)
    py, ry = axis_images(src[1], Ly)
    pz, rz = axis_images(src[2], Lz)

    # total order filter: |nx|+|ny|+|nz| reflections <= ... keep all whose
    # reflection count per axis stems from order <= N images (standard ISM)
    P = np.stack(np.meshgrid(px, py, pz, indexing="ij"), axis=-1).reshape(-1, 3)
    R = (rx[:, None, None] + ry[None, :, None] + rz[None, None, :]).reshape(-1)
    keep = R <= cfg.max_order
    P, R = P[keep], R[keep]

    d = np.linalg.norm(P[None, :, :] - mics[:, None, :], axis=-1)  # [M, I]
    amp = (cfg.reflection**R)[None, :] / (4.0 * np.pi * np.maximum(d, 1e-2))
    delay = d / cfg.c * cfg.fs  # fractional samples

    L = cfg.rir_length or int(np.ceil(delay.max())) + sinc_width + 1
    t = np.arange(L)
    # band-limited impulse: windowed sinc centred at the fractional delay
    half = sinc_width // 2
    di = np.floor(delay).astype(int)
    rir = np.zeros((mics.shape[0], L))
    win_t = np.arange(sinc_width) - half
    hann = np.hanning(sinc_width)
    for m in range(mics.shape[0]):
        idx = di[m][:, None] + win_t[None, :]  # [I, W]
        frac = (delay[m] - di[m])[:, None]
        taps = amp[m][:, None] * hann * np.sinc(win_t[None, :] - frac)
        valid = (idx >= 0) & (idx < L)
        np.add.at(rir[m], idx[valid], taps[valid])
    return rir


def sabine_rt60(cfg: RoomConfig) -> float:
    """Sabine reverberation time of the configured shoebox room."""
    Lx, Ly, Lz = cfg.size
    V = Lx * Ly * Lz
    A = 2.0 * (Lx * Ly + Lx * Lz + Ly * Lz) * cfg.energy_absorption
    return 0.161 * V / A


def hybrid_rir(
    src: np.ndarray, mics: np.ndarray, cfg: RoomConfig = RoomConfig(),
    seed: int = 0, rt60: Optional[float] = None,
) -> np.ndarray:
    """ISM early reflections + stochastic spatially-coherent diffuse tail.

    The analogue of the reference's pyroomacoustics hybrid ISM+ray-tracing
    simulation (ArraySim.py:166-238): the deterministic image-source part
    covers early reflections up to ``cfg.max_order``; beyond the transition
    time the late field is modelled as diffuse noise with

    - the Sabine exponential energy decay (60 dB over ``rt60``),
    - sinc(2 pi f d / c) spatial coherence between mics (the same diffuse
      model as gen_noise_msc.py:7, imposed via a per-frequency Cholesky
      mix of independent noises),
    - amplitude matched to the ISM's mean-square level in the last window
      before the transition, so the early->late envelope is continuous.

    Returns rir [M, L] with L covering the -60 dB tail.
    """
    rng = np.random.default_rng(seed)
    M = np.asarray(mics).shape[0]
    t60 = rt60 if rt60 is not None else sabine_rt60(cfg)

    early = image_source_rir(src, mics, cfg)
    # transition: the path length the ISM reliably covers with max_order
    # reflections of the SHORTEST room dimension (beyond it the truncated
    # image set under-counts energy)
    t0 = int(cfg.max_order * min(cfg.size) / cfg.c * cfg.fs)
    t0 = min(max(t0, 64), early.shape[1])
    L_tail = int(t60 * cfg.fs)
    L = max(early.shape[1], t0 + L_tail)

    # --- diffuse tail: coherent across mics, exponential decay -------------
    n_fft = 1
    while n_fft < L_tail:
        n_fft *= 2
    F = n_fft // 2 + 1
    freqs = np.arange(F) * cfg.fs / n_fft
    d_ij = np.linalg.norm(mics[:, None, :] - mics[None, :, :], axis=-1)  # [M, M]
    x_arg = 2.0 * np.pi * freqs[:, None, None] * d_ij[None] / cfg.c
    Gamma = np.sinc(x_arg / np.pi)  # sin(x)/x, ones on the diagonal
    # regularised Cholesky per bin (Gamma is PSD up to float noise)
    Gc = np.linalg.cholesky(Gamma + 1e-6 * np.eye(M)[None])
    W = rng.standard_normal((M, n_fft))
    Wf = np.fft.rfft(W, axis=-1)  # [M, F]
    coh = np.fft.irfft(np.einsum("fmn,nf->mf", Gc, Wf), n=n_fft, axis=-1)[:, :L_tail]

    # amplitude envelope: 60 dB energy decay over t60
    t = np.arange(L_tail) / cfg.fs
    env = np.exp(-3.0 * np.log(10.0) * t / t60)
    tail = coh * env[None, :]

    # energy-match to the ISM's mean square in the last 20 ms before t0
    w0 = max(t0 // 2, t0 - int(0.02 * cfg.fs))
    e_ism = np.mean(early[:, w0:t0] ** 2) if t0 > w0 else np.mean(early**2)
    g = np.sqrt(max(e_ism, 1e-20) / max(np.mean(coh**2), 1e-20))

    # ISM below the transition, scaled stochastic tail above (the truncated
    # image set beyond t0 under-counts energy and is dropped)
    rir = np.zeros((M, L))
    rir[:, :t0] = early[:, :t0]
    rir[:, t0 : t0 + L_tail] += g * tail
    return rir


def simulate_propagation(
    signal: np.ndarray, src: np.ndarray, mics: np.ndarray, cfg: RoomConfig = RoomConfig(),
    diffuse_tail: bool = False, seed: int = 0,
) -> np.ndarray:
    """Convolve a dry source with its RIRs: [S] -> [M, S].

    ``diffuse_tail=True`` uses the hybrid ISM + stochastic late-field model
    (``hybrid_rir``) instead of the pure truncated ISM."""
    if diffuse_tail:
        rir = hybrid_rir(src, mics, cfg, seed=seed)
    else:
        rir = image_source_rir(src, mics, cfg)
    S = len(signal)
    out = np.stack([np.convolve(signal, rir[m])[:S] for m in range(rir.shape[0])], axis=0)
    return out


def generate_scene(
    source_signal: np.ndarray,
    mics: np.ndarray,
    interference: Optional[np.ndarray] = None,
    source_angle: float = 90.0,
    source_distance: float = 1.0,
    interf_angle: float = 30.0,
    interf_distance: float = 1.5,
    snr: float = 30.0,
    sir: float = 15.0,
    cfg: RoomConfig = RoomConfig(),
    seed: int = 0,
    diffuse_tail: bool = False,
) -> np.ndarray:
    """Reverberant multichannel mixture at chosen SNR/SIR (ArraySim.generate_audio).

    mics: [M, 3] array coordinates centred on the origin; the array is
    placed at the room centre like the reference (ArraySim.py:186-190).
    Returns mix [M, S].
    """
    rng = np.random.default_rng(seed)
    center = np.array([cfg.size[0] / 2.0, cfg.size[1] / 2.0, 0.5])
    mics_room = mics + center

    def place(angle_deg, dist):
        a = angle_deg / 180.0 * np.pi
        return center + np.array([np.cos(a) * dist, np.sin(a) * dist, 0.0])

    premix = [simulate_propagation(
        source_signal, place(source_angle, source_distance), mics_room, cfg,
        diffuse_tail=diffuse_tail, seed=seed + 11)]
    if interference is None:
        interference = rng.random(len(source_signal)) / 10.0  # ArraySim.py:255-257
    premix.append(simulate_propagation(
        interference[: len(source_signal)], place(interf_angle, interf_distance), mics_room, cfg,
        diffuse_tail=diffuse_tail, seed=seed + 12))
    premix = np.stack(premix, axis=0)  # [2, M, S]

    # callback_mix semantics (ArraySim.py:140-163)
    p_ref = np.std(premix[:, 0, :], axis=1)
    premix = premix / p_ref[:, None, None]
    premix[1:] *= np.sqrt(10 ** (-sir / 10.0))
    max_value = np.max(np.abs(premix))
    sigma_n = np.sqrt(10 ** (-snr / 10.0))
    mix = premix.sum(axis=0) + sigma_n * rng.standard_normal(premix.shape[1:])
    return mix / max_value
