"""Plain reference of ``respeaker4_full_stack``: echo cancellation, a
dual-mic keyword-spotting cleaner, and a time-domain GSC with a
multichannel OM-LSA postfilter, waveform in and waveform out.

Per utterance (mics x [M, S] and the playback reference far [S]):

1. AEC, every mic against the shared far end: pre-emphasis (0.98) of both;
   the speex-style two-path MDF, a background filter adapted every block
   and a foreground filter that takes it over when the transfer tests
   fire, num_block partitions of block_len taps in frequency; the
   echo-leak regression and the per-bin optimal step with 3-tap smoothing;
   the proportionate constrained gradient; de-emphasis (0.98) of the
   output.
2. KWS cleaner on the echo-free mics 0 and 1: an FLMS noise canceller
   (mic 0 predicting mic 1 delayed by frame_len / 2), whose taps a frozen
   copy applies Dn frames later through a FIFO.
3. TDGSC on the echo-free mics: DC notch (radius 0.98), fractional-delay
   alignment to the look direction, the fixed beamformer (mean) and the
   pairwise-difference blocking matrix; MCRA on the beam's STFT power
   steps a non-causal FLMS interference canceller by (1 - p); OM-LSA-multi
   on the canceller output against the blocking-matrix powers, applied as
   sqrt(G) through a windowed STFT round trip.

Returns the enhanced signal, the cleaned KWS signal and MCRA's p.  The
transforms are dense products against DFT matrices (the rounding a
control in a lower precision perturbs); the DC notch is the biquad's
impulse response, truncated where it has decayed below 1e-17, as an FIR.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.plain import (
    Precision, alignment_filters, bin_masks, fir, freq_smooth, mcra_frame, mcra_state, pack, packed_dft,
    sqrt_hann, synthesis_gain, unpack,
)

NOTCH_TAPS = 2048  # the notch's impulse response decays as 0.9801^n: < 1e-17 by n = 2048


def run(inputs: dict, cfg: dict, prec: Precision = Precision()) -> dict:
    """inputs {"x": [B, M, S], "far": [B, S]} -> {"enhanced": [B, S'],
    "kws": [B, S'], "p": [B, T, F]} with S' = T frame_len."""
    L = cfg["frame_len"]
    x, far = inputs["x"].to(prec.dtype), inputs["far"].to(prec.dtype)
    T = x.shape[-1] // L
    x, far = x[..., : T * L], far[..., : T * L]
    a = cfg["aec"]
    echo_free = aec(emphasis(far, a["emphasis"]), emphasis(x, a["emphasis"]), cfg, prec)
    kws_clean = kws(echo_free[:, 0], echo_free[:, 1], cfg, prec)
    out, p = tdgsc(echo_free, cfg, prec)
    return {"enhanced": out, "kws": kws_clean, "p": p}


def emphasis(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """y[n] = x[n] - alpha x[n-1] from a zero history."""
    return x - alpha * torch.nn.functional.pad(x[..., :-1], (1, 0))


def aec(farp: torch.Tensor, xp: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """The two-path MDF over pre-emphasised far [B, S'] and mics [B, M, S']:
    the echo-free, de-emphasised mics [B, M, S']."""
    a = cfg["aec"]
    B, M, S = xp.shape
    NB = a["num_block"]
    hop = a["filter_len"] // NB
    n_fft, T, F = 2 * hop, S // hop, hop + 1
    dev = xp.device
    CS, AB = (prec.tensor(m, dev) for m in packed_dft(n_fft))
    win = prec.tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft), dev)
    j, i = np.arange(hop)[None, :], np.arange(hop)[:, None]
    R1 = prec.tensor(np.where(j >= i, a["emphasis"] ** np.maximum(j - i, 0), 0.0), dev)  # de-emphasis in a block
    decay = prec.tensor(a["emphasis"] ** (np.arange(hop) + 1.0), dev)
    beta0 = 2.0 * hop / cfg["array"]["fs"]
    blocks = torch.nn.functional.pad(farp, (hop, 0)).reshape(B, T + 1, hop)
    Zr, Zi = unpack(prec.mm(blocks[:, :-1], CS[:hop]) + prec.mm(blocks[:, 1:], CS[hop:]), F)  # [B, T, F]
    d = xp.reshape(B, M, T, hop)

    zc = xp.new_zeros((B, M, NB, F))
    Wr, Wi, Fr, Fi = zc, zc, zc, zc
    P = xp.new_zeros((B, F))
    Py, Pe = xp.new_zeros((B, M, F)), xp.new_zeros((B, M, F))
    zs = xp.new_zeros((B, M))
    Ryy, Rey, Davg1, Davg2, Dvar1, Dvar2, memE = zs + 1.0, zs + 1.0, zs, zs, zs, zs, zs
    g, g1 = a["gamma"], 1.0 - a["gamma"]
    out = xp.new_empty((B, M, T, hop))
    zero_spec = xp.new_zeros((B, F))
    for t in range(T):
        Xs = [(Zr[:, t], Zi[:, t]), (Zr[:, t - 1], Zi[:, t - 1]) if t > 0 else (zero_spec, zero_spec)][:NB]
        P = a["alpha"] * P + (1.0 - a["alpha"]) * sum(xr * xr + xi * xi for xr, xi in Xs)
        Pr = (P + 1e-6)[:, None]

        def filt(Hr, Hi):
            yr = sum(xr[:, None] * Hr[:, :, b] - xi[:, None] * Hi[:, :, b] for b, (xr, xi) in enumerate(Xs))
            yi = sum(xr[:, None] * Hi[:, :, b] + xi[:, None] * Hr[:, :, b] for b, (xr, xi) in enumerate(Xs))
            return yr, yi

        Ybr, Ybi = filt(Wr, Wi)
        Yfr, Yfi = filt(Fr, Fi)
        yb = prec.mm(pack(Ybr, Ybi), AB[:, hop:])
        yf = prec.mm(pack(Yfr, Yfi), AB[:, hop:])
        d_t = d[:, :, t]
        e_b, e_f = d_t - yb, d_t - yf

        # the two-path transfer tests, per mic
        Sff = torch.sum(e_f * e_f, dim=-1)
        See = torch.sum(e_b * e_b, dim=-1)
        dby = yf - yb
        Dbf = torch.sum(dby * dby, dim=-1)
        Davg1 = 0.6 * Davg1 + 0.4 * (Sff - See)
        Davg2 = 0.85 * Davg2 + 0.15 * (Sff - See)
        Dvar1 = 0.36 * Dvar1 + 0.16 * Sff * Dbf
        Dvar2 = 0.7225 * Dvar2 + 0.0225 * Sff * Dbf
        upd = (
            ((Sff - See) * torch.abs(Sff - See) > Sff * Dbf)
            | (Davg1 * torch.abs(Davg1) > 0.5 * Dvar1)
            | (Davg2 * torch.abs(Davg2) > 0.25 * Dvar2)
        )
        Davg1, Davg2, Dvar1, Dvar2 = (torch.where(upd, torch.zeros_like(v), v) for v in (Davg1, Davg2, Dvar1, Dvar2))
        u4 = upd[:, :, None, None]
        Fr, Fi = torch.where(u4, Wr, Fr), torch.where(u4, Wi, Fi)
        o = d_t - torch.where(upd[..., None], win[hop:] * yf + win[:hop] * yb, yf)

        # the leak regression and the per-bin optimal step
        Er, Ei = unpack(prec.mm(e_b, CS[hop:]), F)
        Ysq = Ybr * Ybr + Ybi * Ybi
        Rsq = Er * Er + Ei * Ei
        Py = g1 * Py + g * Ysq
        Pe = g1 * Pe + g * Rsq
        Eh, Yh = Rsq - Pe, Ysq - Py
        Pyy = torch.sqrt(torch.sum(Yh * Yh, dim=-1))
        Pey = torch.sum(Eh * Yh, dim=-1) / (Pyy + 1e-6)
        Syy = torch.sum(yb * yb, dim=-1)
        al = beta0 * torch.clamp(Syy / See, max=1.0)
        Ryy = (1.0 - al) * Ryy + al * Pyy
        Rey = (1.0 - al) * Rey + al * Pey
        mu = (Rey / (Ryy + 1e-6))[..., None] * Ysq / (Rsq + 1e-3)
        mu = torch.cat([2.0 * mu[..., :2], mu[..., 2:]], dim=-1)
        mu = torch.clamp(mu, 1e-3, a["mu_max"])
        mp = torch.nn.functional.pad(mu, (1, 1))
        mu = 0.25 * mp[..., :-2] + 0.5 * mp[..., 1:-1] + 0.25 * mp[..., 2:]
        if t < 5:
            mu = torch.full_like(mu, 0.1)

        # the constrained gradient (the first hop taps kept), stepped in
        # proportion to each partition's current filter norm
        Gr, Gi = [], []
        for xr, xi in Xs:
            gr = (xr[:, None] * Er + xi[:, None] * Ei) / Pr
            gi = (xr[:, None] * Ei - xi[:, None] * Er) / Pr
            cr, ci = unpack(prec.mm(prec.mm(pack(gr, gi), AB[:, :hop]), CS[:hop]), F)
            Gr.append(cr)
            Gi.append(ci)
        props = torch.sqrt(torch.sum(Wr * Wr + Wi * Wi, dim=-1))
        props = props + 0.1 * torch.clamp(props, min=1e-6)
        step = (0.99 * props / (1e-6 + torch.sum(props, dim=-1, keepdim=True)))[..., None] * mu[:, :, None]
        Wr = Wr + step * torch.stack(Gr, dim=2)
        Wi = Wi + step * torch.stack(Gi, dim=2)

        y = prec.mm(o, R1) + memE[..., None] * decay  # de-emphasis y[n] = o[n] + 0.98 y[n-1]
        memE = y[..., -1]
        out[:, :, t] = y
    return out.reshape(B, M, T * hop)


def kws(x0: torch.Tensor, x1: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """The KWS cleaner on mics 0 and 1 [B, S']: the cleaned mic 1 [B, S']."""
    k = cfg["kws"]
    Lf = hop = cfg["frame_len"]
    B, S = x0.shape
    T, F = S // Lf, Lf + 1
    Dn = int(k["defer_seconds"] * cfg["array"]["fs"]) // Lf + 1
    CS, AB = (prec.tensor(m, x0.device) for m in packed_dft(2 * Lf))
    blocks = torch.nn.functional.pad(x0, (hop, 0)).reshape(B, T + 1, hop)
    Xr, Xi = unpack(prec.mm(blocks[:, :-1], CS[:hop]) + prec.mm(blocks[:, 1:], CS[hop:]), F)
    d = torch.nn.functional.pad(x1, (Lf // 2, 0))[..., :S].reshape(B, T, hop)
    w = x0.new_zeros((B, Lf))
    Pw = x0.new_zeros((B, F))
    fifo = [x0.new_zeros((B, Lf))] * Dn
    out = x0.new_empty((B, T, hop))

    def filtered(taps, xr, xi):
        wr, wi = unpack(prec.mm(taps, CS[:Lf]), F)
        return prec.mm(pack(xr * wr - xi * wi, xr * wi + xi * wr), AB[:, hop:])

    for t in range(T):
        xr, xi = Xr[:, t], Xi[:, t]
        Pw = torch.clamp(k["alpha"] * Pw + (1.0 - k["alpha"]) * (xr * xr + xi * xi), min=1e-4)
        e = d[:, t] - filtered(w, xr, xi)
        Er, Ei = unpack(prec.mm(e, CS[hop:]), F)
        w = w + 2.0 * k["mu"] * prec.mm(pack((xr * Er + xi * Ei) / Pw, (xr * Ei - xi * Er) / Pw), AB[:, :Lf])
        w_old, fifo[t % Dn] = fifo[t % Dn], w  # the taps pushed Dn frames ago
        out[:, t] = d[:, t] - filtered(w_old, xr, xi)
    return out.reshape(B, T * hop)


def notch_response(radius: float, n: int) -> np.ndarray:
    """Impulse response of the speex DC notch,
    H(z) = r (1 - 2 z^-1 + z^-2) / (1 - 2 r z^-1 + (r^2 + 0.7 (1 - r)^2) z^-2)."""
    den2 = radius * radius + 0.7 * (1.0 - radius) ** 2
    h = np.zeros(n)
    x = np.zeros(n)
    x[0] = 1.0
    for i in range(n):
        acc = radius * (x[i] - 2.0 * (x[i - 1] if i >= 1 else 0.0) + (x[i - 2] if i >= 2 else 0.0))
        h[i] = acc + 2.0 * radius * (h[i - 1] if i >= 1 else 0.0) - den2 * (h[i - 2] if i >= 2 else 0.0)
    return h


def stft_power(x: torch.Tensor, n_fft: int, hop: int, prec: Precision) -> torch.Tensor:
    """|STFT|^2 [..., T, F] of x [..., T hop], sqrt-Hann, from a zero history."""
    T, F = x.shape[-1] // hop, n_fft // 2 + 1
    CSW = prec.tensor(packed_dft(n_fft, sqrt_hann(n_fft))[0], x.device)
    blocks = torch.nn.functional.pad(x, (n_fft - hop, 0)).reshape(*x.shape[:-1], T + 1, hop)
    re, im = unpack(prec.mm(blocks[..., :-1, :], CSW[:hop]) + prec.mm(blocks[..., 1:, :], CSW[hop:]), F)
    return re * re + im * im


def tdgsc(xe: torch.Tensor, cfg: dict, prec: Precision):
    """The GSC with its postfilter on the echo-free mics [B, M, S']:
    (enhanced [B, S'], p [B, T, F])."""
    return tdgsc_frames(*front_end(xe, cfg, prec), cfg, prec)


def front_end(xe: torch.Tensor, cfg: dict, prec: Precision):
    """The frame-independent front end: notch, alignment, the fixed beam and
    the blocking matrix; returns (bm [B, C, S'], the beam delayed by
    frame_len / 2 [B, S'], the beam's STFT power [B, T, F], the blocking
    matrix's STFT powers [B, C, T, F])."""
    Lf, dev = cfg["frame_len"], xe.device
    S = xe.shape[-1]
    notched = fir(xe, prec.tensor(notch_response(cfg["gsc"]["notch_radius"], NOTCH_TAPS), dev), prec)
    aligned = fir(notched, prec.tensor(alignment_filters(cfg["array"], cfg["look_deg"]), dev), prec)
    fbf = aligned.mean(dim=-2)
    bm = aligned[:, :-1] - aligned[:, 1:]
    d = torch.nn.functional.pad(fbf, (Lf // 2, 0))[..., :S]
    return bm, d, stft_power(fbf, 2 * Lf, Lf, prec), stft_power(bm, 2 * Lf, Lf, prec)


def tdgsc_frames(bm, d, yp, up, cfg: dict, prec: Precision):
    """The frame recursion: MCRA on the beam power gates the FLMS canceller
    of the blocking-matrix signals, then the postfilter.  Returns
    (enhanced [B, S'], p [B, T, F])."""
    gc, mc = cfg["gsc"], cfg["mcra"]
    Lf = hop = cfg["frame_len"]
    B, C, S = bm.shape
    T, F = S // Lf, Lf + 1
    dev = bm.device
    d = d.reshape(B, T, hop)
    CS, AB = (prec.tensor(m, dev) for m in packed_dft(2 * Lf))
    blocks = torch.nn.functional.pad(bm, (hop, 0)).reshape(B, C, T + 1, hop)
    Xr, Xi = unpack(prec.mm(blocks[:, :, :-1], CS[:hop]) + prec.mm(blocks[:, :, 1:], CS[hop:]), F)
    sf = freq_smooth(yp, mc["b"])
    bins = bin_masks(F, dev)
    n = torch.arange(Lf, device=dev)
    keep = (n >= gc["fir_truncate"]) & (n < Lf - gc["fir_truncate"])
    st = mcra_state((B, F), bm)
    wt = bm.new_zeros((B, C, Lf))
    Pw = bm.new_zeros((B, F))
    out = bm.new_empty((B, T, hop))
    p_out = bm.new_empty((B, T, F))
    pf = _Postfilter(cfg, B, C, bm, prec)
    for t in range(T):
        p, _, sr = mcra_frame(t, yp[:, t], sf[:, t], st, bins, mc)
        p_out[:, t] = p
        gate = 1.0 - p
        if gc["vad_guard"]:
            gate = gate * (sr <= mc["delta_s"])
        xr, xi = Xr[:, :, t], Xi[:, :, t]
        wr, wi = unpack(prec.mm(wt, CS[:Lf]), F)
        Yr = torch.sum(xr * wr - xi * wi, dim=1)
        Yi = torch.sum(xr * wi + xi * wr, dim=1)
        Pw = torch.clamp(gc["alpha"] * Pw + (1.0 - gc["alpha"]) * torch.sum(xr * xr + xi * xi, dim=1), min=1e-4)
        e = d[:, t] - prec.mm(pack(Yr, Yi), AB[:, hop:])
        Er, Ei = unpack(prec.mm(e, CS[hop:]), F)
        Pc = Pw[:, None]
        gr = (xr * Er[:, None] + xi * Ei[:, None]) / Pc
        gi = (xr * Ei[:, None] - xi * Er[:, None]) / Pc
        Gr, Gi = unpack(prec.mm(prec.mm(pack(gr, gi), AB[:, :Lf]), CS[:Lf]), F)  # the gradient constraint
        g = gate[:, None]
        wt = torch.where(keep, wt + 2.0 * gc["mu"] * prec.mm(pack(Gr * g, Gi * g), AB[:, :Lf]), torch.zeros_like(wt))
        out[:, t] = pf.frame(e, up[:, :, t])
    return out.reshape(B, T * hop), p_out


class _Postfilter:
    """OM-LSA-multi (Cohen, Gannot and Berdugo 2003) on the canceller output,
    one frame at a time, through a sqrt-Hann STFT round trip."""

    def __init__(self, cfg: dict, B: int, C: int, like: torch.Tensor, prec: Precision):
        self.om, self.prec = cfg["omlsa"], prec
        self.hop = hop = cfg["frame_len"]
        n_fft = 2 * hop
        self.F = hop + 1
        CSW, ABW = packed_dft(n_fft, sqrt_hann(n_fft))
        self.CSW = prec.tensor(CSW, like.device)
        self.ABW = prec.tensor(ABW * synthesis_gain(n_fft, hop), like.device)
        self.bins = bin_masks(self.F, like.device)
        self.mcra = mcra_state((B, C + 1, self.F), like)
        one = like.new_ones((B, self.F))
        self.zeta_Y, self.zeta_U = one, like.new_zeros((B, C, self.F))
        self.lam, self.gamma, self.G_H1 = like.new_zeros((B, self.F)), one, one
        self.prev = like.new_zeros((B, hop))
        self.ola = like.new_zeros((B, hop))
        self.t = 0

    def frame(self, e: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Canceller block e [B, hop] and the reference powers u [B, C, F] ->
        the postfiltered block [B, hop]."""
        om, hop, prec = self.om, self.hop, self.prec
        yr, yi = unpack(prec.mm(self.prev, self.CSW[:hop]) + prec.mm(e, self.CSW[hop:]), self.F)
        self.prev = e
        y = yr * yr + yi * yi
        G = self._gain(y, u)
        sg = torch.sqrt(G)
        f = prec.mm(pack(sg * yr, sg * yi), self.ABW)
        out = f[:, :hop] + self.ola
        self.ola = f[:, hop:]
        return out

    def _gain(self, y, u):
        om = self.om
        yu = torch.cat([y[:, None], u], dim=1)
        _, mu, _ = mcra_frame(self.t, yu, freq_smooth(yu, om["mcra"]["b"]), self.mcra, self.bins, om["mcra"])
        MU_Y, MU_U = mu[:, 0], mu[:, 1:]
        t, self.t = self.t, self.t + 1
        if t == 0:  # the first frame only seeds the state
            self.zeta_Y, self.zeta_U, self.lam = y, u, y
            return torch.ones_like(y)
        smooth3 = lambda v: 0.25 * torch.nn.functional.pad(v[..., :-1], (1, 0)) + 0.5 * v + \
            0.25 * torch.nn.functional.pad(v[..., 1:], (0, 1))
        self.zeta_Y = om["alpha_s"] * self.zeta_Y + (1.0 - om["alpha_s"]) * smooth3(y)
        self.zeta_U = om["alpha_s"] * self.zeta_U + (1.0 - om["alpha_s"]) * smooth3(u)
        # the transient beam-to-reference ratio, the posterior SNR and the
        # a-priori absence probability
        omega = torch.clamp(self.zeta_Y - MU_Y, min=1e-6) / (
            torch.maximum(torch.amax(self.zeta_U - MU_U, dim=-2), om["eps_tbrr"] * MU_Y) + 1e-6)
        omega = torch.clamp(omega, 0.1, 100.0)
        gamma_s = torch.clamp(y / (MU_Y * om["Bmin"] + 1e-6), max=100.0)
        q = torch.maximum((om["gamma_high"] - gamma_s) / (om["gamma_high"] - om["gamma_low"]),
                          (om["omega_high"] - omega) / (om["omega_high"] - om["omega_low"]))
        absent = (gamma_s < om["gamma_low"]) | (omega < om["omega_low"])
        q = torch.clamp(torch.where(absent, torch.ones_like(q), q), om["q_min"], om["q_max"])
        # the decision-directed prior SNR, the presence probability, the gain
        gamma = y / torch.clamp(self.lam, min=1e-10)
        xi = om["alpha_xi"] * self.G_H1**2 * self.gamma + (1.0 - om["alpha_xi"]) * torch.clamp(gamma - 1.0, min=0.0)
        nu = gamma * xi / (1.0 + xi)
        G_H1 = xi / (1.0 + xi)
        p = 1.0 / (1.0 + q / (1.0 - q) * (1.0 + xi) * torch.exp(-nu))
        alpha_t = om["alpha_d"] + (1.0 - om["alpha_d"]) * p
        self.lam = alpha_t * self.lam + om["beta"] * (1.0 - alpha_t) * y
        self.gamma, self.G_H1 = gamma, G_H1
        gmin = 10.0 ** (om["gmin_db"] / 10.0)
        return torch.clamp(G_H1**p * gmin ** (1.0 - p), gmin, 1.0)
