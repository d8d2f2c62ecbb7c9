"""Plain reference of ``ami8_mvdr_omlsa``: MVDR beamforming with an OM-LSA
postfilter, waveform in and waveform out.

Per utterance x [M, S]: the sqrt-Hann STFT (256 / 128, hop-aligned frames
from a zero history); MCRA on mic 0's power; the noise covariance Rvv
updated where the gate is open (presence p < p_vad and, with the guard,
MCRA's raw indicator S / Smin <= delta_s); the solve u = (Rvv + load I)^-1 a
with load = diag + rel_diag tr(Rvv) / M; y = u^H z / (a^H u)^*; the
decision-directed OM-LSA gain clip(G_H1^p gmin^(1-p), gmin, 1); the inverse
STFT and overlap-add scaled by hop / W0.

``inv_mode = "rank1"`` is part of the configuration's semantics: the first
ceil(64 / t_chunk) chunks of t_chunk frames solve by an exact LDL^H each
frame; the covariance is then factored in place and carried as LDL^H
factors of Rvv + load I through Bennett's rank-1 update (the loading decays
by alpha_v at each update), and at every later chunk start the factors are
rebuilt with a fresh trace loading.  Every lane (utterance, bin) is a list
of real [B, F] tensors, the complex arithmetic split by hand, so that the
same code runs in float64 and in the controls' lower precisions.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.plain import (
    Precision, bin_masks, dft, freq_smooth, idft, mcra_frame, mcra_state, overlap_add, sqrt_hann, steering,
    synthesis_gain,
)

WARM_FRAMES = 64  # exact LDL^H frames before the rank-1 handover, rounded up to whole chunks


def run(inputs: dict, cfg: dict, prec: Precision = Precision()) -> dict:
    """inputs {"x": [B, M, S]} -> {"y": [B, S // hop * hop]} in ``prec``."""
    x = inputs["x"].to(prec.dtype)
    B, M, S = x.shape
    n_fft, hop = cfg["stft"]["n_fft"], cfg["stft"]["hop"]
    T, F = S // hop, n_fft // 2 + 1
    x = x[..., : T * hop]
    win = sqrt_hann(n_fft)
    C, Sn = dft(n_fft, win)
    A, Bm = idft(n_fft, win)
    CS = prec.tensor(np.concatenate([C, Sn], axis=1), x.device)
    AB = prec.tensor(np.concatenate([A, Bm], axis=0), x.device)

    # analysis: frame t is hop-blocks t-1 and t (zeros before the signal)
    blocks = torch.nn.functional.pad(x, (hop, 0)).reshape(B, M, T + 1, hop)
    Y = prec.mm(blocks[:, :, :-1], CS[:hop]) + prec.mm(blocks[:, :, 1:], CS[hop:])  # [B, M, T, 2F]
    Z = Y.reshape(B, M, T, 2, F).permute(2, 1, 3, 0, 4)  # [T, M, 2, B, F]
    a = steering(cfg["array"], cfg["look_deg"], n_fft)  # [F, M]
    planes = prec.tensor(np.stack([a.real.T, a.imag.T], axis=1), x.device)  # [M, 2, F]
    out = lanes(Z, planes, cfg)  # [T, 2, B, F]

    frames = prec.mm(out.permute(2, 0, 1, 3).reshape(B, T, 2 * F), AB)  # [B, T, n_fft]
    return {"y": overlap_add(frames, hop)[..., : T * hop] * synthesis_gain(n_fft, hop)}


def lanes(Z, planes, cfg: dict):
    """The per-lane frame recursion: spectra Z [T, M, 2, B, F] and steering
    planes [M, 2, F] -> the gained beamformer output [T, 2, B, F]."""
    T, M, _, B, F = Z.shape
    mc = cfg["mcra"]
    st = lane_state(M, Z.new_zeros((B, F)))
    Sf = freq_smooth(Z[:, 0, 0] ** 2 + Z[:, 0, 1] ** 2, mc["b"])  # [T, B, F]
    bins = bin_masks(F, Z.device)
    out = Z.new_empty((T, 2, B, F))
    for t in range(T):
        out[t, 0], out[t, 1] = frame(t, Z[t], Sf[t], planes, st, bins, cfg)
    return out


def lane_state(M: int, zero: torch.Tensor) -> dict:
    """The lanes' state from rest: covariance (then factors), held solve,
    MCRA, the gain's carry and the rank-1 path's baked loading."""
    return dict(Rr=[[zero] * M for _ in range(M)], Ri=[[zero] * M for _ in range(M)], Ur=[zero] * M,
                Ui=[zero] * M, mcra=mcra_state(zero.shape, zero), Gh=torch.ones_like(zero),
                Gam=torch.ones_like(zero), Ld=None)


def frame(t: int, z, Sf_t, planes, st: dict, bins, cfg: dict):
    """Frame t of every lane: spectra z [M, 2, B, F], smoothed mic-0 power
    Sf_t [B, F]; updates ``st`` and returns the gained output (re, im)."""
    M = z.shape[0]
    mv, mc, om = cfg["mvdr"], cfg["mcra"], cfg["omlsa"]
    t_chunk = cfg["t_chunk"]
    rank1 = cfg["inv_mode"] == "rank1"
    refresh = rank1 and bool(mv["rel_diag"])
    warm = max(1, -(-WARM_FRAMES // t_chunk))
    Rr, Ri, Ur, Ui = st["Rr"], st["Ri"], st["Ur"], st["Ui"]
    ar = [planes[m, 0] for m in range(M)]
    ai = [planes[m, 1] for m in range(M)]
    chunk, pos = divmod(t, t_chunk)
    steady = rank1 and chunk >= warm
    if steady and refresh and pos == 0 and chunk >= warm + 1:
        st["Ld"] = _refresh_loading(Rr, Ri, st["Ld"], M, mv["diag"], mv["rel_diag"])
    zr = [z[m, 0] for m in range(M)]
    zi = [z[m, 1] for m in range(M)]
    p, lam, sr = mcra_frame(t, zr[0] * zr[0] + zi[0] * zi[0], Sf_t, st["mcra"], bins, mc)
    upd = p < mv["p_vad"]
    if mv["vad_guard"]:
        upd = upd & (sr <= mc["delta_s"])
    if steady:
        st["Ld"] = _update_rank1(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, mv["alpha_v"], st["Ld"])
    else:
        _update_ldl(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, mv["alpha_v"], mv["diag"], mv["rel_diag"])
    yr, yi = _beam(zr, zi, ar, ai, Ur, Ui, M)
    y, st["Gh"], st["Gam"] = _omlsa(yr, yi, p, lam, st["Gh"], st["Gam"], om["alpha_xi"], om["gmin"])
    if rank1 and chunk == warm - 1 and pos == t_chunk - 1:  # the handover: factor in place
        load = _factor_into(Rr, Ri, M, mv["diag"], mv["rel_diag"])
        if refresh:
            st["Ld"] = load
    return y


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _gated(upd, new, old):
    """new where the gate is open; ``upd`` None opens every lane."""
    return new if upd is None else torch.where(upd, new, old)


def _loading(Rr, M, diag, rel_diag):
    """diag + rel_diag tr(R) / M, per lane."""
    if not rel_diag:
        return diag
    tr = Rr[0][0]
    for i in range(1, M):
        tr = tr + Rr[i][i]
    return diag + (rel_diag / M) * tr


def _ldl(Rr, Ri, M, load):
    """LDL^H of R + load I from its lower triangle: unit-lower L, D, 1 / D."""
    Lr = [[None] * M for _ in range(M)]
    Li = [[None] * M for _ in range(M)]
    D, Dinv = [None] * M, [None] * M
    for j in range(M):
        d = Rr[j][j] + load
        for k in range(j):
            d = d - (Lr[j][k] * Lr[j][k] + Li[j][k] * Li[j][k]) * D[k]
        D[j], Dinv[j] = d, 1.0 / d
        for i in range(j + 1, M):
            sr, si = Rr[i][j], Ri[i][j]
            for k in range(j):
                tr, ti = _cmul(Lr[i][k], Li[i][k], Lr[j][k], -Li[j][k])
                sr, si = sr - tr * D[k], si - ti * D[k]
            Lr[i][j], Li[i][j] = sr * Dinv[j], si * Dinv[j]
    return Lr, Li, D, Dinv


def _solve(Lr, Li, Dinv, ar, ai, M):
    """u = L^-H D^-1 L^-1 a."""
    vr, vi = [None] * M, [None] * M
    for i in range(M):
        sr, si = ar[i], ai[i]
        for k in range(i):
            tr, ti = _cmul(Lr[i][k], Li[i][k], vr[k], vi[k])
            sr, si = sr - tr, si - ti
        vr[i], vi[i] = sr, si
    vr = [v * d for v, d in zip(vr, Dinv)]
    vi = [v * d for v, d in zip(vi, Dinv)]
    ur, ui = [None] * M, [None] * M
    for i in range(M - 1, -1, -1):
        sr, si = vr[i], vi[i]
        for k in range(i + 1, M):
            tr, ti = _cmul(Lr[k][i], -Li[k][i], ur[k], ui[k])
            sr, si = sr - tr, si - ti
        ur[i], ui[i] = sr, si
    return ur, ui


def _update_ldl(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, alpha_v, diag, rel_diag):
    """Gated Rvv <- alpha Rvv + (1 - alpha) z z^H on the lower triangle, then
    the solve by LDL^H of the loaded covariance; u held where the gate is
    closed (the loading reads the stored R)."""
    beta = 1.0 - alpha_v
    for i in range(M):
        for j in range(i + 1):
            if i == j:
                Rr[i][i] = _gated(upd, alpha_v * Rr[i][i] + beta * (zr[i] * zr[i] + zi[i] * zi[i]), Rr[i][i])
            else:
                Rr[i][j] = _gated(upd, alpha_v * Rr[i][j] + beta * (zr[i] * zr[j] + zi[i] * zi[j]), Rr[i][j])
                Ri[i][j] = _gated(upd, alpha_v * Ri[i][j] + beta * (zi[i] * zr[j] - zr[i] * zi[j]), Ri[i][j])
    Lr, Li, _, Dinv = _ldl(Rr, Ri, M, _loading(Rr, M, diag, rel_diag))
    ur, ui = _solve(Lr, Li, Dinv, ar, ai, M)
    for i in range(M):
        Ur[i], Ui[i] = _gated(upd, ur[i], Ur[i]), _gated(upd, ui[i], Ui[i])


def _factor_into(Rr, Ri, M, diag, rel_diag):
    """Replace the covariance by the LDL^H factors of R + load I (D on the
    diagonal slots); return load."""
    load = _loading(Rr, M, diag, rel_diag)
    Lr, Li, D, _ = _ldl(Rr, Ri, M, load)
    for i in range(M):
        Rr[i][i] = D[i]
        for j in range(i):
            Rr[i][j], Ri[i][j] = Lr[i][j], Li[i][j]
    return load


def _refresh_loading(Rr, Ri, Ld, M, diag, rel_diag):
    """Rebuild Rvv = L D L^H - Ld I from the factors and refactor it with a
    fresh trace loading; return the new loading."""
    Rv = [[None] * M for _ in range(M)]
    Iv = [[None] * M for _ in range(M)]
    for i in range(M):
        acc = Rr[i][i]
        for k in range(i):
            acc = acc + (Rr[i][k] * Rr[i][k] + Ri[i][k] * Ri[i][k]) * Rr[k][k]
        Rv[i][i] = acc - Ld
        for j in range(i):
            sr, si = Rr[i][j] * Rr[j][j], Ri[i][j] * Rr[j][j]
            for k in range(j):
                tr, ti = _cmul(Rr[i][k], Ri[i][k], Rr[j][k], -Ri[j][k])
                sr, si = sr + tr * Rr[k][k], si + ti * Rr[k][k]
            Rv[i][j], Iv[i][j] = sr, si
    for i in range(M):
        Rr[i][i] = Rv[i][i]
        for j in range(i):
            Rr[i][j], Ri[i][j] = Rv[i][j], Iv[i][j]
    return _factor_into(Rr, Ri, M, diag, rel_diag)


def _update_rank1(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, alpha_v, Ld):
    """Bennett's gated rank-1 update of the factors of A = Rvv + load I,
    A' = alpha (A + ((1 - alpha) / alpha) z z^H), and the solve from the
    candidate factors; returns the decayed loading."""
    wr, wi = list(zr), list(zi)
    Lr = [[None] * M for _ in range(M)]
    Li = [[None] * M for _ in range(M)]
    Dn, Dinv = [None] * M, [None] * M
    sig = (1.0 - alpha_v) / alpha_v
    for j in range(M):
        pr, pi = wr[j], wi[j]
        dj = Rr[j][j] + sig * (pr * pr + pi * pi)
        r = 1.0 / dj
        sr = sig * r
        br, bi = sr * pr, -(sr * pi)
        sig = sig * Rr[j][j] * r
        Dn[j], Dinv[j] = alpha_v * dj, r * (1.0 / alpha_v)
        for i in range(j + 1, M):
            tr, ti = _cmul(pr, pi, Rr[i][j], Ri[i][j])
            wr[i], wi[i] = wr[i] - tr, wi[i] - ti
            tr, ti = _cmul(br, bi, wr[i], wi[i])
            Lr[i][j], Li[i][j] = Rr[i][j] + tr, Ri[i][j] + ti
    ur, ui = _solve(Lr, Li, Dinv, ar, ai, M)
    for i in range(M):
        Rr[i][i] = _gated(upd, Dn[i], Rr[i][i])
        Ur[i], Ui[i] = _gated(upd, ur[i], Ur[i]), _gated(upd, ui[i], Ui[i])
        for j in range(i):
            Rr[i][j], Ri[i][j] = _gated(upd, Lr[i][j], Rr[i][j]), _gated(upd, Li[i][j], Ri[i][j])
    return None if Ld is None else _gated(upd, alpha_v * Ld, Ld)


def _beam(zr, zi, ar, ai, Ur, Ui, M):
    """y = (u^H z) / conj(a^H u)."""
    den_r, den_i = _cmul(ar[0], -ai[0], Ur[0], Ui[0])
    nr, ni = _cmul(Ur[0], -Ui[0], zr[0], zi[0])
    for m in range(1, M):
        tr, ti = _cmul(ar[m], -ai[m], Ur[m], Ui[m])
        den_r, den_i = den_r + tr, den_i + ti
        tr, ti = _cmul(Ur[m], -Ui[m], zr[m], zi[m])
        nr, ni = nr + tr, ni + ti
    dmag = den_r * den_r + den_i * den_i
    return _cmul(nr, ni, den_r / dmag, den_i / dmag)


def _omlsa(yr, yi, p, lam, Gh, Gam, alpha_xi, gmin):
    """The decision-directed OM-LSA gain with the previous frame's (G_H1,
    gamma); returns ((yr G, yi G), G_H1, gamma)."""
    gamma = (yr * yr + yi * yi) / torch.clamp(lam, min=1e-10)
    xi = alpha_xi * Gh**2 * Gam + (1.0 - alpha_xi) * torch.clamp(gamma - 1.0, min=0.0)
    G_H1 = xi / (1.0 + xi)
    logG = p * torch.log(torch.clamp(G_H1, min=1e-30)) + (1.0 - p) * float(np.log(gmin))
    G = torch.clamp(torch.exp(logG), gmin, 1.0)
    return (yr * G, yi * G), G_H1, gamma
