"""Per-lane MVDR math of the fused kernels, in plain PyTorch.

Counterpart of the lane functions of ``distantspeech_tpu/ops/pallas_mvdr.py``
and the plain version of the device functions in ``csrc/enhance_lane.cuh``,
which follow these line by line.  A lane is one (utterance, bin) pair; every
quantity here is a list of per-mic [B, F] real tensors (split complex), and
the state is held in nested lists that the functions update in place:

- ``Rr[i][j]`` / ``Ri[i][j]`` for i >= j: the lower triangle of the noise
  covariance Rvv (real diagonal in ``Rr[i][i]``), or, after the rank-1
  handover, its LDL^H factors (unit-lower off-diagonals in ``[i][j]``, real
  D on the diagonal slots);
- ``Ur[i]`` / ``Ui[i]``: the held solve u = (Rvv + load I)^-1 a.

A gate ``upd`` (bool [B, F], or None for always) selects per lane between
the updated and the held state, as the reference's VAD gate does.
"""

from __future__ import annotations

import torch


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _gated(upd, new, old):
    return new if upd is None else torch.where(upd, new, old)


def _loading(Rr, M, diag, rel_diag):
    """load = diag + rel_diag * tr(R) / M, per lane."""
    if not rel_diag:
        return diag
    tr_R = Rr[0][0]
    for i in range(1, M):
        tr_R = tr_R + Rr[i][i]
    return diag + (rel_diag / M) * tr_R


def _ldl_factors(Rr, Ri, M, load):
    """LDL^H of A = R + load I from the lower triangle: unit-lower L (split
    complex), real D and 1/D."""
    Lr = [[None] * M for _ in range(M)]
    Li = [[None] * M for _ in range(M)]
    D = [None] * M
    Dinv = [None] * M
    for j in range(M):
        d = Rr[j][j] + load
        for k in range(j):
            d = d - (Lr[j][k] * Lr[j][k] + Li[j][k] * Li[j][k]) * D[k]
        D[j] = d
        Dinv[j] = 1.0 / d
        for i in range(j + 1, M):
            sr, si = Rr[i][j], Ri[i][j]
            for k in range(j):
                tr, ti = _cmul(Lr[i][k], Li[i][k], Lr[j][k], -Li[j][k])  # L[i][k] conj(L[j][k])
                sr, si = sr - tr * D[k], si - ti * D[k]
            Lr[i][j] = sr * Dinv[j]
            Li[i][j] = si * Dinv[j]
    return Lr, Li, D, Dinv


def _ldl_solve_factors(Lr, Li, Dinv, ar, ai, M):
    """u = L^-H D^-1 L^-1 a: forward solve (unit diagonal), scale, back solve."""
    vr = [None] * M
    vi = [None] * M
    for i in range(M):
        sr, si = ar[i], ai[i]
        for k in range(i):
            tr, ti = _cmul(Lr[i][k], Li[i][k], vr[k], vi[k])
            sr, si = sr - tr, si - ti
        vr[i], vi[i] = sr, si
    for i in range(M):
        vr[i], vi[i] = vr[i] * Dinv[i], vi[i] * Dinv[i]
    ur = [None] * M
    ui = [None] * M
    for i in range(M - 1, -1, -1):
        sr, si = vr[i], vi[i]
        for k in range(i + 1, M):
            tr, ti = _cmul(Lr[k][i], -Li[k][i], ur[k], ui[k])  # conj(L[k][i]) u[k]
            sr, si = sr - tr, si - ti
        ur[i], ui[i] = sr, si
    return ur, ui


def _mvdr_update_ldl(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, alpha_v, diag, rel_diag=0.0):
    """Gated hermitian rank-1 update of the lower triangle of R, then
    u = (R + load I)^-1 a by an unrolled LDL^H factorisation and two
    triangular solves (no sqrt); u is held where the gate is closed.

    The loading uses the trace of the candidate (updated) R, before gating;
    where the gate is closed the candidate's solve is discarded, so the
    factorisation may read the stored (gated) R."""
    beta = 1.0 - alpha_v
    for i in range(M):
        for j in range(i + 1):
            if i == j:
                out = zr[i] * zr[i] + zi[i] * zi[i]
                Rr[i][i] = _gated(upd, alpha_v * Rr[i][i] + beta * out, Rr[i][i])
            else:
                outr = zr[i] * zr[j] + zi[i] * zi[j]
                outi = zi[i] * zr[j] - zr[i] * zi[j]
                Rr[i][j] = _gated(upd, alpha_v * Rr[i][j] + beta * outr, Rr[i][j])
                Ri[i][j] = _gated(upd, alpha_v * Ri[i][j] + beta * outi, Ri[i][j])
    Lr, Li, _, Dinv = _ldl_factors(Rr, Ri, M, _loading(Rr, M, diag, rel_diag))
    ur, ui = _ldl_solve_factors(Lr, Li, Dinv, ar, ai, M)
    for i in range(M):
        Ur[i] = _gated(upd, ur[i], Ur[i])
        Ui[i] = _gated(upd, ui[i], Ui[i])


def _mvdr_output(zr, zi, ar, ai, Ur, Ui, M):
    """y = w^H z with w = u / (a^H u): (u^H z) / conj(a^H u)."""
    den_r, den_i = _cmul(ar[0], -ai[0], Ur[0], Ui[0])
    nr, ni = _cmul(Ur[0], -Ui[0], zr[0], zi[0])
    for r in range(1, M):
        tr, ti = _cmul(ar[r], -ai[r], Ur[r], Ui[r])  # conj(a) u
        den_r, den_i = den_r + tr, den_i + ti
        tr, ti = _cmul(Ur[r], -Ui[r], zr[r], zi[r])  # conj(u) z
        nr, ni = nr + tr, ni + ti
    dmag = den_r * den_r + den_i * den_i
    return _cmul(nr, ni, den_r / dmag, den_i / dmag)  # times 1 / conj(den)


def _ldl_factor_into(Rr, Ri, M, diag, rel_diag=0.0):
    """Overwrite the covariance state with the LDL^H factors of
    A = R + load I, in place, and return ``load``.

    Runs at the warmup -> rank-1 handover (after the last warmup chunk) and
    inside every re-anchor.  The unit-lower off-diagonals replace
    Rr/Ri[i][j] (i > j) and D replaces the diagonal slots Rr[i][i]; from here
    on the state is the factorisation and ``_mvdr_update_rank1`` maintains
    it."""
    load = _loading(Rr, M, diag, rel_diag)
    Lr, Li, D, _ = _ldl_factors(Rr, Ri, M, load)
    for i in range(M):
        Rr[i][i] = D[i]
        for j in range(i):
            Rr[i][j] = Lr[i][j]
            Ri[i][j] = Li[i][j]
    return load


def _refresh_loading(Rr, Ri, Ld, M, diag, rel_diag):
    """Re-anchor the rank-1 path's trace loading at a chunk start; returns
    the new baked loading.

    The Bennett recursion tracks A = Rvv + baked I where ``baked`` (``Ld``)
    decays by alpha per gated update, while the reference recomputes
    load = diag + rel_diag tr(Rvv)/M every frame.  This rebuilds
    Rvv = L D L^H - baked I from the factors and refactors it with fresh
    loading, so the loading is at most one chunk stale.  Only used when
    rel_diag > 0."""
    Rv = [[None] * M for _ in range(M)]
    Iv = [[None] * M for _ in range(M)]
    for i in range(M):
        acc = Rr[i][i]  # k == i term: D[i] |L[i][i]|^2 = D[i]
        for k in range(i):
            acc = acc + (Rr[i][k] * Rr[i][k] + Ri[i][k] * Ri[i][k]) * Rr[k][k]
        Rv[i][i] = acc - Ld
        for j in range(i):
            # sum_{k<=j} L[i][k] D[k] conj(L[j][k]); k == j term: L[i][j] D[j]
            sr, si = Rr[i][j] * Rr[j][j], Ri[i][j] * Rr[j][j]
            for k in range(j):
                tr, ti = _cmul(Rr[i][k], Ri[i][k], Rr[j][k], -Ri[j][k])
                sr, si = sr + tr * Rr[k][k], si + ti * Rr[k][k]
            Rv[i][j], Iv[i][j] = sr, si
    for i in range(M):
        Rr[i][i] = Rv[i][i]
        for j in range(i):
            Rr[i][j] = Rv[i][j]
            Ri[i][j] = Iv[i][j]
    return _ldl_factor_into(Rr, Ri, M, diag, rel_diag)


def _mvdr_update_rank1(zr, zi, upd, ar, ai, Rr, Ri, Ur, Ui, M, alpha_v, Ld=None):
    """Gated Bennett rank-1 update of the LDL^H factors of A = Rvv + load I,
    plus the triangular solves for u = A^-1 a — the post-warmup path of
    ``inv_mode='rank1'``.  Returns the decayed baked loading (or None).

    Rvv' = alpha Rvv + (1-alpha) z z^H gives
    A' = alpha [A + (b/a) z z^H] + (1-alpha) load I with b/a = (1-alpha)/alpha.
    Dropping the last term (the loading decays as load alpha^n instead of
    staying fixed) makes the update exactly rank-1 in A, and Bennett's
    algorithm applies it directly to the unit-lower / diagonal factors in
    O(M^2): column j consumes the transformed update vector w, inflates d_j
    by sigma |w_j|^2 and rotates the column below it.  Positive-definiteness
    holds by construction (d only grows by a nonnegative term, then scales
    by alpha), which keeps float32 stable where tracking the inverse
    recursively diverges under the sparse vad_guard gate.

    u is then solved fresh each frame from the candidate factors — the same
    two triangular solves as the LDL path, whose error is per frame, not
    recursive.

    Numerics contract: exact up to (a) the loading decay load (1 - alpha^n)
    and (b) the ``rel_diag`` trace loading, honoured through warmup and then
    re-anchored per chunk (``_refresh_loading``)."""
    ba = (1.0 - alpha_v) / alpha_v
    inv_a = 1.0 / alpha_v
    wr = list(zr)
    wi = list(zi)
    Lr = [[None] * M for _ in range(M)]
    Li = [[None] * M for _ in range(M)]
    Dn = [None] * M
    Dinv = [None] * M
    sig = ba
    for j in range(M):
        pr, pi = wr[j], wi[j]
        dj = Rr[j][j] + sig * (pr * pr + pi * pi)
        r = 1.0 / dj  # the one reciprocal per column, re-used as D^-1
        sr = sig * r
        br, bi = sr * pr, -(sr * pi)  # b = sigma conj(p) / d'
        sig = sig * Rr[j][j] * r
        Dn[j] = alpha_v * dj
        Dinv[j] = r * inv_a
        for i in range(j + 1, M):
            tr, ti = _cmul(pr, pi, Rr[i][j], Ri[i][j])
            wr[i], wi[i] = wr[i] - tr, wi[i] - ti
            tr, ti = _cmul(br, bi, wr[i], wi[i])
            Lr[i][j] = Rr[i][j] + tr
            Li[i][j] = Ri[i][j] + ti
    ur, ui = _ldl_solve_factors(Lr, Li, Dinv, ar, ai, M)
    for i in range(M):
        Rr[i][i] = _gated(upd, Dn[i], Rr[i][i])
        Ur[i] = _gated(upd, ur[i], Ur[i])
        Ui[i] = _gated(upd, ui[i], Ui[i])
        for j in range(i):
            Rr[i][j] = _gated(upd, Lr[i][j], Rr[i][j])
            Ri[i][j] = _gated(upd, Li[i][j], Ri[i][j])
    if Ld is None:
        return None
    return _gated(upd, alpha_v * Ld, Ld)
