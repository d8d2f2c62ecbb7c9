"""Per-lane MVDR math of the fused kernels, in plain PyTorch, and kernel K1.

Counterpart of ``distantspeech_tpu/ops/pallas_mvdr.py``: its lane functions
are the plain version of the device functions in ``csrc/enhance_lane.cuh``,
which follow these line by line, and ``fused_mvdr_scan`` replaces its
Pallas kernel ``pallas_mvdr_scan`` (``_mvdr_kernel`` and
``_mvdr_omlsa_kernel``) with the CUDA kernel of ``csrc/mvdr.cu``.  A lane is one (utterance, bin) pair; every
quantity here is a list of per-mic [B, F] real tensors (split complex), and
the state is held in nested lists that the functions update in place:

- ``Rr[i][j]`` / ``Ri[i][j]`` for i >= j: the lower triangle of the noise
  covariance Rvv (real diagonal in ``Rr[i][i]``), or, after the rank-1
  handover, its LDL^H factors (unit-lower off-diagonals in ``[i][j]``, real
  D on the diagonal slots);
- ``Ur[i]`` / ``Ui[i]``: the held solve u = (Rvv + load I)^-1 a.

A gate ``upd`` (bool [B, F], or None for always) selects per lane between
the updated and the held state, as the reference's VAD gate does.

``fused_mvdr_scan`` is the frame loop of the ``pallas`` backend: spectra,
an external covariance gate and, optionally, the MCRA tracks p and
lambda_d in; the MVDR output (with the OM-LSA gain when p and lambda_d are
given) out.  The gate is an input, so no MCRA runs in the kernel, and the
kernel and its plain version see the same gate decisions.  The TPU
kernel's tiling (``f_tile``, ``t_chunk``, the joint 8 x ``f_tile`` lane
packing and its padding) is dropped: one CUDA thread runs one (utterance,
bin) lane through every frame, and the ragged last block is masked.
Without a rank-1 mode the numerics do not depend on any chunking.

What bounds K1 on an H100 at the flagship size (B=64, M=8, 4 s, T=500,
F=129): it moves the spectra, the gate and the MCRA tracks in and the
output out (~350 MB, ~0.1 ms at 3.35 TB/s) and does ~5e9 float32
operations, nearly all on the open-gate frames (~0.08 ms at 67 TFLOP/s),
so bytes bound it.  This first version reads each lane's M
complex inputs as M float2 loads, which neighbouring threads issue at a
stride of M * 8 bytes, and keeps the lane state in registers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from distantspeech_tpu_torch.ops import _build

LAUNCHES = {"fused_mvdr_scan": 0}
_KERNEL_MICS = range(2, 9)  # the M the CUDA templates are instantiated for: 2 to 8


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


def _omlsa_gain(yr, yi, p, lam, Gh, Gam, alpha_xi: float, gmin: float):
    """The decision-directed OM-LSA gain on the MVDR output (y = yr + i yi):
    G = clip(G_H1^p gmin^(1-p), gmin, 1) through exp / log, with the
    previous frame's (G_H1, gamma) carry.  Returns ((yr G, yi G), G_H1,
    gamma)."""
    gamma = (yr * yr + yi * yi) / torch.clamp(lam, min=1e-10)
    xi = alpha_xi * Gh**2 * Gam + (1.0 - alpha_xi) * torch.clamp(gamma - 1.0, min=0.0)
    G_H1 = xi / (1.0 + xi)
    logG = p * torch.log(torch.clamp(G_H1, min=1e-30)) + (1.0 - p) * float(np.log(gmin))
    G = torch.clamp(torch.exp(logG), gmin, 1.0)
    return (yr * G, yi * G), G_H1, gamma


def _validate_scan(Z, p, lam):
    if (p is None) != (lam is None):
        raise ValueError(
            "fused_mvdr_scan: the fused OM-LSA mode needs BOTH p and lam "
            f"(got p={'set' if p is not None else 'None'}, lam={'set' if lam is not None else 'None'})"
        )
    if Z.ndim != 4:
        raise ValueError(f"fused_mvdr_scan: Z must be [T, B, F, M] (4-D), got shape {tuple(Z.shape)}")


def fused_mvdr_scan_plain(
    Z, gate, steer, alpha_v: float = 0.9998, diag: float = 1e-6, rel_diag: float = 0.0,
    p=None, lam=None, alpha_xi: float = 0.92, gmin: float = 0.0631,
) -> torch.Tensor:
    """Plain version of ``fused_mvdr_scan`` (any dtype, any device).

    Z: [T, B, F, M] complex spectra; gate: [T, B, F] (> 0.5 updates the
    noise covariance that frame); steer: [F, M] complex.  With p and lam
    ([T, B, F], the MCRA tracks) the OM-LSA gain is applied per frame.
    Returns Y [T, B, F] in Z's dtype."""
    _validate_scan(Z, p, lam)
    T, B, F, M = Z.shape
    steer = torch.as_tensor(steer, device=Z.device).to(Z.dtype)
    ar = [steer[:, m].real for m in range(M)]
    ai = [steer[:, m].imag for m in range(M)]
    zero = Z.real.new_zeros((B, F))
    Rr = [[zero] * M for _ in range(M)]
    Ri = [[zero] * M for _ in range(M)]
    Ur, Ui = [zero] * M, [zero] * M
    Gh = Gam = torch.ones_like(zero)
    Y = Z.new_empty((T, B, F))
    for t in range(T):
        zr = [Z[t, ..., m].real for m in range(M)]
        zi = [Z[t, ..., m].imag for m in range(M)]
        _mvdr_update_ldl(zr, zi, gate[t] > 0.5, ar, ai, Rr, Ri, Ur, Ui, M, alpha_v, diag, rel_diag)
        yr, yi = _mvdr_output(zr, zi, ar, ai, Ur, Ui, M)
        if p is not None:
            (yr, yi), Gh, Gam = _omlsa_gain(yr, yi, p[t], lam[t], Gh, Gam, alpha_xi, gmin)
        Y[t] = torch.complex(yr, yi)
    return Y


# ---- the CUDA side ----------------------------------------------------------


class _McraParams(ctypes.Structure):
    """Mirror of ``McraParams`` in csrc/enhance_lane.cuh."""

    _fields_ = [
        ("L", ctypes.c_int),
        ("alpha_s", ctypes.c_float), ("one_m_alpha_s", ctypes.c_float),
        ("alpha_p", ctypes.c_float), ("one_m_alpha_p", ctypes.c_float),
        ("alpha_d", ctypes.c_float), ("one_m_alpha_d", ctypes.c_float),
        ("delta_s", ctypes.c_float), ("p_min", ctypes.c_float), ("p_max", ctypes.c_float),
    ]


def _mcra_params(mc) -> _McraParams:
    """An McraConfig as kernel parameters; 1 - alpha is computed in double,
    as the plain version's Python scalars are."""
    return _McraParams(
        L=mc.L,
        alpha_s=mc.alpha_s, one_m_alpha_s=1.0 - mc.alpha_s,
        alpha_p=mc.alpha_p, one_m_alpha_p=1.0 - mc.alpha_p,
        alpha_d=mc.alpha_d, one_m_alpha_d=1.0 - mc.alpha_d,
        delta_s=mc.delta_s, p_min=mc.p_min, p_max=mc.p_max,
    )


class _LaneParams(ctypes.Structure):
    """Mirror of ``LaneParams`` in csrc/enhance_lane.cuh (field order and
    types must match).  Derived constants (1 - alpha, ...) are computed
    here in double, as the plain version's Python scalars are."""

    _fields_ = [
        ("mc", _McraParams),
        ("b0", ctypes.c_float), ("b1", ctypes.c_float), ("b2", ctypes.c_float),
        ("alpha_v", ctypes.c_float), ("beta_v", ctypes.c_float),
        ("ba_v", ctypes.c_float), ("inv_alpha_v", ctypes.c_float),
        ("diag", ctypes.c_float), ("rel_diag_m", ctypes.c_float), ("p_vad", ctypes.c_float),
        ("alpha_xi", ctypes.c_float), ("one_m_alpha_xi", ctypes.c_float),
        ("gmin", ctypes.c_float), ("log_gmin", ctypes.c_float),
        ("vad_guard", ctypes.c_int), ("rank1", ctypes.c_int), ("refresh", ctypes.c_int),
        ("t_chunk", ctypes.c_int), ("warm_chunks", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = _build.load("mvdr")
    if not getattr(lib, "_signatures_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_mvdr_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p]
        lib.fused_mvdr_scan_launch.restype = i
        lib._signatures_set = True
    return lib


def fused_mvdr_scan(
    Z, gate, steer, alpha_v: float = 0.9998, diag: float = 1e-6, rel_diag: float = 0.0,
    p=None, lam=None, alpha_xi: float = 0.92, gmin: float = 0.0631,
) -> torch.Tensor:
    """The K1 kernel: the gated MVDR frame loop, optionally with the OM-LSA
    gain fused in.  Same arguments and result as ``fused_mvdr_scan_plain``,
    which CPU tensors run; a CUDA tensor launches the kernel (complex64 Z,
    float32 p and lam, M from 2 to 8) or raises."""
    _validate_scan(Z, p, lam)
    if Z.device.type == "cpu":
        return fused_mvdr_scan_plain(Z, gate, steer, alpha_v, diag, rel_diag, p, lam, alpha_xi, gmin)
    T, B, F, M = Z.shape
    if Z.dtype != torch.complex64:
        raise ValueError(f"fused_mvdr_scan: the kernel takes complex64 spectra, got {Z.dtype}")
    if M not in _KERNEL_MICS:
        raise ValueError(f"fused_mvdr_scan: the kernel is built for M from 2 to 8, got M={M}")
    Zf = torch.view_as_real(Z.contiguous())  # [T, B, F, M, 2]
    g = gate.to(torch.float32).contiguous()
    sv = torch.view_as_real(torch.as_tensor(steer, device=Z.device).to(torch.complex64).contiguous())
    extra = () if p is None else (p.contiguous(), lam.contiguous())
    _build.check_tensors("fused_mvdr_scan", Zf, g, sv, *extra)
    if g.shape != (T, B, F) or sv.shape != (F, M, 2) or any(a.shape != (T, B, F) for a in extra):
        raise ValueError("fused_mvdr_scan: gate, p and lam must be [T, B, F] and steer [F, M]")
    Y = torch.empty((T, B, F, 2), dtype=torch.float32, device=Z.device)
    params = _LaneParams(
        alpha_v=alpha_v, beta_v=1.0 - alpha_v, diag=diag, rel_diag_m=rel_diag / M,
        alpha_xi=alpha_xi, one_m_alpha_xi=1.0 - alpha_xi, gmin=gmin, log_gmin=float(np.log(gmin)),
    )
    p_ptr, lam_ptr = (a.data_ptr() for a in extra) if extra else (None, None)
    err = _library().fused_mvdr_scan_launch(
        Zf.data_ptr(), g.data_ptr(), p_ptr, lam_ptr, sv.data_ptr(), Y.data_ptr(),
        M, T, B, F, ctypes.addressof(params), torch.cuda.current_stream(Z.device).cuda_stream,
    )
    _build.check_launch("mvdr", err, "fused_mvdr_scan")
    LAUNCHES["fused_mvdr_scan"] += 1
    return torch.view_as_complex(Y)
