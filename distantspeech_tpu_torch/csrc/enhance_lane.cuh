// Per-lane math of the flagship fused kernels: MCRA -> gated MVDR -> OM-LSA.
//
// One lane is one (utterance, bin) pair.  Every function mirrors, line for
// line, the plain PyTorch version in ops/cuda_mvdr.py and
// ops/cuda_enhance.py (themselves ports of the lane math of the Pallas
// kernels in distantspeech_tpu/ops/pallas_mvdr.py and pallas_enhance.py).
// The lane state (~100 floats at M = 8) lives in registers for the whole
// utterance: every loop over mics is unrolled on the template M, so each
// matrix element is a register (or, under pressure, a spill slot).
//
// Covariance storage (lower triangle only): Rr[i][j] / Ri[i][j] for i >= j,
// real diagonal in Rr[i][i].  After the rank-1 handover the same slots hold
// the LDL^H factors: unit-lower off-diagonals, real D on the diagonal.
#pragma once

#include <cuda_runtime.h>

// Field order and types are mirrored by _McraParams / _LaneParams in
// ops/cuda_mvdr.py.
struct McraParams {
  int L;
  float alpha_s, one_m_alpha_s, alpha_p, one_m_alpha_p, alpha_d, one_m_alpha_d;
  float delta_s, p_min, p_max;
};

struct LaneParams {
  McraParams mc;
  float b0, b1, b2;
  float alpha_v, beta_v, ba_v, inv_alpha_v;
  float diag, rel_diag_m, p_vad;
  float alpha_xi, one_m_alpha_xi, gmin, log_gmin;
  int vad_guard, rank1, refresh, t_chunk, warm_chunks;
};

template <int M>
struct Lane {
  float Rr[M][M], Ri[M][M];  // lower triangle: covariance, or its LDL^H factors
  float Ur[M], Ui[M];        // held solve u = (Rvv + load I)^-1 a
  float S, Smin, Stmp, P, Lam;  // MCRA
  float Gh, Gam;             // OM-LSA carry: G_H1 and gamma of the previous frame
  float Ld;                  // baked loading of the rank-1 factors
};

struct BinKind {
  bool interior, lead, first, last;
};

__device__ __forceinline__ BinKind bin_kind(int k, int F) {
  return BinKind{k >= 1 && k <= F - 2, k <= F - 2, k == 0, k == F - 1};
}

__device__ __forceinline__ float2 cmul(float ar, float ai, float br, float bi) {
  return make_float2(ar * br - ai * bi, ar * bi + ai * br);
}

template <int M>
__device__ __forceinline__ void lane_init(Lane<M>& s) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) s.Rr[i][j] = s.Ri[i][j] = 0.f;
    s.Ur[i] = s.Ui[i] = 0.f;
  }
  s.S = s.Smin = s.Stmp = s.P = s.Lam = 0.f;
  s.Gh = s.Gam = 1.f;
  s.Ld = 0.f;
}

// The MCRA state of one lane, for kernels that keep it outside a Lane<M>.
struct McraLane {
  float S, Smin, Stmp, P, Lam;
};

// One MCRA frame at global frame tg (the counters ell / frm_cnt in closed
// form: the minima window resets at tg % L == L-1, p is forced to 0 for
// tg < 2L, frame 0 seeds).  St is any state with the fields S, Smin, Stmp,
// P, Lam (Lane<M> or McraLane).  Returns p; writes lambda_d and S/Smin.
template <class St>
__device__ __forceinline__ float mcra_frame(St& s, int tg, float Yp, float Sf, const BinKind& bk,
                                            const McraParams& lp, float& lam, float& sr) {
  float S_out, Smin_out, Stmp_out, p_sel, lam_pre;
  if (tg == 0) {
    S_out = s.S;
    Smin_out = bk.lead ? Yp : s.Smin;
    Stmp_out = bk.lead ? Yp : s.Stmp;
    p_sel = bk.lead ? 0.f : s.P;
    lam_pre = bk.lead ? Yp : s.Lam;
  } else {
    const float S_new = bk.interior ? lp.alpha_s * s.S + lp.one_m_alpha_s * Sf : s.S;
    float Smin1 = fminf(s.Smin, S_new);
    float Stmp1 = fminf(s.Stmp, S_new);
    if (tg % lp.L == lp.L - 1) {
      Smin1 = fminf(Stmp1, S_new);
      Stmp1 = S_new;
    }
    const float Smin_new = bk.interior ? Smin1 : s.Smin;
    const float Stmp_new = bk.interior ? Stmp1 : s.Stmp;
    float p_upd = 0.f;
    if (tg >= 2 * lp.L) {
      const float I = S_new / (Smin_new + 1e-6f) > lp.delta_s ? 1.f : 0.f;
      p_upd = lp.alpha_p * s.P + lp.one_m_alpha_p * I;
    }
    p_sel = bk.first ? 0.f : (bk.interior ? p_upd : s.P);
    S_out = S_new;
    Smin_out = Smin_new;
    Stmp_out = Stmp_new;
    lam_pre = s.Lam;
  }
  const float p = fminf(fmaxf(p_sel, lp.p_min), lp.p_max);
  if (bk.last) lam_pre = 1e-8f;
  const float alpha_t = lp.alpha_d + lp.one_m_alpha_d * p;
  lam = alpha_t * lam_pre + (1.f - alpha_t) * Yp;
  s.S = S_out;
  s.Smin = Smin_out;
  s.Stmp = Stmp_out;
  s.P = p;
  s.Lam = lam;
  sr = S_out / (Smin_out + 1e-6f);
  return p;
}

// load = diag + rel_diag * tr(R) / M
template <int M>
__device__ __forceinline__ float loading(const float (&Rr)[M][M], const LaneParams& lp) {
  if (lp.rel_diag_m == 0.f) return lp.diag;
  float tr = Rr[0][0];
#pragma unroll
  for (int i = 1; i < M; ++i) tr = tr + Rr[i][i];
  return lp.diag + lp.rel_diag_m * tr;
}

// LDL^H of A = R + load I: unit-lower L, real D and 1/D.
template <int M>
__device__ __forceinline__ void ldl_factors(const float (&Rr)[M][M], const float (&Ri)[M][M], float load,
                                            float (&Lr)[M][M], float (&Li)[M][M], float (&D)[M],
                                            float (&Dinv)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float d = Rr[j][j] + load;
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - (Lr[j][k] * Lr[j][k] + Li[j][k] * Li[j][k]) * D[k];
    D[j] = d;
    Dinv[j] = 1.f / d;
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      float sr = Rr[i][j], si = Ri[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) {
        const float2 t = cmul(Lr[i][k], Li[i][k], Lr[j][k], -Li[j][k]);  // L[i][k] conj(L[j][k])
        sr = sr - t.x * D[k];
        si = si - t.y * D[k];
      }
      Lr[i][j] = sr * Dinv[j];
      Li[i][j] = si * Dinv[j];
    }
  }
}

// u = L^-H D^-1 L^-1 a: forward solve (unit diagonal), scale, back solve.
template <int M>
__device__ __forceinline__ void ldl_solve(const float (&Lr)[M][M], const float (&Li)[M][M],
                                          const float (&Dinv)[M], const float (&ar)[M], const float (&ai)[M],
                                          float (&ur)[M], float (&ui)[M]) {
  float vr[M], vi[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float sr = ar[i], si = ai[i];
#pragma unroll
    for (int k = 0; k < i; ++k) {
      const float2 t = cmul(Lr[i][k], Li[i][k], vr[k], vi[k]);
      sr = sr - t.x;
      si = si - t.y;
    }
    vr[i] = sr;
    vi[i] = si;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    vr[i] = vr[i] * Dinv[i];
    vi[i] = vi[i] * Dinv[i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float sr = vr[i], si = vi[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) {
      const float2 t = cmul(Lr[k][i], -Li[k][i], ur[k], ui[k]);  // conj(L[k][i]) u[k]
      sr = sr - t.x;
      si = si - t.y;
    }
    ur[i] = sr;
    ui[i] = si;
  }
}

// Open-gate frame of the LDL path: rank-1 update of the covariance, then
// u = (R + load I)^-1 a with the loading taken from the updated R.  (The
// plain version computes this for every lane and selects by the gate; here
// a closed gate skips it, which holds the same state.)
template <int M>
__device__ __forceinline__ void mvdr_update_ldl(Lane<M>& s, const float (&zr)[M], const float (&zi)[M],
                                                const float (&ar)[M], const float (&ai)[M],
                                                const LaneParams& lp) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (i == j) {
        const float out = zr[i] * zr[i] + zi[i] * zi[i];
        s.Rr[i][i] = lp.alpha_v * s.Rr[i][i] + lp.beta_v * out;
      } else {
        const float outr = zr[i] * zr[j] + zi[i] * zi[j];
        const float outi = zi[i] * zr[j] - zr[i] * zi[j];
        s.Rr[i][j] = lp.alpha_v * s.Rr[i][j] + lp.beta_v * outr;
        s.Ri[i][j] = lp.alpha_v * s.Ri[i][j] + lp.beta_v * outi;
      }
    }
  }
  float Lr[M][M], Li[M][M], D[M], Dinv[M];
  ldl_factors<M>(s.Rr, s.Ri, loading<M>(s.Rr, lp), Lr, Li, D, Dinv);
  ldl_solve<M>(Lr, Li, Dinv, ar, ai, s.Ur, s.Ui);
}

// y = w^H z with w = u / (a^H u): (u^H z) / conj(a^H u).
template <int M>
__device__ __forceinline__ float2 mvdr_output(const float (&zr)[M], const float (&zi)[M], const float (&ar)[M],
                                              const float (&ai)[M], const float (&Ur)[M], const float (&Ui)[M]) {
  float2 den = cmul(ar[0], -ai[0], Ur[0], Ui[0]);
  float2 num = cmul(Ur[0], -Ui[0], zr[0], zi[0]);
#pragma unroll
  for (int r = 1; r < M; ++r) {
    float2 t = cmul(ar[r], -ai[r], Ur[r], Ui[r]);  // conj(a) u
    den.x = den.x + t.x;
    den.y = den.y + t.y;
    t = cmul(Ur[r], -Ui[r], zr[r], zi[r]);  // conj(u) z
    num.x = num.x + t.x;
    num.y = num.y + t.y;
  }
  const float dmag = den.x * den.x + den.y * den.y;
  return cmul(num.x, num.y, den.x / dmag, den.y / dmag);
}

// Overwrite the covariance with the LDL^H factors of R + load I, in place;
// returns load.  Runs at the warmup -> rank-1 handover and in every
// re-anchor.
template <int M>
__device__ __forceinline__ float ldl_factor_into(float (&Rr)[M][M], float (&Ri)[M][M], const LaneParams& lp) {
  const float load = loading<M>(Rr, lp);
  float Lr[M][M], Li[M][M], D[M], Dinv[M];
  ldl_factors<M>(Rr, Ri, load, Lr, Li, D, Dinv);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    Rr[i][i] = D[i];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      Rr[i][j] = Lr[i][j];
      Ri[i][j] = Li[i][j];
    }
  }
  return load;
}

// Re-anchor the trace loading of the rank-1 factors at a chunk start:
// rebuild Rvv = L D L^H - baked I and refactor with fresh loading; returns
// the new baked loading.
template <int M>
__device__ __forceinline__ float refresh_loading(float (&Rr)[M][M], float (&Ri)[M][M], float baked,
                                                 const LaneParams& lp) {
  float Rv[M][M], Iv[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float acc = Rr[i][i];  // k == i term: D[i] |L[i][i]|^2 = D[i]
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc + (Rr[i][k] * Rr[i][k] + Ri[i][k] * Ri[i][k]) * Rr[k][k];
    Rv[i][i] = acc - baked;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      // sum_{k<=j} L[i][k] D[k] conj(L[j][k]); k == j term: L[i][j] D[j]
      float sr = Rr[i][j] * Rr[j][j], si = Ri[i][j] * Rr[j][j];
#pragma unroll
      for (int k = 0; k < j; ++k) {
        const float2 t = cmul(Rr[i][k], Ri[i][k], Rr[j][k], -Ri[j][k]);
        sr = sr + t.x * Rr[k][k];
        si = si + t.y * Rr[k][k];
      }
      Rv[i][j] = sr;
      Iv[i][j] = si;
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    Rr[i][i] = Rv[i][i];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      Rr[i][j] = Rv[i][j];
      Ri[i][j] = Iv[i][j];
    }
  }
  return ldl_factor_into<M>(Rr, Ri, lp);
}

// Open-gate frame of the rank-1 path: Bennett's update of the LDL^H factors
// of A = Rvv + load I by the rank-1 term, A' = alpha [A + (b/a) z z^H]
// (the loading decays as load alpha^n), applied column by column in O(M^2):
// column j consumes the transformed update vector w, inflates d_j by
// sigma |w_j|^2 and rotates the column below it.  d only grows by a
// nonnegative term, then scales by alpha, so the factors stay positive
// definite by construction.  u is then solved fresh from the new factors.
template <int M>
__device__ __forceinline__ void mvdr_update_rank1(Lane<M>& s, const float (&zr)[M], const float (&zi)[M],
                                                  const float (&ar)[M], const float (&ai)[M],
                                                  const LaneParams& lp) {
  float wr[M], wi[M], Lr[M][M], Li[M][M], Dn[M], Dinv[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    wr[i] = zr[i];
    wi[i] = zi[i];
  }
  float sig = lp.ba_v;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float pr = wr[j], pi = wi[j];
    const float dj = s.Rr[j][j] + sig * (pr * pr + pi * pi);
    const float r = 1.f / dj;  // the one reciprocal per column, re-used as D^-1
    const float sr = sig * r;
    const float br = sr * pr, bi = -(sr * pi);  // b = sigma conj(p) / d'
    sig = sig * s.Rr[j][j] * r;
    Dn[j] = lp.alpha_v * dj;
    Dinv[j] = r * lp.inv_alpha_v;
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      float2 t = cmul(pr, pi, s.Rr[i][j], s.Ri[i][j]);
      wr[i] = wr[i] - t.x;
      wi[i] = wi[i] - t.y;
      t = cmul(br, bi, wr[i], wi[i]);
      Lr[i][j] = s.Rr[i][j] + t.x;
      Li[i][j] = s.Ri[i][j] + t.y;
    }
  }
  ldl_solve<M>(Lr, Li, Dinv, ar, ai, s.Ur, s.Ui);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    s.Rr[i][i] = Dn[i];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      s.Rr[i][j] = Lr[i][j];
      s.Ri[i][j] = Li[i][j];
    }
  }
  if (lp.refresh) s.Ld = lp.alpha_v * s.Ld;
}

// The decision-directed OM-LSA gain on the MVDR output y, from the MCRA
// speech presence p and noise PSD lam: G = clip(G_H1^p gmin^(1-p), gmin, 1)
// through exp / log.  Updates the (G_H1, gamma) carry; returns y G.
template <int M>
__device__ __forceinline__ float2 omlsa_gain(Lane<M>& s, float2 y, float p, float lam, const LaneParams& lp) {
  const float gamma = (y.x * y.x + y.y * y.y) / fmaxf(lam, 1e-10f);
  const float xi = lp.alpha_xi * (s.Gh * s.Gh) * s.Gam + lp.one_m_alpha_xi * fmaxf(gamma - 1.f, 0.f);
  const float G_H1 = xi / (1.f + xi);
  const float logG = p * logf(fmaxf(G_H1, 1e-30f)) + (1.f - p) * lp.log_gmin;
  const float G = fminf(fmaxf(expf(logG), lp.gmin), 1.f);
  s.Gh = G_H1;
  s.Gam = gamma;
  return make_float2(y.x * G, y.y * G);
}

// One full frame of one lane: chunk bookkeeping of inv_mode='rank1',
// MCRA, the covariance gate, the MVDR update and output, and the OM-LSA
// gain.  Returns the gained output bin.
template <int M>
__device__ __forceinline__ float2 lane_frame(Lane<M>& s, const float (&zr)[M], const float (&zi)[M],
                                             const float (&ar)[M], const float (&ai)[M], float Sf, int tg,
                                             const BinKind& bk, const LaneParams& lp) {
  const int chunk = tg / lp.t_chunk;
  const int pos = tg - chunk * lp.t_chunk;
  const bool steady = lp.rank1 && chunk >= lp.warm_chunks;
  if (steady && lp.refresh && pos == 0 && chunk >= lp.warm_chunks + 1)
    s.Ld = refresh_loading<M>(s.Rr, s.Ri, s.Ld, lp);

  float lam, sr;
  const float p = mcra_frame(s, tg, zr[0] * zr[0] + zi[0] * zi[0], Sf, bk, lp.mc, lam, sr);
  bool upd = p < lp.p_vad;
  if (lp.vad_guard) upd = upd && sr <= lp.mc.delta_s;
  if (upd) {
    if (steady)
      mvdr_update_rank1<M>(s, zr, zi, ar, ai, lp);
    else
      mvdr_update_ldl<M>(s, zr, zi, ar, ai, lp);
  }
  const float2 y = omlsa_gain<M>(s, mvdr_output<M>(zr, zi, ar, ai, s.Ur, s.Ui), p, lam, lp);

  if (lp.rank1 && chunk == lp.warm_chunks - 1 && pos == lp.t_chunk - 1) {  // handover: factor in place
    const float load = ldl_factor_into<M>(s.Rr, s.Ri, lp);
    if (lp.refresh) s.Ld = load;
  }
  return y;
}
