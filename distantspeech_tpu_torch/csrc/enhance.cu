// The flagship's two CUDA kernels and their C launchers.
//
// fused_enhance_rows_kernel replaces distantspeech_tpu/ops/pallas_enhance.py
// fused_enhance (_enhance_kernel + its Nyquist companion): spectra in,
// gained spectra out, a lane per (utterance, bin) looping over every frame
// with the lane's state in registers.  Inputs are laid out with the lane
// index b*F + k contiguous.  Up to 16 mics a group of threads runs a lane,
// the rows of its covariance (then factors) split between them (below, by
// the kernel): at the flagship size (B = 64, F = 129) a thread pair a lane,
// 129 blocks.  The first design ran one thread a lane (65 blocks of 128, 1.226
// ms); the frame-parallel layout of K1 (4 threads each applying every
// frame's update) repeated Bennett's update on every thread and ran slower
// (PERF.md keeps every layout's time).
//
// fused_enhance_full_kernel replaces pallas_enhance.py fused_enhance_full
// (_mega_kernel + its Nyquist companion): waveform [B, M, S] in, waveform
// [B, S] out, one 256-thread block per utterance, the spectra never in
// device memory.  The block is split by warps.  The 5 lane warps run the
// lane recursion of frame t, one thread per bin (two at n_fft = 512, four at
// 1024).  Meanwhile the FFT warps (the other 3) window and transform frame
// t + 1 into the other slot of a two-slot spectrum ring, and invert, window
// and overlap-add frame t - 1's gained spectrum.  One block barrier a frame
// hands the slots over: the analysis does not depend on the lane state, so
// the transforms hide behind the lane chain instead of adding to it.  The
// analysis packs the M mics in pairs, x_{2j} + i x_{2j+1} (the mics of one
// scene are of like magnitude; an odd M's last pair holds one mic and a
// zero), as ceil(M / 2) complex N-point FFTs (flms_fft.cuh's warp-owned
// radix-8 passes; split_pair recovers each mic's bins, 0 and N/2 exactly
// real); |z_0|^2 for MCRA's 3-tap smoothing goes into the ring beside the
// spectra.  The synthesis is one inverse (put_pair with an empty second
// half) a frame.  Each transform is owned by one FFT warp, the FFT warps
// meet on a named barrier of their own, and the next hop-block of every
// mic is prefetched with cp.async into a three-slot ring.
//
// Where the lane state lives.  At n_fft 256 (every M) and at 512 with M <= 4
// each lane thread holds its bins' states in registers for the whole
// utterance.  Twice the state of 5 to 8 mics does not fit a thread's 255
// registers, nor do four bins at 1024: there (kMem) each thread runs its
// bins one after another, loading a bin's state into registers, running
// the frame and storing it back, field-major, in shared memory where it fits
// beside the rest of the block's buffers, else in a global scratch of
// lane_fields(M) x F floats an utterance (1024 with 8 mics: 180 KB an
// utterance, which stays in L2).  fused_enhance_full_scratch_floats tells
// the wrapper how much scratch a shape needs.
//
// What bounds them on an H100 (B = 64, M = 8, 4 s): the mega kernel by
// operations (it moves 147 MB and does ~5.5e9 float32 operations with its
// transforms as real FFTs), the lane kernel by bytes (314 MB of spectra in
// and out against ~4e9 operations).  Neither design reaches its bound: the
// lane recursion is a serial chain of frames (the mega kernel's one block
// per utterance leaves 64 of 132 SMs busy at B = 64), and the M = 8 lane
// state takes up to 255 registers a thread; chip_smoke.py prints the lane
// kernel's chain floor beside its bound.  The mega kernel's first design
// computed each bin's DFT as a direct sum against cos/sin tables and took
// 9.516 ms on an H100 at 700 W (PERF.md's kernel table keeps both
// times).
#include <cuda_runtime.h>

#include "fft_mixed.cuh"
#include "flms_fft.cuh"

namespace {

constexpr int kLaneThreads = 128;
constexpr int kLaneGroup8 = 2;  // threads a lane of the lane kernel up to 8 mics
constexpr int kMemLanes = 32;  // lanes a block of the lane kernel above 16 mics
constexpr size_t kMaxSmemBytes = 232448;  // a Hopper block's dynamic shared memory with the opt-in
constexpr int kFullThreads = 256;   // the mega kernel: kFullLaneWarps lane warps, the rest FFT warps
constexpr int kFullLaneWarps = 5;

template <int M>
__device__ __forceinline__ void load_steering(const float* __restrict__ steer, int F, int k, float (&ar)[M],
                                              float (&ai)[M]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    ar[m] = steer[(2 * m) * F + k];
    ai[m] = steer[(2 * m + 1) * F + k];
  }
}

// ---- K2 up to 16 mics: G threads a lane, its rows split -------------------------

// 1 / x for a normal x > 0 without IEEE division's slow-path branch (which
// splits the code it sits in for the scheduler): MUFU.RCP and one Newton
// step, within an ulp of 1.f / x.
__device__ __forceinline__ float rcp_nr(float x) {
  const float r = __fdividef(1.f, x);
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

// Row i of a lane lies with thread row_owner(i, G) of its group: slot q holds
// rows G q .. G q + G - 1, on the threads in reverse order where q is even
// and in order where q is odd, so that each thread's rows of the lower
// triangle hold an even share of its entries (M = 8: rows 1, 2, 5, 6 and
// 0, 3, 4, 7 at G = 2, 14 entries each; 3, 4 / 2, 5 / 1, 6 / 0, 7 at G = 4,
// 7 each).
__host__ __device__ constexpr int row_owner(int i, int G) { return (i / G) & 1 ? i % G : G - 1 - i % G; }

// One thread's share of a lane: its rows' strictly lower entries (column <
// row; R in the warmup, the LDL^H factors after the handover), every row's
// diagonal (R's, or the factors' D), its rows' held u, and the lane's
// scalars (every thread of the group holds them alike).
template <int M, int G>
struct RowLane {
  static constexpr int Q = (M + G - 1) / G;  // slots
  float Rr[Q][M], Ri[Q][M], D[M], Ur[Q], Ui[Q];
  float S, Smin, Stmp, P, Lam, Gh, Gam, Ld;
};

// The lane recursion of lane_frame on a group of G threads, each on its
// rows.  Every row-wise step takes a row's terms in the plain version's
// order: the covariance update, the LDL^H factorisation (row j's diagonal
// and factors go from its owner to the group by shuffle before the rows
// below take their column-j terms), Bennett's update (p = w_j by shuffle,
// the column's scalars on every thread, each row below j updated by its
// owner) and the forward solve (v_k by shuffle as it settles).  The back
// solve sums each u_i's terms by owner, and the group's shares meet by
// __shfl_xor_sync (the same sum on every thread); a^H u and u^H z likewise.
// MCRA, the gate, the chunk bookkeeping and the gain run on every thread
// alike.  Where a slot's row lies at or above the column in hand, its
// thread's step writes only storage no later step reads (a spent w or v, a
// factor's column at or past its row), so the loops run without a test of
// the row.  A warp runs an update where any of its lanes' gates is open
// (its shuffles need the whole warp), and a closed lane keeps its state.
// The reciprocals (the factorisation's D_j, Bennett's d'_j, the output's
// |a^H u|^2, the gain's two divisors) are rcp_nr's: IEEE division cost
// 13% (PERF.md); MCRA's S / Smin stays IEEE, since a threshold reads it.
// z [T, M, 2, B*F], sf [T, B*F], steer [M, 2, F] -> y [T, 2, B*F]
template <int M, int G>
__global__ void __launch_bounds__(kLaneThreads) fused_enhance_rows_kernel(const float* __restrict__ z,
                                                                          const float* __restrict__ sf,
                                                                          const float* __restrict__ steer,
                                                                          float* __restrict__ y, int B, int F, int T,
                                                                          LaneParams lp) {
  constexpr int Q = RowLane<M, G>::Q;
  const int NL = B * F;
  const int gid = blockIdx.x * kLaneThreads + threadIdx.x;
  const int h = threadIdx.x & (G - 1);
  const int base = (threadIdx.x & 31) & ~(G - 1);
  const bool live = gid / G < NL;
  const int lane = live ? gid / G : NL - 1;  // a group past the end runs the last lane and writes nothing
  const int k = lane % F;
  const BinKind bk = bin_kind(k, F);
  // this thread's row of slot q (M where M leaves it none)
  auto row = [&](int q) { return min(G * q + (q & 1 ? h : G - 1 - h), M); };
  auto from_owner = [&](float v, int i) { return __shfl_sync(0xffffffffu, v, base + row_owner(i, G)); };
  auto group_sum = [](float v) {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  // element r of a per-row vector every thread holds, r a row of slot q
  auto pick = [](const float (&v)[M], int q, int r) {
    float x = v[G * q];
#pragma unroll
    for (int o = 1; o < G; ++o)
      if (G * q + o < M && r == G * q + o) x = v[G * q + o];
    return x;
  };
  auto set = [](float& x, float v, bool c) { x = c ? v : x; };
  // loading(): diag + rel_diag tr(R) / M from the diagonal every thread holds
  auto loading_of = [&](const float (&d)[M]) {
    if (lp.rel_diag_m == 0.f) return lp.diag;
    float tr = d[0];
#pragma unroll
    for (int i = 1; i < M; ++i) tr = tr + d[i];
    return lp.diag + lp.rel_diag_m * tr;
  };

  float ar[Q], ai[Q];  // its rows' steering
  RowLane<M, G> s;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = row(q);
    ar[q] = r < M ? steer[(2 * r) * F + k] : 0.f;
    ai[q] = r < M ? steer[(2 * r + 1) * F + k] : 0.f;
    s.Ur[q] = s.Ui[q] = 0.f;
#pragma unroll
    for (int c = 0; c < M; ++c) s.Rr[q][c] = s.Ri[q][c] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) s.D[i] = 0.f;
  s.S = s.Smin = s.Stmp = s.P = s.Lam = 0.f;
  s.Gh = s.Gam = 1.f;
  s.Ld = 0.f;

  // LDL^H of A + load I (A: the rows Ar / Ai and the diagonal Ad) into the
  // rows Lr / Li, Dn and Dinv; in place where L is A
  auto factor = [&](float (&Ar)[Q][M], float (&Ai)[Q][M], const float (&Ad)[M], float load, float (&Lr)[Q][M],
                    float (&Li)[Q][M], float (&Dn)[M], float (&Dinv)[M]) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int qj = j / G;
      float d = Ad[j] + load;  // row j's owner: its diagonal's terms
#pragma unroll
      for (int c = 0; c < j; ++c) d = d - (Lr[qj][c] * Lr[qj][c] + Li[qj][c] * Li[qj][c]) * Dn[c];
      d = from_owner(d, j);
      Dn[j] = d;
      Dinv[j] = rcp_nr(d);
      float lr[M], li[M];  // row j's factors
#pragma unroll
      for (int c = 0; c < j; ++c) {
        lr[c] = from_owner(Lr[qj][c], j);
        li[c] = from_owner(Li[qj][c], j);
      }
#pragma unroll
      for (int q = qj; q < Q; ++q) {
        float sr = Ar[q][j], si = Ai[q][j];
#pragma unroll
        for (int c = 0; c < j; ++c) {
          const float2 t = cmul(Lr[q][c], Li[q][c], lr[c], -li[c]);  // L[i][c] conj(L[j][c])
          sr = sr - t.x * Dn[c];
          si = si - t.y * Dn[c];
        }
        Lr[q][j] = sr * Dinv[j];
        Li[q][j] = si * Dinv[j];
      }
    }
  };

  // u = L^-H D^-1 L^-1 a into the held u where c
  auto solve = [&](const float (&Lr)[Q][M], const float (&Li)[Q][M], const float (&Dinv)[M], bool c) {
    float vr[M], vi[M], accr[Q], acci[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      accr[q] = ar[q];
      acci[q] = ai[q];
    }
#pragma unroll
    for (int kk = 0; kk < M; ++kk) {  // forward: v_kk settles on its owner, then goes to the group
      vr[kk] = from_owner(accr[kk / G], kk);
      vi[kk] = from_owner(acci[kk / G], kk);
#pragma unroll
      for (int q = kk / G; q < Q; ++q) {
        const float2 t = cmul(Lr[q][kk], Li[q][kk], vr[kk], vi[kk]);
        accr[q] = accr[q] - t.x;
        acci[q] = acci[q] - t.y;
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      vr[i] = vr[i] * Dinv[i];
      vi[i] = vi[i] * Dinv[i];
    }
    float pr[M], pi[M];  // back: this thread's rows' terms of each u_i, conj(L[r][i]) u_r
#pragma unroll
    for (int i = 0; i < M; ++i) pr[i] = pi[i] = 0.f;
#pragma unroll
    for (int q = Q - 1; q >= 0; --q) {
      const int r = row(q);
      float ur = 0.f, ui = 0.f;  // its row's u
#pragma unroll
      for (int o = G - 1; o >= 0; --o) {  // the slot's rows from the last: u_i, then row i's terms below it
        const int i = G * q + o;
        if (i >= M) continue;
        const float uir = vr[i] - group_sum(pr[i]), uii = vi[i] - group_sum(pi[i]);
        set(ur, uir, r == i);
        set(ui, uii, r == i);
#pragma unroll
        for (int i2 = G * q; i2 < i; ++i2) {
          const float2 t = cmul(Lr[q][i2], -Li[q][i2], uir, uii);
          set(pr[i2], pr[i2] + t.x, r == i);
          set(pi[i2], pi[i2] + t.y, r == i);
        }
      }
      if (G * q + G > M && r >= M) continue;  // M leaves this thread no row in the last slot
      set(s.Ur[q], ur, c);
      set(s.Ui[q], ui, c);
#pragma unroll
      for (int i = 0; i < G * q; ++i) {
        const float2 t = cmul(Lr[q][i], -Li[q][i], ur, ui);
        pr[i] = pr[i] + t.x;
        pi[i] = pi[i] + t.y;
      }
    }
  };

  float zr[M], zi[M], sft = 0.f;  // frame t's inputs; frame t + 1's loaded before frame t's chain
  auto load = [&](int t, float (&xr)[M], float (&xi)[M], float& sv) {
    const float* zt = z + (size_t)t * M * 2 * NL;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      xr[m] = zt[(size_t)(2 * m) * NL + lane];
      xi[m] = zt[(size_t)(2 * m + 1) * NL + lane];
    }
    sv = sf[(size_t)t * NL + lane];
  };
  if (T > 0) load(0, zr, zi, sft);
  int chunk = 0, pos = 0;  // frame t = chunk t_chunk + pos
  for (int t = 0; t < T; ++t) {
    float nzr[M], nzi[M], nsf = 0.f;
    if (t + 1 < T) load(t + 1, nzr, nzi, nsf);
    const bool steady = lp.rank1 && chunk >= lp.warm_chunks;
    if (steady && lp.refresh && pos == 0 && chunk >= lp.warm_chunks + 1) {
      // re-anchor: R = L D L^H - baked I in place (the diagonal first,
      // then the columns from the last, row j's factors from its owner),
      // then the factors of R + fresh load I
      float nd[M], acc[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = row(q);
        acc[q] = pick(s.D, q, r);
#pragma unroll
        for (int c = 0; c < G * q + G - 1 && c < M; ++c) {
          const float t = acc[q] + (s.Rr[q][c] * s.Rr[q][c] + s.Ri[q][c] * s.Ri[q][c]) * s.D[c];
          if (c < G * q)
            acc[q] = t;
          else
            set(acc[q], t, c < r);
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i) nd[i] = from_owner(acc[i / G], i);
#pragma unroll
      for (int j = M - 2; j >= 0; --j) {
        const int qj = j / G;
        float lr[M], li[M];
#pragma unroll
        for (int c = 0; c < j; ++c) {
          lr[c] = from_owner(s.Rr[qj][c], j);
          li[c] = from_owner(s.Ri[qj][c], j);
        }
#pragma unroll
        for (int q = qj; q < Q; ++q) {
          float sr = s.Rr[q][j] * s.D[j], si = s.Ri[q][j] * s.D[j];
#pragma unroll
          for (int c = 0; c < j; ++c) {
            const float2 tt = cmul(s.Rr[q][c], s.Ri[q][c], lr[c], -li[c]);
            sr = sr + tt.x * s.D[c];
            si = si + tt.y * s.D[c];
          }
          s.Rr[q][j] = sr;
          s.Ri[q][j] = si;
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i) s.D[i] = nd[i] - s.Ld;
      const float load_v = loading_of(s.D);
      float Dn[M], Dinv[M];
      factor(s.Rr, s.Ri, s.D, load_v, s.Rr, s.Ri, Dn, Dinv);
#pragma unroll
      for (int i = 0; i < M; ++i) s.D[i] = Dn[i];
      s.Ld = load_v;
    }
    float lam, sr;
    const float p = mcra_frame(s, t, zr[0] * zr[0] + zi[0] * zi[0], sft, bk, lp.mc, lam, sr);
    bool upd = p < lp.p_vad;
    if (lp.vad_guard) upd = upd && sr <= lp.mc.delta_s;
    if (__any_sync(0xffffffffu, upd)) {
      if (steady) {
        // Bennett's update of the factors, each row below column j by its owner
        float wr[Q], wi[Q], Dinv[M];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          wr[q] = pick(zr, q, row(q));
          wi[q] = pick(zi, q, row(q));
        }
        float sig = lp.ba_v;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const int qj = j / G;
          const float pr = from_owner(wr[qj], j), pi = from_owner(wi[qj], j), d = s.D[j];
          const float dj = d + sig * (pr * pr + pi * pi);
          const float r = rcp_nr(dj);
          const float srr = sig * r;
          const float br = srr * pr, bi = -(srr * pi);  // b = sigma conj(p) / d'
          sig = sig * d * r;
          set(s.D[j], lp.alpha_v * dj, upd);
          Dinv[j] = r * lp.inv_alpha_v;
#pragma unroll
          for (int q = qj; q < Q; ++q) {  // (slot qj's row j or above: its w is spent)
            const float lr = s.Rr[q][j], li = s.Ri[q][j];
            float2 tt = cmul(pr, pi, lr, li);
            wr[q] = wr[q] - tt.x;
            wi[q] = wi[q] - tt.y;
            tt = cmul(br, bi, wr[q], wi[q]);
            set(s.Rr[q][j], lr + tt.x, upd);
            set(s.Ri[q][j], li + tt.y, upd);
          }
        }
        solve(s.Rr, s.Ri, Dinv, upd);
        if (lp.refresh) set(s.Ld, lp.alpha_v * s.Ld, upd);
      } else {
        // the covariance's rank-1 update (every diagonal, this thread's rows),
        // then u from the LDL^H of R + load I
#pragma unroll
        for (int i = 0; i < M; ++i) set(s.D[i], lp.alpha_v * s.D[i] + lp.beta_v * (zr[i] * zr[i] + zi[i] * zi[i]), upd);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int r = row(q);
          const float zrr = pick(zr, q, r), zir = pick(zi, q, r);
#pragma unroll
          for (int c = 0; c < G * q + G - 1 && c < M; ++c) {
            const float outr = zrr * zr[c] + zir * zi[c], outi = zir * zr[c] - zrr * zi[c];
            set(s.Rr[q][c], lp.alpha_v * s.Rr[q][c] + lp.beta_v * outr, upd);
            set(s.Ri[q][c], lp.alpha_v * s.Ri[q][c] + lp.beta_v * outi, upd);
          }
        }
        float Lr[Q][M], Li[Q][M], Dn[M], Dinv[M];
        factor(s.Rr, s.Ri, s.D, loading_of(s.D), Lr, Li, Dn, Dinv);
        solve(Lr, Li, Dinv, upd);
      }
    }
    // ---- y = w^H z with w = u / (a^H u): this thread's rows' terms, then the group's
    float dr = 0.f, di = 0.f, nr = 0.f, ni = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {  // (an odd M's missing row: a = u = 0)
      const int r = row(q);
      float2 tt = cmul(ar[q], -ai[q], s.Ur[q], s.Ui[q]);  // conj(a) u
      dr = dr + tt.x;
      di = di + tt.y;
      tt = cmul(s.Ur[q], -s.Ui[q], pick(zr, q, r), pick(zi, q, r));  // conj(u) z
      nr = nr + tt.x;
      ni = ni + tt.y;
    }
    dr = group_sum(dr);
    di = group_sum(di);
    nr = group_sum(nr);
    ni = group_sum(ni);
    const float rmag = rcp_nr(dr * dr + di * di);
    const float2 ym = cmul(nr, ni, dr * rmag, di * rmag);
    // omlsa_gain, its two divisions by rcp_nr
    const float gamma = (ym.x * ym.x + ym.y * ym.y) * rcp_nr(fmaxf(lam, 1e-10f));
    const float xi_ = lp.alpha_xi * (s.Gh * s.Gh) * s.Gam + lp.one_m_alpha_xi * fmaxf(gamma - 1.f, 0.f);
    const float G_H1 = xi_ * rcp_nr(1.f + xi_);
    const float logG = p * logf(fmaxf(G_H1, 1e-30f)) + (1.f - p) * lp.log_gmin;
    const float Gn = fminf(fmaxf(expf(logG), lp.gmin), 1.f);
    s.Gh = G_H1;
    s.Gam = gamma;
    const float2 out = make_float2(ym.x * Gn, ym.y * Gn);
    if (live && h == 0) {
      y[(size_t)(2 * t) * NL + lane] = out.x;
      y[(size_t)(2 * t + 1) * NL + lane] = out.y;
    }
    if (lp.rank1 && chunk == lp.warm_chunks - 1 && pos == lp.t_chunk - 1) {  // handover: factor in place
      const float load_v = loading_of(s.D);
      float Dn[M], Dinv[M];
      factor(s.Rr, s.Ri, s.D, load_v, s.Rr, s.Ri, Dn, Dinv);
#pragma unroll
      for (int i = 0; i < M; ++i) s.D[i] = Dn[i];
      if (lp.refresh) s.Ld = load_v;
    }
    if (++pos == lp.t_chunk) {
      pos = 0;
      ++chunk;
    }
    if (t + 1 < T) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        zr[m] = nzr[m];
        zi[m] = nzi[m];
      }
      sft = nsf;
    }
  }
}

// The mega kernel's lane state in memory, field-major (float f of bin k at
// st[f * F + k], so that a warp's 32 bins read 32 neighbouring words): the
// lower triangle of the covariance or its factors, u, and the eight scalars.
__host__ __device__ constexpr int lane_fields(int M) { return M * M + 2 * M + 8; }

template <int M, bool kStore>
__device__ __forceinline__ void lane_io(float* st, int F, int k, Lane<M>& s) {
  float* p = st + k;
  auto io = [&](float& v) {
    if (kStore)
      *p = v;
    else
      v = *p;
    p += F;
  };
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) io(s.Rr[i][j]);
#pragma unroll
    for (int j = 0; j < i; ++j) io(s.Ri[i][j]);
    io(s.Ur[i]);
    io(s.Ui[i]);
  }
  io(s.S);
  io(s.Smin);
  io(s.Stmp);
  io(s.P);
  io(s.Lam);
  io(s.Gh);
  io(s.Gam);
  io(s.Ld);
}

// One lane-frame of the mega kernel: bin k of frame i from the spectrum
// ring slot Zf (the mics in pairs; an odd M's last pair holds one mic),
// MCRA's 3-tap smoothing of |z_0|^2 with its neighbours split here too, and
// the lane recursion.  Returns the gained bin.
template <int M, int logN>
__device__ __forceinline__ float2 mega_bin(const float2* Zf, int k, int i, Lane<M>& s, const float (&ar)[M],
                                           const float (&ai)[M], const LaneParams& lp) {
  constexpr int N = 1 << logN, F = N / 2 + 1, NP = (M + 1) / 2;
  float zr[M], zi[M];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    float2 u, v;
    split_pair(Zf + q * N, k, N, logN, u, v);
    zr[2 * q] = u.x;
    zi[2 * q] = u.y;
    if (2 * q + 1 < M) {
      zr[2 * q + 1] = v.x;
      zi[2 * q + 1] = v.y;
    }
  }
  float2 zl, zh, unused;
  split_pair(Zf, k > 0 ? k - 1 : 0, N, logN, zl, unused);
  split_pair(Zf, k < F - 1 ? k + 1 : F - 1, N, logN, zh, unused);
  const float Sf = lp.b0 * (zl.x * zl.x + zl.y * zl.y) + lp.b1 * (zr[0] * zr[0] + zi[0] * zi[0]) +
                   lp.b2 * (zh.x * zh.x + zh.y * zh.y);
  return lane_frame<M>(s, zr, zi, ar, ai, Sf, i, bin_kind(k, F), lp);
}

// x [B, M, T*hop], tabs [3, N] (window | cos | sin of 2 pi j / N),
// steer [M, 2, F] -> y [B, T*hop] for N = 2^logN, a compile-time constant
// so that the transforms' and splits' index arithmetic folds.  Each lane
// thread runs KB bins, k, k + 32 LW, ...: with their states in registers
// (kMem false: KB = 1 at N = 256, 2 at N = 512 with M <= 4), or one after
// another through a state kept in memory (kMem: lst in shared memory where
// it fits beside the rest, else gstate, a global scratch of lane_fields(M)
// x F floats an utterance that stays in L2).
template <int M, int logN, bool kMem>
__global__ void __launch_bounds__(kFullThreads, 1) fused_enhance_full_kernel(
    const float* __restrict__ x, const float* __restrict__ tabs, const float* __restrict__ steer,
    float* __restrict__ y, float* __restrict__ gstate, int T, float syn_gain, LaneParams lp) {
  extern __shared__ float4 smem4[];
  constexpr int N = 1 << logN, hop = N / 2, F = hop + 1;
  constexpr int NP = (M + 1) / 2;  // mic pairs
  constexpr int LW = kFullLaneWarps;
  constexpr int KB = (F + 32 * LW - 1) / (32 * LW);
  constexpr int RB = kMem ? 1 : KB;  // lane states in registers
  static_assert(kMem || KB == 1 || (KB == 2 && M <= 4), "the lane states would not fit in registers");
  float2* Za = reinterpret_cast<float2*>(smem4);  // [2][NP][N] frames t and t+1, mics 2j + i 2j+1
  float2* Zy = Za + 2 * NP * N;                   // [N] frame t-1's inverse
  float2* tw = Zy + N;                            // [N/2]
  float2* Ys = tw + N / 2;                        // [2][F] gained outputs
  float* ring = reinterpret_cast<float*>(Ys + 2 * F);  // [3][M][hop] hop-blocks of every mic
  float* win = ring + 3 * M * hop;                // [N]
  float* tail = win + N;                          // [hop] the previous frame's second half
  float* lst = !kMem ? nullptr                    // [lane_fields(M)][F] (kMem) the lane states
                     : gstate != nullptr ? gstate + (size_t)blockIdx.x * lane_fields(M) * F : tail + hop;

  const int tid = threadIdx.x;
  const float* xb = x + (size_t)blockIdx.x * M * T * hop;
  float* yb = y + (size_t)blockIdx.x * T * hop;
  // hop-block u of every mic into ring slot u mod 3, by nthr threads from rank r
  auto prefetch = [&](int u, int r, int nthr) {
    for (int m = 0; m < M; ++m)
      prefetch_floats(ring + ((u % 3) * M + m) * hop, xb + ((size_t)m * T + u) * hop, hop, r, nthr);
    copy_async_commit();
  };
  prefetch(0, tid, kFullThreads);
  for (int i = tid; i < N / 2; i += kFullThreads) tw[i] = make_float2(tabs[N + i], -tabs[2 * N + i]);
  for (int i = tid; i < N; i += kFullThreads) win[i] = tabs[i];
  for (int i = tid; i < hop; i += kFullThreads) tail[i] = 0.f;

  const bool lane_warp = tid < 32 * LW;
  float ar[RB][M], ai[RB][M];
  Lane<M> s[RB];
  if (lane_warp) {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int k = tid + 32 * LW * j;
      if (k >= F) continue;
      if constexpr (kMem) {
        Lane<M> z;
        lane_init<M>(M, z);
        lane_io<M, true>(lst, F, k, z);
      } else {
        load_steering<M>(steer, F, k, ar[j], ai[j]);
        lane_init<M>(M, s[j]);
      }
    }
  }
  const int r = tid - 32 * LW, nthr = kFullThreads - 32 * LW, fw = r >> 5, lane = tid & 31;  // FFT warps' ranks
  const float invN = 1.f / (float)N;
  copy_async_wait_all();
  __syncthreads();

  // iteration i: the lanes run frame i, the FFT warps analyse frame i + 1
  // and synthesise frame i - 1
  for (int i = -1; i <= T; ++i) {
    if (lane_warp) {
      const float2* Zf = Za + (i & 1) * NP * N;  // frame i's spectra, mics in pairs
      if (i >= 0 && i < T) {
        if constexpr (kMem) {
#pragma unroll 1
          for (int j = 0; j < KB; ++j) {
            const int k = tid + 32 * LW * j;
            if (k >= F) break;
            Lane<M> st;
            float a_r[M], a_i[M];
            lane_io<M, false>(lst, F, k, st);
            load_steering<M>(steer, F, k, a_r, a_i);
            Ys[(i & 1) * F + k] = mega_bin<M, logN>(Zf, k, i, st, a_r, a_i, lp);
            lane_io<M, true>(lst, F, k, st);
          }
        } else {
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int k = tid + 32 * LW * j;
            if (k < F) Ys[(i & 1) * F + k] = mega_bin<M, logN>(Zf, k, i, s[j], ar[j], ai[j], lp);
          }
        }
      }
    } else {
      const int a = i + 1, sy = i - 1;  // the frames analysed and synthesised
      copy_async_wait_all();            // hop-block a
      group_sync(1, nthr);
      // NP forward transforms and one inverse, one warp each; each reads its
      // input as its first pass loads it
      const int nfw = nthr >> 5;
      const int nq = (a < T ? NP : 0) + (sy >= 0 ? 1 : 0);
      for (int q = fw; q < nq; q += nfw) {
        if (a < T && q < NP) {
          // frame a of mics 2q, 2q+1 (2q alone for an odd M's last pair):
          // hop-blocks a - 1 (zeros before the first) and a, windowed
          const float* b0 = ring + (((a + 2) % 3) * M + 2 * q) * hop;
          const float* b1 = ring + ((a % 3) * M + 2 * q) * hop;
          const bool solo = (M & 1) && q == NP - 1;
          fft_seq_from<false>(Za + ((a & 1) * NP + q) * N, logN, tw, lane, 32, 0,
                              [&](const float2*, int p, int lg) {
                                const int n = bitrev(p, lg);
                                if (n >= hop) return make_float2(b1[n - hop] * win[n], solo ? 0.f : b1[n] * win[n]);
                                if (a == 0) return make_float2(0.f, 0.f);
                                return make_float2(b0[n] * win[n], solo ? 0.f : b0[hop + n] * win[n]);
                              });
        } else {
          // frame sy's gained spectrum, hermitian-extended (bins 0 and N/2 real)
          const float2* Y = Ys + (sy & 1) * F;
          fft_seq_from<true>(Zy, logN, tw, lane, 32, 0, [&](const float2*, int p, int lg) {
            const int k = bitrev(p, lg);
            if (k == 0 || k == hop) return make_float2(Y[k].x, 0.f);
            if (k < hop) return Y[k];
            return make_float2(Y[N - k].x, -Y[N - k].y);
          });
          __syncwarp();
          for (int n = lane; n < hop; n += 32) {  // window and overlap-add, by the same warp
            yb[(size_t)sy * hop + n] = (Zy[swz(n, logN)].x * (win[n] * invN) + tail[n]) * syn_gain;
            tail[n] = Zy[swz(n + hop, logN)].x * (win[n + hop] * invN);
          }
        }
      }
      if (a + 1 < T) prefetch(a + 1, r, nthr);
    }
    __syncthreads();
  }
}

// The lane kernel above 16 mics (M a run-time argument): one thread a lane
// running enhance_lane.cuh's lane functions on a memory lane
// (enhance_lane.cuh: mem_fields(M) floats) in shared memory, kMemLanes
// lanes a block, or where that does not fit (M > 27), in the global scratch
// gstate [mem_fields(M)][B*F].
// z [T, M, 2, B*F], sf [T, B*F], steer [M, 2, F] -> y [T, 2, B*F]
__global__ void __launch_bounds__(kMemLanes) fused_enhance_mem_kernel(const float* __restrict__ z,
                                                                      const float* __restrict__ sf,
                                                                      const float* __restrict__ steer,
                                                                      float* __restrict__ y, float* gstate, int M,
                                                                      int B, int F, int T, LaneParams lp) {
  extern __shared__ float4 smem4[];
  const int NL = B * F;
  const int lane = blockIdx.x * kMemLanes + threadIdx.x;
  if (lane >= NL) return;
  const int k = lane % F;
  const BinKind bk = bin_kind(k, F);
  float* base = gstate != nullptr ? gstate + lane : reinterpret_cast<float*>(smem4) + threadIdx.x;
  const int st = gstate != nullptr ? NL : kMemLanes;
  MemLane s = mem_lane(base, st, M);
  MemWork w = mem_work(base, st, M);
  const SVec<const float> ar{steer + k, 2 * F}, ai{steer + F + k, 2 * F};
  lane_init<0>(M, s);
  for (int t = 0; t < T; ++t) {
    const float* zt = z + (size_t)t * M * 2 * NL;
    for (int m = 0; m < M; ++m) {
      s.zr[m] = zt[(size_t)(2 * m) * NL + lane];
      s.zi[m] = zt[(size_t)(2 * m + 1) * NL + lane];
    }
    const float2 out = lane_frame<0>(M, s, s.zr, s.zi, ar, ai, w, sf[(size_t)t * NL + lane], t, bk, lp);
    y[(size_t)(2 * t) * NL + lane] = out.x;
    y[(size_t)(2 * t + 1) * NL + lane] = out.y;
  }
}

bool mem_lanes_in_smem(int M) { return sizeof(float) * (size_t)mem_fields(M) * kMemLanes <= kMaxSmemBytes; }

// Threads a lane of the lane kernel at M mics (2 to 16; the state spills
// from registers above 8).
constexpr int lane_group(int M) { return M <= 8 ? kLaneGroup8 : 4; }

template <int M>
cudaError_t launch_lanes(const float* z, const float* sf, const float* steer, float* y, int B, int F, int T,
                         const LaneParams& lp, cudaStream_t st) {
  constexpr int G = lane_group(M);
  const long long threads = (long long)B * F * G;
  fused_enhance_rows_kernel<M, G><<<(int)((threads + kLaneThreads - 1) / kLaneThreads), kLaneThreads, 0, st>>>(
      z, sf, steer, y, B, F, T, lp);
  return cudaGetLastError();
}

// The mega kernel's general variant, for the shapes the power-of-two one
// does not take: n_fft any multiple of 256 (N and M run-time arguments),
// and above 8 mics.  A block of kFrameThreads per utterance; per frame two
// phases between block barriers: (1) the analysis of frame i, the mics in
// pairs, one mixed-radix transform (fft_mixed.cuh) a warp on warps 0-14,
// beside the synthesis of frame i - 1 (inverse, window, overlap-add) on
// warp 15; (2) the lane recursion of frame i, the bins looped over the
// block's threads, each bin's state in the global scratch lanes: Lane<kM>
// fields (lane_fields(kM) x F an utterance, loaded into registers a bin at
// a time) for kM = M <= 8, else a memory lane (mem_fields(M) x F, kM = 0).
// The spectra ((2 NP + 2) N + F complex) sit in shared memory where they
// fit beside the tables, else in the global scratch work.
// x [B, M, T*hop], tabs [3, N] (window | cos | sin of 2 pi j / N),
// steer [M, 2, F] -> y [B, T*hop].
__host__ __device__ __forceinline__ size_t any_work_floats(int M, int N) {
  const size_t NP = (M + 1) / 2, F = N / 2 + 1;
  return 2 * ((2 * NP + 2) * N + round4(F));
}

__host__ __device__ __forceinline__ size_t any_table_floats(int N) { return 2 * (size_t)N + N + round4(N / 2); }

// (rounded to 16 bytes, so that the spectra after the B utterances' lane
// states stay aligned for float2)
__host__ __device__ __forceinline__ size_t any_lane_floats(int M, int N) {
  return round4z((size_t)(M <= 8 ? lane_fields(M) : mem_fields(M)) * (N / 2 + 1));
}

template <int kM>
__global__ void __launch_bounds__(kFrameThreads, 1) fused_enhance_full_any_kernel(
    const float* __restrict__ x, const float* __restrict__ tabs, const float* __restrict__ steer,
    float* __restrict__ y, float* lanes, float* work, int M, int N, int T, float syn_gain, LaneParams lp) {
  extern __shared__ float4 smem4[];
  const int hop = N / 2, F = hop + 1, NP = (M + 1) / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kSynWarp = kFrameWarps - 1;
  float2* tw = reinterpret_cast<float2*>(smem4);  // [N] e^{-2 pi i j / N}
  float* win = reinterpret_cast<float*>(tw + N);  // [N]
  float* tail = win + N;                          // [hop] the previous frame's second half
  float2* wk = reinterpret_cast<float2*>(work != nullptr ? work + blockIdx.x * any_work_floats(M, N)
                                                         : reinterpret_cast<float*>(smem4) + any_table_floats(N));
  float2* Sa = wk;               // [NP][2][N] the analyses, each in one of its two buffers
  float2* Sy = Sa + 2 * NP * N;  // [2][N] the synthesis
  float2* Ys = Sy + 2 * N;       // [F] the frame's gained output
  float* lst = lanes + blockIdx.x * any_lane_floats(M, N);
  const int ri = (fft_passes(N) - 1) & 1;  // the buffer that holds a transform's result
  const float* xb = x + (size_t)blockIdx.x * M * T * hop;
  float* yb = y + (size_t)blockIdx.x * T * hop;
  for (int i = tid; i < N; i += kFrameThreads) {
    tw[i] = make_float2(tabs[N + i], -tabs[2 * N + i]);
    win[i] = tabs[i];
  }
  for (int i = tid; i < hop; i += kFrameThreads) tail[i] = 0.f;
  for (int k = tid; k < F; k += kFrameThreads) {
    if constexpr (kM > 0) {
      Lane<kM> z;
      lane_init<kM>(kM, z);
      lane_io<kM, true>(lst, F, k, z);
    } else {
      MemLane z = mem_lane(lst + k, F, M);
      lane_init<0>(M, z);
      store_scalars(z, lst + k, F, M);
    }
  }
  const float invN = 1.f / (float)N;
  __syncthreads();

  // bins k of both mics of pair q from its spectrum (split_pair, natural order)
  auto split = [&](int q, int k, float2& X, float2& Y) {
    const float2* Z = Sa + (2 * q + ri) * N;
    const float2 a = Z[k], c = Z[(N - k) % N];
    X = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    Y = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
  };

  for (int i = 0; i <= T; ++i) {
    // ---- frame i's analyses beside frame i - 1's synthesis
    if (warp < kSynWarp) {
      for (int q = warp; q < NP && i < T; q += kSynWarp) {
        const float* m0 = xb + (size_t)(2 * q) * T * hop;
        const float* m1 = 2 * q + 1 < M ? m0 + (size_t)T * hop : nullptr;
        const long long o = (long long)(i - 1) * hop;  // frame i: hop-blocks i - 1 and i
        fft_any<false>(Sa + 2 * q * N, Sa + (2 * q + 1) * N, N, tw, lane, 32, 0, [&](int n) {
          if (o + n < 0) return make_float2(0.f, 0.f);
          return make_float2(m0[o + n] * win[n], m1 != nullptr ? m1[o + n] * win[n] : 0.f);
        });
      }
    } else if (i >= 1) {
      const float2* Y = Ys;
      const float2* o = fft_any<true>(Sy, Sy + N, N, tw, lane, 32, 0, [&](int kk) {
        if (kk == 0 || kk == hop) return make_float2(Y[kk].x, 0.f);
        if (kk < hop) return Y[kk];
        return make_float2(Y[N - kk].x, -Y[N - kk].y);
      });
      __syncwarp();
      const int sy = i - 1;
      for (int n = lane; n < hop; n += 32) {
        yb[(size_t)sy * hop + n] = (o[n].x * (win[n] * invN) + tail[n]) * syn_gain;
        tail[n] = o[n + hop].x * (win[n + hop] * invN);
      }
    }
    __syncthreads();
    if (i == T) break;

    // ---- the lanes of frame i
    for (int k = tid; k < F; k += kFrameThreads) {
      float2 zl, zh, unused;
      split(0, k > 0 ? k - 1 : 0, zl, unused);
      split(0, k < F - 1 ? k + 1 : F - 1, zh, unused);
      if constexpr (kM > 0) {
        float zr[kM], zi[kM], a_r[kM], a_i[kM];
#pragma unroll
        for (int q = 0; q < (kM + 1) / 2; ++q) {
          float2 u, v;
          split(q, k, u, v);
          zr[2 * q] = u.x;
          zi[2 * q] = u.y;
          if (2 * q + 1 < kM) {
            zr[2 * q + 1] = v.x;
            zi[2 * q + 1] = v.y;
          }
        }
        const float Sf = lp.b0 * (zl.x * zl.x + zl.y * zl.y) + lp.b1 * (zr[0] * zr[0] + zi[0] * zi[0]) +
                         lp.b2 * (zh.x * zh.x + zh.y * zh.y);
        Lane<kM> st;
        lane_io<kM, false>(lst, F, k, st);
        load_steering<kM>(steer, F, k, a_r, a_i);
        Ys[k] = lane_frame<kM>(st, zr, zi, a_r, a_i, Sf, i, bin_kind(k, F), lp);
        lane_io<kM, true>(lst, F, k, st);
      } else {
        MemLane s = mem_lane(lst + k, F, M);
        MemWork w = mem_work(lst + k, F, M);
        for (int q = 0; q < NP; ++q) {
          float2 u, v;
          split(q, k, u, v);
          s.zr[2 * q] = u.x;
          s.zi[2 * q] = u.y;
          if (2 * q + 1 < M) {
            s.zr[2 * q + 1] = v.x;
            s.zi[2 * q + 1] = v.y;
          }
        }
        const float Sf = lp.b0 * (zl.x * zl.x + zl.y * zl.y) + lp.b1 * (s.zr[0] * s.zr[0] + s.zi[0] * s.zi[0]) +
                         lp.b2 * (zh.x * zh.x + zh.y * zh.y);
        const SVec<const float> ar{steer + k, 2 * F}, ai{steer + F + k, 2 * F};
        Ys[k] = lane_frame<0>(M, s, s.zr, s.zi, ar, ai, w, Sf, i, bin_kind(k, F), lp);
        store_scalars(s, lst + k, F, M);
      }
    }
    __syncthreads();
  }
}

// Dynamic shared memory of the mega kernel in floats, its lane states aside.
size_t full_smem_floats(int M, int N) {
  const int hop = N / 2, F = hop + 1, NP = (M + 1) / 2;
  return (size_t)4 * NP * N + 2 * N + N + 4 * F + 3 * (size_t)M * hop + N + hop;
}

// Where the mega kernel keeps its lane states at M mics and n_fft N:
// 0 in registers, 1 in shared memory, 2 in a global scratch; 3 for a shape
// that the general variant runs; -1 for a shape it does not take.
int full_state_place(int M, int N) {
  if (M < 2 || N < 256 || N % 256 != 0) return -1;
  if (M > 8 || (N != 256 && N != 512 && N != 1024)) return 3;
  if (N == 256 || (N == 512 && M <= 4)) return 0;
  const size_t need = sizeof(float) * (full_smem_floats(M, N) + (size_t)lane_fields(M) * (N / 2 + 1));
  return need <= kMaxSmemBytes ? 1 : 2;
}

template <int M, int logN, bool kMem>
cudaError_t launch_full(const float* x, const float* tabs, const float* steer, float* y, float* gstate, int B, int T,
                        float syn_gain, const LaneParams& lp, cudaStream_t stream) {
  constexpr int N = 1 << logN;
  size_t floats = full_smem_floats(M, N);
  if (kMem && gstate == nullptr) floats += (size_t)lane_fields(M) * (N / 2 + 1);
  const size_t smem = sizeof(float) * floats;
  const cudaError_t e = allow_smem(fused_enhance_full_kernel<M, logN, kMem>, smem);
  if (e != cudaSuccess) return e;
  fused_enhance_full_kernel<M, logN, kMem><<<B, kFullThreads, smem, stream>>>(x, tabs, steer, y, gstate, T, syn_gain,
                                                                               lp);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_full_m(const float* x, const float* tabs, const float* steer, float* y, float* gstate, int B, int N,
                          int T, float syn_gain, const LaneParams& lp, cudaStream_t st) {
  switch (N) {
    case 256: return launch_full<M, 8, false>(x, tabs, steer, y, nullptr, B, T, syn_gain, lp, st);
    case 512:
      if constexpr (M <= 4) return launch_full<M, 9, false>(x, tabs, steer, y, nullptr, B, T, syn_gain, lp, st);
      else return launch_full<M, 9, true>(x, tabs, steer, y, gstate, B, T, syn_gain, lp, st);
    case 1024: return launch_full<M, 10, true>(x, tabs, steer, y, gstate, B, T, syn_gain, lp, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int kM>
cudaError_t launch_full_any(const float* x, const float* tabs, const float* steer, float* y, float* scratch, int M,
                            int B, int N, int T, float syn_gain, const LaneParams& lp, cudaStream_t stream) {
  const bool work_in_smem = sizeof(float) * (any_table_floats(N) + any_work_floats(M, N)) <= kMaxSmemBytes;
  const size_t smem = sizeof(float) * (any_table_floats(N) + (work_in_smem ? any_work_floats(M, N) : 0));
  const cudaError_t e = allow_smem(fused_enhance_full_any_kernel<kM>, smem);
  if (e != cudaSuccess) return e;
  float* work = work_in_smem ? nullptr : scratch + (size_t)B * any_lane_floats(M, N);
  fused_enhance_full_any_kernel<kM><<<B, kFrameThreads, smem, stream>>>(x, tabs, steer, y, scratch, work, M, N, T,
                                                                          syn_gain, lp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of global scratch the lane kernel needs at M mics over B*F lanes:
// 0 up to 16 mics (the state in registers) and where the memory lanes fit in
// shared memory, else mem_fields(M) a lane; -1 for M < 2.
long long fused_enhance_scratch_floats(int M, int B, int F) {
  if (M < 2) return -1;
  return M <= 16 || mem_lanes_in_smem(M) ? 0 : (long long)mem_fields(M) * B * F;
}

// M (mics) 2 or more: up to 16 lane_group(M) threads a lane, its rows
// split; above 16 the state lives in shared memory or, where that does not
// fit, in scratch (fused_enhance_scratch_floats).
cudaError_t fused_enhance_launch(const void* z, const void* sf, const void* steer, void* y, void* scratch, int M,
                                 int B, int F, int T, const void* params, void* stream) {
  const LaneParams lp = *static_cast<const LaneParams*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  const float* sff = static_cast<const float*>(sf);
  const float* sv = static_cast<const float*>(steer);
  float* yf = static_cast<float*>(y);
  switch (M) {
    case 2: return launch_lanes<2>(zf, sff, sv, yf, B, F, T, lp, st);
    case 3: return launch_lanes<3>(zf, sff, sv, yf, B, F, T, lp, st);
    case 4: return launch_lanes<4>(zf, sff, sv, yf, B, F, T, lp, st);
    case 5: return launch_lanes<5>(zf, sff, sv, yf, B, F, T, lp, st);
    case 6: return launch_lanes<6>(zf, sff, sv, yf, B, F, T, lp, st);
    case 7: return launch_lanes<7>(zf, sff, sv, yf, B, F, T, lp, st);
    case 8: return launch_lanes<8>(zf, sff, sv, yf, B, F, T, lp, st);
    case 9: return launch_lanes<9>(zf, sff, sv, yf, B, F, T, lp, st);
    case 10: return launch_lanes<10>(zf, sff, sv, yf, B, F, T, lp, st);
    case 11: return launch_lanes<11>(zf, sff, sv, yf, B, F, T, lp, st);
    case 12: return launch_lanes<12>(zf, sff, sv, yf, B, F, T, lp, st);
    case 13: return launch_lanes<13>(zf, sff, sv, yf, B, F, T, lp, st);
    case 14: return launch_lanes<14>(zf, sff, sv, yf, B, F, T, lp, st);
    case 15: return launch_lanes<15>(zf, sff, sv, yf, B, F, T, lp, st);
    case 16: return launch_lanes<16>(zf, sff, sv, yf, B, F, T, lp, st);
    default: {
      if (M < 2) return cudaErrorInvalidValue;
      const bool in_smem = mem_lanes_in_smem(M);
      if (!in_smem && scratch == nullptr) return cudaErrorInvalidValue;
      const size_t smem = in_smem ? sizeof(float) * (size_t)mem_fields(M) * kMemLanes : 0;
      const cudaError_t e = allow_smem(fused_enhance_mem_kernel, smem);
      if (e != cudaSuccess) return e;
      fused_enhance_mem_kernel<<<(B * F + kMemLanes - 1) / kMemLanes, kMemLanes, smem, st>>>(
          zf, sff, sv, yf, in_smem ? nullptr : static_cast<float*>(scratch), M, B, F, T, lp);
      return cudaGetLastError();
    }
  }
}

// M (mics) 2 or more; N (n_fft) a multiple of 256, as the JAX kernel takes.
// With M <= 8 and N 256, 512 or 1024 the lane states live in registers at
// N = 256 and at 512 with M <= 4, else in shared memory or, where that does
// not fit, in scratch.  Every other shape runs the general variant, whose
// lane states always live in scratch, and its spectra too where they do
// not fit in shared memory.  fused_enhance_full_scratch_floats(M, N): the
// floats of scratch an utterance, 0 where the launch needs none (scratch
// may then be null), -1 for a shape it does not take.
long long fused_enhance_full_scratch_floats(int M, int N) {
  const int place = full_state_place(M, N);
  if (place == 3) {
    const bool work_in_smem = sizeof(float) * (any_table_floats(N) + any_work_floats(M, N)) <= kMaxSmemBytes;
    return (long long)any_lane_floats(M, N) + (work_in_smem ? 0 : (long long)any_work_floats(M, N));
  }
  return place < 0 ? -1 : place == 2 ? lane_fields(M) * (N / 2 + 1) : 0;
}

cudaError_t fused_enhance_full_launch(const void* x, const void* tabs, const void* steer, void* y, void* scratch,
                                      int M, int B, int N, int T, float syn_gain, const void* params, void* stream) {
  const LaneParams lp = *static_cast<const LaneParams*>(params);
  const int place = full_state_place(M, N);
  if (place < 0 || B < 1 || T < 1 || (place >= 2 && scratch == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(tabs);
  const float* sv = static_cast<const float*>(steer);
  float* yf = static_cast<float*>(y);
  float* gs = place >= 2 ? static_cast<float*>(scratch) : nullptr;
  if (place == 3) {
    switch (M) {
      case 2: return launch_full_any<2>(xf, tf, sv, yf, gs, M, B, N, T, syn_gain, lp, st);
      case 3: return launch_full_any<3>(xf, tf, sv, yf, gs, M, B, N, T, syn_gain, lp, st);
      case 4: return launch_full_any<4>(xf, tf, sv, yf, gs, M, B, N, T, syn_gain, lp, st);
      case 5: return launch_full_any<5>(xf, tf, sv, yf, gs, M, B, N, T, syn_gain, lp, st);
      case 6: return launch_full_any<6>(xf, tf, sv, yf, gs, M, B, N, T, syn_gain, lp, st);
      case 7: return launch_full_any<7>(xf, tf, sv, yf, gs, M, B, N, T, syn_gain, lp, st);
      case 8: return launch_full_any<8>(xf, tf, sv, yf, gs, M, B, N, T, syn_gain, lp, st);
      default: return launch_full_any<0>(xf, tf, sv, yf, gs, M, B, N, T, syn_gain, lp, st);
    }
  }
  switch (M) {
    case 2: return launch_full_m<2>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 3: return launch_full_m<3>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 4: return launch_full_m<4>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 5: return launch_full_m<5>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 6: return launch_full_m<6>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 7: return launch_full_m<7>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 8: return launch_full_m<8>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* enhance_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
