// Kernel K1: the gated MVDR frame loop of the `pallas` backend, with the
// OM-LSA gain optionally fused in, and its C launcher.
//
// Replaces distantspeech_tpu/ops/pallas_mvdr.py pallas_mvdr_scan
// (_mvdr_kernel and _mvdr_omlsa_kernel).  Spectra Z [T, B, F, M] complex64,
// the covariance gate [T, B, F] and, with the gain, the MCRA tracks p and
// lambda_d [T, B, F] come in; Y [T, B, F] complex64 goes out.  The plain
// version is fused_mvdr_scan_plain in ops/cuda_mvdr.py.
//
// Design.  Two layouts, both a group of threads per (utterance, bin) lane
// inside one warp, so that the 8,256 lanes of B1 (B = 64, F = 129) put
// every SM to work; the first design ran one thread a lane, 65 blocks of
// 128 on 132 SMs, each lane's frames a serial chain of 3.15 us, and took
// 1.573 ms (PERF.md's kernel table keeps every time).
//
// Up to 16 mics: frame-parallel (fused_mvdr_frames_kernel).  The
// recursion's only serial parts are the rank-1 update of R and the gain's
// carry; frame t's LDL^H solve depends on R_t alone.  Four threads run a
// lane: each applies every frame's update to its own copy of R (the same
// operations, so the copies agree to the bit), keeps R as it stands at its
// frame of each block of 4, and the 4 solves of a block run at once.  The
// held u of each frame then comes by shuffle from the last open frame's
// thread, and the gain's carry passes from frame to frame by shuffle.
// Every operation is the plain version's, in its order.  Above 8 mics its
// copies of R spill from registers (at 16, a 1.8 KB stack frame a thread),
// and it still beats the other layouts: at B1's size, 12 mics 6.4 ms, 16
// 29.1, against 22.8 and 33.3 by columns and 20.4 and 38.3 with one thread
// a lane on R in shared memory (PERF.md).
//
// Above 16 mics: by columns (fused_mvdr_scan_kernel), G threads a lane (G
// the power of two >= M, up to 32); thread j owns mic column j (and j + G,
// j + 2G, ... where M > 32): its column of R (lower triangle) and of the
// LDL^H factors, u_j and a_j.
//
// - The group reads its lane's M contiguous float2 in one coalesced
//   access; frame t + 1's z, gate, p and lambda_d are loaded into registers
//   before frame t's chain.
// - The rank-1 update is a column per thread, z broadcast by shuffle.
// - The factorisation runs right-looking, column by column: at step k the
//   owner of column k forms D_k and L[:, k] and broadcasts them and v_k by
//   shuffle, and every later column subtracts its step-k term.  Each entry
//   thus takes its terms in the plain version's order (k ascending), and
//   the forward solve L v = a rides along: v_j takes v_k's term at step k.
// - The back solve goes column by column from the last; the owner of
//   column i sums its terms in the plain version's order, from the u_k
//   received before it.
// - a^H u and u^H z, and the trace of R that sets the loading, are
//   __shfl_xor_sync reductions over the group (another order than the
//   plain version's running sums); the OM-LSA gain runs on every thread of
//   the group alike, and thread 0 writes the bin.
//
// At M = 8 the column layout took 6.3 ms at B1 (PERF.md's kernel table
// keeps it): its O(M^2) shuffles and predicated steps a frame cost each
// lane ~7x the instructions of a thread that runs the lane alone; at 32
// mics it takes 280 ms, one thread a lane on R in global memory 580.
//
// A closed gate holds the state, as the plain version's select does (the
// column layout runs the update when any lane of the warp is open and
// discards it where the lane's gate is closed).  Built without FMA
// contraction (ops/_build.py), so that each operation rounds as PyTorch's
// elementwise operations do.  M is a runtime argument of the launcher.
//
// What bounds it on an H100 (B = 64, M = 8, 4 s): bytes (~350 MB of spectra,
// gate and tracks in and the output out, against ~5e9 float32 operations);
// chip_smoke.py prints the chain floor of each layout beside the bound.
#include <cuda_runtime.h>

#include "enhance_lane.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxMics = 128;  // the column layout's widest instantiation: 32 threads x 4 columns
constexpr int kFrameGroup = 4;  // threads a lane, frames solved at once, in the frame-parallel layout

__device__ __forceinline__ float bcast(float v, int src) { return __shfl_sync(0xffffffffu, v, src); }

// Sum of v over the group of G lanes (every lane gets the same value).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// z [T, B*F, M] float2, gate / p / lam [T, B*F], steer [F, M] float2
// -> y [T, B*F] float2
template <int G, int C, bool kGain, int kU = (C == 1 ? G : 1)>  // kU: the loops over rows unrolled by kU
__global__ void __launch_bounds__(kThreads) fused_mvdr_scan_kernel(const float2* __restrict__ z,
                                                                  const float* __restrict__ gate,
                                                                  const float* __restrict__ p,
                                                                  const float* __restrict__ lam,
                                                                  const float2* __restrict__ steer,
                                                                  float2* __restrict__ y, int T, int NL, int F, int M,
                                                                  LaneParams lp) {
  constexpr int MR = G * C;  // rows held per column; registers where the loops over them unroll (C = 1)
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  const int g = threadIdx.x & (G - 1);
  const int base = (threadIdx.x & 31) & ~(G - 1);  // the group's first lane in its warp
  const bool live = gid / G < NL;
  const int lane = live ? gid / G : NL - 1;  // a group past the end runs the last lane and writes nothing
  const int k = lane % F;

  bool own[C];  // column c = g + G q exists
  float ar[C], ai[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int c = g + G * q;
    own[q] = c < M;
    const float2 a = own[q] ? steer[k * M + c] : make_float2(0.f, 0.f);
    ar[q] = a.x;
    ai[q] = a.y;
  }
  float Rr[C][MR], Ri[C][MR];  // column c of R: R[i][c] for i >= c, the real diagonal at i = c
  float Ur[C], Ui[C];          // u_c
#pragma unroll
  for (int q = 0; q < C; ++q) {
#pragma unroll (kU)
    for (int i = 0; i < MR; ++i) Rr[q][i] = Ri[q][i] = 0.f;
    Ur[q] = Ui[q] = 0.f;
  }
  float Gh = 1.f, Gam = 1.f;  // the OM-LSA carry (each thread of the group holds it)

  // frame t's inputs, and frame t + 1's loaded before frame t's chain
  float zr[C], zi[C], gt = 0.f, pt = 0.f, lt = 0.f;
  auto load = [&](int t, float (&xr)[C], float (&xi)[C], float& gv, float& pv, float& lv) {
    const size_t idx = (size_t)t * NL + lane;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const float2 v = own[q] ? z[idx * M + g + G * q] : make_float2(0.f, 0.f);
      xr[q] = v.x;
      xi[q] = v.y;
    }
    gv = gate[idx];
    if (kGain) {
      pv = p[idx];
      lv = lam[idx];
    }
  };
  if (T > 0) load(0, zr, zi, gt, pt, lt);

  for (int t = 0; t < T; ++t) {
    float nzr[C], nzi[C], ngt = 0.f, npt = 0.f, nlt = 0.f;
    if (t + 1 < T) load(t + 1, nzr, nzi, ngt, npt, nlt);
    const bool open = gt > 0.5f;

    if (__any_sync(0xffffffffu, open)) {
      // ---- rank-1 update of column c: R[i][c] = alpha R[i][c] + beta z_i conj(z_c)
#pragma unroll (kU)
      for (int i = 0; i < MR; ++i) {
        if (i >= M) break;
        const float zri = bcast(zr[i / G], base + i % G), zii = bcast(zi[i / G], base + i % G);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int c = g + G * q;
          if (!open || !own[q] || i < c) continue;
          if (i == c) {
            const float out = zri * zri + zii * zii;
            Rr[q][i] = lp.alpha_v * Rr[q][i] + lp.beta_v * out;
          } else {
            const float outr = zri * zr[q] + zii * zi[q];
            const float outi = zii * zr[q] - zri * zi[q];
            Rr[q][i] = lp.alpha_v * Rr[q][i] + lp.beta_v * outr;
            Ri[q][i] = lp.alpha_v * Ri[q][i] + lp.beta_v * outi;
          }
        }
      }
      // ---- each column's diagonal R[c][c] (picked by a select over the rows,
      // so that the columns stay in registers), and load = diag + rel_diag
      // tr(R) / M
      float Rcc[C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        Rcc[q] = 0.f;
#pragma unroll (kU)
        for (int i = 0; i < MR; ++i)
          if (i == g + G * q) Rcc[q] = Rr[q][i];
      }
      float load_v = lp.diag;
      if (lp.rel_diag_m != 0.f) {
        float tr = 0.f;
#pragma unroll
        for (int q = 0; q < C; ++q)
          if (own[q]) tr = tr + Rcc[q];
        load_v = lp.diag + lp.rel_diag_m * group_sum<G>(tr);
      }
      // ---- LDL^H of R + load I, right-looking, with the forward solve L v = a
      float Sr[C][MR], Si[C][MR], dd[C], Dinv[C], vr[C], vi[C], Lcr[C], Lci[C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
#pragma unroll (kU)
        for (int i = 0; i < MR; ++i) {
          Sr[q][i] = Rr[q][i];
          Si[q][i] = Ri[q][i];
        }
        dd[q] = own[q] ? Rcc[q] + load_v : 1.f;
        Dinv[q] = 0.f;
        vr[q] = ar[q];
        vi[q] = ai[q];
        Lcr[q] = Lci[q] = 0.f;
      }
#pragma unroll (kU)
      for (int kk = 0; kk < MR; ++kk) {
        if (kk >= M) break;
        const int src = base + kk % G, qk = kk / G;
        float D = 0.f;
        if (g == kk % G) {  // column kk's owner: D_k, 1 / D_k and L[:, k]
          D = dd[qk];
          const float r = 1.f / D;
          Dinv[qk] = r;
#pragma unroll (kU)
          for (int i = 0; i < MR; ++i) {
            if (i <= kk) continue;
            Sr[qk][i] = Sr[qk][i] * r;
            Si[qk][i] = Si[qk][i] * r;
          }
        }
        const float Dk = bcast(D, src), vkr = bcast(vr[qk], src), vki = bcast(vi[qk], src);
#pragma unroll (kU)
        for (int i = kk + 1; i < MR; ++i) {
          if (i >= M) break;
          const float lr = bcast(Sr[qk][i], src), li = bcast(Si[qk][i], src);  // L[i][k]
#pragma unroll
          for (int q = 0; q < C; ++q) {
            const int c = g + G * q;
            if (!own[q] || c <= kk || i < c) continue;
            if (i == c) {  // the row of column c: D_c and v_c take their step-k terms
              dd[q] = dd[q] - (lr * lr + li * li) * Dk;
              const float2 tv = cmul(lr, li, vkr, vki);
              vr[q] = vr[q] - tv.x;
              vi[q] = vi[q] - tv.y;
              Lcr[q] = lr;
              Lci[q] = li;
            } else {  // L[i][k] conj(L[c][k]) D_k
              const float2 tl = cmul(lr, li, Lcr[q], -Lci[q]);
              Sr[q][i] = Sr[q][i] - tl.x * Dk;
              Si[q][i] = Si[q][i] - tl.y * Dk;
            }
          }
        }
      }
      // ---- v = D^-1 v, then the back solve L^H u = v from the last column
      float nur[C], nui[C], ukr[MR], uki[MR];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        vr[q] = vr[q] * Dinv[q];
        vi[q] = vi[q] * Dinv[q];
        nur[q] = nui[q] = 0.f;
      }
#pragma unroll (kU)
      for (int i = MR - 1; i >= 0; --i) {
        if (i >= M) continue;
        const int qi = i / G;
        if (g == i % G) {
          float sr = vr[qi], si = vi[qi];
#pragma unroll (kU)
          for (int kk = 0; kk < MR; ++kk) {
            if (kk <= i || kk >= M) continue;
            const float2 tu = cmul(Sr[qi][kk], -Si[qi][kk], ukr[kk], uki[kk]);  // conj(L[k][i]) u_k
            sr = sr - tu.x;
            si = si - tu.y;
          }
          nur[qi] = sr;
          nui[qi] = si;
        }
        ukr[i] = bcast(nur[qi], base + i % G);
        uki[i] = bcast(nui[qi], base + i % G);
      }
      if (open) {
#pragma unroll
        for (int q = 0; q < C; ++q) {
          Ur[q] = nur[q];
          Ui[q] = nui[q];
        }
      }
    }

    // ---- y = w^H z with w = u / (a^H u): (u^H z) / conj(a^H u)
    float den_r = 0.f, den_i = 0.f, num_r = 0.f, num_i = 0.f;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (!own[q]) continue;
      const float2 td = cmul(ar[q], -ai[q], Ur[q], Ui[q]);  // conj(a) u
      const float2 tn = cmul(Ur[q], -Ui[q], zr[q], zi[q]);  // conj(u) z
      den_r = den_r + td.x;
      den_i = den_i + td.y;
      num_r = num_r + tn.x;
      num_i = num_i + tn.y;
    }
    den_r = group_sum<G>(den_r);
    den_i = group_sum<G>(den_i);
    num_r = group_sum<G>(num_r);
    num_i = group_sum<G>(num_i);
    const float dmag = den_r * den_r + den_i * den_i;
    float2 out = cmul(num_r, num_i, den_r / dmag, den_i / dmag);
    if (kGain) {
      // the decision-directed OM-LSA gain (enhance_lane.cuh's omlsa_gain)
      const float gamma = (out.x * out.x + out.y * out.y) / fmaxf(lt, 1e-10f);
      const float xi = lp.alpha_xi * (Gh * Gh) * Gam + lp.one_m_alpha_xi * fmaxf(gamma - 1.f, 0.f);
      const float G_H1 = xi / (1.f + xi);
      const float logG = pt * logf(fmaxf(G_H1, 1e-30f)) + (1.f - pt) * lp.log_gmin;
      const float Gn = fminf(fmaxf(expf(logG), lp.gmin), 1.f);
      Gh = G_H1;
      Gam = gamma;
      out = make_float2(out.x * Gn, out.y * Gn);
    }
    if (live && g == 0) y[(size_t)t * NL + lane] = out;

#pragma unroll
    for (int q = 0; q < C; ++q) {
      zr[q] = nzr[q];
      zi[q] = nzi[q];
    }
    gt = ngt;
    pt = npt;
    lt = nlt;
  }
}

// ---- the frame-parallel layout (M <= 16) --------------------------------------

// The same function for M <= 16 mics, frame-parallel: the recursion's only
// serial parts are the rank-1 update of R and the gain's carry; the LDL^H
// solve of frame t depends on R_t alone.  So a group of G threads runs a
// lane (G = 4: 4 x 8,256 threads at B1, 2 blocks of 128 on every SM): each
// thread applies every frame's update to its own copy of R (the same
// operations, so the copies agree to the bit), keeps R as it stands at
// frame j of each block of G frames, and solves that frame, the G solves of
// a block at once.  Then each thread takes the held u of its frame (the
// solve of the last open frame up to it, by shuffle, or the block's carry),
// forms its output, and the gain's carry passes from frame to frame by
// shuffle.  Every operation is the plain version's, in its order, so the
// kernel matches it to the bit (built without contraction).
template <int M, int G, bool kGain>
__global__ void __launch_bounds__(kThreads) fused_mvdr_frames_kernel(const float2* __restrict__ z,
                                                                    const float* __restrict__ gate,
                                                                    const float* __restrict__ p,
                                                                    const float* __restrict__ lam,
                                                                    const float2* __restrict__ steer,
                                                                    float2* __restrict__ y, int T, int NL, int F,
                                                                    LaneParams lp) {
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  const int j = threadIdx.x & (G - 1);  // this thread's frame in each block of G frames
  const int base = (threadIdx.x & 31) & ~(G - 1);
  const bool live = gid / G < NL;
  const int lane = live ? gid / G : NL - 1;  // a group past the end runs the last lane and writes nothing
  const int k = lane % F;
  float ar[M], ai[M], Rr[M][M], Ri[M][M], Ur[M], Ui[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float2 a = steer[k * M + m];
    ar[m] = a.x;
    ai[m] = a.y;
    Ur[m] = Ui[m] = 0.f;
#pragma unroll
    for (int n = 0; n <= m; ++n) Rr[m][n] = Ri[m][n] = 0.f;
  }
  float Gh = 1.f, Gam = 1.f;
  for (int t0 = 0; t0 < T; t0 += G) {
    const int nb = min(G, T - t0);
    float Sr[M][M], Si[M][M];  // R at this thread's frame
    bool mine = false;         // its gate
    unsigned open_bits = 0;    // the block's gates
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (u >= nb) break;
      const size_t idx = (size_t)(t0 + u) * NL + lane;
      float xr[M], xi[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float2 v = z[idx * M + m];
        xr[m] = v.x;
        xi[m] = v.y;
      }
      const bool open = gate[idx] > 0.5f;
      open_bits |= (unsigned)open << u;
      if (open) cov_update<M>(M, Rr, Ri, xr, xi, lp);
      if (u == j) {
        mine = open;
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int n = 0; n <= m; ++n) {
            Sr[m][n] = Rr[m][n];
            Si[m][n] = Ri[m][n];
          }
      }
    }
    // ---- the candidate solve of this thread's frame
    float cr[M], ci[M];
#pragma unroll
    for (int m = 0; m < M; ++m) cr[m] = ci[m] = 0.f;
    if (j < nb && mine) {
      // the factors overwrite S's strictly lower triangle, in place
      float D[M], Dinv[M], vr[M], vi[M];
      ldl_factors<M>(M, Sr, Si, loading<M>(M, Sr, lp), Sr, Si, D, Dinv);
      ldl_solve<M>(M, Sr, Si, Dinv, ar, ai, cr, ci, vr, vi);
    }
    // ---- the held u at this frame: the last open frame of the block up to
    // it, else the carry; then the output
    const unsigned upto = open_bits & ((2u << j) - 1u);
    const int f = upto ? 31 - __clz(upto) : -1;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float hr = __shfl_sync(0xffffffffu, cr[m], base + max(f, 0));
      const float hi = __shfl_sync(0xffffffffu, ci[m], base + max(f, 0));
      cr[m] = f >= 0 ? hr : Ur[m];
      ci[m] = f >= 0 ? hi : Ui[m];
    }
    const size_t idx = (size_t)(t0 + min(j, nb - 1)) * NL + lane;
    float zr[M], zi[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float2 v = z[idx * M + m];
      zr[m] = v.x;
      zi[m] = v.y;
    }
    float2 out = mvdr_output<M>(M, zr, zi, ar, ai, cr, ci);
    if (kGain) {
      // omlsa_gain (enhance_lane.cuh), its (G_H1, gamma) carry passed from
      // frame to frame: step u settles frame t0 + u
      const float pj = p[idx], lj = lam[idx];
      float Gn = 1.f;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (u >= nb) break;
        const float gamma = (out.x * out.x + out.y * out.y) / fmaxf(lj, 1e-10f);
        const float xi = lp.alpha_xi * (Gh * Gh) * Gam + lp.one_m_alpha_xi * fmaxf(gamma - 1.f, 0.f);
        const float G_H1 = xi / (1.f + xi);
        if (u == j) {
          const float logG = pj * logf(fmaxf(G_H1, 1e-30f)) + (1.f - pj) * lp.log_gmin;
          Gn = fminf(fmaxf(expf(logG), lp.gmin), 1.f);
        }
        Gh = __shfl_sync(0xffffffffu, G_H1, base + u);
        Gam = __shfl_sync(0xffffffffu, gamma, base + u);
      }
      out = make_float2(out.x * Gn, out.y * Gn);
    }
    if (live && j < nb) y[(size_t)(t0 + j) * NL + lane] = out;
    // ---- the carry: the held u after the block
#pragma unroll
    for (int m = 0; m < M; ++m) {
      Ur[m] = __shfl_sync(0xffffffffu, cr[m], base + nb - 1);
      Ui[m] = __shfl_sync(0xffffffffu, ci[m], base + nb - 1);
    }
  }
}

template <int M>
cudaError_t launch_frames(const float2* z, const float* gate, const float* p, const float* lam, const float2* steer,
                          float2* y, int T, int NL, int F, const LaneParams& lp, cudaStream_t st) {
  constexpr int G = kFrameGroup;
  const long long threads = (long long)NL * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if (p != nullptr)
    fused_mvdr_frames_kernel<M, G, true><<<blocks, kThreads, 0, st>>>(z, gate, p, lam, steer, y, T, NL, F, lp);
  else
    fused_mvdr_frames_kernel<M, G, false><<<blocks, kThreads, 0, st>>>(z, gate, p, lam, steer, y, T, NL, F, lp);
  return cudaGetLastError();
}

template <int G, int C>
cudaError_t launch(const float2* z, const float* gate, const float* p, const float* lam, const float2* steer,
                   float2* y, int T, int NL, int F, int M, const LaneParams& lp, cudaStream_t st) {
  const long long threads = (long long)NL * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if (p != nullptr)
    fused_mvdr_scan_kernel<G, C, true><<<blocks, kThreads, 0, st>>>(z, gate, p, lam, steer, y, T, NL, F, M, lp);
  else
    fused_mvdr_scan_kernel<G, C, false><<<blocks, kThreads, 0, st>>>(z, gate, p, lam, steer, y, T, NL, F, M, lp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// M (mics) 2 to kMaxMics; p and lam null: no gain.
cudaError_t fused_mvdr_scan_launch(const void* z, const void* gate, const void* p, const void* lam,
                                   const void* steer, void* y, int M, int T, int B, int F, const void* params,
                                   void* stream) {
  const LaneParams lp = *static_cast<const LaneParams*>(params);
  if ((p == nullptr) != (lam == nullptr) || B * F <= 0 || M < 2 || M > kMaxMics)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* zf = static_cast<const float2*>(z);
  const float* gf = static_cast<const float*>(gate);
  const float* pf = static_cast<const float*>(p);
  const float* lf = static_cast<const float*>(lam);
  const float2* sv = static_cast<const float2*>(steer);
  float2* yf = static_cast<float2*>(y);
  const int NL = B * F;
  switch (M) {
    case 2: return launch_frames<2>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 3: return launch_frames<3>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 4: return launch_frames<4>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 5: return launch_frames<5>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 6: return launch_frames<6>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 7: return launch_frames<7>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 8: return launch_frames<8>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 9: return launch_frames<9>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 10: return launch_frames<10>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 11: return launch_frames<11>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 12: return launch_frames<12>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 13: return launch_frames<13>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 14: return launch_frames<14>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 15: return launch_frames<15>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    case 16: return launch_frames<16>(zf, gf, pf, lf, sv, yf, T, NL, F, lp, st);
    default: break;
  }
  if (M <= 32) return launch<32, 1>(zf, gf, pf, lf, sv, yf, T, NL, F, M, lp, st);
  if (M <= 64) return launch<32, 2>(zf, gf, pf, lf, sv, yf, T, NL, F, M, lp, st);
  return launch<32, 4>(zf, gf, pf, lf, sv, yf, T, NL, F, M, lp, st);
}

const char* mvdr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
