// The TDGSC front end in one kernel, and its C launcher.
//
// Replaces no TPU kernel: the JAX package leaves the TDGSC's front end to
// XLA, and the port ran it as ~70 PyTorch operations (ops/cuda_flms.py
// front_end and _kernel_inputs, the plain version).  From the mics x
// [B, M, S'] and the alignment taps [M, K] it computes, per utterance:
//
//   1. the speex DC notch (a two-state recurrence) from the zero state, in
//      the coupled form the wrapper derives (ops/cuda_flms.py
//      notch_coupled: the same filter, rounding errors ~40 times less
//      amplified than in speex's companion form, run sample by sample);
//   2. the causal alignment FIR, aligned[m][n] = sum_j taps[m][j] xn[m][n - j];
//   3. the fixed beam fbf = mean over mics and the blocking matrix
//      bm[c] = aligned[c] - aligned[c + 1];
//   4. the desired signal d = fbf delayed by Lf / 2;
//   5. the STFT powers yp = |STFT(fbf)|^2 [B, T, F] and, with the
//      postfilter, up = |STFT(bm)|^2 [B, C, T, F] (n_fft = 2 Lf, hop Lf, a
//      sqrt-Hann window, Lf leading zeros),
//
// and writes bm, d, yp and up: kernel K5's inputs (flms.cu), in its layout.
//
// Design.  One block of kFrameThreads threads per utterance walks it in
// tiles of `tile` samples (512-2048, a multiple of Lf), every tile's data in
// shared memory, the next tile's mics prefetched with cp.async while the
// tile computes.  Five block barriers a tile:
//
//   - The notch is exact.  Each thread owns a chunk of 16 samples of one
//     mic: it runs the chunk from the zero state (its end state c_i; the
//     chunk's map is s -> A^16 s + c_i), the chunks of a mic scan those maps
//     across the warp by shuffles (Kogge-Stone, the powers A^(16 k) from a
//     table the host computes in float64) and across the mic's warps in
//     order, and each thread then runs its chunk again from its true start
//     state.  The tile's end state carries into the next tile.
//   - The FIR is direct-form from shared memory: a thread's 16 outputs of
//     one mic in registers, the taps in steps of 8 (zero-padded to a
//     multiple of 8), each step a window of 24 samples (6 float4 loads) and
//     2 float4 tap loads for 128 multiply-adds.  The notched samples before
//     the tile that the taps reach (the halo) are copied from the tile
//     before.
//   - The mics' rows then turn into [fbf, bm_0 .. bm_{C-1}] in place, and
//     bm goes out.
//   - The STFT frames are warp-owned FFTs (flms_fft.cuh), two consecutive
//     real frames (of one signal where the tile holds two or more frames)
//     packed into one complex transform, so that the pair is of like
//     magnitude; the powers go out from the split spectra.
//
// A row lies in shared memory with 4 floats of padding after every 16
// samples (sk), so that the threads of a warp reading their 16-sample runs as
// float4 hit distinct banks.  What does not fit in shared memory at large M
// or Lf goes to a global scratch the wrapper sizes
// (gsc_front_scratch_floats), with plain copies for the prefetch.
//
// What bounds it on an H100 (B = 128, M = 4, 4 s, K = 84): the FIR's
// multiply-adds, 2.75 G a call, ~0.09 ms at 132 SMs x 128 a clock; the
// layer's roofline (chip_smoke.py front_end_work: bytes once, an FFT at
// 2.5 N log2 N + N) is ~0.12 ms.  One block an utterance is 128 blocks on
// 132 SMs.  It takes 0.55 ms on an H100 at 700 W, as long at B = 16;
// taking a phase out saves 0.21 ms (the transforms and powers: 16
// warp-owned 512-point FFTs a tile, one a warp, latency-bound), 0.17 ms
// (the FIR, about half the FP32 rate) and 0.065 ms (the notch).  Loading
// the transforms' input in natural order first, or two warps a transform,
// was slower.  No tensor cores: the configuration states float32.
#include <cuda_runtime.h>

#include "flms_fft.cuh"

// Field order and types are mirrored by _GscFrontParams in ops/cuda_flms.py.
struct GscFrontParams {
  float a00, a01, a10, a11, b0, b1;  // the notch's state: s' = A s + b x
  float c0, c1, dd;                  // its output: y = c . s + dd x
  float inv_m;                       // 1 / M, the beam's mean
};

namespace {

constexpr int kChunk = 16;   // samples of a notch chunk and outputs of a FIR run, a thread's
constexpr int kTaps = 8;     // taps a FIR step
constexpr int kPowers = 33;  // the notch table: A^(16 k), k = 0 .. 32, row-major 2 x 2

// Position j of a row in its padded layout: 4 floats after every 16.
__host__ __device__ __forceinline__ int sk(int j) { return j + ((j >> 4) << 2); }

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// The block's buffers at M mics, frame length Lf, K taps and a tile of
// `tile` samples, in floats.  `fixed` always lies in shared memory, `moving`
// (the M-proportional buffers) in shared memory or in the global scratch.
struct Layout {
  int N, Kp, halo, pre, tile, cpc, xs, ss, G, ngrp;
  size_t o_taps, o_nst, o_red, o_xb, o_sig, moving, fixed;
};

__host__ __device__ Layout layout(int M, int Lf, int K, int tile) {
  Layout L;
  L.N = 2 * Lf;
  L.Kp = (K + kTaps - 1) / kTaps * kTaps;
  L.halo = round16(L.Kp);   // the FIR reads back to Kp samples before a tile
  L.pre = round16(Lf);      // a signal row: the previous hop block ends at pre
  L.tile = tile;
  L.cpc = tile / kChunk;    // notch chunks a mic, a multiple of 32
  L.xs = round4(sk(L.halo + tile - 1) + 1);
  L.ss = round4(sk(L.pre + tile - 1) + 1);
  L.G = L.N >= 512 ? L.N / 512 : 1;  // warps a transform: one butterfly a thread a pass
  L.ngrp = kFrameWarps / L.G;
  L.o_taps = 0;                                                   // [M][Kp]
  L.o_nst = L.o_taps + round4(M * L.Kp);                          // [M][2] state at the tile's start
  L.o_red = L.o_nst + round4(2 * M);                              // [M][cpc / 32][2] warp totals
  L.o_xb = L.o_red + round4(M * (L.cpc / 32) * 2);                // [2][M][xs] [halo | tile] of notched mics
  L.o_sig = L.o_xb + 2 * (size_t)M * L.xs;                        // [M][ss] [.. previous block | tile]
  L.moving = L.o_sig + (size_t)M * L.ss;
  L.fixed = 2 * (size_t)L.N + round4(4 * kPowers) + (size_t)L.ngrp * 2 * L.N;  // tw, window, table, Z
  return L;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// c += P u, P a row-major 2 x 2 matrix.
__device__ __forceinline__ void madd(float4 P, float u0, float u1, float& c0, float& c1) {
  c0 = c0 + (P.x * u0 + P.y * u1);
  c1 = c1 + (P.z * u0 + P.w * u1);
}

// The first n (<= 4) values of v to dst: one float4 where dst is aligned and
// n = 4.
__device__ __forceinline__ void store_out(float* dst, float4 v, int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    st4(dst, v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < n && i < 4; ++i) dst[i] = e[i];
}

// x [B, M, S'] (utterance and mic strides sxb, sxm; samples contiguous),
// taps [M, K], tabs [N/2 twiddles as (cos, sin) | N window], ntab
// [kPowers][4] -> bm [B, C, S'], d [B, S'], yp [B, T, F], up [B, C, T, F]
// (null without the postfilter).  kGlobal: the moving buffers in work
// (round4z(moving) floats a block).
template <bool kGlobal>
__global__ void __launch_bounds__(kFrameThreads, 1)
    gsc_front_kernel(const float* __restrict__ x, int sxb, int sxm, const float* __restrict__ taps,
                     const float* __restrict__ tabs, const float* __restrict__ ntab, float* __restrict__ bm,
                     float* __restrict__ d, float* __restrict__ yp, float* __restrict__ up, float* work, int M, int T,
                     int Lf, int K, int tile, int logN, GscFrontParams prm) {
  extern __shared__ float4 smem4[];
  const Layout L = layout(M, Lf, K, tile);
  const int N = L.N, C = M - 1, F = Lf + 1, tid = threadIdx.x;
  const int S = T * Lf, halo = L.halo, pre = L.pre, xs = L.xs, ss = L.ss, cpc = L.cpc;
  float* sm = reinterpret_cast<float*>(smem4);
  float2* tw = reinterpret_cast<float2*>(sm);                            // [N/2]
  float* win = sm + N;                                                   // [N]
  float4* pw = reinterpret_cast<float4*>(win + N);                       // [kPowers] A^(16 k)
  float2* Z = reinterpret_cast<float2*>(win + N + round4(4 * kPowers));  // [ngrp][N]
  float* mv = kGlobal ? work + blockIdx.x * round4z(L.moving) : reinterpret_cast<float*>(Z + (size_t)L.ngrp * N);
  float* tp = mv + L.o_taps;
  float* nst = mv + L.o_nst;
  float* red = mv + L.o_red;
  float* xb = mv + L.o_xb;
  float* sig = mv + L.o_sig;
  const float* xu = x + (size_t)blockIdx.x * sxb;

  // the mics' samples [ts, ts + len) into the tile region of the buffer dst
  const bool aligned16 = ((reinterpret_cast<uintptr_t>(xu) | (uintptr_t)sxm * 4) & 15) == 0;
  auto prefetch = [&](int ts, int len, float* dst) {
    const int nrun = (len + kChunk - 1) / kChunk;
    for (int i = tid; i < M * nrun; i += kFrameThreads) {
      const int m = i / nrun, q = i - m * nrun, n = min(kChunk, len - q * kChunk);
      const float* src = xu + (size_t)m * sxm + ts + q * kChunk;
      float* dq = dst + (size_t)m * xs + sk(halo + q * kChunk);
      if (kGlobal) {
        for (int e = 0; e < n; ++e) dq[e] = src[e];
      } else if (aligned16 && n == kChunk) {
#pragma unroll
        for (int e = 0; e < kChunk; e += 4) copy_async16(dq + e, src + e);
      } else {
        for (int e = 0; e < n; ++e) copy_async4(dq + e, src + e);
      }
    }
    if (!kGlobal) copy_async_commit();
  };

  const int ntiles = (S + tile - 1) / tile;
  prefetch(0, min(tile, S), xb);
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kFrameThreads) tw[i] = twg[i];
  for (int i = tid; i < N; i += kFrameThreads) win[i] = tabs[N + i];
  for (int i = tid; i < kPowers; i += kFrameThreads) pw[i] = ld4(ntab + 4 * i);
  for (int i = tid; i < M * L.Kp; i += kFrameThreads) {
    const int m = i / L.Kp, j = i - m * L.Kp;
    tp[i] = j < K ? taps[m * K + j] : 0.f;
  }
  for (int i = tid; i < 2 * M; i += kFrameThreads) nst[i] = 0.f;
  for (int i = tid; i < M * halo; i += kFrameThreads) {  // the FIR's zero cache
    const int m = i / halo;
    xb[(size_t)m * xs + sk(i - m * halo)] = 0.f;
  }
  for (int i = tid; i < M * Lf; i += kFrameThreads) {  // the STFT's Lf leading zeros
    const int m = i / Lf;
    sig[(size_t)m * ss + sk(pre - Lf + i - m * Lf)] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int ts = it * tile, len = min(tile, S - ts);
    const bool more = it + 1 < ntiles;
    float* xc = xb + (size_t)(it & 1) * M * xs;
    float* xnext = xb + (size_t)((it + 1) & 1) * M * xs;
    if (!kGlobal) copy_async_wait_all();
    __syncthreads();  // this tile's mics are in; the previous tile's transforms have read the rows
    if (more) prefetch(ts + tile, min(tile, S - ts - tile), xnext);
    if (it > 0)  // the previous tile's last hop block, before this tile's
      for (int i = tid; i < M * Lf; i += kFrameThreads) {
        const int m = i / Lf, j = i - m * Lf;
        sig[(size_t)m * ss + sk(pre - Lf + j)] = sig[(size_t)m * ss + sk(pre + tile - Lf + j)];
      }

    // ---- the notch, exactly, in chunks: a thread a chunk, cpc chunks (whole
    // warps) a mic, kFrameThreads / cpc mics a round
    const int nchunk = (len + kChunk - 1) / kChunk;
    for (int mr = 0; mr < M; mr += kFrameThreads / cpc) {
      const int m = mr + tid / cpc, i = tid % cpc, l = i & 31, w = i >> 5;
      const bool act = m < M && i < nchunk;
      const int nv = act ? min(kChunk, len - i * kChunk) : 0;
      float* xq = xc + (size_t)(m < M ? m : 0) * xs + sk(halo + i * kChunk);
      float v[kChunk];
#pragma unroll
      for (int e = 0; e < kChunk; e += 4) {
        const float4 q = act ? ld4(xq + e) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[e] = q.x, v[e + 1] = q.y, v[e + 2] = q.z, v[e + 3] = q.w;
      }
      float c0 = 0.f, c1 = 0.f;  // the chunk from the zero state
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        if (e < nv) {
          const float t0 = prm.a00 * c0 + prm.a01 * c1 + prm.b0 * v[e];
          c1 = prm.a10 * c0 + prm.a11 * c1 + prm.b1 * v[e];
          c0 = t0;
        }
      }
      // inclusive scan of the chunk maps over the warp: the state after
      // chunk l from the zero state at the warp's first chunk
#pragma unroll
      for (int dl = 1; dl < 32; dl <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, c0, dl), u1 = __shfl_up_sync(0xffffffffu, c1, dl);
        if (l >= dl) madd(pw[dl], u0, u1, c0, c1);
      }
      float e0 = __shfl_up_sync(0xffffffffu, c0, 1), e1 = __shfl_up_sync(0xffffffffu, c1, 1);  // exclusive
      if (l == 0) e0 = e1 = 0.f;
      if (m < M && l == 31) {
        red[(m * (cpc / 32) + w) * 2] = c0;
        red[(m * (cpc / 32) + w) * 2 + 1] = c1;
      }
      const float s0 = m < M ? nst[2 * m] : 0.f, s1 = m < M ? nst[2 * m + 1] : 0.f;
      __syncthreads();  // the warp totals; every thread of the mic has read its start state
      if (act) {
        // the state at the warp's first chunk, then at this chunk's
        float a0 = s0, a1 = s1;
        for (int wq = 0; wq < w; ++wq) {
          const float4 P = pw[32];
          const float t0 = P.x * a0 + P.y * a1, t1 = P.z * a0 + P.w * a1;
          a0 = t0 + red[(m * (cpc / 32) + wq) * 2];
          a1 = t1 + red[(m * (cpc / 32) + wq) * 2 + 1];
        }
        const float4 P = pw[l];
        float m0 = e0, m1 = e1;
        madd(P, a0, a1, m0, m1);
        // the chunk again from its true start state, notched in place
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          if (e < nv) {
            const float xe = v[e];
            v[e] = prm.dd * xe + prm.c0 * m0 + prm.c1 * m1;
            const float t0 = prm.a00 * m0 + prm.a01 * m1 + prm.b0 * xe;
            m1 = prm.a10 * m0 + prm.a11 * m1 + prm.b1 * xe;
            m0 = t0;
          }
        }
#pragma unroll
        for (int e = 0; e < kChunk; e += 4) st4(xq + e, make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]));
        if (i == nchunk - 1) {
          nst[2 * m] = m0;
          nst[2 * m + 1] = m1;
        }
      }
      __syncthreads();  // the notched mics; the warp totals are free again
    }

    // ---- the next tile's halo; the FIR into the signal rows' tile region
    if (more)
      for (int i = tid; i < M * halo; i += kFrameThreads) {
        const int m = i / halo, j = i - m * halo;
        xnext[(size_t)m * xs + sk(j)] = xc[(size_t)m * xs + sk(tile + j)];
      }
    for (int item = tid; item < M * cpc; item += kFrameThreads) {
      const int m = item / cpc, g = item - m * cpc;
      if (g * kChunk >= len) continue;
      const float* xr = xc + (size_t)m * xs;
      const float* cr = tp + (size_t)m * L.Kp;
      float acc[kChunk];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) acc[r] = 0.f;
      for (int j0 = 0; j0 < L.Kp; j0 += kTaps) {
        // w[q] = xn[16 g - j0 - 8 + q]: acc[r] += c[j0 + jj] * xn[16 g + r - j0 - jj]
        const int base = halo + g * kChunk - j0 - kTaps;
        float wv[kChunk + kTaps];
#pragma unroll
        for (int q = 0; q < kChunk + kTaps; q += 4) {
          const float4 f = ld4(xr + sk(base + q));
          wv[q] = f.x, wv[q + 1] = f.y, wv[q + 2] = f.z, wv[q + 3] = f.w;
        }
        const float4 ca = ld4(cr + j0), cb = ld4(cr + j0 + 4);
        const float c[kTaps] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
        for (int jj = 0; jj < kTaps; ++jj)
#pragma unroll
          for (int r = 0; r < kChunk; ++r) acc[r] = acc[r] + c[jj] * wv[r - jj + kTaps];
      }
      float* dr = sig + (size_t)m * ss + sk(pre + g * kChunk);
#pragma unroll
      for (int r = 0; r < kChunk; r += 4) st4(dr + r, make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]));
    }
    __syncthreads();  // the aligned mics

    // ---- rows -> [fbf, bm_0 .. bm_{C-1}] in place; bm out
    for (int p = 4 * tid; p < len; p += 4 * kFrameThreads) {
      const int o = sk(pre + p), n = min(4, len - p);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int m = 0; m < M; ++m) {
        const float4 a = ld4(sig + (size_t)m * ss + o);
        sum = make_float4(sum.x + a.x, sum.y + a.y, sum.z + a.z, sum.w + a.w);
      }
      float4 prev = ld4(sig + o);
      for (int c = 0; c < C; ++c) {
        const float4 nx = ld4(sig + (size_t)(c + 1) * ss + o);
        const float4 b = make_float4(prev.x - nx.x, prev.y - nx.y, prev.z - nx.z, prev.w - nx.w);
        st4(sig + (size_t)(c + 1) * ss + o, b);
        store_out(bm + ((size_t)blockIdx.x * C + c) * S + ts + p, b, n);
        prev = nx;
      }
      st4(sig + o, make_float4(sum.x * prm.inv_m, sum.y * prm.inv_m, sum.z * prm.inv_m, sum.w * prm.inv_m));
    }
    __syncthreads();  // the beam and the blocking matrix

    // ---- d out; the STFT powers: frames h, h + 1 of the signals in pairs
    for (int p = tid; p < len; p += kFrameThreads) d[(size_t)blockIdx.x * S + ts + p] = sig[sk(pre + p - Lf / 2)];
    const int H = len / Lf, nsig = up != nullptr ? M : 1, nreal = nsig * H;
    const int grp = (tid >> 5) / L.G, r = tid - grp * 32 * L.G, nthr = 32 * L.G;
    float2* Zg = Z + (size_t)grp * N;
    for (int q = grp; 2 * q < nreal; q += L.ngrp) {
      const int ia = 2 * q, ib = 2 * q + 1;
      const bool two = ib < nreal;
      const int sa = ia / H, ha = ia - sa * H, sb = two ? ib / H : sa, hb = two ? ib - sb * H : ha;
      const float* ra = sig + (size_t)sa * ss;
      const float* rb = sig + (size_t)sb * ss;
      const int oa = pre - Lf + ha * Lf, ob = pre - Lf + hb * Lf;
      seq_sync(nthr, 1 + grp);  // the group's reads of its last spectrum are done
      fft_seq_from<false>(Zg, logN, tw, r, nthr, 1 + grp, [&](const float2*, int pos, int lg) {
        const int n = bitrev(pos, lg);
        return make_float2(win[n] * ra[sk(oa + n)], two ? win[n] * rb[sk(ob + n)] : 0.f);
      });
      seq_sync(nthr, 1 + grp);
      const int ta = ts / Lf + ha, tb = ts / Lf + hb;
      float* pa = sa == 0 ? yp + ((size_t)blockIdx.x * T + ta) * F : up + (((size_t)blockIdx.x * C + sa - 1) * T + ta) * F;
      float* pb = sb == 0 ? yp + ((size_t)blockIdx.x * T + tb) * F : up + (((size_t)blockIdx.x * C + sb - 1) * T + tb) * F;
      for (int k = r; k < F; k += nthr) {
        float2 X, Y;
        split_pair(Zg, k, N, logN, X, Y);
        pa[k] = X.x * X.x + X.y * X.y;
        if (two) pb[k] = Y.x * Y.x + Y.y * Y.y;
      }
    }
  }
}

// The tile for M mics at this Lf and K where the block's buffers all fit in
// shared memory (the largest of 2048, 1024, 512 that is a multiple of Lf),
// or 0.
int smem_tile(int M, int Lf, int K) {
  for (int tile = 2048; tile >= 512 && tile >= Lf; tile /= 2) {
    const Layout L = layout(M, Lf, K, tile);
    if (sizeof(float) * (L.fixed + L.moving) <= kMaxSmem) return tile;
  }
  return 0;
}

bool valid(int M, int Lf, int K) { return M >= 2 && K >= 1 && log2_of_twice(Lf) >= 0; }

template <bool kGlobal>
cudaError_t launch(const float* x, int sxb, int sxm, const float* taps, const float* tabs, const float* ntab,
                   float* bm, float* d, float* yp, float* up, float* work, int B, int M, int T, int Lf, int K,
                   int tile, const GscFrontParams& prm, cudaStream_t st) {
  const Layout L = layout(M, Lf, K, tile);
  const size_t smem = sizeof(float) * (kGlobal ? L.fixed : L.fixed + L.moving);
  const cudaError_t e = allow_smem(gsc_front_kernel<kGlobal>, smem);
  if (e != cudaSuccess) return e;
  gsc_front_kernel<kGlobal><<<B, kFrameThreads, smem, st>>>(x, sxb, sxm, taps, tabs, ntab, bm, d, yp, up, work, M, T,
                                                            Lf, K, tile, log2_of_twice(Lf), prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of global scratch the launch needs (0 where the block's buffers fit
// in shared memory), -1 for a shape the launcher does not take.
long long gsc_front_scratch_floats(int M, int B, int Lf, int K) {
  if (!valid(M, Lf, K) || B < 1) return -1;
  if (smem_tile(M, Lf, K) > 0) return 0;
  return (long long)B * round4z(layout(M, Lf, K, Lf > 512 ? Lf : 512).moving);
}

// M >= 2 mics, Lf a power of two from 2 to 2048, K >= 1 taps; up null
// without the postfilter.  x's samples contiguous, its utterance and mic
// strides sxb and sxm; every other array contiguous.
cudaError_t gsc_front_launch(const void* x, int sxb, int sxm, const void* taps, const void* tabs, const void* ntab,
                             void* bm, void* d, void* yp, void* up, void* scratch, int B, int M, int T, int Lf, int K,
                             const void* params, void* stream) {
  if (!valid(M, Lf, K) || B < 1 || T < 1) return cudaErrorInvalidValue;
  const GscFrontParams prm = *static_cast<const GscFrontParams*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(taps);
  const float* bf = static_cast<const float*>(tabs);
  const float* nf = static_cast<const float*>(ntab);
  float* bmf = static_cast<float*>(bm);
  float* df = static_cast<float*>(d);
  float* yf = static_cast<float*>(yp);
  float* uf = static_cast<float*>(up);
  const int tile = smem_tile(M, Lf, K);
  if (tile > 0) return launch<false>(xf, sxb, sxm, tf, bf, nf, bmf, df, yf, uf, nullptr, B, M, T, Lf, K, tile, prm, st);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  return launch<true>(xf, sxb, sxm, tf, bf, nf, bmf, df, yf, uf, static_cast<float*>(scratch), B, M, T, Lf, K,
                      Lf > 512 ? Lf : 512, prm, st);
}

const char* gsc_front_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
