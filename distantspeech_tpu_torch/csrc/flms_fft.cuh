// The frame-loop pieces of the redesigned kernels K5 (flms.cu), K8
// (fdgsc.cu), K7 (aec.cu), K4 (enhance.cu's mega kernel) and K9 (sgsc.cu):
// a complex FFT owned by one warp (or a few warps) instead of the whole
// block, two real transforms packed into one complex FFT, and the
// asynchronous prefetch of the next frame's inputs into shared memory.
//
// The transform.  Each N-point sequence (N = 2^logN, 4 <= N <= 4096) lies in
// shared memory in bit-reversed order, point p at swz(p): p with its low four
// bits XORed with its top four, so that the bit-reversed stores of
// consecutive bins, 2^(logN-4) points apart, fall in different banks instead
// of one, at no cost in memory.  It is transformed in place by a group of G
// warps: the radix-2 decimation-in-time stages of fft_stages
// (flms_lane.cuh), taken three at a time, so that each pass is one radix-8
// butterfly per thread and point octet (a radix-4 or radix-2 pass closes
// logN % 3 != 0), its 8 points in registers.  The passes of one sequence are
// separated by __syncwarp (G = 1) or by a named barrier of the group's warps
// (bar.sync id, 32 G); no block barrier falls inside a transform.  fft_batch
// hands the sequences of a batch to the block's warps: G warps a sequence
// where the batch leaves warps idle and N / 8 butterflies give each thread
// one.  The arithmetic of each stage is fft_stages' own (the same twiddle
// table, the exact zeros kept exact), so bins 0 and N/2 of a real signal stay
// real.
//
// Real pairs.  Two real signals x and y go through one complex FFT as
// z = x + i y: split_pair recovers X_k = (Z_k + conj Z_{N-k}) / 2 and
// Y_k = (Z_k - conj Z_{N-k}) / (2i), bins 0 and N/2 exactly real.  Two
// hermitian half spectra A and B go back through one inverse as A + i B
// (put_pair): the inverse is N (a + i b), a in .x and b in .y.
//
// Prefetch.  prefetch_floats issues cp.async copies (16 bytes where both ends
// are aligned, else 4) that complete at copy_async_wait_all; the kernels
// issue the next frame's inputs right after a frame's first barrier and wait
// before its last.
//
// Tensor cores are not used: a TF32 product keeps ~10 mantissa bits, against
// a 1e-3 gate over a 250-frame adaptive recursion, and a 3xTF32 mma costs
// more than a 512-point transform's butterflies.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flms_lane.cuh"

namespace {

// Threads per block of K5, K8 and K7: 512 beat 256 for K5 and K8 on an
// H100 (PERF.md, measured with scripts/flms_variants.py on a copy of these
// sources with 256 here).  One block per SM: the kernels declare
// __launch_bounds__(kFrameThreads, 1), since left free ptxas halves the
// registers (and spills) to fit a second block that the batch of 128
// utterances never launches.
constexpr int kFrameThreads = 512;
constexpr int kFrameWarps = kFrameThreads / 32;

#ifdef __CUDACC__
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void copy_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
#endif

// Where point p of an N = 2^logN point sequence lies: p with its low four
// bits XORed with the four above bit logN - 4 (a bijection on 0 .. N-1 for
// every N >= 4).
__device__ __forceinline__ int swz(int p, int logN) { return p ^ ((p >> max(logN - 4, 1)) & 15); }

// n rounded up to a multiple of 4 floats (16 bytes).
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Issues the copy of n floats from src (global) to dst (shared) by the nthr
// threads of a group (this one of rank r); each thread's copies land at its
// copy_async_wait_all.
__device__ __forceinline__ void prefetch_floats(float* dst, const float* src, int n, int r, int nthr) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0 && (n & 3) == 0) {
    for (int i = r; i < n / 4; i += nthr) copy_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = r; i < n; i += nthr) copy_async4(dst + i, src + i);
  }
}

// The same by the block's kFrameThreads threads.
__device__ __forceinline__ void prefetch_floats(float* dst, const float* src, int n) {
  prefetch_floats(dst, src, n, threadIdx.x, kFrameThreads);
}

// Point p of a sequence, in its bit-reversed, swizzled layout in a: the
// input of a transform run in place.
struct InPlace {
  __device__ __forceinline__ float2 operator()(const float2* a, int p, int logN) const { return a[swz(p, logN)]; }
};

// One pass: radix-2 stages s0 .. s0 + K - 1 of fft_stages, each butterfly's
// 2^K points (spaced 2^(s0-1) apart) in registers, by thread r of nthr; the
// points read as load(a, p, logN) (p a bit-reversed position), written to a.
template <int K, bool kInv, class Load = InPlace>
__device__ __forceinline__ void fft_pass(float2* a, int logN, int s0, const float2* tw, int r, int nthr,
                                         const Load& load = Load()) {
  constexpr int P = 1 << K;
  const int half = 1 << (s0 - 1);
  const int nb = (1 << logN) >> K;
  for (int b = r; b < nb; b += nthr) {
    const int pos = b & (half - 1);
    const int base = ((b >> (s0 - 1)) << (s0 - 1 + K)) + pos;
    float2 x[P];
#pragma unroll
    for (int j = 0; j < P; ++j) x[j] = load(a, base + j * half, logN);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int sh = logN - (s0 + m);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (j & (1 << m)) continue;
        // stage s0 + m pairs point j with j + 2^m; its twiddle index is the
        // position within the stage's half span, pos + (j mod 2^m) half
        float2 w = tw[(pos + (j & ((1 << m) - 1)) * half) << sh];
        if (kInv) w.y = -w.y;
        const float2 u = x[j], bb = x[j + (1 << m)];
        const float2 v = make_float2(bb.x * w.x - bb.y * w.y, bb.x * w.y + bb.y * w.x);
        x[j] = make_float2(u.x + v.x, u.y + v.y);
        x[j + (1 << m)] = make_float2(u.x - v.x, u.y - v.y);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) a[swz(base + j * half, logN)] = x[j];
  }
}

// The pass from stage s0 on: radix-8, or the radix-4 or radix-2 that closes
// a transform whose log2 N is not a multiple of 3.
template <bool kInv, class Load = InPlace>
__device__ __forceinline__ void fft_pass_at(float2* a, int logN, int s0, const float2* tw, int r, int nthr,
                                            const Load& load = Load()) {
  const int k = logN - s0 + 1;
  if (k >= 3)
    fft_pass<3, kInv>(a, logN, s0, tw, r, nthr, load);
  else if (k == 2)
    fft_pass<2, kInv>(a, logN, s0, tw, r, nthr, load);
  else
    fft_pass<1, kInv>(a, logN, s0, tw, r, nthr, load);
}

// The sync between two passes of a sequence owned by nthr threads.
__device__ __forceinline__ void seq_sync(int nthr, int id) {
  if (nthr == 32)
    __syncwarp();
  else
    group_sync(id, nthr);
}

// One N-point sequence (bit-reversed in, natural out, unscaled inverse) by
// the nthr threads of a group; rank r, named barrier id for nthr > 32.
template <bool kInv>
__device__ void fft_seq(float2* a, int logN, const float2* tw, int r, int nthr, int id) {
  for (int s0 = 1; s0 <= logN; s0 += 3) {
    fft_pass_at<kInv>(a, logN, s0, tw, r, nthr);
    if (s0 + 3 <= logN) seq_sync(nthr, id);
  }
}

// The same for a sequence whose input is not in a: the first pass reads
// point p (a bit-reversed position) as first(a, p, logN), so that a
// transform can window, pack or extend its input as it loads it, without a
// pass of bit-reversed stores before it.  Inlined, so that a caller with a
// compile-time logN and nthr gets its index arithmetic folded.
template <bool kInv, class First>
__device__ __forceinline__ void fft_seq_from(float2* a, int logN, const float2* tw, int r, int nthr, int id,
                                             const First& first) {
  fft_pass_at<kInv>(a, logN, 1, tw, r, nthr, first);
#pragma unroll
  for (int s0 = 4; s0 <= logN; s0 += 3) {
    seq_sync(nthr, id);
    fft_pass_at<kInv>(a, logN, s0, tw, r, nthr);
  }
}

// nseq contiguous N-point sequences, each owned by a group of G warps.
// Called by every thread of the block; no block barrier inside (the caller
// puts one before, where the inputs were written by other warps, and one
// after, before other warps read the spectra).
template <bool kInv>
__device__ void fft_batch(float2* a, int nseq, int N, int logN, const float2* tw) {
  int G = 1;
  while (2 * G * nseq <= kFrameWarps && 64 * G <= (N >> 3)) G *= 2;
  const int grp = (threadIdx.x >> 5) / G;
  const int r = threadIdx.x - grp * G * 32;
  for (int q = grp; q < nseq; q += kFrameWarps / G)
    fft_seq<kInv>(a + (size_t)q * N, logN, tw, r, 32 * G, 1 + grp);
}

// Bins k of X and Y from Z = FFT(x + i y) (natural order).
__device__ __forceinline__ void split_pair(const float2* Z, int k, int N, int logN, float2& X, float2& Y) {
  const float2 a = Z[swz(k, logN)], c = Z[swz((N - k) & (N - 1), logN)];
  X = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
  Y = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
}

// Bin k (0 <= k <= N/2) of the hermitian half spectra A and B into a
// bit-reversed full spectrum whose inverse is N (a + i b); bins 0 and N/2
// drop their imaginary parts, as put_half does (B = 0 is put_half).
__device__ __forceinline__ void put_pair(float2* z, int k, int N, int logN, float2 A, float2 B) {
  if (k == 0 || k == (N >> 1)) {
    z[swz(bitrev(k, logN), logN)] = make_float2(A.x, B.x);
    return;
  }
  z[swz(bitrev(k, logN), logN)] = make_float2(A.x - B.y, A.y + B.x);
  z[swz(bitrev(N - k, logN), logN)] = make_float2(A.x + B.y, B.x - A.y);
}

// Adds B as the second half spectrum of a pair whose first put_pair gave
// B = 0 (each position is touched by bin k's thread alone).
__device__ __forceinline__ void add_pair_b(float2* z, int k, int N, int logN, float2 B) {
  float2& lo = z[swz(bitrev(k, logN), logN)];
  if (k == 0 || k == (N >> 1)) {
    lo.y = lo.y + B.x;
    return;
  }
  float2& hi = z[swz(bitrev(N - k, logN), logN)];
  lo = make_float2(lo.x - B.y, lo.y + B.x);
  hi = make_float2(hi.x + B.y, hi.y + B.x);
}

// conj(X) E / P: the FLMS gradient of one bin.
__device__ __forceinline__ float2 grad_bin(float2 X, float2 E, float P) {
  return make_float2((X.x * E.x + X.y * E.y) / P, (X.x * E.y - X.y * E.x) / P);
}

// Sums of v over each warp into red[j * kFrameWarps + warp]; the block's
// totals are sum_partials after a barrier.
template <int NV>
__device__ __forceinline__ void warp_partials(float (&v)[NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float s = v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[j * kFrameWarps + warp] = s;
  }
}

// max of v over the warp into red[warp].
__device__ __forceinline__ void warp_max_partial(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
}

// The exponent e of the power of two 2^e that brings a signal whose largest
// magnitude is mb to the scale of one whose largest is ma, for packing the
// two as a + i 2^e b (exact scaling, so b's spectrum keeps its own relative
// precision instead of drowning in a's rounding); 64 where b is zero.
__device__ __forceinline__ int pack_exponent(float ma, float mb) {
  if (mb == 0.f) return 64;
  if (ma == 0.f) return 0;
  return min(max(ilogbf(ma) - ilogbf(mb), -64), 64);
}

// The block's totals from warp_partials, in a fixed order (every thread gets
// the same values).
template <int NV>
__device__ __forceinline__ void sum_partials(float (&v)[NV], const float* red) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float s = red[j * kFrameWarps];
    for (int w = 1; w < kFrameWarps; ++w) s = s + red[j * kFrameWarps + w];
    v[j] = s;
  }
}

}  // namespace
