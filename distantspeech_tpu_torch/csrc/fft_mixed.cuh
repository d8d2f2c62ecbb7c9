// A mixed-radix FFT owned by a warp (or a group of warps), for the
// transform sizes that are not powers of two: N = 2^a 3^b 5^c ... (the mega
// kernel's n_fft, any multiple of 256).  Beside flms_fft.cuh, whose
// radix-2^k passes work in place on a bit-reversed layout and take only
// N = 2^logN.
//
// Stockham's self-sorting form: every pass reads one buffer and writes the
// other, natural order in and out, no digit reversal.  A pass of radix P on
// the sub-length n (stride s = N / n) takes, for each j < n / P and q < s,
// the P points x[q + s (j + r n / P)], r < P, transforms them (a DFT of
// length P) and writes y[q + s (P j + u)] = b_u w^(j u), w = e^{-2 pi i / n}.
// Radices 8, 4 and 2 run as radix-2 butterflies in registers, 3 and 5 as
// direct DFTs in registers, and any other prime factor p as a direct DFT of
// length p per butterfly, read from and written to the buffers (no
// register array of run-time size).  The twiddles come from a table of the
// N-th roots tw[j] = e^{-2 pi i j / N}, j < N (the inverse conjugates them
// and does not scale).  The first pass reads its input through a functor,
// so that a transform can window, pack or extend its input as it loads it.
#pragma once

#include <cuda_runtime.h>

#include "flms_fft.cuh"

namespace {

// The radix of the next pass on the sub-length n: 8, 4, 2, 3, 5, then the
// smallest odd prime factor.
__host__ __device__ __forceinline__ int next_radix(int n) {
  if (n % 8 == 0) return 8;
  if (n % 4 == 0) return 4;
  if (n % 2 == 0) return 2;
  if (n % 3 == 0) return 3;
  if (n % 5 == 0) return 5;
  for (int p = 7; p * p <= n; p += 2)
    if (n % p == 0) return p;
  return n;
}

// Passes of an N-point transform.
__host__ __device__ __forceinline__ int fft_passes(int N) {
  int c = 0;
  for (int n = N; n > 1; n /= next_radix(n)) ++c;
  return c;
}

// b_u = sum_r a_r W^(r u), W = e^{-+2 pi i / P} given as its powers rt.
template <int P>
__device__ __forceinline__ void dft_regs(float2 (&a)[P], const float2 (&rt)[P]) {
  float2 b[P];
  if constexpr (P == 2 || P == 4 || P == 8) {
    constexpr int L = P == 2 ? 1 : P == 4 ? 2 : 3;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      int rj = 0;
#pragma unroll
      for (int bit = 0; bit < L; ++bit) rj |= ((j >> bit) & 1) << (L - 1 - bit);
      b[rj] = a[j];
    }
#pragma unroll
    for (int len = 2; len <= P; len <<= 1) {
#pragma unroll
      for (int st = 0; st < P; st += len) {
#pragma unroll
        for (int j = 0; j < len / 2; ++j) {
          const float2 u = b[st + j], v = cmulf(b[st + j + len / 2], rt[j * (P / len)]);
          b[st + j] = make_float2(u.x + v.x, u.y + v.y);
          b[st + j + len / 2] = make_float2(u.x - v.x, u.y - v.y);
        }
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      float2 acc = a[0];
#pragma unroll
      for (int r = 1; r < P; ++r) {
        const float2 t = cmulf(a[r], rt[(r * u) % P]);
        acc = make_float2(acc.x + t.x, acc.y + t.y);
      }
      b[u] = acc;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) a[j] = b[j];
}

__device__ __forceinline__ float2 root(const float2* tw, int j, bool inv) {
  const float2 w = tw[j];
  return inv ? make_float2(w.x, -w.y) : w;
}

// One pass of radix P (a compile-time constant) on the sub-length n, from
// the points ld(i) to y, by thread r of nthr.
template <int P, bool kInv, class Load>
__device__ __forceinline__ void stockham_pass(float2* y, int N, int n, int s, const float2* tw, int r, int nthr,
                                              const Load& ld) {
  const int m = n / P, tstep = N / n;
  float2 rt[P];
#pragma unroll
  for (int j = 0; j < P; ++j) rt[j] = root(tw, j * (N / P), kInv);
  for (int b = r; b < N / P; b += nthr) {
    const int j = b / s, q = b - j * s;
    float2 a[P];
#pragma unroll
    for (int u = 0; u < P; ++u) a[u] = ld(q + s * (j + u * m));
    dft_regs<P>(a, rt);
    y[q + s * P * j] = a[0];
#pragma unroll
    for (int u = 1; u < P; ++u) y[q + s * (P * j + u)] = cmulf(a[u], root(tw, j * u * tstep, kInv));
  }
}

// One pass of an odd radix p known at run time: a direct DFT of length p
// per butterfly.
template <bool kInv, class Load>
__device__ void stockham_pass_odd(float2* y, int N, int n, int s, int p, const float2* tw, int r, int nthr,
                                  const Load& ld) {
  const int m = n / p, tstep = N / n, rstep = N / p;
  for (int b = r; b < N / p; b += nthr) {
    const int j = b / s, q = b - j * s;
    for (int u = 0; u < p; ++u) {
      float2 acc = ld(q + s * j);
      for (int v = 1; v < p; ++v) {
        const float2 t = cmulf(ld(q + s * (j + v * m)), root(tw, ((v * u) % p) * rstep, kInv));
        acc = make_float2(acc.x + t.x, acc.y + t.y);
      }
      y[q + s * (p * j + u)] = u == 0 ? acc : cmulf(acc, root(tw, j * u * tstep, kInv));
    }
  }
}

// The N-point transform (unscaled inverse for kInv) of the points first(i),
// i < N, by the nthr threads of a group (rank r, named barrier id where
// nthr > 32), ping-ponging between the buffers a and b; returns the one
// that holds the result (a after an odd number of passes).  No barrier
// before the first pass or after the last.
template <bool kInv, class First>
__device__ float2* fft_any(float2* a, float2* b, int N, const float2* tw, int r, int nthr, int id,
                           const First& first) {
  float2* out = a;
  float2* in = b;
  int n = N, s = 1;
  for (bool first_pass = true; n > 1; first_pass = false) {
    const int p = next_radix(n);
    auto run = [&](const auto& ld) {
      switch (p) {
        case 8: stockham_pass<8, kInv>(out, N, n, s, tw, r, nthr, ld); break;
        case 4: stockham_pass<4, kInv>(out, N, n, s, tw, r, nthr, ld); break;
        case 2: stockham_pass<2, kInv>(out, N, n, s, tw, r, nthr, ld); break;
        case 3: stockham_pass<3, kInv>(out, N, n, s, tw, r, nthr, ld); break;
        case 5: stockham_pass<5, kInv>(out, N, n, s, tw, r, nthr, ld); break;
        default: stockham_pass_odd<kInv>(out, N, n, s, p, tw, r, nthr, ld); break;
      }
    };
    if (first_pass) {
      run(first);
    } else {
      seq_sync(nthr, id);
      const float2* x = in;
      run([x](int i) { return x[i]; });
    }
    n /= p;
    s *= p;
    float2* t = in;
    in = out;
    out = t;
  }
  return in;
}

}  // namespace
