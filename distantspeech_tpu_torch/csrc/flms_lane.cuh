// Shared pieces of the FLMS-family kernels (K5 flms.cu, K6 kws.cu, K7
// aec.cu, K8 fdgsc.cu; K9 sgsc.cu and K4 enhance.cu use some): the
// shared-memory radix-2 FFT, the half-spectrum helpers and the MCRA state
// in shared memory.
//
// A kernel that runs its transforms through fft_stages (K6) runs
// kThreads threads per block, one block per utterance, and does each
// 2L-point transform of its frame loop as an in-place FFT in shared memory:
// a real signal as a complex FFT with zero imaginary part, a half spectrum
// through its hermitian extension (put_half).  The twiddles come from the host with
// the exact zeros of sin and cos kept exact, so bins 0 and N/2 of a real
// signal stay real.
#pragma once

#include <cuda_runtime.h>

#include "enhance_lane.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int bitrev(int n, int logN) { return (int)(__brev((unsigned)n) >> (32 - logN)); }

// In-place radix-2 decimation-in-time stages over nseq contiguous length-N
// sequences whose inputs were stored in bit-reversed order.  tw[j] =
// e^{-2 pi i j / N}, j < N/2; the inverse conjugates them and does not
// scale.  Ends with a barrier.
__device__ void fft_stages(float2* a, int nseq, int N, int logN, const float2* tw, bool inverse) {
  const int halfN = N >> 1;
  const int total = nseq * halfN;
  for (int s = 1; s <= logN; ++s) {
    const int half = 1 << (s - 1);
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int q = i >> (logN - 1);
      const int j = i & (halfN - 1);
      const int pos = j & (half - 1);
      const int i0 = (q << logN) + ((j - pos) << 1) + pos;
      const int i1 = i0 + half;
      float2 w = tw[pos << (logN - s)];
      if (inverse) w.y = -w.y;
      const float2 b = a[i1];
      const float2 v = make_float2(b.x * w.x - b.y * w.y, b.x * w.y + b.y * w.x);
      const float2 u = a[i0];
      a[i0] = make_float2(u.x + v.x, u.y + v.y);
      a[i1] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

// Bin k (0 <= k <= N/2) of a real signal's half spectrum into a bit-reversed
// full spectrum, with its hermitian mirror; bins 0 and N/2 drop their
// imaginary part, as the inverse real DFT does.
__device__ __forceinline__ void put_half(float2* a, int k, int N, int logN, float re, float im) {
  if (k == 0 || k == (N >> 1)) {
    a[bitrev(k, logN)] = make_float2(re, 0.f);
    return;
  }
  a[bitrev(k, logN)] = make_float2(re, im);
  a[bitrev(N - k, logN)] = make_float2(re, -im);
}

// conj(X) * E / P, the FLMS gradient of one bin, into bin k of a
// bit-reversed half spectrum.
__device__ __forceinline__ void put_grad(float2* a, int k, int N, int logN, float2 X, float2 E, float P) {
  put_half(a, k, N, logN, (X.x * E.x + X.y * E.y) / P, (X.x * E.y - X.y * E.x) / P);
}

__device__ __forceinline__ float2 cmulf(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Zero-padded [0.25, 0.5, 0.25] smoothing of row at bin k.
__device__ __forceinline__ float smooth_zero(const float* row, int k, int F) {
  return 0.25f * (k > 0 ? row[k - 1] : 0.f) + 0.5f * row[k] + 0.25f * (k < F - 1 ? row[k + 1] : 0.f);
}

__device__ __forceinline__ McraLane load_mcra(const float* st, int stride, int i) {
  return McraLane{st[i], st[stride + i], st[2 * stride + i], st[3 * stride + i], st[4 * stride + i]};
}

__device__ __forceinline__ void store_mcra(float* st, int stride, int i, const McraLane& m) {
  st[i] = m.S;
  st[stride + i] = m.Smin;
  st[2 * stride + i] = m.Stmp;
  st[3 * stride + i] = m.P;
  st[4 * stride + i] = m.Lam;
}

// Raises the kernel's dynamic shared-memory limit where it needs more than
// the default 48 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// log2 of N = 2 L for a power-of-two L, or -1.
inline int log2_of_twice(int L) {
  int logN = 1;
  while ((1 << logN) < 2 * L) ++logN;
  return (L >= 2 && (1 << logN) == 2 * L && logN <= 12) ? logN : -1;
}

}  // namespace
