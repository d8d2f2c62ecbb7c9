// Shared pieces of the FLMS-family kernels (K5 flms.cu, K6 kws.cu, K7
// aec.cu, K8 fdgsc.cu; K9 sgsc.cu and K4 enhance.cu use some): bit
// reversal, the complex product, the MCRA state in shared memory, the
// cross-bin smoothing and the launch helpers.
#pragma once

#include <cuda_runtime.h>

#include "enhance_lane.cuh"

namespace {

__device__ __forceinline__ int bitrev(int n, int logN) { return (int)(__brev((unsigned)n) >> (32 - logN)); }

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
