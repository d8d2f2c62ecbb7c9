// A CPU stand-in for the part of the CUDA runtime and device language that
// the port's FLMS-family kernels (distantspeech_tpu_torch/csrc) use, so that
// g++ (C++20) can compile a kernel source and run a launch on the CPU: one
// std::thread per CUDA thread, the blocks of a grid one after another.
//
// - __syncthreads is a std::barrier of the block, __syncwarp one of the warp,
//   group_sync(id, n) (bar.sync id, n) one per (id, n) of the block;
// - __shfl_xor_sync, __shfl_up_sync, __shfl_sync and __any_sync exchange
//   through a two-half per-thread array, one warp barrier a shuffle;
// - the cp.async helpers of flms_fft.cuh are plain copies, their commit and
//   wait no-ops;
// - srp.cu's warp-level mma.sync m16n8k8 TF32 (mma_m16n8k8_tf32): each
//   thread puts its A and B fragments into a per-warp array, and after the
//   warp's barrier forms its C fragment from the PTX ISA's fragment layout,
//   its operands cut to TF32 (the 13 low bits dropped) as the tensor cores
//   read them;
// - dynamic shared memory is filled with NaN at each block's start, so a read
//   of a word the kernel never wrote shows in its outputs;
// - a launch with more than 1024 threads or more dynamic shared memory than a
//   Hopper block may use (232,448 bytes) fails as the card's would.
//
// rehearse.py rewrites the two constructs g++ cannot parse: the `<<<...>>>`
// launch and `extern __shared__`.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;

namespace shim {

constexpr size_t kMaxSmem = 232448;  // a Hopper block's dynamic shared memory with the opt-in

struct Block {
  explicit Block(unsigned nthreads, size_t smem_bytes) : all(nthreads) {
    for (unsigned w = 0; w < (nthreads + 31) / 32; ++w) warps.emplace_back(std::make_unique<std::barrier<>>(32));
    exchange.resize(2 * nthreads);
    fragments.resize(2 * 6 * nthreads);
    const size_t n = smem_bytes / sizeof(float) + 4;
    smem = static_cast<float*>(std::aligned_alloc(16, ((n * sizeof(float) + 15) / 16) * 16));
    for (size_t i = 0; i < n; ++i) smem[i] = std::numeric_limits<float>::quiet_NaN();
  }
  ~Block() { std::free(smem); }
  std::barrier<>& named(int id, int n) {
    std::lock_guard<std::mutex> lock(mu);
    auto& b = groups[{id, n}];
    if (!b) b = std::make_unique<std::barrier<>>(n);
    return *b;
  }
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<float> exchange;
  std::vector<uint32_t> fragments;  // mma_m16n8k8_tf32's A and B registers, 6 a thread, two halves
  std::mutex mu;
  std::map<std::pair<int, int>, std::unique_ptr<std::barrier<>>> groups;
  float* smem = nullptr;
};

inline thread_local Block* block = nullptr;
inline thread_local cudaError_t last_error = cudaSuccess;

inline void* dynamic_smem() { return block->smem; }

template <class Body>
void launch(unsigned grid, unsigned nthreads, size_t smem_bytes, cudaStream_t, Body&& body);

template <class Body>
void launch(dim3 grid, unsigned nthreads, size_t smem_bytes, cudaStream_t, Body&& body);

}  // namespace shim

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

template <class Body>
void shim::launch(dim3 grid, unsigned nthreads, size_t smem_bytes, cudaStream_t, Body&& body) {
  if (nthreads == 0 || nthreads > 1024 || smem_bytes > kMaxSmem) {
    last_error = cudaErrorInvalidConfiguration;
    return;
  }
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      Block blk(nthreads, smem_bytes);
      std::vector<std::thread> threads;
      threads.reserve(nthreads);
      for (unsigned t = 0; t < nthreads; ++t) {
        threads.emplace_back([&, t, bx, by] {
          threadIdx = dim3{t, 1, 1};
          blockIdx = dim3{bx, by, 1};
          blockDim = dim3{nthreads, 1, 1};
          gridDim = grid;
          block = &blk;
          body();
        });
      }
      for (auto& th : threads) th.join();
    }
  }
}

template <class Body>
void shim::launch(unsigned grid, unsigned nthreads, size_t smem_bytes, cudaStream_t st, Body&& body) {
  launch(dim3{grid, 1, 1}, nthreads, smem_bytes, st, body);
}

inline void __syncthreads() { shim::block->all.arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) { shim::block->warps[threadIdx.x / 32]->arrive_and_wait(); }

inline void group_sync(int id, int nthreads) { shim::block->named(id, nthreads).arrive_and_wait(); }

namespace shim {
// One warp exchange: every lane publishes v, and after the warp's barrier
// reads lane src's.  The exchange array alternates between two halves from
// one shuffle to the next, so a second barrier is not needed: a lane writes
// a half again only after the barrier of the shuffle in between, which
// every lane passes after its read of that half.
inline thread_local unsigned parity = 0;
inline float exchange(float v, unsigned src) {
  float* x = block->exchange.data() + (parity ^= 1u) * block->exchange.size() / 2;
  x[threadIdx.x] = v;
  __syncwarp();
  return x[(threadIdx.x & ~31u) | (src & 31u)];
}
}  // namespace shim

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  return shim::exchange(v, (threadIdx.x & 31u) ^ (unsigned)lane_mask);
}

inline float __shfl_up_sync(unsigned, float v, unsigned delta) {
  const unsigned lane = threadIdx.x & 31u;
  const float r = shim::exchange(v, lane >= delta ? lane - delta : lane);
  return r;
}

inline float __shfl_sync(unsigned, float v, int src_lane) { return shim::exchange(v, (unsigned)src_lane); }

// Whether p holds on any lane of the warp: every lane publishes p into the
// exchange half of this round and, after the warp's barrier, reads all 32.
inline bool __any_sync(unsigned, bool p) {
  float* x = shim::block->exchange.data() + (shim::parity ^= 1u) * shim::block->exchange.size() / 2;
  x[threadIdx.x] = p ? 1.f : 0.f;
  __syncwarp();
  bool any = false;
  for (unsigned l = 0; l < 32; ++l) any = any || x[(threadIdx.x & ~31u) | l] != 0.f;
  return any;
}

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}

inline float __fdividef(float a, float b) { return a / b; }

namespace shim {
inline thread_local unsigned mma_parity = 0;
}  // namespace shim

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a b.  Lane l =
// 4 groupID + tig holds A[groupID + 8 (i & 1)][tig + 4 (i >> 1)] in a[i],
// B[tig + 4 i][groupID] in b[i] and C[groupID + 8 (i >> 1)][2 tig + (i & 1)]
// in d[i].  The operands are read as TF32 (the 13 low bits dropped); each
// exact product is added in k order in float32.  The fragment array
// alternates halves from one call to the next, as the shuffles' exchange.
inline void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  shim::Block& blk = *shim::block;
  uint32_t* x = blk.fragments.data() + (shim::mma_parity ^= 1u) * blk.fragments.size() / 2;
  uint32_t* mine = x + 6 * threadIdx.x;
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b[0];
  mine[5] = b[1];
  __syncwarp();
  const unsigned w0 = threadIdx.x & ~31u, lane = threadIdx.x & 31u, grp = lane >> 2, tig = lane & 3u;
  auto tf32 = [](uint32_t u) { return __uint_as_float(u & 0xffffe000u); };
  auto A = [&](unsigned row, unsigned k) {
    return tf32(x[6 * (w0 + 4 * (row & 7u) + (k & 3u)) + (row >> 3) + 2 * (k >> 2)]);
  };
  auto B = [&](unsigned k, unsigned n) { return tf32(x[6 * (w0 + 4 * n + (k & 3u)) + 4 + (k >> 2)]); };
  for (unsigned i = 0; i < 4; ++i) {
    const unsigned row = grp + 8 * (i >> 1), col = 2 * tig + (i & 1u);
    float s = d[i];
    for (unsigned k = 0; k < 8; ++k) s += A(row, k) * B(k, col);
    d[i] = s;
  }
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }

inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i, x >>= 1) r = (r << 1) | (x & 1u);
  return r;
}

inline void copy_async16(float* dst, const float* src) { std::memcpy(dst, src, 16); }
inline void copy_async4(float* dst, const float* src) { *dst = *src; }
inline void copy_async_commit() {}
inline void copy_async_wait_all() {}

template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int bytes) {
  return (size_t)bytes <= shim::kMaxSmem ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t cudaGetLastError() {
  const cudaError_t e = shim::last_error;
  shim::last_error = cudaSuccess;
  return e;
}

inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : e == cudaErrorInvalidValue ? "invalid argument" : "invalid configuration";
}
