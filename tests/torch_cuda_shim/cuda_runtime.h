// A CPU stand-in for the part of the CUDA runtime and device language that
// the port's FLMS-family kernels (distantspeech_tpu_torch/csrc) use, so that
// g++ (C++20) can compile a kernel source and run a launch on the CPU: one
// std::thread per CUDA thread, the blocks of a grid one after another.
//
// - __syncthreads is a std::barrier of the block, __syncwarp one of the warp,
//   group_sync(id, n) (bar.sync id, n) one per (id, n) of the block;
// - __shfl_xor_sync exchanges through a per-warp array between two warp
//   barriers;
// - the cp.async helpers of flms_fft.cuh are plain copies, their commit and
//   wait no-ops;
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
    exchange.resize(nthreads);
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
  std::mutex mu;
  std::map<std::pair<int, int>, std::unique_ptr<std::barrier<>>> groups;
  float* smem = nullptr;
};

inline thread_local Block* block = nullptr;
inline thread_local cudaError_t last_error = cudaSuccess;

inline void* dynamic_smem() { return block->smem; }

template <class Body>
void launch(unsigned grid, unsigned nthreads, size_t smem_bytes, cudaStream_t, Body&& body);

}  // namespace shim

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

template <class Body>
void shim::launch(unsigned grid, unsigned nthreads, size_t smem_bytes, cudaStream_t, Body&& body) {
  if (nthreads == 0 || nthreads > 1024 || smem_bytes > kMaxSmem) {
    last_error = cudaErrorInvalidConfiguration;
    return;
  }
  for (unsigned b = 0; b < grid; ++b) {
    Block blk(nthreads, smem_bytes);
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (unsigned t = 0; t < nthreads; ++t) {
      threads.emplace_back([&, t, b] {
        threadIdx = dim3{t, 1, 1};
        blockIdx = dim3{b, 1, 1};
        blockDim = dim3{nthreads, 1, 1};
        gridDim = dim3{grid, 1, 1};
        block = &blk;
        body();
      });
    }
    for (auto& th : threads) th.join();
  }
}

inline void __syncthreads() { shim::block->all.arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) { shim::block->warps[threadIdx.x / 32]->arrive_and_wait(); }

inline void group_sync(int id, int nthreads) { shim::block->named(id, nthreads).arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  shim::block->exchange[threadIdx.x] = v;
  __syncwarp();
  const float r = shim::block->exchange[(threadIdx.x & ~31u) | ((threadIdx.x & 31u) ^ (unsigned)lane_mask)];
  __syncwarp();
  return r;
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

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
