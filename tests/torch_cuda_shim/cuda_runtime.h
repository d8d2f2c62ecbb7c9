// A CPU stand-in for the part of the CUDA runtime and device language that
// the port's FLMS-family kernels (distantspeech_tpu_torch/csrc) use, so that
// g++ (C++20) can compile a kernel source and run a launch on the CPU: each
// CUDA thread is a fiber with a stack of its own, and the fibers of a block
// take turns on the launching thread, the blocks of a grid one after another.
// A fiber runs until it waits at a barrier (or returns); a round-robin
// scheduler then resumes the next fiber whose barrier has opened.  Nothing
// spins and nothing asks the operating system to switch, so a rehearsal costs
// one core however busy the machine is.
//
// - __syncthreads is a barrier of the block, __syncwarp one of the warp,
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
//   Hopper block may use (232,448 bytes) fails as the card's would;
// - a block whose fibers all wait at barriers that cannot open (mismatched
//   barriers) aborts the process with a message instead of hanging.
//
// rehearse.py rewrites the two constructs g++ cannot parse: the `<<<...>>>`
// launch and `extern __shared__`.
#pragma once

#include <sys/mman.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <type_traits>
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
constexpr size_t kStackBytes = size_t(1) << 20;  // each fiber's stack, committed as it is touched

// A barrier of `expected` fibers.  The last to arrive opens it (the
// generation moves on) and runs on; the others wait for the scheduler.
struct Gate {
  explicit Gate(unsigned n) : expected(n) {}
  void arrive_and_wait();
  unsigned expected, arrived = 0;
  uint64_t gen = 0;
};

struct Fiber {
  void* sp = nullptr;  // the saved stack pointer while it is not running
  char* stack = nullptr;
  unsigned tid = 0;
  const Gate* gate = nullptr;  // the barrier it waits at, and that barrier's generation then
  uint64_t gen = 0;
  bool done = false;
};

struct Block {
  explicit Block(unsigned nthreads, size_t smem_bytes) : all(nthreads), parity(nthreads, 0u), mma_parity(nthreads, 0u) {
    for (unsigned w = 0; w < (nthreads + 31) / 32; ++w) warps.emplace_back(std::make_unique<Gate>(32));
    exchange.resize(2 * nthreads);
    fragments.resize(2 * 6 * nthreads);
    const size_t n = smem_bytes / sizeof(float) + 4;
    smem = static_cast<float*>(std::aligned_alloc(16, ((n * sizeof(float) + 15) / 16) * 16));
    for (size_t i = 0; i < n; ++i) smem[i] = std::numeric_limits<float>::quiet_NaN();
  }
  ~Block() { std::free(smem); }
  Gate& named(int id, int n) {
    auto& b = groups[{id, n}];
    if (!b) b = std::make_unique<Gate>(n);
    return *b;
  }
  Gate all;
  std::vector<std::unique_ptr<Gate>> warps;
  std::vector<float> exchange;
  std::vector<unsigned> parity, mma_parity;  // each thread's half of exchange / fragments
  std::vector<uint32_t> fragments;  // mma_m16n8k8_tf32's A and B registers, 6 a thread, two halves
  std::map<std::pair<int, int>, std::unique_ptr<Gate>> groups;
  float* smem = nullptr;
};

inline thread_local Block* block = nullptr;
inline thread_local cudaError_t last_error = cudaSuccess;
inline thread_local Fiber* current = nullptr;
inline thread_local void* scheduler_sp = nullptr;
inline thread_local void (*body_fn)(void*) = nullptr;
inline thread_local void* body_arg = nullptr;

inline void* dynamic_smem() { return block->smem; }

// Saves the callee-saved registers and the floating-point control words on
// the stack, stores the stack pointer in *save and resumes the context whose
// stack pointer is `to`.
extern "C" __attribute__((visibility("hidden"))) void shim_ctx_swap(void** save, void* to);
asm(R"(
  .text
  .p2align 4
  .hidden shim_ctx_swap
  .type shim_ctx_swap, @function
shim_ctx_swap:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  subq $16, %rsp
  stmxcsr (%rsp)
  fnstcw 4(%rsp)
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  ldmxcsr (%rsp)
  fldcw 4(%rsp)
  addq $16, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size shim_ctx_swap, .-shim_ctx_swap
)");

[[noreturn]] inline void fiber_main() {
  body_fn(body_arg);
  current->done = true;
  shim_ctx_swap(&current->sp, scheduler_sp);
  std::abort();  // a finished fiber is never resumed
}

// A fresh stack whose first swap "returns" into fiber_main with the stack
// aligned as after a call; the control words are the launching thread's.
inline void* fiber_start(char* stack) {
  uintptr_t top = (reinterpret_cast<uintptr_t>(stack) + kStackBytes) & ~uintptr_t(15);
  auto* sp = reinterpret_cast<uint64_t*>(top - 80);
  std::memset(sp, 0, 80);
  uint32_t csr;
  uint16_t cw;
  asm volatile("stmxcsr %0" : "=m"(csr));
  asm volatile("fnstcw %0" : "=m"(cw));
  std::memcpy(sp, &csr, 4);
  std::memcpy(reinterpret_cast<char*>(sp) + 4, &cw, 2);
  sp[8] = reinterpret_cast<uint64_t>(&fiber_main);
  return sp;
}

inline void Gate::arrive_and_wait() {
  if (++arrived == expected) {
    arrived = 0;
    ++gen;
    return;
  }
  current->gate = this;
  current->gen = gen;
  shim_ctx_swap(&current->sp, scheduler_sp);
}

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
  body_fn = [](void* b) { (*static_cast<std::remove_reference_t<Body>*>(b))(); };
  body_arg = &body;
  blockDim = dim3{nthreads, 1, 1};
  gridDim = grid;
  std::vector<Fiber> fibers(nthreads);
  for (unsigned t = 0; t < nthreads; ++t) {
    void* m = mmap(nullptr, kStackBytes, PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (m == MAP_FAILED) std::abort();
    fibers[t].stack = static_cast<char*>(m);
    fibers[t].tid = t;
  }
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      Block blk(nthreads, smem_bytes);
      block = &blk;
      blockIdx = dim3{bx, by, 1};
      for (auto& f : fibers) {
        f.sp = fiber_start(f.stack);
        f.gate = nullptr;
        f.done = false;
      }
      for (unsigned live = nthreads; live > 0;) {
        bool resumed = false;
        for (auto& f : fibers) {
          if (f.done || (f.gate != nullptr && f.gate->gen == f.gen)) continue;
          f.gate = nullptr;
          threadIdx = dim3{f.tid, 1, 1};
          current = &f;
          shim_ctx_swap(&scheduler_sp, f.sp);
          resumed = true;
          live -= f.done;
        }
        if (!resumed) {
          std::fprintf(stderr, "shim: block (%u, %u): %u of %u threads wait at barriers that cannot open\n", bx, by,
                       live, nthreads);
          std::abort();
        }
      }
    }
  }
  for (auto& f : fibers) munmap(f.stack, kStackBytes);
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
inline float exchange(float v, unsigned src) {
  float* x = block->exchange.data() + (block->parity[threadIdx.x] ^= 1u) * block->exchange.size() / 2;
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
  float* x = shim::block->exchange.data() + (shim::block->parity[threadIdx.x] ^= 1u) * shim::block->exchange.size() / 2;
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

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a b.  Lane l =
// 4 groupID + tig holds A[groupID + 8 (i & 1)][tig + 4 (i >> 1)] in a[i],
// B[tig + 4 i][groupID] in b[i] and C[groupID + 8 (i >> 1)][2 tig + (i & 1)]
// in d[i].  The operands are read as TF32 (the 13 low bits dropped); each
// exact product is added in k order in float32.  The fragment array
// alternates halves from one call to the next, as the shuffles' exchange.
inline void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  shim::Block& blk = *shim::block;
  uint32_t* x = blk.fragments.data() + (blk.mma_parity[threadIdx.x] ^= 1u) * blk.fragments.size() / 2;
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
