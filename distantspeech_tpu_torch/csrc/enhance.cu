// The flagship's two CUDA kernels and their C launchers.
//
// fused_enhance_kernel replaces distantspeech_tpu/ops/pallas_enhance.py
// fused_enhance (_enhance_kernel + its Nyquist companion): spectra in,
// gained spectra out, one thread per (utterance, bin) lane looping over
// every frame with the lane's state in registers.  Inputs are laid out with
// the lane index b*F + k contiguous, so neighbouring threads read
// neighbouring addresses.
//
// fused_enhance_full_kernel replaces pallas_enhance.py fused_enhance_full
// (_mega_kernel + its Nyquist companion): waveform [B, M, S] in, waveform
// [B, S] out, one 256-thread block per utterance.  Per frame the block loads
// the new hop-block of every mic into a two-slot shared ring, windows the
// frame, and threads k < F each compute their bin's DFT as a direct sum
// against shared cos/sin tables indexed by (n k) mod N; |z_0|^2 is exchanged
// through shared memory for MCRA's 3-tap smoothing; the lane recursion runs
// in registers; all threads then compute the inverse DFT sample by sample
// and overlap-add with the previous frame's tail kept in shared memory.
// The spectra never reach device memory.
//
// What bounds them on an H100 (B = 64, M = 8, 4 s): the mega kernel by
// operations (it moves 147 MB but does ~4e10 float32 operations, most of
// them in the DFTs), the lane kernel by bytes (314 MB of spectra in and out
// against ~4e9 operations).  This first version spends no effort on either
// bound: the mega kernel keeps one block per utterance (64 of 132 SMs busy
// at B = 64) and the M = 8 lane state takes up to 255 registers a thread.
#include <cuda_runtime.h>

#include "enhance_lane.cuh"

namespace {

constexpr int kLaneThreads = 128;
constexpr int kFullThreads = 256;  // >= F: one thread per bin in the lane phase

template <int M>
__device__ __forceinline__ void load_steering(const float* __restrict__ steer, int F, int k, float (&ar)[M],
                                              float (&ai)[M]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    ar[m] = steer[(2 * m) * F + k];
    ai[m] = steer[(2 * m + 1) * F + k];
  }
}

// z [T, M, 2, B*F], sf [T, B*F], steer [M, 2, F] -> y [T, 2, B*F]
template <int M>
__global__ void __launch_bounds__(kLaneThreads) fused_enhance_kernel(const float* __restrict__ z,
                                                                     const float* __restrict__ sf,
                                                                     const float* __restrict__ steer,
                                                                     float* __restrict__ y, int B, int F, int T,
                                                                     LaneParams lp) {
  const int NL = B * F;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= NL) return;
  const int k = lane % F;
  const BinKind bk = bin_kind(k, F);
  float ar[M], ai[M];
  load_steering<M>(steer, F, k, ar, ai);
  Lane<M> s;
  lane_init<M>(s);
  for (int t = 0; t < T; ++t) {
    const float* zt = z + (size_t)t * M * 2 * NL;
    float zr[M], zi[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      zr[m] = zt[(size_t)(2 * m) * NL + lane];
      zi[m] = zt[(size_t)(2 * m + 1) * NL + lane];
    }
    const float2 out = lane_frame<M>(s, zr, zi, ar, ai, sf[(size_t)t * NL + lane], t, bk, lp);
    y[(size_t)(2 * t) * NL + lane] = out.x;
    y[(size_t)(2 * t + 1) * NL + lane] = out.y;
  }
}

// x [B, M, T*hop], tabs [3, N] (window | cos | sin of 2 pi j / N),
// steer [M, 2, F] -> y [B, T*hop]
template <int M>
__global__ void __launch_bounds__(kFullThreads, 1) fused_enhance_full_kernel(
    const float* __restrict__ x, const float* __restrict__ tabs, const float* __restrict__ steer,
    float* __restrict__ y, int N, int T, float syn_gain, LaneParams lp) {
  extern __shared__ float smem[];
  const int hop = N / 2, F = hop + 1;
  float* ring = smem;           // [M][2][hop]: hop-blocks t-1 and t of every mic
  float* fw = ring + M * N;     // [N][M]: the windowed frame
  float* win = fw + N * M;      // [N]
  float* cosT = win + N;        // [N]
  float* sinT = cosT + N;       // [N]
  float* pw = sinT + N;         // [F]: |z_0|^2 of every bin
  float* yrS = pw + F;          // [F]: gained output, hermitian weight folded in
  float* yiS = yrS + F;         // [F]
  float* fo = yiS + F;          // [N]: this frame's inverse DFT
  float* tail = fo + N;         // [hop]: the previous frame's second half

  const int tid = threadIdx.x;
  const float* xb = x + (size_t)blockIdx.x * M * T * hop;
  float* yb = y + (size_t)blockIdx.x * T * hop;
  for (int i = tid; i < 3 * N; i += kFullThreads) win[i] = tabs[i];  // win, cosT, sinT are contiguous
  for (int i = tid; i < M * N; i += kFullThreads) ring[i] = 0.f;
  for (int i = tid; i < hop; i += kFullThreads) tail[i] = 0.f;

  const int k = tid;
  const bool is_bin = k < F;
  const BinKind bk = bin_kind(k, F);
  float ar[M], ai[M];
  if (is_bin) load_steering<M>(steer, F, k, ar, ai);
  Lane<M> s;
  lane_init<M>(s);
  const float invN = 1.f / (float)N;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    for (int i = tid; i < M * hop; i += kFullThreads) {
      const int m = i / hop, n = i - m * hop;
      ring[(2 * m + cur) * hop + n] = xb[((size_t)m * T + t) * hop + n];
    }
    __syncthreads();
    for (int n = tid; n < N; n += kFullThreads) {
      const int slot = n < hop ? cur ^ 1 : cur;
      const int nn = n < hop ? n : n - hop;
#pragma unroll
      for (int m = 0; m < M; ++m) fw[n * M + m] = ring[(2 * m + slot) * hop + nn] * win[n];
    }
    __syncthreads();

    float zr[M], zi[M];
    if (is_bin) {
#pragma unroll
      for (int m = 0; m < M; ++m) zr[m] = zi[m] = 0.f;
      int idx = 0;  // (n k) mod N
      for (int n = 0; n < N; ++n) {
        const float c = cosT[idx], sn = sinT[idx];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float v = fw[n * M + m];
          zr[m] = fmaf(v, c, zr[m]);
          zi[m] = fmaf(-v, sn, zi[m]);
        }
        idx += k;
        if (idx >= N) idx -= N;
      }
      pw[k] = zr[0] * zr[0] + zi[0] * zi[0];
    }
    __syncthreads();

    if (is_bin) {
      const float Sf = lp.b0 * pw[k > 0 ? k - 1 : 0] + lp.b1 * pw[k] + lp.b2 * pw[k < F - 1 ? k + 1 : F - 1];
      const float2 out = lane_frame<M>(s, zr, zi, ar, ai, Sf, t, bk, lp);
      const float sc = (bk.first || bk.last) ? 1.f : 2.f;
      yrS[k] = sc * out.x;
      yiS[k] = sc * out.y;
    }
    __syncthreads();

    for (int n = tid; n < N; n += kFullThreads) {
      float acc = 0.f;
      int idx = 0;  // (k n) mod N
      for (int kk = 0; kk < F; ++kk) {
        acc = fmaf(yrS[kk], cosT[idx], acc);
        acc = fmaf(-yiS[kk], sinT[idx], acc);
        idx += n;
        if (idx >= N) idx -= N;
      }
      fo[n] = acc * (win[n] * invN);
    }
    __syncthreads();
    for (int n = tid; n < hop; n += kFullThreads) {
      yb[(size_t)t * hop + n] = (fo[n] + tail[n]) * syn_gain;
      tail[n] = fo[n + hop];
    }
    // the next frame's first barrier orders these reads of fo before its rewrite
  }
}

template <int M>
cudaError_t launch_full(const float* x, const float* tabs, const float* steer, float* y, int B, int N, int T,
                        float syn_gain, const LaneParams& lp, cudaStream_t stream) {
  const int F = N / 2 + 1;
  const size_t smem = sizeof(float) * (size_t)(2 * M * N + 4 * N + 3 * F + N / 2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fused_enhance_full_kernel<M>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fused_enhance_full_kernel<M><<<B, kFullThreads, smem, stream>>>(x, tabs, steer, y, N, T, syn_gain, lp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t fused_enhance_launch(const void* z, const void* sf, const void* steer, void* y, int M, int B, int F, int T,
                         const void* params, void* stream) {
  const LaneParams lp = *static_cast<const LaneParams*>(params);
  const int blocks = (B * F + kLaneThreads - 1) / kLaneThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  const float* sff = static_cast<const float*>(sf);
  const float* sv = static_cast<const float*>(steer);
  float* yf = static_cast<float*>(y);
  switch (M) {
    case 2: fused_enhance_kernel<2><<<blocks, kLaneThreads, 0, st>>>(zf, sff, sv, yf, B, F, T, lp); break;
    case 4: fused_enhance_kernel<4><<<blocks, kLaneThreads, 0, st>>>(zf, sff, sv, yf, B, F, T, lp); break;
    case 8: fused_enhance_kernel<8><<<blocks, kLaneThreads, 0, st>>>(zf, sff, sv, yf, B, F, T, lp); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t fused_enhance_full_launch(const void* x, const void* tabs, const void* steer, void* y, int M, int B, int N,
                              int T, float syn_gain, const void* params, void* stream) {
  const LaneParams lp = *static_cast<const LaneParams*>(params);
  if (N % 2 != 0 || N / 2 + 1 > kFullThreads) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(tabs);
  const float* sv = static_cast<const float*>(steer);
  float* yf = static_cast<float*>(y);
  switch (M) {
    case 2: return launch_full<2>(xf, tf, sv, yf, B, N, T, syn_gain, lp, st);
    case 4: return launch_full<4>(xf, tf, sv, yf, B, N, T, syn_gain, lp, st);
    case 8: return launch_full<8>(xf, tf, sv, yf, B, N, T, syn_gain, lp, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* enhance_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
