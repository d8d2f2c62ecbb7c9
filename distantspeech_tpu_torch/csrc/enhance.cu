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
// [B, S] out, one 256-thread block per utterance, the spectra never in
// device memory.  The block is split by warps.  The lane warps
// (ceil(F / 32) of them, 5 at F = 129) run the lane recursion of frame t,
// one thread per bin with its state in registers (two bins a thread at
// n_fft = 512, 5 warps for F = 257, with M <= 4: twice the 8-mic state
// would not fit a thread's 255 registers).  Meanwhile the FFT warps
// (the other 3) window and transform frame t + 1 into the other slot of a
// two-slot spectrum ring, and invert, window and overlap-add frame t - 1's
// gained spectrum.  One block barrier a frame hands the slots over: the
// analysis does not depend on the lane state, so the transforms hide behind
// the lane chain instead of adding to it.  The analysis packs the M mics in
// pairs, x_{2j} + i x_{2j+1} (the mics of one scene are of like magnitude),
// as M / 2 complex N-point FFTs (flms_fft.cuh's warp-owned radix-8 passes;
// split_pair recovers each mic's bins, 0 and N/2 exactly real); |z_0|^2 for
// MCRA's 3-tap smoothing goes into the ring beside the spectra.  The
// synthesis is one inverse (put_pair with an empty second half) a frame.
// Each transform is owned by one FFT warp, the FFT warps meet on a named
// barrier of their own, and the next hop-block of every mic is prefetched
// with cp.async into a three-slot ring.
//
// What bounds them on an H100 (B = 64, M = 8, 4 s): the mega kernel by
// operations (it moves 147 MB and does ~5.5e9 float32 operations with its
// transforms as real FFTs), the lane kernel by bytes (314 MB of spectra in
// and out against ~4e9 operations).  Neither design reaches its bound: the
// lane recursion is a serial chain of ~2.5 us a frame per lane (one block
// per utterance leaves 64 of 132 SMs busy at B = 64), and the M = 8 lane
// state takes up to 255 registers a thread.  The mega kernel's design before
// this one computed each bin's DFT as a direct sum against cos/sin tables
// and took 9.516 ms on an H100 at 700 W (PERF.md's kernel table keeps both
// times).
#include <cuda_runtime.h>

#include "flms_fft.cuh"

namespace {

constexpr int kLaneThreads = 128;
constexpr int kFullThreads = 256;  // the mega kernel: lane warps for F bins, the rest FFT warps

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
// steer [M, 2, F] -> y [B, T*hop] for N = 2^logN, a compile-time constant
// so that the transforms' and splits' index arithmetic folds.  Each lane
// thread runs KB bins, k and k + 32 LW (KB = 2 at N = 512).
template <int M, int logN>
__global__ void __launch_bounds__(kFullThreads, 1) fused_enhance_full_kernel(
    const float* __restrict__ x, const float* __restrict__ tabs, const float* __restrict__ steer,
    float* __restrict__ y, int T, float syn_gain, LaneParams lp) {
  extern __shared__ float4 smem4[];
  constexpr int N = 1 << logN, hop = N / 2, F = hop + 1;
  constexpr int KB = logN > 8 ? 2 : 1;
  constexpr int LW = (F + 32 * KB - 1) / (32 * KB);  // lane warps; the others are FFT warps
  float2* Za = reinterpret_cast<float2*>(smem4);  // [2][M/2][N] frames t and t+1, mics 2j + i 2j+1
  float2* Zy = Za + M * N;                        // [N] frame t-1's inverse
  float2* tw = Zy + N;                            // [N/2]
  float2* Ys = tw + N / 2;                        // [2][F] gained outputs
  float* ring = reinterpret_cast<float*>(Ys + 2 * F);  // [3][M][hop] hop-blocks of every mic
  float* win = ring + 3 * M * hop;                // [N]
  float* tail = win + N;                          // [hop] the previous frame's second half

  const int tid = threadIdx.x;
  const float* xb = x + (size_t)blockIdx.x * M * T * hop;
  float* yb = y + (size_t)blockIdx.x * T * hop;
  // hop-block u of every mic into ring slot u mod 3, by nthr threads from rank r
  auto prefetch = [&](int u, int r, int nthr) {
    for (int m = 0; m < M; ++m)
      prefetch_floats(ring + ((u % 3) * M + m) * hop, xb + ((size_t)m * T + u) * hop, hop, r, nthr);
    copy_async_commit();
  };
  prefetch(0, tid, kFullThreads);
  for (int i = tid; i < N / 2; i += kFullThreads) tw[i] = make_float2(tabs[N + i], -tabs[2 * N + i]);
  for (int i = tid; i < N; i += kFullThreads) win[i] = tabs[i];
  for (int i = tid; i < hop; i += kFullThreads) tail[i] = 0.f;

  const bool lane_warp = tid < 32 * LW;
  float ar[KB][M], ai[KB][M];
  Lane<M> s[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    if (tid + 32 * LW * j < F) load_steering<M>(steer, F, tid + 32 * LW * j, ar[j], ai[j]);
    lane_init<M>(s[j]);
  }
  const int r = tid - 32 * LW, nthr = kFullThreads - 32 * LW, fw = r >> 5, lane = tid & 31;  // FFT warps' ranks
  const float invN = 1.f / (float)N;
  copy_async_wait_all();
  __syncthreads();

  // iteration i: the lanes run frame i, the FFT warps analyse frame i + 1
  // and synthesise frame i - 1
  for (int i = -1; i <= T; ++i) {
    if (lane_warp) {
      const float2* Zf = Za + (i & 1) * (M / 2) * N;  // frame i's spectra, mics in pairs
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int k = tid + 32 * LW * j;
        if (i < 0 || i >= T || k >= F) continue;
        float zr[M], zi[M];
#pragma unroll
        for (int q = 0; q < M / 2; ++q) {
          float2 u, v;
          split_pair(Zf + q * N, k, N, logN, u, v);
          zr[2 * q] = u.x;
          zi[2 * q] = u.y;
          zr[2 * q + 1] = v.x;
          zi[2 * q + 1] = v.y;
        }
        // MCRA's 3-tap smoothing of |z_0|^2, its neighbours split here too
        float2 zl, zh, unused;
        split_pair(Zf, k > 0 ? k - 1 : 0, N, logN, zl, unused);
        split_pair(Zf, k < F - 1 ? k + 1 : F - 1, N, logN, zh, unused);
        const float Sf = lp.b0 * (zl.x * zl.x + zl.y * zl.y) + lp.b1 * (zr[0] * zr[0] + zi[0] * zi[0]) +
                         lp.b2 * (zh.x * zh.x + zh.y * zh.y);
        Ys[(i & 1) * F + k] = lane_frame<M>(s[j], zr, zi, ar[j], ai[j], Sf, i, bin_kind(k, F), lp);
      }
    } else {
      const int a = i + 1, sy = i - 1;  // the frames analysed and synthesised
      copy_async_wait_all();            // hop-block a
      group_sync(1, nthr);
      // M / 2 forward transforms and one inverse, one warp each; each reads
      // its input as its first pass loads it
      const int nfw = nthr >> 5;
      const int nq = (a < T ? M / 2 : 0) + (sy >= 0 ? 1 : 0);
      for (int q = fw; q < nq; q += nfw) {
        if (a < T && q < M / 2) {
          // frame a of mics 2q, 2q+1: hop-blocks a - 1 (zeros before the
          // first) and a, windowed
          const float* b0 = ring + (((a + 2) % 3) * M + 2 * q) * hop;
          const float* b1 = ring + ((a % 3) * M + 2 * q) * hop;
          fft_seq_from<false>(Za + ((a & 1) * (M / 2) + q) * N, logN, tw, lane, 32, 0,
                              [&](const float2*, int p, int lg) {
                                const int n = bitrev(p, lg);
                                if (n >= hop) return make_float2(b1[n - hop] * win[n], b1[n] * win[n]);
                                if (a == 0) return make_float2(0.f, 0.f);
                                return make_float2(b0[n] * win[n], b0[hop + n] * win[n]);
                              });
        } else {
          // frame sy's gained spectrum, hermitian-extended as put_half does
          const float2* Y = Ys + (sy & 1) * F;
          fft_seq_from<true>(Zy, logN, tw, lane, 32, 0, [&](const float2*, int p, int lg) {
            const int k = bitrev(p, lg);
            if (k == 0 || k == hop) return make_float2(Y[k].x, 0.f);
            if (k < hop) return Y[k];
            return make_float2(Y[N - k].x, -Y[N - k].y);
          });
          __syncwarp();
          for (int n = lane; n < hop; n += 32) {  // window and overlap-add, by the same warp
            yb[(size_t)sy * hop + n] = (Zy[swz(n, logN)].x * (win[n] * invN) + tail[n]) * syn_gain;
            tail[n] = Zy[swz(n + hop, logN)].x * (win[n + hop] * invN);
          }
        }
      }
      if (a + 1 < T) prefetch(a + 1, r, nthr);
    }
    __syncthreads();
  }
}

// Dynamic shared memory of the mega kernel in floats.
size_t full_smem_floats(int M, int N) {
  const int hop = N / 2, F = hop + 1;
  return (size_t)M * N * 2 + 2 * N + N + 4 * F + 3 * M * hop + N + hop;
}

template <int M, int logN>
cudaError_t launch_full(const float* x, const float* tabs, const float* steer, float* y, int B, int T, float syn_gain,
                        const LaneParams& lp, cudaStream_t stream) {
  const size_t smem = sizeof(float) * full_smem_floats(M, 1 << logN);
  const cudaError_t e = allow_smem(fused_enhance_full_kernel<M, logN>, smem);
  if (e != cudaSuccess) return e;
  fused_enhance_full_kernel<M, logN><<<B, kFullThreads, smem, stream>>>(x, tabs, steer, y, T, syn_gain, lp);
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

// N (n_fft) 256 or 512, the sizes the JAX kernel takes (a multiple of 256)
// up to what one block holds: the F = N/2 + 1 lanes take 5 of the block's 8
// warps, one bin a thread at N = 256, two at N = 512, where the M = 8 lane
// state would not fit twice in a thread's 255 registers, so M is 2 or 4
// there.
cudaError_t fused_enhance_full_launch(const void* x, const void* tabs, const void* steer, void* y, int M, int B, int N,
                              int T, float syn_gain, const void* params, void* stream) {
  const LaneParams lp = *static_cast<const LaneParams*>(params);
  if ((N != 256 && N != 512) || B < 1 || T < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(tabs);
  const float* sv = static_cast<const float*>(steer);
  float* yf = static_cast<float*>(y);
  if (N == 512) switch (M) {
      case 2: return launch_full<2, 9>(xf, tf, sv, yf, B, T, syn_gain, lp, st);
      case 4: return launch_full<4, 9>(xf, tf, sv, yf, B, T, syn_gain, lp, st);
      default: return cudaErrorInvalidValue;
    }
  switch (M) {
    case 2: return launch_full<2, 8>(xf, tf, sv, yf, B, T, syn_gain, lp, st);
    case 4: return launch_full<4, 8>(xf, tf, sv, yf, B, T, syn_gain, lp, st);
    case 8: return launch_full<8, 8>(xf, tf, sv, yf, B, T, syn_gain, lp, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* enhance_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
