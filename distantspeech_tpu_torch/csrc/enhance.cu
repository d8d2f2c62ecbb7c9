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
// device memory.  The block is split by warps.  The 5 lane warps run the
// lane recursion of frame t, one thread per bin (two at n_fft = 512, four at
// 1024).  Meanwhile the FFT warps (the other 3) window and transform frame
// t + 1 into the other slot of a two-slot spectrum ring, and invert, window
// and overlap-add frame t - 1's gained spectrum.  One block barrier a frame
// hands the slots over: the analysis does not depend on the lane state, so
// the transforms hide behind the lane chain instead of adding to it.  The
// analysis packs the M mics in pairs, x_{2j} + i x_{2j+1} (the mics of one
// scene are of like magnitude; an odd M's last pair holds one mic and a
// zero), as ceil(M / 2) complex N-point FFTs (flms_fft.cuh's warp-owned
// radix-8 passes; split_pair recovers each mic's bins, 0 and N/2 exactly
// real); |z_0|^2 for MCRA's 3-tap smoothing goes into the ring beside the
// spectra.  The synthesis is one inverse (put_pair with an empty second
// half) a frame.  Each transform is owned by one FFT warp, the FFT warps
// meet on a named barrier of their own, and the next hop-block of every
// mic is prefetched with cp.async into a three-slot ring.
//
// Where the lane state lives.  At n_fft 256 (every M) and at 512 with M <= 4
// each lane thread holds its bins' states in registers for the whole
// utterance.  Twice the state of 5 to 8 mics does not fit a thread's 255
// registers, nor do four bins at 1024: there (kMem) each thread runs its
// bins one after another, loading a bin's state into registers, running
// the frame and storing it back, field-major, in shared memory where it fits
// beside the rest of the block's buffers, else in a global scratch of
// lane_fields(M) x F floats an utterance (1024 with 8 mics: 180 KB an
// utterance, which stays in L2).  fused_enhance_full_scratch_floats tells
// the wrapper how much scratch a shape needs.
//
// What bounds them on an H100 (B = 64, M = 8, 4 s): the mega kernel by
// operations (it moves 147 MB and does ~5.5e9 float32 operations with its
// transforms as real FFTs), the lane kernel by bytes (314 MB of spectra in
// and out against ~4e9 operations).  Neither design reaches its bound: the
// lane recursion is a serial chain of ~2.5 us a frame per lane (one block
// per utterance leaves 64 of 132 SMs busy at B = 64), and the M = 8 lane
// state takes up to 255 registers a thread.  The mega kernel's first design
// computed each bin's DFT as a direct sum against cos/sin tables and took
// 9.516 ms on an H100 at 700 W (PERF.md's kernel table keeps both
// times).
#include <cuda_runtime.h>

#include "flms_fft.cuh"

namespace {

constexpr int kLaneThreads = 128;
constexpr int kFullThreads = 256;   // the mega kernel: kFullLaneWarps lane warps, the rest FFT warps
constexpr int kFullLaneWarps = 5;

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

// The mega kernel's lane state in memory, field-major (float f of bin k at
// st[f * F + k], so that a warp's 32 bins read 32 neighbouring words): the
// lower triangle of the covariance or its factors, u, and the eight scalars.
__host__ __device__ constexpr int lane_fields(int M) { return M * M + 2 * M + 8; }

template <int M, bool kStore>
__device__ __forceinline__ void lane_io(float* st, int F, int k, Lane<M>& s) {
  float* p = st + k;
  auto io = [&](float& v) {
    if (kStore)
      *p = v;
    else
      v = *p;
    p += F;
  };
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) io(s.Rr[i][j]);
#pragma unroll
    for (int j = 0; j < i; ++j) io(s.Ri[i][j]);
    io(s.Ur[i]);
    io(s.Ui[i]);
  }
  io(s.S);
  io(s.Smin);
  io(s.Stmp);
  io(s.P);
  io(s.Lam);
  io(s.Gh);
  io(s.Gam);
  io(s.Ld);
}

// One lane-frame of the mega kernel: bin k of frame i from the spectrum
// ring slot Zf (the mics in pairs; an odd M's last pair holds one mic),
// MCRA's 3-tap smoothing of |z_0|^2 with its neighbours split here too, and
// the lane recursion.  Returns the gained bin.
template <int M, int logN>
__device__ __forceinline__ float2 mega_bin(const float2* Zf, int k, int i, Lane<M>& s, const float (&ar)[M],
                                           const float (&ai)[M], const LaneParams& lp) {
  constexpr int N = 1 << logN, F = N / 2 + 1, NP = (M + 1) / 2;
  float zr[M], zi[M];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    float2 u, v;
    split_pair(Zf + q * N, k, N, logN, u, v);
    zr[2 * q] = u.x;
    zi[2 * q] = u.y;
    if (2 * q + 1 < M) {
      zr[2 * q + 1] = v.x;
      zi[2 * q + 1] = v.y;
    }
  }
  float2 zl, zh, unused;
  split_pair(Zf, k > 0 ? k - 1 : 0, N, logN, zl, unused);
  split_pair(Zf, k < F - 1 ? k + 1 : F - 1, N, logN, zh, unused);
  const float Sf = lp.b0 * (zl.x * zl.x + zl.y * zl.y) + lp.b1 * (zr[0] * zr[0] + zi[0] * zi[0]) +
                   lp.b2 * (zh.x * zh.x + zh.y * zh.y);
  return lane_frame<M>(s, zr, zi, ar, ai, Sf, i, bin_kind(k, F), lp);
}

// x [B, M, T*hop], tabs [3, N] (window | cos | sin of 2 pi j / N),
// steer [M, 2, F] -> y [B, T*hop] for N = 2^logN, a compile-time constant
// so that the transforms' and splits' index arithmetic folds.  Each lane
// thread runs KB bins, k, k + 32 LW, ...: with their states in registers
// (kMem false: KB = 1 at N = 256, 2 at N = 512 with M <= 4), or one after
// another through a state kept in memory (kMem: lst in shared memory where
// it fits beside the rest, else gstate, a global scratch of lane_fields(M)
// x F floats an utterance that stays in L2).
template <int M, int logN, bool kMem>
__global__ void __launch_bounds__(kFullThreads, 1) fused_enhance_full_kernel(
    const float* __restrict__ x, const float* __restrict__ tabs, const float* __restrict__ steer,
    float* __restrict__ y, float* __restrict__ gstate, int T, float syn_gain, LaneParams lp) {
  extern __shared__ float4 smem4[];
  constexpr int N = 1 << logN, hop = N / 2, F = hop + 1;
  constexpr int NP = (M + 1) / 2;  // mic pairs
  constexpr int LW = kFullLaneWarps;
  constexpr int KB = (F + 32 * LW - 1) / (32 * LW);
  constexpr int RB = kMem ? 1 : KB;  // lane states in registers
  static_assert(kMem || KB == 1 || (KB == 2 && M <= 4), "the lane states would not fit in registers");
  float2* Za = reinterpret_cast<float2*>(smem4);  // [2][NP][N] frames t and t+1, mics 2j + i 2j+1
  float2* Zy = Za + 2 * NP * N;                   // [N] frame t-1's inverse
  float2* tw = Zy + N;                            // [N/2]
  float2* Ys = tw + N / 2;                        // [2][F] gained outputs
  float* ring = reinterpret_cast<float*>(Ys + 2 * F);  // [3][M][hop] hop-blocks of every mic
  float* win = ring + 3 * M * hop;                // [N]
  float* tail = win + N;                          // [hop] the previous frame's second half
  float* lst = !kMem ? nullptr                    // [lane_fields(M)][F] (kMem) the lane states
                     : gstate != nullptr ? gstate + (size_t)blockIdx.x * lane_fields(M) * F : tail + hop;

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
  float ar[RB][M], ai[RB][M];
  Lane<M> s[RB];
  if (lane_warp) {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int k = tid + 32 * LW * j;
      if (k >= F) continue;
      if constexpr (kMem) {
        Lane<M> z;
        lane_init<M>(z);
        lane_io<M, true>(lst, F, k, z);
      } else {
        load_steering<M>(steer, F, k, ar[j], ai[j]);
        lane_init<M>(s[j]);
      }
    }
  }
  const int r = tid - 32 * LW, nthr = kFullThreads - 32 * LW, fw = r >> 5, lane = tid & 31;  // FFT warps' ranks
  const float invN = 1.f / (float)N;
  copy_async_wait_all();
  __syncthreads();

  // iteration i: the lanes run frame i, the FFT warps analyse frame i + 1
  // and synthesise frame i - 1
  for (int i = -1; i <= T; ++i) {
    if (lane_warp) {
      const float2* Zf = Za + (i & 1) * NP * N;  // frame i's spectra, mics in pairs
      if (i >= 0 && i < T) {
        if constexpr (kMem) {
#pragma unroll 1
          for (int j = 0; j < KB; ++j) {
            const int k = tid + 32 * LW * j;
            if (k >= F) break;
            Lane<M> st;
            float a_r[M], a_i[M];
            lane_io<M, false>(lst, F, k, st);
            load_steering<M>(steer, F, k, a_r, a_i);
            Ys[(i & 1) * F + k] = mega_bin<M, logN>(Zf, k, i, st, a_r, a_i, lp);
            lane_io<M, true>(lst, F, k, st);
          }
        } else {
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int k = tid + 32 * LW * j;
            if (k < F) Ys[(i & 1) * F + k] = mega_bin<M, logN>(Zf, k, i, s[j], ar[j], ai[j], lp);
          }
        }
      }
    } else {
      const int a = i + 1, sy = i - 1;  // the frames analysed and synthesised
      copy_async_wait_all();            // hop-block a
      group_sync(1, nthr);
      // NP forward transforms and one inverse, one warp each; each reads its
      // input as its first pass loads it
      const int nfw = nthr >> 5;
      const int nq = (a < T ? NP : 0) + (sy >= 0 ? 1 : 0);
      for (int q = fw; q < nq; q += nfw) {
        if (a < T && q < NP) {
          // frame a of mics 2q, 2q+1 (2q alone for an odd M's last pair):
          // hop-blocks a - 1 (zeros before the first) and a, windowed
          const float* b0 = ring + (((a + 2) % 3) * M + 2 * q) * hop;
          const float* b1 = ring + ((a % 3) * M + 2 * q) * hop;
          const bool solo = (M & 1) && q == NP - 1;
          fft_seq_from<false>(Za + ((a & 1) * NP + q) * N, logN, tw, lane, 32, 0,
                              [&](const float2*, int p, int lg) {
                                const int n = bitrev(p, lg);
                                if (n >= hop) return make_float2(b1[n - hop] * win[n], solo ? 0.f : b1[n] * win[n]);
                                if (a == 0) return make_float2(0.f, 0.f);
                                return make_float2(b0[n] * win[n], solo ? 0.f : b0[hop + n] * win[n]);
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

constexpr size_t kMaxSmemBytes = 232448;  // a Hopper block's dynamic shared memory with the opt-in

// Dynamic shared memory of the mega kernel in floats, its lane states aside.
size_t full_smem_floats(int M, int N) {
  const int hop = N / 2, F = hop + 1, NP = (M + 1) / 2;
  return (size_t)4 * NP * N + 2 * N + N + 4 * F + 3 * (size_t)M * hop + N + hop;
}

// Where the mega kernel keeps its lane states at M mics and n_fft N:
// 0 in registers, 1 in shared memory, 2 in a global scratch; -1 for a shape
// it does not take.
int full_state_place(int M, int N) {
  if (M < 2 || M > 8 || (N != 256 && N != 512 && N != 1024)) return -1;
  if (N == 256 || (N == 512 && M <= 4)) return 0;
  const size_t need = sizeof(float) * (full_smem_floats(M, N) + (size_t)lane_fields(M) * (N / 2 + 1));
  return need <= kMaxSmemBytes ? 1 : 2;
}

template <int M, int logN, bool kMem>
cudaError_t launch_full(const float* x, const float* tabs, const float* steer, float* y, float* gstate, int B, int T,
                        float syn_gain, const LaneParams& lp, cudaStream_t stream) {
  constexpr int N = 1 << logN;
  size_t floats = full_smem_floats(M, N);
  if (kMem && gstate == nullptr) floats += (size_t)lane_fields(M) * (N / 2 + 1);
  const size_t smem = sizeof(float) * floats;
  const cudaError_t e = allow_smem(fused_enhance_full_kernel<M, logN, kMem>, smem);
  if (e != cudaSuccess) return e;
  fused_enhance_full_kernel<M, logN, kMem><<<B, kFullThreads, smem, stream>>>(x, tabs, steer, y, gstate, T, syn_gain,
                                                                               lp);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_full_m(const float* x, const float* tabs, const float* steer, float* y, float* gstate, int B, int N,
                          int T, float syn_gain, const LaneParams& lp, cudaStream_t st) {
  switch (N) {
    case 256: return launch_full<M, 8, false>(x, tabs, steer, y, nullptr, B, T, syn_gain, lp, st);
    case 512:
      if constexpr (M <= 4) return launch_full<M, 9, false>(x, tabs, steer, y, nullptr, B, T, syn_gain, lp, st);
      else return launch_full<M, 9, true>(x, tabs, steer, y, gstate, B, T, syn_gain, lp, st);
    case 1024: return launch_full<M, 10, true>(x, tabs, steer, y, gstate, B, T, syn_gain, lp, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// M (mics) 2 to 8.
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
    case 3: fused_enhance_kernel<3><<<blocks, kLaneThreads, 0, st>>>(zf, sff, sv, yf, B, F, T, lp); break;
    case 4: fused_enhance_kernel<4><<<blocks, kLaneThreads, 0, st>>>(zf, sff, sv, yf, B, F, T, lp); break;
    case 5: fused_enhance_kernel<5><<<blocks, kLaneThreads, 0, st>>>(zf, sff, sv, yf, B, F, T, lp); break;
    case 6: fused_enhance_kernel<6><<<blocks, kLaneThreads, 0, st>>>(zf, sff, sv, yf, B, F, T, lp); break;
    case 7: fused_enhance_kernel<7><<<blocks, kLaneThreads, 0, st>>>(zf, sff, sv, yf, B, F, T, lp); break;
    case 8: fused_enhance_kernel<8><<<blocks, kLaneThreads, 0, st>>>(zf, sff, sv, yf, B, F, T, lp); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// M (mics) 2 to 8; N (n_fft) 256, 512 or 1024, the powers of two among the
// sizes the JAX kernel takes (multiples of 256) up to what a block holds.
// The lane states live in registers at N = 256 and at 512 with M <= 4, else
// in shared memory or, where that does not fit, in scratch:
// fused_enhance_full_scratch_floats(M, N) floats an utterance, 0 where the
// launch needs none (scratch may then be null).
int fused_enhance_full_scratch_floats(int M, int N) {
  const int place = full_state_place(M, N);
  return place < 0 ? -1 : place == 2 ? lane_fields(M) * (N / 2 + 1) : 0;
}

cudaError_t fused_enhance_full_launch(const void* x, const void* tabs, const void* steer, void* y, void* scratch,
                                      int M, int B, int N, int T, float syn_gain, const void* params, void* stream) {
  const LaneParams lp = *static_cast<const LaneParams*>(params);
  const int place = full_state_place(M, N);
  if (place < 0 || B < 1 || T < 1 || (place == 2 && scratch == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(tabs);
  const float* sv = static_cast<const float*>(steer);
  float* yf = static_cast<float*>(y);
  float* gs = place == 2 ? static_cast<float*>(scratch) : nullptr;
  switch (M) {
    case 2: return launch_full_m<2>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 3: return launch_full_m<3>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 4: return launch_full_m<4>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 5: return launch_full_m<5>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 6: return launch_full_m<6>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 7: return launch_full_m<7>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    case 8: return launch_full_m<8>(xf, tf, sv, yf, gs, B, N, T, syn_gain, lp, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* enhance_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
