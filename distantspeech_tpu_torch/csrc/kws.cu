// Kernel K6: the dual-mic KWS cleaner's frame loop, and its C launcher.
//
// Replaces distantspeech_tpu/ops/pallas_flms.py fused_kws (_kws_kernel): a
// continuously adapting single-channel FLMS ANC (mic 0 -> mic 1, 2 mu
// step, taps held in time domain so the gradient constraint is a mask)
// whose taps a frozen cleaner applies Dn frames late.  The plain version is
// kws_frames_plain in ops/cuda_flms.py.
//
// Design.  One block of kFrameThreads (512) threads per utterance runs the
// whole frame loop, its N = 2 Lf point transforms owned by warps
// (flms_fft.cuh: radix-8 passes in registers, no block barrier inside a
// transform).  The frame's work splits into what depends on the ANC's
// recursion and what does not:
//
// - the chain, on the chain group (warps 0 and 1, one radix-8 butterfly a
//   thread a pass at N = 512, a named barrier between passes): the ANC tap
//   spectrum Wz of the taps updated a frame ago; the inverse of the ANC
//   output Y, of which only the last hop is read; the error transform of
//   [0; e], whose first pass forms e from that inverse as it loads; the
//   gradient inverse, of which only the first Lf samples are read, the tap
//   update and the push of the new taps into the FIFO;
// - off the chain, on warp pairs of their own: the inverse of the cleaner's
//   output C (warps 2 and 3, beside the inverse of Y) and the cleaned block;
//   and beside frame t's chain, the x0 analysis of frame t + 1 (warps 8 and
//   9, beside the inverse of Y and the error transform) and the deferred
//   taps' spectrum Wf of frame t + 1 (warps 10 and 11, beside the gradient
//   inverse and the tap spectrum: the FIFO slot written Dn frames before,
//   read from L2), into the other slot of two-slot rings, while warp 13
//   prefetches frame t + 2's x0 block and frame t + 1's d block with
//   cp.async.
//
// Bin k stays on thread k (bin Lf on thread Lf) for the FLMS power and the
// per-bin products.  Taps are never packed with signal (the tap spectra
// are transformed alone), and Y and C are not packed either: in one
// complex inverse Y's rounding would leak into C, and the cleaner, whose
// taps are zeros until the FIFO wraps, would no longer return d to the bit
// (as the scan does).  Four block barriers a frame (the design it replaces
// ran 7 radix-2 transforms with ~40).  The tap FIFO (Dn = 94
// slots x 256 taps at the default 1.5 s defer) stays in a zero-filled global
// scratch [B, Dn, Lf] from the wrapper, indexed circularly by frame: slot
// t % Dn holds the taps pushed at frame t - Dn (zeros until the FIFO has
// wrapped).  With Dn = 1 the deferred taps are the ANC's own (the slot read
// at frame t is the one written at t - 1), so the cleaner uses Wz.
//
// What bounds it on an H100 (B = 128, 4 s): operations (7 real transforms
// per utterance and frame), far below the chain of 4 transforms, 2 per-bin
// phases and 4 barriers a frame with one block per utterance on 132 SMs.
// The first design took 2.923 ms at that size (PERF.md's kernel table
// keeps both times).
#include <cuda_runtime.h>

#include "flms_fft.cuh"

// Field order and types are mirrored by _KwsParams in ops/cuda_flms.py.
struct KwsParams {
  float alpha, one_m_alpha, mu2;  // FLMS power pole, 2 mu
};

namespace {

// Warp pairs of 64 threads, each with its own named barrier (id = first
// warp / 2 + 1): the chain (warps 0-1), the cleaner's inverse (2-3), the
// next frame's analysis (8-9) and its deferred-tap spectrum (10-11).
constexpr int kPair = 64;
constexpr int kChainWarp = 0, kCleanWarp = 2, kXWarp = 8, kWfWarp = 10;
constexpr int kCopyWarp = 13;  // prefetches the input blocks

// Shared memory in floats; the kernel carves it in this order.
size_t smem_floats(int Lf) {
  const size_t N = 2 * Lf, F = Lf + 1, hop = Lf;
  return 8 * N * 2 + N + 3 * hop + 2 * hop + Lf + F;
}

// x0, d [B, T*Lf] (d: mic 1 delayed by Lf/2), tabs [N/2 twiddles as
// (cos, sin)], fifo [B, Dn, Lf] zeroed -> out [B, T*Lf].  kLogN = log2 N
// where it is a compile-time constant (the index arithmetic folds), else 0
// and logN gives it.
template <int kLogN>
__global__ void __launch_bounds__(kFrameThreads, 1) kws_kernel(const float* __restrict__ x0,
                                                               const float* __restrict__ d,
                                                               const float* __restrict__ tabs, float* fifo,
                                                               float* __restrict__ out, int T, int Lf, int logN_arg,
                                                               int Dn, KwsParams prm) {
  extern __shared__ float4 smem4[];
  const int logN = kLogN ? kLogN : logN_arg;
  const int N = 1 << logN, hop = N / 2, F = hop + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t S = (size_t)T * hop;
  float2* Xs = reinterpret_cast<float2*>(smem4);  // [2][N] x0 analyses of frames t and t+1
  float2* Wfs = Xs + 2 * N;                       // [2][N] deferred tap spectra of frames t and t+1
  float2* Wz = Wfs + 2 * N;                       // [N] ANC tap spectrum
  float2* Zb = Wz + N;                            // [N] the ANC output Y, then the gradient
  float2* Zc = Zb + N;                            // [N] the cleaner's output C
  float2* Es = Zc + N;                            // [N] error spectrum
  float2* tw = Es + N;                            // [N/2]
  float* xbuf = reinterpret_cast<float*>(tw + N / 2);  // [3][hop] x0 block u in slot u % 3
  float* dbuf = xbuf + 3 * hop;                   // [2][hop] d block t in slot t & 1
  float* w = dbuf + 2 * hop;                      // [Lf] ANC taps
  float* Pw = w + Lf;                             // [F] FLMS power

  const float* xb = x0 + blockIdx.x * S;
  const float* db = d + blockIdx.x * S;
  float* ob = out + blockIdx.x * S;
  float* fb = fifo + (size_t)blockIdx.x * Dn * Lf;
  const bool own = Dn == 1;  // the cleaner runs the ANC's own taps
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kFrameThreads) tw[i] = twg[i];
  for (int i = tid; i < Lf; i += kFrameThreads) w[i] = 0.f;
  for (int k = tid; k < F; k += kFrameThreads) Pw[k] = 0.f;
  for (int n = tid; n < hop; n += kFrameThreads) {
    xbuf[n] = xb[n];
    xbuf[hop + n] = T > 1 ? xb[hop + n] : 0.f;
    dbuf[n] = db[n];
  }
  const float invN = 1.f / (float)N;
  __syncthreads();

  // the pair of warps w and w + 1: is this thread in it, its rank, its barrier
  auto in_pair = [&](int w) { return warp == w || warp == w + 1; };
  auto rank = [&](int w) { return tid - 32 * w; };
  auto bar = [](int w) { return w / 2 + 1; };
  // X_u = FFT [x0 block u - 1 (zeros before the first); block u] into Xs[u & 1]
  auto analyse = [&](int u) {
    const float* b0 = xbuf + ((u + 2) % 3) * hop;
    const float* b1 = xbuf + (u % 3) * hop;
    fft_seq_from<false>(Xs + (u & 1) * N, logN, tw, rank(kXWarp), kPair, bar(kXWarp), [&](const float2*, int p, int lg) {
      const int n = bitrev(p, lg);
      return make_float2(n < hop ? (u > 0 ? b0[n] : 0.f) : b1[n - hop], 0.f);
    });
  };
  // Wf_u = FFT [FIFO slot u % Dn; 0] into Wfs[u & 1]
  auto deferred = [&](int u) {
    const float* sl = fb + (size_t)(u % Dn) * Lf;
    fft_seq_from<false>(Wfs + (u & 1) * N, logN, tw, rank(kWfWarp), kPair, bar(kWfWarp),
                        [&](const float2*, int p, int lg) {
                          const int n = bitrev(p, lg);
                          return make_float2(n < Lf ? sl[n] : 0.f, 0.f);
                        });
  };
  // Wz = FFT [w; 0], by the chain group
  auto taps = [&]() {
    fft_seq_from<false>(Wz, logN, tw, tid, kPair, bar(kChainWarp), [&](const float2*, int p, int lg) {
      const int n = bitrev(p, lg);
      return make_float2(n < Lf ? w[n] : 0.f, 0.f);
    });
  };

  if (in_pair(kXWarp))
    analyse(0);
  else if (in_pair(kWfWarp) && !own)
    deferred(0);
  else if (in_pair(kChainWarp))
    taps();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float2* X = Xs + (t & 1) * N;
    const float2* Wf = own ? Wz : Wfs + (t & 1) * N;

    // ---- per bin: FLMS power; the ANC and cleaner outputs
    for (int k = tid; k < F; k += kFrameThreads) {
      const int sk = swz(k, logN);
      const float2 x = X[sk];
      Pw[k] = fmaxf(prm.alpha * Pw[k] + prm.one_m_alpha * (x.x * x.x + x.y * x.y), 1e-4f);
      put_pair(Zb, k, N, logN, cmulf(x, Wz[sk]), make_float2(0.f, 0.f));
      if (!own) put_pair(Zc, k, N, logN, cmulf(x, Wf[sk]), make_float2(0.f, 0.f));
    }
    __syncthreads();

    const float* dt = dbuf + (t & 1) * hop;
    if (in_pair(kChainWarp)) {
      // ---- the inverse of Y; its last hop: the error e = d - y that the
      // error transform loads as [0; e] (and, with Dn = 1, the cleaned output)
      fft_seq<true>(Zb, logN, tw, tid, kPair, bar(kChainWarp));
      group_sync(bar(kChainWarp), kPair);
      if (own)
        for (int n = tid; n < hop; n += kPair) ob[(size_t)t * hop + n] = dt[n] - Zb[swz(hop + n, logN)].x * invN;
      fft_seq_from<false>(Es, logN, tw, tid, kPair, bar(kChainWarp), [&](const float2*, int p, int lg) {
        const int n = bitrev(p, lg);
        if (n < hop) return make_float2(0.f, 0.f);
        return make_float2(dt[n - hop] - Zb[swz(n, lg)].x * invN, 0.f);
      });
    } else if (in_pair(kCleanWarp)) {
      // ---- the inverse of C; its last hop: the cleaned output
      if (!own) {
        fft_seq<true>(Zc, logN, tw, rank(kCleanWarp), kPair, bar(kCleanWarp));
        group_sync(bar(kCleanWarp), kPair);
        for (int n = rank(kCleanWarp); n < hop; n += kPair)
          ob[(size_t)t * hop + n] = dt[n] - Zc[swz(hop + n, logN)].x * invN;
      }
    } else if (in_pair(kXWarp)) {
      if (t + 1 < T) analyse(t + 1);
    } else if (warp == kCopyWarp) {
      // x0 block t + 2 into the slot of block t - 1 (read by frame t's
      // analysis, a frame ago); d block t + 1 into the slot of block t - 1
      if (t + 2 < T) prefetch_floats(xbuf + ((t + 2) % 3) * hop, xb + (size_t)(t + 2) * hop, hop, lane, 32);
      if (t + 1 < T) prefetch_floats(dbuf + ((t + 1) & 1) * hop, db + (size_t)(t + 1) * hop, hop, lane, 32);
      copy_async_commit();
    }
    __syncthreads();

    // ---- per bin: the gradient conj(X) E / P
    for (int k = tid; k < F; k += kFrameThreads) {
      const int sk = swz(k, logN);
      put_pair(Zb, k, N, logN, grad_bin(X[sk], Es[sk], Pw[k]), make_float2(0.f, 0.f));
    }
    __syncthreads();

    if (in_pair(kChainWarp)) {
      // ---- constrained update (the first Lf samples), the push into the
      // FIFO, and the next frame's tap spectrum
      fft_seq<true>(Zb, logN, tw, tid, kPair, bar(kChainWarp));
      group_sync(bar(kChainWarp), kPair);
      float* slot = fb + (size_t)(t % Dn) * Lf;
      for (int n = tid; n < Lf; n += kPair) {
        const float wn = w[n] + prm.mu2 * (Zb[swz(n, logN)].x * invN);
        w[n] = wn;
        slot[n] = wn;
      }
      group_sync(bar(kChainWarp), kPair);
      taps();
    } else if (in_pair(kWfWarp)) {
      // the FIFO slot read here, written Dn >= 2 frames ago, is not the one
      // the chain writes beside it
      if (t + 1 < T && !own) deferred(t + 1);
    } else if (warp == kCopyWarp) {
      copy_async_wait_all();
    }
    __syncthreads();
  }
}

template <int kLogN>
cudaError_t launch(const float* x0, const float* d, const float* tabs, float* fifo, float* out, int B, int T, int Lf,
                   int logN, int Dn, const KwsParams& prm, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(Lf);
  const cudaError_t e = allow_smem(kws_kernel<kLogN>, smem);
  if (e != cudaSuccess) return e;
  kws_kernel<kLogN><<<B, kFrameThreads, smem, st>>>(x0, d, tabs, fifo, out, T, Lf, logN, Dn, prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t fused_kws_launch(const void* x0, const void* d, const void* tabs, void* fifo, void* out, int B, int T,
                             int Lf, int Dn, const void* params, void* stream) {
  const int logN = log2_of_twice(Lf);
  if (logN < 0 || B < 1 || T < 1 || Dn < 1) return cudaErrorInvalidValue;
  const KwsParams prm = *static_cast<const KwsParams*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x0);
  const float* df = static_cast<const float*>(d);
  const float* tf = static_cast<const float*>(tabs);
  float* ff = static_cast<float*>(fifo);
  float* of = static_cast<float*>(out);
  switch (logN) {
    case 9: return launch<9>(xf, df, tf, ff, of, B, T, Lf, logN, Dn, prm, st);
    case 8: return launch<8>(xf, df, tf, ff, of, B, T, Lf, logN, Dn, prm, st);
    default: return launch<0>(xf, df, tf, ff, of, B, T, Lf, logN, Dn, prm, st);
  }
}

const char* kws_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
