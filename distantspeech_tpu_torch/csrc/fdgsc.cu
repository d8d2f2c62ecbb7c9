// Kernel K8: the fused frequency-domain GSC (FDGSC) frame loop, and its C
// launcher.
//
// Replaces distantspeech_tpu/ops/pallas_flms.py fused_fdgsc (_fdgsc_kernel):
// per frame, MCRA (L = 60) on the raw reference channel's power with the
// returned-p quirk (bins 0..31 pinned to >= 0.8 when the mean of p over
// bins 32..127 exceeds 0.8), M blocking-matrix FLMS filters on the shared
// FBF spectrum (p = 1, no 2x, CCAF-clamped in tap space), and the
// M-channel AIC on [e_prev, e_bm] stepped by mu (1 - mean(p)) under the
// filter-norm ceiling.  The plain version is fdgsc_frames_plain in
// ops/cuda_flms.py.
//
// Design.  One block of kFrameThreads threads per utterance runs the whole
// frame loop.  The state lives in shared memory: the BM and AIC filters as
// Lf time-domain taps each (so the CCAF clamp, the last-hop zeroing and the
// Lf-tap support are plain tap operations), the previous BM outputs, both
// FLMS powers and the MCRA state per bin.  All F = Lf + 1 bins are uniform
// lanes, so the AIC step's mean over F bins takes the Nyquist p (pinned at
// p_min) as one more lane.  The norm ceiling needs the half spectrum of the
// updated, unconstrained AIC filter: that is W + step G per bin, from the
// tap spectra and gradients this frame computes anyway, summed over the
// block before the gradients go back to taps.  Each 512-point transform is
// owned by one warp or a warp pair (flms_fft.cuh), two real transforms
// packed into each complex one: per frame 3 + 7 M real transforms (31 at
// M = 4) as M + 4 H + 3 complex ones (17 at M = 4), H = ceil(M / 2) the
// mic pairs (an odd M's last pair half empty), in 6 batches: {the FBF
// analysis alone, the M BM tap spectra in pairs} (1 + H; the small taps
// do not share a transform with the analysis, whose rounding would drown
// them), {the M BM outputs} (H), {E_bm and the AIC input of each mic}
// (M) with {the M AIC tap spectra} (H), {the M BM gradients, the AIC
// output} (H + 1), {the AIC error} (1) and {the M AIC gradients}
// (H).  Block barriers: 13 a frame, each
// where data crosses between the per-transform and the per-bin layouts (the
// two block sums ride on them); none inside a transform.  The next frame's
// inputs (the FBF block, the M delayed mic blocks, the delayed FBF block and
// the reference power) are prefetched with cp.async into a two-slot ring
// while the frame computes.
//
// What bounds it on an H100 (B = 128, M = 4, 4 s): the serial chain of a
// frame, 6 transform batches and 7 per-bin or per-sample phases between
// block barriers, with one block per utterance (128 blocks on 132 SMs); the
// 31 real transforms a frame are the operation bound.  The design it
// replaces, a block-wide radix-2 FFT with a block barrier per stage (~75 a
// frame), took 10.761 ms on an H100 at 700 W (PERF.md's kernel table keeps
// both times).  No tensor cores (flms_fft.cuh).
#include <cuda_runtime.h>

#include "flms_fft.cuh"

// Field order and types are mirrored by _FdgscParams in ops/cuda_flms.py.
struct FdgscParams {
  McraParams mc;
  float b0, b1, b2;  // MCRA's cross-bin smoothing taps
  float bm_alpha, bm_one_m_alpha, bm_mu;
  float aic_alpha, aic_one_m_alpha, aic_mu;
  float maxnorm;
};

namespace {

// One slot of the input ring, in floats: the FBF block, the M delayed mic
// blocks, the delayed FBF block and the reference power.
__host__ __device__ __forceinline__ int slot_floats(int M, int Lf) {
  return round4(Lf) + round4(M * Lf) + round4(Lf) + round4(Lf + 1);
}

// Shared memory in floats; the kernel carves it in this order.
__host__ __device__ size_t smem_floats(int M, int Lf) {
  const size_t N = 2 * Lf, F = Lf + 1, hop = Lf;
  const size_t H = (M + 1) / 2;  // mic pairs
  const size_t nseq = (1 + H) + (H + 1) + M + H + 1;
  return 2 * (size_t)slot_floats(M, Lf) + nseq * N * 2 + N + Lf + 2 * M * Lf + M * hop + 2 * F + 5 * F + F +
         4 * kFrameWarps;
}

// fbf, daic [B, T*Lf] (the FBF, and the FBF delayed by Lf), dbm [B, M, T*Lf]
// (the aligned mics delayed by Lf/2), yp [B, T, F] (reference-channel
// power), tabs [N/2 twiddles as (cos, sin) | N/2 CCAF upper bounds]
// -> out [B, T*Lf], p [B, T, F], bm [B, M, T*Lf].  MT = M, a compile-time
// constant from 2 to 8; or MT = 0 above that, M = m_run at run time, the
// per-bin loops over mics in pairs, and the block's buffers in the global
// scratch work (round4z(smem_floats(M, Lf)) floats a block, plain copies for
// the prefetch) where they do not fit in shared memory (work null).
template <int MT>
__global__ void __launch_bounds__(kFrameThreads, 1) fdgsc_kernel(const float* __restrict__ fbf, const float* __restrict__ dbm,
                                                              const float* __restrict__ daic, const float* __restrict__ yp,
                                                              const float* __restrict__ tabs, float* __restrict__ out,
                                                              float* __restrict__ pout, float* __restrict__ bmo, int T,
                                                              int Lf, int logN, FdgscParams prm, int m_run, float* work) {
  extern __shared__ float4 smem4[];
  constexpr int HT = (MT + 1) / 2;
  const int M = MT > 0 ? MT : m_run;
  const bool in_global = MT == 0 && work != nullptr;
  const int H = (M + 1) / 2;  // mic pairs; an odd M's last pair has an empty second half
  const int nA = 1 + H;       // the FBF analysis (with zero), then the BM tap spectra in pairs
  const int nY = H + 1;       // BM output pairs; BM gradient pairs + the AIC output; AIC gradient pairs
  const int N = 2 * Lf, hop = Lf, F = Lf + 1;
  const int tid = threadIdx.x;
  const size_t S = (size_t)T * hop;
  const int slot = slot_floats(M, Lf);
  const int o_m = round4(hop), o_a = o_m + round4(M * hop), o_y = o_a + round4(hop);
  float* ring = in_global ? work + blockIdx.x * round4z(smem_floats(M, Lf))
                          : reinterpret_cast<float*>(smem4);  // [2][slot] this and the next frame's inputs
  float2* bA = reinterpret_cast<float2*>(ring + 2 * slot);  // [nA][N] X, W_0 + i W_1, W_2 + i W_3, ...
  float2* bY = bA + nA * N;                                // [nY][N] inverses
  float2* bP = bY + nY * N;                                // [M][N] E_bm + i AIC input, per mic
  float2* bQ = bP + M * N;                                 // [H][N] AIC tap spectra in pairs (after bP)
  float2* bE = bQ + H * N;                                 // [N] the AIC error spectrum
  float2* tw = bE + N;                                     // [N/2]
  float* ub = reinterpret_cast<float*>(tw + N / 2);         // [Lf] CCAF upper bounds
  float* Wbm = ub + Lf;                                     // [M][Lf] BM taps
  float* Waic = Wbm + M * Lf;                               // [M][Lf] AIC taps
  float* Eprev = Waic + M * Lf;                             // [M][hop] previous BM outputs
  float* Pbm = Eprev + M * hop;                             // [F] BM FLMS power
  float* Paic = Pbm + F;                                    // [F] AIC FLMS power
  float* ms = Paic + F;                                     // [5][F] MCRA S, Smin, Stmp, P, Lam
  float* pp = ms + 5 * F;                                   // [F] this frame's MCRA p
  float* red = pp + F;                                      // [3][kFrameWarps] p's sums, [kFrameWarps] the norm

  const int b = blockIdx.x;
  const float* fb = fbf + b * S;
  const float* ab = daic + b * S;
  const float* db = dbm + (size_t)b * M * S;
  float* bo = bmo + (size_t)b * M * S;
  float* ob = out + b * S;
  // the next frame's inputs into ring slot t & 1
  auto prefetch = [&](int t) {
    float* sl = ring + (t & 1) * slot;
    if (in_global) {  // no cp.async into global memory: plain copies, seen after the next barrier
      copy_floats(sl, fb + (size_t)t * hop, hop);
      for (int m = 0; m < M; ++m) copy_floats(sl + o_m + m * hop, db + m * S + (size_t)t * hop, hop);
      copy_floats(sl + o_a, ab + (size_t)t * hop, hop);
      copy_floats(sl + o_y, yp + ((size_t)b * T + t) * F, F);
      return;
    }
    prefetch_floats(sl, fb + (size_t)t * hop, hop);
    for (int m = 0; m < M; ++m) prefetch_floats(sl + o_m + m * hop, db + m * S + (size_t)t * hop, hop);
    prefetch_floats(sl + o_a, ab + (size_t)t * hop, hop);
    prefetch_floats(sl + o_y, yp + ((size_t)b * T + t) * F, F);
    copy_async_commit();
  };
  prefetch(0);
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kFrameThreads) tw[i] = twg[i];
  for (int i = tid; i < Lf; i += kFrameThreads) ub[i] = tabs[N + i];
  for (int i = tid; i < 3 * M * Lf + 7 * F; i += kFrameThreads) Wbm[i] = 0.f;  // taps, Eprev, powers, MCRA
  const float invN = 1.f / (float)N;
  copy_async_wait_all();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* cur = ring + (t & 1) * slot;
    const float* old = ring + ((t + 1) & 1) * slot;  // frame t - 1's FBF block
    const float* fp = cur + o_y;
    // ---- MCRA on the reference power, p's sums for the pinning and the AIC step
    float s[3] = {0.f, 0.f, 0.f};  // sum of p over bins 32..127, over all bins, pinning's raise over bins 0..31
    for (int k = tid; k < F; k += kFrameThreads) {
      McraLane m = load_mcra(ms, F, k);
      const float Sf = prm.b0 * fp[k > 0 ? k - 1 : 0] + prm.b1 * fp[k] + prm.b2 * fp[k < F - 1 ? k + 1 : F - 1];
      float lam, sr;
      const float p = mcra_frame(m, t, fp[k], Sf, bin_kind(k, F), prm.mc, lam, sr);
      store_mcra(ms, F, k, m);
      pp[k] = p;
      if (k >= 32 && k < 128) s[0] += p;
      s[1] += p;
      if (k < 32) s[2] += fmaxf(p, 0.8f) - p;
    }
    warp_partials<3>(s, red);
    // ---- load: [fbf_{t-1}, fbf_t]; the BM taps W_0 + i W_1, W_2 + i W_3, ... bit-reversed
    for (int i = tid; i < nA * N; i += kFrameThreads) {
      const int q = i >> logN, n = i & (N - 1);
      float2 v = make_float2(0.f, 0.f);
      if (q == 0)
        v.x = n < hop ? (t > 0 ? old[n] : 0.f) : cur[n - hop];
      else if (n < Lf)
        v = make_float2(Wbm[(2 * q - 2) * Lf + n], 2 * q - 1 < M ? Wbm[(2 * q - 1) * Lf + n] : 0.f);
      bA[q * N + swz(bitrev(n, logN), logN)] = v;
    }
    __syncthreads();  // 1
    if (t + 1 < T) prefetch(t + 1);  // into frame t - 1's slot, read for the last time above
    sum_partials<3>(s, red);
    const bool pin = s[0] / 96.f > 0.8f;
    const float step = prm.aic_mu * (1.f - (pin ? s[1] + s[2] : s[1]) / (float)F);
    for (int k = tid; k < F; k += kFrameThreads)
      pout[((size_t)b * T + t) * F + k] = (pin && k < 32) ? fmaxf(pp[k], 0.8f) : pp[k];
    fft_batch<false>(bA, nA, N, logN, tw);
    __syncthreads();  // 2

    // ---- per bin: the BM power, the M BM outputs in pairs
    for (int k = tid; k < F; k += kFrameThreads) {
      const float2 X = bA[swz(k, logN)];  // the FBF analysis, a real signal's transform
      Pbm[k] = fmaxf(prm.bm_alpha * Pbm[k] + prm.bm_one_m_alpha * (X.x * X.x + X.y * X.y), 1e-4f);
#pragma unroll
      for (int q = 0; q < H; ++q) {
        float2 W0, W1;
        split_pair(bA + (1 + q) * N, k, N, logN, W0, W1);
        put_pair(bY + q * N, k, N, logN, cmulf(X, W0), 2 * q + 1 < M ? cmulf(X, W1) : make_float2(0.f, 0.f));
      }
    }
    __syncthreads();  // 3
    fft_batch<true>(bY, H, N, logN, tw);
    __syncthreads();  // 4

    // ---- BM outputs e_bm: the BM error input [0; e_bm] + i the AIC input
    // [e_prev; e_bm] per mic; the AIC taps in pairs
    for (int i = tid; i < M * hop; i += kFrameThreads) {
      const int m = i >> (logN - 1), n = i & (hop - 1);
      const float2 y = bY[(m >> 1) * N + swz(hop + n, logN)];
      const float e = cur[o_m + i] - ((m & 1) ? y.y : y.x) * invN;
      bo[(size_t)m * S + (size_t)t * hop + n] = e;
      bP[m * N + swz(bitrev(n, logN), logN)] = make_float2(0.f, Eprev[i]);
      bP[m * N + swz(bitrev(hop + n, logN), logN)] = make_float2(e, e);
      Eprev[i] = e;
    }
    for (int i = tid; i < H * N; i += kFrameThreads) {
      const int q = i >> logN, n = i & (N - 1);
      const bool in = n < Lf;
      bQ[q * N + swz(bitrev(n, logN), logN)] =
          make_float2(in ? Waic[2 * q * Lf + n] : 0.f, in && 2 * q + 1 < M ? Waic[(2 * q + 1) * Lf + n] : 0.f);
    }
    __syncthreads();  // 5
    fft_batch<false>(bP, M + H, N, logN, tw);  // bP and bQ are adjacent
    __syncthreads();  // 6

    // ---- per bin: the BM gradients; the AIC output and power
    for (int k = tid; k < F; k += kFrameThreads) {
      const float2 X = bA[swz(k, logN)];
      const float P = Pbm[k];
      float2 Y = make_float2(0.f, 0.f);
      float pw = 0.f;
      if constexpr (MT > 0) {
        float2 g[2 * HT], Wa[2 * HT];
        g[2 * H - 1] = make_float2(0.f, 0.f);  // an odd M's empty half
#pragma unroll
        for (int q = 0; q < H; ++q) split_pair(bQ + q * N, k, N, logN, Wa[2 * q], Wa[2 * q + 1]);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          float2 Eb, Za;
          split_pair(bP + m * N, k, N, logN, Eb, Za);
          g[m] = grad_bin(X, Eb, P);
          const float2 y = cmulf(Za, Wa[m]);
          Y = make_float2(Y.x + y.x, Y.y + y.y);
          pw = pw + (Za.x * Za.x + Za.y * Za.y);
        }
#pragma unroll
        for (int q = 0; q < H; ++q) put_pair(bY + q * N, k, N, logN, g[2 * q], g[2 * q + 1]);
      } else {
        for (int q = 0; q < H; ++q) {  // mics 2q and 2q + 1, in the same order
          float2 g[2], Wa[2];
          g[1] = make_float2(0.f, 0.f);
          split_pair(bQ + q * N, k, N, logN, Wa[0], Wa[1]);
          for (int h = 0; h < 2 && 2 * q + h < M; ++h) {
            float2 Eb, Za;
            split_pair(bP + (2 * q + h) * N, k, N, logN, Eb, Za);
            g[h] = grad_bin(X, Eb, P);
            const float2 y = cmulf(Za, Wa[h]);
            Y = make_float2(Y.x + y.x, Y.y + y.y);
            pw = pw + (Za.x * Za.x + Za.y * Za.y);
          }
          put_pair(bY + q * N, k, N, logN, g[0], g[1]);
        }
      }
      Paic[k] = fmaxf(prm.aic_alpha * Paic[k] + prm.aic_one_m_alpha * pw, 1e-4f);
      put_pair(bY + H * N, k, N, logN, Y, make_float2(0.f, 0.f));
    }
    __syncthreads();  // 7
    fft_batch<true>(bY, nY, N, logN, tw);
    __syncthreads();  // 8

    // ---- the BM update (the first Lf taps), CCAF-clamped; the AIC error
    for (int i = tid; i < M * Lf; i += kFrameThreads) {
      const int m = i >> (logN - 1), n = i & (Lf - 1);
      const float2 u = bY[(m >> 1) * N + swz(n, logN)];
      Wbm[i] = fminf(fmaxf(Wbm[i] + prm.bm_mu * (((m & 1) ? u.y : u.x) * invN), -0.001f), ub[n]);
    }
    for (int n = tid; n < hop; n += kFrameThreads) {
      const float e = cur[o_a + n] - bY[H * N + swz(hop + n, logN)].x * invN;
      ob[(size_t)t * hop + n] = e;
      bE[swz(bitrev(n, logN), logN)] = make_float2(0.f, 0.f);
      bE[swz(bitrev(hop + n, logN), logN)] = make_float2(e, 0.f);
    }
    __syncthreads();  // 9
    fft_batch<false>(bE, 1, N, logN, tw);
    __syncthreads();  // 10

    // ---- per bin: the AIC gradients in pairs and the norm of the updated filter
    float nrm[1] = {0.f};
    for (int k = tid; k < F; k += kFrameThreads) {
      const float2 E = bE[swz(k, logN)];
      const float P = Paic[k];
      if constexpr (MT > 0) {
        float2 g[2 * HT], Wa[2 * HT];
        g[2 * H - 1] = make_float2(0.f, 0.f);  // an odd M's empty half
#pragma unroll
        for (int q = 0; q < H; ++q) split_pair(bQ + q * N, k, N, logN, Wa[2 * q], Wa[2 * q + 1]);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          float2 Eb, Za;
          split_pair(bP + m * N, k, N, logN, Eb, Za);
          g[m] = grad_bin(Za, E, P);
          const float nr = Wa[m].x + step * g[m].x, ni = Wa[m].y + step * g[m].y;
          nrm[0] += nr * nr + ni * ni;
        }
#pragma unroll
        for (int q = 0; q < H; ++q) put_pair(bY + q * N, k, N, logN, g[2 * q], g[2 * q + 1]);
      } else {
        for (int q = 0; q < H; ++q) {
          float2 g[2], Wa[2];
          g[1] = make_float2(0.f, 0.f);
          split_pair(bQ + q * N, k, N, logN, Wa[0], Wa[1]);
          for (int h = 0; h < 2 && 2 * q + h < M; ++h) {
            float2 Eb, Za;
            split_pair(bP + (2 * q + h) * N, k, N, logN, Eb, Za);
            g[h] = grad_bin(Za, E, P);
            const float nr = Wa[h].x + step * g[h].x, ni = Wa[h].y + step * g[h].y;
            nrm[0] += nr * nr + ni * ni;
          }
          put_pair(bY + q * N, k, N, logN, g[0], g[1]);
        }
      }
    }
    warp_partials<1>(nrm, red + 3 * kFrameWarps);
    __syncthreads();  // 11
    sum_partials<1>(nrm, red + 3 * kFrameWarps);
    const float norm = nrm[0] / (float)N / (float)N;
    const float scale = norm > prm.maxnorm ? sqrtf(prm.maxnorm / fmaxf(norm, 1e-30f)) : 1.f;
    fft_batch<true>(bY, H, N, logN, tw);
    __syncthreads();  // 12
    for (int i = tid; i < M * Lf; i += kFrameThreads) {
      const int m = i >> (logN - 1), n = i & (Lf - 1);
      const float2 u = bY[(m >> 1) * N + swz(n, logN)];
      Waic[i] = (Waic[i] + step * (((m & 1) ? u.y : u.x) * invN)) * scale;
    }
    copy_async_wait_all();  // the next frame's inputs
    __syncthreads();  // 13
  }
}

template <int M>
cudaError_t launch(const float* fbf, const float* dbm, const float* daic, const float* yp, const float* tabs,
                   float* out, float* p, float* bm, int B, int T, int Lf, int logN, const FdgscParams& prm,
                   cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(M, Lf);
  const cudaError_t e = allow_smem(fdgsc_kernel<M>, smem);
  if (e != cudaSuccess) return e;
  fdgsc_kernel<M><<<B, kFrameThreads, smem, st>>>(fbf, dbm, daic, yp, tabs, out, p, bm, T, Lf, logN, prm, M, nullptr);
  return cudaGetLastError();
}

bool fits_smem(int M, int Lf) { return sizeof(float) * smem_floats(M, Lf) <= kMaxSmem; }

// M > 8: fdgsc_kernel<0>, in shared memory where it fits, else in scratch.
cudaError_t launch_any(const float* fbf, const float* dbm, const float* daic, const float* yp, const float* tabs,
                       float* out, float* p, float* bm, float* scratch, int M, int B, int T, int Lf, int logN,
                       const FdgscParams& prm, cudaStream_t st) {
  const bool smem_ok = fits_smem(M, Lf);
  if (!smem_ok && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_ok ? sizeof(float) * smem_floats(M, Lf) : 0;
  const cudaError_t e = allow_smem(fdgsc_kernel<0>, smem);
  if (e != cudaSuccess) return e;
  fdgsc_kernel<0><<<B, kFrameThreads, smem, st>>>(fbf, dbm, daic, yp, tabs, out, p, bm, T, Lf, logN, prm, M,
                                                   smem_ok ? nullptr : scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of global scratch the launch needs at M mics (0 where the block's
// buffers fit in shared memory, always up to M = 8), -1 for a shape the
// launcher does not take.
long long fused_fdgsc_scratch_floats(int M, int B, int Lf) {
  if (M < 2 || log2_of_twice(Lf) < 0 || Lf < 128) return -1;
  return M <= 8 || fits_smem(M, Lf) ? 0 : (long long)B * round4z(smem_floats(M, Lf));
}

// M (mics) 2 or more; Lf a power of two >= 128 (the p pinning reads bins
// 32..127).  Above 8 mics the kernel takes M at run time, its buffers in
// scratch where they do not fit in shared memory (fused_fdgsc_scratch_floats).
cudaError_t fused_fdgsc_launch(const void* fbf, const void* dbm, const void* daic, const void* yp, const void* tabs,
                               void* out, void* p, void* bm, void* scratch, int M, int B, int T, int Lf,
                               const void* params, void* stream) {
  const int logN = log2_of_twice(Lf);
  if (logN < 0 || Lf < 128 || B < 1 || T < 1) return cudaErrorInvalidValue;
  const FdgscParams prm = *static_cast<const FdgscParams*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ff = static_cast<const float*>(fbf);
  const float* df = static_cast<const float*>(dbm);
  const float* af = static_cast<const float*>(daic);
  const float* yf = static_cast<const float*>(yp);
  const float* tf = static_cast<const float*>(tabs);
  float* of = static_cast<float*>(out);
  float* pf = static_cast<float*>(p);
  float* bf = static_cast<float*>(bm);
  switch (M) {
    case 2: return launch<2>(ff, df, af, yf, tf, of, pf, bf, B, T, Lf, logN, prm, st);
    case 3: return launch<3>(ff, df, af, yf, tf, of, pf, bf, B, T, Lf, logN, prm, st);
    case 4: return launch<4>(ff, df, af, yf, tf, of, pf, bf, B, T, Lf, logN, prm, st);
    case 5: return launch<5>(ff, df, af, yf, tf, of, pf, bf, B, T, Lf, logN, prm, st);
    case 6: return launch<6>(ff, df, af, yf, tf, of, pf, bf, B, T, Lf, logN, prm, st);
    case 7: return launch<7>(ff, df, af, yf, tf, of, pf, bf, B, T, Lf, logN, prm, st);
    case 8: return launch<8>(ff, df, af, yf, tf, of, pf, bf, B, T, Lf, logN, prm, st);
    default:
      if (M < 2) return cudaErrorInvalidValue;
      return launch_any(ff, df, af, yf, tf, of, pf, bf, static_cast<float*>(scratch), M, B, T, Lf, logN, prm, st);
  }
}

const char* fdgsc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
