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
// Design.  One 256-thread block per utterance runs the whole frame loop.
// The state lives in shared memory: the BM and AIC filters as Lf
// time-domain taps each (so the CCAF clamp, the last-hop zeroing and the
// Lf-tap support are plain tap operations), the previous BM outputs, both
// FLMS powers and the MCRA state per bin.  All F = Lf + 1 bins are uniform
// lanes, so the AIC step's mean over F bins takes the Nyquist p (pinned at
// p_min) as one more lane.  The norm ceiling needs the half spectrum of the
// updated, unconstrained AIC filter: that is W + step G per bin, from the
// tap spectra and gradients this frame computes anyway, summed in a block
// reduction before the gradients go back to taps.  Per frame, 3 + 7 M
// 512-point FFTs (31 at M = 4) in 7 batched passes (flms_lane.cuh).
//
// What bounds it on an H100 (B = 128, M = 4, 4 s): operations, 31
// transforms per utterance and frame; and the latency of ~70 barriers per
// frame, with one block of 8 warps per utterance on 132 SMs.
#include <cuda_runtime.h>

#include "flms_lane.cuh"

// Field order and types are mirrored by _FdgscParams in ops/cuda_flms.py.
struct FdgscParams {
  McraParams mc;
  float b0, b1, b2;  // MCRA's cross-bin smoothing taps
  float bm_alpha, bm_one_m_alpha, bm_mu;
  float aic_alpha, aic_one_m_alpha, aic_mu;
  float maxnorm;
};

namespace {

// Shared memory in floats; the kernel carves it in this order.
size_t smem_floats(int M, int Lf) {
  const size_t N = 2 * Lf, F = Lf + 1, hop = Lf;
  return (4 * M + 2) * N * 2 + N + Lf + 2 * M * Lf + M * hop + 2 * F + 5 * F + 2 * F + 4 * kWarps;
}

// fbf, daic [B, T*Lf] (the FBF, and the FBF delayed by Lf), dbm [B, M, T*Lf]
// (the aligned mics delayed by Lf/2), yp [B, T, F] (reference-channel
// power), tabs [N/2 twiddles as (cos, sin) | N/2 CCAF upper bounds]
// -> out [B, T*Lf], p [B, T, F], bm [B, M, T*Lf]
template <int M>
__global__ void __launch_bounds__(kThreads) fdgsc_kernel(const float* __restrict__ fbf, const float* __restrict__ dbm,
                                                         const float* __restrict__ daic, const float* __restrict__ yp,
                                                         const float* __restrict__ tabs, float* __restrict__ out,
                                                         float* __restrict__ pout, float* __restrict__ bmo, int T,
                                                         int Lf, int logN, FdgscParams prm) {
  extern __shared__ float4 smem4[];
  const int N = 2 * Lf, hop = Lf, F = Lf + 1;
  const int tid = threadIdx.x;
  const size_t S = (size_t)T * hop;
  float2* bX = reinterpret_cast<float2*>(smem4);  // [N] FBF analysis, then the AIC error spectrum
  float2* bW = bX + N;                            // [M][N] BM tap spectra, then the BM error spectra
  float2* bA = bW + M * N;                        // [M][N] AIC input spectra
  float2* bWa = bA + M * N;                       // [M][N] AIC tap spectra
  float2* bY = bWa + M * N;                       // [M+1][N] inverses: BM outputs; BM gradients and AIC output;
                                                  //   AIC gradients
  float2* tw = bY + (M + 1) * N;                  // [N/2]
  float* ub = reinterpret_cast<float*>(tw + N / 2);  // [Lf] CCAF upper bounds
  float* Wbm = ub + Lf;                           // [M][Lf] BM taps
  float* Waic = Wbm + M * Lf;                     // [M][Lf] AIC taps
  float* Eprev = Waic + M * Lf;                   // [M][hop] previous BM outputs
  float* Pbm = Eprev + M * hop;                   // [F] BM FLMS power
  float* Paic = Pbm + F;                          // [F] AIC FLMS power
  float* ms = Paic + F;                           // [5][F] MCRA S, Smin, Stmp, P, Lam
  float* fp = ms + 5 * F;                         // [F] this frame's reference power
  float* pp = fp + F;                             // [F] this frame's MCRA p
  float* red = pp + F;                            // [4][kWarps] reductions

  const int b = blockIdx.x;
  const float* fb = fbf + b * S;
  const float* ab = daic + b * S;
  const float* db = dbm + (size_t)b * M * S;
  float* bo = bmo + (size_t)b * M * S;
  float* ob = out + b * S;
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kThreads) tw[i] = twg[i];
  for (int i = tid; i < Lf; i += kThreads) ub[i] = tabs[N + i];
  for (int i = tid; i < 3 * M * Lf + 7 * F; i += kThreads) Wbm[i] = 0.f;  // taps, Eprev, powers, MCRA
  const float invN = 1.f / (float)N;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- MCRA on the reference power, p's sums for the pinning and the AIC step
    for (int k = tid; k < F; k += kThreads) fp[k] = yp[((size_t)b * T + t) * F + k];
    __syncthreads();
    float s[3] = {0.f, 0.f, 0.f};  // sum of p over bins 32..127, over all bins, pinning's raise over bins 0..31
    for (int k = tid; k < F; k += kThreads) {
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
    block_sum<3>(s, red);
    const bool pin = s[0] / 96.f > 0.8f;
    const float step = prm.aic_mu * (1.f - (pin ? s[1] + s[2] : s[1]) / (float)F);
    for (int k = tid; k < F; k += kThreads)
      pout[((size_t)b * T + t) * F + k] = (pin && k < 32) ? fmaxf(pp[k], 0.8f) : pp[k];

    // ---- load: [fbf_{t-1}, fbf_t] and the BM taps, bit-reversed
    for (int i = tid; i < N; i += kThreads) {
      const float v = i < hop ? (t > 0 ? fb[(size_t)(t - 1) * hop + i] : 0.f) : fb[(size_t)t * hop + i - hop];
      bX[bitrev(i, logN)] = make_float2(v, 0.f);
    }
    for (int i = tid; i < M * N; i += kThreads) {
      const int m = i >> logN, n = i & (N - 1);
      bW[m * N + bitrev(n, logN)] = make_float2(n < Lf ? Wbm[m * Lf + n] : 0.f, 0.f);
    }
    __syncthreads();
    fft_stages(bX, 1 + M, N, logN, tw, false);  // X and the M BM tap spectra

    // ---- per bin: the BM power, the M BM outputs
    for (int k = tid; k < F; k += kThreads) {
      const float2 X = bX[k];
      Pbm[k] = fmaxf(prm.bm_alpha * Pbm[k] + prm.bm_one_m_alpha * (X.x * X.x + X.y * X.y), 1e-4f);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float2 Y = cmulf(X, bW[m * N + k]);
        put_half(bY + m * N, k, N, logN, Y.x, Y.y);
      }
    }
    __syncthreads();
    fft_stages(bY, M, N, logN, tw, true);

    // ---- BM outputs e_bm (the BM's error spectra input [0; e_bm] and the
    // AIC input [e_prev; e_bm]); the AIC taps
    for (int i = tid; i < M * hop; i += kThreads) {
      const int m = i >> (logN - 1), n = i & (hop - 1);
      const float e = db[(size_t)m * S + (size_t)t * hop + n] - bY[m * N + hop + n].x * invN;
      bo[(size_t)m * S + (size_t)t * hop + n] = e;
      bW[m * N + bitrev(n, logN)] = make_float2(0.f, 0.f);
      bW[m * N + bitrev(hop + n, logN)] = make_float2(e, 0.f);
      bA[m * N + bitrev(n, logN)] = make_float2(Eprev[i], 0.f);
      bA[m * N + bitrev(hop + n, logN)] = make_float2(e, 0.f);
      Eprev[i] = e;
    }
    for (int i = tid; i < M * N; i += kThreads) {
      const int m = i >> logN, n = i & (N - 1);
      bWa[m * N + bitrev(n, logN)] = make_float2(n < Lf ? Waic[m * Lf + n] : 0.f, 0.f);
    }
    __syncthreads();
    fft_stages(bW, 3 * M, N, logN, tw, false);  // E_bm, the AIC inputs and tap spectra

    // ---- per bin: the BM gradients; the AIC output and power
    for (int k = tid; k < F; k += kThreads) {
      const float2 X = bX[k];
      const float P = Pbm[k];
      float2 Y = make_float2(0.f, 0.f);
      float pw = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        put_grad(bY + m * N, k, N, logN, X, bW[m * N + k], P);
        const float2 Za = bA[m * N + k], y = cmulf(Za, bWa[m * N + k]);
        Y = make_float2(Y.x + y.x, Y.y + y.y);
        pw = pw + (Za.x * Za.x + Za.y * Za.y);
      }
      Paic[k] = fmaxf(prm.aic_alpha * Paic[k] + prm.aic_one_m_alpha * pw, 1e-4f);
      put_half(bY + M * N, k, N, logN, Y.x, Y.y);
    }
    __syncthreads();
    fft_stages(bY, M + 1, N, logN, tw, true);

    // ---- the BM update (the first Lf taps), CCAF-clamped; the AIC error
    for (int i = tid; i < M * Lf; i += kThreads) {
      const int m = i >> (logN - 1), n = i & (Lf - 1);
      Wbm[i] = fminf(fmaxf(Wbm[i] + prm.bm_mu * (bY[m * N + n].x * invN), -0.001f), ub[n]);
    }
    for (int n = tid; n < hop; n += kThreads) {
      const float e = ab[(size_t)t * hop + n] - bY[M * N + hop + n].x * invN;
      ob[(size_t)t * hop + n] = e;
      bX[bitrev(n, logN)] = make_float2(0.f, 0.f);
      bX[bitrev(hop + n, logN)] = make_float2(e, 0.f);
    }
    __syncthreads();
    fft_stages(bX, 1, N, logN, tw, false);

    // ---- per bin: the AIC gradients and the norm of the updated filter
    float nrm[1] = {0.f};
    for (int k = tid; k < F; k += kThreads) {
      const float2 E = bX[k];
      const float P = Paic[k];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float2 Za = bA[m * N + k], Wa = bWa[m * N + k];
        const float gr = (Za.x * E.x + Za.y * E.y) / P, gi = (Za.x * E.y - Za.y * E.x) / P;
        put_half(bY + m * N, k, N, logN, gr, gi);
        const float nr = Wa.x + step * gr, ni = Wa.y + step * gi;
        nrm[0] += nr * nr + ni * ni;
      }
    }
    block_sum<1>(nrm, red);
    const float norm = nrm[0] / (float)N / (float)N;
    const float scale = norm > prm.maxnorm ? sqrtf(prm.maxnorm / fmaxf(norm, 1e-30f)) : 1.f;
    fft_stages(bY, M, N, logN, tw, true);
    for (int i = tid; i < M * Lf; i += kThreads) {
      const int m = i >> (logN - 1), n = i & (Lf - 1);
      Waic[i] = (Waic[i] + step * (bY[m * N + n].x * invN)) * scale;
    }
    __syncthreads();
  }
}

template <int M>
cudaError_t launch(const float* fbf, const float* dbm, const float* daic, const float* yp, const float* tabs,
                   float* out, float* p, float* bm, int B, int T, int Lf, int logN, const FdgscParams& prm,
                   cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(M, Lf);
  const cudaError_t e = allow_smem(fdgsc_kernel<M>, smem);
  if (e != cudaSuccess) return e;
  fdgsc_kernel<M><<<B, kThreads, smem, st>>>(fbf, dbm, daic, yp, tabs, out, p, bm, T, Lf, logN, prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// M (mics) in 2, 4, 8; Lf a power of two >= 128 (the p pinning reads bins 32..127).
cudaError_t fused_fdgsc_launch(const void* fbf, const void* dbm, const void* daic, const void* yp, const void* tabs,
                               void* out, void* p, void* bm, int M, int B, int T, int Lf, const void* params,
                               void* stream) {
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
    case 4: return launch<4>(ff, df, af, yf, tf, of, pf, bf, B, T, Lf, logN, prm, st);
    case 8: return launch<8>(ff, df, af, yf, tf, of, pf, bf, B, T, Lf, logN, prm, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* fdgsc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
