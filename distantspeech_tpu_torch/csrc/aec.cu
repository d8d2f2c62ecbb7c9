// Kernel K7: the fused speex-style AEC frame loop, and its C launcher.
//
// Replaces distantspeech_tpu/ops/pallas_aec.py fused_aec (_aec_kernel, with
// the de-emphasis of _deemph_mats): the two-path MDF echo canceller of
// adaptive/aec.py aec_step over whole utterances, M mics sharing one far
// end.  Per frame: background and foreground outputs, the speex transfer
// logic (Davg / Dvar tests), the echo-leak regression, the per-bin optimal
// step size with 3-tap smoothing, the proportionate block steps of the
// constrained gradient, and the de-emphasis IIR of the output.  The plain
// version is aec_frames_plain in ops/cuda_aec.py.
//
// Design.  One 256-thread block per (utterance, mic): B M blocks, each
// independent.  Unlike the other FLMS kernels the filters stay in the
// frequency domain (background W and foreground Fg, NB blocks x F bins):
// the per-bin mu_opt spreads tap support over the full 2L, so a tap-space
// state would not be exact.  Each block recomputes the shared far-end
// spectrum (one FFT a frame) instead of reading it from another block, and
// keeps the previous one for block b = 1 (zeros before frame 0).  Per frame,
// 4 + 2 NB 512-point FFTs (flms_lane.cuh): the far-end analysis, the two
// outputs, the error spectrum, and the gradient constraint's round trip per
// filter block.  The transfer-logic energies, the leak regression sums and
// the proportionate norms are block reductions; every thread then holds the
// same scalar state (Davg, Dvar, Ryy, Rey) in registers.  The de-emphasis
// y[n] = x[n] + 0.98 y[n-1] of the output is a block scan of the affine
// recurrence: each thread runs its R = max(1, L / 256) samples, a warp scan
// of shuffles combines the threads with the powers 0.98^k from the host,
// and the warps' totals chain through shared memory.
//
// What bounds it on an H100 (B = 128, M = 4, 4 s): operations.  The
// function needs 1 + M (3 + 2 NB) transforms per utterance-frame (the far
// end once); the kernel runs 4 + 2 NB per (utterance, mic)-frame, so the
// far end's M - 1 repeated analyses are cost above the bound.  More than
// the transforms, the latency of ~50 barriers per frame.  512 blocks of 8
// warps fill the 132 SMs about four deep.
#include <cuda_runtime.h>

#include "flms_lane.cuh"

// Field order and types are mirrored by _AecParams in ops/cuda_aec.py.
struct AecParams {
  float alpha, one_m_alpha;  // the P pole
  float gamma, one_m_gamma;  // the Py / Pe pole
  float beta0, mu_max;
};

namespace {

// Shared memory in floats; the kernel carves it in this order.
size_t smem_floats(int NB, int hop) {
  const size_t N = 2 * hop, F = hop + 1;
  return 5 * N * 2 + N + (2 + 2 * NB) * F * 2 + N + (hop + 1) + 6 * F + 3 * hop + 8 * kWarps + kWarps + 1;
}

// farp [B, T*L], xp [B, M, T*L] pre-emphasised; tabs [N/2 twiddles as
// (cos, sin) | N Hann window | L + 1 powers 0.98^k] -> out [B, M, T*L];
// upd (optional) [B, M, T] the transfer decisions as 0 / 1.
template <int NB>
__global__ void __launch_bounds__(kThreads) aec_kernel(const float* __restrict__ farp, const float* __restrict__ xp,
                                                       const float* __restrict__ tabs, float* __restrict__ out,
                                                       float* __restrict__ upd_out, int M, int T, int hop, int logN,
                                                       AecParams prm) {
  extern __shared__ float4 smem4[];
  const int N = 2 * hop, F = hop + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t S = (size_t)T * hop;
  float2* bA = reinterpret_cast<float2*>(smem4);  // [2][N] y_b / y_f inverses, then the gradients
  float2* bB = bA + 2 * N;                        // [2][N] the constrained gradients
  float2* bE = bB + 2 * N;                        // [N] far-end analysis, then the error spectrum
  float2* tw = bE + N;                            // [N/2]
  float2* Xs = tw + N / 2;                        // [2][F] far spectra of frames t, t-1 (ring)
  float2* W = Xs + 2 * F;                         // [NB][F] background filter
  float2* Fg = W + NB * F;                        // [NB][F] foreground filter
  float* win = reinterpret_cast<float*>(Fg + NB * F);  // [N] Hann window
  float* apow = win + N;                          // [L+1] 0.98^k
  float* P = apow + hop + 1;                      // [F] far-end power
  float* Py = P + F;                              // [F] echo-estimate PSD
  float* Pe = Py + F;                             // [F] error PSD
  float* Ysq = Pe + F;                            // [F] |Y_b|^2
  float* Rs = Ysq + F;                            // [F] |E|^2, then the smoothed step size
  float* mu = Rs + F;                             // [F] the clipped step size
  float* ybs = mu + F;                            // [L] background output
  float* yfs = ybs + hop;                         // [L] foreground output
  float* os = yfs + hop;                          // [L] near end, then the echo-free output
  float* red = os + hop;                          // [8][kWarps] reductions
  float* wl = red + 8 * kWarps;                   // [kWarps] de-emphasis warp totals
  float* memE = wl + kWarps;                      // [1] de-emphasis carry

  const int b = blockIdx.x / M;
  const float* fb = farp + b * S;
  const float* xb = xp + blockIdx.x * S;
  float* ob = out + blockIdx.x * S;
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kThreads) tw[i] = twg[i];
  for (int i = tid; i < N; i += kThreads) win[i] = tabs[N + i];
  for (int i = tid; i <= hop; i += kThreads) apow[i] = tabs[2 * N + i];
  for (int i = tid; i < (2 + 2 * NB) * F; i += kThreads) Xs[i] = make_float2(0.f, 0.f);  // Xs, W, Fg
  for (int i = tid; i < 3 * F; i += kThreads) P[i] = 0.f;  // P, Py, Pe
  if (tid == 0) *memE = 0.f;
  float Davg1 = 0.f, Davg2 = 0.f, Dvar1 = 0.f, Dvar2 = 0.f, Ryy = 1.f, Rey = 1.f;
  const float invN = 1.f / (float)N;
  const float g = prm.gamma, g1 = prm.one_m_gamma;
  const int R = hop > kThreads ? hop / kThreads : 1;  // de-emphasis samples per thread
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float2* X0 = Xs + (t & 1) * F;        // this frame's far spectrum
    float2* X1 = Xs + ((t + 1) & 1) * F;  // the previous one (zeros at t = 0)
    // ---- far-end analysis of [far_{t-1}, far_t]
    for (int i = tid; i < N; i += kThreads) {
      const float v = i < hop ? (t > 0 ? fb[(size_t)(t - 1) * hop + i] : 0.f) : fb[(size_t)t * hop + i - hop];
      bE[bitrev(i, logN)] = make_float2(v, 0.f);
    }
    __syncthreads();
    fft_stages(bE, 1, N, logN, tw, false);

    // ---- per bin: P, the background and foreground outputs, |W_b|^2 sums
    float sums[4 + NB];
#pragma unroll
    for (int j = 0; j < 4 + NB; ++j) sums[j] = 0.f;
    for (int k = tid; k < F; k += kThreads) {
      const float2 X = bE[k];
      X0[k] = X;
      float pw = X.x * X.x + X.y * X.y;
      float2 yb = cmulf(X, W[k]), yf = cmulf(X, Fg[k]);
      if (NB == 2) {
        const float2 Xp = X1[k];
        pw = pw + (Xp.x * Xp.x + Xp.y * Xp.y);
        const float2 a = cmulf(Xp, W[F + k]), c = cmulf(Xp, Fg[F + k]);
        yb = make_float2(yb.x + a.x, yb.y + a.y);
        yf = make_float2(yf.x + c.x, yf.y + c.y);
      }
      P[k] = prm.alpha * P[k] + prm.one_m_alpha * pw;
      Ysq[k] = yb.x * yb.x + yb.y * yb.y;
      put_half(bA, k, N, logN, yb.x, yb.y);
      put_half(bA + N, k, N, logN, yf.x, yf.y);
#pragma unroll
      for (int j = 0; j < NB; ++j) sums[4 + j] += W[j * F + k].x * W[j * F + k].x + W[j * F + k].y * W[j * F + k].y;
    }
    __syncthreads();
    fft_stages(bA, 2, N, logN, tw, true);

    // ---- time domain: errors, the transfer-logic energies; error spectrum input [0; e_b]
    for (int n = tid; n < hop; n += kThreads) {
      const float dn = xb[(size_t)t * hop + n];
      const float yb = bA[hop + n].x * invN, yf = bA[N + hop + n].x * invN;
      const float eb = dn - yb, ef = dn - yf, dby = yf - yb;
      ybs[n] = yb;
      yfs[n] = yf;
      os[n] = dn;
      bE[bitrev(n, logN)] = make_float2(0.f, 0.f);
      bE[bitrev(hop + n, logN)] = make_float2(eb, 0.f);
      sums[0] += ef * ef;   // Sff
      sums[1] += eb * eb;   // See
      sums[2] += dby * dby; // Dbf
      sums[3] += yb * yb;   // Syy
    }
    block_sum<4 + NB>(sums, red);
    const float Sff = sums[0], See = sums[1], Dbf = sums[2], Syy = sums[3];

    // ---- the speex transfer logic (the same in every thread)
    Davg1 = 0.6f * Davg1 + 0.4f * (Sff - See);
    Davg2 = 0.85f * Davg2 + 0.15f * (Sff - See);
    Dvar1 = 0.36f * Dvar1 + 0.16f * Sff * Dbf;
    Dvar2 = 0.7225f * Dvar2 + 0.0225f * Sff * Dbf;
    const bool upd = ((Sff - See) * fabsf(Sff - See) > Sff * Dbf) || (Davg1 * fabsf(Davg1) > 0.5f * Dvar1) ||
                     (Davg2 * fabsf(Davg2) > 0.25f * Dvar2);
    if (upd) Davg1 = Davg2 = Dvar1 = Dvar2 = 0.f;
    if (upd_out != nullptr && tid == 0) upd_out[(size_t)blockIdx.x * T + t] = upd ? 1.f : 0.f;
    fft_stages(bE, 1, N, logN, tw, false);

    // ---- per bin: the foreground copy, the leak-regression PSD tracks
    float rs[2] = {0.f, 0.f};
    for (int k = tid; k < F; k += kThreads) {
      if (upd) {
#pragma unroll
        for (int j = 0; j < NB; ++j) Fg[j * F + k] = W[j * F + k];
      }
      const float2 E = bE[k];
      const float r = E.x * E.x + E.y * E.y;
      Rs[k] = r;
      const float py = g1 * Py[k] + g * Ysq[k], pe = g1 * Pe[k] + g * r;
      Py[k] = py;
      Pe[k] = pe;
      const float Eh = r - pe, Yh = Ysq[k] - py;
      rs[0] += Yh * Yh;
      rs[1] += Eh * Yh;
    }
    block_sum<2>(rs, red);
    const float Pyy = sqrtf(rs[0]);
    const float Pey = rs[1] / (Pyy + 1e-6f);
    const float a = prm.beta0 * fminf(Syy / See, 1.f);
    Ryy = (1.f - a) * Ryy + a * Pyy;
    Rey = (1.f - a) * Rey + a * Pey;
    const float leak = Rey / (Ryy + 1e-6f);

    // ---- per bin: the optimal step size (bins 0 and 1 doubled, clipped)
    for (int k = tid; k < F; k += kThreads) {
      float m = leak * Ysq[k] / (Rs[k] + 1e-3f);
      if (k < 2) m = 2.f * m;
      mu[k] = fminf(fmaxf(m, 1e-3f), prm.mu_max);
    }
    __syncthreads();
    // ---- its zero-padded 3-tap smoothing (0.1 for the first 5 frames); the gradients
    for (int k = tid; k < F; k += kThreads) {
      Rs[k] = t < 5 ? 0.1f : smooth_zero(mu, k, F);
      const float2 E = bE[k];
      const float Pr = P[k] + 1e-6f;
      put_grad(bA, k, N, logN, X0[k], E, Pr);
      if (NB == 2) put_grad(bA + N, k, N, logN, X1[k], E, Pr);
    }
    __syncthreads();
    fft_stages(bA, NB, N, logN, tw, true);
    // ---- the gradient constraint: keep the first L samples
    for (int i = tid; i < NB * N; i += kThreads) {
      const int j = i >> logN, n = i & (N - 1);
      bB[j * N + bitrev(n, logN)] = make_float2(n < hop ? bA[j * N + n].x * invN : 0.f, 0.f);
    }
    // ---- the echo-free output before de-emphasis: the blended foreground
    for (int n = tid; n < hop; n += kThreads)
      os[n] = upd ? os[n] - (win[hop + n] * yfs[n] + win[n] * ybs[n]) : os[n] - yfs[n];
    __syncthreads();
    fft_stages(bB, NB, N, logN, tw, false);

    // ---- the proportionate update from the W before it (the sums above)
    float scale[NB];
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float p = sqrtf(sums[4 + j]);
      scale[j] = p + 0.1f * fmaxf(p, 1e-6f);
      tot = tot + scale[j];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) scale[j] = 0.99f * scale[j] / (1e-6f + tot);
    for (int k = tid; k < F; k += kThreads) {
      const float m = Rs[k];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float2 G = bB[j * N + k];
        const float s = scale[j] * m;
        W[j * F + k] = make_float2(W[j * F + k].x + s * G.x, W[j * F + k].y + s * G.y);
      }
    }

    // ---- the de-emphasis y[n] = o[n] + 0.98 y[n-1]: a block scan
    const float carry0 = *memE;
    const bool active = tid * R < hop;
    float v = 0.f;
    if (active)
      for (int r = 0; r < R; ++r) v = os[tid * R + r] + apow[1] * v;  // this thread's samples from 0
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = v + apow[R * o] * u;
    }
    if (lane == 31) wl[warp] = v;
    __syncthreads();
    float c = carry0;  // the output just before this warp's first sample
    for (int w = 0; w < warp; ++w) c = wl[w] + apow[32 * R] * c;
    const float vp = __shfl_up_sync(0xffffffffu, v, 1);
    float y = lane == 0 ? c : vp + apow[R * lane] * c;  // just before this thread's first sample
    if (active) {
      for (int r = 0; r < R; ++r) {
        y = os[tid * R + r] + apow[1] * y;
        ob[(size_t)t * hop + tid * R + r] = y;
      }
      if ((tid + 1) * R == hop) *memE = y;
    }
    __syncthreads();
  }
}

template <int NB>
cudaError_t launch(const float* farp, const float* xp, const float* tabs, float* out, float* upd, int B, int M, int T,
                   int hop, int logN, const AecParams& prm, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(NB, hop);
  const cudaError_t e = allow_smem(aec_kernel<NB>, smem);
  if (e != cudaSuccess) return e;
  aec_kernel<NB><<<B * M, kThreads, smem, st>>>(farp, xp, tabs, out, upd, M, T, hop, logN, prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// upd may be null; NB (num_block) is 1 or 2; hop (block_len) a power of two >= 32.
cudaError_t fused_aec_launch(const void* farp, const void* xp, const void* tabs, void* out, void* upd, int NB, int B,
                             int M, int T, int hop, const void* params, void* stream) {
  const int logN = log2_of_twice(hop);
  if (logN < 0 || hop < 32 || B < 1 || M < 1 || T < 1) return cudaErrorInvalidValue;
  const AecParams prm = *static_cast<const AecParams*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ff = static_cast<const float*>(farp);
  const float* xf = static_cast<const float*>(xp);
  const float* tf = static_cast<const float*>(tabs);
  float* of = static_cast<float*>(out);
  float* uf = static_cast<float*>(upd);
  switch (NB) {
    case 1: return launch<1>(ff, xf, tf, of, uf, B, M, T, hop, logN, prm, st);
    case 2: return launch<2>(ff, xf, tf, of, uf, B, M, T, hop, logN, prm, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* aec_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
