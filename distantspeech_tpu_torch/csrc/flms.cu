// Kernel K5: the fused time-domain GSC frame loop, and its C launcher.
//
// Replaces distantspeech_tpu/ops/pallas_flms.py fused_tdgsc: _tdgsc_kernel
// (kPF = false: MCRA on the fixed-beamformer power gates a non-causal
// multichannel overlap-save FLMS canceller) and _tdgsc_pf_kernel (kPF =
// true: the same, then the OM-LSA-multi postfilter on the canceller output:
// windowed STFT, 1 + C MCRA trackers, the TBRR absence probability and the
// decision-directed gain, sqrt(G), windowed ISTFT overlap-add).  The plain
// version is tdgsc_frames_plain in ops/cuda_flms.py.
//
// Design.  One 256-thread block per utterance runs the whole frame loop;
// all state lives in shared memory: the C filters as Lf time-domain taps
// (so the gradient constraint and fir_truncate are masks), the FLMS power
// and the MCRA state per bin, and with the postfilter the (1 + C) MCRA
// trackers, the OM-LSA carries and the overlap-add tail.  All F = Lf + 1
// bins are uniform lanes (the TPU kernel's Nyquist packing is not needed).
// The TPU kernel's per-frame transforms are dots against [512, 512] DFT
// matrices (1 MB each, more than a block's shared memory); here each one is
// a 512-point radix-2 FFT in shared memory (flms_lane.cuh), a real signal as
// a complex FFT with zero imaginary part, a half spectrum through its
// hermitian extension.  Per frame: the C analyses of the blocking-matrix
// buffers and the C tap spectra (one batched pass), the inverse for the output, the
// error spectrum, the C inverse gradients (constraint), their C forward
// transforms, and the C inverse gated updates; with the postfilter also the
// windowed analysis (batched with the error spectrum) and the synthesis
// (batched with the gradients).  Twiddles and the window come from the
// host with the exact zeros of sin and cos kept exact, so bins 0 and N/2 of
// a real signal stay real.
//
// What bounds it on an H100 (B = 128, M = 4, 4 s): operations, ~17 (19 with
// the postfilter) 512-point transforms per utterance and frame against a
// few MB of input; and more than either, the latency of its ~60 barriers
// per frame, with 128 blocks of 8 warps on 132 SMs.  This first version
// takes one butterfly per thread per stage and makes no attempt at bank
// conflicts or at packing two real transforms into one complex FFT.
#include <cuda_runtime.h>

#include "flms_lane.cuh"

// Field order and types are mirrored by _TdgscParams in ops/cuda_flms.py.
struct TdgscParams {
  McraParams mc, om;  // the TDGSC's MCRA (on the FBF power) and OM-LSA's
  float b0, b1, b2, ob0, ob1, ob2;  // their cross-bin smoothing taps
  float alpha, one_m_alpha, mu2;    // FLMS power pole, 2 mu
  int ft, vad_guard;
  float o_alpha_s, o_one_m_alpha_s, o_alpha_d, o_one_m_alpha_d, o_alpha_xi, o_one_m_alpha_xi;
  float o_beta, o_bmin, o_eps, o_gh, o_gh_gl, o_gl, o_oh, o_oh_ol, o_ol, o_qmin, o_qmax;
  float o_gmin, o_log_gmin, syn_gain;
};

namespace {

// Shared memory in floats; the kernel carves it in this order.
size_t smem_floats(int C, int Lf, bool pf) {
  const size_t N = 2 * Lf, F = Lf + 1, hop = Lf;
  size_t n = (2 * C + 2) * N * 2 + N + C * Lf + F + 5 * F + F + F + hop;
  if (pf) n += N + 2 * hop + (1 + C) * F + 2 * F + 5 * (1 + C) * F + F + C * F + 3 * F;
  return n;
}

// bm [B, C, T*Lf], d [B, T*Lf], yp [B, T, F], up [B, C, T, F] (kPF),
// tabs [N/2 twiddles as (cos, sin) | N window] -> out [B, T*Lf], p [B, T, F]
template <int C, bool kPF>
__global__ void __launch_bounds__(kThreads) tdgsc_kernel(const float* __restrict__ bm, const float* __restrict__ d,
                                                         const float* __restrict__ yp, const float* __restrict__ up,
                                                         const float* __restrict__ tabs, float* __restrict__ out,
                                                         float* __restrict__ pout, int T, int Lf, int logN,
                                                         TdgscParams prm) {
  extern __shared__ float4 smem4[];
  const int N = 2 * Lf, hop = Lf, F = Lf + 1;
  const int tid = threadIdx.x;
  const size_t S = (size_t)T * hop;
  float2* Xb = reinterpret_cast<float2*>(smem4);  // [C][N] BM spectra, then the constrained gradients
  float2* Wb = Xb + C * N;                         // [C][N] tap spectra, then gradients / updates
  float2* Pb = Wb + C * N;                         // [N] postfilter analysis and synthesis (after Wb)
  float2* Eb = Pb + N;                             // [N] output inverse, then the error spectrum
  float2* tw = Eb + N;                             // [N/2]
  float* wt = reinterpret_cast<float*>(tw + N / 2);  // [C][Lf] taps
  float* Pw = wt + C * Lf;                         // [F] FLMS power
  float* ms = Pw + F;                              // [5][F] MCRA S, Smin, Stmp, P, Lam
  float* gate = ms + 5 * F;                        // [F] per-bin step gate
  float* fp = gate + F;                            // [F] this frame's FBF power
  float* esm = fp + F;                             // [hop] this frame's canceller output
  float* win = esm + hop;                          // postfilter: [N] window
  float* prev = win + N;                           // [hop] previous canceller output block
  float* ola = prev + hop;                         // [hop] overlap-add tail
  float* pw = ola + hop;                           // [1+C][F] beam and reference powers
  float* ybr = pw + (1 + C) * F;                   // [F] beam spectrum
  float* ybi = ybr + F;                            // [F]
  float* oms = ybi + F;                            // [5][1+C][F] OM-LSA's MCRA trackers
  float* zY = oms + 5 * (1 + C) * F;               // [F] zeta_Y
  float* zU = zY + F;                              // [C][F] zeta_U
  float* olam = zU + C * F;                        // [F] noise PSD
  float* ogam = olam + F;                          // [F] gamma carry
  float* ogh1 = ogam + F;                          // [F] G_H1 carry

  const float* bmb = bm + (size_t)blockIdx.x * C * S;
  const float* db = d + (size_t)blockIdx.x * S;
  float* ob = out + (size_t)blockIdx.x * S;
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kThreads) tw[i] = twg[i];
  for (int i = tid; i < C * Lf; i += kThreads) wt[i] = 0.f;
  for (int i = tid; i < 6 * F; i += kThreads) Pw[i] = 0.f;  // Pw and the MCRA state
  if (kPF) {
    for (int i = tid; i < N; i += kThreads) win[i] = tabs[N + i];
    for (int i = tid; i < 2 * hop; i += kThreads) prev[i] = 0.f;  // prev and ola
    for (int i = tid; i < 5 * (1 + C) * F; i += kThreads) oms[i] = 0.f;
    for (int k = tid; k < F; k += kThreads) {
      zY[k] = 1.f;
      olam[k] = 0.f;
      ogam[k] = ogh1[k] = 1.f;
    }
    for (int i = tid; i < C * F; i += kThreads) zU[i] = 0.f;
  }
  const float invN = 1.f / (float)N;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- load: BM buffers [b_{t-1}, b_t] and taps, bit-reversed; powers
    for (int i = tid; i < C * N; i += kThreads) {
      const int c = i >> logN, n = i & (N - 1);
      const float* src = bmb + (size_t)c * S;
      const float x = n < hop ? (t > 0 ? src[(size_t)(t - 1) * hop + n] : 0.f) : src[(size_t)t * hop + n - hop];
      const int r = c * N + bitrev(n, logN);
      Xb[r] = make_float2(x, 0.f);
      Wb[r] = make_float2(n < Lf ? wt[c * Lf + n] : 0.f, 0.f);
    }
    for (int k = tid; k < F; k += kThreads) fp[k] = yp[((size_t)blockIdx.x * T + t) * F + k];
    if (kPF) {
      for (int i = tid; i < C * F; i += kThreads) {
        const int c = i / F, k = i - c * F;
        pw[(1 + c) * F + k] = up[(((size_t)blockIdx.x * C + c) * T + t) * F + k];
      }
    }
    __syncthreads();
    fft_stages(Xb, 2 * C, N, logN, tw, false);  // X_c and W_c

    // ---- per bin: MCRA and the step gate, filter output, FLMS power
    for (int k = tid; k < F; k += kThreads) {
      const BinKind bk = bin_kind(k, F);
      McraLane m = load_mcra(ms, F, k);
      const float Sf = prm.b0 * fp[k > 0 ? k - 1 : 0] + prm.b1 * fp[k] + prm.b2 * fp[k < F - 1 ? k + 1 : F - 1];
      float lam, sr;
      const float p = mcra_frame(m, t, fp[k], Sf, bk, prm.mc, lam, sr);
      store_mcra(ms, F, k, m);
      pout[((size_t)blockIdx.x * T + t) * F + k] = p;
      float g = 1.f - p;
      if (prm.vad_guard) g = g * (sr <= prm.mc.delta_s ? 1.f : 0.f);
      gate[k] = g;
      float yr = 0.f, yi = 0.f, pwr = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 X = Xb[c * N + k], W = Wb[c * N + k];
        yr = yr + (X.x * W.x - X.y * W.y);
        yi = yi + (X.x * W.y + X.y * W.x);
        pwr = pwr + (X.x * X.x + X.y * X.y);
      }
      Pw[k] = fmaxf(prm.alpha * Pw[k] + prm.one_m_alpha * pwr, 1e-4f);
      put_half(Eb, k, N, logN, yr, yi);
    }
    __syncthreads();
    fft_stages(Eb, 1, N, logN, tw, true);

    // ---- canceller output: the last hop of the inverse, from the delayed FBF
    for (int n = tid; n < hop; n += kThreads) {
      const float e = db[(size_t)t * hop + n] - Eb[hop + n].x * invN;
      esm[n] = e;
      if (!kPF) ob[(size_t)t * hop + n] = e;
    }
    __syncthreads();
    // ---- error spectrum input [0; e]; postfilter analysis input w [prev; e]
    for (int n = tid; n < N; n += kThreads) {
      const int r = bitrev(n, logN);
      Eb[r] = make_float2(n < hop ? 0.f : esm[n - hop], 0.f);
      if (kPF) Pb[r] = make_float2(win[n] * (n < hop ? prev[n] : esm[n - hop]), 0.f);
    }
    __syncthreads();
    if (kPF)
      fft_stages(Pb, 2, N, logN, tw, false);  // Pb and Eb are adjacent
    else
      fft_stages(Eb, 1, N, logN, tw, false);

    // ---- per bin: gradients conj(X_c) E / P; beam spectrum and power
    for (int k = tid; k < F; k += kThreads) {
      const float2 E = Eb[k];
      const float P = Pw[k];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 X = Xb[c * N + k];
        put_half(Wb + c * N, k, N, logN, (X.x * E.x + X.y * E.y) / P, (X.x * E.y - X.y * E.x) / P);
      }
      if (kPF) {
        const float2 Y = Pb[k];
        ybr[k] = Y.x;
        ybi[k] = Y.y;
        pw[k] = Y.x * Y.x + Y.y * Y.y;
      }
    }
    __syncthreads();

    if (kPF) {
      for (int n = tid; n < hop; n += kThreads) prev[n] = esm[n];
      // ---- OM-LSA-multi: 1 + C MCRA trackers, TBRR q, gain; sqrt(G) Y
      const bool first = t == 0;
      for (int k = tid; k < F; k += kThreads) {
        const BinKind bk = bin_kind(k, F);
        float mu[1 + C];
#pragma unroll
        for (int m = 0; m <= C; ++m) {
          const float* row = pw + m * F;
          const float Sf = prm.ob0 * row[k > 0 ? k - 1 : 0] + prm.ob1 * row[k] + prm.ob2 * row[k < F - 1 ? k + 1 : F - 1];
          McraLane st = load_mcra(oms, (1 + C) * F, m * F + k);
          float sr;
          mcra_frame(st, t, row[k], Sf, bk, prm.om, mu[m], sr);
          store_mcra(oms, (1 + C) * F, m * F + k, st);
        }
        const float y = pw[k];
        const float zy = first ? y : prm.o_alpha_s * zY[k] + prm.o_one_m_alpha_s * smooth_zero(pw, k, F);
        zY[k] = zy;
        float ref_max = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float* row = pw + (1 + c) * F;
          const float zu = first ? row[k] : prm.o_alpha_s * zU[c * F + k] + prm.o_one_m_alpha_s * smooth_zero(row, k, F);
          zU[c * F + k] = zu;
          ref_max = c == 0 ? zu - mu[1 + c] : fmaxf(ref_max, zu - mu[1 + c]);
        }
        float omega = fmaxf(zy - mu[0], 1e-6f) / (fmaxf(ref_max, prm.o_eps * mu[0]) + 1e-6f);
        omega = fminf(fmaxf(omega, 0.1f), 100.f);
        const float gamma_s = fminf(y / (mu[0] * prm.o_bmin + 1e-6f), 100.f);
        const float q_cand = fmaxf((prm.o_gh - gamma_s) / prm.o_gh_gl, (prm.o_oh - omega) / prm.o_oh_ol);
        const bool absent = gamma_s < prm.o_gl || omega < prm.o_ol;
        const float q = fminf(fmaxf(absent ? 1.f : q_cand, prm.o_qmin), prm.o_qmax);
        const float gam = y / fmaxf(olam[k], 1e-10f);
        const float xi = prm.o_alpha_xi * (ogh1[k] * ogh1[k]) * ogam[k] + prm.o_one_m_alpha_xi * fmaxf(gam - 1.f, 0.f);
        const float nu = gam * xi / (1.f + xi);
        const float GH1 = xi / (1.f + xi);
        const float pp = 1.f / (1.f + q / (1.f - q) * (1.f + xi) * expf(-nu));
        const float a_t = prm.o_alpha_d + prm.o_one_m_alpha_d * pp;
        float sg = 1.f;  // the first frame only seeds the state: G = 1
        if (first) {
          olam[k] = y;
        } else {
          olam[k] = a_t * olam[k] + prm.o_beta * (1.f - a_t) * y;
          const float logG = pp * logf(fmaxf(GH1, 1e-30f)) + (1.f - pp) * prm.o_log_gmin;
          sg = sqrtf(fminf(fmaxf(expf(logG), prm.o_gmin), 1.f));
          ogam[k] = gam;
          ogh1[k] = GH1;
        }
        put_half(Pb, k, N, logN, sg * ybr[k], sg * ybi[k]);
      }
      __syncthreads();
    }
    fft_stages(Wb, kPF ? C + 1 : C, N, logN, tw, true);  // gradients (and the postfiltered beam in Pb)

    // ---- gradient constraint: keep the first Lf samples; postfilter synthesis
    for (int i = tid; i < C * N; i += kThreads) {
      const int c = i >> logN, n = i & (N - 1);
      Xb[c * N + bitrev(n, logN)] = make_float2(n < Lf ? Wb[c * N + n].x * invN : 0.f, 0.f);
    }
    if (kPF) {
      for (int n = tid; n < hop; n += kThreads) {
        const float f0 = Pb[n].x * invN * win[n] * prm.syn_gain;
        const float f1 = Pb[n + hop].x * invN * win[n + hop] * prm.syn_gain;
        ob[(size_t)t * hop + n] = f0 + ola[n];
        ola[n] = f1;
      }
    }
    __syncthreads();
    fft_stages(Xb, C, N, logN, tw, false);

    // ---- per-bin gate, back to taps, update and fir_truncate
    for (int k = tid; k < F; k += kThreads) {
      const float g = gate[k];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 G = Xb[c * N + k];
        put_half(Wb + c * N, k, N, logN, G.x * g, G.y * g);
      }
    }
    __syncthreads();
    fft_stages(Wb, C, N, logN, tw, true);
    for (int i = tid; i < C * Lf; i += kThreads) {
      const int c = i / Lf, n = i - c * Lf;
      const float w_new = wt[i] + prm.mu2 * (Wb[c * N + n].x * invN);
      wt[i] = (n >= prm.ft && n < Lf - prm.ft) ? w_new : 0.f;
    }
    __syncthreads();
  }
}

template <int C, bool kPF>
cudaError_t launch(const float* bm, const float* d, const float* yp, const float* up, const float* tabs, float* out,
                   float* p, int B, int T, int Lf, int logN, const TdgscParams& prm, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(C, Lf, kPF);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(tdgsc_kernel<C, kPF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  tdgsc_kernel<C, kPF><<<B, kThreads, smem, st>>>(bm, d, yp, up, tabs, out, p, T, Lf, logN, prm);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(const float* bm, const float* d, const float* yp, const float* up, const float* tabs,
                     float* out, float* p, int B, int T, int Lf, int logN, const TdgscParams& prm, cudaStream_t st) {
  if (up != nullptr) return launch<C, true>(bm, d, yp, up, tabs, out, p, B, T, Lf, logN, prm, st);
  return launch<C, false>(bm, d, yp, up, tabs, out, p, B, T, Lf, logN, prm, st);
}

}  // namespace

extern "C" {

// up null: the core kernel; else the postfilter variant.
cudaError_t fused_tdgsc_launch(const void* bm, const void* d, const void* yp, const void* up, const void* tabs,
                               void* out, void* p, int C, int B, int T, int Lf, const void* params, void* stream) {
  int logN = 1;
  while ((1 << logN) < 2 * Lf) ++logN;
  if (Lf < 2 || (1 << logN) != 2 * Lf || logN > 12 || B < 1 || T < 1) return cudaErrorInvalidValue;
  const TdgscParams prm = *static_cast<const TdgscParams*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bm);
  const float* df = static_cast<const float*>(d);
  const float* yf = static_cast<const float*>(yp);
  const float* uf = static_cast<const float*>(up);
  const float* tf = static_cast<const float*>(tabs);
  float* of = static_cast<float*>(out);
  float* pf = static_cast<float*>(p);
  switch (C) {
    case 1: return launch_c<1>(bf, df, yf, uf, tf, of, pf, B, T, Lf, logN, prm, st);
    case 3: return launch_c<3>(bf, df, yf, uf, tf, of, pf, B, T, Lf, logN, prm, st);
    case 7: return launch_c<7>(bf, df, yf, uf, tf, of, pf, B, T, Lf, logN, prm, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* flms_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
