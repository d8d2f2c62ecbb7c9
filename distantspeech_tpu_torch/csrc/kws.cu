// Kernel K6: the dual-mic KWS cleaner's frame loop, and its C launcher.
//
// Replaces distantspeech_tpu/ops/pallas_flms.py fused_kws (_kws_kernel): a
// continuously adapting single-channel FLMS ANC (mic 0 -> mic 1, 2 mu
// step, taps held in time domain so the gradient constraint is a mask)
// whose taps a frozen cleaner applies Dn frames late.  The plain version is
// kws_frames_plain in ops/cuda_flms.py.
//
// Design.  One 256-thread block per utterance runs the whole frame loop.
// The taps and the FLMS power live in shared memory; the tap FIFO (Dn = 94
// slots x 256 taps = 96 KB at the default 1.5 s defer) would cap the
// blocks per SM at two if it were held there too, so it is a zero-filled
// global scratch [B, Dn, Lf] from the wrapper, indexed circularly by frame:
// slot t % Dn is read (the taps pushed Dn frames ago, zeros until it has
// wrapped) before this frame's taps are written to it.  Each tap is read and
// written by the same thread, so no barrier orders the two.  Per frame, 7
// 512-point FFTs in 4 batched passes (flms_lane.cuh): the x0 analysis with
// the ANC and cleaner tap spectra; the ANC and cleaner outputs; the error
// spectrum; the constrained gradient back to taps.
//
// What bounds it on an H100 (B = 128, 4 s): operations, 7 transforms per
// utterance and frame, and more than those the latency of ~40 barriers per
// frame with one block of 8 warps per utterance on 132 SMs.  The FIFO's
// traffic (2 KB per utterance and frame) stays in L2.
#include <cuda_runtime.h>

#include "flms_lane.cuh"

// Field order and types are mirrored by _KwsParams in ops/cuda_flms.py.
struct KwsParams {
  float alpha, one_m_alpha, mu2;  // FLMS power pole, 2 mu
};

namespace {

// Shared memory in floats; the kernel carves it in this order.
size_t smem_floats(int Lf) {
  const size_t N = 2 * Lf, F = Lf + 1;
  return 6 * N * 2 + N + Lf + F;
}

// x0, d [B, T*Lf] (d: mic 1 delayed by Lf/2), tabs [N/2 twiddles as
// (cos, sin)], fifo [B, Dn, Lf] zeroed -> out [B, T*Lf]
__global__ void __launch_bounds__(kThreads) kws_kernel(const float* __restrict__ x0, const float* __restrict__ d,
                                                       const float* __restrict__ tabs, float* fifo,
                                                       float* __restrict__ out, int T, int Lf, int logN, int Dn,
                                                       KwsParams prm) {
  extern __shared__ float4 smem4[];
  const int N = 2 * Lf, hop = Lf, F = Lf + 1;
  const int tid = threadIdx.x;
  const size_t S = (size_t)T * hop;
  float2* Xb = reinterpret_cast<float2*>(smem4);  // [N] x0 analysis
  float2* Wz = Xb + N;                            // [N] ANC tap spectrum
  float2* Wf = Wz + N;                            // [N] cleaner (deferred) tap spectrum
  float2* Yb = Wf + N;                            // [2][N] ANC and cleaner outputs, then the gradient
  float2* Eb = Yb + 2 * N;                        // [N] error spectrum
  float2* tw = Eb + N;                            // [N/2]
  float* w = reinterpret_cast<float*>(tw + N / 2);  // [Lf] ANC taps
  float* Pw = w + Lf;                             // [F] FLMS power

  const float* xb = x0 + blockIdx.x * S;
  const float* db = d + blockIdx.x * S;
  float* ob = out + blockIdx.x * S;
  float* fb = fifo + (size_t)blockIdx.x * Dn * Lf;
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kThreads) tw[i] = twg[i];
  for (int i = tid; i < Lf; i += kThreads) w[i] = 0.f;
  for (int k = tid; k < F; k += kThreads) Pw[k] = 0.f;
  const float invN = 1.f / (float)N;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float* slot = fb + (size_t)(t % Dn) * Lf;
    // ---- load: [x0_{t-1}, x0_t], the ANC taps and the deferred taps, bit-reversed
    for (int i = tid; i < N; i += kThreads) {
      const int r = bitrev(i, logN);
      const float x = i < hop ? (t > 0 ? xb[(size_t)(t - 1) * hop + i] : 0.f) : xb[(size_t)t * hop + i - hop];
      Xb[r] = make_float2(x, 0.f);
      Wz[r] = make_float2(i < Lf ? w[i] : 0.f, 0.f);
      Wf[r] = make_float2(i < Lf ? slot[i] : 0.f, 0.f);
    }
    __syncthreads();
    fft_stages(Xb, 3, N, logN, tw, false);  // X, Wz, Wf

    // ---- per bin: FLMS power, the ANC and cleaner outputs
    for (int k = tid; k < F; k += kThreads) {
      const float2 X = Xb[k];
      Pw[k] = fmaxf(prm.alpha * Pw[k] + prm.one_m_alpha * (X.x * X.x + X.y * X.y), 1e-4f);
      const float2 Y = cmulf(X, Wz[k]), C = cmulf(X, Wf[k]);
      put_half(Yb, k, N, logN, Y.x, Y.y);
      put_half(Yb + N, k, N, logN, C.x, C.y);
    }
    __syncthreads();
    fft_stages(Yb, 2, N, logN, tw, true);

    // ---- the last hop of each inverse: ANC error, cleaned output; error spectrum input [0; e]
    for (int n = tid; n < hop; n += kThreads) {
      const float dn = db[(size_t)t * hop + n];
      const float e = dn - Yb[hop + n].x * invN;
      ob[(size_t)t * hop + n] = dn - Yb[N + hop + n].x * invN;
      Eb[bitrev(n, logN)] = make_float2(0.f, 0.f);
      Eb[bitrev(hop + n, logN)] = make_float2(e, 0.f);
    }
    __syncthreads();
    fft_stages(Eb, 1, N, logN, tw, false);

    // ---- per bin: the gradient conj(X) E / P
    for (int k = tid; k < F; k += kThreads) put_grad(Yb, k, N, logN, Xb[k], Eb[k], Pw[k]);
    __syncthreads();
    fft_stages(Yb, 1, N, logN, tw, true);

    // ---- constrained update (the first Lf samples) and the push into the FIFO
    for (int n = tid; n < Lf; n += kThreads) {
      const float wn = w[n] + prm.mu2 * (Yb[n].x * invN);
      w[n] = wn;
      slot[n] = wn;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

cudaError_t fused_kws_launch(const void* x0, const void* d, const void* tabs, void* fifo, void* out, int B, int T,
                             int Lf, int Dn, const void* params, void* stream) {
  const int logN = log2_of_twice(Lf);
  if (logN < 0 || B < 1 || T < 1 || Dn < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(Lf);
  const cudaError_t e = allow_smem(kws_kernel, smem);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kws_kernel<<<B, kThreads, smem, st>>>(static_cast<const float*>(x0), static_cast<const float*>(d),
                                        static_cast<const float*>(tabs), static_cast<float*>(fifo),
                                        static_cast<float*>(out), T, Lf, logN, Dn,
                                        *static_cast<const KwsParams*>(params));
  return cudaGetLastError();
}

const char* kws_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
