// Kernel K1: the gated MVDR frame loop of the `pallas` backend, with the
// OM-LSA gain optionally fused in, and its C launcher.
//
// Replaces distantspeech_tpu/ops/pallas_mvdr.py pallas_mvdr_scan
// (_mvdr_kernel and _mvdr_omlsa_kernel).  Spectra Z [T, B, F, M] complex64,
// the covariance gate [T, B, F] and, with the gain, the MCRA tracks p and
// lambda_d [T, B, F] come in; Y [T, B, F] complex64 goes out.  One thread
// runs one (utterance, bin) lane through every frame with the lane state in
// registers; the update, LDL^H solve, output and gain are the device
// functions of enhance_lane.cuh, shared with the fused_enhance kernels.  A
// closed gate skips the update, which holds the state exactly as the
// plain version's select does.  The ragged last block is masked; there is
// no padding.
//
// What bounds it on an H100 (B = 64, M = 8, 4 s): bytes (~350 MB of spectra,
// gate and tracks in and the output out, against ~5e9 float32 operations).
// This first version makes no attempt at the bound: each thread reads its
// lane's M complex values as M float2 loads at a stride of M * 8 bytes from
// its neighbour's, and the M = 8 lane state takes most of the register file.
#include <cuda_runtime.h>

#include "enhance_lane.cuh"

namespace {

constexpr int kThreads = 128;

// z [T, B*F, M] float2, gate / p / lam [T, B*F], steer [F, M] float2
// -> y [T, B*F] float2
template <int M, bool kGain>
__global__ void __launch_bounds__(kThreads) fused_mvdr_scan_kernel(const float2* __restrict__ z,
                                                                  const float* __restrict__ gate,
                                                                  const float* __restrict__ p,
                                                                  const float* __restrict__ lam,
                                                                  const float2* __restrict__ steer,
                                                                  float2* __restrict__ y, int T, int NL, int F,
                                                                  LaneParams lp) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= NL) return;
  const int k = lane % F;
  float ar[M], ai[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float2 a = steer[k * M + m];
    ar[m] = a.x;
    ai[m] = a.y;
  }
  Lane<M> s;
  lane_init<M>(s);
  for (int t = 0; t < T; ++t) {
    const size_t idx = (size_t)t * NL + lane;
    const float2* zt = z + idx * M;
    float zr[M], zi[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float2 v = zt[m];
      zr[m] = v.x;
      zi[m] = v.y;
    }
    if (gate[idx] > 0.5f) mvdr_update_ldl<M>(s, zr, zi, ar, ai, lp);
    float2 out = mvdr_output<M>(zr, zi, ar, ai, s.Ur, s.Ui);
    if (kGain) out = omlsa_gain<M>(s, out, p[idx], lam[idx], lp);
    y[idx] = out;
  }
}

template <int M>
cudaError_t launch(const float2* z, const float* gate, const float* p, const float* lam, const float2* steer,
                   float2* y, int T, int NL, int F, const LaneParams& lp, cudaStream_t st) {
  const int blocks = (NL + kThreads - 1) / kThreads;
  if (p != nullptr)
    fused_mvdr_scan_kernel<M, true><<<blocks, kThreads, 0, st>>>(z, gate, p, lam, steer, y, T, NL, F, lp);
  else
    fused_mvdr_scan_kernel<M, false><<<blocks, kThreads, 0, st>>>(z, gate, p, lam, steer, y, T, NL, F, lp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// M (mics) 2 to 8; p and lam null: no gain.
cudaError_t fused_mvdr_scan_launch(const void* z, const void* gate, const void* p, const void* lam,
                                   const void* steer, void* y, int M, int T, int B, int F, const void* params,
                                   void* stream) {
  const LaneParams lp = *static_cast<const LaneParams*>(params);
  if ((p == nullptr) != (lam == nullptr) || B * F <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* zf = static_cast<const float2*>(z);
  const float* gf = static_cast<const float*>(gate);
  const float* pf = static_cast<const float*>(p);
  const float* lf = static_cast<const float*>(lam);
  const float2* sv = static_cast<const float2*>(steer);
  float2* yf = static_cast<float2*>(y);
  switch (M) {
    case 2: return launch<2>(zf, gf, pf, lf, sv, yf, T, B * F, F, lp, st);
    case 3: return launch<3>(zf, gf, pf, lf, sv, yf, T, B * F, F, lp, st);
    case 4: return launch<4>(zf, gf, pf, lf, sv, yf, T, B * F, F, lp, st);
    case 5: return launch<5>(zf, gf, pf, lf, sv, yf, T, B * F, F, lp, st);
    case 6: return launch<6>(zf, gf, pf, lf, sv, yf, T, B * F, F, lp, st);
    case 7: return launch<7>(zf, gf, pf, lf, sv, yf, T, B * F, F, lp, st);
    case 8: return launch<8>(zf, gf, pf, lf, sv, yf, T, B * F, F, lp, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* mvdr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
