// The MCRA lane kernel: MCRA noise tracking over a whole spectrogram, and
// its C launcher.
//
// Not a TPU kernel: distantspeech_tpu/noise/mcra.py runs mcra_run as one
// lax.scan over frames (mcra.py:145, :161), which XLA keeps on the device.
// The port's counterpart of that scan is this kernel: noise.mcra.mcra_run
// launches it on a CUDA tensor, and its plain version is
// noise.mcra.mcra_run_plain, the per-frame loop of mcra_step.
//
// Design.  One thread per lane (one (utterance, bin) pair, lane l is bin
// l % F) runs every frame with the five MCRA state values in registers:
// mcra_frame of enhance_lane.cuh, the recursion the fused flagship kernels
// run per lane, with the counters ell / frm_cnt in closed form.  The 3-tap
// smoothing over bins couples neighbouring lanes but depends on the input
// power alone, so the wrapper computes it for every frame as one tensor
// operation and passes it in.  Inputs are [T, NL] with the lane index
// contiguous: a warp reads 32 neighbouring floats a frame.
//
// What bounds it on an H100: bytes.  Each lane-frame reads the power and
// its smoothing and writes lambda_d, p (and S / Smin with return_sr), 16-20
// bytes for ~25 float32 operations.  At the `pallas` path's size (T = 500,
// B = 64, F = 129) that is ~83 MB, ~0.025 ms at 3.35 TB/s.  Built without
// fused multiply-adds (ops/_build.py), so each operation rounds as the plain
// version's elementwise tensor operations do and the thresholded decision
// S / Smin > delta_s sees the same values.
#include <cuda_runtime.h>

#include "enhance_lane.cuh"

namespace {

constexpr int kThreads = 128;

// y, sf [T, NL] -> lam, p [T, NL]; sr [T, NL] unless null
__global__ void __launch_bounds__(kThreads) mcra_kernel(const float* __restrict__ y, const float* __restrict__ sf,
                                                        float* __restrict__ lam, float* __restrict__ p,
                                                        float* __restrict__ sr, int T, int NL, int F,
                                                        McraParams mc) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= NL) return;
  const BinKind bk = bin_kind(l % F, F);
  McraLane s{0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < T; ++t) {
    const size_t i = (size_t)t * NL + l;
    float lm, r;
    p[i] = mcra_frame(s, t, y[i], sf[i], bk, mc, lm, r);
    lam[i] = lm;
    if (sr != nullptr) sr[i] = r;
  }
}

}  // namespace

extern "C" {

// sr null: lambda_d and p only.
cudaError_t mcra_launch(const void* y, const void* sf, void* lam, void* p, void* sr, int T, int NL, int F,
                        const void* params, void* stream) {
  if (T < 1 || NL < 1 || F < 2 || NL % F != 0) return cudaErrorInvalidValue;
  const McraParams mc = *static_cast<const McraParams*>(params);
  const int blocks = (NL + kThreads - 1) / kThreads;
  mcra_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(sf), static_cast<float*>(lam), static_cast<float*>(p),
      static_cast<float*>(sr), T, NL, F, mc);
  return cudaGetLastError();
}

const char* mcra_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
