// Kernel K10: the fused SRP-PHAT angle spectrum, and its C launcher.
//
// Replaces distantspeech_tpu/ops/pallas_srp.py fused_srp_spectrum
// (_srp_kernel): out[r, a] = sum_f |sum_m conj(g[a, f, m]) y[r, f, m]| over
// whitened spectrum rows y, with the grid packed per bin as
// G[f] = [[Gr, -Gi], [Gi, Gr]] ([2M, 2 Theta]) so that [yr | yi] G[f] is
// [Re | Im] of the steered response.  The plain version is
// srp_spectrum_plain in ops/cuda_srp.py.
//
// Design.  A 256-thread block owns a tile of 64 rows x 64 angles and loops
// over the bins: per bin it stages the tile's rows [64][2M] and the bin's
// grid slice [2M][64 re | 64 im] in shared memory, and each thread forms 4
// rows x 4 angles of the product in FP32 FMAs, takes the magnitude and adds
// it to accumulators in registers, so the [rows, Theta, F] field is never
// stored.  The block takes a bin's 2M columns in chunks: up to 8 mics one
// chunk of all 2M (a template constant), above that 16 at a time.  No
// tensor cores: the JAX kernel ran at precision="highest", and TF32 would
// not meet the 1e-4 gate.
//
// What bounds it on an H100 (4,000 rows, F = 129, Theta = 360, M = 8):
// operations, 8M + 5 a (row, bin, angle); the bytes (the rows, the grid and
// the output once) are ~15x below them.  Each block rereads its rows for
// every angle tile (6 tiles at Theta = 360), from L2.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64, kAngles = 64;  // the block's tile; 4 x 4 per thread

// y [R, F, M2], G [F, M2, 2 Theta] -> out [R, Theta], M2 = 2M.  Each bin's
// M2 columns go through the block's tile kChunk at a time (one pass where
// M2 = kChunk, up to 8 mics), their terms accumulated in m order before the
// magnitude; the columns past M2 of a last, partial chunk are zeros.
template <int kChunk>
__global__ void __launch_bounds__(kThreads) srp_kernel(const float* __restrict__ y, const float* __restrict__ G,
                                                       float* __restrict__ out, int R, int F, int M2, int Theta) {
  __shared__ float ys[kRows][kChunk];
  __shared__ float gs[kChunk][2 * kAngles];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kRows, a0 = blockIdx.y * kAngles;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int f = 0; f < F; ++f) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;
    for (int m0 = 0; m0 < M2; m0 += kChunk) {
      for (int i = tid; i < kRows * kChunk; i += kThreads) {
        const int r = i / kChunk, m = i % kChunk;
        ys[r][m] = r0 + r < R && m0 + m < M2 ? y[((size_t)(r0 + r) * F + f) * M2 + m0 + m] : 0.f;
      }
      for (int i = tid; i < kChunk * 2 * kAngles; i += kThreads) {
        const int m = i / (2 * kAngles), c = i % (2 * kAngles);
        const int a = a0 + (c & (kAngles - 1));
        const int col = c < kAngles ? a : Theta + a;
        gs[m][c] = a < Theta && m0 + m < M2 ? G[((size_t)f * M2 + m0 + m) * 2 * Theta + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kChunk; ++m) {
        float yv[4], gr[4], gi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = ys[ty + 16 * i][m];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gr[j] = gs[m][tx + 16 * j];
          gi[j] = gs[m][kAngles + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(yv[i], gr[j], re[i][j]);
            im[i][j] = fmaf(yv[i], gi[j], im[i][j]);
          }
      }
      if (m0 + kChunk >= M2) {  // the bin's last chunk: its magnitudes, before the barrier
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + tx + 16 * j;
      if (a < Theta) out[(size_t)r * Theta + a] = acc[i][j];
    }
  }
}

template <int kChunk>
cudaError_t launch(const float* y, const float* G, float* out, int R, int F, int M2, int Theta, cudaStream_t st) {
  const dim3 grid((R + kRows - 1) / kRows, (Theta + kAngles - 1) / kAngles);
  srp_kernel<kChunk><<<grid, kThreads, 0, st>>>(y, G, out, R, F, M2, Theta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// M (mics) 2 or more: up to 8 the chunk is the 2M columns themselves, a
// template constant; above, 16 columns a chunk.
cudaError_t fused_srp_launch(const void* y, const void* G, void* out, int R, int F, int M, int Theta, void* stream) {
  if (R < 1 || F < 1 || Theta < 1 || M < 2) return cudaErrorInvalidValue;
  const float* yf = static_cast<const float*>(y);
  const float* gf = static_cast<const float*>(G);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 2: return launch<4>(yf, gf, of, R, F, 4, Theta, st);
    case 3: return launch<6>(yf, gf, of, R, F, 6, Theta, st);
    case 4: return launch<8>(yf, gf, of, R, F, 8, Theta, st);
    case 5: return launch<10>(yf, gf, of, R, F, 10, Theta, st);
    case 6: return launch<12>(yf, gf, of, R, F, 12, Theta, st);
    case 7: return launch<14>(yf, gf, of, R, F, 14, Theta, st);
    case 8: return launch<16>(yf, gf, of, R, F, 16, Theta, st);
    default: return launch<16>(yf, gf, of, R, F, 2 * M, Theta, st);
  }
}

const char* srp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
