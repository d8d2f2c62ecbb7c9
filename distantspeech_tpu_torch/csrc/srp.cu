// Kernel K10: the fused SRP-PHAT angle spectrum, and its C launcher.
//
// Replaces distantspeech_tpu/ops/pallas_srp.py fused_srp_spectrum
// (_srp_kernel): out[r, a] = sum_f |sum_m conj(g[a, f, m]) y[r, f, m]| over
// whitened spectrum rows y, with the grid packed per bin as
// G[f] = [[Gr, -Gi], [Gi, Gr]] ([2M, 2 Theta]) so that [yr | yi] G[f] is
// [Re | Im] of the steered response.  The plain version is
// srp_spectrum_plain in ops/cuda_srp.py.
//
// Design.  The products run on the tensor cores in 3xTF32: each operand x
// splits as hi = tf32(x) (rounded as cvt.rna) and lo = tf32(x - hi), and
// mma.sync.m16n8k8.tf32 accumulates lo hi + hi lo, then hi hi, in FP32; the
// dropped lo lo term and lo's own rounding leave ~2^-22 of each product,
// float32's accuracy (a single TF32 product keeps ~2^-11, which misses the
// 1e-4 gate).  A 512-thread block (16 warps) owns 32 rows (two m16 row
// tiles) and kAngles angles (all 360 of B6 in one block), so each row is
// read once; warp w owns the n8 column tiles w, w + 16, ...: 4 angles a
// tile, and the tile's column n takes Re (n even) or Im (n odd) of angle
// n / 2, so a thread's accumulator pair (c0, c1) of the m16n8 fragment is
// (Re, Im) of one angle and (c2, c3) the same angle 8 rows down.  The
// interleave lies in the fragment's addressing, so the bin's grid slice is
// staged as it is in memory (Re and Im halves, each row padded so that the
// fragment loads hit 32 banks), and the hi / lo split is done where a
// fragment is loaded into registers.  |c| = sqrtf(c0^2 + c1^2) (IEEE) is
// added to accumulators that stay in registers across all bins, so the
// [rows, Theta, F] field is never stored.  The next bin's rows and grid
// slice are prefetched with cp.async into a two-slot ring: one block
// barrier a bin.  The bin's 2M columns are padded with zeros to a multiple
// of 8 (zero terms add exactly zero); up to 8 mics the k-step count is a
// template constant (1 up to 4 mics, 2 up to 8) and a bin is one step of
// the ring.  Above 8 mics a bin's columns go through the ring 16 at a time,
// the fragments accumulated across a bin's steps before the magnitude
// (half the angles a block, so that they stay in registers).
//
// What bounds it on an H100 (4,000 rows, F = 129, Theta = 360, M = 8):
// operations.  Its 3 x 5.9e9 tensor-core multiply-adds take 0.072 ms at
// the card's 495 TF32 TFLOP/s, its 1.86e8 magnitudes ~0.04 ms on the SFU;
// the bytes (the rows, the grid and the output once) ~0.012 ms.
// chip_smoke.py prints the tensor-core bound beside the FP32 one (8M + 5
// operations a (row, bin, angle) at 67 TFLOP/s, 0.191 ms), the bound of
// the first design, which ran the products as FP32 FMAs, 4 x 4 outputs a
// thread, and took 0.981 ms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flms_fft.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTiles = 2;             // m16 row tiles a block
constexpr int kRows = 16 * kRowTiles;    // rows a block

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero: half an ulp of TF32 added to the magnitude, then the 13 bits
// below its mantissa cleared), for the finite x the kernel sees; in
// integer operations, which ran 9% faster than the instruction
// (scripts/lane_variants.py's k10-cvt).
__device__ __forceinline__ uint32_t cvt_rna_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

#ifdef __CUDACC__
// d += a b on one m16n8k8 tile: a the thread's 4 TF32 A fragment registers
// (row-major 16 x 8), b its 2 B registers (column-major 8 x 8), d its 4
// FP32 C registers, in the PTX ISA's fragment layout.
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// x = hi + lo to ~2^-22 of x, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = cvt_rna_tf32(x);
  lo = cvt_rna_tf32(x - __uint_as_float(hi));
}

// The block's shape for KS k-steps a ring step and TW column tiles a warp.
template <int KS, int TW>
struct Tile {
  static constexpr int kCols = 8 * KS;               // columns of a ring step
  static constexpr int kAngles = 4 * kWarps * TW;    // angles a block
  static constexpr int kStrideA = kCols + 4;         // row stride of the rows (fragment loads on 32 banks)
  static constexpr int kIm = kAngles + 4;            // offset of a grid row's Im half
  static constexpr int kStrideB = 2 * kAngles + 8;   // row stride of the grid slice (8 mod 32)
  static constexpr int kSlot = kRows * kStrideA + kCols * kStrideB;  // floats a ring slot
};

// y [R, F, M2], G [F, M2, 2 Theta] -> out [R, Theta], M2 = 2M.  KS k-steps
// of 8 columns a ring step and TW column tiles a warp; kChunked: a bin takes
// ceil(M2 / (8 KS)) steps (above 8 mics), else one.  vec: the grid's rows
// go by 16-byte copies (Theta a multiple of 4 and G 16-byte aligned).
template <int KS, int TW, bool kChunked>
__global__ void __launch_bounds__(kThreads, 1) srp_kernel(const float* __restrict__ y, const float* __restrict__ G,
                                                          float* __restrict__ out, int R, int F, int M2, int Theta,
                                                          int vec) {
  using S = Tile<KS, TW>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // [2][rows | grid slice]
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  const int r0 = blockIdx.x * kRows, a0 = blockIdx.y * S::kAngles;
  const int nc = kChunked ? (M2 + S::kCols - 1) / S::kCols : 1;  // ring steps a bin
  const int steps = F * nc;

  // step s (bin s / nc, columns c0 .. c0 + kCols of it) into slot s & 1:
  // rows r0 .. r0 + 31 and the grid slice of angles a0 .. a0 + kAngles,
  // zeros past R, M2 and Theta
  auto stage = [&](int s) {
    const int f = kChunked ? s / nc : s, c0 = kChunked ? (s - f * nc) * S::kCols : 0;
    float* As = smem + (s & 1) * S::kSlot;
    float* Bs = As + kRows * S::kStrideA;
    for (int e = tid; e < kRows * S::kCols; e += kThreads) {
      const int r = e / S::kCols, k = e % S::kCols;
      float* dst = As + r * S::kStrideA + k;
      if (r0 + r < R && c0 + k < M2)
        copy_async4(dst, y + ((size_t)(r0 + r) * F + f) * M2 + c0 + k);
      else
        *dst = 0.f;
    }
    const float* Gf = G + (size_t)f * M2 * 2 * Theta;
    if (vec) {
      constexpr int kQuads = S::kAngles / 4;
      for (int e = tid; e < S::kCols * 2 * kQuads; e += kThreads) {
        const int k = e / (2 * kQuads), part = (e / kQuads) & 1, a = 4 * (e % kQuads);
        float* dst = Bs + k * S::kStrideB + part * S::kIm + a;
        if (c0 + k < M2 && a0 + a < Theta)
          copy_async16(dst, Gf + (size_t)(c0 + k) * 2 * Theta + part * Theta + a0 + a);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int e = tid; e < S::kCols * 2 * S::kAngles; e += kThreads) {
        const int k = e / (2 * S::kAngles), part = (e / S::kAngles) & 1, a = e % S::kAngles;
        float* dst = Bs + k * S::kStrideB + part * S::kIm + a;
        if (c0 + k < M2 && a0 + a < Theta)
          copy_async4(dst, Gf + (size_t)(c0 + k) * 2 * Theta + part * Theta + a0 + a);
        else
          *dst = 0.f;
      }
    }
    copy_async_commit();
  };

  float acc[kRowTiles][TW][2];  // sum_f |.| of (rows g, g + 8 of each row tile) x (angle tq of each column tile)
  float C[kRowTiles][TW][4];    // the bin's products, fragment by fragment
#pragma unroll
  for (int i = 0; i < kRowTiles; ++i)
#pragma unroll
    for (int j = 0; j < TW; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;

  stage(0);
  for (int s = 0; s < steps; ++s) {
    copy_async_wait_all();
    __syncthreads();  // step s landed for every thread; every thread is done with slot (s + 1) & 1
    if (s + 1 < steps) stage(s + 1);
    const int c = kChunked ? s % nc : 0;
    const float* As = smem + (s & 1) * S::kSlot;
    const float* Bs = As + kRows * S::kStrideA;

    // the rows' A fragments, hi and lo, for every row tile and k-step
    uint32_t ah[kRowTiles][KS][4], al[kRowTiles][KS][4];
#pragma unroll
    for (int i = 0; i < kRowTiles; ++i)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(As[(16 * i + g + 8 * (q & 1)) * S::kStrideA + 8 * ks + tq + 4 * (q >> 1)], ah[i][ks][q],
                     al[i][ks][q]);
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const int nt = warp + kWarps * j;  // the column tile: angles a0 + 4 nt .. + 3
      if (a0 + 4 * nt >= Theta) break;   // the same for the whole warp
      // B fragment: column g of the tile is Re (g even) or Im (g odd) of angle 4 nt + g / 2
      uint32_t bh[KS][2], bl[KS][2];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          split_tf32(Bs[(8 * ks + tq + 4 * q) * S::kStrideB + (g & 1) * S::kIm + 4 * nt + (g >> 1)], bh[ks][q],
                     bl[ks][q]);
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) {
        float(&d)[4] = C[i][j];
        if (!kChunked || c == 0) d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma_m16n8k8_tf32(d, al[i][ks], bh[ks]);
          mma_m16n8k8_tf32(d, ah[i][ks], bl[ks]);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_m16n8k8_tf32(d, ah[i][ks], bh[ks]);
        if (!kChunked || c == nc - 1) {
          acc[i][j][0] += sqrtf(d[0] * d[0] + d[1] * d[1]);
          acc[i][j][1] += sqrtf(d[2] * d[2] + d[3] * d[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowTiles; ++i)
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const int a = a0 + 4 * (warp + kWarps * j) + tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * i + g + 8 * h;
        if (r < R && a < Theta) out[(size_t)r * Theta + a] = acc[i][j][h];
      }
    }
}

template <int KS, int TW, bool kChunked>
cudaError_t launch(const float* y, const float* G, float* out, int R, int F, int M2, int Theta, cudaStream_t st) {
  using S = Tile<KS, TW>;
  const size_t smem = 2 * sizeof(float) * S::kSlot;
  const cudaError_t e = allow_smem(srp_kernel<KS, TW, kChunked>, smem);
  if (e != cudaSuccess) return e;
  const int vec = Theta % 4 == 0 && (reinterpret_cast<uintptr_t>(G) & 15) == 0;
  const dim3 grid((R + kRows - 1) / kRows, (Theta + S::kAngles - 1) / S::kAngles);
  srp_kernel<KS, TW, kChunked><<<grid, kThreads, smem, st>>>(y, G, out, R, F, M2, Theta, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// M (mics) 2 or more: up to 4 one k-step a bin, up to 8 two (template
// constants, 384 angles a block); above 8 a bin in steps of 16 columns, 192
// angles a block.
cudaError_t fused_srp_launch(const void* y, const void* G, void* out, int R, int F, int M, int Theta, void* stream) {
  if (R < 1 || F < 1 || Theta < 1 || M < 2) return cudaErrorInvalidValue;
  const float* yf = static_cast<const float*>(y);
  const float* gf = static_cast<const float*>(G);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4) return launch<1, 6, false>(yf, gf, of, R, F, 2 * M, Theta, st);
  if (M <= 8) return launch<2, 6, false>(yf, gf, of, R, F, 2 * M, Theta, st);
  return launch<2, 3, true>(yf, gf, of, R, F, 2 * M, Theta, st);
}

const char* srp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
