// Kernel K9: the fused subband GSC frame loop, and its C launcher.
//
// Replaces distantspeech_tpu/ops/pallas_sgsc.py fused_subband_gsc
// (_sgsc_kernel): per frame of Lf samples, the analysis of the 4 aligned
// mics and the fixed beamformer (FBF); per bin, the McCDR pair-(1, 2)
// coherence and its MCRA track (L = 65), McSpp's Phi_yy / Phi_vv 4x4
// hermitian recursions with the adaptive loading from the q band's mean, the
// Gauss-Jordan inverse of Phi_vv + load (and, only where xi < 0, the repair
// inverse of Phi_yy), xi / gamma / p with the q >= 1 guard, and the per-mic
// 2-tap subband NLMS blocking matrix (p-gated); the 4 BM syntheses and the 4
// AIC-input analyses; per bin, the multichannel 2-tap NLMS AIC ((1 - p)
// gated) on the FBF delayed by one frame; the output synthesis.  The plain
// version is subband_gsc_frames_plain in ops/cuda_sgsc.py.
//
// Design.  One block of kFrameThreads = 512 threads per utterance runs the
// whole frame loop, with __launch_bounds__(512, 1).  Thread k owns bin k
// (F = Lf + 1 <= 257 bins, each on a thread of its own) in all three per-bin
// phases, so what a bin's phases hand each other (its spectra, q, MCRA's
// decision, p) stays in its registers; the state that crosses frames (85
// floats a bin: both covariances in hermitian storage, the coherence and
// MCRA tracks, both filters, their powers, the previous FBF bin) lives in
// shared memory as one [field][F] array.  Every 2Lf-point transform is a
// warp-owned radix-8 FFT of flms_fft.cuh (a group of G warps a transform,
// G = 2 at Lf = 256, synchronised by a named barrier of its own), real
// signals of like magnitude packed in pairs: the mics as 2 pairs and the FBF
// alone (3 transforms), the 4 BM syntheses as 2 pairs and the 4 AIC-input
// analyses as 2 pairs (the group that inverts a BM pair also overlap-adds
// it and analyses the pair's AIC inputs, with no block barrier in between),
// and the output alone: 8 complex transforms a frame instead of 14 real
// ones.  Each transform's first pass loads, windows or packs its own input.
// The output synthesis of frame t runs on warps of its own while the others
// analyse frame t + 1.  The next frame's 5 input blocks and MCRA's smoothed
// power are prefetched with cp.async into a three-slot ring.  Block
// barriers: 5 a frame.  The q band's mean is one reduction a frame.  The
// elimination order is gauss_jordan_inv's, without pivoting; the repair
// inverse is a per-bin branch, taken only where xi < 0, which changes no
// value.
//
// What bounds it on an H100 (B = 128, 4 s): operations (14 real transforms
// and one 4x4 complex elimination a bin-frame, a second where xi < 0); in
// practice the serial chain of a frame: 5 barriers, the transforms, and the
// per-bin phase B, whose inverse runs on one thread a bin.  The design it
// replaces (256 threads, thread 0 also running bin 256, 14 radix-2 FFTs
// through shared memory, ~40 barriers a frame) took 8.457 ms at B5 on an
// H100 at 700 W (PERF.md's kernel table keeps both times).
#include <cuda_runtime.h>

#include "flms_fft.cuh"

// Field order and types are mirrored by _SgscParams in ops/cuda_sgsc.py.
struct SgscParams {
  McraParams mc;
  float msc_alpha, msc_one_m_alpha;
  float sp_alpha, sp_one_m_alpha, sp_alpha_d, sp_one_m_alpha_d;
  float diag_min, diag_max;
  int warmup, repair, q_lo, q_hi;
  float bm_alpha, bm_one_m_alpha, bm_mu2;
  float aic_alpha, aic_one_m_alpha, aic_mu2;
  float af_eps, freeze;
  int aic_warmup;
};

namespace {

constexpr int kM = 4;  // mics: McSpp's CDR is the 4-channel one

// Per-bin state fields that cross frames, each a row of F floats.  PhiY /
// PhiV: 4 real diagonal entries, then the 6 upper off-diagonal entries
// (i < j, in the order (0,1), (0,2), (0,3), (1,2), (1,3), (2,3)) as re, im.
// Wbm / Waic: per mic, tap 0 re, im, tap 1 re, im.  UBuf: per mic, the
// previous AIC input bin.  XfP: the previous FBF bin.
enum : int {
  kPhiY = 0, kPhiV = 16, kMsc = 32, kMc = 36, kWbm = 41, kPbm = 57, kWaic = 58, kUBuf = 74, kPaic = 82,
  kXfP = 83, kFields = 85
};

struct Cx {
  float r, i;
};

__device__ __forceinline__ Cx cx(float2 v) { return Cx{v.x, v.y}; }
__device__ __forceinline__ Cx cadd(Cx a, Cx b) { return Cx{a.r + b.r, a.i + b.i}; }
__device__ __forceinline__ Cx csub(Cx a, Cx b) { return Cx{a.r - b.r, a.i - b.i}; }
__device__ __forceinline__ Cx cmul(Cx a, Cx b) { return Cx{a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r}; }
// a * conj(b)
__device__ __forceinline__ Cx cmulc(Cx a, Cx b) { return Cx{a.r * b.r + a.i * b.i, a.i * b.r - a.r * b.i}; }
__device__ __forceinline__ Cx cscale(Cx a, float s) { return Cx{a.r * s, a.i * s}; }
// a / b as a conj(b) / |b|^2
__device__ __forceinline__ Cx cdiv(Cx a, Cx b) {
  const float den = b.r * b.r + b.i * b.i;
  return Cx{(a.r * b.r + a.i * b.i) / den, (a.i * b.r - a.r * b.i) / den};
}

// Index of the upper off-diagonal entry (i < j) in hermitian storage.
__host__ __device__ constexpr int off(int i, int j) { return i * (7 - i) / 2 + j - i - 1; }

// Element (i, j) of the hermitian matrix with real diagonal d and upper
// off-diagonal entries o.
__device__ __forceinline__ Cx herm(const float (&d)[kM], const Cx (&o)[6], int i, int j) {
  if (i == j) return Cx{d[i], 0.f};
  if (i < j) return o[off(i, j)];
  const Cx v = o[off(j, i)];
  return Cx{v.r, -v.i};
}

// P = (A + load I)^-1 for the hermitian A (d, o): Gauss-Jordan on [A | I]
// in gauss_jordan_inv's order, no pivoting.  Pivot k updates the columns
// k+1 .. kM+k only: those left of them already hold unit vectors and those
// right of them zeros, which the step would leave as they are.
__device__ __forceinline__ void inv4(const float (&d)[kM], const Cx (&o)[6], float load, Cx (&P)[kM][kM]) {
  Cx w[kM][2 * kM];
#pragma unroll
  for (int r = 0; r < kM; ++r) {
#pragma unroll
    for (int c = 0; c < kM; ++c) {
      w[r][c] = herm(d, o, r, c);
      w[r][kM + c] = Cx{r == c ? 1.f : 0.f, 0.f};
    }
    w[r][r].r = d[r] + load;
  }
#pragma unroll
  for (int k = 0; k < kM; ++k) {
    const Cx piv = w[k][k];
    Cx prow[2 * kM];
#pragma unroll
    for (int j = k + 1; j <= kM + k; ++j) prow[j] = cdiv(w[k][j], piv);
#pragma unroll
    for (int r = 0; r < kM; ++r) {
      if (r == k) continue;  // overwritten by the pivot row below
      const Cx col = w[r][k];
#pragma unroll
      for (int j = k + 1; j <= kM + k; ++j) w[r][j] = csub(w[r][j], cmul(col, prow[j]));
    }
#pragma unroll
    for (int j = k + 1; j <= kM + k; ++j) w[k][j] = prow[j];
  }
#pragma unroll
  for (int r = 0; r < kM; ++r)
#pragma unroll
    for (int c = 0; c < kM; ++c) P[r][c] = w[r][kM + c];
}

// Re tr(P Y) - 4 for the hermitian Y (d, o).
__device__ __forceinline__ float trace_re(const Cx (&P)[kM][kM], const float (&d)[kM], const Cx (&o)[6]) {
  float xi = -(float)kM;
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    Cx acc{0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kM; ++j) acc = cadd(acc, cmul(P[i][j], herm(d, o, j, i)));
    xi = xi + acc.r;
  }
  return xi;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// One slot of the input ring, in floats: the 5 input blocks (the mics, the
// FBF), then MCRA's smoothed power row.
__host__ __device__ __forceinline__ int sgsc_slot(int Lf) { return round4(5 * Lf) + round4(Lf + 1); }

// Shared memory in floats; the kernel carves it in this order.
size_t smem_floats(int Lf) {
  const size_t N = 2 * Lf, F = Lf + 1, hop = Lf;
  return 3 * (size_t)sgsc_slot(Lf) + 2 * N * 8 + N + 2 * N + F + kFields * F + (3 * kM + 1) * hop + kFrameWarps;
}

// sig [B, 5, T*Lf] (the 4 aligned mics, then the FBF), sf [B, T, F] (MCRA's
// smoothed mic-0 power), tabs [N twiddles (cos, sin) | N analysis window |
// N synthesis window x gain / N | F diffuse pair coherence]
// -> out [B, T*Lf], p [B, T, F], bm [B, 4, T*Lf], dec [B, T, F]; N = 2 Lf =
// 2^logN, a compile-time constant, so the transforms' index arithmetic folds.
template <int logN>
__global__ void __launch_bounds__(kFrameThreads, 1) sgsc_kernel(const float* __restrict__ sig,
                                                              const float* __restrict__ sf,
                                                              const float* __restrict__ tabs, float* __restrict__ out,
                                                              float* __restrict__ pout, float* __restrict__ bmo,
                                                              unsigned char* __restrict__ dec, int T,
                                                              SgscParams prm) {
  extern __shared__ float4 smem4[];
  constexpr int N = 1 << logN, hop = N / 2, F = hop + 1;
  constexpr int G = N >= 512 ? 2 : 1;  // warps a transform
  static_assert(F <= kFrameThreads && 4 * G <= kFrameWarps, "a thread a bin, and warps for 4 transform groups");
  const int tid = threadIdx.x;
  const int grp = (tid >> 5) / G, r = tid - grp * 32 * G;  // transform group and rank in it
  const size_t S = (size_t)T * hop;
  const int slot = sgsc_slot(hop);
  float* ring = reinterpret_cast<float*>(smem4);             // [3][slot] frames t - 1, t, t + 1
  float2* bZ = reinterpret_cast<float2*>(ring + 3 * slot);  // [3][N] analyses: mics 0 + i 1, 2 + i 3, the FBF
  float2* bS = bZ + 3 * N;                                  // [2][N] BM error syntheses, mics in pairs
  float2* bU = bS + 2 * N;                                  // [2][N] AIC input analyses, mics in pairs
  float2* bO = bU + 2 * N;                                  // [N] output synthesis
  float2* tw = bO + N;                                      // [N/2]
  float* win = reinterpret_cast<float*>(tw + N / 2);         // [N]
  float* swin = win + N;                                    // [N]
  float* fn = swin + N;                                     // [F]
  float* st = fn + F;                                       // [kFields][F]
  float* olaBm = st + kFields * F;                          // [4][hop]
  float* uBuf = olaBm + kM * hop;                           // [2][4][hop] AIC inputs of frames t - 1 and t
  float* olaOut = uBuf + 2 * kM * hop;                      // [hop]
  float* red = olaOut + hop;                                // [kFrameWarps]

  const int b = blockIdx.x;
  const float* sg = sig + (size_t)b * (kM + 1) * S;
  const float* sfb = sf + (size_t)b * T * F;
  float* ob = out + (size_t)b * S;
  float* bo = bmo + (size_t)b * kM * S;
  // frame t's input blocks and smoothed power into ring slot t mod 3
  auto prefetch = [&](int t) {
    float* sl = ring + (t % 3) * slot;
    for (int c = 0; c <= kM; ++c) prefetch_floats(sl + c * hop, sg + c * S + (size_t)t * hop, hop);
    prefetch_floats(sl + round4(5 * hop), sfb + (size_t)t * F, F);
    copy_async_commit();
  };
  prefetch(0);
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kFrameThreads) tw[i] = twg[i];
  for (int i = tid; i < 2 * N + F; i += kFrameThreads) win[i] = tabs[N + i];  // win, swin, fn
  for (int i = tid; i < kFields * F + (3 * kM + 1) * hop; i += kFrameThreads) st[i] = 0.f;
  copy_async_wait_all();
  __syncthreads();
#define ST(field, k) st[(field) * F + (k)]

  const int k = tid;  // this thread's bin in the per-bin phases (k < F)
  for (int t = 0; t <= T; ++t) {
    if (t + 1 < T) prefetch(t + 1);  // into the slot of frame t - 2, read for the last time in frame t - 1
    const float* cur = ring + (t % 3) * slot;
    const float* old = ring + ((t + 2) % 3) * slot;  // frame t - 1's blocks
    // ---- the analyses of frame t ([x_{t-1} | x_t], windowed), groups 0-2;
    // the output synthesis of frame t - 1 and its overlap-add, group 3
    if (grp < 3 && t < T) {
      const int c0 = 2 * grp;  // mics c0, c0 + 1, or the FBF (c0 = 4) alone
      fft_seq_from<false>(bZ + grp * N, logN, tw, r, 32 * G, 1 + grp, [&](const float2*, int p, int lg) {
        const int n = bitrev(p, lg);
        const float* src = n < hop ? old : cur;
        const int i = n < hop ? n : n - hop;
        if (n < hop && t == 0) return make_float2(0.f, 0.f);
        return make_float2(src[c0 * hop + i] * win[n], c0 < kM ? src[(c0 + 1) * hop + i] * win[n] : 0.f);
      });
    } else if (grp == 3 && t > 0) {
      fft_seq<true>(bO, logN, tw, r, 32 * G, 4);
      seq_sync(32 * G, 4);
      for (int n = r; n < hop; n += 32 * G) {
        ob[(size_t)(t - 1) * hop + n] = olaOut[n] + bO[swz(n, logN)].x * swin[n];
        olaOut[n] = bO[swz(hop + n, logN)].x * swin[hop + n];
      }
    }
    __syncthreads();  // 1
    if (t == T) break;

    // ---- phase A, per bin: McCDR (the pair-(1, 2) coherence, MCRA on mic 0), q
    Cx d[kM], Xf{0.f, 0.f};
    float q = 0.f, qs[1] = {0.f};
    bool over = false;
    if (k < F) {
      float2 a0, a1, a2, a3;
      split_pair(bZ, k, N, logN, a0, a1);
      split_pair(bZ + N, k, N, logN, a2, a3);
      d[0] = cx(a0);
      d[1] = cx(a1);
      d[2] = cx(a2);
      d[3] = cx(a3);
      Xf = cx(bZ[2 * N + swz(k, logN)]);
      const Cx d0 = d[0], d1 = d[1], d2 = d[2];
      const float p11 = prm.msc_alpha * ST(kMsc, k) + prm.msc_one_m_alpha * (d1.r * d1.r + d1.i * d1.i);
      const float p22 = prm.msc_alpha * ST(kMsc + 1, k) + prm.msc_one_m_alpha * (d2.r * d2.r + d2.i * d2.i);
      const Cx c12 = cmulc(d1, d2);
      const float p12r = prm.msc_alpha * ST(kMsc + 2, k) + prm.msc_one_m_alpha * c12.r;
      const float p12i = prm.msc_alpha * ST(kMsc + 3, k) + prm.msc_one_m_alpha * c12.i;
      ST(kMsc, k) = p11;
      ST(kMsc + 1, k) = p22;
      ST(kMsc + 2, k) = p12r;
      ST(kMsc + 3, k) = p12i;
      const float den = sqrtf(p11 * p22);
      const float Fxr = p12r / den, Fxi = p12i / den;
      const float Fx2 = Fxr * Fxr + Fxi * Fxi;
      const float Fn = fn[k], Fn2 = Fn * Fn;
      // the radicand as noise/mccdr.py's cdr_gamma forms it, two terms >= 0
      // that do not cancel, and clamped at 0 as the JAX package's is
      const float dn = Fn - Fxr;
      const float rad = dn * dn + (1.f - Fn2) * (Fxi * Fxi);
      const float num = Fn * Fxr - Fx2 - sqrtf(fmaxf(rad, 0.f));
      float Gc = num / fminf(Fx2 - 1.f, -1e-3f);
      Gc = Gc * Gc;
      Gc = Gc > 1.f ? 1.f : Gc;
      Gc = Gc < 0.f ? 1e-3f : Gc;
      McraLane m = load_mcra(st + kMc * F, F, k);
      float lam, sr;
      const float pm = mcra_frame(m, t, d0.r * d0.r + d0.i * d0.i, cur[round4(5 * hop) + k], bin_kind(k, F), prm.mc,
                                  lam, sr);
      store_mcra(st + kMc * F, F, k, m);
      q = 1.f - sqrtf(Gc * pm);
      over = sr > prm.mc.delta_s;
      if (k >= prm.q_lo && k < prm.q_hi) qs[0] = q;
    }
    warp_partials<1>(qs, red);
    __syncthreads();  // 2
    sum_partials<1>(qs, red);
    const float q_avg = qs[0] / (float)(prm.q_hi - prm.q_lo);
    const float dval = q_avg * prm.diag_max + (1.f - q_avg) * prm.diag_min;
    const bool warm = t < prm.warmup;
    const float rep_load = t < prm.repair ? dval : 0.f;

    // ---- phase B, per bin: McSpp's core, p, the noise update, the BM
    float p = 0.f;
    if (k < F) {
      const Cx XfP{ST(kXfP, k), ST(kXfP + 1, k)};
      if (warm) q = 0.99f;

      // Phi_yy (hermitian storage); Phi_vv follows it while warm
      float psd_d[kM], yd[kM], vd[kM];
      Cx psd_o[6], yo[6], vo[6];
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        psd_d[i] = d[i].r * d[i].r + d[i].i * d[i].i;
        yd[i] = prm.sp_alpha * ST(kPhiY + i, k) + prm.sp_one_m_alpha * psd_d[i];
        ST(kPhiY + i, k) = yd[i];
        vd[i] = warm ? yd[i] : ST(kPhiV + i, k);
#pragma unroll
        for (int j = i + 1; j < kM; ++j) {
          const int o = off(i, j);
          psd_o[o] = cmulc(d[i], d[j]);
          yo[o] = Cx{prm.sp_alpha * ST(kPhiY + 4 + 2 * o, k) + prm.sp_one_m_alpha * psd_o[o].r,
                     prm.sp_alpha * ST(kPhiY + 5 + 2 * o, k) + prm.sp_one_m_alpha * psd_o[o].i};
          ST(kPhiY + 4 + 2 * o, k) = yo[o].r;
          ST(kPhiY + 5 + 2 * o, k) = yo[o].i;
          vo[o] = warm ? yo[o] : Cx{ST(kPhiV + 4 + 2 * o, k), ST(kPhiV + 5 + 2 * o, k)};
        }
      }

      // the estimation core: the inverse; the repair, and its trace, where xi < 0
      Cx P[kM][kM];
      inv4(vd, vo, dval, P);
      float tr = trace_re(P, yd, yo);
      const bool neg = tr < 0.f;
      if (neg) {
        inv4(yd, yo, rep_load, P);
        tr = trace_re(P, yd, yo);
      }
      const float xi = clampf(tr, 1e-6f, 1e8f);
      // gamma = y^H P Phi_yy P y - y^H P y
      Cx lv[kM], rv[kM];
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        Cx al{0.f, 0.f}, ar{0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kM; ++kk) {
          al = cadd(al, cmul(Cx{d[kk].r, -d[kk].i}, P[kk][j]));
          ar = cadd(ar, cmul(P[j][kk], d[kk]));
        }
        lv[j] = al;
        rv[j] = ar;
      }
      Cx t1{0.f, 0.f}, t2{0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        Cx acc{0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kM; ++j) acc = cadd(acc, cmul(herm(yd, yo, i, j), rv[j]));
        t1 = cadd(t1, cmul(lv[i], acc));
        t2 = cadd(t2, cmul(lv[i], d[i]));
      }
      const float gamma = clampf(t1.r - t2.r, 1e-6f, 1e8f);
      // q == 1 in float32 makes q / (1 - q) inf and inf * exp(-huge) NaN;
      // the limit q -> 1 is p = 0
      const float ratio = q / (1.f - q) * (1.f + xi) * expf(-(gamma / (1.f + xi)));
      p = clampf(q >= 1.f ? 0.f : 1.f / (1.f + ratio), 0.f, 1.f);
      const size_t tf = ((size_t)b * T + t) * F + k;
      pout[tf] = p;
      dec[tf] = (unsigned char)((neg ? 1 : 0) + (over ? 2 : 0));

      // the noise update
      const float at = prm.sp_alpha_d + prm.sp_one_m_alpha_d * p, one_m_at = 1.f - at;
#pragma unroll
      for (int i = 0; i < kM; ++i) ST(kPhiV + i, k) = at * vd[i] + one_m_at * psd_d[i];
#pragma unroll
      for (int o = 0; o < 6; ++o) {
        ST(kPhiV + 4 + 2 * o, k) = at * vo[o].r + one_m_at * psd_o[o].r;
        ST(kPhiV + 5 + 2 * o, k) = at * vo[o].i + one_m_at * psd_o[o].i;
      }

      // the blocking matrix: per mic, 2-tap subband NLMS, p-gated; the
      // errors into the BM syntheses, mics in pairs
      const float pbuf = Xf.r * Xf.r + Xf.i * Xf.i + XfP.r * XfP.r + XfP.i * XfP.i;
      const float Pc = prm.bm_alpha * ST(kPbm, k) + prm.bm_one_m_alpha * pbuf;
      ST(kPbm, k) = Pc;
      const float scale = prm.bm_mu2 * p / (Pc + prm.af_eps);
      Cx e[kM];
#pragma unroll
      for (int c = 0; c < kM; ++c) {
        float* W = st + (kWbm + 4 * c) * F + k;
        const Cx W0{W[0], W[F]}, W1{W[2 * F], W[3 * F]};
        const Cx y = cadd(cmulc(Xf, W0), cmulc(XfP, W1));
        e[c] = csub(d[c], cscale(y, p));
        const Cx g0 = cmulc(Xf, e[c]), g1 = cmulc(XfP, e[c]);
        W[0] = W0.r + g0.r * scale;
        W[F] = W0.i + g0.i * scale;
        W[2 * F] = W1.r + g1.r * scale;
        W[3 * F] = W1.i + g1.i * scale;
      }
      put_pair(bS, k, N, logN, make_float2(e[0].r, e[0].i), make_float2(e[1].r, e[1].i));
      put_pair(bS + N, k, N, logN, make_float2(e[2].r, e[2].i), make_float2(e[3].r, e[3].i));
    }
    __syncthreads();  // 3

    // ---- groups 0 and 1, a mic pair each: the BM synthesis, the BM outputs
    // (overlap-add) and the AIC inputs [u_{t-1} | u_t], then their analysis
    float* uCur = uBuf + (t & 1) * kM * hop;
    const float* uPrev = uBuf + ((t + 1) & 1) * kM * hop;
    if (grp < 2) {
      fft_seq<true>(bS + grp * N, logN, tw, r, 32 * G, 1 + grp);
      seq_sync(32 * G, 1 + grp);
      for (int i = r; i < 2 * hop; i += 32 * G) {
        const int c = 2 * grp + (i >= hop ? 1 : 0), n = i - (i >= hop ? hop : 0);
        const float2 lo = bS[grp * N + swz(n, logN)], hi = bS[grp * N + swz(hop + n, logN)];
        const float blk = olaBm[c * hop + n] + ((c & 1) ? lo.y : lo.x) * swin[n];
        olaBm[c * hop + n] = ((c & 1) ? hi.y : hi.x) * swin[hop + n];
        bo[(size_t)c * S + (size_t)t * hop + n] = blk;
        uCur[c * hop + n] = blk;
      }
      seq_sync(32 * G, 1 + grp);
      const int c0 = 2 * grp;
      fft_seq_from<false>(bU + grp * N, logN, tw, r, 32 * G, 1 + grp, [&](const float2*, int pp, int lg) {
        const int n = bitrev(pp, lg);
        const float* src = n < hop ? uPrev : uCur;
        const int i = n < hop ? n : n - hop;
        return make_float2(src[c0 * hop + i] * win[n], src[(c0 + 1) * hop + i] * win[n]);
      });
    }
    __syncthreads();  // 4

    // ---- phase C, per bin: the AIC on the delayed FBF, (1 - p)-gated; the
    // error into the output synthesis
    if (k < F) {
      float gate = 1.f - p;
      if (prm.freeze > 0.f) gate = gate * (p <= prm.freeze ? 1.f : 0.f);
      if (prm.aic_warmup > 0) gate = gate * (t >= prm.aic_warmup ? 1.f : 0.f);
      Cx U[kM], Up[kM];
      Cx y{0.f, 0.f};
      float pw = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float2 u0, u1;
        split_pair(bU + j * N, k, N, logN, u0, u1);
        U[2 * j] = cx(u0);
        U[2 * j + 1] = cx(u1);
      }
#pragma unroll
      for (int c = 0; c < kM; ++c) {
        const float* W = st + (kWaic + 4 * c) * F + k;
        Up[c] = Cx{ST(kUBuf + 2 * c, k), ST(kUBuf + 2 * c + 1, k)};
        y = cadd(y, cmulc(U[c], Cx{W[0], W[F]}));
        y = cadd(y, cmulc(Up[c], Cx{W[2 * F], W[3 * F]}));
        pw = pw + U[c].r * U[c].r + U[c].i * U[c].i + Up[c].r * Up[c].r + Up[c].i * Up[c].i;
      }
      const Cx e = csub(Cx{ST(kXfP, k), ST(kXfP + 1, k)}, cscale(y, gate));  // desired: the FBF of frame t-1
      const float Pa = prm.aic_alpha * ST(kPaic, k) + prm.aic_one_m_alpha * pw / (float)kM;
      ST(kPaic, k) = Pa;
      const float scale = prm.aic_mu2 * gate / (Pa + prm.af_eps);
#pragma unroll
      for (int c = 0; c < kM; ++c) {
        float* W = st + (kWaic + 4 * c) * F + k;
        const Cx g0 = cmulc(U[c], e), g1 = cmulc(Up[c], e);
        W[0] = W[0] + g0.r * scale;
        W[F] = W[F] + g0.i * scale;
        W[2 * F] = W[2 * F] + g1.r * scale;
        W[3 * F] = W[3 * F] + g1.i * scale;
        ST(kUBuf + 2 * c, k) = U[c].r;
        ST(kUBuf + 2 * c + 1, k) = U[c].i;
      }
      put_pair(bO, k, N, logN, make_float2(e.r, e.i), make_float2(0.f, 0.f));
      ST(kXfP, k) = Xf.r;
      ST(kXfP + 1, k) = Xf.i;
    }
    copy_async_wait_all();  // frame t + 1's inputs
    __syncthreads();  // 5
  }
#undef ST
}

template <int logN>
cudaError_t launch(const float* sig, const float* sf, const float* tabs, float* out, float* p, float* bm,
                   unsigned char* dec, int B, int T, const SgscParams& prm, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(1 << (logN - 1));
  const cudaError_t e = allow_smem(sgsc_kernel<logN>, smem);
  if (e != cudaSuccess) return e;
  sgsc_kernel<logN><<<B, kFrameThreads, smem, st>>>(sig, sf, tabs, out, p, bm, dec, T, prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lf 64, 128 or 256 (a thread a bin: F = Lf + 1 <= 257 of the block's 512).
cudaError_t fused_sgsc_launch(const void* sig, const void* sf, const void* tabs, void* out, void* p, void* bm, void* dec,
                              int B, int T, int Lf, const void* params, void* stream) {
  if (B < 1 || T < 1) return cudaErrorInvalidValue;
  const SgscParams prm = *static_cast<const SgscParams*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(sig);
  const float* sff = static_cast<const float*>(sf);
  const float* tf = static_cast<const float*>(tabs);
  float* of = static_cast<float*>(out);
  float* pf = static_cast<float*>(p);
  float* bf = static_cast<float*>(bm);
  unsigned char* df = static_cast<unsigned char*>(dec);
  switch (Lf) {
    case 64: return launch<7>(sg, sff, tf, of, pf, bf, df, B, T, prm, st);
    case 128: return launch<8>(sg, sff, tf, of, pf, bf, df, B, T, prm, st);
    case 256: return launch<9>(sg, sff, tf, of, pf, bf, df, B, T, prm, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* sgsc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
