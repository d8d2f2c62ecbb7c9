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
// Design.  One 256-thread block per utterance runs the whole frame loop
// (flms_lane.cuh's mapping).  The per-bin state (87 floats a bin: both
// covariances in hermitian storage, the coherence and MCRA tracks, both
// filters, their powers, the previous FBF bin and two per-frame slots) lives
// in shared memory as one [field][F] array, so a bin's arithmetic runs in
// registers on whichever thread owns it: thread k owns bin k, thread 0 also
// bin 256.  Every 2Lf-point transform is a shared-memory radix-2 FFT, 14 a
// frame in 4 batched passes (5 analyses, 4 inverses, 4 analyses, 1 inverse);
// the twiddles' exact zeros keep bins 0 and Lf of a real signal real.  The
// q band's mean is one block reduction a frame.  The elimination order is
// gauss_jordan_inv's, without pivoting; the repair inverse is a per-bin
// branch, taken only where xi < 0, which changes no value.
//
// What bounds it on an H100 (B = 128, 4 s): operations (14 transforms and
// one 4x4 complex elimination a bin-frame, a second where xi < 0); in
// practice the latency of the ~40 barriers a frame with one block of 8
// warps per utterance on 132 SMs, and the second pass over bins that bin
// 256 costs thread 0.
#include <cuda_runtime.h>

#include "flms_lane.cuh"

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

// Per-bin state fields, each a row of F floats.  PhiY / PhiV: 4 real
// diagonal entries, then the 6 upper off-diagonal entries (i < j, in the
// order (0,1), (0,2), (0,3), (1,2), (1,3), (2,3)) as re, im.  Wbm / Waic:
// per mic, tap 0 re, im, tap 1 re, im.  UBuf: per mic, the previous AIC
// input bin.  Q and P are per-frame slots: q (phase A -> B), then p
// (phase B -> C), which first carries MCRA's decision bit.
enum : int {
  kPhiY = 0, kPhiV = 16, kMsc = 32, kMc = 36, kWbm = 41, kPbm = 57, kWaic = 58, kUBuf = 74, kPaic = 82,
  kXfP = 83, kQ = 85, kP = 86, kFields = 87
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

// Shared memory in floats; the kernel carves it in this order.
size_t smem_floats(int Lf) {
  const size_t N = 2 * Lf, F = Lf + 1, hop = Lf;
  return 2 * N * (3 * kM + 2) + 3 * N + F + kFields * F + (2 * kM + 1) * hop + kWarps;
}

// sig [B, 5, T*Lf] (the 4 aligned mics, then the FBF), sf [B, T, F] (MCRA's
// smoothed mic-0 power), tabs [N twiddles (cos, sin) | N analysis window |
// N synthesis window x gain / N | F diffuse pair coherence]
// -> out [B, T*Lf], p [B, T, F], bm [B, 4, T*Lf], dec [B, T, F]
__global__ void __launch_bounds__(kThreads) sgsc_kernel(const float* __restrict__ sig, const float* __restrict__ sf,
                                                        const float* __restrict__ tabs, float* __restrict__ out,
                                                        float* __restrict__ pout, float* __restrict__ bmo,
                                                        unsigned char* __restrict__ dec, int T, int Lf, int logN,
                                                        SgscParams prm) {
  extern __shared__ float4 smem4[];
  const int N = 2 * Lf, hop = Lf, F = Lf + 1;
  const int tid = threadIdx.x;
  const size_t S = (size_t)T * hop;
  float2* bZ = reinterpret_cast<float2*>(smem4);  // [5][N] analyses: the mics, the FBF
  float2* bS = bZ + (kM + 1) * N;                  // [4][N] BM error syntheses
  float2* bU = bS + kM * N;                        // [4][N] AIC input analyses
  float2* bO = bU + kM * N;                        // [N] output synthesis
  float2* tw = bO + N;                             // [N/2]
  float* win = reinterpret_cast<float*>(tw + N / 2);  // [N]
  float* swin = win + N;                           // [N]
  float* fn = swin + N;                            // [F]
  float* st = fn + F;                              // [kFields][F]
  float* olaBm = st + kFields * F;                 // [4][hop]
  float* uPrev = olaBm + kM * hop;                 // [4][hop]
  float* olaOut = uPrev + kM * hop;                // [hop]
  float* red = olaOut + hop;                       // [kWarps]

  const int b = blockIdx.x;
  const float* sg = sig + (size_t)b * (kM + 1) * S;
  const float* sfb = sf + (size_t)b * T * F;
  float* ob = out + (size_t)b * S;
  float* bo = bmo + (size_t)b * kM * S;
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kThreads) tw[i] = twg[i];
  for (int i = tid; i < 2 * N + F; i += kThreads) win[i] = tabs[N + i];  // win, swin, fn
  for (int i = tid; i < kFields * F + (2 * kM + 1) * hop; i += kThreads) st[i] = 0.f;
  __syncthreads();
#define ST(field, k) st[(field) * F + (k)]

  for (int t = 0; t < T; ++t) {
    // ---- the analyses: [x_{t-1} | x_t] windowed, bit-reversed
    for (int i = tid; i < (kM + 1) * N; i += kThreads) {
      const int c = i >> logN, n = i & (N - 1);
      const float* src = sg + (size_t)c * S;
      const float v = n < hop ? (t > 0 ? src[(size_t)(t - 1) * hop + n] : 0.f) : src[(size_t)t * hop + n - hop];
      bZ[c * N + bitrev(n, logN)] = make_float2(v * win[n], 0.f);
    }
    __syncthreads();
    fft_stages(bZ, kM + 1, N, logN, tw, false);

    // ---- phase A, per bin: McCDR (the pair-(1, 2) coherence, MCRA on mic 0), q
    float qs[1] = {0.f};
    for (int k = tid; k < F; k += kThreads) {
      const Cx d0 = cx(bZ[k]), d1 = cx(bZ[N + k]), d2 = cx(bZ[2 * N + k]);
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
      float G = num / fminf(Fx2 - 1.f, -1e-3f);
      G = G * G;
      G = G > 1.f ? 1.f : G;
      G = G < 0.f ? 1e-3f : G;
      McraLane m = load_mcra(st + kMc * F, F, k);
      float lam, sr;
      const float pm = mcra_frame(m, t, d0.r * d0.r + d0.i * d0.i, sfb[(size_t)t * F + k], bin_kind(k, F), prm.mc,
                                  lam, sr);
      store_mcra(st + kMc * F, F, k, m);
      const float q = 1.f - sqrtf(G * pm);
      ST(kQ, k) = q;
      ST(kP, k) = sr > prm.mc.delta_s ? 2.f : 0.f;
      if (k >= prm.q_lo && k < prm.q_hi) qs[0] += q;
    }
    block_sum<1>(qs, red);
    const float q_avg = qs[0] / (float)(prm.q_hi - prm.q_lo);
    const float dval = q_avg * prm.diag_max + (1.f - q_avg) * prm.diag_min;
    const bool warm = t < prm.warmup;
    const float rep_load = t < prm.repair ? dval : 0.f;

    // ---- phase B, per bin: McSpp's core, p, the noise update, the BM
    for (int k = tid; k < F; k += kThreads) {
      Cx d[kM];
#pragma unroll
      for (int c = 0; c < kM; ++c) d[c] = cx(bZ[c * N + k]);
      const Cx Xf = cx(bZ[kM * N + k]);
      const Cx XfP{ST(kXfP, k), ST(kXfP + 1, k)};
      const float q = warm ? 0.99f : ST(kQ, k);

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
      const float p = clampf(q >= 1.f ? 0.f : 1.f / (1.f + ratio), 0.f, 1.f);
      const size_t tf = ((size_t)b * T + t) * F + k;
      pout[tf] = p;
      dec[tf] = (unsigned char)((neg ? 1 : 0) + (int)ST(kP, k));
      ST(kP, k) = p;

      // the noise update
      const float at = prm.sp_alpha_d + prm.sp_one_m_alpha_d * p, one_m_at = 1.f - at;
#pragma unroll
      for (int i = 0; i < kM; ++i) ST(kPhiV + i, k) = at * vd[i] + one_m_at * psd_d[i];
#pragma unroll
      for (int o = 0; o < 6; ++o) {
        ST(kPhiV + 4 + 2 * o, k) = at * vo[o].r + one_m_at * psd_o[o].r;
        ST(kPhiV + 5 + 2 * o, k) = at * vo[o].i + one_m_at * psd_o[o].i;
      }

      // the blocking matrix: per mic, 2-tap subband NLMS, p-gated
      const float pbuf = Xf.r * Xf.r + Xf.i * Xf.i + XfP.r * XfP.r + XfP.i * XfP.i;
      const float Pc = prm.bm_alpha * ST(kPbm, k) + prm.bm_one_m_alpha * pbuf;
      ST(kPbm, k) = Pc;
      const float scale = prm.bm_mu2 * p / (Pc + prm.af_eps);
#pragma unroll
      for (int c = 0; c < kM; ++c) {
        float* W = st + (kWbm + 4 * c) * F + k;
        const Cx W0{W[0], W[F]}, W1{W[2 * F], W[3 * F]};
        const Cx y = cadd(cmulc(Xf, W0), cmulc(XfP, W1));
        const Cx e = csub(d[c], cscale(y, p));
        put_half(bS + c * N, k, N, logN, e.r, e.i);
        const Cx g0 = cmulc(Xf, e), g1 = cmulc(XfP, e);
        W[0] = W0.r + g0.r * scale;
        W[F] = W0.i + g0.i * scale;
        W[2 * F] = W1.r + g1.r * scale;
        W[3 * F] = W1.i + g1.i * scale;
      }
    }
    __syncthreads();
    fft_stages(bS, kM, N, logN, tw, true);

    // ---- the BM outputs (overlap-add), and the AIC inputs [u_{t-1} | u_t]
    for (int i = tid; i < kM * hop; i += kThreads) {
      const int c = i >> (logN - 1), n = i & (hop - 1);
      const float blk = olaBm[i] + bS[c * N + n].x * swin[n];
      olaBm[i] = bS[c * N + hop + n].x * swin[hop + n];
      bo[(size_t)c * S + (size_t)t * hop + n] = blk;
      bU[c * N + bitrev(n, logN)] = make_float2(uPrev[i] * win[n], 0.f);
      bU[c * N + bitrev(hop + n, logN)] = make_float2(blk * win[hop + n], 0.f);
      uPrev[i] = blk;
    }
    __syncthreads();
    fft_stages(bU, kM, N, logN, tw, false);

    // ---- phase C, per bin: the AIC on the delayed FBF, (1 - p)-gated
    for (int k = tid; k < F; k += kThreads) {
      const float p = ST(kP, k);
      float gate = 1.f - p;
      if (prm.freeze > 0.f) gate = gate * (p <= prm.freeze ? 1.f : 0.f);
      if (prm.aic_warmup > 0) gate = gate * (t >= prm.aic_warmup ? 1.f : 0.f);
      Cx U[kM], Up[kM];
      Cx y{0.f, 0.f};
      float pw = 0.f;
#pragma unroll
      for (int c = 0; c < kM; ++c) {
        const float* W = st + (kWaic + 4 * c) * F + k;
        U[c] = cx(bU[c * N + k]);
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
      put_half(bO, k, N, logN, e.r, e.i);
      const float2 X = bZ[kM * N + k];
      ST(kXfP, k) = X.x;
      ST(kXfP + 1, k) = X.y;
    }
    __syncthreads();
    fft_stages(bO, 1, N, logN, tw, true);
    for (int n = tid; n < hop; n += kThreads) {
      ob[(size_t)t * hop + n] = olaOut[n] + bO[n].x * swin[n];
      olaOut[n] = bO[hop + n].x * swin[hop + n];
    }
    __syncthreads();
  }
#undef ST
}

}  // namespace

extern "C" {

// Lf a power of two >= 64.
cudaError_t fused_sgsc_launch(const void* sig, const void* sf, const void* tabs, void* out, void* p, void* bm, void* dec,
                              int B, int T, int Lf, const void* params, void* stream) {
  const int logN = log2_of_twice(Lf);
  if (logN < 0 || Lf < 64 || B < 1 || T < 1) return cudaErrorInvalidValue;
  const SgscParams prm = *static_cast<const SgscParams*>(params);
  const size_t smem = sizeof(float) * smem_floats(Lf);
  const cudaError_t e = allow_smem(sgsc_kernel, smem);
  if (e != cudaSuccess) return e;
  sgsc_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(sf), static_cast<const float*>(tabs),
      static_cast<float*>(out), static_cast<float*>(p), static_cast<float*>(bm), static_cast<unsigned char*>(dec), T,
      Lf, logN, prm);
  return cudaGetLastError();
}

const char* sgsc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
