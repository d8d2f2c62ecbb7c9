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
// Design.  One block of kFrameThreads threads per utterance holds all of its
// mics, as the TPU kernel does (M inside the program): Mb mic groups of Wm =
// kFrameWarps / 2^ceil(log2 Mb) warps each (4 warps a mic at M = 4, 2 at
// M = 8), each mic's state (the NB x F background and foreground filters,
// the leak-regression PSDs, two 2L-point transform buffers) in shared
// memory.  A mic group synchronises on a named barrier of its own
// (group_sync, or __syncwarp for a one-warp group): its reductions (the
// transfer-logic energies, the |W_j|^2 norms, the leak-regression sums) and
// its de-emphasis scan need no block barrier.  Unlike the other FLMS
// kernels the filters stay in the frequency domain: the per-bin mu_opt
// spreads tap support over the full 2L, so a tap-space state would not be
// exact.
//
// The far end is analysed once per utterance-frame, one frame ahead: in
// frame t the mic group t mod Mb transforms [far_t, far_{t+1}] into slot
// (t+1) mod 3 of a three-slot spectrum ring and updates the shared far-end
// power P, beside its own output transforms; the one block barrier of a
// frame publishes both.  Each transform is a 2L-point FFT owned by one warp
// in flms_fft.cuh's radix-8 passes on the swizzled layout, with N = 2L a
// template constant.  Per frame and mic, 5 complex transforms on a chain of
// 4: the background and foreground outputs y_b and y_f (two warps at once;
// they are not packed as one pair: before the first transfer Fg = 0 while W
// is not, and the transfer logic thresholds Sff - See, so y_f must not carry
// y_b's rounding), the error spectrum (its input [0; e_b] loaded by its
// first pass), the NB gradients conj(X_b) E / P as one packed inverse, and
// their constrained forward transforms as one packed pair, loaded from the
// inverse's first L samples by the same warp.  At M = 4, NB = 2 that is 21
// complex transforms a frame where the block-per-mic design ran 32 radix-2
// ones (and M - 1 repeated far-end analyses), 8 group barriers and 1 block
// barrier where it ran ~50 block barriers.  A group's single-warp phases
// start from its lead warp, rotated so that the groups' transforms issue
// from different SM sub-partitions.  While the error spectrum is
// transformed, the next warp forms the blended output, runs its de-emphasis
// y[n] = x[n] + 0.98 y[n-1] as a warp scan of the affine recurrence (R = L
// / 32 samples a lane, the powers 0.98^k from the host; the carry stays in
// that warp's registers) and copies the foreground filter on a transfer.
// The next frame's mic blocks and the far block after it are prefetched with
// cp.async.
//
// Where the mics of an utterance do not fit one block's shared memory
// (227 KB), ceil(M / Mb) blocks share an utterance, each with its own
// far-end analysis: at L = 256, NB = 2 one block holds up to 8 mics (226 KB
// at 8), so that starts at M = 9; at L = 128, up to 16 (the warp limit).
// L = 2048 does not fit even one mic, so the launcher takes L up to 1024.
//
// What bounds it on an H100 (B = 128, M = 4, 4 s): the serial chain of a
// frame, 4 transforms and 6 per-bin or per-sample phases between group
// barriers, with one block per utterance (128 blocks on 132 SMs); the
// 1 + M (3 + 2 NB) real transforms a frame are the operation bound.  The
// design it replaces, a 256-thread block per (utterance, mic) with
// block-wide radix-2 FFTs and the far end analysed by every mic, took
// 10.093 ms on an H100 at 700 W (PERF.md's kernel table keeps both times).
#include <cuda_runtime.h>

#include "flms_fft.cuh"

// Field order and types are mirrored by _AecParams in ops/cuda_aec.py.
struct AecParams {
  float alpha, one_m_alpha;  // the P pole
  float gamma, one_m_gamma;  // the Py / Pe pole
  float beta0, mu_max;
};

namespace {

constexpr size_t kMaxSmemBytes = 232448;  // a Hopper block's dynamic shared memory with the opt-in

// One mic's share of shared memory, in floats: two N-point transform
// buffers, the NB x F background and foreground filters, five per-bin rows
// (Py, Pe, |Y_b|^2, |E|^2 then the smoothed step, the clipped step) and two
// per-sample rows (y_b; y_f, then the output before de-emphasis).
__host__ __device__ __forceinline__ int mic_floats(int NB, int hop) {
  const int N = 2 * hop, F = hop + 1;
  return 4 * N + 4 * NB * F + round4(5 * F) + 2 * hop;
}

// Shared memory in floats for a block of Mb mics; the kernel carves it in
// this order.
__host__ __device__ __forceinline__ size_t smem_floats(int NB, int hop, int Mb) {
  const int N = 2 * hop, F = hop + 1;
  return 3 * (size_t)hop + 2 * (size_t)Mb * hop + N + N + round4(hop + 1) + round4(6 * F) + round4(2 * F) + 2 * N +
         8 * kFrameWarps + (size_t)Mb * mic_floats(NB, hop);
}

// The mics a block holds: as many as fit (at most one warp each), then
// spread evenly over the ceil(M / Mb) blocks of an utterance; 0 if not even
// one fits.
int mics_per_block(int NB, int hop, int M) {
  int Mb = M < kFrameWarps ? M : kFrameWarps;
  while (Mb > 0 && sizeof(float) * smem_floats(NB, hop, Mb) > kMaxSmemBytes) --Mb;
  if (Mb == 0) return 0;
  const int nblk = (M + Mb - 1) / Mb;
  return (M + nblk - 1) / nblk;
}

// The block totals of v over the Wm warps of a group from warp w0 on, from
// warp_partials, in a fixed order.
template <int NV>
__device__ __forceinline__ void group_total(float (&v)[NV], const float* red, int w0, int Wm) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float s = red[j * kFrameWarps + w0];
    for (int w = 1; w < Wm; ++w) s = s + red[j * kFrameWarps + w0 + w];
    v[j] = s;
  }
}

// The de-emphasis y[n] = o[n] + 0.98 y[n-1] of one hop by one warp, from
// the carry y[-1]: each lane runs its R = hop / 32 samples from zero, a
// shuffle scan combines the lanes with the powers apow[k] = 0.98^k, then
// each lane reruns its samples from its true start.  Returns y[hop-1].
__device__ __forceinline__ float deemph_warp(const float* o, float* y_out, int hop, const float* apow, float carry,
                                             int lane) {
  const int R = hop >> 5;
  const float a1 = apow[1];
  float v = 0.f;
  for (int i = 0; i < R; ++i) v = o[lane * R + i] + a1 * v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = v + apow[R * off] * u;
  }
  const float vp = __shfl_up_sync(0xffffffffu, v, 1);
  float y = lane == 0 ? carry : vp + apow[R * lane] * carry;  // just before this lane's first sample
  for (int i = 0; i < R; ++i) {
    y = o[lane * R + i] + a1 * y;
    y_out[lane * R + i] = y;
  }
  return __shfl_sync(0xffffffffu, y, 31);
}

// farp [B, T*L], xp [B, M, T*L] pre-emphasised; tabs [N/2 twiddles as
// (cos, sin) | N Hann window | L + 1 powers 0.98^k] -> out [B, M, T*L];
// upd (optional) [B, M, T] the transfer decisions as 0 / 1.  Block
// b * nblk + q holds mics q Mb .. of utterance b.  N = 2 L = 2^logN is a
// compile-time constant, so that the transforms' index arithmetic folds.
template <int NB, int logN>
__global__ void __launch_bounds__(kFrameThreads, 1) aec_kernel(const float* __restrict__ farp, const float* __restrict__ xp,
                                                            const float* __restrict__ tabs, float* __restrict__ out,
                                                            float* __restrict__ upd_out, int M, int Mb, int nblk, int T,
                                                            AecParams prm) {
  extern __shared__ float4 smem4[];
  constexpr int N = 1 << logN, hop = N / 2, F = hop + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t S = (size_t)T * hop;
  float* farR = reinterpret_cast<float*>(smem4);           // [3][L] far blocks t, t+1 and the prefetched t+2
  float* micR = farR + 3 * hop;                             // [2][Mb][L] this and the next frame's mic blocks
  float2* tw = reinterpret_cast<float2*>(micR + 2 * Mb * hop);  // [N/2]
  float* win = reinterpret_cast<float*>(tw + N / 2);        // [N] Hann window
  float* apow = win + N;                                    // [L+1] 0.98^k
  float2* Xr = reinterpret_cast<float2*>(apow + round4(hop + 1));  // [3][F] far spectra X_{t-1}, X_t, X_{t+1}
  float* Pr = reinterpret_cast<float*>(Xr) + round4(6 * F);  // [2][F] far-end power P_t, P_{t+1}
  float2* farbuf = reinterpret_cast<float2*>(Pr + round4(2 * F));  // [N] the far end's next analysis
  float* red = reinterpret_cast<float*>(farbuf + N);        // [8][kFrameWarps] warp partials
  float* mics = red + 8 * kFrameWarps;                      // [Mb][mic_floats]

  const int b = blockIdx.x / nblk, m0 = (blockIdx.x - b * nblk) * Mb;
  const int nm = min(Mb, M - m0);  // mics of this block
  int P2 = 1;
  while (P2 < Mb) P2 *= 2;
  const int Wm = kFrameWarps / P2;  // warps a mic
  const int g = warp / Wm, nthr = 32 * Wm, r = tid - g * nthr;
  // the group's warps counted from its lead warp, whose single-warp phases
  // (the chain's transforms) fall on SM sub-partition g mod 4 (warp w issues
  // from sub-partition w mod 4), so that the groups' transforms do not queue
  // on one
  const int lead = Wm >= 4 ? (g & 3) : Wm == 2 ? ((g >> 1) & 1) : 0;
  const int gw = (warp - g * Wm - lead + Wm) % Wm;
  const bool active = g < nm;
  auto gsync = [&]() {
    if (Wm == 1)
      __syncwarp();
    else
      group_sync(1 + g, nthr);
  };

  float* base = mics + (size_t)(active ? g : 0) * mic_floats(NB, hop);
  float2* bA = reinterpret_cast<float2*>(base);  // [N] y_b, then the gradients
  float2* bB = bA + N;                           // [N] y_f, then the error spectrum, then the constrained gradients
  float2* W = bB + N;                            // [NB][F] background filter
  float2* Fg = W + NB * F;                       // [NB][F] foreground filter
  float* Py = reinterpret_cast<float*>(Fg + NB * F);  // [F] echo-estimate PSD
  float* Pe = Py + F;                            // [F] error PSD
  float* Ysq = Pe + F;                           // [F] |Y_b|^2
  float* Rs = Ysq + F;                           // [F] |E|^2, then the smoothed step size
  float* mu = Rs + F;                            // [F] the clipped step size
  float* ybs = Py + round4(5 * F);               // [L] background output
  float* os = ybs + hop;                         // [L] foreground output, then the output before de-emphasis

  const float* fb = farp + (size_t)b * S;
  const float* xb = xp + ((size_t)b * M + m0) * S;
  float* ob = out + ((size_t)b * M + m0 + g) * S;
  auto prefetch_mics = [&](int t) {
    for (int q = 0; q < nm; ++q) prefetch_floats(micR + ((t & 1) * Mb + q) * hop, xb + q * S + (size_t)t * hop, hop);
  };
  prefetch_floats(farR, fb, hop);
  if (T > 1) prefetch_floats(farR + hop, fb + hop, hop);
  prefetch_mics(0);
  copy_async_commit();
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kFrameThreads) tw[i] = twg[i];
  for (int i = tid; i < N; i += kFrameThreads) win[i] = tabs[N + i];
  for (int i = tid; i <= hop; i += kFrameThreads) apow[i] = tabs[2 * N + i];
  for (int i = tid; i < 6 * F; i += kFrameThreads) reinterpret_cast<float*>(Xr)[i] = 0.f;
  for (int q = 0; q < Mb; ++q)  // W, Fg, Py, Pe
    for (int i = tid; i < 4 * NB * F + 2 * F; i += kFrameThreads) mics[(size_t)q * mic_floats(NB, hop) + 4 * N + i] = 0.f;
  copy_async_wait_all();
  __syncthreads();
  // ---- X_0 and P_0 from [0, far_0]
  for (int i = tid; i < N; i += kFrameThreads)
    farbuf[swz(bitrev(i, logN), logN)] = make_float2(i < hop ? 0.f : farR[i - hop], 0.f);
  __syncthreads();
  if (warp == 0) fft_seq<false>(farbuf, logN, tw, lane, 32, 0);
  __syncthreads();
  for (int k = tid; k < F; k += kFrameThreads) {
    const float2 X = farbuf[swz(k, logN)];
    Xr[k] = X;
    Pr[k] = prm.alpha * 0.f + prm.one_m_alpha * (X.x * X.x + X.y * X.y);
  }
  __syncthreads();

  float Davg1 = 0.f, Davg2 = 0.f, Dvar1 = 0.f, Dvar2 = 0.f, Ryy = 1.f, Rey = 1.f, carry = 0.f;
  const float invN = 1.f / (float)N;
  const float ga = prm.gamma, g1 = prm.one_m_gamma;
  for (int t = 0; t < T; ++t) {
    if (t + 2 < T) prefetch_floats(farR + ((t + 2) % 3) * hop, fb + (size_t)(t + 2) * hop, hop);
    if (t + 1 < T) prefetch_mics(t + 1);
    copy_async_commit();
    if (active) {
      const float2* X0 = Xr + (t % 3) * F;        // X_t
      const float2* X1 = Xr + ((t + 2) % 3) * F;  // X_{t-1} (zeros at t = 0)
      const float* Pt = Pr + (t & 1) * F;
      const float* dn = micR + ((t & 1) * Mb + g) * hop;
      const bool far_duty = t + 1 < T && t % nm == g;
      // ---- 1. per bin: the two outputs' spectra, the |W_j|^2 sums
      float sums[4 + NB];
#pragma unroll
      for (int j = 0; j < 4 + NB; ++j) sums[j] = 0.f;
      for (int k = r; k < F; k += nthr) {
        const float2 X = X0[k];
        float2 yb = cmulf(X, W[k]), yf = cmulf(X, Fg[k]);
        if (NB == 2) {
          const float2 Xp = X1[k];
          const float2 a = cmulf(Xp, W[F + k]), c = cmulf(Xp, Fg[F + k]);
          yb = make_float2(yb.x + a.x, yb.y + a.y);
          yf = make_float2(yf.x + c.x, yf.y + c.y);
        }
        Ysq[k] = yb.x * yb.x + yb.y * yb.y;
        put_pair(bA, k, N, logN, yb, make_float2(0.f, 0.f));
        put_pair(bB, k, N, logN, yf, make_float2(0.f, 0.f));
#pragma unroll
        for (int j = 0; j < NB; ++j) sums[4 + j] += W[j * F + k].x * W[j * F + k].x + W[j * F + k].y * W[j * F + k].y;
      }
      if (far_duty) {  // [far_t, far_{t+1}]
        const float* f0 = farR + (t % 3) * hop;
        const float* f1 = farR + ((t + 1) % 3) * hop;
        for (int i = r; i < N; i += nthr)
          farbuf[swz(bitrev(i, logN), logN)] = make_float2(i < hop ? f0[i] : f1[i - hop], 0.f);
      }
      gsync();
      // ---- 2. the outputs' inverses, and the far end's next analysis
      if (gw == 0) fft_seq<true>(bA, logN, tw, lane, 32, 0);
      if (gw == 1 % Wm) fft_seq<true>(bB, logN, tw, lane, 32, 0);
      if (far_duty && gw == 2 % Wm) fft_seq<false>(farbuf, logN, tw, lane, 32, 0);
      gsync();
      // ---- 3. per sample: the errors and the transfer-logic energies
      for (int n = r; n < hop; n += nthr) {
        const float d = dn[n];
        const float yb = bA[swz(hop + n, logN)].x * invN, yf = bB[swz(hop + n, logN)].x * invN;
        const float eb = d - yb, ef = d - yf, dby = yf - yb;
        ybs[n] = yb;
        os[n] = yf;
        sums[0] += ef * ef;    // Sff
        sums[1] += eb * eb;    // See
        sums[2] += dby * dby;  // Dbf
        sums[3] += yb * yb;    // Syy
      }
      if (far_duty) {  // X_{t+1} and P_{t+1}
        float* Pn = Pr + ((t + 1) & 1) * F;
        float2* Xn = Xr + ((t + 1) % 3) * F;
        for (int k = r; k < F; k += nthr) {
          const float2 X = farbuf[swz(k, logN)];
          Xn[k] = X;
          float pw = X.x * X.x + X.y * X.y;
          if (NB == 2) pw = pw + (X0[k].x * X0[k].x + X0[k].y * X0[k].y);
          Pn[k] = prm.alpha * Pt[k] + prm.one_m_alpha * pw;
        }
      }
      warp_partials<4 + NB>(sums, red);
      gsync();
      group_total<4 + NB>(sums, red, g * Wm, Wm);
      const float Sff = sums[0], See = sums[1], Dbf = sums[2], Syy = sums[3];
      // ---- the speex transfer logic (the same in every thread of the group)
      Davg1 = 0.6f * Davg1 + 0.4f * (Sff - See);
      Davg2 = 0.85f * Davg2 + 0.15f * (Sff - See);
      Dvar1 = 0.36f * Dvar1 + 0.16f * Sff * Dbf;
      Dvar2 = 0.7225f * Dvar2 + 0.0225f * Sff * Dbf;
      const bool upd = ((Sff - See) * fabsf(Sff - See) > Sff * Dbf) || (Davg1 * fabsf(Davg1) > 0.5f * Dvar1) ||
                       (Davg2 * fabsf(Davg2) > 0.25f * Dvar2);
      if (upd) Davg1 = Davg2 = Dvar1 = Dvar2 = 0.f;
      if (upd_out != nullptr && r == 0) upd_out[((size_t)b * M + m0 + g) * T + t] = upd ? 1.f : 0.f;
      // ---- 4. the error spectrum, its input [0; e_b] loaded by its first
      // pass; meanwhile, on the next warp, the blended output, its
      // de-emphasis and the foreground copy
      if (gw == 0)
        fft_seq_from<false>(bB, logN, tw, lane, 32, 0, [&](const float2*, int p, int lg) {
          const int n = bitrev(p, lg) - hop;
          return make_float2(n < 0 ? 0.f : dn[n] - ybs[n], 0.f);
        });
      if (gw == 1 % Wm) {
        for (int n = lane; n < hop; n += 32) {
          const float d = dn[n], yb = ybs[n], yf = os[n];
          os[n] = upd ? d - (win[hop + n] * yf + win[n] * yb) : d - yf;
        }
        __syncwarp();
        carry = deemph_warp(os, ob + (size_t)t * hop, hop, apow, carry, lane);
        if (upd)
          for (int i = lane; i < NB * F; i += 32) Fg[i] = W[i];
      }
      gsync();
      // ---- 5. per bin: the leak-regression PSD tracks
      float rs[2] = {0.f, 0.f};
      for (int k = r; k < F; k += nthr) {
        const float2 E = bB[swz(k, logN)];
        const float rr = E.x * E.x + E.y * E.y;
        Rs[k] = rr;
        const float py = g1 * Py[k] + ga * Ysq[k], pe = g1 * Pe[k] + ga * rr;
        Py[k] = py;
        Pe[k] = pe;
        const float Eh = rr - pe, Yh = Ysq[k] - py;
        rs[0] += Yh * Yh;
        rs[1] += Eh * Yh;
      }
      warp_partials<2>(rs, red + 6 * kFrameWarps);
      gsync();
      group_total<2>(rs, red + 6 * kFrameWarps, g * Wm, Wm);
      const float Pyy = sqrtf(rs[0]);
      const float Pey = rs[1] / (Pyy + 1e-6f);
      const float a = prm.beta0 * fminf(Syy / See, 1.f);
      Ryy = (1.f - a) * Ryy + a * Pyy;
      Rey = (1.f - a) * Rey + a * Pey;
      const float leak = Rey / (Ryy + 1e-6f);
      // ---- 6. per bin: the optimal step size (bins 0 and 1 doubled, clipped)
      for (int k = r; k < F; k += nthr) {
        float m = leak * Ysq[k] / (Rs[k] + 1e-3f);
        if (k < 2) m = 2.f * m;
        mu[k] = fminf(fmaxf(m, 1e-3f), prm.mu_max);
      }
      gsync();
      // ---- 7. per bin: its zero-padded 3-tap smoothing (0.1 for the first 5
      // frames); the gradients conj(X_b) E / P, to go through one packed inverse
      for (int k = r; k < F; k += nthr) {
        Rs[k] = t < 5 ? 0.1f : smooth_zero(mu, k, F);
        const float2 E = bB[swz(k, logN)];
        const float P = Pt[k] + 1e-6f;
        put_pair(bA, k, N, logN, grad_bin(X0[k], E, P), NB == 2 ? grad_bin(X1[k], E, P) : make_float2(0.f, 0.f));
      }
      gsync();
      // ---- 8. the gradients' inverse, then, on the same warp, the forward
      // transform of its first L samples, zero-padded (the gradient
      // constraint), loaded by the first pass
      if (gw == 0) {
        fft_seq<true>(bA, logN, tw, lane, 32, 0);
        __syncwarp();
        fft_seq_from<false>(bB, logN, tw, lane, 32, 0, [&](const float2*, int p, int lg) {
          const int n = bitrev(p, lg);
          if (n >= hop) return make_float2(0.f, 0.f);
          const float2 u = bA[swz(n, lg)];
          return make_float2(u.x * invN, NB == 2 ? u.y * invN : 0.f);
        });
      }
      gsync();
      // ---- 9. per bin: the proportionate update from the W before it (the sums above)
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
      for (int k = r; k < F; k += nthr) {
        const float m = Rs[k];
        float2 G[NB];
        if (NB == 2)
          split_pair(bB, k, N, logN, G[0], G[NB - 1]);
        else
          G[0] = bB[swz(k, logN)];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float s = scale[j] * m;
          W[j * F + k] = make_float2(W[j * F + k].x + s * G[j].x, W[j * F + k].y + s * G[j].y);
        }
      }
    }
    copy_async_wait_all();  // the next frame's inputs
    __syncthreads();        // X_{t+1} and P_{t+1} published
  }
}

template <int NB, int logN>
cudaError_t launch(const float* farp, const float* xp, const float* tabs, float* out, float* upd, int B, int M, int T,
                   const AecParams& prm, cudaStream_t st) {
  constexpr int hop = 1 << (logN - 1);
  const int Mb = mics_per_block(NB, hop, M);
  if (Mb == 0) return cudaErrorInvalidValue;
  const int nblk = (M + Mb - 1) / Mb;
  const size_t smem = sizeof(float) * smem_floats(NB, hop, Mb);
  const cudaError_t e = allow_smem(aec_kernel<NB, logN>, smem);
  if (e != cudaSuccess) return e;
  aec_kernel<NB, logN><<<B * nblk, kFrameThreads, smem, st>>>(farp, xp, tabs, out, upd, M, Mb, nblk, T, prm);
  return cudaGetLastError();
}

// hop 32 .. 1024 (a 2048-point block's state does not fit a block's shared
// memory even for one mic).
template <int NB>
cudaError_t launch_hop(const float* farp, const float* xp, const float* tabs, float* out, float* upd, int B, int M,
                       int T, int logN, const AecParams& prm, cudaStream_t st) {
  switch (logN) {
    case 6: return launch<NB, 6>(farp, xp, tabs, out, upd, B, M, T, prm, st);
    case 7: return launch<NB, 7>(farp, xp, tabs, out, upd, B, M, T, prm, st);
    case 8: return launch<NB, 8>(farp, xp, tabs, out, upd, B, M, T, prm, st);
    case 9: return launch<NB, 9>(farp, xp, tabs, out, upd, B, M, T, prm, st);
    case 10: return launch<NB, 10>(farp, xp, tabs, out, upd, B, M, T, prm, st);
    case 11: return launch<NB, 11>(farp, xp, tabs, out, upd, B, M, T, prm, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// upd may be null; NB (num_block) is 1 or 2; hop (block_len) a power of two from 32 to 1024.
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
    case 1: return launch_hop<1>(ff, xf, tf, of, uf, B, M, T, logN, prm, st);
    case 2: return launch_hop<2>(ff, xf, tf, of, uf, B, M, T, logN, prm, st);
    default: return cudaErrorInvalidValue;
  }
}

// The launch shape for M mics: the mics a block holds (0 if none fits) and,
// through smem, its dynamic shared memory in bytes.
int fused_aec_layout(int NB, int hop, int M, long long* smem) {
  const int Mb = mics_per_block(NB, hop, M);
  *smem = Mb > 0 ? (long long)(sizeof(float) * smem_floats(NB, hop, Mb)) : 0;
  return Mb;
}

const char* aec_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
