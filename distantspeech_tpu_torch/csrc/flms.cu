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
// Design.  One block of kFrameThreads threads per utterance runs the whole
// frame loop; all state lives in shared memory: the C filters as Lf
// time-domain taps (so the gradient constraint and fir_truncate are masks),
// the FLMS power and the MCRA state per bin, and with the postfilter the
// (1 + C) MCRA trackers, the OM-LSA carries and the overlap-add tail.  All
// F = Lf + 1 bins are uniform lanes (the TPU kernel's Nyquist packing is not
// needed).  The TPU kernel's per-frame transforms are dots against
// [512, 512] DFT matrices; here each is a 512-point FFT owned by one warp or
// a warp pair (flms_fft.cuh), two real transforms packed into each complex
// one.  Per frame, 11 complex transforms at C = 3 (5C + 2 = 17 real ones,
// 19 with the postfilter) in 6 batches: the C analyses with the C tap
// spectra (C; the taps scaled by an exact power of two to the analyses'
// magnitude, from the previous frame's maxima, so that the small tap
// spectra keep their precision), the output inverse (1), the error spectrum
// with the postfilter analysis (1), the C gradients with the postfiltered
// beam (ceil(C / 2) pairs, the beam the second half of an odd C's last; an
// even C's beam takes a pair of its own), the C constrained gradients and
// the C gated updates (ceil(C / 2) pairs each, an odd C's last half empty).
// Block barriers: 13 a frame (14 with the postfilter), each where data
// crosses between the per-transform and the per-bin layouts; none inside a
// transform.  The next frame's inputs (the C
// blocking-matrix blocks, the desired block, the FBF power and, with the
// postfilter, the C reference powers) are prefetched with cp.async into a
// two-slot ring while the frame computes.  Twiddles and the window come from
// the host with the exact zeros of sin and cos kept exact, so bins 0 and N/2
// of a real signal stay real.
//
// What bounds it on an H100 (B = 128, M = 4, 4 s): the serial chain of a
// frame, 6 transform batches and 6-7 per-bin phases between block barriers,
// with one block per utterance (128 blocks on 132 SMs); the butterflies
// (17-19 real transforms a frame) are the operation bound.  The design it
// replaces, a block-wide radix-2 FFT with a block barrier per stage (~63 a
// frame), took 6.472 ms (core) and 8.727 ms (postfilter) on an H100 at
// 700 W (PERF.md's kernel table keeps both times).  No tensor cores
// (flms_fft.cuh).
#include <cuda_runtime.h>

#include "flms_fft.cuh"

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

// One slot of the input ring, in floats: the C blocking-matrix blocks, the
// desired block, the FBF power and (kPF) the C reference powers.
__host__ __device__ __forceinline__ int slot_floats(int C, int Lf, bool pf) {
  return round4(C * Lf) + round4(Lf) + round4(Lf + 1) + (pf ? round4(C * (Lf + 1)) : 0);
}

// Shared memory in floats; the kernel carves it in this order.
__host__ __device__ size_t smem_floats(int C, int Lf, bool pf) {
  const size_t N = 2 * Lf, F = Lf + 1, hop = Lf;
  const size_t nG = (C + (pf ? 1 : 0) + 1) / 2;  // the pairs of Gb
  size_t n = 2 * (size_t)slot_floats(C, Lf, pf) + (C + nG + 1) * N * 2 + N + C * Lf + 7 * F + 3 * kFrameWarps;
  if (pf) n += N + 2 * hop + F + 2 * F + 5 * (1 + C) * F + F + C * F + 3 * F;
  return n;
}

// bm [B, C, T*Lf], d [B, T*Lf], yp [B, T, F], up [B, C, T, F] (kPF),
// tabs [N/2 twiddles as (cos, sin) | N window] -> out [B, T*Lf], p [B, T, F].
// CT = C, a compile-time constant from 1 to 7; or CT = 0 above that, C =
// c_run at run time, the per-bin loops over channels in pairs, and the
// block's buffers in the global scratch work (round4z(smem_floats(C, Lf,
// kPF)) floats a block, plain copies for the prefetch) where they do not fit
// in shared memory (work null).
template <int CT, bool kPF>
__global__ void __launch_bounds__(kFrameThreads, 1) tdgsc_kernel(const float* __restrict__ bm, const float* __restrict__ d,
                                                              const float* __restrict__ yp, const float* __restrict__ up,
                                                              const float* __restrict__ tabs, float* __restrict__ out,
                                                              float* __restrict__ pout, int T, int Lf, int logN,
                                                              TdgscParams prm, int c_run, float* work) {
  static_assert(CT >= 0 && CT <= 7, "built for C = M - 1 = 1 .. 7, or 0: C at run time");
  extern __shared__ float4 smem4[];
  const int C = CT > 0 ? CT : c_run;
  const bool in_global = CT == 0 && work != nullptr;
  // nQ gradient pairs (an even C's last pair with an empty second half),
  // then constrained-gradient and update pairs; nG with the postfiltered
  // beam, the second signal of pair C / 2 (with gradient C - 1 for an odd
  // C, alone in a pair of its own for an even one)
  const int nQ = (C + 1) / 2;
  const int nG = (C + (kPF ? 1 : 0) + 1) / 2;
  const int N = 2 * Lf, hop = Lf, F = Lf + 1;
  const int tid = threadIdx.x;
  const size_t S = (size_t)T * hop;
  const int slot = slot_floats(C, Lf, kPF);
  const int o_d = round4(C * hop), o_y = o_d + round4(hop), o_u = o_y + round4(F);
  float* ring = in_global ? work + blockIdx.x * round4z(smem_floats(C, Lf, kPF))
                          : reinterpret_cast<float*>(smem4);  // [2][slot] this and the next frame's inputs
  float2* Z = reinterpret_cast<float2*>(ring + 2 * slot);  // [C][N] x_c + i w_c; then the nQ constrained pairs
  float2* Gb = Z + C * N;                             // [nG][N] output inverse (Gb[0]); gradient, then update pairs
  float2* E2 = Gb + nG * N;                           // [N] error + i postfilter analysis
  float2* tw = E2 + N;                                // [N/2]
  float* wt = reinterpret_cast<float*>(tw + N / 2);    // [C][Lf] taps
  float* Pw = wt + C * Lf;                             // [F] FLMS power
  float* ms = Pw + F;                                  // [5][F] MCRA S, Smin, Stmp, P, Lam
  float* gate = ms + 5 * F;                            // [F] per-bin step gate
  float* win = gate + F;                               // postfilter: [N] window
  float* prev = win + N;                               // [hop] previous canceller output block
  float* ola = prev + hop;                             // [hop] overlap-add tail
  float* pw0 = ola + hop;                              // [F] beam power
  float* ybr = pw0 + F;                                // [F] beam spectrum
  float* ybi = ybr + F;                                // [F]
  float* oms = ybi + F;                                // [5][1+C][F] OM-LSA's MCRA trackers
  float* zY = oms + 5 * (1 + C) * F;                   // [F] zeta_Y
  float* zU = zY + F;                                  // [C][F] zeta_U
  float* olam = zU + C * F;                            // [F] noise PSD
  float* ogam = olam + F;                              // [F] gamma carry
  float* ogh1 = ogam + F;                              // [F] G_H1 carry
  float* redx = kPF ? ogh1 + F : gate + F;             // [2][kFrameWarps] max |x| of a frame's analyses
  float* redw = redx + 2 * kFrameWarps;                // [kFrameWarps] max |w| of the taps

  const float* bmb = bm + (size_t)blockIdx.x * C * S;
  const float* db = d + (size_t)blockIdx.x * S;
  float* ob = out + (size_t)blockIdx.x * S;
  // the next frame's inputs into ring slot t & 1
  auto prefetch = [&](int t) {
    float* sl = ring + (t & 1) * slot;
    if (in_global) {  // no cp.async into global memory: plain copies, seen after the next barrier
      for (int c = 0; c < C; ++c) copy_floats(sl + c * hop, bmb + c * S + (size_t)t * hop, hop);
      copy_floats(sl + o_d, db + (size_t)t * hop, hop);
      copy_floats(sl + o_y, yp + ((size_t)blockIdx.x * T + t) * F, F);
      if (kPF)
        for (int c = 0; c < C; ++c) copy_floats(sl + o_u + c * F, up + (((size_t)blockIdx.x * C + c) * T + t) * F, F);
      return;
    }
    for (int c = 0; c < C; ++c) prefetch_floats(sl + c * hop, bmb + c * S + (size_t)t * hop, hop);
    prefetch_floats(sl + o_d, db + (size_t)t * hop, hop);
    prefetch_floats(sl + o_y, yp + ((size_t)blockIdx.x * T + t) * F, F);
    if (kPF)
      for (int c = 0; c < C; ++c) prefetch_floats(sl + o_u + c * F, up + (((size_t)blockIdx.x * C + c) * T + t) * F, F);
    copy_async_commit();
  };
  prefetch(0);
  const float2* twg = reinterpret_cast<const float2*>(tabs);
  for (int i = tid; i < N / 2; i += kFrameThreads) tw[i] = twg[i];
  for (int i = tid; i < C * Lf; i += kFrameThreads) wt[i] = 0.f;
  for (int i = tid; i < 3 * kFrameWarps; i += kFrameThreads) redx[i] = 0.f;  // redx and redw
  for (int i = tid; i < 6 * F; i += kFrameThreads) Pw[i] = 0.f;  // Pw and the MCRA state
  if (kPF) {
    for (int i = tid; i < N; i += kFrameThreads) win[i] = tabs[N + i];
    for (int i = tid; i < 2 * hop; i += kFrameThreads) prev[i] = 0.f;  // prev and ola
    for (int i = tid; i < 5 * (1 + C) * F; i += kFrameThreads) oms[i] = 0.f;
    for (int k = tid; k < F; k += kFrameThreads) {
      zY[k] = 1.f;
      olam[k] = 0.f;
      ogam[k] = ogh1[k] = 1.f;
    }
    for (int i = tid; i < C * F; i += kFrameThreads) zU[i] = 0.f;
  }
  const float invN = 1.f / (float)N;
  copy_async_wait_all();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* cur = ring + (t & 1) * slot;
    const float* old = ring + ((t + 1) & 1) * slot;  // frame t - 1's blocks
    const float* fp = cur + o_y;
    // ---- load: x_c = [b_{t-1}, b_t] + i 2^e w_c, bit-reversed
    float mx = 0.f, mw = 0.f;
    for (int w = 0; w < kFrameWarps; ++w) {
      mx = fmaxf(mx, redx[((t + 1) & 1) * kFrameWarps + w]);
      mw = fmaxf(mw, redw[w]);
    }
    const int e = pack_exponent(mx, mw);
    const float ws = ldexpf(1.f, e), inv_ws = ldexpf(1.f, -e);
    float lx = 0.f;
    for (int i = tid; i < C * N; i += kFrameThreads) {
      const int c = i >> logN, n = i & (N - 1);
      const float x = n < hop ? (t > 0 ? old[c * hop + n] : 0.f) : cur[c * hop + n - hop];
      lx = fmaxf(lx, fabsf(x));
      Z[c * N + swz(bitrev(n, logN), logN)] = make_float2(x, n < Lf ? ws * wt[c * Lf + n] : 0.f);
    }
    warp_max_partial(lx, redx + (t & 1) * kFrameWarps);
    __syncthreads();
    if (t + 1 < T) prefetch(t + 1);  // into frame t - 1's slot, read for the last time above
    fft_batch<false>(Z, C, N, logN, tw);
    __syncthreads();

    // ---- per bin: MCRA and the step gate, filter output, FLMS power
    for (int k = tid; k < F; k += kFrameThreads) {
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
        float2 X, W;
        split_pair(Z + c * N, k, N, logN, X, W);
        W = make_float2(W.x * inv_ws, W.y * inv_ws);
        yr = yr + (X.x * W.x - X.y * W.y);
        yi = yi + (X.x * W.y + X.y * W.x);
        pwr = pwr + (X.x * X.x + X.y * X.y);
      }
      Pw[k] = fmaxf(prm.alpha * Pw[k] + prm.one_m_alpha * pwr, 1e-4f);
      put_pair(Gb, k, N, logN, make_float2(yr, yi), make_float2(0.f, 0.f));
    }
    __syncthreads();
    fft_batch<true>(Gb, 1, N, logN, tw);
    __syncthreads();

    // ---- canceller output e (the last hop of the inverse, from the delayed
    // FBF); error spectrum input [0; e] + i postfilter analysis input w [prev; e]
    for (int n = tid; n < hop; n += kFrameThreads) {
      const float e = cur[o_d + n] - Gb[swz(hop + n, logN)].x * invN;
      if (!kPF) ob[(size_t)t * hop + n] = e;
      E2[swz(bitrev(n, logN), logN)] = make_float2(0.f, kPF ? win[n] * prev[n] : 0.f);
      E2[swz(bitrev(n + hop, logN), logN)] = make_float2(e, kPF ? win[n + hop] * e : 0.f);
      if (kPF) prev[n] = e;
    }
    __syncthreads();
    fft_batch<false>(E2, 1, N, logN, tw);
    __syncthreads();

    // ---- per bin: gradients conj(X_c) E / P in pairs; beam spectrum and power
    for (int k = tid; k < F; k += kFrameThreads) {
      float2 E, Y;
      split_pair(E2, k, N, logN, E, Y);
      const float P = Pw[k];
      if constexpr (CT > 0) {
        float2 gr[2 * ((CT + (kPF ? 1 : 0) + 1) / 2)];
#pragma unroll
        for (int c = 0; c < 2 * nG; ++c) {
          gr[c] = make_float2(0.f, 0.f);
          if (c < C) {
            float2 X, W;
            split_pair(Z + c * N, k, N, logN, X, W);
            gr[c] = grad_bin(X, E, P);
          }
        }
#pragma unroll
        for (int q = 0; q < nG; ++q) put_pair(Gb + q * N, k, N, logN, gr[2 * q], gr[2 * q + 1]);
      } else {
        for (int q = 0; q < nG; ++q) {
          float2 g2[2];
          for (int h = 0; h < 2; ++h) {
            const int c = 2 * q + h;
            g2[h] = make_float2(0.f, 0.f);
            if (c < C) {
              float2 X, W;
              split_pair(Z + c * N, k, N, logN, X, W);
              g2[h] = grad_bin(X, E, P);
            }
          }
          put_pair(Gb + q * N, k, N, logN, g2[0], g2[1]);
        }
      }
      if (kPF) {
        ybr[k] = Y.x;
        ybi[k] = Y.y;
        pw0[k] = Y.x * Y.x + Y.y * Y.y;
      }
    }
    __syncthreads();

    if (kPF) {
      const float* pu = cur + o_u;  // [C][F] this frame's reference powers
      // ---- OM-LSA-multi: 1 + C MCRA trackers, TBRR q, gain; sqrt(G) Y is real signal C
      const bool first = t == 0;
      for (int k = tid; k < F; k += kFrameThreads) {
        const BinKind bk = bin_kind(k, F);
        // mu_m: tracker m's noise PSD, which it also keeps as its Lam (read
        // back from there where C is not a compile-time constant)
        float mu[1 + (CT > 0 ? CT : 0)];
        const float* lam_row = oms + 4 * (1 + C) * F + k;
#pragma unroll
        for (int m = 0; m <= C; ++m) {
          const float* row = m == 0 ? pw0 : pu + (m - 1) * F;
          const float Sf = prm.ob0 * row[k > 0 ? k - 1 : 0] + prm.ob1 * row[k] + prm.ob2 * row[k < F - 1 ? k + 1 : F - 1];
          McraLane st = load_mcra(oms, (1 + C) * F, m * F + k);
          float sr, lam;
          mcra_frame(st, t, row[k], Sf, bk, prm.om, CT > 0 ? mu[m] : lam, sr);
          store_mcra(oms, (1 + C) * F, m * F + k, st);
        }
        const float y = pw0[k];
        const float zy = first ? y : prm.o_alpha_s * zY[k] + prm.o_one_m_alpha_s * smooth_zero(pw0, k, F);
        const float mu0 = CT > 0 ? mu[0] : lam_row[0];
        zY[k] = zy;
        float ref_max = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float* row = pu + c * F;
          const float zu = first ? row[k] : prm.o_alpha_s * zU[c * F + k] + prm.o_one_m_alpha_s * smooth_zero(row, k, F);
          zU[c * F + k] = zu;
          const float muc = CT > 0 ? mu[1 + c] : lam_row[(1 + c) * F];
          ref_max = c == 0 ? zu - muc : fmaxf(ref_max, zu - muc);
        }
        float omega = fmaxf(zy - mu0, 1e-6f) / (fmaxf(ref_max, prm.o_eps * mu0) + 1e-6f);
        omega = fminf(fmaxf(omega, 0.1f), 100.f);
        const float gamma_s = fminf(y / (mu0 * prm.o_bmin + 1e-6f), 100.f);
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
        add_pair_b(Gb + (C / 2) * N, k, N, logN, make_float2(sg * ybr[k], sg * ybi[k]));
      }
      __syncthreads();  // postfilter only
    }
    fft_batch<true>(Gb, nG, N, logN, tw);  // gradients (and the postfiltered beam)
    __syncthreads();

    // ---- gradient constraint: keep the first Lf samples, in pairs; postfilter synthesis
    for (int i = tid; i < nQ * N; i += kFrameThreads) {
      const int q = i >> logN, n = i & (N - 1);
      const float2 g = Gb[q * N + swz(n, logN)];
      const bool keep = n < Lf;
      Z[q * N + swz(bitrev(n, logN), logN)] =
          make_float2(keep ? g.x * invN : 0.f, keep && 2 * q + 1 < C ? g.y * invN : 0.f);
    }
    if (kPF) {
      const float2* sy = Gb + (C / 2) * N;
      for (int n = tid; n < hop; n += kFrameThreads) {
        const float f0 = sy[swz(n, logN)].y * invN * win[n] * prm.syn_gain;
        const float f1 = sy[swz(n + hop, logN)].y * invN * win[n + hop] * prm.syn_gain;
        ob[(size_t)t * hop + n] = f0 + ola[n];
        ola[n] = f1;
      }
    }
    __syncthreads();
    fft_batch<false>(Z, nQ, N, logN, tw);
    __syncthreads();

    // ---- per-bin gate, in pairs
    for (int k = tid; k < F; k += kFrameThreads) {
      const float g = gate[k];
#pragma unroll
      for (int q = 0; q < nQ; ++q) {
        float2 G0, G1;
        split_pair(Z + q * N, k, N, logN, G0, G1);
        put_pair(Gb + q * N, k, N, logN, make_float2(G0.x * g, G0.y * g),
                 2 * q + 1 < C ? make_float2(G1.x * g, G1.y * g) : make_float2(0.f, 0.f));
      }
    }
    __syncthreads();
    fft_batch<true>(Gb, nQ, N, logN, tw);
    __syncthreads();

    // ---- back to taps: update and fir_truncate
    float lw = 0.f;
    for (int i = tid; i < C * Lf; i += kFrameThreads) {
      const int c = i / Lf, n = i - c * Lf;
      const float2 u = Gb[(c >> 1) * N + swz(n, logN)];
      const float w_new = wt[i] + prm.mu2 * (((c & 1) ? u.y : u.x) * invN);
      wt[i] = (n >= prm.ft && n < Lf - prm.ft) ? w_new : 0.f;
      lw = fmaxf(lw, fabsf(wt[i]));
    }
    warp_max_partial(lw, redw);
    copy_async_wait_all();  // the next frame's inputs
    __syncthreads();
  }
}

template <int C, bool kPF>
cudaError_t launch(const float* bm, const float* d, const float* yp, const float* up, const float* tabs, float* out,
                   float* p, int B, int T, int Lf, int logN, const TdgscParams& prm, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(C, Lf, kPF);
  const cudaError_t e = allow_smem(tdgsc_kernel<C, kPF>, smem);
  if (e != cudaSuccess) return e;
  tdgsc_kernel<C, kPF><<<B, kFrameThreads, smem, st>>>(bm, d, yp, up, tabs, out, p, T, Lf, logN, prm, C, nullptr);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(const float* bm, const float* d, const float* yp, const float* up, const float* tabs,
                     float* out, float* p, int B, int T, int Lf, int logN, const TdgscParams& prm, cudaStream_t st) {
  if (up != nullptr) return launch<C, true>(bm, d, yp, up, tabs, out, p, B, T, Lf, logN, prm, st);
  return launch<C, false>(bm, d, yp, up, tabs, out, p, B, T, Lf, logN, prm, st);
}

// Whether the block's buffers at C channels fit in shared memory.
bool fits_smem(int C, int Lf, bool pf) { return sizeof(float) * smem_floats(C, Lf, pf) <= kMaxSmem; }

// C > 7: tdgsc_kernel<0, kPF>, in shared memory where it fits, else in scratch.
template <bool kPF>
cudaError_t launch_any(const float* bm, const float* d, const float* yp, const float* up, const float* tabs,
                       float* out, float* p, float* scratch, int C, int B, int T, int Lf, int logN,
                       const TdgscParams& prm, cudaStream_t st) {
  const bool smem_ok = fits_smem(C, Lf, kPF);
  if (!smem_ok && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_ok ? sizeof(float) * smem_floats(C, Lf, kPF) : 0;
  const cudaError_t e = allow_smem(tdgsc_kernel<0, kPF>, smem);
  if (e != cudaSuccess) return e;
  tdgsc_kernel<0, kPF><<<B, kFrameThreads, smem, st>>>(bm, d, yp, up, tabs, out, p, T, Lf, logN, prm, C,
                                                        smem_ok ? nullptr : scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of global scratch the launch needs at C channels (0 where the
// block's buffers fit in shared memory, always up to C = 7), -1 for a shape
// the launcher does not take.
long long fused_tdgsc_scratch_floats(int C, int B, int Lf, int pf) {
  if (C < 1 || log2_of_twice(Lf) < 0) return -1;
  return C <= 7 || fits_smem(C, Lf, pf != 0) ? 0 : (long long)B * round4z(smem_floats(C, Lf, pf != 0));
}

// C (= M - 1 blocking-matrix channels) 1 or more; up null: the core kernel,
// else the postfilter variant.  Above C = 7 the kernel takes C at run time,
// its buffers in scratch where they do not fit in shared memory
// (fused_tdgsc_scratch_floats).
cudaError_t fused_tdgsc_launch(const void* bm, const void* d, const void* yp, const void* up, const void* tabs,
                               void* out, void* p, void* scratch, int C, int B, int T, int Lf, const void* params,
                               void* stream) {
  const int logN = log2_of_twice(Lf);
  if (logN < 0 || B < 1 || T < 1) return cudaErrorInvalidValue;
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
    case 2: return launch_c<2>(bf, df, yf, uf, tf, of, pf, B, T, Lf, logN, prm, st);
    case 3: return launch_c<3>(bf, df, yf, uf, tf, of, pf, B, T, Lf, logN, prm, st);
    case 4: return launch_c<4>(bf, df, yf, uf, tf, of, pf, B, T, Lf, logN, prm, st);
    case 5: return launch_c<5>(bf, df, yf, uf, tf, of, pf, B, T, Lf, logN, prm, st);
    case 6: return launch_c<6>(bf, df, yf, uf, tf, of, pf, B, T, Lf, logN, prm, st);
    case 7: return launch_c<7>(bf, df, yf, uf, tf, of, pf, B, T, Lf, logN, prm, st);
    default:
      if (C < 1) return cudaErrorInvalidValue;
      float* sc = static_cast<float*>(scratch);
      if (uf != nullptr) return launch_any<true>(bf, df, yf, uf, tf, of, pf, sc, C, B, T, Lf, logN, prm, st);
      return launch_any<false>(bf, df, yf, uf, tf, of, pf, sc, C, B, T, Lf, logN, prm, st);
  }
}

const char* flms_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
