// WPE's RLS recursion over a whole subband spectrogram in one kernel, and its
// C launcher.
//
// Replaces no TPU kernel: the JAX package runs wpe_run as a lax.scan of
// wpe_step (distantspeech_tpu/derev/wpe.py) and has no Pallas kernel for it.
// It was added because the port's recursion, ~35 torch operations a frame
// (derev.wpe._recursion, the plain version), streams P-sized temporaries
// through device memory: at nara_wpe's widths (8 channels x 10 taps, an
// 80 x 80 complex P a bin, 105 MB at B = 8) 0.53 ms a frame, 97% of a
// reverb8.wpe_srp.b8 call.  Here each bin's state stays on chip for all its
// frames.
//
// What it computes, per (utterance, bin) state and frame t, in float32:
// wpe_step's mathematics, with K = C N taps and X the regressor of each
// channel's spectra delay .. delay + N - 1 frames back (zero before frame 0):
//
//   e   = d - W^H X                          (W: C x K, e and d: C)
//   s2  = alpha s2 + (1 - alpha) |d|^2 / C   (the PSD normaliser)
//   u   = P X,  den = lambda s2 + X^H u,  k = u / den
//   P  <- (P - k u^H) / lambda               (u^H = X^H P, as P is Hermitian)
//   W  <- W + conj(e) k^T
//
// from wpe_init's state (P = p_init I, W = 0, s2 = 0).  P is kept as its
// Hermitian lower half: it stays exactly Hermitian (the frame loop's float32
// P drifts from it by rounding), its diagonal real and X^H u real.
//
// Design.  A group of G threads steps one state through every frame; a block
// holds S groups (S > 1 where K is small) that step their frames together.
// Two block barriers a frame:
//
//   1. Every thread forms den_{t-1} and k = u / den from the last frame's
//      sums (two 16-byte loads).  P's lower half, in 4 x 4 tiles (K padded
//      with zero rows and columns to Kp, a multiple of 4), lies in
//      registers: tile (I, J), I >= J, on one thread (two tiles a thread
//      above K = 88).  A frame is one sweep over the tiles: the thread
//      applies frame t - 1's rank-1 update to its tile and from the updated
//      entries forms the tile's shares of u = P X, its rows' (P X) and its
//      columns' (the upper half's, P^H X).  The shares go to shared memory as
//      part[B][i], row i's share from tile block B, each (B, i) written once
//      a frame.  W lies in shared memory in chunks of 4 taps of one channel;
//      after its tile, a chunk's thread applies frame t - 1's update to it
//      and forms its share of W^H X_t.
//   2. Thread i < Kp sums row i's R = Kp / 4 shares into u_i and its term of
//      X^H u, summed by warp shuffles (one sum a group of <= 32 threads, else
//      one a warp of rows), and builds frame t + 1's X_i from the ring below;
//      thread e0 + c sums channel c's shares into e_c and writes it out, and
//      thread v0 steps s2, on warps of their own.
//
// The spectra come straight from D through its strides (wpe_analysis's
// movedim view: no copy), by cp.async, kChunk frames at a time and a chunk
// ahead, into a ring of the last 2^r >= 2 kChunk + delay + N - 1 frames of
// each channel.
//
// What bounds it on an H100, at reverb8.wpe_srp.b8 (B = 8, F = 257, T = 500,
// K = 80: 224 threads a state, two blocks an SM, 8 waves): operations, 90.5
// GFLOP (portbench/roofline/wpe.py's count), 1.35 ms at 67 TFLOP/s.  Kept in
// shared memory, P's half would be read and written once a frame, 2 x 25.9
// KB a state-frame, a floor of ~1.6 ms (~3.2 ms for the full P); in
// registers it costs no shared-memory traffic.  What sets its time is the
// frame's chain: one block alone on an SM takes ~2,800 cycles a frame (the
// sweep ~1,000, W's chunks ~500, the row sums ~650, the shuffles ~300, den
// and the barriers the rest), and the two blocks of an SM overlap.  Moving
// W's chunks to phase 2's idle warps, the error sums to phase 1, W into
// registers or the sums into batches of loads was slower (PERF.md).
#include <cuda_runtime.h>

#include "flms_fft.cuh"

// Field order and types are mirrored by _WpeParams in ops/cuda_wpe.py.
struct WpeParams {
  float lam, inv_lam;        // the forgetting factor and its reciprocal
  float alpha, one_m_alpha;  // the PSD normaliser's smoothing
  float p_init, inv_c;       // P's start (times I) and 1 / C
};

namespace {

constexpr int kTile = 4;          // P's tiles: kTile x kTile entries
constexpr int kChunk = 16;        // frames a prefetch brings
constexpr int kMaxK = 160;        // C N
constexpr int kMaxC = 32;         // channels
constexpr int kMaxReach = 200;    // delay + N
constexpr int kSmallGroup = 64;   // groups of up to this many threads share a block of kSmallBlock
constexpr int kSmallBlock = 128;

// A state's group and its shared memory; offsets in floats from the group's
// region, every region a multiple of 4 floats.  Phase 2's roles: threads
// 0 .. Kp - 1 the rows, e0 .. e0 + C - 1 the channels' errors, v0 the
// normaliser (e0 and v0 on warps of their own where the group is larger than
// one).
struct Layout {
  int K, Kp, R, tiles, tpt, e0, v0, G, S, ring, ps;
  int o_part, o_w, o_ep, o_ring, o_x, o_u, o_e, o_q, per_state;
};

__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }

// Threads for n: a power of two up to 32, else a multiple of 32.
inline int group_of(int n) {
  if (n > 32) return (n + 31) / 32 * 32;
  int g = 1;
  while (g < n) g *= 2;
  return g;
}

bool valid(int C, int N, int delay) {
  return C >= 1 && N >= 1 && C <= kMaxC && C * N <= kMaxK && delay >= 1 && delay + N <= kMaxReach;
}

Layout layout(int C, int N, int delay) {
  Layout L{};
  L.K = C * N;
  L.Kp = up4(L.K);
  L.R = L.Kp / kTile;
  L.tiles = L.R * (L.R + 1) / 2;
  const bool small = L.Kp + C + 1 <= 32;
  L.e0 = small ? L.Kp : (L.Kp + 31) / 32 * 32;
  L.v0 = small ? L.e0 + C : L.e0 + (C + 31) / 32 * 32;
  const int phase2 = L.v0 + 1;
  L.tpt = group_of(max(L.tiles, phase2)) <= 256 ? 1 : 2;
  L.G = group_of(max((L.tiles + L.tpt - 1) / L.tpt, phase2));
  L.S = L.G <= kSmallGroup ? kSmallBlock / L.G : 1;
  L.ring = 1;
  while (L.ring < 2 * kChunk + delay + N - 1) L.ring *= 2;
  L.ps = 2 * L.Kp + 4;  // part's row stride: 4 floats of padding, so that a warp's row shares fall in distinct banks
  int o = 0;
  L.o_part = o, o += up4(L.R * L.ps);
  L.o_w = o, o += up4(2 * C * L.Kp);
  L.o_ep = o, o += up4(2 * L.R * C);
  L.o_ring = o, o += up4(2 * L.ring * C);
  L.o_x = o, o += up4(4 * L.Kp);  // X of two frames
  L.o_u = o, o += up4(2 * L.Kp);
  L.o_e = o, o += up4(2 * C);
  L.o_q = o, o += 8;  // X^H u's sums, one a warp of rows (<= 5), zeros, s2 last
  L.per_state = o;
  return L;
}

size_t smem_bytes(const Layout& L) { return sizeof(float) * (size_t)L.S * L.per_state; }

__device__ __forceinline__ float2 f2(float x, float y) { return make_float2(x, y); }
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return f2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 cscale(float2 a, float s) { return f2(a.x * s, a.y * s); }
// acc + a b
__device__ __forceinline__ float2 cmac(float2 acc, float2 a, float2 b) {
  return f2(acc.x + a.x * b.x - a.y * b.y, acc.y + a.x * b.y + a.y * b.x);
}
// acc + conj(a) b
__device__ __forceinline__ float2 cmacc(float2 acc, float2 a, float2 b) {
  return f2(acc.x + a.x * b.x + a.y * b.y, acc.y + a.x * b.y - a.y * b.x);
}

// 1 / x for a normal x > 0 without IEEE division's slow-path branch:
// MUFU.RCP and one Newton step, within an ulp of 1.f / x (enhance.cu's).
__device__ __forceinline__ float rcp_nr(float x) {
  const float r = __fdividef(1.f, x);
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

// Four consecutive complex values from (to) shared memory, 16-byte aligned.
__device__ __forceinline__ void ld4(const float2* p, float2 (&v)[4]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = f2(a.x, a.y), v[1] = f2(a.z, a.w), v[2] = f2(b.x, b.y), v[3] = f2(b.z, b.w);
}
__device__ __forceinline__ void st4(float2* p, const float2 (&v)[4]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[2].x, v[2].y, v[3].x, v[3].y);
}

// D [T, NB, F, C] complex through its strides (complex elements) -> e, the
// same shape, contiguous.  Block b holds the states b S .. b S + S - 1 (of
// NS = NB F, utterance-major), group s of its threads state b S + s.
template <int kTpt>
__global__ void __launch_bounds__(kTpt == 1 ? 256 : 512, kTpt == 1 ? 2 : 1)
    wpe_kernel(const float2* __restrict__ D, long long sT, long long sB, long long sF, long long sC,
               float2* __restrict__ out, int T, int NS, int F, int C, int N, int delay, Layout L, WpeParams prm) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int s = tid / L.G, g = tid - s * L.G;
  const int state = blockIdx.x * L.S + s;
  const bool live = state < NS;  // a group past the last state idles, but passes the barriers
  const int Kp = L.Kp, R = L.R, K = L.K, mask = L.ring - 1;
  float* sm = smem + (size_t)s * L.per_state;
  float2* part = reinterpret_cast<float2*>(sm + L.o_part);
  float2* W = reinterpret_cast<float2*>(sm + L.o_w);
  float2* ep = reinterpret_cast<float2*>(sm + L.o_ep);
  float2* ring = reinterpret_cast<float2*>(sm + L.o_ring);
  float2* xv = reinterpret_cast<float2*>(sm + L.o_x);
  float2* uv = reinterpret_cast<float2*>(sm + L.o_u);
  float2* ev = reinterpret_cast<float2*>(sm + L.o_e);
  float* qs = sm + L.o_q;  // qs[w]: warp w's sum of X^H u; qs[7]: s2; zeros between
  const int ps2 = L.ps / 2;  // part's row stride in complex values

  // Issues the copies of frames f0 .. f0 + kChunk - 1 (those before T) of
  // every state of the block into the rings.
  auto prefetch = [&](int f0) {
    const int per = (min(f0 + kChunk, T) - f0) * C;
    for (int i = tid; i < L.S * per; i += nthr) {
      const int ss = i / per, r = i - ss * per, f = f0 + r / C, c = r - (r / C) * C;
      const int st = blockIdx.x * L.S + ss;
      if (st >= NS) continue;
      const float* src = reinterpret_cast<const float*>(D + (st / F) * sB + (st % F) * sF + f * sT + c * sC);
      float* dst = smem + (size_t)ss * L.per_state + L.o_ring + 2 * ((f & mask) * C + c);
      copy_async4(dst, src);
      copy_async4(dst + 1, src + 1);
    }
    copy_async_commit();
  };

  // The zero state: the rings (frames before 0 read as zeros), W, u, e.
  for (int i = tid; i < L.S * L.per_state; i += nthr) {
    const int r = i % L.per_state;
    if ((r >= L.o_ring && r < L.o_ring + 2 * L.ring * C) || (r >= L.o_w && r < L.o_w + 2 * C * Kp) ||
        (r >= L.o_u && r < L.o_u + 2 * Kp) || (r >= L.o_e && r < L.o_e + 2 * C) || r >= L.o_q)
      smem[i] = 0.f;
  }
  __syncthreads();
  prefetch(0);
  copy_async_wait_all();
  if (kChunk < T) prefetch(kChunk);

  // Thread g's tiles (I, J), I >= J: tile index g + j G.
  int ti[kTpt], tj[kTpt];
  bool own[kTpt];
  float2 p[kTpt][kTile][kTile];
#pragma unroll
  for (int j = 0; j < kTpt; ++j) {
    const int tau = g + j * L.G;
    own[j] = live && tau < L.tiles;
    int I = 0;
    while ((I + 1) * (I + 2) / 2 <= tau) ++I;
    ti[j] = I, tj[j] = tau - I * (I + 1) / 2;
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b)
        p[j][a][b] = f2(ti[j] == tj[j] && a == b && kTile * ti[j] + a < K ? prm.p_init : 0.f, 0.f);
  }
  // Row thread g < K: its tap (channel gc, delay gn) of X.
  const int gc = g < K ? g / N : 0, gn = g < K ? g - gc * N : 0;
  auto regressor = [&](int t) {
    const int f = t - delay - gn;
    return g < K && f >= 0 ? ring[(f & mask) * C + gc] : f2(0.f, 0.f);
  };
  const int ec = g - L.e0;  // phase 2: channel ec's error (0 <= ec < C)
  __syncthreads();  // frame 0's chunk in every ring
  float2 xg = f2(0.f, 0.f);  // X_t of row g
  if (live && g < Kp) xv[g] = xg = regressor(0);
  float s2 = 0.f;  // the normaliser, on thread v0
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (t > 0 && t % kChunk == 0 && t + kChunk < T) prefetch(t + kChunk);
    // ---- 1. frame t - 1's updates of P and W; the shares of P X_t and W^H X_t
    const float2* xt = xv + (t & 1) * Kp;
    float scale = 1.f, coef = 0.f, rden = 0.f;  // frame 0: P from wpe_init, no update
    if (t > 0) {
      const float4 a = reinterpret_cast<const float4*>(qs)[0], b = reinterpret_cast<const float4*>(qs)[1];
      const float q = b.w * prm.lam + (((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + b.z));
      rden = rcp_nr(q);
      coef = rden * prm.inv_lam;
      scale = prm.inv_lam;
    }
#pragma unroll
    for (int j = 0; j < kTpt; ++j) {
      if (!own[j]) continue;
      const int I = ti[j], J = tj[j];
      const bool diag = I == J;
      float2 xr[kTile], xc[kTile], a[kTile], u[kTile], r[kTile], c[kTile];
      ld4(xt + kTile * I, xr);
      ld4(xt + kTile * J, xc);
      ld4(uv + kTile * I, a);
      ld4(uv + kTile * J, u);
#pragma unroll
      for (int i = 0; i < kTile; ++i) a[i] = cscale(a[i], coef), r[i] = c[i] = f2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          if (diag && k > i) continue;
          float2& v = p[j][i][k];
          // v <- v / lambda - (k_i / lambda) conj(u_k)
          v.x = v.x * scale - (a[i].x * u[k].x + a[i].y * u[k].y);
          v.y = diag && k == i ? 0.f : v.y * scale - (a[i].y * u[k].x - a[i].x * u[k].y);
          r[i] = cmac(r[i], v, xc[k]);
          if (!diag || k < i) c[k] = cmacc(c[k], v, xr[i]);
        }
      }
      if (diag) {
#pragma unroll
        for (int i = 0; i < kTile; ++i) r[i] = cadd(r[i], c[i]);
        st4(part + I * ps2 + kTile * I, r);
      } else {
        st4(part + J * ps2 + kTile * I, r);
        st4(part + I * ps2 + kTile * J, c);
      }
    }
    if (live) {  // W in chunks of kTile taps of one channel
      for (int ch = g; ch < C * R; ch += L.G) {
        const int c = ch / R, B = ch - c * R;
        float2 w[kTile], x[kTile];
        ld4(W + c * Kp + kTile * B, w);
        ld4(xt + kTile * B, x);
        if (t > 0) {
          float2 kn[kTile];
          ld4(uv + kTile * B, kn);
          const float2 ce = f2(ev[c].x, -ev[c].y);
#pragma unroll
          for (int k = 0; k < kTile; ++k) w[k] = cmac(w[k], ce, cscale(kn[k], rden));
          st4(W + c * Kp + kTile * B, w);
        }
        float2 acc = f2(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kTile; ++k) acc = cmacc(acc, w[k], x[k]);
        ep[B * C + c] = acc;
      }
    }
    __syncthreads();
    // ---- 2. u = P X_t and X_t^H u; e_t; s2_t; X_{t+1}
    float q = 0.f;
    if (live && g < Kp) {
      float2 acc = f2(0.f, 0.f);
      for (int B = 0; B < R; ++B) acc = cadd(acc, part[B * ps2 + g]);
      uv[g] = acc;
      q = xg.x * acc.x + xg.y * acc.y;  // Re(conj(X_g) u_g)
      if (t + 1 < T) xv[((t + 1) & 1) * Kp + g] = xg = regressor(t + 1);
    } else if (live && ec >= 0 && ec < C) {
      float2 acc = f2(0.f, 0.f);
      for (int B = 0; B < R; ++B) acc = cadd(acc, ep[B * C + ec]);
      const float2 d = ring[(t & mask) * C + ec], e = f2(d.x - acc.x, d.y - acc.y);
      ev[ec] = e;
      out[((size_t)t * NS + state) * C + ec] = e;
    } else if (live && g == L.v0) {
      float pw = 0.f;
      for (int c = 0; c < C; ++c) {
        const float2 d = ring[(t & mask) * C + c];
        pw += d.x * d.x + d.y * d.y;
      }
      s2 = prm.alpha * s2 + prm.one_m_alpha * (pw * prm.inv_c);
      qs[7] = s2;
    }
    if (g < ((Kp + 31) & ~31) || L.G <= 32)  // the rows' warps
      for (int o = min(L.G, 32) / 2; o > 0; o /= 2) q += __shfl_xor_sync(0xffffffffu, q, o);
    if (live && g < Kp && g % 32 == 0) qs[g / 32] = q;
    if ((t + 1) % kChunk == 0) copy_async_wait_all();  // the next chunk, before the barrier shows it
    __syncthreads();
  }
}

template <int kTpt>
cudaError_t launch(const float2* D, long long sT, long long sB, long long sF, long long sC, float2* out, int T, int NS,
                   int F, int C, int N, int delay, const Layout& L, const WpeParams& prm, cudaStream_t st) {
  const size_t smem = smem_bytes(L);
  const cudaError_t e = allow_smem(wpe_kernel<kTpt>, smem);
  if (e != cudaSuccess) return e;
  wpe_kernel<kTpt><<<(NS + L.S - 1) / L.S, L.S * L.G, smem, st>>>(D, sT, sB, sF, sC, out, T, NS, F, C, N, delay, L,
                                                                   prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// For C channels, N taps and the delay: a state's threads, states a block,
// P's tiles a thread and a block's shared-memory bytes; 0, or -1 for a shape
// the launcher does not take.
int wpe_shape(int C, int N, int delay, int* group, int* states, int* tiles_per_thread, long long* smem) {
  if (!valid(C, N, delay)) return -1;
  const Layout L = layout(C, N, delay);
  *group = L.G, *states = L.S, *tiles_per_thread = L.tpt, *smem = (long long)smem_bytes(L);
  return smem_bytes(L) <= kMaxSmem ? 0 : -1;
}

// D: complex64 [T, NB, F, C] through the strides sT, sB, sF, sC (complex
// elements); e: complex64 [T, NB, F, C] contiguous.  1 <= C <= 32,
// C N <= 160, delay >= 1, delay + N <= 200.
cudaError_t wpe_launch(const void* D, long long sT, long long sB, long long sF, long long sC, void* e, int T, int NB,
                       int F, int C, int N, int delay, const void* params, void* stream) {
  if (!valid(C, N, delay) || T < 1 || NB < 1 || F < 1) return cudaErrorInvalidValue;
  const Layout L = layout(C, N, delay);
  if (smem_bytes(L) > kMaxSmem) return cudaErrorInvalidValue;
  const WpeParams prm = *static_cast<const WpeParams*>(params);
  const float2* d = static_cast<const float2*>(D);
  float2* o = static_cast<float2*>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L.tpt == 1) return launch<1>(d, sT, sB, sF, sC, o, T, NB * F, F, C, N, delay, L, prm, st);
  return launch<2>(d, sT, sB, sF, sC, o, T, NB * F, F, C, N, delay, L, prm, st);
}

const char* wpe_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
