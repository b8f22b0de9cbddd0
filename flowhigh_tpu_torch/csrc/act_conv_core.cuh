// The act->conv pass shared by kernel D (act_conv1d.cu) and kernel E
// (amp_unit.cu): one block computes
//
//   out[co, l] = sum_{ci, k} w[co, ci, k] * a[ci, tstart + l + k*d - pad]
//
// for BM output channels co0 .. co0 + BM and BN = 32 * NI output samples
// l, where a = down2(snakebeta(up2(src))) is the anti-aliased snake of
// kernel A (snake_aa.cu), taken as zero outside [0, T) (the conv's zero
// padding), and src is read replicate-clamped at the sequence edges (the
// snake's own padding). The result goes to an epilogue functor
// epi(co, l, value); bias, residuals and scale are the caller's.
//
// Per chunk of CI input channels:
//   1. stage src over the conv window plus the snake's reach of 6 samples,
//      aw + 12 samples with aw = BN + 2 pad, and the chunk's weights
//      (transposed to [CI*K][BM]) and snake parameters, double-buffered:
//      the next chunk is staged (cp.async where src is in device memory)
//      while this one is computed;
//   2. form the 2x-rate snake signal over aw + 6 base-rate positions in
//      shared memory, exactly as kernel A does (same taps, same order);
//   3. downsample it into the activation over aw positions, zero outside
//      [0, T);
//   4. run kernel B's implicit GEMM over the chunk's CI*K rows, reading the
//      activation at offset k*d: each thread keeps TM channels x NI samples
//      (samples tx + 32 i, so a warp reads 32 consecutive floats per row);
//      TYB warps share the block's BM = TM * TYB output channels, so the
//      activation of a chunk is computed once per BM channels.
// The sums run in kernel B's order (chunk, channel, tap), so D and E give
// what kernel B gives on kernel A's output.
//
// Shared memory, in floats (mirrored by
// flowhigh_tpu_torch/ops/fused_conv.py:core_smem_floats):
//   weights 2 x CI*K x (BM + 4) | raw input 2 x CI x (aw + 12) |
//   snake parameters 2 x 2 x CI | snake signal CI x 2 (aw + 6) |
//   activation CI x aw | filter taps 12.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;  // threads along time (one warp)

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes a zero
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
    static_assert(N % 2 == 0, "TM must be even");
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x; v[j + 1] = q.y;
    }
  }
}

// Floats of shared memory one pass takes (see the layout above).
__host__ __device__ constexpr long long core_floats(int K, int CI, int BM,
                                                    int BN, int pad) {
  return 2LL * CI * (BN + 2 * pad + 12) + 2LL * CI * K * (BM + 4) + 4LL * CI +
         2LL * CI * (BN + 2 * pad + 6) + 1LL * CI * (BN + 2 * pad) + 12;
}

// src in device memory: x[c, clamp(g)] of one batch row [C, T], by cp.async.
struct GlobalSrc {
  const float* x;
  int T;
  __device__ __forceinline__ void stage(float* dst, int c, int g,
                                        bool ok) const {
    const int gc = min(max(g, 0), T - 1);
    cp_async4(dst, ok ? x + (long long)c * T + gc : x, ok);
  }
};

// src in shared memory: buf[c, clamp(g) - base], a [C, n] block holding
// positions base .. base + n - 1 (kernel E's conv1 output). Positions the
// block does not hold are clamped into it; they feed only outputs that are
// thrown away.
struct SmemSrc {
  const float* buf;
  int n, base, T;
  __device__ __forceinline__ void stage(float* dst, int c, int g,
                                        bool ok) const {
    const int p = min(max(min(max(g, 0), T - 1) - base, 0), n - 1);
    *dst = ok ? buf[c * n + p] : 0.0f;
  }
};

template <int K, int CI, int TM, int NI, int TYB, class Src, class Epi>
__device__ __forceinline__ void act_conv_tile(
    const Src& src, const Epi& epi, float* smem, const float* filt,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    int logscale, const float* __restrict__ w, int Cin, int Cout, int co0,
    int T, int tstart, int dil) {
  constexpr int NT = TX * TYB;  // threads
  constexpr int BN = TX * NI;   // output samples per pass
  constexpr int BM = TM * TYB;  // output channels per pass
  constexpr int R = CI * K;     // GEMM depth per chunk
  constexpr int WS = BM + 4;    // weight row stride (floats)
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int pad = dil * (K - 1) / 2;
  const int aw = BN + 2 * pad;  // activation window
  const int xw = aw + 12;       // raw input window
  const int sn = aw + 6;        // base-rate positions of the snake signal
  float* ws0 = smem;
  float* xr0 = ws0 + 2 * R * WS;
  float* ab0 = xr0 + 2 * CI * xw;
  float* ss = ab0 + 4 * CI;
  float* act = ss + 2 * CI * sn;
  float* h = act + CI * aw;
  const long long CK = (long long)Cin * K;
  const int n_chunks = (Cin + CI - 1) / CI;
  const int g0 = tstart - pad - 6;  // position of raw input 0
  // e / len for the flat loops over CI x len elements below, without an
  // integer division: (e + 0.5) / len lies at least 0.5 / len away from an
  // integer, far beyond float rounding at these sizes (e < 2^16)
  const float inv_xw = 1.0f / xw, inv_sn = 1.0f / sn, inv_aw = 1.0f / aw;
  auto split = [](int e, float inv_len) {
    return __float2int_rd((e + 0.5f) * inv_len);
  };

  if (tid < 12) h[tid] = filt[tid];  // read after the first barrier below

  auto load = [&](int chunk, int stage) {
    const int c0 = chunk * CI;
    float* xr = xr0 + stage * CI * xw;
    for (int e = tid; e < CI * xw; e += NT) {
      const int ci = split(e, inv_xw);
      src.stage(xr + e, c0 + ci, g0 + e - ci * xw, c0 + ci < Cin);
    }
    float* ws = ws0 + stage * R * WS;
    const long long rmax = CK - (long long)c0 * K;
    for (int e = tid; e < BM * R; e += NT) {
      const int co = e / R;
      const int r = e - co * R;
      const int gco = co0 + co;
      const bool ok = gco < Cout && r < rmax;
      cp_async4(ws + r * WS + co,
                ok ? w + gco * CK + (long long)c0 * K + r : w, ok);
    }
    if (tid < CI) {  // as kernel A: a = exp(alpha), 1 / (b + 1e-9)
      const int c = c0 + tid;
      float a = 1.0f, b = 1.0f;
      if (c < Cin) {
        a = alpha[c];
        b = beta != nullptr ? beta[c] : a;
        if (logscale) {
          a = expf(a);
          b = expf(b);
        }
      }
      ab0[stage * 2 * CI + tid] = a;
      ab0[stage * 2 * CI + CI + tid] = 1.0f / (b + 1e-9f);
    }
    cp_async_commit();
  };

  float acc[TM][NI];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[j][i] = 0.0f;

  const int s_base = 2 * (tstart - pad - 3);  // 2x-rate index of ss[0]
  const int s_max = 2 * T - 1;
  load(0, 0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int st = chunk & 1;
    if (chunk + 1 < n_chunks) {
      load(chunk + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 2x-rate snake signal at m = tstart - pad - 3 + i: s[2m] reads raw
    // i .. i+5, s[2m+1] reads raw i+1 .. i+6 (kernel A's arithmetic)
    const float* xr = xr0 + st * CI * xw;
    const float* ab = ab0 + st * 2 * CI;
    for (int e = tid; e < CI * sn; e += NT) {
      const int ci = split(e, inv_sn);
      const int i = e - ci * sn;
      const float* xi = xr + ci * xw + i;
      float se = 0.0f, so = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        se = fmaf(2.0f * h[2 * k], xi[k], se);
        so = fmaf(2.0f * h[2 * k + 1], xi[k + 1], so);
      }
      const float a = ab[ci];
      const float inv_b = ab[CI + ci];
      const float pe = sinf(a * se);
      const float po = sinf(a * so);
      ss[2 * e] = se + inv_b * (pe * pe);
      ss[2 * e + 1] = so + inv_b * (po * po);
    }
    __syncthreads();

    // activation at n = tstart - pad + j; the down stage clamps its 2x-rate
    // index into [0, 2T - 1] (replicate), which only the first 3 and last 4
    // samples of the sequence need; the conv sees zeros outside [0, T)
    for (int e = tid; e < CI * aw; e += NT) {
      const int ci = split(e, inv_aw);
      const int n = tstart - pad + e - ci * aw;
      const float* sc = ss + ci * 2 * sn - s_base;
      float v = 0.0f;
      if (n >= 3 && n <= T - 4) {
        const float* s0 = sc + 2 * n - 5;
#pragma unroll
        for (int q = 0; q < 12; ++q) v = fmaf(h[q], s0[q], v);
      } else if (n >= 0 && n < T) {
#pragma unroll
        for (int q = 0; q < 12; ++q) {
          const int s = min(max(2 * n + q - 5, 0), s_max);
          v = fmaf(h[q], sc[s], v);
        }
      }
      act[e] = v;
    }
    __syncthreads();

    const float* wsb = ws0 + st * R * WS + ty * TM;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a[TM];
      load_row<TM>(wsb + r * WS, a);
      const float* xp = act + (r / K) * aw + (r % K) * dil + tx;
      float v[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) v[i] = xp[TX * i];
#pragma unroll
      for (int j = 0; j < TM; ++j)
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[j][i] = fmaf(a[j], v[i], acc[j][i]);
    }
    __syncthreads();  // the next chunk's staging overwrites this one's
  }

#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int co = co0 + ty * TM + j;
    if (co >= Cout) continue;
#pragma unroll
    for (int i = 0; i < NI; ++i) epi(co, tx + TX * i, acc[j][i]);
  }
}

}  // namespace
