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
//      shared memory, as kernel A does (same taps, same order; the I8
//      instances without FMAs, see Pass::activate);
//   3. downsample it into the activation over aw positions, zero outside
//      [0, T);
//   4. run an implicit GEMM on the FMA units (kernel B.int8's) over the
//      chunk's CI*K rows, reading the activation at offset k*d: each
//      thread keeps TM channels x NI samples
//      (samples tx + 32 i, so a warp reads 32 consecutive floats per row);
//      TYB warps share the block's BM = TM * TYB output channels, so the
//      activation of a chunk is computed once per BM channels.
// The sums run in the order (chunk, channel, tap), as kernel B.int8's;
// kernel B's float32 and bf16 instances sum on the tensor cores instead.
//
// Shared memory, in floats (mirrored by
// flowhigh_tpu_torch/ops/fused_conv.py:core_smem_floats):
//   weights 2 x CI*K x (BM + 4) | raw input 2 x CI x (aw + 12) |
//   snake parameters 2 x 2 x CI | snake signal CI x 2 (aw + 6) |
//   activation CI x aw | filter taps 12.
//
// dot_dtype (dot_dtype.cuh): step 3 writes the activation as the dot of D
// stages it, after the zero mask (packed.py:829, :1188, :1199): rounded to
// bf16, or quantised with the window's scale (int32 bits); the weights come
// rounded or quantised from the host, and an I8 pass sums in int32 and
// hands epi float(acc) * (s_x * s_w[co]). The window's amax comes from
// act_amax below, a pass over the same chunks that runs steps 1-3 without
// the GEMM.

#pragma once

#include "dot_dtype.cuh"

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

// e / len for the flat loops over CI x len elements below, without an
// integer division: (e + 0.5) / len lies at least 0.5 / len away from an
// integer, far beyond float rounding at these sizes (e < 2^16)
__device__ __forceinline__ int split(int e, float inv_len) {
  return __float2int_rd((e + 0.5f) * inv_len);
}

// One pass's shared-memory layout and its steps 1-3 (see the top of this
// file), for BN output samples starting at tstart, BM output channels.
template <int K, int CI, int BM, int BN, int NT>
struct Pass {
  static constexpr int R = CI * K;   // GEMM depth per chunk
  static constexpr int WS = BM + 4;  // weight row stride (floats)
  int pad, aw, xw, sn, tstart, T;
  float inv_xw, inv_sn, inv_aw;
  float *ws0, *xr0, *ab0, *ss, *act, *h;

  __device__ __forceinline__ Pass(float* smem, int dil, int tstart_, int T_)
      : pad(dil * (K - 1) / 2), aw(BN + 2 * pad), xw(aw + 12), sn(aw + 6),
        tstart(tstart_), T(T_), inv_xw(1.0f / xw), inv_sn(1.0f / sn),
        inv_aw(1.0f / aw) {
    ws0 = smem;                  // activation window aw, raw input window
    xr0 = ws0 + 2 * R * WS;      // xw (the snake's reach of 6 each side),
    ab0 = xr0 + 2 * CI * xw;     // base-rate positions of the snake signal
    ss = ab0 + 4 * CI;           // sn
    act = ss + 2 * CI * sn;
    h = act + CI * aw;
  }

  // Step 1 without the weights: src over the chunk's raw window into stage
  // st (cp.async where src is in device memory; the caller commits), and
  // the snake parameters as kernel A takes them: a = exp(alpha),
  // 1 / (b + 1e-9).
  template <class Src>
  __device__ __forceinline__ void stage_input(
      const Src& src, int st, int c0, int Cin, const float* __restrict__ alpha,
      const float* __restrict__ beta, int logscale) const {
    const int tid = threadIdx.x;
    const int g0 = tstart - pad - 6;  // position of raw input 0
    float* xr = xr0 + st * CI * xw;
    for (int e = tid; e < CI * xw; e += NT) {
      const int ci = split(e, inv_xw);
      src.stage(xr + e, c0 + ci, g0 + e - ci * xw, c0 + ci < Cin);
    }
    if (tid < CI) {
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
      ab0[st * 2 * CI + tid] = a;
      ab0[st * 2 * CI + CI + tid] = 1.0f / (b + 1e-9f);
    }
  }

  // Steps 2 and 3 on stage st (staged and visible to all threads): the
  // activation, as the dot of D stages it (qs: the I8 scale 127 / amax).
  // ORDERED (the I8 instances) takes every product and sum as a separate
  // f32 operation rounded to nearest, in the order of
  // ops/fused_act.py:snake_activation1d_ordered, so that its plain version
  // on the card gives the same bits and the same int8 quanta; the other
  // instances let the compiler fuse them into FMAs. Ends with a barrier.
  template <Dot D, bool ORDERED = D == Dot::I8>
  __device__ __forceinline__ void activate(int st, float qs) const {
    const int tid = threadIdx.x;
    // 2x-rate snake signal at m = tstart - pad - 3 + i: s[2m] reads raw
    // i .. i+5, s[2m+1] reads raw i+1 .. i+6 (kernel A's arithmetic)
    const float* xr = xr0 + st * CI * xw;
    const float* ab = ab0 + st * 2 * CI;
    for (int e = tid; e < CI * sn; e += NT) {
      const int ci = split(e, inv_sn);
      const int i = e - ci * sn;
      const float* xi = xr + ci * xw + i;
      float se = 0.0f, so = 0.0f;
      const float a = ab[ci];
      const float inv_b = ab[CI + ci];
      if constexpr (ORDERED) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          se = __fadd_rn(se, __fmul_rn(2.0f * h[2 * k], xi[k]));
          so = __fadd_rn(so, __fmul_rn(2.0f * h[2 * k + 1], xi[k + 1]));
        }
        const float pe = sinf(__fmul_rn(se, a));
        const float po = sinf(__fmul_rn(so, a));
        ss[2 * e] = __fadd_rn(se, __fmul_rn(inv_b, __fmul_rn(pe, pe)));
        ss[2 * e + 1] = __fadd_rn(so, __fmul_rn(inv_b, __fmul_rn(po, po)));
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          se = fmaf(2.0f * h[2 * k], xi[k], se);
          so = fmaf(2.0f * h[2 * k + 1], xi[k + 1], so);
        }
        const float pe = sinf(a * se);
        const float po = sinf(a * so);
        ss[2 * e] = se + inv_b * (pe * pe);
        ss[2 * e + 1] = so + inv_b * (po * po);
      }
    }
    __syncthreads();

    // activation at n = tstart - pad + j; the down stage clamps its 2x-rate
    // index into [0, 2T - 1] (replicate), which only the first 3 and last 4
    // samples of the sequence need; the conv sees zeros outside [0, T)
    const int s_base = 2 * (tstart - pad - 3);  // 2x-rate index of ss[0]
    const int s_max = 2 * T - 1;
    for (int e = tid; e < CI * aw; e += NT) {
      const int ci = split(e, inv_aw);
      const int n = tstart - pad + e - ci * aw;
      const float* sc = ss + ci * 2 * sn - s_base;
      float v = 0.0f;
      if (n >= 3 && n <= T - 4) {
        const float* s0 = sc + 2 * n - 5;
#pragma unroll
        for (int q = 0; q < 12; ++q)
          v = ORDERED ? __fadd_rn(v, __fmul_rn(h[q], s0[q]))
                      : fmaf(h[q], s0[q], v);
      } else if (n >= 0 && n < T) {
#pragma unroll
        for (int q = 0; q < 12; ++q) {
          const int s = min(max(2 * n + q - 5, 0), s_max);
          v = ORDERED ? __fadd_rn(v, __fmul_rn(h[q], sc[s]))
                      : fmaf(h[q], sc[s], v);
        }
      }
      act[e] = stage_value<D>(v, qs);
    }
    __syncthreads();
  }
};

// The int8 window's amax: the largest |activation| over positions
// [tstart - pad, tstart + nvalid + pad) ∩ [0, T) of all Cin channels (the
// activation is zero outside [0, T)), by steps 1-3 over every chunk. Every
// thread gets it. Uses the pass's staging buffers (stage 0).
template <int K, int CI, int TM, int NI, int TYB, class Src>
__device__ __forceinline__ float act_amax(
    const Src& src, float* smem, const float* filt,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    int logscale, int Cin, int T, int tstart, int nvalid, int dil) {
  constexpr int NT = TX * TYB;
  const Pass<K, CI, TM * TYB, TX * NI, NT> P(smem, dil, tstart, T);
  __shared__ float red[32];
  const int tid = threadIdx.x;
  if (tid < 12) P.h[tid] = filt[tid];  // read after the first barrier below
  const int jmax = nvalid + 2 * P.pad;
  float m = 0.0f;
  for (int c0 = 0; c0 < Cin; c0 += CI) {
    P.stage_input(src, 0, c0, Cin, alpha, beta, logscale);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    P.template activate<Dot::F32, true>(0, 0.0f);  // the I8 arithmetic
    for (int e = tid; e < CI * P.aw; e += NT) {
      if (e - split(e, P.inv_aw) * P.aw < jmax) m = fmaxf(m, fabsf(P.act[e]));
    }
    __syncthreads();  // the next chunk's staging overwrites this one's
  }
  return block_max(m, red);
}

// The act->conv pass. D: the dot precision; q and sw (the [Cout] weight
// scales) are read by an I8 pass only.
template <Dot D, int K, int CI, int TM, int NI, int TYB, class Src, class Epi>
__device__ __forceinline__ void act_conv_tile(
    const Src& src, const Epi& epi, float* smem, const float* filt,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    int logscale, const float* __restrict__ w, int Cin, int Cout, int co0,
    int T, int tstart, int dil, Quant q = {0.0f, 0.0f},
    const float* __restrict__ sw = nullptr) {
  using A = Acc<D>;
  constexpr int NT = TX * TYB;  // threads
  constexpr int BM = TM * TYB;  // output channels per pass
  using P_t = Pass<K, CI, BM, TX * NI, NT>;
  constexpr int R = P_t::R;
  constexpr int WS = P_t::WS;
  const P_t P(smem, dil, tstart, T);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long CK = (long long)Cin * K;
  const int n_chunks = (Cin + CI - 1) / CI;

  if (tid < 12) P.h[tid] = filt[tid];  // read after the first barrier below

  auto load = [&](int chunk, int stage) {
    const int c0 = chunk * CI;
    P.stage_input(src, stage, c0, Cin, alpha, beta, logscale);
    float* ws = P.ws0 + stage * R * WS;
    const long long rmax = CK - (long long)c0 * K;
    for (int e = tid; e < BM * R; e += NT) {
      const int co = e / R;
      const int r = e - co * R;
      const int gco = co0 + co;
      const bool ok = gco < Cout && r < rmax;
      cp_async4(ws + r * WS + co,
                ok ? w + gco * CK + (long long)c0 * K + r : w, ok);
    }
    cp_async_commit();
  };

  A acc[TM][NI];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[j][i] = 0;

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
    P.template activate<D>(st, q.qs);

    const float* wsb = P.ws0 + st * R * WS + ty * TM;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a[TM];
      load_row<TM>(wsb + r * WS, a);
      const float* xp = P.act + (r / K) * P.aw + (r % K) * dil + tx;
      float v[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) v[i] = xp[TX * i];
#pragma unroll
      for (int j = 0; j < TM; ++j)
#pragma unroll
        for (int i = 0; i < NI; ++i)
          acc[j][i] = mad(bits_as<A>(a[j]), bits_as<A>(v[i]), acc[j][i]);
    }
    __syncthreads();  // the next chunk's staging overwrites this one's
  }

#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int co = co0 + ty * TM + j;
    if (co >= Cout) continue;
    float fac = 0.0f;
    if constexpr (D == Dot::I8) fac = q.sx * sw[co];
#pragma unroll
    for (int i = 0; i < NI; ++i) epi(co, tx + TX * i, dequant(acc[j][i], fac));
  }
}

}  // namespace
