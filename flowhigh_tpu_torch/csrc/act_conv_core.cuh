// The act->conv pass shared by kernel D (act_conv1d.cu) and kernel E
// (amp_unit.cu): one block computes
//
//   out[co, l] = sum_{ci, k} w[co, ci, k] * a[ci, tstart + l + k*d - pad]
//
// for BM output channels co0 .. co0 + BM and BN output samples l, where
// a = down2(snakebeta(up2(src))) is the anti-aliased snake of kernel A
// (snake_aa.cu), taken as zero outside [0, T) (the conv's zero padding),
// and src is read replicate-clamped at the sequence edges (the snake's own
// padding). The result goes to an epilogue functor epi(co, l, value);
// bias, residuals and scale are the caller's. Two routes, as kernel B
// (conv1d_same.cu) has them:
//
// 1. The tensor-core route (F32, BF16; act_conv_mma): an implicit GEMM with
//    kernel B's GEMM arithmetic (mma_sm90.cuh): BF16 mma.sync m16n8k16
//    bf16 -> f32, keeping the tensor cores' sums; F32 3xTF32 on m16n8k8,
//    each tap's three products summed in a fresh accumulator and joined to
//    the running sum by an f32 add that rounds to nearest (the tensor
//    cores' own sums round toward zero and drift over 8,448-deep sums).
//    256 threads, WM warps along channels x 8 / WM along time. Per chunk of
//    KC input channels (8 f32 or 16 bf16: one 32-byte weight row):
//    a. src over the conv window plus the snake's reach, BN + 2 pad + 12
//       samples, and the chunk's snake parameters are staged a chunk ahead
//       (cp.async where src is in device memory; two stages);
//    b. in sub-passes of SUB = 8 channels: the 2x-rate snake signal over
//       BN + 2 pad + 6 base-rate positions, as kernel A forms it (same
//       taps, same order), then its downsampling into the activation,
//       written in the GEMM's operand layout: [frame][ci] rows over the
//       tile plus the taps' halo, BN + 2 pad frames, so that tap k is the
//       row offset k*d. F32 rows hold the TF32 hi (columns 0-7) and lo
//       (8-15) parts, split once here; BF16 rows the bf16 values, read by
//       ldmatrix;
//    c. per tap, the tap's weights [BM][KC] (32-byte rows by 16-byte
//       cp.async from the prepared layout [K][Cout_p][Cin_p] of
//       ops/conv.py:conv_weights, kernel B's) from a ring of RING stages
//       loaded AHEAD taps ahead across chunk boundaries (deeper rings ran
//       no faster); one barrier a tap.
//    The activation of a chunk is computed once per BM output channels, or
//    once per cluster of blocks (CLUSTER, kernel D's bf16 instances).
//    Shared memory, in bytes (mma_core_bytes; mirrored by
//    flowhigh_tpu_torch/ops/fused_conv.py:mma_core_smem_bytes):
//      weights RING x BM x 32 | activation (BN + 2 pad) x (80 F32, 48 BF16),
//      twice for CLUSTER | raw src 2 x KC x (BN + 2 pad + 12) x 4 | snake
//      signal SUB x 2 (BN + 2 pad + 6) x 4 | snake parameters 2 x 2 x KC x
//      4. The 12 filter taps are in constant memory (c_taps).
//
// 2. The FMA route (I8; act_conv_tile): per chunk of CI input channels,
//    1. stage src over the conv window plus the snake's reach of 6 samples,
//       aw + 12 samples with aw = BN + 2 pad, and the chunk's weights
//       (transposed to [CI*K][BM]) and snake parameters, double-buffered:
//       the next chunk is staged (cp.async where src is in device memory)
//       while this one is computed;
//    2. form the 2x-rate snake signal over aw + 6 base-rate positions in
//       shared memory, as kernel A does, without FMAs (see Pass::activate);
//    3. downsample it into the activation over aw positions, zero outside
//       [0, T), quantised with the window's scale (int32 bits);
//    4. run an implicit GEMM of int32 multiply-adds on the FMA units
//       (kernel B.int8's) over the chunk's CI*K rows, reading the
//       activation at offset k*d: each thread keeps TM channels x NI
//       samples (samples tx + 32 i, so a warp reads 32 consecutive values a
//       row); TYB warps share the block's BM = TM * TYB output channels.
//    The sums run in the order (chunk, channel, tap), exact in int32; epi
//    gets float(acc) * (s_x * s_w[co]) (dot_dtype.cuh). The window's amax
//    comes from act_amax below, a pass over the same chunks that runs
//    steps 1-3 without the GEMM. Shared memory, in floats (mirrored by
//    flowhigh_tpu_torch/ops/fused_conv.py:core_smem_floats):
//      weights 2 x CI*K x (BM + 4) | raw input 2 x CI x (aw + 12) |
//      snake parameters 2 x 2 x CI | snake signal CI x 2 (aw + 6) |
//      activation CI x aw | filter taps 12.
//
// Both routes write the activation as the dot of D stages it, after the
// zero mask (packed.py:829, :1188, :1199): f32 (split into TF32 parts),
// rounded to bf16, or quantised.

#pragma once

#include <cooperative_groups.h>

#include "dot_dtype.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int TX = 32;  // threads along time (one warp)

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

// Floats of shared memory one FMA-route pass takes (see the layout above).
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
    cp_async4_zfill(dst, ok ? x + (long long)c * T + gc : x, ok);
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

// --- 1. the tensor-core route (F32, BF16) -------------------------------------

constexpr int MMA_NT = 256;  // threads a block of the route: 8 warps
constexpr int SUB = 8;       // channels a snake sub-pass
constexpr int RING = 3;      // weight stages, one tap each
constexpr int AHEAD = 2;     // taps a stage is loaded ahead (<= RING - 1)

// The 12 filter taps of the anti-aliased snake (kernel A's); each launch of
// the route copies them here first, on its stream (set_taps)
__constant__ float c_taps[12];

inline cudaError_t set_taps(const float* filt, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_taps, filt, sizeof(c_taps), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}

template <Dot D>
struct MmaOps {
  static constexpr bool BF = D == Dot::BF16;
  using WT = typename std::conditional<BF, __nv_bfloat16, float>::type;
  static constexpr int KC = BF ? 16 : 8;              // channels a chunk
  static constexpr int EPS = 16 / (int)sizeof(WT);    // elements a 16-byte copy
  // activation rows: F32 TF32 hi and lo of 8 channels at a stride of 20
  // floats (kernel B's conflict-free x rows); BF16 16 channels at 24 bf16
  // (48 bytes: conflict-free ldmatrix at any row offset)
  static constexpr int XS = 20;
  static constexpr int XSB = 24;
  static constexpr int ROW_BYTES = BF ? XSB * 2 : XS * 4;
};

// Bytes of shared memory one act_conv_mma pass takes (see the layout above;
// a CLUSTER pass keeps two activation buffers).
__host__ __device__ constexpr long long mma_core_bytes(int BM, int BN, int pad,
                                                       bool bf,
                                                       bool cluster) {
  const long long aw = BN + 2 * pad, kc = bf ? 16 : 8;
  return RING * BM * 32LL + (cluster ? 2 : 1) * aw * (bf ? 48 : 80) +
         2 * kc * (aw + 12) * 4 + SUB * 2 * (aw + 6) * 4 + 2 * 2 * kc * 4;
}

// The act->conv pass on the tensor cores (route 1 above). wp: the prepared
// weights [K][cout_p][cin_p] (cin_p a multiple of 16, cout_p >= Cout; rows
// past cout_p read as zeros). Starts and ends with every thread done with
// ``smem``, so passes may follow one another on the same memory. LEAN (for
// instances short of registers): F32 splits each m-tile's weights as it
// multiplies them and reads x again for each, rather than keeping every
// m-tile's TF32 parts live across the n-tiles. NP: neighbouring positions a
// thread takes in each snake stage (2 share their loads; 1 keeps fewer
// registers live). CLUSTER: the block is one of a thread-block cluster
// (launched with a cluster dimension along the output-channel blocks of
// one time tile) whose blocks share the activation: each computes 1 /
// (cluster size) of a chunk's rows and writes them into every block's
// shared memory (DSMEM), two buffers, one cluster barrier a chunk; the
// snake then runs once per sample, not once per block.
template <Dot D, int K, int BM, int BN, int WM, bool LEAN, int NP,
          bool CLUSTER, class Src, class Epi>
__device__ __forceinline__ void act_conv_mma(
    const Src& src, const Epi& epi, unsigned char* smem,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    int logscale, const typename MmaOps<D>::WT* __restrict__ wp, int Cin,
    int Cout, int cin_p, int cout_p, int co0, int T, int tstart, int dil) {
  using O = MmaOps<D>;
  using WT = typename O::WT;
  constexpr int KC = O::KC, EPS = O::EPS, XS = O::XS, XSB = O::XSB;
  constexpr int WN = 8 / WM;
  constexpr int MT = BM / (16 * WM), NT8 = BN / (8 * WN);
  static_assert(MT * 16 * WM == BM && NT8 * 8 * WN == BN, "warp tiles");
  static_assert(!O::BF || NT8 % 2 == 0, "BF16 loads x for two n-tiles");
  static_assert(AHEAD <= RING - 1 && AHEAD <= 3, "one barrier a tap");
  static_assert(NP == 1 || NP == 2, "positions a thread");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;
  const int pad = dil * (K - 1) / 2;
  const int aw = BN + 2 * pad, xw = aw + 12, sn = aw + 6;
  const float inv_xw = 1.0f / xw;

  WT* ws0 = reinterpret_cast<WT*>(smem);
  unsigned char* act0 = smem + RING * BM * 32;  // (CLUSTER: two) buffers
  float* xr0 = reinterpret_cast<float*>(act0 + (CLUSTER ? 2 : 1) * aw *
                                                   O::ROW_BYTES);
  float* sig = xr0 + 2 * KC * xw;
  float* ab0 = sig + SUB * 2 * sn;
  const int n_chunks = (Cin + KC - 1) / KC;
  const int n_steps = n_chunks * K;

  namespace cg = cooperative_groups;
  // this block's share of the activation rows: pairs [r pr, (r + 1) pr)
  int rank = 0, n_ranks = 1;
  if constexpr (CLUSTER) {
    const cg::cluster_group cl = cg::this_cluster();
    rank = (int)cl.block_rank();
    n_ranks = (int)cl.num_blocks();
    cl.sync();  // every block of the cluster runs before any DSMEM write
  } else {
    __syncthreads();  // an earlier pass over this memory is done with it
  }
  const int pr = (aw / 2 + n_ranks - 1) / n_ranks;
  const int j0 = CLUSTER ? min(2 * rank * pr, aw) : 0;
  const int j1 = CLUSTER ? min(j0 + 2 * pr, aw) : aw;

  // step a for chunk c: src and the snake parameters as kernel A takes
  // them (a = exp(alpha), 1 / (b + 1e-9)) into stage c % 2
  auto stage_raw = [&](int c) {
    const int c0 = c * KC;
    float* xr = xr0 + (c & 1) * KC * xw;
    const int g0 = tstart - pad - 6;  // position of raw input 0
    for (int e = tid; e < KC * xw; e += MMA_NT) {
      const int ci = split(e, inv_xw);
      src.stage(xr + e, c0 + ci, g0 + e - ci * xw, c0 + ci < Cin);
    }
    if (tid < KC) {
      const int ch = c0 + tid;
      float a = 1.0f, b = 1.0f;
      if (ch < Cin) {
        a = alpha[ch];
        b = beta != nullptr ? beta[ch] : a;
        if (logscale) {
          a = expf(a);
          b = expf(b);
        }
      }
      float* ab = ab0 + (c & 1) * 2 * KC;
      ab[tid] = a;
      ab[KC + tid] = 1.0f / (b + 1e-9f);
    }
  };

  // one commit group a step s (chunk s / K, tap s % K): the step's weights
  // into ring stage s % RING and, with a chunk's first tap, src of the
  // next chunk (its stage was last read by the activation of chunk c - 1,
  // which every thread finished before step (c - 1) K's barrier)
  auto issue = [&](int s) {
    if (s < n_steps) {
      const int c = s / K, k = s - c * K;
      WT* wd = ws0 + (s % RING) * BM * 2 * EPS;
      for (int e = tid; e < 2 * BM; e += MMA_NT) {
        const int row = e >> 1, half = e & 1;
        const bool ok = co0 + row < cout_p;
        cp_async16_zfill(
            wd + w_row_offset(row, half, EPS),
            ok ? wp + ((long long)k * cout_p + co0 + row) * cin_p + c * KC +
                     half * EPS
               : wp,
            ok);
      }
      if (k == 0 && c + 1 < n_chunks) stage_raw(c + 1);
    }
    cp_async_commit();
  };

  // step b for chunk c (its src staged and visible to every thread); the
  // activation at position n = tstart - pad + j: the down stage clamps its
  // 2x-rate index into [0, 2T - 1] (replicate), which only the first 3 and
  // last 4 samples of the sequence need; the conv sees zeros outside [0, T).
  // Each thread takes NP neighbouring positions of one channel in both
  // stages; the taps are in constant memory (c_taps), an FMA operand at no
  // cost
  auto activate = [&](int c) {
    const float* xr = xr0 + (c & 1) * KC * xw;
    const float* ab = ab0 + (c & 1) * 2 * KC;
    unsigned char* act = act0 + (CLUSTER ? (c & 1) * aw * O::ROW_BYTES : 0);
    const int s_base = 2 * (tstart - pad - 3);  // 2x-rate index of sig[0]
    const int s_max = 2 * T - 1;
    // signal positions this block needs for rows [j0, j1): j0 .. j1 + 5
    const int sp = (j1 - j0 + 6) / NP;  // position groups a channel
    const float inv_sp = 1.0f / sp;
    auto put = [&](int j, int ci, float v) {
      if constexpr (O::BF) {
        const __nv_bfloat16 hv = __float2bfloat16_rn(v);
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(act) +
                             j * XSB + ci;
        if constexpr (CLUSTER) {
          const cg::cluster_group cl = cg::this_cluster();
          for (int r = 0; r < n_ranks; ++r) *cl.map_shared_rank(dst, r) = hv;
        } else {
          *dst = hv;
        }
      } else {
        unsigned hi, lo;
        tf32_split(v, hi, lo);
        float* row = reinterpret_cast<float*>(act) + j * XS;
        if constexpr (CLUSTER) {
          const cg::cluster_group cl = cg::this_cluster();
          for (int r = 0; r < n_ranks; ++r) {
            float* rr = cl.map_shared_rank(row, r);
            rr[ci] = __uint_as_float(hi);
            rr[KC + ci] = __uint_as_float(lo);
          }
        } else {
          row[ci] = __uint_as_float(hi);
          row[KC + ci] = __uint_as_float(lo);
        }
      }
    };
#pragma unroll 1
    for (int c8 = 0; c8 < KC; c8 += SUB) {
      if (c8 > 0) __syncthreads();  // the last sub-pass is done with sig
      // 2x-rate snake signal at m = tstart - pad - 3 + i: s[2m] reads raw
      // i .. i+5, s[2m+1] reads raw i+1 .. i+6 (kernel A's arithmetic:
      // 2 h[2k] x == 2 (h[2k] x) exactly, so the doubling comes last); m
      // for i .. i + NP - 1 here
      for (int e = tid; e < SUB * sp; e += MMA_NT) {
        const int cl = split(e, inv_sp);
        const int i = j0 + NP * (e - cl * sp);
        const float* xi = xr + (c8 + cl) * xw + i;
        const float a = ab[c8 + cl], inv_b = ab[KC + c8 + cl];
        float v[6 + NP];
#pragma unroll
        for (int k = 0; k < 6 + NP; ++k) v[k] = xi[k];
        float sv[2 * NP];  // s[2m], s[2m+1] for each m
#pragma unroll
        for (int q = 0; q < 2 * NP; ++q) sv[q] = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k)
#pragma unroll
          for (int q = 0; q < 2 * NP; ++q)
            sv[q] = fmaf(c_taps[2 * k + (q & 1)], v[k + (q >> 1) + (q & 1)],
                         sv[q]);
        float* out = sig + cl * 2 * sn + 2 * i;
#pragma unroll
        for (int q = 0; q < 2 * NP; ++q) {
          const float u = 2.0f * sv[q];
          const float pq = sinf(a * u);
          out[q] = u + inv_b * (pq * pq);
        }
      }
      __syncthreads();
      for (int e = tid; e < SUB * ((j1 - j0) / NP); e += MMA_NT) {
        const int cl = e % SUB, j = j0 + NP * (e / SUB);
        const int n = tstart - pad + j;
        const float* sc = sig + cl * 2 * sn - s_base;
        float v[NP];
#pragma unroll
        for (int q = 0; q < NP; ++q) v[q] = 0.0f;
        if (n >= 3 && n + NP - 1 <= T - 4) {
          const float* s0 = sc + 2 * n - 5;
          float w[10 + 2 * NP];
#pragma unroll
          for (int q = 0; q < 10 + 2 * NP; ++q) w[q] = s0[q];
#pragma unroll
          for (int q = 0; q < 12; ++q)
#pragma unroll
            for (int r = 0; r < NP; ++r)
              v[r] = fmaf(c_taps[q], w[q + 2 * r], v[r]);
        } else {
#pragma unroll
          for (int r = 0; r < NP; ++r) {
            if (n + r < 0 || n + r >= T) continue;
#pragma unroll
            for (int q = 0; q < 12; ++q)
              v[r] = fmaf(c_taps[q],
                          sc[min(max(2 * (n + r) + q - 5, 0), s_max)], v[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < NP; ++r) put(j + r, c8 + cl, v[r]);
      }
    }
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;

  stage_raw(0);
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < AHEAD; ++s) issue(s);
  cp_async_wait<AHEAD>();  // chunk 0's src
  __syncthreads();

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    // the activation of chunk c overwrites chunk c - 1's once every warp
    // has passed the barrier after the signal, i.e. is done with its taps
    // (CLUSTER: chunk c - 2's, which every block of the cluster finished
    // before the cluster barrier of chunk c - 1)
    activate(c);
    // CLUSTER: every block's rows of chunk c have landed
    if constexpr (CLUSTER) cg::this_cluster().sync();
    const unsigned char* act =
        act0 + (CLUSTER ? (c & 1) * aw * O::ROW_BYTES : 0);
    // one tap at a time (unrolled over the taps, kernel B's F32 instances
    // spill)
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const int s = c * K + k;
      cp_async_wait<AHEAD - 1>();  // step s's group (and older) landed
      __syncthreads();             // ... for every thread; step s - 1 done
      issue(s + AHEAD);
      const WT* ws = ws0 + (s % RING) * BM * 2 * EPS;
      if constexpr (O::BF) {
        // ldmatrix.x4 rows, lane l: frame (wn NT8 + n + l / 16) 8 + l % 8
        // + k d, channels 8 ((l / 8) % 2) ..: b0, b1 of n-tiles n, n + 1
        const __nv_bfloat16* xh =
            reinterpret_cast<const __nv_bfloat16*>(act) +
            ((wn * NT8 + ((lane >> 4) & 1)) * 8 + (lane & 7) + k * dil) * XSB +
            ((lane >> 3) & 1) * 8;
        unsigned a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          a_frag_bf16(a[i], ws, (wm * MT + i) * 16, lane);
#pragma unroll
        for (int n = 0; n < NT8; n += 2) {
          unsigned bq[4];
          ldmatrix_x4(bq, xh + n * 8 * XSB);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16_16816(acc[i][n], a[i], bq[0], bq[1]);
            mma_bf16_16816(acc[i][n + 1], a[i], bq[2], bq[3]);
          }
        }
      } else {
        // this lane's frames (wn NT8 + n) 8 + g + k d, channels t and t + 4
        const float* xa = reinterpret_cast<const float*>(act) +
                          ((wn * NT8) * 8 + g + k * dil) * XS;
        constexpr int MA = LEAN ? 1 : MT;  // m-tiles whose weights are live
#pragma unroll
        for (int i0 = 0; i0 < MT; i0 += MA) {
          unsigned ah[MA][4], al[MA][4];
#pragma unroll
          for (int i = 0; i < MA; ++i)
            a_frag_3xtf32(ah[i], al[i], ws, (wm * MT + i0 + i) * 16, g, t);
#pragma unroll
          for (int n = 0; n < NT8; ++n) {
            const float* xr = xa + n * 8 * XS;
            const unsigned bh0 = __float_as_uint(xr[t]);
            const unsigned bh1 = __float_as_uint(xr[t + 4]);
            const unsigned bl0 = __float_as_uint(xr[KC + t]);
            const unsigned bl1 = __float_as_uint(xr[KC + t + 4]);
#pragma unroll
            for (int i = 0; i < MA; ++i)
              mma_3xtf32_1688(acc[i0 + i][n], ah[i], al[i], bh0, bh1, bl0,
                              bl1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int co = co0 + (wm * MT + i) * 16 + g + 8 * hh;
      if (co >= Cout) continue;
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        const int l = (wn * NT8 + n) * 8 + 2 * t;
        epi(co, l, acc[i][n][2 * hh]);
        epi(co, l + 1, acc[i][n][2 * hh + 1]);
      }
    }
}

// --- 2. the FMA route (I8) ------------------------------------------------------

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
      cp_async4_zfill(ws + r * WS + co,
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
