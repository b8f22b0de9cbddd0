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
// bias, residuals and scale are the caller's.
//
// act_conv_mma runs an implicit GEMM on the tensor cores with kernel B's
// (conv1d_same.cu) GEMM arithmetic (mma_sm90.cuh), at the dot precision D:
//   F32   3xTF32 on m16n8k8, each tap's three products summed in a fresh
//         accumulator and joined to the running sum by an f32 add that
//         rounds to nearest (the tensor cores' own sums round toward zero
//         and drift over 8,448-deep sums);
//   BF16  mma.sync m16n8k16 bf16 -> f32, keeping the tensor cores' sums;
//   I8    mma.sync m16n8k32 s8 -> s32 on int8 quanta of the activation
//         (rint(a * 127 / amax), one scale per window, given: see the
//         pre-pass below) and of the weights: integer sums, exact in any
//         order (K Cin 127^2 < 2^31), then float(acc) * (s_x * s_w[co])
//         (dot_dtype.cuh).
// 256 threads, WM warps along channels x 8 / WM along time. Per chunk of
// KC input channels (8 f32, 16 bf16, 32 int8: one 32-byte weight row):
//    a. src over the conv window plus the snake's reach, BN + 2 pad + 12
//       samples, and the chunk's snake parameters are staged a chunk ahead
//       (cp.async where src is in device memory; two stages);
//    b. in sub-passes of SUB = 8 channels: the 2x-rate snake signal over
//       BN + 2 pad + 6 base-rate positions, as kernel A forms it (same
//       taps, same order), then its downsampling into the activation,
//       written in the GEMM's operand layout: [frame][ci] rows over the
//       tile plus the taps' halo, BN + 2 pad frames, so that tap k is the
//       row offset k*d. F32 rows hold the TF32 hi (columns 0-7) and lo
//       (8-15) parts, split once here; BF16 rows the bf16 values, I8 rows
//       the int8 quanta, 32 bytes whose 16-byte halves swap where
//       (frame / 4) is odd (i8_offset), so that ldmatrix reads 8
//       consecutive frames without bank conflicts at any tap offset; BF16
//       and I8 rows are read by ldmatrix. The I8 activation is computed
//       without FMAs (snake_ordered): every product and sum a separate f32
//       operation rounded to nearest, in the order of
//       ops/fused_act.py:snake_activation1d_ordered, so that its plain
//       version on the card gives the same bits and the same quanta;
//    c. per tap, the tap's weights [BM][KC] (32-byte rows by 16-byte
//       cp.async from the prepared layout [K][Cout_p][Cin_p] of
//       ops/conv.py:conv_weights) from a ring of RING stages loaded AHEAD
//       taps ahead across chunk boundaries (deeper rings ran no faster);
//       one barrier a tap.
//    The activation of a chunk is computed once per BM output channels, or
//    once per cluster of blocks (CLUSTER, kernel D's bf16 and int8
//    instances).
//    Shared memory, in bytes (mma_core_bytes; mirrored by
//    flowhigh_tpu_torch/ops/fused_conv.py:mma_core_smem_bytes):
//      weights RING x BM x 32 | activation (BN + 2 pad) x (80 F32, 48 BF16,
//      32 I8), twice for CLUSTER | raw src 2 x KC x (BN + 2 pad + 12) x 4 |
//      snake signal SUB x 2 (BN + 2 pad + 6) x 4 | snake parameters 2 x 2 x
//      KC x 4. The 12 filter taps are in constant memory (c_taps).
//
// The int8 window scales: the windows are ops/quant.py's (I8_WINDOW
// outputs each, the activation over the window plus the conv's halo), so
// a scale needs the activation of all Cin channels over a whole window
// before any of it is quantised. act_amax_kernel, launched before each
// int8 launch of D and E, computes the ordered activation over each
// window of 8 channels a block and writes its largest |value| (one float
// per window and 8 channels; the activation itself is never written); the
// act->conv kernel takes the max of its window's partials (window_quant,
// dot_dtype.cuh). So the snake runs once per sample in the pre-pass and
// once per block or cluster in the kernel, and D's tiles need only tile
// the windows (BN divides I8_WINDOW) rather than be them. Kernel E.int8
// (amp_unit.cu) takes the pre-pass for its first activation and builds
// its own passes from the I8 pieces (snake_ordered here; i8_offset and
// mma_tap_s8 in mma_sm90.cuh, which kernel B.int8 shares), computing its
// second activation's scale itself.
//
// The activation is written as the dot of D stages it, after the zero
// mask (packed.py:829, :1188, :1199): f32 (split into TF32 parts), rounded
// to bf16, or quantised.
//
// bf16 feature maps (Store::BF16, dot_dtype.cuh): src in device memory is
// staged by cp.async as the 4-byte word holding each value, into the same
// f32 raw stages, and widened in place by the thread that staged it once
// its group has landed, before the barrier that precedes the activation
// (GlobalSrc::widen; mma_sm90.cuh: cp_async_bf16_word); the pre-pass reads
// it through registers. So the staging stays asynchronous, and the shared
// memory and the arithmetic are the F32-storage instance's. The callers'
// epilogues load residuals into f32 and round the one stored map.

#pragma once

#include <cooperative_groups.h>

#include "dot_dtype.cuh"
#include "mma_sm90.cuh"

namespace {

// src in device memory: x[c, clamp(g)] of one batch row [C, T], by cp.async;
// bf16 maps as the word holding the value, which widen() turns into the f32
// value in place once it has landed (WIDEN).
template <Store ST>
struct GlobalSrc {
  static constexpr bool WIDEN = ST == Store::BF16;
  const StoreT<ST>* x;
  int T;
  __device__ __forceinline__ const StoreT<ST>* at(int c, int g) const {
    return x + (long long)c * T + min(max(g, 0), T - 1);
  }
  __device__ __forceinline__ void stage(float* dst, int c, int g,
                                        bool ok) const {
    if constexpr (WIDEN)
      cp_async_bf16_word(dst, ok ? at(c, g) : x, ok);
    else
      cp_async4_zfill(dst, ok ? at(c, g) : x, ok);
  }
  __device__ __forceinline__ void widen(float* dst, int c, int g) const {
    if constexpr (WIDEN)
      *dst = bf16_half_to_f32(
          *dst, bf16_parity(x, (unsigned)c * (unsigned)T +
                                   (unsigned)min(max(g, 0), T - 1)));
  }
};

// src in shared memory: buf[c, clamp(g) - base], a [C, n] block holding
// positions base .. base + n - 1 (kernel E's conv1 output). Positions the
// block does not hold are clamped into it; they feed only outputs that are
// thrown away.
struct SmemSrc {
  static constexpr bool WIDEN = false;
  const float* buf;
  int n, base, T;
  __device__ __forceinline__ void stage(float* dst, int c, int g,
                                        bool ok) const {
    const int p = min(max(min(max(g, 0), T - 1) - base, 0), n - 1);
    *dst = ok ? buf[c * n + p] : 0.0f;
  }
  __device__ __forceinline__ void widen(float*, int, int) const {}
};

// e / len for the flat loops over CI x len elements below, without an
// integer division: (e + 0.5) / len lies at least 0.5 / len away from an
// integer, far beyond float rounding at these sizes (e < 2^16)
__device__ __forceinline__ int split(int e, float inv_len) {
  return __float2int_rd((e + 0.5f) * inv_len);
}

// --- the tensor-core pass -------------------------------------------------

constexpr int MMA_NT = 256;  // threads a block of the route: 8 warps
constexpr int SUB = 8;       // channels a snake sub-pass
constexpr int RING = 3;      // weight stages, one tap each
constexpr int AHEAD = 2;     // taps a stage is loaded ahead (<= RING - 1)
// the int8 window (ops/quant.py): D's outputs per window, E's pass
constexpr int I8_WINDOW = 256;

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
  static constexpr bool I8 = D == Dot::I8;
  using WT = typename std::conditional<
      I8, signed char,
      typename std::conditional<BF, __nv_bfloat16, float>::type>::type;
  static constexpr int KC = 32 / (int)sizeof(WT);     // channels a chunk
  static constexpr int EPS = 16 / (int)sizeof(WT);    // elements a 16-byte copy
  // activation rows: F32 TF32 hi and lo of 8 channels at a stride of 20
  // floats (kernel B's conflict-free x rows); BF16 16 channels at 24 bf16
  // (48 bytes: conflict-free ldmatrix at any row offset); I8 32 channels in
  // 32 bytes, swizzled (i8_offset)
  static constexpr int XS = 20;
  static constexpr int XSB = 24;
  static constexpr int ROW_BYTES = I8 ? 32 : BF ? XSB * 2 : XS * 4;
};

// Bytes of shared memory one act_conv_mma pass takes (see the layout above;
// a CLUSTER pass keeps two activation buffers).
__host__ __device__ constexpr long long mma_core_bytes(int BM, int BN, int pad,
                                                       Dot d, bool cluster) {
  const long long aw = BN + 2 * pad;
  const long long kc = d == Dot::I8 ? 32 : d == Dot::BF16 ? 16 : 8;
  const long long row = d == Dot::I8 ? 32 : d == Dot::BF16 ? 48 : 80;
  return RING * BM * 32LL + (cluster ? 2 : 1) * aw * row +
         2 * kc * (aw + 12) * 4 + SUB * 2 * (aw + 6) * 4 + 2 * 2 * kc * 4;
}

// The ordered snake of SUB channels (the I8 activation; see the top of this
// file). xr: SUB rows of xw raw samples, sample i at position p0 - 6 + i;
// a_, ib_: the channels' a and 1 / (b + 1e-9). Fills sig (SUB rows of 2 sn
// floats, sn >= j1 + 6) with the 2x-rate signal at base-rate positions
// p0 - 3 + i, i in [j0, j1 + 6), then, after a barrier, calls out(j, cl,
// v) with the activation v at position p0 + j for j in [j0, j1) (j1 - j0
// even), zero outside [0, T); the down stage clamps its 2x-rate index into
// [0, 2T - 1] (replicate). Two positions a thread, taps in constant memory.
// The caller makes sure that every thread is done with sig before the call;
// no barrier at the end.
template <class Out>
__device__ __forceinline__ void snake_ordered(const float* xr, int xw,
                                              const float* a_,
                                              const float* ib_, float* sig,
                                              int sn, int j0, int j1, int p0,
                                              int T, const Out& out) {
  constexpr int NP = 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int sp = (j1 - j0 + 6) / NP;  // position pairs a channel
  const float inv_sp = 1.0f / sp;
  for (int e = tid; e < SUB * sp; e += nt) {
    const int cl = split(e, inv_sp);
    const int i = j0 + NP * (e - cl * sp);
    const float* xi = xr + cl * xw + i;
    const float a = a_[cl], inv_b = ib_[cl];
    float v[6 + NP];
#pragma unroll
    for (int k = 0; k < 6 + NP; ++k) v[k] = xi[k];
    float* o = sig + cl * 2 * sn + 2 * i;
    // s[2m] = sum_k (2 h[2k]) x[m - 3 + k], s[2m+1] = sum_k (2 h[2k+1])
    // x[m - 2 + k], from 0, tap by tap; then s + inv_b sin(s a)^2
#pragma unroll
    for (int q = 0; q < 2 * NP; ++q) {
      float u = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        u = __fadd_rn(u, __fmul_rn(2.0f * c_taps[2 * k + (q & 1)],
                                   v[k + (q >> 1) + (q & 1)]));
      const float pq = sinf(__fmul_rn(u, a));
      o[q] = __fadd_rn(u, __fmul_rn(inv_b, __fmul_rn(pq, pq)));
    }
  }
  __syncthreads();
  const int s_base = 2 * (p0 - 3);  // 2x-rate index of sig[0]
  const int s_max = 2 * T - 1;
  for (int e = tid; e < SUB * ((j1 - j0) / NP); e += nt) {
    const int cl = e % SUB, j = j0 + NP * (e / SUB);
    const int n = p0 + j;
    const float* sc = sig + cl * 2 * sn - s_base;
    float v[NP];
#pragma unroll
    for (int r = 0; r < NP; ++r) v[r] = 0.0f;
    if (n >= 3 && n + NP - 1 <= T - 4) {
      const float* s0 = sc + 2 * n - 5;
      float w[10 + 2 * NP];
#pragma unroll
      for (int q = 0; q < 10 + 2 * NP; ++q) w[q] = s0[q];
#pragma unroll
      for (int q = 0; q < 12; ++q)
#pragma unroll
        for (int r = 0; r < NP; ++r)
          v[r] = __fadd_rn(v[r], __fmul_rn(c_taps[q], w[q + 2 * r]));
    } else {
#pragma unroll
      for (int r = 0; r < NP; ++r) {
        if (n + r < 0 || n + r >= T) continue;
#pragma unroll
        for (int q = 0; q < 12; ++q)
          v[r] = __fadd_rn(
              v[r], __fmul_rn(c_taps[q],
                              sc[min(max(2 * (n + r) + q - 5, 0), s_max)]));
      }
    }
#pragma unroll
    for (int r = 0; r < NP; ++r) out(j + r, cl, v[r]);
  }
}

// The act->conv pass on the tensor cores (see the top of this file). wp:
// the prepared weights [K][cout_p][cin_p] (cin_p a multiple of KC, cout_p
// >= Cout; rows past cout_p read as zeros); I8 also takes the window's
// scale q and the [Cout] weight scales sw. Starts and ends with every
// thread done with ``smem``, so passes may follow one another on the same
// memory. LEAN (for instances short of registers): F32 splits each
// m-tile's weights as it multiplies them and reads x again for each,
// rather than keeping every m-tile's TF32 parts live across the n-tiles.
// NP: neighbouring positions a
// thread takes in each snake stage (2 share their loads; 1 keeps fewer
// registers live). CLUSTER: the block is one of a thread-block cluster
// (launched with a cluster dimension along the output-channel blocks of
// one time tile) whose blocks share the activation: each computes 1 /
// (cluster size) of a chunk's rows and writes them into every block's
// shared memory (DSMEM), two buffers, one cluster barrier a chunk; the
// snake then runs once per sample, not once per block. I8 takes the
// ordered snake (snake_ordered) at two positions a thread, whatever NP.
template <Dot D, int K, int BM, int BN, int WM, bool LEAN, int NP,
          bool CLUSTER, class Src, class Epi>
__device__ __forceinline__ void act_conv_mma(
    const Src& src, const Epi& epi, unsigned char* smem,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    int logscale, const typename MmaOps<D>::WT* __restrict__ wp, int Cin,
    int Cout, int cin_p, int cout_p, int co0, int T, int tstart, int dil,
    Quant q = {0.0f, 0.0f}, const float* __restrict__ sw = nullptr) {
  using O = MmaOps<D>;
  using WT = typename O::WT;
  constexpr int KC = O::KC, EPS = O::EPS, XS = O::XS, XSB = O::XSB;
  constexpr int WN = 8 / WM;
  constexpr int MT = BM / (16 * WM), NT8 = BN / (8 * WN);
  static_assert(MT * 16 * WM == BM && NT8 * 8 * WN == BN, "warp tiles");
  static_assert(!(O::BF || O::I8) || NT8 % 2 == 0,
                "BF16 and I8 load x for two n-tiles");
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

  // bf16 maps: this thread's words of chunk c's raw stage, widened in place
  // once they have landed (before the barrier that precedes the activation)
  auto widen_raw = [&](int c) {
    if constexpr (Src::WIDEN) {
      const int c0 = c * KC;
      float* xr = xr0 + (c & 1) * KC * xw;
      const int g0 = tstart - pad - 6;
#pragma unroll 1
      for (int e = tid; e < KC * xw; e += MMA_NT) {
        const int ci = split(e, inv_xw);
        if (c0 + ci < Cin) src.widen(xr + e, c0 + ci, g0 + e - ci * xw);
      }
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
    if constexpr (O::I8) {
#pragma unroll 1
      for (int c8 = 0; c8 < KC; c8 += SUB) {
        if (c8 > 0) __syncthreads();  // the last sub-pass is done with sig
        snake_ordered(xr + c8 * xw, xw, ab + c8, ab + KC + c8, sig, sn, j0,
                      j1, tstart - pad, T, [&](int j, int cl, float v) {
                        unsigned char* dst = act + i8_offset(j, c8 + cl);
                        const unsigned char qv =
                            (unsigned char)__float2int_rn(v * q.qs);
                        if constexpr (CLUSTER) {
                          const cg::cluster_group cl_ = cg::this_cluster();
                          for (int r = 0; r < n_ranks; ++r)
                            *cl_.map_shared_rank(dst, r) = qv;
                        } else {
                          *dst = qv;
                        }
                      });
      }
      return;
    }
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

  Acc<D> acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;

  stage_raw(0);
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < AHEAD; ++s) issue(s);
  cp_async_wait<AHEAD>();  // chunk 0's src
  if constexpr (Src::WIDEN) widen_raw(0);
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
      // bf16 maps: chunk c + 1's src (step c K's group), visible to every
      // thread from the next tap's barrier on (K >= 3)
      if constexpr (Src::WIDEN)
        if (k == 0 && c + 1 < n_chunks) widen_raw(c + 1);
      __syncthreads();             // ... for every thread; step s - 1 done
      issue(s + AHEAD);
      const WT* ws = ws0 + (s % RING) * BM * 2 * EPS;
      if constexpr (O::I8) {
        mma_tap_s8<MT, NT8>(acc, ws, act, wn * NT8 * 8 + k * dil, wm, lane);
      } else if constexpr (O::BF) {
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
      float fac = 0.0f;
      if constexpr (O::I8) fac = q.sx * sw[co];
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        const int l = (wn * NT8 + n) * 8 + 2 * t;
        epi(co, l, dequant(acc[i][n][2 * hh], fac));
        epi(co, l + 1, dequant(acc[i][n][2 * hh + 1], fac));
      }
    }
}

// --- the int8 window scales (the pre-pass) -----------------------------------

constexpr int AMAX_CH = SUB;  // channels a block of the pre-pass

// Bytes of shared memory a pre-pass block takes for windows of ``width``
// positions: raw x AMAX_CH x (width + 12), snake signal AMAX_CH x 2
// (width + 6), snake parameters 2 x AMAX_CH, in floats
__host__ __device__ constexpr long long amax_smem_bytes(int width) {
  return 4LL * (AMAX_CH * (width + 12) + AMAX_CH * 2 * (width + 6) +
                2 * AMAX_CH);
}

// part[b][w][g] = the largest |a| of the ordered activation (snake_ordered)
// of x's channels [8 g, 8 g + 8) over positions [w stride + lo, w stride +
// lo + width) ∩ [0, T) (zero outside). Grid (windows, ceil(Cin / 8), B);
// width even. The taps are c_taps (set_taps first).
template <Store ST>
__global__ void __launch_bounds__(MMA_NT)
act_amax_kernel(const StoreT<ST>* __restrict__ x,
                const float* __restrict__ alpha,
                const float* __restrict__ beta, int logscale,
                float* __restrict__ part, int Cin, int T, int stride, int lo,
                int width) {
  extern __shared__ __align__(16) float smem_amax[];
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * AMAX_CH, p0 = blockIdx.x * stride + lo;
  const int xw = width + 12, sn = width + 6;
  float* xr = smem_amax;
  float* sig = xr + AMAX_CH * xw;
  float* ab = sig + AMAX_CH * 2 * sn;
  const StoreT<ST>* xb = x + (long long)blockIdx.z * Cin * T;
  const float inv_xw = 1.0f / xw;
  for (int e = tid; e < AMAX_CH * xw; e += MMA_NT) {
    const int ci = split(e, inv_xw);
    const int g = min(max(p0 - 6 + e - ci * xw, 0), T - 1);
    xr[e] = c0 + ci < Cin ? load_f32(xb + (long long)(c0 + ci) * T + g)
                          : 0.0f;
  }
  if (tid < AMAX_CH) {  // as act_conv_mma's stage_raw
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
    ab[tid] = a;
    ab[AMAX_CH + tid] = 1.0f / (b + 1e-9f);
  }
  __syncthreads();
  float m = 0.0f;
  snake_ordered(xr, xw, ab, ab + AMAX_CH, sig, sn, 0, width, p0, T,
                [&](int, int, float v) { m = fmaxf(m, fabsf(v)); });
  m = block_max(m, red);
  if (tid == 0)
    part[((long long)blockIdx.z * gridDim.x + blockIdx.x) * gridDim.y +
         blockIdx.y] = m;
}

// The pre-pass over n_win windows (after set_taps on the same stream)
template <Store ST>
inline cudaError_t launch_act_amax(const void* x, const float* alpha,
                                   const float* beta, int logscale,
                                   float* part, int B, int Cin, int T,
                                   int n_win, int stride, int lo, int width,
                                   cudaStream_t s) {
  const long long smem = amax_smem_bytes(width);
  if (smem > 232448 || n_win <= 0 || width % 2 != 0)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      act_amax_kernel<ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_win, (Cin + AMAX_CH - 1) / AMAX_CH, B);
  act_amax_kernel<ST><<<grid, MMA_NT, smem, s>>>(
      static_cast<const StoreT<ST>*>(x), alpha, beta, logscale, part, Cin, T,
      stride, lo, width);
  return cudaGetLastError();
}

}  // namespace
