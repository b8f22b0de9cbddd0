// Kernel F: blockwise (flash) attention forward with key-padding segments,
//   out[b, h, i] = sum_j p_ij v[b, h, j],
//   p_ij = softmax_j(scale * q_i . k_j) over the keys j with seg(j) == seg(i),
// seg = 1 at a valid position and 0 at a masked one (seg == nullptr: all 1).
//
// Replaces the JAX package's flowhigh_tpu/models/transformer.py
// :_flash_attention, the Pallas TPU library kernel
// jax.experimental.pallas.ops.tpu.flash_attention called with segment ids,
// padding semantics included: that function pads N up to n_pad, a multiple
// of its block, with q = k = v = 0 in segment 0, so every masked query
// (segment 0) also attends to n_pad - N keys of logit 0 and value 0. Those
// keys are not stored here: a masked query's running softmax starts as if
// it had already seen them (running max 0, running sum n_pad - N, numerator
// 0). Valid queries never meet them.
//
// Layout: q, k, v, out [B, H, N, D] float32, contiguous; seg [B, N] int32.
// Instances for D = 16, 32, 64.
//
// Bound: the two products, 4 N^2 D operations per (b, h) over 16 N D bytes
// (at N = 30,000 and D = 64 about 7,500 operations a byte). They run here
// on the tensor cores in 3xTF32 (three TF32 products per f32 product), so
// the least time is 3 x 4 N^2 D at the TF32 peak plus the softmax's exps,
// scales, maxima and sums per score on the FMA units. What binds this
// kernel is the instruction stream around its mma.sync (by elimination on
// an H100: the splits into TF32 hi and lo, the joins, the softmax), not
// its loads.
//
// Design: one block of 4 warps per (128 queries, b * h), 2 blocks an SM;
// each warp owns 32 query rows (MT = 2 m-tiles of 16) and walks the keys
// in tiles of 32, the loop that takes the place of the TPU grid's
// sequential key axis.
// - Both products run on mma.sync m16n8k8 in 3xTF32. An operand v splits
//   as hi = v rounded to TF32 (to nearest, ties away from zero) and lo = v
//   - hi, of which the tensor cores take the top 19 bits (split_hi: two
//   integer operations and a subtraction, where ptxas makes
//   cvt.rna.tf32.f32 four). S = Q K^T (k = D) takes each 16-wide chunk of
//   D, two k-steps, in a fresh accumulator (six products, small ones
//   first) joined to S by f32 adds that round to nearest; O += P V (k =
//   the tile's keys) goes into a zeroed fragment per tile, joined as O = O
//   alpha + (P V)_tile by an FMA. So the tensor cores' round-toward-zero
//   sums never run along D or the key axis (a chain over all of D misses
//   the 1e-4 bound at D = 64; tests/test_torch_flash_plan.py emulates it).
// - Q is split once a block, into shared memory in fragment order (each
//   lane reads its own back with 16-byte loads). Each warp splits the K and
//   V values it loads once a tile, and each of those serves both of its
//   m-tiles; it splits P once a tile (once per pass over O's columns:
//   with two m-tiles, (P V)_tile takes O's columns JG n-tiles at a time,
//   which keeps the registers below 255 without a spill).
// - The accumulator of S is P's A fragment without a shuffle: within each
//   8-key n-tile, S column 2t holds key t and column 2t + 1 key t + 4 (the
//   K rows are loaded in that order), which are exactly the keys that an
//   m16n8k8 A fragment's k = t and t + 4 take. Within each 16-wide chunk
//   of D, a k-step pairs dims 4t + 2h and 4t + 2h + 1, so one 16-byte
//   shared load of K gives two k-steps' B fragments. O's n-tile j, column
//   c is output dim 8 JG (j / JG) + JG c + j % JG (JG = min(D / 8, 4)), so
//   a lane reads V's B fragments and writes O as runs of JG floats. K rows
//   are padded to D + 4 floats and V rows to D + 8: every load of a
//   fragment is free of bank conflicts.
// - K, V (and the key segments) reach shared memory through a two-stage
//   cp.async ring; tile i + 1 loads while tile i computes, one barrier a
//   tile; the ragged last tile is zero-filled.
// - The softmax works in base 2 on logits scaled by scale * log2(e), on
//   the exp unit (ex2.approx). Each lane keeps its rows' running max (quad
//   shuffles) and a partial running sum of its own columns, summed over the
//   quad at the end. A warp whose rows share one segment, over a full key
//   tile of that segment, skips the per-score segment compares.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_sm90.cuh"

namespace {

constexpr int MT = 2;           // m-tiles of 16 query rows a warp
constexpr int WARPS = 4;
constexpr int BM = 16 * MT * WARPS;  // queries a block
constexpr int BN = 32;          // keys a tile
constexpr int NT = 32 * WARPS;
constexpr int BLOCKS = 2;       // blocks an SM (launch bounds)
constexpr int STAGES = 2;       // the K / V ring
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int KLD = D + 4;  // K rows, floats
  static constexpr int VLD = D + 8;  // V rows, floats
  static constexpr int KS = 0;                  // [BN][KLD] keys
  static constexpr int VS = KS + BN * KLD;      // [BN][VLD] values
  static constexpr int SEG = VS + BN * VLD;     // [BN] int key segments
  static constexpr int STAGE = SEG + BN;        // floats a stage
  // after the ring: Q's split A fragments,
  // [warp][m-tile][k-step][hi, lo][lane][4]
  static constexpr int QF = STAGES * STAGE;
  static constexpr size_t bytes =
      (size_t)(QF + WARPS * MT * (D / 8) * 2 * 32 * 4) * sizeof(float);
};

// stage ``st`` <- key tile k0: K and V rows by 16-byte cp.async (zeros past
// N) and, with segments, the tile's key segments by 4-byte ones
template <int D>
__device__ __forceinline__ void load_tile(float* smem, int st, int k0,
                                          const float* k, const float* v,
                                          const int* segb, long long base,
                                          int N, int tid) {
  using L = Layout<D>;
  float* s = smem + st * L::STAGE;
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  for (int e = tid; e < BN * CPR; e += NT) {
    const int r = e / CPR, c = (e % CPR) * 4;
    const bool ok = k0 + r < N;
    const long long off = base + (ok ? (long long)(k0 + r) * D + c : 0);
    cp_async16_zfill(s + L::KS + r * L::KLD + c, k + off, ok);
    cp_async16_zfill(s + L::VS + r * L::VLD + c, v + off, ok);
  }
  if (segb != nullptr && tid < BN) {
    const bool ok = k0 + tid < N;
    cp_async4_zfill(s + L::SEG + tid, segb + (ok ? k0 + tid : 0), ok);
  }
}

// the 3xTF32 pair of a B fragment: (hi, lo) of b0 and b1
struct BFrag {
  unsigned h0, h1, l0, l1;
  __device__ __forceinline__ BFrag(float b0, float b1) {
    split_hi(b0, h0, l0);
    split_hi(b1, h1, l1);
  }
};

// c += a b over two k-steps in 3xTF32: the six TF32 products (each
// k-step's small ones first) in a fresh accumulator, joined to c by f32
// adds that round to nearest
__device__ __forceinline__ void mma_3xtf32_pair(float (&c)[4],
                                                const unsigned (&ah)[2][4],
                                                const unsigned (&al)[2][4],
                                                const BFrag& b0,
                                                const BFrag& b1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(d, al[0], b0.h0, b0.h1);
  mma_tf32_1688(d, ah[0], b0.l0, b0.l1);
  mma_tf32_1688(d, ah[0], b0.h0, b0.h1);
  mma_tf32_1688(d, al[1], b1.h0, b1.h1);
  mma_tf32_1688(d, ah[1], b1.l0, b1.l1);
  mma_tf32_1688(d, ah[1], b1.h0, b1.h1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], d[e]);
}

// 2^x on the exp unit (ex2.approx: 2 ulp; a result below 2^-126 is 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
struct Vec;
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* x) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* x) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <int D>
__global__ void __launch_bounds__(NT, BLOCKS)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ seg,
                  float* __restrict__ out, int H, int N, int n_extra,
                  float scale) {
  using L = Layout<D>;
  constexpr int J = D / 8;               // n-tiles of O, k-steps of S
  constexpr int JG = J < 4 ? J : 4;      // n-tiles a V load serves
  constexpr int NTK = BN / 8;            // n-tiles of S, k-steps of P V
  constexpr int R = 2 * MT;              // rows a lane: 16 mt + 8 h + g
  constexpr int JP = MT > 1 ? JG : J;    // n-tiles of O a pass of P V
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const long long base = (long long)bh * N * D;
  const int* segb = seg != nullptr ? seg + (long long)(bh / H) * N : nullptr;
  const int ntiles = (N + BN - 1) / BN;
  int row[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    row[i] = blockIdx.x * BM + 16 * MT * warp + 8 * i + g;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_tile<D>(smem, s, s * BN, k, v, segb, base, N, tid);
    cp_async_commit();
  }

  // Q's A fragments, split once into shared memory (each lane reads back
  // only its own): for m-tile mt, k-step 2 c + h of chunk c pairs dims
  // 16 c + 4 t + 2 h (a0, a1: rows g, g + 8 of the m-tile) and + 1 (a2, a3)
  uint4* qf = reinterpret_cast<uint4*>(smem + L::QF) +
              warp * MT * J * 2 * 32 + lane;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      float4 x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        x[h] = row[2 * mt + h] < N
                   ? *reinterpret_cast<const float4*>(
                         q + base + (long long)row[2 * mt + h] * D + 16 * c +
                         4 * t)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      const float a[2][4] = {{x[0].x, x[1].x, x[0].y, x[1].y},
                             {x[0].z, x[1].z, x[0].w, x[1].w}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_hi(a[h][e], hi[e], lo[e]);
        uint4* f = qf + ((mt * J + 2 * c + h) * 2) * 32;
        f[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        f[32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }

  int sq[R];
  bool rows_in = true;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    sq[i] = (row[i] < N && segb != nullptr) ? segb[row[i]] : 1;
    rows_in = rows_in && row[i] < N;
  }
  // one segment over the warp's rows, all of them queries
  const int wseg = __shfl_sync(0xffffffffu, sq[0], 0);
  bool same = rows_in;
#pragma unroll
  for (int i = 0; i < R; ++i) same = same && sq[i] == wseg;
  const bool rows_one = __all_sync(0xffffffffu, same);
  // a masked query has already "seen" the n_extra pad keys (logit 0); its
  // lane t = 0 carries them in its partial sum
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = sq[i] == 0 && n_extra > 0 ? 0.f : -INFINITY;
    l[i] = t == 0 && m[i] == 0.f ? (float)n_extra : 0.f;
  }
  float o[MT][J][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  const float c2 = scale * LOG2E;
  // S column c of an n-tile is key (c >> 1) + 4 (c & 1): the B fragment's
  // n = g row
  const int krow = (g >> 1) + 4 * (g & 1);

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it has landed; tile it - 1's stage is free
    {
      const int nx = it + STAGES - 1;
      if (nx < ntiles)
        load_tile<D>(smem, nx % STAGES, nx * BN, k, v, segb, base, N, tid);
      cp_async_commit();
    }
    const float* st = smem + (it % STAGES) * L::STAGE;
    const float* ks = st + L::KS;
    const float* vs = st + L::VS;
    const int* sk = reinterpret_cast<const int*>(st + L::SEG);
    const int k0 = it * BN;

    // S = Q K^T: n-tile n, columns 2t, 2t + 1 = keys 8 n + t, 8 n + t + 4;
    // each K fragment, split once, serves the warp's MT m-tiles
    float s[MT][NTK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      unsigned qh[MT][2][4], ql[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4* f = qf + ((mt * J + 2 * c + h) * 2) * 32;
          const uint4 x = f[0], y = f[32];
          qh[mt][h][0] = x.x; qh[mt][h][1] = x.y;
          qh[mt][h][2] = x.z; qh[mt][h][3] = x.w;
          ql[mt][h][0] = y.x; ql[mt][h][1] = y.y;
          ql[mt][h][2] = y.z; ql[mt][h][3] = y.w;
        }
#pragma unroll
      for (int n = 0; n < NTK; ++n) {
        const float4 kk = *reinterpret_cast<const float4*>(
            ks + (8 * n + krow) * L::KLD + 16 * c + 4 * t);
        const BFrag b0(kk.x, kk.y), b1(kk.z, kk.w);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32_pair(s[mt][n], qh[mt], ql[mt], b0, b1);
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] *= c2;
    bool one = k0 + BN <= N;  // a full tile
    if (segb != nullptr) {
      bool keys = true;
#pragma unroll
      for (int x = lane; x < BN; x += 32) keys = keys && sk[x] == wseg;
      one = __all_sync(0xffffffffu, one && rows_one && keys);
    }
    if (!one) {  // a masked or ragged tile: compare each score's segments
#pragma unroll
      for (int n = 0; n < NTK; ++n) {
        const int ca = 8 * n + t, cb = ca + 4;
        const int sa = k0 + ca < N ? (segb != nullptr ? sk[ca] : 1) : -1;
        const int sb = k0 + cb < N ? (segb != nullptr ? sk[cb] : 1) : -1;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (sa != sq[2 * mt]) s[mt][n][0] = -INFINITY;
          if (sb != sq[2 * mt]) s[mt][n][1] = -INFINITY;
          if (sa != sq[2 * mt + 1]) s[mt][n][2] = -INFINITY;
          if (sb != sq[2 * mt + 1]) s[mt][n][3] = -INFINITY;
        }
      }
    }

    // the running softmax of each row (i = 2 mt + h: accumulator entries
    // 2 h and 2 h + 1)
    float al[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float (&si)[NTK][4] = s[i / 2];
      const int e0 = 2 * (i % 2);
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NTK; ++n)
        mx = fmaxf(mx, fmaxf(si[n][e0], si[n][e0 + 1]));
#pragma unroll
      for (int x = 1; x < 4; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float mn = fmaxf(m[i], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;  // no key of the row yet
      al[i] = exp2_approx(m[i] - mu);
      m[i] = mn;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NTK; ++n) {
        si[n][e0] = exp2_approx(si[n][e0] - mu);
        si[n][e0 + 1] = exp2_approx(si[n][e0 + 1] - mu);
        rs += si[n][e0];
        rs += si[n][e0 + 1];
      }
      l[i] = fmaf(l[i], al[i], rs);
    }

    // (P V)_tile: k-step n takes keys 8 n + t (a0, a1) and 8 n + t + 4
    // (a2, a3), the S accumulator's own columns; each V fragment, split
    // once, serves the warp's MT m-tiles. With MT > 1 the columns of O go
    // in passes of JG n-tiles (P split again each pass), which keeps
    // (P V)_tile's registers to one pass.
#pragma unroll
    for (int gp = 0; gp < J / JP; ++gp) {
      float pv[MT][JP][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < JP; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[mt][j][e] = 0.f;
#pragma unroll
      for (int n = 0; n < NTK; ++n) {
        unsigned ah[MT][4], alo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_hi(s[mt][n][0], ah[mt][0], alo[mt][0]);
          split_hi(s[mt][n][2], ah[mt][1], alo[mt][1]);
          split_hi(s[mt][n][1], ah[mt][2], alo[mt][2]);
          split_hi(s[mt][n][3], ah[mt][3], alo[mt][3]);
        }
        const float* v0 = vs + (8 * n + t) * L::VLD + JG * g;
        const float* v1 = v0 + 4 * L::VLD;
#pragma unroll
        for (int gr = gp * JP / JG; gr < (gp + 1) * JP / JG; ++gr) {
          float x0[JG], x1[JG];
          Vec<JG>::load(v0 + 8 * JG * gr, x0);
          Vec<JG>::load(v1 + 8 * JG * gr, x1);
#pragma unroll
          for (int jj = 0; jj < JG; ++jj) {
            const BFrag b(x0[jj], x1[jj]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              float(&acc)[4] = pv[mt][JG * gr + jj - gp * JP];
              mma_tf32_1688(acc, alo[mt], b.h0, b.h1);
              mma_tf32_1688(acc, ah[mt], b.l0, b.l1);
              mma_tf32_1688(acc, ah[mt], b.h0, b.h1);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          float(&oj)[4] = o[mt][gp * JP + j];
          oj[0] = fmaf(oj[0], al[2 * mt], pv[mt][j][0]);
          oj[1] = fmaf(oj[1], al[2 * mt], pv[mt][j][1]);
          oj[2] = fmaf(oj[2], al[2 * mt + 1], pv[mt][j][2]);
          oj[3] = fmaf(oj[3], al[2 * mt + 1], pv[mt][j][3]);
        }
    }
  }
  cp_async_wait<0>();

  // n-tile j, columns 2t and 2t + 1: dims 8 JG (j / JG) + 2 JG t + j % JG
  // and the same + JG
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int x = 1; x < 4; x <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    if (row[i] >= N) continue;
    const float inv = 1.f / l[i];
    const int mt = i / 2, e0 = 2 * (i % 2);
    float* dst = out + base + (long long)row[i] * D + 2 * JG * t;
#pragma unroll
    for (int gr = 0; gr < J / JG; ++gr) {
      float y[2 * JG];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
        y[jj] = o[mt][JG * gr + jj][e0] * inv;
        y[JG + jj] = o[mt][JG * gr + jj][e0 + 1] * inv;
      }
#pragma unroll
      for (int e = 0; e < 2 * JG; e += 4)
        Vec<4>::store(dst + 8 * JG * gr + e, y + e);
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* seg,
           float* out, int B, int H, int N, int n_extra, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BM - 1) / BM, B * H);
  flash_attn_kernel<D><<<grid, NT, smem, stream>>>(q, k, v, seg, out, H, N,
                                                   n_extra, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// n_extra = n_pad - N, the pad keys every masked query also attends to.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a D without an instance or bad sizes.
extern "C" int flash_attn_f32(const float* q, const float* k, const float* v,
                              const int* seg, float* out, int B, int H, int N,
                              int D, int n_extra, float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || n_extra < 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 16) return launch<16>(q, k, v, seg, out, B, H, N, n_extra, scale, s);
  if (D == 32) return launch<32>(q, k, v, seg, out, B, H, N, n_extra, scale, s);
  if (D == 64) return launch<64>(q, k, v, seg, out, B, H, N, n_extra, scale, s);
  return (int)cudaErrorInvalidValue;
}

// 1 when D has a compiled instance.
extern "C" int flash_attn_supported(int D) {
  return D == 16 || D == 32 || D == 64;
}
