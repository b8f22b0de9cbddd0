// Kernel E: one whole AMPBlock1 dilation unit,
//
//   t = bias1 + conv1(act1(x))             conv1: K taps, dilation d
//   y = out_scale * (bias2 + conv2(act2(t)) + x + e0 + e1)   conv2: K, 1
//
// where act is the anti-aliased snake of kernel A, zero outside [0, T) as
// each conv's padding, and act2 reads t replicate-clamped at the sequence
// edges (t's values outside [0, T) are never used). Equals two kernel-D
// pairs, with conv1's output kept in shared memory.
//
// Replaces the Pallas kernel flowhigh_tpu/ops/packed.py:
// pallas_packed_amp_unit (core _amp_unit_core, body _make_amp_unit_kernel),
// with its edge handling: the replicate substitution of conv1's output
// before act2 (packed.py:1190-1194) is the clamp of SmemSrc, the zero
// masks of both activations (:1186-1188, :1197-1199) are the core's. The
// subtile pipeline= interleave (:1212-1239) is TPU scheduling and has no
// counterpart.
//
// Layout: x, e0, e1, y [B, C, T]; w1, w2 [C, C, K]; alpha/beta [C]; all
// contiguous. x, e0, e1 and y are in the storage type (float32, or bf16 for
// the JAX package's bf16 feature maps: widened to f32 on load, y rounded
// once at the store; act_conv_core.cuh); conv1's output t stays f32 in
// shared memory whatever the storage, as in the JAX kernel
// (packed.py:1139-1148). The rest is float32.
//
// Bound (a 10 s clip, 27 launches at C = 192, 96 and 48): operations.
// F32 runs each product as three TF32 products on the tensor cores
// (3xTF32: 4.74 TFLOP of TF32 products, 9.6 ms at 495 TFLOP/s), BF16 one
// bf16 product (2.6 ms), I8 one s8 product (0.8 ms at 1,979 TOP/s); the
// two snakes add ~112 f32 operations a sample and channel. Against two
// kernel-D pairs the unit saves conv1's output write and read (8 bytes an
// element).
//
// Design: a block (I8: a cluster) owns TT = BN - 2 H output samples of all
// C channels, H = (K - 1) / 2 + 6 (conv2's reach plus act2's). Phase 1
// computes conv1 over BN samples starting H before the tile and keeps the
// result, C x BN floats, in shared memory. Phase 2 runs act2 and conv2
// with src read from there. Weights (w1 and w2, 3.2 MB at C = 192, K = 11)
// are not resident: each block streams them through L2 once per phase.
// Two kernels, both on the tensor cores:
// - F32, BF16 (amp_unit_mma_kernel): the act->conv pass of
//   act_conv_core.cuh (act_conv_mma, 8 warps) for each BM-channel block of
//   conv1's output, then for conv2. BN = 192 and one pass of BM = 192
//   channels at C = 192 (warps 4 along channels x 2 along time, each
//   48 x 96), so each activation runs once per sample: 147,456 bytes of
//   conv1 output leave room for the pass's working set, up to 78,688 bytes
//   (BF16, K = 11, d = 5), where BN = 256 would not (196,608 bytes). The
//   halo costs BN / TT = 1.08x (K = 3) to 1.13x (K = 11) of the unit's
//   work. At C = 96 and 48: one pass of BM = 96 (2 x 4 warps) or 48
//   (1 x 8); BF16 over BN = 128, so that two blocks share an SM and one's
//   snake runs beside the other's GEMM (1.12-1.21x halo work), F32 over
//   BN = 256 (1.06-1.09x; its GEMM dominates, and 128 ran 1.03-1.25x
//   slower); any other C: BN = 192, BM = 64 (2 x 4). 16 warps a block
//   (48 x 48 a warp at C = 192) ran slower or spilled at 128 registers,
//   except E.bf16 at C = 192 (PERF.md). Weights: kernel B's prepared
//   layout [K][C_p][C_p] (ops/conv.py:conv_weights), f32 or bf16.
// - I8 (amp_unit_s8_kernel, s8 mma.sync): the pass is the int8 window,
//   BN = 256 (TT = 256 - 2 H outputs), because act2's scale can only come
//   from conv1's output on chip. Two scales per tile (ops/quant.py): act1's
//   over [t0 - H - pad1, t0 + TT + H + pad1), from the pre-pass
//   act_amax_kernel (act_conv_core.cuh; one launch before the kernel, 8
//   channels' partial maxima per window in the caller's scratch), and
//   act2's over [t0 - pad2, t0 + TT + pad2), in the kernel. A tile is a
//   cluster of n = ceil(C / BM) blocks (BM = 96 with 16 warps, one block
//   an SM; 48 with 8 warps, two an SM, at C <= 48; n = 2 at C = 192, 1 at
//   96 and 48), block r owning output channels [r BM, (r + 1) BM) of both
//   convs and their conv1 output (BM x 256 floats, 98,304 bytes: all 192
//   channels, 196,608, leave too little of 227 KB for a tensor-core
//   pass). Every block holds the whole quantised activation,
//   [ceil(C / 32)][256 + 2 pad1] rows of 32 bytes (i8_offset), and:
//   1. computes act1 of its share of the 32-channel chunks (every n-th),
//      quantised with act1's scale and written into every block's rows
//      (DSMEM); a cluster barrier;
//   2. runs conv1 (s8 mma.sync, weights through a RING of 32-byte rows,
//      mma_tap_s8) for its BM channels over the 256 samples into its
//      conv1 output;
//   3. computes act2 of its own channels over the 244 samples of act2's
//      window (TT + 2 pad2), in place of their conv1 output, and its
//      largest |value|; the blocks exchange those (DSMEM, a cluster
//      barrier) for act2's scale, so act2 runs once a sample;
//   4. quantises its channels' act2 into every block's rows (4 channels a
//      32-bit DSMEM store); a cluster barrier;
//   5. runs conv2 for its BM channels, epilogue as above.
//   Both activations are computed without FMAs (snake_ordered), so that
//   they equal their plain version's bits and int8 quanta. Weights: the
//   prepared int8 layout [K][C_p][C_p] (ops/conv.py:conv_weights; C_p a
//   multiple of 32) with [C] scales.
//
// The unit's tile TT is mirrored by ops/fused_conv.py:amp_unit_plan, the
// shared memory by amp_unit_smem_bytes there.

#include "act_conv_core.cuh"

namespace {

// --- F32, BF16: passes of the act->conv core --------------------------------

// blocks an SM: two where a pass has at most 96 x 128 outputs (at most 128
// registers a thread), else one (up to 255)
// F32 on bf16 maps keeps one: widening the staged words in place (while
// the accumulators are live) spilled 4-56 bytes at 128 registers.
__host__ __device__ constexpr int unit_min_blocks(int BM, int BN,
                                                  bool f32_on_bf16) {
  return BM * BN <= 96 * 128 && !f32_on_bf16 ? 2 : 1;
}

template <Dot D, int K, int BM, int BN, int WM, Store ST>
__global__ void __launch_bounds__(
    MMA_NT, unit_min_blocks(BM, BN, D == Dot::F32 && ST == Store::BF16))
amp_unit_mma_kernel(const StoreT<ST>* __restrict__ x,
                    const float* __restrict__ a1,
                    const float* __restrict__ be1,
                    const float* __restrict__ a2,
                    const float* __restrict__ be2,
                    const typename MmaOps<D>::WT* __restrict__ w1,
                    const float* __restrict__ bias1,
                    const typename MmaOps<D>::WT* __restrict__ w2,
                    const float* __restrict__ bias2,
                    const StoreT<ST>* __restrict__ e0,
                    const StoreT<ST>* __restrict__ e1,
                    StoreT<ST>* __restrict__ y, int C, int T, int cin_p,
                    int cout_p, int dil, int logscale, float out_scale) {
  constexpr int H = (K - 1) / 2 + 6;
  constexpr int TT = BN - 2 * H;
  // F32 short of registers (LEAN and NP in act_conv_core.cuh): the
  // one-position snake at 192 x 192 (up to 255 registers; the two-position
  // one spilled 4-28 bytes there, and LEAN did not help), LEAN at two
  // blocks an SM (128)
  constexpr int NP = D == Dot::F32 && BM * BN > 96 * 256 ? 1 : 2;
  constexpr bool LEAN =
      D == Dot::F32 && unit_min_blocks(BM, BN, ST == Store::BF16) == 2;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  float* t1 = reinterpret_cast<float*>(smem_mma);  // [C][BN], from t0 - H
  unsigned char* work = smem_mma + (long long)C * BN * 4;
  const int t0 = blockIdx.x * TT;
  const long long b = blockIdx.y;

  auto epi1 = [&](int co, int l, float acc) {
    t1[co * BN + l] = acc + (bias1 != nullptr ? bias1[co] : 0.0f);
  };
  for (int co0 = 0; co0 < C; co0 += BM)
    act_conv_mma<D, K, BM, BN, WM, LEAN, NP, false>(
        GlobalSrc<ST>{x + b * C * T, T}, epi1, work, a1, be1, logscale, w1, C, C,
        cin_p, cout_p, co0, T, t0 - H, dil);

  // each pass starts with a barrier: phase 1's writes of t1 are complete
  // before phase 2 stages from it
  const long long ob = b * C * T;
  auto epi2 = [&](int co, int l, float acc) {
    const int t = t0 + l;
    if (l >= TT || t >= T) return;
    const long long o = ob + (long long)co * T + t;
    float v = acc + (bias2 != nullptr ? bias2[co] : 0.0f);
    v += load_f32(x + o);
    if (e0 != nullptr) v += load_f32(e0 + o);
    if (e1 != nullptr) v += load_f32(e1 + o);
    store_f32(y + o, v * out_scale);
  };
  for (int co0 = 0; co0 < C; co0 += BM)
    act_conv_mma<D, K, BM, BN, WM, LEAN, NP, false>(
        SmemSrc{t1, BN, t0 - H, T}, epi2, work, a2, be2, logscale, w2, C, C,
        cin_p, cout_p, co0, T, t0, 1);
}

template <int K, int BM, int BN, int WM>
long long mma_smem_bytes(int C, int dil, bool bf) {
  return (long long)C * BN * 4 + mma_core_bytes(BM, BN, dil * (K - 1) / 2,
                                                bf ? Dot::BF16 : Dot::F32,
                                                false);
}

// the tile (BM, BN, warps along channels) of C for BF16 (BF) or F32; -1
// without an instance
template <bool BF, class F>
long long dispatch_mma(int K, int C, const F& f) {
  const int kind = C % 192 == 0 ? 0 : C % 96 == 0 ? 1 : C % 48 == 0 ? 2 : 3;
  constexpr int BN2 = BF ? 128 : 256;  // the pass at C = 96, 48
#define FHT_CASE(K_)                                                       \
  case K_:                                                                 \
    return kind == 0   ? f.template run<K_, 192, 192, 4>()                 \
           : kind == 1 ? f.template run<K_, 96, BN2, 2>()                  \
           : kind == 2 ? f.template run<K_, 48, BN2, 1>()                  \
                       : f.template run<K_, 64, 192, 2>();
  switch (K) {
    FHT_CASE(3)
    FHT_CASE(7)
    FHT_CASE(11)
    default: return -1;
  }
#undef FHT_CASE
}

struct MmaSmemQuery {
  int C, dil;
  bool bf;
  template <int K, int BM, int BN, int WM>
  long long run() const {
    return mma_smem_bytes<K, BM, BN, WM>(C, dil, bf);
  }
};

template <Dot D, Store ST>
struct MmaLauncher {
  const void* x;
  const float *a1, *be1, *a2, *be2, *filt;
  const void* w1;
  const float* bias1;
  const void* w2;
  const float* bias2;
  const void *e0, *e1;
  void* y;
  int B, C, T, cin_p, cout_p, dil, logscale;
  float out_scale;
  cudaStream_t s;
  template <int K, int BM, int BN, int WM>
  long long run() const {
    using WT = typename MmaOps<D>::WT;
    using S = StoreT<ST>;
    auto kern = amp_unit_mma_kernel<D, K, BM, BN, WM, ST>;
    const long long smem =
        mma_smem_bytes<K, BM, BN, WM>(C, dil, MmaOps<D>::BF);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = set_taps(filt, s);
    if (e != cudaSuccess) return (int)e;
    constexpr int TT = BN - 2 * ((K - 1) / 2 + 6);
    dim3 grid((T + TT - 1) / TT, B);
    kern<<<grid, MMA_NT, smem, s>>>(
        static_cast<const S*>(x), a1, be1, a2, be2,
        static_cast<const WT*>(w1), bias1, static_cast<const WT*>(w2), bias2,
        static_cast<const S*>(e0), static_cast<const S*>(e1),
        static_cast<S*>(y), C, T, cin_p, cout_p, dil, logscale, out_scale);
    return (int)cudaGetLastError();
  }
};

template <Dot D, Store ST = Store::F32>
int amp_unit_mma(const void* x, const float* a1, const float* be1,
                 const float* a2, const float* be2, const float* filt,
                 const void* w1, const float* bias1, const void* w2,
                 const float* bias2, const void* e0, const void* e1,
                 void* y, int B, int C, int T, int K, int dil, int logscale,
                 int cin_p, int cout_p, float out_scale, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || dil <= 0 || B > 65535 || cin_p < C ||
      cin_p % 16 != 0 || cout_p < C)
    return (int)cudaErrorInvalidValue;
  const MmaLauncher<D, ST> f{x,     a1, be1,   a2,     be2, filt,     w1,
                         bias1, w2, bias2, e0,     e1,  y,        B,
                         C,     T,  cin_p, cout_p, dil, logscale, out_scale,
                         (cudaStream_t)stream};
  const long long err = dispatch_mma<MmaOps<D>::BF>(K, C, f);
  return err < 0 ? (int)cudaErrorInvalidValue : (int)err;
}

// --- I8: clusters sharing the quantised activation ---------------------------

constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// Threads a block: 16 warps for 96 output channels (one block an SM: twice
// the 8 warps' latency hiding in the snakes, 1.12-1.14x faster at C = 192,
// 96 on an H100, PERF.md), 8 for 48 (two blocks an SM; 16 warps at one ran
// 1.29x slower)
__host__ __device__ constexpr int s8_threads(int BM) {
  return BM == 48 ? 256 : 512;
}

// Bytes of shared memory of one block (see the top of this file): conv1
// output BM x 256 floats | activation rows ceil(C / 32) x (256 + 2 pad) x
// 32 | weight ring RING x BM x 32 | two stages of raw input SUB x (256 +
// 2 pad + 12) floats | snake signal SUB x 2 (256 + 2 pad + 6) floats |
// two stages of snake parameters 2 x SUB floats | the cluster's act2
// maxima MAX_CLUSTER floats
__host__ __device__ constexpr long long s8_unit_bytes(int C, int BM,
                                                      int pad) {
  const long long aw = I8_WINDOW + 2 * pad;
  return 4LL * BM * I8_WINDOW + (C + 31) / 32 * aw * 32 + RING * BM * 32LL +
         4 * (2 * SUB * (aw + 12) + SUB * 2 * (aw + 6) + 2 * 2 * SUB +
              MAX_CLUSTER);
}

// One unit tile, as a cluster (grid (n, tiles, B), cluster (n, 1, 1)). w1,
// w2: the prepared int8 weights [K][cout_p][cin_p], sw1, sw2 their [C]
// scales; part: act1's pre-pass maxima, n_groups a tile
template <int K, int BM, Store ST>
__global__ void __launch_bounds__(s8_threads(BM), BM == 48 ? 2 : 1)
amp_unit_s8_kernel(const StoreT<ST>* __restrict__ x,
                   const float* __restrict__ a1,
                   const float* __restrict__ be1,
                   const float* __restrict__ a2,
                   const float* __restrict__ be2,
                   const signed char* __restrict__ w1,
                   const float* __restrict__ sw1,
                   const float* __restrict__ bias1,
                   const signed char* __restrict__ w2,
                   const float* __restrict__ sw2,
                   const float* __restrict__ bias2,
                   const StoreT<ST>* __restrict__ e0,
                   const StoreT<ST>* __restrict__ e1,
                   StoreT<ST>* __restrict__ y, const float* __restrict__ part,
                   int n_groups, int C, int T, int cin_p, int cout_p, int dil,
                   int logscale, float out_scale) {
  namespace cg = cooperative_groups;
  constexpr int BN = I8_WINDOW;
  constexpr int H = (K - 1) / 2 + 6;
  constexpr int TT = BN - 2 * H;
  constexpr int AW2 = BN - 12;  // act2's window, TT + 2 pad2
  // warps: 48 output channels x 256 / WN samples each
  constexpr int NT = s8_threads(BM);
  constexpr int WM = BM / 48, WN = NT / 32 / WM;
  constexpr int MT = BM / (16 * WM), NT8 = BN / (8 * WN);
  static_assert(MT * 16 * WM == BM && NT8 * 8 * WN == BN, "warp tiles");
  extern __shared__ __align__(16) unsigned char smem_s8[];
  __shared__ float red[32];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), n_ranks = (int)cl.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;
  const int co0 = rank * BM, own = min(BM, C - co0);
  const int t0 = blockIdx.y * TT;
  const long long b = blockIdx.z;
  const int pad1 = dil * (K - 1) / 2, aw1 = BN + 2 * pad1;
  const int xw1 = aw1 + 12, sn1 = aw1 + 6;
  const int n_ch = (C + 31) / 32;  // 32-channel chunks of the activation

  float* t1 = reinterpret_cast<float*>(smem_s8);  // [BM][BN] from t0 - H
  unsigned char* act = smem_s8 + 4 * BM * BN;     // [n_ch][aw1][32]
  signed char* ring =
      reinterpret_cast<signed char*>(act + (long long)n_ch * aw1 * 32);
  float* xr0 = reinterpret_cast<float*>(ring + RING * BM * 32);
  float* sig = xr0 + 2 * SUB * xw1;
  float* ab0 = sig + SUB * 2 * sn1;
  float* slots = ab0 + 2 * 2 * SUB;

  const Quant q1 = window_quant(
      part + (b * gridDim.y + blockIdx.y) * n_groups, n_groups, red);
  cl.sync();  // every block of the cluster runs before any DSMEM write

  // 8 channels of src from channel c (n_valid of them; zeros after) and
  // their snake parameters (channel pc ...) into stage st, xw samples from
  // position g0; with ``widen``, once they have landed, this thread's words
  // of bf16 maps widened in place instead (GlobalSrc::widen)
  auto stage = [&](const auto& src, int st, int c, int n_valid, int pc,
                   const float* alpha, const float* beta, int g0, int xw,
                   bool widen) {
    float* xr = xr0 + st * SUB * xw;
    const float inv_xw = 1.0f / xw;
    if (widen) {
      if constexpr (std::decay_t<decltype(src)>::WIDEN)
#pragma unroll 1
        for (int e = tid; e < SUB * xw; e += NT) {
          const int ci = split(e, inv_xw);
          if (ci < n_valid) src.widen(xr + e, c + ci, g0 + e - ci * xw);
        }
      return;
    }
    for (int e = tid; e < SUB * xw; e += NT) {
      const int ci = split(e, inv_xw);
      src.stage(xr + e, c + ci, g0 + e - ci * xw, ci < n_valid);
    }
    if (tid < SUB) {
      float a = 1.0f, bb = 1.0f;
      if (tid < n_valid) {
        a = alpha[pc + tid];
        bb = beta != nullptr ? beta[pc + tid] : a;
        if (logscale) {
          a = expf(a);
          bb = expf(bb);
        }
      }
      float* ab = ab0 + st * 2 * SUB;
      ab[tid] = a;
      ab[SUB + tid] = 1.0f / (bb + 1e-9f);
    }
  };
  // n sub-passes: staging of i + 1 (stage_i) overlaps the snake of i
  // (compute_i); ends with every thread done with the stages and sig
  auto sub_passes = [&](int n, const auto& stage_i, const auto& compute_i) {
    if (n > 0) stage_i(0, 0, false);
    cp_async_commit();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      if (i + 1 < n) stage_i(i + 1, (i + 1) & 1, false);
      cp_async_commit();
      cp_async_wait<1>();     // stage i landed ...
      stage_i(i, i & 1, true);  // (bf16 maps: widened by its stager)
      __syncthreads();  // ... for every thread; sub-pass i - 1 is done
      compute_i(i, i & 1);
    }
    cp_async_wait<0>();
    __syncthreads();
  };

  // 1. act1 of chunks rank, rank + n, ... (sub-pass i: chunk rank + n (i /
  // 4), channels 8 (i % 4) ..), quantised into every block's rows
  const int my_ch = (n_ch - rank + n_ranks - 1) / n_ranks;
  const int n_sub1 =
      my_ch <= 0 ? 0
                 : 4 * (my_ch - 1) +
                       min(4, (C - 32 * (rank + n_ranks * (my_ch - 1)) + 7) /
                                  8);
  const GlobalSrc<ST> src1{x + b * C * T, T};
  sub_passes(
      n_sub1,
      [&](int i, int st, bool widen) {
        const int c = 32 * (rank + n_ranks * (i >> 2)) + 8 * (i & 3);
        stage(src1, st, c, min(SUB, C - c), c, a1, be1, t0 - H - pad1 - 6,
              xw1, widen);
      },
      [&](int i, int st) {
        const int ch = rank + n_ranks * (i >> 2), c8 = 8 * (i & 3);
        const float* ab = ab0 + st * 2 * SUB;
        unsigned char* rows = act + (long long)ch * aw1 * 32;
        snake_ordered(xr0 + st * SUB * xw1, xw1, ab, ab + SUB, sig, sn1, 0,
                      aw1, t0 - H - pad1, T, [&](int j, int c, float v) {
                        unsigned char* dst = rows + i8_offset(j, c8 + c);
                        const unsigned char qv =
                            (unsigned char)__float2int_rn(v * q1.qs);
                        for (int r = 0; r < n_ranks; ++r)
                          *cl.map_shared_rank(dst, r) = qv;
                      });
      });
  cl.sync();  // every block's share of act1 has landed

  int acc[MT][NT8][4];
  // acc = conv of the activation rows with wp (dilation dl), this block's
  // BM output channels; weights through the ring, one barrier a tap
  auto conv = [&](const signed char* wp, int dl) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;
    const int n_steps = n_ch * K;
    auto issue = [&](int s) {
      if (s < n_steps) {
        const int c = s / K, k = s - c * K;
        signed char* wd = ring + (s % RING) * BM * 32;
        for (int e = tid; e < 2 * BM; e += NT) {
          const int row = e >> 1, half = e & 1;
          const bool ok = co0 + row < cout_p;
          cp_async16_zfill(
              wd + w_row_offset(row, half, 16),
              ok ? wp + ((long long)k * cout_p + co0 + row) * cin_p + c * 32 +
                       half * 16
                 : wp,
              ok);
        }
      }
      cp_async_commit();
    };
#pragma unroll 1
    for (int s = 0; s < AHEAD; ++s) issue(s);
#pragma unroll 1
    for (int s = 0; s < n_steps; ++s) {
      const int c = s / K, k = s - c * K;
      cp_async_wait<AHEAD - 1>();  // step s's weights landed ...
      __syncthreads();             // ... for every thread; step s - 1 done
      issue(s + AHEAD);
      mma_tap_s8<MT, NT8>(acc, ring + (s % RING) * BM * 32,
                          act + (long long)c * aw1 * 32,
                          wn * NT8 * 8 + k * dl, wm, lane);
    }
    cp_async_wait<0>();  // only empty groups are left
  };
  // epi(co, l, value) for this block's outputs
  auto drain = [&](const float* sw, const Quant& q, const auto& epi) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int co = co0 + (wm * MT + i) * 16 + g + 8 * hh;
        if (co >= C || co - co0 >= BM) continue;
        const float fac = q.sx * sw[co];
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          const int l = (wn * NT8 + n) * 8 + 2 * t;
          epi(co, l, dequant(acc[i][n][2 * hh], fac));
          epi(co, l + 1, dequant(acc[i][n][2 * hh + 1], fac));
        }
      }
  };

  // 2. conv1 into this block's conv1 output
  conv(w1, dil);
  drain(sw1, q1, [&](int co, int l, float v) {
    t1[(co - co0) * BN + l] = v + (bias1 != nullptr ? bias1[co] : 0.0f);
  });
  __syncthreads();  // all of this block's conv1 output

  // 3. act2 of this block's channels over [t0 - pad2, t0 + TT + pad2), in
  // place: raw sample i is conv1 output i (position t0 - H + i)
  const int n_sub2 = (own + SUB - 1) / SUB;
  const SmemSrc src2{t1, BN, t0 - H, T};
  float m2 = 0.0f;
  sub_passes(
      n_sub2,
      [&](int i, int st, bool widen) {
        stage(src2, st, 8 * i, min(SUB, own - 8 * i), co0 + 8 * i, a2, be2,
              t0 - H, BN, widen);
      },
      [&](int i, int st) {
        const float* ab = ab0 + st * 2 * SUB;
        snake_ordered(xr0 + st * SUB * BN, BN, ab, ab + SUB, sig, AW2 + 6, 0,
                      AW2, t0 - (K - 1) / 2, T, [&](int j, int c, float v) {
                        t1[(8 * i + c) * BN + j] = v;
                        m2 = fmaxf(m2, fabsf(v));
                      });
      });
  m2 = block_max(m2, red);
  if (tid < n_ranks) *cl.map_shared_rank(slots + rank, tid) = m2;
  cl.sync();  // every block's maximum has landed; every block is done
              // reading act1
  float amax2 = 0.0f;
  for (int r = 0; r < n_ranks; ++r) amax2 = fmaxf(amax2, slots[r]);
  const Quant q2 = quant_of(amax2);

  // 4. act2's quanta of this block's channels (8 n_sub2 of them, the
  // last zeros past C) into every block's rows, 4 channels a store
  const float inv_aw2 = 1.0f / AW2;
  for (int e = tid; e < 2 * n_sub2 * AW2; e += NT) {
    const int c4 = 4 * split(e, inv_aw2), j = e - (c4 / 4) * AW2;
    unsigned word = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int qv = __float2int_rn(t1[(c4 + u) * BN + j] * q2.qs);
      word |= ((unsigned)qv & 0xffu) << (8 * u);
    }
    const int c = co0 + c4;
    unsigned* dst = reinterpret_cast<unsigned*>(
        act + (long long)(c >> 5) * aw1 * 32 + i8_offset(j, c & 31));
    for (int r = 0; r < n_ranks; ++r) *cl.map_shared_rank(dst, r) = word;
  }
  cl.sync();  // the whole of act2 has landed in every block

  // 5. conv2 and the epilogue
  conv(w2, 1);
  const long long ob = b * C * T;
  drain(sw2, q2, [&](int co, int l, float v) {
    const int tt = t0 + l;
    if (l >= TT || tt >= T) return;
    const long long o = ob + (long long)co * T + tt;
    v += bias2 != nullptr ? bias2[co] : 0.0f;
    v += load_f32(x + o);
    if (e0 != nullptr) v += load_f32(e0 + o);
    if (e1 != nullptr) v += load_f32(e1 + o);
    store_f32(y + o, v * out_scale);
  });
}

// BM of C: 96, or 48 where C <= 48 (one block)
inline int s8_unit_bm(int C) { return C <= 48 ? 48 : 96; }

template <class F>
long long dispatch_s8(int K, int C, const F& f) {
  const bool narrow = s8_unit_bm(C) == 48;
#define FHT_CASE(K_)                                                        \
  case K_:                                                                  \
    return narrow ? f.template run<K_, 48>() : f.template run<K_, 96>();
  switch (K) {
    FHT_CASE(3)
    FHT_CASE(7)
    FHT_CASE(11)
    default: return -1;
  }
#undef FHT_CASE
}

struct S8SmemQuery {
  int C, dil;
  template <int K, int BM>
  long long run() const {
    return s8_unit_bytes(C, BM, dil * (K - 1) / 2);
  }
};

template <Store ST>
struct S8Launcher {
  const void* x;
  const float *a1, *be1, *a2, *be2, *filt;
  const void* w1;
  const float *sw1, *bias1;
  const void* w2;
  const float *sw2, *bias2;
  const void *e0, *e1;
  void* y;
  float* part;
  int B, C, T, dil, logscale, cin_p, cout_p;
  float out_scale;
  cudaStream_t s;
  template <int K, int BM>
  long long run() const {
    using S = StoreT<ST>;
    auto kern = amp_unit_s8_kernel<K, BM, ST>;
    const int pad = dil * (K - 1) / 2, n = (C + BM - 1) / BM;
    constexpr int H = (K - 1) / 2 + 6, TT = I8_WINDOW - 2 * H;
    const long long smem = s8_unit_bytes(C, BM, pad);
    if (smem > 232448 || n > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = set_taps(filt, s);
    const int n_tiles = (T + TT - 1) / TT;
    if (e == cudaSuccess)  // act1's window scales first
      e = launch_act_amax<ST>(x, a1, be1, logscale, part, B, C, T, n_tiles,
                              TT, -H - pad, I8_WINDOW + 2 * pad, s);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n, n_tiles, B);
    cfg.blockDim = dim3(s8_threads(BM));
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(
        &cfg, kern, static_cast<const S*>(x), a1, be1, a2, be2,
        static_cast<const signed char*>(w1), sw1, bias1,
        static_cast<const signed char*>(w2), sw2, bias2,
        static_cast<const S*>(e0), static_cast<const S*>(e1),
        static_cast<S*>(y), static_cast<const float*>(part),
        (C + AMAX_CH - 1) / AMAX_CH, C, T, cin_p, cout_p, dil, logscale,
        out_scale);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
};

}  // namespace

// Shared memory one block of instance ``dot`` (0 f32, 1 bf16, 2 int8) takes
// (bytes), -1 without an instance; mirrored by
// flowhigh_tpu_torch/ops/fused_conv.py:amp_unit_smem_bytes.
extern "C" long long amp_unit_smem_bytes(int K, int dil, int C, int dot) {
  if (dot == (int)Dot::I8) return dispatch_s8(K, C, S8SmemQuery{C, dil});
  return dot == (int)Dot::BF16
             ? dispatch_mma<true>(K, C, MmaSmemQuery{C, dil, true})
             : dispatch_mma<false>(K, C, MmaSmemQuery{C, dil, false});
}

template <Store ST>
int amp_unit_s8(const void* x, const float* a1, const float* be1,
                const float* a2, const float* be2, const float* filt,
                const void* w1, const float* sw1, const float* bias1,
                const void* w2, const float* sw2, const float* bias2,
                const void* e0, const void* e1, void* y, float* part, int B,
                int C, int T, int K, int dil, int logscale, int cin_p,
                int cout_p, float out_scale, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || dil <= 0 || B > 65535 || cin_p < C ||
      cin_p % 32 != 0 || cout_p < C || sw1 == nullptr || sw2 == nullptr ||
      part == nullptr)
    return (int)cudaErrorInvalidValue;
  const S8Launcher<ST> f{x,   a1,    be1,   a2,    be2,      filt,   w1,
                         sw1, bias1, w2,    sw2,   bias2,    e0,     e1,
                         y,   part,  B,     C,     T,        dil,    logscale,
                         cin_p, cout_p, out_scale, (cudaStream_t)stream};
  const long long err = dispatch_s8(K, C, f);
  return err < 0 ? (int)cudaErrorInvalidValue : (int)err;
}

// The launch entry points on float32 maps build here; those on bf16 maps
// build from amp_unit_bf16io.cu, which defines FHT_BF16_MAPS and includes
// this file, so that the two halves compile in parallel.
#ifndef FHT_BF16_MAPS
// Each returns cudaGetLastError() after the launch (or the error that kept
// it from launching). be1, be2, bias1, bias2, e0 and e1 may be null. w1,
// w2: kernel B's prepared weights [K][cout_p][cin_p]
// (ops/conv.py:conv_weights), float32 for amp_unit_f32 and bfloat16
// (rounded to nearest even) for amp_unit_bf16; cin_p a multiple of 16.
extern "C" int amp_unit_f32(const float* x, const float* a1, const float* be1,
                            const float* a2, const float* be2,
                            const float* filt, const void* w1,
                            const float* bias1, const void* w2,
                            const float* bias2, const float* e0,
                            const float* e1, float* y, int B, int C, int T,
                            int K, int dil, int logscale, int cin_p,
                            int cout_p, float out_scale, void* stream) {
  return amp_unit_mma<Dot::F32>(x, a1, be1, a2, be2, filt, w1, bias1, w2,
                                bias2, e0, e1, y, B, C, T, K, dil, logscale,
                                cin_p, cout_p, out_scale, stream);
}

extern "C" int amp_unit_bf16(const float* x, const float* a1,
                             const float* be1, const float* a2,
                             const float* be2, const float* filt,
                             const void* w1, const float* bias1,
                             const void* w2, const float* bias2,
                             const float* e0, const float* e1, float* y,
                             int B, int C, int T, int K, int dil,
                             int logscale, int cin_p, int cout_p,
                             float out_scale, void* stream) {
  return amp_unit_mma<Dot::BF16>(x, a1, be1, a2, be2, filt, w1, bias1, w2,
                                 bias2, e0, e1, y, B, C, T, K, dil, logscale,
                                 cin_p, cout_p, out_scale, stream);
}

// w1, w2: the prepared int8 weights [K][cout_p][cin_p]
// (ops/conv.py:conv_weights, quantize_weights' values; cin_p a multiple of
// 32), sw1, sw2 their [C] scales; part: scratch of B x ceil(T / TT) x
// ceil(C / 8) floats for act1's window scales (two launches: the pre-pass,
// then the kernel).
extern "C" int amp_unit_int8(const float* x, const float* a1,
                             const float* be1, const float* a2,
                             const float* be2, const float* filt,
                             const void* w1, const float* sw1,
                             const float* bias1, const void* w2,
                             const float* sw2, const float* bias2,
                             const float* e0, const float* e1, float* y,
                             float* part, int B, int C, int T, int K,
                             int dil, int logscale, int cin_p, int cout_p,
                             float out_scale, void* stream) {
  return amp_unit_s8<Store::F32>(x, a1, be1, a2, be2, filt, w1, sw1, bias1,
                                 w2, sw2, bias2, e0, e1, y, part, B, C, T, K,
                                 dil, logscale, cin_p, cout_p, out_scale,
                                 stream);
}

#else  // FHT_BF16_MAPS
// The same three instances on bf16 maps: x, e0, e1 and y __nv_bfloat16
// (the rest as above).
extern "C" int amp_unit_f32_bf16io(const void* x, const float* a1,
                                   const float* be1, const float* a2,
                                   const float* be2, const float* filt,
                                   const void* w1, const float* bias1,
                                   const void* w2, const float* bias2,
                                   const void* e0, const void* e1, void* y,
                                   int B, int C, int T, int K, int dil,
                                   int logscale, int cin_p, int cout_p,
                                   float out_scale, void* stream) {
  return amp_unit_mma<Dot::F32, Store::BF16>(
      x, a1, be1, a2, be2, filt, w1, bias1, w2, bias2, e0, e1, y, B, C, T, K,
      dil, logscale, cin_p, cout_p, out_scale, stream);
}

extern "C" int amp_unit_bf16_bf16io(const void* x, const float* a1,
                                    const float* be1, const float* a2,
                                    const float* be2, const float* filt,
                                    const void* w1, const float* bias1,
                                    const void* w2, const float* bias2,
                                    const void* e0, const void* e1, void* y,
                                    int B, int C, int T, int K, int dil,
                                    int logscale, int cin_p, int cout_p,
                                    float out_scale, void* stream) {
  return amp_unit_mma<Dot::BF16, Store::BF16>(
      x, a1, be1, a2, be2, filt, w1, bias1, w2, bias2, e0, e1, y, B, C, T, K,
      dil, logscale, cin_p, cout_p, out_scale, stream);
}

extern "C" int amp_unit_int8_bf16io(const void* x, const float* a1,
                                    const float* be1, const float* a2,
                                    const float* be2, const float* filt,
                                    const void* w1, const float* sw1,
                                    const float* bias1, const void* w2,
                                    const float* sw2, const float* bias2,
                                    const void* e0, const void* e1, void* y,
                                    float* part, int B, int C, int T, int K,
                                    int dil, int logscale, int cin_p,
                                    int cout_p, float out_scale,
                                    void* stream) {
  return amp_unit_s8<Store::BF16>(x, a1, be1, a2, be2, filt, w1, sw1, bias1,
                                  w2, sw2, bias2, e0, e1, y, part, B, C, T, K,
                                  dil, logscale, cin_p, cout_p, out_scale,
                                  stream);
}
#endif  // FHT_BF16_MAPS
