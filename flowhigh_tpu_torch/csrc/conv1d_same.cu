// Kernel B: dilated "same" 1-D convolution with a fused epilogue,
//   y = out_scale * (bias + sum_{ci,k} w[co,ci,k] x[ci, t + k*d - pad]
//                    + r0 + r1 + r2),         pad = d*(K-1)/2, zero padding.
//
// Replaces the Pallas kernel flowhigh_tpu/ops/packed.py:pallas_packed_conv1d
// (:235; core _pallas_conv_rows, body _make_conv_kernel :183, pallas_call
// :361) at p = 1: the BigVGAN resblock convs (K in {3,7,11}, d in {1,3,5})
// with up to three residuals and the folded MRF average (out_scale = 1/3),
// and conv_post (Cout = 1).
//
// Layout: x [B, Cin, T], residuals and y [B, Cout, T], contiguous, in the
// storage type (dot_dtype.cuh: float32, or bf16 for the JAX package's bf16
// feature maps: loaded into f32, the epilogue in f32, y rounded once at the
// store). The weights come in the layout of their route (below).
//
// Two routes:
//
// 1. The GEMM route (F32, BF16, I8; Cout >= 16, K in {3, 7, 11}): an
//    implicit GEMM on the tensor cores, Y[co, t] = sum_k W_k[co, :] x[:, t +
//    k*d - pad]. Bound (a 10 s clip, 91 launches; I8 90): F32 by operations
//    (3.07 TFLOP of products, run as 3xTF32: three TF32 products per f32
//    product), BF16 and I8 by bytes. Design, as kernel C
//    (conv_transpose1d.cu), whose helpers it shares (mma_sm90.cuh):
//    - BF16: mma.sync m16n8k16 bf16 -> f32 (a bf16 x bf16 product is exact,
//      so this is the JAX kernel's bf16 dot with f32 accumulation); F32:
//      3xTF32 on m16n8k8 (the weights split into TF32 hi and lo in
//      registers, x once a chunk in shared memory), each tap's three
//      products summed in a fresh accumulator and added to the sum in f32
//      with round to nearest (the tensor cores' own sums round toward zero,
//      which drifts over the 8,448-deep sums of stage 1). BF16 keeps the
//      tensor cores' sums (tests/test_torch_conv_plan.py emulates both);
//    - I8 (the JAX kernel's int8 dot, dot_dtype.cuh): mma.sync m16n8k32 s8
//      -> s32 on int8 quanta of x and of the weights, integer sums (exact
//      in any order), then float(acc) * (s_x * s_w[co]). The block's 256
//      frames are the int8 window of ops/quant.py (outputs [t0, t0 + 256),
//      x over [t0 - pad, t0 + 256 + pad) ∩ [0, T), one scale s_x), so a
//      pre-pass launch (conv1d_amax_kernel) first writes each window's
//      largest |x| as partial maxima of 8 channels, and each block reduces
//      its window's (window_quant): the window is read once for its scale,
//      not once per block of output channels;
//    - a block owns TILE_CO output channels x BN = 256 frames: TILE_CO = 64
//      (8 warps as 2 along channels x 4 along time, a warp 32 x 64), or 48
//      where 48 divides Cout and 64 does not (the C = 48, 96 stages: 8 warps
//      along time, a warp 48 x 32), so no tile row idles there;
//    - per chunk of KC input channels (8 f32, 16 bf16, 32 int8: 32 bytes)
//      the block stages the chunk's weights [K][TILE_CO][KC] (16-byte
//      cp.async) and x over the tile plus the taps' reach, BN + 2 pad
//      frames, transposed to [frame][ci] (4-byte cp.async, zero-filled at
//      the sequence's edges and beyond Cin): tap k is then the row offset
//      k*d, so one staged window serves every tap and every x value is
//      staged once. Each thread then splits (F32, see split_x_once), rounds
//      to bf16 rows read by ldmatrix (BF16) or quantises to int8 rows read
//      by ldmatrix (I8: rint(x * 127 / amax), four channels a 32-bit
//      store, i8_offset) the values it staged. Two stages: the next chunk
//      loads while this one multiplies, one barrier a chunk. With bf16
//      maps a value cannot move alone by cp.async (4 bytes are two bf16 of
//      one channel, and the layout puts channels side by side): each is
//      staged as the 4-byte word that holds it, into its f32 slot, and the
//      thread that staged it widens it in place once it has landed, before
//      the steps above (mma_sm90.cuh: cp_async_bf16_word);
//    - the accumulators pass through shared memory (I8 dequantised), and
//      the epilogue (bias, residuals, scale, in the plain version's order)
//      leaves as 16-byte row stores.
//    Weights: [K][Cout_p][Cin_p] (Cout_p a multiple of COUT_ALIGN, Cin_p of
//    CIN_ALIGN, CIN_ALIGN_I8 for I8, zero-padded), f32, bf16 rounded to
//    nearest even for BF16, or int8 quanta for I8 with [Cout] scales
//    (ops/conv.py:conv_weights, prepared once per weight tensor).
//
// 2. The narrow route (F32, BF16; Cout < 16, any odd K: conv_post, Cin 48,
//    K 7, T 480,000 on a 10 s clip). Bound: bytes (a read of x and a write
//    of y). A block of 128 threads owns NB = 512 outputs of one output
//    channel and walks Cin in chunks of NCC = 8 channels: it stages x over
//    its outputs plus the taps' reach by 16-byte cp.async (4-byte where T
//    is not a multiple of 4), two stages, so that the next chunk's copies
//    are in flight while this one computes; each thread computes 4 outputs
//    (t0 + tid + 128 j, so a warp's shared-memory reads are consecutive) on
//    the FMA units. With bf16 maps the copies move 8 bytes (four values)
//    where T % 4 == 0, else one 4-byte word a value, and each thread widens
//    the values it staged in place once they have landed. Weights:
//    [Cout][Cin][K] f32 (bf16 values for BF16). int8 has no narrow route:
//    the vocoder keeps conv_post float32.

#include "dot_dtype.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int NT = 256;  // threads a block of the GEMM route and its pre-pass
constexpr int SMEM_MAX = 232448;  // bytes a block may use on the H100

// --- 1. the GEMM route -------------------------------------------------------------

constexpr int BN = 256;  // frames a block; for I8 the int8 window
constexpr int CIN_ALIGN = 16;  // Cin_p's multiple for F32, BF16 (KC divides it)
constexpr int CIN_ALIGN_I8 = 32;  // and for I8: one s8 k-step (KC)
constexpr int COUT_ALIGN = 64;  // Cout_p is a multiple of it (TILE_CO <= it)

// WM warps along channels (MT m16 tiles each), 8 / WM along time (NT8 n8
// tiles each)
template <Dot D, int WM, int MT>
struct Gemm {
  static constexpr bool BF = D == Dot::BF16;
  static constexpr bool I8 = D == Dot::I8;
  using WT = typename std::conditional<
      I8, signed char,
      typename std::conditional<BF, __nv_bfloat16, float>::type>::type;
  static constexpr int WN = 8 / WM;
  static constexpr int TILE_CO = WM * MT * 16;
  static constexpr int NT8 = BN / (WN * 8);
  static constexpr int KC = 32 / (int)sizeof(WT);     // channels a chunk
  static constexpr int EPS = 16 / (int)sizeof(WT);    // elements a 16-byte copy
  static constexpr int ALIGN = I8 ? CIN_ALIGN_I8 : CIN_ALIGN;  // of Cin_p
  // x staged f32 [frame][XS] by 4-byte cp.async (XS = 20: conflict-free
  // writes and fragment loads). F32 splits each value in place into TF32
  // hi (columns 0-7) and lo (8-15); BF16 converts each chunk to bf16 rows
  // of XSB elements (48 bytes: conflict-free ldmatrix at any row offset);
  // I8 (XS = 33: a warp stages 32 consecutive frames of a channel, an odd
  // stride puts them in 32 banks) quantises each chunk into 32-byte rows
  // of int8 quanta (i8_offset: conflict-free ldmatrix at any row offset)
  static constexpr int XS = I8 ? 33 : 20;
  static constexpr int XSB = 24;
  static constexpr int OS = BN + 8;  // output tile row stride: float2 stores
  static constexpr int O_BYTES = TILE_CO * OS * 4;
  static_assert(KC * sizeof(WT) == 32, "a weight row is two 16-byte copies");
  static_assert(NT8 % 2 == 0, "BF16, I8 load x fragments for two n-tiles");
  static_assert(TILE_CO <= COUT_ALIGN && COUT_ALIGN % 16 == 0, "tiles");
  __host__ __device__ static int w_bytes(int K) {
    return K * TILE_CO * KC * (int)sizeof(WT);
  }
  // window rows: BN frames plus the taps' reach
  __host__ __device__ static int x_rows(int K, int dil) {
    return BN + dil * (K - 1);
  }
  __host__ __device__ static int x32_bytes(int K, int dil) {
    return (x_rows(K, dil) * XS * 4 + 15) / 16 * 16;
  }
  // a stage: the chunk's weights and its x as the fragments read it (f32
  // hi and lo; bf16 for BF16, int8 quanta for I8, whose single f32 staging
  // buffer follows the stages)
  __host__ __device__ static int stage_bytes(int K, int dil) {
    return w_bytes(K) +
           (I8   ? x_rows(K, dil) * 32
            : BF ? (x_rows(K, dil) * XSB * 2 + 15) / 16 * 16
                 : x32_bytes(K, dil));
  }
  __host__ __device__ static int smem(int K, int dil) {
    const int s =
        2 * stage_bytes(K, dil) + (BF || I8 ? x32_bytes(K, dil) : 0);
    return s > O_BYTES ? s : O_BYTES;
  }
};

// F32 splits x into TF32 hi and lo once a chunk in shared memory, except
// the K = 3 instance with 48-channel tiles, which splits each fragment as
// it loads it and so fits 128 registers: split once, it takes 145 at one
// block an SM and ran 0.427 ms against 0.358 (96 channels, T 240,000, d 5;
// H100 80GB HBM3, scripts/port_conv_variants.py).
__host__ __device__ constexpr bool split_x_once(Dot D, int K, int WM) {
  return D == Dot::F32 && !(K == 3 && WM == 1);
}

// Blocks an SM keeps: 2 (at most 128 registers a thread), except the F32
// instances with K = 7, 11, which spill 16-32 bytes at 128 registers
// (ptxas) and keep 1 (147-194 registers, no spills). That costs 5-7%
// against 2 blocks with the spills: 1.351 / 1.277 ms (768 channels, K 11,
// d 5), 0.894 / 0.850 (384, K 7), 0.553 / 0.517 (48, K 11) on an H100
// 80GB HBM3 (scripts/port_conv_variants.py).
// On bf16 maps the F32 K = 3 instances keep 1 too: widening the staged
// words in place (while the accumulators are live) spilled 8 bytes at 128.
__host__ __device__ constexpr int mma_min_blocks(Dot D, int K, Store ST) {
  return D == Dot::F32 && (K != 3 || ST == Store::BF16) ? 1 : 2;
}

// The block's tile (see the top of this file); I8 also takes its window's
// scale q and the [Cout] weight scales sw.
template <Dot D, int K, int WM, int MT, Store ST>
__device__ __forceinline__ void conv1d_gemm(
    unsigned char* smem, const StoreT<ST>* __restrict__ x,
    const typename Gemm<D, WM, MT>::WT* __restrict__ wp,
    const float* __restrict__ bias, const StoreT<ST>* __restrict__ r0,
    const StoreT<ST>* __restrict__ r1, const StoreT<ST>* __restrict__ r2,
    StoreT<ST>* __restrict__ y, int Cin, int Cout, int T, int dil,
    float out_scale, Quant q = {0.0f, 0.0f},
    const float* __restrict__ sw = nullptr) {
  using G = Gemm<D, WM, MT>;
  using S = StoreT<ST>;
  // bf16 maps: x as words, widened in place (see the top of this file)
  constexpr bool WIDEN = ST == Store::BF16;
  using WT = typename G::WT;
  constexpr int KC = G::KC, EPS = G::EPS, XS = G::XS, XSB = G::XSB,
                NT8 = G::NT8, TILE_CO = G::TILE_CO;
  constexpr bool SPLIT_ONCE = split_x_once(D, K, WM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * TILE_CO;
  const long long b = blockIdx.z;
  const int pad = dil * (K - 1) / 2;
  const int cin_p = (Cin + G::ALIGN - 1) / G::ALIGN * G::ALIGN;
  const int cout_p = (Cout + COUT_ALIGN - 1) / COUT_ALIGN * COUT_ALIGN;
  const int xr_n = G::x_rows(K, dil);
  const int stage = G::stage_bytes(K, dil);
  const S* xb = x + b * (long long)Cin * T;

  auto w_stage = [&](int s) {
    return reinterpret_cast<WT*>(smem + s * stage);
  };
  // x as staged (f32; BF16, I8: one buffer for both stages) and, for BF16
  // and I8, as the fragments read it (bf16, int8)
  auto x_stage = [&](int s) {
    return reinterpret_cast<float*>(
        smem + (G::BF || G::I8 ? 2 * stage : s * stage + G::w_bytes(K)));
  };
  auto xb_stage = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * stage + G::w_bytes(K));
  };
  auto x8_stage = [&](int s) { return smem + s * stage + G::w_bytes(K); };

  // What a thread stages of every chunk: weight rows wrow + 128 i, 16-byte
  // half wseg; x's input channel xci at window rows xu + i XSTEP, lane =
  // 8 (ci % 4) + u % 8 (32-byte global segments; no bank conflicts)
  constexpr int WROWS = NT / 2, NW = (K * TILE_CO + WROWS - 1) / WROWS;
  const int wseg = tid & 1, wrow = tid >> 1;
  constexpr int XSTEP = NT / KC;
  const int xci = (tid >> 3) % KC;
  const int xu = ((tid >> 3) / KC) * 8 + (tid & 7);

  auto load = [&](int c0, int s) {
    WT* wd = w_stage(s);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int row = wrow + i * WROWS;  // = k TILE_CO + r
      if ((K * TILE_CO) % WROWS != 0 && row >= K * TILE_CO) break;
      const int k = row / TILE_CO, r = row - k * TILE_CO;
      cp_async16(wd + w_row_offset(row, wseg, EPS),
                 wp + ((long long)k * cout_p + co0 + r) * cin_p + c0 +
                     wseg * EPS);
    }
    if constexpr (G::I8) {
      // warp w: channels 4 w .. 4 w + 3 of the chunk, lane: frames lane +
      // 32 i (128-byte segments of x's rows)
      float* xd = x_stage(s) + 4 * warp;
      for (int u = lane; u < xr_n; u += 32) {
        const int gt = t0 - pad + u;
        const bool tvalid = (unsigned)gt < (unsigned)T;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = c0 + 4 * warp + j;
          const bool valid = tvalid && ci < Cin;
          if constexpr (WIDEN)
            cp_async_bf16_word(xd + u * XS + j,
                               valid ? xb + (long long)ci * T + gt : xb,
                               valid);
          else
            cp_async4_zfill(xd + u * XS + j,
                            valid ? xb + (long long)ci * T + gt : xb, valid);
        }
      }
      return;
    }
    float* xd = x_stage(s) + xci;
    const bool cvalid = c0 + xci < Cin;
    const S* xs = xb + (cvalid ? (long long)(c0 + xci) * T : 0);
    for (int u = xu; u < xr_n; u += XSTEP) {
      const int gt = t0 - pad + u;
      const bool valid = cvalid && (unsigned)gt < (unsigned)T;
      if constexpr (WIDEN)
        cp_async_bf16_word(xd + u * XS, valid ? xs + gt : xb, valid);
      else
        cp_async4_zfill(xd + u * XS, valid ? xs + gt : xb, valid);
    }
  };
  // bf16 maps: the words this thread staged for chunk c0, widened in place
  // once they have landed (the same elements as load's)
  auto widen_own = [&](int c0, int s) {
    if constexpr (!WIDEN) {
      return;
    } else if constexpr (G::I8) {
      float* xd = x_stage(s) + 4 * warp;
#pragma unroll 1
      for (int u = lane; u < xr_n; u += 32) {
        const int gt = t0 - pad + u;
        if ((unsigned)gt >= (unsigned)T) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = c0 + 4 * warp + j;
          if (ci < Cin)
            xd[u * XS + j] = bf16_half_to_f32(
                xd[u * XS + j],
                bf16_parity(xb, (unsigned)ci * (unsigned)T + (unsigned)gt));
        }
      }
    } else {
      if (c0 + xci >= Cin) return;
      float* xd = x_stage(s) + xci;
      const unsigned row = (unsigned)(c0 + xci) * (unsigned)T;
#pragma unroll 1
      for (int u = xu; u < xr_n; u += XSTEP) {
        const int gt = t0 - pad + u;
        if ((unsigned)gt < (unsigned)T)
          xd[u * XS] = bf16_half_to_f32(
              xd[u * XS], bf16_parity(xb, row + (unsigned)gt));
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

  // two stages, one barrier a chunk: the barrier at chunk c ends every
  // warp's reads of chunk c - 1, whose stage the load of chunk c + 1 refills
  // (and, for BF16 and I8, every thread's conversion of chunk c out of the
  // f32 buffer that the load refills)
  const int n_chunks = cin_p / KC;
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();
    if constexpr (WIDEN) widen_own(c * KC, c & 1);
    if constexpr (G::I8) {  // the values this thread staged, quantised
      const float* xf = x_stage(0) + 4 * warp;
      unsigned char* xq = x8_stage(c & 1);
      for (int u = lane; u < xr_n; u += 32) {
        const float* v = xf + u * XS;
        unsigned packed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          packed |= (unsigned)(quantize(v[j], q.qs) & 0xff) << (8 * j);
        *reinterpret_cast<unsigned*>(xq + i8_offset(u, 4 * warp)) = packed;
      }
    } else if constexpr (G::BF) {  // the values this thread staged, to bf16
      const float* xf = x_stage(0) + xci;
      __nv_bfloat16* xh = xb_stage(c & 1) + xci;
      for (int u = xu; u < xr_n; u += XSTEP)
        xh[u * XSB] = __float2bfloat16_rn(xf[u * XS]);
    } else if constexpr (SPLIT_ONCE) {  // to TF32 hi (in place) and lo
      float* xf = x_stage(c & 1) + xci;
      for (int u = xu; u < xr_n; u += XSTEP) {
        unsigned hi, lo;
        tf32_split(xf[u * XS], hi, lo);
        xf[u * XS] = __uint_as_float(hi);
        xf[u * XS + KC] = __uint_as_float(lo);
      }
    }
    __syncthreads();
    if (c + 1 < n_chunks) load((c + 1) * KC, (c + 1) & 1);
    cp_async_commit();
    const WT* ws = w_stage(c & 1);
    // this warp's frames: rows (wn NT8 + n) 8 + g of the window, + k d a tap
    const float* xs = x_stage(c & 1) + ((wn * NT8) * 8 + g) * XS;
    // BF16: ldmatrix.x4 rows, lane l: frame (wn NT8 + n + l / 16) 8 + l % 8,
    // channels 8 ((l / 8) % 2) ..: b0, b1 of n-tiles n and n + 1
    const __nv_bfloat16* xh =
        xb_stage(c & 1) +
        ((wn * NT8 + ((lane >> 4) & 1)) * 8 + (lane & 7)) * XSB +
        ((lane >> 3) & 1) * 8;

    // one tap at a time: unrolled over the taps, five of the six F32
    // instances spill 28-72 bytes, even at 255 registers (ptxas)
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const float* xk = xs + k * dil * XS;
      if constexpr (G::I8) {
        mma_tap_s8<MT, NT8>(acc, ws + k * TILE_CO * 32, x8_stage(c & 1),
                            wn * NT8 * 8 + k * dil, wm, lane);
      } else if constexpr (G::BF) {
        unsigned a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          a_frag_bf16(a[i], ws, k * TILE_CO + (wm * MT + i) * 16, lane);
#pragma unroll
        for (int n = 0; n < NT8; n += 2) {
          unsigned bq[4];
          ldmatrix_x4(bq, xh + (k * dil + n * 8) * XSB);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16_16816(acc[i][n], a[i], bq[0], bq[1]);
            mma_bf16_16816(acc[i][n + 1], a[i], bq[2], bq[3]);
          }
        }
      } else {
        unsigned ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          a_frag_3xtf32(ah[i], al[i], ws, k * TILE_CO + (wm * MT + i) * 16,
                        g, t);
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          // channels t and t + 4 of this lane's frame
          const float* xr = xk + n * 8 * XS;
          unsigned bh[2], bl[2];
          if constexpr (SPLIT_ONCE) {  // split as staged
            bh[0] = __float_as_uint(xr[t]);
            bh[1] = __float_as_uint(xr[t + 4]);
            bl[0] = __float_as_uint(xr[KC + t]);
            bl[1] = __float_as_uint(xr[KC + t + 4]);
          } else {
            tf32_split(xr[t], bh[0], bl[0]);
            tf32_split(xr[t + 4], bh[1], bl[1]);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma_3xtf32_1688(acc[i][n], ah[i], al[i], bh[0], bh[1], bl[0],
                            bl[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages

  // the tile in shared memory, [TILE_CO][OS] (I8: dequantised)
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = (wm * MT + i) * 16 + g + 8 * h;
      float fac = 0.0f;
      if constexpr (G::I8) fac = co0 + co < Cout ? q.sx * sw[co0 + co] : 0.0f;
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        const int m = (wn * NT8 + n) * 8 + 2 * t;
        *reinterpret_cast<float2*>(os + co * G::OS + m) =
            make_float2(dequant(acc[i][n][2 * h], fac),
                        dequant(acc[i][n][2 * h + 1], fac));
      }
    }
  __syncthreads();

  // whole rows out, in the epilogue's order: + bias, + r0, + r1, + r2,
  // x out_scale; four-element accesses (16 bytes f32, 8 bf16) where y's
  // rows are aligned to them
  const int cols = min(BN, T - t0);
  const bool vec = T % 4 == 0;
  constexpr int V = BN / 4;
  for (int idx = tid; idx < TILE_CO * V; idx += NT) {
    const int row = idx / V, col = (idx - row * V) * 4;
    const int co = co0 + row;
    if (co >= Cout || col >= cols) continue;
    const float bv = bias != nullptr ? bias[co] : 0.0f;
    const long long o = (b * Cout + co) * (long long)T + t0 + col;
    const float* src = os + row * G::OS + col;
    if (vec) {
      float4 v = *reinterpret_cast<const float4*>(src);
      auto add = [&](const S* r) {
        if (r == nullptr) return;
        const float4 q = load4_f32(r + o);
        v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
      };
      v.x += bv; v.y += bv; v.z += bv; v.w += bv;
      add(r0);
      add(r1);
      add(r2);
      v.x *= out_scale; v.y *= out_scale; v.z *= out_scale; v.w *= out_scale;
      store4_f32(y + o, v);
    } else {
      for (int j = 0; j < 4 && col + j < cols; ++j) {
        float v = src[j] + bv;
        if (r0 != nullptr) v += load_f32(r0 + o + j);
        if (r1 != nullptr) v += load_f32(r1 + o + j);
        if (r2 != nullptr) v += load_f32(r2 + o + j);
        store_f32(y + o + j, v * out_scale);
      }
    }
  }
}

// F32 and BF16
template <Dot D, int K, int WM, int MT, Store ST>
__global__ void __launch_bounds__(NT, mma_min_blocks(D, K, ST))
conv1d_mma_kernel(const StoreT<ST>* __restrict__ x,
                  const typename Gemm<D, WM, MT>::WT* __restrict__ wp,
                  const float* __restrict__ bias,
                  const StoreT<ST>* __restrict__ r0,
                  const StoreT<ST>* __restrict__ r1,
                  const StoreT<ST>* __restrict__ r2,
                  StoreT<ST>* __restrict__ y, int Cin, int Cout, int T,
                  int dil, float out_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  conv1d_gemm<D, K, WM, MT, ST>(smem, x, wp, bias, r0, r1, r2, y, Cin, Cout,
                                T, dil, out_scale);
}

// I8: the block's tile is its window; its scale from the pre-pass's
// partial maxima ``part`` (n_groups a window, conv1d_amax_kernel)
template <int K, int WM, int MT, Store ST>
__global__ void __launch_bounds__(NT, 2)
conv1d_s8_kernel(const StoreT<ST>* __restrict__ x,
                 const signed char* __restrict__ wp,
                 const float* __restrict__ sw,
                 const float* __restrict__ part, int n_groups,
                 const float* __restrict__ bias,
                 const StoreT<ST>* __restrict__ r0,
                 const StoreT<ST>* __restrict__ r1,
                 const StoreT<ST>* __restrict__ r2,
                 StoreT<ST>* __restrict__ y, int Cin, int Cout, int T,
                 int dil, float out_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  const Quant q = window_quant(
      part + ((long long)blockIdx.z * gridDim.x + blockIdx.x) * n_groups,
      n_groups, red);
  conv1d_gemm<Dot::I8, K, WM, MT, ST>(smem, x, wp, bias, r0, r1, r2, y, Cin,
                                      Cout, T, dil, out_scale, q, sw);
}

// The I8 pre-pass: part[b][w][g] = the largest |x| of channels [8 g, 8 g +
// 8) over window w's positions [w BN - pad, w BN + BN + pad) ∩ [0, T)
// (ops/quant.py's windows; zero where it holds none). A warp takes one
// group of 8 channels (128-byte loads along each row), a block 8 groups:
// grid (windows, ceil(Cin / 64), B). Reads x once, plus the windows' halos.
constexpr int AMAX_CH = 8;  // channels a partial maximum

template <Store ST>
__global__ void __launch_bounds__(NT)
conv1d_amax_kernel(const StoreT<ST>* __restrict__ x, float* __restrict__ part,
                   int Cin, int T, int pad) {
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.y * (NT / 32) + (threadIdx.x >> 5);
  const int n_groups = (Cin + AMAX_CH - 1) / AMAX_CH;
  if (grp >= n_groups) return;  // a whole warp
  const int c0 = grp * AMAX_CH, nc = min(AMAX_CH, Cin - c0);
  const int lo = max((int)blockIdx.x * BN - pad, 0);
  const int width = min((int)blockIdx.x * BN + BN + pad, T) - lo;
  const StoreT<ST>* xb = x + ((long long)blockIdx.z * Cin + c0) * T + lo;
  float m = 0.0f;
  for (int c = 0; c < nc; ++c)
    for (int g = lane; g < width; g += 32)
      m = fmaxf(m, fabsf(load_f32(xb + (long long)c * T + g)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0)
    part[((long long)blockIdx.z * gridDim.x + blockIdx.x) * n_groups + grp] =
        m;
}

template <Dot D, int K, int WM, int MT, Store ST>
int launch_mma(const void* xv, const void* w, const float* sw, float* part,
               const float* bias, const void* r0v, const void* r1v,
               const void* r2v, void* yv, int B, int Cin, int Cout, int T,
               int dil, float out_scale, cudaStream_t stream) {
  using G = Gemm<D, WM, MT>;
  using S = StoreT<ST>;
  const S *x = static_cast<const S*>(xv), *r0 = static_cast<const S*>(r0v),
          *r1 = static_cast<const S*>(r1v), *r2 = static_cast<const S*>(r2v);
  S* y = static_cast<S*>(yv);
  const int smem = G::smem(K, dil);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BN - 1) / BN, (Cout + G::TILE_CO - 1) / G::TILE_CO, B);
  const auto* wp = static_cast<const typename G::WT*>(w);
  if constexpr (D == Dot::I8) {
    auto kernel = conv1d_s8_kernel<K, WM, MT, ST>;  // with 128 static bytes
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    const int n_groups = (Cin + AMAX_CH - 1) / AMAX_CH;
    conv1d_amax_kernel<ST>
        <<<dim3(grid.x, (n_groups + NT / 32 - 1) / (NT / 32), B), NT, 0,
           stream>>>(x, part, Cin, T, dil * (K - 1) / 2);
    kernel<<<grid, NT, smem, stream>>>(x, wp, sw, part, n_groups, bias, r0,
                                       r1, r2, y, Cin, Cout, T, dil,
                                       out_scale);
  } else {
    auto kernel = conv1d_mma_kernel<D, K, WM, MT, ST>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (attr != cudaSuccess) return (int)attr;
    kernel<<<grid, NT, smem, stream>>>(x, wp, bias, r0, r1, r2, y, Cin, Cout,
                                       T, dil, out_scale);
  }
  return (int)cudaGetLastError();
}

// TILE_CO = 48 where 48 divides Cout and 64 does not, else 64
inline bool narrow_tile(int Cout) { return Cout % 48 == 0 && Cout % 64 != 0; }

template <Dot D, int K, Store ST>
int launch_mma_k(const void* x, const void* w, const float* sw, float* part,
                 const float* bias, const void* r0, const void* r1,
                 const void* r2, void* y, int B, int Cin, int Cout, int T,
                 int dil, float out_scale, cudaStream_t s) {
  if (narrow_tile(Cout))
    return launch_mma<D, K, 1, 3, ST>(x, w, sw, part, bias, r0, r1, r2, y, B,
                                      Cin, Cout, T, dil, out_scale, s);
  return launch_mma<D, K, 2, 2, ST>(x, w, sw, part, bias, r0, r1, r2, y, B,
                                    Cin, Cout, T, dil, out_scale, s);
}

// Shared memory one block of the GEMM route takes (mirrored by
// flowhigh_tpu_torch/ops/conv.py:conv_smem_bytes)
template <Dot D>
int mma_smem(int K, int Cout, int dil) {
  return narrow_tile(Cout) ? Gemm<D, 1, 3>::smem(K, dil)
                           : Gemm<D, 2, 2>::smem(K, dil);
}

int mma_smem(int K, int Cout, int dil, int dot) {
  return dot == (int)Dot::I8    ? mma_smem<Dot::I8>(K, Cout, dil)
         : dot == (int)Dot::BF16 ? mma_smem<Dot::BF16>(K, Cout, dil)
                                 : mma_smem<Dot::F32>(K, Cout, dil);
}

// --- 2. the narrow route -----------------------------------------------------------

constexpr int NNT = 128;  // threads a block
constexpr int NB = 512;   // outputs a block: 4 a thread
constexpr int NCC = 8;    // input channels a stage

// window floats a channel: NB outputs plus the taps' reach, padded to a
// multiple of 4 on each side (16-byte copies from 16-byte-aligned sources)
__host__ __device__ inline int narrow_halo(int K, int dil) {
  return (dil * (K - 1) / 2 + 3) / 4 * 4;
}
__host__ __device__ inline int narrow_width(int K, int dil) {
  return NB + 2 * narrow_halo(K, dil);
}
inline int narrow_smem(int K, int dil) {
  return 2 * NCC * narrow_width(K, dil) * 4;
}

// vec: x's rows are aligned to four elements (T % 4 == 0 and x 16-byte
// aligned for f32, 8-byte for bf16)
template <Dot D, Store ST>
__global__ void __launch_bounds__(NNT)
conv1d_narrow_kernel(const StoreT<ST>* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const StoreT<ST>* __restrict__ r0,
                     const StoreT<ST>* __restrict__ r1,
                     const StoreT<ST>* __restrict__ r2,
                     StoreT<ST>* __restrict__ y, int Cin, int Cout, int T,
                     int K, int dil, float out_scale, int vec) {
  using S = StoreT<ST>;
  extern __shared__ __align__(16) float xsm[];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * NB;
  const int co = blockIdx.y;
  const long long b = blockIdx.z;
  const int pad = dil * (K - 1) / 2;
  const int halo = narrow_halo(K, dil);
  const int W = narrow_width(K, dil);  // window positions t0 - halo ..
  const S* xb = x + b * (long long)Cin * T;
  const float* wr = w + (long long)co * Cin * K;
  const int n_chunks = (Cin + NCC - 1) / NCC;

  // stage s <- channels c0 .. c0 + NCC of the window, zero outside [0, T)
  // and beyond Cin (bf16 maps: through registers, widened to f32); BF16
  // dots on f32 maps round the values this thread staged once they have
  // landed (round_own below)
  auto load = [&](int c0, int s) {
    float* dst = xsm + s * NCC * W;
    if (vec) {
      const int w4 = W / 4;
      for (int e = tid; e < NCC * w4; e += NNT) {
        const int ci = e / w4, p = (e - ci * w4) * 4;
        const int gt = t0 - halo + p;
        const bool ok = c0 + ci < Cin && gt >= 0 && gt < T;
        const S* src = ok ? xb + (long long)(c0 + ci) * T + gt : xb;
        if constexpr (ST == Store::BF16)  // four values into the slot's half
          cp_async8_zfill(dst + ci * W + p, src, ok);
        else
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                           "r"(smem_addr(dst + ci * W + p)),
                       "l"(src), "r"(ok ? 16 : 0));
      }
    } else {
      for (int e = tid; e < NCC * W; e += NNT) {
        const int ci = e / W, p = e - ci * W;
        const int gt = t0 - halo + p;
        const bool ok = c0 + ci < Cin && gt >= 0 && gt < T;
        if constexpr (ST == Store::BF16)
          cp_async_bf16_word(dst + ci * W + p,
                             ok ? xb + (long long)(c0 + ci) * T + gt : xb,
                             ok);
        else
          cp_async4_zfill(dst + ci * W + p,
                          ok ? xb + (long long)(c0 + ci) * T + gt : xb, ok);
      }
    }
  };
  auto widen_own = [&](int c0, int s) {  // bf16 maps: load's elements
    if constexpr (ST == Store::BF16) {
      float* dst = xsm + s * NCC * W;
      if (vec) {  // four values in the low 8 bytes of each 16-byte slot
        const int w4 = W / 4;
        for (int e = tid; e < NCC * w4; e += NNT) {
          float4* slot = reinterpret_cast<float4*>(dst) + e;
          *slot = unpack_bf16x4(*reinterpret_cast<const uint2*>(slot));
        }
      } else {
        for (int e = tid; e < NCC * W; e += NNT) {
          const int ci = e / W, p = e - ci * W;
          const int gt = t0 - halo + p;
          if (c0 + ci < Cin && gt >= 0 && gt < T)
            dst[e] = bf16_half_to_f32(
                dst[e], bf16_parity(xb, (unsigned)(c0 + ci) * (unsigned)T +
                                            (unsigned)gt));
        }
      }
    }
  };
  auto round_own = [&](int s) {  // the same elements load(., s) gave tid
    float* dst = xsm + s * NCC * W;
    const int step = vec ? 4 : 1;
    for (int e = tid * step; e < NCC * W; e += NNT * step)
      for (int j = 0; j < step; ++j) dst[e + j] = round_bf16(dst[e + j]);
  };

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();
    if constexpr (ST == Store::BF16) widen_own(c * NCC, c & 1);
    if constexpr (D == Dot::BF16 && ST == Store::F32) round_own(c & 1);
    __syncthreads();
    if (c + 1 < n_chunks) load((c + 1) * NCC, (c + 1) & 1);
    cp_async_commit();
    const float* xs = xsm + (c & 1) * NCC * W + halo - pad + tid;
    const int nc = min(NCC, Cin - c * NCC);
    for (int ci = 0; ci < nc; ++ci) {
      const float* wk = wr + (long long)(c * NCC + ci) * K;
      const float* xc = xs + ci * W;
      for (int k = 0; k < K; ++k) {
        const float wv = __ldg(wk + k);
        const float* xk = xc + k * dil;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = fmaf(wv, xk[j * (NB / 4)], acc[j]);
      }
    }
  }

  const float bv = bias != nullptr ? bias[co] : 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = t0 + tid + j * (NB / 4);
    if (t >= T) continue;
    const long long o = (b * Cout + co) * (long long)T + t;
    float v = acc[j] + bv;
    if (r0 != nullptr) v += load_f32(r0 + o);
    if (r1 != nullptr) v += load_f32(r1 + o);
    if (r2 != nullptr) v += load_f32(r2 + o);
    store_f32(y + o, v * out_scale);
  }
}

template <Dot D, Store ST>
int launch_narrow(const void* xv, const float* w, const float* bias,
                  const void* r0, const void* r1, const void* r2, void* y,
                  int B, int Cin, int Cout, int T, int K, int dil,
                  float out_scale, cudaStream_t s) {
  using S = StoreT<ST>;
  const S* x = static_cast<const S*>(xv);
  auto kernel = conv1d_narrow_kernel<D, ST>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const int smem = narrow_smem(K, dil);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int vec =
      T % 4 == 0 && reinterpret_cast<size_t>(x) % (4 * sizeof(S)) == 0;
  dim3 grid((T + NB - 1) / NB, Cout, B);
  kernel<<<grid, NNT, smem, s>>>(
      x, w, bias, static_cast<const S*>(r0), static_cast<const S*>(r1),
      static_cast<const S*>(r2), static_cast<S*>(y), Cin, Cout, T, K, dil,
      out_scale, vec);
  return (int)cudaGetLastError();
}

// --- dispatch ----------------------------------------------------------------------

int supported(int K, int Cout, int dil, int dot) {
  const bool gemm = K == 3 || K == 7 || K == 11;
  if (K <= 0 || K % 2 == 0 || dil <= 0) return 0;
  if (dot != (int)Dot::F32 && dot != (int)Dot::BF16 && dot != (int)Dot::I8)
    return 0;
  if (Cout < 16)  // int8 has no narrow route: conv_post stays float32
    return dot != (int)Dot::I8 && narrow_smem(K, dil) <= SMEM_MAX;
  return gemm && mma_smem(K, Cout, dil, dot) <= SMEM_MAX;
}

template <Dot D, Store ST = Store::F32>
int conv1d_same(const void* x, const void* w, const float* sw, float* part,
                const float* bias, const void* r0, const void* r1,
                const void* r2, void* y, int B, int Cin, int Cout, int T,
                int K, int dil, float out_scale, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || T <= 0 || B > 65535 ||
      Cout > 65535 || !supported(K, Cout, dil, (int)D) ||
      (D == Dot::I8 && (sw == nullptr || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (D != Dot::I8) {
    if (Cout < 16)
      return launch_narrow<D, ST>(x, static_cast<const float*>(w), bias, r0,
                                  r1, r2, y, B, Cin, Cout, T, K, dil,
                                  out_scale, s);
  }
  switch (K) {
    case 3:
      return launch_mma_k<D, 3, ST>(x, w, sw, part, bias, r0, r1, r2, y, B,
                                    Cin, Cout, T, dil, out_scale, s);
    case 7:
      return launch_mma_k<D, 7, ST>(x, w, sw, part, bias, r0, r1, r2, y, B,
                                    Cin, Cout, T, dil, out_scale, s);
    default:
      return launch_mma_k<D, 11, ST>(x, w, sw, part, bias, r0, r1, r2, y, B,
                                     Cin, Cout, T, dil, out_scale, s);
  }
}

}  // namespace

// 1 when (K, Cout, dilation) has an instance of dot dtype ``dot`` (0 f32,
// 1 bf16, 2 int8): f32 and bf16 any odd K for Cout < 16 (the narrow route);
// every dtype K in {3, 7, 11} for Cout >= 16 (the GEMM route); and the
// dilation's window fits shared memory.
extern "C" int conv1d_same_supported(int K, int Cout, int dil, int dot) {
  return supported(K, Cout, dil, dot);
}

// The padding of the GEMM route's prepared weights: 0 -> Cin_p's multiple
// (f32, bf16), 1 -> Cout_p's, 2 -> Cin_p's multiple for int8.
extern "C" int conv1d_same_weight_align(int which) {
  return which == 0 ? CIN_ALIGN : which == 1 ? COUT_ALIGN : CIN_ALIGN_I8;
}

// Shared memory one block of the GEMM route takes for instance ``dot``
// (0 f32, 1 bf16, 2 int8) at (K, Cout, dilation)
extern "C" int conv1d_same_smem_bytes(int K, int Cout, int dil, int dot) {
  return mma_smem(K, Cout, dil, dot);
}

// The launch entry points on float32 maps build here; those on bf16 maps
// build from conv1d_same_bf16io.cu, which defines FHT_BF16_MAPS and includes
// this file, so that the two halves compile in parallel.
#ifndef FHT_BF16_MAPS
// Each returns cudaGetLastError() after the launch (or the error that kept
// it from launching). bias and r0..r2 may be null. w: for Cout >= 16 the
// prepared weights [K][Cout_p][Cin_p] (ops/conv.py:conv_weights), float32
// for conv1d_same_f32, bfloat16 for conv1d_same_bf16 and int8 for
// conv1d_same_int8; for Cout < 16 the weights [Cout][Cin][K] as float32
// (rounded to bf16 values for bf16).
extern "C" int conv1d_same_f32(const float* x, const void* w,
                               const float* bias, const float* r0,
                               const float* r1, const float* r2, float* y,
                               int B, int Cin, int Cout, int T, int K, int dil,
                               float out_scale, void* stream) {
  return conv1d_same<Dot::F32>(x, w, nullptr, nullptr, bias, r0, r1, r2, y,
                               B, Cin, Cout, T, K, dil, out_scale, stream);
}

extern "C" int conv1d_same_bf16(const float* x, const void* w,
                                const float* bias, const float* r0,
                                const float* r1, const float* r2, float* y,
                                int B, int Cin, int Cout, int T, int K,
                                int dil, float out_scale, void* stream) {
  return conv1d_same<Dot::BF16>(x, w, nullptr, nullptr, bias, r0, r1, r2, y,
                                B, Cin, Cout, T, K, dil, out_scale, stream);
}

// sw: the [Cout] weight scales (ops/quant.py:int8_weights); part: scratch
// of B x ceil(T / 256) x ceil(Cin / 8) floats for the pre-pass's partial
// maxima. Launches the pre-pass, then the GEMM.
extern "C" int conv1d_same_int8(const float* x, const void* w,
                                const float* sw, float* part,
                                const float* bias, const float* r0,
                                const float* r1, const float* r2, float* y,
                                int B, int Cin, int Cout, int T, int K,
                                int dil, float out_scale, void* stream) {
  return conv1d_same<Dot::I8>(x, w, sw, part, bias, r0, r1, r2, y, B, Cin,
                              Cout, T, K, dil, out_scale, stream);
}

#else  // FHT_BF16_MAPS
// The same three instances on bf16 maps: x, r0..r2 and y __nv_bfloat16
// (the rest as above).
extern "C" int conv1d_same_f32_bf16io(const void* x, const void* w,
                                      const float* bias, const void* r0,
                                      const void* r1, const void* r2, void* y,
                                      int B, int Cin, int Cout, int T, int K,
                                      int dil, float out_scale, void* stream) {
  return conv1d_same<Dot::F32, Store::BF16>(x, w, nullptr, nullptr, bias, r0,
                                            r1, r2, y, B, Cin, Cout, T, K, dil,
                                            out_scale, stream);
}

extern "C" int conv1d_same_bf16_bf16io(const void* x, const void* w,
                                       const float* bias, const void* r0,
                                       const void* r1, const void* r2,
                                       void* y, int B, int Cin, int Cout,
                                       int T, int K, int dil, float out_scale,
                                       void* stream) {
  return conv1d_same<Dot::BF16, Store::BF16>(x, w, nullptr, nullptr, bias, r0,
                                             r1, r2, y, B, Cin, Cout, T, K,
                                             dil, out_scale, stream);
}

extern "C" int conv1d_same_int8_bf16io(const void* x, const void* w,
                                       const float* sw, float* part,
                                       const float* bias, const void* r0,
                                       const void* r1, const void* r2,
                                       void* y, int B, int Cin, int Cout,
                                       int T, int K, int dil, float out_scale,
                                       void* stream) {
  return conv1d_same<Dot::I8, Store::BF16>(x, w, sw, part, bias, r0, r1, r2,
                                           y, B, Cin, Cout, T, K, dil,
                                           out_scale, stream);
}
#endif  // FHT_BF16_MAPS
