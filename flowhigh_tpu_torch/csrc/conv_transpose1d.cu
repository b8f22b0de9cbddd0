// Kernel C: ConvTranspose1d with stride U, padding P = (K - U) / 2 and
// exactly U*T outputs, + bias, as a polyphase convolution:
//   y[co, U*m + r] = bias[co]
//       + sum_ci sum_{j : (r + P - j) % U == 0} w[ci, co, j] x[ci, m + (r + P - j) / U]
// (x zero outside [0, T)). Output phase r only meets the taps j congruent
// to r + P mod U, about K/U of them: the zero-stuffed input is never formed.
//
// Replaces the Pallas kernel
// flowhigh_tpu/ops/packed.py:pallas_packed_conv_transpose1d (:432; plan
// _convt_plan, core _pallas_conv_rows, pallas_call :361) at p_in = p_out = 1:
// BigVGAN's five stage-boundary upsamplers, (U, K) = (5,11), (4,8), (4,8),
// (3,7), (2,4), and (8,16), the first upsampler of the CLI's --tiny vocoder
// (whose odd pairs (5,10), (3,6) run the library conv, models/bigvgan.py).
//
// Layout: x [B, Cin, T] and y [B, Cout, U*T], contiguous, float32 or, on
// bf16 feature maps (Store::BF16, the vocoder's compute dtype bf16), both
// __nv_bfloat16 (see the end of this note). The
// weights come prepared on the host (ops/conv.py:convt_weights, cached per
// weight tensor): [K][Cout_p][Cin_p], Cout_p = Cout rounded up to TILE_CO,
// Cin_p = Cin rounded up to CIN_ALIGN, zero-padded; float32 for F32,
// bf16 (rounded to nearest even) for BF16.
//
// The phase plan (Plan below): tap j belongs to phase r(j) = (j - P) mod U
// and reads x[m + q(j)], q(j) = (r(j) + P - j) / U in [QLO, QHI]:
//   (5,11) P 3, q in [-2, 1]   (4,8) P 2, q in [-2, 1]   (3,7) P 2, q in [-2, 1]
//   (2,4)  P 1, q in [-1, 1]   (8,16) P 4, q in [-2, 1]
// Each phase is a GEMM: y_r[co, m] = sum over its taps j and over ci of
// W_j[co, ci] x[ci, m + q(j)]: M = Cout, N = time, depth Cin x (taps of r).
//
// Bound (a 10 s clip, 102.6 GFLOP over 562 MB, 183 flop/byte): BF16 is bound
// by bytes (its products fit the bf16 tensor cores 5x over); F32, as 3xTF32
// (three TF32 products per f32 product), by operations. Design:
// - implicit GEMM on the tensor cores: mma.sync m16n8k16 bf16 -> f32 for
//   BF16 (a bf16 x bf16 product is exact, so this is still the JAX kernel's
//   bf16 dot with f32 accumulation; only the order of the sums changes);
//   3xTF32 on m16n8k8 for F32 (mma_sm90.cuh: hi + lo splits, the lo x lo
//   term dropped, f32-grade: about 2^-22 of each product; each tap's three
//   products are summed apart and added to the accumulator in f32 with
//   round to nearest, since the tensor cores' own sums round toward zero
//   and drifted by 1.2e-4 over Cin = 1536). BF16 sums in the tensor cores
//   (2.2e-5 at Cin = 1536, inside the instance's 1e-4 bound);
// - a block owns TILE_CO = 64 output channels x BN input frames and all U
//   phases of them (BN = 32 NT: 64 frames for U = 4, 5, so stage 1's
//   1,000 frames give 16 x 12 = 192 blocks); 8 warps as 2 (channels) x 4
//   (time), a warp 32 channels x 8 NT frames x U phases of accumulators;
// - per chunk of KC input channels the block stages, double-buffered with
//   cp.async, the x window of its tile plus the tap halo, transposed to
//   [frame][ci] (4-byte copies: a tap shift q is a row offset, and every
//   fragment load stays aligned), and the chunk's weights [K][64][KC]
//   (16-byte copies); the next chunk loads while the current one multiplies;
// - B fragments (x) are loaded once per shift q and serve every tap of that
//   shift in every phase; A fragments (weights) once per tap. F32 splits
//   both into TF32 hi and lo as it loads them, so shared memory holds f32
//   once (a host-side hi/lo pair would double the weight stage and halve
//   the blocks per SM); BF16 rounds x to bf16 as it loads it (ldmatrix for
//   the weights);
// - the output goes through shared memory: the accumulators of all U phases
//   interleave there into [64][U*BN] (y's own order, y[co, U*m + r]), and
//   the block stores whole rows with 16-byte stores, bias added.
// Row strides are padded so that fragment loads are free of bank conflicts.
//
// dot_dtype (dot_dtype.cuh): F32 and BF16. The JAX package keeps the
// upsamplers in f32 under int8 (bigvgan.py:406-414), so there is no I8
// instance.
//
// Store (dot_dtype.cuh), a second template parameter: with BigVGAN's
// compute dtype bf16 the JAX package feeds each upsampler bf16 x and stores
// its output in bf16 (bigvgan.py:459-463; packed.py:363, out_shape in x's
// dtype), at either dot dtype. Store::BF16 reads x as bf16: each value is
// staged by cp.async as the 4-byte word that holds it, into its f32 slot of
// the x stage (two bf16 of one channel share a word, and the stage puts
// channels side by side), and the thread that staged it widens it in place
// once it has landed (mma_sm90.cuh: cp_async_bf16_word, bf16_half_to_f32),
// before the barrier that hands the chunk to the warps; odd T and the
// shift halo stage zeros as before. Everything after is the Store::F32
// instance on the widened values: the same dots, the bias added in f32 in
// the epilogue, and y stored once, rounded to nearest even. The weights
// and the bias stay float32 (or the bf16 layout of BF16), as on f32 maps.
// The entry points on bf16 maps build from conv_transpose1d_bf16io.cu,
// which defines FHT_BF16_MAPS and includes this file, so that the two
// halves compile in parallel.

#include "dot_dtype.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: 2 along channels x 4 along time
constexpr int WM = 2, WN = 4;
constexpr int MT = 2;                  // m16 tiles a warp (32 channels)
constexpr int TILE_CO = WM * MT * 16;  // 64: Cout_p is a multiple of it
constexpr int CIN_ALIGN = 16;          // Cin_p is a multiple of it
constexpr int STAGES = 3;              // chunks in flight in shared memory

template <int U, int K>
struct Plan {
  static constexpr int P = (K - U) / 2;
  static constexpr int QLO = -((K - 1 - P + U - 1) / U);  // floor((P-K+1)/U)
  static constexpr int QHI = (U - 1 + P) / U;
  __host__ __device__ static constexpr int r_of(int j) {
    return ((j - P) % U + U) % U;
  }
  __host__ __device__ static constexpr int q_of(int j) {
    return (r_of(j) + P - j) / U;
  }
};

template <Dot D, int U, int K>
struct Cfg {
  static constexpr bool BF = D == Dot::BF16;
  using WT = typename std::conditional<BF, __nv_bfloat16, float>::type;
  static constexpr int KC = BF ? 16 : 8;  // input channels a chunk: 32 bytes
  static constexpr int EPS = 16 / (int)sizeof(WT);  // elements a 16-byte copy
  // weights [K][64][KC], unpadded, the two 16-byte halves of row w swapped
  // when (w / 4) is odd; x [XR][XS] f32, rows padded
  static constexpr int XS = BF ? 24 : 12;
  static constexpr int NT = U == 2 ? 4 : U == 3 ? 3 : U == 8 ? 1 : 2;
  static constexpr int BN = WN * NT * 8;  // input frames a block
  static constexpr int XR =
      (BN + Plan<U, K>::QHI - Plan<U, K>::QLO + 7) / 8 * 8;  // window rows
  static constexpr int W_BYTES = K * TILE_CO * KC * (int)sizeof(WT);
  static constexpr int X_BYTES = XR * XS * 4;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int OS = U * BN + 4;  // output tile row stride (floats)
  static constexpr int O_BYTES = TILE_CO * OS * 4;
  static constexpr int SMEM =
      STAGES * STAGE > O_BYTES ? STAGES * STAGE : O_BYTES;
  static_assert(KC * sizeof(WT) == 32, "a weight row is two 16-byte copies");
  static_assert(W_BYTES % 16 == 0 && X_BYTES % 16 == 0, "stage alignment");
  static_assert(32 % KC == 0, "a thread stages one input channel of x");
};

template <Dot D, Store ST, int U, int K>
__global__ void __launch_bounds__(THREADS, 2)
conv_transpose1d_kernel(const StoreT<ST>* __restrict__ x,
                        const typename Cfg<D, U, K>::WT* __restrict__ wp,
                        const float* __restrict__ bias,
                        StoreT<ST>* __restrict__ y, int Cin, int Cout, int T) {
  using PL = Plan<U, K>;
  using C = Cfg<D, U, K>;
  using WT = typename C::WT;
  using S = StoreT<ST>;
  // bf16 maps: x as words, widened in place (see the top of this file)
  constexpr bool WIDEN = ST == Store::BF16;
  constexpr int KC = C::KC, EPS = C::EPS, XS = C::XS, NT = C::NT,
                BN = C::BN;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * TILE_CO;
  const long long b = blockIdx.z;
  const int cin_p = (Cin + CIN_ALIGN - 1) / CIN_ALIGN * CIN_ALIGN;
  const int cout_p = (Cout + TILE_CO - 1) / TILE_CO * TILE_CO;
  const S* xb = x + b * (long long)Cin * T;

  auto w_stage = [&](int s) {
    return reinterpret_cast<WT*>(smem + s * C::STAGE);
  };
  auto x_stage = [&](int s) {
    return reinterpret_cast<float*>(smem + s * C::STAGE + C::W_BYTES);
  };

  // What a thread stages of every chunk, fixed for the kernel's life:
  // weight rows wrow + 128 i (row = 64 j + co), 16-byte half wseg, whose
  // source moves by two taps a step; and x's input channel xci at window
  // rows xu + i * (256 / KC), lane = 8 (ci % 4) + u % 8 (32-byte global
  // segments; no bank conflicts at XS = 12)
  constexpr int WROWS = THREADS / 2, NW = (K * TILE_CO + WROWS - 1) / WROWS;
  const int wseg = tid & 1, wrow = tid >> 1;
  WT* const wdst0 = w_stage(0) + w_row_offset(wrow, wseg, EPS);
  const WT* const wsrc0 =
      wp + ((long long)(wrow / TILE_CO) * cout_p + co0 + wrow % TILE_CO) *
               cin_p + wseg * EPS;
  const long long wstep = (long long)(WROWS / TILE_CO) * cout_p * cin_p;
  constexpr int XSTEP = THREADS / KC, NX = (C::XR * KC + THREADS - 1) / THREADS;
  const int xci = (tid >> 3) % KC;
  const int xu = ((tid >> 3) / KC) * 8 + (tid & 7);
  const int xg = m0 + PL::QLO + xu;

  auto load = [&](int c0, int s) {
    WT* wd = wdst0 + s * (C::STAGE / (int)sizeof(WT));
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if ((K * TILE_CO) % WROWS == 0 || wrow + i * WROWS < K * TILE_CO)
        cp_async16(wd + i * WROWS * KC, wsrc0 + i * wstep + c0);
    float* xd = x_stage(s) + xu * XS + xci;
    const bool cvalid = c0 + xci < Cin;
    const S* xs = xb + (cvalid ? (long long)(c0 + xci) * T : 0);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if ((C::XR * KC) % THREADS != 0 && xu + i * XSTEP >= C::XR) break;
      const int gt = xg + i * XSTEP;
      const bool valid = cvalid && (unsigned)gt < (unsigned)T;
      if constexpr (WIDEN)
        cp_async_bf16_word(xd + i * XSTEP * XS, valid ? xs + gt : xb, valid);
      else
        cp_async4_zfill(xd + i * XSTEP * XS, valid ? xs + gt : xb, valid);
    }
  };
  // bf16 maps: the words this thread staged for chunk c0 into stage s,
  // widened in place once they have landed (the same slots as load's; the
  // zero-filled ones stay 0)
  auto widen_own = [&](int c0, int s) {
    if constexpr (WIDEN) {
      if (c0 + xci >= Cin) return;
      float* xd = x_stage(s) + xu * XS + xci;
      const unsigned row = (unsigned)(c0 + xci) * (unsigned)T;
#pragma unroll 1
      for (int i = 0; i < NX; ++i) {
        if ((C::XR * KC) % THREADS != 0 && xu + i * XSTEP >= C::XR) break;
        const int gt = xg + i * XSTEP;
        if ((unsigned)gt < (unsigned)T)
          xd[i * XSTEP * XS] = bf16_half_to_f32(
              xd[i * XSTEP * XS], bf16_parity(xb, row + (unsigned)gt));
      }
    }
  };

  float acc[U][MT][NT][4];
#pragma unroll
  for (int r = 0; r < U; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][i][n][e] = 0.0f;

  // a ring of STAGES chunks, one barrier a chunk: the barrier at chunk c
  // also ends every warp's reads of chunk c - 1, whose stage the load of
  // chunk c + STAGES - 1 then refills (and, on bf16 maps, publishes every
  // thread's widening of chunk c)
  const int n_chunks = cin_p / KC;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) load(c * KC, c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    widen_own(c * KC, c % STAGES);
    __syncthreads();
    if (c + STAGES - 1 < n_chunks)
      load((c + STAGES - 1) * KC, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    const WT* ws = w_stage(c % STAGES);
    const float* xs = x_stage(c % STAGES);

#pragma unroll
    for (int q = PL::QLO; q <= PL::QHI; ++q) {
      // B fragments of shift q: frames wn*NT*8 + 8n + g (+ q - QLO)
      unsigned bh[NT][2], bl[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* xr = xs + ((wn * NT + n) * 8 + g + q - PL::QLO) * XS;
        if constexpr (C::BF) {
          const float2 v0 = *reinterpret_cast<const float2*>(xr + 2 * t);
          const float2 v1 = *reinterpret_cast<const float2*>(xr + 2 * t + 8);
          bh[n][0] = pack_bf16x2(v0.x, v0.y);
          bh[n][1] = pack_bf16x2(v1.x, v1.y);
        } else {
          tf32_split(xr[t], bh[n][0], bl[n][0]);
          tf32_split(xr[t + 4], bh[n][1], bl[n][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (PL::q_of(j) != q) continue;  // resolved at compile time
        const int r = PL::r_of(j);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int row0 = j * TILE_CO + (wm * MT + i) * 16;
          if constexpr (C::BF) {
            unsigned a[4];
            a_frag_bf16(a, ws, row0, lane);
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma_bf16_16816(acc[r][i][n], a, bh[n][0], bh[n][1]);
          } else {
            unsigned ah[4], al[4];
            a_frag_3xtf32(ah, al, ws, row0, g, t);
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma_3xtf32_1688(acc[r][i][n], ah, al, bh[n][0], bh[n][1],
                              bl[n][0], bl[n][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages

  // the U phases interleave in shared memory as y's own order: [64][U*BN]
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < U; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = (wm * MT + i) * 16 + g + 8 * (e >> 1);
          const int m = (wn * NT + n) * 8 + 2 * t + (e & 1);
          os[co * C::OS + U * m + r] = acc[r][i][n][e];
        }
  __syncthreads();

  // whole rows out, bias added: four outputs a store (16 bytes f32, 8 bf16)
  // where y's rows are so aligned (U*T % 4 == 0; U*m0 is a multiple of 4),
  // else one; on bf16 maps each output rounds once, at its store
  const long long t_out = (long long)U * T;
  const int cols = (int)min((long long)U * BN, t_out - (long long)U * m0);
  if (t_out % 4 == 0) {
    constexpr int V = U * BN / 4;
    for (int idx = tid; idx < TILE_CO * V; idx += THREADS) {
      const int row = idx / V, col = (idx - row * V) * 4;
      const int co = co0 + row;
      if (co >= Cout || col >= cols) continue;
      const float bv = bias != nullptr ? bias[co] : 0.0f;
      float4 v = *reinterpret_cast<const float4*>(os + row * C::OS + col);
      v.x += bv;
      v.y += bv;
      v.z += bv;
      v.w += bv;
      store4_f32(y + (b * Cout + co) * t_out + (long long)U * m0 + col, v);
    }
  } else {
    constexpr int V = U * BN;
    for (int idx = tid; idx < TILE_CO * V; idx += THREADS) {
      const int row = idx / V, col = idx - row * V;
      const int co = co0 + row;
      if (co >= Cout || col >= cols) continue;
      const float bv = bias != nullptr ? bias[co] : 0.0f;
      store_f32(y + (b * Cout + co) * t_out + (long long)U * m0 + col,
                os[row * C::OS + col] + bv);
    }
  }
}

template <Dot D, Store ST, int U, int K>
int launch(const void* x, const void* w, const float* bias, void* y, int B,
           int Cin, int Cout, int T, cudaStream_t stream) {
  using C = Cfg<D, U, K>;
  using S = StoreT<ST>;
  auto kernel = conv_transpose1d_kernel<D, ST, U, K>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + C::BN - 1) / C::BN, (Cout + TILE_CO - 1) / TILE_CO, B);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const S*>(x), static_cast<const typename C::WT*>(w), bias,
      static_cast<S*>(y), Cin, Cout, T);
  return (int)cudaGetLastError();
}

template <Dot D, Store ST = Store::F32>
int conv_transpose1d(const void* x, const void* w, const float* bias,
                     void* y, int B, int Cin, int Cout, int T, int stride,
                     int K, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || T <= 0 || B > 65535 ||
      (Cout + TILE_CO - 1) / TILE_CO > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stride == 5 && K == 11)
    return launch<D, ST, 5, 11>(x, w, bias, y, B, Cin, Cout, T, s);
  if (stride == 4 && K == 8)
    return launch<D, ST, 4, 8>(x, w, bias, y, B, Cin, Cout, T, s);
  if (stride == 3 && K == 7)
    return launch<D, ST, 3, 7>(x, w, bias, y, B, Cin, Cout, T, s);
  if (stride == 2 && K == 4)
    return launch<D, ST, 2, 4>(x, w, bias, y, B, Cin, Cout, T, s);
  if (stride == 8 && K == 16)
    return launch<D, ST, 8, 16>(x, w, bias, y, B, Cin, Cout, T, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#ifndef FHT_BF16_MAPS
// The (stride, K) pairs of BigVGAN's upsamplers and (8, 16); others return
// cudaErrorInvalidValue. w: the f32 weights as [K][Cout_p][Cin_p] (see the
// note above). Returns cudaGetLastError() after the launch.
extern "C" int conv_transpose1d_f32(const float* x, const void* w,
                                    const float* bias, float* y, int B,
                                    int Cin, int Cout, int T, int stride,
                                    int K, void* stream) {
  return conv_transpose1d<Dot::F32>(x, w, bias, y, B, Cin, Cout, T, stride,
                                    K, stream);
}

// w: the weights rounded to bf16, as [K][Cout_p][Cin_p] bf16
extern "C" int conv_transpose1d_bf16(const float* x, const void* w,
                                     const float* bias, float* y, int B,
                                     int Cin, int Cout, int T, int stride,
                                     int K, void* stream) {
  return conv_transpose1d<Dot::BF16>(x, w, bias, y, B, Cin, Cout, T, stride,
                                     K, stream);
}

#else  // FHT_BF16_MAPS
// The same two instances on bf16 maps: x and y __nv_bfloat16 (the rest as
// above).
extern "C" int conv_transpose1d_f32_bf16io(const void* x, const void* w,
                                           const float* bias, void* y, int B,
                                           int Cin, int Cout, int T,
                                           int stride, int K, void* stream) {
  return conv_transpose1d<Dot::F32, Store::BF16>(x, w, bias, y, B, Cin, Cout,
                                                 T, stride, K, stream);
}

extern "C" int conv_transpose1d_bf16_bf16io(const void* x, const void* w,
                                            const float* bias, void* y, int B,
                                            int Cin, int Cout, int T,
                                            int stride, int K, void* stream) {
  return conv_transpose1d<Dot::BF16, Store::BF16>(x, w, bias, y, B, Cin,
                                                  Cout, T, stride, K, stream);
}
#endif  // FHT_BF16_MAPS

// 1 when (stride, K) has a compiled instance (float32 and bfloat16).
extern "C" int conv_transpose1d_supported(int stride, int K) {
  return (stride == 5 && K == 11) || (stride == 4 && K == 8) ||
         (stride == 3 && K == 7) || (stride == 2 && K == 4) ||
         (stride == 8 && K == 16);
}

// The padding of the prepared weights: 0 -> Cin_p's multiple, 1 -> Cout_p's.
extern "C" int conv_transpose1d_weight_align(int which) {
  return which == 0 ? CIN_ALIGN : TILE_CO;
}
