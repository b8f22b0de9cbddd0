// Kernel B: dilated "same" 1-D convolution with a fused epilogue,
//   y = out_scale * (bias + sum_{ci,k} w[co,ci,k] x[ci, t + k*d - pad]
//                    + r0 + r1 + r2),         pad = d*(K-1)/2, zero padding.
//
// Replaces the Pallas kernel flowhigh_tpu/ops/packed.py:pallas_packed_conv1d
// (core _pallas_conv_rows, body _make_conv_kernel) at p = 1: the BigVGAN
// resblock convs (k in {3,7,11}, d in {1,3,5}) with up to three residuals
// and the folded MRF average (out_scale = 1/3), and conv_post (Cout = 1).
//
// Layout: x [B, Cin, T], w [Cout, Cin, K] (PyTorch Conv1d), residuals and y
// [B, Cout, T], all float32 and contiguous.
//
// Bound: f32 arithmetic. A resblock conv does T*Cin*Cout*K multiply-adds
// against 2-3 reads and one write of a [C, T] map; at C >= 48 that is above
// the card's f32 FMA-to-bandwidth ratio. Design: an implicit GEMM on the FMA
// units, Y[co, t] = sum_r W[co, r] X[r, t] over r = (ci, k) with
// X[(ci, k), t] = x[ci, t + k*d - pad]. A block owns a BM x 256 output tile
// and walks Cin in chunks of CI channels (GEMM depth R = CI*K, K a template
// parameter so the loop over the chunk is fully unrolled). Each chunk's
// im2col rows [R][256] and weights [R][BM] are copied by cp.async into one
// of two shared-memory stages while the other stage is computed, so global
// latency overlaps the FMAs. A thread keeps a TM x 8 register tile: per
// row r it reads 2 x 16 B of x (the warp's 32 lanes cover 512 contiguous
// bytes) and TM weights (one address across the warp: a broadcast) for
// 8*TM FMAs. The epilogue (bias, residuals, scale) runs in registers.
// conv_post (Cout < 16) takes a direct kernel: one thread per output sample.
//
// dot_dtype (dot_dtype.cuh; the JAX kernel's bf16 and int8 modes,
// packed.py:200-216): BF16 and I8 instances round or quantise each staged
// x value in place, by the thread that staged it, once its cp.async has
// landed; the weights come rounded (bf16) or quantised (int32 + per-channel
// scale) from the host. I8 accumulates in int32, and first takes the
// window's amax: one pass of the block over x[all Cin, t0 - pad ..
// t0 + 256 + pad) (the x chunks are read again by the GEMM, from L2). The
// narrow kernel has F32 and BF16 instances only.

#include "dot_dtype.cuh"

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes a zero: the conv's padding and the ragged edges
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

constexpr int NT = 256;  // threads: 8 warps, one per row of the thread grid
constexpr int TX = 32;   // threads along time (one warp)
constexpr int TY = 8;    // threads along output channels
constexpr int BN = 256;  // time samples per tile: 8 per thread, 2 x float4

template <int K, int CI, int TM>
struct Tile {
  static constexpr int BM = TM * TY;           // output channels per tile
  static constexpr int R = CI * K;             // GEMM depth per chunk
  static constexpr int WS = BM + 4;            // weight row stride (floats)
  static constexpr int STAGE = R * BN + R * WS;  // floats per stage
  static constexpr size_t SMEM = 2 * STAGE * sizeof(float);
};

// w holds int32 values (by their bits) for I8, with sw the [Cout] scales
template <Dot D, int K, int CI, int TM>
__global__ void __launch_bounds__(NT, 2)
conv1d_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ sw,
                   const float* __restrict__ bias,
                   const float* __restrict__ r0, const float* __restrict__ r1,
                   const float* __restrict__ r2, float* __restrict__ y,
                   int Cin, int Cout, int T, int dil, float out_scale) {
  using L = Tile<K, CI, TM>;
  using A = Acc<D>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int t0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * L::BM;
  const long long b = blockIdx.z;
  const int pad = dil * (K - 1) / 2;
  const long long CK = (long long)Cin * K;
  const float* xb = x + b * (long long)Cin * T;
  const int n_chunks = (Cin + CI - 1) / CI;

  // stage one chunk: im2col rows (thread tid owns time sample tid of every
  // row) and the weights, transposed to [R][BM]
  auto load = [&](int chunk, int stage) {
    float* xs = smem + stage * L::STAGE;
    float* ws = xs + L::R * BN;
    const int c0 = chunk * CI;
    const int g0 = t0 + tid - pad;
#pragma unroll
    for (int r = 0; r < L::R; ++r) {
      const int c = c0 + r / K;
      const int g = g0 + (r % K) * dil;
      const bool ok = c < Cin && g >= 0 && g < T;
      cp_async4(xs + r * BN + tid, ok ? xb + (long long)c * T + g : xb, ok);
    }
    const long long rmax = CK - (long long)c0 * K;
#pragma unroll
    for (int e = tid; e < L::BM * L::R; e += NT) {
      const int co = e / L::R;
      const int r = e - co * L::R;
      const int gco = co0 + co;
      const bool ok = gco < Cout && r < rmax;
      cp_async4(ws + r * L::WS + co,
                ok ? w + gco * CK + (long long)c0 * K + r : w, ok);
    }
    cp_async_commit();
  };

  A acc[TM][8];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0;

  load(0, 0);
  Quant q{0.0f, 0.0f};
  if constexpr (D == Dot::I8) {  // the window's amax, while chunk 0 lands
    __shared__ float red[32];
    const int lo = max(t0 - pad, 0), hi = min(t0 + BN + pad, T);
    float m = 0.0f;
    for (int c = 0; c < Cin; ++c)
      for (int g = lo + tid; g < hi; g += NT)
        m = fmaxf(m, fabsf(xb[(long long)c * T + g]));
    q = quant_of(block_max(m, red));
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) {
      load(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (D != Dot::F32) {  // this thread's own staged x values
      float* xo = smem + (chunk & 1) * L::STAGE + tid;
#pragma unroll
      for (int r = 0; r < L::R; ++r) xo[r * BN] = stage_value<D>(xo[r * BN], q.qs);
    }
    __syncthreads();
    const float* xs = smem + (chunk & 1) * L::STAGE + 4 * tx;
    const float* ws = smem + (chunk & 1) * L::STAGE + L::R * BN + ty * TM;
#pragma unroll
    for (int r = 0; r < L::R; ++r) {
      float a[TM];
      load_row<TM>(ws + r * L::WS, a);
      const float4 p = *reinterpret_cast<const float4*>(xs + r * BN);
      const float4 u = *reinterpret_cast<const float4*>(xs + r * BN + BN / 2);
      const float v[8] = {p.x, p.y, p.z, p.w, u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < TM; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[j][i] = mad(bits_as<A>(a[j]), bits_as<A>(v[i]), acc[j][i]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int co = co0 + ty * TM + j;
    if (co >= Cout) continue;
    const long long base = (b * Cout + co) * (long long)T;
    const float bv = bias != nullptr ? bias[co] : 0.0f;
    const float fac = D == Dot::I8 ? q.sx * sw[co] : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + (i / 4) * (BN / 2) + 4 * tx + (i % 4);
      if (t >= T) continue;
      float v = dequant(acc[j][i], fac) + bv;
      if (r0 != nullptr) v += r0[base + t];
      if (r1 != nullptr) v += r1[base + t];
      if (r2 != nullptr) v += r2[base + t];
      y[base + t] = v * out_scale;
    }
  }
}

// Few output channels (conv_post): one thread per output sample, weights
// read through the read-only cache (one address across the warp). F32 and
// BF16 only.
template <Dot D>
__global__ void __launch_bounds__(NT)
conv1d_narrow_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ r0, const float* __restrict__ r1,
                     const float* __restrict__ r2, float* __restrict__ y,
                     int Cin, int Cout, int T, int K, int dil,
                     float out_scale) {
  const int t = blockIdx.x * NT + threadIdx.x;
  if (t >= T) return;
  const int co = blockIdx.y;
  const long long b = blockIdx.z;
  const int pad = dil * (K - 1) / 2;
  const float* xb = x + b * (long long)Cin * T;
  const float* wr = w + (long long)co * Cin * K;
  float acc = 0.0f;
  for (int ci = 0; ci < Cin; ++ci) {
    const float* xr = xb + (long long)ci * T;
    for (int k = 0; k < K; ++k) {
      const int g = t + k * dil - pad;
      if (g >= 0 && g < T)
        acc = fmaf(__ldg(wr + ci * K + k), stage_value<D>(xr[g], 0.0f), acc);
    }
  }
  const long long o = (b * Cout + co) * (long long)T + t;
  float v = acc + (bias != nullptr ? bias[co] : 0.0f);
  if (r0 != nullptr) v += r0[o];
  if (r1 != nullptr) v += r1[o];
  if (r2 != nullptr) v += r2[o];
  y[o] = v * out_scale;
}

template <Dot D, int K, int CI, int TM>
int launch(const float* x, const float* w, const float* sw, const float* bias,
           const float* r0, const float* r1, const float* r2, float* y, int B,
           int Cin, int Cout, int T, int dil, float out_scale,
           cudaStream_t stream) {
  using L = Tile<K, CI, TM>;
  auto kern = conv1d_gemm_kernel<D, K, CI, TM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BN - 1) / BN, (Cout + L::BM - 1) / L::BM, B);
  kern<<<grid, NT, L::SMEM, stream>>>(x, w, sw, bias, r0, r1, r2, y, Cin,
                                      Cout, T, dil, out_scale);
  return (int)cudaGetLastError();
}

// BM = 48 for the C = 48, 96 stages (no idle rows), else 64
template <Dot D, int K, int CI>
int launch_k(const float* x, const float* w, const float* sw,
             const float* bias, const float* r0, const float* r1,
             const float* r2, float* y, int B, int Cin, int Cout, int T,
             int dil, float out_scale, cudaStream_t s) {
  if (Cout % 48 == 0 && Cout % 64 != 0)
    return launch<D, K, CI, 6>(x, w, sw, bias, r0, r1, r2, y, B, Cin, Cout,
                               T, dil, out_scale, s);
  return launch<D, K, CI, 8>(x, w, sw, bias, r0, r1, r2, y, B, Cin, Cout, T,
                             dil, out_scale, s);
}

int supported(int K, int Cout, int dot) {
  const bool gemm = K == 3 || K == 7 || K == 11;
  if (K <= 0 || K % 2 == 0) return 0;
  if (dot == (int)Dot::I8) return Cout >= 16 && gemm;
  return (dot == (int)Dot::F32 || dot == (int)Dot::BF16) &&
         (Cout < 16 || gemm);
}

template <Dot D>
int conv1d_same(const float* x, const float* w, const float* sw,
                const float* bias, const float* r0, const float* r1,
                const float* r2, float* y, int B, int Cin, int Cout, int T,
                int K, int dil, float out_scale, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || T <= 0 || dil <= 0 || B > 65535 ||
      Cout > 65535 || !supported(K, Cout, (int)D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (D != Dot::I8) {
    if (Cout < 16) {
      dim3 grid((T + NT - 1) / NT, Cout, B);
      conv1d_narrow_kernel<D><<<grid, NT, 0, s>>>(x, w, bias, r0, r1, r2, y,
                                                  Cin, Cout, T, K, dil,
                                                  out_scale);
      return (int)cudaGetLastError();
    }
  }
  switch (K) {  // CI x K = 24, 28, 22 rows of GEMM depth per chunk
    case 3:
      return launch_k<D, 3, 8>(x, w, sw, bias, r0, r1, r2, y, B, Cin, Cout,
                               T, dil, out_scale, s);
    case 7:
      return launch_k<D, 7, 4>(x, w, sw, bias, r0, r1, r2, y, B, Cin, Cout,
                               T, dil, out_scale, s);
    default:
      return launch_k<D, 11, 2>(x, w, sw, bias, r0, r1, r2, y, B, Cin, Cout,
                                T, dil, out_scale, s);
  }
}

}  // namespace

// 1 when (K, Cout) has an instance of dot dtype ``dot`` (0 f32, 1 bf16,
// 2 int8): f32 and bf16 any odd K for Cout < 16, else K in {3, 7, 11};
// int8 K in {3, 7, 11} and Cout >= 16.
extern "C" int conv1d_same_supported(int K, int Cout, int dot) {
  return supported(K, Cout, dot);
}

// Each returns cudaGetLastError() after the launch (or the error that kept
// it from launching). bias and r0..r2 may be null.
extern "C" int conv1d_same_f32(const float* x, const float* w,
                               const float* bias, const float* r0,
                               const float* r1, const float* r2, float* y,
                               int B, int Cin, int Cout, int T, int K, int dil,
                               float out_scale, void* stream) {
  return conv1d_same<Dot::F32>(x, w, nullptr, bias, r0, r1, r2, y, B, Cin,
                               Cout, T, K, dil, out_scale, stream);
}

// w: the weights rounded to bf16 (as f32)
extern "C" int conv1d_same_bf16(const float* x, const float* w,
                                const float* bias, const float* r0,
                                const float* r1, const float* r2, float* y,
                                int B, int Cin, int Cout, int T, int K,
                                int dil, float out_scale, void* stream) {
  return conv1d_same<Dot::BF16>(x, w, nullptr, bias, r0, r1, r2, y, B, Cin,
                                Cout, T, K, dil, out_scale, stream);
}

// wq: int32 weights in [-127, 127], sw: [Cout] scales (ops/quant.py)
extern "C" int conv1d_same_int8(const float* x, const int* wq,
                                const float* sw, const float* bias,
                                const float* r0, const float* r1,
                                const float* r2, float* y, int B, int Cin,
                                int Cout, int T, int K, int dil,
                                float out_scale, void* stream) {
  return conv1d_same<Dot::I8>(x, reinterpret_cast<const float*>(wq), sw, bias,
                              r0, r1, r2, y, B, Cin, Cout, T, K, dil,
                              out_scale, stream);
}
