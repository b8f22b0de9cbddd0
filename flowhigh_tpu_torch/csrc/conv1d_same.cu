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

#include <cuda_runtime.h>

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

template <int K, int CI, int TM>
__global__ void __launch_bounds__(NT, 2)
conv1d_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ r0, const float* __restrict__ r1,
                   const float* __restrict__ r2, float* __restrict__ y,
                   int Cin, int Cout, int T, int dil, float out_scale) {
  using L = Tile<K, CI, TM>;
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

  float acc[TM][8];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;

  load(0, 0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) {
      load(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + (chunk & 1) * L::STAGE + 4 * tx;
    const float* ws = smem + (chunk & 1) * L::STAGE + L::R * BN + ty * TM;
#pragma unroll
    for (int r = 0; r < L::R; ++r) {
      float a[TM];
      load_row<TM>(ws + r * L::WS, a);
      const float4 p = *reinterpret_cast<const float4*>(xs + r * BN);
      const float4 q = *reinterpret_cast<const float4*>(xs + r * BN + BN / 2);
      const float v[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < TM; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(a[j], v[i], acc[j][i]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int co = co0 + ty * TM + j;
    if (co >= Cout) continue;
    const long long base = (b * Cout + co) * (long long)T;
    const float bv = bias != nullptr ? bias[co] : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + (i / 4) * (BN / 2) + 4 * tx + (i % 4);
      if (t >= T) continue;
      float v = acc[j][i] + bv;
      if (r0 != nullptr) v += r0[base + t];
      if (r1 != nullptr) v += r1[base + t];
      if (r2 != nullptr) v += r2[base + t];
      y[base + t] = v * out_scale;
    }
  }
}

// Few output channels (conv_post): one thread per output sample, weights
// read through the read-only cache (one address across the warp).
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
      if (g >= 0 && g < T) acc = fmaf(__ldg(wr + ci * K + k), xr[g], acc);
    }
  }
  const long long o = (b * Cout + co) * (long long)T + t;
  float v = acc + (bias != nullptr ? bias[co] : 0.0f);
  if (r0 != nullptr) v += r0[o];
  if (r1 != nullptr) v += r1[o];
  if (r2 != nullptr) v += r2[o];
  y[o] = v * out_scale;
}

template <int K, int CI, int TM>
int launch(const float* x, const float* w, const float* bias, const float* r0,
           const float* r1, const float* r2, float* y, int B, int Cin,
           int Cout, int T, int dil, float out_scale, cudaStream_t stream) {
  using L = Tile<K, CI, TM>;
  auto kern = conv1d_gemm_kernel<K, CI, TM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BN - 1) / BN, (Cout + L::BM - 1) / L::BM, B);
  kern<<<grid, NT, L::SMEM, stream>>>(x, w, bias, r0, r1, r2, y, Cin, Cout, T,
                                      dil, out_scale);
  return (int)cudaGetLastError();
}

// BM = 48 for the C = 48, 96 stages (no idle rows), else 64
template <int K, int CI>
int launch_k(const float* x, const float* w, const float* bias,
             const float* r0, const float* r1, const float* r2, float* y,
             int B, int Cin, int Cout, int T, int dil, float out_scale,
             cudaStream_t s) {
  if (Cout % 48 == 0 && Cout % 64 != 0)
    return launch<K, CI, 6>(x, w, bias, r0, r1, r2, y, B, Cin, Cout, T, dil,
                            out_scale, s);
  return launch<K, CI, 8>(x, w, bias, r0, r1, r2, y, B, Cin, Cout, T, dil,
                          out_scale, s);
}

}  // namespace

// 1 when (K, Cout) has a kernel: any K for Cout < 16, else K in {3, 7, 11}.
extern "C" int conv1d_same_supported(int K, int Cout) {
  return K > 0 && K % 2 == 1 && (Cout < 16 || K == 3 || K == 7 || K == 11);
}

// Returns cudaGetLastError() after the launch (or the error that kept it
// from launching). bias and r0..r2 may be null.
extern "C" int conv1d_same_f32(const float* x, const float* w,
                               const float* bias, const float* r0,
                               const float* r1, const float* r2, float* y,
                               int B, int Cin, int Cout, int T, int K, int dil,
                               float out_scale, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || T <= 0 || dil <= 0 || B > 65535 ||
      Cout > 65535 || !conv1d_same_supported(K, Cout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout < 16) {
    dim3 grid((T + NT - 1) / NT, Cout, B);
    conv1d_narrow_kernel<<<grid, NT, 0, s>>>(x, w, bias, r0, r1, r2, y, Cin,
                                             Cout, T, K, dil, out_scale);
    return (int)cudaGetLastError();
  }
  switch (K) {  // CI x K = 24, 28, 22 rows of GEMM depth per chunk
    case 3:
      return launch_k<3, 8>(x, w, bias, r0, r1, r2, y, B, Cin, Cout, T, dil,
                            out_scale, s);
    case 7:
      return launch_k<7, 4>(x, w, bias, r0, r1, r2, y, B, Cin, Cout, T, dil,
                            out_scale, s);
    default:
      return launch_k<11, 2>(x, w, bias, r0, r1, r2, y, B, Cin, Cout, T, dil,
                             out_scale, s);
  }
}
