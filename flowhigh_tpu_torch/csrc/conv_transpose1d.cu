// Kernel C: ConvTranspose1d with stride U, padding P = (K - U) / 2 and
// exactly U*T outputs, + bias, as a polyphase convolution:
//   y[co, U*m + r] = bias[co]
//       + sum_ci sum_{j : (r + P - j) % U == 0} w[ci, co, j] x[ci, m + (r + P - j) / U]
// (x zero outside [0, T)). Output phase r only meets the taps j congruent
// to r + P mod U, about K/U of them: the zero-stuffed input is never formed.
//
// Replaces the Pallas kernel
// flowhigh_tpu/ops/packed.py:pallas_packed_conv_transpose1d (plan
// _convt_plan, core _pallas_conv_rows) at p_in = p_out = 1: BigVGAN's five
// stage-boundary upsamplers, (U, K) = (5,11), (4,8), (4,8), (3,7), (2,4),
// and (8,16), the first upsampler of the CLI's --tiny vocoder (whose odd
// pairs (5,10), (3,6) run the library conv, models/bigvgan.py).
//
// Layout: x [B, Cin, T], w [Cin, Cout, K] (PyTorch ConvTranspose1d),
// y [B, Cout, U*T], float32, contiguous.
//
// Bound: f32 arithmetic (T*Cin*Cout*K multiply-adds over a few MB of
// traffic). Design: U and K are template parameters, so the tap-to-phase
// plan above is resolved at compile time and the inner loops are fully
// unrolled with no divergence. A block owns a (Cout tile x input-time tile)
// and all U output phases of it; per Cin chunk it stages the x window (the
// tile plus the tap halo) and the weights in shared memory. Each thread
// keeps CPT x MPT x U f32 accumulators.
//
// dot_dtype (dot_dtype.cuh): a BF16 instance rounds each x value to bf16 as
// it is staged; its weights come rounded from the host. The JAX package
// keeps the upsamplers in f32 under int8 (bigvgan.py:406-414), so there is
// no I8 instance.

#include "dot_dtype.cuh"

namespace {

constexpr int CPT = 4, MPT = 4, TY = 16, TX = 16, CI = 8;
constexpr int TILE_CO = CPT * TY;
constexpr int TILE_M = MPT * TX;
constexpr int NT = TY * TX;

template <int U, int K>
struct Plan {
  static constexpr int P = (K - U) / 2;
  // tap j reads x[m + q] with q = (r + P - j) / U, over r in [0, U)
  static constexpr int QLO = -((K - 1 - P + U - 1) / U);  // floor((P-K+1)/U)
  static constexpr int QHI = (U - 1 + P) / U;
  static constexpr int W = TILE_M + QHI - QLO;
};

template <Dot D, int U, int K>
__global__ void __launch_bounds__(NT)
conv_transpose1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ y,
                        int Cin, int Cout, int T) {
  using PL = Plan<U, K>;
  __shared__ float xs[CI][PL::W];
  __shared__ float ws[CI][K][TILE_CO];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * TILE_M;
  const int co0 = blockIdx.y * TILE_CO;
  const long long b = blockIdx.z;
  const float* xb = x + b * (long long)Cin * T;

  float acc[U][CPT][MPT];
#pragma unroll
  for (int r = 0; r < U; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j)
#pragma unroll
      for (int i = 0; i < MPT; ++i) acc[r][j][i] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CI) {
    for (int idx = tid; idx < CI * PL::W; idx += NT) {
      const int ci = idx / PL::W;
      const int u = idx - ci * PL::W;
      const int g = m0 + PL::QLO + u;
      const int c = c0 + ci;
      xs[ci][u] = (c < Cin && g >= 0 && g < T)
                      ? stage_value<D>(xb[(long long)c * T + g], 0.0f)
                      : 0.0f;
    }
    // weights: k fastest, then co, then ci (runs of TILE_CO*K contiguous
    // floats of w per input channel)
    for (int idx = tid; idx < CI * TILE_CO * K; idx += NT) {
      const int ci = idx / (TILE_CO * K);
      const int rem = idx - ci * (TILE_CO * K);
      const int co = rem / K;
      const int k = rem - co * K;
      const int c = c0 + ci;
      const int gco = co0 + co;
      ws[ci][k][co] = (c < Cin && gco < Cout)
                          ? w[((long long)c * Cout + gco) * K + k]
                          : 0.0f;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
      for (int r = 0; r < U; ++r) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if ((r + PL::P - j) % U != 0) continue;  // resolved at compile time
          const int q = (r + PL::P - j) / U;
          float wv[CPT];
          float xv[MPT];
#pragma unroll
          for (int jj = 0; jj < CPT; ++jj) wv[jj] = ws[ci][j][ty * CPT + jj];
#pragma unroll
          for (int i = 0; i < MPT; ++i) xv[i] = xs[ci][tx + i * TX + q - PL::QLO];
#pragma unroll
          for (int jj = 0; jj < CPT; ++jj)
#pragma unroll
            for (int i = 0; i < MPT; ++i)
              acc[r][jj][i] = fmaf(wv[jj], xv[i], acc[r][jj][i]);
        }
      }
    }
    __syncthreads();
  }

  const long long t_out = (long long)U * T;
#pragma unroll
  for (int jj = 0; jj < CPT; ++jj) {
    const int co = co0 + ty * CPT + jj;
    if (co >= Cout) continue;
    const float bv = bias != nullptr ? bias[co] : 0.0f;
    float* yr = y + (b * Cout + co) * t_out;
#pragma unroll
    for (int i = 0; i < MPT; ++i) {
      const int m = m0 + tx + i * TX;
      if (m >= T) continue;
#pragma unroll
      for (int r = 0; r < U; ++r) yr[(long long)U * m + r] = acc[r][jj][i] + bv;
    }
  }
}

template <Dot D, int U, int K>
int launch(const float* x, const float* w, const float* bias, float* y, int B,
           int Cin, int Cout, int T, cudaStream_t stream) {
  dim3 grid((T + TILE_M - 1) / TILE_M, (Cout + TILE_CO - 1) / TILE_CO, B);
  conv_transpose1d_kernel<D, U, K><<<grid, NT, 0, stream>>>(x, w, bias, y,
                                                           Cin, Cout, T);
  return (int)cudaGetLastError();
}

template <Dot D>
int conv_transpose1d(const float* x, const float* w, const float* bias,
                     float* y, int B, int Cin, int Cout, int T, int stride,
                     int K, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || T <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stride == 5 && K == 11)
    return launch<D, 5, 11>(x, w, bias, y, B, Cin, Cout, T, s);
  if (stride == 4 && K == 8)
    return launch<D, 4, 8>(x, w, bias, y, B, Cin, Cout, T, s);
  if (stride == 3 && K == 7)
    return launch<D, 3, 7>(x, w, bias, y, B, Cin, Cout, T, s);
  if (stride == 2 && K == 4)
    return launch<D, 2, 4>(x, w, bias, y, B, Cin, Cout, T, s);
  if (stride == 8 && K == 16)
    return launch<D, 8, 16>(x, w, bias, y, B, Cin, Cout, T, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The (stride, K) pairs of BigVGAN's upsamplers and (8, 16); others return
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch.
extern "C" int conv_transpose1d_f32(const float* x, const float* w,
                                    const float* bias, float* y, int B,
                                    int Cin, int Cout, int T, int stride,
                                    int K, void* stream) {
  return conv_transpose1d<Dot::F32>(x, w, bias, y, B, Cin, Cout, T, stride,
                                    K, stream);
}

// w: the weights rounded to bf16 (as f32)
extern "C" int conv_transpose1d_bf16(const float* x, const float* w,
                                     const float* bias, float* y, int B,
                                     int Cin, int Cout, int T, int stride,
                                     int K, void* stream) {
  return conv_transpose1d<Dot::BF16>(x, w, bias, y, B, Cin, Cout, T, stride,
                                     K, stream);
}

// 1 when (stride, K) has a compiled instance (float32 and bfloat16).
extern "C" int conv_transpose1d_supported(int stride, int K) {
  return (stride == 5 && K == 11) || (stride == 4 && K == 8) ||
         (stride == 3 && K == 7) || (stride == 2 && K == 4) ||
         (stride == 8 && K == 16);
}
