// Kernel A: anti-aliased snake activation, y = down2(snakebeta(up2(x))).
//
// Replaces the Pallas kernels flowhigh_tpu/ops/fused_act.py:
// fused_snake_activation1d (with its _patch_edges edge fix) and
// flowhigh_tpu/ops/packed.py:packed_snake_activation1d (the same function
// on space-to-depth packed rows; the card needs no packing).
//
// Layout: x, y are [rows = B*C, T] float32 (PyTorch's [B, C, T]); alpha,
// beta are [C]; h is the 12-tap Kaiser-sinc half-band filter
// kaiser_sinc_filter1d(0.25, 0.3, 12). With we = 2 h[0::2], wo = 2 h[1::2]:
//
//   s[2m]   = snake(sum_k we[k] x[clamp(m - 3 + k)])        k = 0..5
//   s[2m+1] = snake(sum_k wo[k] x[clamp(m - 2 + k)])
//   y[n]    = sum_j h[j] s[clamp(2n + j - 5, 0, 2T - 1)]     j = 0..11
//
// The clamp on x is the up stage's replicate padding and the clamp on s the
// down stage's, both done here in the kernel.
//
// Bound: device memory. Each element is read once and written once (8 B);
// the ~40 flops and one sinf per element are far below the card's rate.
// Design: one block per (row, time tile of TILE outputs). The block stages
// its x tile with a +-6 sample halo in shared memory (coalesced loads), forms
// the 2x-rate snake signal for the tile in shared memory, then each thread
// writes outputs at consecutive addresses. The 2x-rate intermediate never
// leaves the SM. The sine is the precise sinf.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
snake_aa_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                const float* __restrict__ beta, const float* __restrict__ filt,
                float* __restrict__ y, int channels, int T, int logscale) {
  __shared__ float xs[TILE + 12];      // x[t0 - 6 .. t0 + TILE + 6)
  __shared__ float ss[2 * (TILE + 6)]; // s[2(t0 - 3) .. 2(t0 + TILE + 3))
  __shared__ float h[12];

  const long long row = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const float* xr = x + row * (long long)T;

  if (threadIdx.x < 12) h[threadIdx.x] = filt[threadIdx.x];
  for (int i = threadIdx.x; i < TILE + 12; i += THREADS) {
    const int g = min(max(t0 - 6 + i, 0), T - 1);
    xs[i] = xr[g];
  }
  const int c = (int)(row % channels);
  float a = alpha[c];
  float b = beta != nullptr ? beta[c] : a;
  if (logscale) {
    a = expf(a);
    b = expf(b);
  }
  const float inv_b = 1.0f / (b + 1e-9f);
  __syncthreads();

  // 2x-rate snake signal for m = t0 - 3 + i: s[2m] reads xs[i .. i+5],
  // s[2m+1] reads xs[i+1 .. i+6]
  for (int i = threadIdx.x; i < TILE + 6; i += THREADS) {
    float se = 0.0f, so = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      se = fmaf(2.0f * h[2 * k], xs[i + k], se);
      so = fmaf(2.0f * h[2 * k + 1], xs[i + 1 + k], so);
    }
    const float pe = sinf(a * se);
    const float po = sinf(a * so);
    ss[2 * i] = se + inv_b * (pe * pe);
    ss[2 * i + 1] = so + inv_b * (po * po);
  }
  __syncthreads();

  const int s_base = 2 * (t0 - 3);
  const int s_max = 2 * T - 1;
  float* yr = y + row * (long long)T;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const int n = t0 + i;
    if (n >= T) break;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int s = min(max(2 * n + j - 5, 0), s_max);
      acc = fmaf(h[j], ss[s - s_base], acc);
    }
    yr[n] = acc;
  }
}

}  // namespace

// x, y: [rows, T]; alpha, beta: [channels] (beta may be null: plain snake,
// beta = alpha); filt: the 12 taps. Returns cudaGetLastError() after the
// launch.
extern "C" int snake_aa_f32(const float* x, const float* alpha,
                            const float* beta, const float* filt, float* y,
                            int rows, int channels, int T, int logscale,
                            void* stream) {
  if (rows <= 0 || T <= 0 || channels <= 0 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((T + TILE - 1) / TILE, rows);
  snake_aa_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, alpha, beta, filt, y, channels, T, logscale);
  return (int)cudaGetLastError();
}
