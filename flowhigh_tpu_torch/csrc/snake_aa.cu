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
// leaves the SM. The sine is the precise sinf (snake.cuh, shared with
// probe kernel G).
//
// The firs-only instance (kSnake = false, entry snake_aa_firs_f32) replaces
// the snake by the identity: down2(up2(x)), the FIR half of the work. It is
// the card's counterpart of scripts/bench_act_mxu.py's `firs_only` row (the
// JAX script monkeypatches ops/packed.py:_snake_packed to the identity) and
// runs only in the probe script and chip_smoke.py.

#include <cuda_runtime.h>

#include "snake.cuh"

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 256;

template <bool kSnake>
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
  float a = 0.0f, inv_b = 0.0f;
  if (kSnake) {
    const int c = (int)(row % channels);
    a = alpha[c];
    float b = beta != nullptr ? beta[c] : a;
    if (logscale) {
      a = expf(a);
      b = expf(b);
    }
    inv_b = 1.0f / (b + 1e-9f);
  }
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
    ss[2 * i] = kSnake ? snake_fn(se, a, inv_b) : se;
    ss[2 * i + 1] = kSnake ? snake_fn(so, a, inv_b) : so;
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
  snake_aa_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, alpha, beta, filt, y, channels, T, logscale);
  return (int)cudaGetLastError();
}

// The firs-only instance: y = down2(up2(x)) on [rows, T], same edges.
extern "C" int snake_aa_firs_f32(const float* x, const float* filt, float* y,
                                 int rows, int T, void* stream) {
  if (rows <= 0 || T <= 0 || rows > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((T + TILE - 1) / TILE, rows);
  snake_aa_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, nullptr, nullptr, filt, y, 1, T, 0);
  return (int)cudaGetLastError();
}
