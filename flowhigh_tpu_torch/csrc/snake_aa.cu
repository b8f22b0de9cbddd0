// Kernel A: anti-aliased snake activation, y = down2(snakebeta(up2(x))).
//
// Replaces the Pallas kernels flowhigh_tpu/ops/fused_act.py:
// fused_snake_activation1d (with its _patch_edges edge fix) and
// flowhigh_tpu/ops/packed.py:packed_snake_activation1d (the same function
// on space-to-depth packed rows; the card needs no packing).
//
// Layout: x, y are [rows = B*C, T] (PyTorch's [B, C, T]) in the storage
// type (dot_dtype.cuh: float, or bf16 for the JAX package's bf16 feature
// maps, loaded into f32 and rounded once at the store); alpha, beta are [C]
// float32; h is the 12-tap Kaiser-sinc half-band filter
// kaiser_sinc_filter1d(0.25, 0.3, 12). With we = 2 h[0::2], wo = 2 h[1::2]:
//
//   s[2m]   = snake(sum_k we[k] x[clamp(m - 3 + k)])        k = 0..5
//   s[2m+1] = snake(sum_k wo[k] x[clamp(m - 2 + k)])
//   y[n]    = sum_j h[j] s[clamp(2n + j - 5, 0, 2T - 1)]     j = 0..11
//
// The clamp on x is the up stage's replicate padding and the clamp on s the
// down stage's (s[2T - 1] = snake(so(T - 1)), s[0] = snake(se(0))): the
// unfused composition's edges at every T >= 1. (The JAX fused kernel, at
// lengths with no multiple-of-8 tile, pads x and patches the padded
// length's edge instead; the port keeps the composition.)
//
// Bound: device memory. Each element is read once and written once (8 B,
// 4 B with bf16 maps);
// its ~24 FIR multiply-adds and two snakes (snake.cuh: a sine by a
// polynomial, no slow path) stay below the card's FMA rate.
//
// Design: registers, not shared memory. A thread owns a strip of R
// consecutive outputs n0 .. n0 + R - 1; a warp 32 strips, a block WARPS
// warps (TILE outputs of one row); the grid is one-dimensional over
// (row, tile), so any B*C. The thread
//   1. reads x[n0 - 4, n0 + R + 4) (four elements a load on interior
//      tiles: 16 bytes f32, 8 bytes bf16),
//   2. computes its own 2R samples of the 2x-rate signal s, once,
//   3. takes the 5 samples of s to its left and the 5 to its right from its
//      neighbouring lanes (__shfl_up_sync / __shfl_down_sync); the warp's
//      two outer halos (10 samples) are computed by lanes 0..9, one sample
//      each, and handed to lanes 0 and 31 by shuffles,
//   4. runs the 12-tap down FIR in registers and stores its R outputs
//      (four elements a store on interior tiles).
// Interior tiles run without index clamps. The first and last tiles of a
// row, every tile of a row shorter than a tile, and every tile when T % 4
// or the pointers rule out four-element access, take the clamped path: scalar
// loads at clamped indices, s positions outside [0, 2T) replaced by the
// down stage's edge samples, stores guarded by T. The taps arrive by value
// (kernel parameters: constant-bank operands, no registers).
//
// The firs-only instance (kSnake = false, entry snake_aa_firs_f32) replaces
// the snake by the identity: down2(up2(x)), the FIR half of the work, on the
// same structure. It is the card's counterpart of scripts/bench_act_mxu.py's
// `firs_only` row (the JAX script monkeypatches ops/packed.py:_snake_packed
// to the identity) and runs only in the probe script and chip_smoke.py.

#include <climits>

#include <cuda_runtime.h>

#include "dot_dtype.cuh"
#include "snake.cuh"

namespace {

constexpr int R = 8;                // outputs a thread (a multiple of 4)
constexpr int WARPS = 4;            // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = THREADS * R;   // outputs a block
constexpr int XW = R + 8;           // x window: x[n0 - 4, n0 + R + 4)
constexpr int SW = 2 * R + 10;      // s window: s[2 n0 - 5, 2 n0 + 2R + 5)
constexpr unsigned FULL = 0xffffffffu;

struct Taps {
  float up[12];  // 2 h: up[2k] = we[k], up[2k + 1] = wo[k]
  float dn[12];  // h
};

template <bool kSnake>
__device__ __forceinline__ float act(float v, float a, float inv_b) {
  return kSnake ? snake_fn(v, a, inv_b) : v;
}

// s at 2x-rate index idx (any integer; x read at clamped indices when
// kClamp): s[2m] = se(m), s[2m + 1] = so(m).
template <bool kSnake, bool kClamp, class S>
__device__ __forceinline__ float s_at(const S* __restrict__ xr, int T,
                                      int idx, const Taps& tp, float a,
                                      float inv_b) {
  const int m = idx >> 1, par = idx & 1;
  const int base = m - 3 + par;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int g = kClamp ? min(max(base + k, 0), T - 1) : base + k;
    acc = fmaf(par ? tp.up[2 * k + 1] : tp.up[2 * k], ldg_f32(xr + g), acc);
  }
  return act<kSnake>(acc, a, inv_b);
}

// One thread's strip: outputs n0 = w0 + lane * R .. n0 + R - 1 of a row.
template <bool kSnake, bool kEdge, class S>
__device__ __forceinline__ void strip(const S* __restrict__ xr,
                                      S* __restrict__ yr, int T, int w0,
                                      int lane, const Taps& tp, float a,
                                      float inv_b) {
  const int n0 = w0 + lane * R;

  float xw[XW];  // xw[j] = x[n0 - 4 + j]
  if (kEdge) {
#pragma unroll
    for (int j = 0; j < XW; ++j)
      xw[j] = ldg_f32(xr + min(max(n0 - 4 + j, 0), T - 1));
  } else {
#pragma unroll
    for (int q = 0; q < XW / 4; ++q) {
      const float4 v = ldg4_f32(xr + n0 - 4 + 4 * q);
      xw[4 * q] = v.x;
      xw[4 * q + 1] = v.y;
      xw[4 * q + 2] = v.z;
      xw[4 * q + 3] = v.w;
    }
  }

  float sw[SW];  // sw[p] = s[2 n0 - 5 + p]; own samples at p = 5 .. 2R + 4
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float se = 0.0f, so = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      se = fmaf(tp.up[2 * k], xw[i + 1 + k], se);
      so = fmaf(tp.up[2 * k + 1], xw[i + 2 + k], so);
    }
    sw[5 + 2 * i] = act<kSnake>(se, a, inv_b);
    sw[6 + 2 * i] = act<kSnake>(so, a, inv_b);
  }

  // the warp's outer halos: lane j < 5 computes s[2 w0 - 5 + j], lane
  // 5 <= j < 10 s[2 (w0 + 32 R) + j - 5] (lanes 10..31 repeat lane 9)
  const int j = min(lane, 9);
  const float e = s_at<kSnake, kEdge, S>(
      xr, T, j < 5 ? 2 * w0 - 5 + j : 2 * (w0 + 32 * R) + j - 5, tp, a,
      inv_b);

#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const float left = __shfl_up_sync(FULL, sw[2 * R + q], 1);
    const float right = __shfl_down_sync(FULL, sw[5 + q], 1);
    const float outer_left = __shfl_sync(FULL, e, q);
    const float outer_right = __shfl_sync(FULL, e, 5 + q);
    sw[q] = lane == 0 ? outer_left : left;
    sw[2 * R + 5 + q] = lane == 31 ? outer_right : right;
  }

  if (kEdge) {  // the down stage's replicate edges
    const float s_lo = s_at<kSnake, true, S>(xr, T, 0, tp, a, inv_b);
    const float s_hi = s_at<kSnake, true, S>(xr, T, 2 * T - 1, tp, a, inv_b);
#pragma unroll
    for (int p = 0; p < SW; ++p) {
      const int idx = 2 * n0 - 5 + p;
      sw[p] = idx < 0 ? s_lo : (idx > 2 * T - 1 ? s_hi : sw[p]);
    }
  }

  float out[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 12; ++jj) acc = fmaf(tp.dn[jj], sw[2 * i + jj], acc);
    out[i] = acc;
  }

  if (kEdge) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (n0 + i < T) store_f32(yr + n0 + i, out[i]);
  } else {
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      store4_f32(yr + n0 + 4 * q,
                 make_float4(out[4 * q], out[4 * q + 1], out[4 * q + 2],
                             out[4 * q + 3]));
  }
}

template <bool kSnake, Store ST>
__global__ void __launch_bounds__(THREADS)
snake_aa_kernel(const StoreT<ST>* __restrict__ x,
                const float* __restrict__ alpha,
                const float* __restrict__ beta, const Taps taps,
                StoreT<ST>* __restrict__ y, int channels, int T, int tiles,
                int logscale, int vec) {
  using S = StoreT<ST>;
  const int row = (int)(blockIdx.x / (unsigned)tiles);
  const int tile = (int)blockIdx.x - row * tiles;
  const S* xr = x + (long long)row * T;
  S* yr = y + (long long)row * T;

  float a = 0.0f, inv_b = 0.0f;
  if (kSnake) {
    const int c = row % channels;
    a = __ldg(alpha + c);
    float b = beta != nullptr ? __ldg(beta + c) : a;
    if (logscale) {
      a = expf(a);
      b = expf(b);
    }
    inv_b = 1.0f / (b + 1e-9f);
  }

  const int w0 = tile * TILE + (threadIdx.x >> 5) * 32 * R;
  const int lane = threadIdx.x & 31;
  // interior: every read of x (x[t0 - 5, t0 + TILE + 5)) and every s
  // position in range, four-element access allowed
  if (vec && tile > 0 && (long long)(tile + 1) * TILE + 8 <= T)
    strip<kSnake, false, S>(xr, yr, T, w0, lane, taps, a, inv_b);
  else
    strip<kSnake, true, S>(xr, yr, T, w0, lane, taps, a, inv_b);
}

template <bool kSnake, Store ST>
int launch(const void* x, const float* alpha, const float* beta,
           const float* taps_host, void* y, int rows, int channels, int T,
           int logscale, void* stream) {
  using S = StoreT<ST>;
  if (rows <= 0 || T <= 0 || channels <= 0 || taps_host == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles = (T + TILE - 1) / TILE;
  if ((long long)rows * tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int j = 0; j < 12; ++j) {
    taps.up[j] = 2.0f * taps_host[j];
    taps.dn[j] = taps_host[j];
  }
  const int vec = T % 4 == 0 &&
                  ((reinterpret_cast<unsigned long long>(x) |
                    reinterpret_cast<unsigned long long>(y)) &
                   (4 * sizeof(S) - 1)) == 0;
  snake_aa_kernel<kSnake, ST>
      <<<(unsigned)(rows * tiles), THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const S*>(x), alpha, beta, taps, static_cast<S*>(y),
          channels, T, tiles, logscale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [rows, T] on the card; alpha, beta: [channels] on the card (beta
// may be null: plain snake, beta = alpha); taps_host: the 12 taps in host
// memory (passed to the kernel by value). Any rows and T with rows *
// ceil(T / TILE) < 2^31. Returns cudaGetLastError() after the launch.
extern "C" int snake_aa_f32(const float* x, const float* alpha,
                            const float* beta, const float* taps_host,
                            float* y, int rows, int channels, int T,
                            int logscale, void* stream) {
  return launch<true, Store::F32>(x, alpha, beta, taps_host, y, rows,
                                  channels, T, logscale, stream);
}

// The same on bf16 maps (x, y __nv_bfloat16; alpha, beta float32).
extern "C" int snake_aa_f32_bf16io(const void* x, const float* alpha,
                                   const float* beta, const float* taps_host,
                                   void* y, int rows, int channels, int T,
                                   int logscale, void* stream) {
  return launch<true, Store::BF16>(x, alpha, beta, taps_host, y, rows,
                                   channels, T, logscale, stream);
}

// The firs-only instance: y = down2(up2(x)) on [rows, T], same edges.
extern "C" int snake_aa_firs_f32(const float* x, const float* taps_host,
                                 float* y, int rows, int T, void* stream) {
  return launch<false, Store::F32>(x, nullptr, nullptr, taps_host, y, rows, 1,
                                   T, 0, stream);
}
