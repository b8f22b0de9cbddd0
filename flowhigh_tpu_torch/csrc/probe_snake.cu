// Kernel G: the snake alone on 2x the elements, out = snake(x) + snake(x + 1),
// with per-lane a, b (already exp'd).
//
// Replaces the Pallas probe kernel scripts/bench_act_mxu.py:snake_only (its
// pallas_call at :52): the anti-aliased activation's arithmetic floor,
// kernel A's snake work without its FIRs. The snake is kernel A's own
// (snake.cuh), so G measures A's floor with A's arithmetic.
//
// Layout: x, out [B, S, L] float32 with the lanes last (the JAX layout,
// L = p * C in the script); ab [2, L].
//
// Bound: device memory, 8 bytes per element (one read, one write); two
// sines per element (snake.cuh: reduction by pi and a polynomial, no slow
// path) are below the card's rate. Design: elementwise.
// A block owns VEC * blockDim.x consecutive lanes, so each thread keeps its
// lanes' a and 1 / (b + 1e-9) in registers (no per-element division or
// index arithmetic), and walks the rows ROWS at a time, 16-byte loads and
// stores where L % 4 == 0. Any S: the JAX tile constraint is the TPU's.

#include <cuda_runtime.h>

#include "snake.cuh"

namespace {

constexpr int ROWS = 8;

__device__ __forceinline__ float probe(float u, float a, float ib) {
  return snake_fn(u, a, ib) + snake_fn(u + 1.0f, a, ib);
}

__device__ __forceinline__ float probe(float u, const float* a,
                                       const float* ib) {
  return probe(u, a[0], ib[0]);
}

__device__ __forceinline__ float4 probe(float4 u, const float* a,
                                        const float* ib) {
  return make_float4(probe(u.x, a[0], ib[0]), probe(u.y, a[1], ib[1]),
                     probe(u.z, a[2], ib[2]), probe(u.w, a[3], ib[3]));
}

template <int VEC>
struct Vec {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int VEC>
__global__ void __launch_bounds__(256)
snake_only_kernel(const float* __restrict__ x, const float* __restrict__ ab,
                  float* __restrict__ out, long long rows, int L) {
  using V = typename Vec<VEC>::T;
  const int lane0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (lane0 >= L) return;
  float a[VEC], ib[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    a[v] = ab[lane0 + v];
    ib[v] = 1.0f / (ab[L + lane0 + v] + 1e-9f);
  }
  for (long long r0 = (long long)blockIdx.y * ROWS; r0 < rows;
       r0 += (long long)gridDim.y * ROWS) {
    V buf[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (r0 + i < rows)
        buf[i] = *reinterpret_cast<const V*>(x + (r0 + i) * L + lane0);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (r0 + i < rows)
        *reinterpret_cast<V*>(out + (r0 + i) * L + lane0) =
            probe(buf[i], a, ib);
  }
}

template <int VEC>
int launch(const float* x, const float* ab, float* out, long long rows, int L,
           cudaStream_t stream) {
  const int per = (L + VEC - 1) / VEC;  // threads a row needs
  const int threads = per >= 256 ? 256 : ((per + 31) / 32) * 32;
  const long long groups = (rows + ROWS - 1) / ROWS;
  dim3 grid((per + threads - 1) / threads,
            (unsigned)(groups < 65535 ? groups : 65535));
  snake_only_kernel<VEC><<<grid, threads, 0, stream>>>(x, ab, out, rows, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [rows = B * S, L]; ab: [2, L]. 16-byte aligned pointers take the
// vector path when L % 4 == 0. Returns cudaGetLastError() after the launch.
extern "C" int snake_only_f32(const float* x, const float* ab, float* out,
                              long long rows, int L, void* stream) {
  if (rows <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((reinterpret_cast<unsigned long long>(x) |
                         reinterpret_cast<unsigned long long>(out)) & 15) == 0;
  if (L % 4 == 0 && aligned) return launch<4>(x, ab, out, rows, L, s);
  return launch<1>(x, ab, out, rows, L, s);
}
