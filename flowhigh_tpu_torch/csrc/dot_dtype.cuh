// The dot precision of the vocoder's conv kernels (B, C, D, E), the port of
// the JAX kernels' dot_dtype (flowhigh_tpu/ops/packed.py:164-181; the rules
// and the int8 windows: flowhigh_tpu_torch/ops/quant.py):
//
//   F32   f32 operands, f32 FMA;
//   BF16  both operands rounded to bf16 (nearest even), f32 FMA: a bf16 x
//         bf16 product is exact in f32, so this is the JAX kernel's bf16
//         dot with f32 accumulation;
//   I8    weights quantised per output channel on the host (values in
//         [-127, 127] and an f32 scale), the activation quantised in the
//         kernel with one scale per window (aq = rint(a * (127 / amax))),
//         integer sums (exact in any order: K Cin 127^2 < 2^31), then
//         float(acc) * (s_x * s_w[co]). Kernels B, D and E sum on the
//         tensor cores (s8 mma.sync, int8 operands; mma_sm90.cuh), each
//         window's amax from a pre-pass launch that writes partial maxima
//         (window_quant below reduces them).
//
// The tensor-core kernels (B's GEMM route, C, D, E) stage bf16 and int8
// operands in their own types.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

enum class Dot { F32 = 0, BF16 = 1, I8 = 2 };

template <Dot D>
using Acc = typename std::conditional<D == Dot::I8, int, float>::type;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the dequantised sum of one output: float(acc) * (s_x * s_w), the
// product kept apart from the epilogue's adds (no FMA contraction), as the
// JAX kernel's separate multiply
__device__ __forceinline__ float dequant(int acc, float fac) {
  return __fmul_rn(__int2float_rn(acc), fac);
}
__device__ __forceinline__ float dequant(float acc, float) { return acc; }

// an activation value's int8 quantum, qs = 127 / amax: rint(v * qs), half
// to even
__device__ __forceinline__ int quantize(float v, float qs) {
  return __float2int_rn(v * qs);
}

// The int8 activation scale of one window: 127 / amax and amax / 127 with
// amax = max(largest |a|, 1e-30), as the JAX package's _quant_tile.
struct Quant {
  float qs;  // 127 / amax
  float sx;  // amax / 127
};

__device__ __forceinline__ Quant quant_of(float amax) {
  amax = fmaxf(amax, 1e-30f);
  return {127.0f / amax, amax / 127.0f};
}

// The largest v over the block (every thread passes its own partial max of
// values >= 0); all threads get it. ``red`` is 32 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = (blockDim.x + 31) / 32;
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < n_warps ? red[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The int8 scale of one window: the largest of its n_groups pre-pass
// partials at part[0 .. n_groups). Every thread of the block gets it.
__device__ __forceinline__ Quant window_quant(const float* __restrict__ part,
                                              int n_groups, float* red) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_groups; i += blockDim.x)
    m = fmaxf(m, part[i]);
  return quant_of(block_max(m, red));
}

}  // namespace
