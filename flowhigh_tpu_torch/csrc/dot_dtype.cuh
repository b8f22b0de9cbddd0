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
//         float(acc) * (s_x * s_w[co]). Kernels D and E sum on the tensor
//         cores (s8 mma.sync, int8 operands; act_conv_core.cuh), kernel
//         B.int8 by int32 multiply-adds on the FMA units.
//
// The tensor-core kernels (B's GEMM route, C, D, E) stage bf16 and int8
// operands in their own types; kernel B.int8 (conv1d_same.cu) stages its
// int8 operands as int32 values (bits_as, mad below).

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

// the staged 4-byte value of an operand (an int32 for I8, by its bits)
template <class T>
__device__ __forceinline__ T bits_as(float f);
template <>
__device__ __forceinline__ float bits_as<float>(float f) { return f; }
template <>
__device__ __forceinline__ int bits_as<int>(float f) {
  return __float_as_int(f);
}

__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ int mad(int a, int b, int c) { return a * b + c; }

// the dequantised sum of one output: float(acc) * (s_x * s_w), the
// product kept apart from the epilogue's adds (no FMA contraction), as the
// JAX kernel's separate multiply
__device__ __forceinline__ float dequant(int acc, float fac) {
  return __fmul_rn(__int2float_rn(acc), fac);
}
__device__ __forceinline__ float dequant(float acc, float) { return acc; }

// an activation value as the dot of D stages it: rounded to bf16, or
// quantised with qs = 127 / amax (its int32 bits)
template <Dot D>
__device__ __forceinline__ float stage_value(float v, float qs) {
  if constexpr (D == Dot::BF16) return round_bf16(v);
  if constexpr (D == Dot::I8) return __int_as_float(__float2int_rn(v * qs));
  return v;
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

}  // namespace
