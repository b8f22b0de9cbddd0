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
//
// The storage type of the feature maps (vocoder_storage_dtype), a second
// parameter beside Dot: the JAX kernels load their rows and residuals into
// f32 and store in the input's dtype (flowhigh_tpu/ops/packed.py:668-670,
// :684-689; ops/fused_act.py io_dtype). Kernels A, B, D and E take
//   F32   float maps;
//   BF16  __nv_bfloat16 maps: every load widens to f32 (exact), the kernel
//         computes and accumulates in f32 as the F32 instance does, and the
//         one stored map rounds to nearest even (__float2bfloat16_rn).
// So an instance with BF16 storage is its F32-storage instance on the
// widened inputs, rounded once at the store.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

enum class Dot { F32 = 0, BF16 = 1, I8 = 2 };
enum class Store { F32 = 0, BF16 = 1 };

template <Store S>
using StoreT =
    typename std::conditional<S == Store::BF16, __nv_bfloat16, float>::type;

template <Dot D>
using Acc = typename std::conditional<D == Dot::I8, int, float>::type;

// --- loads and stores of a map element, in f32 --------------------------------

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float((unsigned)u << 16);
}
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return bf16_bits(*reinterpret_cast<const unsigned short*>(p));
}
// through the read-only cache
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive elements at p, which is aligned to four elements (16
// bytes f32, 8 bytes bf16).
__device__ __forceinline__ float4 unpack_bf16x4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* p) {
  return unpack_bf16x4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 ldg4_f32(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4_f32(const __nv_bfloat16* p) {
  return unpack_bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}
// lo and hi rounded to bf16, lo in the low half
__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void store4_f32(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4_f32(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16x2_bits(v.x, v.y), bf16x2_bits(v.z, v.w));
}

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
