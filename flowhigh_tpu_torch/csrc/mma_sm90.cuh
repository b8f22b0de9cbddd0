// Warp-level tensor-core and asynchronous-copy helpers for sm_90a (mma.sync
// on bf16, tf32 and s8, ldmatrix, cp.async) and the 3xTF32 split, shared by
// the kernels that run their dot products on the tensor cores: kernel B's
// GEMM route (csrc/conv1d_same.cu), kernel C (csrc/conv_transpose1d.cu),
// the act->conv core of kernels D and E (csrc/act_conv_core.cuh), kernel F
// (csrc/flash_attn.cu) and kernel H's f32 instances (csrc/probe_fir.cu;
// its bf16 ones run on wgmma, csrc/wgmma_sm90.cuh). B and C stage
// a chunk of KC input channels at a time: the weights as rows of 32 bytes
// (one tap and output channel, KC = 8 f32, 16 bf16 or 32 int8 channels),
// and x as f32 rows [frame][XS] (the chunk's channels of one frame, padded
// to XS), and load their weight fragments with the a_frag_* helpers below.
// The s8 GEMMs (B.int8, D.int8, E.int8) keep their int8 operand as 32-byte
// rows (i8_offset) and run a tap with mma_tap_s8.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16 / m16n8k8 /
// m16n8k32"), for lane = 4 g + t (g = lane / 4 in [0, 8), t = lane % 4):
//   m16n8k16 bf16   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..),
//                   a2 (g, 2t+8..), a3 (g+8, 2t+8..), two bf16 a register
//                   (the lower k in the low half); B (16 x 8, "col": k
//                   contiguous for one n): b0 (k 2t..2t+1, n g), b1 (k
//                   2t+8..2t+9, n g);
//   m16n8k32 s8     the same bytes: A (16 x 32): a0 (g, 4t..4t+3), a1 (g+8,
//                   4t..), a2 (g, 4t+16..), a3 (g+8, 4t+16..), four int8 a
//                   register; B (32 x 8): b0 (k 4t..4t+3, n g), b1 (k
//                   4t+16..4t+19, n g); so a 32-byte row of 32 int8 is
//                   loaded as a 16-bf16 row is (ldmatrix);
//   m16n8k8 tf32    A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
//                   a3 (g+8, t+4); B (8 x 8): b0 (k t, n g), b1 (k t+4, n g);
//   accumulator     c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, the same
//                   cols), f32 (s32 for s8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// --- asynchronous copies, global -> shared ------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes, both addresses 16-byte aligned; bypasses L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// 16 bytes, as cp_async16; writes zeros (and reads nothing) when !valid;
// ``src`` must be a valid address all the same
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes; writes 0.0f (and reads nothing) when !valid; ``src`` must be a
// valid address all the same
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// 8 bytes, both addresses 8-byte aligned; zeros when !valid
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// bf16 feature maps: cp.async moves 4 bytes at least, two bf16 values. One
// value is staged as the aligned 4-byte word that holds it, into its f32
// slot (zeros when !valid), and widened in place, by the thread that staged
// it, once it has landed: bf16_half_to_f32 takes the half that the value's
// address names (its bit 1: bf16_parity of the row's base and the element
// index, in 32-bit arithmetic, of which only the low bit counts). So the
// copy stays asynchronous and takes no registers while it is in flight.
__device__ __forceinline__ void cp_async_bf16_word(float* dst,
                                                   const __nv_bfloat16* src,
                                                   bool valid) {
  cp_async4_zfill(dst,
                  reinterpret_cast<const void*>(
                      reinterpret_cast<unsigned long long>(src) & ~3ull),
                  valid);
}
// 1 where element ``index`` of the bf16 array at ``base`` is a word's high
// half
__device__ __forceinline__ unsigned bf16_parity(const __nv_bfloat16* base,
                                                unsigned index) {
  return ((unsigned)(reinterpret_cast<unsigned long long>(base) >> 1) +
          index) & 1u;
}
__device__ __forceinline__ float bf16_half_to_f32(float word, unsigned hi) {
  const unsigned u = __float_as_uint(word);
  return __uint_as_float(hi ? (u & 0xffff0000u) : (u << 16));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- fragments ----------------------------------------------------------------

// four 8 x 8 b16 matrices; lane l gives the address of row (l % 8) of
// matrix l / 8 (16 bytes, 16-byte aligned)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two f32 -> one register of two bf16, each rounded to nearest even; ``lo``
// in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// --- the 3xTF32 split -------------------------------------------------------------

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as the bits of an f32
__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo + (a remainder below 2^-22 |v|), hi and lo TF32 values
__device__ __forceinline__ void tf32_split(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// v = hi + lo exactly: hi is v rounded to TF32, to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds a finite v (here two integer
// operations on the bits, where ptxas makes the cvt four); lo is the f32
// remainder, of which the tensor cores take the top 19 bits (TF32 by
// truncation: below 2^-21 |v| is lost, against 2^-22 with tf32_split's
// rounded lo, at one conversion less)
__device__ __forceinline__ void split_hi(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// --- products -----------------------------------------------------------------

// c += a b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, m16n8k8, tf32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, m16n8k32, int8 operands, int32 accumulator: exact (no rounding,
// any order) while the sums stay below 2^31
__device__ __forceinline__ void mma_s8_16832(int (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to f32 accuracy with three TF32 products (the small ones first):
// a_lo b_hi + a_hi b_lo + a_hi b_hi; the omitted a_lo b_lo is below
// 2^-22 |a b|. The tensor cores round their sums toward zero, which biases
// a long chain of products by about half an ulp of c a step (1.2e-4 at
// Cin 1536 measured on an H100 where c took the whole sum), so the three
// products go into a fresh accumulator and reach c through f32 adds that
// round to nearest, as an FMA loop's would.
__device__ __forceinline__ void mma_3xtf32_1688(float (&c)[4],
                                                const unsigned (&ahi)[4],
                                                const unsigned (&alo)[4],
                                                unsigned bhi0, unsigned bhi1,
                                                unsigned blo0, unsigned blo1) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32_1688(d, alo, bhi0, bhi1);
  mma_tf32_1688(d, ahi, blo0, blo1);
  mma_tf32_1688(d, ahi, bhi0, bhi1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], d[e]);
}

// --- the conv kernels' staged operands --------------------------------------------

// Weight rows of 32 bytes are stored unpadded with their two 16-byte halves
// swapped when (row / 4) is odd: the element offset of half ``half`` (of
// ``eps`` elements) of row ``row``. Fragment loads are then free of bank
// conflicts.
__device__ __forceinline__ int w_row_offset(int row, int half, int eps) {
  return row * 2 * eps + (half ^ ((row >> 2) & 1)) * eps;
}

// A fragment (m16 x k16) of bf16 weights: rows row0 .. row0 + 15 (row0 a
// multiple of 16) of a weight stage of 16-channel rows
__device__ __forceinline__ void a_frag_bf16(unsigned (&a)[4],
                                            const __nv_bfloat16* ws,
                                            int row0, int lane) {
  // lane l gives row row0 + l % 16, half l / 16
  ldmatrix_x4(a, ws + w_row_offset(row0 + (lane & 15), lane >> 4, 8));
}

// A fragment (m16 x k32) of int8 weights: rows row0 .. row0 + 15 (row0 a
// multiple of 16) of a weight stage of 32-channel rows
__device__ __forceinline__ void a_frag_s8(unsigned (&a)[4],
                                          const signed char* ws, int row0,
                                          int lane) {
  ldmatrix_x4(a, ws + w_row_offset(row0 + (lane & 15), lane >> 4, 16));
}

// A fragment (m16 x k8) of f32 weights, split into TF32 hi and lo: rows
// row0 + g and + 8 (row0 a multiple of 16, so both share (row / 4) % 2),
// channels t and t + 4 of a weight stage of 8-channel rows
__device__ __forceinline__ void a_frag_3xtf32(unsigned (&ah)[4],
                                              unsigned (&al)[4],
                                              const float* ws, int row0,
                                              int g, int t) {
  const int sw = ((g >> 2) & 1) * 4;
  const float* wr = ws + (row0 + g) * 8;
  tf32_split(wr[t ^ sw], ah[0], al[0]);
  tf32_split(wr[64 + (t ^ sw)], ah[1], al[1]);
  tf32_split(wr[(t + 4) ^ sw], ah[2], al[2]);
  tf32_split(wr[64 + ((t + 4) ^ sw)], ah[3], al[3]);
}

// --- the s8 GEMMs' x or activation operand ------------------------------------------

// Byte offset of channel ci (< 32) of frame j in int8 rows (one 32-channel
// chunk of an s8 GEMM's x or activation): 32 bytes a frame, the two
// 16-byte halves swapped where (j / 4) is odd. The 8 rows an ldmatrix
// reads, frames f .. f + 7 at one half, then fall in 8 distinct 4-bank
// groups for any f.
__device__ __forceinline__ int i8_offset(int j, int ci) {
  return j * 32 + ((((ci >> 4) ^ (j >> 2)) & 1) << 4) + (ci & 15);
}

// One tap of an I8 GEMM (s8 mma.sync): acc[i][n] += W[rows (wm MT + i) 16
// ..][32 channels] x A[frames f0 + 8 n ..][32 channels], with ws a weight
// stage of 32-byte rows (w_row_offset) and act int8 rows (i8_offset) of
// one 32-channel chunk; f0 = the warp's first frame plus the tap's offset.
template <int MT, int NT8>
__device__ __forceinline__ void mma_tap_s8(int (&acc)[MT][NT8][4],
                                           const signed char* ws,
                                           const unsigned char* act, int f0,
                                           int wm, int lane) {
  static_assert(NT8 % 2 == 0, "x for two n-tiles a load");
  unsigned a[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) a_frag_s8(a[i], ws, (wm * MT + i) * 16, lane);
  // ldmatrix.x4 rows, lane l: frame f0 + (n + l / 16) 8 + l % 8, half
  // (l / 8) % 2: b0, b1 of n-tiles n, n + 1
  const int h = (lane >> 3) & 1;
  const int f1 = f0 + ((lane >> 4) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int n = 0; n < NT8; n += 2) {
    const int f = f1 + n * 8;
    unsigned bq[4];
    ldmatrix_x4(bq, act + f * 32 + (((h ^ (f >> 2)) & 1) << 4));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_s8_16832(acc[i][n], a[i], bq[0], bq[1]);
      mma_s8_16832(acc[i][n + 1], a[i], bq[2], bq[3]);
    }
  }
}

}  // namespace
