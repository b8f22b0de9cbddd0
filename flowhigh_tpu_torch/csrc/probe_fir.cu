// Kernel H: the anti-aliased activation's FIRs as matrix products,
//   s2  = sum_q xe[r + q] @ up[q + 1]      r in [-1, S + 1), q in {-1, 0, 1}
//   s2  = snake(s2)                         (when SNAKE; a, b = ab2)
//   out = sum_q s2[r + q] @ dn[q + 1]       r in [0, S)
// over x [B, S, L] (lanes last), up [3, L, 2L], dn [3, 2L, L], ab2 [2, 2L],
// with xe = x extended along S by the clamped 8-row neighbour blocks:
// xe[r] = x[r + 8] for r < 0 and x[r - 8] for r >= S. Interior tile seams
// see the true neighbours, so the function does not depend on the tile.
// The BF16 instance rounds xe and s2 to bf16 (nearest even) before their
// products and sums in f32; up and dn come as bf16.
//
// Replaces the Pallas probe kernel scripts/bench_act_mxu.py:mxu_fir (its
// pallas_call at :102; the halo index maps at :109-115): the up/down FIRs
// of kernel A moved onto the matrix unit. It is called by the probe script
// (scripts/port_bench_act_mxu.py) and chip_smoke.py, no model path.
//
// Bound: operations, 24 S L^2 (12 L^2 per row for each product): at the
// f32 FMA peak for F32 (no TF32, so it meets f32 parity), at the bf16
// tensor-core peak for BF16. Design: a back-to-back GEMM with the snake in
// between, as flash attention with the snake for the softmax. A block owns
// TM = 62 output rows; it keeps its xe rows (TM + 4) in shared memory for
// its whole life and walks the 2L intermediate columns in chunks of NC = 64:
//   GEMM1  the chunk of s2 for its 64 = TM + 2 rows (a one-row halo each
//          side), K = 3 L, over k-slices of up;
//   snake, rounding, into shared memory (s2 never reaches device memory);
//   GEMM2  fold the chunk into the [64, L] output accumulator, held in
//          registers across the chunks, K = 3 NC, over k-slices of dn.
// The weight slices stream through a double buffer with cp.async. Warp w
// owns rows 16 (w % 4) .. + 16 and half the columns (w / 4) of each
// product, as m16n8 tiles: BF16 issues mma.sync.m16n8k16 bf16 -> f32 on
// fragments loaded by ldmatrix; F32 computes the same fragment of each
// tile with FMAs from shared memory. L % 64 == 0 and L <= 384 (the
// registers of the accumulator); the script's width is 384.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "snake.cuh"

namespace {

constexpr int THREADS = 256;     // 8 warps
constexpr int M1 = 64;           // s2 rows per block
constexpr int TM = M1 - 2;       // output rows per block
constexpr int XR = M1 + 2;       // xe rows per block
constexpr int NC = 64;           // intermediate columns per chunk
constexpr int KS1 = 64;          // k-slice of GEMM1
constexpr int MAX_L = 384;
constexpr int MAX_NT2 = MAX_L / 16;  // n-tiles of a warp in GEMM2

template <bool BF16>
struct Cfg {
  using E = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  static constexpr int EPC = 16 / sizeof(E);  // elements per 16 bytes
  static constexpr int PAD = EPC;             // row padding: 16 bytes
  static constexpr int KS2 = BF16 ? 32 : 16;  // k-slice of GEMM2
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] (n-tile j of 8 columns at n0 + 8 j; j < nt, NT the most) +=
// A[r0 .. r0 + 16, k0 .. k0 + K] @ B[0 .. K, n0 + 8 j ..]: the warp's m16
// tile against nt n-tiles. A: row-major, stride lda; B: [k][n], stride ldb.
// Thread (g = lane / 4, t = lane % 4) owns acc[j] = (row g, cols 2t, 2t+1),
// (row g + 8, cols 2t, 2t+1): mma.sync's accumulator fragment.
template <int NT, int K>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], int nt,
                                         const __nv_bfloat16* A, int lda,
                                         int r0, int k0,
                                         const __nv_bfloat16* B, int ldb,
                                         int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    unsigned a[4];
    ldmatrix_x4(a, A + (r0 + (lane & 15)) * lda + k0 + kk + (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      if (2 * p >= nt) break;
      unsigned b[4];
      ldmatrix_x4_trans(
          b, B + (kk + (lane & 15)) * ldb + n0 + 16 * p + (lane >> 4) * 8);
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

template <int NT, int K>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], int nt,
                                         const float* A, int lda, int r0,
                                         int k0, const float* B, int ldb,
                                         int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* alo = A + (r0 + g) * lda + k0;
  const float* ahi = alo + 8 * lda;
  const float* bk = B + n0 + 2 * t;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    const float lo = alo[kk], hi = ahi[kk];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      const float2 b = *reinterpret_cast<const float2*>(bk + kk * ldb + 8 * j);
      acc[j][0] = fmaf(lo, b.x, acc[j][0]);
      acc[j][1] = fmaf(lo, b.y, acc[j][1]);
      acc[j][2] = fmaf(hi, b.x, acc[j][2]);
      acc[j][3] = fmaf(hi, b.y, acc[j][3]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  store2(p, v.x, v.y);
  store2(p + 2, v.z, v.w);
}

template <bool BF16, bool SNAKE>
__global__ void __launch_bounds__(THREADS, 1)
mxu_fir_kernel(const float* __restrict__ x,
               const typename Cfg<BF16>::E* __restrict__ up,
               const typename Cfg<BF16>::E* __restrict__ dn,
               const float* __restrict__ ab2, float* __restrict__ out, int S,
               int L) {
  using C = Cfg<BF16>;
  using E = typename C::E;
  constexpr int KS2 = C::KS2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda_x = L + C::PAD;   // xs [XR][L + PAD]
  const int lda_s = NC + C::PAD;  // s2s [XR][NC + PAD]
  const int ldb1 = NC + C::PAD;   // a GEMM1 slice [KS1][NC + PAD]
  const int ldb2 = L + C::PAD;    // a GEMM2 slice [KS2][L + PAD]
  const int wsz = max(KS1 * ldb1, KS2 * ldb2);
  E* xs = reinterpret_cast<E*>(smem);
  E* s2s = xs + XR * lda_x;
  E* wb[2] = {s2s + XR * lda_s, s2s + XR * lda_s + wsz};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * TM;  // first output row
  const long long bofs = (long long)blockIdx.y * S * L;
  const int L2 = 2 * L;

  // xe rows r0 - 2 .. r0 + 64 (local j = r - r0 + 2), rounded for BF16
  const int l4 = L / 4;
  for (int idx = tid; idx < XR * l4; idx += THREADS) {
    const int j = idx / l4, k = (idx - j * l4) * 4;
    int r = r0 - 2 + j;
    r = r < 0 ? r + 8 : (r >= S ? min(r - 8, S - 1) : r);
    store4(xs + j * lda_x + k,
           *reinterpret_cast<const float4*>(x + bofs + (long long)r * L + k));
  }
  // s2s rows 64, 65 feed only the tile's two unused output rows
  for (int idx = tid; idx < NC; idx += THREADS)
    store2(s2s + (M1 + idx / (NC / 2)) * lda_s + 2 * (idx % (NC / 2)), 0.0f,
           0.0f);

  // the slices: per chunk, 3 L / KS1 of up, then 3 NC / KS2 of dn
  const int kb1n = L / KS1, n1 = 3 * kb1n;
  const int kb2n = NC / KS2, n2 = 3 * kb2n;
  const int per_chunk = n1 + n2, total = (L2 / NC) * per_chunk;
  auto issue = [&](int s, E* buf) {
    const int c = s / per_chunk, j = s - c * per_chunk;
    if (j < n1) {
      const int q = j / kb1n, kb = (j - q * kb1n) * KS1;
      const E* src = up + ((long long)q * L + kb) * L2 + c * NC;
      constexpr int cpr = NC / C::EPC;
      for (int idx = tid; idx < KS1 * cpr; idx += THREADS) {
        const int r = idx / cpr, ch = idx - r * cpr;
        cp_async16(buf + r * ldb1 + ch * C::EPC,
                   src + (long long)r * L2 + ch * C::EPC);
      }
    } else {
      const int j2 = j - n1, q = j2 / kb2n, kb = (j2 - q * kb2n) * KS2;
      const E* src = dn + ((long long)q * L2 + c * NC + kb) * L;
      const int cpr = L / C::EPC;
      for (int idx = tid; idx < KS2 * cpr; idx += THREADS) {
        const int r = idx / cpr, ch = idx - r * cpr;
        cp_async16(buf + r * ldb2 + ch * C::EPC,
                   src + (long long)r * L + ch * C::EPC);
      }
    }
  };

  float acc1[4][4];       // the warp's 16 x 32 of the s2 chunk
  float acc2[MAX_NT2][4]; // the warp's 16 x L/2 of the output
  const int nt2 = L / 16;
#pragma unroll
  for (int j = 0; j < MAX_NT2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[j][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[j][e] = 0.0f;

  issue(0, wb[0]);
  cp_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) {
      issue(s + 1, wb[(s + 1) & 1]);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const E* buf = wb[s & 1];
    const int c = s / per_chunk, j = s - c * per_chunk;
    if (j < n1) {
      // GEMM1: s2 local row m reads xs local row m + q
      const int q = j / kb1n, kb = (j - q * kb1n) * KS1;
      tile_mma<4, KS1>(acc1, 4, xs, lda_x, wm * 16 + q, kb, buf, ldb1,
                       wn * 32, lane);
      if (j == n1 - 1) {
        // the chunk of s2 is complete: snake, round, to shared memory
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
          const int nl = wn * 32 + 8 * jt + 2 * t;
          float v[4] = {acc1[jt][0], acc1[jt][1], acc1[jt][2], acc1[jt][3]};
          if (SNAKE) {
            const int n = c * NC + nl;
            const float a0 = ab2[n], a1 = ab2[n + 1];
            const float i0 = 1.0f / (ab2[L2 + n] + 1e-9f);
            const float i1 = 1.0f / (ab2[L2 + n + 1] + 1e-9f);
            v[0] = snake_fn(v[0], a0, i0);
            v[1] = snake_fn(v[1], a1, i1);
            v[2] = snake_fn(v[2], a0, i0);
            v[3] = snake_fn(v[3], a1, i1);
          }
          const int m = wm * 16 + g;
          store2(s2s + m * lda_s + nl, v[0], v[1]);
          store2(s2s + (m + 8) * lda_s + nl, v[2], v[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc1[jt][e] = 0.0f;
        }
      }
    } else {
      // GEMM2: output local row i reads s2s local row i + q
      const int j2 = j - n1, q = j2 / kb2n, kb = (j2 - q * kb2n) * KS2;
      tile_mma<MAX_NT2, KS2>(acc2, nt2, s2s, lda_s, wm * 16 + q, kb, buf,
                             ldb2, wn * (L / 2), lane);
    }
    __syncthreads();
  }

  float* ob = out + bofs;
#pragma unroll
  for (int jt = 0; jt < MAX_NT2; ++jt) {
    if (jt >= nt2) break;
    const int n = wn * (L / 2) + 8 * jt + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wm * 16 + g + 8 * h;
      if (i < TM && r0 + i < S)
        store2(ob + (long long)(r0 + i) * L + n, acc2[jt][2 * h],
               acc2[jt][2 * h + 1]);
    }
  }
}

template <bool BF16>
size_t smem_bytes(int L) {
  using C = Cfg<BF16>;
  const size_t w = std::max(KS1 * (NC + C::PAD), C::KS2 * (L + C::PAD));
  return sizeof(typename C::E) *
         ((size_t)XR * (L + C::PAD) + (size_t)XR * (NC + C::PAD) + 2 * w);
}

template <bool BF16, bool SNAKE>
int launch(const float* x, const void* up, const void* dn, const float* ab2,
           float* out, int B, int S, int L, void* stream) {
  if (B <= 0 || B > 65535 || S < 8 || L <= 0 || L % 64 != 0 || L > MAX_L)
    return (int)cudaErrorInvalidValue;
  using E = typename Cfg<BF16>::E;
  const size_t bytes = smem_bytes<BF16>(L);
  auto kernel = mxu_fir_kernel<BF16, SNAKE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + TM - 1) / TM, B);
  kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      x, static_cast<const E*>(up), static_cast<const E*>(dn), ab2, out, S, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B, S, L] float32; up [3, L, 2L], dn [3, 2L, L] float32 (f32
// entries) or bfloat16 (bf16 entries); ab2 [2, 2L] float32 (read only by
// the snake entries). 16-byte aligned, contiguous. S >= 8, L % 64 == 0,
// L <= 384. Return cudaGetLastError() after the launch.
extern "C" int mxu_fir_f32(const float* x, const void* up, const void* dn,
                           const float* ab2, float* out, int B, int S, int L,
                           void* stream) {
  return launch<false, true>(x, up, dn, ab2, out, B, S, L, stream);
}
extern "C" int mxu_fir_f32_dots(const float* x, const void* up,
                                const void* dn, const float* ab2, float* out,
                                int B, int S, int L, void* stream) {
  return launch<false, false>(x, up, dn, ab2, out, B, S, L, stream);
}
extern "C" int mxu_fir_bf16(const float* x, const void* up, const void* dn,
                            const float* ab2, float* out, int B, int S, int L,
                            void* stream) {
  return launch<true, true>(x, up, dn, ab2, out, B, S, L, stream);
}
extern "C" int mxu_fir_bf16_dots(const float* x, const void* up,
                                 const void* dn, const float* ab2, float* out,
                                 int B, int S, int L, void* stream) {
  return launch<true, false>(x, up, dn, ab2, out, B, S, L, stream);
}
