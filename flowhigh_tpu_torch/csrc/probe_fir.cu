// Kernel H: the anti-aliased activation's FIRs as matrix products,
//   s2  = sum_q xe[r + q] @ up[q + 1]      r in [-1, S + 1), q in {-1, 0, 1}
//   s2  = snake(s2)                         (when SNAKE; a, b = ab2)
//   out = sum_q s2[r + q] @ dn[q + 1]       r in [0, S)
// over x [B, S, L] (lanes last), up [3, L, 2L], dn [3, 2L, L], ab2 [2, 2L],
// with xe = x extended along S by the clamped 8-row neighbour blocks:
// xe[r] = x[r + 8] for r < 0 and x[r - 8] for r >= S. Interior tile seams
// see the true neighbours, so the function does not depend on the tile.
// The BF16 instances round xe and s2 to bf16 (nearest even) before their
// products and sum in f32; up and dn come as bf16.
//
// Replaces the Pallas probe kernel scripts/bench_act_mxu.py:mxu_fir (its
// pallas_call at :102; the halo index maps at :109-115): the up/down FIRs
// of kernel A moved onto the matrix unit. It is called by the probe script
// (scripts/port_bench_act_mxu.py) and chip_smoke.py, no model path.
//
// Bound: operations, 24 S L^2 (12 L^2 per row for each product), on the
// tensor cores: in 3xTF32 (three TF32 products per f32 one) for the F32
// instances, at the bf16 rate for BF16. Both designs are a back-to-back
// GEMM with the snake in between, as flash attention has the softmax: a
// block walks the 2L intermediate columns in chunks of NC = 128: GEMM1
// gives the chunk of s2 for its rows (K = 3 L), the snake and the rounding
// put it into shared memory (s2 never reaches device memory), GEMM2 folds
// it into the output accumulator (K = 3 NC), which stays in registers
// across the chunks. The weights stream through a ring of slices. A FIR
// tap q is a row shift of the A operand, never a copy.
//
// F32 (fir_tf32_kernel, one instance per L): 64 rows of s2 (62 output
// rows) a block of 8 warps, each warp 32 rows (two m16 tiles) and a
// quarter of the columns of each product, on mma.sync m16n8k8 in 3xTF32
// (the operand splits of kernel F: hi rounded, lo as the tensor cores
// truncate it). Each 16-wide k-chunk of either product goes into a fresh
// accumulator, six products, joined to the sum by an f32 add: the tensor
// cores round their own sums toward zero. Within a k-step, fragment
// position t takes k = 2t and t + 4 takes 2t + 1, so one 8-byte shared
// load gives a lane both of its A values from the block's xe rows (kept
// for the block's life, rows of L + 8 floats) or s2 (NC + 8), free of bank
// conflicts. A prep kernel (fir_pack_f32_kernel) writes up and dn into the
// caller's scratch as the slices in the order they are read, each in mma
// fragment order (one 16-byte load a lane for a k-chunk's B fragments);
// one bulk copy by one thread fills a slot of a three-slot ring, counted
// by an mbarrier. The warps run apart: each waits only for its slice to
// land, and a slot is refilled once all eight have arrived on its "empty"
// mbarrier; one barrier a chunk, after s2 is written.
//
// BF16 (fir_wgmma_kernel): a cluster of two blocks shares 128 rows of s2
// (126 output rows); block h of the pair computes columns h NC / 2 .. of
// each chunk of s2 and writes them, snaked and rounded, into its own and
// its peer's shared memory, and computes output columns h L / 2 .. from the
// whole chunk. Each block so streams half of up and dn for 128 rows: the
// weights cross L2 once per 126 output rows, not per 62. In a block, two
// warpgroups own 64 rows each and run both products as wgmma (bf16, f32
// accumulators, both operands from shared memory, csrc/wgmma_sm90.cuh):
// xe and s2 stored K-major without swizzle as [K / 8][rows][8], so a FIR
// tap is the descriptor's start address plus 16 bytes a row; the weight
// slices K-major with the 128-byte swizzle. A prep kernel (fir_pack_kernel)
// writes each block's half of up and dn into the caller's scratch as the
// slices themselves, in the order they are read, so one bulk copy by one
// thread fills a ring slot and an mbarrier counts its bytes: the copies
// write through the async proxy that wgmma reads by, and no thread touches
// a weight. Four slots, two slices in flight, one barrier a slice, one
// group of wgmma left running across it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"
#include "snake.cuh"
#include "wgmma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // 8 warps, two warpgroups
constexpr int MAX_L = 384;    // the output accumulator's registers
constexpr int NC = 128;       // intermediate columns a chunk

// the global row of xe row r (r in [-2, S + 66)): the clamped neighbour
// blocks at the ends; rows past S + 1 feed only rows that are not stored
__device__ __forceinline__ int xe_row(int r, int S) {
  return r < 0 ? r + 8 : (r >= S ? min(r - 8, S - 1) : r);
}

// the snake's a and 1 / (b + 1e-9) of intermediate columns n, n + 1
struct SnakePair {
  float a0, a1, i0, i1;
  SnakePair() = default;
  __device__ __forceinline__ SnakePair(const float* ab2, int n, int L2)
      : a0(ab2[n]), a1(ab2[n + 1]), i0(1.0f / (ab2[L2 + n] + 1e-9f)),
        i1(1.0f / (ab2[L2 + n + 1] + 1e-9f)) {}
  // v = {(m, n), (m, n + 1), (m + 8, n), (m + 8, n + 1)}
  __device__ __forceinline__ void apply(float* v) const {
    v[0] = snake_fn(v[0], a0, i0);
    v[1] = snake_fn(v[1], a1, i1);
    v[2] = snake_fn(v[2], a0, i0);
    v[3] = snake_fn(v[3], a1, i1);
  }
};

// --- F32: 3xTF32 on mma.sync --------------------------------------------------

namespace f32k {

constexpr int M1 = 64;        // s2 rows a block
constexpr int TM = M1 - 2;    // output rows a block
constexpr int XR = M1 + 2;    // xe rows a block
constexpr int KS1 = 32;       // k-rows of up a slice
constexpr int KS2 = 16;       // k-rows of dn a slice
constexpr int STAGES = 3;

// floats: x and s2 rows (A operands)
__host__ __device__ constexpr int ldx(int L) { return L + 8; }
constexpr int LDS = NC + 8;
// A slice holds its weights in fragment order: per 16-wide k-chunk u and
// n-tile jn (8 columns), 32 lanes x 4 floats, lane 4 g + t holding rows 2t,
// 2t + 1, 2t + 8, 2t + 9 of column 8 jn + g: the B fragments (b0, b1) of
// the chunk's two k-steps, one 16-byte load. GEMM1 slices are [KS1][NC]
// of up, GEMM2 slices [KS2][L] of dn.
constexpr int B1 = KS1 * NC;
__host__ __device__ constexpr int b2(int L) { return KS2 * L; }
__host__ __device__ constexpr int stage_floats(int L) {
  return B1 > b2(L) ? B1 : b2(L);
}
// the slices of a chunk: 3 L / KS1 of up, then 3 NC / KS2 of dn
__host__ __device__ constexpr int n1(int L) { return 3 * (L / KS1); }
constexpr int KB2N = NC / KS2, N2 = 3 * KB2N;
__host__ __device__ constexpr size_t chunk_floats(int L) {
  return (size_t)n1(L) * B1 + (size_t)N2 * b2(L);
}
// up and dn as the slices, in the order the blocks read them (the caller's
// scratch): 12 L^2 floats
__host__ __device__ constexpr size_t image_bytes(int L) {
  return sizeof(float) * (size_t)(2 * L / NC) * chunk_floats(L);
}
constexpr int BARS = 64;  // bytes for the ring's mbarriers
__host__ __device__ constexpr size_t smem_bytes(int L) {
  return BARS + sizeof(float) * ((size_t)XR * ldx(L) + (size_t)XR * LDS +
                                 (size_t)STAGES * stage_floats(L));
}

// The prep kernel: up [3][L][2L] and dn [3][2L][L] (f32) into the slice
// image (image_bytes(L)), each slice in fragment order. A thread writes 16
// bytes (one lane's fragments of a k-chunk and n-tile); grid (3 L^2 / 256),
// 256 threads.
__global__ void fir_pack_f32_kernel(const float* __restrict__ up,
                                    const float* __restrict__ dn,
                                    float* __restrict__ img, int L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3LL * L * L) return;
  const int L2 = 2 * L, kb1n = L / KS1;
  const long long cf = (long long)chunk_floats(L) / 4;  // 16-byte units
  const int c = (int)(i / cf);
  long long w = i - c * cf;
  const float* src;
  int ld, nt;  // source row length; n-tiles of the slice
  if (w < (long long)n1(L) * B1 / 4) {  // GEMM1 slice j: up[q][kb ..][c NC ..]
    const int j = (int)(w / (B1 / 4));
    w -= (long long)j * (B1 / 4);
    const int q = j / kb1n, kb = (j % kb1n) * KS1;
    src = up + ((long long)q * L + kb) * L2 + c * NC;
    ld = L2;
    nt = NC / 8;
  } else {  // GEMM2 slice: dn[q][c NC + kb ..][..]
    w -= (long long)n1(L) * B1 / 4;
    const int j2 = (int)(w / (b2(L) / 4));
    w -= (long long)j2 * (b2(L) / 4);
    const int q = j2 / KB2N, kb = (j2 % KB2N) * KS2;
    src = dn + ((long long)q * L2 + c * NC + kb) * L;
    ld = L;
    nt = L / 8;
  }
  const int lane = (int)(w & 31), jn = (int)((w >> 5) % nt);
  const int u = (int)((w >> 5) / nt);  // the k-chunk within the slice
  const int g = lane >> 2, t = lane & 3;
  const float* col = src + (long long)(16 * u + 2 * t) * ld + 8 * jn + g;
  *reinterpret_cast<float4*>(img + 4 * i) =
      make_float4(col[0], col[ld], col[8 * ld], col[9 * ld]);
}

// acc[i][j] += A[rows 16 i + g, + 8][K] B[K][n-tile j] for the warp's two
// m16 tiles and NT n8 tiles, in 3xTF32: A row-major (lda floats, at the
// warp's first row and the slice's first k); B a slice in fragment order
// (at the warp's first n-tile and this lane; ldk floats from one k-chunk to
// the next). k-step position t is k 2t, t + 4 is 2t + 1 (A: one float2 a
// row). Each 16-wide chunk of K: a fresh accumulator over its two k-steps,
// six products, joined by f32 adds.
template <int NT, int K>
__device__ __forceinline__ void tile_3xtf32(float (&acc)[2][NT][4],
                                            const float* A, int lda,
                                            const float* B, int ldk, int g,
                                            int t) {
#pragma unroll
  for (int kc = 0; kc < K; kc += 16) {
    unsigned ah[2][2][4], al[2][2][4];  // [k-step][m-tile][fragment]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = A + (16 * i + g) * lda + kc + 8 * h + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(a);
        const float2 r8 = *reinterpret_cast<const float2*>(a + 8 * lda);
        split_hi(r0.x, ah[h][i][0], al[h][i][0]);
        split_hi(r8.x, ah[h][i][1], al[h][i][1]);
        split_hi(r0.y, ah[h][i][2], al[h][i][2]);
        split_hi(r8.y, ah[h][i][3], al[h][i][3]);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + (kc / 16) * ldk + 128 * j);
      const float bk[2][2] = {{b.x, b.y}, {b.z, b.w}};
      float d[2][4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned bh0, bl0, bh1, bl1;
        split_hi(bk[h][0], bh0, bl0);
        split_hi(bk[h][1], bh1, bl1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32_1688(d[i], al[h][i], bh0, bh1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32_1688(d[i], ah[h][i], bl0, bl1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32_1688(d[i], ah[h][i], bh0, bh1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], d[i][e]);
    }
  }
}

template <bool SNAKE, int L>
__global__ void __launch_bounds__(THREADS, 1)
fir_tf32_kernel(const float* __restrict__ x, const float* __restrict__ img,
                const float* __restrict__ ab2, float* __restrict__ out,
                int S) {
  constexpr int lx = ldx(L), stage = stage_floats(L);
  constexpr int L2 = 2 * L, l4 = L / 4, NT2 = L / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per ring slot: its bulk copy's bytes (full) and its 8 warps (empty)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + STAGES;
  float* xs = reinterpret_cast<float*>(smem_raw + BARS);   // [XR][L + 8]
  float* s2s = xs + XR * lx;                               // [XR][NC + 8]
  float* ring = s2s + XR * LDS;                            // STAGES slices

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // rows 32 wm .., column quarter
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * TM;  // first output row
  const long long bofs = (long long)blockIdx.y * S * L;

  constexpr int kb1n = L / KS1, n1_ = n1(L);
  constexpr int per_chunk = n1_ + N2, total = (L2 / NC) * per_chunk;
  // slice s: one bulk copy from the image into its ring slot, by thread 0,
  // counted on the slot's mbarrier
  auto issue = [&](int s) {
    if (s >= total) return;
    const int c = s / per_chunk, j = s - c * per_chunk;
    const int floats = j < n1_ ? B1 : b2(L);
    const size_t off = c * chunk_floats(L) +
                       (j < n1_ ? (size_t)j * B1
                                : (size_t)n1_ * B1 + (size_t)(j - n1_) * b2(L));
    mbar_expect_tx(&full[s % STAGES], 4 * floats);
    bulk_copy_g2s(ring + (s % STAGES) * stage, img + off, 4 * floats,
                  &full[s % STAGES]);
  };
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], THREADS / 32);
    }
    fence_mbarrier_init();
    issue(0);
    issue(1);
  }

  // xe rows r0 - 2 .. r0 + 63 (local j = r - r0 + 2)
  for (int idx = tid; idx < XR * l4; idx += THREADS) {
    const int j = idx / l4, k = (idx - j * l4) * 4;
    cp_async16(xs + j * lx + k,
               x + bofs + (long long)xe_row(r0 - 2 + j, S) * L + k);
  }
  cp_async_commit();
  // s2s rows 64, 65 feed only the tile's two unused output rows
  for (int idx = tid; idx < 2 * NC; idx += THREADS)
    s2s[(M1 + idx / NC) * LDS + idx % NC] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();  // xs, s2s's zero rows and the mbarriers

  float acc1[2][4][4];      // the warp's 32 x 32 of the s2 chunk
  float acc2[2][NT2][4];    // the warp's 32 x L/4 of the output
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NT2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.0f;
  }

  // The warps run apart, each as far as the slices that have landed; a
  // slot is refilled once every warp has arrived on its empty mbarrier.
  // One barrier a chunk: a warp reaches a chunk's last GEMM1 slice only
  // once every warp is past the chunk before (thread 0 issues slice s + 2
  // after all are done with s - 1), so s2s may be written there; the
  // barrier after the writes lets GEMM2 read them.
  for (int s = 0; s < total; ++s) {
    mbar_wait(&full[s % STAGES], (s / STAGES) & 1);  // slice s landed
    if (tid == 0 && s + 2 < total) {  // into slice s - 1's slot
      if (s > 0) mbar_wait(&empty[(s + 2) % STAGES], ((s - 1) / STAGES) & 1);
      issue(s + 2);
    }
    const float* buf = ring + (s % STAGES) * stage;
    const int c = s / per_chunk, j = s - c * per_chunk;
    if (j < n1_) {
      // GEMM1: s2 local row m reads xs local row m + q
      const int q = j / kb1n, kb = (j - q * kb1n) * KS1;
      tile_3xtf32<4, KS1>(acc1, xs + (wm * 32 + q) * lx + kb, lx,
                          buf + (wn * 4 * 32 + lane) * 4, NC / 8 * 128, g, t);
      if (j == n1_ - 1) {
        // the chunk of s2 is complete: snake, to shared memory
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jt = 0; jt < 4; ++jt) {
            const int nl = wn * 32 + 8 * jt + 2 * t;
            if (SNAKE) SnakePair(ab2, c * NC + nl, L2).apply(acc1[i][jt]);
            const int m = wm * 32 + 16 * i + g;
            *reinterpret_cast<float2*>(s2s + m * LDS + nl) =
                make_float2(acc1[i][jt][0], acc1[i][jt][1]);
            *reinterpret_cast<float2*>(s2s + (m + 8) * LDS + nl) =
                make_float2(acc1[i][jt][2], acc1[i][jt][3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc1[i][jt][e] = 0.0f;
          }
        __syncthreads();
      }
    } else {
      // GEMM2: output local row i reads s2s local row i + q
      const int j2 = j - n1_, q = j2 / KB2N, kb = (j2 - q * KB2N) * KS2;
      tile_3xtf32<NT2, KS2>(acc2, s2s + (wm * 32 + q) * LDS + kb, LDS,
                            buf + (wn * NT2 * 32 + lane) * 4, L / 8 * 128, g,
                            t);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s % STAGES]);  // this warp is done
  }

  float* ob = out + bofs;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jt = 0; jt < NT2; ++jt) {
      const int n = wn * (L / 4) + 8 * jt + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wm * 32 + 16 * i + g + 8 * hh;
        if (row < TM && r0 + row < S)
          *reinterpret_cast<float2*>(ob + (long long)(r0 + row) * L + n) =
              make_float2(acc2[i][jt][2 * hh], acc2[i][jt][2 * hh + 1]);
      }
    }
}

template <bool SNAKE, int L>
cudaError_t launch_tf32(const float* x, const float* img, const float* ab2,
                        float* out, int B, int S, cudaStream_t stream) {
  auto kernel = fir_tf32_kernel<SNAKE, L>;
  constexpr size_t bytes = smem_bytes(L);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((S + TM - 1) / TM, B);
  kernel<<<grid, THREADS, bytes, stream>>>(x, img, ab2, out, S);
  return cudaGetLastError();
}

}  // namespace f32k

// --- BF16: wgmma, a cluster of two blocks on 128 rows ---------------------------

namespace bf16k {

using bf = __nv_bfloat16;

constexpr int M1 = 128;       // s2 rows a cluster (and a block)
constexpr int TM = M1 - 2;    // output rows a cluster
constexpr int XR = M1 + 2;    // xe rows a block
constexpr int NH = NC / 2;    // the chunk's s2 columns a block computes
constexpr int STAGES = 4;
constexpr int SLICE = 24576;  // bytes a ring slot: GEMM1's slice, the largest
constexpr int ALIGN = 1024;   // the 128-byte swizzle's atoms
constexpr int BARS = 64;      // bytes for the ring's mbarriers
// a GEMM1 slice: the three taps' [NH][64] k-slabs; a GEMM2 slice [L / 2][64]
constexpr int B1 = 3 * NH * 128;
__host__ __device__ constexpr int b2(int L) { return L / 2 * 128; }
// the slices of a chunk: L / 64 of up, then 3 NC / 64 of dn
__host__ __device__ constexpr int n1(int L) { return L / 64; }
constexpr int KB2N = NC / 64, N2 = 3 * KB2N;
__host__ __device__ constexpr size_t chunk_bytes(int L) {
  return (size_t)n1(L) * B1 + (size_t)N2 * b2(L);
}
// one block's half of up and dn as its slices, in the order it reads them:
// 12 L^2 bytes (both halves: the caller's scratch of 12 L^2 bf16)
__host__ __device__ constexpr size_t image_bytes(int L) {
  return (size_t)(2 * L / NC) * chunk_bytes(L);
}

// bytes: the mbarriers and the ring's alignment, the ring, xs [L / 8][XR][8]
// and s2s [NC / 8][M1][8] (bf16), and 32 bytes that the two unused output
// rows' GEMM2 reads run past s2s's last k-chunk
__host__ __device__ constexpr size_t smem_bytes(int L) {
  return (size_t)BARS + ALIGN + (size_t)STAGES * SLICE +
         (size_t)L / 8 * XR * 16 + (size_t)NC / 8 * M1 * 16 + 32;
}

// byte offset of 16-byte chunk ch (k 8 ch .. + 8) of row n in a K-major
// slice of 64-wide rows with the 128-byte swizzle
__host__ __device__ __forceinline__ int sw128(int n, int ch) {
  return (n >> 3) * 1024 + (n & 7) * 128 + ((ch ^ (n & 7)) << 4);
}

// The prep kernel: up [3][L][2L] and dn [3][2L][L] (bf16) into the two
// blocks' images (img: 2 x image_bytes(L)), each slice exactly as the ring
// slot will hold it. z < 3 takes tap z of up (K = L, N = 2L), z >= 3 tap
// z - 3 of dn (K = 2L, N = L); a block transposes a 64 x 64 tile through
// shared memory and writes 16-byte chunks. Grid (2L / 64, 2L / 64, 6),
// 256 threads.
__global__ void fir_pack_kernel(const bf* __restrict__ up,
                                const bf* __restrict__ dn,
                                unsigned char* __restrict__ img, int L) {
  __shared__ __align__(16) unsigned short tile[64][72];
  const int z = blockIdx.z, q = z % 3;
  const bool isup = z < 3;
  const int K = isup ? L : 2 * L, N = isup ? 2 * L : L;
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  if (n0 >= N || k0 >= K) return;
  const bf* src = (isup ? up : dn) + (long long)q * K * N;
  for (int i = threadIdx.x; i < 512; i += blockDim.x) {
    const int r = i >> 3, cn = i & 7;
    *reinterpret_cast<uint4*>(&tile[r][8 * cn]) =
        *reinterpret_cast<const uint4*>(src + (long long)(k0 + r) * N + n0 +
                                        8 * cn);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 512; i += blockDim.x) {
    const int nt = i >> 3, ch = i & 7, n = n0 + nt;
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = tile[8 * ch + 2 * e][nt] |
             ((unsigned)tile[8 * ch + 2 * e + 1][nt] << 16);
    size_t off;
    int row;
    if (isup) {  // GEMM1 slice (c, k-slab k0 / 64) of half h, tap q
      const int c = n / NC, h = (n % NC) / NH;
      row = n % NH;
      off = h * image_bytes(L) + c * chunk_bytes(L) + (size_t)(k0 / 64) * B1 +
            q * (NH * 128);
    } else {     // GEMM2 slice (c, q, k-slab) of half h
      const int c = k0 / NC, kb = (k0 % NC) / 64, h = n / (L / 2);
      row = n % (L / 2);
      off = h * image_bytes(L) + c * chunk_bytes(L) + (size_t)n1(L) * B1 +
            (size_t)(q * KB2N + kb) * b2(L);
    }
    *reinterpret_cast<uint4*>(img + off + sw128(row, ch)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// HALF = L / 2: the output columns a block computes, GEMM2's wgmma width
template <bool SNAKE, int HALF>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
fir_wgmma_kernel(const float* __restrict__ x,
                 const unsigned char* __restrict__ images,
                 const float* __restrict__ ab2, float* __restrict__ out,
                 int S) {
  constexpr int L = 2 * HALF, L2 = 2 * L;
  constexpr int XLBO = XR * 16;  // xs: bytes from one k-chunk to the next
  constexpr int SLBO = M1 * 16;  // s2s: the same
  constexpr int n1_ = n1(L), per_chunk = n1_ + N2;
  constexpr int total = (L2 / NC) * per_chunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // a slot's bytes
  const unsigned base = smem_addr(smem_raw);
  unsigned char* ring =
      smem_raw + (((base + BARS + ALIGN - 1) & ~(ALIGN - 1u)) - base);
  unsigned char* xs = ring + STAGES * SLICE;    // [L / 8][XR][8] bf16
  unsigned char* s2s = xs + (L / 8) * XLBO;     // [NC / 8][M1][8] bf16

  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank();      // the block's half
  unsigned char* s2p = cluster.map_shared_rank(s2s, h ^ 1);  // the peer's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;      // warpgroup, its warp
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (blockIdx.x >> 1) * TM;        // first output row
  const long long bofs = (long long)blockIdx.y * S * L;
  const unsigned char* img = images + h * image_bytes(L);

  // slice s: one bulk copy from the block's image into its ring slot, by
  // thread 0, counted on the slot's mbarrier
  auto issue = [&](int s) {
    if (s >= total) return;
    const int c = s / per_chunk, j = s - c * per_chunk;
    const unsigned bytes = j < n1_ ? B1 : b2(L);
    const size_t off = c * chunk_bytes(L) +
                       (j < n1_ ? (size_t)j * B1
                                : (size_t)n1_ * B1 + (size_t)(j - n1_) * b2(L));
    mbar_expect_tx(&full[s % STAGES], bytes);
    bulk_copy_g2s(ring + (s % STAGES) * SLICE, img + off, bytes,
                  &full[s % STAGES]);
  };
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    fence_mbarrier_init();
    issue(0);
    issue(1);
  }

  // xe rows r0 - 2 .. r0 + 127, rounded to bf16: 8 lanes a thread
  constexpr int l8 = L / 8;
#pragma unroll 4
  for (int idx = tid; idx < XR * l8; idx += THREADS) {
    const int kc = idx / XR, j = idx - kc * XR;
    const float4* src = reinterpret_cast<const float4*>(
        x + bofs + (long long)xe_row(r0 - 2 + j, S) * L + kc * 8);
    const float4 a = src[0], b = src[1];
    *reinterpret_cast<uint4*>(xs + kc * XLBO + j * 16) =
        make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                   pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
  }
  fence_proxy_async();  // xs, for wgmma
  __syncthreads();      // ... and the mbarriers initialised

  float acc1[NH / 2];    // the warpgroup's 64 x NH of the s2 chunk
  float acc2[HALF / 2];  // the warpgroup's 64 x HALF of the output
#pragma unroll
  for (int e = 0; e < HALF / 2; ++e) acc2[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < NH / 2; ++e) acc1[e] = 0.0f;

  for (int s = 0; s < total; ++s) {
    mbar_wait(&full[s % STAGES], (s / STAGES) & 1);  // slice s landed
    __syncthreads();          // and slice s - 2's wgmma are done
    if (tid == 0) issue(s + 2);  // into slice s - 2's slot
    const unsigned char* buf = ring + (s % STAGES) * SLICE;
    const int c = s / per_chunk, j = s - c * per_chunk;
    if (j < n1_) {
      // GEMM1: s2 local row m reads xs local row m + q
      fence_operands(acc1);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16<NH>(
              acc1,
              smem_desc(xs + (8 * j + 2 * kk) * XLBO + (64 * wg + q) * 16,
                        XLBO, 128, SWIZZLE_NONE),
              smem_desc(buf + q * (NH * 128) + 32 * kk, 16, 1024,
                        SWIZZLE_128B),
              j > 0 || q > 0 || kk > 0);
      wgmma_commit();
      fence_operands(acc1);
      if (j < n1_ - 1) {
        wgmma_wait<1>();
        fence_operands(acc1);
        continue;
      }
      // the block's half of the chunk of s2 is complete: snake, round,
      // into both blocks' s2s, once the peer is done with the last chunk's;
      // the snake's parameters load while the tensor cores finish
      SnakePair sp[NH / 8];
      if (SNAKE) {
#pragma unroll
        for (int jt = 0; jt < NH / 8; ++jt)
          sp[jt] = SnakePair(ab2, c * NC + h * NH + 8 * jt + 2 * t, L2);
      }
      wgmma_wait<0>();
      fence_operands(acc1);
      cluster.sync();
#pragma unroll
      for (int jt = 0; jt < NH / 8; ++jt) {
        const int col = h * NH + 8 * jt + 2 * t;  // within the chunk
        if (SNAKE) sp[jt].apply(acc1 + 4 * jt);
        const int off = (col >> 3) * SLBO + (64 * wg + 16 * wi + g) * 16 +
                        (col & 7) * 2;
        const unsigned lo = pack_bf16x2(acc1[4 * jt], acc1[4 * jt + 1]);
        const unsigned hi = pack_bf16x2(acc1[4 * jt + 2], acc1[4 * jt + 3]);
        *reinterpret_cast<unsigned*>(s2s + off) = lo;
        *reinterpret_cast<unsigned*>(s2s + off + 128) = hi;
        *reinterpret_cast<unsigned*>(s2p + off) = lo;
        *reinterpret_cast<unsigned*>(s2p + off + 128) = hi;
      }
      fence_proxy_async();
      cluster.sync();
    } else {
      // GEMM2: output local row i reads s2s local row i + q (rows 128, 129
      // feed only the two unused output rows: whatever lies there)
      const int j2 = j - n1_, q = j2 / KB2N, kb = (j2 - q * KB2N) * 64;
      fence_operands(acc2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16<HALF>(
            acc2,
            smem_desc(s2s + ((kb >> 3) + 2 * kk) * SLBO + (64 * wg + q) * 16,
                      SLBO, 128, SWIZZLE_NONE),
            smem_desc(buf + 32 * kk, 16, 1024, SWIZZLE_128B), 1);
      wgmma_commit();
      fence_operands(acc2);
      wgmma_wait<1>();
      fence_operands(acc2);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc2);

  float* ob = out + bofs;
#pragma unroll
  for (int jt = 0; jt < HALF / 8; ++jt) {
    const int n = h * HALF + 8 * jt + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 64 * wg + 16 * wi + g + 8 * hh;
      if (i < TM && r0 + i < S)
        *reinterpret_cast<float2*>(ob + (long long)(r0 + i) * L + n) =
            make_float2(acc2[4 * jt + 2 * hh], acc2[4 * jt + 2 * hh + 1]);
    }
  }
}

template <bool SNAKE, int HALF>
cudaError_t launch_wgmma(const float* x, const unsigned char* images,
                         const float* ab2, float* out, int B, int S,
                         cudaStream_t stream) {
  auto kernel = fir_wgmma_kernel<SNAKE, HALF>;
  constexpr size_t bytes = smem_bytes(2 * HALF);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(2 * ((S + TM - 1) / TM), B);
  kernel<<<grid, THREADS, bytes, stream>>>(x, images, ab2, out, S);
  return cudaGetLastError();
}

}  // namespace bf16k

template <bool BF16, bool SNAKE>
int launch(const float* x, const void* up, const void* dn, const float* ab2,
           float* out, void* scratch, int B, int S, int L, void* stream) {
  if (B <= 0 || B > 65535 || S < 8 || L <= 0 || L % 64 != 0 || L > MAX_L)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if constexpr (!BF16) {
    using namespace f32k;
    auto* img = static_cast<float*>(scratch);
    fir_pack_f32_kernel<<<(3 * L * L + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(up), static_cast<const float*>(dn), img, L);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    switch (L) {
      case 64: return (int)launch_tf32<SNAKE, 64>(x, img, ab2, out, B, S, st);
      case 128: return (int)launch_tf32<SNAKE, 128>(x, img, ab2, out, B, S, st);
      case 192: return (int)launch_tf32<SNAKE, 192>(x, img, ab2, out, B, S, st);
      case 256: return (int)launch_tf32<SNAKE, 256>(x, img, ab2, out, B, S, st);
      case 320: return (int)launch_tf32<SNAKE, 320>(x, img, ab2, out, B, S, st);
      default: return (int)launch_tf32<SNAKE, 384>(x, img, ab2, out, B, S, st);
    }
  } else {
    using namespace bf16k;
    auto* img = static_cast<unsigned char*>(scratch);
    fir_pack_kernel<<<dim3(2 * L / 64, 2 * L / 64, 6), 256, 0, st>>>(
        static_cast<const bf*>(up), static_cast<const bf*>(dn), img, L);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    switch (L) {
      case 64: return (int)launch_wgmma<SNAKE, 32>(x, img, ab2, out, B, S, st);
      case 128: return (int)launch_wgmma<SNAKE, 64>(x, img, ab2, out, B, S, st);
      case 192: return (int)launch_wgmma<SNAKE, 96>(x, img, ab2, out, B, S, st);
      case 256: return (int)launch_wgmma<SNAKE, 128>(x, img, ab2, out, B, S, st);
      case 320: return (int)launch_wgmma<SNAKE, 160>(x, img, ab2, out, B, S, st);
      default: return (int)launch_wgmma<SNAKE, 192>(x, img, ab2, out, B, S, st);
    }
  }
}

}  // namespace

// x, out: [B, S, L] float32; up [3, L, 2L], dn [3, 2L, L] float32 (f32
// entries) or bfloat16 (bf16 entries); ab2 [2, 2L] float32 (read only by
// the snake entries); scratch: mxu_fir_scratch_bytes(L, bf16) bytes, where
// a prep kernel lays up and dn out as the slices the kernel reads. 16-byte
// aligned, contiguous. S >= 8, L % 64 == 0, L <= 384. Return
// cudaGetLastError() after the launches.
extern "C" long long mxu_fir_scratch_bytes(int L, int bf16) {
  return bf16 ? (long long)(2 * bf16k::image_bytes(L))
              : (long long)f32k::image_bytes(L);
}
extern "C" int mxu_fir_f32(const float* x, const void* up, const void* dn,
                           const float* ab2, float* out, void* scratch, int B,
                           int S, int L, void* stream) {
  return launch<false, true>(x, up, dn, ab2, out, scratch, B, S, L, stream);
}
extern "C" int mxu_fir_f32_dots(const float* x, const void* up,
                                const void* dn, const float* ab2, float* out,
                                void* scratch, int B, int S, int L,
                                void* stream) {
  return launch<false, false>(x, up, dn, ab2, out, scratch, B, S, L, stream);
}
extern "C" int mxu_fir_bf16(const float* x, const void* up, const void* dn,
                            const float* ab2, float* out, void* scratch, int B,
                            int S, int L, void* stream) {
  return launch<true, true>(x, up, dn, ab2, out, scratch, B, S, L, stream);
}
extern "C" int mxu_fir_bf16_dots(const float* x, const void* up,
                                 const void* dn, const float* ab2, float* out,
                                 void* scratch, int B, int S, int L,
                                 void* stream) {
  return launch<true, false>(x, up, dn, ab2, out, scratch, B, S, L, stream);
}
