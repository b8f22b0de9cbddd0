// Kernel F: blockwise (flash) attention forward with key-padding segments,
//   out[b, h, i] = sum_j p_ij v[b, h, j],
//   p_ij = softmax_j(scale * q_i . k_j) over the keys j with seg(j) == seg(i),
// seg = 1 at a valid position and 0 at a masked one (seg == nullptr: all 1).
//
// Replaces the JAX package's flowhigh_tpu/models/transformer.py
// :_flash_attention, the Pallas TPU library kernel
// jax.experimental.pallas.ops.tpu.flash_attention called with segment ids,
// padding semantics included: that function pads N up to n_pad, a multiple
// of its block, with q = k = v = 0 in segment 0, so every masked query
// (segment 0) also attends to n_pad - N keys of logit 0 and value 0. Those
// keys are not stored here: a masked query's running softmax starts as if
// it had already seen them (running max 0, running sum n_pad - N, numerator
// 0). Valid queries never meet them.
//
// Layout: q, k, v, out [B, H, N, D] float32, contiguous; seg [B, N] int32.
// Instances for D = 16, 32, 64.
//
// Bound: f32 arithmetic. 4 N^2 D operations per (b, h) over 16 N D bytes:
// at N = 30,000 and D = 64 about 7,500 operations per byte. Design: one
// block of 256 threads per (64-query tile, b * h); a loop over 64-key tiles
// takes the place of the TPU grid's sequential key axis. Each key tile is
// staged in shared memory (K transposed, V row-major), each thread computes
// a 4 x 4 block of the 64 x 64 scores with f32 FMAs (no tensor cores: TF32
// would not hold the 1e-4 parity with the reference), and keeps the running
// max and sum of its 4 rows in f32, reduced over the 16 threads that share
// a row by warp shuffles. The probabilities go through shared memory to the
// P.V product, where each thread owns 4 rows x D/16 output columns.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;   // queries per block
constexpr int BN = 64;   // keys per tile
constexpr int NT = 256;  // 16 row groups (4 rows each) x 16 column lanes
constexpr int LD = 68;   // padded row length of the 64-wide tiles

template <int D>
struct Layout {
  static constexpr int VLD = D + 4;  // padded row length of the V tile
  static constexpr int QT = 0;                  // [D][LD] q tile, transposed
  static constexpr int KT = QT + D * LD;        // [D][LD] k tile, transposed
  static constexpr int VS = KT + D * LD;        // [BN][VLD] v tile
  static constexpr int PS = VS + BN * VLD;      // [BM][LD] probabilities
  static constexpr int SEG = PS + BM * LD;      // [BN] int key segments
  static constexpr size_t bytes = (size_t)(SEG + BN) * sizeof(float);
};

// Element e of a [64 rows][D] tile load, mapped so that a warp reads 8 rows
// x 64 contiguous bytes of device memory and stores the transposed tile to
// shared memory with at most 2-way bank conflicts.
template <int D>
__device__ __forceinline__ void tile_index(int e, int& r, int& c) {
  const int g = e >> 5, w = e & 31;
  r = (g % (BN / 8)) * 8 + (w & 7);
  c = ((g / (BN / 8)) * 4 + (w >> 3)) * 4;
}

template <int N>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = p[0]; }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* v) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ seg,
                  float* __restrict__ out, int H, int N, int n_extra,
                  float scale) {
  using L = Layout<D>;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem + L::QT;
  float* kt = smem + L::KT;
  float* vs = smem + L::VS;
  float* ps = smem + L::PS;
  int* segk = reinterpret_cast<int*>(smem + L::SEG);

  const int tid = threadIdx.x;
  const int lane = tid & 15;  // keys 4 lane .. 4 lane + 3; columns lane * CPT
  const int rg = tid >> 4;    // rows 4 rg .. 4 rg + 3
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const long long base = (long long)bh * N * D;
  const int* segb = seg != nullptr ? seg + (long long)(bh / H) * N : nullptr;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < BM * D / 4; e += NT) {
    int r, c;
    tile_index<D>(e, r, c);
    const float4 x = q0 + r < N ? *reinterpret_cast<const float4*>(
                                      q + base + (long long)(q0 + r) * D + c)
                                : zero;
    qt[(c + 0) * LD + r] = x.x;
    qt[(c + 1) * LD + r] = x.y;
    qt[(c + 2) * LD + r] = x.z;
    qt[(c + 3) * LD + r] = x.w;
  }

  float m[4], l[4], acc[4][CPT];
  int sq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = q0 + 4 * rg + i;
    sq[i] = (gi < N && segb != nullptr) ? segb[gi] : 1;
    // a masked query has already "seen" the n_extra pad keys (logit 0)
    const bool pads = sq[i] == 0 && n_extra > 0;
    m[i] = pads ? 0.f : -INFINITY;
    l[i] = pads ? (float)n_extra : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BN) {
    __syncthreads();  // the previous tile's kt, vs, ps and segk are consumed
    for (int e = tid; e < BN * D / 4; e += NT) {
      int r, c;
      tile_index<D>(e, r, c);
      float4 kx = zero, vx = zero;
      if (k0 + r < N) {
        const long long off = base + (long long)(k0 + r) * D + c;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
      }
      kt[(c + 0) * LD + r] = kx.x;
      kt[(c + 1) * LD + r] = kx.y;
      kt[(c + 2) * LD + r] = kx.z;
      kt[(c + 3) * LD + r] = kx.w;
      *reinterpret_cast<float4*>(vs + r * L::VLD + c) = vx;
    }
    if (tid < BN) {
      const int gj = k0 + tid;
      segk[tid] = gj < N ? (segb != nullptr ? segb[gj] : 1) : -1;
    }
    __syncthreads();

    // scores: s[i][j] = q[4 rg + i] . k[4 lane + j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LD + 4 * rg);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * LD + 4 * lane);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    int sk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sk[j] = segk[4 * lane + j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = sk[j] == sq[i] ? s[i][j] * scale : -INFINITY;
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;  // no key of the row yet
      const float alpha = expf(m[i] - mu);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mu);
        rs += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (4 * rg + i) * LD + 4 * lane) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc[i][c] += sum_kk p[4 rg + i][kk] v[kk][lane * CPT + c]
#pragma unroll 2
    for (int kk = 0; kk < BN; kk += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) Vec<4>::load(ps + (4 * rg + i) * LD + kk, p[i]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float vv[CPT];
        Vec<CPT>::load(vs + (kk + t) * L::VLD + lane * CPT, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p[i][t], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = q0 + 4 * rg + i;
    if (gi >= N) continue;
    const float inv = 1.f / l[i];
    float* o = out + base + (long long)gi * D + lane * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[c] = acc[i][c] * inv;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* seg,
           float* out, int B, int H, int N, int n_extra, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BM - 1) / BM, B * H);
  flash_attn_kernel<D><<<grid, NT, smem, stream>>>(q, k, v, seg, out, H, N,
                                                   n_extra, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// n_extra = n_pad - N, the pad keys every masked query also attends to.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a D without an instance or bad sizes.
extern "C" int flash_attn_f32(const float* q, const float* k, const float* v,
                              const int* seg, float* out, int B, int H, int N,
                              int D, int n_extra, float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || n_extra < 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 16) return launch<16>(q, k, v, seg, out, B, H, N, n_extra, scale, s);
  if (D == 32) return launch<32>(q, k, v, seg, out, B, H, N, n_extra, scale, s);
  if (D == 64) return launch<64>(q, k, v, seg, out, B, H, N, n_extra, scale, s);
  return (int)cudaErrorInvalidValue;
}

// 1 when D has a compiled instance.
extern "C" int flash_attn_supported(int D) {
  return D == 16 || D == 32 || D == 64;
}
