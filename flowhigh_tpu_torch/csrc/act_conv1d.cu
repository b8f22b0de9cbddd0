// Kernel D: the anti-aliased snake fused into the dilated "same" conv,
//
//   y = out_scale * (bias + conv(a) + r0 + r1 + r2),   a = snakebeta-AA(x),
//
// with the conv's zero padding applied to a and the snake's replicate
// padding applied to x. Computes kernel B (conv1d_same.cu) on kernel A's
// (snake_aa.cu) output, without writing a to device memory.
//
// Replaces the Pallas kernel flowhigh_tpu/ops/packed.py:
// pallas_packed_act_conv1d (core _act_conv_core, body _make_act_conv_kernel):
// the [act -> conv] pairs of BigVGAN's AMPBlock1 that the vocoder does not
// fuse into a whole unit (kernel E), with up to three residuals (the unit's
// input and the folded MRF average, out_scale = 1/3).
//
// Layout: x [B, Cin, T], w [Cout, Cin, K], residuals and y [B, Cout, T],
// alpha, beta [Cin], all contiguous; filt the 12 Kaiser-sinc taps of kernel
// A. x, the residuals and y are in the storage type (float32, or bf16 for
// the JAX package's bf16 feature maps: widened to f32 on load, y rounded
// once at the store; act_conv_core.cuh), the rest float32.
//
// Bound (a 10 s clip, 36 launches at C = 768 and 384): operations. F32
// runs each product as three TF32 products on the tensor cores (3xTF32:
// 4.47 TFLOP of TF32 products, 9.0 ms at 495 TFLOP/s), BF16 one bf16
// product (1.7 ms), I8 one s8 product (0.75 ms at 1,979 TOP/s); the snake
// adds ~56 f32 operations per input sample and the epilogue a few per
// output. Against kernel A + kernel B the fusion saves the snake's write
// and read of a [Cin, T] map (8 bytes an element).
//
// Design: act_conv_core.cuh's tensor-core pass (act_conv_mma), a BM x BN
// output tile per block of 8 warps (dispatch_mma): 256 x 64 at C = 768,
// 128 x 128 at C = 384 (the stages the vocoder routes here), else 64 x
// 128. At most 128 registers a thread, so two blocks share an SM: one
// block's snake (FMA units, sinf) runs while the other's GEMM runs on the
// tensor cores (one block an SM ran 1.25x slower). F32 computes the snake
// of a chunk once per block, Cout / BM times per sample (3x at C = 768 and
// 384) over (BN + 2 pad) / BN of the samples: wide, short tiles trade the
// snake's recompute for more weight traffic from L2 (each block reads its
// BM rows of all K Cin weights); 256 x 64 won at C = 768, 128 x 128 at 384
// (PERF.md). BF16 and I8 run the Cout / BM blocks of a time tile (C = 768,
// 384) as a thread-block cluster that shares each chunk's activation, so
// their snake runs once per sample. Weights: kernel B's prepared layout
// [K][Cout_p][Cin_p] (ops/conv.py:conv_weights), f32, bf16 or int8 (with
// the [Cout] scales; Cin_p a multiple of 32).
// I8: the activation is quantised with one scale per window of 256 outputs
// (ops/quant.py), from the pre-pass act_amax_kernel (act_conv_core.cuh):
// one launch before the kernel over every window [t0 - pad, t0 + 256 +
// pad) of all Cin channels, which writes 8-channel partial maxima to the
// caller's scratch ``part`` [B][ceil(T / 256)][ceil(Cin / 8)]. A tile
// (BN = 64 or 128) reads its window's. Both compute the activation
// without FMAs (snake_ordered), so that it equals its plain version's bits
// and int8 quanta.

#include "act_conv_core.cuh"

namespace {

// --- the tensor-core pass, every dtype -----------------------------------------

template <Dot D, int K, int BM, int BN, int WM, bool CLUSTER, Store ST>
__global__ void __launch_bounds__(MMA_NT, 2)
act_conv1d_mma_kernel(const StoreT<ST>* __restrict__ x,
                      const float* __restrict__ alpha,
                      const float* __restrict__ beta,
                      const typename MmaOps<D>::WT* __restrict__ wp,
                      const float* __restrict__ bias,
                      const StoreT<ST>* __restrict__ r0,
                      const StoreT<ST>* __restrict__ r1,
                      const StoreT<ST>* __restrict__ r2,
                      StoreT<ST>* __restrict__ y, int Cin, int Cout,
                      int cin_p, int cout_p, int T, int dil, int logscale,
                      float out_scale) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int t0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const long long b = blockIdx.z;
  const long long ob = b * Cout * T;
  auto epi = [&](int co, int l, float acc) {
    const int t = t0 + l;
    if (t >= T) return;
    const long long o = ob + (long long)co * T + t;
    float v = acc + (bias != nullptr ? bias[co] : 0.0f);
    if (r0 != nullptr) v += load_f32(r0 + o);
    if (r1 != nullptr) v += load_f32(r1 + o);
    if (r2 != nullptr) v += load_f32(r2 + o);
    store_f32(y + o, v * out_scale);
  };
  act_conv_mma<D, K, BM, BN, WM, D == Dot::F32, 2, CLUSTER>(
      GlobalSrc<ST>{x + b * Cin * T, T}, epi, smem_mma, alpha, beta, logscale, wp,
      Cin, Cout, cin_p, cout_p, co0, T, t0, dil);
}

// I8: as above, with sw, the [Cout] weight scales, and part, the
// pre-pass's partial maxima (n_groups a window)
template <int K, int BM, int BN, int WM, bool CLUSTER, Store ST>
__global__ void __launch_bounds__(MMA_NT, 2)
act_conv1d_s8_kernel(const StoreT<ST>* __restrict__ x,
                     const float* __restrict__ alpha,
                     const float* __restrict__ beta,
                     const signed char* __restrict__ wp,
                     const float* __restrict__ sw,
                     const float* __restrict__ bias,
                     const StoreT<ST>* __restrict__ r0,
                     const StoreT<ST>* __restrict__ r1,
                     const StoreT<ST>* __restrict__ r2,
                     StoreT<ST>* __restrict__ y,
                     const float* __restrict__ part, int n_groups, int Cin,
                     int Cout, int cin_p, int cout_p, int T, int dil,
                     int logscale, float out_scale) {
  static_assert(I8_WINDOW % BN == 0, "I8 tiles tile the windows");
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __shared__ float red[32];
  const int t0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const long long b = blockIdx.z;
  const long long n_win = (T + I8_WINDOW - 1) / I8_WINDOW;
  const Quant q = window_quant(
      part + (b * n_win + t0 / I8_WINDOW) * n_groups, n_groups, red);
  const long long ob = b * Cout * T;
  auto epi = [&](int co, int l, float acc) {
    const int t = t0 + l;
    if (t >= T) return;
    const long long o = ob + (long long)co * T + t;
    float v = acc + (bias != nullptr ? bias[co] : 0.0f);
    if (r0 != nullptr) v += load_f32(r0 + o);
    if (r1 != nullptr) v += load_f32(r1 + o);
    if (r2 != nullptr) v += load_f32(r2 + o);
    store_f32(y + o, v * out_scale);
  };
  act_conv_mma<Dot::I8, K, BM, BN, WM, false, 2, CLUSTER>(
      GlobalSrc<ST>{x + b * Cin * T, T}, epi, smem_mma, alpha, beta, logscale, wp,
      Cin, Cout, cin_p, cout_p, co0, T, t0, dil, q, sw);
}

// The tile (BM, BN, warps along channels, cluster) of Cout for BF16 and I8
// (SHARE) or F32: 256 x 64 (8 x 1 warps, each 32 x 64) where 256 divides
// Cout (C = 768), 128 x 128 (4 x 2, each 32 x 64) where 128 does (C =
// 384), for BF16 and I8 in clusters of the output-channel blocks of a time
// tile (cluster_size: BF16 10% faster; F32 ran 3% slower); else 64 x 128
// (2 x 4, each 32 x 32), no cluster; -1 without an instance
template <bool SHARE, class F>
long long dispatch_mma(int K, int Cout, const F& f) {
  const int kind = Cout % 256 == 0 ? 0 : Cout % 128 == 0 ? 1 : 2;
#define FHT_CASE(K_)                                                       \
  case K_:                                                                 \
    return kind == 0   ? f.template run<K_, 256, 64, 8, SHARE>()           \
           : kind == 1 ? f.template run<K_, 128, 128, 4, SHARE>()          \
                       : f.template run<K_, 64, 128, 2, false>();
  switch (K) {
    FHT_CASE(3)
    FHT_CASE(7)
    FHT_CASE(11)
    default: return -1;
  }
#undef FHT_CASE
}

// blocks a cluster: the largest divisor of the Cout / BM output-channel
// blocks of a time tile that is at most 8 (the portable cluster size)
inline int cluster_size(int Cout, int BM) {
  const int m = (Cout + BM - 1) / BM;
  int n = m < 8 ? m : 8;
  while (m % n != 0) --n;
  return n;
}

struct MmaSmemQuery {
  int dil;
  Dot d;
  template <int K, int BM, int BN, int WM, bool CLUSTER>
  long long run() const {
    return mma_core_bytes(BM, BN, dil * (K - 1) / 2, d, CLUSTER);
  }
};

template <Dot D, Store ST>
struct MmaLauncher {
  const void* x;
  const float *alpha, *beta, *filt;
  const void* w;
  const float *sw, *bias;
  const void *r0, *r1, *r2;
  void* y;
  float* part;
  int B, Cin, Cout, cin_p, cout_p, T, dil, logscale;
  float out_scale;
  cudaStream_t s;
  template <int K, int BM, int BN, int WM, bool CLUSTER>
  long long run() const {
    using S = StoreT<ST>;
    const int pad = dil * (K - 1) / 2;
    const long long smem = mma_core_bytes(BM, BN, pad, D, CLUSTER);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if constexpr (D == Dot::I8)
      e = cudaFuncSetAttribute(
          act_conv1d_s8_kernel<K, BM, BN, WM, CLUSTER, ST>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    else
      e = cudaFuncSetAttribute(
          act_conv1d_mma_kernel<D, K, BM, BN, WM, CLUSTER, ST>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = set_taps(filt, s);
    const int n_groups = (Cin + AMAX_CH - 1) / AMAX_CH;
    if (e == cudaSuccess && D == Dot::I8)  // the windows' scales first
      e = launch_act_amax<ST>(x, alpha, beta, logscale, part, B, Cin, T,
                              (T + I8_WINDOW - 1) / I8_WINDOW, I8_WINDOW,
                              -pad, I8_WINDOW + 2 * pad, s);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((T + BN - 1) / BN, (Cout + BM - 1) / BM, B);
    cfg.blockDim = dim3(MMA_NT);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = CLUSTER ? cluster_size(Cout, BM) : 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const S* xs = static_cast<const S*>(x);
    const S *r0s = static_cast<const S*>(r0), *r1s = static_cast<const S*>(r1),
            *r2s = static_cast<const S*>(r2);
    S* ys = static_cast<S*>(y);
    if constexpr (D == Dot::I8)
      e = cudaLaunchKernelEx(
          &cfg, act_conv1d_s8_kernel<K, BM, BN, WM, CLUSTER, ST>, xs, alpha,
          beta, static_cast<const signed char*>(w), sw, bias, r0s, r1s, r2s,
          ys, static_cast<const float*>(part), n_groups, Cin, Cout, cin_p,
          cout_p, T, dil, logscale, out_scale);
    else
      e = cudaLaunchKernelEx(
          &cfg, act_conv1d_mma_kernel<D, K, BM, BN, WM, CLUSTER, ST>, xs,
          alpha, beta, static_cast<const typename MmaOps<D>::WT*>(w), bias,
          r0s, r1s, r2s, ys, Cin, Cout, cin_p, cout_p, T, dil, logscale,
          out_scale);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
};

template <Dot D, Store ST = Store::F32>
int act_conv1d_mma(const void* x, const float* alpha, const float* beta,
                   const float* filt, const void* w, const float* sw,
                   const float* bias, const void* r0, const void* r1,
                   const void* r2, void* y, float* part, int B, int Cin,
                   int Cout, int cin_p, int cout_p, int T, int K, int dil,
                   int logscale, float out_scale, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || T <= 0 || dil <= 0 || B > 65535 ||
      Cout > 65535 || cin_p < Cin || cin_p % MmaOps<D>::KC != 0 ||
      cin_p % 16 != 0 || cout_p < Cout ||
      (D == Dot::I8 && (sw == nullptr || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const MmaLauncher<D, ST> f{x,   alpha, beta, filt,   w,      sw,
                         bias, r0,   r1,   r2,     y,      part,
                         B,   Cin,   Cout, cin_p,  cout_p, T,
                         dil, logscale, out_scale, (cudaStream_t)stream};
  const long long err = dispatch_mma<D != Dot::F32>(K, Cout, f);
  return err < 0 ? (int)cudaErrorInvalidValue : (int)err;
}

}  // namespace

// Shared memory one block of instance ``dot`` (0 f32, 1 bf16, 2 int8) takes
// (bytes), -1 without an instance; mirrored by
// flowhigh_tpu_torch/ops/fused_conv.py:act_conv_smem_bytes.
extern "C" long long act_conv1d_smem_bytes(int K, int dil, int Cout, int dot) {
  if (dot < 0 || dot > 2) return -1;
  const MmaSmemQuery f{dil, (Dot)dot};
  return dot == (int)Dot::F32 ? dispatch_mma<false>(K, Cout, f)
                              : dispatch_mma<true>(K, Cout, f);
}

// The launch entry points on float32 maps build here; those on bf16 maps
// build from act_conv1d_bf16io.cu, which defines FHT_BF16_MAPS and includes
// this file, so that the two halves compile in parallel.
#ifndef FHT_BF16_MAPS
// Each returns cudaGetLastError() after the launch (or the error that kept
// it from launching). beta, bias and r0..r2 may be null. w: kernel B's
// prepared weights [K][cout_p][cin_p] (ops/conv.py:conv_weights), float32
// for act_conv1d_f32 and bfloat16 (rounded to nearest even) for
// act_conv1d_bf16; cin_p a multiple of 16.
extern "C" int act_conv1d_f32(const float* x, const float* alpha,
                              const float* beta, const float* filt,
                              const void* w, const float* bias,
                              const float* r0, const float* r1,
                              const float* r2, float* y, int B, int Cin,
                              int Cout, int T, int K, int dil, int logscale,
                              int cin_p, int cout_p, float out_scale,
                              void* stream) {
  return act_conv1d_mma<Dot::F32>(x, alpha, beta, filt, w, nullptr, bias, r0,
                                  r1, r2, y, nullptr, B, Cin, Cout, cin_p,
                                  cout_p, T, K, dil, logscale, out_scale,
                                  stream);
}

extern "C" int act_conv1d_bf16(const float* x, const float* alpha,
                               const float* beta, const float* filt,
                               const void* w, const float* bias,
                               const float* r0, const float* r1,
                               const float* r2, float* y, int B, int Cin,
                               int Cout, int T, int K, int dil, int logscale,
                               int cin_p, int cout_p, float out_scale,
                               void* stream) {
  return act_conv1d_mma<Dot::BF16>(x, alpha, beta, filt, w, nullptr, bias,
                                   r0, r1, r2, y, nullptr, B, Cin, Cout,
                                   cin_p, cout_p, T, K, dil, logscale,
                                   out_scale, stream);
}

// w: the prepared int8 weights [K][cout_p][cin_p] (ops/conv.py:conv_weights,
// quantize_weights' values; cin_p a multiple of 32) and sw their [Cout]
// scales; part: scratch of B x ceil(T / 256) x ceil(Cin / 8) floats for the
// window scales' pre-pass (two launches: the pre-pass, then the kernel).
extern "C" int act_conv1d_int8(const float* x, const float* alpha,
                               const float* beta, const float* filt,
                               const void* w, const float* sw,
                               const float* bias, const float* r0,
                               const float* r1, const float* r2, float* y,
                               float* part, int B, int Cin, int Cout, int T,
                               int K, int dil, int logscale, int cin_p,
                               int cout_p, float out_scale, void* stream) {
  return act_conv1d_mma<Dot::I8>(x, alpha, beta, filt, w, sw, bias, r0, r1,
                                 r2, y, part, B, Cin, Cout, cin_p, cout_p, T,
                                 K, dil, logscale, out_scale, stream);
}

#else  // FHT_BF16_MAPS
// The same three instances on bf16 maps: x, r0..r2 and y __nv_bfloat16
// (the rest as above).
extern "C" int act_conv1d_f32_bf16io(const void* x, const float* alpha,
                                     const float* beta, const float* filt,
                                     const void* w, const float* bias,
                                     const void* r0, const void* r1,
                                     const void* r2, void* y, int B, int Cin,
                                     int Cout, int T, int K, int dil,
                                     int logscale, int cin_p, int cout_p,
                                     float out_scale, void* stream) {
  return act_conv1d_mma<Dot::F32, Store::BF16>(
      x, alpha, beta, filt, w, nullptr, bias, r0, r1, r2, y, nullptr, B, Cin,
      Cout, cin_p, cout_p, T, K, dil, logscale, out_scale, stream);
}

extern "C" int act_conv1d_bf16_bf16io(const void* x, const float* alpha,
                                      const float* beta, const float* filt,
                                      const void* w, const float* bias,
                                      const void* r0, const void* r1,
                                      const void* r2, void* y, int B, int Cin,
                                      int Cout, int T, int K, int dil,
                                      int logscale, int cin_p, int cout_p,
                                      float out_scale, void* stream) {
  return act_conv1d_mma<Dot::BF16, Store::BF16>(
      x, alpha, beta, filt, w, nullptr, bias, r0, r1, r2, y, nullptr, B, Cin,
      Cout, cin_p, cout_p, T, K, dil, logscale, out_scale, stream);
}

extern "C" int act_conv1d_int8_bf16io(const void* x, const float* alpha,
                                      const float* beta, const float* filt,
                                      const void* w, const float* sw,
                                      const float* bias, const void* r0,
                                      const void* r1, const void* r2, void* y,
                                      float* part, int B, int Cin, int Cout,
                                      int T, int K, int dil, int logscale,
                                      int cin_p, int cout_p, float out_scale,
                                      void* stream) {
  return act_conv1d_mma<Dot::I8, Store::BF16>(
      x, alpha, beta, filt, w, sw, bias, r0, r1, r2, y, part, B, Cin, Cout,
      cin_p, cout_p, T, K, dil, logscale, out_scale, stream);
}
#endif  // FHT_BF16_MAPS
