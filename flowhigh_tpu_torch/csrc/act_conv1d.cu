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
// alpha, beta [Cin], all float32 and contiguous; filt the 12 Kaiser-sinc
// taps of kernel A.
//
// Bound: f32 arithmetic, as kernel B: T*Cin*Cout*K multiply-adds per pair
// against one read of x and one write of y. The fusion saves the snake's
// write and read of a [Cin, T] map (8 bytes per element), the pair's only
// device-memory traffic beyond x, y and the residuals.
//
// Design: act_conv_core.cuh, with a BM x 256 output tile per block and Cin
// chunks of 8 / 4 / 2 channels at K = 3 / 7 / 11. BM is 128 (16 warps,
// 512 threads) where 128 divides Cout (the C = 768 and 384 stages, where
// the vocoder routes its pairs), 48 at C = 48 and 96, else 64 (8 warps).
// The cost of the fusion is recompute: every output-channel block computes
// the snake of its whole Cin window, (256 + 2 pad) / 256 of the samples,
// so the snake runs Cout / BM times per sample (6x at C = 768, 1x at
// C = 48) against once in kernel A. Each snake sample costs ~56 operations
// and two sinf; the conv does 2 K operations per input sample per output
// channel, so the recompute adds 56 / (2 BM K) of the conv's operations at
// any C: 7% at K = 3, 2% at K = 11 with BM = 128 (counting each sinf as one
// operation). Measured, the snake cost more than that count says: with
// BM = 64 it took 40% of the kernel's time at C = 768, K = 3 (PERF.md).
//
// dot_dtype (dot_dtype.cuh, act_conv_core.cuh): the BF16 and I8 instances
// round or quantise the activation in shared memory and take rounded or
// quantised weights from the host. I8 first runs act_amax, the snake over
// the whole window [t0 - pad, t0 + 256 + pad) of all Cin channels, for the
// window's scale: the snake runs twice per block (the simple way; a
// pre-pass shared by the Cout / BM blocks of a tile is the faster one).

#include "act_conv_core.cuh"

namespace {

constexpr int NI = 8;   // samples per thread: a 256-sample tile
constexpr int BN = TX * NI;

// w holds int32 values (by their bits) for I8, with sw the [Cout] scales
template <Dot D, int K, int CI, int TM, int TYB>
__global__ void __launch_bounds__(TX * TYB, 512 / (TX * TYB))
act_conv1d_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                  const float* __restrict__ beta, const float* filt,
                  const float* __restrict__ w, const float* __restrict__ sw,
                  const float* __restrict__ bias,
                  const float* __restrict__ r0, const float* __restrict__ r1,
                  const float* __restrict__ r2, float* __restrict__ y,
                  int Cin, int Cout, int T, int dil, int logscale,
                  float out_scale) {
  extern __shared__ __align__(16) float smem[];
  const int t0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * TM * TYB;
  const long long b = blockIdx.z;
  const GlobalSrc src{x + b * Cin * T, T};
  const long long ob = b * Cout * T;
  auto epi = [&](int co, int l, float acc) {
    const int t = t0 + l;
    if (t >= T) return;
    const long long o = ob + (long long)co * T + t;
    float v = acc + (bias != nullptr ? bias[co] : 0.0f);
    if (r0 != nullptr) v += r0[o];
    if (r1 != nullptr) v += r1[o];
    if (r2 != nullptr) v += r2[o];
    y[o] = v * out_scale;
  };
  Quant q{0.0f, 0.0f};
  if constexpr (D == Dot::I8)
    q = quant_of(act_amax<K, CI, TM, NI, TYB>(src, smem, filt, alpha, beta,
                                              logscale, Cin, T, t0, BN, dil));
  act_conv_tile<D, K, CI, TM, NI, TYB>(src, epi, smem, filt, alpha, beta,
                                       logscale, w, Cin, Cout, co0, T, t0, dil,
                                       q, sw);
}

template <int K, int CI, int TM, int TYB>
long long smem_bytes(int dil) {
  return 4 * core_floats(K, CI, TM * TYB, BN, dil * (K - 1) / 2);
}

template <Dot D, int K, int CI, int TM, int TYB>
int launch(const float* x, const float* alpha, const float* beta,
           const float* filt, const float* w, const float* sw,
           const float* bias, const float* r0, const float* r1,
           const float* r2, float* y, int B, int Cin, int Cout, int T,
           int dil, int logscale, float out_scale, cudaStream_t stream) {
  auto kern = act_conv1d_kernel<D, K, CI, TM, TYB>;
  const long long smem = smem_bytes<K, CI, TM, TYB>(dil);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int BM = TM * TYB;
  dim3 grid((T + BN - 1) / BN, (Cout + BM - 1) / BM, B);
  kern<<<grid, TX * TYB, smem, stream>>>(x, alpha, beta, filt, w, sw, bias,
                                         r0, r1, r2, y, Cin, Cout, T, dil,
                                         logscale, out_scale);
  return (int)cudaGetLastError();
}

// the output-channel tile: 128 (16 warps) where 128 divides Cout, 48
// where 48 divides Cout and 64 does not, else 64
inline int tile_kind(int Cout) {
  if (Cout % 128 == 0) return 2;
  return Cout % 48 == 0 && Cout % 64 != 0 ? 0 : 1;
}

template <class F>
long long dispatch(int K, int Cout, const F& f) {
  const int kind = tile_kind(Cout);
#define FHT_CASE(K_, CI_)                                                  \
  case K_:                                                                 \
    return kind == 2   ? f.template run<K_, CI_, 8, 16>()                  \
           : kind == 0 ? f.template run<K_, CI_, 6, 8>()                   \
                       : f.template run<K_, CI_, 8, 8>();
  switch (K) {  // CI x K = 24, 28, 22 rows of GEMM depth per chunk
    FHT_CASE(3, 8)
    FHT_CASE(7, 4)
    FHT_CASE(11, 2)
    default: return -1;
  }
#undef FHT_CASE
}

struct SmemQuery {
  int dil;
  template <int K, int CI, int TM, int TYB>
  long long run() const {
    return smem_bytes<K, CI, TM, TYB>(dil);
  }
};

template <Dot D>
struct Launcher {
  const float *x, *alpha, *beta, *filt, *w, *sw, *bias, *r0, *r1, *r2;
  float* y;
  int B, Cin, Cout, T, dil, logscale;
  float out_scale;
  cudaStream_t s;
  template <int K, int CI, int TM, int TYB>
  long long run() const {
    return launch<D, K, CI, TM, TYB>(x, alpha, beta, filt, w, sw, bias, r0,
                                     r1, r2, y, B, Cin, Cout, T, dil,
                                     logscale, out_scale, s);
  }
};

template <Dot D>
int act_conv1d(const float* x, const float* alpha, const float* beta,
               const float* filt, const float* w, const float* sw,
               const float* bias, const float* r0, const float* r1,
               const float* r2, float* y, int B, int Cin, int Cout, int T,
               int K, int dil, int logscale, float out_scale, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || T <= 0 || dil <= 0 || B > 65535 ||
      Cout > 65535)
    return (int)cudaErrorInvalidValue;
  const Launcher<D> f{x, alpha, beta, filt, w, sw, bias, r0, r1, r2, y, B,
                      Cin, Cout, T, dil, logscale, out_scale,
                      (cudaStream_t)stream};
  const long long err = dispatch(K, Cout, f);
  return err < 0 ? (int)cudaErrorInvalidValue : (int)err;
}

}  // namespace

// Shared memory one block takes (bytes), -1 without an instance; mirrored
// by flowhigh_tpu_torch/ops/fused_conv.py:act_conv_smem_bytes.
extern "C" long long act_conv1d_smem_bytes(int K, int dil, int Cout) {
  return dispatch(K, Cout, SmemQuery{dil});
}

// Each returns cudaGetLastError() after the launch (or the error that kept
// it from launching). beta, bias and r0..r2 may be null.
extern "C" int act_conv1d_f32(const float* x, const float* alpha,
                              const float* beta, const float* filt,
                              const float* w, const float* bias,
                              const float* r0, const float* r1,
                              const float* r2, float* y, int B, int Cin,
                              int Cout, int T, int K, int dil, int logscale,
                              float out_scale, void* stream) {
  return act_conv1d<Dot::F32>(x, alpha, beta, filt, w, nullptr, bias, r0, r1,
                              r2, y, B, Cin, Cout, T, K, dil, logscale,
                              out_scale, stream);
}

// w: the weights rounded to bf16 (as f32)
extern "C" int act_conv1d_bf16(const float* x, const float* alpha,
                               const float* beta, const float* filt,
                               const float* w, const float* bias,
                               const float* r0, const float* r1,
                               const float* r2, float* y, int B, int Cin,
                               int Cout, int T, int K, int dil, int logscale,
                               float out_scale, void* stream) {
  return act_conv1d<Dot::BF16>(x, alpha, beta, filt, w, nullptr, bias, r0, r1,
                               r2, y, B, Cin, Cout, T, K, dil, logscale,
                               out_scale, stream);
}

// wq: int32 weights in [-127, 127], sw: [Cout] scales (ops/quant.py)
extern "C" int act_conv1d_int8(const float* x, const float* alpha,
                               const float* beta, const float* filt,
                               const int* wq, const float* sw,
                               const float* bias, const float* r0,
                               const float* r1, const float* r2, float* y,
                               int B, int Cin, int Cout, int T, int K, int dil,
                               int logscale, float out_scale, void* stream) {
  return act_conv1d<Dot::I8>(x, alpha, beta, filt,
                             reinterpret_cast<const float*>(wq), sw, bias, r0,
                             r1, r2, y, B, Cin, Cout, T, K, dil, logscale,
                             out_scale, stream);
}
