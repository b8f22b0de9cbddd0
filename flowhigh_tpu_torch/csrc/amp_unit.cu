// Kernel E: one whole AMPBlock1 dilation unit,
//
//   t = bias1 + conv1(act1(x))             conv1: K taps, dilation d
//   y = out_scale * (bias2 + conv2(act2(t)) + x + e0 + e1)   conv2: K, 1
//
// where act is the anti-aliased snake of kernel A, zero outside [0, T) as
// each conv's padding, and act2 reads t replicate-clamped at the sequence
// edges (t's values outside [0, T) are never used). Equals two kernel-D
// pairs, with conv1's output kept in shared memory.
//
// Replaces the Pallas kernel flowhigh_tpu/ops/packed.py:
// pallas_packed_amp_unit (core _amp_unit_core, body _make_amp_unit_kernel),
// with its edge handling: the replicate substitution of conv1's output
// before act2 (packed.py:1190-1194) is the clamp of SmemSrc, the zero
// masks of both activations (:1186-1188, :1197-1199) are the core's. The
// subtile pipeline= interleave (:1212-1239) is TPU scheduling and has no
// counterpart.
//
// Layout: x, e0, e1, y [B, C, T]; w1, w2 [C, C, K]; alpha/beta [C]; all
// float32 and contiguous.
//
// Bound: f32 arithmetic, 2 T C^2 K multiply-adds per unit against one read
// of x (twice: conv1's input and the residual) and one write of y. Against
// two pairs the unit saves conv1's output write and read (8 bytes per
// element).
//
// Design: a block owns TT = BN - 2 H output samples of all C channels,
// H = (K - 1) / 2 + 6 (conv2's reach plus act2's), BN = 256. Phase 1 runs
// the act->conv pass of act_conv_core.cuh over BN samples starting H
// before the tile, for each 64-channel block of conv1's output, and keeps
// the result, C x BN floats, in shared memory (192 KB at C = 192, the
// widest stage that fits: ops/fused_conv.py:amp_unit_plan). Phase 2 runs
// the same pass for conv2 with the staged input read from there. A pass
// covers 96 output channels with 16 warps where 96 divides C (C = 192,
// 96), else 48 or 64 with 8 warps. The halo costs recompute: both convs
// run over BN samples for TT outputs, BN / TT = 1.06x (K = 3) to 1.09x
// (K = 11), and each activation runs C / 96 (2x at C = 192) times per
// sample, as in kernel D. Weights (w1 and w2: 2 C^2 K floats, 3.2 MB at
// C = 192, K = 11) are not resident: each block streams them through L2
// once per phase, staged by cp.async a chunk ahead of the GEMM.
//
// dot_dtype (dot_dtype.cuh, act_conv_core.cuh): BF16 and I8 instances round
// or quantise act1 and act2 in shared memory (conv1's output stays f32)
// and take rounded or quantised weights from the host. I8 takes one scale
// per phase: conv1's over act1 on [t0 - H - pad1, t0 + TT + H + pad1), by
// an act_amax pass over x before phase 1, and conv2's over act2 on
// [t0 - pad2, t0 + TT + pad2), by an act_amax pass over conv1's output in
// shared memory before phase 2; each pass runs once for all the phase's
// output-channel passes.

#include "act_conv_core.cuh"

namespace {

constexpr int NI = 8;  // samples per thread: a 256-sample pass
constexpr int BN = TX * NI;

// One block per SM at C >= 96 (its conv1 buffer alone is >= 96 KB); the
// 48-channel instance (C = 48: 76 KB) is capped for two blocks per SM.
// w1, w2 hold int32 values (by their bits) for I8, with sw1, sw2 the [C]
// scales
template <Dot D, int K, int CI, int TM, int TYB>
__global__ void __launch_bounds__(TX * TYB, TYB == 8 && TM == 6 ? 2 : 1)
amp_unit_kernel(const float* __restrict__ x, const float* __restrict__ a1,
                const float* __restrict__ be1, const float* __restrict__ a2,
                const float* __restrict__ be2, const float* filt,
                const float* __restrict__ w1, const float* __restrict__ sw1,
                const float* __restrict__ bias1,
                const float* __restrict__ w2, const float* __restrict__ sw2,
                const float* __restrict__ bias2,
                const float* __restrict__ e0, const float* __restrict__ e1,
                float* __restrict__ y, int C, int T, int dil, int logscale,
                float out_scale) {
  constexpr int BM = TM * TYB;
  constexpr int H = (K - 1) / 2 + 6;
  constexpr int TT = BN - 2 * H;
  extern __shared__ __align__(16) float smem[];
  float* t1 = smem;            // conv1's output [C][BN], positions t0 - H ..
  float* work = smem + C * BN;
  const int t0 = blockIdx.x * TT;
  const long long b = blockIdx.y;
  const float* xb = x + b * C * T;

  const GlobalSrc src1{xb, T};
  auto epi1 = [&](int co, int l, float acc) {
    t1[co * BN + l] = acc + (bias1 != nullptr ? bias1[co] : 0.0f);
  };
  Quant q{0.0f, 0.0f};
  if constexpr (D == Dot::I8)
    q = quant_of(act_amax<K, CI, TM, NI, TYB>(src1, work, filt, a1, be1,
                                              logscale, C, T, t0 - H, BN, dil));
  for (int co0 = 0; co0 < C; co0 += BM)
    act_conv_tile<D, K, CI, TM, NI, TYB>(src1, epi1, work, filt, a1, be1,
                                         logscale, w1, C, C, co0, T, t0 - H,
                                         dil, q, sw1);
  __syncthreads();  // all of conv1's output before phase 2 reads it

  const SmemSrc src2{t1, BN, t0 - H, T};
  const long long ob = b * C * T;
  auto epi2 = [&](int co, int l, float acc) {
    const int t = t0 + l;
    if (l >= TT || t >= T) return;
    const long long o = ob + (long long)co * T + t;
    float v = acc + (bias2 != nullptr ? bias2[co] : 0.0f);
    v += x[o];
    if (e0 != nullptr) v += e0[o];
    if (e1 != nullptr) v += e1[o];
    y[o] = v * out_scale;
  };
  if constexpr (D == Dot::I8)
    q = quant_of(act_amax<K, CI, TM, NI, TYB>(src2, work, filt, a2, be2,
                                              logscale, C, T, t0, TT, 1));
  for (int co0 = 0; co0 < C; co0 += BM)
    act_conv_tile<D, K, CI, TM, NI, TYB>(src2, epi2, work, filt, a2, be2,
                                         logscale, w2, C, C, co0, T, t0, 1, q,
                                         sw2);
}

template <int K, int CI, int TM, int TYB>
long long smem_bytes(int C, int dil) {
  return 4 * ((long long)C * BN +
              core_floats(K, CI, TM * TYB, BN, dil * (K - 1) / 2));
}

template <Dot D, int K, int CI, int TM, int TYB>
int launch(const float* x, const float* a1, const float* be1,
           const float* a2, const float* be2, const float* filt,
           const float* w1, const float* sw1, const float* bias1,
           const float* w2, const float* sw2, const float* bias2,
           const float* e0, const float* e1, float* y, int B, int C, int T,
           int dil, int logscale, float out_scale, cudaStream_t stream) {
  auto kern = amp_unit_kernel<D, K, CI, TM, TYB>;
  const long long smem = smem_bytes<K, CI, TM, TYB>(C, dil);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int TT = BN - 2 * ((K - 1) / 2 + 6);
  dim3 grid((T + TT - 1) / TT, B);
  kern<<<grid, TX * TYB, smem, stream>>>(x, a1, be1, a2, be2, filt, w1, sw1,
                                         bias1, w2, sw2, bias2, e0, e1, y, C,
                                         T, dil, logscale, out_scale);
  return (int)cudaGetLastError();
}

struct SmemQuery {
  int C, dil;
  template <int K, int CI, int TM, int TYB>
  long long run() const {
    return smem_bytes<K, CI, TM, TYB>(C, dil);
  }
};

template <Dot D>
struct Launcher {
  const float *x, *a1, *be1, *a2, *be2, *filt, *w1, *sw1, *bias1, *w2, *sw2,
      *bias2, *e0, *e1;
  float* y;
  int B, C, T, dil, logscale;
  float out_scale;
  cudaStream_t s;
  template <int K, int CI, int TM, int TYB>
  long long run() const {
    return launch<D, K, CI, TM, TYB>(x, a1, be1, a2, be2, filt, w1, sw1,
                                     bias1, w2, sw2, bias2, e0, e1, y, B, C,
                                     T, dil, logscale, out_scale, s);
  }
};

// one instance per (K, output-channel pass): 96 channels (16 warps) where
// 96 divides C, 48 where 48 divides C and 64 does not, else 64 (8 warps);
// CI = 4 / 2 / 2 input channels per chunk at K = 3 / 7 / 11; -1 without an
// instance
template <class F>
long long dispatch(int K, int C, const F& f) {
  const int kind = C % 96 == 0 ? 2 : (C % 48 == 0 && C % 64 != 0) ? 0 : 1;
#define FHT_CASE(K_, CI_)                                                  \
  case K_:                                                                 \
    return kind == 2   ? f.template run<K_, CI_, 6, 16>()                  \
           : kind == 0 ? f.template run<K_, CI_, 6, 8>()                   \
                       : f.template run<K_, CI_, 8, 8>();
  switch (K) {
    FHT_CASE(3, 4)
    FHT_CASE(7, 2)
    FHT_CASE(11, 2)
    default: return -1;
  }
#undef FHT_CASE
}

template <Dot D>
int amp_unit(const float* x, const float* a1, const float* be1,
             const float* a2, const float* be2, const float* filt,
             const float* w1, const float* sw1, const float* bias1,
             const float* w2, const float* sw2, const float* bias2,
             const float* e0, const float* e1, float* y, int B, int C, int T,
             int K, int dil, int logscale, float out_scale, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || dil <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Launcher<D> f{x,  a1,  be1, a2, be2, filt, w1, sw1, bias1, w2,
                      sw2, bias2, e0, e1, y, B, C, T, dil, logscale,
                      out_scale, (cudaStream_t)stream};
  const long long err = dispatch(K, C, f);
  return err < 0 ? (int)cudaErrorInvalidValue : (int)err;
}

}  // namespace

// Shared memory one block takes (bytes), -1 without an instance; mirrored
// by flowhigh_tpu_torch/ops/fused_conv.py:amp_unit_smem_bytes.
extern "C" long long amp_unit_smem_bytes(int K, int dil, int C) {
  return dispatch(K, C, SmemQuery{C, dil});
}

// Each returns cudaGetLastError() after the launch (or the error that kept
// it from launching). be1, be2, bias1, bias2, e0 and e1 may be null. Each
// block writes 256 - 2 ((K - 1) / 2 + 6) outputs of all C channels.
extern "C" int amp_unit_f32(const float* x, const float* a1, const float* be1,
                            const float* a2, const float* be2,
                            const float* filt, const float* w1,
                            const float* bias1, const float* w2,
                            const float* bias2, const float* e0,
                            const float* e1, float* y, int B, int C, int T,
                            int K, int dil, int logscale, float out_scale,
                            void* stream) {
  return amp_unit<Dot::F32>(x, a1, be1, a2, be2, filt, w1, nullptr, bias1, w2,
                            nullptr, bias2, e0, e1, y, B, C, T, K, dil,
                            logscale, out_scale, stream);
}

// w1, w2: the weights rounded to bf16 (as f32)
extern "C" int amp_unit_bf16(const float* x, const float* a1,
                             const float* be1, const float* a2,
                             const float* be2, const float* filt,
                             const float* w1, const float* bias1,
                             const float* w2, const float* bias2,
                             const float* e0, const float* e1, float* y,
                             int B, int C, int T, int K, int dil,
                             int logscale, float out_scale, void* stream) {
  return amp_unit<Dot::BF16>(x, a1, be1, a2, be2, filt, w1, nullptr, bias1,
                             w2, nullptr, bias2, e0, e1, y, B, C, T, K, dil,
                             logscale, out_scale, stream);
}

// wq1, wq2: int32 weights in [-127, 127], sw1, sw2: [C] scales
// (ops/quant.py)
extern "C" int amp_unit_int8(const float* x, const float* a1,
                             const float* be1, const float* a2,
                             const float* be2, const float* filt,
                             const int* wq1, const float* sw1,
                             const float* bias1, const int* wq2,
                             const float* sw2, const float* bias2,
                             const float* e0, const float* e1, float* y,
                             int B, int C, int T, int K, int dil,
                             int logscale, float out_scale, void* stream) {
  return amp_unit<Dot::I8>(x, a1, be1, a2, be2, filt,
                           reinterpret_cast<const float*>(wq1), sw1, bias1,
                           reinterpret_cast<const float*>(wq2), sw2, bias2, e0,
                           e1, y, B, C, T, K, dil, logscale, out_scale,
                           stream);
}
