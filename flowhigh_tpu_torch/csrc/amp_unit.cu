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
// Bound (a 10 s clip, 27 launches at C = 192, 96 and 48): operations.
// F32 runs each product as three TF32 products on the tensor cores
// (3xTF32: 4.74 TFLOP of TF32 products, 9.6 ms at 495 TFLOP/s), BF16 one
// bf16 product (2.6 ms); the two snakes add ~112 f32 operations a sample
// and channel. Against two kernel-D pairs the unit saves conv1's output
// write and read (8 bytes an element).
//
// Design: a block owns TT = BN - 2 H output samples of all C channels,
// H = (K - 1) / 2 + 6 (conv2's reach plus act2's). Phase 1 runs the
// act->conv pass of act_conv_core.cuh over BN samples starting H before
// the tile, for each BM-channel block of conv1's output, and keeps the
// result, C x BN floats, in shared memory. Phase 2 runs the same pass for
// conv2 with its src read from there. Weights (w1 and w2, 3.2 MB at
// C = 192, K = 11) are not resident: each block streams them through L2
// once per phase. Two routes, as the core's:
// - F32, BF16 (act_conv_mma, 8 warps): BN = 192 and one pass of BM = 192
//   channels at C = 192 (warps 4 along channels x 2 along time, each
//   48 x 96), so each activation runs once per sample: 147,456 bytes of
//   conv1 output leave room for the pass's working set, up to 78,688 bytes
//   (BF16, K = 11, d = 5), where BN = 256 would not (196,608 bytes). The
//   halo costs BN / TT = 1.08x (K = 3) to 1.13x (K = 11) of the unit's
//   work. At C = 96 and 48: one pass of BM = 96 (2 x 4 warps) or 48
//   (1 x 8); BF16 over BN = 128, so that two blocks share an SM and one's
//   snake runs beside the other's GEMM (1.12-1.21x halo work), F32 over
//   BN = 256 (1.06-1.09x; its GEMM dominates, and 128 ran 1.03-1.25x
//   slower); any other C: BN = 192, BM = 64 (2 x 4). 16 warps a block
//   (48 x 48 a warp at C = 192) ran slower or spilled at 128 registers,
//   except E.bf16 at C = 192 (PERF.md). Weights: kernel B's prepared
//   layout [K][C_p][C_p] (ops/conv.py:conv_weights), f32 or bf16.
// - I8 (act_conv_tile, the FMA route): BN = 256; a pass covers 96 output
//   channels with 16 warps where 96 divides C (C = 192, 96), else 48 or 64
//   with 8 warps; each activation runs C / 96 times per sample (2x at
//   C = 192). act1 and act2 are quantised in shared memory (conv1's output
//   stays f32), without FMAs (ORDERED in act_conv_core.cuh). One scale per
//   phase: conv1's over act1 on [t0 - H - pad1, t0 + TT + H + pad1), by an
//   act_amax pass over x before phase 1, and conv2's over act2 on
//   [t0 - pad2, t0 + TT + pad2), by an act_amax pass over conv1's output
//   in shared memory before phase 2. Weights: [C][C][K] int32 values with
//   [C] scales.
//
// The unit's tile TT is mirrored by ops/fused_conv.py:amp_unit_plan.

#include "act_conv_core.cuh"

namespace {

// --- F32, BF16: the tensor-core route -------------------------------------------

// blocks an SM: two where a pass has at most 96 x 128 outputs (at most 128
// registers a thread), else one (up to 255)
__host__ __device__ constexpr int unit_min_blocks(int BM, int BN) {
  return BM * BN <= 96 * 128 ? 2 : 1;
}

template <Dot D, int K, int BM, int BN, int WM>
__global__ void __launch_bounds__(MMA_NT, unit_min_blocks(BM, BN))
amp_unit_mma_kernel(const float* __restrict__ x, const float* __restrict__ a1,
                    const float* __restrict__ be1,
                    const float* __restrict__ a2,
                    const float* __restrict__ be2,
                    const typename MmaOps<D>::WT* __restrict__ w1,
                    const float* __restrict__ bias1,
                    const typename MmaOps<D>::WT* __restrict__ w2,
                    const float* __restrict__ bias2,
                    const float* __restrict__ e0, const float* __restrict__ e1,
                    float* __restrict__ y, int C, int T, int cin_p,
                    int cout_p, int dil, int logscale, float out_scale) {
  constexpr int H = (K - 1) / 2 + 6;
  constexpr int TT = BN - 2 * H;
  // F32 short of registers (LEAN and NP in act_conv_core.cuh): the
  // one-position snake at 192 x 192 (up to 255 registers; the two-position
  // one spilled 4-28 bytes there, and LEAN did not help), LEAN at two
  // blocks an SM (128)
  constexpr int NP = D == Dot::F32 && BM * BN > 96 * 256 ? 1 : 2;
  constexpr bool LEAN = D == Dot::F32 && unit_min_blocks(BM, BN) == 2;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  float* t1 = reinterpret_cast<float*>(smem_mma);  // [C][BN], from t0 - H
  unsigned char* work = smem_mma + (long long)C * BN * 4;
  const int t0 = blockIdx.x * TT;
  const long long b = blockIdx.y;

  auto epi1 = [&](int co, int l, float acc) {
    t1[co * BN + l] = acc + (bias1 != nullptr ? bias1[co] : 0.0f);
  };
  for (int co0 = 0; co0 < C; co0 += BM)
    act_conv_mma<D, K, BM, BN, WM, LEAN, NP, false>(
        GlobalSrc{x + b * C * T, T}, epi1, work, a1, be1, logscale, w1, C, C,
        cin_p, cout_p, co0, T, t0 - H, dil);

  // each pass starts with a barrier: phase 1's writes of t1 are complete
  // before phase 2 stages from it
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
  for (int co0 = 0; co0 < C; co0 += BM)
    act_conv_mma<D, K, BM, BN, WM, LEAN, NP, false>(
        SmemSrc{t1, BN, t0 - H, T}, epi2, work, a2, be2, logscale, w2, C, C,
        cin_p, cout_p, co0, T, t0, 1);
}

template <int K, int BM, int BN, int WM>
long long mma_smem_bytes(int C, int dil, bool bf) {
  return (long long)C * BN * 4 +
         mma_core_bytes(BM, BN, dil * (K - 1) / 2, bf, false);
}

// the tile (BM, BN, warps along channels) of C for BF16 (BF) or F32; -1
// without an instance
template <bool BF, class F>
long long dispatch_mma(int K, int C, const F& f) {
  const int kind = C % 192 == 0 ? 0 : C % 96 == 0 ? 1 : C % 48 == 0 ? 2 : 3;
  constexpr int BN2 = BF ? 128 : 256;  // the pass at C = 96, 48
#define FHT_CASE(K_)                                                       \
  case K_:                                                                 \
    return kind == 0   ? f.template run<K_, 192, 192, 4>()                 \
           : kind == 1 ? f.template run<K_, 96, BN2, 2>()                  \
           : kind == 2 ? f.template run<K_, 48, BN2, 1>()                  \
                       : f.template run<K_, 64, 192, 2>();
  switch (K) {
    FHT_CASE(3)
    FHT_CASE(7)
    FHT_CASE(11)
    default: return -1;
  }
#undef FHT_CASE
}

struct MmaSmemQuery {
  int C, dil;
  bool bf;
  template <int K, int BM, int BN, int WM>
  long long run() const {
    return mma_smem_bytes<K, BM, BN, WM>(C, dil, bf);
  }
};

template <Dot D>
struct MmaLauncher {
  const float *x, *a1, *be1, *a2, *be2, *filt;
  const void* w1;
  const float* bias1;
  const void* w2;
  const float *bias2, *e0, *e1;
  float* y;
  int B, C, T, cin_p, cout_p, dil, logscale;
  float out_scale;
  cudaStream_t s;
  template <int K, int BM, int BN, int WM>
  long long run() const {
    using WT = typename MmaOps<D>::WT;
    auto kern = amp_unit_mma_kernel<D, K, BM, BN, WM>;
    const long long smem =
        mma_smem_bytes<K, BM, BN, WM>(C, dil, MmaOps<D>::BF);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = set_taps(filt, s);
    if (e != cudaSuccess) return (int)e;
    constexpr int TT = BN - 2 * ((K - 1) / 2 + 6);
    dim3 grid((T + TT - 1) / TT, B);
    kern<<<grid, MMA_NT, smem, s>>>(
        x, a1, be1, a2, be2, static_cast<const WT*>(w1), bias1,
        static_cast<const WT*>(w2), bias2, e0, e1, y, C, T, cin_p, cout_p, dil,
        logscale, out_scale);
    return (int)cudaGetLastError();
  }
};

template <Dot D>
int amp_unit_mma(const float* x, const float* a1, const float* be1,
                 const float* a2, const float* be2, const float* filt,
                 const void* w1, const float* bias1, const void* w2,
                 const float* bias2, const float* e0, const float* e1,
                 float* y, int B, int C, int T, int K, int dil, int logscale,
                 int cin_p, int cout_p, float out_scale, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || dil <= 0 || B > 65535 || cin_p < C ||
      cin_p % 16 != 0 || cout_p < C)
    return (int)cudaErrorInvalidValue;
  const MmaLauncher<D> f{x,     a1, be1,   a2,     be2, filt,     w1,
                         bias1, w2, bias2, e0,     e1,  y,        B,
                         C,     T,  cin_p, cout_p, dil, logscale, out_scale,
                         (cudaStream_t)stream};
  const long long err = dispatch_mma<MmaOps<D>::BF>(K, C, f);
  return err < 0 ? (int)cudaErrorInvalidValue : (int)err;
}

// --- I8: the FMA route ---------------------------------------------------------------

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

// Shared memory one block of instance ``dot`` (0 f32, 1 bf16, 2 int8) takes
// (bytes), -1 without an instance; mirrored by
// flowhigh_tpu_torch/ops/fused_conv.py:amp_unit_smem_bytes.
extern "C" long long amp_unit_smem_bytes(int K, int dil, int C, int dot) {
  if (dot == (int)Dot::I8) return dispatch(K, C, SmemQuery{C, dil});
  return dot == (int)Dot::BF16
             ? dispatch_mma<true>(K, C, MmaSmemQuery{C, dil, true})
             : dispatch_mma<false>(K, C, MmaSmemQuery{C, dil, false});
}

// Each returns cudaGetLastError() after the launch (or the error that kept
// it from launching). be1, be2, bias1, bias2, e0 and e1 may be null. w1,
// w2: kernel B's prepared weights [K][cout_p][cin_p]
// (ops/conv.py:conv_weights), float32 for amp_unit_f32 and bfloat16
// (rounded to nearest even) for amp_unit_bf16; cin_p a multiple of 16.
extern "C" int amp_unit_f32(const float* x, const float* a1, const float* be1,
                            const float* a2, const float* be2,
                            const float* filt, const void* w1,
                            const float* bias1, const void* w2,
                            const float* bias2, const float* e0,
                            const float* e1, float* y, int B, int C, int T,
                            int K, int dil, int logscale, int cin_p,
                            int cout_p, float out_scale, void* stream) {
  return amp_unit_mma<Dot::F32>(x, a1, be1, a2, be2, filt, w1, bias1, w2,
                                bias2, e0, e1, y, B, C, T, K, dil, logscale,
                                cin_p, cout_p, out_scale, stream);
}

extern "C" int amp_unit_bf16(const float* x, const float* a1,
                             const float* be1, const float* a2,
                             const float* be2, const float* filt,
                             const void* w1, const float* bias1,
                             const void* w2, const float* bias2,
                             const float* e0, const float* e1, float* y,
                             int B, int C, int T, int K, int dil,
                             int logscale, int cin_p, int cout_p,
                             float out_scale, void* stream) {
  return amp_unit_mma<Dot::BF16>(x, a1, be1, a2, be2, filt, w1, bias1, w2,
                                 bias2, e0, e1, y, B, C, T, K, dil, logscale,
                                 cin_p, cout_p, out_scale, stream);
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
