// One pass of a second-order-section IIR cascade (direct form II
// transposed) over each row of a [rows, T] float32 array: the device half
// of flowhigh_tpu_torch/dsp/filters.py:sosfiltfilt, which pads and crops
// around two launches (forward, then reverse).
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's
// lax.scan in flowhigh_tpu/dsp/filters.py:_sosfilt (:67-98), which XLA
// compiles into one loop; eager PyTorch would issue ~9 launches per
// section per sample there. Arithmetic as that scan, in float32, per
// sample and section in turn:
//   y  = b0 v + z1;  z1 = (b1 v + z2) - a1 y;  z2 = b2 v - a2 y;  v = y
// each product and sum rounded on its own (__fmul_rn / __fadd_rn, never
// contracted into an FMA), so the kernel gives the plain version's bits
// (flowhigh_tpu_torch/ops/iir.py:sosfilt_plain).
//
// Design: one thread per row and pass. The recurrence is serial in time,
// so a row cannot be split; the cascade's coefficients (passed by value)
// and its 2 S states live in registers, the section count S is a template
// argument (1..MAX_SECTIONS) so that the cascade unrolls. A warp issues in
// order, so each sample runs its output chain through the S sections
// first (2 dependent operations a section) and updates the sections'
// states after it (independent of each other), instead of stalling on
// each section's updates in turn; the operations and their order per
// value are the scan's. Each thread keeps the next CHUNK samples' loads in
// flight while it filters the current CHUNK. Bound: not the bytes (16
// bytes a sample and pass) but the thread's serial instruction stream, 9 S
// float32 operations a sample, issued one a cycle per warp; a batch of 128
// rows keeps only 4 warps busy (chip_smoke.py phase D3 prints both
// bounds). Per-thread loads and stores touch 32 lines a warp instruction,
// which costs about as much again at small S.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MAX_SECTIONS = 8;
constexpr int CHUNK = 16;  // samples a thread loads ahead
constexpr int BLOCK = 32;  // one warp, 32 rows
constexpr int COEFS = 7;   // b0 b1 b2 a1 a2 zi0 zi1 (a0 == 1)

struct Cascade {
  float c[MAX_SECTIONS][COEFS];
};

// samples t0 .. t0 + CHUNK - 1 of a row in pass order (0 past the end)
__device__ __forceinline__ void load_chunk(const float* xr, int T, int t0,
                                           int reverse, float* v) {
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const int t = t0 + j;
    v[j] = t < T ? xr[reverse ? T - 1 - t : t] : 0.f;
  }
}

template <int S>
__global__ void __launch_bounds__(BLOCK)
sosfilt_kernel(Cascade k, const float* __restrict__ x, float* __restrict__ y,
               int rows, int T, int reverse) {
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= rows) return;
  const float* xr = x + static_cast<size_t>(r) * T;
  float* yr = y + static_cast<size_t>(r) * T;

  float b0[S], b1[S], b2[S], a1[S], a2[S], z1[S], z2[S];
  // the initial state: sosfilt_zi scaled by the pass's first sample
  const float x0 = xr[reverse ? T - 1 : 0];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    b0[s] = k.c[s][0];
    b1[s] = k.c[s][1];
    b2[s] = k.c[s][2];
    a1[s] = k.c[s][3];
    a2[s] = k.c[s][4];
    z1[s] = __fmul_rn(k.c[s][5], x0);
    z2[s] = __fmul_rn(k.c[s][6], x0);
  }

  float cur[CHUNK], nxt[CHUNK];
  load_chunk(xr, T, 0, reverse, cur);
  for (int t0 = 0; t0 < T; t0 += CHUNK) {
    load_chunk(xr, T, t0 + CHUNK, reverse, nxt);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      // y = b0 v + z1 through the sections, then each section's
      // z1 = (b1 v + z2) - a1 y and z2 = b2 v - a2 y
      float in[S], out[S];
      float u = cur[j];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        in[s] = u;
        u = __fadd_rn(__fmul_rn(b0[s], u), z1[s]);
        out[s] = u;
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        z1[s] = __fsub_rn(__fadd_rn(__fmul_rn(b1[s], in[s]), z2[s]),
                          __fmul_rn(a1[s], out[s]));
        z2[s] = __fsub_rn(__fmul_rn(b2[s], in[s]), __fmul_rn(a2[s], out[s]));
      }
      const int t = t0 + j;
      if (t < T) yr[reverse ? T - 1 - t : t] = u;
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) cur[j] = nxt[j];
  }
}

template <int S>
cudaError_t launch(const Cascade& k, const float* x, float* y, int rows,
                   int T, int reverse, cudaStream_t stream) {
  const int blocks = (rows + BLOCK - 1) / BLOCK;
  sosfilt_kernel<S><<<blocks, BLOCK, 0, stream>>>(k, x, y, rows, T, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sosfilt_max_sections() { return MAX_SECTIONS; }

// coef: host pointer to n_sections x 7 floats (b0 b1 b2 a1 a2 zi0 zi1);
// x, y: device [rows, T] float32, contiguous, not overlapping; reverse != 0
// runs the pass from the last sample to the first. Returns a CUDA error code
// (cudaErrorInvalidValue for a section count without an instance).
int sosfilt_f32(const float* coef, int n_sections, const float* x, float* y,
                int rows, int T, int reverse, void* stream) {
  if (n_sections < 1 || n_sections > MAX_SECTIONS || rows < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Cascade k{};
  for (int s = 0; s < n_sections; ++s)
    for (int j = 0; j < COEFS; ++j) k.c[s][j] = coef[s * COEFS + j];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_sections) {
    case 1: err = launch<1>(k, x, y, rows, T, reverse, st); break;
    case 2: err = launch<2>(k, x, y, rows, T, reverse, st); break;
    case 3: err = launch<3>(k, x, y, rows, T, reverse, st); break;
    case 4: err = launch<4>(k, x, y, rows, T, reverse, st); break;
    case 5: err = launch<5>(k, x, y, rows, T, reverse, st); break;
    case 6: err = launch<6>(k, x, y, rows, T, reverse, st); break;
    case 7: err = launch<7>(k, x, y, rows, T, reverse, st); break;
    default: err = launch<8>(k, x, y, rows, T, reverse, st); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
