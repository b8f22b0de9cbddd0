// The snake of kernel A's instances and of probe kernels G and H, one
// function so that G and H measure A's arithmetic floor with A's own
// arithmetic:
//   snake(u) = u + sin^2(a u) / b,
// with inv_b = 1 / (b + 1e-9) and a, b already exp'd.
//
// The sine (sin_pi_reduced) has no slow path, no branch and no local
// memory. sin^2 has period pi, so t = a u is reduced by pi, not 2 pi:
//   k = rint(t / pi)          (t * 1/pi + 1.5 * 2^23 - 1.5 * 2^23)
//   r = t - k pi              (Cody-Waite, two constants, in FMAs: the
//                              first step is exact, the second rounds once)
//   sin(r) = r + r^3 P(r^2)   (P of degree 3 in r^2, minimax for absolute
//                              error on |r| <= pi / 2 + 2e-3: 4.7e-9)
// which is (-1)^k sin(t). Worst-case absolute error against sin in float64:
// 1.34e-7 over every float32 |t| in [2^-20, 2^15] (exhaustive; below 2^-20
// the error is under 1e-18), the precise sinf's own order (about 1 ulp near
// |sin| = 1). tests/test_torch_snake_plan.py emulates these steps in float32
// and holds them to that bound. Past 2^15 the error grows with k (the
// constants' rounding times k), and past |t| = 2^22 the rounding trick no
// longer gives an integer k; the vocoder's activations stay far below
// (chip_smoke.py prints the largest |a u| a clip reaches on the card).
// Every step is an explicit rounding (fmaf, __fmul_rn, __fsub_rn), so the
// compiler contracts nothing and the CPU emulation is step for step.
#pragma once

namespace snake_sin {
constexpr float kInvPi = 0x1.45f306p-2f;  // float32(1 / pi)
constexpr float kRound = 0x1.8p23f;       // 1.5 * 2^23: adding it rounds to
                                          // an integer for |x| < 2^22
constexpr float kPi1 = 0x1.921fb6p+1f;    // float32(pi)
constexpr float kPi2 = -0x1.777a5cp-24f;  // float32(pi - kPi1)
constexpr float kS3 = -0x1.555548p-3f;    // sin(r) = r + r^3 (kS3 + r^2 (kS5
constexpr float kS5 = 0x1.110e66p-7f;     //   + r^2 (kS7 + r^2 kS9)))
constexpr float kS7 = -0x1.9f5f06p-13f;
constexpr float kS9 = 0x1.5cebf0p-19f;
}  // namespace snake_sin

// (-1)^k sin(t) = sin(t - k pi), k = rint(t / pi): sin(t) up to its sign.
__device__ __forceinline__ float sin_pi_reduced(float t) {
  using namespace snake_sin;
  const float k = __fsub_rn(fmaf(t, kInvPi, kRound), kRound);
  float r = fmaf(-k, kPi1, t);
  r = fmaf(-k, kPi2, r);
  const float r2 = __fmul_rn(r, r);
  float p = fmaf(kS9, r2, kS7);
  p = fmaf(p, r2, kS5);
  p = fmaf(p, r2, kS3);
  return fmaf(__fmul_rn(p, r2), r, r);
}

__device__ __forceinline__ float snake_fn(float u, float a, float inv_b) {
  const float p = sin_pi_reduced(__fmul_rn(a, u));
  return fmaf(inv_b, __fmul_rn(p, p), u);
}
