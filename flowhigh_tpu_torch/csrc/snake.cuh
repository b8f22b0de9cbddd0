// The snake of kernel A's instances and of probe kernel G, one function so
// that G measures A's arithmetic floor with A's own arithmetic:
//   snake(u) = u + sin^2(a u) / b  ==  u + h - h cos(2 a u),  h = 0.5 / b,
// with inv_b = 1 / (b + 1e-9) and a, b already exp'd. The sine is the
// precise sinf (the JAX package's polynomial fast_cos works around the
// TPU's slow builtin cos and is not ported).
#pragma once

__device__ __forceinline__ float snake_fn(float u, float a, float inv_b) {
  const float p = sinf(a * u);
  return u + inv_b * (p * p);
}
