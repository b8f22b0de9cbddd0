// Native host-DSP kernels for the training degradation pipeline.
//
// The reference runs its per-clip degradation (Chebyshev-I sosfiltfilt +
// down/up resample_poly) in torch DataLoader worker processes, leaning on
// scipy's Cython kernels (reference: src/flowhigh/train/data.py:92-131).
// This library re-implements the two hot primitives — zero-phase biquad
// cascade filtering and polyphase FIR rational resampling — as plain C++
// matched to scipy.signal semantics bit-for-bit-close (same padding, same
// initial conditions, same output alignment), so host workers can feed the
// TPU at a multiple of the scipy rate. Filter *design* (cheby1, firwin)
// stays in Python where it is cached per (order, ripple, cutoff) — design
// is data-independent and tiny once cached.
//
// Exposed C ABI (ctypes-friendly, all int64/double):
//   fh_sosfilt      — DF2T biquad cascade with explicit state in/out
//   fh_sosfilt_zi   — scipy.signal.sosfilt_zi (steady-state step response)
//   fh_sosfiltfilt  — scipy.signal.sosfiltfilt (odd ext, zi-scaled fwd/bwd)
//   fh_upfirdn      — scipy.signal.upfirdn output range [k0, k0+nk)
//   fh_degrade      — fused cheby1-filtfilt + down + up chain (one call)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Fixed-section-count cascade: coefficients and state live in registers, the
// section loop fully unrolls. NS covers cheby1 order 1-11 (1-6 sections);
// larger cascades take the generic path.
template <int NS>
void sosfilt_fixed(const double* sos, const double* x, int64_t n, double* zi,
                   double* y) {
  double b0[NS], b1[NS], b2[NS], a1[NS], a2[NS], z1[NS], z2[NS];
  for (int s = 0; s < NS; ++s) {
    b0[s] = sos[s * 6 + 0]; b1[s] = sos[s * 6 + 1]; b2[s] = sos[s * 6 + 2];
    a1[s] = sos[s * 6 + 4]; a2[s] = sos[s * 6 + 5];
    z1[s] = zi[s * 2]; z2[s] = zi[s * 2 + 1];
  }
  for (int64_t i = 0; i < n; ++i) {
    double v = x[i];
#pragma GCC unroll 8
    for (int s = 0; s < NS; ++s) {
      double out = b0[s] * v + z1[s];
      z1[s] = b1[s] * v + z2[s] - a1[s] * out;
      z2[s] = b2[s] * v - a2[s] * out;
      v = out;
    }
    y[i] = v;
  }
  for (int s = 0; s < NS; ++s) {
    zi[s * 2] = z1[s];
    zi[s * 2 + 1] = z2[s];
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Direct-form II transposed biquad cascade.
// sos: [ns, 6] rows (b0 b1 b2 a0 a1 a2), a0 == 1 (caller normalizes).
// zi: [ns, 2] state, updated in place.

void fh_sosfilt(const double* sos, int64_t ns, const double* x, int64_t n,
                double* zi, double* y) {
  switch (ns) {
    case 1: return sosfilt_fixed<1>(sos, x, n, zi, y);
    case 2: return sosfilt_fixed<2>(sos, x, n, zi, y);
    case 3: return sosfilt_fixed<3>(sos, x, n, zi, y);
    case 4: return sosfilt_fixed<4>(sos, x, n, zi, y);
    case 5: return sosfilt_fixed<5>(sos, x, n, zi, y);
    case 6: return sosfilt_fixed<6>(sos, x, n, zi, y);
    default: break;
  }
  std::vector<double> c(sos, sos + ns * 6);
  std::vector<double> z(zi, zi + ns * 2);
  for (int64_t i = 0; i < n; ++i) {
    double v = x[i];
    for (int64_t s = 0; s < ns; ++s) {
      const double* k = &c[s * 6];
      double z1 = z[s * 2], z2 = z[s * 2 + 1];
      double out = k[0] * v + z1;
      z[s * 2] = k[1] * v + z2 - k[4] * out;
      z[s * 2 + 1] = k[2] * v - k[5] * out;
      v = out;
    }
    y[i] = v;
  }
  std::memcpy(zi, z.data(), static_cast<size_t>(ns) * 2 * sizeof(double));
}

// ---------------------------------------------------------------------------
// scipy.signal.sosfilt_zi: per-section lfilter_zi chained through the
// cascade's cumulative DC gain. For a 2nd-order section the lfilter_zi
// linear system (I - companion(a).T) zi = b[1:] - a[1:] b[0] reduces to a
// closed-form 2x2 solve.
void fh_sosfilt_zi(const double* sos, int64_t ns, double* zi) {
  double scale = 1.0;
  for (int64_t s = 0; s < ns; ++s) {
    const double* k = sos + s * 6;
    double a0 = k[3];
    double b0 = k[0] / a0, b1 = k[1] / a0, b2 = k[2] / a0;
    double a1 = k[4] / a0, a2 = k[5] / a0;
    double B0 = b1 - a1 * b0, B1 = b2 - a2 * b0;
    double det = 1.0 + a1 + a2;
    zi[s * 2] = scale * (B0 + B1) / det;
    zi[s * 2 + 1] = scale * ((1.0 + a1) * B1 - a2 * B0) / det;
    scale *= (b0 + b1 + b2) / det;
  }
}

// ---------------------------------------------------------------------------
// scipy.signal.sosfiltfilt with padtype='odd', padlen=edge (caller computes
// scipy's default edge = 3 * (2*ns + 1 - min(#b2==0, #a2==0)) and validates
// n > edge). Forward pass seeded with zi*ext[0], backward with zi*y[-1].
void fh_sosfiltfilt(const double* sos, int64_t ns, const double* x, int64_t n,
                    int64_t edge, double* y) {
  int64_t ne = n + 2 * edge;
  std::vector<double> ext(ne);
  for (int64_t i = 0; i < edge; ++i) ext[i] = 2.0 * x[0] - x[edge - i];
  std::memcpy(ext.data() + edge, x, static_cast<size_t>(n) * sizeof(double));
  for (int64_t i = 0; i < edge; ++i)
    ext[edge + n + i] = 2.0 * x[n - 1] - x[n - 2 - i];

  std::vector<double> zi0(ns * 2), zi(ns * 2), fwd(ne), bwd(ne);
  fh_sosfilt_zi(sos, ns, zi0.data());
  for (int64_t k = 0; k < ns * 2; ++k) zi[k] = zi0[k] * ext[0];
  fh_sosfilt(sos, ns, ext.data(), ne, zi.data(), fwd.data());

  std::reverse(fwd.begin(), fwd.end());
  for (int64_t k = 0; k < ns * 2; ++k) zi[k] = zi0[k] * fwd[0];
  fh_sosfilt(sos, ns, fwd.data(), ne, zi.data(), bwd.data());

  // bwd is reversed-time output; undo the reversal while cropping the pads.
  for (int64_t i = 0; i < n; ++i) y[i] = bwd[ne - 1 - edge - i];
}

// ---------------------------------------------------------------------------
// scipy.signal.upfirdn, output indices [k0, k0+nk). Output k corresponds to
// position t = k*down on the up-sampled grid: y[k] = sum_j h[j]*xup[t-j]
// with xup[m*up] = x[m]. Indices past the end of h (scipy's trailing
// zero-pad) contribute zero and are handled by the m_lo/m_hi clamps.
void fh_upfirdn(const double* h, int64_t nh, const double* x, int64_t nx,
                int64_t up, int64_t down, int64_t k0, int64_t nk, double* y) {
  if (up == 1) {
    // Pure decimation: contiguous dot product of up to nh taps per output.
    for (int64_t k = 0; k < nk; ++k) {
      int64_t t = (k0 + k) * down;
      int64_t m_lo = std::max<int64_t>(0, t - nh + 1);
      int64_t m_hi = std::min<int64_t>(nx - 1, t);
      double acc0 = 0.0, acc1 = 0.0, acc2 = 0.0, acc3 = 0.0;
      const double* hp = h + (t - m_lo);  // h index decreases as m increases
      const double* xp = x + m_lo;
      int64_t len = m_hi - m_lo + 1;
      int64_t i = 0;
      for (; i + 4 <= len; i += 4) {
        acc0 += hp[-(i + 0)] * xp[i + 0];
        acc1 += hp[-(i + 1)] * xp[i + 1];
        acc2 += hp[-(i + 2)] * xp[i + 2];
        acc3 += hp[-(i + 3)] * xp[i + 3];
      }
      for (; i < len; ++i) acc0 += hp[-i] * xp[i];
      y[k] = (acc0 + acc1) + (acc2 + acc3);
    }
    return;
  }
  // up > 1: phase-decomposed polyphase. Output k sits at t = k*down on the
  // up-grid with phase p = t mod up; only taps h[p], h[p+up], ... touch real
  // input samples. Pre-reversing each phase's taps turns every output into a
  // CONTIGUOUS dot product hr_p[off+m] * x[m] (both stride 1 -> SIMD), where
  // for L_p taps and q = t/up: off = L_p - 1 - q.
  int64_t lmax = (nh + up - 1) / up;
  std::vector<double> hrb(static_cast<size_t>(up) * lmax, 0.0);
  std::vector<int64_t> lp(up);
  for (int64_t p = 0; p < up; ++p) {
    int64_t L = p < nh ? (nh - p + up - 1) / up : 0;
    lp[p] = L;
    double* dst = &hrb[p * lmax];
    for (int64_t i = 0; i < L; ++i) dst[i] = h[p + (L - 1 - i) * up];
  }
  for (int64_t k = 0; k < nk; ++k) {
    int64_t t = (k0 + k) * down;
    int64_t p = t % up, q = t / up;
    int64_t L = lp[p];
    int64_t m_lo = std::max<int64_t>(0, q - (L - 1));
    int64_t m_hi = std::min<int64_t>(nx - 1, q);
    const double* hp = &hrb[p * lmax] + (L - 1 - q) + m_lo;
    const double* xp = x + m_lo;
    int64_t len = m_hi - m_lo + 1;
    double acc0 = 0.0, acc1 = 0.0, acc2 = 0.0, acc3 = 0.0;
    int64_t i = 0;
    for (; i + 4 <= len; i += 4) {
      acc0 += hp[i + 0] * xp[i + 0];
      acc1 += hp[i + 1] * xp[i + 1];
      acc2 += hp[i + 2] * xp[i + 2];
      acc3 += hp[i + 3] * xp[i + 3];
    }
    for (; i < len; ++i) acc0 += hp[i] * xp[i];
    y[k] = (acc0 + acc1) + (acc2 + acc3);
  }
}

// ---------------------------------------------------------------------------
// Fused degradation chain (reference: src/flowhigh/train/data.py:110-123):
//   filtered = sosfiltfilt(sos, wave)
//   down     = resample_poly(filtered, random_sr, sr)
//   up       = resample_poly(down, sr, random_sr)
// The caller supplies the designed filters plus scipy's resample_poly
// alignment (k0 = n_pre_remove) and output lengths for both stages; the
// final output is end-padded/cropped to n_out samples (matching wave).
void fh_degrade(const double* sos, int64_t ns, int64_t edge,
                const double* wave, int64_t n,
                const double* h_dn, int64_t nh_dn, int64_t dn_up,
                int64_t dn_down, int64_t dn_k0, int64_t n_mid,
                const double* h_up, int64_t nh_up, int64_t up_up,
                int64_t up_down, int64_t up_k0, int64_t n_up,
                double* out, int64_t n_out) {
  std::vector<double> filt(n), mid(n_mid), up(n_up);
  fh_sosfiltfilt(sos, ns, wave, n, edge, filt.data());
  fh_upfirdn(h_dn, nh_dn, filt.data(), n, dn_up, dn_down, dn_k0, n_mid,
             mid.data());
  fh_upfirdn(h_up, nh_up, mid.data(), n_mid, up_up, up_down, up_k0, n_up,
             up.data());
  int64_t ncopy = std::min(n_up, n_out);
  std::memcpy(out, up.data(), static_cast<size_t>(ncopy) * sizeof(double));
  for (int64_t i = ncopy; i < n_out; ++i) out[i] = 0.0;
}

}  // extern "C"
