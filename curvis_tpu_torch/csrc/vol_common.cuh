// The emission of the flared Gaussian gas disk shared by the volumetric
// marches: the planar ones (disk_vol.cu and planar_rk45_disk.cu, through
// planar_vol.cuh) and the Boyer-Lindquist ones (kerr.cu, kerr_rk45.cu).  The Planck constants, the starlight scattering source and
// the colour tail (blackbody or tint) are the TPU kernels' _vol_emission
// and _kerr_vol_emission (curvis_tpu/ops/march_pallas.py), which share
// them too.
#pragma once

#include "planar.cuh"

namespace curvis {

constexpr int kScatterDeg = 7;
constexpr int kScatterBlock = 3 + 3 * (kScatterDeg + 1);   // = 27

// The eight emission slots after (r_in, r_out) in both families' rows
// (VOL_SLOT of curvis_tpu/ops/march_pallas.py).
struct VolSlots {
  float h2;          // h_rel^2
  float inv_norm;    // 1 / (sqrt(2 pi) h_rel)
  float kappa;
  float tau_max;
  float t_peak;
  float emis_q;      // emissivity index
  float spin_sign;
  float t_scale;     // t_peak / f_peak
};

// c2 / lambda and -5 ln lambda at the three sample wavelengths (610, 550,
// 465 nm), as the TPU kernel's _VOL_BB_K and _VOL_BB_L5 (the logs in
// double, from numpy).
constexpr float kBbK0 = static_cast<float>(1.4388e-2 / 610e-9);
constexpr float kBbK1 = static_cast<float>(1.4388e-2 / 550e-9);
constexpr float kBbK2 = static_cast<float>(1.4388e-2 / 465e-9);
constexpr float kBbL50 = static_cast<float>(71.54903439889527);
constexpr float kBbL51 = static_cast<float>(72.06673779359947);
constexpr float kBbL52 = static_cast<float>(72.90614215679527);

// ln of the Planck radiance at one wavelength, up to a common constant:
// -5 ln lambda - ln(e^x - 1), x = c2 / (lambda T), with
// ln(e^x - 1) = x + ln(1 - e^-x) (no overflow for cold T).
__device__ __forceinline__ float planck_log(float k, float l5, float inv_T) {
  const float x = k * inv_T;
  return l5 - (x + logf(max_nan(1.0f - expf(-x), 1e-30f)));
}

// The single-scattering source of the lensed sky at cylindrical radius
// r_cyl: per channel the Horner sum of the block's monomials in the
// compactified radius t (clipped at 0: a least-squares fit may
// undershoot), times sw = e^-tau * density.  `blk` is the 27-scalar block
// [tint_r, tint_g, tint_b, 3 x (kScatterDeg + 1) monomials].
__device__ __forceinline__ void scatter_source(const float* blk, float r_cyl,
                                               float r_in, float r_out,
                                               float sw, float* scat) {
  const float t =
      clip_nan(2.0f * (r_cyl - r_in) / (r_out - r_in) - 1.0f, -1.0f, 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int c0 = 3 + c * (kScatterDeg + 1);
    float acc = blk[c0 + kScatterDeg];
#pragma unroll
    for (int k = kScatterDeg - 1; k >= 0; --k) acc = acc * t + blk[c0 + k];
    scat[c] = sw * max_nan(acc, 0.0f);
  }
}

// The emission per unit step at radius rr = max(r_cyl, r_in) with total
// shift g, given tb = e^-tau * density: Planck colours of the observed
// Shakura-Sunyaev temperature g T(rr) weighted by (T_obs / t_peak)^4
// (BLACKBODY), else the grey power law (r_in / rr)^q g^3 — tinted per
// channel with the scattered light added when SCATTER (scattered light is
// coloured), the same grey value in all three channels otherwise.
template <bool BLACKBODY, bool SCATTER>
__device__ __forceinline__ void vol_color(const VolSlots& v, float r_in,
                                          float rr, float g, float tb,
                                          const float* blk,
                                          const float* scat, float* dem) {
  if constexpr (BLACKBODY) {
    const float sq = sqrtf(r_in / rr);
    const float ln_r = logf(rr);
    const float f =
        expf(-0.75f * ln_r + 0.25f * logf(max_nan(1.0f - sq, 1e-20f)));
    const float t_obs = g * v.t_scale * f;
    const float rel_sq = t_obs / v.t_peak;
    float rel = rel_sq * rel_sq;
    rel = rel * rel;                               // (t_obs / t_peak)^4
    const float inv_T = 1.0f / max_nan(t_obs, 1.0f);
    const float lg[3] = {planck_log(kBbK0, kBbL50, inv_T),
                         planck_log(kBbK1, kBbL51, inv_T),
                         planck_log(kBbK2, kBbL52, inv_T)};
    const float m = max_nan(lg[0], max_nan(lg[1], lg[2]));
    const float w = tb * rel;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dem[c] = w * expf(lg[c] - m);
      if constexpr (SCATTER) dem[c] = dem[c] + scat[c];
    }
  } else {
    const float emis = expf(v.emis_q * logf(r_in / rr));
    const float cg = clip_nan(g, 0.0f, 4.0f);
    const float w = tb * emis * (cg * cg * cg);
    if constexpr (SCATTER) {
#pragma unroll
      for (int c = 0; c < 3; ++c) dem[c] = w * blk[c] + scat[c];
    } else {
      dem[0] = w;
      dem[1] = w;
      dem[2] = w;
    }
  }
}

}  // namespace curvis
