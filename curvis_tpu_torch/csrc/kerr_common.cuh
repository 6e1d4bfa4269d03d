// The Boyer-Lindquist photon flow and the volumetric emission of the
// flared gas disk along it, shared by the Kerr marches: the fixed-step RK4
// kernel (kerr.cu, #7) and the adaptive DP5(4) kernel (kerr_rk45.cu, #8).
//
// They are the TPU kernels' _kerr_rhs and _kerr_vol_emission
// (curvis_tpu/ops/march_pallas.py), which both Pallas Kerr kernels share
// too.  Both rows keep M, a, q^2, r_in, r_out at slots 2-4 and 6-7 and the
// eight emission slots at VOL_BLOCK_KERR = 10, so the functions take those
// fields rather than either row.
#pragma once

#include "vol_common.cuh"

namespace curvis {

// d(r, theta, phi, p_r, p_theta) / d lambda: the Hamiltonian flow of
// 2 Sigma H = Delta p_r^2 + p_th^2 + (L - a E sin^2)^2 / sin^2 -
// ((r^2 + a^2) E - a L)^2 / Delta written out by hand, with the off-shell
// W d(1/2 Sigma) term; Kerr-Newman enters only through Delta (q2).
__device__ __forceinline__ void kerr_rhs(float M, float a, float q2,
                                         float E, float L, float r,
                                         float th, float p_r, float p_th,
                                         float* d) {
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float u = max_nan(sn * sn, 1e-12f);       // axis guard
  const float invu = 1.0f / u;
  const float ac = a * cs;
  const float sigma = r * r + ac * ac;
  const float inv_sigma = 1.0f / sigma;
  const float delta = r * (r - 2.0f * M) + a * a + q2;
  const float inv_delta = 1.0f / delta;
  const float P = (r * r + a * a) * E - a * L;
  const float G = L - a * E * u;
  const float W =
      delta * p_r * p_r + p_th * p_th + G * G * invu - P * P * inv_delta;
  const float dDelta = 2.0f * r - 2.0f * M;
  const float dWdr = dDelta * p_r * p_r - 4.0f * r * E * P * inv_delta +
                     P * P * dDelta * inv_delta * inv_delta;
  const float sin2t = 2.0f * sn * cs;
  const float aE = a * E;
  const float dWdth = (aE * aE - L * L * invu * invu) * sin2t;
  const float half = 0.5f * inv_sigma;
  d[0] = delta * p_r * inv_sigma;
  d[1] = p_th * inv_sigma;
  d[2] = (G * invu + a * P * inv_delta) * inv_sigma;
  d[3] = (-dWdr + W * (2.0f * r) * inv_sigma) * half;
  d[4] = (-dWdth - W * (a * a * sin2t) * inv_sigma) * half;
}

// (dtau, dem_r, dem_g, dem_b) per unit step at a BL state: the flared
// Gaussian gas with zq = cos(theta) and r_cyl = r sin(theta), the
// Kerr-Newman circular-orbit g (BEAMING) seen along b_ph = L / E, and the
// starlight scattering source of the 27-float block `scatter` (SCATTER).
template <bool BLACKBODY, bool BEAMING, bool SCATTER>
__device__ __forceinline__ void kerr_vol_emission(
    float M, float a, float q2, float r_in, float r_out, const VolSlots& v,
    const float* scatter, float r, float th, float b_ph, float tau,
    float* dtau, float* dem) {
  const float ct = cosf(th);
  const float zq2 = ct * ct;
  const float s2 = clip_nan(1.0f - zq2, 1e-12f, 1.0f);
  const float r_cyl = r * sqrtf(s2);
  const float dens = expf(-zq2 / (2.0f * v.h2 * s2)) * (v.inv_norm / r_cyl);
  const float w_edge = r_out - r_in;
  const float edge_in =
      clip_nan((r_cyl - r_in) / (0.1f * w_edge), 0.0f, 1.0f);
  const float edge_out =
      clip_nan((r_out - r_cyl) / (0.3f * w_edge), 0.0f, 1.0f);
  const float base = dens * edge_in * edge_out;
  const float rr = max_nan(r_cyl, r_in);
  float g = 1.0f;
  if constexpr (BEAMING) {
    const float sp = v.spin_sign;
    const float sq = sqrtf(max_nan(M * rr - q2, 1e-12f));
    const float rr2 = rr * rr;
    const float omega = sp * sq / (rr2 + sp * a * sq);
    const float under = max_nan(
        1.0f - (3.0f * M - 2.0f * q2 / rr) / rr + 2.0f * sp * a * sq / rr2,
        1e-3f);
    g = sqrtf(under) / clip_nan(1.0f - omega * b_ph, 0.2f, 5.0f);
  }
  const float trans = expf(-tau);
  *dtau = v.kappa * base;
  float scat[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (SCATTER)
    scatter_source(scatter, r_cyl, r_in, r_out, trans * base, scat);
  vol_color<BLACKBODY, SCATTER>(v, r_in, rr, g, trans * base, scatter, scat,
                                dem);
}

}  // namespace curvis
