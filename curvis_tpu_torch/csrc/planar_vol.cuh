// The per-step emission of the flared Gaussian gas disk along a planar ray,
// shared by the two planar volumetric marches: the Euler one (disk_vol.cu,
// kernel #6) and the DP5(4) one (planar_rk45_disk.cu, kernel #4's vol
// variant); and the Euler volumetric step, shared by disk_vol.cu and the
// replay of its checkpoint kernels (ckpt_surface.cu).  Both TPU kernels call the same
// curvis_tpu/ops/march_pallas.py:_vol_emission, so one function keeps the
// two marches' emission identical by construction.
//
// Semantics kept from the TPU kernel: r from rsqrt of the shape function's
// 1/r^2 (r = l for the lapse kinds; a table's from its series, table.cuh);
// every max and clip propagates NaN, as jnp.maximum / jnp.clip do.
//
// The scalars of a kernel are templated on the metric scalars type, as
// planar.cuh's ScalarsOf: MarchScalars for the analytic kinds, TableScalars
// (the same fields, then the coefficient table) for kTable.  The host
// entries read the analytic row and add the table with vol_scalars_of.
#pragma once

#include "vol_common.cuh"

namespace curvis {

// Host row of the Euler volumetric march (the planar volumetric row of
// curvis_tpu/ops/march_pallas.py): the march scalars, the band, the 8
// emission slots, then the scatter block [tint_r, tint_g, tint_b,
// 3 x (kScatterDeg + 1) monomials] when the SCATTER instance runs (the
// host passes 16 or 43 floats); M = TableScalars adds the table.
template <class M>
struct VolScalarsT {
  M m;
  float r_in;
  float r_out;
  VolSlots v;
  float scatter[kScatterBlock];
};
using VolScalars = VolScalarsT<MarchScalars>;

template <int KIND>
using VolScalarsOf = VolScalarsT<ScalarsOf<KIND>>;

// The scalars of kind KIND from the host's row and, for kTable, its table.
template <int KIND>
VolScalarsOf<KIND> vol_scalars_of(const VolScalars& s, const ChebTable* tab) {
  VolScalarsOf<KIND> o;
  o.m = scalars_of<KIND>(s.m, tab);
  o.r_in = s.r_in;
  o.r_out = s.r_out;
  o.v = s.v;
  for (int k = 0; k < kScatterBlock; ++k) o.scatter[k] = s.scatter[k];
  return o;
}

constexpr int kVolBaseFloats = 16;

// (dtau, dem_r, dem_g, dem_b) per unit step at the post-step state (l, p_l,
// zq = z / r) with the optical depth tau reached before the step.  `m`
// gives the metric parameters, (r_in, r_out) the band, `v` the emission
// slots and `scatter` the 27-scalar block (read only by SCATTER).
template <int KIND, bool BLACKBODY, bool REDSHIFT, bool DOPPLER,
          bool SCATTER, class S>
__device__ __forceinline__ void vol_emission(const S& m,
                                             float r_in, float r_out,
                                             const VolSlots& v,
                                             const float* scatter, float l,
                                             float p_l, float b, float zq,
                                             float tau, float nz,
                                             float* dtau, float* dem) {
  constexpr bool kLapse = HasCapture<KIND>::value;
  float r;
  if constexpr (kLapse) {
    r = l;
  } else {
    r = rsqrtf(planar_inv_r2<KIND>(m, l));
  }
  const float zq2 = zq * zq;
  const float s2 = clip_nan(1.0f - zq2, 1e-12f, 1.0f);
  const float r_cyl = r * sqrtf(s2);
  const float dens = expf(-zq2 / (2.0f * v.h2 * s2)) * (v.inv_norm / r_cyl);
  const float w_edge = r_out - r_in;
  const float edge_in = clip_nan((r_cyl - r_in) / (0.1f * w_edge), 0.0f,
                                 1.0f);
  const float edge_out = clip_nan((r_out - r_cyl) / (0.3f * w_edge), 0.0f,
                                  1.0f);
  const float base = dens * edge_in * edge_out;
  const float rr = max_nan(r_cyl, r_in);
  float g = 1.0f;
  if constexpr (kLapse && (REDSHIFT || DOPPLER)) {
    const float M = m.p0;
    float A, vsq;
    if constexpr (KIND == kReissnerNordstrom) {
      const float q2 = m.p1;
      A = clip_nan(1.0f - (2.0f * M - q2 / rr) / rr, 1e-3f, 1.0f);
      vsq = (M - q2 / rr) / rr;     // r A'/2: circular-orbit speed^2
    } else {
      A = clip_nan(1.0f - 2.0f * M / rr, 1e-3f, 1.0f);
      vsq = M / rr;
    }
    const float sqA = sqrtf(A);
    if constexpr (REDSHIFT) g = sqA;
    if constexpr (DOPPLER) {
      const float vel = clip_nan(sqrtf(vsq) / sqA, 0.0f, 0.99f);
      const float gamma = rsqrtf(1.0f - vel * vel);
      const float u_l = p_l * sqA;
      const float u_psi = b / rr;
      const float inv = rsqrtf(u_l * u_l + u_psi * u_psi + 1e-30f);
      const float cos_xi = (u_psi * inv) * nz * v.spin_sign;
      g = g / (gamma * (1.0f - vel * cos_xi));
    }
  }
  const float trans = expf(-tau);
  *dtau = v.kappa * base;
  float scat[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (SCATTER)
    scatter_source(scatter, r_cyl, r_in, r_out, trans * base, scat);
  vol_color<BLACKBODY, SCATTER>(v, r_in, rr, g, trans * base, scatter, scat,
                                dem);
}

// One step of the Euler volumetric march (kernel #6, disk_vol.cu), shared
// with the replay of its checkpoint kernels (ckpt_surface.cu): the Euler
// update of (l, psi, p_l), the incremental rotation of (u, v) = (cos psi,
// sin psi), zq = c1 u + c2 v, and the emission at the post-step state with
// the pre-step tau, accumulated into tau and em over the step.
template <int KIND, bool BLACKBODY, bool REDSHIFT, bool DOPPLER,
          bool SCATTER, class VS>
__device__ __forceinline__ void vol_step(const VS& s, float b,
                                         float b2, float c1, float c2,
                                         float nz, float* l, float* psi,
                                         float* p_l, float* u, float* v,
                                         float* tau, float em[3]) {
  const float dt = s.m.dt;
  float dl, dpsi, dpl;
  planar_deriv<KIND>(s.m, *l, *p_l, b, b2, &dl, &dpsi, &dpl);
  *l = *l + dt * dl;
  *psi = *psi + dt * dpsi;
  *p_l = *p_l + dt * dpl;
  const float du = dt * dpsi;
  const float u1 = *u - *v * du;
  *v = *v + *u * du;
  *u = u1;
  const float zq = c1 * *u + c2 * *v;
  float dtau, dem[3];
  vol_emission<KIND, BLACKBODY, REDSHIFT, DOPPLER, SCATTER>(
      s.m, s.r_in, s.r_out, s.v, s.scatter, *l, *p_l, b, zq, *tau, nz, &dtau,
      dem);
#pragma unroll
  for (int c = 0; c < 3; ++c) em[c] = em[c] + dt * dem[c];
  *tau = *tau + dt * dtau;
}

}  // namespace curvis
