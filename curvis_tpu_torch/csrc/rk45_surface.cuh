// One DP5(4) iteration of a planar ray with a disk surface: kernel #4's
// track_disk / vol iteration, shared by its march (planar_rk45_disk.cu)
// and the replay of its checkpoint kernels (ckpt_surface_rk45.cu), so that
// both take the same accept, crossing, emission and clamp decisions bit
// for bit.  Both are built without FMA contraction (ops/_build.py).
//
// Semantics kept from the TPU kernel curvis_tpu/ops/march_pallas.py:
// _rk45_kernel, iteration by iteration:
//   - rk45_trial writes back (l, psi, p_l); zq = c1 cos psi + c2 sin psi is
//     then recomputed for every ray (a rejected ray keeps psi, so the
//     carried zq is always that of the current psi);
//   - TRACK: a crossing counts only on an accepted step, on the written-
//     back state: zq changes sign, frac = |zq0| / max(|zq0| + |zq1|,
//     1e-30), the hit coordinate l0 + frac (l1 - l0) is SIGNED (its sign is
//     the sheet) and recorded when its radius lies in [r_in, r_out]; a slot
//     counts as free while it holds exactly 0;
//   - vol: on an accepted step, the emission at the written-back state
//     with the PRE-update tau, weighted by the trial dt (also on the step
//     that escapes);
//   - rk45_control: escape and capture, then the tau_max freeze (sign 2,
//     OPAQUE_SIGN), then the stall test at the dt floor with the unclamped
//     dt, then the controller;
//   - then, for a ray still at sign 0, the anticipatory clamps that keep
//     base resolution (dt0) near the surface: TRACK dt <= max(dt0,
//     0.2 |l| |zq|) where |l| < r_out + 2; vol dt <= max(dt0, half the
//     larger of the radial gap to the r_out + 2 cylinder and the vertical
//     gap to the 5-sigma density shell), with r = l for the lapse kinds and
//     rsqrt(max(1/r^2, 1e-30)) for the others;
//   - every max, min and clip propagates NaN.
#pragma once

#include "planar_vol.cuh"
#include "rk45.cuh"

namespace curvis {

// The vol variant's radius for the gas clamp: l for the lapse kinds, else
// rsqrt(max(1/r^2, 1e-30)) (a table's 1/r^2 from its series).
template <int KIND, class S>
__device__ __forceinline__ float gas_radius(const S& m, float l) {
  if constexpr (HasCapture<KIND>::value) {
    return l;
  } else {
    return rsqrtf(max_nan(planar_inv_r2<KIND>(m, l), 1e-30f));
  }
}

// One live iteration from (l, psi, p_l, dt) with the carried zq (that of
// psi) and the accumulators acc (TRACK: h1, h1p, h1s, h2, h2p, h2s; vol:
// tau, em_r, em_g, em_b): updates them, adds the accepted step to *n_acc
// and sets *sign as rk45_control does.  *slot says which hit slot the
// iteration filled (0 or 3, -1 for none).  m.dt is the initial step dt0;
// m is the kind's march scalars (ScalarsOf<KIND>, a table's with it).
template <int KIND, bool TRACK, bool BLACKBODY, bool REDSHIFT, bool DOPPLER,
          bool SCATTER, class S>
__device__ __forceinline__ void rk45_surface_iter(
    const S& m, const Rk45Control& c, float r_in, float r_out,
    const VolSlots& v, const float* scatter, float b, float b2, float c1,
    float c2, float nz, float* l, float* psi, float* p_l, float* dt,
    float* zq, float acc[6], int* slot, int* sign, int* n_acc) {
  const float dt0 = m.dt;
  const float l0 = *l, psi0 = *psi, pl0 = *p_l;
  const Rk45Trial t = rk45_trial<KIND>(m, c, b, b2, l, psi, p_l, *dt);
  const float zq1 = c1 * cosf(*psi) + c2 * sinf(*psi);
  bool opaque = false;
  *slot = -1;
  if constexpr (TRACK) {
    if (t.accept && *zq * zq1 < 0.0f) {
      const float frac =
          fabsf(*zq) / max_nan(fabsf(*zq) + fabsf(zq1), 1e-30f);
      const float lh = l0 + frac * (*l - l0);
      const float r_hit = fabsf(lh);
      if (r_hit >= r_in && r_hit <= r_out) {
        const int k = acc[0] == 0.0f ? 0 : acc[3] == 0.0f ? 3 : -1;
        if (k >= 0) {
          acc[k] = lh;
          acc[k + 1] = pl0 + frac * (*p_l - pl0);
          acc[k + 2] = psi0 + frac * (*psi - psi0);
          *slot = k;
        }
      }
    }
  } else if (t.accept) {
    float dtau, dem[3];
    vol_emission<KIND, BLACKBODY, REDSHIFT, DOPPLER, SCATTER>(
        m, r_in, r_out, v, scatter, *l, *p_l, b, zq1, acc[0], nz, &dtau,
        dem);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[1 + k] = acc[1 + k] + t.dt * dem[k];
    acc[0] = acc[0] + t.dt * dtau;
    opaque = acc[0] > v.tau_max;
  }
  *zq = zq1;
  rk45_control(m, c, t, *l, opaque, dt, sign, n_acc);
  if (*sign == 0) {
    if constexpr (TRACK) {
      if (fabsf(*l) < r_out + 2.0f)
        *dt = min_nan(*dt, max_nan(dt0, 0.2f * fabsf(*l) * fabsf(*zq)));
    } else {
      const float rl = gas_radius<KIND>(m, *l);
      const float s2v = clip_nan(1.0f - *zq * *zq, 1e-12f, 1.0f);
      const float r_cyl = rl * sqrtf(s2v);
      const float gap_r = r_cyl - (r_out + 2.0f);
      const float h_rel5 = 5.0f * sqrtf(v.h2);
      const float gap_z = rl * fabsf(*zq) - h_rel5 * r_cyl;
      *dt = min_nan(*dt, max_nan(dt0, 0.5f * max_nan(gap_r, gap_z)));
    }
  }
}

}  // namespace curvis
