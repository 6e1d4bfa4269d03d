// One adaptive Dormand-Prince 5(4) iteration of a planar ray, in two
// halves, and the per-ray adaptive march built on it; shared by
// planar_rk45.cu (kernel #4, bare), planar_rk45_disk.cu (kernel #4's
// track_disk / vol variants) and render_fused.cu (kernel #3).
//
// The arithmetic is that of the TPU kernel
// curvis_tpu/ops/march_pallas.py:_rk45_kernel, which the checkpointed
// replay of its adjoint (curvis_tpu/integrate/rk45_adjoint_planar.py:
// _planar_rk45_iter) repeats, so it is kept form for form:
//   - the error of a component is |dt (d5 - d4)| / (atol + rtol max(|y|,
//     |y5|)), not |y5 - y4|;
//   - the controller factor is 0.9 exp(-0.2 log err), not a pow;
//   - every live ray writes back y + a frac (y5 - y) with a = 1 on accept
//     and 0 on reject, frac = 1 unless the step escapes (so a rejected
//     non-finite trial turns the state NaN, as on the TPU);
//   - the dt floor is 1e-6 and the stall test dt <= f32(1e-6 * 1.01).
// Every max of the error norm propagates NaN, as jnp.maximum does: fmaxf
// would drop it, accept a non-finite trial or grow dt on it, and spin the
// ray to max_iters with sign 0 instead of freezing it as sign 3.
#pragma once

#include "dp54.cuh"
#include "planar.cuh"

namespace curvis {

// Controller scalars, after the march scalars in the rk45 rows.
struct Rk45Control {
  float rtol;
  float atol;
  float dt_max;   // dt grows at most to this
};

// Host row of kernel #4: [dt0, R, p0, p1, p2, r_cap, rtol, atol, dt_max]
// (the compact rk45 row of curvis_tpu/ops/march_pallas.py).
struct Rk45Scalars {
  MarchScalars m;   // m.dt is the initial step dt0
  Rk45Control c;
};

constexpr int kRk45Capped = -128;   // sign of a ray stopped at max_steps
constexpr float kRk45DtFloor = 1e-6f;
constexpr float kRk45StallDt = static_cast<float>(1e-6 * 1.01);

// The DP5(4) tableau kA.., kB.., kE.. is dp54.cuh's.

// Scaled error of one component: |dt e| / (atol + rtol max(|y0|, |y1|)).
__device__ __forceinline__ float rk45_err(const Rk45Control& c, float dt,
                                          float e, float y0, float y1) {
  return fabsf(dt * e) / (c.atol + c.rtol * max_nan(fabsf(y0), fabsf(y1)));
}

// What the first half of an iteration hands to the second.
struct Rk45Trial {
  float dt;       // the trial step
  float err;      // its scaled error (NaN for a non-finite trial)
  bool accept;    // err <= 1
  bool esc_pos;   // accepted with l5 beyond +R
  bool esc_neg;   // accepted with l5 beyond -R
};

// The first half of one DP5(4) iteration of a live ray (sign 0, fewer
// than max_steps accepted steps) with step dt: the seven stages, the error
// norm, accept and escape, and the write-back of (l, psi, p_l) (interpolated
// onto l = +-R on an escaping step).  A surface march (planar_rk45_disk.cu)
// does its crossing or emission work on the written-back state between
// this and rk45_control, as the TPU kernel does.
template <int KIND>
__device__ __forceinline__ Rk45Trial rk45_trial(const MarchScalars& s,
                                                const Rk45Control& c,
                                                float b, float b2,
                                                float* l_io, float* psi_io,
                                                float* pl_io, float dt) {
  const float l = *l_io, psi = *psi_io, p_l = *pl_io;
  // stages: (dl, dpsi, dp_l) at l + dt sum_j a_ij k_j (psi does not enter
  // the RHS), summed in the order of the tableau's rows
  float k1l, k1p, k1q, k2l, k2p, k2q, k3l, k3p, k3q, k4l, k4p, k4q;
  float k5l, k5p, k5q, k6l, k6p, k6q, k7l, k7p, k7q;
  planar_deriv<KIND>(s, l, p_l, b, b2, &k1l, &k1p, &k1q);
  planar_deriv<KIND>(s, l + dt * kA21 * k1l, p_l + dt * kA21 * k1q, b, b2,
                     &k2l, &k2p, &k2q);
  planar_deriv<KIND>(s, l + dt * kA31 * k1l + dt * kA32 * k2l,
                     p_l + dt * kA31 * k1q + dt * kA32 * k2q, b, b2, &k3l,
                     &k3p, &k3q);
  planar_deriv<KIND>(
      s, l + dt * kA41 * k1l + dt * kA42 * k2l + dt * kA43 * k3l,
      p_l + dt * kA41 * k1q + dt * kA42 * k2q + dt * kA43 * k3q, b, b2,
      &k4l, &k4p, &k4q);
  planar_deriv<KIND>(s,
                     l + dt * kA51 * k1l + dt * kA52 * k2l + dt * kA53 * k3l +
                         dt * kA54 * k4l,
                     p_l + dt * kA51 * k1q + dt * kA52 * k2q +
                         dt * kA53 * k3q + dt * kA54 * k4q,
                     b, b2, &k5l, &k5p, &k5q);
  planar_deriv<KIND>(s,
                     l + dt * kA61 * k1l + dt * kA62 * k2l + dt * kA63 * k3l +
                         dt * kA64 * k4l + dt * kA65 * k5l,
                     p_l + dt * kA61 * k1q + dt * kA62 * k2q +
                         dt * kA63 * k3q + dt * kA64 * k4q + dt * kA65 * k5q,
                     b, b2, &k6l, &k6p, &k6q);
  planar_deriv<KIND>(s,
                     l + dt * kB1 * k1l + dt * kA72 * k2l + dt * kB3 * k3l +
                         dt * kB4 * k4l + dt * kB5 * k5l + dt * kB6 * k6l,
                     p_l + dt * kB1 * k1q + dt * kA72 * k2q +
                         dt * kB3 * k3q + dt * kB4 * k4q + dt * kB5 * k5q +
                         dt * kB6 * k6q,
                     b, b2, &k7l, &k7p, &k7q);

  // 5th- and 4th-order combinations, each summed from 0 in stage order
  const float d5l = 0.0f + kB1 * k1l + kB3 * k3l + kB4 * k4l + kB5 * k5l +
                    kB6 * k6l;
  const float d5p = 0.0f + kB1 * k1p + kB3 * k3p + kB4 * k4p + kB5 * k5p +
                    kB6 * k6p;
  const float d5q = 0.0f + kB1 * k1q + kB3 * k3q + kB4 * k4q + kB5 * k5q +
                    kB6 * k6q;
  const float e_l = d5l - (0.0f + kE1 * k1l + kE3 * k3l + kE4 * k4l +
                           kE5 * k5l + kE6 * k6l + kE7 * k7l);
  const float e_p = d5p - (0.0f + kE1 * k1p + kE3 * k3p + kE4 * k4p +
                           kE5 * k5p + kE6 * k6p + kE7 * k7p);
  const float e_q = d5q - (0.0f + kE1 * k1q + kE3 * k3q + kE4 * k4q +
                           kE5 * k5q + kE6 * k6q + kE7 * k7q);
  const float l5 = l + dt * d5l;
  const float psi5 = psi + dt * d5p;
  const float pl5 = p_l + dt * d5q;

  const float err = max_nan(rk45_err(c, dt, e_l, l, l5),
                            max_nan(rk45_err(c, dt, e_p, psi, psi5),
                                    rk45_err(c, dt, e_q, p_l, pl5)));
  const bool accept = err <= 1.0f;   // false for NaN

  // escape on an accepted step: interpolate the step onto l = +-R
  const bool esc_pos = accept && l5 > s.R;
  const bool esc_neg = accept && l5 < -s.R;
  const bool esc = esc_pos || esc_neg;
  const float target = esc_pos ? s.R : -s.R;
  float denom = l5 - l;
  if (fabsf(denom) < 1e-30f) denom = 1.0f;
  const float frac = esc ? clip_nan((target - l) / denom, 0.0f, 1.0f) : 1.0f;
  const float a = accept ? frac : 0.0f;
  *l_io = l + a * (l5 - l);
  *psi_io = psi + a * (psi5 - psi);
  *pl_io = p_l + a * (pl5 - p_l);
  return Rk45Trial{dt, err, accept, esc_pos, esc_neg};
}

// The second half: adds the accepted step to *steps, sets *sign (+1 / -1
// for an escape, 2 for capture below r_cap at the written-back l1, then 2
// for an `opaque` ray still at 0, then 3 for a reject at the dt floor or a
// non-finite trial, else 0) and, for a ray still marching, the
// controller's next step in *dt_io.  The caller applies the step cap.
__device__ __forceinline__ void rk45_control(const MarchScalars& s,
                                             const Rk45Control& c,
                                             const Rk45Trial& t, float l1,
                                             bool opaque, float* dt_io,
                                             int* sign, int* steps) {
  const bool captured = t.accept && l1 < s.r_cap;
  int sg = (t.esc_pos ? 1 : 0) - (t.esc_neg ? 1 : 0) + (captured ? 2 : 0);
  if (sg == 0 && opaque) sg = 2;
  *steps += t.accept ? 1 : 0;
  // a reject at the dt floor can never pass: freeze as blowup
  if (!t.accept && t.dt <= kRk45StallDt && sg == 0) sg = 3;
  *sign = sg;

  // controller: clip(0.9 err^-0.2, 0.2, 5) via exp / log; a NaN err gives
  // a NaN factor, which the guard turns into 0.2
  const float err_s = max_nan(t.err, 1e-10f);
  float factor = clip_nan(0.9f * expf(-0.2f * logf(err_s)), 0.2f, 5.0f);
  if (!(factor > 0.0f)) factor = 0.2f;
  if (!(t.esc_pos || t.esc_neg) && sg == 0)
    *dt_io = clip_nan(t.dt * factor, kRk45DtFloor, c.dt_max);
}

// One DP5(4) iteration of a live ray: rk45_trial, then rk45_control.
// Updates (l, psi, p_l) and dt, adds the accepted step to *steps and sets
// *sign as rk45_control does (never opaque).
template <int KIND>
__device__ __forceinline__ void rk45_iter(const MarchScalars& s,
                                          const Rk45Control& c, float b,
                                          float b2, float* l_io,
                                          float* psi_io, float* pl_io,
                                          float* dt_io, int* sign,
                                          int* steps) {
  const Rk45Trial t = rk45_trial<KIND>(s, c, b, b2, l_io, psi_io, pl_io,
                                       *dt_io);
  rk45_control(s, c, t, *l_io, false, dt_io, sign, steps);
}

// Adaptive march of one ray until it escapes (sign +1 / -1, on |l| = R),
// is captured (2), stalls (3), takes max_steps accepted steps (0) or runs
// out of max_iters iterations (0).  Returns the sign; *steps gets the
// accepted steps and *iters the iterations the ray was live for
// (accepted and rejected).  A thread's own loop is the TPU tile's
// lock-step loop seen from one lane, which stops where the lane freezes
// (the tile keeps adding 0 (y5 - y) to a frozen lane: the same state
// unless that lane's trial is non-finite).
template <int KIND>
__device__ __forceinline__ int march_ray_rk45(const MarchScalars& s,
                                              const Rk45Control& c,
                                              float* l, float* psi,
                                              float* p_l, float b,
                                              int max_steps, int max_iters,
                                              int* steps, int* iters) {
  const float b2 = b * b;
  float dt = s.dt;
  int sign = 0, n = 0, live = 0;
  for (int it = 0; it < max_iters && sign == 0; ++it) {
    if (n < max_steps) {
      ++live;
      rk45_iter<KIND>(s, c, b, b2, l, psi, p_l, &dt, &sign, &n);
    }
    if (sign == 0 && n >= max_steps) sign = kRk45Capped;
  }
  *steps = n;
  *iters = live;
  return sign == kRk45Capped ? 0 : sign;
}

}  // namespace curvis
