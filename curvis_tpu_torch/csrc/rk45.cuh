// One adaptive Dormand-Prince 5(4) iteration of a planar ray, in two
// halves, and the per-ray adaptive march built on it; shared by
// planar_rk45.cu (kernel #4, bare), rk45_surface.cuh (kernel #4's
// track_disk / vol variants), render_fused.cu (kernel #3) and the
// checkpoint kernels of the rk45 families (ckpt_rk45.cu,
// ckpt_surface_rk45.cu).
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
// (the compact rk45 row of curvis_tpu/ops/march_pallas.py); a kTable
// kernel's march scalars carry the table (M = TableScalars).
template <class M>
struct Rk45ScalarsT {
  M m;   // m.dt is the initial step dt0
  Rk45Control c;
};
using Rk45Scalars = Rk45ScalarsT<MarchScalars>;

template <int KIND>
using Rk45ScalarsOf = Rk45ScalarsT<ScalarsOf<KIND>>;

template <int KIND>
Rk45ScalarsOf<KIND> rk45_scalars_of(const Rk45Scalars& s,
                                    const ChebTable* tab) {
  return Rk45ScalarsOf<KIND>{scalars_of<KIND>(s.m, tab), s.c};
}

constexpr int kRk45Capped = -128;   // sign of a ray stopped at max_steps
constexpr float kRk45DtFloor = 1e-6f;
constexpr float kRk45StallDt = static_cast<float>(1e-6 * 1.01);

// The DP5(4) tableau (dp_a, dp_b5, dp_b4) is dp54.cuh's.

// The seven stages of one DP5(4) trial from (l, p_l) with step dt: stage
// i's inputs li[i], pli[i] = (l, p_l) + dt sum_j a_ij k_j (summed in the
// order of the tableau's rows; the zero a72 is multiplied in) and its
// slopes k[i] = (dl, dpsi, dp_l) there (psi does not enter the RHS).  The
// trial and the replay's VJP (rk45_vjp.cuh) both take their stages from
// here, so they see the same bits.
struct Rk45Stages {
  float li[7];
  float pli[7];
  float k[7][3];
};

template <int KIND, class S>
__device__ __forceinline__ void rk45_stages(const S& s, float b,
                                            float b2, float l, float p_l,
                                            float dt, Rk45Stages* st) {
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float li = l, pli = p_l;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      li = li + dt * dp_a(i, j) * st->k[j][0];
      pli = pli + dt * dp_a(i, j) * st->k[j][2];
    }
    st->li[i] = li;
    st->pli[i] = pli;
    planar_deriv<KIND>(s, li, pli, b, b2, &st->k[i][0], &st->k[i][1],
                       &st->k[i][2]);
  }
}

// The 5th-order slope d5 and the error slope e = d5 - d4 of component c,
// each weighted sum from 0 in stage order (zero weights skipped).
__device__ __forceinline__ void rk45_combine(const Rk45Stages& st, int c,
                                             float* d5, float* e) {
  float a5 = 0.0f, a4 = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i)
    if (dp_b5(i) != 0.0f) a5 = a5 + dp_b5(i) * st.k[i][c];
#pragma unroll
  for (int i = 0; i < 7; ++i)
    if (dp_b4(i) != 0.0f) a4 = a4 + dp_b4(i) * st.k[i][c];
  *d5 = a5;
  *e = a5 - a4;
}

// The first half of one DP5(4) iteration from (l, psi, p_l) with step dt,
// with what the replay's VJP (rk45_vjp.cuh) reads: the seven stages, the
// error norm, accept and escape, and the write-back of (l, psi, p_l)
// (interpolated onto l = +-R on an escaping step).
struct Rk45Rec {
  Rk45Stages st;
  float y[3];      // l, psi, p_l at the start
  float y5[3];     // the 5th-order solution
  float d5[3];     // its slopes
  float e[3];      // the error slopes d5 - d4
  float ec[3];     // the scaled errors |dt e| / den
  float den[3];    // their denominators atol + rtol max(|y|, |y5|)
  float out[3];    // the written-back state
  float dt, err, q, denom, a;
  bool accept, esc_pos, esc_neg, small;
};

template <int KIND, class S>
__device__ __forceinline__ void rk45_trial_rec(const S& s,
                                               const Rk45Control& c,
                                               float b, float b2, float l,
                                               float psi, float p_l, float dt,
                                               Rk45Rec* r) {
  rk45_stages<KIND>(s, b, b2, l, p_l, dt, &r->st);
  r->y[0] = l;
  r->y[1] = psi;
  r->y[2] = p_l;
  r->dt = dt;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rk45_combine(r->st, k, &r->d5[k], &r->e[k]);
    r->y5[k] = r->y[k] + dt * r->d5[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r->den[k] = c.atol + c.rtol * max_nan(fabsf(r->y[k]), fabsf(r->y5[k]));
    r->ec[k] = fabsf(dt * r->e[k]) / r->den[k];
  }
  r->err = max_nan(r->ec[0], max_nan(r->ec[1], r->ec[2]));
  r->accept = r->err <= 1.0f;   // false for NaN
  // escape on an accepted step: interpolate the step onto l = +-R
  r->esc_pos = r->accept && r->y5[0] > s.R;
  r->esc_neg = r->accept && r->y5[0] < -s.R;
  const float target = r->esc_pos ? s.R : -s.R;
  r->denom = r->y5[0] - l;
  r->small = fabsf(r->denom) < 1e-30f;
  if (r->small) r->denom = 1.0f;
  r->q = (target - l) / r->denom;
  const float frac =
      (r->esc_pos || r->esc_neg) ? clip_nan(r->q, 0.0f, 1.0f) : 1.0f;
  r->a = r->accept ? frac : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    r->out[k] = r->y[k] + r->a * (r->y5[k] - r->y[k]);
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
// than max_steps accepted steps) with step dt (rk45_trial_rec): writes
// back (l, psi, p_l).  A surface march (rk45_surface.cuh) does its
// crossing or emission work on the written-back state between this and
// rk45_control, as the TPU kernel does.
template <int KIND, class S>
__device__ __forceinline__ Rk45Trial rk45_trial(const S& s,
                                                const Rk45Control& c,
                                                float b, float b2,
                                                float* l_io, float* psi_io,
                                                float* pl_io, float dt) {
  Rk45Rec r;
  rk45_trial_rec<KIND>(s, c, b, b2, *l_io, *psi_io, *pl_io, dt, &r);
  *l_io = r.out[0];
  *psi_io = r.out[1];
  *pl_io = r.out[2];
  return Rk45Trial{dt, r.err, r.accept, r.esc_pos, r.esc_neg};
}

// The controller's next step after a trial of step dt and error err:
// clip(dt dp54_factor(err)) within [1e-6, dt_max].
__device__ __forceinline__ float rk45_next_dt(const Rk45Control& c,
                                              float err, float dt) {
  return clip_nan(dt * dp54_factor(err), kRk45DtFloor, c.dt_max);
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

  if (!(t.esc_pos || t.esc_neg) && sg == 0)
    *dt_io = rk45_next_dt(c, t.err, t.dt);
}

// One DP5(4) iteration of a live ray: rk45_trial, then rk45_control.
// Updates (l, psi, p_l) and dt, adds the accepted step to *steps and sets
// *sign as rk45_control does (never opaque).
template <int KIND, class S>
__device__ __forceinline__ void rk45_iter(const S& s,
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
template <int KIND, class S>
__device__ __forceinline__ int march_ray_rk45(const S& s,
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
