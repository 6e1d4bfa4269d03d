// The hand-written VJP of one planar DP5(4) iteration (rk45.cuh), the
// step of the checkpoint kernels of the rk45 families (ckpt_rk45.cu: the
// bare march; ckpt_surface_rk45.cu: the disk tracker and the gas).
//
// The map differentiated is that of curvis_tpu/integrate/
// rk45_adjoint_planar.py:_planar_rk45_iter on the state (l, psi, p_l, dt):
// the seven stages, the error norm, the escape interpolation and the
// controller's next dt, with accept, escape, capture and stall as data.
//   - The forward is recomputed by rk45.cuh:rk45_trial_rec, the trial that
//     kernel #4 runs, so the VJP sees the decisions that the march took;
//     only the partials of the RHS are guarded: l and p_l are
//     clipped to +-1e4 and every reciprocal is sign(x) / max(|x|, eps),
//     which has the bits of 1 / x off the guard (IEEE division, no fast
//     math).  A rejected trial that overshoots wildly still reaches err,
//     and so dt, and a raw 1 / l or 1 / A partial there is infinite: its
//     zero cotangent times infinity would be NaN.
//   - The escape interpolation frac is part of the map in both modes;
//     freeze mode (freeze_controller) drops the cotangent of the next dt,
//     which cuts the err -> factor -> dt chain and nothing else.
//   - Ties follow the JAX package's gradients: a max of two equal values
//     and a clip at either bound split the cotangent in halves (jnp.clip
//     is a max then a min).
// ops/ckpt_rk45_cuda.py transcribes these functions line by line
// (rk45_iter_vjp_plain and its pieces).
#pragma once

#include "rk45.cuh"

namespace curvis {

// Cotangents of (l, p_l) and theta (g[0..2] the metric slots, g[3] b; a
// table's coefficients at gc, as euler_step_vjp's) of one RHS
// evaluation (dl, dpsi, dp_l) at (l, p_l) for the cotangents
// (u, v, w) of its outputs, added to *g_l, *g_pl and g: the derivatives of
// the guarded forms of curvis_tpu_torch/integrate/rk45_adjoint_planar.py:
// _guarded_deriv_fns, except DNEG, whose shape is the kernel's dneg_shape
// (log1pf, atanf) with only 1 / r guarded.
template <int KIND, class S>
__device__ __forceinline__ void planar_deriv_vjp(const S& s,
                                                 float l, float p_l, float b,
                                                 float b2, float u, float v,
                                                 float w, float* g_l,
                                                 float* g_pl, float* g,
                                                 float* gc) {
  const float sl = clip_share(l, -1e4f, 1e4f);
  const float lc = clip_nan(l, -1e4f, 1e4f);
  if constexpr (KIND == kEllis) {
    const float r2 = s.p0 * s.p0 + lc * lc;
    const float inv = 1.0f / max_nan(r2, 1e-12f);
    const float inv2 = inv * inv;
    const float g_inv = v * b + w * b2 * lc * 2.0f * inv;
    const float g_r2 = -g_inv * inv2 * max_share(r2, 1e-12f);
    *g_l += (w * b2 * inv2 + g_r2 * 2.0f * lc) * sl;
    *g_pl += u;
    g[0] += g_r2 * 2.0f * s.p0;
    g[3] += v * inv + w * 2.0f * b * (lc * inv * inv);
  } else if constexpr (KIND == kFlat) {
    const float r2 = max_nan(lc * lc, 1e-8f);
    const float inv = 1.0f / r2;
    const float r = sqrtf(r2);
    const float g_inv = v * b + w * b2 / r;
    const float g_r = -w * b2 * inv / (r * r);
    const float g_r2 = -g_inv * inv * inv + g_r * 0.5f / r;
    *g_l += g_r2 * max_share(lc * lc, 1e-8f) * 2.0f * lc * sl;
    *g_pl += u;
    g[3] += v * inv + w * 2.0f * b * (inv / r);
  } else if constexpr (KIND == kInterstellar) {
    const float m = s.p0, a = s.p1;
    float r, dr;
    dneg_shape(m, a, s.p2, lc, &r, &dr);
    const float ir = 1.0f / max_nan(r, 1e-6f);
    const float inv = ir * ir;
    const float g_inv = v * b + w * b2 * dr * ir;
    const float g_ir = g_inv * 2.0f * ir + w * b2 * dr * inv;
    const float g_r = -g_ir * ir * ir * max_share(r, 1e-6f);
    const float g_dr = w * b2 * inv * ir;
    g[2] += g_r;                                   // dr/drho = 1
    if (fabsf(lc) > a) {
      const float sg = lc < 0.0f ? -1.0f : 1.0f;
      const float c = 2.0f / (kPi * m);
      const float x = c * (fabsf(lc) - a);
      const float at = atanf(x);
      const float g_x =
          g_r * m * at + g_dr * sg * (2.0f / kPi) / (1.0f + x * x);
      g[0] += g_r * (x * at - 0.5f * log1pf(x * x)) - g_x * x / m;
      g[1] += -g_x * c;
      *g_l += g_x * sg * c * sl;
    }
    *g_pl += u;
    g[3] += v * inv + w * 2.0f * b * dr * inv * ir;
  } else if constexpr (KIND == kTable) {
    // dpsi = b inv, dpl = b2 dr3 of the guarded table form: l clipped,
    // l^2 + s^2 floored at 1e-12
    float inv, dr3, g_lc = 0.0f;
    table_shape_vjp<true>(s.tab, lc, v * b, w * b2, &inv, &dr3, &g_lc,
                          &g[0], gc, gc + kChebCap);
    *g_l += g_lc * sl;
    *g_pl += u;
    g[3] += v * inv + w * 2.0f * b * dr3;
  } else {
    // the lapse kinds (Schwarzschild: q2 = 0):
    //   A = 1 - (2M - q2/l)/l,  C = -(M - q2/l)/l^2,
    //   dl = A p_l,  dpsi = b/l^2,  dpl = C (1/A^2 + p_l^2) + b^2/l^3
    const float M = s.p0;
    const float q2 = KIND == kReissnerNordstrom ? s.p1 : 0.0f;
    const float pc = clip_nan(p_l, -1e4f, 1e4f);
    const float invl = guarded_inv(lc, 1e-4f);
    const float invl2 = invl * invl;
    const float A = 1.0f - (2.0f * M - q2 * invl) * invl;
    const float invA = guarded_inv(A, 1e-4f);
    const float C = -(M - q2 * invl) * invl2;
    const float Q = invA * invA + pc * pc;
    const float gC = w * Q;
    const float gQ = w * C;
    const float gA = u * pc -
                     gQ * 2.0f * invA * invA * invA * max_share(fabsf(A), 1e-4f);
    *g_pl += (u * A + gQ * 2.0f * pc) * clip_share(p_l, -1e4f, 1e4f);
    g[3] += v * invl2 + w * 2.0f * b * invl2 * invl;
    g[0] += gA * (-2.0f * invl) - gC * invl2;
    if constexpr (KIND == kReissnerNordstrom)
      g[1] += gA * invl2 + gC * invl * invl2;
    const float g_invl2 = v * b + w * b2 * invl - gC * (M - q2 * invl);
    const float g_invl = w * b2 * invl2 + g_invl2 * 2.0f * invl +
                         gA * (-2.0f * M + 2.0f * q2 * invl) +
                         gC * q2 * invl2;
    *g_l += g_invl * (-invl * invl) * max_share(fabsf(lc), 1e-4f) * sl;
  }
}

// Whether the controller left dt as it was (an escape, a capture at the
// written-back l, a stall, or `opaque`), as rk45_control decides.
__device__ __forceinline__ bool rk45_terminal(const MarchScalars& s,
                                              const Rk45Rec& r,
                                              bool opaque) {
  const bool esc = r.esc_pos || r.esc_neg;
  const bool captured = r.accept && r.out[0] < s.r_cap;
  const bool stall = !r.accept && r.dt <= kRk45StallDt;
  return esc || captured || stall || opaque;
}

// VJP of the controller's dt_next = terminal ? dt : clip(dt factor(err)):
// adds the cotangents of dt and err to *g_dt and *g_err.
__device__ __forceinline__ void rk45_control_vjp(const Rk45Control& c,
                                                 const Rk45Rec& r,
                                                 bool terminal, float g_next,
                                                 float* g_dt, float* g_err) {
  if (terminal)
    *g_dt += g_next;
  else
    dp54_control_vjp(r.err, r.dt, kRk45DtFloor, c.dt_max, g_next, g_dt,
                     g_err);
}

// VJP of rk45_trial at the start state of r, for the cotangents g_out of
// the written-back (l, psi, p_l) and g_err of the error norm: adds to
// g_y[3] (l, psi, p_l), *g_dt and g[4] (p0, p1, p2, b; a table's series
// coefficients at gc).
template <int KIND, class S>
__device__ __forceinline__ void rk45_trial_vjp(const S& s,
                                               const Rk45Control& c,
                                               float b, float b2,
                                               const Rk45Rec& r,
                                               const float g_out[3],
                                               float g_err, float g_y[3],
                                               float* g_dt, float* g,
                                               float* gc) {
  const float dt = r.dt;
  // out = y + a (y5 - y), a = accept ? frac : 0
  float g_y5[3], g_a = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_y5[k] = r.a * g_out[k];
    g_y[k] += (1.0f - r.a) * g_out[k];
    g_a += g_out[k] * (r.y5[k] - r.y[k]);
  }
  if (r.accept && (r.esc_pos || r.esc_neg)) {
    // frac = clip(q, 0, 1), q = (target - l) / denom, denom = l5 - l
    const float g_q = g_a * clip_share(r.q, 0.0f, 1.0f);
    g_y[0] += -g_q / r.denom;
    if (!r.small) {
      const float g_den = -g_q * r.q / r.denom;
      g_y5[0] += g_den;
      g_y[0] -= g_den;
    }
  }
  float g_e[3] = {0.0f, 0.0f, 0.0f};
  if (g_err != 0.0f) {
    // err = max(ec_l, max(ec_psi, ec_pl)), ec = |dt e| / den,
    // den = atol + rtol max(|y|, |y5|)
    const float s0 = max_share(r.ec[0], max_nan(r.ec[1], r.ec[2]));
    const float s1 = max_share(r.ec[1], r.ec[2]);
    const float g_ec[3] = {g_err * s0, g_err * (1.0f - s0) * s1,
                           g_err * (1.0f - s0) * (1.0f - s1)};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = dt * r.e[k];
      const float g_x = g_ec[k] / r.den[k] * sgn(x);
      *g_dt += g_x * r.e[k];
      g_e[k] = g_x * dt;
      const float g_mx = -g_ec[k] * r.ec[k] / r.den[k] * c.rtol;
      const float sh = max_share(fabsf(r.y[k]), fabsf(r.y5[k]));
      g_y[k] += g_mx * sh * sgn(r.y[k]);
      g_y5[k] += g_mx * (1.0f - sh) * sgn(r.y5[k]);
    }
  }
  // y5 = y + dt d5; e = d5 - d4
  float gk[7][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_y[k] += g_y5[k];
    *g_dt += g_y5[k] * r.d5[k];
    const float g_d5 = g_y5[k] * dt + g_e[k];
#pragma unroll
    for (int i = 0; i < 7; ++i) gk[i][k] = dp_b5(i) * g_d5 - dp_b4(i) * g_e[k];
  }
  // the stages in reverse: stage i's input is (l, p_l) + dt sum_j a_ij k_j
#pragma unroll
  for (int i = 6; i >= 0; --i) {
    float g_li = 0.0f, g_pli = 0.0f;
    planar_deriv_vjp<KIND>(s, r.st.li[i], r.st.pli[i], b, b2, gk[i][0],
                           gk[i][1], gk[i][2], &g_li, &g_pli, g, gc);
    g_y[0] += g_li;
    g_y[2] += g_pli;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      if (dp_a(i, j) != 0.0f) {
        const float coef = dt * dp_a(i, j);
        gk[j][0] += coef * g_li;
        gk[j][2] += coef * g_pli;
        *g_dt += dp_a(i, j) * (r.st.k[j][0] * g_li + r.st.k[j][2] * g_pli);
      }
    }
  }
}

// VJP of one bare iteration (rk45_iter) at its start (l, psi, p_l, dt):
// lam[4] is the cotangent of (l, psi, p_l, dt) after it and becomes that
// before it; g[4] gathers the cotangents of p0, p1, p2 and b.  `freeze`
// drops the cotangent of the next dt.
template <int KIND, class S>
__device__ __forceinline__ void rk45_iter_vjp(const S& s,
                                              const Rk45Control& c,
                                              bool freeze, float l,
                                              float psi, float p_l, float dt,
                                              float b, float b2,
                                              float lam[4], float g[4]) {
  Rk45Rec r;
  rk45_trial_rec<KIND>(s, c, b, b2, l, psi, p_l, dt, &r);
  float g_dt = 0.0f, g_err = 0.0f;
  if (!freeze)
    rk45_control_vjp(c, r, rk45_terminal(s, r, false), lam[3], &g_dt,
                     &g_err);
  float g_y[3] = {0.0f, 0.0f, 0.0f};
  rk45_trial_vjp<KIND>(s, c, b, b2, r, lam, g_err, g_y, &g_dt, g, g + 4);
  lam[0] = g_y[0];
  lam[1] = g_y[1];
  lam[2] = g_y[2];
  lam[3] = g_dt;
}

}  // namespace curvis
