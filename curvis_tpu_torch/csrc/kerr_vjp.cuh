// The hand-written VJPs of the Boyer-Lindquist steps (kerr_step.cuh), the
// steps of the checkpoint kernels of the Kerr families: the RK4 step of
// kernel #7 (ckpt_kerr.cu) and the bare DP5(4) iteration of kernel #8
// (ckpt_kerr_rk45.cu), in parts that the surface families' VJPs
// (kerr_surface_vjp.cuh) reuse.
//
// The maps differentiated are those of the JAX package's adjoints:
// curvis_tpu/integrate/kerr_adjoint.py:_step5_theta (RK4 on (r, theta,
// phi, p_r, p_theta) with the axis and far-field scales of dt taken at the
// step's start) and curvis_tpu/integrate/rk45_adjoint.py:_rk45_iter (one
// DP5(4) iteration on (r, theta, phi, p_r, p_theta, dt) with accept,
// escape, capture, blowup and stall as data), for theta = (M, a, q^2, E,
// L).
//   - The bare RK4 family takes the partials of the unguarded RHS
//     (_kerr_rhs, with its sin^2 >= 1e-12 clip): excluded rays replay no
//     step, so no replayed state is near a horizon.  The surface families
//     replay captured rays too and take the guarded partials (GUARD), as
//     kerr_surface_adjoint.py:_rk4_state does.
//   - DP5(4) recomputes the forward with kernel #8's own iteration, so the
//     VJP sees the decisions that the march took, and guards only the
//     partials of the RHS, as _kerr_rhs_guarded does: r, p_r and p_theta
//     clipped to +-1e4, sigma >= 1e-3 and 1 / Delta as sign(Delta) /
//     max(|Delta|, 1e-6), which has the bits of 1 / Delta off the guard.
//     A rejected trial that overshoots across Delta = 0 still reaches err,
//     and so dt, and a raw partial there is infinite: its zero cotangent
//     times infinity would be NaN.
//   - The escape fraction of an over-reject is part of the DP5(4) map in
//     both modes; FREEZE (freeze_controller) drops the cotangent of the
//     next dt, which cuts the err -> factor -> dt chain and the
//     frac -> dt chain, as the JAX map's stop_gradients do.
//   - Ties follow the JAX package's gradients: a max of two equal values
//     and a clip at either bound split the cotangent in halves.
// ops/ckpt_kerr_cuda.py transcribes these functions line by line
// (kerr_rhs_vjp_plain, kerr_step5_vjp_plain, kerr_rk45_iter_vjp_plain) and
// adds the theta terms in the same order.
#pragma once

#include "kerr_step.cuh"

namespace curvis {

// Cotangents of (r, theta, p_r, p_theta) and theta = (M, a, q2, E, L) of
// one kerr_rhs evaluation at (r, theta, p_r, p_theta) for the cotangents
// g[5] of its outputs, added to *g_r, *g_th, *g_pr, *g_pth and gt[5].
// GUARD takes the partials of the guarded forms (DP5(4)).
template <bool GUARD>
__device__ __forceinline__ void kerr_rhs_vjp(float M, float a, float q2,
                                             float E, float L, float r_in,
                                             float th, float pr_in,
                                             float pth_in, const float g[5],
                                             float* g_r, float* g_th,
                                             float* g_pr, float* g_pth,
                                             float gt[5]) {
  const float r = GUARD ? clip_nan(r_in, -1e4f, 1e4f) : r_in;
  const float p_r = GUARD ? clip_nan(pr_in, -1e4f, 1e4f) : pr_in;
  const float p_th = GUARD ? clip_nan(pth_in, -1e4f, 1e4f) : pth_in;
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float ss = sn * sn;
  const float u = max_nan(ss, 1e-12f);
  const float invu = 1.0f / u;
  const float ac = a * cs;
  const float sigma = r * r + ac * ac;
  const float inv_sigma = GUARD ? 1.0f / max_nan(sigma, 1e-3f) : 1.0f / sigma;
  const float delta = r * (r - 2.0f * M) + a * a + q2;
  const float inv_delta =
      GUARD ? guarded_inv(delta, 1e-6f) : 1.0f / delta;
  const float P = (r * r + a * a) * E - a * L;
  const float G = L - a * E * u;
  const float W =
      delta * p_r * p_r + p_th * p_th + G * G * invu - P * P * inv_delta;
  const float dDelta = 2.0f * r - 2.0f * M;
  const float dWdr = dDelta * p_r * p_r - 4.0f * r * E * P * inv_delta +
                     P * P * dDelta * inv_delta * inv_delta;
  const float sin2t = 2.0f * sn * cs;
  const float aE = a * E;
  const float q = aE * aE - L * L * invu * invu;
  const float dWdth = q * sin2t;
  const float half = 0.5f * inv_sigma;
  const float aas = a * a * sin2t;
  // d2 = t2 inv_sigma, d3 = t3 half, d4 = t4 half
  const float t2 = G * invu + a * P * inv_delta;
  const float t3 = -dWdr + W * (2.0f * r) * inv_sigma;
  const float t4 = -dWdth - W * aas * inv_sigma;
  const float g_t2 = g[2] * inv_sigma;
  const float g_t3 = g[3] * half;
  const float g_t4 = g[4] * half;
  float g_is = g[0] * delta * p_r + g[1] * p_th + g[2] * t2 +
               0.5f * (g[3] * t3 + g[4] * t4) + g_t3 * W * (2.0f * r) -
               g_t4 * W * aas;
  float g_W = g_t3 * (2.0f * r) * inv_sigma - g_t4 * aas * inv_sigma;
  const float g_dWdr = -g_t3;
  const float g_q = -g_t4 * sin2t;
  float g_rr = g_t3 * W * 2.0f * inv_sigma;
  float g_delta = g[0] * p_r * inv_sigma;
  float g_prr = g[0] * delta * inv_sigma;
  float g_pthh = g[1] * inv_sigma;
  float g_G = g_t2 * invu;
  float g_invu = g_t2 * G;
  float g_P = g_t2 * a * inv_delta;
  float g_id = g_t2 * a * P;
  const float g_aas = -g_t4 * W * inv_sigma;
  float g_a = g_t2 * P * inv_delta + g_aas * 2.0f * a * sin2t;
  float g_sin2t = g_aas * a * a - g_t4 * q;
  // q = aE aE - L L invu invu
  const float g_aE = g_q * 2.0f * aE;
  float g_L = -g_q * 2.0f * L * invu * invu;
  g_invu += -g_q * L * L * 2.0f * invu;
  g_a += g_aE * E;
  float g_E = g_aE * a;
  // dWdr = dDelta p_r p_r - 4 r E P inv_delta + P P dDelta inv_delta^2
  const float g_dD = g_dWdr * (p_r * p_r + P * P * inv_delta * inv_delta);
  g_prr += g_dWdr * dDelta * 2.0f * p_r;
  g_rr += -g_dWdr * 4.0f * E * P * inv_delta;
  g_E += -g_dWdr * 4.0f * r * P * inv_delta;
  g_P += g_dWdr * (-4.0f * r * E * inv_delta +
                   2.0f * P * dDelta * inv_delta * inv_delta);
  g_id += g_dWdr * (-4.0f * r * E * P + 2.0f * P * P * dDelta * inv_delta);
  g_rr += 2.0f * g_dD;
  float g_M = -2.0f * g_dD;
  // W = delta p_r p_r + p_th p_th + G G invu - P P inv_delta
  g_delta += g_W * p_r * p_r;
  g_prr += g_W * 2.0f * delta * p_r;
  g_pthh += g_W * 2.0f * p_th;
  g_G += g_W * 2.0f * G * invu;
  g_invu += g_W * G * G;
  g_P += -g_W * 2.0f * P * inv_delta;
  g_id += -g_W * P * P;
  // G = L - a E u
  g_L += g_G;
  g_a += -g_G * E * u;
  g_E += -g_G * a * u;
  float g_u = -g_G * a * E;
  // P = (r r + a a) E - a L
  g_rr += g_P * 2.0f * r * E;
  g_a += g_P * (2.0f * a * E - L);
  g_E += g_P * (r * r + a * a);
  g_L += -g_P * a;
  // inv_delta, then delta = r (r - 2M) + a a + q2
  g_delta += -g_id * inv_delta * inv_delta *
             (GUARD ? max_share(fabsf(delta), 1e-6f) : 1.0f);
  g_rr += g_delta * (2.0f * r - 2.0f * M);
  g_M += -g_delta * 2.0f * r;
  g_a += g_delta * 2.0f * a;
  // inv_sigma, then sigma = r r + ac ac, ac = a cos(theta)
  const float g_sig = -g_is * inv_sigma * inv_sigma *
                      (GUARD ? max_share(sigma, 1e-3f) : 1.0f);
  g_rr += g_sig * 2.0f * r;
  const float g_ac = g_sig * 2.0f * ac;
  g_a += g_ac * cs;
  float g_c = g_ac * a;
  // invu = 1 / u, u = max(sin^2, 1e-12), sin2t = 2 sin cos
  g_u += -g_invu * invu * invu;
  const float g_s = g_u * max_share(ss, 1e-12f) * 2.0f * sn +
                    g_sin2t * 2.0f * cs;
  g_c += g_sin2t * 2.0f * sn;
  *g_th += g_s * cs - g_c * sn;
  *g_r += GUARD ? g_rr * clip_share(r_in, -1e4f, 1e4f) : g_rr;
  *g_pr += GUARD ? g_prr * clip_share(pr_in, -1e4f, 1e4f) : g_prr;
  *g_pth += GUARD ? g_pthh * clip_share(pth_in, -1e4f, 1e4f) : g_pthh;
  gt[0] += g_M;
  gt[1] += g_a;
  gt[2] += g_delta;   // d delta / d q2 = 1
  gt[3] += g_E;
  gt[4] += g_L;
}

// VJP of one RK4 step (kerr_rk4_step) at its start y: lam[5] is the
// cotangent of the state after it and becomes that before it; gt[5]
// gathers the cotangents of (M, a, q2, E, L).  GUARD takes the partials of
// the guarded RHS (the surface families'); DTE_IN adds g_dte_in, a
// cotangent of the step's dte from elsewhere (the gas quadrature's
// weight).
template <bool GUARD, bool DTE_IN = false>
__device__ __forceinline__ void kerr_rk4_vjp(const KerrScalars& s, float E,
                                             float L, const float y[5],
                                             float lam[5], float gt[5],
                                             float g_dte_in = 0.0f) {
  KerrRk4Stages st;
  kerr_rk4_stages(s, E, L, y, &st);
  const float dte = st.dte, hd = st.hd;
  const float w = dte * (1.0f / 6.0f);
  // y1 = y + w (k0 + 2 (k1 + k2) + k3)
  float g_w = 0.0f;
  float gk[4][5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float sum =
        st.k[0][c] + 2.0f * (st.k[1][c] + st.k[2][c]) + st.k[3][c];
    g_w += lam[c] * sum;
    const float g_sum = lam[c] * w;
    gk[0][c] = g_sum;
    gk[1][c] = 2.0f * g_sum;
    gk[2][c] = 2.0f * g_sum;
    gk[3][c] = g_sum;
  }
  float g_dte = g_w * (1.0f / 6.0f);
  if constexpr (DTE_IN) g_dte += g_dte_in;
  float g_hd = 0.0f;
  // the stages in reverse: stage i's input is y + h k_{i-1} (h = hd for
  // stages 1, 2 and dte for stage 3)
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    float gi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    kerr_rhs_vjp<GUARD>(s.M, s.a, s.q2, E, L, st.yi[i][0], st.yi[i][1],
                        st.yi[i][2], st.yi[i][3], gk[i], &gi[0], &gi[1],
                        &gi[2], &gi[3], gt);
#pragma unroll
    for (int q = 0; q < 4; ++q) lam[rhs_in(q)] += gi[q];
    if (i > 0) {
      const float h = i == 3 ? dte : hd;
      float g_h = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gk[i - 1][rhs_in(q)] += h * gi[q];
        g_h += gi[q] * st.k[i - 1][rhs_in(q)];
      }
      if (i == 3)
        g_dte += g_h;
      else
        g_hd += g_h;
    }
  }
  g_dte += 0.5f * g_hd;
  // dte = dt scale(theta) fscale(r), both taken at the start
  const float s_ax = sinf(y[1]);
  const float u0 = max_nan(s.ax_u0, 1e-12f);
  const float x_ax = (s_ax * s_ax + 1e-12f) / u0;
  const float scale = clip_nan(x_ax, 1.0f / 16.0f, 1.0f);
  const float f0 = max_nan(s.far_r0, 1e-12f);
  const float x_far = y[0] / f0;
  const float fscale = clip_nan(x_far, 1.0f, 8.0f);
  const float g_scale = g_dte * fscale * s.dt;
  const float g_fscale = g_dte * s.dt * scale;
  lam[1] += g_scale * clip_share(x_ax, 1.0f / 16.0f, 1.0f) * 2.0f * s_ax *
            cosf(y[1]) / u0;
  lam[0] += g_fscale * clip_share(x_far, 1.0f, 8.0f) / f0;
}

// Whether kernel #8 left dt as it was after trial t (sign != 0: escape,
// capture or blowup of an accepted step, or a stall).
__device__ __forceinline__ bool kerr_rk45_terminal(const KerrRk45Scalars& s,
                                                   const KerrRk45Rec& t) {
  if (t.accept)
    return !kerr_finite(t.y1) || t.esc || t.y1[0] < s.r_cap;
  return t.dt <= s.dt_min * 1.01f;
}

// VJP of the next dt of trial t (kerr_rk45_next_dt, or dt itself where
// the ray ended: `terminal`) for its cotangent g_next: adds to g_y[0] and
// g_y1[0] (the escape fraction of an over-reject), *g_dt and *g_err.
__device__ __forceinline__ void kerr_rk45_next_vjp(const KerrRk45Scalars& s,
                                                   const KerrRk45Rec& t,
                                                   bool terminal,
                                                   float g_next, float g_y[5],
                                                   float g_y1[5],
                                                   float* g_dt,
                                                   float* g_err) {
  if (terminal) {
    *g_dt += g_next;
  } else if (t.over) {
    // next = clip(dt frac 1.05), frac = (R - r) / den_r, den_r = r1 - r
    const float x = t.dt * t.frac * 1.05f;
    const float g_x = g_next * clip_share(x, s.dt_min, s.dt_max);
    *g_dt += g_x * t.frac * 1.05f;
    const float g_frac = g_x * t.dt * 1.05f;
    g_y[0] += -g_frac / t.den_r;
    if (!t.small) {
      const float g_den = -g_frac * t.frac / t.den_r;
      g_y1[0] += g_den;
      g_y[0] -= g_den;
    }
  } else {
    dp54_control_vjp(t.err, t.dt, s.dt_min, s.dt_max, g_next, g_dt, g_err);
  }
}

// VJP of trial t (kerr_rk45_trial) at its start (y, dt) for the
// cotangents g_y1[5] of the trial y1 and g_err of its error norm, given
// the cotangents already gathered for the start (g_y[5], g_dt): lam[6]
// becomes the cotangent of (y, dt); gt[5] gathers those of (M, a, q2, E,
// L).
__device__ __forceinline__ void kerr_rk45_trial_vjp(
    const KerrRk45Scalars& s, float E, float L, const KerrRk45Rec& t,
    float g_err, float g_y[5], float g_y1[5], float g_dt, float lam[6],
    float gt[5]) {
  float g_e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (g_err != 0.0f) {
    // err = max(max(ec0, ec1), max(ec2, ec3)), ec = |dt e| / den,
    // den = atol + rtol max(|y|, |y1|)
    const float s01 = max_share(max_nan(t.ec[0], t.ec[1]),
                                max_nan(t.ec[2], t.ec[3]));
    const float s0 = max_share(t.ec[0], t.ec[1]);
    const float s2 = max_share(t.ec[2], t.ec[3]);
    const float g_ec[4] = {g_err * s01 * s0, g_err * s01 * (1.0f - s0),
                           g_err * (1.0f - s01) * s2,
                           g_err * (1.0f - s01) * (1.0f - s2)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = rhs_in(q);
      const float x = t.dt * t.e[q];
      const float g_x = g_ec[q] / t.den[q] * sgn(x);
      g_dt += g_x * t.e[q];
      g_e[q] = g_x * t.dt;
      const float g_mx = -g_ec[q] * t.ec[q] / t.den[q] * s.rtol;
      const float sh = max_share(fabsf(t.y[c]), fabsf(t.y1[c]));
      g_y[c] += g_mx * sh * sgn(t.y[c]);
      g_y1[c] += g_mx * (1.0f - sh) * sgn(t.y1[c]);
    }
  }
  // y1 = y + dt d5; e = d5 - d4.  A rejected trial whose error norm has
  // no cotangent (its factor clipped at 0.2, or frozen) passes none to y1
  // or its stages; the replay's unguarded trial may be non-finite there,
  // so its terms (zero cotangents times infinite slopes) are not formed.
  if (t.accept || t.over || g_err != 0.0f) {
    float gk[7][5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float ge = c == 2 ? 0.0f : g_e[c < 2 ? c : c - 1];
      g_y[c] += g_y1[c];
      g_dt += g_y1[c] * t.d5[c];
      const float g_d5 = g_y1[c] * t.dt + ge;
#pragma unroll
      for (int i = 0; i < 7; ++i) gk[i][c] = dp_b5(i) * g_d5 - dp_b4(i) * ge;
    }
    // the stages in reverse: stage i's input is y + dt sum_j a_ij k_j
#pragma unroll
    for (int i = 6; i >= 0; --i) {
      float gi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      kerr_rhs_vjp<true>(s.M, s.a, s.q2, E, L, t.yi[i][0], t.yi[i][1],
                         t.yi[i][2], t.yi[i][3], gk[i], &gi[0], &gi[1],
                         &gi[2], &gi[3], gt);
#pragma unroll
      for (int q = 0; q < 4; ++q) g_y[rhs_in(q)] += gi[q];
#pragma unroll
      for (int j = 0; j < i; ++j) {
        if (dp_a(i, j) != 0.0f) {
          const float coef = t.dt * dp_a(i, j);
          float g_a = 0.0f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            gk[j][rhs_in(q)] += coef * gi[q];
            g_a += t.k[j][rhs_in(q)] * gi[q];
          }
          g_dt += dp_a(i, j) * g_a;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) lam[c] = g_y[c];
  lam[5] = g_dt;
}

// VJP of one bare DP5(4) iteration (kerr_rk45_iter) at its start (y, dt):
// lam[6] is the cotangent of (r, theta, phi, p_r, p_theta, dt) after it
// and becomes that before it; gt[5] gathers the cotangents of (M, a, q2,
// E, L).  FREEZE drops the cotangent of the next dt.
template <bool FREEZE>
__device__ __forceinline__ void kerr_rk45_vjp(const KerrRk45Scalars& s,
                                              float E, float L,
                                              const float y[5], float dt,
                                              float lam[6], float gt[5]) {
  KerrRk45Rec t;
  kerr_rk45_trial(s, E, L, y, dt, &t);
  // the write-back: y1 on accept, y on reject
  float g_y[5], g_y1[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    g_y1[c] = t.accept ? lam[c] : 0.0f;
    g_y[c] = t.accept ? 0.0f : lam[c];
  }
  float g_dt = 0.0f, g_err = 0.0f;
  if (!FREEZE)
    kerr_rk45_next_vjp(s, t, kerr_rk45_terminal(s, t), lam[5], g_y, g_y1,
                       &g_dt, &g_err);
  kerr_rk45_trial_vjp(s, E, L, t, g_err, g_y, g_y1, g_dt, lam, gt);
}

}  // namespace curvis
