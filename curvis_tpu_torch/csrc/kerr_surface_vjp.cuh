// The hand-written VJPs of the Boyer-Lindquist surface steps
// (kerr_step.cuh: kerr_rk4_surface_step, kerr_rk45_surface_iter), the
// steps of the checkpoint kernels of the Kerr surface families: the thin
// disk and the volumetric gas of kernel #7 (ckpt_kerr_surface.cu) and of
// kernel #8 (ckpt_kerr_surface_rk45.cu).
//
// The maps differentiated are those of curvis_tpu/integrate/
// kerr_surface_adjoint.py: _disk_step (12 floats: r, theta, phi, p_r,
// p_theta, ct_prev, (h, h_phi, h_side) x 2), _vol_step (9: the five, tau,
// em_r, em_g, em_b) and _rk45_surface_iter (13 and 10: dt after the five),
// for theta = (M, a, q2, E, L) and, for the gas, the emission row (r_in,
// r_out, the 8 slots of VolSlots) and the 27 scatter scalars:
//   - the replay runs the forward kernels' own step, so it takes their
//     decisions (the crossings, the hit slots, accept, the gates); the
//     partials of the RHS are the guarded ones (kerr_vjp.cuh), as the JAX
//     maps differentiate _kerr_rhs_guarded: captured rays replay every step
//     up to capture, for their hit, tau and emission cotangents;
//   - a hit is (r, phi) of the step's start and end mixed at the crossing
//     fraction |ct_prev| / max(|ct_prev| + |ct|, 1e-30), ct = cos theta
//     after the step: the planar algebra with zq -> ct (surface_vjp.cuh:
//     crossing_frac_vjp, take_hit_cotangent), chained through -sin theta;
//     the band and the side are gates, with no cotangent;
//   - the gas adds the emission at the state after the step with the
//     pre-step tau, weighted by dte (RK4: its axis and far-field scales
//     make a term into theta and r) or by the trial dt (DP5(4)), where the
//     state passed the guard (and, DP5(4), the trial was accepted);
//   - DP5(4) without FREEZE differentiates the next dt through err, the
//     escape fraction, the thin disk's min(dt, dt0) near the disk and the
//     gas's slab bound max(dt0, max(gap_r, gap_z) / 2) (into r, theta,
//     r_out, M and h2); a rejected trial whose outputs have no cotangent
//     forms no term (kerr_vjp.cuh:kerr_rk45_trial_vjp), nor does the
//     emission of a rejected trial, which is gated off.
// At a clamp the cotangent passes on the closed interval and a max of two
// equal values splits it in halves, as torch's autograd does.
// ops/ckpt_kerr_surface_cuda.py transcribes these functions line by line
// and adds the theta terms in the same order.
#pragma once

#include "kerr_vjp.cuh"
#include "surface_vjp.cuh"

namespace curvis {

constexpr int kKerrDiskTheta = 5;    // M, a, q2, E, L (the band: a gate)
constexpr int kKerrVolTheta = 15;    // + r_in, r_out, the 8 slots
constexpr int kKerrThR = 5, kKerrThRout = 6, kKerrThSlots = 7,
              kKerrThBlock = 15;     // where the row's cotangents go

// VJP of kerr_vol_emission at (r, theta) with impact parameter b_ph and
// the pre-step tau, for the cotangents (g_dtau, g_dem[3]) of (dtau, dem):
// adds to *g_r, *g_th, *g_bph, *g_tau and g (M, a, q2 at 0-2, r_in, r_out
// at 5-6, the 8 slots at 7-14, the scatter block at 15-41).
template <bool BLACKBODY, bool BEAMING, bool SCATTER>
__device__ __forceinline__ void kerr_vol_emission_vjp(
    float M, float a, float q2, float r_in, float r_out, const VolSlots& v,
    const float* scatter, float r, float th, float b_ph, float tau,
    float g_dtau, const float g_dem[3], float* g_r, float* g_th,
    float* g_bph, float* g_tau, float* g) {
  float* g_rin = g + kKerrThR;
  float* g_rout = g + kKerrThRout;
  float* gs = g + kKerrThSlots;
  float* g_blk = g + kKerrThBlock;
  // ---- forward, as kerr_vol_emission
  const float ct = cosf(th);
  const float zq2 = ct * ct;
  const float s2_raw = 1.0f - zq2;
  const float s2 = clip_nan(s2_raw, 1e-12f, 1.0f);
  const float sq_s2 = sqrtf(s2);
  const float r_cyl = r * sq_s2;
  const float dn = 2.0f * v.h2 * s2;
  const float Ex = expf(-zq2 / dn);
  const float P = v.inv_norm / r_cyl;
  const float dens = Ex * P;
  const float w_edge = r_out - r_in;
  const float ein_raw = (r_cyl - r_in) / (0.1f * w_edge);
  const float edge_in = clip_nan(ein_raw, 0.0f, 1.0f);
  const float eout_raw = (r_out - r_cyl) / (0.3f * w_edge);
  const float edge_out = clip_nan(eout_raw, 0.0f, 1.0f);
  const float base = dens * edge_in * edge_out;
  const float rr = max_nan(r_cyl, r_in);
  float g_shift = 1.0f;
  float sp = 0.0f, qin = 0.0f, sq = 1.0f, rr2 = 1.0f, Dn = 1.0f,
        omega = 0.0f, u_raw = 1.0f, S = 1.0f, x = 1.0f, cl = 1.0f;
  if constexpr (BEAMING) {
    sp = v.spin_sign;
    qin = M * rr - q2;
    sq = sqrtf(max_nan(qin, 1e-12f));
    rr2 = rr * rr;
    Dn = rr2 + sp * a * sq;
    omega = sp * sq / Dn;
    u_raw =
        1.0f - (3.0f * M - 2.0f * q2 / rr) / rr + 2.0f * sp * a * sq / rr2;
    S = sqrtf(max_nan(u_raw, 1e-3f));
    x = 1.0f - omega * b_ph;
    cl = clip_nan(x, 0.2f, 5.0f);
    g_shift = S / cl;
  }
  const float trans = expf(-tau);
  const float tb = trans * base;
  // ---- reverse
  float g_base = v.kappa * g_dtau;
  gs[2] += base * g_dtau;                          // kappa
  float g_tb, g_g, g_rr, g_rcyl;
  vol_color_vjp(BLACKBODY, SCATTER, v, r_in, r_out, rr, r_cyl, g_shift, tb,
                scatter, g_dem, &g_tb, &g_g, &g_rr, &g_rcyl, g_rin, g_rout,
                gs, g_blk);
  const float g_trans = g_tb * base;
  g_base += g_tb * trans;
  *g_tau += -g_trans * trans;
  if constexpr (BEAMING) {
    // g = sqrt(max(u_raw, 1e-3)) / clip(1 - omega b_ph, 0.2, 5)
    const float g_S = g_g / cl;
    const float g_cl = -g_g * g_shift / cl;
    const float g_x = g_cl * pass(x, 0.2f, 5.0f);
    const float g_om = -g_x * b_ph;
    *g_bph += -g_x * omega;
    const float g_u = g_S * 0.5f / S * pass(u_raw, 1e-3f, INFINITY);
    // u_raw = 1 - A1 / rr + T / rr2, A1 = 3M - 2 q2 / rr, T = 2 sp a sq
    const float A1 = 3.0f * M - 2.0f * q2 / rr;
    const float g_A1 = -g_u / rr;
    g_rr += g_u * A1 / (rr * rr);
    float g_M = 3.0f * g_A1;
    float g_q2 = -2.0f * g_A1 / rr;
    g_rr += g_A1 * 2.0f * q2 / (rr * rr);
    const float T = 2.0f * sp * a * sq;
    const float g_T = g_u / rr2;
    float g_rr2 = -g_u * T / (rr2 * rr2);
    float g_sp = g_T * 2.0f * a * sq;
    float g_a = g_T * 2.0f * sp * sq;
    float g_sq = g_T * 2.0f * sp * a;
    // omega = sp sq / Dn, Dn = rr2 + sp a sq
    const float g_N = g_om / Dn;
    const float g_Dn = -g_om * omega / Dn;
    g_sp += g_N * sq + g_Dn * a * sq;
    g_sq += g_N * sp + g_Dn * sp * a;
    g_a += g_Dn * sp * sq;
    g_rr2 += g_Dn;
    g_rr += 2.0f * rr * g_rr2;
    // sq = sqrt(max(M rr - q2, 1e-12))
    const float g_in = g_sq * 0.5f / sq * pass(qin, 1e-12f, INFINITY);
    g_M += g_in * rr;
    g_rr += g_in * M;
    g_q2 += -g_in;
    g[0] += g_M;
    g[1] += g_a;
    g[2] += g_q2;
    gs[6] += g_sp;                                 // spin_sign
  }
  // rr = max(r_cyl, r_in)
  const float s_cyl = max_share(r_cyl, r_in);
  g_rcyl += g_rr * s_cyl;
  *g_rin += g_rr * (1.0f - s_cyl);
  // base = dens edge_in edge_out
  const float g_dens = g_base * edge_in * edge_out;
  const float g_ein = g_base * dens * edge_out * pass(ein_raw, 0.0f, 1.0f);
  const float g_eout = g_base * dens * edge_in * pass(eout_raw, 0.0f, 1.0f);
  const float g_we = -(g_ein * ein_raw + g_eout * eout_raw) / w_edge;
  g_rcyl += g_ein / (0.1f * w_edge) - g_eout / (0.3f * w_edge);
  *g_rin += -g_ein / (0.1f * w_edge) - g_we;
  *g_rout += g_eout / (0.3f * w_edge) + g_we;
  // dens = Ex P, Ex = exp(-zq2 / dn), P = inv_norm / r_cyl
  const float g_E = g_dens * P;
  const float g_P = g_dens * Ex;
  gs[1] += g_P / r_cyl;                            // inv_norm
  g_rcyl += -g_P * P / r_cyl;
  const float g_arg = g_E * Ex;
  float g_zq2 = -g_arg / dn;
  const float g_dn = g_arg * zq2 / (dn * dn);
  gs[0] += g_dn * 2.0f * s2;                       // h2
  float g_s2 = g_dn * 2.0f * v.h2;
  // r_cyl = r sqrt(s2), s2 = clip(1 - zq2), zq = cos theta
  *g_r += g_rcyl * sq_s2;
  g_s2 += g_rcyl * r * 0.5f / sq_s2;
  g_zq2 += -g_s2 * pass(s2_raw, 1e-12f, 1.0f);
  *g_th += 2.0f * ct * g_zq2 * (-sinf(th));
}

// The cotangents of a hit that a step from y to y1 wrote into slot `slot`
// (0 or 3; -1 for none) of the six hit values lam_h (whose filled slot's
// old value gets none, as through a select): adds to g_y[0], g_y[2] (r,
// phi of the start), g_y1[0], g_y1[2] (of the end), *g_ctp and *g_ct (the
// cos theta before and after the step).
__device__ __forceinline__ void kerr_hit_vjp(int slot, const float y[5],
                                             const float y1[5], float ct_prev,
                                             float ct, float* lam_h,
                                             float g_y[5], float g_y1[5],
                                             float* g_ctp, float* g_ct) {
  float g_rh, g_phh, g_side;
  take_hit_cotangent(slot, lam_h, &g_rh, &g_phh, &g_side);
  if (slot >= 0) {
    // r_hit = r + frac (r1 - r), ph_hit = ph + frac (ph1 - ph)
    const CrossFrac cf = crossing_frac(ct_prev, ct);
    const float frac = cf.frac;
    const float g_frac = g_rh * (y1[0] - y[0]) + g_phh * (y1[2] - y[2]);
    g_y1[0] += frac * g_rh;
    g_y1[2] += frac * g_phh;
    g_y[0] += (1.0f - frac) * g_rh;
    g_y[2] += (1.0f - frac) * g_phh;
    float gz0, gz1;
    crossing_frac_vjp(cf, ct_prev, ct, g_frac, &gz0, &gz1);
    *g_ctp += gz0;
    *g_ct += gz1;
  }
}

// ------------------------------------------------------------ RK4 (#7)

// VJP of the thin-disk step (kerr_rk4_surface_step<TRACK_DISK>) at its
// start y, ct_prev, given the slot it filled: lam[12] is the cotangent of
// the state after it and becomes that before it; gt[5] gathers the
// cotangents of (M, a, q2, E, L).
__device__ __forceinline__ void kerr_rk4_disk_vjp(const KerrScalars& s,
                                                  float E, float L,
                                                  const float y[5],
                                                  float ct_prev, int slot,
                                                  float lam[12],
                                                  float gt[5]) {
  float y1[5];
  kerr_rk4_step(s, E, L, y, y1);
  float g_y1[5], g_y[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    g_y1[c] = lam[c];
    g_y[c] = 0.0f;
  }
  float g_ct = lam[5], g_ctp = 0.0f;
  if (slot >= 0)
    kerr_hit_vjp(slot, y, y1, ct_prev, cosf(y1[1]), lam + 6, g_y, g_y1,
                 &g_ctp, &g_ct);
  // ct = cos theta after the step
  g_y1[1] += g_ct * (-sinf(y1[1]));
  kerr_rk4_vjp<true>(s, E, L, y, g_y1, gt);
#pragma unroll
  for (int c = 0; c < 5; ++c) lam[c] = g_y1[c] + g_y[c];
  lam[5] = g_ctp;
}

// VJP of the gas step (kerr_rk4_surface_step<VOL>) at its start y, tau:
// lam[9] is the cotangent of the state after it and becomes that before
// it; g gathers the theta cotangents of the gas family.
template <bool BLACKBODY, bool BEAMING, bool SCATTER>
__device__ __forceinline__ void kerr_rk4_vol_vjp(const KerrScalars& s,
                                                 float E, float L,
                                                 float b_ph,
                                                 const float y[5], float tau,
                                                 float lam[9], float* g) {
  float y1[5];
  const float dte = kerr_rk4_step(s, E, L, y, y1);
  float g5[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) g5[c] = lam[c];
  float g_dte = 0.0f, g_tau = lam[5];
  if (kerr_finite(y1)) {
    // tau += dte dtau, em += dte dem
    float dtau, dem[3];
    kerr_vol_emission<BLACKBODY, BEAMING, SCATTER>(
        s.M, s.a, s.q2, s.r_in, s.r_out, s.v, s.scatter, y1[0], y1[1], b_ph,
        tau, &dtau, dem);
    g_dte = lam[5] * dtau + lam[6] * dem[0] + lam[7] * dem[1] +
            lam[8] * dem[2];
    const float g_dem[3] = {dte * lam[6], dte * lam[7], dte * lam[8]};
    float g_bph = 0.0f;
    kerr_vol_emission_vjp<BLACKBODY, BEAMING, SCATTER>(
        s.M, s.a, s.q2, s.r_in, s.r_out, s.v, s.scatter, y1[0], y1[1], b_ph,
        tau, dte * lam[5], g_dem, &g5[0], &g5[1], &g_bph, &g_tau, g);
    // b_ph = L / E
    g[4] += g_bph / E;
    g[3] += -g_bph * b_ph / E;
  }
  kerr_rk4_vjp<true, true>(s, E, L, y, g5, g, g_dte);
#pragma unroll
  for (int c = 0; c < 5; ++c) lam[c] = g5[c];
  lam[5] = g_tau;
}

// -------------------------------------------------------- DP5(4) (#8)

// VJP of the thin-disk iteration (kerr_rk45_surface_iter<TRACK_DISK>) at
// its start (y, dt), ct_prev, given the slot it filled: lam[13] is the
// cotangent of the state after it and becomes that before it; gt[5]
// gathers the cotangents of (M, a, q2, E, L).  `freeze` drops the
// cotangent of the next dt.
__device__ __forceinline__ void kerr_rk45_disk_vjp(
    const KerrRk45Scalars& s, float E, float L, const float y[5], float dt,
    float ct_prev, int slot, bool freeze, float lam[13], float gt[5]) {
  KerrRk45Rec t;
  kerr_rk45_trial(s, E, L, y, dt, &t);
  // the write-back: y1 and ct on accept, y and ct_prev on reject
  float g_y[5], g_y1[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    g_y1[c] = t.accept ? lam[c] : 0.0f;
    g_y[c] = t.accept ? 0.0f : lam[c];
  }
  float g_ct = t.accept ? lam[6] : 0.0f;
  float g_ctp = t.accept ? 0.0f : lam[6];
  float g_dt = 0.0f, g_err = 0.0f;
  if (!freeze) {
    const bool terminal = kerr_rk45_terminal(s, t);
    float g_next = lam[5];
    if (!terminal) {
      // dt = min(next, dt0) inside r_out + 2M
      const float rn = t.accept ? t.y1[0] : y[0];
      if (rn < s.r_out + 2.0f * s.M)
        g_next = g_next * max_share(s.dt0, kerr_rk45_next_dt(s, t));
    }
    kerr_rk45_next_vjp(s, t, terminal, g_next, g_y, g_y1, &g_dt, &g_err);
  }
  if (slot >= 0)
    kerr_hit_vjp(slot, y, t.y1, ct_prev, cosf(t.y1[1]), lam + 7, g_y, g_y1,
                 &g_ctp, &g_ct);
  // ct = cos theta of the trial
  if (t.accept) g_y1[1] += g_ct * (-sinf(t.y1[1]));
  kerr_rk45_trial_vjp(s, E, L, t, g_err, g_y, g_y1, g_dt, lam, gt);
  lam[6] = g_ctp;
}

// VJP of the gas iteration (kerr_rk45_surface_iter<VOL>) at its start (y,
// dt), tau: lam[10] is the cotangent of the state after it and becomes
// that before it; g gathers the theta cotangents of the gas family.
template <bool BLACKBODY, bool BEAMING, bool SCATTER>
__device__ __forceinline__ void kerr_rk45_vol_vjp(
    const KerrRk45Scalars& s, float E, float L, float b_ph, const float y[5],
    float dt, float tau, bool freeze, float lam[10], float* g) {
  KerrRk45Rec t;
  kerr_rk45_trial(s, E, L, y, dt, &t);
  float g_y[5], g_y1[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    g_y1[c] = t.accept ? lam[c] : 0.0f;
    g_y[c] = t.accept ? 0.0f : lam[c];
  }
  // the quadrature, on an accepted trial whose state passed the guard
  const bool gate = t.accept && kerr_finite(t.y1);
  float dtau = 0.0f, dem[3] = {0.0f, 0.0f, 0.0f};
  if (gate)
    kerr_vol_emission<BLACKBODY, BEAMING, SCATTER>(
        s.M, s.a, s.q2, s.r_in, s.r_out, s.v, s.scatter, t.y1[0], t.y1[1],
        b_ph, tau, &dtau, dem);
  const float tau1 = gate ? tau + dt * dtau : tau;
  float g_dt = 0.0f, g_err = 0.0f, g_tau = lam[6];
  if (!freeze) {
    const bool terminal =
        kerr_rk45_terminal(s, t) || tau1 > s.v.tau_max;
    float g_next = lam[5];
    if (!terminal) {
      // dt = min(next, max(dt0, max(gap_r, gap_z) / 2)) at (rn, thn)
      const float rn = t.accept ? t.y1[0] : y[0];
      const float thn = t.accept ? t.y1[1] : y[1];
      const float next = kerr_rk45_next_dt(s, t);
      const float sn = sinf(thn), cn = cosf(thn);
      const float s_th = fabsf(sn);
      const float r_cyl = rn * s_th;
      const float gap_r = r_cyl - (s.r_out + 2.0f * s.M);
      const float sh2 = sqrtf(s.v.h2);
      const float h_rel5 = 5.0f * sh2;
      const float gap_z = rn * fabsf(cn) - h_rel5 * r_cyl;
      const float lim_raw = 0.5f * max_nan(gap_r, gap_z);
      const float lim = max_nan(s.dt0, lim_raw);
      const float g_lim = g_next * max_share(next, lim);
      g_next = g_next * max_share(lim, next);
      const float g_gap = 0.5f * (g_lim * max_share(lim_raw, s.dt0));
      const float s_r = max_share(gap_r, gap_z);
      const float g_gr = g_gap * s_r, g_gz = g_gap * (1.0f - s_r);
      float g_rcyl = g_gr;
      g[kKerrThRout] += -g_gr;                     // r_out
      g[0] += -2.0f * g_gr;                        // M
      float g_rn = g_gz * fabsf(cn);
      float g_thn = g_gz * rn * sgn(cn) * (-sn);
      g_rcyl += -g_gz * h_rel5;
      g[kKerrThSlots] += -g_gz * r_cyl * 5.0f * 0.5f / sh2;   // h2
      // r_cyl = rn |sin thn|
      g_rn += g_rcyl * s_th;
      g_thn += g_rcyl * rn * sgn(sn) * cn;
      if (t.accept) {
        g_y1[0] += g_rn;
        g_y1[1] += g_thn;
      } else {
        g_y[0] += g_rn;
        g_y[1] += g_thn;
      }
    }
    kerr_rk45_next_vjp(s, t, terminal, g_next, g_y, g_y1, &g_dt, &g_err);
  }
  if (gate) {
    // tau += dt dtau, em += dt dem with the trial dt
    g_dt += lam[6] * dtau + lam[7] * dem[0] + lam[8] * dem[1] +
            lam[9] * dem[2];
    const float g_dem[3] = {dt * lam[7], dt * lam[8], dt * lam[9]};
    float g_bph = 0.0f;
    kerr_vol_emission_vjp<BLACKBODY, BEAMING, SCATTER>(
        s.M, s.a, s.q2, s.r_in, s.r_out, s.v, s.scatter, t.y1[0], t.y1[1],
        b_ph, tau, dt * lam[6], g_dem, &g_y1[0], &g_y1[1], &g_bph, &g_tau,
        g);
    // b_ph = L / E
    g[4] += g_bph / E;
    g[3] += -g_bph * b_ph / E;
  }
  kerr_rk45_trial_vjp(s, E, L, t, g_err, g_y, g_y1, g_dt, lam, g);
  lam[6] = g_tau;
}

}  // namespace curvis
