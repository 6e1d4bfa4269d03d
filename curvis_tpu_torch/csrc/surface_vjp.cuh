// Hand-written VJPs shared by the checkpoint kernels of the planar disk
// marches: the crossing fraction and hit-slot cotangents of the thin disk,
// and the emission of the volumetric gas (planar_vol.cuh:vol_emission),
// with the dispatch of the volumetric flags.  Used by ckpt_surface.cu (the
// Euler families) and ckpt_surface_rk45.cu (the DP5(4) families).
//
// The VJPs are written out in reverse mode from the forward forms; at a
// clamp the cotangent passes on the closed interval and a max of two equal
// values splits it in halves, as torch's autograd does, so the plain
// versions (ops/ckpt_surface_cuda.py) equal torch.func.vjp of the steps.
#pragma once

#include <type_traits>

#include "planar_vol.cuh"

namespace curvis {

constexpr int kFlagBlackbody = 1, kFlagRedshift = 2, kFlagDoppler = 4,
              kFlagScatter = 8;

// ---------------------------------------------------------------- thin disk

// The crossing fraction frac = |zq| / max(|zq| + |zq1|, 1e-30) of a step
// from zq to zq1, with what its VJP reads.
struct CrossFrac {
  float a0, a1;      // |zq|, |zq1|
  float inv_den;     // 1 / max(a0 + a1, 1e-30)
  bool big;          // a0 + a1 >= 1e-30
  float frac;
};

__device__ __forceinline__ CrossFrac crossing_frac(float zq, float zq1) {
  CrossFrac cf;
  cf.a0 = fabsf(zq);
  cf.a1 = fabsf(zq1);
  const float den = cf.a0 + cf.a1;
  cf.big = den >= 1e-30f;
  cf.inv_den = 1.0f / max_nan(den, 1e-30f);
  cf.frac = cf.a0 * cf.inv_den;
  return cf;
}

// Cotangents of (zq, zq1) from that of frac.
__device__ __forceinline__ void crossing_frac_vjp(const CrossFrac& cf,
                                                  float zq, float zq1,
                                                  float g_frac, float* g_zq,
                                                  float* g_zq1) {
  const float g_a0 = cf.big ? g_frac * cf.a1 * cf.inv_den * cf.inv_den
                            : g_frac * cf.inv_den;
  const float g_a1 =
      cf.big ? -g_frac * cf.a0 * cf.inv_den * cf.inv_den : 0.0f;
  *g_zq = g_a0 * sgn(zq);
  *g_zq1 = g_a1 * sgn(zq1);
}

// The cotangent of the hit triple (lh, p_l, psi) that a step wrote into
// slot k of the six hit values lam_h (0 or 3; -1 for none: zeros); the
// filled slot's old value gets none, as through a select.
__device__ __forceinline__ void take_hit_cotangent(int k, float* lam_h,
                                                   float* g_lh, float* g_plh,
                                                   float* g_psih) {
  *g_lh = *g_plh = *g_psih = 0.0f;
  if (k >= 0) {
    *g_lh = lam_h[k];
    *g_plh = lam_h[k + 1];
    *g_psih = lam_h[k + 2];
    lam_h[k] = lam_h[k + 1] = lam_h[k + 2] = 0.0f;
  }
}

// ----------------------------------------------------------------- vol gas

// Cotangents of the emission's radius r(l) (l for the lapse kinds, else
// rsqrt of planar_inv_r2): adds to *g_l and gp[0..2] (a table: s^2 to
// gp[0] and its series coefficients to gc, c1's then c2's at
// gc + kChebCap, through table_shape_vjp).
template <int KIND, class S>
__device__ __forceinline__ void radius_vjp(const S& m, float l, float g_r,
                                           float* g_l, float gp[3],
                                           float* gc) {
  if constexpr (HasCapture<KIND>::value) {
    *g_l += g_r;
  } else {
    const float q = planar_inv_r2<KIND>(m, l);
    const float r = rsqrtf(q);
    const float g_q = g_r * (-0.5f) * r * r * r;
    if constexpr (KIND == kTable) {
      // q = inv of the series; dr3 gets no cotangent
      float inv, dr3;
      table_shape_vjp<false>(m.tab, l, g_q, 0.0f, &inv, &dr3, g_l, &gp[0],
                             gc, gc + kChebCap);
    } else if constexpr (KIND == kEllis) {
      const float g_den = -g_q * q * q;
      *g_l += g_den * 2.0f * l;
      gp[0] += g_den * 2.0f * m.p0;
    } else if constexpr (KIND == kFlat) {
      *g_l += -g_q * q * q * 2.0f * l;
    } else {  // kInterstellar: q = ir^2, ir = 1 / rd
      const float ma = m.p0, a = m.p1;
      float rd, dr;
      dneg_shape(ma, a, m.p2, l, &rd, &dr);
      const float ir = 1.0f / rd;
      const float g_rd = -(g_q * 2.0f * ir) * ir * ir;
      gp[2] += g_rd;                               // drd/drho = 1
      if (fabsf(l) > a) {
        const float sg = l < 0.0f ? -1.0f : 1.0f;
        const float c = 2.0f / (kPi * ma);
        const float x = c * (fabsf(l) - a);
        const float at = atanf(x);
        const float g_x = g_rd * ma * at;
        gp[0] += g_rd * (x * at - 0.5f * log1pf(x * x)) - g_x * x / ma;
        gp[1] += -g_x * c;
        *g_l += g_x * sg * c;
      }
    }
  }
}

// VJP of the colour tail vol_color (vol_common.cuh), with the scattering
// source scatter_source when `sc`, at radius rr = max(r_cyl, r_in) with
// shift g_shift and tb = e^-tau density, for the cotangents g_dem[3] of
// dem: sets the cotangents of tb, g_shift, rr and (through the scattering
// source's radius) r_cyl, and adds to *g_rin, *g_rout, gs (the 8 slots, in
// VolSlots order) and g_blk (the 27 block scalars).  Shared by the planar
// (vol_emission_vjp) and the Boyer-Lindquist (kerr_surface_vjp.cuh) gas.
__device__ __forceinline__ void vol_color_vjp(
    bool bb, bool sc, const VolSlots& vs, float r_in, float r_out, float rr,
    float r_cyl, float g_shift, float tb, const float* blk,
    const float g_dem[3], float* g_tb_out, float* g_g_out, float* g_rr_out,
    float* g_rcyl_out, float* g_rin, float* g_rout, float* gs,
    float* g_blk) {
  float g_tb = 0.0f, g_g = 0.0f, g_rr = 0.0f, g_rcyl = 0.0f;
  if (bb) {
    const float sq = sqrtf(r_in / rr);
    const float ln_r = logf(rr);
    const float om_raw = 1.0f - sq;
    const float om = max_nan(om_raw, 1e-20f);
    const float f = expf(-0.75f * ln_r + 0.25f * logf(om));
    const float t_obs = g_shift * vs.t_scale * f;
    const float rel_sq = t_obs / vs.t_peak;
    float rel = rel_sq * rel_sq;
    rel = rel * rel;
    const float inv_T = 1.0f / max_nan(t_obs, 1.0f);
    const float ks[3] = {kBbK0, kBbK1, kBbK2};
    const float l5s[3] = {kBbL50, kBbL51, kBbL52};
    float es[3], qs[3], lg[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = ks[c] * inv_T;
      es[c] = expf(-x);
      qs[c] = 1.0f - es[c];
      lg[c] = l5s[c] - (x + logf(max_nan(qs[c], 1e-30f)));
    }
    const float m12 = max_nan(lg[1], lg[2]);
    const float mx = max_nan(lg[0], m12);
    const float w = tb * rel;
    float g_w = 0.0f, g_lg[3], g_m = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ex = expf(lg[c] - mx);
      g_w += g_dem[c] * ex;
      g_lg[c] = g_dem[c] * w * ex;
      g_m -= g_lg[c];
    }
    const float s0 = max_share(lg[0], m12);
    const float s1 = max_share(lg[1], lg[2]);
    g_lg[0] += g_m * s0;
    g_lg[1] += g_m * (1.0f - s0) * s1;
    g_lg[2] += g_m * (1.0f - s0) * (1.0f - s1);
    g_tb += g_w * rel;
    const float g_rel = g_w * tb;
    const float g_relsq = g_rel * 4.0f * rel_sq * rel_sq * rel_sq;
    float g_tobs = g_relsq / vs.t_peak;
    gs[4] += -g_relsq * rel_sq / vs.t_peak;        // t_peak
    float g_invT = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float qc = max_nan(qs[c], 1e-30f);
      const float g_x =
          -g_lg[c] - g_lg[c] * es[c] / qc * pass(qs[c], 1e-30f, INFINITY);
      g_invT += g_x * ks[c];
    }
    g_tobs -= g_invT * inv_T * inv_T * pass(t_obs, 1.0f, INFINITY);
    g_g += g_tobs * vs.t_scale * f;
    gs[7] += g_tobs * g_shift * f;                 // t_scale
    const float g_f = g_tobs * g_shift * vs.t_scale;
    const float g_arg = g_f * f;
    const float g_lnr = -0.75f * g_arg;
    const float g_om = 0.25f * g_arg / om;
    const float g_sq = -g_om * pass(om_raw, 1e-20f, INFINITY);
    const float g_ratio = g_sq * 0.5f / sq;
    *g_rin += g_ratio / rr;
    g_rr += -g_ratio * (r_in / rr) / rr + g_lnr / rr;
  } else {
    const float ratio = r_in / rr;
    const float L = logf(ratio);
    const float emis = expf(vs.emis_q * L);
    const float cg = clip_nan(g_shift, 0.0f, 4.0f);
    const float cg3 = cg * cg * cg;
    const float w = tb * emis * cg3;
    float g_w;
    if (sc) {
      g_w = g_dem[0] * blk[0] + g_dem[1] * blk[1] + g_dem[2] * blk[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) g_blk[c] += g_dem[c] * w;
    } else {
      g_w = g_dem[0] + g_dem[1] + g_dem[2];
    }
    g_tb += g_w * emis * cg3;
    const float g_emis = g_w * tb * cg3;
    const float g_cg3 = g_w * tb * emis;
    g_g += g_cg3 * 3.0f * cg * cg * pass(g_shift, 0.0f, 4.0f);
    gs[5] += g_emis * emis * L;                    // emis_q
    const float g_ratio = g_emis * emis * vs.emis_q / ratio;
    *g_rin += g_ratio / rr;
    g_rr += -g_ratio * ratio / rr;
  }
  if (sc) {
    // scat_c = tb max(acc_c, 0), acc_c a Horner sum in t
    const float W = r_out - r_in;
    const float t_raw = 2.0f * (r_cyl - r_in) / W - 1.0f;
    const float t = clip_nan(t_raw, -1.0f, 1.0f);
    float g_t = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int c0 = 3 + c * (kScatterDeg + 1);
      float accs[kScatterDeg + 1];
      accs[0] = blk[c0 + kScatterDeg];
#pragma unroll
      for (int j = 1; j <= kScatterDeg; ++j)
        accs[j] = accs[j - 1] * t + blk[c0 + kScatterDeg - j];
      const float acc = accs[kScatterDeg];
      g_tb += g_dem[c] * max_nan(acc, 0.0f);
      float G = g_dem[c] * tb * pass(acc, 0.0f, INFINITY);
#pragma unroll
      for (int j = kScatterDeg; j >= 1; --j) {
        g_blk[c0 + kScatterDeg - j] += G;
        g_t += G * accs[j - 1];
        G = G * t;
      }
      g_blk[c0 + kScatterDeg] += G;
    }
    const float g_a = g_t * pass(t_raw, -1.0f, 1.0f) * 2.0f / W;
    g_rcyl += g_a;
    const float g_W = -g_a * (r_cyl - r_in) / W;
    *g_rin += -g_a - g_W;
    *g_rout += g_W;
  }
  *g_tb_out = g_tb;
  *g_g_out = g_g;
  *g_rr_out = g_rr;
  *g_rcyl_out = g_rcyl;
}

// VJP of vol_emission (planar_vol.cuh) at (l, p_l, b, zq, tau, nz) with
// the runtime flags, for the cotangents (g_dtau, g_dem[3]) of (dtau, dem):
// adds to *g_l, *g_pl, *g_zq, *g_tau and to g (the theta layout of the vol
// family: p0, p1, p2 at 0-2, b at 3, nz at 6, r_in, r_out and the 8 slots
// at 7-16, the scatter block at 17-43; a table's s^2 at 0 and its series
// coefficients at gc, as radius_vjp's).
template <int KIND, class VS>
__device__ __forceinline__ void vol_emission_vjp(
    const VS& s, int flags, float l, float p_l, float b, float zq,
    float tau, float nz, float g_dtau, const float g_dem[3], float* g_l,
    float* g_pl, float* g_zq, float* g_tau, float* g, float* gc) {
  constexpr bool kLapse = HasCapture<KIND>::value;
  const bool bb = flags & kFlagBlackbody;
  const bool rs = kLapse && (flags & kFlagRedshift);
  const bool dop = kLapse && (flags & kFlagDoppler);
  const bool sc = flags & kFlagScatter;
  const auto& m = s.m;
  const VolSlots& vs = s.v;
  const float r_in = s.r_in, r_out = s.r_out;
  const float* blk = s.scatter;
  float* g_rin = g + 7;
  float* g_rout = g + 8;
  float* gs = g + 9;          // the 8 slots, in VolSlots order
  float* g_blk = g + 17;
  // ---- forward, as vol_emission
  float r;
  if constexpr (kLapse) {
    r = l;
  } else {
    r = rsqrtf(planar_inv_r2<KIND>(m, l));
  }
  const float zq2 = zq * zq;
  const float s2_raw = 1.0f - zq2;
  const float s2 = clip_nan(s2_raw, 1e-12f, 1.0f);
  const float sq_s2 = sqrtf(s2);
  const float r_cyl = r * sq_s2;
  const float dn = 2.0f * vs.h2 * s2;
  const float E = expf(-zq2 / dn);
  const float P = vs.inv_norm / r_cyl;
  const float dens = E * P;
  const float w_edge = r_out - r_in;
  const float ein_raw = (r_cyl - r_in) / (0.1f * w_edge);
  const float edge_in = clip_nan(ein_raw, 0.0f, 1.0f);
  const float eout_raw = (r_out - r_cyl) / (0.3f * w_edge);
  const float edge_out = clip_nan(eout_raw, 0.0f, 1.0f);
  const float base = dens * edge_in * edge_out;
  const float rr = max_nan(r_cyl, r_in);
  float g_shift = 1.0f;
  float M = 0.0f, q2 = 0.0f, A_raw = 0.0f, vsq = 0.0f, sqA = 1.0f,
        g0 = 1.0f, svsq = 0.0f, vr = 0.0f, vel = 0.0f, gamma = 1.0f,
        u_l = 0.0f, u_psi = 0.0f, inv = 0.0f, upi = 0.0f, cos_xi = 0.0f,
        D = 1.0f;
  if (rs || dop) {
    M = m.p0;
    if constexpr (KIND == kReissnerNordstrom) {
      q2 = m.p1;
      A_raw = 1.0f - (2.0f * M - q2 / rr) / rr;
      vsq = (M - q2 / rr) / rr;
    } else {
      A_raw = 1.0f - 2.0f * M / rr;
      vsq = M / rr;
    }
    const float A = clip_nan(A_raw, 1e-3f, 1.0f);
    sqA = sqrtf(A);
    g0 = rs ? sqA : 1.0f;
    g_shift = g0;
    if (dop) {
      svsq = sqrtf(vsq);
      vr = svsq / sqA;
      vel = clip_nan(vr, 0.0f, 0.99f);
      gamma = rsqrtf(1.0f - vel * vel);
      u_l = p_l * sqA;
      u_psi = b / rr;
      inv = rsqrtf(u_l * u_l + u_psi * u_psi + 1e-30f);
      upi = u_psi * inv;
      cos_xi = upi * nz * vs.spin_sign;
      D = gamma * (1.0f - vel * cos_xi);
      g_shift = g0 / D;
    }
  }
  const float trans = expf(-tau);
  const float tb = trans * base;
  // ---- reverse
  float g_base = vs.kappa * g_dtau;
  gs[2] += base * g_dtau;                          // kappa
  float g_tb, g_g, g_rr, g_rcyl;
  vol_color_vjp(bb, sc, vs, r_in, r_out, rr, r_cyl, g_shift, tb, blk, g_dem,
                &g_tb, &g_g, &g_rr, &g_rcyl, g_rin, g_rout, gs, g_blk);
  const float g_trans = g_tb * base;
  g_base += g_tb * trans;
  *g_tau += -g_trans * trans;
  float g_M = 0.0f, g_q2 = 0.0f;
  if (rs || dop) {
    float g_sqA = 0.0f;
    if (dop) {
      const float g_g0 = g_g / D;
      const float g_D = -g_g * g_shift / D;
      const float g_gamma = g_D * (1.0f - vel * cos_xi);
      float g_vel = -g_D * gamma * cos_xi;
      const float g_cos = -g_D * gamma * vel;
      const float g_upi = g_cos * nz * vs.spin_sign;
      g[6] += g_cos * upi * vs.spin_sign;          // nz
      gs[6] += g_cos * upi * nz;                   // spin_sign
      float g_upsi = g_upi * inv;
      const float g_inv = g_upi * u_psi;
      // (g_inv inv) first: a zero cotangent stays zero where inv^3 would
      // overflow
      const float g_Q = -0.5f * (g_inv * inv) * inv * inv;
      const float g_ul = g_Q * 2.0f * u_l;
      g_upsi += g_Q * 2.0f * u_psi;
      g[3] += g_upsi / rr;                         // b
      g_rr += -g_upsi * u_psi / rr;
      *g_pl += g_ul * sqA;
      g_sqA += g_ul * p_l;
      g_vel += g_gamma * vel * gamma * gamma * gamma;
      const float g_vr = g_vel * pass(vr, 0.0f, 0.99f);
      g_sqA += -g_vr * vr / sqA;
      const float g_vsq = (g_vr / sqA) * 0.5f / svsq;
      g_M += g_vsq / rr;
      if constexpr (KIND == kReissnerNordstrom) {
        g_q2 += -g_vsq / (rr * rr);
        g_rr += g_vsq * (q2 / (rr * rr) / rr - vsq / rr);
      } else {
        g_rr += -g_vsq * M / (rr * rr);
      }
      if (rs) g_sqA += g_g0;
    } else {
      g_sqA += g_g;
    }
    const float g_A = g_sqA * 0.5f / sqA * pass(A_raw, 1e-3f, 1.0f);
    g_M += -2.0f * g_A / rr;
    if constexpr (KIND == kReissnerNordstrom) {
      g_q2 += g_A / (rr * rr);
      g_rr += g_A * (2.0f * M / (rr * rr) - 2.0f * q2 / (rr * rr * rr));
    } else {
      g_rr += g_A * 2.0f * M / (rr * rr);
    }
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
  // dens = E P, E = exp(-zq2 / dn), P = inv_norm / r_cyl
  const float g_E = g_dens * P;
  const float g_P = g_dens * E;
  gs[1] += g_P / r_cyl;                            // inv_norm
  g_rcyl += -g_P * P / r_cyl;
  const float g_arg = g_E * E;
  float g_zq2 = -g_arg / dn;
  const float g_dn = g_arg * zq2 / (dn * dn);
  gs[0] += g_dn * 2.0f * s2;                       // h2
  float g_s2 = g_dn * 2.0f * vs.h2;
  // r_cyl = r sqrt(s2), s2 = clip(1 - zq2)
  const float g_r = g_rcyl * sq_s2;
  g_s2 += g_rcyl * r * 0.5f / sq_s2;
  g_zq2 += -g_s2 * pass(s2_raw, 1e-12f, 1.0f);
  *g_zq += 2.0f * zq * g_zq2;
  radius_vjp<KIND>(m, l, g_r, g_l, g, gc);
  g[0] += g_M;
  g[1] += g_q2;
}

// Calls f(std::integral_constant<bool, BB>, ..., <bool, SC>) for the
// runtime flags; the shifts act only for the lapse kinds, so the others
// share the instance without them (as disk_vol.cu's pick_shift).
template <int KIND, typename F>
__device__ __forceinline__ void with_vol_flags(int flags, F&& f) {
  using T = std::true_type;
  using U = std::false_type;
  const bool bb = flags & kFlagBlackbody;
  const bool rs = HasCapture<KIND>::value && (flags & kFlagRedshift);
  const bool dop = HasCapture<KIND>::value && (flags & kFlagDoppler);
  const bool sc = flags & kFlagScatter;
  const int code = (bb ? 8 : 0) | (rs ? 4 : 0) | (dop ? 2 : 0) | (sc ? 1 : 0);
  switch (code) {
    case 0: f(U{}, U{}, U{}, U{}); break;
    case 1: f(U{}, U{}, U{}, T{}); break;
    case 8: f(T{}, U{}, U{}, U{}); break;
    case 9: f(T{}, U{}, U{}, T{}); break;
    default:
      if constexpr (HasCapture<KIND>::value) {
        switch (code) {
          case 2: f(U{}, U{}, T{}, U{}); break;
          case 3: f(U{}, U{}, T{}, T{}); break;
          case 4: f(U{}, T{}, U{}, U{}); break;
          case 5: f(U{}, T{}, U{}, T{}); break;
          case 6: f(U{}, T{}, T{}, U{}); break;
          case 7: f(U{}, T{}, T{}, T{}); break;
          case 10: f(T{}, U{}, T{}, U{}); break;
          case 11: f(T{}, U{}, T{}, T{}); break;
          case 12: f(T{}, T{}, U{}, U{}); break;
          case 13: f(T{}, T{}, U{}, T{}); break;
          case 14: f(T{}, T{}, T{}, U{}); break;
          default: f(T{}, T{}, T{}, T{}); break;
        }
      }
  }
}

}  // namespace curvis
