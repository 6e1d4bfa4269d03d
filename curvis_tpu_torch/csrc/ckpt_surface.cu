// Checkpointed-recompute adjoint of the planar disk marches: checkpoint
// generation and the reverse-segment backward sweep for the thin-disk
// (11-state) and volumetric (9-state) Euler step families, one thread per
// ray (CUDA, sm_90a).
//
// Replaces the TPU kernels curvis_tpu/ops/ckpt_adjoint_pallas.py:
// _ckpt_gen_kernel (#9) and _ckpt_bwd_kernel (#10) driven by the step maps
// of curvis_tpu/integrate/planar_surface_adjoint.py (_pl_disk_step,
// _pl_vol_step).  The Python wrapper is
// curvis_tpu_torch/ops/ckpt_surface_cuda.py, which also holds the plain
// PyTorch versions of both kernels and of the two step VJPs written here.
//
// Families (the state per ray, then theta, the parameters whose cotangents
// bwd returns per ray):
//   thin:  y = (l, psi, p_l, u, v, h1, h1p, h1s, h2, h2p, h2s),
//          theta = (p0, p1, p2, b, c1, c2, r_in, r_out);
//   vol:   y = (l, psi, p_l, u, v, tau, em_r, em_g, em_b),
//          theta = (p0, p1, p2, b, c1, c2, nz, r_in, r_out, the 8 emission
//          slots of VolSlots, the 27 scatter scalars when SCATTER is on).
// The step is the forward kernels' own: disk_step (planar.cuh), which
// disk.cu (#5) marches, and vol_step (planar_vol.cuh), which disk_vol.cu
// (#6) marches, so the replay takes the crossing decisions that the forward
// took.  The four volumetric flags (blackbody, redshift, doppler, scatter)
// arrive as a runtime bitmask, the same for every thread of a launch: the
// forward step is dispatched once per segment to its templated instance,
// the VJP branches on the bits.  Kernels are templated on the metric kind
// and the family only (20 instances).
//
//   gen: march steps[i] steps from y0 = (l, psi, p_l, cos psi, sin psi,
//        0...), writing the state at the start of each of the ray's
//        segments to its rows of the compacted buffer: ray i owns
//        ceil(steps[i] / seg) rows of n_state floats from offsets[i] (the
//        exclusive prefix sum of those counts); the final state goes to
//        final[c][i].
//   bwd: for each of the ray's segments, last to first: re-march it from
//        its checkpoint keeping what the step VJP reads (l, p_l, u, v and
//        the filled hit slots as two bit masks for thin; l, p_l, u, v, tau
//        for vol) in per-thread arrays, then pull lam back through the
//        steps in reverse with disk_step_vjp / vol_step_vjp, summing the
//        theta cotangents per ray.
//
// The VJPs are written out in reverse mode from the forward forms; at a
// clamp the cotangent passes on the closed interval and a max of two equal
// values splits it in halves, as torch's autograd does, so the plain
// versions equal torch.func.vjp of the steps.
//
// What bounds it on the H100: FP32 issue and warp divergence, as the march
// kernels.  Gen does one march (~64 operations a thin step, ~150-280 a
// volumetric one); bwd re-marches it and adds the VJP (~2-3x a step), so
// the pair costs ~4 marches.  Device memory moves the checkpoint buffer
// once out and once in (11 or 9 floats per ray per segment, a few percent
// of the time at seg = 32); the per-step start states live in per-thread
// local memory (4 or 5 x seg floats).  The design does nothing about
// divergence (no ray sorting): this is the correct, simple form.
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "planar_vol.cuh"

namespace curvis {

constexpr int kSurfThreads = 128;
constexpr int kSurfMaxSeg = 64;     // longest segment the backward can hold
constexpr int kDiskState = 11;
constexpr int kVolState = 9;
constexpr int kDiskTheta = 8;
constexpr int kVolTheta = 17 + kScatterBlock;   // the most a vol launch uses
constexpr int kFlagBlackbody = 1, kFlagRedshift = 2, kFlagDoppler = 4,
              kFlagScatter = 8;

// sign(x) with sign(0) = 0 and NaN kept, as torch.sign
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// 1 where a clamp to [lo, hi] passes the cotangent, else 0
__device__ __forceinline__ float pass(float x, float lo, float hi) {
  return (x >= lo && x <= hi) ? 1.0f : 0.0f;
}

// a's share of the cotangent of max(a, b): 1, 0 or 1/2 at a tie
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.0f : (a < b ? 0.0f : 0.5f);
}

// ---------------------------------------------------------------- thin VJP

// VJP of disk_step at its start (l, p_l, u, v), given which slot the step
// filled.  lam[11] is the cotangent of the step's output and becomes that
// of its input; g[0..5] gather the cotangents of p0, p1, p2, b, c1, c2 (the
// band r_in, r_out is a gate: no cotangent).
template <int KIND>
__device__ __forceinline__ void disk_step_vjp(const MarchScalars& s,
                                              float l, float p_l, float u,
                                              float v, bool new1, bool new2,
                                              float b, float b2, float c1,
                                              float c2, float lam[kDiskState],
                                              float g[kDiskTheta]) {
  const float dt = s.dt;
  float dl, dpsi, dpl;
  planar_deriv<KIND>(s, l, p_l, b, b2, &dl, &dpsi, &dpl);
  const float l1 = l + dt * dl;
  const float pl1 = p_l + dt * dpl;
  const float du = dt * dpsi;
  const float u1 = u - v * du;
  const float v1 = v + u * du;
  const float zq = c1 * u + c2 * v;
  const float zq1 = c1 * u1 + c2 * v1;
  const float a0 = fabsf(zq), a1 = fabsf(zq1);
  const float den = a0 + a1;
  const bool big = den >= 1e-30f;
  const float inv_den = 1.0f / max_nan(den, 1e-30f);
  const float frac = a0 * inv_den;
  // the hit triple written this step; a filled slot's old value gets none
  float g_lh = 0.0f, g_plh = 0.0f, g_psih = 0.0f;
  if (new1) {
    g_lh = lam[5];
    g_plh = lam[6];
    g_psih = lam[7];
    lam[5] = lam[6] = lam[7] = 0.0f;
  } else if (new2) {
    g_lh = lam[8];
    g_plh = lam[9];
    g_psih = lam[10];
    lam[8] = lam[9] = lam[10] = 0.0f;
  }
  const float g_frac = g_lh * (l1 - l) + g_plh * (pl1 - p_l) + g_psih * du;
  const float g_l1 = lam[0] + frac * g_lh;
  const float g_pl1 = lam[2] + frac * g_plh;
  float g_du = lam[1] + frac * g_psih;
  // frac = a0 / max(a0 + a1, 1e-30)
  const float g_a0 =
      big ? g_frac * a1 * inv_den * inv_den : g_frac * inv_den;
  const float g_a1 = big ? -g_frac * a0 * inv_den * inv_den : 0.0f;
  const float g_zq = g_a0 * sgn(zq);
  const float g_zq1 = g_a1 * sgn(zq1);
  // zq = c1 u + c2 v, zq1 = c1 u1 + c2 v1, u1 = u - v du, v1 = v + u du
  const float g_u1 = lam[3] + c1 * g_zq1;
  const float g_v1 = lam[4] + c2 * g_zq1;
  g[4] += u * g_zq + u1 * g_zq1;
  g[5] += v * g_zq + v1 * g_zq1;
  const float g_u = c1 * g_zq + g_u1 + du * g_v1;
  const float g_v = c2 * g_zq - du * g_u1 + g_v1;
  g_du = g_du - v * g_u1 + u * g_v1;
  // the Euler update and the RHS: l1 = l + dt dl, du = dt dpsi, ...
  float lam_l = g_l1, lam_pl = g_pl1;
  euler_step_vjp<KIND>(s, l, p_l, b, b2, &lam_l, g_du, &lam_pl, g);
  lam[0] = lam_l + (1.0f - frac) * g_lh;
  lam[1] = lam[1] + g_psih;
  lam[2] = lam_pl + (1.0f - frac) * g_plh;
  lam[3] = g_u;
  lam[4] = g_v;
}

// ----------------------------------------------------------------- vol VJP

// Cotangents of the emission's radius r(l) (l for the lapse kinds, else
// rsqrt of planar_inv_r2): adds to *g_l and gp[0..2].
template <int KIND>
__device__ __forceinline__ void radius_vjp(const MarchScalars& m, float l,
                                           float g_r, float* g_l,
                                           float gp[3]) {
  if constexpr (HasCapture<KIND>::value) {
    *g_l += g_r;
  } else {
    const float q = planar_inv_r2<KIND>(m, l);
    const float r = rsqrtf(q);
    const float g_q = g_r * (-0.5f) * r * r * r;
    if constexpr (KIND == kEllis) {
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

// VJP of vol_emission (planar_vol.cuh) at (l, p_l, b, zq, tau, nz) with
// the runtime flags, for the cotangents (g_dtau, g_dem[3]) of (dtau, dem):
// adds to *g_l, *g_pl, *g_zq, *g_tau and to g (the theta layout of the vol
// family: p0, p1, p2 at 0-2, b at 3, nz at 6, r_in, r_out and the 8 slots
// at 7-16, the scatter block at 17-43).
template <int KIND>
__device__ __forceinline__ void vol_emission_vjp(
    const VolScalars& s, int flags, float l, float p_l, float b, float zq,
    float tau, float nz, float g_dtau, const float g_dem[3], float* g_l,
    float* g_pl, float* g_zq, float* g_tau, float* g) {
  constexpr bool kLapse = HasCapture<KIND>::value;
  const bool bb = flags & kFlagBlackbody;
  const bool rs = kLapse && (flags & kFlagRedshift);
  const bool dop = kLapse && (flags & kFlagDoppler);
  const bool sc = flags & kFlagScatter;
  const MarchScalars& m = s.m;
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
  radius_vjp<KIND>(m, l, g_r, g_l, g);
  g[0] += g_M;
  g[1] += g_q2;
}

// VJP of vol_step at its start (l, p_l, u, v, tau).  lam[9] is the
// cotangent of the step's output and becomes that of its input; g gathers
// the theta cotangents of the vol family.
template <int KIND>
__device__ __forceinline__ void vol_step_vjp(const VolScalars& s, int flags,
                                             float l, float p_l, float u,
                                             float v, float tau, float b,
                                             float b2, float c1, float c2,
                                             float nz, float lam[kVolState],
                                             float* g) {
  const float dt = s.m.dt;
  float dl, dpsi, dpl;
  planar_deriv<KIND>(s.m, l, p_l, b, b2, &dl, &dpsi, &dpl);
  const float l1 = l + dt * dl;
  const float pl1 = p_l + dt * dpl;
  const float du = dt * dpsi;
  const float u1 = u - v * du;
  const float v1 = v + u * du;
  const float zq = c1 * u1 + c2 * v1;
  const float g_dem[3] = {dt * lam[6], dt * lam[7], dt * lam[8]};
  float g_l1 = lam[0], g_pl1 = lam[2], g_zq = 0.0f, g_tau = 0.0f;
  vol_emission_vjp<KIND>(s, flags, l1, pl1, b, zq, tau, nz, dt * lam[5],
                         g_dem, &g_l1, &g_pl1, &g_zq, &g_tau, g);
  const float g_u1 = lam[3] + c1 * g_zq;
  const float g_v1 = lam[4] + c2 * g_zq;
  g[4] += u1 * g_zq;
  g[5] += v1 * g_zq;
  const float g_u = g_u1 + du * g_v1;
  const float g_v = -du * g_u1 + g_v1;
  const float g_du = -v * g_u1 + u * g_v1;
  // psi1 = psi + dt dpsi and du = dt dpsi: dpsi's cotangent is
  // dt (lam_psi + g_du)
  float lam_l = g_l1, lam_pl = g_pl1;
  euler_step_vjp<KIND>(s.m, l, p_l, b, b2, &lam_l, lam[1] + g_du, &lam_pl,
                       g);
  lam[0] = lam_l;
  lam[2] = lam_pl;
  lam[3] = g_u;
  lam[4] = g_v;
  lam[5] = lam[5] + g_tau;
}

// ------------------------------------------------------------ dispatching

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

// k_n volumetric steps from y with the templated step of the flags
template <int KIND>
__device__ __forceinline__ void vol_steps(const VolScalars& s, int flags,
                                          float b, float b2, float c1,
                                          float c2, float nz, float y[9],
                                          int k_n, float* ys) {
  with_vol_flags<KIND>(flags, [&](auto bb, auto rs, auto dop, auto sc) {
    for (int k = 0; k < k_n; ++k) {
      if (ys != nullptr) {
        ys[k] = y[0];
        ys[kSurfMaxSeg + k] = y[2];
        ys[2 * kSurfMaxSeg + k] = y[3];
        ys[3 * kSurfMaxSeg + k] = y[4];
        ys[4 * kSurfMaxSeg + k] = y[5];
      }
      vol_step<KIND, decltype(bb)::value, decltype(rs)::value,
               decltype(dop)::value, decltype(sc)::value>(
          s, b, b2, c1, c2, nz, &y[0], &y[1], &y[2], &y[3], &y[4], &y[5],
          &y[6]);
    }
  });
}

// ---------------------------------------------------------------- kernels

template <int KIND, bool VOL>
__global__ void __launch_bounds__(kSurfThreads)
    ckpt_surface_gen_kernel(VolScalars s, int flags,
                            const float* __restrict__ l_in,
                            const float* __restrict__ psi_in,
                            const float* __restrict__ pl_in,
                            const float* __restrict__ b_in,
                            const float* __restrict__ c1_in,
                            const float* __restrict__ c2_in,
                            const float* __restrict__ nz_in,
                            const int* __restrict__ steps_in,
                            const long long* __restrict__ off_in,
                            float* __restrict__ ckpt,
                            float* __restrict__ final_out, long long n,
                            int seg) {
  constexpr int NS = VOL ? kVolState : kDiskState;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float b = b_in[i], c1 = c1_in[i], c2 = c2_in[i];
  const float b2 = b * b;
  const int steps = steps_in[i];
  float y[NS];
  y[0] = l_in[i];
  y[1] = psi_in[i];
  y[2] = pl_in[i];
  y[3] = cosf(y[1]);
  y[4] = sinf(y[1]);
#pragma unroll
  for (int c = 5; c < NS; ++c) y[c] = 0.0f;
  float* row = ckpt + off_in[i] * NS;
  if constexpr (VOL) {
    const float nz = nz_in[i];
    for (int j = 0; j < steps; j += seg) {
#pragma unroll
      for (int c = 0; c < NS; ++c) row[c] = y[c];
      row += NS;
      vol_steps<KIND>(s, flags, b, b2, c1, c2, nz, y, min(seg, steps - j),
                      nullptr);
    }
  } else {
    // zq is carried from step to step, as in disk.cu
    float zq = c1 * y[3] + c2 * y[4];
    for (int j = 0; j < steps; j += seg) {
#pragma unroll
      for (int c = 0; c < NS; ++c) row[c] = y[c];
      row += NS;
      const int k_n = min(seg, steps - j);
      for (int k = 0; k < k_n; ++k) {
        bool new1, new2;
        disk_step<KIND>(s.m, s.r_in, s.r_out, b, b2, c1, c2, &y[0], &y[1],
                        &y[2], &y[3], &y[4], &zq, &y[5], &new1, &new2);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) final_out[c * n + i] = y[c];
}

template <int KIND, bool VOL>
__global__ void __launch_bounds__(kSurfThreads)
    ckpt_surface_bwd_kernel(VolScalars s, int flags,
                            const float* __restrict__ ckpt,
                            const float* __restrict__ b_in,
                            const float* __restrict__ c1_in,
                            const float* __restrict__ c2_in,
                            const float* __restrict__ nz_in,
                            const int* __restrict__ steps_in,
                            const long long* __restrict__ off_in,
                            const float* __restrict__ cot,
                            float* __restrict__ lam_out,
                            float* __restrict__ g_out, long long n,
                            int seg) {
  constexpr int NS = VOL ? kVolState : kDiskState;
  constexpr int NT = VOL ? kVolTheta : kDiskTheta;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float b = b_in[i], c1 = c1_in[i], c2 = c2_in[i];
  const float b2 = b * b;
  const int steps = steps_in[i];
  const int n_theta =
      VOL ? 17 + ((flags & kFlagScatter) ? kScatterBlock : 0) : kDiskTheta;
  float lam[NS];
#pragma unroll
  for (int c = 0; c < NS; ++c) lam[c] = cot[c * n + i];
  float g[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) g[k] = 0.0f;
  // per-step start states: l, p_l, u, v (and tau for vol)
  float ys[(VOL ? 5 : 4) * kSurfMaxSeg];
  const float* rows = ckpt + off_in[i] * NS;
  const int n_seg = (steps + seg - 1) / seg;
  for (int sg = n_seg - 1; sg >= 0; --sg) {
    float y[NS];
#pragma unroll
    for (int c = 0; c < NS; ++c) y[c] = rows[sg * NS + c];
    const int k_n = min(seg, steps - sg * seg);
    if constexpr (VOL) {
      const float nz = nz_in[i];
      vol_steps<KIND>(s, flags, b, b2, c1, c2, nz, y, k_n, ys);
      for (int k = k_n - 1; k >= 0; --k)
        vol_step_vjp<KIND>(s, flags, ys[k], ys[kSurfMaxSeg + k],
                           ys[2 * kSurfMaxSeg + k], ys[3 * kSurfMaxSeg + k],
                           ys[4 * kSurfMaxSeg + k], b, b2, c1, c2, nz, lam,
                           g);
    } else {
      float zq = c1 * y[3] + c2 * y[4];
      uint64_t m1 = 0, m2 = 0;
      for (int k = 0; k < k_n; ++k) {
        ys[k] = y[0];
        ys[kSurfMaxSeg + k] = y[2];
        ys[2 * kSurfMaxSeg + k] = y[3];
        ys[3 * kSurfMaxSeg + k] = y[4];
        bool new1, new2;
        disk_step<KIND>(s.m, s.r_in, s.r_out, b, b2, c1, c2, &y[0], &y[1],
                        &y[2], &y[3], &y[4], &zq, &y[5], &new1, &new2);
        m1 |= static_cast<uint64_t>(new1) << k;
        m2 |= static_cast<uint64_t>(new2) << k;
      }
      for (int k = k_n - 1; k >= 0; --k)
        disk_step_vjp<KIND>(s.m, ys[k], ys[kSurfMaxSeg + k],
                            ys[2 * kSurfMaxSeg + k], ys[3 * kSurfMaxSeg + k],
                            (m1 >> k) & 1, (m2 >> k) & 1, b, b2, c1, c2, lam,
                            g);
    }
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) lam_out[c * n + i] = lam[c];
#pragma unroll
  for (int k = 0; k < NT; ++k)
    if (k < n_theta) g_out[k * n + i] = g[k];
}

// Calls f(std::integral_constant<int, KIND>) for a runtime metric kind;
// false for an unknown kind.
template <typename F>
bool with_surface_kind(int kind, F&& f) {
  switch (kind) {
    case kEllis: f(std::integral_constant<int, kEllis>{}); return true;
    case kInterstellar:
      f(std::integral_constant<int, kInterstellar>{});
      return true;
    case kFlat: f(std::integral_constant<int, kFlat>{}); return true;
    case kSchwarzschild:
      f(std::integral_constant<int, kSchwarzschild>{});
      return true;
    case kReissnerNordstrom:
      f(std::integral_constant<int, kReissnerNordstrom>{});
      return true;
    default: return false;
  }
}

// Checks shared by both host entries: the scalar row's length for the
// family (8 floats thin; 16, or 43 with the scatter bit, vol), the segment
// and the grid; fills the scalars and the grid size.
int surface_setup(int vol, int flags, const float* scalars, int n_scalars,
                  long long n, int seg, int device, VolScalars* s,
                  unsigned* blocks) {
  const int want = vol ? kVolBaseFloats +
                             ((flags & kFlagScatter) ? kScatterBlock : 0)
                       : 8;
  if (n_scalars != want || (!vol && flags != 0) || flags < 0 || flags > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg < 1 || seg > kSurfMaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  std::memset(s, 0, sizeof(*s));
  std::memcpy(s, scalars, sizeof(float) * n_scalars);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long g = (n + kSurfThreads - 1) / kSurfThreads;
  if (g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(g);
  return 0;
}

}  // namespace curvis

// Host entries.  `scalars` is a host array: the thin family's 8 floats
// (curvis::DiskScalars: dt, R, p0, p1, p2, r_cap, r_in, r_out) or the vol
// family's curvis::VolScalars row (16 floats, 43 with the scatter block);
// `flags` the vol bitmask (1 blackbody, 2 redshift, 4 doppler, 8 scatter;
// 0 for thin).  `offsets` (int64) are each ray's first checkpoint row;
// `ckpt` holds sum_i ceil(steps[i] / seg) rows of n_state floats.  Each
// launches on `stream` without synchronising and returns the cudaError_t
// of the launch (0 on success).
extern "C" int curvis_ckpt_surface_gen(
    int kind, int vol, int flags, const float* scalars, int n_scalars,
    const float* l, const float* psi, const float* p_l, const float* b,
    const float* c1, const float* c2, const float* nz, const int* steps,
    const long long* offsets, float* ckpt, float* final_state, long long n,
    int seg, int device, void* stream) {
  using namespace curvis;
  VolScalars s;
  unsigned g = 0;
  const int err = surface_setup(vol, flags, scalars, n_scalars, n, seg,
                                device, &s, &g);
  if (err != 0 || n <= 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_surface_kind(kind, [&](auto k) {
    if (vol)
      ckpt_surface_gen_kernel<decltype(k)::value, true>
          <<<g, kSurfThreads, 0, st>>>(s, flags, l, psi, p_l, b, c1, c2, nz,
                                       steps, offsets, ckpt, final_state, n,
                                       seg);
    else
      ckpt_surface_gen_kernel<decltype(k)::value, false>
          <<<g, kSurfThreads, 0, st>>>(s, flags, l, psi, p_l, b, c1, c2, nz,
                                       steps, offsets, ckpt, final_state, n,
                                       seg);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// `cot` and `lam` are (n_state, n) float buffers, `g_theta` (n_theta, n):
// 8 for thin, 17 or 44 for vol.
extern "C" int curvis_ckpt_surface_bwd(
    int kind, int vol, int flags, const float* scalars, int n_scalars,
    const float* ckpt, const float* b, const float* c1, const float* c2,
    const float* nz, const int* steps, const long long* offsets,
    const float* cot, float* lam, float* g_theta, long long n, int seg,
    int device, void* stream) {
  using namespace curvis;
  VolScalars s;
  unsigned g = 0;
  const int err = surface_setup(vol, flags, scalars, n_scalars, n, seg,
                                device, &s, &g);
  if (err != 0 || n <= 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_surface_kind(kind, [&](auto k) {
    if (vol)
      ckpt_surface_bwd_kernel<decltype(k)::value, true>
          <<<g, kSurfThreads, 0, st>>>(s, flags, ckpt, b, c1, c2, nz, steps,
                                       offsets, cot, lam, g_theta, n, seg);
    else
      ckpt_surface_bwd_kernel<decltype(k)::value, false>
          <<<g, kSurfThreads, 0, st>>>(s, flags, ckpt, b, c1, c2, nz, steps,
                                       offsets, cot, lam, g_theta, n, seg);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
