// One step of each Boyer-Lindquist march, shared by the march kernels and
// the checkpoint kernels that replay them: the fixed-step RK4 step of
// kerr.cu (#7, replayed by ckpt_kerr.cu and ckpt_kerr_surface.cu) and the
// DP5(4) iteration of kerr_rk45.cu (#8, replayed by ckpt_kerr_rk45.cu and
// ckpt_kerr_surface_rk45.cu), each with the surface work of the TRACK_DISK
// and VOL variants: the crossing tracker, the gated volumetric quadrature
// and #8's two step clamps near the disk.
//
// A replay must march the trajectory the forward marched, bit for bit:
// the checkpoints are its states, and an adaptive replay that accepts
// where the forward rejected marches another ray.  So the march kernels
// and the replays call these functions, and every file that does is built
// with the same flags (--fmad=false, ops/_build.py:SOURCE_FLAGS).  The
// arithmetic is that of the TPU kernels _kerr_kernel and _kerr_rk45_kernel
// (curvis_tpu/ops/march_pallas.py), which the JAX package's adjoints
// (curvis_tpu/integrate/kerr_adjoint.py:_step5_theta, rk45_adjoint.py:
// _rk45_iter, kerr_surface_adjoint.py) differentiate.
#pragma once

#include <cstring>

#include "dp54.cuh"
#include "kerr_common.cuh"

namespace curvis {

// Host row of kernel #7, the Kerr rows of curvis_tpu/ops/march_pallas.py:
// 10 floats (bare, disk), 20 with the emission slots at VOL_BLOCK_KERR = 10
// and two spares (VOL), 47 with the scatter block at KERR_SCATTER_OFF = 20.
struct KerrScalars {
  float dt;
  float R;       // escape radius
  float M;
  float a;
  float q2;      // Kerr-Newman charge^2 (0 for Kerr)
  float r_cap;   // capture radius
  float r_in;
  float r_out;
  float ax_u0;   // polar-axis band, sin^2 theta
  float far_r0;  // far-field radius (1e30 = off)
  VolSlots v;
  float spare[2];
  float scatter[kScatterBlock];
};

constexpr int kKerrBaseFloats = 10;
constexpr int kKerrVolFloats = 20;
static_assert(sizeof(KerrScalars) ==
                  (kKerrVolFloats + kScatterBlock) * sizeof(float),
              "KerrScalars is a packed row of floats");

// Kernel #8's row.  The host rows are those of curvis_tpu/ops/
// march_pallas.py: bare and disk [dt0, R, M, a, q2, r_cap, r_in, r_out,
// rtol, atol, dt_max, dt_min] (12 floats, the bounds at
// KERR_RK45_BOUNDS[False] = 10); VOL puts the eight emission slots at
// VOL_BLOCK_KERR = 10 and the bounds at 18 (20 floats); SCATTER adds the
// 27-float block at KERR_SCATTER_OFF = 20 (47).  kerr_rk45_row moves a
// 12-float row's bounds to dt_max / dt_min.
struct KerrRk45Scalars {
  float dt0;     // initial step, and the step bound near the disk
  float R;       // escape radius
  float M;
  float a;
  float q2;      // Kerr-Newman charge^2 (0 for Kerr)
  float r_cap;   // capture radius
  float r_in;
  float r_out;
  float rtol;
  float atol;
  VolSlots v;
  float dt_max;
  float dt_min;
  float scatter[kScatterBlock];
};

constexpr int kKerrRk45HeadFloats = 10;   // up to rtol, atol
constexpr int kKerrRk45BareFloats = 12;
constexpr int kKerrRk45VolFloats = 20;
static_assert(sizeof(KerrRk45Scalars) ==
                  (kKerrRk45VolFloats + kScatterBlock) * sizeof(float),
              "KerrRk45Scalars is a packed row of floats");

// The kernel row of a host row of n_scalars floats (12 bare or disk, 20
// volumetric, 47 with the scatter block).
inline KerrRk45Scalars kerr_rk45_row(const float* scalars, int n_scalars,
                                     bool vol) {
  KerrRk45Scalars s;
  std::memset(&s, 0, sizeof(s));
  if (vol) {
    std::memcpy(&s, scalars, sizeof(float) * n_scalars);
  } else {
    std::memcpy(&s, scalars, sizeof(float) * kKerrRk45HeadFloats);
    s.dt_max = scalars[kKerrRk45HeadFloats];
    s.dt_min = scalars[kKerrRk45HeadFloats + 1];
  }
  return s;
}

// State per ray: y = (r, theta, phi, p_r, p_theta); the RHS reads four of
// them, the q-th at y[rhs_in(q)] (phi does not enter it).
__host__ __device__ constexpr int rhs_in(int q) { return q < 2 ? q : q + 1; }

// Whether a BL state passed the blowup guard |r| + |theta| + |phi| + |p_r|
// + |p_theta| <= 1e8 (false for NaN).
__device__ __forceinline__ bool kerr_finite(const float y[5]) {
  const float m_chk = fabsf(y[0]) + fabsf(y[1]) + fabsf(y[2]) +
                      fabsf(y[3]) + fabsf(y[4]);
  return m_chk <= 1e8f;
}

// ------------------------------------------------------------ RK4 (#7)

// The step of a ray at (r, theta): dt times the polar-axis factor (sin^2
// theta below ax_u0, at most 16x smaller) and the far-field factor (r
// beyond far_r0, at most 8x larger; 1e30 = off).
__device__ __forceinline__ float kerr_dte(const KerrScalars& s, float r,
                                          float th) {
  const float s_ax = sinf(th);
  const float scale = clip_nan(
      (s_ax * s_ax + 1e-12f) / max_nan(s.ax_u0, 1e-12f), 1.0f / 16.0f, 1.0f);
  const float fscale = clip_nan(r / max_nan(s.far_r0, 1e-12f), 1.0f, 8.0f);
  return s.dt * scale * fscale;
}

// The four stages of one RK4 step from y: the step dte, its half hd,
// stage i's input yi[i] (r, theta, p_r, p_theta) and slopes k[i].  The
// step and the replay's VJP (kerr_vjp.cuh) both take their stages from
// here.
struct KerrRk4Stages {
  float dte, hd;
  float yi[4][4];
  float k[4][5];
};

__device__ __forceinline__ void kerr_rk4_stages(const KerrScalars& s,
                                                float E, float L,
                                                const float y[5],
                                                KerrRk4Stages* st) {
  st->dte = kerr_dte(s, y[0], y[1]);
  st->hd = 0.5f * st->dte;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // stage 0 at y, 1 and 2 half a step along the previous slope, 3 a
    // whole step along stage 2's
    const float h = i == 3 ? st->dte : st->hd;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ci = rhs_in(c);
      st->yi[i][c] = i == 0 ? y[ci] : y[ci] + h * st->k[i - 1][ci];
    }
    kerr_rhs(s.M, s.a, s.q2, E, L, st->yi[i][0], st->yi[i][1],
             st->yi[i][2], st->yi[i][3], st->k[i]);
  }
}

// One RK4 step of kernel #7 from y into y1; returns its step dte.
__device__ __forceinline__ float kerr_rk4_step(const KerrScalars& s,
                                               float E, float L,
                                               const float y[5],
                                               float y1[5]) {
  KerrRk4Stages st;
  kerr_rk4_stages(s, E, L, y, &st);
  const float w = st.dte * (1.0f / 6.0f);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    y1[c] = y[c] + w * (st.k[0][c] + 2.0f * (st.k[1][c] + st.k[2][c]) +
                        st.k[3][c]);
  return st.dte;
}

// ------------------------------------------------ the surfaces (#7, #8)

// The crossing tracker of the TRACK_DISK variants: a step from (r, phi) at
// cos theta = ct_prev to y1 at cos theta = ct crossed the equator where
// ct_prev ct < 0; the crossing's radius and azimuth are linear in the
// step's fraction frac = |ct_prev| / max(|ct_prev| + |ct|, 1e-30), its
// side is sign(ct_prev).  A crossing in [r_in, r_out] fills the first
// empty slot of hit = (r, phi, side) x 2.  Returns the slot written (0 or
// 3), or -1.
__device__ __forceinline__ int kerr_track_hit(float r_in, float r_out,
                                              float r, float ph,
                                              const float y1[5],
                                              float ct_prev, float ct,
                                              float hit[6]) {
  if (ct_prev * ct < 0.0f) {
    const float den = fabsf(ct_prev) + fabsf(ct);
    const float frac = fabsf(ct_prev) / max_nan(den, 1e-30f);
    const float r_hit = r + frac * (y1[0] - r);
    const float ph_hit = ph + frac * (y1[2] - ph);
    const float side = ct_prev > 0.0f ? 1.0f : -1.0f;
    if (r_hit >= r_in && r_hit <= r_out) {
      const int k = hit[0] == 0.0f ? 0 : (hit[3] == 0.0f ? 3 : -1);
      if (k >= 0) {
        hit[k] = r_hit;
        hit[k + 1] = ph_hit;
        hit[k + 2] = side;
      }
      return k;
    }
  }
  return -1;
}

// The volumetric quadrature of the VOL variants: where `gate` (the state
// after the step passed the blowup guard; for DP5(4) also accepted), adds
// w (dtau, dem) of kerr_vol_emission at (r, theta) with the pre-step tau
// to (tau, em); w is the step's dte (#7) or dt (#8).  S is either
// kernel's row (both hold M, a, q2, r_in, r_out, v and scatter).
template <bool BLACKBODY, bool BEAMING, bool SCATTER, class S>
__device__ __forceinline__ void kerr_vol_quad(const S& s, float r, float th,
                                              float b_ph, float w, bool gate,
                                              float* tau, float em[3]) {
  if (gate) {
    float dtau, dem[3];
    kerr_vol_emission<BLACKBODY, BEAMING, SCATTER>(
        s.M, s.a, s.q2, s.r_in, s.r_out, s.v, s.scatter, r, th, b_ph, *tau,
        &dtau, dem);
#pragma unroll
    for (int c = 0; c < 3; ++c) em[c] = em[c] + w * dem[c];
    *tau = *tau + w * dtau;
  }
}

// One step of kernel #7 with its surface work, from y (written over with
// the state after it): the RK4 step, then the crossing tracker (its
// ct_prev becomes cos theta after the step; *slot the hit slot written)
// or the quadrature weighted by the step's dte.  Returns whether the state
// after it passed the blowup guard.
template <bool TRACK_DISK, bool VOL, bool BLACKBODY, bool BEAMING,
          bool SCATTER>
__device__ __forceinline__ bool kerr_rk4_surface_step(
    const KerrScalars& s, float E, float L, float b_ph, float y[5],
    float* ct_prev, float hit[6], float* tau, float em[3], int* slot) {
  float y1[5];
  const float dte = kerr_rk4_step(s, E, L, y, y1);
  *slot = -1;
  if constexpr (TRACK_DISK) {
    const float ct = cosf(y1[1]);
    *slot = kerr_track_hit(s.r_in, s.r_out, y[0], y[2], y1, *ct_prev, ct,
                           hit);
    *ct_prev = ct;
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) y[c] = y1[c];
  const bool ok = kerr_finite(y);
  if constexpr (VOL)
    kerr_vol_quad<BLACKBODY, BEAMING, SCATTER>(s, y[0], y[1], b_ph, dte, ok,
                                               tau, em);
  return ok;
}

// -------------------------------------------------------- DP5(4) (#8)

// One DP5(4) trial from y with step dt, with what the replay's VJP
// (kerr_vjp.cuh) reads:
//   - seven stages advance (r, theta, p_r, p_theta): stage i's input yi[i]
//     = y + sum_j (dt a_ij) k_j in the tableau's order (the zero a72
//     multiplied in), its slopes k[i];
//   - the 5th-order slope d5 and the error slope e = d5 - d4 (each summed
//     from 0 in stage order), the trial y1 = y + dt d5;
//   - the scaled error |dt e| / (atol + rtol max(|y|, |y1|)) of r, theta,
//     p_r and p_theta (phi is excluded), err their max (NaN propagates), a
//     trial with err <= 1 accepted (a NaN err rejects);
//   - boundary stepping: an accepted trial that lands beyond R at a
//     fraction frac = (R - r) / (r1 - r) < 0.9 of the step, and more than
//     R * 1e-3 past R, is rejected (over) and retried with dt frac 1.05.
struct KerrRk45Rec {
  float yi[7][4];
  float k[7][5];
  float y[5];      // the start
  float y1[5];     // the 5th-order trial
  float d5[5];
  float e[4];      // error slopes of r, theta, p_r, p_theta
  float ec[4];     // their scaled errors
  float den[4];    // and the denominators atol + rtol max(|y|, |y1|)
  float dt, err, frac, den_r;   // den_r = r1 - r, or 1 where |r1 - r| < 1e-30
  bool accept, esc, over, small;
};

__device__ __forceinline__ void kerr_rk45_trial(const KerrRk45Scalars& s,
                                                float E, float L,
                                                const float y[5], float dt,
                                                KerrRk45Rec* t) {
#pragma unroll
  for (int st = 0; st < 7; ++st) {
#pragma unroll
    for (int c = 0; c < 4; ++c) t->yi[st][c] = y[rhs_in(c)];
#pragma unroll
    for (int j = 0; j < st; ++j) {
      const float c = dt * dp_a(st, j);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        t->yi[st][q] = t->yi[st][q] + c * t->k[j][rhs_in(q)];
    }
    kerr_rhs(s.M, s.a, s.q2, E, L, t->yi[st][0], t->yi[st][1],
             t->yi[st][2], t->yi[st][3], t->k[st]);
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float(&k)[7][5] = t->k;
    t->d5[c] = 0.0f + kB1 * k[0][c] + kB3 * k[2][c] + kB4 * k[3][c] +
               kB5 * k[4][c] + kB6 * k[5][c];
    t->y[c] = y[c];
    t->y1[c] = y[c] + dt * t->d5[c];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = rhs_in(q);
    const float(&k)[7][5] = t->k;
    t->e[q] = t->d5[c] - (0.0f + kE1 * k[0][c] + kE3 * k[2][c] +
                          kE4 * k[3][c] + kE5 * k[4][c] + kE6 * k[5][c] +
                          kE7 * k[6][c]);
    t->den[q] = s.atol + s.rtol * max_nan(fabsf(y[c]), fabsf(t->y1[c]));
    t->ec[q] = fabsf(dt * t->e[q]) / t->den[q];
  }
  t->dt = dt;
  t->err = max_nan(max_nan(t->ec[0], t->ec[1]), max_nan(t->ec[2], t->ec[3]));
  bool accept = t->err <= 1.0f;   // false for NaN
  const float r = y[0], r1 = t->y1[0];
  bool esc = accept && r1 > s.R;
  t->small = fabsf(r1 - r) < 1e-30f;
  t->den_r = t->small ? 1.0f : r1 - r;
  t->frac = (s.R - r) / t->den_r;
  t->over = esc && t->frac < 0.9f &&
            r1 > s.R * static_cast<float>(1.0 + 1e-3);
  t->accept = accept && !t->over;
  t->esc = esc && !t->over;
}

// The controller's next step after trial t of a ray still marching:
// clip(dt frac 1.05) after an over-reject, else clip(dt dp54_factor(err)),
// both within [dt_min, dt_max].
__device__ __forceinline__ float kerr_rk45_next_dt(const KerrRk45Scalars& s,
                                                   const KerrRk45Rec& t) {
  return t.over ? clip_nan(t.dt * t.frac * 1.05f, s.dt_min, s.dt_max)
                : clip_nan(t.dt * dp54_factor(t.err), s.dt_min, s.dt_max);
}

// The sign of an accepted step at its written-back state y: escape (1)
// beyond R, capture (2) below r_cap, blowup (3) where the guard fails.
__device__ __forceinline__ int kerr_rk45_fate(const KerrRk45Scalars& s,
                                              const KerrRk45Rec& t,
                                              const float y[5], bool ok) {
  return ok ? static_cast<int>(t.esc) + 2 * static_cast<int>(y[0] < s.r_cap)
            : 3;
}

// #8's step bound of TRACK_DISK inside the disk region r < r_out + 2M:
// min(dt, dt0).
__device__ __forceinline__ float kerr_near_clamp(const KerrRk45Scalars& s,
                                                 float r, float dt) {
  return r < s.r_out + 2.0f * s.M ? min_nan(dt, s.dt0) : dt;
}

// #8's anticipatory step bound of VOL at (r, theta): max(dt0, max(gap_r,
// gap_z) / 2), gap_r the radial gap to the r_out + 2M cylinder and gap_z
// the vertical gap to the 5-sigma density shell.
__device__ __forceinline__ float kerr_gas_dt(const KerrRk45Scalars& s,
                                             float r, float th) {
  const float s_th = fabsf(sinf(th));
  const float r_cyl = r * s_th;
  const float gap_r = r_cyl - (s.r_out + 2.0f * s.M);
  const float h_rel5 = 5.0f * sqrtf(s.v.h2);
  const float gap_z = r * fabsf(cosf(th)) - h_rel5 * r_cyl;
  return max_nan(s.dt0, 0.5f * max_nan(gap_r, gap_z));
}

// One DP5(4) iteration of a live ray with the surface work of kernel #8's
// variants, as #8 runs it: the trial; on accept the crossing tracker (on
// the trial, ct_prev carried to cos theta of the trial), the write-back,
// the quadrature weighted by the trial dt where the state passed the
// guard, and its fate; the tau_max freeze (VOL); a stall (sign 3) for a
// reject at dt <= dt_min * 1.01; and for a ray still marching the
// controller's next dt, clamped near the disk.  Sets *sign to this
// iteration's fate (0: still marching; a replay runs a ray's iterations
// again, so no sign may carry over from an iteration it replayed before),
// adds an accepted step to *steps and returns the hit slot written (or
// -1).
template <bool TRACK_DISK, bool VOL, bool BLACKBODY, bool BEAMING,
          bool SCATTER>
__device__ __forceinline__ int kerr_rk45_surface_iter(
    const KerrRk45Scalars& s, float E, float L, float b_ph, float y[5],
    float* dt, float* ct_prev, float hit[6], float* tau, float em[3],
    int* sign, int* steps) {
  KerrRk45Rec t;
  kerr_rk45_trial(s, E, L, y, *dt, &t);
  int slot = -1;
  int sg = 0;
  if (t.accept) {
    if constexpr (TRACK_DISK) {
      const float ct = cosf(t.y1[1]);
      slot = kerr_track_hit(s.r_in, s.r_out, y[0], y[2], t.y1, *ct_prev, ct,
                            hit);
      *ct_prev = ct;
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) y[c] = t.y1[c];
    const bool ok = kerr_finite(y);
    if constexpr (VOL)
      kerr_vol_quad<BLACKBODY, BEAMING, SCATTER>(s, y[0], y[1], b_ph, *dt,
                                                 ok, tau, em);
    sg = kerr_rk45_fate(s, t, y, ok);
    ++*steps;
  }
  // the tau_max freeze (OPAQUE_SIGN == CAPTURED == 2)
  if constexpr (VOL) {
    if (sg == 0 && *tau > s.v.tau_max) sg = 2;
  }
  // a reject at dt_min can never pass (over-rejects included)
  if (!t.accept && *dt <= s.dt_min * 1.01f) sg = 3;
  *sign = sg;
  if (sg == 0) {
    float dn = kerr_rk45_next_dt(s, t);
    if constexpr (VOL)
      dn = min_nan(dn, kerr_gas_dt(s, y[0], y[1]));
    else if constexpr (TRACK_DISK)
      dn = kerr_near_clamp(s, y[0], dn);
    *dt = dn;
  }
  return slot;
}

// The bare iteration (no surface): what kernel #8's bare variant runs and
// the Kerr DP5(4) family's replay (ckpt_kerr_rk45.cu) repeats.
__device__ __forceinline__ void kerr_rk45_iter(const KerrRk45Scalars& s,
                                               float E, float L, float y[5],
                                               float* dt, int* sign,
                                               int* steps) {
  kerr_rk45_surface_iter<false, false, false, false, false>(
      s, E, L, 0.0f, y, dt, nullptr, nullptr, nullptr, nullptr, sign, steps);
}

}  // namespace curvis
