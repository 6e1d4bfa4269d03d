// One step of each Boyer-Lindquist march, shared by the march kernels and
// the checkpoint kernels that replay them: the fixed-step RK4 step of
// kerr.cu (#7, replayed by ckpt_kerr.cu) and the bare DP5(4) iteration of
// kerr_rk45.cu (#8, replayed by ckpt_kerr_rk45.cu).
//
// A replay must march the trajectory the forward marched, bit for bit:
// the checkpoints are its states, and an adaptive replay that accepts
// where the forward rejected marches another ray.  So the march kernels
// and the replays call these functions, and every file that does is built
// with the same flags (--fmad=false, ops/_build.py:SOURCE_FLAGS).  The
// arithmetic is that of the TPU kernels _kerr_kernel and _kerr_rk45_kernel
// (curvis_tpu/ops/march_pallas.py), which the JAX package's adjoints
// (curvis_tpu/integrate/kerr_adjoint.py:_step5_theta, rk45_adjoint.py:
// _rk45_iter) differentiate.
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

// One bare DP5(4) iteration of a live ray, as kernel #8 runs it: the trial,
// the write-back of an accepted step and its fate, a stall (sign 3) for a
// reject at dt <= dt_min * 1.01, and the controller's next dt for a ray
// still marching.  Sets *sign to this iteration's fate (0: still
// marching; a replay runs a ray's iterations again, so no sign may carry
// over from an iteration it replayed before) and adds the accepted step
// to *steps.
__device__ __forceinline__ void kerr_rk45_iter(const KerrRk45Scalars& s,
                                               float E, float L, float y[5],
                                               float* dt, int* sign,
                                               int* steps) {
  KerrRk45Rec t;
  kerr_rk45_trial(s, E, L, y, *dt, &t);
  int sg = 0;
  if (t.accept) {
#pragma unroll
    for (int c = 0; c < 5; ++c) y[c] = t.y1[c];
    sg = kerr_rk45_fate(s, t, y, kerr_finite(y));
    ++*steps;
  }
  if (!t.accept && *dt <= s.dt_min * 1.01f) sg = 3;
  *sign = sg;
  if (sg == 0) *dt = kerr_rk45_next_dt(s, t);
}

}  // namespace curvis
