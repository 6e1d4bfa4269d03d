// Planar null-geodesic right-hand sides, the per-ray Euler march, the
// thin-disk step and the hand-written VJP of one Euler step, shared by
// planar_march.cu, render_fused.cu, ckpt_adjoint.cu, disk.cu, disk_vol.cu
// and ckpt_surface.cu.
//
// State per ray: (l, psi, p_l) with conserved angular momentum b.  The
// metric kind is a template parameter, so each kernel instance carries only
// its own RHS.  The scalars type S is one too: MarchScalars for the analytic
// kinds, TableScalars (the same fields, then the coefficient table of
// table.cuh) for kTable, the tabulated user metrics.  The forms follow
// curvis_tpu/ops/march_pallas.py (_shape_fns / _deriv_fns); the DNEG shape
// uses atanf / log1pf as in curvis_tpu/metrics/base.py.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "table.cuh"

namespace curvis {

enum MetricKind : int {
  kEllis = 0,
  kInterstellar = 1,
  kFlat = 2,
  kSchwarzschild = 3,
  kReissnerNordstrom = 4,
  kTable = 5,   // metrics/table.py: inv, dr3 from the ChebTable
};

// Metrics with a lapse (A != 1) capture photons below r_cap; the others
// never test it.
template <int KIND>
struct HasCapture {
  static constexpr bool value =
      KIND == kSchwarzschild || KIND == kReissnerNordstrom;
};

// March scalars, in the order of the host row (ops/march_cuda.py).
struct MarchScalars {
  float dt;      // Euler step
  float R;       // escape radius
  float p0;      // metric parameters: ellis (rho); interstellar (m, a, rho);
  float p1;      //   schwarzschild (M); reissner-nordstrom (M, Q^2)
  float p2;
  float r_cap;   // capture radius (metrics with a lapse)
};

// The scalars of a kTable kernel: the march scalars (p0 holds s^2, as in
// the JAX package's row) and the table.
struct TableScalars : MarchScalars {
  ChebTable tab;
};

template <int KIND>
using ScalarsOf =
    std::conditional_t<KIND == kTable, TableScalars, MarchScalars>;

// Per-ray parameter cotangents a VJP gathers: (p0, p1, p2, b), and for a
// table s^2 at 0, b at 3 and the two coefficient series from 4.
template <int KIND>
constexpr int kThetaSlots = KIND == kTable ? 4 + 2 * kChebCap : 4;

// The scalars of kind KIND from the host's march scalars and, for kTable,
// its table.
template <int KIND>
ScalarsOf<KIND> scalars_of(const MarchScalars& m, const ChebTable* tab) {
  if constexpr (KIND == kTable)
    return TableScalars{m, *tab};
  else
    return m;
}

constexpr float kPi = 3.14159265358979323846f;

// max, min and clip that propagate NaN, as jnp.maximum / jnp.minimum /
// jnp.clip do (fmaxf / fminf drop a NaN operand).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// Helpers of the hand-written VJPs (ckpt_surface.cu, the rk45 families).
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

// x's share of the cotangent of min(max(x, lo), hi), jnp.clip's form:
// halves at either tie
__device__ __forceinline__ float clip_share(float x, float lo, float hi) {
  return max_share(x, lo) * max_share(hi, x);
}

// sign(x) / max(|x|, eps): 1 / x off the guard, bounded on it
__device__ __forceinline__ float guarded_inv(float x, float eps) {
  return sgn(x) / fmaxf(fabsf(x), eps);
}

// DNEG: r(l) and r'(l) with x = 2(|l| - a) / (pi m); r = rho, r' = 0 inside
// the throat |l| <= a.
__device__ __forceinline__ void dneg_shape(float m, float a, float rho,
                                           float l, float* r, float* dr) {
  const float al = fabsf(l);
  if (al > a) {
    const float x = 2.0f * (al - a) / (kPi * m);
    const float at = atanf(x);
    *r = rho + m * (x * at - 0.5f * log1pf(x * x));
    *dr = (l < 0.0f ? -1.0f : 1.0f) * (2.0f / kPi) * at;
  } else {
    *r = rho;
    *dr = 0.0f;
  }
}

// (dl, dpsi, dp_l) for one ray.  b2 = b * b.
template <int KIND, class S>
__device__ __forceinline__ void planar_deriv(const S& s, float l,
                                             float p_l, float b, float b2,
                                             float* dl, float* dpsi,
                                             float* dpl) {
  if constexpr (KIND == kEllis) {
    const float inv = 1.0f / (s.p0 * s.p0 + l * l);
    *dl = p_l;
    *dpsi = b * inv;
    *dpl = b2 * (l * inv * inv);                 // r'/r^3 = l / r2^2
  } else if constexpr (KIND == kFlat) {
    const float r2 = l * l;
    const float inv = 1.0f / r2;
    *dl = p_l;
    *dpsi = b * inv;
    *dpl = b2 * (inv / sqrtf(r2));
  } else if constexpr (KIND == kInterstellar) {
    float r, dr;
    dneg_shape(s.p0, s.p1, s.p2, l, &r, &dr);
    const float ir = 1.0f / r;
    const float inv = ir * ir;
    *dl = p_l;
    *dpsi = b * inv;
    *dpl = b2 * (dr * inv * ir);
  } else if constexpr (KIND == kSchwarzschild) {
    // A = 1 - 2M/l;  dp_l = -A'/2 (1/A^2 + p_l^2) + b^2 / l^3
    const float M = s.p0;
    const float invl = 1.0f / l;
    const float invl2 = invl * invl;
    const float A = 1.0f - 2.0f * M * invl;
    const float invA = 1.0f / A;
    *dl = A * p_l;
    *dpsi = b * invl2;
    *dpl = (-M * invl2) * (invA * invA + p_l * p_l) + b2 * invl2 * invl;
  } else if constexpr (KIND == kTable) {
    float inv, dr3;
    table_shape(s.tab, l, &inv, &dr3);
    *dl = p_l;
    *dpsi = b * inv;
    *dpl = b2 * dr3;
  } else {  // kReissnerNordstrom: A = 1 - 2M/l + Q^2/l^2
    const float M = s.p0, q2 = s.p1;
    const float invl = 1.0f / l;
    const float invl2 = invl * invl;
    const float A = 1.0f - (2.0f * M - q2 * invl) * invl;
    const float invA = 1.0f / A;
    *dl = A * p_l;
    *dpsi = b * invl2;
    *dpl = (-(M - q2 * invl) * invl2) * (invA * invA + p_l * p_l) +
           b2 * invl2 * invl;
  }
}

// 1 / r(l)^2 of the unit-lapse kinds, in the form planar_deriv computes
// it (curvis_tpu/ops/march_pallas.py:_shape_fns); the lapse kinds have
// r = l and never call it.
template <int KIND, class S>
__device__ __forceinline__ float planar_inv_r2(const S& s, float l) {
  if constexpr (KIND == kEllis) return 1.0f / (s.p0 * s.p0 + l * l);
  if constexpr (KIND == kTable) {
    float inv, dr3;
    table_shape(s.tab, l, &inv, &dr3);
    return inv;
  }
  if constexpr (KIND == kInterstellar) {
    float r, dr;
    dneg_shape(s.p0, s.p1, s.p2, l, &r, &dr);
    const float ir = 1.0f / r;
    return ir * ir;
  }
  return 1.0f / (l * l);
}

// Areal radius r(l), for the readout (a table: 1 / sqrt(inv) with inv
// floored at 1e-30, curvis_tpu/ops/render_fused.py:_r_of_l).
template <int KIND, class S>
__device__ __forceinline__ float planar_r(const S& s, float l) {
  if constexpr (KIND == kEllis) return sqrtf(s.p0 * s.p0 + l * l);
  if constexpr (KIND == kTable)
    return 1.0f / sqrtf(max_nan(planar_inv_r2<KIND>(s, l), 1e-30f));
  if constexpr (KIND == kInterstellar) {
    float r, dr;
    dneg_shape(s.p0, s.p1, s.p2, l, &r, &dr);
    return r;
  }
  return fabsf(l);
}

// Local radial direction component u_l = p_l sqrt(A), with A clamped at
// 1e-6 (curvis_tpu/ops/render_fused.py:_readout_u_l).
template <int KIND, class S>
__device__ __forceinline__ float readout_u_l(const S& s, float l,
                                             float p_l) {
  if constexpr (KIND == kSchwarzschild)
    return p_l * sqrtf(fmaxf(1.0f - 2.0f * s.p0 / l, 1e-6f));
  if constexpr (KIND == kReissnerNordstrom) {
    const float A = 1.0f - (2.0f * s.p0 - s.p1 / l) / l;
    return p_l * sqrtf(fmaxf(A, 1e-6f));
  }
  return p_l;
}

// One forward-Euler step y <- y + dt f(y), y = (l, psi, p_l): the step of
// march_ray, which the checkpoint kernels re-run, so the recomputed map is
// the marched map bit for bit.
template <int KIND, class S>
__device__ __forceinline__ void euler_step(const S& s, float b,
                                           float b2, float* l, float* psi,
                                           float* p_l) {
  float dl, dpsi, dpl;
  planar_deriv<KIND>(s, *l, *p_l, b, b2, &dl, &dpsi, &dpl);
  *l = *l + s.dt * dl;
  *psi = *psi + s.dt * dpsi;
  *p_l = *p_l + s.dt * dpl;
}

// Reverse mode of the lapse metrics' RHS (Schwarzschild is q2 = 0, which
// leaves the forms of planar_deriv bit for bit):
//   A = 1 - (2M - q2/l)/l,  C = -(M - q2/l)/l^2,
//   dl = A p_l,  dpsi = b/l^2,  dpl = C (1/A^2 + p_l^2) + b^2/l^3.
// (u, v, w) are the cotangents of (dl, dpsi, dpl); adds d/dl to *g_l,
// d/dp_l to *g_pl, d/db to *g_b and d/dM, d/dq2 to *g_m, *g_q2.
__device__ __forceinline__ void lapse_rhs_vjp(float M, float q2, float l,
                                              float p_l, float b, float b2,
                                              float u, float v, float w,
                                              float* g_l, float* g_pl,
                                              float* g_b, float* g_m,
                                              float* g_q2) {
  const float invl = 1.0f / l;
  const float invl2 = invl * invl;
  const float A = 1.0f - (2.0f * M - q2 * invl) * invl;
  const float invA = 1.0f / A;
  const float C = -(M - q2 * invl) * invl2;
  const float Q = invA * invA + p_l * p_l;
  // dpl = C Q + b2 invl2 invl
  const float gC = w * Q;
  const float gQ = w * C;
  const float gA = u * p_l - gQ * 2.0f * invA * invA * invA;
  *g_pl += u * A + gQ * 2.0f * p_l;
  *g_b += v * invl2 + w * 2.0f * b * invl2 * invl;
  *g_m += gA * (-2.0f * invl) - gC * invl2;
  *g_q2 += gA * invl2 + gC * invl * invl2;
  // invl2 = invl * invl enters dpsi, dpl's b^2 term and C
  const float g_invl2 = v * b + w * b2 * invl - gC * (M - q2 * invl);
  const float g_invl = w * b2 * invl2 + g_invl2 * 2.0f * invl +
                       gA * (-2.0f * M + 2.0f * q2 * invl) +
                       gC * q2 * invl2;
  *g_l += g_invl * (-invl * invl);
}

// VJP of one Euler step at (l, p_l) (psi does not enter the RHS):
// lam = (lam_l, lam_psi, lam_pl) is the cotangent of the step's output and
// becomes that of its input; g[0..2] gather the cotangents of the metric
// slots p0, p1, p2 and g[3] that of b; a kTable kernel's g has
// kThetaSlots<kTable> entries: g[0] s^2, g[3] b, then the coefficient
// sums, c1's at g + 4 and c2's at g + 4 + kChebCap.  The derivatives are
// those of the forms in planar_deriv, written out in reverse mode.
template <int KIND, class S>
__device__ __forceinline__ void euler_step_vjp(const S& s,
                                               float l, float p_l, float b,
                                               float b2, float* lam_l,
                                               float lam_psi, float* lam_pl,
                                               float g[4]) {
  // cotangents of the RHS (dl, dpsi, dpl): y1 = y + dt f(y)
  const float u = s.dt * *lam_l, v = s.dt * lam_psi, w = s.dt * *lam_pl;
  float g_l = *lam_l, g_pl = *lam_pl;
  if constexpr (KIND == kEllis) {
    // inv = 1/r2, r2 = p0^2 + l^2; dpsi = b inv; dpl = b2 l inv^2
    const float inv = 1.0f / (s.p0 * s.p0 + l * l);
    const float inv2 = inv * inv;
    const float g_inv = v * b + w * b2 * l * 2.0f * inv;
    const float g_r2 = -g_inv * inv2;
    g_l += w * b2 * inv2 + g_r2 * 2.0f * l;
    g_pl += u;
    g[0] += g_r2 * 2.0f * s.p0;
    g[3] += v * inv + w * 2.0f * b * l * inv2;
  } else if constexpr (KIND == kFlat) {
    // inv = 1/l^2, r = sqrt(l^2); dpsi = b inv; dpl = b2 inv / r
    const float r2 = l * l;
    const float inv = 1.0f / r2;
    const float r = sqrtf(r2);
    const float g_inv = v * b + w * b2 / r;
    const float g_r = -w * b2 * inv / (r * r);
    const float g_r2 = -g_inv * inv * inv + g_r * 0.5f / r;
    g_l += g_r2 * 2.0f * l;
    g_pl += u;
    g[3] += v * inv + w * 2.0f * b * inv / r;
  } else if constexpr (KIND == kInterstellar) {
    // r, r' of dneg_shape; ir = 1/r; dpsi = b ir^2; dpl = b2 r' ir^3
    const float m = s.p0, a = s.p1;
    float r, dr;
    dneg_shape(m, a, s.p2, l, &r, &dr);
    const float ir = 1.0f / r;
    const float inv = ir * ir;
    const float g_inv = v * b + w * b2 * dr * ir;
    const float g_ir = g_inv * 2.0f * ir + w * b2 * dr * inv;
    const float g_r = -g_ir * ir * ir;
    const float g_dr = w * b2 * inv * ir;
    g[2] += g_r;                                   // dr/drho = 1
    if (fabsf(l) > a) {
      // x = 2(|l| - a)/(pi m); r = rho + m (x atan x - log1p(x^2)/2);
      // r' = sgn(l) (2/pi) atan x; dr/dx = m atan x
      const float sg = l < 0.0f ? -1.0f : 1.0f;
      const float c = 2.0f / (kPi * m);
      const float x = c * (fabsf(l) - a);
      const float at = atanf(x);
      const float g_x =
          g_r * m * at + g_dr * sg * (2.0f / kPi) / (1.0f + x * x);
      g[0] += g_r * (x * at - 0.5f * log1pf(x * x)) - g_x * x / m;
      g[1] += -g_x * c;
      g_l += g_x * sg * c;
    }
    g_pl += u;
    g[3] += v * inv + w * 2.0f * b * dr * inv * ir;
  } else if constexpr (KIND == kTable) {
    // dpsi = b inv; dpl = b2 dr3; (inv, dr3) from the table
    float inv, dr3;
    table_shape_vjp<false>(s.tab, l, v * b, w * b2, &inv, &dr3, &g_l, &g[0],
                           g + 4, g + 4 + kChebCap);
    g_pl += u;
    g[3] += v * inv + w * 2.0f * b * dr3;
  } else if constexpr (KIND == kSchwarzschild) {
    float unused = 0.0f;
    lapse_rhs_vjp(s.p0, 0.0f, l, p_l, b, b2, u, v, w, &g_l, &g_pl, &g[3],
                  &g[0], &unused);
  } else {  // kReissnerNordstrom: p1 = Q^2
    lapse_rhs_vjp(s.p0, s.p1, l, p_l, b, b2, u, v, w, &g_l, &g_pl, &g[3],
                  &g[0], &g[1]);
  }
  *lam_l = g_l;
  *lam_pl = g_pl;
}

// One step of the thin-disk march (kernel #5, disk.cu), shared with the
// replay of its checkpoint kernels (ckpt_surface.cu), so that both take
// the same crossing decisions bit for bit.  The state is (l, psi, p_l),
// the incrementally rotated (u, v) = (cos psi, sin psi), zq = c1 u + c2 v
// (z / r(l)) carried from the last step, and the hit slots h = (h1, h1p,
// h1s, h2, h2p, h2s): a crossing of zq within the step at signed radius
// lh = l + frac (l1 - l) inside [r_in, r_out] fills the first empty slot
// with (lh, p_l, psi) interpolated at frac = |zq| / (|zq| + |zq1|).
// *new1 / *new2 say which slot this step filled.
template <int KIND, class S>
__device__ __forceinline__ void disk_step(const S& s, float r_in,
                                          float r_out, float b, float b2,
                                          float c1, float c2, float* l,
                                          float* psi, float* p_l, float* u,
                                          float* v, float* zq, float h[6],
                                          bool* new1, bool* new2) {
  const float dt = s.dt;
  float dl, dpsi, dpl;
  planar_deriv<KIND>(s, *l, *p_l, b, b2, &dl, &dpsi, &dpl);
  const float l1 = *l + dt * dl;
  const float pl1 = *p_l + dt * dpl;
  const float du = dt * dpsi;
  const float u1 = *u - *v * du;
  const float v1 = *v + *u * du;
  const float zq1 = c1 * u1 + c2 * v1;
  // crossing: z changes sign within the step (r > 0, so zq's sign is z's)
  const bool crossed = *zq * zq1 < 0.0f;
  const float frac = fabsf(*zq) / max_nan(fabsf(*zq) + fabsf(zq1), 1e-30f);
  const float lh = *l + frac * (l1 - *l);
  const float r_hit = fabsf(lh);
  const bool in_disk = crossed && r_hit >= r_in && r_hit <= r_out;
  const float pl_hit = *p_l + frac * (pl1 - *p_l);
  const float psi_hit = *psi + frac * du;
  *new1 = in_disk && h[0] == 0.0f;
  *new2 = in_disk && h[0] != 0.0f && h[3] == 0.0f;
  const float n1 = *new1 ? 1.0f : 0.0f;
  const float n2 = *new2 ? 1.0f : 0.0f;
  h[0] = h[0] + n1 * lh;
  h[1] = h[1] + n1 * pl_hit;
  h[2] = h[2] + n1 * psi_hit;
  h[3] = h[3] + n2 * lh;
  h[4] = h[4] + n2 * pl_hit;
  h[5] = h[5] + n2 * psi_hit;
  *l = l1;
  *psi = *psi + du;
  *p_l = pl1;
  *u = u1;
  *v = v1;
  *zq = zq1;
}

// Calls f(std::integral_constant<int, KIND>{}) for a runtime metric kind of
// the planar families that take tables (the five analytic kinds and
// kTable); false for another kind.
template <typename F>
bool with_planar_kind(int kind, F&& f) {
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
    case kTable: f(std::integral_constant<int, kTable>{}); return true;
    default: return false;
  }
}

// A launch of kind `kind` has what it needs: a kTable launch a table of
// 1 .. kChebCap coefficients per series.
inline bool table_ok(int kind, const ChebTable* tab) {
  return kind != kTable ||
         (tab != nullptr && tab->n >= 1 && tab->n <= kChebCap);
}

// Euler march of one ray until it escapes (sign +1 / -1), is captured
// (sign 2) or has taken max_steps steps (sign 0).  The escape test follows
// each step, strict on both sides.  Returns the sign; *steps gets the
// number of steps taken.
template <int KIND, class S>
__device__ __forceinline__ int march_ray(const S& s, float* l_io,
                                         float* psi_io, float* pl_io, float b,
                                         int max_steps, int* steps) {
  float l = *l_io, psi = *psi_io, p_l = *pl_io;
  const float b2 = b * b;
  int sign = 0;
  int n = 0;
  while (n < max_steps && sign == 0) {
    euler_step<KIND>(s, b, b2, &l, &psi, &p_l);
    ++n;
    if (l > s.R) {
      sign = 1;
    } else if (l < -s.R) {
      sign = -1;
    } else if (HasCapture<KIND>::value && l < s.r_cap) {
      sign = 2;
    }
  }
  *l_io = l;
  *psi_io = psi;
  *pl_io = p_l;
  *steps = n;
  return sign;
}

}  // namespace curvis
