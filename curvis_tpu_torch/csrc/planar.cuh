// Planar null-geodesic right-hand sides and the per-ray Euler march, shared
// by planar_march.cu and render_fused.cu.
//
// State per ray: (l, psi, p_l) with conserved angular momentum b.  The
// metric kind is a template parameter, so each kernel instance carries only
// its own RHS.  The forms follow curvis_tpu/ops/march_pallas.py
// (_shape_fns / _deriv_fns); the DNEG shape uses atanf / log1pf as in
// curvis_tpu/metrics/base.py.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace curvis {

enum MetricKind : int {
  kEllis = 0,
  kInterstellar = 1,
  kFlat = 2,
  kSchwarzschild = 3,
  kReissnerNordstrom = 4,
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

constexpr float kPi = 3.14159265358979323846f;

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
template <int KIND>
__device__ __forceinline__ void planar_deriv(const MarchScalars& s, float l,
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

// Areal radius r(l), for the readout.
template <int KIND>
__device__ __forceinline__ float planar_r(const MarchScalars& s, float l) {
  if constexpr (KIND == kEllis) return sqrtf(s.p0 * s.p0 + l * l);
  if constexpr (KIND == kInterstellar) {
    float r, dr;
    dneg_shape(s.p0, s.p1, s.p2, l, &r, &dr);
    return r;
  }
  return fabsf(l);
}

// Local radial direction component u_l = p_l sqrt(A), with A clamped at
// 1e-6 (curvis_tpu/ops/render_fused.py:_readout_u_l).
template <int KIND>
__device__ __forceinline__ float readout_u_l(const MarchScalars& s, float l,
                                             float p_l) {
  if constexpr (KIND == kSchwarzschild)
    return p_l * sqrtf(fmaxf(1.0f - 2.0f * s.p0 / l, 1e-6f));
  if constexpr (KIND == kReissnerNordstrom) {
    const float A = 1.0f - (2.0f * s.p0 - s.p1 / l) / l;
    return p_l * sqrtf(fmaxf(A, 1e-6f));
  }
  return p_l;
}

// Euler march of one ray until it escapes (sign +1 / -1), is captured
// (sign 2) or has taken max_steps steps (sign 0).  The escape test follows
// each step, strict on both sides.  Returns the sign; *steps gets the
// number of steps taken.
template <int KIND>
__device__ __forceinline__ int march_ray(const MarchScalars& s, float* l_io,
                                         float* psi_io, float* pl_io, float b,
                                         int max_steps, int* steps) {
  float l = *l_io, psi = *psi_io, p_l = *pl_io;
  const float b2 = b * b;
  int sign = 0;
  int n = 0;
  while (n < max_steps && sign == 0) {
    float dl, dpsi, dpl;
    planar_deriv<KIND>(s, l, p_l, b, b2, &dl, &dpsi, &dpl);
    l = l + s.dt * dl;
    psi = psi + s.dt * dpsi;
    p_l = p_l + s.dt * dpl;
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
