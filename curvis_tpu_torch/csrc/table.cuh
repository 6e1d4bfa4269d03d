// Tabulated user metrics (curvis_tpu_torch/metrics/table.py): the two
// shape functions of the planar right-hand side evaluated from a
// coefficient table, and the reverse mode of that evaluation.
//
// A table metric compactifies l with w = 1 / sqrt(l^2 + s^2), t = l w in
// (-1, 1), and keeps two series in t:
//     inv = 1 / r^2  = w^2 P(c1, t),    dr3 = r' / r^3 = w^3 P(c2, t),
// P a Chebyshev series summed by Clenshaw's recurrence or a monomial one
// summed by Horner's rule, in the operation order of
// curvis_tpu/metrics/table.py (cheb_eval, horner_eval), which the plain
// versions (curvis_tpu_torch/ops/table_cuda.py) repeat.
//
// The TPU kernels read the coefficients from a tail spliced into each
// family's SMEM scalar row at a per-family offset.  Here the table is its
// own struct, passed by value inside the kernel's scalar argument
// (TableScalars, the analytic kinds' MarchScalars with the table after it):
// every thread reads the same coefficient at the same time, a uniform
// constant-bank broadcast.  The kernels take that argument as
// __grid_constant__, so indexing the coefficient arrays with the loop
// counter reads the argument in place instead of copying it to each
// thread's stack.
#pragma once

#include <cuda_runtime.h>

namespace curvis {

constexpr int kChebMaxDegree = 32;               // degrees 0 .. 32
constexpr int kChebCap = kChebMaxDegree + 1;     // coefficients per series

// Host layout: ops/table_cuda.py:ChebTable (a ctypes.Structure of the same
// fields), copied by the host entries into the kernel argument.
struct ChebTable {
  float s2;      // compactification scale squared, s^2
  int n;         // coefficients per series, degree + 1 (1 .. kChebCap)
  int horner;    // 1: monomial series (Horner), 0: Chebyshev (Clenshaw)
  float c1[kChebCap];   // series of (l^2 + s^2) / r^2
  float c2[kChebCap];   // series of (l^2 + s^2)^{3/2} r' / r^3
};

// P(c, t) of n coefficients: Horner acc = c[n-1] + 0 t, acc = acc t + c[k];
// Clenshaw b1 <- c[k] + 2t b1 - b2 for k = n-1 .. 1, then c[0] + t b1 - b2.
__device__ __forceinline__ float table_poly(const float* c, int n,
                                            bool horner, float t) {
  if (horner) {
    float acc = c[n - 1] + t * 0.0f;
    for (int k = n - 2; k >= 0; --k) acc = acc * t + c[k];
    return acc;
  }
  float b1 = t * 0.0f, b2 = t * 0.0f;
  const float two_t = 2.0f * t;
  for (int k = n - 1; k >= 1; --k) {
    const float nb = c[k] + two_t * b1 - b2;
    b2 = b1;
    b1 = nb;
  }
  return c[0] + t * b1 - b2;
}

// (inv, dr3) = (1 / r^2, r' / r^3) at l.
__device__ __forceinline__ void table_shape(const ChebTable& tab, float l,
                                            float* inv, float* dr3) {
  const float w = 1.0f / sqrtf(l * l + tab.s2);
  const float t = l * w;
  const float w2 = w * w;
  const bool h = tab.horner != 0;
  *inv = w2 * table_poly(tab.c1, tab.n, h, t);
  *dr3 = w2 * w * table_poly(tab.c2, tab.n, h, t);
}

// Reverse mode of table_poly for the cotangent g_y of its value: adds
// d/dc[k] to gc[k] (one add each), returns d/dt.  The forward is re-run
// keeping its sequence (Horner's acc, Clenshaw's b1), which the reverse
// sweep reads last-computed first.
__device__ __forceinline__ float table_poly_vjp(const float* c, int n,
                                                bool horner, float t,
                                                float g_y, float* gc) {
  float seq[kChebCap + 1];
  if (horner) {
    // acc_{n-1} = c[n-1] + 0 t; acc_k = acc_{k+1} t + c[k]; y = acc_0
    float acc = c[n - 1] + t * 0.0f;
    seq[n - 1] = acc;
    for (int k = n - 2; k >= 0; --k) {
      acc = acc * t + c[k];
      seq[k] = acc;
    }
    float g_acc = g_y, g_t = 0.0f;
    for (int k = 0; k < n - 1; ++k) {
      gc[k] += g_acc;
      g_t += g_acc * seq[k + 1];
      g_acc = g_acc * t;
    }
    gc[n - 1] += g_acc;
    return g_t;
  }
  // B1_k, B2_k: (b1, b2) entering iteration k (k = n-1 .. 1), B*_0 after
  // iteration 1; seq[k] = B1_k, and B2_k = B1_{k+1} = seq[k + 1] (the
  // starts B1_{n-1} = B2_{n-1} = 0 t are seq[n-1] = seq[n])
  const float two_t = 2.0f * t;
  float b1 = t * 0.0f, b2 = t * 0.0f;
  seq[n] = b2;
  seq[n - 1] = b1;
  for (int k = n - 1; k >= 1; --k) {
    const float nb = c[k] + two_t * b1 - b2;
    b2 = b1;
    b1 = nb;
    seq[k - 1] = b1;
  }
  // y = c[0] + t B1_0 - B2_0
  gc[0] += g_y;
  float g_t = g_y * seq[0];
  float g_b1 = g_y * t, g_b2 = -g_y, g_two_t = 0.0f;
  // iteration k: B1_{k-1} = c[k] + two_t B1_k - B2_k, B2_{k-1} = B1_k
  for (int k = 1; k <= n - 1; ++k) {
    gc[k] += g_b1;
    g_two_t += g_b1 * seq[k];
    const float g_b1_in = g_b1 * two_t + g_b2;
    g_b2 = -g_b1;
    g_b1 = g_b1_in;
  }
  return g_t + 2.0f * g_two_t;
}

// Reverse mode of table_shape at l for the cotangents (g_inv, g_dr3) of
// (inv, dr3): sets *inv, *dr3, adds d/dl to *g_l, d/ds^2 to *g_s2 and the
// coefficients' to gc1[k], gc2[k].  GUARD evaluates the guarded form of the
// DP5(4) VJPs (curvis_tpu/integrate/rk45_adjoint_planar.py): x = l^2 + s^2
// floored at 1e-12 (the caller clips l).
template <bool GUARD>
__device__ __forceinline__ void table_shape_vjp(
    const ChebTable& tab, float l, float g_inv, float g_dr3, float* inv,
    float* dr3, float* g_l, float* g_s2, float* gc1, float* gc2) {
  const float x = l * l + tab.s2;
  const float xg = GUARD ? (isnan(x) ? x : fmaxf(x, 1e-12f)) : x;
  const float q = sqrtf(xg);
  const float w = 1.0f / q;
  const float t = l * w;
  const float w2 = w * w;
  const float w3 = w2 * w;
  const bool h = tab.horner != 0;
  const float p1 = table_poly(tab.c1, tab.n, h, t);
  const float p2 = table_poly(tab.c2, tab.n, h, t);
  *inv = w2 * p1;
  *dr3 = w3 * p2;
  // inv = w2 p1, dr3 = w3 p2, w3 = w2 w, w2 = w w
  const float g_w3 = g_dr3 * p2;
  const float g_w2 = g_inv * p1 + g_w3 * w;
  float g_t = table_poly_vjp(tab.c1, tab.n, h, t, g_inv * w2, gc1);
  g_t += table_poly_vjp(tab.c2, tab.n, h, t, g_dr3 * w3, gc2);
  // t = l w; w = 1 / q; q = sqrt(xg)
  const float g_w = g_w3 * w2 + g_w2 * 2.0f * w + g_t * l;
  const float g_q = -g_w * w * w;
  float g_x = g_q * 0.5f / q;
  if (GUARD) g_x = g_x * (x > 1e-12f ? 1.0f : (x < 1e-12f ? 0.0f : 0.5f));
  *g_s2 += g_x;
  *g_l += g_t * w + g_x * 2.0f * l;
}

}  // namespace curvis
