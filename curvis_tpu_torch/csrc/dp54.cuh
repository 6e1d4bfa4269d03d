// The Dormand-Prince 5(4) tableau as float32 and the step controller,
// shared by the planar DP5(4) iteration (rk45.cuh: kernels #3 and #4) and
// the Boyer-Lindquist DP5(4) march (kerr_step.cuh: kernel #8), and the
// controller's VJP, shared by their replays' VJPs (rk45_vjp.cuh,
// kerr_vjp.cuh).
//
// These are the values the TPU kernels multiply by: _DP_A, _DP_B5 and
// _DP_B4 of curvis_tpu/ops/march_pallas.py, rounded to float32.
#pragma once

#include <cuda_runtime.h>

#include "planar.cuh"

namespace curvis {

constexpr float kA21 = static_cast<float>(1.0 / 5);
constexpr float kA31 = static_cast<float>(3.0 / 40);
constexpr float kA32 = static_cast<float>(9.0 / 40);
constexpr float kA41 = static_cast<float>(44.0 / 45);
constexpr float kA42 = static_cast<float>(-56.0 / 15);
constexpr float kA43 = static_cast<float>(32.0 / 9);
constexpr float kA51 = static_cast<float>(19372.0 / 6561);
constexpr float kA52 = static_cast<float>(-25360.0 / 2187);
constexpr float kA53 = static_cast<float>(64448.0 / 6561);
constexpr float kA54 = static_cast<float>(-212.0 / 729);
constexpr float kA61 = static_cast<float>(9017.0 / 3168);
constexpr float kA62 = static_cast<float>(-355.0 / 33);
constexpr float kA63 = static_cast<float>(46732.0 / 5247);
constexpr float kA64 = static_cast<float>(49.0 / 176);
constexpr float kA65 = static_cast<float>(-5103.0 / 18656);
// the last row equals the 5th-order weights (FSAL); its zero a72 is
// multiplied in, as the TPU kernels do
constexpr float kB1 = static_cast<float>(35.0 / 384);
constexpr float kB3 = static_cast<float>(500.0 / 1113);
constexpr float kB4 = static_cast<float>(125.0 / 192);
constexpr float kB5 = static_cast<float>(-2187.0 / 6784);
constexpr float kB6 = static_cast<float>(11.0 / 84);
constexpr float kA72 = 0.0f;
// 4th-order weights (e2 = 0 is skipped, as in the TPU kernels' sums)
constexpr float kE1 = static_cast<float>(5179.0 / 57600);
constexpr float kE3 = static_cast<float>(7571.0 / 16695);
constexpr float kE4 = static_cast<float>(393.0 / 640);
constexpr float kE5 = static_cast<float>(-92097.0 / 339200);
constexpr float kE6 = static_cast<float>(187.0 / 2100);
constexpr float kE7 = static_cast<float>(1.0 / 40);

// The same tableau indexed by stage, for loops that the compiler unrolls
// (constant indices fold to the constants above): a_ij of stage i < 7,
// j < i; the 5th- and 4th-order weights of stage i (0 where the tableau
// has none).
__host__ __device__ constexpr float dp_a(int i, int j) {
  return i == 1   ? kA21
         : i == 2 ? (j == 0 ? kA31 : kA32)
         : i == 3 ? (j == 0 ? kA41 : j == 1 ? kA42 : kA43)
         : i == 4 ? (j == 0 ? kA51 : j == 1 ? kA52 : j == 2 ? kA53 : kA54)
         : i == 5 ? (j == 0   ? kA61
                     : j == 1 ? kA62
                     : j == 2 ? kA63
                     : j == 3 ? kA64
                              : kA65)
                  : (j == 0   ? kB1
                     : j == 1 ? kA72
                     : j == 2 ? kB3
                     : j == 3 ? kB4
                     : j == 4 ? kB5
                              : kB6);
}

__host__ __device__ constexpr float dp_b5(int i) {
  return i == 0 ? kB1 : i == 2 ? kB3 : i == 3 ? kB4 : i == 4 ? kB5
       : i == 5 ? kB6 : 0.0f;
}

__host__ __device__ constexpr float dp_b4(int i) {
  return i == 0 ? kE1 : i == 2 ? kE3 : i == 3 ? kE4 : i == 4 ? kE5
       : i == 5 ? kE6 : i == 6 ? kE7 : 0.0f;
}

// The controller's factor after a trial of scaled error err: 0.9
// err^-0.2 via exp / log of max(err, 1e-10), clipped to [0.2, 5]; a NaN
// err gives a NaN factor, which the guard turns into 0.2.
__device__ __forceinline__ float dp54_factor(float err) {
  const float err_s = max_nan(err, 1e-10f);
  const float factor =
      clip_nan(0.9f * expf(-0.2f * logf(err_s)), 0.2f, 5.0f);
  return factor > 0.0f ? factor : 0.2f;
}

// VJP of the next step clip(dt dp54_factor(err), dt_min, dt_max) of a ray
// still marching: adds the cotangents of dt and err to *g_dt and *g_err
// for the cotangent g_next of the next step.  A clip or max at a tie
// passes half, as jnp.clip and jnp.maximum do.
__device__ __forceinline__ void dp54_control_vjp(float err, float dt,
                                                 float dt_min, float dt_max,
                                                 float g_next, float* g_dt,
                                                 float* g_err) {
  const float err_s = max_nan(err, 1e-10f);
  const float f_raw = 0.9f * expf(-0.2f * logf(err_s));
  const float f_c = clip_nan(f_raw, 0.2f, 5.0f);
  const float factor = f_c > 0.0f ? f_c : 0.2f;
  const float x = dt * factor;
  const float g_x = g_next * clip_share(x, dt_min, dt_max);
  *g_dt += g_x * factor;
  const float g_fc = f_c > 0.0f ? g_x * dt : 0.0f;
  const float g_fraw = g_fc * clip_share(f_raw, 0.2f, 5.0f);
  // f_raw = 0.9 exp(-0.2 log err_s): d f_raw / d err_s = -0.2 f_raw / err_s
  // (added only where it is not zero: a NaN err, of a non-finite trial,
  // has the constant factor 0.2)
  if (g_fraw != 0.0f)
    *g_err += g_fraw * (-0.2f) * f_raw / err_s * max_share(err, 1e-10f);
}

}  // namespace curvis
