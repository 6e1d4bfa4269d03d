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
// A tabulated metric (kTable; the scalars carry the table, as
// planar.cuh's ScalarsOf) has the metric part (s^2, series c1[0..K],
// series c2[0..K]) in place of (p0, p1, p2): s^2 in slot p0 (p1, p2 stay
// 0) and the 2 (K + 1) series coefficients after the family's theta.  The
// series c1 / c2 of the table are not the plane coefficients c1 / c2.
// The step is the forward kernels' own: disk_step (planar.cuh), which
// disk.cu (#5) marches, and vol_step (planar_vol.cuh), which disk_vol.cu
// (#6) marches, so the replay takes the crossing decisions that the forward
// took.  The four volumetric flags (blackbody, redshift, doppler, scatter)
// arrive as a runtime bitmask, the same for every thread of a launch: the
// forward step is dispatched once per segment to its templated instance,
// the VJP branches on the bits.  Kernels are templated on the metric kind
// and the family only (24 instances).
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
// local memory (4 or 5 x seg floats), and for a table the 2 x 33 series
// sums too.  The design does nothing about divergence (no ray sorting):
// this is the correct, simple form.
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "surface_vjp.cuh"

namespace curvis {

constexpr int kSurfThreads = 128;
constexpr int kSurfMaxSeg = 64;     // longest segment the backward can hold
constexpr int kDiskState = 11;
constexpr int kVolState = 9;
constexpr int kDiskTheta = 8;
constexpr int kVolTheta = 17 + kScatterBlock;   // the most a vol launch uses

// ---------------------------------------------------------------- thin VJP

// VJP of disk_step at its start (l, p_l, u, v), given which slot the step
// filled.  lam[11] is the cotangent of the step's output and becomes that
// of its input; g[0..5] gather the cotangents of p0, p1, p2, b, c1, c2 (the
// band r_in, r_out is a gate: no cotangent) and gc a table's series.
template <int KIND, class S>
__device__ __forceinline__ void disk_step_vjp(const S& s,
                                              float l, float p_l, float u,
                                              float v, bool new1, bool new2,
                                              float b, float b2, float c1,
                                              float c2, float lam[kDiskState],
                                              float g[kDiskTheta],
                                              float* gc) {
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
  const CrossFrac cf = crossing_frac(zq, zq1);
  const float frac = cf.frac;
  // the hit triple written this step; a filled slot's old value gets none
  float g_lh, g_plh, g_psih;
  take_hit_cotangent(new1 ? 0 : (new2 ? 3 : -1), lam + 5, &g_lh, &g_plh,
                     &g_psih);
  const float g_frac = g_lh * (l1 - l) + g_plh * (pl1 - p_l) + g_psih * du;
  const float g_l1 = lam[0] + frac * g_lh;
  const float g_pl1 = lam[2] + frac * g_plh;
  float g_du = lam[1] + frac * g_psih;
  float g_zq, g_zq1;
  crossing_frac_vjp(cf, zq, zq1, g_frac, &g_zq, &g_zq1);
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
  euler_step_vjp<KIND>(s, l, p_l, b, b2, &lam_l, g_du, &lam_pl, g, gc);
  lam[0] = lam_l + (1.0f - frac) * g_lh;
  lam[1] = lam[1] + g_psih;
  lam[2] = lam_pl + (1.0f - frac) * g_plh;
  lam[3] = g_u;
  lam[4] = g_v;
}

// VJP of vol_step at its start (l, p_l, u, v, tau).  lam[9] is the
// cotangent of the step's output and becomes that of its input; g gathers
// the theta cotangents of the vol family and gc a table's series.
template <int KIND, class VS>
__device__ __forceinline__ void vol_step_vjp(const VS& s, int flags,
                                             float l, float p_l, float u,
                                             float v, float tau, float b,
                                             float b2, float c1, float c2,
                                             float nz, float lam[kVolState],
                                             float* g, float* gc) {
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
                         g_dem, &g_l1, &g_pl1, &g_zq, &g_tau, g, gc);
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
                       g, gc);
  lam[0] = lam_l;
  lam[2] = lam_pl;
  lam[3] = g_u;
  lam[4] = g_v;
  lam[5] = lam[5] + g_tau;
}

// ------------------------------------------------------------ dispatching

// k_n volumetric steps from y with the templated step of the flags
template <int KIND, class VS>
__device__ __forceinline__ void vol_steps(const VS& s, int flags,
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
    ckpt_surface_gen_kernel(const __grid_constant__ VolScalarsOf<KIND> s,
                            int flags,
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
    ckpt_surface_bwd_kernel(const __grid_constant__ VolScalarsOf<KIND> s,
                            int flags,
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
  // a table's series sums (c1's, then c2's at kChebCap)
  constexpr int NC = KIND == kTable ? 2 * kChebCap : 1;
  float gc[NC];
  for (int k = 0; k < NC; ++k) gc[k] = 0.0f;
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
                           g, gc);
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
                            g, gc);
    }
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) lam_out[c * n + i] = lam[c];
#pragma unroll
  for (int k = 0; k < NT; ++k)
    if (k < n_theta) g_out[k * n + i] = g[k];
  if constexpr (KIND == kTable) {
    // the series after the family's theta: c1[0..K], then c2[0..K]
    const int nc = s.m.tab.n;
    for (int k = 0; k < nc; ++k) {
      g_out[(n_theta + k) * n + i] = gc[k];
      g_out[(n_theta + nc + k) * n + i] = gc[kChebCap + k];
    }
  }
}

// Checks shared by both host entries: the scalar row's length for the
// family (8 floats thin; 16, or 43 with the scatter bit, vol), the segment
// and the grid; fills the scalars and the grid size.
int surface_setup(int kind, int vol, int flags, const float* scalars,
                  int n_scalars, const ChebTable* tab, long long n, int seg,
                  int device, VolScalars* s, unsigned* blocks) {
  const int want = vol ? kVolBaseFloats +
                             ((flags & kFlagScatter) ? kScatterBlock : 0)
                       : 8;
  if (n_scalars != want || (!vol && flags != 0) || flags < 0 || flags > 15 ||
      !table_ok(kind, tab))
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
// `table` the host ChebTable of a kTable launch (ignored otherwise);
// `flags` the vol bitmask (1 blackbody, 2 redshift, 4 doppler, 8 scatter;
// 0 for thin).  `offsets` (int64) are each ray's first checkpoint row;
// `ckpt` holds sum_i ceil(steps[i] / seg) rows of n_state floats.  Each
// launches on `stream` without synchronising and returns the cudaError_t
// of the launch (0 on success).
extern "C" int curvis_ckpt_surface_gen(
    int kind, int vol, int flags, const float* scalars, int n_scalars,
    const void* table,
    const float* l, const float* psi, const float* p_l, const float* b,
    const float* c1, const float* c2, const float* nz, const int* steps,
    const long long* offsets, float* ckpt, float* final_state, long long n,
    int seg, int device, void* stream) {
  using namespace curvis;
  const ChebTable* tab = static_cast<const ChebTable*>(table);
  VolScalars s;
  unsigned g = 0;
  const int err = surface_setup(kind, vol, flags, scalars, n_scalars, tab, n,
                                seg, device, &s, &g);
  if (err != 0 || n <= 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_planar_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    const VolScalarsOf<K> sk = vol_scalars_of<K>(s, tab);
    if (vol)
      ckpt_surface_gen_kernel<K, true><<<g, kSurfThreads, 0, st>>>(
          sk, flags, l, psi, p_l, b, c1, c2, nz, steps, offsets, ckpt,
          final_state, n, seg);
    else
      ckpt_surface_gen_kernel<K, false><<<g, kSurfThreads, 0, st>>>(
          sk, flags, l, psi, p_l, b, c1, c2, nz, steps, offsets, ckpt,
          final_state, n, seg);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// `cot` and `lam` are (n_state, n) float buffers, `g_theta` (n_theta, n):
// 8 for thin, 17 or 44 for vol, and 2 table->n more rows for a kTable
// launch (the series coefficients after the family's theta).
extern "C" int curvis_ckpt_surface_bwd(
    int kind, int vol, int flags, const float* scalars, int n_scalars,
    const void* table,
    const float* ckpt, const float* b, const float* c1, const float* c2,
    const float* nz, const int* steps, const long long* offsets,
    const float* cot, float* lam, float* g_theta, long long n, int seg,
    int device, void* stream) {
  using namespace curvis;
  const ChebTable* tab = static_cast<const ChebTable*>(table);
  VolScalars s;
  unsigned g = 0;
  const int err = surface_setup(kind, vol, flags, scalars, n_scalars, tab, n,
                                seg, device, &s, &g);
  if (err != 0 || n <= 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_planar_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    const VolScalarsOf<K> sk = vol_scalars_of<K>(s, tab);
    if (vol)
      ckpt_surface_bwd_kernel<K, true><<<g, kSurfThreads, 0, st>>>(
          sk, flags, ckpt, b, c1, c2, nz, steps, offsets, cot, lam, g_theta,
          n, seg);
    else
      ckpt_surface_bwd_kernel<K, false><<<g, kSurfThreads, 0, st>>>(
          sk, flags, ckpt, b, c1, c2, nz, steps, offsets, cot, lam, g_theta,
          n, seg);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
