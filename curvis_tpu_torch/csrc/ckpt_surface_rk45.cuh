// The checkpoint kernels of the DP5(4) planar disk families, gen and bwd,
// templated on the metric kind, the family and the volumetric flags; the
// host entries are ckpt_surface_rk45.cu's, which sets out what they do.
// Each kind's instances are built in one translation unit
// (ckpt_surface_rk45.cu for the analytic capture-free kinds,
// ckpt_surface_rk45_schwarzschild.cu and ckpt_surface_rk45_rn.cu for the
// lapse kinds, whose 16 flag sets make most of the code, and
// ckpt_surface_rk45_table.cu and ckpt_surface_rk45_table_bb.cu for the
// tabulated metrics, whose VJPs reverse the series' recurrences).
#pragma once

#include <cstdint>
#include <type_traits>

#include "rk45_surface.cuh"
#include "rk45_vjp.cuh"
#include "surface_vjp.cuh"

namespace curvis {

constexpr int kSurfRk45Threads = 128;
constexpr int kSurfRk45MaxSeg = 32;   // longest segment the backward holds
constexpr int kThinRk45State = 10;
constexpr int kVolRk45State = 8;
constexpr int kThinRk45Theta = 8;
constexpr int kVolRk45Theta = 17 + kScatterBlock;   // the most vol uses

// The kernels' scalars: the controller and the volumetric row (the march
// scalars with m.dt = dt0, the band, the slots and the scatter block); a
// kTable kernel's march scalars carry the table (M = TableScalars).
template <class M>
struct Rk45SurfScalarsT {
  Rk45Control c;
  VolScalarsT<M> vs;
};
using Rk45SurfScalars = Rk45SurfScalarsT<MarchScalars>;

template <int KIND>
using Rk45SurfScalarsOf = Rk45SurfScalarsT<ScalarsOf<KIND>>;

// VJP of one thin iteration at its start (l, psi, p_l, dt), given the hit
// slot it filled (0 or 3, -1 for none).  lam[10] is the cotangent of the
// state after it and becomes that before it; g[0..5] gather the
// cotangents of p0, p1, p2, b, c1, c2 (the band is a gate) and gc a
// table's series.
template <int KIND, class S>
__device__ __forceinline__ void rk45_thin_iter_vjp(
    const S& m, const Rk45Control& c, float r_out, bool freeze, float l,
    float psi, float p_l, float dt, int slot, float b, float b2, float c1,
    float c2, float lam[kThinRk45State], float g[kThinRk45Theta],
    float* gc) {
  Rk45Rec r;
  rk45_trial_rec<KIND>(m, c, b, b2, l, psi, p_l, dt, &r);
  const float ln = r.out[0], psin = r.out[1], pln = r.out[2];
  const float cs0 = cosf(psi), sn0 = sinf(psi);
  const float cs1 = cosf(psin), sn1 = sinf(psin);
  const float zq0 = c1 * cs0 + c2 * sn0, zq1 = c1 * cs1 + c2 * sn1;
  const bool terminal = rk45_terminal(m, r, false);
  float g_out[3] = {lam[0], lam[1], lam[2]};
  float g_y[3] = {0.0f, 0.0f, 0.0f};
  float g_zq0 = 0.0f, g_zq1 = 0.0f, g_dt = 0.0f, g_err = 0.0f;
  if (!freeze) {
    float g_next = lam[3];
    if (!terminal && fabsf(ln) < r_out + 2.0f) {
      // dt = min(next, max(dt0, 0.2 |l| |zq|)) near the plane
      const float next = rk45_next_dt(c, r.err, r.dt);
      const float lim_raw = 0.2f * fabsf(ln) * fabsf(zq1);
      const float lim = max_nan(m.dt, lim_raw);
      const float g_raw =
          g_next * max_share(next, lim) * max_share(lim_raw, m.dt);
      g_next = g_next * max_share(lim, next);
      g_out[0] += g_raw * 0.2f * fabsf(zq1) * sgn(ln);
      g_zq1 += g_raw * (0.2f * fabsf(ln)) * sgn(zq1);
    }
    rk45_control_vjp(c, r, terminal, g_next, &g_dt, &g_err);
  }
  // the hit this iteration wrote: (l, p_l, psi) at the crossing fraction
  float g_lh, g_plh, g_psih;
  take_hit_cotangent(slot, lam + 4, &g_lh, &g_plh, &g_psih);
  if (slot >= 0) {
    const CrossFrac cf = crossing_frac(zq0, zq1);
    const float frac = cf.frac;
    const float g_frac =
        g_lh * (ln - l) + g_plh * (pln - p_l) + g_psih * (psin - psi);
    g_out[0] += frac * g_lh;
    g_out[1] += frac * g_psih;
    g_out[2] += frac * g_plh;
    g_y[0] += (1.0f - frac) * g_lh;
    g_y[1] += (1.0f - frac) * g_psih;
    g_y[2] += (1.0f - frac) * g_plh;
    float gz0, gz1;
    crossing_frac_vjp(cf, zq0, zq1, g_frac, &gz0, &gz1);
    g_zq0 += gz0;
    g_zq1 += gz1;
  }
  // zq = c1 cos psi + c2 sin psi, before and after
  g_out[1] += g_zq1 * (c2 * cs1 - c1 * sn1);
  g_y[1] += g_zq0 * (c2 * cs0 - c1 * sn0);
  g[4] += g_zq0 * cs0 + g_zq1 * cs1;
  g[5] += g_zq0 * sn0 + g_zq1 * sn1;
  rk45_trial_vjp<KIND>(m, c, b, b2, r, g_out, g_err, g_y, &g_dt, g, gc);
  lam[0] = g_y[0];
  lam[1] = g_y[1];
  lam[2] = g_y[2];
  lam[3] = g_dt;
}

// VJP of one volumetric iteration at its start (l, psi, p_l, dt, tau).
// lam[8] is the cotangent of the state after it and becomes that before
// it; g gathers the theta cotangents of the vol family and gc a table's
// series.
template <int KIND, bool BB, bool RS, bool DOP, bool SC, class VS>
__device__ __forceinline__ void rk45_vol_iter_vjp(
    const VS& vs, const Rk45Control& c, int flags, bool freeze, float l,
    float psi, float p_l, float dt, float tau, float b, float b2, float c1,
    float c2, float nz, float lam[kVolRk45State], float* g, float* gc) {
  const auto& m = vs.m;
  Rk45Rec r;
  rk45_trial_rec<KIND>(m, c, b, b2, l, psi, p_l, dt, &r);
  const float ln = r.out[0], pln = r.out[2];
  const float cs1 = cosf(r.out[1]), sn1 = sinf(r.out[1]);
  const float zq1 = c1 * cs1 + c2 * sn1;
  float dtau = 0.0f, dem[3] = {0.0f, 0.0f, 0.0f};
  bool opaque = false;
  if (r.accept) {
    vol_emission<KIND, BB, RS, DOP, SC>(m, vs.r_in, vs.r_out, vs.v,
                                        vs.scatter, ln, pln, b, zq1, tau, nz,
                                        &dtau, dem);
    opaque = tau + dt * dtau > vs.v.tau_max;
  }
  const bool terminal = rk45_terminal(m, r, opaque);
  float g_out[3] = {lam[0], lam[1], lam[2]};
  float g_zq1 = 0.0f, g_dt = 0.0f, g_err = 0.0f;
  if (!freeze) {
    float g_next = lam[3];
    if (!terminal) {
      // dt = min(next, max(dt0, max(gap_r, gap_z) / 2)) (the gas clamp)
      const float next = rk45_next_dt(c, r.err, r.dt);
      const float rl = gas_radius<KIND>(m, ln);
      const float s2_raw = 1.0f - zq1 * zq1;
      const float sq = sqrtf(clip_nan(s2_raw, 1e-12f, 1.0f));
      const float r_cyl = rl * sq;
      const float gap_r = r_cyl - (vs.r_out + 2.0f);
      const float sh2 = sqrtf(vs.v.h2);
      const float h_rel5 = 5.0f * sh2;
      const float gap_z = rl * fabsf(zq1) - h_rel5 * r_cyl;
      const float lim_raw = 0.5f * max_nan(gap_r, gap_z);
      const float lim = max_nan(m.dt, lim_raw);
      const float g_gap = 0.5f * g_next * max_share(next, lim) *
                          max_share(lim_raw, m.dt);
      g_next = g_next * max_share(lim, next);
      const float s_r = max_share(gap_r, gap_z);
      const float g_gr = g_gap * s_r, g_gz = g_gap * (1.0f - s_r);
      const float g_rcyl = g_gr - g_gz * h_rel5;
      g[8] += -g_gr;                               // r_out
      g[9] += -g_gz * r_cyl * 5.0f * 0.5f / sh2;   // h2 (slot 0)
      g_zq1 += g_gz * rl * sgn(zq1);
      const float g_rl = g_gz * fabsf(zq1) + g_rcyl * sq;
      const float g_s2 = g_rcyl * rl * 0.5f / sq;
      g_zq1 += -2.0f * zq1 * g_s2 * clip_share(s2_raw, 1e-12f, 1.0f);
      if constexpr (HasCapture<KIND>::value) {
        g_out[0] += g_rl;
      } else {
        radius_vjp<KIND>(
            m, ln,
            g_rl * max_share(planar_inv_r2<KIND>(m, ln), 1e-30f), &g_out[0],
            g, gc);
      }
    }
    rk45_control_vjp(c, r, terminal, g_next, &g_dt, &g_err);
  }
  float g_tau = lam[4];
  if (r.accept) {
    // tau += dt dtau, em += dt dem with the trial dt
    g_dt += lam[4] * dtau + lam[5] * dem[0] + lam[6] * dem[1] +
            lam[7] * dem[2];
    const float g_dem[3] = {dt * lam[5], dt * lam[6], dt * lam[7]};
    vol_emission_vjp<KIND>(vs, flags, ln, pln, b, zq1, tau, nz, dt * lam[4],
                           g_dem, &g_out[0], &g_out[2], &g_zq1, &g_tau, g,
                           gc);
  }
  g_out[1] += g_zq1 * (c2 * cs1 - c1 * sn1);
  g[4] += g_zq1 * cs1;
  g[5] += g_zq1 * sn1;
  float g_y[3] = {0.0f, 0.0f, 0.0f};
  rk45_trial_vjp<KIND>(m, c, b, b2, r, g_out, g_err, g_y, &g_dt, g, gc);
  lam[0] = g_y[0];
  lam[1] = g_y[1];
  lam[2] = g_y[2];
  lam[3] = g_dt;
  lam[4] = g_tau;
}

// k_n iterations of the templated surface instance from y (zq recomputed
// from psi), writing each one's start into ys (5 rows of kSurfRk45MaxSeg:
// l, psi, p_l, dt, tau) and the filled slots into *m1 / *m2, when ys is
// not null.
template <int KIND, bool TRACK, bool BB, bool RS, bool DOP, bool SC,
          class SS>
__device__ __forceinline__ void surface_iters(const SS& s,
                                              float b, float b2, float c1,
                                              float c2, float nz, float* y,
                                              int k_n, float* ys,
                                              uint32_t* m1, uint32_t* m2) {
  float zq = c1 * cosf(y[1]) + c2 * sinf(y[1]);
  constexpr int kAcc = TRACK ? 6 : 4;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = y[4 + k];
  int sign = 0, n_acc = 0;
  for (int k = 0; k < k_n; ++k) {
    if (ys != nullptr) {
#pragma unroll
      for (int c = 0; c < 4; ++c) ys[c * kSurfRk45MaxSeg + k] = y[c];
      ys[4 * kSurfRk45MaxSeg + k] = acc[0];
    }
    int slot;
    rk45_surface_iter<KIND, TRACK, BB, RS, DOP, SC>(
        s.vs.m, s.c, s.vs.r_in, s.vs.r_out, s.vs.v, s.vs.scatter, b, b2, c1,
        c2, nz, &y[0], &y[1], &y[2], &y[3], &zq, acc, &slot, &sign, &n_acc);
    if (ys != nullptr && TRACK) {
      *m1 |= static_cast<uint32_t>(slot == 0) << k;
      *m2 |= static_cast<uint32_t>(slot == 3) << k;
    }
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) y[4 + k] = acc[k];
}

template <int KIND, bool TRACK, bool BB, bool RS, bool DOP, bool SC>
__global__ void __launch_bounds__(kSurfRk45Threads)
    ckpt_surface_rk45_gen_kernel(const __grid_constant__
                                 Rk45SurfScalarsOf<KIND> s,
                                 const float* __restrict__ l_in,
                                 const float* __restrict__ psi_in,
                                 const float* __restrict__ pl_in,
                                 const float* __restrict__ b_in,
                                 const float* __restrict__ c1_in,
                                 const float* __restrict__ c2_in,
                                 const float* __restrict__ nz_in,
                                 const int* __restrict__ iters_in,
                                 const long long* __restrict__ off_in,
                                 float* __restrict__ ckpt,
                                 float* __restrict__ final_out, long long n,
                                 int seg) {
  constexpr int NS = TRACK ? kThinRk45State : kVolRk45State;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float b = b_in[i], c1 = c1_in[i], c2 = c2_in[i];
  const float nz = TRACK ? 0.0f : nz_in[i];
  const float b2 = b * b;
  const int iters = iters_in[i];
  float y[NS];
  y[0] = l_in[i];
  y[1] = psi_in[i];
  y[2] = pl_in[i];
  y[3] = s.vs.m.dt;
#pragma unroll
  for (int c = 4; c < NS; ++c) y[c] = 0.0f;
  float* row = ckpt + off_in[i] * NS;
  for (int j = 0; j < iters; j += seg) {
#pragma unroll
    for (int c = 0; c < NS; ++c) row[c] = y[c];
    row += NS;
    surface_iters<KIND, TRACK, BB, RS, DOP, SC>(s, b, b2, c1, c2, nz, y,
                                                min(seg, iters - j), nullptr,
                                                nullptr, nullptr);
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) final_out[c * n + i] = y[c];
}

template <int KIND, bool TRACK, bool BB, bool RS, bool DOP, bool SC>
__global__ void __launch_bounds__(kSurfRk45Threads)
    ckpt_surface_rk45_bwd_kernel(const __grid_constant__
                                 Rk45SurfScalarsOf<KIND> s,
                                 int flags, int freeze,
                                 const float* __restrict__ ckpt,
                                 const float* __restrict__ b_in,
                                 const float* __restrict__ c1_in,
                                 const float* __restrict__ c2_in,
                                 const float* __restrict__ nz_in,
                                 const int* __restrict__ iters_in,
                                 const long long* __restrict__ off_in,
                                 const float* __restrict__ cot,
                                 float* __restrict__ lam_out,
                                 float* __restrict__ g_out, long long n,
                                 int seg) {
  constexpr int NS = TRACK ? kThinRk45State : kVolRk45State;
  constexpr int NT = TRACK ? kThinRk45Theta : 17 + (SC ? kScatterBlock : 0);
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float b = b_in[i], c1 = c1_in[i], c2 = c2_in[i];
  const float nz = TRACK ? 0.0f : nz_in[i];
  const float b2 = b * b;
  const int iters = iters_in[i];
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
  float ys[5 * kSurfRk45MaxSeg];
  const float* rows = ckpt + off_in[i] * NS;
  const int n_seg = (iters + seg - 1) / seg;
  for (int sg = n_seg - 1; sg >= 0; --sg) {
    float y[NS];
#pragma unroll
    for (int c = 0; c < NS; ++c) y[c] = rows[sg * NS + c];
    const int k_n = min(seg, iters - sg * seg);
    uint32_t m1 = 0, m2 = 0;
    surface_iters<KIND, TRACK, BB, RS, DOP, SC>(s, b, b2, c1, c2, nz, y, k_n,
                                                ys, &m1, &m2);
    for (int k = k_n - 1; k >= 0; --k) {
      const float l = ys[k], psi = ys[kSurfRk45MaxSeg + k],
                  p_l = ys[2 * kSurfRk45MaxSeg + k],
                  dt = ys[3 * kSurfRk45MaxSeg + k];
      if constexpr (TRACK) {
        const int slot = ((m1 >> k) & 1) ? 0 : (((m2 >> k) & 1) ? 3 : -1);
        rk45_thin_iter_vjp<KIND>(s.vs.m, s.c, s.vs.r_out, freeze != 0, l,
                                 psi, p_l, dt, slot, b, b2, c1, c2, lam, g,
                                 gc);
      } else {
        rk45_vol_iter_vjp<KIND, BB, RS, DOP, SC>(
            s.vs, s.c, flags, freeze != 0, l, psi, p_l, dt,
            ys[4 * kSurfRk45MaxSeg + k], b, b2, c1, c2, nz, lam, g, gc);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) lam_out[c * n + i] = lam[c];
#pragma unroll
  for (int k = 0; k < NT; ++k) g_out[k * n + i] = g[k];
  if constexpr (KIND == kTable) {
    // the series after the family's theta: c1[0..K], then c2[0..K]
    const int nc = s.vs.m.tab.n;
    for (int k = 0; k < nc; ++k) {
      g_out[(NT + k) * n + i] = gc[k];
      g_out[(NT + nc + k) * n + i] = gc[kChebCap + k];
    }
  }
}

// The arguments of one launch of either kernel.
struct SurfRk45Call {
  Rk45SurfScalars s;
  const ChebTable* tab;   // the table of a kTable launch, else null
  int vol, flags, freeze, seg;
  unsigned blocks;
  cudaStream_t stream;
  const float *l, *psi, *p_l, *b, *c1, *c2, *nz, *ckpt_in, *cot;
  const int* iters;
  const long long* offsets;
  float *ckpt_out, *final_state, *lam, *g_theta;
  long long n;
};

template <int KIND, bool TRACK, bool BB, bool RS, bool DOP, bool SC>
void launch_surface_rk45_instance(bool bwd, const SurfRk45Call& a) {
  const Rk45SurfScalarsOf<KIND> s{a.s.c, vol_scalars_of<KIND>(a.s.vs, a.tab)};
  if (bwd)
    ckpt_surface_rk45_bwd_kernel<KIND, TRACK, BB, RS, DOP, SC>
        <<<a.blocks, kSurfRk45Threads, 0, a.stream>>>(
            s, a.flags, a.freeze, a.ckpt_in, a.b, a.c1, a.c2, a.nz,
            a.iters, a.offsets, a.cot, a.lam, a.g_theta, a.n, a.seg);
  else
    ckpt_surface_rk45_gen_kernel<KIND, TRACK, BB, RS, DOP, SC>
        <<<a.blocks, kSurfRk45Threads, 0, a.stream>>>(
            s, a.l, a.psi, a.p_l, a.b, a.c1, a.c2, a.nz, a.iters,
            a.offsets, a.ckpt_out, a.final_state, a.n, a.seg);
}

template <int KIND, bool BB, bool RS, bool DOP>
void pick_surface_rk45_scatter(bool bwd, const SurfRk45Call& a) {
  if (a.flags & kFlagScatter)
    launch_surface_rk45_instance<KIND, false, BB, RS, DOP, true>(bwd, a);
  else
    launch_surface_rk45_instance<KIND, false, BB, RS, DOP, false>(bwd, a);
}

template <int KIND, bool BB>
void pick_surface_rk45_shift(bool bwd, const SurfRk45Call& a) {
  const bool rs = a.flags & kFlagRedshift, dop = a.flags & kFlagDoppler;
  if constexpr (!HasCapture<KIND>::value) {
    // the shifts act only for the lapse kinds: one instance serves all
    pick_surface_rk45_scatter<KIND, BB, false, false>(bwd, a);
  } else if (rs && dop) {
    pick_surface_rk45_scatter<KIND, BB, true, true>(bwd, a);
  } else if (rs) {
    pick_surface_rk45_scatter<KIND, BB, true, false>(bwd, a);
  } else if (dop) {
    pick_surface_rk45_scatter<KIND, BB, false, true>(bwd, a);
  } else {
    pick_surface_rk45_scatter<KIND, BB, false, false>(bwd, a);
  }
}

// gen (bwd false) or bwd of kind KIND with the call's family and flags:
// the thin family, or the vol instance of the flags.  Each kind is
// instantiated in one translation unit (ckpt_surface_rk45.cu and the
// per-kind files beside it), so that nvcc builds them in parallel.
template <int KIND>
void launch_surface_rk45(bool bwd, const SurfRk45Call& a) {
  if (!a.vol)
    launch_surface_rk45_instance<KIND, true, false, false, false, false>(bwd,
                                                                         a);
  else if (a.flags & kFlagBlackbody)
    pick_surface_rk45_shift<KIND, true>(bwd, a);
  else
    pick_surface_rk45_shift<KIND, false>(bwd, a);
}

extern template void launch_surface_rk45<kSchwarzschild>(
    bool, const SurfRk45Call&);
extern template void launch_surface_rk45<kReissnerNordstrom>(
    bool, const SurfRk45Call&);
extern template void launch_surface_rk45<kTable>(bool, const SurfRk45Call&);
// the table's blackbody gas instances, built apart from its other ones
// (ckpt_surface_rk45_table_bb.cu) so that nvcc compiles them in parallel
extern template void launch_surface_rk45_instance<kTable, false, true, false,
                                                  false, false>(
    bool, const SurfRk45Call&);
extern template void launch_surface_rk45_instance<kTable, false, true, false,
                                                  false, true>(
    bool, const SurfRk45Call&);

}  // namespace curvis
