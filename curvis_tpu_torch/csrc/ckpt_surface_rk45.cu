// Checkpointed-recompute adjoint of the adaptive DP5(4) planar disk
// marches: checkpoint generation and the reverse-segment backward sweep for
// the disk-tracker (10-state) and volumetric (8-state) rk45 step families,
// one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernels curvis_tpu/ops/ckpt_adjoint_pallas.py:
// _ckpt_gen_kernel (#9) and _ckpt_bwd_kernel (#10) driven by the step map
// of curvis_tpu/integrate/planar_surface_adjoint.py:_pl_rk45_surface_iter.
// The Python wrapper is curvis_tpu_torch/ops/ckpt_surface_cuda.py, which
// also holds the plain PyTorch versions of both kernels and of the two
// iteration VJPs written here.
//
// Families (the state per ray, then theta, whose cotangents bwd returns
// per ray; theta is that of the Euler families of ckpt_surface.cu):
//   thin:  y = (l, psi, p_l, dt, h1, h1p, h1s, h2, h2p, h2s),
//          theta = (p0, p1, p2, b, c1, c2, r_in, r_out);
//   vol:   y = (l, psi, p_l, dt, tau, em_r, em_g, em_b),
//          theta = (p0, p1, p2, b, c1, c2, nz, r_in, r_out, the 8 emission
//          slots, the 27 scatter scalars when the scatter bit is set).
// A tabulated metric's theta is as ckpt_surface.cu's: s^2 in slot p0 and
// its 2 (K + 1) series coefficients after the family's theta.
// No (u, v) is carried: zq = c1 cos psi + c2 sin psi is recomputed from
// psi, as kernel #4 does.  The iteration is rk45_surface.cuh's
// rk45_surface_iter, the one kernel #4's surface variants run
// (planar_rk45_disk.cu), and both files are built without FMA contraction
// (ops/_build.py), so the replay takes the forward's accept, crossing,
// opacity and clamp decisions bit for bit.  The volumetric flags arrive as
// a runtime bitmask, which the host turns into the kernels' template
// parameters (ckpt_surface_rk45.cuh holds the kernels).
//
//   gen: march iters[i] iterations from y0 = (l, psi, p_l, dt0, 0...),
//        writing the state at the start of each of the ray's segments to
//        its rows of the compacted buffer (ceil(iters[i] / seg) rows of
//        n_state floats from offsets[i]); the final state goes to
//        final[c][i].
//   bwd: for each segment, last to first: re-march it from its checkpoint
//        keeping each iteration's start (l, psi, p_l, dt and the slot it
//        filled as two bit masks for thin; l, psi, p_l, dt, tau for vol),
//        then pull lam back through the iterations in reverse with
//        rk45_thin_iter_vjp / rk45_vol_iter_vjp, which add the crossing,
//        the emission and the anticipatory clamps to rk45_vjp.cuh's
//        iteration VJP and reuse surface_vjp.cuh's crossing, hit and
//        emission VJPs.
//
// What bounds it on the H100: FP32 issue and warp divergence.  An
// iteration is #4's (~300 operations plus a sincos), an accepted vol
// iteration adds the emission (~45-110); the VJP recomputes it and
// reverses the stages and the emission (~3x).  The buffer moves 40 or 32
// bytes per ray per segment; the start states live in per-thread local
// memory.  The design does nothing about divergence: the correct, simple
// form.
#include <cstring>

#include "ckpt_surface_rk45.cuh"

namespace curvis {

template void launch_surface_rk45<kEllis>(bool, const SurfRk45Call&);
template void launch_surface_rk45<kInterstellar>(bool, const SurfRk45Call&);
template void launch_surface_rk45<kFlat>(bool, const SurfRk45Call&);

// gen or bwd of a runtime metric kind; false for an unknown kind.
bool launch_surface_rk45_kind(int kind, bool bwd, const SurfRk45Call& a) {
  switch (kind) {
    case kEllis: launch_surface_rk45<kEllis>(bwd, a); return true;
    case kInterstellar:
      launch_surface_rk45<kInterstellar>(bwd, a);
      return true;
    case kFlat: launch_surface_rk45<kFlat>(bwd, a); return true;
    case kSchwarzschild:
      launch_surface_rk45<kSchwarzschild>(bwd, a);
      return true;
    case kReissnerNordstrom:
      launch_surface_rk45<kReissnerNordstrom>(bwd, a);
      return true;
    case kTable: launch_surface_rk45<kTable>(bwd, a); return true;
    default: return false;
  }
}

// Checks shared by both host entries: the row's length for the family
// (kernel #4's surface row: 11 floats thin; 19, or 46 with the scatter
// bit, vol), the segment and the grid; fills the scalars and the grid.
int surface_rk45_setup(int kind, int vol, int flags, const float* scalars,
                       int n_scalars, const ChebTable* tab, long long n,
                       int seg, int device, Rk45SurfScalars* s,
                       unsigned* blocks) {
  const int want =
      vol ? 19 + ((flags & kFlagScatter) ? kScatterBlock : 0) : 11;
  if (n_scalars != want || (!vol && flags != 0) || flags < 0 || flags > 15 ||
      !table_ok(kind, tab))
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg < 1 || seg > kSurfRk45MaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  // row: dt0, R, p0, p1, p2, r_cap | rtol, atol, dt_max | r_in, r_out |
  // 8 slots | scatter block
  float row[19 + kScatterBlock];
  std::memset(row, 0, sizeof(row));
  std::memcpy(row, scalars, sizeof(float) * n_scalars);
  std::memset(s, 0, sizeof(*s));
  std::memcpy(&s->vs.m, row, sizeof(MarchScalars));
  std::memcpy(&s->c, row + 6, sizeof(Rk45Control));
  std::memcpy(&s->vs.r_in, row + 9, sizeof(float) * (10 + kScatterBlock));
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long g = (n + kSurfRk45Threads - 1) / kSurfRk45Threads;
  if (g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(g);
  return 0;
}

}  // namespace curvis

// Host entries.  `scalars` is kernel #4's surface row (curvis::
// Rk45DiskScalars of planar_rk45_disk.cu: 11, 19 or 46 floats); `table`
// the host ChebTable of a kTable launch (ignored otherwise); `flags`
// the vol bitmask (1 blackbody, 2 redshift, 4 doppler, 8 scatter; 0 for
// thin).  `offsets` (int64) are each ray's first checkpoint row; `ckpt`
// holds sum_i ceil(iters[i] / seg) rows of n_state floats; `final_state`,
// `cot` and `lam` are (n_state, n), `g_theta` (n_theta, n): 8 for thin,
// 17 or 44 for vol, and 2 table->n more rows for a kTable launch.  Each
// launches on `stream` without synchronising and returns the cudaError_t
// of the launch (0 on success).
extern "C" int curvis_ckpt_surface_rk45_gen(
    int kind, int vol, int flags, const float* scalars, int n_scalars,
    const void* table,
    const float* l, const float* psi, const float* p_l, const float* b,
    const float* c1, const float* c2, const float* nz, const int* iters,
    const long long* offsets, float* ckpt, float* final_state, long long n,
    int seg, int device, void* stream) {
  using namespace curvis;
  static_assert(sizeof(Rk45SurfScalars) ==
                    (19 + kScatterBlock) * sizeof(float),
                "Rk45SurfScalars is a packed row of floats");
  SurfRk45Call a{};
  a.tab = static_cast<const ChebTable*>(table);
  const int err = surface_rk45_setup(kind, vol, flags, scalars, n_scalars,
                                     a.tab, n, seg, device, &a.s, &a.blocks);
  if (err != 0 || n <= 0) return err;
  a.vol = vol;
  a.flags = flags;
  a.seg = seg;
  a.stream = static_cast<cudaStream_t>(stream);
  a.l = l;
  a.psi = psi;
  a.p_l = p_l;
  a.b = b;
  a.c1 = c1;
  a.c2 = c2;
  a.nz = nz;
  a.iters = iters;
  a.offsets = offsets;
  a.ckpt_out = ckpt;
  a.final_state = final_state;
  a.n = n;
  if (!launch_surface_rk45_kind(kind, false, a))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int curvis_ckpt_surface_rk45_bwd(
    int kind, int vol, int flags, const float* scalars, int n_scalars,
    const void* table, int freeze, const float* ckpt, const float* b, const float* c1,
    const float* c2, const float* nz, const int* iters,
    const long long* offsets, const float* cot, float* lam, float* g_theta,
    long long n, int seg, int device, void* stream) {
  using namespace curvis;
  SurfRk45Call a{};
  a.tab = static_cast<const ChebTable*>(table);
  const int err = surface_rk45_setup(kind, vol, flags, scalars, n_scalars,
                                     a.tab, n, seg, device, &a.s, &a.blocks);
  if (err != 0 || n <= 0) return err;
  a.vol = vol;
  a.flags = flags;
  a.freeze = freeze;
  a.seg = seg;
  a.stream = static_cast<cudaStream_t>(stream);
  a.ckpt_in = ckpt;
  a.b = b;
  a.c1 = c1;
  a.c2 = c2;
  a.nz = nz;
  a.iters = iters;
  a.offsets = offsets;
  a.cot = cot;
  a.lam = lam;
  a.g_theta = g_theta;
  a.n = n;
  if (!launch_surface_rk45_kind(kind, true, a))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
