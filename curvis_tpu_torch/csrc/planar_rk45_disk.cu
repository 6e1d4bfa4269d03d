// Adaptive Dormand-Prince 5(4) march of planar rays with a disk surface,
// one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernel curvis_tpu/ops/march_pallas.py:_rk45_kernel in
// its track_disk and vol variants (with vol's scatter option; wrapper
// march_planar_rk45_pallas).  The bare variant is planar_rk45.cu; both run
// csrc/rk45.cuh's iteration.  Inputs per ray: (l, psi, p_l, b), the
// z-components (c1, c2) of the orbital-plane basis and, for vol, the plane
// normal's z-component nz.  Outputs: (l, psi, p_l), then
//   - TRACK (track_disk): the first two in-band crossings of the plane as
//     signed (l, p_l, psi) triples (h1, h1p, h1s, h2, h2p, h2s), h1 == 0
//     meaning no hit;
//   - vol: the optical depth tau and the emission (em_r, em_g, em_b),
// and (sign, steps, iters): steps counts accepted steps, iters the
// iterations a ray was live for.  The Python wrapper is
// curvis_tpu_torch/ops/rk45_disk_cuda.py:march_planar_rk45_disk_cuda and
// the plain PyTorch version march_planar_rk45_disk_plain there.
//
// The vol variant's four flags are template parameters, as in disk_vol.cu:
// BLACKBODY, REDSHIFT, DOPPLER (the shifts act only for the lapse kinds,
// so the capture-free kinds have one instance for all four settings) and
// SCATTER (the 27-scalar lensed-sky source after the emission slots).
//
// A tabulated metric (kTable) takes the table in the kernel's scalar
// argument (Rk45DiskScalarsT<TableScalars>, __grid_constant__); with no
// lapse it has the instances without the shifts only.
//
// The iteration is rk45_surface.cuh's rk45_surface_iter, which the
// checkpoint kernels of the rk45 surface families (ckpt_surface_rk45.cu)
// replay; its header lists the semantics kept from the TPU kernel.
//
// The file is built without FMA contraction (ops/_build.py:SOURCE_FLAGS):
// an adaptive march turns a last-bit difference at err ~ 1 into another
// step sequence, and thick gas turns that into another transfer integral,
// so the kernel rounds every operation as its plain version does.
//
// What bounds it on the H100: FP32 issue and warp divergence.  An
// iteration is #4's bare iteration (~280 operations for Ellis, ~300 for
// Schwarzschild) plus a sincos for zq and the crossing test or the clamp;
// an accepted vol step adds the emission (~45-110 operations with up to
// six exp and log).  Per-ray dt and rejects make a warp's lanes need
// different iteration counts.  The design does nothing about either yet:
// one loop per thread, no ray regrouping, no fast-math.
#include <cstring>

#include "rk45_surface.cuh"

namespace curvis {

constexpr int kRk45DiskThreads = 128;

// Host row: the rk45 row [dt0, R, p0, p1, p2, r_cap, rtol, atol, dt_max],
// the band [r_in, r_out], and for vol the 8 emission slots and, with
// SCATTER, the scatter block (11, 19 or 46 floats); a kTable kernel's
// march scalars carry the table (M = TableScalars).
template <class M>
struct Rk45DiskScalarsT {
  M m;   // m.dt is the initial step dt0
  Rk45Control c;
  float r_in;
  float r_out;
  VolSlots v;
  float scatter[kScatterBlock];
};
using Rk45DiskScalars = Rk45DiskScalarsT<MarchScalars>;

template <int KIND>
Rk45DiskScalarsT<ScalarsOf<KIND>> rk45_disk_scalars_of(
    const Rk45DiskScalars& s, const ChebTable* tab) {
  Rk45DiskScalarsT<ScalarsOf<KIND>> o;
  o.m = scalars_of<KIND>(s.m, tab);
  o.c = s.c;
  o.r_in = s.r_in;
  o.r_out = s.r_out;
  o.v = s.v;
  for (int k = 0; k < kScatterBlock; ++k) o.scatter[k] = s.scatter[k];
  return o;
}

constexpr int kRk45DiskFloats = 11;
constexpr int kRk45VolFloats = 19;

template <int KIND, bool TRACK, bool BLACKBODY, bool REDSHIFT, bool DOPPLER,
          bool SCATTER>
__global__ void __launch_bounds__(kRk45DiskThreads)
    march_planar_rk45_disk_kernel(
        const __grid_constant__ Rk45DiskScalarsT<ScalarsOf<KIND>> s,
                                  const float* __restrict__ l_in,
                                  const float* __restrict__ psi_in,
                                  const float* __restrict__ pl_in,
                                  const float* __restrict__ b_in,
                                  const float* __restrict__ c1_in,
                                  const float* __restrict__ c2_in,
                                  const float* __restrict__ nz_in,
                                  float* __restrict__ fout,
                                  int* __restrict__ iout, long long n,
                                  int max_steps, int max_iters) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float l = l_in[i], psi = psi_in[i], p_l = pl_in[i];
  const float b = b_in[i], c1 = c1_in[i], c2 = c2_in[i];
  const float nz = TRACK ? 0.0f : nz_in[i];
  const float b2 = b * b;
  float dt = s.m.dt;
  float zq = c1 * cosf(psi) + c2 * sinf(psi);
  // TRACK: h1, h1p, h1s, h2, h2p, h2s; vol: tau, em_r, em_g, em_b
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int sign = 0, n_acc = 0, live = 0;
  for (int it = 0; it < max_iters && sign == 0; ++it) {
    if (n_acc < max_steps) {
      ++live;
      int slot;
      rk45_surface_iter<KIND, TRACK, BLACKBODY, REDSHIFT, DOPPLER, SCATTER>(
          s.m, s.c, s.r_in, s.r_out, s.v, s.scatter, b, b2, c1, c2, nz, &l,
          &psi, &p_l, &dt, &zq, acc, &slot, &sign, &n_acc);
    }
    if (sign == 0 && n_acc >= max_steps) sign = kRk45Capped;
  }
  // fout rows: l, psi, p_l, then 6 hit rows (TRACK) or tau, em_r, em_g,
  // em_b; iout rows: sign, steps, iters
  constexpr int kAcc = TRACK ? 6 : 4;
  fout[i] = l;
  fout[n + i] = psi;
  fout[2 * n + i] = p_l;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) fout[(3 + k) * n + i] = acc[k];
  iout[i] = sign == kRk45Capped ? 0 : sign;
  iout[n + i] = n_acc;
  iout[2 * n + i] = live;
}

// Launch arguments of one call, bundled for the flag dispatch below.
struct Rk45DiskLaunch {
  const ChebTable* tab;   // the table of a kTable launch, else null
  unsigned blocks;
  cudaStream_t stream;
  const float *l, *psi, *p_l, *b, *c1, *c2, *nz;
  float* fout;
  int* iout;
  long long n;
  int max_steps;
  int max_iters;
};

template <int KIND, bool TRACK, bool BB, bool RS, bool DOP, bool SC>
void launch_rk45_disk(const Rk45DiskScalars& s, const Rk45DiskLaunch& a) {
  march_planar_rk45_disk_kernel<KIND, TRACK, BB, RS, DOP, SC>
      <<<a.blocks, kRk45DiskThreads, 0, a.stream>>>(
          rk45_disk_scalars_of<KIND>(s, a.tab), a.l, a.psi, a.p_l, a.b, a.c1, a.c2, a.nz, a.fout, a.iout, a.n,
          a.max_steps, a.max_iters);
}

template <int KIND, bool BB, bool RS, bool DOP>
void pick_rk45_scatter(bool sc, const Rk45DiskScalars& s,
                       const Rk45DiskLaunch& a) {
  if (sc)
    launch_rk45_disk<KIND, false, BB, RS, DOP, true>(s, a);
  else
    launch_rk45_disk<KIND, false, BB, RS, DOP, false>(s, a);
}

template <int KIND, bool BB>
void pick_rk45_shift(bool rs, bool dop, bool sc, const Rk45DiskScalars& s,
                     const Rk45DiskLaunch& a) {
  if constexpr (!HasCapture<KIND>::value) {
    // the shifts act only for the lapse kinds: one instance serves all
    pick_rk45_scatter<KIND, BB, false, false>(sc, s, a);
  } else if (rs && dop) {
    pick_rk45_scatter<KIND, BB, true, true>(sc, s, a);
  } else if (rs) {
    pick_rk45_scatter<KIND, BB, true, false>(sc, s, a);
  } else if (dop) {
    pick_rk45_scatter<KIND, BB, false, true>(sc, s, a);
  } else {
    pick_rk45_scatter<KIND, BB, false, false>(sc, s, a);
  }
}

template <int KIND>
void pick_rk45_mode(bool vol, bool bb, bool rs, bool dop, bool sc,
                    const Rk45DiskScalars& s, const Rk45DiskLaunch& a) {
  if (!vol)
    launch_rk45_disk<KIND, true, false, false, false, false>(s, a);
  else if (bb)
    pick_rk45_shift<KIND, true>(rs, dop, sc, s, a);
  else
    pick_rk45_shift<KIND, false>(rs, dop, sc, s, a);
}

}  // namespace curvis

// Host entry.  `scalars` is a host array of n_scalars floats in the layout
// of curvis::Rk45DiskScalars: 11 for the disk tracker (vol = 0), 19 for
// vol, 19 + 27 with the scatter block (`scatter` must say which), and
// `table` the host ChebTable of a kTable launch (ignored otherwise).  `nz`
// is read only by vol.  `fout` is a (9, n) float buffer for the tracker
// (l, psi, p_l, h1, h1p, h1s, h2, h2p, h2s) and a (7, n) one for vol (l,
// psi, p_l, tau, em_r, em_g, em_b); `iout` a (3, n) int buffer (sign,
// steps, iters).  Launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success).
extern "C" int curvis_march_planar_rk45_disk(
    int kind, int vol, int blackbody, int redshift, int doppler, int scatter,
    const float* scalars, int n_scalars, const void* table, const float* l,
    const float* psi,
    const float* p_l, const float* b, const float* c1, const float* c2,
    const float* nz, float* fout, int* iout, long long n, int max_steps,
    int max_iters, int device, void* stream) {
  using namespace curvis;
  static_assert(sizeof(Rk45DiskScalars) ==
                    (kRk45VolFloats + kScatterBlock) * sizeof(float),
                "Rk45DiskScalars is a packed row of floats");
  if (!vol && (blackbody || redshift || doppler || scatter))
    return static_cast<int>(cudaErrorInvalidValue);
  const int want = !vol ? kRk45DiskFloats
                        : kRk45VolFloats + (scatter ? kScatterBlock : 0);
  const ChebTable* tab = static_cast<const ChebTable*>(table);
  if (n_scalars != want || !table_ok(kind, tab))
    return static_cast<int>(cudaErrorInvalidValue);
  Rk45DiskScalars s;
  std::memset(&s, 0, sizeof(s));
  std::memcpy(&s, scalars, sizeof(float) * n_scalars);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kRk45DiskThreads - 1) / kRk45DiskThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Rk45DiskLaunch a{tab, static_cast<unsigned>(blocks),
                         static_cast<cudaStream_t>(stream),
                         l, psi, p_l, b, c1, c2, nz, fout, iout, n,
                         max_steps, max_iters};
  const bool v = vol != 0, bb = blackbody != 0, rs = redshift != 0,
             dop = doppler != 0, sc = scatter != 0;
  switch (kind) {
    case kEllis:
      pick_rk45_mode<kEllis>(v, bb, rs, dop, sc, s, a);
      break;
    case kInterstellar:
      pick_rk45_mode<kInterstellar>(v, bb, rs, dop, sc, s, a);
      break;
    case kFlat:
      pick_rk45_mode<kFlat>(v, bb, rs, dop, sc, s, a);
      break;
    case kSchwarzschild:
      pick_rk45_mode<kSchwarzschild>(v, bb, rs, dop, sc, s, a);
      break;
    case kReissnerNordstrom:
      pick_rk45_mode<kReissnerNordstrom>(v, bb, rs, dop, sc, s, a);
      break;
    case kTable:
      pick_rk45_mode<kTable>(v, bb, rs, dop, sc, s, a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
