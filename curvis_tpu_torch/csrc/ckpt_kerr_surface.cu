// Checkpointed-recompute adjoint of the fixed-step RK4 Boyer-Lindquist
// surface marches: checkpoint generation and the reverse-segment backward
// sweep for the Kerr thin-disk (12-state) and gas (9-state) step families,
// one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernels curvis_tpu/ops/ckpt_adjoint_pallas.py:
// _ckpt_gen_kernel (#9) and _ckpt_bwd_kernel (#10) driven by the step maps
// of curvis_tpu/integrate/kerr_surface_adjoint.py (_fixed_make_step('disk'
// | ('vol', blackbody, beaming))).  The Python wrapper is
// curvis_tpu_torch/ops/ckpt_kerr_surface_cuda.py, which also holds the
// plain PyTorch versions of both kernels and of the VJPs.
//
// Families (the state per ray, then theta, the parameters whose cotangents
// bwd returns per ray; E = -p_t and L = p_phi are per ray):
//   disk: y = (r, theta, phi, p_r, p_theta, ct_prev, h1, h1_phi, h1_side,
//         h2, h2_phi, h2_side), theta = (M, a, q2, E, L) (the band is a
//         gate);
//   gas:  y = (r, theta, phi, p_r, p_theta, tau, em_r, em_g, em_b),
//         theta = (M, a, q2, E, L, r_in, r_out, the 8 slots of VolSlots,
//         the 27 scatter scalars when SCATTER is on).
// The row is kernel #7's (ops/kerr_cuda.py:kerr_scalars: 10 floats for the
// disk, 20 or 47 for the gas), and the step is #7's own, kerr_step.cuh:
// kerr_rk4_surface_step with its crossing tracker or quadrature; both files
// are built without FMA contraction (ops/_build.py), so the replay marches
// #7's trajectory, its hits and its gas sums bit for bit.  The gas flags
// (blackbody, beaming, scatter) arrive as a bitmask and pick a templated
// instance: 1 disk + 8 gas instances of each kernel.
//
//   gen: march steps[i] steps from y0 = (the spawn state, cos theta, 0...)
//        or (the spawn state, 0...), writing the state at the start of each
//        of the ray's segments to its rows of the compacted buffer: ray i
//        owns ceil(steps[i] / seg) rows of n_state floats from offsets[i]
//        (the exclusive prefix sum of those counts); the final state goes
//        to final[c][i].
//   bwd: for each of the ray's segments, last to first: re-march it from
//        its checkpoint keeping what the VJP reads (the 5-state and ct_prev
//        or tau, and the filled hit slots as two bit masks) in per-thread
//        arrays, then pull lam back through the steps in reverse with
//        kerr_surface_vjp.cuh, summing the theta cotangents per ray.
//
// What bounds it on the H100: FP32 and special-function issue, as #7.  Gen
// is one march; bwd re-marches it and adds the VJP, which recomputes the
// step (twice for the disk: the step and its stages), reverses four
// guarded RHS of ~230 operations and, for the gas, the emission (~150-350
// more), so the pair costs ~5-6 marches.  Device memory moves the
// checkpoint buffer once out and once in (48 or 36 bytes per ray per
// segment); the per-step start states live in per-thread local memory (6 x
// seg floats).  Rays of a warp differ in their step counts, which the warp
// pays for; the design does nothing about it: this is the correct, simple
// form.
#include <cstdint>

#include "kerr_surface_vjp.cuh"

namespace curvis {

constexpr int kCkptKerrSurfThreads = 128;
constexpr int kCkptKerrSurfMaxSeg = 32;   // longest segment bwd holds
constexpr int kKerrDiskState = 12;
constexpr int kKerrVolState = 9;
constexpr int kKerrFlagBlackbody = 1, kKerrFlagBeaming = 2,
              kKerrFlagScatter = 4;

// One step of kernel #7's surface variant on the family's state y (the
// 5-state, then ct_prev and the hits, or tau and em); returns the hit
// slot written (disk) or -1.
template <bool TRACK, bool BB, bool BEAM, bool SC>
__device__ __forceinline__ int kerr_surface_step(const KerrScalars& s,
                                                 float E, float L,
                                                 float b_ph, float* y) {
  int slot;
  if constexpr (TRACK)
    kerr_rk4_surface_step<true, false, false, false, false>(
        s, E, L, b_ph, y, &y[5], y + 6, nullptr, nullptr, &slot);
  else
    kerr_rk4_surface_step<false, true, BB, BEAM, SC>(
        s, E, L, b_ph, y, nullptr, nullptr, &y[5], y + 6, &slot);
  return slot;
}

template <bool TRACK, bool BB, bool BEAM, bool SC>
__global__ void __launch_bounds__(kCkptKerrSurfThreads)
    ckpt_kerr_surface_gen_kernel(KerrScalars s, const float* __restrict__ r_in,
                                 const float* __restrict__ th_in,
                                 const float* __restrict__ ph_in,
                                 const float* __restrict__ pr_in,
                                 const float* __restrict__ pth_in,
                                 const float* __restrict__ E_in,
                                 const float* __restrict__ L_in,
                                 const int* __restrict__ steps_in,
                                 const long long* __restrict__ off_in,
                                 float* __restrict__ ckpt,
                                 float* __restrict__ final_out, long long n,
                                 int seg) {
  constexpr int NS = TRACK ? kKerrDiskState : kKerrVolState;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float y[NS];
  y[0] = r_in[i];
  y[1] = th_in[i];
  y[2] = ph_in[i];
  y[3] = pr_in[i];
  y[4] = pth_in[i];
#pragma unroll
  for (int c = 5; c < NS; ++c) y[c] = 0.0f;
  if constexpr (TRACK) y[5] = cosf(y[1]);
  const float E = E_in[i], L = L_in[i];
  const float b_ph = TRACK ? 0.0f : L / E;
  const int steps = steps_in[i];
  float* row = ckpt + off_in[i] * NS;
  for (int j = 0; j < steps; j += seg) {
#pragma unroll
    for (int c = 0; c < NS; ++c) row[c] = y[c];
    row += NS;
    const int k_n = min(seg, steps - j);
    for (int k = 0; k < k_n; ++k)
      kerr_surface_step<TRACK, BB, BEAM, SC>(s, E, L, b_ph, y);
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) final_out[c * n + i] = y[c];
}

template <bool TRACK, bool BB, bool BEAM, bool SC>
__global__ void __launch_bounds__(kCkptKerrSurfThreads)
    ckpt_kerr_surface_bwd_kernel(KerrScalars s, const float* __restrict__ ckpt,
                                 const float* __restrict__ E_in,
                                 const float* __restrict__ L_in,
                                 const int* __restrict__ steps_in,
                                 const long long* __restrict__ off_in,
                                 const float* __restrict__ cot,
                                 float* __restrict__ lam_out,
                                 float* __restrict__ g_out, long long n,
                                 int seg) {
  constexpr int NS = TRACK ? kKerrDiskState : kKerrVolState;
  constexpr int NT =
      TRACK ? kKerrDiskTheta : kKerrVolTheta + (SC ? kScatterBlock : 0);
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float E = E_in[i], L = L_in[i];
  const float b_ph = TRACK ? 0.0f : L / E;
  const int steps = steps_in[i];
  float lam[NS];
#pragma unroll
  for (int c = 0; c < NS; ++c) lam[c] = cot[c * n + i];
  float g[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) g[k] = 0.0f;
  // each step's start: the 5-state, then ct_prev (disk) or tau (gas)
  float ys[6][kCkptKerrSurfMaxSeg];
  const float* rows = ckpt + off_in[i] * NS;
  const int n_seg = (steps + seg - 1) / seg;
  for (int sg = n_seg - 1; sg >= 0; --sg) {
    float y[NS];
#pragma unroll
    for (int c = 0; c < NS; ++c) y[c] = rows[sg * NS + c];
    const int k_n = min(seg, steps - sg * seg);
    uint32_t m1 = 0, m2 = 0;
    for (int k = 0; k < k_n; ++k) {
#pragma unroll
      for (int c = 0; c < 6; ++c) ys[c][k] = y[c];
      const int slot = kerr_surface_step<TRACK, BB, BEAM, SC>(s, E, L, b_ph,
                                                              y);
      m1 |= static_cast<uint32_t>(slot == 0) << k;
      m2 |= static_cast<uint32_t>(slot == 3) << k;
    }
    for (int k = k_n - 1; k >= 0; --k) {
      float yk[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) yk[c] = ys[c][k];
      if constexpr (TRACK) {
        const int slot = ((m1 >> k) & 1) ? 0 : (((m2 >> k) & 1) ? 3 : -1);
        kerr_rk4_disk_vjp(s, E, L, yk, ys[5][k], slot, lam, g);
      } else {
        kerr_rk4_vol_vjp<BB, BEAM, SC>(s, E, L, b_ph, yk, ys[5][k], lam, g);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) lam_out[c * n + i] = lam[c];
#pragma unroll
  for (int k = 0; k < NT; ++k) g_out[k * n + i] = g[k];
}

// The arguments of one launch of either kernel.
struct KerrSurfCall {
  KerrScalars s;
  int seg;
  unsigned blocks;
  cudaStream_t stream;
  const float *r, *th, *ph, *p_r, *p_th, *E, *L, *ckpt_in, *cot;
  const int* steps;
  const long long* offsets;
  float *ckpt_out, *final_state, *lam, *g_theta;
  long long n;
};

template <bool TRACK, bool BB, bool BEAM, bool SC>
void launch_kerr_surface_instance(bool bwd, const KerrSurfCall& a) {
  if (bwd)
    ckpt_kerr_surface_bwd_kernel<TRACK, BB, BEAM, SC>
        <<<a.blocks, kCkptKerrSurfThreads, 0, a.stream>>>(
            a.s, a.ckpt_in, a.E, a.L, a.steps, a.offsets, a.cot, a.lam,
            a.g_theta, a.n, a.seg);
  else
    ckpt_kerr_surface_gen_kernel<TRACK, BB, BEAM, SC>
        <<<a.blocks, kCkptKerrSurfThreads, 0, a.stream>>>(
            a.s, a.r, a.th, a.ph, a.p_r, a.p_th, a.E, a.L, a.steps,
            a.offsets, a.ckpt_out, a.final_state, a.n, a.seg);
}

template <bool BB, bool BEAM>
void pick_kerr_surface_scatter(bool bwd, int flags, const KerrSurfCall& a) {
  if (flags & kKerrFlagScatter)
    launch_kerr_surface_instance<false, BB, BEAM, true>(bwd, a);
  else
    launch_kerr_surface_instance<false, BB, BEAM, false>(bwd, a);
}

template <bool BB>
void pick_kerr_surface_beaming(bool bwd, int flags, const KerrSurfCall& a) {
  if (flags & kKerrFlagBeaming)
    pick_kerr_surface_scatter<BB, true>(bwd, flags, a);
  else
    pick_kerr_surface_scatter<BB, false>(bwd, flags, a);
}

// Checks shared by both host entries; fills the row and the grid size.
int kerr_surface_setup(int vol, int flags, const float* scalars,
                       int n_scalars, long long n, int seg, int device,
                       KerrSurfCall* a) {
  const int want = !vol ? kKerrBaseFloats
                        : kKerrVolFloats +
                              ((flags & kKerrFlagScatter) ? kScatterBlock
                                                          : 0);
  if (n_scalars != want || (!vol && flags != 0) || flags < 0 || flags > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg < 1 || seg > kCkptKerrSurfMaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  std::memset(&a->s, 0, sizeof(a->s));
  std::memcpy(&a->s, scalars, sizeof(float) * n_scalars);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long g = (n + kCkptKerrSurfThreads - 1) / kCkptKerrSurfThreads;
  if (g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a->blocks = static_cast<unsigned>(g);
  a->seg = seg;
  a->n = n;
  return 0;
}

void launch_kerr_surface(bool bwd, int vol, int flags,
                         const KerrSurfCall& a) {
  if (!vol)
    launch_kerr_surface_instance<true, false, false, false>(bwd, a);
  else if (flags & kKerrFlagBlackbody)
    pick_kerr_surface_beaming<true>(bwd, flags, a);
  else
    pick_kerr_surface_beaming<false>(bwd, flags, a);
}

}  // namespace curvis

// Host entries.  `vol` picks the gas family (else the disk), `flags` its
// bitmask (1 blackbody, 2 beaming, 4 scatter); `scalars` is a host array
// of kernel #7's row (10 floats for the disk, 20 for the gas, 47 with the
// scatter block).  `offsets` (int64) are each ray's first checkpoint row;
// `ckpt` holds sum_i ceil(steps[i] / seg) rows of n_state floats (12 or
// 9); `final_state`, `cot` and `lam` are (n_state, n) float buffers and
// `g_theta` (n_theta, n) (5 for the disk; 15 for the gas, 42 with the
// scatter block).  Each launches on `stream` without synchronising and
// returns the cudaError_t of the launch (0 on success).
extern "C" int curvis_ckpt_kerr_surface_gen(
    int vol, int flags, const float* scalars, int n_scalars, const float* r,
    const float* th, const float* ph, const float* p_r, const float* p_th,
    const float* E, const float* L, const int* steps,
    const long long* offsets, float* ckpt, float* final_state, long long n,
    int seg, int device, void* stream) {
  using namespace curvis;
  KerrSurfCall a;
  std::memset(&a, 0, sizeof(a));
  const int err = kerr_surface_setup(vol, flags, scalars, n_scalars, n, seg,
                                     device, &a);
  if (err != 0 || n <= 0) return err;
  a.stream = static_cast<cudaStream_t>(stream);
  a.r = r;
  a.th = th;
  a.ph = ph;
  a.p_r = p_r;
  a.p_th = p_th;
  a.E = E;
  a.L = L;
  a.steps = steps;
  a.offsets = offsets;
  a.ckpt_out = ckpt;
  a.final_state = final_state;
  launch_kerr_surface(false, vol, flags, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int curvis_ckpt_kerr_surface_bwd(
    int vol, int flags, const float* scalars, int n_scalars,
    const float* ckpt, const float* E, const float* L, const int* steps,
    const long long* offsets, const float* cot, float* lam, float* g_theta,
    long long n, int seg, int device, void* stream) {
  using namespace curvis;
  KerrSurfCall a;
  std::memset(&a, 0, sizeof(a));
  const int err = kerr_surface_setup(vol, flags, scalars, n_scalars, n, seg,
                                     device, &a);
  if (err != 0 || n <= 0) return err;
  a.stream = static_cast<cudaStream_t>(stream);
  a.ckpt_in = ckpt;
  a.E = E;
  a.L = L;
  a.steps = steps;
  a.offsets = offsets;
  a.cot = cot;
  a.lam = lam;
  a.g_theta = g_theta;
  launch_kerr_surface(true, vol, flags, a);
  return static_cast<int>(cudaGetLastError());
}
