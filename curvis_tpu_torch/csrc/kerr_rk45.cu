// Adaptive Dormand-Prince 5(4) march of Kerr / Kerr-Newman photons in
// Boyer-Lindquist coordinates, one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernel curvis_tpu/ops/march_pallas.py:_kerr_rk45_kernel
// (wrapper march_kerr_rk45_pallas).  State per ray: (r, theta, phi, p_r,
// p_theta) with the conserved E = -p_t and L = p_phi, and a per-ray step
// dt; seven float inputs and (r, theta, phi, p_r, p_theta, sign, steps)
// out, then the first two equatorial crossings in [r_in, r_out] as (r, BL
// phi, approach side) x 2 (TRACK_DISK) or (tau, em_r, em_g, em_b) (VOL),
// and last the ray's live iterations, accepted and rejected, which the
// Kerr rk45 adjoint replays.  The Python wrapper is
// curvis_tpu_torch/ops/kerr_rk45_cuda.py:march_kerr_rk45_cuda, and the
// plain PyTorch version of this arithmetic is march_kerr_rk45_plain there.
//
// The RHS and the emission are kerr_common.cuh's, shared with the RK4
// kernel kerr.cu (#7); the tableau is dp54.cuh's.  The iteration with its
// surface work is kerr_step.cuh:kerr_rk45_surface_iter (the trial, the
// fate of an accepted step, the controller and the clamps near the disk),
// which the checkpoint kernels of the Kerr DP5(4) families
// (ckpt_kerr_rk45.cu, ckpt_kerr_surface_rk45.cu) replay.  The flags are
// template parameters: TRACK_DISK, VOL and, for VOL, BLACKBODY, BEAMING
// and SCATTER: 1 bare + 1 disk + 8 volumetric instances.
//
// One iteration of a live ray, as in the TPU kernel:
//   - seven stages advance (r, theta, p_r, p_theta); the error of a
//     component is |dt (d5 - d4)| / (atol + rtol max(|y0|, |y1|)) over r,
//     theta, p_r and p_theta (phi is excluded), and a trial with err <= 1
//     is accepted (a NaN err rejects);
//   - boundary stepping: an accepted trial that lands beyond R at a
//     fraction frac = (R - r) / (r1 - r) < 0.9 of the step, and more than
//     R * 1e-3 past R, is rejected and retried with dt frac 1.05 (the
//     overshoot guard keeps a ray parked on R from over-rejecting forever);
//   - hits (TRACK_DISK) are recorded on accepted steps only, by select;
//   - an accepted step writes the trial back, escapes (sign 1) beyond R,
//     is captured (2) below r_cap, or blows up (3) unless |r| + |theta| +
//     |phi| + |p_r| + |p_theta| <= 1e8, which NaN fails; a rejected trial
//     never touches the state;
//   - VOL adds the emission at the post-step state with the pre-step tau,
//     weighted by the accepted dt, where the state passed the guard; the
//     tau_max freeze (sign 2) touches only rays still at sign 0;
//   - a reject at dt <= dt_min * 1.01 stalls (sign 3);
//   - the controller factor clip(0.9 exp(-0.2 log err), 0.2, 5) (0.2 for a
//     NaN err) sets the next dt within [dt_min, dt_max]; near the disk dt
//     is clamped: VOL to the anticipatory gas-slab bound, TRACK_DISK to
//     dt0 inside r_out + 2M;
//   - a ray stops at max_steps accepted steps (sign 0) or max_iters
//     iterations (sign 0).
// Every max, min and clip propagates NaN, as jnp.maximum / jnp.clip do.
//
// This file is built with --fmad=false (ops/_build.py:SOURCE_FLAGS): every
// multiply and add rounds on its own, as in the plain version, so the
// accept / reject decisions, which flip on the last bit near err = 1, and
// with them the step sequences are the plain version's.  With contracted
// FMAs the kernel took other step sequences on 1-2.5 % of rays; without,
// it reproduced the plain version bit for bit, at 6-15 % more time (H100
// SXM at 700 W, chip_smoke.py phase 15).
//
// What bounds it on the H100: FP32 and special-function issue.  An
// iteration is seven RHS of ~77 operations (three divisions and one sincos
// each), ~250 more for the stages, the two weighted sums, the error norm
// and the controller (an exp and a log), and the emission (~75-185) or the
// disk tracker where flagged.  A ray moves 28 bytes in and 32 to 72 out, so
// memory is far from the bound.  A thread leaves its loop when its ray
// ends; neighbouring rays near the photon ring differ ~2x in iterations,
// which the warp pays for.
#include "kerr_step.cuh"

namespace curvis {

constexpr int kKerrRk45Threads = 128;
constexpr int kKerrRk45Capped = -128;   // sign of a ray stopped at max_steps

template <bool TRACK_DISK, bool VOL, bool BLACKBODY, bool BEAMING,
          bool SCATTER>
__global__ void __launch_bounds__(kKerrRk45Threads)
    march_kerr_rk45_kernel(KerrRk45Scalars s,
                           const float* __restrict__ rad_in,
                           const float* __restrict__ th_in,
                           const float* __restrict__ ph_in,
                           const float* __restrict__ pr_in,
                           const float* __restrict__ pth_in,
                           const float* __restrict__ E_in,
                           const float* __restrict__ L_in,
                           float* __restrict__ fout, int* __restrict__ iout,
                           long long n, int max_steps, int max_iters) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float y[5] = {rad_in[i], th_in[i], ph_in[i], pr_in[i], pth_in[i]};
  const float E = E_in[i], L = L_in[i];
  float dt = s.dt0;
  float ct_prev = cosf(y[1]);
  float hit[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // (r, phi, side) x 2
  float tau = 0.0f;
  float em[3] = {0.0f, 0.0f, 0.0f};
  const float b_ph = VOL ? L / E : 0.0f;
  int sign = 0, n_steps = 0, iters = 0;
  while (sign == 0 && iters < max_iters) {
    ++iters;
    kerr_rk45_surface_iter<TRACK_DISK, VOL, BLACKBODY, BEAMING, SCATTER>(
        s, E, L, b_ph, y, &dt, &ct_prev, hit, &tau, em, &sign, &n_steps);
    if (sign == 0 && n_steps >= max_steps) sign = kKerrRk45Capped;
  }
  if (sign == kKerrRk45Capped) sign = 0;
  // fout rows: r, theta, phi, p_r, p_theta, then the six hit rows or
  // (tau, em_r, em_g, em_b); iout: sign, steps, iters
#pragma unroll
  for (int c = 0; c < 5; ++c) fout[c * n + i] = y[c];
  if constexpr (TRACK_DISK) {
#pragma unroll
    for (int c = 0; c < 6; ++c) fout[(5 + c) * n + i] = hit[c];
  }
  if constexpr (VOL) {
    fout[5 * n + i] = tau;
#pragma unroll
    for (int c = 0; c < 3; ++c) fout[(6 + c) * n + i] = em[c];
  }
  iout[i] = sign;
  iout[n + i] = n_steps;
  iout[2 * n + i] = iters;
}

// Launch arguments of one call, bundled for the flag dispatch below.
struct KerrRk45Launch {
  unsigned blocks;
  cudaStream_t stream;
  const float *r, *th, *ph, *p_r, *p_th, *E, *L;
  float* fout;
  int* iout;
  long long n;
  int max_steps;
  int max_iters;
};

template <bool TRACK, bool VOL, bool BB, bool BEAM, bool SC>
void launch_kerr_rk45(const KerrRk45Scalars& s, const KerrRk45Launch& a) {
  march_kerr_rk45_kernel<TRACK, VOL, BB, BEAM, SC>
      <<<a.blocks, kKerrRk45Threads, 0, a.stream>>>(
          s, a.r, a.th, a.ph, a.p_r, a.p_th, a.E, a.L, a.fout, a.iout, a.n,
          a.max_steps, a.max_iters);
}

template <bool BB, bool BEAM>
void pick_kerr_rk45_scatter(bool sc, const KerrRk45Scalars& s,
                            const KerrRk45Launch& a) {
  if (sc)
    launch_kerr_rk45<false, true, BB, BEAM, true>(s, a);
  else
    launch_kerr_rk45<false, true, BB, BEAM, false>(s, a);
}

template <bool BB>
void pick_kerr_rk45_beaming(bool beam, bool sc, const KerrRk45Scalars& s,
                            const KerrRk45Launch& a) {
  if (beam)
    pick_kerr_rk45_scatter<BB, true>(sc, s, a);
  else
    pick_kerr_rk45_scatter<BB, false>(sc, s, a);
}

}  // namespace curvis

// Host entry.  `scalars` is a host array of n_scalars floats in the layout
// of the JAX package's Kerr rk45 rows: 12 for the bare and the disk march,
// 20 with `vol`, 47 with `vol` and `scatter`.  `fout` is a (5 + 6, n) float
// buffer with `track_disk`, (5 + 4, n) with `vol`, (5, n) otherwise, and
// `iout` a (3, n) int buffer (sign, steps, iters).  Launches on `stream`
// without synchronising and returns the cudaError_t of the launch.
extern "C" int curvis_march_kerr_rk45(
    int track_disk, int vol, int scatter, int blackbody, int beaming,
    const float* scalars, int n_scalars, const float* r, const float* th,
    const float* ph, const float* p_r, const float* p_th, const float* E,
    const float* L, float* fout, int* iout, long long n, int max_steps,
    int max_iters, int device, void* stream) {
  using namespace curvis;
  const int want = !vol ? kKerrRk45BareFloats
                        : kKerrRk45VolFloats + (scatter ? kScatterBlock : 0);
  if (n_scalars != want || (track_disk && vol) || (scatter && !vol))
    return static_cast<int>(cudaErrorInvalidValue);
  const KerrRk45Scalars s = kerr_rk45_row(scalars, n_scalars, vol != 0);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kKerrRk45Threads - 1) / kKerrRk45Threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const KerrRk45Launch a{static_cast<unsigned>(blocks),
                         static_cast<cudaStream_t>(stream),
                         r, th, ph, p_r, p_th, E, L, fout, iout, n,
                         max_steps, max_iters};
  if (vol) {
    if (blackbody)
      pick_kerr_rk45_beaming<true>(beaming != 0, scatter != 0, s, a);
    else
      pick_kerr_rk45_beaming<false>(beaming != 0, scatter != 0, s, a);
  } else if (track_disk) {
    launch_kerr_rk45<true, false, false, false, false>(s, a);
  } else {
    launch_kerr_rk45<false, false, false, false, false>(s, a);
  }
  return static_cast<int>(cudaGetLastError());
}
