// Fixed-step RK4 march of Kerr / Kerr-Newman photons in Boyer-Lindquist
// coordinates, one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernel curvis_tpu/ops/march_pallas.py:_kerr_kernel
// with its RHS _kerr_rhs and its volumetric emission _kerr_vol_emission
// (wrapper march_kerr_pallas).  State per ray: (r, theta, phi, p_r,
// p_theta) with the conserved E = -p_t and L = p_phi; seven float inputs
// and (r, theta, phi, p_r, p_theta, sign, steps) out, then either the
// first two equatorial crossings in [r_in, r_out] as (r, BL phi, approach
// side) x 2 (TRACK_DISK) or the optical depth and the three emission
// accumulators (tau, em_r, em_g, em_b) (VOL).  The Python wrapper is
// curvis_tpu_torch/ops/kerr_cuda.py:march_kerr_cuda, and the plain
// PyTorch version of this arithmetic is march_kerr_plain there.
//
// The RHS is the Hamiltonian flow of 2 Sigma H = Delta p_r^2 + p_th^2 +
// (L - a E sin^2)^2 / sin^2 - ((r^2 + a^2) E - a L)^2 / Delta written out
// by hand, with the off-shell W d(1/2 Sigma) term; Kerr-Newman enters only
// through Delta (the q^2 slot).  It and the emission live in
// kerr_common.cuh, shared with the DP5(4) march kerr_rk45.cu (#8); the RK4
// step with its crossing tracker and quadrature is kerr_step.cuh:
// kerr_rk4_surface_step, which the checkpoint kernels of the Kerr RK4
// families (ckpt_kerr.cu, ckpt_kerr_surface.cu) replay.  These files are
// built without FMA contraction (ops/_build.py:SOURCE_FLAGS), so the
// replays march this kernel's trajectory bit for bit.  The
// flags of the TPU kernel are template parameters: TRACK_DISK, VOL and,
// for VOL, BLACKBODY, BEAMING (the circular-orbit g of the frame-dragged
// gas) and SCATTER (the lensed-sky source of vol_common.cuh): 1 bare + 1
// disk + 8 volumetric instances.
//
// Semantics kept from the TPU kernel:
//   - dt scales by the polar-axis factor (sin^2 theta below ax_u0) and the
//     far-field factor (r beyond far_r0, 1e30 = off), every step;
//   - escape r > R (sign 1), capture r < r_cap (sign 2), and the blowup
//     guard: sign 3 unless |r| + |theta| + |phi| + |p_r| + |p_theta| <=
//     1e8, which NaN fails;
//   - each ray takes at most max_steps steps; a ray that has ended takes
//     none, so its state is never touched again;
//   - a hit is recorded by select, only for the first two in-band
//     crossings; the volumetric emission is evaluated at the post-step
//     state with the pre-step tau, added only when the state passed the
//     guard, and the tau_max freeze (sign 2) follows the sign update and
//     touches only rays still at sign 0;
//   - every max and clip propagates NaN, as jnp.maximum / jnp.clip do.
//
// What bounds it on the H100: FP32 and special-function issue.  An RK4
// step is four RHS of ~75 operations (three divisions and one sincos
// each) and ~40 more; the volumetric emission adds ~60-110.  A ray moves
// 28 bytes in and 48 to 68 out, so memory is far from the bound.  As the
// other march kernels, a thread leaves its loop when its ray ends.
#include "kerr_step.cuh"

namespace curvis {

constexpr int kKerrThreads = 128;

template <bool TRACK_DISK, bool VOL, bool BLACKBODY, bool BEAMING,
          bool SCATTER>
__global__ void __launch_bounds__(kKerrThreads)
    march_kerr_kernel(KerrScalars s, const float* __restrict__ rad_in,
                      const float* __restrict__ th_in,
                      const float* __restrict__ ph_in,
                      const float* __restrict__ pr_in,
                      const float* __restrict__ pth_in,
                      const float* __restrict__ E_in,
                      const float* __restrict__ L_in,
                      float* __restrict__ fout, int* __restrict__ iout,
                      long long n, int max_steps) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float y[5] = {rad_in[i], th_in[i], ph_in[i], pr_in[i], pth_in[i]};
  const float E = E_in[i], L = L_in[i];
  float ct_prev = cosf(y[1]);
  float hit[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // (r, phi, side) x 2
  float tau = 0.0f;
  float em[3] = {0.0f, 0.0f, 0.0f};
  const float b_ph = VOL ? L / E : 0.0f;
  int sign = 0;
  int n_steps = 0;
  while (n_steps < max_steps && sign == 0) {
    int slot;
    const bool ok =
        kerr_rk4_surface_step<TRACK_DISK, VOL, BLACKBODY, BEAMING, SCATTER>(
            s, E, L, b_ph, y, &ct_prev, hit, &tau, em, &slot);
    sign = ok ? static_cast<int>(y[0] > s.R) +
                    2 * static_cast<int>(y[0] < s.r_cap)
              : 3;
    // the tau_max freeze (OPAQUE_SIGN == CAPTURED == 2)
    if constexpr (VOL) {
      if (sign == 0 && tau > s.v.tau_max) sign = 2;
    }
    ++n_steps;
  }
  // fout rows: r, theta, phi, p_r, p_theta, then the six hit rows or
  // (tau, em_r, em_g, em_b); iout: sign, steps
#pragma unroll
  for (int k = 0; k < 5; ++k) fout[k * n + i] = y[k];
  if constexpr (TRACK_DISK) {
#pragma unroll
    for (int k = 0; k < 6; ++k) fout[(5 + k) * n + i] = hit[k];
  }
  if constexpr (VOL) {
    fout[5 * n + i] = tau;
#pragma unroll
    for (int c = 0; c < 3; ++c) fout[(6 + c) * n + i] = em[c];
  }
  iout[i] = sign;
  iout[n + i] = n_steps;
}

// Launch arguments of one call, bundled for the flag dispatch below.
struct KerrLaunch {
  unsigned blocks;
  cudaStream_t stream;
  const float *r, *th, *ph, *p_r, *p_th, *E, *L;
  float* fout;
  int* iout;
  long long n;
  int max_steps;
};

template <bool TRACK, bool VOL, bool BB, bool BEAM, bool SC>
void launch_kerr(const KerrScalars& s, const KerrLaunch& a) {
  march_kerr_kernel<TRACK, VOL, BB, BEAM, SC>
      <<<a.blocks, kKerrThreads, 0, a.stream>>>(s, a.r, a.th, a.ph, a.p_r,
                                                a.p_th, a.E, a.L, a.fout,
                                                a.iout, a.n, a.max_steps);
}

template <bool BB, bool BEAM>
void pick_kerr_scatter(bool sc, const KerrScalars& s, const KerrLaunch& a) {
  if (sc)
    launch_kerr<false, true, BB, BEAM, true>(s, a);
  else
    launch_kerr<false, true, BB, BEAM, false>(s, a);
}

template <bool BB>
void pick_kerr_beaming(bool beam, bool sc, const KerrScalars& s,
                       const KerrLaunch& a) {
  if (beam)
    pick_kerr_scatter<BB, true>(sc, s, a);
  else
    pick_kerr_scatter<BB, false>(sc, s, a);
}

}  // namespace curvis

// Host entry.  `scalars` is a host array of n_scalars floats in the layout
// of curvis::KerrScalars: 10 for the bare and the disk march, 20 with
// `vol`, 47 with `vol` and `scatter`.  `fout` is a (5 + 6, n) float buffer
// with `track_disk`, (5 + 4, n) with `vol`, (5, n) otherwise, and `iout` a
// (2, n) int buffer (sign, steps).  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch.
extern "C" int curvis_march_kerr(int track_disk, int vol, int scatter,
                                 int blackbody, int beaming,
                                 const float* scalars, int n_scalars,
                                 const float* r, const float* th,
                                 const float* ph, const float* p_r,
                                 const float* p_th, const float* E,
                                 const float* L, float* fout, int* iout,
                                 long long n, int max_steps, int device,
                                 void* stream) {
  using namespace curvis;
  const int want = !vol ? kKerrBaseFloats
                        : kKerrVolFloats + (scatter ? kScatterBlock : 0);
  if (n_scalars != want || (track_disk && vol) || (scatter && !vol))
    return static_cast<int>(cudaErrorInvalidValue);
  KerrScalars s;
  std::memset(&s, 0, sizeof(s));
  std::memcpy(&s, scalars, sizeof(float) * n_scalars);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kKerrThreads - 1) / kKerrThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const KerrLaunch a{static_cast<unsigned>(blocks),
                     static_cast<cudaStream_t>(stream),
                     r, th, ph, p_r, p_th, E, L, fout, iout, n, max_steps};
  if (vol) {
    if (blackbody)
      pick_kerr_beaming<true>(beaming != 0, scatter != 0, s, a);
    else
      pick_kerr_beaming<false>(beaming != 0, scatter != 0, s, a);
  } else if (track_disk) {
    launch_kerr<true, false, false, false, false>(s, a);
  } else {
    launch_kerr<false, false, false, false, false>(s, a);
  }
  return static_cast<int>(cudaGetLastError());
}
