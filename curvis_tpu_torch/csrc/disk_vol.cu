// Euler march of planar rays with per-step volumetric radiative transfer
// through a flared Gaussian gas disk, one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernel curvis_tpu/ops/march_pallas.py:_disk_vol_kernel
// with its per-step emission _vol_emission (wrapper
// march_planar_disk_volumetric_pallas).  Inputs per ray: (l, psi, p_l, b),
// the z-components (c1, c2) of the orbital-plane basis and the plane
// normal's z-component nz; outputs: (l, psi, p_l, sign, steps) and the
// optical depth tau with the three emission accumulators (em_r, em_g,
// em_b).  The Python wrapper is curvis_tpu_torch/ops/disk_vol_cuda.py:
// march_planar_disk_volumetric_cuda, and the plain PyTorch version of this
// arithmetic is march_planar_disk_volumetric_plain there.
//
// The TPU kernel's four compile-time flags are template parameters:
// BLACKBODY (Planck colours of the Shakura-Sunyaev temperature, else a
// power-law emissivity in grey), REDSHIFT and DOPPLER (the gravitational
// and the orbital shift g; they act only for the lapse kinds,
// Schwarzschild and Reissner-Nordstrom) and SCATTER (the single-scattering
// source of the lensed sky, a 27-scalar block after the emission slots).
//
// The step (vol_step) is shared with the replay of the checkpoint kernels
// (ckpt_surface.cu) and the emission (vol_emission) with the DP5(4)
// volumetric march, through planar_vol.cuh; its Planck constants, scattering source and
// colour tail with the Kerr volumetric marches through vol_common.cuh.
//
// Semantics kept from the TPU kernel:
//   - emission at the post-step state with the PRE-update tau; the
//     accumulators and tau advance by dt only while the ray is live;
//   - r from rsqrt of the shape function's 1/r^2 (r = l for the lapse
//     kinds); the Planck chromaticity from ln(e^x - 1) = x + ln(1 - e^-x);
//   - escape / capture first, then the tau_max freeze of a ray still at
//     sign 0 (sign 2: OPAQUE_SIGN == CAPTURED);
//   - every max and clip propagates NaN, as jnp.maximum / jnp.clip do.
//
// A tabulated metric (kTable) takes the table in the kernel's scalar
// argument (VolScalarsOf<kTable>, __grid_constant__); a table has no lapse,
// so it has only the instances without the shifts, as Ellis has.
//
// What bounds it on the H100: FP32 issue (an Euler step of ~14 operations
// plus ~45 of tint emission, ~75 with blackbody: 3 more exp and 3 more log)
// and warp divergence; 28 bytes read and 36 written per ray.  As the other
// march kernels, a thread leaves its loop when its ray ends.
#include <cstring>

#include "planar_vol.cuh"

namespace curvis {

constexpr int kVolThreads = 128;

template <int KIND, bool BLACKBODY, bool REDSHIFT, bool DOPPLER,
          bool SCATTER>
__global__ void __launch_bounds__(kVolThreads)
    march_disk_vol_kernel(const __grid_constant__ VolScalarsOf<KIND> s,
                          const float* __restrict__ l_in,
                          const float* __restrict__ psi_in,
                          const float* __restrict__ pl_in,
                          const float* __restrict__ b_in,
                          const float* __restrict__ c1_in,
                          const float* __restrict__ c2_in,
                          const float* __restrict__ nz_in,
                          float* __restrict__ fout, int* __restrict__ iout,
                          long long n, int max_steps) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float l = l_in[i], psi = psi_in[i], p_l = pl_in[i];
  const float b = b_in[i], c1 = c1_in[i], c2 = c2_in[i], nz = nz_in[i];
  const float b2 = b * b;
  float u = cosf(psi), v = sinf(psi);
  float tau = 0.0f;
  float em[3] = {0.0f, 0.0f, 0.0f};
  int sign = 0;
  int n_steps = 0;
  while (n_steps < max_steps && sign == 0) {
    vol_step<KIND, BLACKBODY, REDSHIFT, DOPPLER, SCATTER>(
        s, b, b2, c1, c2, nz, &l, &psi, &p_l, &u, &v, &tau, em);
    ++n_steps;
    if (l > s.m.R) {
      sign = 1;
    } else if (l < -s.m.R) {
      sign = -1;
    } else if (HasCapture<KIND>::value && l < s.m.r_cap) {
      sign = 2;
    }
    // the tau_max freeze (OPAQUE_SIGN == CAPTURED == 2) comes after
    // escape / capture
    if (sign == 0 && tau > s.v.tau_max) sign = 2;
  }
  // fout rows: l, psi, p_l, tau, em_r, em_g, em_b; iout: sign, steps
  const float row[7] = {l, psi, p_l, tau, em[0], em[1], em[2]};
#pragma unroll
  for (int k = 0; k < 7; ++k) fout[k * n + i] = row[k];
  iout[i] = sign;
  iout[n + i] = n_steps;
}

// Launch arguments of one call, bundled for the flag dispatch below.
struct VolLaunch {
  const ChebTable* tab;   // the table of a kTable launch, else null
  unsigned blocks;
  cudaStream_t stream;
  const float *l, *psi, *p_l, *b, *c1, *c2, *nz;
  float* fout;
  int* iout;
  long long n;
  int max_steps;
};

template <int KIND, bool BB, bool RS, bool DOP, bool SC>
void launch_vol(const VolScalars& s, const VolLaunch& a) {
  march_disk_vol_kernel<KIND, BB, RS, DOP, SC>
      <<<a.blocks, kVolThreads, 0, a.stream>>>(
          vol_scalars_of<KIND>(s, a.tab), a.l, a.psi, a.p_l, a.b, a.c1, a.c2,
          a.nz, a.fout, a.iout, a.n, a.max_steps);
}

template <int KIND, bool BB, bool RS, bool DOP>
void pick_scatter(bool sc, const VolScalars& s, const VolLaunch& a) {
  if (sc)
    launch_vol<KIND, BB, RS, DOP, true>(s, a);
  else
    launch_vol<KIND, BB, RS, DOP, false>(s, a);
}

template <int KIND, bool BB>
void pick_shift(bool rs, bool dop, bool sc, const VolScalars& s,
                const VolLaunch& a) {
  if constexpr (!HasCapture<KIND>::value) {
    // the shifts act only for the lapse kinds: one instance serves all
    pick_scatter<KIND, BB, false, false>(sc, s, a);
  } else if (rs && dop) {
    pick_scatter<KIND, BB, true, true>(sc, s, a);
  } else if (rs) {
    pick_scatter<KIND, BB, true, false>(sc, s, a);
  } else if (dop) {
    pick_scatter<KIND, BB, false, true>(sc, s, a);
  } else {
    pick_scatter<KIND, BB, false, false>(sc, s, a);
  }
}

template <int KIND>
void pick_flags(bool bb, bool rs, bool dop, bool sc, const VolScalars& s,
                const VolLaunch& a) {
  if (bb)
    pick_shift<KIND, true>(rs, dop, sc, s, a);
  else
    pick_shift<KIND, false>(rs, dop, sc, s, a);
}

}  // namespace curvis

// Host entry.  `scalars` is a host array of n_scalars floats in the layout
// of curvis::VolScalars: 16 without the scatter block, 16 + 27 with it
// (`scatter` must say which); `table` the host ChebTable of a kTable launch
// (ignored otherwise).  `fout` is a (7, n) float buffer (l, psi,
// p_l, tau, em_r, em_g, em_b) and `iout` a (2, n) int buffer (sign,
// steps).  Launches on `stream` without synchronising and returns the
// cudaError_t of the launch.
extern "C" int curvis_march_disk_vol(int kind, int blackbody, int redshift,
                                     int doppler, int scatter,
                                     const float* scalars, int n_scalars,
                                     const void* table, const float* l,
                                     const float* psi,
                                     const float* p_l, const float* b,
                                     const float* c1, const float* c2,
                                     const float* nz, float* fout, int* iout,
                                     long long n, int max_steps, int device,
                                     void* stream) {
  using namespace curvis;
  const int want = kVolBaseFloats + (scatter ? kScatterBlock : 0);
  static_assert(sizeof(VolScalars) ==
                    (kVolBaseFloats + kScatterBlock) * sizeof(float),
                "VolScalars is a packed row of floats");
  const ChebTable* tab = static_cast<const ChebTable*>(table);
  if (n_scalars != want || !table_ok(kind, tab))
    return static_cast<int>(cudaErrorInvalidValue);
  VolScalars s;
  std::memset(&s, 0, sizeof(s));
  std::memcpy(&s, scalars, sizeof(float) * n_scalars);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kVolThreads - 1) / kVolThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const VolLaunch a{tab, static_cast<unsigned>(blocks),
                    static_cast<cudaStream_t>(stream),
                    l, psi, p_l, b, c1, c2, nz, fout, iout, n, max_steps};
  const bool bb = blackbody != 0, rs = redshift != 0, dop = doppler != 0,
             sc = scatter != 0;
  switch (kind) {
    case kEllis:
      pick_flags<kEllis>(bb, rs, dop, sc, s, a);
      break;
    case kInterstellar:
      pick_flags<kInterstellar>(bb, rs, dop, sc, s, a);
      break;
    case kFlat:
      pick_flags<kFlat>(bb, rs, dop, sc, s, a);
      break;
    case kSchwarzschild:
      pick_flags<kSchwarzschild>(bb, rs, dop, sc, s, a);
      break;
    case kReissnerNordstrom:
      pick_flags<kReissnerNordstrom>(bb, rs, dop, sc, s, a);
      break;
    case kTable:
      pick_flags<kTable>(bb, rs, dop, sc, s, a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
