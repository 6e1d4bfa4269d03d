// Euler march of planar rays that records their first two crossings of the
// equatorial disk, one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernel curvis_tpu/ops/march_pallas.py:_disk_kernel
// (wrapper march_planar_disk_pallas).  Inputs per ray: (l, psi, p_l, b) and
// the world z-components (c1, c2) of its orbital-plane basis; outputs: the
// march state (l, psi, p_l, sign, steps) and the first two in-band crossings
// as signed (l, p_l, psi) triples (h1, h1p, h1s, h2, h2p, h2s), h1 == 0
// meaning no hit.  The Python wrapper is
// curvis_tpu_torch/ops/disk_cuda.py:march_planar_disk_cuda and the plain
// PyTorch version of this arithmetic is march_planar_disk_plain there.
//
// The step is csrc/planar.cuh:disk_step, which the checkpoint kernels'
// replay (ckpt_surface.cu) shares.  Semantics kept from the TPU kernel:
//   - (cos psi, sin psi) advance incrementally, u <- u - v du,
//     v <- v + u du, and zq = c1 u + c2 v (z / r(l), no r) detects the
//     crossing; the drift of that rotation in norm is part of the march;
//   - the crossing interpolates frac = |zq| / max(|zq| + |zq1|, 1e-30)
//     within the step; the hit coordinate l + frac (l1 - l) is SIGNED
//     (sign = sheet), psi at the hit is psi + frac du;
//   - the second hit is decided from h1 before this step's update, and the
//     hits accumulate as h += new * value (a NaN ray gets NaN hits, as on
//     the TPU);
//   - escape / capture after each step as in march_ray (planar.cuh).
//
// A tabulated metric (kTable) takes the table in the kernel's scalar
// argument (DiskScalarsT<TableScalars>, passed __grid_constant__), as
// planar_march.cu does; a step then evaluates the two series (table.cuh).
//
// What bounds it on the H100: FP32 issue and warp divergence, as the plain
// march kernel (planar_march.cu): ~14 operations per Schwarzschild Euler
// step plus ~20 for the rotation and the crossing test, over thousands of
// dependent steps; 24 bytes read and 44 written per ray.  The design does
// nothing about divergence yet: a thread leaves the loop when its ray ends.
#include <cstring>

#include "planar.cuh"

namespace curvis {

constexpr int kDiskThreads = 128;

// Host row: the march scalars, then the recording band [r_in, r_out]; a
// kTable kernel's march scalars carry the table (M = TableScalars).
template <class M>
struct DiskScalarsT {
  M m;
  float r_in;
  float r_out;
};
using DiskScalars = DiskScalarsT<MarchScalars>;

template <int KIND>
__global__ void __launch_bounds__(kDiskThreads)
    march_disk_kernel(const __grid_constant__ DiskScalarsT<ScalarsOf<KIND>> s,
                      const float* __restrict__ l_in,
                      const float* __restrict__ psi_in,
                      const float* __restrict__ pl_in,
                      const float* __restrict__ b_in,
                      const float* __restrict__ c1_in,
                      const float* __restrict__ c2_in,
                      float* __restrict__ fout, int* __restrict__ iout,
                      long long n, int max_steps) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float l = l_in[i], psi = psi_in[i], p_l = pl_in[i];
  const float b = b_in[i], c1 = c1_in[i], c2 = c2_in[i];
  const float b2 = b * b;
  float u = cosf(psi), v = sinf(psi);
  float zq = c1 * u + c2 * v;
  float h[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int sign = 0;
  int n_steps = 0;
  while (n_steps < max_steps && sign == 0) {
    bool new1, new2;
    disk_step<KIND>(s.m, s.r_in, s.r_out, b, b2, c1, c2, &l, &psi, &p_l, &u,
                    &v, &zq, h, &new1, &new2);
    ++n_steps;
    if (l > s.m.R) {
      sign = 1;
    } else if (l < -s.m.R) {
      sign = -1;
    } else if (HasCapture<KIND>::value && l < s.m.r_cap) {
      sign = 2;
    }
  }
  // fout rows: l, psi, p_l, h1, h1p, h1s, h2, h2p, h2s; iout: sign, steps
  const float row[9] = {l, psi, p_l, h[0], h[1], h[2], h[3], h[4], h[5]};
#pragma unroll
  for (int k = 0; k < 9; ++k) fout[k * n + i] = row[k];
  iout[i] = sign;
  iout[n + i] = n_steps;
}

}  // namespace curvis

// Host entry.  `scalars` is a host array of n_scalars floats in the layout
// of curvis::DiskScalars, copied into the kernel's by-value argument, and
// `table` the host ChebTable of a kTable launch (ignored otherwise), copied
// in after the march scalars.  `fout` is a (9, n) float buffer (l, psi,
// p_l, h1, h1p, h1s, h2, h2p, h2s) and `iout` a (2, n) int buffer (sign,
// steps).  Launches on `stream` without synchronising and returns the
// cudaError_t of the launch.
extern "C" int curvis_march_disk(int kind, const float* scalars,
                                 int n_scalars, const void* table,
                                 const float* l, const float* psi,
                                 const float* p_l, const float* b,
                                 const float* c1, const float* c2,
                                 float* fout, int* iout, long long n,
                                 int max_steps, int device, void* stream) {
  using namespace curvis;
  const ChebTable* tab = static_cast<const ChebTable*>(table);
  if (n_scalars != static_cast<int>(sizeof(DiskScalars) / sizeof(float)) ||
      !table_ok(kind, tab))
    return static_cast<int>(cudaErrorInvalidValue);
  DiskScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kDiskThreads - 1) / kDiskThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_planar_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    const DiskScalarsT<ScalarsOf<K>> sk{scalars_of<K>(s.m, tab), s.r_in,
                                        s.r_out};
    march_disk_kernel<K><<<g, kDiskThreads, 0, st>>>(
        sk, l, psi, p_l, b, c1, c2, fout, iout, n, max_steps);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
