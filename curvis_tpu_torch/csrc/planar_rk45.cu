// Adaptive Dormand-Prince 5(4) march of planar rays, one thread per ray
// (CUDA, sm_90a).
//
// Replaces the TPU kernel curvis_tpu/ops/march_pallas.py:_rk45_kernel,
// bare variant (track_disk = vol = False; wrapper
// march_planar_rk45_pallas).  Same inputs (l, psi, p_l, b) and the same
// six outputs (l, psi, p_l, sign, steps, iters); iters counts the
// iterations a ray was live for, accepted and rejected, which is what the
// checkpointed adjoint replays.  The plain PyTorch version is
// curvis_tpu_torch/ops/rk45_cuda.py:march_planar_rk45_plain and the Python
// wrapper march_planar_rk45_cuda.
//
// What bounds it on the H100: FP32 issue and warp divergence.  Each ray
// reads 16 bytes and writes 24, then runs its iterations: seven RHS
// evaluations, the stage sums, the 5th- and 4th-order combinations, the
// error norm and the controller (~280 FP32 operations for Ellis, with
// seven IEEE divisions, one expf and one logf; a table metric's two series
// add ~2 x 2K (Horner) or ~3 x 2K (Clenshaw) operations to each of the
// seven RHS evaluations, csrc/table.cuh).  Per-ray dt and rejects
// make a warp's lanes need different iteration counts, and a warp runs
// until its slowest lane has finished.  The design does nothing about
// either yet: this is the correct, simple form (one loop per thread, no
// ray sorting or regrouping, no fast-math).
#include <cstring>

#include "rk45.cuh"

namespace curvis {

constexpr int kRk45Threads = 128;

template <int KIND>
__global__ void __launch_bounds__(kRk45Threads)
    march_planar_rk45_kernel(const __grid_constant__ Rk45ScalarsOf<KIND> s,
                             const float* __restrict__ l_in,
                             const float* __restrict__ psi_in,
                             const float* __restrict__ pl_in,
                             const float* __restrict__ b_in,
                             float* __restrict__ l_out,
                             float* __restrict__ psi_out,
                             float* __restrict__ pl_out,
                             int* __restrict__ sign_out,
                             int* __restrict__ steps_out,
                             int* __restrict__ iters_out, long long n,
                             int max_steps, int max_iters) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float l = l_in[i], psi = psi_in[i], p_l = pl_in[i];
  int steps, iters;
  const int sign = march_ray_rk45<KIND>(s.m, s.c, &l, &psi, &p_l, b_in[i],
                                        max_steps, max_iters, &steps,
                                        &iters);
  l_out[i] = l;
  psi_out[i] = psi;
  pl_out[i] = p_l;
  sign_out[i] = sign;
  steps_out[i] = steps;
  iters_out[i] = iters;
}

}  // namespace curvis

// Host entry.  `scalars` is a host array of n_scalars floats in the layout
// of curvis::Rk45Scalars, copied into the kernel's by-value argument, and
// `table` the host ChebTable of a kTable launch (ignored otherwise).
// Launches on `stream` without synchronising and returns the cudaError_t
// of the launch (0 on success).
extern "C" int curvis_march_planar_rk45(
    int kind, const float* scalars, int n_scalars, const void* table,
    const float* l, const float* psi, const float* p_l, const float* b,
    float* l_out,
    float* psi_out, float* pl_out, int* sign_out, int* steps_out,
    int* iters_out, long long n, int max_steps, int max_iters, int device,
    void* stream) {
  using namespace curvis;
  const ChebTable* tab = static_cast<const ChebTable*>(table);
  if (n_scalars != static_cast<int>(sizeof(Rk45Scalars) / sizeof(float)) ||
      !table_ok(kind, tab))
    return static_cast<int>(cudaErrorInvalidValue);
  Rk45Scalars s;
  std::memcpy(&s, scalars, sizeof(s));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kRk45Threads - 1) / kRk45Threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_planar_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    march_planar_rk45_kernel<K><<<g, kRk45Threads, 0, st>>>(
        rk45_scalars_of<K>(s, tab), l, psi, p_l, b, l_out, psi_out, pl_out,
        sign_out, steps_out, iters_out, n, max_steps, max_iters);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
