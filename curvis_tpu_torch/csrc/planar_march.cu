// Euler march of planar rays, one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernel curvis_tpu/ops/march_pallas.py:_march_kernel
// (wrapper march_planar_pallas).  Same inputs (l, psi, p_l, b) and the same
// five outputs (l, psi, p_l, sign, steps); the plain PyTorch version is
// curvis_tpu_torch/physics/planar.py:march_planar_while and the Python
// wrapper is curvis_tpu_torch/ops/march_cuda.py:march_planar_cuda.
//
// What bounds it on the H100: FP32 issue and warp divergence.  Each ray
// reads 16 bytes and writes 20, then runs up to max_steps dependent Euler
// steps (~15-30 FP32 operations each, one or two IEEE divisions); a warp
// runs until its slowest ray has finished, so warps that mix fast outward
// rays with near-critical rays that orbit the throat waste lanes.  Device
// memory traffic is negligible.  The design does nothing about either yet:
// this is the correct, simple form (no ray sorting, no work redistribution,
// no fast-math division).
//
// A tabulated metric (kTable) evaluates its two coefficient series every
// step (table.cuh): ~8 + 2 x 2K FP32 operations for a Horner table of
// degree K, ~8 + 3 x 2K for a Clenshaw one, on top of the ~15 of the step.
//
// The per-ray loop stops exactly at max_steps, so no unroll divisor is
// needed for an exact step cap, and there is no maskless "sprint" phase: a
// thread whose ray has ended simply leaves the loop.
#include <cstring>

#include "planar.cuh"

namespace curvis {

constexpr int kMarchThreads = 128;

template <int KIND>
__global__ void __launch_bounds__(kMarchThreads)
    march_planar_kernel(const __grid_constant__ ScalarsOf<KIND> s,
                        const float* __restrict__ l_in,
                        const float* __restrict__ psi_in,
                        const float* __restrict__ pl_in,
                        const float* __restrict__ b_in,
                        float* __restrict__ l_out,
                        float* __restrict__ psi_out,
                        float* __restrict__ pl_out,
                        int* __restrict__ sign_out,
                        int* __restrict__ steps_out, long long n,
                        int max_steps) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float l = l_in[i], psi = psi_in[i], p_l = pl_in[i];
  int steps;
  const int sign =
      march_ray<KIND>(s, &l, &psi, &p_l, b_in[i], max_steps, &steps);
  l_out[i] = l;
  psi_out[i] = psi;
  pl_out[i] = p_l;
  sign_out[i] = sign;
  steps_out[i] = steps;
}

}  // namespace curvis

// Name of a cudaError_t returned by the host entries below.
extern "C" const char* curvis_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Host entry.  `scalars` is a host array of n_scalars floats in the layout
// of curvis::MarchScalars; it is copied into the kernel's by-value argument,
// so no device copy is made.  `table` is the host ChebTable of a kTable
// launch (ignored otherwise), copied into the argument after the scalars.
// Launches on `stream` without synchronising and returns the cudaError_t of
// the launch (0 on success).
extern "C" int curvis_march_planar(int kind, const float* scalars,
                                   int n_scalars, const void* table,
                                   const float* l, const float* psi,
                                   const float* p_l, const float* b,
                                   float* l_out,
                                   float* psi_out, float* pl_out,
                                   int* sign_out, int* steps_out, long long n,
                                   int max_steps, int device, void* stream) {
  using namespace curvis;
  const ChebTable* tab = static_cast<const ChebTable*>(table);
  if (n_scalars != static_cast<int>(sizeof(MarchScalars) / sizeof(float)) ||
      !table_ok(kind, tab))
    return static_cast<int>(cudaErrorInvalidValue);
  MarchScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kMarchThreads - 1) / kMarchThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_planar_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    march_planar_kernel<K><<<g, kMarchThreads, 0, st>>>(
        scalars_of<K>(s, tab), l, psi, p_l, b, l_out, psi_out, pl_out,
        sign_out, steps_out, n, max_steps);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
