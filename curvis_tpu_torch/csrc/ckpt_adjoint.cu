// Checkpointed-recompute adjoint of the planar Euler march: checkpoint
// generation and the reverse-segment backward sweep, one thread per ray
// (CUDA, sm_90a).
//
// Replaces the TPU kernels curvis_tpu/ops/ckpt_adjoint_pallas.py:
// _ckpt_gen_kernel (#9) and _ckpt_bwd_kernel (#10), for the planar Euler
// step family (Ellis, DNEG, flat, Schwarzschild, Reissner-Nordstrom).  The
// Python wrapper is curvis_tpu_torch/ops/ckpt_adjoint_cuda.py, which also
// holds the plain PyTorch versions of both kernels.
//
// Both compute the exact discrete VJP of the masked march of planar_march.cu:
// ray i takes steps[i] Euler steps from y0 and is frozen after.  The TPU grid
// marched every ray through ceil(max_steps / seg) segments in lock-step;
// here each thread loops over its own ray's ceil(steps[i] / seg) segments
// only.  The skipped steps are masked identities (d_y = lam, d_theta = 0),
// so the result is the same.
//
//   gen: march steps[i] steps from y0 with euler_step (the march kernel's
//        step), writing the state at the start of each segment s to
//        ckpt[s][c][i] (c = l, psi, p_l).  Segments at or past the ray's
//        own count are not written.
//   bwd: for each of the ray's segments, last to first: re-march the
//        segment from its checkpoint keeping the (l, p_l) start state of
//        every step in a per-thread array (psi does not enter the RHS), then
//        pull lam back through the steps in reverse with euler_step_vjp,
//        summing the cotangents of the metric slots (p0, p1, p2) and of b
//        per ray.  The caller sums the slots over rays.
//
// What bounds it on the H100: FP32 issue and warp divergence, like the march
// kernel.  Gen does one march; bwd re-marches it and adds the VJP (~3x a
// step's operations), so the pair costs ~5 marches.  Device memory moves the
// checkpoint buffer once out and once in (3 floats per ray per segment), a
// few percent of the time at seg = 32; the per-step start states live in
// per-thread local memory (2 x seg floats), which ptxas reports as stack.
// The design does nothing about divergence yet (no ray sorting): this is
// the correct, simple form.
#include <cstring>
#include <type_traits>

#include "planar.cuh"

namespace curvis {

constexpr int kCkptThreads = 128;
constexpr int kMaxSeg = 64;   // longest segment the backward can hold

template <int KIND>
__global__ void __launch_bounds__(kCkptThreads)
    ckpt_gen_kernel(MarchScalars s, const float* __restrict__ l_in,
                    const float* __restrict__ psi_in,
                    const float* __restrict__ pl_in,
                    const float* __restrict__ b_in,
                    const int* __restrict__ steps_in,
                    float* __restrict__ ckpt, long long n, int seg) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float l = l_in[i], psi = psi_in[i], p_l = pl_in[i];
  const float b = b_in[i], b2 = b * b;
  const int steps = steps_in[i];
  float* c = ckpt;
  for (int j = 0; j < steps; j += seg) {
    c[i] = l;
    c[n + i] = psi;
    c[2 * n + i] = p_l;
    c += 3 * n;
    const int k_n = min(seg, steps - j);
    for (int k = 0; k < k_n; ++k) euler_step<KIND>(s, b, b2, &l, &psi, &p_l);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kCkptThreads)
    ckpt_bwd_kernel(MarchScalars s, const float* __restrict__ ckpt,
                    const float* __restrict__ b_in,
                    const int* __restrict__ steps_in,
                    const float* __restrict__ cot_l,
                    const float* __restrict__ cot_psi,
                    const float* __restrict__ cot_pl,
                    float* __restrict__ lam_l_out,
                    float* __restrict__ lam_psi_out,
                    float* __restrict__ lam_pl_out,
                    float* __restrict__ g0_out, float* __restrict__ g1_out,
                    float* __restrict__ g2_out, float* __restrict__ gb_out,
                    long long n, int seg) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float b = b_in[i], b2 = b * b;
  const int steps = steps_in[i];
  float lam_l = cot_l[i], lam_pl = cot_pl[i];
  const float lam_psi = cot_psi[i];
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ys_l[kMaxSeg], ys_pl[kMaxSeg];
  const int n_seg = (steps + seg - 1) / seg;
  for (int sg = n_seg - 1; sg >= 0; --sg) {
    const float* c = ckpt + static_cast<long long>(sg) * 3 * n;
    float l = c[i], psi = c[n + i], p_l = c[2 * n + i];
    const int k_n = min(seg, steps - sg * seg);
    for (int k = 0; k < k_n; ++k) {
      ys_l[k] = l;
      ys_pl[k] = p_l;
      euler_step<KIND>(s, b, b2, &l, &psi, &p_l);
    }
    for (int k = k_n - 1; k >= 0; --k)
      euler_step_vjp<KIND>(s, ys_l[k], ys_pl[k], b, b2, &lam_l, lam_psi,
                           &lam_pl, g);
  }
  lam_l_out[i] = lam_l;
  lam_psi_out[i] = lam_psi;
  lam_pl_out[i] = lam_pl;
  g0_out[i] = g[0];
  g1_out[i] = g[1];
  g2_out[i] = g[2];
  gb_out[i] = g[3];
}

// Calls f(std::integral_constant<int, KIND>) for a runtime metric kind;
// false for an unknown kind.
template <typename F>
bool with_kind(int kind, F&& f) {
  switch (kind) {
    case kEllis: f(std::integral_constant<int, kEllis>{}); return true;
    case kInterstellar:
      f(std::integral_constant<int, kInterstellar>{});
      return true;
    case kFlat: f(std::integral_constant<int, kFlat>{}); return true;
    case kSchwarzschild:
      f(std::integral_constant<int, kSchwarzschild>{});
      return true;
    case kReissnerNordstrom:
      f(std::integral_constant<int, kReissnerNordstrom>{});
      return true;
    default: return false;
  }
}

// Checks shared by both host entries; fills the scalars and the grid size.
int ckpt_setup(const float* scalars, int n_scalars, long long n, int seg,
               int device, MarchScalars* s, unsigned* blocks) {
  if (n_scalars != static_cast<int>(sizeof(MarchScalars) / sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg < 1 || seg > kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(s, scalars, sizeof(*s));
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long g = (n + kCkptThreads - 1) / kCkptThreads;
  if (g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(g);
  return 0;
}

}  // namespace curvis

// Host entries.  `scalars` is a host array in the layout of
// curvis::MarchScalars (only dt and the metric slots are read).  `ckpt` is
// a (n_seg, 3, n) float32 buffer with n_seg >= ceil(max_i steps[i] / seg).
// Each launches on `stream` without synchronising and returns the
// cudaError_t of the launch (0 on success).
extern "C" int curvis_ckpt_gen(int kind, const float* scalars, int n_scalars,
                               const float* l, const float* psi,
                               const float* p_l, const float* b,
                               const int* steps, float* ckpt, long long n,
                               int seg, int device, void* stream) {
  using namespace curvis;
  MarchScalars s;
  unsigned g = 0;
  const int err = ckpt_setup(scalars, n_scalars, n, seg, device, &s, &g);
  if (err != 0 || n <= 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_kind(kind, [&](auto k) {
    ckpt_gen_kernel<decltype(k)::value><<<g, kCkptThreads, 0, st>>>(
        s, l, psi, p_l, b, steps, ckpt, n, seg);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int curvis_ckpt_bwd(int kind, const float* scalars, int n_scalars,
                               const float* ckpt, const float* b,
                               const int* steps, const float* cot_l,
                               const float* cot_psi, const float* cot_pl,
                               float* lam_l, float* lam_psi, float* lam_pl,
                               float* g0, float* g1, float* g2, float* gb,
                               long long n, int seg, int device,
                               void* stream) {
  using namespace curvis;
  MarchScalars s;
  unsigned g = 0;
  const int err = ckpt_setup(scalars, n_scalars, n, seg, device, &s, &g);
  if (err != 0 || n <= 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_kind(kind, [&](auto k) {
    ckpt_bwd_kernel<decltype(k)::value><<<g, kCkptThreads, 0, st>>>(
        s, ckpt, b, steps, cot_l, cot_psi, cot_pl, lam_l, lam_psi, lam_pl,
        g0, g1, g2, gb, n, seg);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
