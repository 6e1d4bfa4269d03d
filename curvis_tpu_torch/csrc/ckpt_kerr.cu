// Checkpointed-recompute adjoint of the fixed-step RK4 Boyer-Lindquist
// march: checkpoint generation and the reverse-segment backward sweep for
// the Kerr RK4 step family, one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernels curvis_tpu/ops/ckpt_adjoint_pallas.py:
// _ckpt_gen_kernel (#9) and _ckpt_bwd_kernel (#10) driven by the step map
// of curvis_tpu/integrate/kerr_adjoint.py (_kerr_make_step).  The Python
// wrapper is curvis_tpu_torch/ops/ckpt_kerr_cuda.py, which also holds the
// plain PyTorch versions of both kernels and of the VJP.
//
// The family: state y = (r, theta, phi, p_r, p_theta) per ray, theta = (M,
// a, q2, E, L) (the metric slots of kernel #7's row and the per-ray
// conserved E = -p_t and L = p_phi; bwd returns each ray's cotangents, the
// caller sums the metric slots).  Ray i takes steps[i] steps from its spawn
// state: the steps it took in the forward march (kernel #7, kerr.cu), or 0
// for a ray the adjoint excludes.  The step is kerr_step.cuh's
// kerr_rk4_step, the one #7 runs, and both files are built without FMA
// contraction (ops/_build.py), so the replay marches #7's trajectory bit
// for bit.
//
//   gen: march steps[i] steps, writing the state at the start of each of
//        the ray's segments to its rows of the compacted buffer: ray i owns
//        ceil(steps[i] / seg) rows of 5 floats from offsets[i] (the
//        exclusive prefix sum of those counts); the final state goes to
//        final[c][i].
//   bwd: for each of the ray's segments, last to first: re-march it from
//        its checkpoint keeping the start state of every step in a
//        per-thread array, then pull lam back through the steps in reverse
//        with kerr_rk4_vjp (kerr_vjp.cuh).
//
// What bounds it on the H100: FP32 and special-function issue, as #7.  Gen
// is one march (~390 operations a step); bwd re-marches it and adds the
// VJP, which recomputes the step's four stages and reverses four RHS of
// ~230 operations, so the pair costs ~5 marches.  Device memory moves the
// checkpoint buffer once out and once in (20 bytes per ray per segment);
// the per-step start states live in per-thread local memory (5 x seg
// floats).  Rays of a warp differ in their step counts, which the warp pays
// for; the design does nothing about it (no ray sorting): this is the
// correct, simple form.
#include "kerr_vjp.cuh"

namespace curvis {

constexpr int kCkptKerrThreads = 128;
constexpr int kCkptKerrMaxSeg = 32;   // longest segment the backward holds
constexpr int kKerrState = 5;

__global__ void __launch_bounds__(kCkptKerrThreads)
    ckpt_kerr_gen_kernel(KerrScalars s, const float* __restrict__ r_in,
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
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float y[kKerrState] = {r_in[i], th_in[i], ph_in[i], pr_in[i], pth_in[i]};
  const float E = E_in[i], L = L_in[i];
  const int steps = steps_in[i];
  float* row = ckpt + off_in[i] * kKerrState;
  for (int j = 0; j < steps; j += seg) {
#pragma unroll
    for (int c = 0; c < kKerrState; ++c) row[c] = y[c];
    row += kKerrState;
    const int k_n = min(seg, steps - j);
    for (int k = 0; k < k_n; ++k) {
      float y1[kKerrState];
      kerr_rk4_step(s, E, L, y, y1);
#pragma unroll
      for (int c = 0; c < kKerrState; ++c) y[c] = y1[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kKerrState; ++c) final_out[c * n + i] = y[c];
}

__global__ void __launch_bounds__(kCkptKerrThreads)
    ckpt_kerr_bwd_kernel(KerrScalars s, const float* __restrict__ ckpt,
                         const float* __restrict__ E_in,
                         const float* __restrict__ L_in,
                         const int* __restrict__ steps_in,
                         const long long* __restrict__ off_in,
                         const float* __restrict__ cot,
                         float* __restrict__ lam_out,
                         float* __restrict__ g_out, long long n, int seg) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float E = E_in[i], L = L_in[i];
  const int steps = steps_in[i];
  float lam[kKerrState];
#pragma unroll
  for (int c = 0; c < kKerrState; ++c) lam[c] = cot[c * n + i];
  float g[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ys[kKerrState][kCkptKerrMaxSeg];
  const float* rows = ckpt + off_in[i] * kKerrState;
  const int n_seg = (steps + seg - 1) / seg;
  for (int sg = n_seg - 1; sg >= 0; --sg) {
    float y[kKerrState];
#pragma unroll
    for (int c = 0; c < kKerrState; ++c) y[c] = rows[sg * kKerrState + c];
    const int k_n = min(seg, steps - sg * seg);
    for (int k = 0; k < k_n; ++k) {
      float y1[kKerrState];
#pragma unroll
      for (int c = 0; c < kKerrState; ++c) ys[c][k] = y[c];
      kerr_rk4_step(s, E, L, y, y1);
#pragma unroll
      for (int c = 0; c < kKerrState; ++c) y[c] = y1[c];
    }
    for (int k = k_n - 1; k >= 0; --k) {
      float yk[kKerrState];
#pragma unroll
      for (int c = 0; c < kKerrState; ++c) yk[c] = ys[c][k];
      kerr_rk4_vjp<false>(s, E, L, yk, lam, g);
    }
  }
#pragma unroll
  for (int c = 0; c < kKerrState; ++c) lam_out[c * n + i] = lam[c];
#pragma unroll
  for (int c = 0; c < 5; ++c) g_out[c * n + i] = g[c];
}

// Checks shared by both host entries; fills the scalars and the grid size.
int ckpt_kerr_setup(const float* scalars, int n_scalars, long long n,
                    int seg, int device, KerrScalars* s, unsigned* blocks) {
  if (n_scalars != kKerrBaseFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg < 1 || seg > kCkptKerrMaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  std::memset(s, 0, sizeof(*s));
  std::memcpy(s, scalars, sizeof(float) * n_scalars);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long g = (n + kCkptKerrThreads - 1) / kCkptKerrThreads;
  if (g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(g);
  return 0;
}

}  // namespace curvis

// Host entries.  `scalars` is a host array of kernel #7's bare row (10
// floats: dt, R, M, a, q2, r_cap, r_in, r_out, axis_u0, far_r0).
// `offsets` (int64) are each ray's first checkpoint row; `ckpt` holds
// sum_i ceil(steps[i] / seg) rows of 5 floats; `final_state`, `cot` and
// `lam` are (5, n) float buffers and `g_theta` (5, n) (M, a, q2, E, L).
// Each launches on `stream` without synchronising and returns the
// cudaError_t of the launch (0 on success).
extern "C" int curvis_ckpt_kerr_gen(const float* scalars, int n_scalars,
                                    const float* r, const float* th,
                                    const float* ph, const float* p_r,
                                    const float* p_th, const float* E,
                                    const float* L, const int* steps,
                                    const long long* offsets, float* ckpt,
                                    float* final_state, long long n, int seg,
                                    int device, void* stream) {
  using namespace curvis;
  KerrScalars s;
  unsigned g = 0;
  const int err = ckpt_kerr_setup(scalars, n_scalars, n, seg, device, &s, &g);
  if (err != 0 || n <= 0) return err;
  ckpt_kerr_gen_kernel<<<g, kCkptKerrThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      s, r, th, ph, p_r, p_th, E, L, steps, offsets, ckpt, final_state, n,
      seg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int curvis_ckpt_kerr_bwd(const float* scalars, int n_scalars,
                                    const float* ckpt, const float* E,
                                    const float* L, const int* steps,
                                    const long long* offsets,
                                    const float* cot, float* lam,
                                    float* g_theta, long long n, int seg,
                                    int device, void* stream) {
  using namespace curvis;
  KerrScalars s;
  unsigned g = 0;
  const int err = ckpt_kerr_setup(scalars, n_scalars, n, seg, device, &s, &g);
  if (err != 0 || n <= 0) return err;
  ckpt_kerr_bwd_kernel<<<g, kCkptKerrThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      s, ckpt, E, L, steps, offsets, cot, lam, g_theta, n, seg);
  return static_cast<int>(cudaGetLastError());
}
