// Checkpointed-recompute adjoint of the adaptive DP5(4) Boyer-Lindquist
// march: checkpoint generation and the reverse-segment backward sweep for
// the Kerr DP5(4) step family, one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernels curvis_tpu/ops/ckpt_adjoint_pallas.py:
// _ckpt_gen_kernel (#9) and _ckpt_bwd_kernel (#10) driven by the step maps
// of curvis_tpu/integrate/rk45_adjoint.py (_rk45_make_step,
// _rk45_make_step_frozen).  The Python wrapper is
// curvis_tpu_torch/ops/ckpt_kerr_cuda.py, which also holds the plain
// PyTorch versions of both kernels and of the VJP.
//
// The family: state y = (r, theta, phi, p_r, p_theta, dt) per ray, theta =
// (M, a, q2, E, L) (the metric slots of kernel #8's row and the per-ray
// E, L; bwd returns each ray's cotangents, the caller sums the metric
// slots).  Ray i takes iters[i] iterations from (its spawn state, dt0): the
// iterations it was live for in the forward march (kernel #8,
// kerr_rk45.cu), accepted and rejected, or 0 for a ray the adjoint
// excludes.  The iteration is kerr_step.cuh's kerr_rk45_iter, the one #8
// runs, and both files are built without FMA contraction (ops/_build.py),
// so the replay takes every decision that the forward took, bit for bit.
// FREEZE (freeze_controller) is a template parameter of bwd.
//
//   gen: march iters[i] iterations, writing the state at the start of each
//        of the ray's segments to its rows of the compacted buffer: ray i
//        owns ceil(iters[i] / seg) rows of 6 floats from offsets[i] (the
//        exclusive prefix sum of those counts); the final state goes to
//        final[c][i].
//   bwd: for each of the ray's segments, last to first: re-march it from
//        its checkpoint keeping the start state of every iteration in a
//        per-thread array, then pull lam back through the iterations in
//        reverse with kerr_rk45_vjp (kerr_vjp.cuh).
//
// What bounds it on the H100: FP32 and special-function issue, as #8.  Gen
// is one march (~910 operations an iteration); bwd re-marches it and adds
// the VJP, which recomputes the iteration and reverses seven RHS of ~240
// operations, so the pair costs ~5 marches.  Device memory moves the
// checkpoint buffer once out and once in (24 bytes per ray per segment);
// the per-iteration start states live in per-thread local memory (6 x seg
// floats).  Nothing is done about warp divergence: this is the correct,
// simple form.
#include "kerr_vjp.cuh"

namespace curvis {

constexpr int kCkptKerrRk45Threads = 128;
constexpr int kCkptKerrRk45MaxSeg = 32;   // longest segment bwd holds
constexpr int kKerrRk45State = 6;

__global__ void __launch_bounds__(kCkptKerrRk45Threads)
    ckpt_kerr_rk45_gen_kernel(KerrRk45Scalars s,
                              const float* __restrict__ r_in,
                              const float* __restrict__ th_in,
                              const float* __restrict__ ph_in,
                              const float* __restrict__ pr_in,
                              const float* __restrict__ pth_in,
                              const float* __restrict__ E_in,
                              const float* __restrict__ L_in,
                              const int* __restrict__ iters_in,
                              const long long* __restrict__ off_in,
                              float* __restrict__ ckpt,
                              float* __restrict__ final_out, long long n,
                              int seg) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float y[5] = {r_in[i], th_in[i], ph_in[i], pr_in[i], pth_in[i]};
  float dt = s.dt0;
  const float E = E_in[i], L = L_in[i];
  const int iters = iters_in[i];
  float* row = ckpt + off_in[i] * kKerrRk45State;
  int sign = 0, steps = 0;
  for (int j = 0; j < iters; j += seg) {
#pragma unroll
    for (int c = 0; c < 5; ++c) row[c] = y[c];
    row[5] = dt;
    row += kKerrRk45State;
    const int k_n = min(seg, iters - j);
    for (int k = 0; k < k_n; ++k)
      kerr_rk45_iter(s, E, L, y, &dt, &sign, &steps);
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) final_out[c * n + i] = y[c];
  final_out[5 * n + i] = dt;
}

template <bool FREEZE>
__global__ void __launch_bounds__(kCkptKerrRk45Threads)
    ckpt_kerr_rk45_bwd_kernel(KerrRk45Scalars s,
                              const float* __restrict__ ckpt,
                              const float* __restrict__ E_in,
                              const float* __restrict__ L_in,
                              const int* __restrict__ iters_in,
                              const long long* __restrict__ off_in,
                              const float* __restrict__ cot,
                              float* __restrict__ lam_out,
                              float* __restrict__ g_out, long long n,
                              int seg) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float E = E_in[i], L = L_in[i];
  const int iters = iters_in[i];
  float lam[kKerrRk45State];
#pragma unroll
  for (int c = 0; c < kKerrRk45State; ++c) lam[c] = cot[c * n + i];
  float g[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ys[kKerrRk45State][kCkptKerrRk45MaxSeg];
  const float* rows = ckpt + off_in[i] * kKerrRk45State;
  const int n_seg = (iters + seg - 1) / seg;
  int sign = 0, steps = 0;
  for (int sg = n_seg - 1; sg >= 0; --sg) {
    float y[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) y[c] = rows[sg * kKerrRk45State + c];
    float dt = rows[sg * kKerrRk45State + 5];
    const int k_n = min(seg, iters - sg * seg);
    for (int k = 0; k < k_n; ++k) {
#pragma unroll
      for (int c = 0; c < 5; ++c) ys[c][k] = y[c];
      ys[5][k] = dt;
      kerr_rk45_iter(s, E, L, y, &dt, &sign, &steps);
    }
    for (int k = k_n - 1; k >= 0; --k) {
      float yk[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) yk[c] = ys[c][k];
      kerr_rk45_vjp<FREEZE>(s, E, L, yk, ys[5][k], lam, g);
    }
  }
#pragma unroll
  for (int c = 0; c < kKerrRk45State; ++c) lam_out[c * n + i] = lam[c];
#pragma unroll
  for (int c = 0; c < 5; ++c) g_out[c * n + i] = g[c];
}

// Checks shared by both host entries; fills the scalars and the grid size.
int ckpt_kerr_rk45_setup(const float* scalars, int n_scalars, long long n,
                         int seg, int device, KerrRk45Scalars* s,
                         unsigned* blocks) {
  if (n_scalars != kKerrRk45BareFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg < 1 || seg > kCkptKerrRk45MaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  *s = kerr_rk45_row(scalars, n_scalars, false);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long g = (n + kCkptKerrRk45Threads - 1) / kCkptKerrRk45Threads;
  if (g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(g);
  return 0;
}

}  // namespace curvis

// Host entries.  `scalars` is a host array of kernel #8's bare row (12
// floats: dt0, R, M, a, q2, r_cap, r_in, r_out, rtol, atol, dt_max,
// dt_min).  `offsets` (int64) are each ray's first checkpoint row; `ckpt`
// holds sum_i ceil(iters[i] / seg) rows of 6 floats; `final_state`, `cot`
// and `lam` are (6, n) float buffers and `g_theta` (5, n) (M, a, q2, E,
// L).  Each launches on `stream` without synchronising and returns the
// cudaError_t of the launch (0 on success).
extern "C" int curvis_ckpt_kerr_rk45_gen(
    const float* scalars, int n_scalars, const float* r, const float* th,
    const float* ph, const float* p_r, const float* p_th, const float* E,
    const float* L, const int* iters, const long long* offsets, float* ckpt,
    float* final_state, long long n, int seg, int device, void* stream) {
  using namespace curvis;
  KerrRk45Scalars s;
  unsigned g = 0;
  const int err =
      ckpt_kerr_rk45_setup(scalars, n_scalars, n, seg, device, &s, &g);
  if (err != 0 || n <= 0) return err;
  ckpt_kerr_rk45_gen_kernel<<<g, kCkptKerrRk45Threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      s, r, th, ph, p_r, p_th, E, L, iters, offsets, ckpt, final_state, n,
      seg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int curvis_ckpt_kerr_rk45_bwd(
    const float* scalars, int n_scalars, int freeze, const float* ckpt,
    const float* E, const float* L, const int* iters,
    const long long* offsets, const float* cot, float* lam, float* g_theta,
    long long n, int seg, int device, void* stream) {
  using namespace curvis;
  KerrRk45Scalars s;
  unsigned g = 0;
  const int err =
      ckpt_kerr_rk45_setup(scalars, n_scalars, n, seg, device, &s, &g);
  if (err != 0 || n <= 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (freeze)
    ckpt_kerr_rk45_bwd_kernel<true><<<g, kCkptKerrRk45Threads, 0, st>>>(
        s, ckpt, E, L, iters, offsets, cot, lam, g_theta, n, seg);
  else
    ckpt_kerr_rk45_bwd_kernel<false><<<g, kCkptKerrRk45Threads, 0, st>>>(
        s, ckpt, E, L, iters, offsets, cot, lam, g_theta, n, seg);
  return static_cast<int>(cudaGetLastError());
}
