// Checkpointed-recompute adjoint of the adaptive DP5(4) planar march:
// checkpoint generation and the reverse-segment backward sweep for the
// planar rk45 step family, one thread per ray (CUDA, sm_90a).
//
// Replaces the TPU kernels curvis_tpu/ops/ckpt_adjoint_pallas.py:
// _ckpt_gen_kernel (#9) and _ckpt_bwd_kernel (#10) driven by the step map
// of curvis_tpu/integrate/rk45_adjoint_planar.py (_planar_rk45_step).  The
// Python wrapper is curvis_tpu_torch/ops/ckpt_rk45_cuda.py, which also
// holds the plain PyTorch versions of both kernels and of the VJP.
//
// The family: state y = (l, psi, p_l, dt) per ray, theta = (p0, p1, p2, b)
// (the metric slots of the scalar row and the per-ray b; bwd returns each
// ray's cotangents, the caller sums the slots); for a tabulated metric
// theta = (s^2, c1[0..K], c2[0..K], b), the JAX package's order.  Ray i
// takes iters[i] iterations from y0 = (l, psi, p_l, dt0): the iterations it
// was live for in the forward march (kernel #4, planar_rk45.cu), accepted
// and rejected.
// The iteration is rk45.cuh's rk45_iter, the one #4 runs, and both files
// are built without FMA contraction (ops/_build.py), so the replay takes
// every controller decision that the forward took, bit for bit.
//
//   gen: march iters[i] iterations from y0, writing the state at the start
//        of each of the ray's segments to its rows of the compacted buffer:
//        ray i owns ceil(iters[i] / seg) rows of 4 floats from offsets[i]
//        (the exclusive prefix sum of those counts); the final state goes
//        to final[c][i].
//   bwd: for each of the ray's segments, last to first: re-march it from
//        its checkpoint keeping the start state of every iteration in a
//        per-thread array, then pull lam back through the iterations in
//        reverse with rk45_iter_vjp (rk45_vjp.cuh).
//
// What bounds it on the H100: FP32 issue and warp divergence, as the march
// kernel.  Gen is one march (~280 operations an iteration for Ellis); bwd
// re-marches it and adds the VJP, which recomputes the iteration and
// reverses the seven stages (~3x an iteration), so the pair costs ~5
// marches.  Device memory moves the checkpoint buffer once out and once in
// (16 bytes per ray per segment); the per-iteration start states live in
// per-thread local memory (4 x seg floats), and so do a table's 2 (K + 1)
// coefficient sums and its recurrences' sequences.  The design does nothing
// about divergence (no ray sorting): this is the correct, simple form.
#include <cstring>
#include "rk45_vjp.cuh"

namespace curvis {

constexpr int kCkptRk45Threads = 128;
constexpr int kCkptRk45MaxSeg = 32;   // longest segment the backward holds
constexpr int kRk45State = 4;

template <int KIND>
__global__ void __launch_bounds__(kCkptRk45Threads)
    ckpt_rk45_gen_kernel(const __grid_constant__ Rk45ScalarsOf<KIND> s,
                         const float* __restrict__ l_in,
                         const float* __restrict__ psi_in,
                         const float* __restrict__ pl_in,
                         const float* __restrict__ b_in,
                         const int* __restrict__ iters_in,
                         const long long* __restrict__ off_in,
                         float* __restrict__ ckpt,
                         float* __restrict__ final_out, long long n,
                         int seg) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float l = l_in[i], psi = psi_in[i], p_l = pl_in[i], dt = s.m.dt;
  const float b = b_in[i], b2 = b * b;
  const int iters = iters_in[i];
  float* row = ckpt + off_in[i] * kRk45State;
  int sign = 0, steps = 0;
  for (int j = 0; j < iters; j += seg) {
    row[0] = l;
    row[1] = psi;
    row[2] = p_l;
    row[3] = dt;
    row += kRk45State;
    const int k_n = min(seg, iters - j);
    for (int k = 0; k < k_n; ++k)
      rk45_iter<KIND>(s.m, s.c, b, b2, &l, &psi, &p_l, &dt, &sign, &steps);
  }
  final_out[i] = l;
  final_out[n + i] = psi;
  final_out[2 * n + i] = p_l;
  final_out[3 * n + i] = dt;
}

template <int KIND>
__global__ void __launch_bounds__(kCkptRk45Threads)
    ckpt_rk45_bwd_kernel(const __grid_constant__ Rk45ScalarsOf<KIND> s,
                         int freeze,
                         const float* __restrict__ ckpt,
                         const float* __restrict__ b_in,
                         const int* __restrict__ iters_in,
                         const long long* __restrict__ off_in,
                         const float* __restrict__ cot,
                         float* __restrict__ lam_out,
                         float* __restrict__ g_out, long long n, int seg) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float b = b_in[i], b2 = b * b;
  const int iters = iters_in[i];
  float lam[kRk45State];
#pragma unroll
  for (int c = 0; c < kRk45State; ++c) lam[c] = cot[c * n + i];
  float g[kThetaSlots<KIND>];
  for (int j = 0; j < kThetaSlots<KIND>; ++j) g[j] = 0.0f;
  float ys[kRk45State][kCkptRk45MaxSeg];
  const float* rows = ckpt + off_in[i] * kRk45State;
  const int n_seg = (iters + seg - 1) / seg;
  int sign = 0, steps = 0;
  for (int sg = n_seg - 1; sg >= 0; --sg) {
    float l = rows[sg * kRk45State], psi = rows[sg * kRk45State + 1],
          p_l = rows[sg * kRk45State + 2], dt = rows[sg * kRk45State + 3];
    const int k_n = min(seg, iters - sg * seg);
    for (int k = 0; k < k_n; ++k) {
      ys[0][k] = l;
      ys[1][k] = psi;
      ys[2][k] = p_l;
      ys[3][k] = dt;
      rk45_iter<KIND>(s.m, s.c, b, b2, &l, &psi, &p_l, &dt, &sign, &steps);
    }
    for (int k = k_n - 1; k >= 0; --k)
      rk45_iter_vjp<KIND>(s.m, s.c, freeze != 0, ys[0][k], ys[1][k],
                          ys[2][k], ys[3][k], b, b2, lam, g);
  }
#pragma unroll
  for (int c = 0; c < kRk45State; ++c) lam_out[c * n + i] = lam[c];
  if constexpr (KIND == kTable) {
    // theta order: s^2, c1[0..K], c2[0..K], b
    const int nc = s.m.tab.n;
    g_out[i] = g[0];
    for (int k = 0; k < nc; ++k) {
      g_out[(1 + k) * n + i] = g[4 + k];
      g_out[(1 + nc + k) * n + i] = g[4 + kChebCap + k];
    }
    g_out[(1 + 2 * nc) * n + i] = g[3];
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) g_out[c * n + i] = g[c];
  }
}

// Checks shared by both host entries; fills the scalars and the grid size.
int ckpt_rk45_setup(int kind, const float* scalars, int n_scalars,
                    const ChebTable* tab, long long n, int seg, int device,
                    Rk45Scalars* s, unsigned* blocks) {
  if (n_scalars != static_cast<int>(sizeof(Rk45Scalars) / sizeof(float)) ||
      !table_ok(kind, tab))
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg < 1 || seg > kCkptRk45MaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(s, scalars, sizeof(*s));
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long g = (n + kCkptRk45Threads - 1) / kCkptRk45Threads;
  if (g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(g);
  return 0;
}

}  // namespace curvis

// Host entries.  `scalars` is a host array in the layout of
// curvis::Rk45Scalars (kernel #4's row: dt0, R, p0, p1, p2, r_cap, rtol,
// atol, dt_max), and `table` the host ChebTable of a kTable launch (ignored
// otherwise).  `offsets` (int64) are each ray's first checkpoint row;
// `ckpt` holds sum_i ceil(iters[i] / seg) rows of 4 floats; `final_state`,
// `cot` and `lam` are (4, n) float buffers and `g_theta` (4, n), or
// (2 table->n + 2, n) for a table.  Each
// launches on `stream` without synchronising and returns the cudaError_t
// of the launch (0 on success).
extern "C" int curvis_ckpt_rk45_gen(int kind, const float* scalars,
                                    int n_scalars, const void* table,
                                    const float* l,
                                    const float* psi, const float* p_l,
                                    const float* b, const int* iters,
                                    const long long* offsets, float* ckpt,
                                    float* final_state, long long n, int seg,
                                    int device, void* stream) {
  using namespace curvis;
  const ChebTable* tab = static_cast<const ChebTable*>(table);
  Rk45Scalars s;
  unsigned g = 0;
  const int err = ckpt_rk45_setup(kind, scalars, n_scalars, tab, n, seg,
                                  device, &s, &g);
  if (err != 0 || n <= 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_planar_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    ckpt_rk45_gen_kernel<K><<<g, kCkptRk45Threads, 0, st>>>(
        rk45_scalars_of<K>(s, tab), l, psi, p_l, b, iters, offsets, ckpt,
        final_state, n, seg);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int curvis_ckpt_rk45_bwd(int kind, const float* scalars,
                                    int n_scalars, const void* table,
                                    int freeze,
                                    const float* ckpt, const float* b,
                                    const int* iters,
                                    const long long* offsets,
                                    const float* cot, float* lam,
                                    float* g_theta, long long n, int seg,
                                    int device, void* stream) {
  using namespace curvis;
  const ChebTable* tab = static_cast<const ChebTable*>(table);
  Rk45Scalars s;
  unsigned g = 0;
  const int err = ckpt_rk45_setup(kind, scalars, n_scalars, tab, n, seg,
                                  device, &s, &g);
  if (err != 0 || n <= 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_planar_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    ckpt_rk45_bwd_kernel<K><<<g, kCkptRk45Threads, 0, st>>>(
        rk45_scalars_of<K>(s, tab), freeze, ckpt, b, iters, offsets, cot,
        lam, g_theta, n, seg);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
