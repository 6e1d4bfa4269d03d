// Fused camera ray + planar spawn + Euler march + world-direction readout,
// one thread per pixel of one camera (CUDA, sm_90a).
//
// Replaces the TPU kernel curvis_tpu/ops/render_fused.py:_fused_kernel
// (with _fused_spawn and _fused_readout; wrapper render_planar_fused,
// stepper "euler").  It writes the world escape direction (wx, wy, wz) and
// the sign of every pixel and nothing else; the two-sky texture lookup stays
// a PyTorch gather in curvis_tpu_torch/ops/render_fused.py.  The plain
// PyTorch version is render_fused.py:render_planar_fused_plain.
//
// Pixels are numbered column-major like the reference, idx = x * H + y.
//
// What bounds it on the H100: FP32 issue and warp divergence.  A pixel
// reads nothing from device memory (its camera and metric scalars arrive
// as a by-value kernel argument) and writes 16 bytes; the march is up to
// max_steps dependent Euler steps, and a warp runs until its slowest ray
// has finished.  The design does nothing about that yet: this is the
// correct, simple form.
//
// The readout keeps the reference's clamps (lapse at 1e-6, |u|^2 at 1e-30)
// and builds cos(beta), sin(beta) from sincosf(psi) and the normalised
// local direction, which equals beta = psi + atan2(u_psi, u_l) wherever
// u != 0.
#include <cstring>

#include "planar.cuh"

namespace curvis {

constexpr int kFusedThreads = 128;

// Scalars of one camera, in the order of the host row
// (ops/render_fused.py:_fused_row).
struct FusedScalars {
  MarchScalars m;             // dt, R, metric params, capture radius
  float focal, sw, sh;        // focal length, sensor width / height
  float inv_w, inv_h;         // 1 / resolution
  float rot[9];               // camera->world rotation, row-major
  float rx, ry, rz;           // launch radial direction r_hat
  float fx, fy, fz;           // theta_hat: plane normal for radial rays
  float l0;                   // camera l
  float s_pl, s_b;            // spawn scalings of p_l and b
};

template <int KIND>
__global__ void __launch_bounds__(kFusedThreads)
    render_fused_kernel(FusedScalars s, float* __restrict__ wx_out,
                        float* __restrict__ wy_out,
                        float* __restrict__ wz_out,
                        int* __restrict__ sign_out, int H, long long n,
                        int max_steps) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long xpix = idx / H;
  const long long ypix = idx - xpix * H;

  // camera ray
  const float wfrac = static_cast<float>(xpix) * s.inv_w - 0.5f;
  const float hfrac = 0.5f - static_cast<float>(ypix) * s.inv_h;
  const float vx = s.focal;
  const float vy = -s.sw * wfrac;
  const float vz = s.sh * hfrac;
  const float inv = 1.0f / sqrtf(vx * vx + vy * vy + vz * vz);
  const float vxn = vx * inv, vyn = vy * inv, vzn = vz * inv;
  const float dx = s.rot[0] * vxn + s.rot[1] * vyn + s.rot[2] * vzn;
  const float dy = s.rot[3] * vxn + s.rot[4] * vyn + s.rot[5] * vzn;
  const float dz = s.rot[6] * vxn + s.rot[7] * vyn + s.rot[8] * vzn;

  // planar spawn; the degenerate (radial) plane is gated on the computed
  // cross-product norm, not on sin(alpha)
  const float cos_a =
      fminf(fmaxf(dx * s.rx + dy * s.ry + dz * s.rz, -1.0f), 1.0f);
  float nx = s.ry * dz - s.rz * dy;
  float ny = s.rz * dx - s.rx * dz;
  float nz = s.rx * dy - s.ry * dx;
  const float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
  const float n2 = nx * nx + ny * ny + nz * nz;
  if (n2 < 1e-12f) {
    nx = s.fx;
    ny = s.fy;
    nz = s.fz;
  } else {
    const float nn = 1.0f / sqrtf(n2);
    nx *= nn;
    ny *= nn;
    nz *= nn;
  }
  const float e2x = ny * s.rz - nz * s.ry;
  const float e2y = nz * s.rx - nx * s.rz;
  const float e2z = nx * s.ry - ny * s.rx;
  float p_l = cos_a * s.s_pl;
  const float b = sin_a * s.s_b;
  float l = s.l0;
  float psi = 0.0f;

  int steps;
  const int sign = march_ray<KIND>(s.m, &l, &psi, &p_l, b, max_steps, &steps);

  // world-direction readout: w = cos(beta) r_hat + sin(beta) e2
  const float u_l = readout_u_l<KIND>(s.m, l, p_l);
  const float u_psi = b / planar_r<KIND>(s.m, l);
  const float invu = 1.0f / sqrtf(fmaxf(u_l * u_l + u_psi * u_psi, 1e-30f));
  const float cg = u_l * invu;
  const float sg = u_psi * invu;
  float sp, cp;
  sincosf(psi, &sp, &cp);
  const float cb = cp * cg - sp * sg;
  const float sb = sp * cg + cp * sg;
  wx_out[idx] = cb * s.rx + sb * e2x;
  wy_out[idx] = cb * s.ry + sb * e2y;
  wz_out[idx] = cb * s.rz + sb * e2z;
  sign_out[idx] = sign;
}

template <int KIND>
void launch_fused(unsigned blocks, cudaStream_t stream, const FusedScalars& s,
                  float* wx, float* wy, float* wz, int* sign, int H,
                  long long n, int max_steps) {
  render_fused_kernel<KIND><<<blocks, kFusedThreads, 0, stream>>>(
      s, wx, wy, wz, sign, H, n, max_steps);
}

}  // namespace curvis

// Host entry.  `scalars` is a host array of n_scalars floats in the layout
// of curvis::FusedScalars, copied into the kernel's by-value argument.  n is
// the pixel count W * H.  Launches on `stream` without synchronising and
// returns the cudaError_t of the launch (0 on success).
extern "C" int curvis_render_fused(int kind, const float* scalars,
                                   int n_scalars, float* wx, float* wy,
                                   float* wz, int* sign, int H, long long n,
                                   int max_steps, int device, void* stream) {
  using namespace curvis;
  if (n_scalars != static_cast<int>(sizeof(FusedScalars) / sizeof(float)) ||
      H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FusedScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kFusedThreads - 1) / kFusedThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kEllis:
      launch_fused<kEllis>(g, st, s, wx, wy, wz, sign, H, n, max_steps);
      break;
    case kInterstellar:
      launch_fused<kInterstellar>(g, st, s, wx, wy, wz, sign, H, n,
                                  max_steps);
      break;
    case kFlat:
      launch_fused<kFlat>(g, st, s, wx, wy, wz, sign, H, n, max_steps);
      break;
    case kSchwarzschild:
      launch_fused<kSchwarzschild>(g, st, s, wx, wy, wz, sign, H, n,
                                   max_steps);
      break;
    case kReissnerNordstrom:
      launch_fused<kReissnerNordstrom>(g, st, s, wx, wy, wz, sign, H, n,
                                       max_steps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
