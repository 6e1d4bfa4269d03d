// The kTable instances of the DP5(4) disk families' checkpoint kernels
// (ckpt_surface_rk45.cuh), built apart from the other kinds so that nvcc
// compiles them in parallel; ckpt_surface_rk45.cu holds the host entries.
#include "ckpt_surface_rk45.cuh"

namespace curvis {

template void launch_surface_rk45<kTable>(bool, const SurfRk45Call&);

}  // namespace curvis
