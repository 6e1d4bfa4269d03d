// The kTable blackbody gas instances of the DP5(4) disk families'
// checkpoint kernels (ckpt_surface_rk45.cuh), built apart from the table's
// other instances (ckpt_surface_rk45_table.cu) so that nvcc compiles them
// in parallel; ckpt_surface_rk45.cu holds the host entries.
#include "ckpt_surface_rk45.cuh"

namespace curvis {

template void launch_surface_rk45_instance<kTable, false, true, false, false,
                                           false>(bool, const SurfRk45Call&);
template void launch_surface_rk45_instance<kTable, false, true, false, false,
                                           true>(bool, const SurfRk45Call&);

}  // namespace curvis
