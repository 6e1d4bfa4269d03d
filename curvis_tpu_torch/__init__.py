"""curvis_tpu_torch — the PyTorch / CUDA port of curvis_tpu.

The planar wormhole / static black-hole render path of ``curvis_tpu``
(Euler and the adaptive DP5(4) quality mode) and its inverse-rendering
path, written in PyTorch, with their TPU kernels rewritten by hand in CUDA
for the H100 (``csrc/``): the Euler march (``ops/march_cuda.py``), the
adaptive march (``ops/rk45_cuda.py``), the fused spawn + march + readout
for both steppers (``ops/render_fused.py``) and the
checkpointed-recompute backward of the Euler march
(``ops/ckpt_adjoint_cuda.py``), behind ``render_direct(...,
differentiable='adjoint')`` and ``fit``; and the black-hole accretion-disk
path (``render_blackhole_disk``, ``render_disk_frames_batched``,
``compute_starlight_map``) with its disk-crossing march
(``ops/disk_cuda.py``), volumetric-transfer march (``ops/disk_vol_cuda.py``)
and, for ``stepper='rk45'``, the adaptive march with both surfaces
(``ops/rk45_disk_cuda.py``), and its Euler renders differentiable
(``differentiable='adjoint'``, ``disk_theta=``) through the surface
variants of the checkpoint kernels (``ops/ckpt_surface_cuda.py``); and
the Kerr / Kerr-Newman path
(``render_kerr``, ``render_kerr_frames_batched``, ``render_kerr_adaptive``,
``compute_kerr_starlight_map``) with its Boyer-Lindquist RK4 march
(``ops/kerr_cuda.py``) and DP5(4) march (``ops/kerr_rk45_cuda.py``,
``stepper='rk45'``); and user-defined spacetimes tabulated as
coefficient series (``TabulatedMetric``, ``tabulate_metric``,
``metrics/table.py:tabulate_metric_diff``) on the wormhole routes without
a disk.  Tensors on a GPU run the kernels;
tensors on the CPU run their plain PyTorch versions.  Factories build on
the current CUDA device unless given ``device='cpu'``.  The package imports
neither JAX nor ``curvis_tpu``.
"""

from curvis_tpu_torch.metrics.base import (
    EllisMetric,
    FlatSphericalMetric,
    InterstellarMetric,
    Metric,
    ReissnerNordstromMetric,
    SchwarzschildMetric,
    make_metric,
)
from curvis_tpu_torch.metrics.table import TabulatedMetric, tabulate_metric
from curvis_tpu_torch.camera.camera import Camera, make_camera
from curvis_tpu_torch.env.spherical_image import (
    SphericalImage,
    load_spherical_image,
    make_spherical_image,
    save_image,
)
from curvis_tpu_torch.render.fast import (render_frames_batched,
                                          render_planar_adaptive,
                                          render_planar_fast)
from curvis_tpu_torch.ops.render_fused import render_planar_fused
from curvis_tpu_torch.integrate.rk45 import (march_kerr_rk45,
                                             march_planar_rk45)
from curvis_tpu_torch.ops.rk45_cuda import march_planar_rk45_cuda
from curvis_tpu_torch.ops.rk45_disk_cuda import march_planar_rk45_disk_cuda
from curvis_tpu_torch.render.direct import render_direct
from curvis_tpu_torch.integrate.adjoint import march_planar_adjoint
from curvis_tpu_torch.fit import FitResult, fit
from curvis_tpu_torch.render.disk import (DiskParams, compute_starlight_map,
                                          render_blackhole_disk,
                                          render_disk_frames_batched)
from curvis_tpu_torch.metrics.kerr import (KerrMetric, KerrNewmanMetric,
                                           make_kerr, make_kerr_newman)
from curvis_tpu_torch.ops.kerr_cuda import march_kerr_cuda
from curvis_tpu_torch.ops.kerr_rk45_cuda import march_kerr_rk45_cuda
from curvis_tpu_torch.render.kerr import (render_kerr, render_kerr_adaptive,
                                          render_kerr_frames_batched)
from curvis_tpu_torch.render.starlight import compute_kerr_starlight_map

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "DiskParams",
    "EllisMetric",
    "FitResult",
    "FlatSphericalMetric",
    "InterstellarMetric",
    "KerrMetric",
    "KerrNewmanMetric",
    "Metric",
    "ReissnerNordstromMetric",
    "SchwarzschildMetric",
    "SphericalImage",
    "TabulatedMetric",
    "compute_kerr_starlight_map",
    "compute_starlight_map",
    "fit",
    "load_spherical_image",
    "make_camera",
    "make_kerr",
    "make_kerr_newman",
    "make_metric",
    "make_spherical_image",
    "march_kerr_cuda",
    "march_kerr_rk45",
    "march_kerr_rk45_cuda",
    "march_planar_adjoint",
    "march_planar_rk45",
    "march_planar_rk45_cuda",
    "march_planar_rk45_disk_cuda",
    "render_blackhole_disk",
    "render_direct",
    "render_disk_frames_batched",
    "render_frames_batched",
    "render_kerr",
    "render_kerr_adaptive",
    "render_kerr_frames_batched",
    "render_planar_adaptive",
    "render_planar_fast",
    "render_planar_fused",
    "save_image",
    "tabulate_metric",
]
