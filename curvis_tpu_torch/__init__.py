"""curvis_tpu_torch — the PyTorch / CUDA port of curvis_tpu.

The planar wormhole / static black-hole render path of ``curvis_tpu``,
written in PyTorch, with its two TPU kernels rewritten by hand in CUDA for
the H100 (``csrc/``): the Euler march (``ops/march_cuda.py``) and the fused
spawn + march + readout (``ops/render_fused.py``).  Tensors on a GPU run the
kernels; tensors on the CPU run their plain PyTorch versions.  The package
imports neither JAX nor ``curvis_tpu``.
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
from curvis_tpu_torch.camera.camera import Camera, make_camera
from curvis_tpu_torch.env.spherical_image import (
    SphericalImage,
    load_spherical_image,
    make_spherical_image,
    save_image,
)
from curvis_tpu_torch.render.fast import (render_frames_batched,
                                          render_planar_fast)
from curvis_tpu_torch.ops.render_fused import render_planar_fused

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "EllisMetric",
    "FlatSphericalMetric",
    "InterstellarMetric",
    "Metric",
    "ReissnerNordstromMetric",
    "SchwarzschildMetric",
    "SphericalImage",
    "load_spherical_image",
    "make_camera",
    "make_metric",
    "make_spherical_image",
    "render_frames_batched",
    "render_planar_fast",
    "render_planar_fused",
    "save_image",
]
