"""Direct per-pixel renderer, differentiable (PyTorch).

Counterpart of ``curvis_tpu/render/direct.py``, method ``'planar'``: every
pixel's ray is reduced to its orbital plane, marched, turned back into a
world escape direction and shaded from the two skies.  The march is chosen
by ``differentiable``:

  - ``False``: ``ops/march_cuda.py:march_planar_cuda`` (kernel #1 on CUDA,
    no gradient);
  - ``True`` or ``'scan'``: ``physics/planar.py:march_planar_scan``, plain
    autograd through the masked march, checkpointed per segment;
  - ``'adjoint'``: ``integrate/adjoint.py:march_planar_adjoint_rays``,
    kernel #1 forward and the checkpoint kernels #9/#10 backward on CUDA;
    with ``stepper='rk45'``, ``integrate/rk45_adjoint_planar.py:
    march_planar_rk45_adjoint_rays`` (``dt`` the initial step), kernel #4
    forward and the rk45 variant of #9/#10 backward on CUDA.

Every other rk45 combination raises, as it does in the JAX package: the
non-differentiable rk45 image is ``render/fast.py:render_planar_fast(
stepper='rk45')``.

Gradients reach the metric's parameters and the camera position, through
the spawn, the march, the readout and the bilinear lookup.
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.camera.camera import Camera
from curvis_tpu_torch.env.spherical_image import SphericalImage, sample
from curvis_tpu_torch.geometry.rotations import normalize
from curvis_tpu_torch.integrate.adjoint import march_planar_adjoint_rays
from curvis_tpu_torch.integrate.rk45_adjoint_planar import \
    march_planar_rk45_adjoint_rays
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops.march_cuda import march_planar_cuda
from curvis_tpu_torch.physics import planar as pl
from curvis_tpu_torch.render.fast import _pixel_dirs_soa
from curvis_tpu_torch.utils.device import common_device


def shade(bg_positive: SphericalImage, bg_negative: SphericalImage,
          directions, sign, *, filtering="nearest"):
    """Background lookup by escape sign: the positive sky for +1, the
    negative sky for -1, black for rays that did not escape."""
    pos = sample(bg_positive, directions, filtering=filtering)
    neg = sample(bg_negative, directions, filtering=filtering)
    s = sign[..., None]
    return torch.where(s == 1, pos,
                       torch.where(s == -1, neg, torch.zeros_like(pos)))


def render_direct(metric: Metric, camera: Camera,
                  bg_positive: SphericalImage, bg_negative: SphericalImage,
                  *, dt, max_steps, escape_radius, stepper="euler",
                  filtering="nearest", center_pixels=False,
                  differentiable=False, method="planar"):
    """Render an (H, W, 3) image; ``differentiable`` picks the march (see
    the module docstring).  ``method='planar'`` with the Euler stepper, or
    rk45 with ``differentiable='adjoint'``, is ported."""
    if method == "frame3d":
        raise NotImplementedError(
            "method='frame3d': the 3-D frame march is ROADMAP Queue 1 item 6")
    if method != "planar":
        raise ValueError(f"unknown method {method!r}")
    rk45 = stepper == "rk45" and differentiable == "adjoint"
    if not rk45:
        pl.check_stepper(stepper)
    common_device(metric, camera, bg_positive, bg_negative)
    d_world = torch.stack(_pixel_dirs_soa(camera, center_pixels), dim=-1)
    rays = pl.spawn_planar(metric, camera.position, d_world)
    kw = dict(dt=dt, max_steps=max_steps, escape_radius=escape_radius)
    if rk45:
        res = march_planar_rk45_adjoint_rays(
            metric, rays, dt0=dt, max_steps=max_steps,
            escape_radius=escape_radius)
    elif differentiable == "adjoint":
        res = march_planar_adjoint_rays(metric, rays, **kw)
    elif differentiable is True or differentiable == "scan":
        res = pl.march_planar_scan(metric, rays, **kw)
    elif differentiable is False:
        res = march_planar_cuda(metric, rays, **kw)
    else:
        raise ValueError(f"unknown differentiable mode {differentiable!r}")
    w = normalize(pl.planar_world_directions(metric, rays, res))
    colors = shade(bg_positive, bg_negative, w, res.sign, filtering=filtering)
    # rays are numbered column-major, index = x * H + y
    W, H = camera.resolution_x, camera.resolution_y
    return colors.reshape(W, H, 3).permute(1, 0, 2)
