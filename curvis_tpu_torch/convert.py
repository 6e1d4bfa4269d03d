"""Carry the JAX package's state across to the port.

The "weights" of a ``curvis_tpu`` scene are a metric's parameters, a camera
and sky textures with their rotation matrices.  The functions here take
them as numpy arrays (the JAX dataclass fields after ``np.asarray``) and
build the port's objects on a given device and dtype, so that both packages
compute on the same state.  This module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from curvis_tpu_torch.camera.camera import Camera
from curvis_tpu_torch.env.spherical_image import SphericalImage
from curvis_tpu_torch.metrics.base import (EllisMetric, FlatSphericalMetric,
                                           InterstellarMetric, Metric,
                                           ReissnerNordstromMetric,
                                           SchwarzschildMetric)

_METRICS = {
    "ellis": (EllisMetric, ("rho",)),
    "interstellar": (InterstellarMetric, ("m", "a", "rho")),
    "dneg": (InterstellarMetric, ("m", "a", "rho")),
    "flat": (FlatSphericalMetric, ()),
    "schwarzschild": (SchwarzschildMetric, ("m",)),
    "reissner-nordstrom": (ReissnerNordstromMetric, ("m", "q")),
    "rn": (ReissnerNordstromMetric, ("m", "q")),
}


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def metric_from_arrays(kind: str, *, device=None, dtype=torch.float32,
                       **params) -> Metric:
    """A port metric of ``kind`` with the given parameter arrays, e.g.
    ``metric_from_arrays("ellis", rho=np.asarray(jax_metric.rho))``."""
    cls, names = _METRICS[kind.lower()]
    if set(params) != set(names):
        raise ValueError(f"{kind} takes parameters {names}, got "
                         f"{sorted(params)}")
    return cls(*(_t(params[k], device, dtype) for k in names))


def camera_from_arrays(position, forward, up, focal_length, sensor_diagonal,
                       resolution_x, resolution_y, *, device=None,
                       dtype=torch.float32) -> Camera:
    return Camera(position=_t(position, device, dtype),
                  forward=_t(forward, device, dtype),
                  up=_t(up, device, dtype),
                  focal_length=_t(focal_length, device, dtype),
                  sensor_diagonal=_t(sensor_diagonal, device, dtype),
                  resolution_x=int(resolution_x),
                  resolution_y=int(resolution_y))


def spherical_image_from_arrays(texture, rotation, *, device=None,
                                dtype=torch.float32) -> SphericalImage:
    """A sky from its (H, W, 3) texture and (3, 3) image->world rotation,
    taken as they are (the rotation is not rebuilt)."""
    return SphericalImage(texture=_t(texture, device, dtype),
                          rotation=_t(rotation, device, dtype))
