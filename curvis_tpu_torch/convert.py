"""Carry the JAX package's state across to the port.

The "weights" of a ``curvis_tpu`` scene are a metric's parameters, a
camera, sky textures with their rotation matrices and, for a starlit disk,
its starlight map (``DiskParams`` carries across as plain field values).
The functions here take them as numpy arrays (the JAX dataclass fields
after ``np.asarray``) and build the port's objects on a given device and
dtype (the current CUDA device unless ``device`` is given), so that both
packages compute on the same state.  This module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from curvis_tpu_torch.camera.camera import Camera
from curvis_tpu_torch.env.spherical_image import SphericalImage
from curvis_tpu_torch.metrics.base import (EllisMetric, FlatSphericalMetric,
                                           InterstellarMetric,
                                           ReissnerNordstromMetric,
                                           SchwarzschildMetric)
from curvis_tpu_torch.metrics.kerr import KerrMetric, KerrNewmanMetric
from curvis_tpu_torch.utils.device import resolve_device

_METRICS = {
    "ellis": EllisMetric,
    "interstellar": InterstellarMetric,
    "dneg": InterstellarMetric,
    "flat": FlatSphericalMetric,
    "schwarzschild": SchwarzschildMetric,
    "reissner-nordstrom": ReissnerNordstromMetric,
    "rn": ReissnerNordstromMetric,
    "kerr": KerrMetric,
    "kerr-newman": KerrNewmanMetric,
    "kn": KerrNewmanMetric,
}


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype,
                           device=resolve_device(device))


def metric_from_arrays(kind: str, *, device=None, dtype=torch.float32,
                       **params):
    """A port metric of ``kind`` with the given parameter arrays, e.g.
    ``metric_from_arrays("ellis", rho=np.asarray(jax_metric.rho))`` or
    ``metric_from_arrays("kerr", m=..., a=...)`` (Kerr-Newman: m, a, q)."""
    cls = _METRICS[kind.lower()]
    names = cls.fields
    if set(params) != set(names):
        raise ValueError(f"{kind} takes parameters {names}, got "
                         f"{sorted(params)}")
    if not names:
        return cls()
    device = resolve_device(device)
    return cls(*(_t(params[k], device, dtype) for k in names), device=device)


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


def starlight_map(radii, values, values_neg=None, *, device=None,
                  dtype=torch.float32):
    """A port StarlightMap from the arrays of a JAX ``StarlightMap``
    (``radii`` (n_r,), ``values`` (2, n_r, n_phi, 3), optional
    ``values_neg``), e.g. ``starlight_map(np.asarray(m.radii),
    np.asarray(m.values))`` for a one-sheet JAX map ``m``."""
    from curvis_tpu_torch.render.starlight import StarlightMap
    neg = None if values_neg is None else _t(values_neg, device, dtype)
    return StarlightMap(radii=_t(radii, device, dtype),
                        values=_t(values, device, dtype), values_neg=neg)


def disk_theta_from_arrays(d, *, device=None, dtype=torch.float32):
    """A ``disk_theta`` dict of the port from a JAX-side one, e.g.
    ``{k: np.asarray(v) for k, v in jax_theta.items()}``: each value (a
    numpy scalar, or a (3,) array for ``tint`` and ``albedo``) becomes a
    tensor of ``dtype`` on ``device``.  Set ``requires_grad`` on the values
    to differentiate the port's render with respect to them."""
    return {k: _t(v, device, dtype) for k, v in d.items()}
