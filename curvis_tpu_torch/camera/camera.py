"""Pinhole camera in curved spacetime (PyTorch).

Counterpart of ``curvis_tpu/camera/camera.py``; the geometry matches the
reference camera:
  - sensor sizes from diagonal + aspect ratio;
  - per-pixel camera-space ray v = normalize(f, -sw*(x/W - 0.5), sh*(0.5 - y/H))
    (pixel corners, with an opt-in ``center_pixels`` mode in the renderers);
  - camera->world rotation from the forward/up orientation.
"""
from __future__ import annotations

import dataclasses

import torch

from curvis_tpu_torch.geometry import rotations
from curvis_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """Viewpoint: 4-position on the metric + tangent-space orientation.

    ``position``: (4,) contravariant (t, l, theta, phi).
    ``forward``/``up``: (3,) tangent-space vectors.
    ``focal_length``/``sensor_diagonal``: 0-d tensors (mm).
    """

    position: torch.Tensor
    forward: torch.Tensor
    up: torch.Tensor
    focal_length: torch.Tensor
    sensor_diagonal: torch.Tensor
    resolution_x: int
    resolution_y: int

    def __post_init__(self):
        if self.resolution_x <= 0 or self.resolution_y <= 0:
            raise ValueError("resolution must be positive")

    @property
    def device(self):
        return self.position.device


def make_camera(position, forward, up, focal_length, sensor_diagonal,
                resolution_x, resolution_y, *, device=None,
                dtype=torch.float32) -> Camera:
    """Validated constructor (focal length and diagonal must be positive),
    on the current CUDA device unless ``device`` is given."""
    if float(focal_length) <= 0:
        raise ValueError("focal_length must be > 0")
    if float(sensor_diagonal) <= 0:
        raise ValueError("sensor_diagonal must be > 0")
    device = resolve_device(device)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return Camera(position=t(position), forward=t(forward), up=t(up),
                  focal_length=t(focal_length),
                  sensor_diagonal=t(sensor_diagonal),
                  resolution_x=int(resolution_x),
                  resolution_y=int(resolution_y))


def sensor_size(camera: Camera):
    """(sensor_width, sensor_height) from diagonal + aspect."""
    aspect = camera.resolution_x / camera.resolution_y
    h = torch.sqrt(camera.sensor_diagonal ** 2 / (aspect * aspect + 1.0))
    return aspect * h, h


def camera_rotation(camera: Camera):
    """Camera->world rotation matrix (3, 3) from the forward/up pair."""
    return rotations.rotation_from_forward_up(camera.forward, camera.up)


def aberrate_directions(dx, dy, dz, velocity):
    """Special-relativistic aberration of look directions from the camera's
    comoving frame into the local static frame, SoA in/out:

        d' = [ d/gamma - beta + (gamma/(gamma+1)) (beta . d) beta ]
             / (1 - beta . d)

    Returns (dx', dy', dz', delta) with delta = gamma (1 + beta . d') the
    per-ray Doppler factor (surface brightness scales as delta^3)."""
    beta = torch.as_tensor(velocity, dtype=dx.dtype, device=dx.device)
    bx, by, bz = beta[0], beta[1], beta[2]
    b2 = bx * bx + by * by + bz * bz
    gamma = torch.rsqrt(torch.clamp(1.0 - b2, min=1e-12))
    bd = bx * dx + by * dy + bz * dz
    coef = (gamma / (gamma + 1.0)) * bd - 1.0
    inv_g = 1.0 / gamma
    inv = 1.0 / (1.0 - bd)
    nx = (dx * inv_g + coef * bx) * inv
    ny = (dy * inv_g + coef * by) * inv
    nz = (dz * inv_g + coef * bz) * inv
    delta = gamma * (1.0 + bx * nx + by * ny + bz * nz)
    return nx, ny, nz, delta
