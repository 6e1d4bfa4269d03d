"""Equirectangular ("360-degree") background environments (PyTorch).

Counterpart of ``curvis_tpu/env/spherical_image.py``: a texture (H, W, 3)
on the device plus the image->world rotation of its orientation.  World
directions are rotated into image space with R^T before the (theta, phi)
conversion.  ``filter_lookup`` is the one texture lookup: ``sample`` (as
``render_direct`` uses it) and the SoA render paths of ``render/fast.py``
go through it.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from curvis_tpu_torch.geometry import rotations
from curvis_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SphericalImage:
    """Texture (H, W, 3) float in [0, 1] + world-space orientation rotation."""

    texture: torch.Tensor
    rotation: torch.Tensor        # image->world (3, 3); world->image is R.T

    @property
    def height(self) -> int:
        return self.texture.shape[0]

    @property
    def width(self) -> int:
        return self.texture.shape[1]

    @property
    def device(self):
        return self.texture.device


def make_spherical_image(texture, forward=None, up=None, *, device=None,
                         dtype=torch.float32) -> SphericalImage:
    """Build from an (H, W, 3) array (float [0,1] or uint8) and an optional
    orientation (defaults: forward=+x, up=+z), on the current CUDA device
    unless ``device`` is given."""
    device = resolve_device(device)
    if not torch.is_tensor(texture):
        texture = torch.from_numpy(np.array(texture))   # writable copy
    tex = texture.to(device)
    if tex.dtype == torch.uint8:
        tex = tex.to(dtype) / 255.0
    else:
        tex = tex.to(dtype)
    if forward is None:
        forward = [1.0, 0.0, 0.0]
    if up is None:
        up = [0.0, 0.0, 1.0]
    R = rotations.rotation_from_forward_up(
        torch.as_tensor(forward, dtype=dtype, device=tex.device),
        torch.as_tensor(up, dtype=dtype, device=tex.device))
    return SphericalImage(texture=tex, rotation=R)


def load_spherical_image(path, forward=None, up=None, *, device=None,
                         dtype=torch.float32) -> SphericalImage:
    """Load a PNG/JPEG file as a SphericalImage (on the current CUDA device
    unless ``device`` is given)."""
    device = resolve_device(device)
    from PIL import Image
    with Image.open(Path(path)) as im:
        arr = np.asarray(im.convert("RGB"))
    return make_spherical_image(arr, forward=forward, up=up, device=device,
                                dtype=dtype)


def direction_to_theta_phi(img: SphericalImage, v_world):
    """World direction (..., 3) -> (theta, phi) in image space: rotate by
    the inverse orientation (v @ R, R orthogonal), then spherical angles."""
    return rotations.theta_phi_from_vector3(v_world @ img.rotation)


def _uv_from_theta_phi(theta, phi):
    """Continuous texture coordinates in [0, 1): u = (0.5 - phi/2pi) mod 1
    (the reference's horizontal flip), v = theta/pi."""
    u = torch.remainder(0.5 - phi / (2.0 * math.pi), 1.0)
    return u, theta / math.pi


def filter_lookup(rows, base, u, v, W, H, filtering):
    """Gather from (M, 3) texture rows at per-ray page offset ``base`` +
    continuous coordinates (u, v), all (N,).  Nearest truncates; bilinear
    wraps horizontally and reflects at the poles (a row beyond a pole is
    the same row half a turn around), and is differentiable with respect to
    (u, v) through its weights."""
    if filtering == "nearest":
        xi = torch.clamp((u * W).to(torch.int64), 0, W - 1)
        yi = torch.clamp((v * H).to(torch.int64), 0, H - 1)
        return rows[base + yi * W + xi]                    # (N, 3)
    if filtering != "bilinear":
        raise ValueError(f"unknown filtering {filtering!r}")
    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wxf = (fx - x0)[:, None]
    wyf = (fy - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), W)
    x1i = torch.remainder(x0i + 1, W)

    def pole(yr):
        over = (yr < 0) | (yr > H - 1)
        yc = torch.clamp(torch.where(yr < 0, -1 - yr, 2 * H - 1 - yr),
                         0, H - 1)
        yc = torch.where(over, yc, yr)
        xs = torch.where(over, W // 2, 0)
        return yc, xs

    y0r = y0.to(torch.int64)
    y0c, xs0 = pole(y0r)
    y1c, xs1 = pole(y0r + 1)
    x0t = torch.remainder(x0i + xs0, W)
    x1t = torch.remainder(x1i + xs0, W)
    x0b = torch.remainder(x0i + xs1, W)
    x1b = torch.remainder(x1i + xs1, W)
    y0i = base + y0c * W
    y1i = base + y1c * W
    top = rows[y0i + x0t] * (1.0 - wxf) + rows[y0i + x1t] * wxf
    bot = rows[y1i + x0b] * (1.0 - wxf) + rows[y1i + x1b] * wxf
    return top * (1.0 - wyf) + bot * wyf


def sample(img: SphericalImage, v_world, *, filtering="nearest"):
    """Sky colours (..., 3) of world directions (..., 3): ``'nearest'`` or
    ``'bilinear'`` (differentiable with respect to the direction)."""
    u, v = _uv_from_theta_phi(*direction_to_theta_phi(img, v_world))
    colors = filter_lookup(img.texture.reshape(-1, 3), 0, u.reshape(-1),
                           v.reshape(-1), img.width, img.height, filtering)
    return colors.reshape(v_world.shape)


def sample_nearest(img: SphericalImage, v_world):
    return sample(img, v_world, filtering="nearest")


def sample_bilinear(img: SphericalImage, v_world):
    return sample(img, v_world, filtering="bilinear")


def save_image(array01, path):
    """Save an (H, W, 3) float [0,1] array or tensor as PNG."""
    from PIL import Image
    t = torch.as_tensor(array01).detach().cpu()
    arr = (torch.clamp(t, 0.0, 1.0) * 255.0).numpy().astype(np.uint8)
    Image.fromarray(arr).save(str(path))
