"""Equirectangular ("360-degree") background environments (PyTorch).

Counterpart of ``curvis_tpu/env/spherical_image.py``: a texture (H, W, 3)
on the device plus the image->world rotation of its orientation.  World
directions are rotated into image space with R^T before the (theta, phi)
conversion; the lookups themselves live in ``render/fast.py``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from curvis_tpu_torch.geometry import rotations


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
    orientation (defaults: forward=+x, up=+z)."""
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
    """Load a PNG/JPEG file as a SphericalImage."""
    from PIL import Image
    with Image.open(Path(path)) as im:
        arr = np.asarray(im.convert("RGB"))
    return make_spherical_image(arr, forward=forward, up=up, device=device,
                                dtype=dtype)


def save_image(array01, path):
    """Save an (H, W, 3) float [0,1] array or tensor as PNG."""
    from PIL import Image
    t = torch.as_tensor(array01).detach().cpu()
    arr = (torch.clamp(t, 0.0, 1.0) * 255.0).numpy().astype(np.uint8)
    Image.fromarray(arr).save(str(path))
