"""Batched 3-D rotation / spherical-coordinate utilities (PyTorch).

Counterpart of ``curvis_tpu/geometry/rotations.py``; same conventions:

  - theta in [0, pi] measured from +z; phi in [0, 2*pi) from +x toward +y.
  - An orientation is a (forward, up) pair; its rotation matrix maps the
    canonical frame (forward = +x, up = +z) onto the pair, with ``up``
    repaired to be orthogonal to ``forward``.

All rotation matrices are (..., 3, 3) acting on column vectors: w = R @ v.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-30


def _norm(v, dim=-1, keepdim=True):
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim))


def normalize(v, dim=-1):
    """Safe vector normalization (returns v/|v|, zeros stay zeros)."""
    return v / torch.clamp(_norm(v, dim=dim), min=_EPS)


def normalize_theta_phi(theta, phi):
    """Map (theta, phi) into [0, pi] x [0, 2*pi): negative theta is
    reflected with phi shifted by pi, then phi is reduced mod 2*pi."""
    neg = theta < 0.0
    theta = torch.abs(theta)
    phi = torch.where(neg, phi + math.pi, phi)
    phi = torch.remainder(phi, 2.0 * math.pi)
    return theta, phi


def vector3_from_theta_phi(theta, phi):
    """Unit vector for spherical angles; batched."""
    theta, phi = normalize_theta_phi(theta, phi)
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def theta_phi_from_vector3(v):
    """Spherical angles of a (not necessarily unit) vector."""
    r = torch.clamp(_norm(v, keepdim=False), min=_EPS)
    theta = torch.arccos(torch.clamp(v[..., 2] / r, -1.0, 1.0))
    phi = torch.atan2(v[..., 1], v[..., 0])
    return normalize_theta_phi(theta, phi)


def rotation_from_forward_up(forward, up):
    """Rotation taking the canonical frame (fwd=+x, up=+z) to (forward, up):
    columns [f_hat, normalize(up x f_hat), f_hat x normalize(up x f_hat)]."""
    f = normalize(forward)
    left = normalize(torch.linalg.cross(up, f, dim=-1))
    u = torch.linalg.cross(f, left, dim=-1)
    return torch.stack([f, left, u], dim=-1)


def orthogonal_up(forward, up):
    """The repaired up vector of an orientation."""
    f = normalize(forward)
    return torch.linalg.cross(f, normalize(torch.linalg.cross(up, f, dim=-1)),
                              dim=-1)


def _any_perpendicular(a):
    """A vector perpendicular to a (nonzero for any nonzero a): the cross
    product with the world axis least aligned with a."""
    ax = torch.abs(a)
    use_x = ax[..., 0:1] <= torch.minimum(ax[..., 1:2], ax[..., 2:3])
    use_y = (~use_x) & (ax[..., 1:2] <= ax[..., 2:3])
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device)
    e = torch.where(use_x, ex, torch.where(use_y, ey, ez))
    return torch.linalg.cross(a, e.expand_as(a), dim=-1)


def frame_matrix(theta, phi):
    """Orthonormal coordinate frame [r_hat, theta_hat, phi_hat] as columns,
    (..., 3, 3): tangent components (along increasing r, theta, phi) map
    to world space as w = F @ u."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    r_hat = torch.stack([st * cp, st * sp, ct], dim=-1)
    t_hat = torch.stack([ct * cp, ct * sp, -st], dim=-1)
    p_hat = torch.stack([-sp, cp, torch.zeros_like(sp)], dim=-1)
    return torch.stack([r_hat, t_hat, p_hat], dim=-1)
