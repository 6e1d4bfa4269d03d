"""Reduced planar geodesic system (PyTorch).

Counterpart of ``curvis_tpu/physics/planar.py``.  In a spherically symmetric
spacetime every null geodesic stays in the plane through the origin spanned
by its initial position and direction, so each photon is integrated in its
own plane with the 2-D state

    state  = (l, psi, p_l)        psi: in-plane angle from the launch radius
    const  = b = p_psi            (conserved angular momentum)

    dl/dlam   = p_l
    dpsi/dlam = b / r(l)^2
    dp_l/dlam = b^2 r'(l) / r(l)^3

(static metrics with a lapse A != 1 use the general form in ``planar_rhs``).
``march_planar_while`` is the plain version of the CUDA march kernel
(``ops/march_cuda.py``); ``march_planar_scan`` is the same march under
plain autograd, checkpointed per segment; the escape direction is rebuilt
afterwards as w = cos(beta) r_hat + sin(beta) e2.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from curvis_tpu_torch.geometry.rotations import (_any_perpendicular,
                                                 normalize,
                                                 vector3_from_theta_phi)
from curvis_tpu_torch.metrics.base import Metric


class PlanarRays(NamedTuple):
    """A bundle of rays, each reduced to its own orbital plane."""
    l: torch.Tensor        # (...,) radial coordinate
    psi: torch.Tensor      # (...,) in-plane angle from the launch radius
    p_l: torch.Tensor      # (...,) radial covariant momentum
    b: torch.Tensor        # (...,) conserved angular momentum (p_psi)
    r_hat: torch.Tensor    # (..., 3) world launch radial direction (e1)
    e2: torch.Tensor       # (..., 3) in-plane transverse basis, e2 = n x e1


class PlanarResult(NamedTuple):
    l: torch.Tensor
    psi: torch.Tensor
    p_l: torch.Tensor
    sign: torch.Tensor     # int32: +1 / -1 escaped, 2 captured, 0 still marching
    steps: torch.Tensor    # int32


CAPTURED = 2      # PlanarResult.sign value for captured (shadow) rays

# The plain march tests for global termination every this many steps: on a
# GPU each test is a device->host sync; the steps in between are masked, so
# the result does not depend on it.
_CHECK_EVERY = 32


def _unit_lapse(metric) -> bool:
    """True for the reference's metric family (g00 = -1, g11 = 1)."""
    return getattr(metric, "unit_lapse", True)


def _capture_radius(metric):
    """Radius below which a photon is captured; None without capture."""
    return getattr(metric, "capture_radius", None)


def spawn_planar(metric: Metric, camera_position, directions_world) -> PlanarRays:
    """Decompose world ray directions into per-ray orbital planes.

    ``camera_position``: (4,) contravariant (t, l, theta, phi).
    ``directions_world``: (..., 3) unit world directions.
    p_l = cos(alpha), b = sin(alpha) r(l0) (static-observer tetrad scaling
    for metrics with a lapse); radial rays get an arbitrary plane (b = 0).
    """
    l0 = camera_position[..., 1]
    r_hat = vector3_from_theta_phi(camera_position[..., 2],
                                   camera_position[..., 3])
    r_hat = r_hat.expand(directions_world.shape)
    d = normalize(directions_world)
    cos_a = torch.clamp(torch.sum(d * r_hat, dim=-1), -1.0, 1.0)
    n = torch.linalg.cross(r_hat, d, dim=-1)          # |n| = sin(alpha)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    # gate the degenerate plane on the computed cross norm, not on sin_a
    n2 = torch.sum(n * n, dim=-1)
    n_safe = torch.where((n2 < 1e-12)[..., None], _any_perpendicular(r_hat),
                         n)
    n_hat = normalize(n_safe)
    e2 = torch.linalg.cross(n_hat, r_hat, dim=-1)
    r0 = metric.r(l0)
    shape = d.shape[:-1]
    p_l = cos_a
    b = sin_a * r0
    if not _unit_lapse(metric):
        A0 = metric.lapse(l0)
        B0 = metric.radial_B(l0)
        p_l = cos_a * torch.sqrt(B0 / A0)
        b = b / torch.sqrt(A0)
    return PlanarRays(l=l0.expand(shape), psi=torch.zeros_like(cos_a),
                      p_l=p_l, b=b, r_hat=r_hat, e2=e2)


def planar_rhs(metric: Metric, l, psi, p_l, b):
    r2 = metric.r_squared(l)
    r = metric.r(l)
    if _unit_lapse(metric):
        dl = p_l
        dpsi = b / r2
        dp_l = (b * b) * metric.r_derivative(l) / (r2 * r)
        return dl, dpsi, dp_l
    # general static metric with B = 1/A, E = p_t = 1:
    #   dl = A p_l,  dp_l = -A'/2 (1/A^2 + p_l^2) + b^2 r'/r^3
    A = metric.lapse(l)
    Ap = metric.lapse_deriv(l)
    dl = A * p_l
    dpsi = b / r2
    dp_l = (-0.5 * Ap * (1.0 / (A * A) + p_l * p_l)
            + (b * b) * metric.r_derivative(l) / (r2 * r))
    return dl, dpsi, dp_l


def planar_euler_step(metric: Metric, l, psi, p_l, b, dt):
    dl, dpsi, dp_l = planar_rhs(metric, l, psi, p_l, b)
    return l + dt * dl, psi + dt * dpsi, p_l + dt * dp_l


# Where each stepper that a route may not run is still to come.
_STEPPER_ITEMS = {
    "rk4": "the planar RK4 stepper is ROADMAP Queue 1 item 7",
    "rk45": "rk45 runs in the render routes (render_planar_fast, "
            "render_frames_batched, render_planar_adaptive, "
            "render_planar_fused), which give the non-differentiable rk45 "
            "image (render_planar_fast(stepper='rk45')); its gradients "
            "come from render_direct(stepper='rk45', "
            "differentiable='adjoint'), as in the JAX package",
}


def check_stepper(stepper, ported=("euler",)):
    """Raise NotImplementedError for a stepper outside ``ported``, the
    steppers that the calling route runs."""
    if stepper not in ported:
        why = _STEPPER_ITEMS.get(stepper, f"unknown stepper {stepper!r}")
        raise NotImplementedError(
            f"stepper {stepper!r} on this route (it runs "
            f"{', '.join(ported)}): {why}")


def march_planar_while(metric: Metric, rays: PlanarRays, *, dt, max_steps,
                       escape_radius, stepper="euler") -> PlanarResult:
    """Masked Euler march with global early exit: after each step a ray
    escapes on strict l > R (+1) or l < -R (-1), or is captured below the
    capture radius (2); a ray still marching at ``max_steps`` keeps 0."""
    check_stepper(stepper)
    l, psi, p_l, b = rays.l, rays.psi, rays.p_l, rays.b
    dt = torch.as_tensor(dt, dtype=l.dtype, device=l.device)
    R = escape_radius
    r_cap = _capture_radius(metric)
    sign = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        l1, psi1, pl1 = planar_euler_step(metric, l, psi, p_l, b, dt)
        l = torch.where(active, l1, l)
        psi = torch.where(active, psi1, psi)
        p_l = torch.where(active, pl1, p_l)
        sign = torch.where(active & (l > R), 1,
                           torch.where(active & (l < -R), -1, sign))
        if r_cap is not None:
            sign = torch.where(active & (l < r_cap), CAPTURED, sign)
        steps = steps + active.to(torch.int32)
    return PlanarResult(l, psi, p_l, sign.to(torch.int32), steps)


def march_planar_scan(metric: Metric, rays: PlanarRays, *, dt, max_steps,
                      escape_radius, stepper="euler") -> PlanarResult:
    """Differentiable masked Euler march with the result of
    march_planar_while, under plain autograd: each segment of
    ~sqrt(max_steps) steps runs under ``torch.utils.checkpoint``,
    so the graph holds the segment starts and recomputes one segment at a
    time in the backward pass.  Gradients reach the metric's parameters and
    the rays' (l, psi, p_l, b).  Marching stops at the first segment start
    with no ray left: every later step would be masked (the identity)."""
    check_stepper(stepper)
    l, psi, p_l, b = rays.l, rays.psi, rays.p_l, rays.b
    dt = torch.as_tensor(dt, dtype=l.dtype, device=l.device)
    segment = max(1, int(math.sqrt(max_steps)))
    R = escape_radius
    r_cap = _capture_radius(metric)

    def run(n, l, psi, p_l, sign, steps):
        for _ in range(n):
            active = sign == 0
            l1, psi1, pl1 = planar_euler_step(metric, l, psi, p_l, b, dt)
            l = torch.where(active, l1, l)
            psi = torch.where(active, psi1, psi)
            p_l = torch.where(active, pl1, p_l)
            sign = torch.where(active & (l > R), 1,
                               torch.where(active & (l < -R), -1, sign))
            if r_cap is not None:
                sign = torch.where(active & (l < r_cap), CAPTURED, sign)
            steps = steps + active.to(torch.int32)
        return l, psi, p_l, sign.to(torch.int32), steps

    sign = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    state = (l, psi, p_l, sign, torch.zeros_like(sign))
    done = 0
    while done < max_steps and bool((state[3] == 0).any()):
        n = min(segment, max_steps - done)
        state = checkpoint(run, n, *state, use_reentrant=False)
        done += n
    return PlanarResult(*state)


def escape_angle_beta(metric: Metric, res: PlanarResult, b):
    """In-plane escape direction angle from the launch radius:
    beta = psi + atan2(u_psi, u_l), u_psi = b / r, u_l = p_l sqrt(A)."""
    u_psi = b / metric.r(res.l)
    u_l = res.p_l
    if not _unit_lapse(metric):
        u_l = u_l * torch.sqrt(metric.lapse(res.l))
    return res.psi + torch.atan2(u_psi, u_l)


def planar_world_directions(metric: Metric, rays: PlanarRays,
                            res: PlanarResult):
    """3-D world escape directions: w = cos(beta) e1 + sin(beta) e2."""
    beta = escape_angle_beta(metric, res, rays.b)
    return (torch.cos(beta)[..., None] * rays.r_hat
            + torch.sin(beta)[..., None] * rays.e2)
