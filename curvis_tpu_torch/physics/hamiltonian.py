"""General-metric geodesic integration with autodiff-generated equations
(PyTorch).

Counterpart of ``curvis_tpu/physics/hamiltonian.py``.  Given an inverse
metric g^{mu nu}(x), the geodesic equations come from the super-Hamiltonian

    H(x, p) = (1/2) g^{mu nu}(x) p_mu p_nu,
    dx/dlam = dH/dp = g^{-1} p,       dp/dlam = -dH/dx,

with dH/dx from ``torch.func.grad``, and a local photon is spawned from an
orthonormal static tetrad built by Gram-Schmidt on the coordinate basis.
``torch.func.grad`` is a function transform: it differentiates under an
outer ``torch.no_grad()`` too, where ``torch.autograd.grad`` would fail.

This is the march of the Kerr render routes on CPU tensors (the JAX
package's XLA route); on a GPU they run the hand-inlined RHS of kernel #7
(``ops/kerr_cuda.py``).  ``march_hamiltonian_scan`` is the differentiable
march of ``render_kerr(backend='scan')`` on any device: plain PyTorch, as
the JAX package's scan is plain XLA.  It checkpoints each segment by hand
(an autograd Function that recomputes the segment in its backward), since
``torch.func.grad`` does not run under the saved-tensor hooks of
``torch.utils.checkpoint``; a ``torch.func.grad`` inside a recompute under
``torch.enable_grad()`` carries the graph to the outer backward.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from curvis_tpu_torch.physics.planar import _CHECK_EVERY


class HamiltonianResult(NamedTuple):
    x: torch.Tensor       # (..., 4) final position
    p: torch.Tensor       # (..., 4) final covariant momentum
    sign: torch.Tensor    # int32: 1 escaped, 2 captured, 3 blown up, 0 not
    steps: torch.Tensor   # int32


def hamiltonian(metric, x, p):
    """H = (1/2) g^{mu nu} p_mu p_nu, batched over leading dims (from the
    metric's five components when it has them)."""
    if hasattr(metric, "inverse_components"):
        gtt, grr, gthth, gphph, gtph = metric.inverse_components(x)
        pt, pr_, pth, pph = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
        return 0.5 * (gtt * pt * pt + grr * pr_ * pr_ + gthth * pth * pth
                      + gphph * pph * pph) + gtph * pt * pph
    ginv = metric.inverse_metric(x)
    return 0.5 * torch.einsum("...ij,...i,...j->...", ginv, p, p)


def _rhs_batched(metric, x, p):
    """(dx, dp) of a bundle: dp = -grad_x sum_i H(x_i, p_i), which is the
    per-ray gradient because the sum is block-diagonal."""
    if hasattr(metric, "inverse_components"):
        gtt, grr, gthth, gphph, gtph = metric.inverse_components(x)
        pt, pr_, pth, pph = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
        dx = torch.stack([gtt * pt + gtph * pph, grr * pr_, gthth * pth,
                          gtph * pt + gphph * pph], dim=-1)
    else:
        dx = torch.einsum("...ij,...j->...i", metric.inverse_metric(x), p)
    dp = -torch.func.grad(
        lambda X: torch.sum(hamiltonian(metric, X, p)))(x)
    return dx, dp


def rk4_step_batched(metric, x, p, dt):
    k1x, k1p = _rhs_batched(metric, x, p)
    k2x, k2p = _rhs_batched(metric, x + 0.5 * dt * k1x, p + 0.5 * dt * k1p)
    k3x, k3p = _rhs_batched(metric, x + 0.5 * dt * k2x, p + 0.5 * dt * k2p)
    k4x, k4p = _rhs_batched(metric, x + dt * k3x, p + dt * k3p)
    x1 = x + (dt / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x)
    p1 = p + (dt / 6.0) * (k1p + 2 * k2p + 2 * k3p + k4p)
    return x1, p1


def _dot(g, u, v):
    return torch.einsum("...i,...ij,...j->...", u, g, v)


def static_tetrad(metric, x):
    """Orthonormal tetrad e_(a)^mu at each point of x (..., 4) by modified
    Gram-Schmidt on the coordinate basis (d_t, d_r, d_theta, d_phi) under
    g, first leg timelike -> (..., 4, 4), rows the legs.  Valid wherever
    d_t is timelike (outside the ergosphere for Kerr)."""
    g = metric.metric(x)
    basis = torch.eye(4, dtype=x.dtype, device=x.device).expand(
        *x.shape[:-1], 4, 4)
    e0 = basis[..., 0, :]
    e0 = e0 / torch.sqrt(-_dot(g, e0, e0))[..., None]
    vecs, signs = [e0], [-1.0]
    for k in range(1, 4):
        v = basis[..., k, :]
        for e, s in zip(vecs, signs):
            v = v - (s * _dot(g, v, e))[..., None] * e
        v = v / torch.sqrt(_dot(g, v, v))[..., None]
        vecs.append(v)
        signs.append(1.0)
    return torch.stack(vecs, dim=-2)


def spawn_photon(metric, x, direction3):
    """Covariant null momentum (..., 4) of photons at x (..., 4) with local
    directions ``direction3`` (..., 3) along the spatial tetrad legs, local
    energy 1 in the static frame.  x broadcasts against the directions: a
    single (4,) position builds one tetrad for the whole bundle."""
    tet = static_tetrad(metric, x)
    d = direction3 / torch.linalg.norm(direction3, dim=-1, keepdim=True)
    p_up = (tet[..., 0, :] + d[..., 0:1] * tet[..., 1, :]
            + d[..., 1:2] * tet[..., 2, :] + d[..., 2:3] * tet[..., 3, :])
    return torch.matmul(metric.metric(x), p_up[..., None])[..., 0]


def axis_dt_scale(theta, axis_u0):
    """Polar-axis step control of every BL march: dt shrinks up to 16x
    inside the sin^2(theta) < axis_u0 band (axis_u0 = 0 disables)."""
    s = torch.sin(theta)
    return torch.clamp((s * s + 1e-12) / max(float(axis_u0), 1e-12),
                       1.0 / 16.0, 1.0)


FAR_DT_CAP = 8.0


def far_dt_scale(r, far_r0):
    """Far-field step growth of every BL march: dt grows linearly with r
    beyond ``far_r0``, capped at FAR_DT_CAP; far_r0 = 1e30 is 'off' (r /
    1e30 clips to 1 exactly)."""
    return torch.clamp(r / torch.clamp(torch.as_tensor(far_r0, dtype=r.dtype,
                                                       device=r.device),
                                       min=1e-12), 1.0, FAR_DT_CAP)


def blown_up(x, p):
    """The blowup guard of every BL march: |r| + |theta| + |phi| + |p_r| +
    |p_theta| > 1e8, true for inf and NaN in any of them."""
    m_chk = (torch.abs(x[..., 1]) + torch.abs(x[..., 2])
             + torch.abs(x[..., 3]) + torch.abs(p[..., 1])
             + torch.abs(p[..., 2]))
    return ~(m_chk <= 1e8)


def march_hamiltonian(metric, x0, p0, *, dt, max_steps, escape_radius,
                      capture_radius=None, axis_u0=0.01,
                      far_r0=None) -> HamiltonianResult:
    """Masked lock-step RK4 march of the general system: escape at r =
    x[..., 1] > escape_radius (sign 1), capture below capture_radius (sign
    2), blowup (sign 3); each ray takes at most ``max_steps`` steps."""
    dt = torch.as_tensor(dt, dtype=x0.dtype, device=x0.device)
    if far_r0 is None:
        far_r0 = 1e30
    x, p = x0, p0
    sign = torch.zeros(x0.shape[:-1], dtype=torch.int32, device=x0.device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        dte = dt * axis_dt_scale(x[..., 2], axis_u0) \
            * far_dt_scale(x[..., 1], far_r0)
        x1, p1 = rk4_step_batched(metric, x, p, dte[..., None])
        am = active[..., None]
        x = torch.where(am, x1, x)
        p = torch.where(am, p1, p)
        sign = update_sign(sign, active, x, p, escape_radius, capture_radius)
        steps = steps + active.to(torch.int32)
    return HamiltonianResult(x, p, sign, steps)


def update_sign(sign, active, x, p, escape_radius, capture_radius):
    """The sign after a masked BL step: escape, then capture, then the
    blowup guard, as the JAX marches order their selects."""
    r = x[..., 1]
    bad = blown_up(x, p)
    ok = ~bad
    sign = torch.where(active & ok & (r > escape_radius), 1, sign)
    if capture_radius is not None:
        sign = torch.where(active & ok & (r < capture_radius), 2, sign)
    return torch.where(active & bad, 3, sign).to(torch.int32)


def _scan_segment(metric, x, p, sign, steps, cfg, far_r0):
    """``segment`` masked steps of the scan (march_hamiltonian's step,
    masked on steps < max_steps as well as on the sign)."""
    dt, segment, max_steps, escape_radius, capture_radius, axis_u0 = cfg
    for _ in range(segment):
        active = (sign == 0) & (steps < max_steps)
        dte = dt * axis_dt_scale(x[..., 2], axis_u0) \
            * far_dt_scale(x[..., 1], far_r0)
        x1, p1 = rk4_step_batched(metric, x, p, dte[..., None])
        am = active[..., None]
        x = torch.where(am, x1, x)
        p = torch.where(am, p1, p)
        sign = update_sign(sign, active, x, p, escape_radius, capture_radius)
        steps = steps + active.to(torch.int32)
    return x, p, sign, steps


class _ScanSegment(torch.autograd.Function):
    """One checkpointed segment: (x, p, sign, steps, far_r0, *metric
    fields) -> (x, p, sign, steps); the forward keeps only its inputs, the
    backward recomputes it under autograd."""

    @staticmethod
    def forward(ctx, metric, cfg, x, p, sign, steps, far_r0, *fields):
        with torch.no_grad():
            out = _scan_segment(metric, x, p, sign, steps, cfg, far_r0)
        ctx.metric, ctx.cfg = metric, cfg
        ctx.save_for_backward(x, p, sign, steps, far_r0, *fields)
        ctx.mark_non_differentiable(out[2], out[3])
        return out

    @staticmethod
    def backward(ctx, g_x, g_p, _g_sign, _g_steps):
        x, p, sign, steps, far_r0, *fields = ctx.saved_tensors
        ins = [t.detach().requires_grad_() for t in (x, p, far_r0, *fields)]
        metric = type(ctx.metric)(*ins[3:], device=x.device, dtype=x.dtype)
        with torch.enable_grad():
            x1, p1, _, _ = _scan_segment(metric, ins[0], ins[1], sign, steps,
                                         ctx.cfg, ins[2])
            grads = torch.autograd.grad((x1, p1), ins, (g_x, g_p),
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, ins)]
        return (None, None, grads[0], grads[1], None, None, *grads[2:])


def march_hamiltonian_scan(metric, x0, p0, *, dt, max_steps, escape_radius,
                           capture_radius=None, axis_u0=0.01, segment=None,
                           far_r0=None) -> HamiltonianResult:
    """Differentiable general-metric march: the per-step semantics of
    :func:`march_hamiltonian`, masking on ``steps < max_steps`` as well as
    on the sign, in segments of ``segment`` (~sqrt(max_steps)) steps, each
    recomputed in the backward (O(sqrt(steps)) memory).  Gradients reach
    the metric's parameters, ``x0``, ``p0`` and a tensor ``far_r0``.  The
    JAX package's scan always runs every segment; once every ray has ended
    the rest are identity maps, so this one stops there."""
    if segment is None:
        segment = max(1, int(math.sqrt(max_steps)))
    n_seg = -(-max_steps // segment)
    dt = torch.as_tensor(dt, dtype=x0.dtype, device=x0.device)
    far_r0 = torch.as_tensor(1e30 if far_r0 is None else far_r0,
                             dtype=x0.dtype, device=x0.device)
    cfg = (dt, segment, max_steps, escape_radius, capture_radius, axis_u0)
    fields = tuple(getattr(metric, k) for k in metric.fields)
    x, p = x0, p0
    sign = torch.zeros(x0.shape[:-1], dtype=torch.int32, device=x0.device)
    steps = torch.zeros_like(sign)
    for _ in range(n_seg):
        if not bool(((sign == 0) & (steps < max_steps)).any()):
            break
        x, p, sign, steps = _ScanSegment.apply(metric, cfg, x, p, sign,
                                               steps, far_r0, *fields)
    return HamiltonianResult(x, p, sign, steps)
