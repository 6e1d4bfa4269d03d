"""Bounded-memory gradients through the planar ray march: a
``torch.autograd.Function`` whose backward is checkpointed recompute.

Counterpart of ``curvis_tpu/integrate/adjoint.py``.  The forward is the
production march, ``ops/march_cuda.py:march_planar_cuda`` (kernel #1 on
CUDA tensors, ``march_planar_while`` on CPU tensors); the backward
re-marches the trajectory from the spawn state in segments and pulls the
cotangent back through each one, exactly (see ``integrate/ckpt.py``):

  * CUDA tensors: kernels #9/#10 (``ops/ckpt_adjoint_cuda.py``), on the
    march kernel's own step, with per-ray cotangents of the metric slots
    summed here with ``torch.sum``;
  * CPU tensors: ``integrate/ckpt.py`` under autograd, on
    ``physics/planar.py:planar_euler_step`` (the CPU forward's step).

Rays are frozen once they escape: a ray's backward covers only its own
``steps[i]`` steps.  Captured rays (sign 2) are excluded, as in the JAX
package: their cotangent is zeroed and their step count set to 0, so the
spawn state stands in for their frozen state (capture is a discrete event,
and the renderers paint them black anyway).

Gradients flow to the metric's parameters (explicit inputs of the
Function), the spawn state (l, psi, p_l) -- hence the camera position --
and ``b``.  The CUDA kernels see the metric through the slots of the march
scalar row; ``_planar_metric_grads`` maps slot cotangents back onto the
metric's fields, with the chain rule g_q = 2 q g_{q^2} for
Reissner-Nordstrom, whose slot p1 holds q^2.
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.metrics.base import (InterstellarMetric, Metric,
                                           ReissnerNordstromMetric)
from curvis_tpu_torch.ops import ckpt_adjoint_cuda
from curvis_tpu_torch.ops.march_cuda import march_planar_cuda, march_scalars
from curvis_tpu_torch.physics.planar import (CAPTURED, PlanarRays,
                                             PlanarResult, planar_euler_step)


def _planar_metric_grads(metric: Metric, g012):
    """Slot cotangents (p0, p1, p2), summed over rays -> the cotangents of
    ``metric.fields``: Ellis rho <- p0; DNEG (m, a, rho) <- (p0, p1, p2);
    Schwarzschild m <- p0; RN m <- p0 and q <- 2 q p1 (p1 = q^2)."""
    g0, g1, g2 = g012
    if isinstance(metric, InterstellarMetric):
        return (g0, g1, g2)
    if isinstance(metric, ReissnerNordstromMetric):
        return (g0, 2.0 * metric.q.detach() * g1)
    return (g0,)[:len(metric.fields)]


def _rebuilt(metric: Metric, fields):
    """A metric of ``metric``'s type on the tensors ``fields``."""
    if not fields:
        return type(metric)()
    return type(metric)(*fields, device=fields[0].device,
                        dtype=fields[0].dtype)


class _PlanarAdjoint(torch.autograd.Function):
    """(l, psi, p_l, b, *metric fields) -> (l, psi, p_l, sign, steps) of
    the march; ``cfg`` = (metric, dt, max_steps, escape_radius)."""

    @staticmethod
    def forward(ctx, cfg, l, psi, p_l, b, *fields):
        metric, dt, max_steps, escape_radius = cfg
        rays = PlanarRays(l=l, psi=psi, p_l=p_l, b=b, r_hat=None, e2=None)
        res = march_planar_cuda(metric, rays, dt=dt, max_steps=max_steps,
                                escape_radius=escape_radius)
        ctx.cfg = cfg
        ctx.save_for_backward(l, psi, p_l, b, res.sign, res.steps, *fields)
        ctx.mark_non_differentiable(res.sign, res.steps)
        return res.l, res.psi, res.p_l, res.sign, res.steps

    @staticmethod
    def backward(ctx, g_l, g_psi, g_pl, _g_sign, _g_steps):
        metric, dt, max_steps, _ = ctx.cfg
        l, psi, p_l, b, sign, steps, *fields = ctx.saved_tensors
        smooth = sign != CAPTURED                # captured rays excluded
        cot = tuple(torch.where(smooth, c, torch.zeros_like(c))
                    for c in (g_l, g_psi, g_pl))
        steps_eff = torch.where(smooth, steps, torch.zeros_like(steps))
        y0 = (l, psi, p_l)
        if l.device.type == "cuda":
            kind, scal = march_scalars(metric, dt, 0.0)
            flat = [t.reshape(-1).contiguous()
                    for t in (*y0, b, steps_eff, *cot)]
            g, lam = ckpt_adjoint_cuda.ckpt_adjoint_backward_cuda(
                kind, scal, tuple(flat[:3]), flat[3], flat[4],
                tuple(flat[5:]))
            g_fields = _planar_metric_grads(
                metric, tuple(torch.sum(gi) for gi in g[:3]))
            g_b = g[3].reshape(b.shape)
            lam = tuple(a.reshape(l.shape) for a in lam)
        elif l.device.type == "cpu":
            def step_fn(theta, y):
                return planar_euler_step(_rebuilt(metric, theta[:-1]), *y,
                                         theta[-1], dt)
            (*g_fields, g_b), lam = ckpt_adjoint_backward(
                step_fn, (*fields, b), y0, steps_eff, cot,
                max_steps=max_steps,
                segment=max(1, int(math.sqrt(max_steps))))
        else:
            raise ValueError(f"march_planar_adjoint: unsupported device "
                             f"{l.device}")
        return (None, *lam, g_b, *g_fields)


def march_planar_adjoint(metric: Metric, state, b, dt, max_steps,
                         escape_radius):
    """Differentiable planar Euler march with the checkpointed-recompute
    backward.  ``state`` = (l, psi, p_l) tensors; returns (l, psi, p_l,
    sign, steps).  Gradients flow to the metric's parameters, ``state`` and
    ``b``; ``dt`` is not differentiated.  The backward recomputes segments
    of 32 steps on CUDA and of ~sqrt(max_steps) on the CPU (the JAX
    package's defaults; the gradient does not depend on them)."""
    l, psi, p_l = state
    fields = tuple(getattr(metric, f) for f in metric.fields)
    cfg = (metric, float(dt), int(max_steps), float(escape_radius))
    return _PlanarAdjoint.apply(cfg, l, psi, p_l, b, *fields)


def march_planar_adjoint_rays(metric: Metric, rays: PlanarRays, *, dt,
                              max_steps, escape_radius) -> PlanarResult:
    """PlanarRays-facing wrapper with the standard result contract."""
    return PlanarResult(*march_planar_adjoint(
        metric, (rays.l, rays.psi, rays.p_l), rays.b, dt, max_steps,
        escape_radius))
