"""Exact gradients through the fixed-step RK4 Kerr / Kerr-Newman march
(PyTorch).

Counterpart of ``curvis_tpu/integrate/kerr_adjoint.py``: a
``torch.autograd.Function`` on the 5-state Boyer-Lindquist system (r,
theta, phi, p_r, p_theta; E = -p_t and L = p_phi exactly conserved) whose
backward is checkpointed recompute (``integrate/ckpt.py``): the trajectory
is re-marched from the spawn state in segments and the cotangent pulled
back through each, so the gradient is the exact discrete gradient of the
march, photon-ring rays included.

Routes, by the device of the inputs:

  * CUDA tensors (float32): the forward is kernel #7
    (``ops/kerr_cuda.py:march_kerr_cuda``), the backward the checkpoint
    kernels #9 / #10's Kerr RK4 family (``ops/ckpt_kerr_cuda.py``), which
    replay #7's own step in segments of 32;
  * CPU tensors: the forward is the masked loop ``_forward_xla`` over the
    step ``_step5_theta`` (the JAX package's XLA route), the backward
    ``integrate/ckpt.py:ckpt_adjoint_backward`` under autograd on the same
    step, in segments of ~sqrt(max_steps).

Gradients reach the metric's parameters (m, a and, for Kerr-Newman, q
through g_q = 2 q g_{q^2}), ``x0`` and ``p0``.  What the Function keeps
from the JAX package's custom VJP:

  * only smooth fates carry a cotangent: escaped (sign 1) and step-capped
    (0) rays; captured (2) and blown-up (3) rays replay no step from the
    spawn state and get a zero cotangent (the renderers paint them black
    and substitute the spawn state before the readout);
  * p's t and phi components are never marched: p_out[:, 0] = p0[:, 0] and
    p_out[:, 3] = p0[:, 3], so their cotangents reach p0 directly, beside
    the per-step E and L sensitivities (E = -p0[:, 0], L = p0[:, 3]);
  * dt, escape_radius, axis_u0 and far_r0 are knobs, not parameters: their
    cotangents are dropped (``render_kerr`` passes far_r0 = 8 M, and its
    path to d / dM is dropped here as in JAX).
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.ops import ckpt_kerr_cuda
from curvis_tpu_torch.ops.kerr_cuda import (kerr_rhs_theta, kerr_scalars,
                                            march_kerr_cuda)
from curvis_tpu_torch.ops.rk45_cuda import jclip
from curvis_tpu_torch.physics.hamiltonian import FAR_DT_CAP
from curvis_tpu_torch.physics.planar import _CHECK_EVERY


def knob(v):
    """A solver knob (dt, a radius, a tolerance) as a Python float; a
    tensor's graph is dropped, as the adjoints do not differentiate
    knobs."""
    return float(v.detach()) if torch.is_tensor(v) else float(v)


def q2_of(metric, like):
    """The metric's charge squared as a 0-d tensor in its graph (zeros like
    ``like`` for Kerr)."""
    q = getattr(metric, "q", None)
    if q is None:
        return torch.zeros((), dtype=like.dtype, device=like.device)
    return q * q


def step_dte(dt, axis_u0, far_r0, r, th):
    """The step at (r, theta): dt scaled by the polar-axis factor and the
    far-field factor (the rule of every Kerr march), with jnp.clip's
    gradient (a tie passes half the cotangent)."""
    s = torch.sin(th)
    return (dt * jclip((s * s + 1e-12) / max(float(axis_u0), 1e-12),
                       1.0 / 16.0, 1.0)
            * jclip(r / max(float(far_r0), 1e-12), 1.0, FAR_DT_CAP))


def _step5_theta(dt, axis_u0, far_r0, theta, y):
    """One unmasked RK4 step of the 5-state BL system, the dt scaled by the
    polar-axis factor and the far-field factor at the step's start (the
    rule of every Kerr march).  ``theta = (M, a, q2, E, L)``, scalars or
    per-ray; the clips are jnp.clip's (a tie passes half the cotangent)."""
    M, a, q2, E, L = theta
    r, th, ph, p_r, p_th = y
    dte = step_dte(dt, axis_u0, far_r0, r, th)

    def rhs(r_, th_, pr_, pth_):
        return kerr_rhs_theta(M, a, q2, E, L, r_, th_, pr_, pth_)

    k1 = rhs(r, th, p_r, p_th)
    k2 = rhs(r + 0.5 * dte * k1[0], th + 0.5 * dte * k1[1],
             p_r + 0.5 * dte * k1[3], p_th + 0.5 * dte * k1[4])
    k3 = rhs(r + 0.5 * dte * k2[0], th + 0.5 * dte * k2[1],
             p_r + 0.5 * dte * k2[3], p_th + 0.5 * dte * k2[4])
    k4 = rhs(r + dte * k3[0], th + dte * k3[1], p_r + dte * k3[3],
             p_th + dte * k3[4])
    w = dte * (1.0 / 6.0)
    return tuple(v + w * (a1 + 2.0 * (a2 + a3) + a4)
                 for v, a1, a2, a3, a4 in zip(y, k1, k2, k3, k4))


def step5(metric, y, E, L, dt, axis_u0, far_r0):
    """The metric-facing front door to :func:`_step5_theta`."""
    return _step5_theta(dt, axis_u0, far_r0,
                        (metric.m, metric.a, q2_of(metric, y[0]), E, L), y)


def _forward_xla(theta, y0, dt, max_steps, escape_radius, axis_u0, far_r0,
                 r_cap):
    """The masked lock-step march on :func:`_step5_theta` -> (y, sign,
    steps): escape beyond R (sign 1), capture below r_cap (2), blowup (3)
    where |r| + |theta| + |phi| + |p_r| + |p_theta| > 1e8 or NaN, each ray
    at most ``max_steps`` steps."""
    y = tuple(y0)
    sign = torch.zeros(y[0].shape, dtype=torch.int32, device=y[0].device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        y1 = _step5_theta(dt, axis_u0, far_r0, theta, y)
        y = tuple(torch.where(active, b, a) for a, b in zip(y, y1))
        r = y[0]
        ok = sum(torch.abs(v) for v in y) <= 1e8
        sign = torch.where(active & ok & (r > escape_radius), 1, sign)
        sign = torch.where(active & ok & (r < r_cap), 2, sign)
        sign = torch.where(active & ~ok, 3, sign).to(torch.int32)
        steps = steps + active.to(torch.int32)
    return y, sign, steps


def _pack(y, E, L):
    """(x, p) of the 5-state with x's t component 0 and p = (-E, p_r,
    p_theta, L)."""
    r, th, ph, p_r, p_th = y
    x = torch.stack([torch.zeros_like(r), r, th, ph], dim=-1)
    p = torch.stack([-E, p_r, p_th, L], dim=-1)
    return x, p


def _smooth_cotangent(sign, counts, cot):
    """Zero cotangents and replay counts for captured and blown-up rays."""
    smooth = (sign == 0) | (sign == 1)
    cot = tuple(torch.where(smooth, c, torch.zeros_like(c)) for c in cot)
    return cot, torch.where(smooth, counts, torch.zeros_like(counts))


def kernel_pullback(family, scal, y0, E, L, counts, cot, *, freeze=False):
    """The checkpoint kernels' pullback of the march of ``family`` ('rk4' or
    'rk45') -> ((g_M, g_a, g_q2 summed over rays, g_E, g_L per ray), lam)."""
    flat = [t.contiguous() for t in (*y0, E, L)]
    g, lam = ckpt_kerr_cuda.ckpt_kerr_backward_cuda(
        family, scal, flat[:5], flat[5], flat[6], counts.to(torch.int32),
        torch.stack(cot).contiguous(), freeze=freeze,
        seg=ckpt_kerr_cuda.SEG[family])
    return (torch.sum(g[0]), torch.sum(g[1]), torch.sum(g[2]), g[3],
            g[4]), lam


def input_grads(metric, x0, p0, g_p, g_theta, lam):
    """The Function's input cotangents (None for its config, x0, p0, the
    metric's fields) from the march's pullback: lam of (r, theta, phi,
    p_r, p_theta), g_theta = (g_M, g_a, g_q2, g_E, g_L).  p's t and phi
    components reach p0 by identity beside E = -p0[:, 0] and L = p0[:, 3];
    q through g_q = 2 q g_q2."""
    g_m, g_a, g_q2, gE, gL = g_theta
    g_fields = [g_m, g_a]
    if "q" in metric.fields:
        g_fields.append(2.0 * metric.q.detach() * g_q2)
    zero = torch.zeros_like(lam[0])
    g_x0 = torch.stack([zero, lam[0], lam[1], lam[2]], dim=-1)
    g_p0 = torch.stack([g_p[:, 0] - gE, lam[3], lam[4], g_p[:, 3] + gL],
                       dim=-1)
    return (None, g_x0.to(x0.dtype), g_p0.to(p0.dtype),
            *(g.to(getattr(metric, k).dtype)
              for g, k in zip(g_fields, metric.fields)))


class _KerrAdjoint(torch.autograd.Function):
    """(x0, p0, *metric fields) -> (x, p, sign, steps); ``cfg`` = (metric,
    dt, max_steps, escape_radius, axis_u0, far_r0)."""

    @staticmethod
    def forward(ctx, cfg, x0, p0, *fields):
        metric, dt, max_steps, R, axis_u0, far_r0 = cfg
        E, L = -p0[:, 0], p0[:, 3]
        if x0.device.type == "cuda":
            x, p, sign, steps = march_kerr_cuda(
                metric, x0, p0, dt=dt, max_steps=max_steps, escape_radius=R,
                axis_u0=axis_u0, far_r0=far_r0)
        else:
            theta = (metric.m, metric.a, q2_of(metric, x0), E, L)
            y0 = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2])
            with torch.no_grad():
                y, sign, steps = _forward_xla(
                    theta, y0, dt, max_steps, R, axis_u0,
                    1e30 if far_r0 is None else far_r0,
                    knob(metric.capture_radius))
            x, p = _pack(y, E, L)
        ctx.cfg = cfg
        ctx.save_for_backward(x0, p0, sign, steps)
        ctx.mark_non_differentiable(sign, steps)
        return x, p, sign, steps

    @staticmethod
    def backward(ctx, g_x, g_p, _g_sign, _g_steps):
        metric, dt, max_steps, R, axis_u0, far_r0 = ctx.cfg
        x0, p0, sign, steps = ctx.saved_tensors
        E, L = -p0[:, 0], p0[:, 3]
        y0 = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2])
        cot, counts = _smooth_cotangent(
            sign, steps, (g_x[:, 1], g_x[:, 2], g_x[:, 3], g_p[:, 1],
                          g_p[:, 2]))
        far = 1e30 if far_r0 is None else far_r0
        if x0.device.type == "cuda":
            scal = kerr_scalars(metric, dt, R, axis_u0=axis_u0, far_r0=far)
            g_theta, lam = kernel_pullback("rk4", scal, y0, E, L, counts,
                                           cot)
        else:
            theta = (metric.m.detach(), metric.a.detach(),
                     q2_of(metric, x0).detach(), E.detach(), L.detach())

            def step(th, y):
                return _step5_theta(dt, axis_u0, far, th, y)
            g_theta, lam = ckpt_adjoint_backward(
                step, theta, tuple(t.detach() for t in y0), counts, cot,
                max_steps=max_steps,
                segment=max(1, int(math.sqrt(max_steps))))
        return input_grads(metric, x0, p0, g_p, g_theta, lam)


def march_kerr_adjoint(metric, x0, p0, *, dt, max_steps, escape_radius,
                       axis_u0=0.01, far_r0=None):
    """Differentiable Kerr / Kerr-Newman BL march with the checkpointed-
    recompute backward (module docstring) -> (x, p, sign, steps), the
    contract of ``march_kerr_cuda`` (x's t component 0).  The inputs'
    device picks the route: kernel #7 and the checkpoint kernels on CUDA
    tensors, the twin loop on CPU tensors.  ``far_r0`` (None = off) and the
    other knobs are not differentiated."""
    fields = tuple(getattr(metric, k) for k in metric.fields)
    cfg = (metric, knob(dt), int(max_steps), knob(escape_radius),
           knob(axis_u0), None if far_r0 is None else knob(far_r0))
    return _KerrAdjoint.apply(cfg, x0, p0, *fields)
