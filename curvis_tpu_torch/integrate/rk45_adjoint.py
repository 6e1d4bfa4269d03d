"""Exact gradients through the adaptive DP5(4) Kerr / Kerr-Newman march
(PyTorch).

Counterpart of ``curvis_tpu/integrate/rk45_adjoint.py``.  One lock-step
DP5(4) iteration -- seven trial stages on (r, theta, p_r, p_theta), the
error estimate over those four, the accept write-back with the boundary
over-reject rule at R, and the controller's next dt -- is a fixed map on
the extended per-ray state (r, theta, phi, p_r, p_theta, dt).  The forward
counts each ray's live iterations (accepted and rejected), so the
checkpointed-recompute backward (``integrate/ckpt.py``) replays ``steps =
iters`` iterations of that map and recovers every controller decision as
data.

What the map keeps from the JAX module (its docstring lists why):

  * by default the gradient is that of the whole extended map, the
    controller's err -> factor -> dt chain and the over-reject's frac -> dt
    chain included; ``freeze_controller=True`` detaches err, frac and the
    next dt (step sizes as data);
  * the RHS of the map, ``_kerr_rhs_guarded``, bounds r, p_r and p_theta to
    +-1e4, sigma below by 1e-3 and takes 1 / Delta as sign(Delta) /
    max(|Delta|, 1e-6): the replay evaluates every stage of every rejected
    trial, and a raw partial at a trial that overshoots across Delta = 0 is
    infinite (a zero cotangent times it is NaN).  Off the guards it is the
    march kernels' RHS, and ``sign(x) / |x|`` has the bits of ``1 / x``;
  * captured (sign 2), blown-up and stalled (3) rays get a zero cotangent
    and a zero-length replay; escaped (1) and capped (0) rays carry exact
    gradients; the cotangent of dt0 is dropped;
  * ``max_iters`` defaults to 2 max_steps and is rounded up to even (the
    TPU kernel's unroll; the forward kernel rounds it too).

Routes, by the device of the inputs:

  * CUDA tensors (float32): the forward is kernel #8
    (``ops/kerr_rk45_cuda.py:march_kerr_rk45_cuda``, with its iteration
    counts) and the backward the checkpoint kernels #9 / #10's Kerr DP5(4)
    family (``ops/ckpt_kerr_cuda.py``), in segments of 16; the replay runs
    #8's own unguarded iteration, so it takes #8's decisions, and guards
    only the partials of its VJP;
  * CPU tensors, or ``backend='twin'``: the forward is the masked loop
    ``_forward_xla_rk45`` over ``_rk45_iter`` (the JAX package's XLA
    route), the backward ``integrate/ckpt.py:ckpt_adjoint_backward`` under
    autograd on the same map, in segments of ~sqrt(max_iters).
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.integrate.kerr_adjoint import (_pack, _smooth_cotangent,
                                                     input_grads,
                                                     kernel_pullback, knob,
                                                     q2_of)
from curvis_tpu_torch.integrate.rk45 import CAPPED, DP_A, DP_B4, DP_B5, _comb
from curvis_tpu_torch.ops.kerr_rk45_cuda import (kerr_rk45_scalars,
                                                 march_kerr_rk45_cuda)
from curvis_tpu_torch.ops.rk45_cuda import jclip
from curvis_tpu_torch.physics.planar import _CHECK_EVERY


def _kerr_rhs_guarded(M, a, q2, E, L, r, th, p_r, p_th):
    """The Kerr RHS with bounded inputs and guarded reciprocals: finite
    outputs and finite partials for any finite state (module docstring)."""
    r = jclip(r, -1e4, 1e4)
    p_r = jclip(p_r, -1e4, 1e4)
    p_th = jclip(p_th, -1e4, 1e4)
    s = torch.sin(th)
    c = torch.cos(th)
    u = torch.maximum(s * s, torch.full_like(s, 1e-12))
    invu = 1.0 / u
    ac = a * c
    sigma = r * r + ac * ac
    inv_sigma = 1.0 / torch.maximum(sigma, torch.full_like(sigma, 1e-3))
    delta = r * (r - 2.0 * M) + a * a + q2
    inv_delta = torch.sign(delta) / torch.maximum(
        torch.abs(delta), torch.full_like(delta, 1e-6))
    P = (r * r + a * a) * E - a * L
    G = L - a * E * u
    W = (delta * p_r * p_r + p_th * p_th + G * G * invu
         - P * P * inv_delta)
    dDelta = 2.0 * r - 2.0 * M
    dWdr = (dDelta * p_r * p_r - 4.0 * r * E * P * inv_delta
            + P * P * dDelta * inv_delta * inv_delta)
    sin2t = 2.0 * s * c
    aE = a * E
    dWdth = (aE * aE - L * L * invu * invu) * sin2t
    half = 0.5 * inv_sigma
    return (delta * p_r * inv_sigma, p_th * inv_sigma,
            (G * invu + a * P * inv_delta) * inv_sigma,
            (-dWdr + W * (2.0 * r) * inv_sigma) * half,
            (-dWdth - W * (a * a * sin2t) * inv_sigma) * half)


def _rk45_iter(consts, theta, y, freeze=False):
    """One unmasked lock-step DP5(4) iteration on y = (r, th, ph, p_r,
    p_th, dt) -> (y1, (accept, esc, cap, blow, stall)): the JAX package's
    map, form for form.  ``consts`` = (rtol, atol, dt_min, dt_max, R,
    r_cap) as 0-d tensors of the state's dtype; theta = (M, a, q2, E, L).
    ``freeze`` detaches the controller's inputs and its output."""
    sg = (lambda x: x.detach()) if freeze else (lambda x: x)
    rtol, atol, dt_min, dt_max, R, r_cap = consts
    M, a, q2, E, L = theta
    r, th, ph, p_r, p_th, dt = y
    one = torch.ones_like(r)

    ks = []
    for i in range(7):
        ri, ti, pri, pti = r, th, p_r, p_th
        for j, aa in enumerate(DP_A[i]):
            ri = ri + dt * aa * ks[j][0]
            ti = ti + dt * aa * ks[j][1]
            pri = pri + dt * aa * ks[j][3]
            pti = pti + dt * aa * ks[j][4]
        ks.append(_kerr_rhs_guarded(M, a, q2, E, L, ri, ti, pri, pti))

    d5 = [_comb(DP_B5, ks, c, r) for c in range(5)]
    e = [d5[c] - _comb(DP_B4, ks, c, r) for c in (0, 1, 3, 4)]
    r1 = r + dt * d5[0]
    th1 = th + dt * d5[1]
    ph1 = ph + dt * d5[2]
    pr1 = p_r + dt * d5[3]
    pth1 = p_th + dt * d5[4]

    def ec(ei, y0, y1):
        return torch.abs(dt * ei) / (atol + rtol * torch.maximum(
            torch.abs(y0), torch.abs(y1)))

    err = torch.maximum(torch.maximum(ec(e[0], r, r1), ec(e[1], th, th1)),
                        torch.maximum(ec(e[2], p_r, pr1),
                                      ec(e[3], p_th, pth1)))
    err = sg(err)
    accept = err <= 1.0
    esc_i = accept & (r1 > R)
    den = r1 - r
    den = torch.where(torch.abs(den) < 1e-30, one, den)
    frac = sg((R - r) / den)
    over = esc_i & (frac < 0.9) & (r1 > R * (1.0 + 1e-3))
    accept = accept & ~over
    esc_i = esc_i & ~over

    rn, thn, phn, prn, pthn = (torch.where(accept, b, a_) for a_, b in zip(
        (r, th, ph, p_r, p_th), (r1, th1, ph1, pr1, pth1)))
    with torch.no_grad():                             # flags only
        ok = (torch.abs(rn) + torch.abs(thn) + torch.abs(phn)
              + torch.abs(prn) + torch.abs(pthn)) <= 1e8
    esc_set = accept & ok & esc_i
    cap_i = accept & ok & (rn < r_cap)
    blow_i = accept & ~ok
    stall_i = ~accept & (dt <= dt_min * 1.01)
    terminal = esc_set | cap_i | blow_i | stall_i

    err_s = torch.maximum(err, torch.full_like(err, 1e-10))
    factor = jclip(0.9 * torch.exp(-0.2 * torch.log(err_s)), 0.2, 5.0)
    factor = torch.where(torch.isfinite(factor), factor, 0.2)
    dt_b = jclip(dt * frac * 1.05, dt_min, dt_max)
    dtn = torch.where(~terminal, jclip(dt * factor, dt_min, dt_max), dt)
    dtn = torch.where(over & ~terminal, dt_b, dtn)
    dtn = sg(dtn)
    return ((rn, thn, phn, prn, pthn, dtn),
            (accept, esc_set, cap_i, blow_i, stall_i))


def _rk45_step(consts, theta, y, freeze=False):
    """The bare 6-state map (flags dropped): what the replay
    differentiates."""
    return _rk45_iter(consts, theta, y, freeze)[0]


def _forward_xla_rk45(consts, theta, y0, dt0, max_steps, max_iters):
    """The masked lock-step march on :func:`_rk45_iter` -> (y (5), sign,
    steps, iters): the map the backward replays, so the replay's trajectory
    is the forward's."""
    r0 = y0[0]
    y = tuple(y0) + (torch.full_like(r0, dt0),)
    sign = torch.zeros(r0.shape, dtype=torch.int32, device=r0.device)
    steps = torch.zeros_like(sign)
    iters = torch.zeros_like(sign)
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        iters = iters + active.to(torch.int32)
        y1, (accept, esc_set, cap_i, blow_i, stall_i) = _rk45_iter(
            consts, theta, y)
        y = tuple(torch.where(active, b, a) for a, b in zip(y, y1))
        sign = torch.where(active & esc_set, 1, sign)
        sign = torch.where(active & cap_i, 2, sign)
        sign = torch.where(active & (blow_i | stall_i), 3, sign)
        steps = steps + (active & accept).to(torch.int32)
        sign = torch.where((sign == 0) & (steps >= max_steps), CAPPED,
                           sign).to(torch.int32)
    sign = torch.where(sign == CAPPED, 0, sign).to(torch.int32)
    return y[:5], sign, steps, iters


def _consts(metric, rtol, atol, dt_min, dt_max, R, like):
    """(rtol, atol, dt_min, dt_max, R, r_cap) as 0-d tensors of ``like``'s
    dtype and device."""
    return tuple(torch.tensor(knob(v), dtype=like.dtype, device=like.device)
                 for v in (rtol, atol, dt_min, dt_max, R,
                           metric.capture_radius))


class _KerrRk45Adjoint(torch.autograd.Function):
    """(x0, p0, *metric fields) -> (x, p, sign, steps); ``cfg`` = (metric,
    dt0, max_steps, max_iters, R, rtol, atol, dt_min, dt_max, freeze,
    twin)."""

    @staticmethod
    def forward(ctx, cfg, x0, p0, *fields):
        (metric, dt0, max_steps, max_iters, R, rtol, atol, dt_min, dt_max,
         _, twin) = cfg
        E, L = -p0[:, 0], p0[:, 3]
        if x0.device.type == "cuda" and not twin:
            x, p, sign, steps, iters = march_kerr_rk45_cuda(
                metric, x0, p0, dt0=dt0, max_steps=max_steps,
                max_iters=max_iters, escape_radius=R, rtol=rtol, atol=atol,
                dt_min=dt_min, dt_max=dt_max, return_iters=True)
        else:
            consts = _consts(metric, rtol, atol, dt_min, dt_max, R, x0)
            theta = (metric.m, metric.a, q2_of(metric, x0), E, L)
            y0 = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2])
            with torch.no_grad():
                y, sign, steps, iters = _forward_xla_rk45(
                    consts, theta, y0, dt0, max_steps, max_iters)
            x, p = _pack(y, E, L)
        ctx.cfg = cfg
        ctx.save_for_backward(x0, p0, sign, iters)
        ctx.mark_non_differentiable(sign, steps)
        return x, p, sign, steps

    @staticmethod
    def backward(ctx, g_x, g_p, _g_sign, _g_steps):
        (metric, dt0, max_steps, max_iters, R, rtol, atol, dt_min, dt_max,
         freeze, twin) = ctx.cfg
        x0, p0, sign, iters = ctx.saved_tensors
        E, L = -p0[:, 0], p0[:, 3]
        y0 = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2])
        zero = torch.zeros_like(y0[0])
        cot, counts = _smooth_cotangent(
            sign, iters, (g_x[:, 1], g_x[:, 2], g_x[:, 3], g_p[:, 1],
                          g_p[:, 2], zero))          # dt: no cotangent
        if x0.device.type == "cuda" and not twin:
            scal = kerr_rk45_scalars(metric, dt0, R, rtol=rtol, atol=atol,
                                     dt_min=dt_min, dt_max=dt_max)
            g_theta, lam = kernel_pullback("rk45", scal, y0, E, L, counts,
                                           cot, freeze=freeze)
        else:
            consts = _consts(metric, rtol, atol, dt_min, dt_max, R, x0)
            theta = (metric.m.detach(), metric.a.detach(),
                     q2_of(metric, x0).detach(), E.detach(), L.detach())
            start = tuple(t.detach() for t in y0) + (
                torch.full_like(zero, dt0),)

            def step(th, y):
                return _rk45_step(consts, th, y, freeze)
            g_theta, lam = ckpt_adjoint_backward(
                step, theta, start, counts, cot, max_steps=max_iters,
                segment=max(1, int(math.sqrt(max_iters))))
        # lam[5], the dt0 cotangent, is dropped: dt0 is a solver knob
        return input_grads(metric, x0, p0, g_p, g_theta, lam)


def default_max_iters(max_steps, max_iters=None):
    """2 max_steps unless given, rounded up to even (module docstring)."""
    mi = 2 * int(max_steps) if max_iters is None else int(max_iters)
    return mi + (mi & 1)


def march_kerr_rk45_adjoint(metric, x0, p0, *, dt0, max_steps,
                            escape_radius, rtol=1e-4, atol=1e-7,
                            dt_min=1e-5, dt_max=None, max_iters=None,
                            backend="auto", freeze_controller=False):
    """Differentiable error-controlled Kerr / Kerr-Newman march (module
    docstring) -> (x, p, sign, steps), the contract of
    ``march_kerr_adjoint``.  The forward is kernel #8 on CUDA tensors
    (``backend='auto'``) and the twin loop otherwise (``backend='twin'``,
    or CPU tensors; ``render_kerr``'s 'scan' route).  ``max_iters``
    bounds the forward iterations and the backward replay (default 2
    max_steps, rounded up to even); ``dt_max`` defaults to escape_radius /
    8."""
    if backend not in ("auto", "twin"):
        raise ValueError(f"backend must be 'auto' or 'twin', got {backend!r}")
    mi = default_max_iters(max_steps, max_iters)
    if dt_max is None:
        dt_max = knob(escape_radius) / 8.0
    fields = tuple(getattr(metric, k) for k in metric.fields)
    cfg = (metric, knob(dt0), int(max_steps), mi, knob(escape_radius),
           knob(rtol), knob(atol), knob(dt_min), knob(dt_max),
           bool(freeze_controller), backend == "twin")
    return _KerrRk45Adjoint.apply(cfg, x0, p0, *fields)
