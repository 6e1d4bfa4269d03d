"""Differentiable error-controlled planar march (PyTorch).

Counterpart of ``curvis_tpu/integrate/rk45_adjoint_planar.py``: the
adaptive DP5(4) march of the planar system with exact gradients by
checkpointed recompute (``integrate/ckpt.py``).  One lock-step DP5(4)
iteration -- seven trial stages on (l, p_l), the three-component error
estimate, the accept write-back with the escape interpolation, and the
controller's next dt -- is a fixed map on the per-ray state (l, psi, p_l,
dt).  The forward counts each ray's live iterations (accepted and
rejected), so the replay runs ``steps = iters`` iterations of that map and
recovers every controller decision as data.

What the map keeps from the JAX module (its docstring lists why):

  * the controller factor is 0.9 exp(-0.2 log err), never a pow; err_s =
    max(err, 1e-10); the factor is clipped to [0.2, 5] and a NaN factor
    becomes 0.2; the dt floor is dt_min and the stall test dt <= 1.01
    dt_min (kernel #4 hardcodes dt_min = 1e-6, so its route requires it);
  * the escape interpolation frac is part of the differentiated map in
    both modes; ``freeze_controller=True`` detaches only the err -> factor
    -> dt chain;
  * captured (sign 2) and stalled (3) rays get a zero cotangent and a
    zero-length replay; escaped (+-1) and capped (0) rays carry exact
    gradients; the dt0 cotangent is dropped.

Routes, by the device of the inputs:

  * CUDA tensors (float32): the forward is kernel #4
    (``ops/rk45_cuda.py:march_planar_rk45_cuda``, with its iteration
    counts) and the backward the checkpoint kernels #9 / #10's planar rk45
    variant (``ops/ckpt_rk45_cuda.py``), in segments of 16 iterations;
  * CPU tensors, or ``backend='twin'``: the forward is the masked loop over
    the twin ``_planar_rk45_iter`` (the JAX package's XLA route) and the
    backward ``integrate/ckpt.py:ckpt_adjoint_backward`` under autograd on
    the same map, in segments of ~sqrt(max_iters) iterations.

The twin's right-hand sides are ``_guarded_deriv_fns``.  A checkpointed-
recompute backward evaluates each step on every ray, frozen or not, and a
wildly overshooting rejected trial still reaches err, and so dt; at a
horizon (A -> 0) or near l = 0 raw reciprocals give infinite partials, and
a zero cotangent times an infinite partial is NaN.  So every reciprocal
there is guarded, ``sign(x) / max(|x|, eps)``, and l and p_l are bounded.
The operations are grouped as in the JAX closures, so off the guards the
four closed-form kinds are the unguarded forms of the march kernels
(``ops/ckpt_adjoint_cuda.py:planar_deriv``, which transcribes
``csrc/planar.cuh:planar_deriv``) bit for bit: ``sign(x) / |x|`` has the
bits of ``1 / x``.

DNEG (``interstellar``) keeps the JAX closure's shape form (x clamped at
0, log(1 + x^2)), which equals the kernels' (log1p, a select at the
throat) to rounding, and differs by method from the JAX closure, which
evaluates atan with the degree-6 polynomial ``_ATAN6`` of the TPU kernels
even on its XLA route: here ``torch.atan`` is exact (the polynomial is on
the port's "do not port" list).  The difference is the polynomial's error,
about 1e-6 absolute in (2 / pi) atan.  The CUDA route replays with the
kernel's own RHS, unguarded, so that it takes #4's decisions, and guards
only the partials of its VJP (``csrc/rk45_vjp.cuh``).

Tabulated (``cheb{K}``) metrics raise: ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.integrate.adjoint import _planar_metric_grads
from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.integrate.rk45 import CAPPED, DP_A, DP_B4, DP_B5, _comb
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops import ckpt_rk45_cuda
from curvis_tpu_torch.ops.march_cuda import (_NO_CAPTURE,
                                             metric_kind_and_params)
from curvis_tpu_torch.ops.rk45_cuda import (jclip, march_planar_rk45_cuda,
                                            rk45_scalars)
from curvis_tpu_torch.physics.planar import (_CHECK_EVERY, PlanarRays,
                                             PlanarResult)


def _guarded_inv(x, eps):
    """sign(x) / max(|x|, eps): 1 / x off the guard, bounded on it."""
    return torch.sign(x) / torch.clamp(torch.abs(x), min=eps)


def _guarded_deriv_fns(kind):
    """``fns(p, l, p_l, b, b2) -> (dl, dpsi, dpl)`` with the metric slots
    ``p = (p0, p1, p2)`` of ``ops/march_cuda.py:metric_kind_and_params``:
    finite outputs and finite partials for any finite state (module
    docstring).  ``cheb{K}`` kinds raise: tabulated metrics are ROADMAP
    Queue 1 item 4."""
    if kind == "schwarzschild":
        def fns(p, l, p_l, b, b2):
            M = p[0]
            l = torch.clamp(l, -1e4, 1e4)
            p_l = torch.clamp(p_l, -1e4, 1e4)
            invl = _guarded_inv(l, 1e-4)
            invl2 = invl * invl
            A = 1.0 - 2.0 * M * invl
            invA = _guarded_inv(A, 1e-4)
            dl = A * p_l
            dpsi = b * invl2
            dpl = (-M * invl2) * (invA * invA + p_l * p_l) + b2 * invl2 * invl
            return dl, dpsi, dpl
        return fns
    if kind == "rn":
        def fns(p, l, p_l, b, b2):
            M, q2 = p[0], p[1]
            l = torch.clamp(l, -1e4, 1e4)
            p_l = torch.clamp(p_l, -1e4, 1e4)
            invl = _guarded_inv(l, 1e-4)
            invl2 = invl * invl
            A = 1.0 - (2.0 * M - q2 * invl) * invl
            invA = _guarded_inv(A, 1e-4)
            dl = A * p_l
            dpsi = b * invl2
            dpl = ((-(M - q2 * invl) * invl2) * (invA * invA + p_l * p_l)
                   + b2 * invl2 * invl)
            return dl, dpsi, dpl
        return fns
    if kind == "ellis":
        def fns(p, l, p_l, b, b2):
            rho = p[0]
            l = torch.clamp(l, -1e4, 1e4)
            r2 = rho * rho + l * l
            inv = 1.0 / torch.clamp(r2, min=1e-12)
            return p_l, b * inv, b2 * (l * inv * inv)
        return fns
    if kind == "flat":
        def fns(p, l, p_l, b, b2):
            l = torch.clamp(l, -1e4, 1e4)
            r2 = torch.clamp(l * l, min=1e-8)
            inv = 1.0 / r2
            r = torch.sqrt(r2)
            return p_l, b * inv, b2 * (inv / r)
        return fns
    if kind == "interstellar":
        def fns(p, l, p_l, b, b2):
            m, a, rho = p[0], p[1], p[2]
            l = torch.clamp(l, -1e4, 1e4)
            c = 2.0 / (math.pi * m)
            x = torch.clamp(c * (torch.abs(l) - a), min=0.0)
            atx2 = (2.0 / math.pi) * torch.atan(x)       # exact atan
            L = torch.log(1.0 + x * x)
            r = (rho + (0.5 * math.pi * m) * (x * atx2)) - (0.5 * m) * L
            dr = torch.where(l < 0, -atx2, atx2)
            ir = 1.0 / torch.clamp(r, min=1e-6)
            inv = ir * ir
            return p_l, b * inv, b2 * (dr * inv * ir)
        return fns
    if kind.startswith("cheb"):
        raise NotImplementedError(
            f"metric kind {kind!r}: tabulated (cheb{{K}}) metrics are "
            "ROADMAP Queue 1 item 4")
    raise NotImplementedError(
        f"planar guarded RHS: unsupported metric kind {kind!r}")


# ---------------------------------------------------------------------------
# the twin map (the JAX package's _planar_rk45_iter)
# ---------------------------------------------------------------------------

def metric_slots(metric: Metric, like):
    """(kind, (p0, p1, p2)) of the metric as 0-d tensors in its graph, the
    unused slots zeros like ``like``."""
    kind, params = metric_kind_and_params(metric)
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    return kind, tuple([t.reshape(()) for t in params]
                       + [zero] * (3 - len(params)))


def _rk45_trial(kind, consts, p, b, y, sg):
    """The trial half of the twin iteration on y = (l, psi, p_l, dt) ->
    ((ln, psin, pln), err, accept, esc_pos, esc_neg): the seven stages,
    the error norm (through ``sg``, the controller's stop-gradient) and the
    accept write-back with the escape interpolation."""
    rtol, atol, R = consts[0], consts[1], consts[4]
    deriv = _guarded_deriv_fns(kind)
    b2 = b * b
    l, psi, p_l, dt = y
    one = torch.ones_like(l)

    ks = []
    for i in range(7):
        li, pli = l, p_l
        for j, aa in enumerate(DP_A[i]):
            li = li + dt * aa * ks[j][0]
            pli = pli + dt * aa * ks[j][2]
        ks.append(deriv(p, li, pli, b, b2))

    d5l, d5p, d5pl = (_comb(DP_B5, ks, c, l) for c in range(3))
    e_l = d5l - _comb(DP_B4, ks, 0, l)
    e_p = d5p - _comb(DP_B4, ks, 1, l)
    e_pl = d5pl - _comb(DP_B4, ks, 2, l)
    l5 = l + dt * d5l
    psi5 = psi + dt * d5p
    pl5 = p_l + dt * d5pl

    def ec(e, y0, y1):
        return torch.abs(dt * e) / (atol + rtol * torch.maximum(
            torch.abs(y0), torch.abs(y1)))

    err = torch.maximum(ec(e_l, l, l5),
                        torch.maximum(ec(e_p, psi, psi5), ec(e_pl, p_l, pl5)))
    err = sg(err)
    accept = err <= 1.0
    esc_pos = accept & (l5 > R)
    esc_neg = accept & (l5 < -R)
    esc = esc_pos | esc_neg

    # the escape interpolation to |l| = R: part of the map in both modes
    target = torch.where(esc_pos, R, -R)
    denom = l5 - l
    denom = torch.where(torch.abs(denom) < 1e-30, one, denom)
    frac = jclip((target - l) / denom, 0.0, 1.0)
    frac = torch.where(esc, frac, one)
    ln = torch.where(accept, l + frac * (l5 - l), l)
    psin = torch.where(accept, psi + frac * (psi5 - psi), psi)
    pln = torch.where(accept, p_l + frac * (pl5 - p_l), p_l)
    return (ln, psin, pln), err, accept, esc_pos, esc_neg


def _rk45_next(consts, err, dt, terminal):
    """The controller's next dt: dt where ``terminal``, else clip(dt
    0.9 exp(-0.2 log max(err, 1e-10)), dt_min, dt_max), the factor clipped
    to [0.2, 5] and a NaN factor 0.2."""
    dt_min, dt_max = consts[2], consts[3]
    err_s = torch.maximum(err, torch.full_like(err, 1e-10))
    factor = jclip(0.9 * torch.exp(-0.2 * torch.log(err_s)), 0.2, 5.0)
    factor = torch.where(factor > 0.0, factor, 0.2)   # NaN guard
    return torch.where(terminal, dt, jclip(dt * factor, dt_min, dt_max))


def _planar_rk45_iter(kind, consts, theta, y, freeze=False):
    """One unmasked lock-step planar DP5(4) iteration on y = (l, psi, p_l,
    dt) -> (y1, (accept, esc_pos, esc_neg, cap_i, stall_i)): the JAX
    package's map, form for form.  ``consts`` = (rtol, atol, dt_min,
    dt_max, R, r_cap) as 0-d tensors of the state's dtype; theta = (p0, p1,
    p2, b).  ``freeze`` detaches the controller chain (err -> factor -> dt)
    and keeps the escape interpolation."""
    sg = (lambda x: x.detach()) if freeze else (lambda x: x)
    dt_min, r_cap = consts[2], consts[5]
    dt = y[3]
    (ln, psin, pln), err, accept, esc_pos, esc_neg = _rk45_trial(
        kind, consts, theta[:3], theta[3], y, sg)
    cap_i = accept & (ln < r_cap)
    stall_i = ~accept & (dt <= dt_min * 1.01)
    dtn = _rk45_next(consts, err, dt, esc_pos | esc_neg | cap_i | stall_i)
    return ((ln, psin, pln, sg(dtn)),
            (accept, esc_pos, esc_neg, cap_i, stall_i))


def _planar_rk45_step(kind, consts, theta, y, freeze=False):
    """The bare 4-state map (flags dropped): what the replay
    differentiates."""
    return _planar_rk45_iter(kind, consts, theta, y, freeze)[0]


def _forward_twin(kind, consts, theta, state, dt0, max_steps, max_iters):
    """The masked lock-step march on the same map the backward replays ->
    ((l, psi, p_l, sign, steps), iters)."""
    l0, psi0, pl0 = state
    y = (l0, psi0, pl0, torch.full_like(l0, dt0))
    sign = torch.zeros(l0.shape, dtype=torch.int32, device=l0.device)
    steps = torch.zeros_like(sign)
    iters = torch.zeros_like(sign)
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        iters = iters + active.to(torch.int32)
        y1, (accept, esc_pos, esc_neg, cap_i, stall_i) = _planar_rk45_iter(
            kind, consts, theta, y)
        y = tuple(torch.where(active, a1, a0) for a0, a1 in zip(y, y1))
        # the additive fate update of the kernel (the flags are disjoint for
        # physical rays)
        dsign = (esc_pos.to(torch.int32) - esc_neg.to(torch.int32)
                 + 2 * cap_i.to(torch.int32))
        sign = torch.where(active, sign + dsign, sign)
        sign = torch.where(active & stall_i, 3, sign)
        steps = steps + (active & accept).to(torch.int32)
        sign = torch.where((sign == 0) & (steps >= max_steps), CAPPED,
                           sign).to(torch.int32)
    sign = torch.where(sign == CAPPED, 0, sign).to(torch.int32)
    return (y[0], y[1], y[2], sign, steps), iters


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _consts(metric, rtol, atol, dt_min, dt_max, R, like):
    """(rtol, atol, dt_min, dt_max, R, r_cap) as 0-d tensors of ``like``'s
    dtype and device."""
    r_cap = getattr(metric, "capture_radius", None)
    r_cap = float(_NO_CAPTURE if r_cap is None else r_cap)
    return tuple(torch.tensor(float(v), dtype=like.dtype, device=like.device)
                 for v in (rtol, atol, dt_min, dt_max, R, r_cap))


class _Rk45Adjoint(torch.autograd.Function):
    """(l, psi, p_l, b, *metric fields) -> (l, psi, p_l, sign, steps);
    ``cfg`` = (metric, dt0, max_steps, max_iters, R, rtol, atol, dt_min,
    dt_max, segment, freeze, twin)."""

    @staticmethod
    def forward(ctx, cfg, l, psi, p_l, b, *fields):
        (metric, dt0, max_steps, max_iters, R, rtol, atol, dt_min, dt_max,
         _, _, twin) = cfg
        if l.device.type == "cuda" and not twin:
            rays = PlanarRays(l=l, psi=psi, p_l=p_l, b=b, r_hat=None,
                              e2=None)
            res, iters = march_planar_rk45_cuda(
                metric, rays, escape_radius=R, max_steps=max_steps,
                max_iters=max_iters, rtol=rtol, atol=atol, dt0=dt0,
                dt_max=dt_max, return_iters=True)
            out = tuple(res)
        else:
            kind, p = metric_slots(metric, l)
            consts = _consts(metric, rtol, atol, dt_min, dt_max, R, l)
            with torch.no_grad():
                out, iters = _forward_twin(kind, consts, (*p, b),
                                           (l, psi, p_l), dt0, max_steps,
                                           max_iters)
        ctx.cfg = cfg
        ctx.save_for_backward(l, psi, p_l, b, out[3], iters, *fields)
        ctx.mark_non_differentiable(out[3], out[4])
        return out

    @staticmethod
    def backward(ctx, g_l, g_psi, g_pl, _g_sign, _g_steps):
        (metric, dt0, _, max_iters, R, rtol, atol, dt_min, dt_max, segment,
         freeze, twin) = ctx.cfg
        l0, psi0, pl0, b, sign, iters, *fields = ctx.saved_tensors
        # smooth fates only: escaped (+-1) and capped (0) rays
        smooth = (sign == 0) | (sign == 1) | (sign == -1)
        zero = torch.zeros_like(l0)
        cot = tuple(torch.where(smooth, c, zero) for c in (g_l, g_psi, g_pl))
        cot = cot + (zero,)
        counts = torch.where(smooth, iters, torch.zeros_like(iters))
        b = torch.broadcast_to(b, l0.shape)
        if l0.device.type == "cuda" and not twin:
            kind, scal = rk45_scalars(metric, dt0, R, rtol, atol, dt_max)
            flat = [t.reshape(-1).contiguous() for t in (l0, psi0, pl0, b)]
            g, lam = ckpt_rk45_cuda.ckpt_rk45_backward_cuda(
                kind, scal, freeze, tuple(flat[:3]), flat[3],
                counts.reshape(-1).contiguous(),
                torch.stack([c.reshape(-1) for c in cot]).contiguous(),
                seg=segment or ckpt_rk45_cuda.SEG)
            g_p = tuple(torch.sum(g[i]) for i in range(3))
            g_b = g[3].reshape(l0.shape)
            lam = tuple(a.reshape(l0.shape) for a in lam)
        else:
            kind, p = metric_slots(metric, l0)
            consts = _consts(metric, rtol, atol, dt_min, dt_max, R, l0)
            y0 = (l0, psi0, pl0, torch.full_like(l0, dt0))

            def step(theta, y):
                return _planar_rk45_step(kind, consts, theta, y, freeze)
            d_theta, lam = ckpt_adjoint_backward(
                step, (*p, b), y0, counts, cot, max_steps=max_iters,
                segment=segment or max(1, int(math.sqrt(max_iters))))
            g_p, g_b = d_theta[:3], d_theta[3]
        g_fields = _planar_metric_grads(metric, g_p)
        g_fields = tuple(g.to(f.dtype) for g, f in zip(g_fields, fields))
        # lam[3], the dt0 cotangent, is dropped: dt0 is a solver knob
        return (None, lam[0], lam[1], lam[2], g_b, *g_fields)


def march_planar_rk45_adjoint(metric: Metric, state, b, *, dt0, max_steps,
                              escape_radius, rtol=1e-5, atol=1e-7,
                              dt_min=1e-6, dt_max=10.0, max_iters=None,
                              backend="auto", segment=None,
                              freeze_controller=False):
    """Differentiable error-controlled planar march: ``state`` = (l, psi,
    p_l); returns (l, psi, p_l, sign, steps).  Gradients flow to the
    metric's parameters, ``state`` and ``b``.  The forward is kernel #4 on
    CUDA tensors (``backend='auto'``) and the twin loop otherwise
    (``backend='twin'``, or CPU tensors).  ``max_iters`` bounds the forward
    iterations and the backward replay (default 4 max_steps);
    ``segment`` the iterations re-marched per recompute (default 16 on the
    kernel route, ~sqrt(max_iters) on the twin)."""
    if backend not in ("auto", "twin"):
        raise ValueError(f"backend must be 'auto' or 'twin', got {backend!r}")
    l = state[0]
    twin = backend == "twin"
    if l.device.type == "cuda" and not twin and dt_min != 1e-6:
        raise ValueError(
            "the CUDA forward (kernel #4) hardcodes its dt floor at 1e-6; "
            "the replay must use the same dt_min or knife-edge stall "
            "decisions diverge")
    if max_iters is None:
        max_iters = 4 * max_steps
    fields = tuple(getattr(metric, f) for f in metric.fields)
    cfg = (metric, float(dt0), int(max_steps), int(max_iters),
           float(escape_radius), float(rtol), float(atol), float(dt_min),
           float(dt_max), int(segment) if segment else 0,
           bool(freeze_controller), twin)
    shape = l.shape
    return _Rk45Adjoint.apply(cfg, l, *(torch.broadcast_to(t, shape)
                                        for t in (state[1], state[2], b)),
                              *fields)


def march_planar_rk45_adjoint_rays(metric: Metric, rays: PlanarRays, *, dt0,
                                   max_steps, escape_radius, **kw
                                   ) -> PlanarResult:
    """PlanarRays-facing wrapper with the standard result contract."""
    return PlanarResult(*march_planar_rk45_adjoint(
        metric, (rays.l, rays.psi, rays.p_l), rays.b, dt0=dt0,
        max_steps=max_steps, escape_radius=escape_radius, **kw))
