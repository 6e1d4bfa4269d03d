"""Differentiable planar disk marches (PyTorch): the Euler half of
``curvis_tpu/integrate/planar_surface_adjoint.py``.

Two marches of the disk routes become differentiable through their
crossings and their radiative transfer, with the checkpointed-recompute
machinery of ``integrate/ckpt.py`` run on extended step maps:

  * the thin disk (kernel #5): the state gains the incrementally rotated
    (u, v) = (cos psi, sin psi) and the two crossing triples (r, p_l, psi),
    11 values; the crossing is interpolated on zq = c1 u + c2 v, not on
    z = r(l) zq (the kernel's contract; the non-differentiable CPU march,
    ``render/disk.py:march_planar_disk``, crosses on z);
  * the volumetric disk (kernel #6): the state gains (u, v) and the
    transfer sums (tau, em_r, em_g, em_b), 9 values, and the parameters
    gain the (10,) emission row of ``integrate/kerr_surface_adjoint.py:
    build_vol_row``, so that ``disk_theta`` overrides reach the march.

Gradients flow to the metric's parameters, the spawn state (l, psi, p_l),
the conserved b, the plane coefficients (c1, c2) and nz, and the emission
row (the thin disk's recording band gets zero: it is a gate).

Fate policy (the JAX package's): final-state cotangents flow only for the
smooth fates, escaped (+-1) and capped (0); the hit, tau and emission
cotangents flow for every ray whose sign is not 3, captured and opaque
(sign 2) rays included, because the disk seen in front of the shadow is
the signal; a blown-up ray (sign 3, which the Euler marches never give)
would be excluded.  The step maps' guarded RHS
(``integrate/rk45_adjoint_planar.py``) keeps the frozen captured states
that the CPU route's masked replay evaluates finite.

Routes, by the device of the inputs:

  * CUDA tensors (float32): the forward is the production kernel, #5
    (``ops/disk_cuda.py``) or #6 (``ops/disk_vol_cuda.py``), and the
    backward kernels #9 / #10's surface variants
    (``ops/ckpt_surface_cuda.py``), in segments of 32 steps;
  * CPU tensors, or ``backend='twin'`` on any device: the forward is the
    masked loop over the step twin (the JAX package's XLA route) and
    the backward ``integrate/ckpt.py:ckpt_adjoint_backward`` under autograd
    on the twin, in segments of ~sqrt(max_steps) steps.

``stepper='rk45'`` (the adaptive surfaces) is ROADMAP Queue 1 item 3.
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.integrate.adjoint import _planar_metric_grads
from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.integrate.kerr_surface_adjoint import build_vol_row
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
from curvis_tpu_torch.ops import disk_cuda, disk_vol_cuda
from curvis_tpu_torch.ops.march_cuda import (_NO_CAPTURE,
                                             metric_kind_and_params,
                                             march_scalars)
from curvis_tpu_torch.physics import planar as pl

_RK45_ITEM = ("the differentiable rk45 disk marches (the rk45 half of "
              "integrate/planar_surface_adjoint.py, after the planar rk45 "
              "adjoint) are ROADMAP Queue 1 item 3")


# ---------------------------------------------------------------------------
# step twins (the JAX package's _pl_disk_step / _pl_vol_step)
# ---------------------------------------------------------------------------

def _disk_step(kind, dt, theta, y):
    """11-state Euler thin-disk map (``ops/ckpt_surface_cuda.py:disk_step``
    without the slot flags)."""
    return cs.disk_step(kind, dt, theta, y)[0]


_vol_step = cs.vol_step          # 9-state Euler volumetric map


def _forward_twin(step, y0, escape_radius, r_cap, max_steps, tau_max=None):
    """The masked march of ``step`` from ``y0``: after each step a live ray
    escapes on strict l > R (+1) or l < -R (-1), is captured below
    ``r_cap`` (2), and, for the volumetric map, is frozen as opaque (2)
    once tau > ``tau_max`` -> (y, sign, steps)."""
    y = tuple(y0)
    l = y[0]
    sign = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % pl._CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        y1 = step(y)
        y = tuple(torch.where(active, a1, a0) for a0, a1 in zip(y, y1))
        ln = y[0]
        sign = torch.where(active & (ln > escape_radius), 1,
                           torch.where(active & (ln < -escape_radius), -1,
                                       sign))
        sign = torch.where(active & (ln < r_cap), pl.CAPTURED, sign)
        if tau_max is not None:
            sign = torch.where((sign == 0) & (y[5] > tau_max), pl.CAPTURED,
                               sign)
        sign = sign.to(torch.int32)
        steps = steps + active.to(torch.int32)
    return y, sign, steps


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _slots(metric, like):
    """(kind, (p0, p1, p2)) of the metric as 0-d tensors in its graph, the
    unused slots zeros like ``like``."""
    kind, params = metric_kind_and_params(metric)
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    return kind, tuple([t.reshape(()) for t in params]
                       + [zero] * (3 - len(params)))


class _SurfaceAdjoint(torch.autograd.Function):
    """(l, psi, p_l, b, c1, c2, nz, surf, *metric fields) -> (l, psi, p_l,
    sign, steps, *extras): extras = (h1, h1p, h1s, h2, h2p, h2s) for the
    thin disk, (tau, em_r, em_g, em_b) for the volumetric one.  ``cfg`` =
    (metric, flags, dt, max_steps, escape_radius, twin): ``flags`` None for
    the thin disk, else (blackbody, redshift, doppler, scatter)."""

    @staticmethod
    def forward(ctx, cfg, l, psi, p_l, b, c1, c2, nz, surf, *fields):
        metric, flags, dt, max_steps, R, twin = cfg
        if l.device.type == "cuda" and not twin:
            outs = _forward_kernel(metric, flags, dt, max_steps, R, l, psi,
                                   p_l, b, c1, c2, nz, surf)
        else:
            outs = _forward_twin_route(metric, flags, dt, max_steps, R, l,
                                       psi, p_l, b, c1, c2, nz, surf)
        ctx.cfg = cfg
        ctx.save_for_backward(l, psi, p_l, b, c1, c2, nz, surf, outs[3],
                              outs[4], *fields)
        ctx.mark_non_differentiable(outs[3], outs[4])
        return outs

    @staticmethod
    def backward(ctx, g_l, g_psi, g_pl, _g_sign, _g_steps, *g_ex):
        metric, flags, dt, max_steps, R, twin = ctx.cfg
        (l0, psi0, pl0, b, c1, c2, nz, surf, sign, steps,
         *fields) = ctx.saved_tensors
        smooth = (sign == 0) | (sign == 1) | (sign == -1)
        replay = sign != 3
        zero = torch.zeros_like(l0)
        cot = tuple(torch.where(smooth, c, zero) for c in (g_l, g_psi, g_pl))
        cot = cot + (zero, zero) + tuple(torch.where(replay, c, zero)
                                         for c in g_ex)
        counts = torch.where(replay, steps, torch.zeros_like(steps))
        vol = flags is not None
        n_surf = surf.shape[0]
        if l0.device.type == "cuda" and not twin:
            g_theta, lam = _backward_kernel(metric, flags, dt, R, surf, l0,
                                            psi0, pl0, b, c1, c2, nz,
                                            counts, cot)
            g_p = tuple(torch.sum(g_theta[i]) for i in range(3))
            k = 7 if vol else 6
            g_b, g_c1, g_c2 = g_theta[3], g_theta[4], g_theta[5]
            g_nz = g_theta[6] if vol else None
            g_surf = torch.sum(g_theta[k:k + n_surf], dim=1)
        else:
            g_p, g_b, g_c1, g_c2, g_nz, g_surf, lam = _backward_twin(
                metric, flags, dt, max_steps, surf, l0, psi0, pl0, b, c1,
                c2, nz, counts, cot)
        # (u0, v0) = (cos, sin)(psi0)
        g_psi0 = lam[1] - lam[3] * torch.sin(psi0) + lam[4] * torch.cos(psi0)
        g_fields = _planar_metric_grads(metric, g_p)
        g_fields = tuple(g.to(f.dtype) for g, f in zip(g_fields, fields))
        return (None, lam[0], g_psi0, lam[2], g_b, g_c1, g_c2, g_nz,
                g_surf.to(surf.dtype), *g_fields)


def _forward_twin_route(metric, flags, dt, max_steps, R, l, psi, p_l, b,
                        c1, c2, nz, surf):
    kind, p = _slots(metric, l)
    r_cap = getattr(metric, "capture_radius", None)
    r_cap = float(_NO_CAPTURE if r_cap is None else r_cap)
    zero = torch.zeros_like(l)
    y0 = (l, psi, p_l, torch.cos(psi), torch.sin(psi))
    with torch.no_grad():
        if flags is None:
            theta = (*p, b, c1, c2, surf[0], surf[1])
            y, sign, steps = _forward_twin(
                lambda y: _disk_step(kind, dt, theta, y), y0 + (zero,) * 6,
                R, r_cap, max_steps)
        else:
            theta = (*p, b, c1, c2, nz, surf)
            y, sign, steps = _forward_twin(
                lambda y: _vol_step(kind, flags, dt, theta, y),
                y0 + (zero,) * 4, R, r_cap, max_steps, tau_max=surf[5])
    return (y[0], y[1], y[2], sign, steps, *y[5:])


def _backward_twin(metric, flags, dt, max_steps, surf, l0, psi0, pl0, b, c1,
                   c2, nz, counts, cot):
    kind, p = _slots(metric, l0)
    zero = torch.zeros_like(l0)
    y0 = (l0, psi0, pl0, torch.cos(psi0), torch.sin(psi0))
    if flags is None:
        y0 = y0 + (zero,) * 6
        theta = (*p, b, c1, c2, surf)

        def step(th, y):
            return _disk_step(kind, dt, (*th[:6], th[6][0], th[6][1]), y)
    else:
        y0 = y0 + (zero,) * 4
        theta = (*p, b, c1, c2, nz, surf)

        def step(th, y):
            return _vol_step(kind, flags, dt, th, y)
    d_theta, lam = ckpt_adjoint_backward(
        step, theta, y0, counts, cot, max_steps=max_steps,
        segment=max(1, int(math.sqrt(max_steps))))
    g_nz = d_theta[6] if flags is not None else None
    return (d_theta[:3], d_theta[3], d_theta[4], d_theta[5], g_nz,
            d_theta[-1], lam)


def _forward_kernel(metric, flags, dt, max_steps, R, l, psi, p_l, b, c1, c2,
                    nz, surf):
    rays = pl.PlanarRays(l, psi, p_l, b, None, None)
    host = surf.detach().cpu().tolist()
    if flags is None:
        res, h1, h2 = disk_cuda.march_planar_disk_cuda(
            metric, rays, c1, c2, dt=dt, max_steps=max_steps,
            escape_radius=R, r_inner=host[0], r_outer=host[1])
        return (*res, *h1, *h2)
    kind, head = march_scalars(metric, dt, R)
    ins = [disk_cuda._flat_f32(t) for t in (l, psi, p_l, b, c1, c2, nz)]
    outs = disk_vol_cuda.launch(kind, flags, head + host, *ins,
                                max_steps=max_steps)
    return tuple(o.reshape(l.shape) for o in outs)


def _backward_kernel(metric, flags, dt, R, surf, l0, psi0, pl0, b, c1, c2,
                     nz, counts, cot):
    kind, head = march_scalars(metric, dt, R)
    scal = head + surf.detach().cpu().tolist()
    flat = [t.reshape(-1).contiguous()
            for t in (l0, psi0, pl0, b, c1, c2, nz)]
    cot = torch.stack([c.reshape(-1) for c in cot]).contiguous()
    g, lam = cs.ckpt_surface_backward_cuda(
        kind, flags, scal, tuple(flat[:3]), *flat[3:], counts.reshape(-1),
        cot)
    shape = l0.shape
    return g.reshape(-1, *shape), lam.reshape(-1, *shape)


def _common(metric, state, b, c1, c2, nz, surf, flags, *, stepper, dt,
            max_steps, escape_radius, backend):
    if stepper != "euler":
        if stepper == "rk45":
            raise NotImplementedError(_RK45_ITEM)
        pl.check_stepper(stepper)
    if backend not in ("auto", "twin"):
        raise ValueError(f"backend must be 'auto' or 'twin', got {backend!r}")
    l, psi, p_l = state
    shape = l.shape
    b, c1, c2 = (torch.broadcast_to(t, shape) for t in (b, c1, c2))
    nz = torch.zeros_like(l) if nz is None else torch.broadcast_to(nz, shape)
    fields = tuple(getattr(metric, f) for f in metric.fields)
    cfg = (metric, flags, float(dt), int(max_steps), float(escape_radius),
           backend == "twin")
    out = _SurfaceAdjoint.apply(cfg, l, psi, p_l, b, c1, c2, nz, surf,
                                *fields)
    return tuple(out[:5]), out[5:]


def march_planar_disk_adjoint(metric: Metric, state, b, c1, c2, *, dt,
                              max_steps, escape_radius, r_inner, r_outer,
                              stepper="euler", backend="auto"):
    """Differentiable thin-disk march: ``state`` = (l, psi, p_l); returns
    (l, psi, p_l, sign, steps, ((h1, h1p, h1s), (h2, h2p, h2s))), the
    contract of ``ops/disk_cuda.py:march_planar_disk_cuda``.  The forward
    is kernel #5 on CUDA tensors (``backend='auto'``) and the twin loop
    otherwise (``backend='twin'``, or CPU tensors)."""
    l = state[0]
    surf = torch.tensor([float(r_inner), float(r_outer)], dtype=l.dtype,
                        device=l.device)
    st, ex = _common(metric, state, b, c1, c2, None, surf, None,
                     stepper=stepper, dt=dt, max_steps=max_steps,
                     escape_radius=escape_radius, backend=backend)
    return (*st, ((ex[0], ex[1], ex[2]), (ex[3], ex[4], ex[5])))


def march_planar_vol_adjoint(metric: Metric, state, b, c1, c2, nz, disk, *,
                             dt, max_steps, escape_radius, disk_theta=None,
                             scatter_block=None, stepper="euler",
                             backend="auto"):
    """Differentiable volumetric march through ``disk`` (a DiskParams):
    returns (l, psi, p_l, sign, steps, (tau, (em_r, em_g, em_b))).  The
    emission row is ``build_vol_row(disk, disk_theta)``, so tensors in
    ``disk_theta`` get gradients through the march; ``scatter_block``: the
    (SCATTER_BLOCK,) in-gas starlight coefficients
    (``render/starlight.py:starlight_scatter_block``), a tensor that gets
    its gradient too.  Routes as in ``march_planar_disk_adjoint``."""
    l = state[0]
    surf = build_vol_row(disk, disk_theta, dtype=l.dtype, device=l.device)
    if scatter_block is not None:
        surf = torch.cat([surf, torch.as_tensor(scatter_block, dtype=l.dtype,
                                                device=l.device)])
    flags = (disk.color_mode == "blackbody", bool(disk.redshift),
             bool(disk.doppler), scatter_block is not None)
    st, ex = _common(metric, state, b, c1, c2, nz, surf, flags,
                     stepper=stepper, dt=dt, max_steps=max_steps,
                     escape_radius=escape_radius, backend=backend)
    return (*st, (ex[0], (ex[1], ex[2], ex[3])))
