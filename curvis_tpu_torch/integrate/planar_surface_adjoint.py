"""Differentiable planar disk marches (PyTorch): counterpart of
``curvis_tpu/integrate/planar_surface_adjoint.py``.

Two marches of the disk routes become differentiable through their
crossings and their radiative transfer, with the checkpointed-recompute
machinery of ``integrate/ckpt.py`` run on extended step maps, for both
steppers:

  * Euler thin disk (kernel #5): the state gains the incrementally rotated
    (u, v) = (cos psi, sin psi) and the two crossing triples (r, p_l, psi),
    11 values; the crossing is interpolated on zq = c1 u + c2 v, not on
    z = r(l) zq (the kernel's contract; the non-differentiable CPU march,
    ``render/disk.py:march_planar_disk``, crosses on z);
  * Euler volumetric (kernel #6): the state gains (u, v) and the transfer
    sums (tau, em_r, em_g, em_b), 9 values, and the parameters gain the
    (10,) emission row of ``integrate/kerr_surface_adjoint.py:
    build_vol_row``, so that ``disk_theta`` overrides reach the march;
  * rk45 thin disk / volumetric (kernel #4's track_disk / vol variants):
    the 4-state controller map of ``integrate/rk45_adjoint_planar.py``
    (l, psi, p_l, dt) gains the hit triples (10 values) or the transfer
    sums (8); zq is recomputed from psi, as the kernel does, and the
    kernel's anticipatory plane / gas-slab dt clamps are part of the
    replayed controller chain.  ``rtol`` (atol default rtol 1e-3),
    ``dt_min``, ``dt_max``, ``max_iters`` (default 4 max_steps, rounded up
    to even), ``segment`` and ``freeze_controller`` (which also stops the
    clamps) are those of the JAX module.

Gradients flow to the metric's parameters, the spawn state (l, psi, p_l),
the conserved b, the plane coefficients (c1, c2) and nz, and the emission
row (the thin disk's recording band gets zero: it is a gate).

Fate policy (the JAX package's): final-state cotangents flow only for the
smooth fates, escaped (+-1) and capped (0); the hit, tau and emission
cotangents flow for every ray whose sign is not 3, captured and opaque
(sign 2) rays included, because the disk seen in front of the shadow is
the signal; a stalled or blown-up ray (sign 3) is excluded.  The step
maps' guarded RHS (``integrate/rk45_adjoint_planar.py``) keeps the frozen
captured states that the CPU route's masked replay evaluates finite.  The
dt0 cotangent is dropped.

Routes, by the device of the inputs:

  * CUDA tensors (float32): the forward is the production kernel, #5
    (``ops/disk_cuda.py``), #6 (``ops/disk_vol_cuda.py``) or #4's surface
    variants (``ops/rk45_disk_cuda.py``), and the backward kernels #9 /
    #10's surface variants (``ops/ckpt_surface_cuda.py``), in segments of
    32 steps (Euler) or 16 iterations (rk45);
  * CPU tensors, or ``backend='twin'`` on any device: the forward is the
    masked loop over the step twin (the JAX package's XLA route) and
    the backward ``integrate/ckpt.py:ckpt_adjoint_backward`` under autograd
    on the twin, in segments of ~sqrt(max_steps) steps (~sqrt(max_iters)
    iterations).
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.integrate.adjoint import _planar_metric_grads
from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.integrate.kerr_surface_adjoint import build_vol_row
from curvis_tpu_torch.integrate.rk45 import CAPPED
from curvis_tpu_torch.integrate.rk45_adjoint_planar import (_consts,
                                                            _rk45_next,
                                                            _rk45_trial,
                                                            metric_slots)
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
from curvis_tpu_torch.ops import disk_cuda, disk_vol_cuda, rk45_disk_cuda
from curvis_tpu_torch.ops.disk_cuda import LAPSE_KINDS
from curvis_tpu_torch.ops.disk_vol_cuda import inv_r2_plain, vol_row_of
from curvis_tpu_torch.ops.march_cuda import (_NO_CAPTURE, march_scalars,
                                             refuse_table)
from curvis_tpu_torch.ops.rk45_cuda import jclip, rk45_scalars
from curvis_tpu_torch.physics import planar as pl

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
# the rk45 twin (the JAX package's _pl_rk45_surface_iter)
# ---------------------------------------------------------------------------

def _pl_rk45_surface_iter(kind, flags, consts, theta, y, freeze=False):
    """One rk45 surface iteration: ``consts`` = (rtol, atol, dt_min, dt_max,
    R, r_cap, dt0) as 0-d tensors, theta = (p0, p1, p2, b, c1, c2, surf)
    (thin, ``flags`` None; surf = (r_in, r_out)) or (p0, p1, p2, b, c1, c2,
    nz, surf) (vol; surf the emission row [+ scatter block]); y = (l, psi,
    p_l, dt) + the six hit values | (tau, em_r, em_g, em_b) -> (y1,
    (accept, esc_pos, esc_neg, cap_i, stall_i, opaque_i)).  ``freeze``
    detaches the controller chain and the clamps."""
    sg = (lambda x: x.detach()) if freeze else (lambda x: x)
    dt_min, r_cap, dt0 = consts[2], consts[5], consts[6]
    vol = flags is not None
    if vol:
        p0, p1, p2, b, c1, c2, nz, surf = theta
    else:
        p0, p1, p2, b, c1, c2, surf = theta
    p = (p0, p1, p2)
    r_in, r_out = surf[0], surf[1]
    l, psi, p_l, dt = y[:4]
    ex = y[4:]
    (ln, psin, pln), err, accept, esc_pos, esc_neg = _rk45_trial(
        kind, consts[:6], p, b, y[:4], sg)
    esc = esc_pos | esc_neg
    zq_prev = c1 * torch.cos(psi) + c2 * torch.sin(psi)
    zq_new = c1 * torch.cos(psin) + c2 * torch.sin(psin)
    opaque_i = torch.zeros_like(accept)
    if vol:
        tau, emr, emg, emb = ex
        dtau, dem = disk_vol_cuda.vol_emission_plain(
            kind, flags, vol_row_of(p, surf), ln, pln, b, zq_new, tau, nz)
        zero = torch.zeros_like(tau)
        ex = (tau + torch.where(accept, dt * dtau, zero),
              *(e + torch.where(accept, dt * d, zero)
                for e, d in zip((emr, emg, emb), dem)))
    else:
        h1, h1p, h1s, h2, h2p, h2s = ex
        crossed = accept & (zq_prev * zq_new < 0.0)
        cden = torch.abs(zq_prev) + torch.abs(zq_new)
        cfrac = torch.abs(zq_prev) / jclip(cden, 1e-30, None)
        lh = l + cfrac * (ln - l)             # signed (kernel contract)
        r_hit = torch.abs(lh)
        pl_hit = p_l + cfrac * (pln - p_l)
        psi_hit = psi + cfrac * (psin - psi)
        in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
        new1 = in_disk & (h1 == 0.0)
        new2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
        ex = (torch.where(new1, lh, h1), torch.where(new1, pl_hit, h1p),
              torch.where(new1, psi_hit, h1s), torch.where(new2, lh, h2),
              torch.where(new2, pl_hit, h2p), torch.where(new2, psi_hit, h2s))
    cap_i = accept & (ln < r_cap)
    if vol:
        opaque_i = ~(esc | cap_i) & (ex[0] > surf[2 + 3])    # tau_max
    stall_i = ~accept & (dt <= dt_min * 1.01)
    terminal = esc | cap_i | stall_i | opaque_i
    dtn = _rk45_next(consts, err, dt, terminal)
    if vol:
        # the anticipatory gas-slab clamp (the kernel's planar-vol rule)
        if kind in LAPSE_KINDS:
            rl = ln
        else:
            rl = torch.rsqrt(jclip(inv_r2_plain(kind, p, ln), 1e-30, None))
        r_cyl = rl * torch.sqrt(jclip(1.0 - zq_new * zq_new, 1e-12, 1.0))
        gap_r = r_cyl - (r_out + 2.0)
        gap_z = rl * torch.abs(zq_new) - 5.0 * torch.sqrt(surf[2]) * r_cyl
        dt_gas = torch.maximum(dt0, 0.5 * torch.maximum(gap_r, gap_z))
        dtn = torch.where(terminal, dtn, torch.minimum(dtn, dt_gas))
    else:
        # the anticipatory plane-distance clamp (the planar-disk rule)
        near = torch.abs(ln) < (r_out + 2.0)
        dt_pl = torch.maximum(dt0, 0.2 * torch.abs(ln) * torch.abs(zq_new))
        dtn = torch.where(near & ~terminal, torch.minimum(dtn, dt_pl), dtn)
    return ((ln, psin, pln, sg(dtn)) + tuple(ex),
            (accept, esc_pos, esc_neg, cap_i, stall_i, opaque_i))


def _forward_twin_rk45(kind, flags, consts, theta, state, max_steps,
                       max_iters):
    """The masked lock-step march of ``_pl_rk45_surface_iter`` -> (y, sign,
    steps, iters)."""
    l0, psi0, pl0 = state
    zero = torch.zeros_like(l0)
    y = (l0, psi0, pl0, torch.ones_like(l0) * consts[6]) + (zero,) * (
        4 if flags is not None else 6)
    sign = torch.zeros(l0.shape, dtype=torch.int32, device=l0.device)
    steps = torch.zeros_like(sign)
    iters = torch.zeros_like(sign)
    for it in range(max_iters):
        if it % pl._CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        iters = iters + active.to(torch.int32)
        y1, (accept, esc_pos, esc_neg, cap_i, stall_i, opaque_i) = \
            _pl_rk45_surface_iter(kind, flags, consts, theta, y)
        y = tuple(torch.where(active, a1, a0) for a0, a1 in zip(y, y1))
        dsign = (esc_pos.to(torch.int32) - esc_neg.to(torch.int32)
                 + 2 * cap_i.to(torch.int32))
        sign = torch.where(active, sign + dsign, sign)
        sign = torch.where(active & opaque_i & (sign == 0), pl.CAPTURED, sign)
        sign = torch.where(active & stall_i, 3, sign)
        steps = steps + (active & accept).to(torch.int32)
        sign = torch.where((sign == 0) & (steps >= max_steps), CAPPED,
                           sign).to(torch.int32)
    sign = torch.where(sign == CAPPED, 0, sign).to(torch.int32)
    return y, sign, steps, iters


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

class _SurfaceAdjoint(torch.autograd.Function):
    """(l, psi, p_l, b, c1, c2, nz, surf, *metric fields) -> (l, psi, p_l,
    sign, steps, *extras): extras = (h1, h1p, h1s, h2, h2p, h2s) for the
    thin disk, (tau, em_r, em_g, em_b) for the volumetric one.  ``cfg`` =
    (metric, flags, dt, max_steps, escape_radius, twin, rk): ``flags`` None
    for the thin disk, else (blackbody, redshift, doppler, scatter); ``rk``
    None for Euler, else the rk45 settings (rtol, atol, dt_min, dt_max,
    max_iters, segment, freeze)."""

    @staticmethod
    def forward(ctx, cfg, l, psi, p_l, b, c1, c2, nz, surf, *fields):
        metric, flags, dt, max_steps, R, twin, rk = cfg
        kernel = l.device.type == "cuda" and not twin
        if rk is not None:
            route = _forward_kernel_rk45 if kernel else _forward_twin_rk45_route
            outs, counts = route(metric, flags, dt, max_steps, R, rk, l, psi,
                                 p_l, b, c1, c2, nz, surf)
        else:
            route = _forward_kernel if kernel else _forward_twin_route
            outs = route(metric, flags, dt, max_steps, R, l, psi, p_l, b, c1,
                         c2, nz, surf)
            counts = outs[4]
        ctx.cfg = cfg
        ctx.save_for_backward(l, psi, p_l, b, c1, c2, nz, surf, outs[3],
                              counts, *fields)
        ctx.mark_non_differentiable(outs[3], outs[4])
        return outs

    @staticmethod
    def backward(ctx, g_l, g_psi, g_pl, _g_sign, _g_steps, *g_ex):
        metric, flags, dt, max_steps, R, twin, rk = ctx.cfg
        (l0, psi0, pl0, b, c1, c2, nz, surf, sign, counts,
         *fields) = ctx.saved_tensors
        smooth = (sign == 0) | (sign == 1) | (sign == -1)
        replay = sign != 3
        zero = torch.zeros_like(l0)
        cot = tuple(torch.where(smooth, c, zero) for c in (g_l, g_psi, g_pl))
        # Euler: (u, v) get none; rk45: dt gets none
        cot = cot + (zero,) * (2 if rk is None else 1) + tuple(
            torch.where(replay, c, zero) for c in g_ex)
        counts = torch.where(replay, counts, torch.zeros_like(counts))
        vol = flags is not None
        n_surf = surf.shape[0]
        args = (metric, flags, dt, R, surf, l0, psi0, pl0, b, c1, c2, nz,
                counts, cot)
        if l0.device.type == "cuda" and not twin:
            g_theta, lam = (_backward_kernel(*args) if rk is None
                            else _backward_kernel_rk45(rk, *args))
            g_p = tuple(torch.sum(g_theta[i]) for i in range(3))
            k = 7 if vol else 6
            g_b, g_c1, g_c2 = g_theta[3], g_theta[4], g_theta[5]
            g_nz = g_theta[6] if vol else None
            g_surf = torch.sum(g_theta[k:k + n_surf], dim=1)
        else:
            g_p, g_b, g_c1, g_c2, g_nz, g_surf, lam = _backward_twin(
                max_steps, rk, *args)
        g_psi0 = lam[1]
        if rk is None:
            # (u0, v0) = (cos, sin)(psi0)
            g_psi0 = g_psi0 - lam[3] * torch.sin(psi0) \
                + lam[4] * torch.cos(psi0)
        g_fields = _planar_metric_grads(metric, g_p)
        g_fields = tuple(g.to(f.dtype) for g, f in zip(g_fields, fields))
        return (None, lam[0], g_psi0, lam[2], g_b, g_c1, g_c2, g_nz,
                g_surf.to(surf.dtype), *g_fields)


def _forward_twin_route(metric, flags, dt, max_steps, R, l, psi, p_l, b,
                        c1, c2, nz, surf):
    kind, p = metric_slots(metric, l)
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


def _rk45_consts(metric, R, rk, dt, like):
    """The rk45 twin's consts (rtol, atol, dt_min, dt_max, R, r_cap, dt0)
    as 0-d tensors of ``like``'s dtype."""
    return _consts(metric, *rk[:4], R, like) + (torch.tensor(
        float(dt), dtype=like.dtype, device=like.device),)


def _forward_twin_rk45_route(metric, flags, dt, max_steps, R, rk, l, psi,
                             p_l, b, c1, c2, nz, surf):
    kind, p = metric_slots(metric, l)
    consts = _rk45_consts(metric, R, rk, dt, l)
    theta = (*p, b, c1, c2) + ((nz,) if flags is not None else ()) + (surf,)
    with torch.no_grad():
        y, sign, steps, iters = _forward_twin_rk45(kind, flags, consts, theta,
                                                   (l, psi, p_l), max_steps,
                                                   rk[4])
    return (y[0], y[1], y[2], sign, steps, *y[4:]), iters


def _backward_twin(max_steps, rk, metric, flags, dt, R, surf, l0, psi0, pl0,
                   b, c1, c2, nz, counts, cot):
    kind, p = metric_slots(metric, l0)
    zero = torch.zeros_like(l0)
    vol = flags is not None
    theta = (*p, b, c1, c2) + ((nz,) if vol else ()) + (surf,)
    if rk is not None:
        consts = _rk45_consts(metric, R, rk, dt, l0)
        y0 = (l0, psi0, pl0, torch.ones_like(l0) * consts[6]) + (zero,) * (
            4 if vol else 6)
        bound = rk[4]
        segment = rk[5] or max(1, int(math.sqrt(bound)))

        def step(th, y):
            return _pl_rk45_surface_iter(kind, flags, consts, th, y,
                                         rk[6])[0]
    else:
        y0 = (l0, psi0, pl0, torch.cos(psi0), torch.sin(psi0)) + (zero,) * (
            4 if vol else 6)
        bound = max_steps
        segment = max(1, int(math.sqrt(max_steps)))
        if vol:
            def step(th, y):
                return _vol_step(kind, flags, dt, th, y)
        else:
            def step(th, y):
                return _disk_step(kind, dt, (*th[:6], th[6][0], th[6][1]), y)
    d_theta, lam = ckpt_adjoint_backward(step, theta, y0, counts, cot,
                                         max_steps=bound, segment=segment)
    g_nz = d_theta[6] if vol else None
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


def _rk45_row(metric, dt, R, rk, surf):
    """(kind, kernel #4's surface row): the rk45 row and the host values of
    ``surf``."""
    kind, head = rk45_scalars(metric, dt, R, rk[0], rk[1], rk[3])
    return kind, head + surf.detach().cpu().tolist()


def _forward_kernel_rk45(metric, flags, dt, max_steps, R, rk, l, psi, p_l, b,
                         c1, c2, nz, surf):
    kind, scal = _rk45_row(metric, dt, R, rk, surf)
    vol = flags is not None
    mode = (True, *flags) if vol else (False,) * 5
    ins = [disk_cuda._flat_f32(t) for t in (l, psi, p_l, b, c1, c2)]
    ins.append(disk_cuda._flat_f32(nz) if vol else None)
    outs = rk45_disk_cuda.launch(kind, mode, scal, *ins, max_steps=max_steps,
                                 max_iters=rk[4])
    outs = [o.reshape(l.shape) for o in outs]
    # (l, psi, p_l, extras..., sign, steps, iters) -> the Function's order
    return (*outs[:3], outs[-3], outs[-2], *outs[3:-3]), outs[-1]


def _backward_kernel_rk45(rk, metric, flags, dt, R, surf, l0, psi0, pl0, b,
                          c1, c2, nz, counts, cot):
    kind, scal = _rk45_row(metric, dt, R, rk, surf)
    flat = [t.reshape(-1).contiguous()
            for t in (l0, psi0, pl0, b, c1, c2, nz)]
    cot = torch.stack([c.reshape(-1) for c in cot]).contiguous()
    g, lam = cs.ckpt_surface_rk45_backward_cuda(
        kind, flags, scal, rk[6], tuple(flat[:3]), *flat[3:],
        counts.reshape(-1).contiguous(), cot, seg=rk[5] or cs.RK45_SEG)
    shape = l0.shape
    return g.reshape(-1, *shape), lam.reshape(-1, *shape)


def _common(metric, state, b, c1, c2, nz, surf, flags, *, stepper, dt,
            max_steps, escape_radius, backend, rtol, atol, dt_min, dt_max,
            max_iters, segment, freeze_controller):
    if stepper not in ("euler", "rk45"):
        pl.check_stepper(stepper)
    if backend not in ("auto", "twin"):
        raise ValueError(f"backend must be 'auto' or 'twin', got {backend!r}")
    refuse_table(metric, "differentiable disk march")
    l, psi, p_l = state
    rk = None
    if stepper == "rk45":
        if l.device.type == "cuda" and backend == "auto" and dt_min != 1e-6:
            raise ValueError(
                "the CUDA forward (kernel #4) hardcodes its dt floor at 1e-6; "
                "the replay must use the same dt_min or knife-edge stall "
                "decisions diverge")
        mi = 4 * int(max_steps) if max_iters is None else int(max_iters)
        rk = (float(rtol), float(rtol * 1e-3 if atol is None else atol),
              float(dt_min), float(dt_max), mi + (mi & 1),
              int(segment) if segment else 0, bool(freeze_controller))
    shape = l.shape
    b, c1, c2 = (torch.broadcast_to(t, shape) for t in (b, c1, c2))
    nz = torch.zeros_like(l) if nz is None else torch.broadcast_to(nz, shape)
    fields = tuple(getattr(metric, f) for f in metric.fields)
    cfg = (metric, flags, float(dt), int(max_steps), float(escape_radius),
           backend == "twin", rk)
    out = _SurfaceAdjoint.apply(cfg, l, psi, p_l, b, c1, c2, nz, surf,
                                *fields)
    return tuple(out[:5]), out[5:]


_RK45_KW = dict(rtol=1e-5, atol=None, dt_min=1e-6, dt_max=10.0,
                max_iters=None, segment=None, freeze_controller=False)


def march_planar_disk_adjoint(metric: Metric, state, b, c1, c2, *, dt,
                              max_steps, escape_radius, r_inner, r_outer,
                              stepper="euler", backend="auto", **rk45):
    """Differentiable thin-disk march: ``state`` = (l, psi, p_l); returns
    (l, psi, p_l, sign, steps, ((h1, h1p, h1s), (h2, h2p, h2s))), the
    contract of ``ops/disk_cuda.py:march_planar_disk_cuda``.  The forward
    is kernel #5 (``stepper='euler'``) or #4's disk tracker ('rk45', ``dt``
    the initial step; ``rk45`` takes rtol, atol, dt_min, dt_max,
    max_iters, segment and freeze_controller) on CUDA tensors
    (``backend='auto'``) and the twin loop otherwise (``backend='twin'``,
    or CPU tensors)."""
    l = state[0]
    surf = torch.tensor([float(r_inner), float(r_outer)], dtype=l.dtype,
                        device=l.device)
    st, ex = _common(metric, state, b, c1, c2, None, surf, None,
                     stepper=stepper, dt=dt, max_steps=max_steps,
                     escape_radius=escape_radius, backend=backend,
                     **{**_RK45_KW, **rk45})
    return (*st, ((ex[0], ex[1], ex[2]), (ex[3], ex[4], ex[5])))


def march_planar_vol_adjoint(metric: Metric, state, b, c1, c2, nz, disk, *,
                             dt, max_steps, escape_radius, disk_theta=None,
                             scatter_block=None, stepper="euler",
                             backend="auto", **rk45):
    """Differentiable volumetric march through ``disk`` (a DiskParams):
    returns (l, psi, p_l, sign, steps, (tau, (em_r, em_g, em_b))).  The
    emission row is ``build_vol_row(disk, disk_theta)``, so tensors in
    ``disk_theta`` get gradients through the march; ``scatter_block``: the
    (SCATTER_BLOCK,) in-gas starlight coefficients
    (``render/starlight.py:starlight_scatter_block``), a tensor that gets
    its gradient too.  Steppers and routes as in
    ``march_planar_disk_adjoint``."""
    l = state[0]
    surf = build_vol_row(disk, disk_theta, dtype=l.dtype, device=l.device)
    if scatter_block is not None:
        surf = torch.cat([surf, torch.as_tensor(scatter_block, dtype=l.dtype,
                                                device=l.device)])
    flags = (disk.color_mode == "blackbody", bool(disk.redshift),
             bool(disk.doppler), scatter_block is not None)
    st, ex = _common(metric, state, b, c1, c2, nz, surf, flags,
                     stepper=stepper, dt=dt, max_steps=max_steps,
                     escape_radius=escape_radius, backend=backend,
                     **{**_RK45_KW, **rk45})
    return (*st, (ex[0], (ex[1], ex[2], ex[3])))
