"""Adaptive Dormand-Prince 5(4) planar march with per-ray step control
(PyTorch).

Counterpart of ``curvis_tpu/integrate/rk45.py:march_planar_rk45``, with
its disk-tracker and volumetric variants: the quality mode of the planar
and disk renderers.  Each iteration of a lock-step masked loop proposes
one DP5(4) step for every live ray, accepts it where the embedded error
estimate |y5 - y4| passes (rtol, atol), and retries rejected rays with a
smaller dt from the controller ``clip(0.9 err^-0.2, 0.2, 5)``.  Escaping
steps are interpolated to |l| = R, which removes the O(dt) readout jitter
of the fixed-step marches.

This is the CPU route of ``render_planar_fast(stepper='rk45')`` and of the
disk routes' ``stepper='rk45'``, as in the JAX package.  On a GPU those
routes are the CUDA kernels (``ops/rk45_cuda.py``,
``ops/rk45_disk_cuda.py``), whose arithmetic is the Pallas kernel's, not
this (the module docstrings there say how).
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops.disk_vol_cuda import (inv_r2_plain,
                                                vol_emission_plain,
                                                vol_scalars)
from curvis_tpu_torch.ops.table_cuda import slot_params
from curvis_tpu_torch.physics.hamiltonian import (HamiltonianResult,
                                                  _rhs_batched)
from curvis_tpu_torch.physics.planar import (_CHECK_EVERY, PlanarResult,
                                             PlanarRays, _capture_radius,
                                             planar_rhs)

# Dormand-Prince 5(4) tableau
DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
DP_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
DP_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
         187 / 2100, 1 / 40]

CAPPED = -128     # sign of a ray stopped at max_steps, reported as 0


def _comb(weights, ks, comp, like):
    acc = torch.zeros_like(like)
    for w, k in zip(weights, ks):
        if w != 0.0:
            acc = acc + w * k[comp]
    return acc


def march_planar_rk45(metric: Metric, rays: PlanarRays, *, escape_radius,
                      max_steps=10_000, rtol=1e-6, atol=1e-9, dt0=0.05,
                      dt_min=1e-6, dt_max=10.0, max_iters=None, c1=None,
                      c2=None, nz=None, disk=None, vol_disk=None,
                      scatter_block=None):
    """Adaptive march with the result contract of the fixed-step marches;
    ``steps`` counts accepted steps.  A ray ends escaped (+1 / -1, on
    |l| = R), captured (2), stalled (3: a reject at the dt floor, which the
    controller cannot pass, or a non-finite trial) or still marching at
    ``max_steps`` accepted steps (0).  The loop runs at most ``max_iters``
    (default 4 max_steps) iterations, accepted and rejected.

    The surface variants of the JAX twin, which clamp dt near the disk as
    the Pallas kernel does (crossing detection and the gas quadrature keep
    base resolution dt0):

    - ``disk=(r_in, r_out)`` with the plane coefficients ``c1, c2``:
      records the first two in-band crossings of the plane as signed
      (l, p_l, psi) triples -> (PlanarResult, (h1, h1p, h1s),
      (h2, h2p, h2s));
    - ``vol_disk`` (a DiskParams) with ``c1, c2, nz`` and the optional
      ``scatter_block``: radiative transfer per accepted step with the
      kernel's emission (``ops/disk_vol_cuda.py:vol_emission_plain``, as
      the JAX twin evaluates the Pallas one); a ray still marching freezes
      as OPAQUE_SIGN (2) once tau > tau_max -> (PlanarResult, tau,
      (em_r, em_g, em_b))."""
    vol = vol_disk is not None
    track_disk = disk is not None
    if vol and track_disk:
        raise ValueError("pass disk=(r_in, r_out) OR vol_disk, not both")
    l, psi, p_l, b = rays.l, rays.psi, rays.p_l, rays.b
    shape, dtype, dev = l.shape, l.dtype, l.device
    R = escape_radius
    R_t = torch.as_tensor(R, dtype=dtype, device=dev)
    if max_iters is None:
        max_iters = 4 * max_steps
    r_cap = _capture_radius(metric)
    if track_disk or vol:
        c1 = torch.broadcast_to(torch.as_tensor(c1, dtype=dtype,
                                                device=dev), shape)
        c2 = torch.broadcast_to(torch.as_tensor(c2, dtype=dtype,
                                                device=dev), shape)
        zq = c1 * torch.cos(psi) + c2 * torch.sin(psi)
        acc = [torch.zeros_like(l) for _ in range(4 if vol else 6)]
    if track_disk:
        r_in, r_out = disk
    if vol:
        kind, scal = vol_scalars(metric, dt0, escape_radius, vol_disk,
                                 scatter_block)
        vrow = torch.tensor(scal, dtype=dtype, device=dev)
        p = slot_params(kind, vrow)
        surf = vrow[6:]
        flags = (vol_disk.color_mode == "blackbody", vol_disk.redshift,
                 vol_disk.doppler, scatter_block is not None)
        r_in, r_out = vol_disk.r_inner, vol_disk.r_outer
        h_rel5 = 5.0 * vol_disk.h_rel
        nz = torch.broadcast_to(torch.as_tensor(nz, dtype=dtype, device=dev),
                                shape)
    dt = torch.full(shape, dt0, dtype=dtype, device=dev)
    sign = torch.zeros(shape, dtype=torch.int32, device=dev)
    steps = torch.zeros_like(sign)
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        ks = []                                   # 7 stages x 3 components
        for i in range(7):
            li, pi_, pli = l, psi, p_l
            for j, a in enumerate(DP_A[i]):
                li = li + dt * a * ks[j][0]
                pi_ = pi_ + dt * a * ks[j][1]
                pli = pli + dt * a * ks[j][2]
            ks.append(planar_rhs(metric, li, pi_, pli, b))
        l5 = l + dt * _comb(DP_B5, ks, 0, l)
        psi5 = psi + dt * _comb(DP_B5, ks, 1, l)
        pl5 = p_l + dt * _comb(DP_B5, ks, 2, l)
        l4 = l + dt * _comb(DP_B4, ks, 0, l)
        psi4 = psi + dt * _comb(DP_B4, ks, 1, l)
        pl4 = p_l + dt * _comb(DP_B4, ks, 2, l)

        def err_comp(y5, y4, y0):
            return torch.abs(y5 - y4) / (atol + rtol * torch.maximum(
                torch.abs(y0), torch.abs(y5)))

        # torch.maximum propagates NaN, as jnp.maximum: a non-finite trial
        # is rejected and then stalls at the dt floor
        err = torch.maximum(err_comp(l5, l4, l),
                            torch.maximum(err_comp(psi5, psi4, psi),
                                          err_comp(pl5, pl4, p_l)))
        accept = active & (err <= 1.0)

        # escape on accepted steps: interpolate to |l| = R
        esc_pos = accept & (l5 > R)
        esc_neg = accept & (l5 < -R)
        esc = esc_pos | esc_neg
        target = torch.where(esc_pos, R_t, -R_t)
        denom = torch.where(torch.abs(l5 - l) < 1e-30, 1.0, l5 - l)
        frac = torch.clamp((target - l) / denom, 0.0, 1.0)
        l_new = torch.where(esc, l + frac * (l5 - l), l5)
        psi_new = torch.where(esc, psi + frac * (psi5 - psi), psi5)
        pl_new = torch.where(esc, p_l + frac * (pl5 - p_l), pl5)
        l_prev, psi_prev, pl_prev = l, psi, p_l
        l = torch.where(accept, l_new, l)
        psi = torch.where(accept, psi_new, psi)
        p_l = torch.where(accept, pl_new, p_l)
        if track_disk or vol:
            zq_prev = zq
            zq = c1 * torch.cos(psi) + c2 * torch.sin(psi)
        if track_disk:
            h1, h1p, h1s, h2, h2p, h2s = acc
            crossed = accept & (zq_prev * zq < 0.0)
            cden = torch.abs(zq_prev) + torch.abs(zq)
            cfrac = torch.abs(zq_prev) / torch.clamp(cden, min=1e-30)
            lh = l_prev + cfrac * (l - l_prev)       # signed: sheet
            r_hit = torch.abs(lh)
            pl_hit = pl_prev + cfrac * (p_l - pl_prev)
            psi_hit = psi_prev + cfrac * (psi - psi_prev)
            in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
            new1 = in_disk & (h1 == 0.0)
            new2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
            acc = [torch.where(new1, lh, h1), torch.where(new1, pl_hit, h1p),
                   torch.where(new1, psi_hit, h1s),
                   torch.where(new2, lh, h2), torch.where(new2, pl_hit, h2p),
                   torch.where(new2, psi_hit, h2s)]
        if vol:
            tau = acc[0]
            dtau, dem = vol_emission_plain(kind, flags, p, surf, l, p_l, b,
                                           zq, tau, nz)
            acc = [tau + torch.where(accept, dt * dtau, 0.0)] + [
                e + torch.where(accept, dt * d, 0.0)
                for e, d in zip(acc[1:], dem)]
            tau = acc[0]

        sign = torch.where(esc_pos, 1, torch.where(esc_neg, -1, sign))
        if r_cap is not None:
            sign = torch.where(accept & (l < r_cap) & (sign == 0), 2, sign)
        if vol:
            # the tau_max freeze: OPAQUE_SIGN == CAPTURED == 2
            sign = torch.where((sign == 0) & (tau > vol_disk.tau_max), 2,
                               sign)
        steps = steps + accept.to(torch.int32)
        over = steps >= max_steps
        # a reject at the dt floor can never pass -> freeze as blowup
        # instead of spinning to max_iters (a NaN err lands here too)
        stalled = active & ~(err <= 1.0) & (dt <= dt_min * 1.01) \
            & (sign == 0)
        sign = torch.where(stalled, 3, sign)
        # step-size control for rays still marching; the guard on a
        # non-finite factor keeps dt finite, so the stall test can fire
        err_safe = torch.clamp(err, min=1e-10)
        factor = torch.clamp(0.9 * err_safe ** -0.2, 0.2, 5.0)
        factor = torch.where(torch.isfinite(factor), factor, 0.2)
        dt = torch.where(active & ~esc & (sign == 0),
                         torch.clamp(dt * factor, dt_min, dt_max), dt)
        if vol:
            # the anticipatory slab clamp: dt <= max(dt0, half the larger
            # of the radial gap to the r_out + 2 cylinder and the vertical
            # gap to the 5-sigma density shell)
            if kind in ("schwarzschild", "rn"):
                rl = l
            else:
                rl = torch.rsqrt(torch.clamp(inv_r2_plain(kind, p, l),
                                             min=1e-30))
            s2v = torch.clamp(1.0 - zq * zq, 1e-12, 1.0)
            r_cyl = rl * torch.sqrt(s2v)
            gap_r = r_cyl - (r_out + 2.0)
            gap_z = rl * torch.abs(zq) - h_rel5 * r_cyl
            dt_gas = torch.clamp(0.5 * torch.maximum(gap_r, gap_z), min=dt0)
            dt = torch.where(sign == 0, torch.minimum(dt, dt_gas), dt)
        elif track_disk:
            # the anticipatory plane clamp: dt <= max(dt0, 0.2 r |zq|), so a
            # clamped step cannot reach the plane
            near = torch.abs(l) < (r_out + 2.0)
            dt_pl = torch.clamp(0.2 * torch.abs(l) * torch.abs(zq), min=dt0)
            dt = torch.where(near & (sign == 0), torch.minimum(dt, dt_pl),
                             dt)
        # test the current sign, not `active`: a ray whose max_steps-th
        # accepted step also escapes or is captured keeps that fate
        sign = torch.where((sign == 0) & over, CAPPED, sign).to(torch.int32)
    sign = torch.where(sign == CAPPED, 0, sign).to(torch.int32)
    res = PlanarResult(l, psi, p_l, sign, steps)
    if track_disk:
        return res, tuple(acc[:3]), tuple(acc[3:])
    if vol:
        return res, acc[0], tuple(acc[1:])
    return res


def march_kerr_rk45(metric, x0, p0, *, escape_radius, capture_radius=None,
                    max_steps=4_000, rtol=1e-4, atol=1e-7, dt0=0.1,
                    dt_min=1e-5, dt_max=None, max_iters=None,
                    return_iters=False):
    """Error-controlled Boyer-Lindquist march: DP5(4) with per-ray adaptive
    dt on the general Hamiltonian flow (``physics/hamiltonian.py``'s
    autodiff RHS), the counterpart of the JAX package's XLA twin.

    The error norm |y5 - y4| / (atol + rtol max(|y0|, |y5|)) runs over
    (r, theta, p_r, p_theta); phi is excluded (its near-axis spikes are
    coordinate artifacts).  An accepted trial that overshoots R grossly
    (at a fraction < 0.9 of the step and more than R * 1e-3 past R) is
    rejected and retried with dt scaled to land just past R.  A ray ends
    escaped (1), captured (2), blown up or stalled at ``dt_min`` (3), or
    at ``max_steps`` accepted steps or ``max_iters`` iterations (0;
    max_iters defaults to 4 max_steps, not rounded).  Returns a
    HamiltonianResult whose ``steps`` are accepted steps, and each ray's
    live iterations with ``return_iters``.

    This is the bare rk45 route on the CPU; the GPU route, and the disk,
    volumetric and map marches on either device, run kernel #8
    (``ops/kerr_rk45_cuda.py``), whose arithmetic differs by rounding."""
    dtype, dev = x0.dtype, x0.device
    R = torch.as_tensor(escape_radius, dtype=dtype, device=dev)
    if capture_radius is None:
        capture_radius = getattr(metric, "capture_radius", None)
    if dt_max is None:
        dt_max = escape_radius / 8.0
    dt_min, dt_max = (torch.as_tensor(v, dtype=dtype, device=dev)
                      for v in (dt_min, dt_max))
    if max_iters is None:
        max_iters = 4 * max_steps
    shape = x0.shape[:-1]
    x, p = x0, p0
    dt = torch.full(shape, float(dt0), dtype=dtype, device=dev)
    sign = torch.zeros(shape, dtype=torch.int32, device=dev)
    steps = torch.zeros_like(sign)
    iters = torch.zeros_like(sign)
    for it in range(int(max_iters)):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        iters = iters + active.to(torch.int32)
        dte = dt[..., None]
        ks = []                                   # 7 stages of (dx, dp)
        for i in range(7):
            xi, pi_ = x, p
            for j, a in enumerate(DP_A[i]):
                xi = xi + dte * a * ks[j][0]
                pi_ = pi_ + dte * a * ks[j][1]
            ks.append(_rhs_batched(metric, xi, pi_))
        x5 = x + dte * _comb(DP_B5, ks, 0, x)
        p5 = p + dte * _comb(DP_B5, ks, 1, x)
        x4 = x + dte * _comb(DP_B4, ks, 0, x)
        p4 = p + dte * _comb(DP_B4, ks, 1, x)

        def err_comp(y5, y4, y0):
            return torch.abs(y5 - y4) / (atol + rtol * torch.maximum(
                torch.abs(y0), torch.abs(y5)))

        # torch.amax and torch.maximum propagate NaN, as jnp.max / maximum
        err = torch.maximum(
            torch.amax(err_comp(x5[..., 1:3], x4[..., 1:3], x[..., 1:3]),
                       dim=-1),
            torch.amax(err_comp(p5[..., 1:3], p4[..., 1:3], p[..., 1:3]),
                       dim=-1))
        accept = active & (err <= 1.0)
        esc = accept & (x5[..., 1] > R)
        denom = x5[..., 1] - x[..., 1]
        denom = torch.where(torch.abs(denom) < 1e-30, 1.0, denom)
        frac = (R - x[..., 1]) / denom
        over = esc & (frac < 0.9) & (x5[..., 1] > R * (1.0 + 1e-3))
        accept = accept & ~over
        esc = esc & ~over
        am = accept[..., None]
        x = torch.where(am, x5, x)
        p = torch.where(am, p5, p)
        r = x[..., 1]
        m_chk = (torch.abs(r) + torch.abs(x[..., 2]) + torch.abs(x[..., 3])
                 + torch.abs(p[..., 1]) + torch.abs(p[..., 2]))
        ok = m_chk <= 1e8
        # escape from the pre-writeback flag
        sign = torch.where(accept & ok & esc, 1, sign)
        if capture_radius is not None:
            sign = torch.where(accept & ok & (r < capture_radius), 2, sign)
        sign = torch.where(accept & ~ok, 3, sign)
        # a reject at dt_min can never pass (over-rejects included)
        stalled = active & ~accept & (dt <= dt_min * 1.01)
        sign = torch.where(stalled, 3, sign).to(torch.int32)
        steps = steps + accept.to(torch.int32)
        err_safe = torch.clamp(err, min=1e-10)
        factor = torch.clamp(0.9 * torch.exp(-0.2 * torch.log(err_safe)),
                             0.2, 5.0)
        factor = torch.where(torch.isfinite(factor), factor, 0.2)
        dt_b = torch.clamp(dt * frac * 1.05, dt_min, dt_max)
        dt = torch.where(active & (sign == 0),
                         torch.clamp(dt * factor, dt_min, dt_max), dt)
        dt = torch.where(over & (sign == 0), dt_b, dt)
        sign = torch.where((sign == 0) & (steps >= max_steps), CAPPED,
                           sign).to(torch.int32)
    sign = torch.where(sign == CAPPED, 0, sign).to(torch.int32)
    res = HamiltonianResult(x, p, sign, steps)
    return (res, iters) if return_iters else res
