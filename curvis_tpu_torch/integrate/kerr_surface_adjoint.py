"""Differentiable Kerr / Kerr-Newman surfaces: the thin disk and the
volumetric gas, with fixed-step RK4 and adaptive DP5(4) (PyTorch).

Counterpart of ``curvis_tpu/integrate/kerr_surface_adjoint.py``.  The
checkpointed-recompute adjoints of the bare Kerr marches
(``integrate/kerr_adjoint.py``, ``integrate/rk45_adjoint.py``) extended
with larger carried states:

  * thin disk: the state gains the crossing tracker (ct_prev, h1, h1_phi,
    h1_side, h2, h2_phi, h2_side); a crossing's radius and azimuth are
    linear in the step's crossing fraction, so d(hit) / d(M, a, q, spawn)
    is exact, and which step crossed replays as data;
  * volumetric gas: the state gains (tau, em_r, em_g, em_b), and the
    parameters gain the 10 entries of the emission row (``build_vol_row``:
    r_in, r_out and the 8 slots) and, with the in-gas starlight, the 27
    scatter scalars, one traced vector that the forward kernel and the
    backward replay both read, so gradients reach the disk parameters
    through the quadrature.

Fate policy (the JAX package's, wider than the bare adjoints'): the state
cotangents reach escaped (sign 1) and step-capped (0) rays only; the hit,
tau and emission cotangents reach every ray but the blown-up and stalled
ones (sign 3): a captured ray (2, the tau_max freeze included) replays
every step up to capture, because the disk in front of the shadow is
the signal an inverse problem fits.  The replayed maps take the guarded
RHS (``integrate/rk45_adjoint.py:_kerr_rhs_guarded``), whose partials stay
finite on frozen near-horizon states and equal the raw ones off the
guards.  The cotangents of dt, the escape radius and far_r0 are dropped;
``max_iters`` defaults to 2 max_steps, rounded up to even.

Routes, by the device of the inputs (``backend='auto'``):

  * CUDA tensors (float32): the forward is kernel #7 or #8 with its
    surface variant (``ops/kerr_cuda.py``, ``ops/kerr_rk45_cuda.py``, the
    emission row passed as ``vol_row=``), the backward the checkpoint
    kernels #9 / #10's Kerr surface families
    (``ops/ckpt_kerr_surface_cuda.py``), which replay the forward kernel's
    own step in segments of 32 (RK4) or 16 (DP5(4));
  * CPU tensors, or ``backend='twin'`` (``render_kerr``'s 'scan' route):
    the forward is the masked loop ``_forward_xla_fixed`` /
    ``_forward_xla_rk45_surface`` over the step maps below (the JAX
    package's XLA route), the backward ``integrate/ckpt.py:
    ckpt_adjoint_backward`` under autograd on the same maps, in segments
    of ~sqrt(max_steps).
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.integrate.kerr_adjoint import (_pack, input_grads, knob,
                                                     q2_of, step_dte)
from curvis_tpu_torch.integrate.rk45 import CAPPED, DP_A, DP_B4, DP_B5, _comb
from curvis_tpu_torch.integrate.rk45_adjoint import (_kerr_rhs_guarded,
                                                     default_max_iters)
from curvis_tpu_torch.ops import ckpt_kerr_surface_cuda as cks
from curvis_tpu_torch.ops.disk_vol_cuda import VOL_SLOT_NAMES
from curvis_tpu_torch.ops.kerr_cuda import (KERR_SCATTER_OFF,
                                            kerr_scalars,
                                            kerr_vol_emission_plain,
                                            march_kerr_cuda)
from curvis_tpu_torch.ops.kerr_rk45_cuda import (kerr_rk45_scalars,
                                                 march_kerr_rk45_cuda)
from curvis_tpu_torch.ops.rk45_cuda import jclip
from curvis_tpu_torch.physics.planar import _CHECK_EVERY

# the DiskParams fields that enter the volumetric march's row; the other
# differentiable keys (brightness, opacity, tint, albedo,
# starlight_scatter) act in the shading after the march
_ROW_KEYS = ("r_inner", "r_outer", "h_rel", "kappa", "t_peak",
             "emissivity_index", "spin_sign")
TAU_MAX = 2 + VOL_SLOT_NAMES.index("tau_max")    # its entry of the row
H2 = 2 + VOL_SLOT_NAMES.index("h2")


# ---------------------------------------------------------------------------
# the traced emission row
# ---------------------------------------------------------------------------

def build_vol_row(disk, disk_theta=None, *, dtype=torch.float32,
                  device=None):
    """The (10,) emission row [r_in, r_out, h2, inv_norm, kappa, tau_max,
    t_peak, emis_q, spin_sign, t_scale] of the volumetric marches (the
    order of ``ops/disk_vol_cuda.py:vol_param_slots`` after r_in, r_out),
    with torch ops, so that a tensor in ``disk_theta`` (overrides keyed by
    DiskParams field names) stays in the graph through the composite
    slots inv_norm and t_scale.  The row is built once per march, so the
    forward kernel's scalars and the backward's replay see the same
    values.  It is computed in float64 on the CPU, as ``vol_param_slots``
    computes it in Python floats, and then cast to ``dtype`` on
    ``device``: without overrides the two rows are equal."""
    from curvis_tpu_torch.render.disk import DIFF_DISK_KEYS
    over = disk_theta or {}
    unknown = set(over) - DIFF_DISK_KEYS
    if unknown:
        raise ValueError(f"disk_theta: non-differentiable or unknown keys "
                         f"{sorted(unknown)}")

    def get(name):
        v = over[name] if name in _ROW_KEYS and name in over \
            else getattr(disk, name)
        if torch.is_tensor(v):
            return v.to(device="cpu", dtype=torch.float64).reshape(())
        return torch.tensor(float(v), dtype=torch.float64)

    r_in, r_out = get("r_inner"), get("r_outer")
    h_rel = get("h_rel")
    t_peak = get("t_peak")
    rp = (49.0 / 36.0) * r_in                  # Shakura-Sunyaev peak radius
    f_peak = rp ** -0.75 * (1.0 / 7.0) ** 0.25
    slots = dict(h2=h_rel * h_rel,
                 inv_norm=1.0 / (math.sqrt(2.0 * math.pi) * h_rel),
                 kappa=get("kappa"), tau_max=get("tau_max"), t_peak=t_peak,
                 emis_q=get("emissivity_index"), spin_sign=get("spin_sign"),
                 t_scale=t_peak / f_peak)
    # layout: the slot order of ops/disk_vol_cuda.py:vol_param_slots
    assert VOL_SLOT_NAMES == ("h2", "inv_norm", "kappa", "tau_max", "t_peak",
                              "emis_q", "spin_sign", "t_scale")
    row = torch.stack([r_in, r_out] + [slots[k] for k in VOL_SLOT_NAMES])
    return row.to(device=device, dtype=dtype)


def _vol_param_row_ref(M, a, q2, vol):
    """The march kernels' row for ``kerr_vol_emission_plain`` with the
    metric slots at 2-4, (r_in, r_out) at 6-7, the 8 emission slots at
    VOL_BLOCK_KERR and a scatter block (``len(vol) > 10``) at
    KERR_SCATTER_OFF, as a list of ``vol``'s entries, so that the replay
    runs the kernels' emission algebra on them under autograd."""
    row = [0.0, 0.0, M, a, q2, 0.0, vol[0], vol[1], 0.0, 0.0]
    row += [vol[2 + i] for i in range(8)] + [0.0, 0.0]
    assert len(row) == KERR_SCATTER_OFF
    return row + [vol[10 + i] for i in range(len(vol) - 10)]


def _finite(y):
    """The blowup guard (``ops/ckpt_kerr_surface_cuda.py:_finite``), as
    flags only."""
    with torch.no_grad():
        return cks._finite(y)


# ---------------------------------------------------------------------------
# fixed-step (RK4) step maps
# ---------------------------------------------------------------------------

def _rk4_state(dt, axis_u0, far_r0, M, a, q2, E, L, r, th, ph, p_r, p_th):
    """One unmasked RK4 step on the guarded 5-state RHS with the dt
    scaling of every Kerr march -> (dte, r1, theta1, phi1, p_r1,
    p_theta1), the combination order of kernel #7."""
    dte = step_dte(dt, axis_u0, far_r0, r, th)

    def rhs(r_, th_, pr_, pth_):
        return _kerr_rhs_guarded(M, a, q2, E, L, r_, th_, pr_, pth_)

    k1 = rhs(r, th, p_r, p_th)
    k2 = rhs(r + 0.5 * dte * k1[0], th + 0.5 * dte * k1[1],
             p_r + 0.5 * dte * k1[3], p_th + 0.5 * dte * k1[4])
    k3 = rhs(r + 0.5 * dte * k2[0], th + 0.5 * dte * k2[1],
             p_r + 0.5 * dte * k2[3], p_th + 0.5 * dte * k2[4])
    k4 = rhs(r + dte * k3[0], th + dte * k3[1], p_r + dte * k3[3],
             p_th + dte * k3[4])
    w = dte * (1.0 / 6.0)
    return (dte,) + tuple(v + w * (a1 + 2.0 * (a2 + a3) + a4)
                          for v, a1, a2, a3, a4 in zip(
                              (r, th, ph, p_r, p_th), k1, k2, k3, k4))


def _disk_step(dt, axis_u0, far_r0, theta, y):
    """The 12-state thin-disk step map: y = (r, th, ph, p_r, p_th, ct_prev,
    h1, h1f, h1d, h2, h2f, h2d); theta = (M, a, q2, E, L, r_in, r_out)."""
    M, a, q2, E, L, r_in, r_out = theta
    r, th, ph, p_r, p_th, ct_prev = y[:6]
    _, r1, th1, ph1, pr1, pth1 = _rk4_state(dt, axis_u0, far_r0, M, a, q2,
                                            E, L, r, th, ph, p_r, p_th)
    ct = torch.cos(th1)
    hits, _, _ = cks.track_hit_plain(r_in, r_out, r, ph, (r1, th1, ph1),
                                     ct_prev, ct, y[6:])
    return (r1, th1, ph1, pr1, pth1, ct, *hits)


def _vol_step(blackbody, beaming, dt, axis_u0, far_r0, theta, y):
    """The 9-state volumetric step map: y = (r, th, ph, p_r, p_th, tau,
    em_r, em_g, em_b); theta = (M, a, q2, E, L) + the 10 row entries (+ the
    27 scatter scalars).  The emission at the post-step state with the
    pre-step tau, weighted by the scaled dte, where the state passed the
    blowup guard: the kernel's quadrature."""
    M, a, q2, E, L = theta[:5]
    vol = theta[5:]
    r, th, ph, p_r, p_th, tau, emr, emg, emb = y
    dte, r1, th1, ph1, pr1, pth1 = _rk4_state(dt, axis_u0, far_r0, M, a, q2,
                                              E, L, r, th, ph, p_r, p_th)
    row = _vol_param_row_ref(M, a, q2, vol)
    dtau, dem = kerr_vol_emission_plain(
        row, (blackbody, beaming, len(vol) > 10), r1, th1, L / E, tau)
    ok = _finite((r1, th1, ph1, pr1, pth1))
    zero = torch.zeros_like(tau)
    return (r1, th1, ph1, pr1, pth1,
            tau + torch.where(ok, dte * dtau, zero),
            emr + torch.where(ok, dte * dem[0], zero),
            emg + torch.where(ok, dte * dem[1], zero),
            emb + torch.where(ok, dte * dem[2], zero))


def _forward_xla_fixed(step_fn, y0, escape_radius, r_cap, max_steps,
                       tau_max=None):
    """The masked fixed-step march on ``step_fn`` -> (y, sign, steps):
    escape beyond R (1), capture below r_cap (2), blowup (3); with
    ``tau_max`` (the gas) a ray still marching whose tau passed it freezes
    with sign 2."""
    y = tuple(y0)
    sign = torch.zeros(y[0].shape, dtype=torch.int32, device=y[0].device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        y1 = step_fn(y)
        y = tuple(torch.where(active, b, a) for a, b in zip(y, y1))
        r = y[0]
        ok = _finite(y)
        sign = torch.where(active & ok & (r > escape_radius), 1, sign)
        sign = torch.where(active & ok & (r < r_cap), 2, sign)
        sign = torch.where(active & ~ok, 3, sign).to(torch.int32)
        if tau_max is not None:
            sign = torch.where((sign == 0) & (y[5] > tau_max), 2,
                               sign).to(torch.int32)
        steps = steps + active.to(torch.int32)
    return y, sign, steps


# ---------------------------------------------------------------------------
# error-controlled (DP5(4)) surface iteration
# ---------------------------------------------------------------------------

def _rk45_surface_iter(consts, theta, y, track_disk, vol, blackbody,
                       beaming, freeze=False):
    """One lock-step DP5(4) iteration on the extended state, kernel #8's
    track_disk / vol blocks.  ``consts`` = (rtol, atol, dt_min, dt_max, R,
    r_cap, dt0); theta = (M, a, q2, E, L) + (r_in, r_out) (disk) or the
    row (gas); y = (r, th, ph, p_r, p_th, dt) + (ct_prev, 6 hits) or (tau,
    em_rgb) -> (y1, (accept, esc, cap, blow, stall, opaque)).  ``freeze``
    detaches err, the escape fraction and the next dt."""
    sg = (lambda x: x.detach()) if freeze else (lambda x: x)
    rtol, atol, dt_min, dt_max, R, r_cap, dt0 = consts
    M, a, q2, E, L = theta[:5]
    surf = theta[5:]
    r_in, r_out = surf[0], surf[1]
    r, th, ph, p_r, p_th, dt = y[:6]
    ex = tuple(y[6:])
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

    def ec(ei, y0, y1_):
        return torch.abs(dt * ei) / (atol + rtol * torch.maximum(
            torch.abs(y0), torch.abs(y1_)))

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

    if track_disk:
        ct_prev = ex[0]
        ct = torch.cos(th1)
        hits, _, _ = cks.track_hit_plain(r_in, r_out, r, ph, (r1, th1, ph1),
                                         ct_prev, ct, ex[1:], gate=accept)
        ex = (torch.where(accept, ct, ct_prev), *hits)

    rn, thn, phn, prn, pthn = (torch.where(accept, b, a_) for a_, b in zip(
        (r, th, ph, p_r, p_th), (r1, th1, ph1, pr1, pth1)))
    ok = _finite((rn, thn, phn, prn, pthn))
    opaque_i = torch.zeros_like(accept)
    if vol:
        tau, emr, emg, emb = ex
        row = _vol_param_row_ref(M, a, q2, surf)
        dtau, dem = kerr_vol_emission_plain(
            row, (blackbody, beaming, len(surf) > 10), rn, thn, L / E, tau)
        gate = accept & ok
        zero = torch.zeros_like(tau)
        ex = (tau + torch.where(gate, dt * dtau, zero),
              emr + torch.where(gate, dt * dem[0], zero),
              emg + torch.where(gate, dt * dem[1], zero),
              emb + torch.where(gate, dt * dem[2], zero))

    esc_set = accept & ok & esc_i
    cap_i = accept & ok & (rn < r_cap)
    blow_i = accept & ~ok
    stall_i = ~accept & (dt <= dt_min * 1.01)
    if vol:
        opaque_i = ~(esc_set | cap_i | blow_i) & (ex[0] > surf[TAU_MAX])
    terminal = esc_set | cap_i | blow_i | stall_i | opaque_i
    live = ~terminal

    err_s = torch.maximum(err, torch.full_like(err, 1e-10))
    factor = jclip(0.9 * torch.exp(-0.2 * torch.log(err_s)), 0.2, 5.0)
    factor = torch.where(torch.isfinite(factor), factor, 0.2)
    dt_b = jclip(dt * frac * 1.05, dt_min, dt_max)
    dtn = torch.where(live, jclip(dt * factor, dt_min, dt_max), dt)
    dtn = torch.where(over & live, dt_b, dtn)
    if track_disk:
        # the step bound inside the disk region (kernel rule)
        near = rn < (r_out + 2.0 * M)
        dtn = torch.where(near & live, torch.minimum(dtn, dt0), dtn)
    if vol:
        # the anticipatory slab-distance bound (kernel rule)
        s_th = torch.abs(torch.sin(thn))
        r_cyl = rn * s_th
        gap_r = r_cyl - (r_out + 2.0 * M)
        h_rel5 = 5.0 * torch.sqrt(surf[H2])
        gap_z = rn * torch.abs(torch.cos(thn)) - h_rel5 * r_cyl
        dt_gas = torch.maximum(dt0, 0.5 * torch.maximum(gap_r, gap_z))
        dtn = torch.where(live, torch.minimum(dtn, dt_gas), dtn)
    dtn = sg(dtn)
    return ((rn, thn, phn, prn, pthn, dtn) + ex,
            (accept, esc_set, cap_i, blow_i, stall_i, opaque_i))


def _forward_xla_rk45_surface(consts, theta, y0, extras0, dt0, max_steps,
                              max_iters, track_disk, vol, blackbody,
                              beaming):
    """The masked lock-step DP5(4) march on :func:`_rk45_surface_iter` ->
    (y, sign, steps, iters): the map the backward replays."""
    r0 = y0[0]
    y = tuple(y0) + (torch.full_like(r0, dt0),) + tuple(extras0)
    sign = torch.zeros(r0.shape, dtype=torch.int32, device=r0.device)
    steps = torch.zeros_like(sign)
    iters = torch.zeros_like(sign)
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        iters = iters + active.to(torch.int32)
        y1, (accept, esc_set, cap_i, blow_i, stall_i, opaque_i) = \
            _rk45_surface_iter(consts, theta, y, track_disk, vol, blackbody,
                               beaming)
        y = tuple(torch.where(active, b, a) for a, b in zip(y, y1))
        sign = torch.where(active & esc_set, 1, sign)
        sign = torch.where(active & cap_i, 2, sign)
        sign = torch.where(active & (blow_i | stall_i), 3, sign)
        sign = torch.where(active & opaque_i & (sign == 0), 2, sign)
        steps = steps + (active & accept).to(torch.int32)
        sign = torch.where((sign == 0) & (steps >= max_steps), CAPPED,
                           sign).to(torch.int32)
    sign = torch.where(sign == CAPPED, 0, sign).to(torch.int32)
    return y, sign, steps, iters


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _rays(x0, p0):
    """(y0 = (r, theta, phi, p_r, p_theta), E, L) of a BL bundle."""
    return ((x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2]),
            -p0[:, 0], p0[:, 3])


def _zeros_for(grads, like):
    return tuple(torch.zeros_like(like) if g is None else g for g in grads)


class _KerrSurfaceAdjoint(torch.autograd.Function):
    """(x0, p0, surf, *metric fields) -> (x, p, sign, steps, *extras), the
    extras (h1, h1_phi, h1_side, h2, h2_phi, h2_side) for the thin disk or
    (tau, em_r, em_g, em_b) for the gas.  ``surf`` is the band (r_in,
    r_out) or the emission row (+ scatter block).  ``cfg`` is a dict:
    metric, family ('rk4' | 'rk45'), flags (None: disk, else (blackbody,
    beaming, scatter)), disk (the DiskParams of the gas), twin, and the
    march's knobs."""

    @staticmethod
    def forward(ctx, cfg, x0, p0, surf, *fields):
        metric, family, flags = cfg["metric"], cfg["family"], cfg["flags"]
        (y0, E, L) = _rays(x0, p0)
        kernel = x0.device.type == "cuda" and not cfg["twin"]
        iters = None
        if kernel:
            vol_kw = (dict(disk=(knob(surf[0]), knob(surf[1])))
                      if flags is None else
                      dict(vol_disk=cfg["disk"], vol_row=surf[:10],
                           scatter_block=surf[10:] if flags[2] else None))
            if family == "rk4":
                x, p, sign, steps, extra = march_kerr_cuda(
                    metric, x0, p0, dt=cfg["dt"], max_steps=cfg["max_steps"],
                    escape_radius=cfg["R"], axis_u0=cfg["axis_u0"],
                    far_r0=cfg["far_r0"], **vol_kw)
            else:
                x, p, sign, steps, extra, iters = march_kerr_rk45_cuda(
                    metric, x0, p0, dt0=cfg["dt"],
                    max_steps=cfg["max_steps"], max_iters=cfg["max_iters"],
                    escape_radius=cfg["R"], rtol=cfg["rtol"],
                    atol=cfg["atol"], dt_min=cfg["dt_min"],
                    dt_max=cfg["dt_max"], return_iters=True, **vol_kw)
            extras = ((*extra[0], *extra[1]) if flags is None
                      else (extra[0], *extra[1]))
        else:
            theta = _theta(metric, E, L, surf, x0)
            with torch.no_grad():
                y, sign, steps, iters = _twin_forward(cfg, theta, y0)
            x, p = _pack(y[:5], E, L)
            extras = y[5 + (family == "rk45") + (flags is None):]
        ctx.cfg = cfg
        counts = steps if iters is None else iters
        ctx.save_for_backward(x0, p0, surf, sign, counts)
        ctx.mark_non_differentiable(sign, steps)
        return (x, p, sign, steps, *extras)

    @staticmethod
    def backward(ctx, g_x, g_p, _g_sign, _g_steps, *g_ex):
        cfg = ctx.cfg
        metric, family, flags = cfg["metric"], cfg["family"], cfg["flags"]
        x0, p0, surf, sign, counts = ctx.saved_tensors
        (y0, E, L) = _rays(x0, p0)
        zero = torch.zeros_like(y0[0])
        smooth = (sign == 0) | (sign == 1)
        replayable = sign != 3
        g_ex = _zeros_for(g_ex, zero)
        cot = [torch.where(smooth, c, zero) for c in
               (g_x[:, 1], g_x[:, 2], g_x[:, 3], g_p[:, 1], g_p[:, 2])]
        if family == "rk45":
            cot.append(zero)                          # dt: no cotangent
        if flags is None:
            cot.append(zero)                          # ct_prev
        cot += [torch.where(replayable, c, zero) for c in g_ex]
        counts = torch.where(replayable, counts, torch.zeros_like(counts))
        kernel = x0.device.type == "cuda" and not cfg["twin"]
        n_surf = surf.shape[0]
        if kernel:
            g, lam = cks.ckpt_kerr_surface_backward_cuda(
                family, flags, _scalars(cfg, surf),
                [t.contiguous() for t in y0], E.contiguous(), L.contiguous(),
                counts.to(torch.int32), torch.stack(cot).contiguous(),
                freeze=cfg["freeze"])
            g_theta = (torch.sum(g[0]), torch.sum(g[1]), torch.sum(g[2]),
                       g[3], g[4])
            g_surf = (torch.zeros_like(surf) if flags is None else
                      torch.stack([torch.sum(g[5 + i])
                                   for i in range(n_surf)]))
        else:
            theta = tuple(t.detach() for t in _theta(metric, E, L, surf, x0))
            start = tuple(t.detach() for t in _start(cfg, y0))
            step = _step_fn(cfg)
            mx = cfg["max_steps"] if family == "rk4" else cfg["max_iters"]
            d_theta, lam = ckpt_adjoint_backward(
                step, theta, start, counts, tuple(cot), max_steps=mx,
                segment=max(1, int(math.sqrt(mx))))
            g_theta = d_theta[:5]
            g_surf = torch.stack(list(d_theta[5:5 + n_surf]))
        lam = list(lam[:5]) + list(lam[5:])
        if flags is None:
            # ct_prev0 = cos(theta0): its cotangent chain-rules into theta0
            i_ct = 6 if family == "rk45" else 5
            lam[1] = lam[1] + lam[i_ct] * (-torch.sin(x0[:, 2]))
        res = input_grads(metric, x0, p0, g_p, g_theta, lam[:5])
        return res[:3] + (g_surf.to(surf.dtype),) + res[3:]


def _theta(metric, E, L, surf, like):
    """(M, a, q2, E, L) + the surface's entries."""
    return ((metric.m, metric.a, q2_of(metric, like), E, L)
            + tuple(surf[i] for i in range(surf.shape[0])))


def _start(cfg, y0):
    """The replayed start: the spawn state, dt0 (DP5(4)), then (cos
    theta0, zeros) (disk) or zeros (gas)."""
    zero = torch.zeros_like(y0[0])
    y = tuple(y0)
    if cfg["family"] == "rk45":
        y += (torch.full_like(zero, cfg["dt"]),)
    if cfg["flags"] is None:
        return y + (torch.cos(y0[1]),) + (zero,) * 6
    return y + (zero,) * 4


def _consts(cfg, like):
    return tuple(torch.tensor(v, dtype=like.dtype, device=like.device)
                 for v in (cfg["rtol"], cfg["atol"], cfg["dt_min"],
                           cfg["dt_max"], cfg["R"], cfg["r_cap"], cfg["dt"]))


def _step_fn(cfg):
    """The twin's step map of the family, (theta, y) -> y1."""
    flags = cfg["flags"]
    if cfg["family"] == "rk4":
        far = 1e30 if cfg["far_r0"] is None else cfg["far_r0"]
        if flags is None:
            return lambda th, y: _disk_step(cfg["dt"], cfg["axis_u0"], far,
                                            th, y)
        return lambda th, y: _vol_step(flags[0], flags[1], cfg["dt"],
                                       cfg["axis_u0"], far, th, y)
    consts = _consts(cfg, torch.zeros((), dtype=cfg["dtype"],
                                      device=cfg["device"]))
    track = flags is None
    bb, beam = (False, False) if track else flags[:2]
    return lambda th, y: _rk45_surface_iter(consts, th, y, track, not track,
                                            bb, beam, cfg["freeze"])[0]


def _twin_forward(cfg, theta, y0):
    """The twin's forward -> (y, sign, steps, iters or None)."""
    flags = cfg["flags"]
    start = _start(cfg, y0)
    if cfg["family"] == "rk4":
        step = _step_fn(cfg)
        tau_max = None if flags is None else theta[5 + TAU_MAX]
        y, sign, steps = _forward_xla_fixed(
            lambda yy: step(theta, yy), start, cfg["R"], cfg["r_cap"],
            cfg["max_steps"], tau_max=tau_max)
        return y, sign, steps, None
    track = flags is None
    bb, beam = (False, False) if track else flags[:2]
    consts = _consts(cfg, y0[0])
    return _forward_xla_rk45_surface(
        consts, theta, y0, start[6:], cfg["dt"], cfg["max_steps"],
        cfg["max_iters"], track, not track, bb, beam)


def _scalars(cfg, surf):
    """The march kernel's row of the family (the kernels' replay reads the
    forward's values)."""
    metric, flags = cfg["metric"], cfg["flags"]
    vol_kw = (dict(disk=(knob(surf[0]), knob(surf[1]))) if flags is None
              else dict(vol_disk=cfg["disk"], vol_row=surf[:10],
                        scatter_block=surf[10:] if flags[2] else None))
    if cfg["family"] == "rk4":
        far = 1e30 if cfg["far_r0"] is None else cfg["far_r0"]
        return kerr_scalars(metric, cfg["dt"], cfg["R"],
                            axis_u0=cfg["axis_u0"], far_r0=far, **vol_kw)
    return kerr_rk45_scalars(metric, cfg["dt"], cfg["R"], rtol=cfg["rtol"],
                             atol=cfg["atol"], dt_min=cfg["dt_min"],
                             dt_max=cfg["dt_max"], **vol_kw)


# ---------------------------------------------------------------------------
# the public marches
# ---------------------------------------------------------------------------

def _vol_surf(disk, disk_theta, scatter_block, like):
    """The gas's traced row: ``build_vol_row`` and the scatter block."""
    row = build_vol_row(disk, disk_theta, dtype=like.dtype,
                        device=like.device)
    if scatter_block is not None:
        row = torch.cat([row, torch.as_tensor(scatter_block).to(
            dtype=like.dtype, device=like.device).reshape(-1)])
    return row


def _gas_flags(disk, scatter_block):
    return (disk.color_mode == "blackbody",
            bool(disk.redshift or disk.doppler), scatter_block is not None)


def _run(metric, x0, p0, surf, cfg, backend):
    if backend not in ("auto", "twin"):
        raise ValueError(f"backend must be 'auto' or 'twin', got {backend!r}")
    cfg = dict(cfg, metric=metric, twin=backend == "twin",
               r_cap=knob(metric.capture_radius), dtype=x0.dtype,
               device=x0.device)
    fields = tuple(getattr(metric, k) for k in metric.fields)
    return _KerrSurfaceAdjoint.apply(cfg, x0, p0, surf, *fields)


def _band(r_inner, r_outer, like):
    return torch.stack([torch.as_tensor(v, dtype=like.dtype,
                                        device=like.device).reshape(())
                        for v in (r_inner, r_outer)])


def _fixed_cfg(dt, max_steps, escape_radius, axis_u0, far_r0):
    return dict(dt=knob(dt), max_steps=int(max_steps),
                R=knob(escape_radius), axis_u0=knob(axis_u0),
                far_r0=None if far_r0 is None else knob(far_r0),
                freeze=False, family="rk4")


def march_kerr_disk_adjoint(metric, x0, p0, *, dt, max_steps, escape_radius,
                            r_inner, r_outer, axis_u0=0.01, far_r0=None,
                            backend="auto"):
    """Differentiable Kerr / Kerr-Newman thin-disk RK4 march (module
    docstring) -> (x, p, sign, steps, ((h1, h1_phi, h1_side), (h2, h2_phi,
    h2_side))), the contract of ``march_kerr_cuda(disk=...)``.  Gradients
    reach the metric, x0 and p0; (r_inner, r_outer) gate the recording
    (their cotangent is zero; the shading reads the band)."""
    out = _run(metric, x0, p0, _band(r_inner, r_outer, x0),
               dict(_fixed_cfg(dt, max_steps, escape_radius, axis_u0,
                               far_r0), flags=None, disk=None), backend)
    return out[:4] + ((out[4:7], out[7:10]),)


def march_kerr_vol_adjoint(metric, x0, p0, disk, *, dt, max_steps,
                           escape_radius, disk_theta=None, scatter_block=None,
                           axis_u0=0.01, far_r0=None, backend="auto"):
    """Differentiable Kerr / Kerr-Newman volumetric RK4 march (module
    docstring) -> (x, p, sign, steps, tau, (em_r, em_g, em_b)), the
    contract of ``march_kerr_cuda(vol_disk=...)``.  Gradients reach the
    metric, x0, p0, the tensors of ``disk_theta`` (see
    ``build_vol_row``) and the ``scatter_block``."""
    surf = _vol_surf(disk, disk_theta, scatter_block, x0)
    out = _run(metric, x0, p0, surf,
               dict(_fixed_cfg(dt, max_steps, escape_radius, axis_u0,
                               far_r0),
                    flags=_gas_flags(disk, scatter_block), disk=disk),
               backend)
    return out[:4] + (out[4], tuple(out[5:8]))


def _rk45_cfg(dt0, max_steps, escape_radius, rtol, atol, dt_min, dt_max,
              max_iters, freeze_controller):
    return dict(dt=knob(dt0), max_steps=int(max_steps),
                max_iters=default_max_iters(max_steps, max_iters),
                R=knob(escape_radius), rtol=knob(rtol), atol=knob(atol),
                dt_min=knob(dt_min),
                dt_max=(knob(escape_radius) / 8.0 if dt_max is None
                        else knob(dt_max)),
                freeze=bool(freeze_controller), family="rk45")


def march_kerr_rk45_disk_adjoint(metric, x0, p0, *, dt0, max_steps,
                                 escape_radius, r_inner, r_outer, rtol=1e-4,
                                 atol=1e-7, dt_min=1e-5, dt_max=None,
                                 max_iters=None, backend="auto",
                                 freeze_controller=False):
    """Differentiable error-controlled Kerr / Kerr-Newman thin-disk march,
    the DP5(4) twin of :func:`march_kerr_disk_adjoint` (same contract; the
    replay bound is max_iters, default 2 max_steps: pass DP5(4)-scale
    max_steps)."""
    out = _run(metric, x0, p0, _band(r_inner, r_outer, x0),
               dict(_rk45_cfg(dt0, max_steps, escape_radius, rtol, atol,
                              dt_min, dt_max, max_iters, freeze_controller),
                    flags=None, disk=None), backend)
    return out[:4] + ((out[4:7], out[7:10]),)


def march_kerr_rk45_vol_adjoint(metric, x0, p0, disk, *, dt0, max_steps,
                                escape_radius, disk_theta=None,
                                scatter_block=None, rtol=1e-4, atol=1e-7,
                                dt_min=1e-5, dt_max=None, max_iters=None,
                                backend="auto", freeze_controller=False):
    """Differentiable error-controlled Kerr / Kerr-Newman volumetric march,
    the DP5(4) twin of :func:`march_kerr_vol_adjoint` (same contract)."""
    surf = _vol_surf(disk, disk_theta, scatter_block, x0)
    out = _run(metric, x0, p0, surf,
               dict(_rk45_cfg(dt0, max_steps, escape_radius, rtol, atol,
                              dt_min, dt_max, max_iters, freeze_controller),
                    flags=_gas_flags(disk, scatter_block), disk=disk),
               backend)
    return out[:4] + (out[4], tuple(out[5:8]))
