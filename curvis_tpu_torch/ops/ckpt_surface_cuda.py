"""Checkpointed-recompute adjoint of the planar disk marches on the GPU:
wrapper of the CUDA kernels ``csrc/ckpt_surface.cu`` (Euler) and
``csrc/ckpt_surface_rk45*.cu`` (DP5(4)), the variants of
``curvis_tpu/ops/ckpt_adjoint_pallas.py``'s ``_ckpt_gen_kernel`` (#9) and
``_ckpt_bwd_kernel`` (#10) for the step families of
``curvis_tpu/integrate/planar_surface_adjoint.py``, and their plain
PyTorch versions.

The Euler families are the steps of the two Euler disk marches:

  * thin (kernel #5, ``csrc/disk.cu``): state y = (l, psi, p_l, u, v, h1,
    h1p, h1s, h2, h2p, h2s), parameters theta = (p0, p1, p2, b, c1, c2,
    r_in, r_out);
  * volumetric (kernel #6, ``csrc/disk_vol.cu``): y = (l, psi, p_l, u, v,
    tau, em_r, em_g, em_b), theta = (p0, p1, p2, b, c1, c2, nz, r_in,
    r_out, the 8 emission slots of ``VOL_SLOT_NAMES``), then the
    ``SCATTER_BLOCK`` scalars when the scatter source is on.

The metric slots (p0, p1, p2) and the disk row are the kernels' scalar row
(``ops/disk_cuda.py:disk_scalars``, ``ops/disk_vol_cuda.py:vol_scalars``);
b, c1, c2 and nz are per ray.  A tabulated metric (the kind
``ops/table_cuda.py:TableKind``) has the metric parameters (s^2, series
c1[0..K], series c2[0..K]) in place of (p0, p1, p2): in the steps' theta
they lead, as the JAX package's theta; in the per-ray cotangents the
kernels return, s^2 takes slot p0 (p1, p2 stay 0) and the 2 (K + 1) series
coefficients follow the family's theta (``n_theta``).  The table's series
c1 / c2 are not the plane coefficients c1 / c2.  Ray i takes ``steps[i]`` steps from
y0 = (l, psi, p_l, cos psi, sin psi, 0, ...) and is frozen after.

``ckpt_surface_backward_cuda`` pulls a cotangent of the final state back to
y0 and theta: kernels #9 / #10 for CUDA tensors, the plain pair for CPU
tensors, never a fallback from the one to the other.  It returns per-ray
cotangents of every theta entry; the caller sums the shared ones.

The checkpoint buffer is compacted: ray i owns ceil(steps[i] / seg)
consecutive rows of ``n_state`` floats from ``offsets[i]``, the exclusive
prefix sum of those counts (one device-to-host read of the total per
backward), so its size follows the rays' mean step count and not the
longest ray's.  ``ckpt_surface_gen_plain`` and ``ckpt_surface_bwd_plain``
keep the same layout.

The plain versions run vectorised over rays with masks, on any device.
They march with ``disk_step`` and ``vol_step``, the one plain form of each
step, which the differentiable CPU route
(``integrate/planar_surface_adjoint.py``) differentiates under autograd
too; ``disk_step_vjp_plain`` and ``vol_step_vjp_plain`` transcribe the
kernels' hand-written VJPs line by line.  At a clamp the cotangent passes on the
closed interval and a max of two equal values splits it in halves, as
torch's autograd does, so these VJPs equal ``torch.func.vjp`` of the steps.

The DP5(4) families (the rk45 section below) are one iteration of kernel
#4's surface variants, ``ops/rk45_disk_cuda.py:rk45_surface_iter_plain``:
thin y = (l, psi, p_l, dt, h1, h1p, h1s, h2, h2p, h2s), volumetric y =
(l, psi, p_l, dt, tau, em_r, em_g, em_b), theta as the Euler families',
the scalar row kernel #4's (``rk45_disk_scalars``), ``iters[i]``
iterations from (l, psi, p_l, dt0, 0...).  ``rk45_thin_iter_vjp_plain``
and ``rk45_vol_iter_vjp_plain`` transcribe the kernels' iteration VJPs
(``csrc/ckpt_surface_rk45.cuh`` on ``csrc/rk45_vjp.cuh``), reusing the
crossing, hit and emission VJPs above, and add their theta terms to the
running sums in the kernels' order.
"""
from __future__ import annotations

import functools
import math

import torch

from curvis_tpu_torch.integrate.rk45_adjoint_planar import _guarded_deriv_fns
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops import ckpt_rk45_cuda as ckr
from curvis_tpu_torch.ops import rk45_disk_cuda as r4
from curvis_tpu_torch.ops.ckpt_adjoint_cuda import (_dneg_shape,
                                                    euler_step_vjp,
                                                    planar_deriv,
                                                    segment_offsets)
from curvis_tpu_torch.ops.disk_cuda import LAPSE_KINDS
from curvis_tpu_torch.ops.disk_vol_cuda import (_BB_K, _BB_L5,
                                                SCATTER_BLOCK, SCATTER_DEG,
                                                inv_r2_plain,
                                                vol_emission_plain)
from curvis_tpu_torch.ops.march_cuda import KINDS
from curvis_tpu_torch.ops.rk45_cuda import next_dt_plain, trial_rec_plain
from curvis_tpu_torch.ops.table_cuda import (kernel_table, n_series,
                                             slot_params, table_shape_vjp)

SEG = 32                 # default segment: 32 Euler steps per recompute
MAX_SEG = 64             # longest segment the backward kernel can hold
N_DISK = 11              # thin-disk state
N_VOL = 9                # volumetric state
N_THETA_DISK = 8         # p0, p1, p2, b, c1, c2, r_in, r_out
N_THETA_VOL = 17         # p0, p1, p2, b, c1, c2, nz, r_in, r_out, 8 slots

# the volumetric flags as the kernels' runtime bitmask
FLAG_BITS = {"blackbody": 1, "redshift": 2, "doppler": 4, "scatter": 8}

launches = {"surface_gen": 0, "surface_bwd": 0}   # since the last reset


def n_state(flags):
    """State size of a family: ``flags`` None is the thin disk, a
    (blackbody, redshift, doppler, scatter) tuple the volumetric one."""
    return N_DISK if flags is None else N_VOL


def n_theta(flags, kind=None):
    """Rows of a family's per-ray theta cotangents: the family's own, then
    a table ``kind``'s 2 (K + 1) series coefficients."""
    if flags is None:
        return N_THETA_DISK + n_series(kind)
    return N_THETA_VOL + (SCATTER_BLOCK if flags[3] else 0) + n_series(kind)


def flag_mask(flags):
    """The runtime bitmask of a volumetric family (0 for the thin one)."""
    if flags is None:
        return 0
    return sum(bit for bit, on in zip(FLAG_BITS.values(), flags) if on)


# ------------------------------------------------------- the steps

def disk_step(kind, dt, theta, y):
    """One step of the thin-disk map: theta = (p0, p1, p2, b, c1, c2, r_in,
    r_out) (a table's (s^2, c1..., c2...) in place of (p0, p1, p2)),
    y = (l, psi, p_l, u, v, h1, h1p, h1s, h2, h2p, h2s), the hits
    signed (sign = sheet) -> (y1, new1, new2), the booleans saying which
    hit slot this step filled.  Kernel #5's step (csrc/planar.cuh:
    disk_step: the crossing on zq = c1 u + c2 v) with the guarded RHS of
    ``integrate/rk45_adjoint_planar.py``, which equals the kernel's off the
    guards, and selects for the hit slots."""
    p = theta[:-5]
    b, c1, c2, r_in, r_out = theta[-5:]
    l, psi, p_l, u, v, h1, h1p, h1s, h2, h2p, h2s = y
    dl, dpsi, dpl = _guarded_deriv_fns(kind)(p, l, p_l, b, b * b)
    l1 = l + dt * dl
    pl1 = p_l + dt * dpl
    du = dt * dpsi
    u1 = u - v * du
    v1 = v + u * du
    zq = c1 * u + c2 * v
    zq1 = c1 * u1 + c2 * v1
    crossed = zq * zq1 < 0.0
    den = torch.abs(zq) + torch.abs(zq1)
    frac = torch.abs(zq) / torch.clamp(den, min=1e-30)
    lh = l + frac * (l1 - l)
    r_hit = torch.abs(lh)
    pl_hit = p_l + frac * (pl1 - p_l)
    psi_hit = psi + frac * du
    in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
    new1 = in_disk & (h1 == 0.0)
    new2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
    y1 = (l1, psi + dt * dpsi, pl1, u1, v1,
          torch.where(new1, lh, h1), torch.where(new1, pl_hit, h1p),
          torch.where(new1, psi_hit, h1s), torch.where(new2, lh, h2),
          torch.where(new2, pl_hit, h2p), torch.where(new2, psi_hit, h2s))
    return y1, new1, new2


def vol_step(kind, flags, dt, theta, y):
    """One step of the volumetric map: theta = (p0, p1, p2, b, c1, c2, nz,
    surf) (a table's metric part as ``disk_step``'s), ``surf`` the emission
    row (with the scatter block when ``flags[3]``), y = (l, psi, p_l, u, v,
    tau, em_r, em_g, em_b).  Kernel
    #6's step (csrc/planar_vol.cuh:vol_step) with the guarded RHS; the
    emission is ``vol_emission_plain`` at the post-step state with the
    pre-step tau."""
    p = theta[:-5]
    b, c1, c2, nz, surf = theta[-5:]
    l, psi, p_l, u, v, tau, emr, emg, emb = y
    dl, dpsi, dpl = _guarded_deriv_fns(kind)(p, l, p_l, b, b * b)
    l = l + dt * dl
    psi = psi + dt * dpsi
    p_l = p_l + dt * dpl
    du = dt * dpsi
    u, v = u - v * du, v + u * du
    zq = c1 * u + c2 * v
    dtau, dem = vol_emission_plain(kind, flags, p, surf, l, p_l, b, zq, tau,
                                   nz)
    return (l, psi, p_l, u, v, tau + dt * dtau, emr + dt * dem[0],
            emg + dt * dem[1], emb + dt * dem[2])


def step_theta(flags, row, b, c1, c2, nz, kind):
    """(dt, theta) of ``disk_step`` (``flags`` None) or ``vol_step`` from
    the kernels' scalar row ``row`` = [dt, R, p0, p1, p2, r_cap, ...] as a
    tensor (a table ``kind``'s metric part from its series)."""
    p = slot_params(kind, row)
    if flags is None:
        return row[0], (*p, b, c1, c2, row[6], row[7])
    return row[0], (*p, b, c1, c2, nz, row[6:])


# ------------------------------------------------------- plain VJPs

def _slots_series(kind, gm, zero):
    """Metric cotangents in the order of the metric parameters -> (the
    slots (p0, p1, p2), the series coefficients' list): a table's s^2
    takes p0 and its series follow the family's theta, as the kernels keep
    them."""
    if kind == "table":
        return (gm[0], zero, zero), list(gm[1:])
    return tuple(gm), []


def _add_metric(kind, g, gm, act, base):
    """Adds the metric cotangents ``gm`` (in the metric parameters' order)
    to the per-ray sums ``g`` where ``act``: to the slots, a table's s^2 to
    p0 and its series to the rows from ``base``."""
    (s0, s1, s2), series = _slots_series(kind, gm, None)
    g[0] = g[0] + ckr.masked(act, s0)
    if kind != "table":
        g[1] = g[1] + ckr.masked(act, s1)
        g[2] = g[2] + ckr.masked(act, s2)
    for k, c in enumerate(series):
        g[base + k] = g[base + k] + ckr.masked(act, c)


def _clamp_pass(x, lo=None, hi=None):
    """1 where torch.clamp passes the cotangent (lo <= x <= hi), else 0."""
    ok = torch.ones_like(x, dtype=torch.bool)
    if lo is not None:
        ok = ok & (x >= lo)
    if hi is not None:
        ok = ok & (x <= hi)
    return ok.to(x.dtype)


def _max_split(a, b):
    """(share of a, share of b) of max(a, b)'s cotangent: all to the larger,
    halves at a tie (torch.maximum's rule)."""
    sa = torch.where(a > b, 1.0, torch.where(a < b, 0.0, 0.5)).to(a.dtype)
    return sa, 1.0 - sa


def crossing_frac(zq, zq1):
    """csrc/surface_vjp.cuh:crossing_frac: (a0, a1, inv_den, big, frac) of
    frac = |zq| / max(|zq| + |zq1|, 1e-30)."""
    a0, a1 = torch.abs(zq), torch.abs(zq1)
    den = a0 + a1
    inv_den = 1.0 / torch.clamp(den, min=1e-30)
    return a0, a1, inv_den, den >= 1e-30, a0 * inv_den


def crossing_frac_vjp(cf, zq, zq1, g_frac):
    """csrc/surface_vjp.cuh:crossing_frac_vjp: cotangents of (zq, zq1)."""
    a0, a1, inv_den, big, _ = cf
    g_a0 = torch.where(big, g_frac * a1 * inv_den * inv_den,
                       g_frac * inv_den)
    g_a1 = torch.where(big, -g_frac * a0 * inv_den * inv_den,
                       torch.zeros_like(g_frac))
    return g_a0 * torch.sign(zq), g_a1 * torch.sign(zq1)


def take_hit_cotangent(new1, new2, lam_h):
    """csrc/surface_vjp.cuh:take_hit_cotangent: the cotangent (g_lh, g_plh,
    g_psih) of the hit triple a step wrote (slot 1 where ``new1``, slot 2
    where ``new2``), and the six hit cotangents with the filled slot's
    zeroed, as through a select."""
    zero = torch.zeros_like(lam_h[0])
    g = tuple(torch.where(new1, lam_h[c], torch.where(new2, lam_h[3 + c],
                                                      zero))
              for c in range(3))
    keep1 = lambda x: torch.where(new1, zero, x)        # noqa: E731
    keep2 = lambda x: torch.where(new2, zero, x)        # noqa: E731
    return g, (keep1(lam_h[0]), keep1(lam_h[1]), keep1(lam_h[2]),
               keep2(lam_h[3]), keep2(lam_h[4]), keep2(lam_h[5]))


def disk_step_vjp_plain(kind, row, start, new1, new2, b, c1, c2, lam):
    """VJP of ``disk_step`` at the step's start (l, p_l, u, v) (psi
    and the hits do not enter its arithmetic), with the slots it filled
    (``new1``, ``new2``) as data, as csrc/ckpt_surface.cu:disk_step_vjp.
    ``lam`` (11) is the cotangent of the step's output -> (that of its
    input (11), per-ray theta cotangents (8, then a table's series)).  A
    filled slot's old value gets no cotangent, as through a select."""
    dt, p = row[0], slot_params(kind, row)
    l, p_l, u, v = start
    lam_l, lam_psi, lam_pl, lam_u, lam_v = lam[:5]
    zero = torch.zeros_like(l)
    dl, dpsi, dpl = planar_deriv(kind, p, l, p_l, b)
    l1 = l + dt * dl
    pl1 = p_l + dt * dpl
    du = dt * dpsi
    u1 = u - v * du
    v1 = v + u * du
    zq = c1 * u + c2 * v
    zq1 = c1 * u1 + c2 * v1
    cf = crossing_frac(zq, zq1)
    frac = cf[4]
    # the hit triple written this step: lh, pl_hit, psi_hit
    (g_lh, g_plh, g_psih), hits = take_hit_cotangent(new1, new2, lam[5:])
    g_frac = g_lh * (l1 - l) + g_plh * (pl1 - p_l) + g_psih * du
    g_l1 = lam_l + frac * g_lh
    g_pl1 = lam_pl + frac * g_plh
    g_du = lam_psi + frac * g_psih
    g_zq, g_zq1 = crossing_frac_vjp(cf, zq, zq1, g_frac)
    # zq = c1 u + c2 v, zq1 = c1 u1 + c2 v1, u1 = u - v du, v1 = v + u du
    g_u1 = lam_u + c1 * g_zq1
    g_v1 = lam_v + c2 * g_zq1
    g_c1 = u * g_zq + u1 * g_zq1
    g_c2 = v * g_zq + v1 * g_zq1
    g_u = c1 * g_zq + g_u1 + du * g_v1
    g_v = c2 * g_zq - du * g_u1 + g_v1
    g_du = g_du - v * g_u1 + u * g_v1
    # the Euler update and the RHS: l1 = l + dt dl, du = dt dpsi, ...
    (g_l, _, g_pl), gm = euler_step_vjp(kind, dt, p, l, p_l, b,
                                        (g_l1, g_du, g_pl1))
    slots, series = _slots_series(kind, gm[:-1], zero)
    lam_in = (g_l + (1.0 - frac) * g_lh, lam_psi + g_psih,
              g_pl + (1.0 - frac) * g_plh, g_u, g_v, *hits)
    return lam_in, (*slots, gm[-1], g_c1, g_c2, zero, zero, *series)


def _radius_vjp(kind, p, l, g_r):
    """Cotangents (of l, of the metric parameters p) of the emission's
    radius r(l): l for the lapse kinds, else rsqrt(1 / r^2) of the shape
    function (a table's through ``table_shape_vjp``, as
    csrc/surface_vjp.cuh:radius_vjp)."""
    zero = torch.zeros_like(l)
    if kind in LAPSE_KINDS:
        return g_r, (zero, zero, zero)
    q = inv_r2_plain(kind, p, l)
    r = torch.rsqrt(q)
    g_q = g_r * (-0.5) * r * r * r
    if kind == "table":
        _, _, g_l, g_s2, gc = table_shape_vjp(kind, p, l, g_q, zero)
        return g_l, (g_s2, *gc)
    p0, p1, p2 = p
    if kind == "ellis":
        g_den = -g_q * q * q
        return g_den * 2.0 * l, (g_den * 2.0 * p0, zero, zero)
    if kind == "flat":
        return -g_q * q * q * 2.0 * l, (zero, zero, zero)
    # interstellar: q = ir^2, ir = 1 / rd, rd of csrc/planar.cuh:dneg_shape
    m, a = p0, p1
    rd, _ = _dneg_shape(m, a, p2, l)
    ir = 1.0 / rd
    g_rd = -(g_q * 2.0 * ir) * ir * ir
    sg = torch.where(l < 0.0, -1.0, 1.0).to(l.dtype)
    c = 2.0 / (math.pi * m)
    x = c * (torch.abs(l) - a)
    at = torch.atan(x)
    outside = torch.abs(l) > a
    g_x = g_rd * m * at
    g_m = torch.where(outside, g_rd * (x * at - 0.5 * torch.log1p(x * x))
                      - g_x * x / m, zero)
    g_a = torch.where(outside, -g_x * c, zero)
    g_l = torch.where(outside, g_x * sg * c, zero)
    return g_l, (g_m, g_a, g_rd)


def vol_emission_vjp_plain(kind, flags, p, surf, l, p_l, b, zq, tau, nz,
                           g_dtau, g_dem):
    """VJP of ``ops/disk_vol_cuda.py:vol_emission_plain`` (metric
    parameters ``p``, emission row ``surf``) at (l, p_l, b, zq, tau, nz)
    for the cotangents of (dtau, dem_r, dem_g, dem_b), as
    csrc/surface_vjp.cuh:vol_emission_vjp -> (g_l, g_pl, g_b, g_zq, g_tau,
    g_nz, g_p (in p's order), g_surf (10: r_in, r_out and the 8 slots),
    g_block (SCATTER_BLOCK, or None without scatter))."""
    blackbody, redshift, doppler, scatter = flags
    r_in, r_out = surf[0], surf[1]
    h2, inv_norm, kappa, _, t_peak, emis_q, spin, t_scale = surf[2:10]
    blk = surf[10:]
    zero = torch.zeros_like(l)
    lapse = kind in LAPSE_KINDS
    # ---- forward, as vol_emission_plain
    r = l if lapse else torch.rsqrt(inv_r2_plain(kind, p, l))
    zq2 = zq * zq
    s2_raw = 1.0 - zq2
    s2 = torch.clamp(s2_raw, 1e-12, 1.0)
    sq_s2 = torch.sqrt(s2)
    r_cyl = r * sq_s2
    dn = 2.0 * h2 * s2
    E = torch.exp(-zq2 / dn)
    P = inv_norm / r_cyl
    dens = E * P
    w_edge = r_out - r_in
    ein_raw = (r_cyl - r_in) / (0.1 * w_edge)
    edge_in = torch.clamp(ein_raw, 0.0, 1.0)
    eout_raw = (r_out - r_cyl) / (0.3 * w_edge)
    edge_out = torch.clamp(eout_raw, 0.0, 1.0)
    base = dens * edge_in * edge_out
    rr = torch.maximum(r_cyl, r_in)
    g = torch.ones_like(r_cyl)
    shift = lapse and (redshift or doppler)
    if shift:
        M = p[0]
        q2 = p[1] if kind == "rn" else zero
        if kind == "rn":
            A_raw = 1.0 - (2.0 * M - q2 / rr) / rr
            vsq = (M - q2 / rr) / rr
        else:
            A_raw = 1.0 - 2.0 * M / rr
            vsq = M / rr
        A = torch.clamp(A_raw, 1e-3, 1.0)
        sqA = torch.sqrt(A)
        g0 = sqA if redshift else torch.ones_like(sqA)
        g = g0
        if doppler:
            svsq = torch.sqrt(vsq)
            vr = svsq / sqA
            vel = torch.clamp(vr, 0.0, 0.99)
            gamma = torch.rsqrt(1.0 - vel * vel)
            u_l = p_l * sqA
            u_psi = b / rr
            Q = u_l * u_l + u_psi * u_psi + 1e-30
            inv = torch.rsqrt(Q)
            upi = u_psi * inv
            cos_xi = upi * nz * spin
            D = gamma * (1.0 - vel * cos_xi)
            g = g0 / D
    trans = torch.exp(-tau)
    tb = trans * base
    # ---- reverse
    g_base = kappa * g_dtau
    g_kappa = base * g_dtau
    g_tb = zero
    g_g = zero
    g_rr = zero
    g_rin = zero
    g_rout = zero
    g_tpeak = zero
    g_tscale = zero
    g_emisq = zero
    g_scat = g_dem if scatter else None
    g_blk = [zero] * SCATTER_BLOCK if scatter else None
    if blackbody:
        sq = torch.sqrt(r_in / rr)
        ln_r = torch.log(rr)
        om_raw = 1.0 - sq
        om = torch.clamp(om_raw, min=1e-20)
        f = torch.exp(-0.75 * ln_r + 0.25 * torch.log(om))
        t_obs = g * t_scale * f
        rel_sq = t_obs / t_peak
        rel = rel_sq * rel_sq
        rel = rel * rel
        Tc = torch.clamp(t_obs, min=1.0)
        inv_T = 1.0 / Tc
        xs, es, qs_raw, lgs = [], [], [], []
        for k_c, l5 in zip(_BB_K, _BB_L5):
            x = k_c * inv_T
            e = torch.exp(-x)
            q_raw = 1.0 - e
            xs.append(x)
            es.append(e)
            qs_raw.append(q_raw)
            lgs.append(l5 - (x + torch.log(torch.clamp(q_raw, min=1e-30))))
        m12 = torch.maximum(lgs[1], lgs[2])
        mx = torch.maximum(lgs[0], m12)
        w = tb * rel
        exs = [torch.exp(lg - mx) for lg in lgs]
        g_w = g_dem[0] * exs[0] + g_dem[1] * exs[1] + g_dem[2] * exs[2]
        g_lg = [g_dem[c] * w * exs[c] for c in range(3)]
        g_m = -(g_lg[0] + g_lg[1] + g_lg[2])
        s0, s12 = _max_split(lgs[0], m12)
        s1, s2_ = _max_split(lgs[1], lgs[2])
        g_lg[0] = g_lg[0] + g_m * s0
        g_lg[1] = g_lg[1] + g_m * s12 * s1
        g_lg[2] = g_lg[2] + g_m * s12 * s2_
        g_tb = g_tb + g_w * rel
        g_rel = g_w * tb
        g_relsq = g_rel * 4.0 * rel_sq * rel_sq * rel_sq
        g_tobs = g_relsq / t_peak
        g_tpeak = -g_relsq * rel_sq / t_peak
        g_invT = zero
        for c in range(3):
            qc = torch.clamp(qs_raw[c], min=1e-30)
            g_x = -g_lg[c] - g_lg[c] * es[c] / qc * _clamp_pass(qs_raw[c],
                                                                1e-30)
            g_invT = g_invT + g_x * _BB_K[c]
        g_tobs = g_tobs - g_invT * inv_T * inv_T * _clamp_pass(t_obs, 1.0)
        g_g = g_g + g_tobs * t_scale * f
        g_tscale = g_tobs * g * f
        g_f = g_tobs * g * t_scale
        g_arg = g_f * f
        g_lnr = -0.75 * g_arg
        g_om = 0.25 * g_arg / om
        g_sq = -g_om * _clamp_pass(om_raw, 1e-20)
        g_ratio = g_sq * 0.5 / sq
        g_rin = g_rin + g_ratio / rr
        g_rr = g_rr - g_ratio * (r_in / rr) / rr + g_lnr / rr
    else:
        ratio = r_in / rr
        L = torch.log(ratio)
        emis = torch.exp(emis_q * L)
        cg = torch.clamp(g, 0.0, 4.0)
        cg3 = cg * cg * cg
        w = tb * emis * cg3
        if scatter:
            g_w = g_dem[0] * blk[0] + g_dem[1] * blk[1] + g_dem[2] * blk[2]
            for c in range(3):
                g_blk[c] = g_dem[c] * w
        else:
            g_w = g_dem[0] + g_dem[1] + g_dem[2]
        g_tb = g_tb + g_w * emis * cg3
        g_emis = g_w * tb * cg3
        g_cg3 = g_w * tb * emis
        g_g = g_g + g_cg3 * 3.0 * cg * cg * _clamp_pass(g, 0.0, 4.0)
        g_emisq = g_emis * emis * L
        g_ratio = g_emis * emis * emis_q / ratio
        g_rin = g_rin + g_ratio / rr
        g_rr = g_rr - g_ratio * ratio / rr
    g_rcyl = zero
    if scatter:
        # scat_c = tb max(acc_c, 0), acc_c a Horner sum in t
        W = r_out - r_in
        t_raw = 2.0 * (r_cyl - r_in) / W - 1.0
        t = torch.clamp(t_raw, -1.0, 1.0)
        g_t = zero
        for c in range(3):
            c0 = 3 + c * (SCATTER_DEG + 1)
            accs = [blk[c0 + SCATTER_DEG]]
            for k in range(SCATTER_DEG - 1, -1, -1):
                accs.append(accs[-1] * t + blk[c0 + k])
            acc = accs[-1]
            cl = torch.clamp(acc, min=0.0)
            g_tb = g_tb + g_scat[c] * cl
            G = g_scat[c] * tb * _clamp_pass(acc, 0.0)
            # accs[j] = accs[j - 1] t + blk[c0 + SCATTER_DEG - j]
            for j in range(SCATTER_DEG, 0, -1):
                g_blk[c0 + SCATTER_DEG - j] = g_blk[c0 + SCATTER_DEG - j] + G
                g_t = g_t + G * accs[j - 1]
                G = G * t
            g_blk[c0 + SCATTER_DEG] = g_blk[c0 + SCATTER_DEG] + G
        g_traw = g_t * _clamp_pass(t_raw, -1.0, 1.0)
        g_a = g_traw * 2.0 / W
        g_rcyl = g_rcyl + g_a
        g_rin = g_rin - g_a
        g_W = -g_a * (r_cyl - r_in) / W
        g_rout = g_rout + g_W
        g_rin = g_rin - g_W
    g_trans = g_tb * base
    g_base = g_base + g_tb * trans
    g_tau = -g_trans * trans
    g_pl = zero
    g_b = zero
    g_nz = zero
    g_spin = zero
    g_M = zero
    g_q2 = zero
    if shift:
        g_sqA = zero
        if doppler:
            g_g0 = g_g / D
            g_D = -g_g * g / D
            g_gamma = g_D * (1.0 - vel * cos_xi)
            g_vel = -g_D * gamma * cos_xi
            g_cos = -g_D * gamma * vel
            g_upi = g_cos * nz * spin
            g_nz = g_cos * upi * spin
            g_spin = g_cos * upi * nz
            g_upsi = g_upi * inv
            g_inv = g_upi * u_psi
            # (g_inv inv) first: a zero cotangent stays zero where inv^3
            # would overflow float32
            g_Q = -0.5 * (g_inv * inv) * inv * inv
            g_ul = g_Q * 2.0 * u_l
            g_upsi = g_upsi + g_Q * 2.0 * u_psi
            g_b = g_upsi / rr
            g_rr = g_rr - g_upsi * u_psi / rr
            g_pl = g_ul * sqA
            g_sqA = g_sqA + g_ul * p_l
            g_vel = g_vel + g_gamma * vel * gamma * gamma * gamma
            g_vr = g_vel * _clamp_pass(vr, 0.0, 0.99)
            g_sqA = g_sqA - g_vr * vr / sqA
            g_vsq = (g_vr / sqA) * 0.5 / svsq
            if kind == "rn":
                g_M = g_M + g_vsq / rr
                g_q2 = g_q2 - g_vsq / (rr * rr)
                g_rr = g_rr + g_vsq * (q2 / (rr * rr) / rr - vsq / rr)
            else:
                g_M = g_M + g_vsq / rr
                g_rr = g_rr - g_vsq * M / (rr * rr)
            if redshift:
                g_sqA = g_sqA + g_g0
        else:
            g_sqA = g_sqA + g_g
        g_A = g_sqA * 0.5 / sqA * _clamp_pass(A_raw, 1e-3, 1.0)
        if kind == "rn":
            g_M = g_M - 2.0 * g_A / rr
            g_q2 = g_q2 + g_A / (rr * rr)
            g_rr = g_rr + g_A * (2.0 * M / (rr * rr)
                                 - 2.0 * q2 / (rr * rr * rr))
        else:
            g_M = g_M - 2.0 * g_A / rr
            g_rr = g_rr + g_A * 2.0 * M / (rr * rr)
    # rr = max(r_cyl, r_in)
    s_cyl, s_in = _max_split(r_cyl, r_in)
    g_rcyl = g_rcyl + g_rr * s_cyl
    g_rin = g_rin + g_rr * s_in
    # base = dens edge_in edge_out
    g_dens = g_base * edge_in * edge_out
    g_ein = g_base * dens * edge_out * _clamp_pass(ein_raw, 0.0, 1.0)
    g_eout = g_base * dens * edge_in * _clamp_pass(eout_raw, 0.0, 1.0)
    g_we = -(g_ein * ein_raw + g_eout * eout_raw) / w_edge
    g_rcyl = g_rcyl + g_ein / (0.1 * w_edge) - g_eout / (0.3 * w_edge)
    g_rin = g_rin - g_ein / (0.1 * w_edge) - g_we
    g_rout = g_rout + g_eout / (0.3 * w_edge) + g_we
    # dens = E P, E = exp(-zq2 / dn), P = inv_norm / r_cyl
    g_E = g_dens * P
    g_P = g_dens * E
    g_invnorm = g_P / r_cyl
    g_rcyl = g_rcyl - g_P * P / r_cyl
    g_arg = g_E * E
    g_zq2 = -g_arg / dn
    g_dn = g_arg * zq2 / (dn * dn)
    g_h2 = g_dn * 2.0 * s2
    g_s2 = g_dn * 2.0 * h2
    # r_cyl = r sqrt(s2), s2 = clip(1 - zq2)
    g_r = g_rcyl * sq_s2
    g_s2 = g_s2 + g_rcyl * r * 0.5 / sq_s2
    g_zq2 = g_zq2 - g_s2 * _clamp_pass(s2_raw, 1e-12, 1.0)
    g_zq = 2.0 * zq * g_zq2
    g_l, g_pm = _radius_vjp(kind, p, l, g_r)
    g_p = g_pm if kind == "table" else (g_pm[0] + g_M, g_pm[1] + g_q2,
                                        g_pm[2])
    g_surf = (g_rin, g_rout, g_h2, g_invnorm, g_kappa, zero, g_tpeak,
              g_emisq, g_spin, g_tscale)
    return (g_l, g_pl, g_b, g_zq, g_tau, g_nz, g_p, g_surf, g_blk)


def vol_step_vjp_plain(kind, flags, row, start, b, c1, c2, nz, lam):
    """VJP of ``vol_step`` at the step's start (l, p_l, u, v, tau)
    (psi and the emission sums do not enter its arithmetic), as
    csrc/ckpt_surface.cu:vol_step_vjp.  ``lam`` (9) is the cotangent of
    the step's output -> (that of its input (9), per-ray theta cotangents
    (17, or 44 with the scatter block, then a table's series))."""
    dt, p = row[0], slot_params(kind, row)
    l, p_l, u, v, tau = start
    lam_l, lam_psi, lam_pl, lam_u, lam_v, lam_tau, *lam_em = lam
    dl, dpsi, dpl = planar_deriv(kind, p, l, p_l, b)
    l1 = l + dt * dl
    pl1 = p_l + dt * dpl
    du = dt * dpsi
    u1 = u - v * du
    v1 = v + u * du
    zq = c1 * u1 + c2 * v1
    (g_l1e, g_pl1e, g_be, g_zq, g_tau, g_nz, g_pe, g_surf,
     g_blk) = vol_emission_vjp_plain(kind, flags, p, row[6:], l1, pl1, b,
                                     zq, tau, nz, dt * lam_tau,
                                     [dt * e for e in lam_em])
    g_l1 = lam_l + g_l1e
    g_pl1 = lam_pl + g_pl1e
    g_u1 = lam_u + c1 * g_zq
    g_v1 = lam_v + c2 * g_zq
    g_c1 = u1 * g_zq
    g_c2 = v1 * g_zq
    g_u = g_u1 + du * g_v1
    g_v = -du * g_u1 + g_v1
    g_du = -v * g_u1 + u * g_v1
    # psi1 = psi + dt dpsi and du = dt dpsi: dpsi's cotangent is
    # dt (lam_psi + g_du)
    (g_l, _, g_pl), gm = euler_step_vjp(kind, dt, p, l, p_l, b,
                                        (g_l1, lam_psi + g_du, g_pl1))
    lam_in = (g_l, lam_psi, g_pl, g_u, g_v, lam_tau + g_tau, *lam_em)
    slots, series = _slots_series(
        kind, [a + c for a, c in zip(gm[:-1], g_pe)], torch.zeros_like(l))
    g = (*slots, gm[-1] + g_be, g_c1, g_c2, g_nz, *g_surf)
    if g_blk is not None:
        g = g + tuple(g_blk)
    return lam_in, g + tuple(series)


# ------------------------------------------------------- plain kernel pair

def _y0(flags, l, psi, p_l):
    zero = torch.zeros_like(l)
    return ((l, psi, p_l, torch.cos(psi), torch.sin(psi))
            + (zero,) * (n_state(flags) - 5))


def _stepper(kind, flags, row, b, c1, c2, nz):
    dt, theta = step_theta(flags, row, b, c1, c2, nz, kind)
    if flags is None:
        return lambda y: disk_step(kind, dt, theta, y)[0]
    return lambda y: vol_step(kind, flags, dt, theta, y)


def ckpt_surface_gen_plain(kind, flags, scal, l, psi, p_l, b, c1, c2, nz,
                           steps, *, seg, offsets, total):
    """Plain version of kernel #9's surface variant: the masked march from
    y0 writing each ray's segment starts into the compacted (total,
    n_state) buffer -> (ckpt, final state (n_state, n))."""
    row = torch.tensor(scal, dtype=l.dtype, device=l.device)
    step = _stepper(kind, flags, row, b, c1, c2, nz)
    y = _y0(flags, l, psi, p_l)
    n_s = n_state(flags)
    ckpt = torch.zeros((total, n_s), dtype=l.dtype, device=l.device)
    n_seg = -(-int(steps.max()) // seg) if steps.numel() else 0
    for s in range(n_seg):
        has = s * seg < steps
        ckpt[offsets[has] + s] = torch.stack(y, 1)[has]
        for k in range(seg):
            act = s * seg + k < steps
            y1 = step(y)
            y = tuple(torch.where(act, a1, a0) for a0, a1 in zip(y, y1))
    return ckpt, torch.stack(y)


def ckpt_surface_bwd_plain(kind, flags, scal, ckpt, b, c1, c2, nz, steps,
                           cot, *, seg, offsets):
    """Plain version of kernel #10's surface variant: each segment, last to
    first, re-marched from its checkpoint and pulled back through its steps
    with the step VJP -> (per-ray theta cotangents (n_theta, n), lam
    (n_state, n)).  A step at or past a ray's count is the identity."""
    row = torch.tensor(scal, dtype=b.dtype, device=b.device)
    lam = tuple(cot)
    g = [torch.zeros_like(b) for _ in range(n_theta(flags, kind))]
    dt, theta = step_theta(flags, row, b, c1, c2, nz, kind)
    n_seg = -(-int(steps.max()) // seg) if steps.numel() else 0
    for s in range(n_seg - 1, -1, -1):
        has = s * seg < steps
        rows = ckpt[torch.where(has, offsets + s, 0)]
        y = tuple(rows[:, c] for c in range(rows.shape[1]))
        starts = []
        for _ in range(seg):
            if flags is None:
                y1, new1, new2 = disk_step(kind, dt, theta, y)
                starts.append(((y[0], y[2], y[3], y[4]), new1, new2))
            else:
                y1 = vol_step(kind, flags, dt, theta, y)
                starts.append((y[0], y[2], y[3], y[4], y[5]))
            y = y1
        for k in range(seg - 1, -1, -1):
            act = s * seg + k < steps
            if flags is None:
                st, new1, new2 = starts[k]
                new, dg = disk_step_vjp_plain(kind, row, st, new1, new2, b,
                                              c1, c2, lam)
            else:
                new, dg = vol_step_vjp_plain(kind, flags, row, starts[k], b,
                                             c1, c2, nz, lam)
            lam = tuple(torch.where(act, a1, a0) for a0, a1 in zip(lam, new))
            g = [gi + torch.where(act, d, torch.zeros_like(d))
                 for gi, d in zip(g, dg)]
    return torch.stack(g), torch.stack(lam)


# ------------------------------------------------------------ the kernels

def _flat_f32(*arrays):
    n = arrays[0].numel()
    for a in arrays:
        if a.dtype != torch.float32:
            raise TypeError(f"surface checkpoint kernels take float32, got "
                            f"{a.dtype}")
        if a.shape != (n,) or not a.is_contiguous():
            raise ValueError("surface checkpoint kernels take contiguous "
                             f"(n,) rays, got {tuple(a.shape)}")


def launch_gen(kind, flags, scal, l, psi, p_l, b, c1, c2, nz, steps, *,
               seg, offsets, total):
    """Kernel #9's surface variant on flat contiguous CUDA tensors of one
    device (float32 rays, int32 steps, int64 offsets) -> (the (total,
    n_state) checkpoint buffer, the final state (n_state, n))."""
    _flat_f32(l, psi, p_l, b, c1, c2, nz)
    n = l.numel()
    if steps.dtype != torch.int32 or offsets.dtype != torch.int64:
        raise TypeError("steps must be int32 and offsets int64")
    dev = l.device
    n_s = n_state(flags)
    ckpt = torch.empty((max(total, 1), n_s), dtype=torch.float32, device=dev)
    final = torch.empty((n_s, n), dtype=torch.float32, device=dev)
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_ckpt_surface_gen(
        KINDS[kind], int(flags is not None), flag_mask(flags), row,
        len(scal), _build.table_ptr(tab), l.data_ptr(), psi.data_ptr(), p_l.data_ptr(),
        b.data_ptr(), c1.data_ptr(), c2.data_ptr(), nz.data_ptr(),
        steps.data_ptr(), offsets.data_ptr(), ckpt.data_ptr(),
        final.data_ptr(), n, seg, dev.index, stream)
    _build.check(lib, err, "ckpt_surface_gen_kernel")
    launches["surface_gen"] += 1
    return ckpt, final


def launch_bwd(kind, flags, scal, ckpt, b, c1, c2, nz, steps, cot, *, seg,
               offsets):
    """Kernel #10's surface variant on the checkpoint buffer of
    ``launch_gen`` and the (n_state, n) cotangent ``cot`` -> (per-ray theta
    cotangents (n_theta, n), lam (n_state, n))."""
    _flat_f32(b, c1, c2, nz)
    n = b.numel()
    dev = b.device
    n_s = n_state(flags)
    if cot.dtype != torch.float32 or cot.shape != (n_s, n) \
            or not cot.is_contiguous():
        raise ValueError(f"bad cotangent {tuple(cot.shape)}")
    if ckpt.dtype != torch.float32 or ckpt.shape[1:] != (n_s,) \
            or not ckpt.is_contiguous():
        raise ValueError(f"bad checkpoint buffer {tuple(ckpt.shape)}")
    lam = torch.empty((n_s, n), dtype=torch.float32, device=dev)
    g = torch.empty((n_theta(flags, kind), n), dtype=torch.float32,
                    device=dev)
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_ckpt_surface_bwd(
        KINDS[kind], int(flags is not None), flag_mask(flags), row,
        len(scal), _build.table_ptr(tab), ckpt.data_ptr(), b.data_ptr(), c1.data_ptr(),
        c2.data_ptr(), nz.data_ptr(), steps.data_ptr(), offsets.data_ptr(),
        cot.data_ptr(), lam.data_ptr(), g.data_ptr(), n, seg, dev.index,
        stream)
    _build.check(lib, err, "ckpt_surface_bwd_kernel")
    launches["surface_bwd"] += 1
    return g, lam


def ckpt_surface_backward_cuda(kind, flags, scal, y0, b, c1, c2, nz, steps,
                               cot, *, seg=SEG):
    """Exact pullback of the masked disk march of ``kind`` (thin for
    ``flags`` None, else volumetric with ``flags`` = (blackbody, redshift,
    doppler, scatter)) with the scalar row ``scal``: ray i takes
    ``steps[i]`` steps from y0 = (l, psi, p_l) extended with (cos psi,
    sin psi) and zeros; ``cot`` is the (n_state, n) cotangent of the final
    state -> ``(g_theta (n_theta, n), lam (n_state, n))``, lam the
    cotangent of the extended y0.  CUDA tensors run kernels #9 / #10, CPU
    tensors their plain versions."""
    if not 1 <= seg <= MAX_SEG:
        raise ValueError(f"segment {seg} outside [1, {MAX_SEG}]")
    offsets, total = segment_offsets(steps, seg)
    dev = b.device
    if total == 0:
        return (torch.zeros((n_theta(flags, kind), b.numel()), dtype=b.dtype,
                            device=dev), cot.clone())
    if dev.type == "cpu":
        ckpt, _ = ckpt_surface_gen_plain(kind, flags, scal, *y0, b, c1, c2,
                                         nz, steps, seg=seg, offsets=offsets,
                                         total=total)
        return ckpt_surface_bwd_plain(kind, flags, scal, ckpt, b, c1, c2,
                                      nz, steps, cot, seg=seg,
                                      offsets=offsets)
    if dev.type != "cuda":
        raise ValueError(f"ckpt_surface_backward_cuda: unsupported device "
                         f"{dev}")
    ckpt, _ = launch_gen(kind, flags, scal, *y0, b, c1, c2, nz, steps,
                         seg=seg, offsets=offsets, total=total)
    return launch_bwd(kind, flags, scal, ckpt, b, c1, c2, nz, steps, cot,
                      seg=seg, offsets=offsets)


# ----------------------------------------------- the DP5(4) families

RK45_SEG = 16            # default segment: the JAX package's _PALLAS_SEG_RK45
RK45_MAX_SEG = 32        # longest segment the rk45 backward kernel can hold
N_DISK_RK45 = 10         # thin: l, psi, p_l, dt, h1, h1p, h1s, h2, h2p, h2s
N_VOL_RK45 = 8           # vol: l, psi, p_l, dt, tau, em_r, em_g, em_b

launches.update(surface_rk45_gen=0, surface_rk45_bwd=0)


def n_state_rk45(flags):
    return N_DISK_RK45 if flags is None else N_VOL_RK45


def rk45_thin_iter_vjp_plain(kind, row, start, new1, new2, b, c1, c2, lam,
                             freeze=False, g=None, act=None):
    """VJP of ``ops/rk45_disk_cuda.py:rk45_surface_iter_plain`` (disk
    tracker) at the start (l, psi, p_l, dt), with the hit slot it filled as
    data, as csrc/ckpt_surface_rk45.cu:rk45_thin_iter_vjp.  ``lam`` (10) is
    the cotangent of the state after it -> (that of the state before it
    (10), the per-ray theta sums ``g`` (8, then a table's series) with this
    iteration's terms added as the kernel adds them (from zeros when None;
    ``act`` masks them))."""
    p = slot_params(kind, row)
    dt0, r_out = row[0], row[10]
    l, psi, p_l, dt = start
    zero = torch.zeros_like(l)
    r = trial_rec_plain(kind, p, row[1], row[6], row[7], l, psi, p_l, b, dt)
    ln, psin, pln = r["out"]
    cs0, sn0 = torch.cos(psi), torch.sin(psi)
    cs1, sn1 = torch.cos(psin), torch.sin(psin)
    zq0, zq1 = c1 * cs0 + c2 * sn0, c1 * cs1 + c2 * sn1
    terminal = ckr.terminal_plain(row, r)
    g_out = list(lam[:3])
    g_y = [zero, zero, zero]
    g_zq0 = g_zq1 = g_dt = g_err = zero
    if not freeze:
        g_next = lam[3]
        clamp = ~terminal & (torch.abs(ln) < r_out + 2.0)
        nxt = next_dt_plain(row[8], r["err"], r["dt"])
        lim_raw = 0.2 * torch.abs(ln) * torch.abs(zq1)
        lim = torch.maximum(dt0, lim_raw)
        g_raw = torch.where(clamp, g_next * ckr._max_share(nxt, lim)
                            * ckr._max_share(lim_raw, dt0), zero)
        g_next = torch.where(clamp, g_next * ckr._max_share(lim, nxt),
                             g_next)
        g_out[0] = g_out[0] + g_raw * 0.2 * torch.abs(zq1) * torch.sign(ln)
        g_zq1 = g_zq1 + g_raw * (0.2 * torch.abs(ln)) * torch.sign(zq1)
        g_dt, g_err = ckr.control_vjp_plain(row, r, terminal, g_next)
    (g_lh, g_plh, g_psih), hits = take_hit_cotangent(new1, new2, lam[4:])
    cf = crossing_frac(zq0, zq1)
    frac = cf[4]
    g_frac = g_lh * (ln - l) + g_plh * (pln - p_l) + g_psih * (psin - psi)
    g_out[0] = g_out[0] + frac * g_lh
    g_out[1] = g_out[1] + frac * g_psih
    g_out[2] = g_out[2] + frac * g_plh
    g_y = [g_y[0] + (1.0 - frac) * g_lh, g_y[1] + (1.0 - frac) * g_psih,
           g_y[2] + (1.0 - frac) * g_plh]
    gz0, gz1 = crossing_frac_vjp(cf, zq0, zq1, g_frac)
    filled = new1 | new2
    g_zq0 = g_zq0 + torch.where(filled, gz0, zero)
    g_zq1 = g_zq1 + torch.where(filled, gz1, zero)
    g_out[1] = g_out[1] + g_zq1 * (c2 * cs1 - c1 * sn1)
    g_y[1] = g_y[1] + g_zq0 * (c2 * cs0 - c1 * sn0)
    g = [zero] * n_theta(None, kind) if g is None else list(g)
    g[4] = g[4] + ckr.masked(act, g_zq0 * cs0 + g_zq1 * cs1)
    g[5] = g[5] + ckr.masked(act, g_zq0 * sn0 + g_zq1 * sn1)
    g_y, g_dt, g = ckr.trial_vjp_plain(kind, row, p, b, r, g_out, g_err, g_y,
                                       g_dt, g, act, series_at=N_THETA_DISK)
    return (*g_y, g_dt, *hits), tuple(g)


def rk45_vol_iter_vjp_plain(kind, flags, row, start, b, c1, c2, nz, lam,
                            freeze=False, g=None, act=None):
    """VJP of ``rk45_surface_iter_plain`` (vol) at the start (l, psi, p_l,
    dt, tau), as csrc/ckpt_surface_rk45.cu:rk45_vol_iter_vjp.  ``lam`` (8)
    is the cotangent of the state after it -> (that of the state before it
    (8), the per-ray theta sums ``g`` (17, or 44 with the scatter block,
    then a table's series) with this iteration's terms added (from zeros when None; ``act`` masks
    them): the gas clamp's and the emission's first, then (c1, c2) and
    the stages', in the kernel's order of the terms that carry the
    controller's chain."""
    p = slot_params(kind, row)
    surf = row[9:]
    base = n_theta(flags)
    dt0, r_out, h2, tau_max = row[0], row[10], row[11], row[14]
    l, psi, p_l, dt, tau = start
    zero = torch.zeros_like(l)
    r = trial_rec_plain(kind, p, row[1], row[6], row[7], l, psi, p_l, b, dt)
    ln, psin, pln = r["out"]
    accept = r["accept"]
    cs1, sn1 = torch.cos(psin), torch.sin(psin)
    zq1 = c1 * cs1 + c2 * sn1
    dtau, dem = vol_emission_plain(kind, flags, p, surf, ln, pln, b, zq1,
                                   tau, nz)
    opaque = accept & (tau + dt * dtau > tau_max)
    terminal = ckr.terminal_plain(row, r, opaque)
    m = functools.partial(ckr.masked, act)
    g = [zero] * n_theta(flags, kind) if g is None else list(g)
    g_out = list(lam[:3])
    g_zq1 = g_dt = g_err = zero
    if not freeze:
        g_next = lam[3]
        nxt = next_dt_plain(row[8], r["err"], r["dt"])
        if kind in LAPSE_KINDS:
            rl = ln
        else:
            q = inv_r2_plain(kind, p, ln)
            rl = torch.rsqrt(torch.clamp(q, min=1e-30))
        s2_raw = 1.0 - zq1 * zq1
        sq = torch.sqrt(torch.clamp(s2_raw, 1e-12, 1.0))
        r_cyl = rl * sq
        gap_r = r_cyl - (r_out + 2.0)
        sh2 = torch.sqrt(h2)
        h_rel5 = 5.0 * sh2
        gap_z = rl * torch.abs(zq1) - h_rel5 * r_cyl
        lim_raw = 0.5 * torch.maximum(gap_r, gap_z)
        lim = torch.maximum(dt0, lim_raw)
        g_gap = torch.where(terminal, zero, 0.5 * g_next
                            * ckr._max_share(nxt, lim)
                            * ckr._max_share(lim_raw, dt0))
        g_next = torch.where(terminal, g_next,
                             g_next * ckr._max_share(lim, nxt))
        s_r = ckr._max_share(gap_r, gap_z)
        g_gr, g_gz = g_gap * s_r, g_gap * (1.0 - s_r)
        g_rcyl = g_gr - g_gz * h_rel5
        g[8] = g[8] + m(-g_gr)                     # r_out
        g[9] = g[9] + m(-g_gz * r_cyl * 5.0 * 0.5 / sh2)   # h2 (slot 0)
        g_zq1 = g_zq1 + g_gz * rl * torch.sign(zq1)
        g_rl = g_gz * torch.abs(zq1) + g_rcyl * sq
        g_s2 = g_rcyl * rl * 0.5 / sq
        g_zq1 = g_zq1 - 2.0 * zq1 * g_s2 * ckr._clip_share(s2_raw, 1e-12,
                                                             1.0)
        if kind in LAPSE_KINDS:
            g_out[0] = g_out[0] + g_rl
        else:
            g_lr, g_pr = _radius_vjp(kind, p, ln,
                                     g_rl * ckr._max_share(q, 1e-30))
            g_out[0] = g_out[0] + g_lr
            _add_metric(kind, g, g_pr, act, base)
        g_dt, g_err = ckr.control_vjp_plain(row, r, terminal, g_next)
    # tau += dt dtau, em += dt dem on an accepted iteration (the trial dt)
    lam_em = [torch.where(accept, e, zero) for e in lam[5:]]
    lam_tau = torch.where(accept, lam[4], zero)
    g_dt = g_dt + lam_tau * dtau + sum(e * d for e, d in zip(lam_em, dem))
    (g_le, g_ple, g_be, g_zqe, g_taue, g_nze, g_pe, g_surf,
     g_blk) = vol_emission_vjp_plain(kind, flags, p, surf, ln, pln, b, zq1,
                                     tau, nz, dt * lam_tau,
                                     [dt * e for e in lam_em])
    g_out[0] = g_out[0] + g_le
    g_out[2] = g_out[2] + g_ple
    g_zq1 = g_zq1 + g_zqe
    g_out[1] = g_out[1] + g_zq1 * (c2 * cs1 - c1 * sn1)
    _add_metric(kind, g, g_pe, act, base)
    g[3] = g[3] + m(g_be)
    g[6] = g[6] + m(g_nze)
    for i, gs in enumerate(g_surf):
        g[7 + i] = g[7 + i] + m(gs)
    if g_blk is not None:
        for i, gs in enumerate(g_blk):
            g[17 + i] = g[17 + i] + m(gs)
    g[4] = g[4] + m(g_zq1 * cs1)
    g[5] = g[5] + m(g_zq1 * sn1)
    g_y, g_dt, g = ckr.trial_vjp_plain(kind, row, p, b, r, g_out, g_err,
                                       (zero, zero, zero), g_dt, g, act,
                                       series_at=base)
    return (*g_y, g_dt, lam[4] + g_taue, *lam[5:]), tuple(g)


def ckpt_surface_rk45_gen_plain(kind, flags, scal, l, psi, p_l, b, c1, c2,
                                nz, iters, *, seg, offsets, total):
    """Plain version of kernel #9's rk45 surface variant: the masked march
    of ``iters[i]`` iterations from (l, psi, p_l, dt0, 0...), writing each
    ray's segment starts into the compacted (total, n_state) buffer ->
    (ckpt, final state (n_state, n))."""
    row = torch.tensor(scal, dtype=l.dtype, device=l.device)
    theta = r4.surface_theta(flags, row, b, c1, c2, nz, kind)
    n_s = n_state_rk45(flags)
    zero = torch.zeros_like(l)
    y = (l, psi, p_l, torch.ones_like(l) * row[0]) + (zero,) * (n_s - 4)
    ckpt = torch.zeros((total, n_s), dtype=l.dtype, device=l.device)
    n_seg = -(-int(iters.max()) // seg) if iters.numel() else 0
    for s in range(n_seg):
        has = s * seg < iters
        ckpt[offsets[has] + s] = torch.stack(y, 1)[has]
        for k in range(seg):
            act = s * seg + k < iters
            y1, _ = r4.rk45_surface_iter_plain(kind, flags, row, theta, y)
            y = tuple(torch.where(act, a1, a0) for a0, a1 in zip(y, y1))
    return ckpt, torch.stack(y)


def ckpt_surface_rk45_bwd_plain(kind, flags, scal, freeze, ckpt, b, c1, c2,
                                nz, iters, cot, *, seg, offsets):
    """Plain version of kernel #10's rk45 surface variant: each segment,
    last to first, re-marched from its checkpoint and pulled back through
    its iterations with the iteration VJP -> (per-ray theta cotangents
    (n_theta, n), lam (n_state, n)).  An iteration at or past a ray's count
    is the identity."""
    row = torch.tensor(scal, dtype=b.dtype, device=b.device)
    theta = r4.surface_theta(flags, row, b, c1, c2, nz, kind)
    lam = tuple(cot)
    g = [torch.zeros_like(b) for _ in range(n_theta(flags, kind))]
    n_seg = -(-int(iters.max()) // seg) if iters.numel() else 0
    for s in range(n_seg - 1, -1, -1):
        has = s * seg < iters
        rows = ckpt[torch.where(has, offsets + s, 0)]
        y = tuple(rows[:, c] for c in range(rows.shape[1]))
        starts = []
        for _ in range(seg):
            y1, (_, _, new1, new2) = r4.rk45_surface_iter_plain(
                kind, flags, row, theta, y)
            starts.append((y[:4], new1, new2) if flags is None else y[:5])
            y = y1
        for k in range(seg - 1, -1, -1):
            act = s * seg + k < iters
            if flags is None:
                st, new1, new2 = starts[k]
                new, g = rk45_thin_iter_vjp_plain(kind, row, st, new1, new2,
                                                  b, c1, c2, lam, freeze, g,
                                                  act)
            else:
                new, g = rk45_vol_iter_vjp_plain(kind, flags, row, starts[k],
                                                 b, c1, c2, nz, lam, freeze,
                                                 g, act)
            lam = tuple(torch.where(act, a1, a0) for a0, a1 in zip(lam, new))
    return torch.stack(g), torch.stack(lam)


def launch_rk45_gen(kind, flags, scal, l, psi, p_l, b, c1, c2, nz, iters, *,
                    seg, offsets, total):
    """Kernel #9's rk45 surface variant on flat contiguous CUDA tensors of
    one device (float32 rays, int32 iters, int64 offsets; ``scal`` kernel
    #4's surface row) -> (the (total, n_state) checkpoint buffer, the final
    state (n_state, n))."""
    _flat_f32(l, psi, p_l, b, c1, c2, nz)
    n = l.numel()
    if iters.dtype != torch.int32 or offsets.dtype != torch.int64:
        raise TypeError("iters must be int32 and offsets int64")
    dev = l.device
    n_s = n_state_rk45(flags)
    ckpt = torch.empty((max(total, 1), n_s), dtype=torch.float32, device=dev)
    final = torch.empty((n_s, n), dtype=torch.float32, device=dev)
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_ckpt_surface_rk45_gen(
        KINDS[kind], int(flags is not None), flag_mask(flags), row,
        len(scal), _build.table_ptr(tab), l.data_ptr(), psi.data_ptr(), p_l.data_ptr(),
        b.data_ptr(), c1.data_ptr(), c2.data_ptr(), nz.data_ptr(),
        iters.data_ptr(), offsets.data_ptr(), ckpt.data_ptr(),
        final.data_ptr(), n, seg, dev.index, stream)
    _build.check(lib, err, "ckpt_surface_rk45_gen_kernel")
    launches["surface_rk45_gen"] += 1
    return ckpt, final


def launch_rk45_bwd(kind, flags, scal, freeze, ckpt, b, c1, c2, nz, iters,
                    cot, *, seg, offsets):
    """Kernel #10's rk45 surface variant on the buffer of
    ``launch_rk45_gen`` and the (n_state, n) cotangent ``cot`` -> (per-ray
    theta cotangents (n_theta, n), lam (n_state, n))."""
    _flat_f32(b, c1, c2, nz)
    n = b.numel()
    dev = b.device
    n_s = n_state_rk45(flags)
    if cot.dtype != torch.float32 or cot.shape != (n_s, n) \
            or not cot.is_contiguous():
        raise ValueError(f"bad cotangent {tuple(cot.shape)}")
    if ckpt.dtype != torch.float32 or ckpt.shape[1:] != (n_s,) \
            or not ckpt.is_contiguous():
        raise ValueError(f"bad checkpoint buffer {tuple(ckpt.shape)}")
    lam = torch.empty((n_s, n), dtype=torch.float32, device=dev)
    g = torch.empty((n_theta(flags, kind), n), dtype=torch.float32,
                    device=dev)
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_ckpt_surface_rk45_bwd(
        KINDS[kind], int(flags is not None), flag_mask(flags), row,
        len(scal), _build.table_ptr(tab), int(bool(freeze)), ckpt.data_ptr(), b.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), nz.data_ptr(), iters.data_ptr(),
        offsets.data_ptr(), cot.data_ptr(), lam.data_ptr(), g.data_ptr(), n,
        seg, dev.index, stream)
    _build.check(lib, err, "ckpt_surface_rk45_bwd_kernel")
    launches["surface_rk45_bwd"] += 1
    return g, lam


def ckpt_surface_rk45_backward_cuda(kind, flags, scal, freeze, y0, b, c1,
                                    c2, nz, iters, cot, *, seg=RK45_SEG):
    """Exact pullback of kernel #4's masked surface march (thin for
    ``flags`` None, else vol) with its scalar row ``scal``: ray i takes
    ``iters[i]`` iterations from y0 = (l, psi, p_l) extended with dt0 and
    zeros; ``cot`` is the (n_state, n) cotangent of the final state ->
    ``(g_theta (n_theta, n), lam (n_state, n))``.  CUDA tensors run kernels
    #9 / #10, CPU tensors their plain versions."""
    if not 1 <= seg <= RK45_MAX_SEG:
        raise ValueError(f"segment {seg} outside [1, {RK45_MAX_SEG}]")
    offsets, total = segment_offsets(iters, seg)
    dev = b.device
    if total == 0:
        return (torch.zeros((n_theta(flags, kind), b.numel()), dtype=b.dtype,
                            device=dev), cot.clone())
    if dev.type == "cpu":
        ckpt, _ = ckpt_surface_rk45_gen_plain(kind, flags, scal, *y0, b, c1,
                                              c2, nz, iters, seg=seg,
                                              offsets=offsets, total=total)
        return ckpt_surface_rk45_bwd_plain(kind, flags, scal, freeze, ckpt, b,
                                           c1, c2, nz, iters, cot, seg=seg,
                                           offsets=offsets)
    if dev.type != "cuda":
        raise ValueError(f"ckpt_surface_rk45_backward_cuda: unsupported "
                         f"device {dev}")
    ckpt, _ = launch_rk45_gen(kind, flags, scal, *y0, b, c1, c2, nz, iters,
                              seg=seg, offsets=offsets, total=total)
    return launch_rk45_bwd(kind, flags, scal, freeze, ckpt, b, c1, c2, nz,
                           iters, cot, seg=seg, offsets=offsets)
