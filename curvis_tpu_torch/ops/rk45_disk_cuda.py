"""Adaptive DP5(4) planar march with a disk surface on the GPU: wrapper of
the CUDA kernel ``csrc/planar_rk45_disk.cu`` (replacing
``curvis_tpu/ops/march_pallas.py``'s ``_rk45_kernel`` in its ``track_disk``
and ``vol`` variants, with vol's scatter option), and its plain PyTorch
version.

``march_planar_rk45_disk_cuda`` has the contract of the JAX package's
``march_planar_rk45_pallas`` with ``disk=`` or ``vol_disk=`` (without its
TPU tiling): the kernel for CUDA tensors (float32), the plain version for
CPU tensors.  A CUDA tensor never falls back to the plain version: a
failure to build or launch raises.

``march_planar_rk45_disk_plain`` is a line-by-line transcription of the
kernel's body, which is the Pallas kernel's: the iteration of
``ops/rk45_cuda.py`` (``rk45_trial_plain`` / ``rk45_control_plain``), the
crossing test on zq = c1 cos psi + c2 sin psi of the written-back state,
the emission of ``ops/disk_vol_cuda.py:vol_emission_plain`` and the
anticipatory dt clamps.  It is held against the Pallas kernel in interpret
mode, not against ``integrate/rk45.py:march_planar_rk45``, the port of the
JAX package's XLA twin (|y5 - y4| norm, pow factor, where-writeback),
whose ulps flip knife-edge accepts.  The lock-step loop masks every ray
that is no longer live, so a frozen ray never changes, as in the kernel's
per-thread loop.

The scalar row (``rk45_disk_scalars``) is the rk45 row of
``rk45_cuda.rk45_scalars``, the band (r_in, r_out) and, for vol, the eight
emission slots of ``vol_param_slots`` and the optional scatter block.  A
tabulated metric runs as ``ops/table_cuda.py:TableKind``: the kernel takes
its ``ChebTable`` beside the row, and the plain version evaluates its
series in the kernel's order.
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.integrate.rk45 import CAPPED
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.disk_cuda import LAPSE_KINDS, _flat_f32
from curvis_tpu_torch.ops.disk_vol_cuda import (inv_r2_plain, scatter_row,
                                                vol_emission_plain,
                                                vol_param_slots)
from curvis_tpu_torch.ops.march_cuda import KINDS
from curvis_tpu_torch.ops.table_cuda import kernel_table, slot_params
from curvis_tpu_torch.ops.rk45_cuda import (default_max_iters, jclip,
                                            rk45_control_plain,
                                            rk45_scalars, rk45_trial_plain)
from curvis_tpu_torch.physics.planar import (_CHECK_EVERY, PlanarResult,
                                             PlanarRays)
from curvis_tpu_torch.utils.device import common_device

N_RK45 = 9               # dt0, R, p0, p1, p2, r_cap, rtol, atol, dt_max

launches = 0             # kernel launches since the last reset


def rk45_disk_scalars(metric: Metric, dt0, escape_radius, rtol, atol,
                      dt_max, *, disk=None, vol_disk=None,
                      scatter_block=None):
    """(kind, the kernel's scalar row as Python floats): the rk45 row, then
    ``disk`` = (r_in, r_out), or the band and emission slots of the
    DiskParams ``vol_disk`` with the optional scatter block."""
    if (disk is None) == (vol_disk is None):
        raise ValueError("pass disk=(r_in, r_out) OR vol_disk, not both")
    if vol_disk is None and scatter_block is not None:
        raise ValueError("scatter_block needs vol_disk")
    kind, row = rk45_scalars(metric, dt0, escape_radius, rtol, atol, dt_max)
    if disk is not None:
        return kind, row + [float(disk[0]), float(disk[1])]
    row += [float(vol_disk.r_inner), float(vol_disk.r_outer)]
    return kind, row + vol_param_slots(vol_disk) + scatter_row(scatter_block)


def disk_flags(vol_disk, scatter_block):
    """(vol, blackbody, redshift, doppler, scatter) of a march."""
    if vol_disk is None:
        return (False, False, False, False, False)
    return (True, vol_disk.color_mode == "blackbody",
            bool(vol_disk.redshift), bool(vol_disk.doppler),
            scatter_block is not None)


def surface_theta(flags, row, b, c1, c2, nz, kind):
    """theta of ``rk45_surface_iter_plain`` from the scalar row tensor of
    ``rk45_disk_scalars``: (p0, p1, p2, b, c1, c2, r_in, r_out) for the disk
    tracker (``flags`` None), (p0, p1, p2, b, c1, c2, nz, surf) for vol,
    surf = (r_in, r_out, the 8 slots[, the scatter block]); a table
    ``kind``'s (s^2, c1..., c2...) in place of (p0, p1, p2)."""
    p = slot_params(kind, row)
    if flags is None:
        return (*p, b, c1, c2, row[9], row[10])
    return (*p, b, c1, c2, nz, row[N_RK45:])


def rk45_surface_iter_plain(kind, flags, row, theta, y, freeze=False):
    """One iteration of kernel #4's surface variants on every ray
    (csrc/rk45_surface.cuh:rk45_surface_iter): ``flags`` None for the disk
    tracker, else the vol (blackbody, redshift, doppler, scatter); ``row``
    the scalar row tensor of ``rk45_disk_scalars``; theta of
    ``surface_theta``; y = (l, psi, p_l, dt, h1, h1p, h1s, h2, h2p, h2s) or
    (l, psi, p_l, dt, tau, em_r, em_g, em_b) -> (the state after it, (sign,
    accept, new1, new2)), new1 / new2 the hit slot it filled (None for
    vol).  ``freeze`` detaches the next dt.  The clips are jnp.clip's max /
    min forms, so autograd splits ties as the JAX package does."""
    vol = flags is not None
    p = theta[:-5]
    if vol:
        b, c1, c2, nz, surf = theta[-5:]
        r_out = surf[1]
    else:
        b, c1, c2, r_in, r_out = theta[-5:]
    dt0, R, r_cap = row[0], row[1], row[5]
    l0, psi0, pl0, dt = y[:4]
    alive = torch.ones(l0.shape, dtype=torch.bool, device=l0.device)
    zq = c1 * torch.cos(psi0) + c2 * torch.sin(psi0)
    l, psi, p_l, *trial = rk45_trial_plain(kind, p, R, row[6], row[7], l0,
                                           psi0, pl0, b, dt, alive)
    accept = trial[1]
    zq1 = c1 * torch.cos(psi) + c2 * torch.sin(psi)
    opaque = new1 = new2 = None
    if vol:
        tau, emr, emg, emb = y[4:]
        dtau, dem = vol_emission_plain(kind, flags, p, surf, l, p_l, b, zq1,
                                       tau, nz)
        acc = [torch.where(accept, e + dt * d, e)
               for e, d in zip((emr, emg, emb), dem)]
        tau = torch.where(accept, tau + dt * dtau, tau)
        acc.insert(0, tau)
        opaque = tau > surf[5]                  # the tau_max slot
    else:
        h1, h1p, h1s, h2_, h2p, h2s = y[4:]
        crossed = accept & (zq * zq1 < 0.0)
        frac = torch.abs(zq) / jclip(torch.abs(zq) + torch.abs(zq1), 1e-30,
                                     None)
        lh = l0 + frac * (l - l0)
        r_hit = torch.abs(lh)
        in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
        new1 = in_disk & (h1 == 0.0)
        new2 = in_disk & (h1 != 0.0) & (h2_ == 0.0)
        pl_hit = pl0 + frac * (p_l - pl0)
        psi_hit = psi0 + frac * (psi - psi0)
        acc = [torch.where(new1, lh, h1), torch.where(new1, pl_hit, h1p),
               torch.where(new1, psi_hit, h1s),
               torch.where(new2, lh, h2_), torch.where(new2, pl_hit, h2p),
               torch.where(new2, psi_hit, h2s)]
    zero = torch.zeros(l0.shape, dtype=torch.int32, device=l0.device)
    sign, _, dt = rk45_control_plain(r_cap, row[8], alive, trial, l, dt,
                                     zero, zero, opaque)
    # the anticipatory clamps of a ray still marching
    if vol:
        if kind in LAPSE_KINDS:
            rl = l
        else:
            rl = torch.rsqrt(jclip(inv_r2_plain(kind, p, l), 1e-30, None))
        r_cyl = rl * torch.sqrt(jclip(1.0 - zq1 * zq1, 1e-12, 1.0))
        gap_r = r_cyl - (r_out + 2.0)
        gap_z = rl * torch.abs(zq1) - 5.0 * torch.sqrt(surf[2]) * r_cyl
        lim = torch.maximum(dt0, 0.5 * torch.maximum(gap_r, gap_z))
        dt = torch.where(sign == 0, torch.minimum(dt, lim), dt)
    else:
        near = torch.abs(l) < (r_out + 2.0)
        lim = torch.maximum(dt0, 0.2 * torch.abs(l) * torch.abs(zq1))
        dt = torch.where(near & (sign == 0), torch.minimum(dt, lim), dt)
    if freeze:
        dt = dt.detach()
    return (l, psi, p_l, dt, *acc), (sign, accept, new1, new2)


def march_planar_rk45_disk_plain(kind, flags, scal, l, psi, p_l, b, c1, c2,
                                 nz, *, max_steps, max_iters):
    """Plain version of kernel #4's surface variants on rays of any dtype
    and device, with the scalar row of ``rk45_disk_scalars`` and ``flags``
    of ``disk_flags`` (``nz`` is read only by vol) -> (l, psi, p_l, h1,
    h1p, h1s, h2, h2p, h2s, sign, steps, iters) for the disk tracker and
    (l, psi, p_l, tau, em_r, em_g, em_b, sign, steps, iters) for vol: the
    lock-step loop of ``rk45_surface_iter_plain`` over the live rays."""
    vol, *vflags = flags
    vflags = tuple(vflags) if vol else None
    row = torch.tensor(scal, dtype=l.dtype, device=l.device)
    theta = surface_theta(vflags, row, b, c1, c2, nz, kind)
    zero = torch.zeros_like(l)
    y = (l, psi, p_l, torch.ones_like(l) * row[0]) + (zero,) * (4 if vol
                                                                else 6)
    sign = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    steps = torch.zeros_like(sign)
    iters = torch.zeros_like(sign)
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        alive = (sign == 0) & (steps < max_steps)
        iters = iters + alive.to(torch.int32)
        y1, (sg, accept, _, _) = rk45_surface_iter_plain(kind, vflags, row,
                                                         theta, y)
        y = tuple(torch.where(alive, a1, a0) for a0, a1 in zip(y, y1))
        sign = torch.where(alive, sg, sign)
        steps = steps + (alive & accept).to(torch.int32)
        sign = torch.where((sign == 0) & (steps >= max_steps), CAPPED,
                           sign).to(torch.int32)
    sign = torch.where(sign == CAPPED, 0, sign).to(torch.int32)
    return (y[0], y[1], y[2], *y[4:], sign, steps, iters)


def march_planar_rk45_disk_cuda(metric: Metric, rays: PlanarRays, *, c1, c2,
                                nz=None, disk=None, vol_disk=None,
                                scatter_block=None, escape_radius,
                                max_steps=10_000, max_iters=None, rtol=1e-5,
                                atol=1e-7, dt0=0.05, dt_max=10.0,
                                return_iters=False):
    """Adaptive DP5(4) march of ``rays`` with a surface, with the contract
    and defaults of the JAX package's ``march_planar_rk45_pallas``:
    ``disk=(r_in, r_out)`` with the plane coefficients ``c1, c2`` ->
    (PlanarResult, (h1, h1p, h1s), (h2, h2p, h2s)); ``vol_disk`` (a
    DiskParams) with ``c1, c2, nz`` and the optional ``scatter_block`` ->
    (PlanarResult, tau, (em_r, em_g, em_b)).  ``steps`` counts accepted
    steps; ``max_iters`` (default 4 max_steps) caps each ray's iterations;
    ``return_iters`` appends each ray's live iteration count.  The CUDA
    kernel for CUDA tensors (f32 only), the plain version for CPU
    tensors."""
    flags = disk_flags(vol_disk, scatter_block)
    vol = flags[0]
    if vol and nz is None:
        raise ValueError("vol_disk needs the plane normals' nz")
    planes = (c1, c2, nz) if vol else (c1, c2)
    dev = common_device(metric, rays.l, rays.psi, rays.p_l, rays.b, *planes)
    kind, scal = rk45_disk_scalars(metric, dt0, escape_radius, rtol, atol,
                                   dt_max, disk=disk, vol_disk=vol_disk,
                                   scatter_block=scatter_block)
    mi = default_max_iters(max_steps, max_iters)
    shape = rays.l.shape
    ins = [torch.broadcast_to(t, shape)
           for t in (rays.l, rays.psi, rays.p_l, rays.b, *planes)]
    if not vol:
        ins.append(None)
    if dev.type == "cpu":
        outs = march_planar_rk45_disk_plain(kind, flags, scal, *ins,
                                            max_steps=max_steps,
                                            max_iters=mi)
    elif dev.type == "cuda":
        outs = launch(kind, flags, scal,
                      *(None if t is None else _flat_f32(t) for t in ins),
                      max_steps=max_steps, max_iters=mi)
        outs = [o.reshape(shape) for o in outs]
    else:
        raise ValueError("march_planar_rk45_disk_cuda: unsupported device "
                         f"{dev}")
    res = PlanarResult(*outs[:3], *outs[-3:-1])
    acc = outs[3:-3]
    ret = ((res, acc[0], tuple(acc[1:])) if vol
           else (res, tuple(acc[:3]), tuple(acc[3:])))
    return ret + (outs[-1],) if return_iters else ret


def launch(kind, flags, scal, l, psi, p_l, b, c1, c2, nz, *, max_steps,
           max_iters):
    """One kernel launch on flat contiguous float32 CUDA tensors of one
    device (``nz`` None for the disk tracker), with the host scalars of
    ``rk45_disk_scalars`` and ``flags`` of ``disk_flags`` -> the outputs of
    ``march_planar_rk45_disk_plain``."""
    global launches
    n = l.numel()
    dev = l.device
    vol = flags[0]
    fout = torch.empty((7 if vol else 9, n), dtype=torch.float32, device=dev)
    iout = torch.empty((3, n), dtype=torch.int32, device=dev)
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_march_planar_rk45_disk(
        KINDS[kind], *(int(bool(f)) for f in flags), row, len(scal),
        _build.table_ptr(tab), l.data_ptr(), psi.data_ptr(), p_l.data_ptr(), b.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), None if nz is None else nz.data_ptr(),
        fout.data_ptr(), iout.data_ptr(), n, int(max_steps), int(max_iters),
        dev.index, stream)
    _build.check(lib, err, "march_planar_rk45_disk_kernel")
    launches += 1
    return (*fout, *iout)
