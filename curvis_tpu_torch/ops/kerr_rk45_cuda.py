"""Adaptive Dormand-Prince 5(4) march of Kerr / Kerr-Newman photons on the
GPU: wrapper of the CUDA kernel ``csrc/kerr_rk45.cu`` (replacing
``curvis_tpu/ops/march_pallas.py``'s ``_kerr_rk45_kernel``), and its plain
PyTorch version.

``march_kerr_rk45_cuda`` has the contract of the JAX package's
``march_kerr_rk45_pallas`` (without its TPU tiling): (N, 4) BL positions
and covariant momenta in, (x, p, sign, steps[, extra][, iters]) out, with
x's t component 0, p rebuilt as (-E, p_r, p_theta, L), ``steps`` the
accepted steps and ``iters`` (``return_iters``) each ray's live
iterations, accepted and rejected.  ``disk=(r_in, r_out)`` records the
first two equatorial crossings in the band as (radius, BL azimuth,
approach side) triples; ``vol_disk`` (a volumetric DiskParams)
accumulates the transfer through the gas disk on accepted steps instead,
with ``scatter_block`` its starlight source.  The kernel runs for CUDA
tensors (float32), the plain version for CPU tensors; a CUDA tensor never
falls back: a failure to build or launch raises.

``march_kerr_rk45_plain`` transcribes the kernel's arithmetic, which is
the TPU kernel's: the hand-inlined RHS and emission of ``ops/kerr_cuda.py``
(kernel #7's), the error |dt (d5 - d4)| / (atol + rtol max(|y0|, |y1|))
over (r, theta, p_r, p_theta), the boundary stepping with its overshoot
guard, the controller 0.9 exp(-0.2 log err) and the clamps near the disk.
It is not ``integrate/rk45.py:march_kerr_rk45``, the port of the JAX
package's XLA twin (autodiff RHS, |y5 - y4| norm), which the bare route
runs on the CPU.  A lock-step loop masks every ray that has ended by
select, so an ended ray never changes, as in the kernel's per-thread loop.

``max_iters`` defaults to 4 max_steps and is rounded up to even, as the
Pallas wrapper rounds it to its unroll of 2; the plain version takes the
same rounded value.  The scalar row (``kerr_rk45_scalars``) is the JAX
package's: [dt0, R, M, a, q^2, r_cap, r_in, r_out, rtol, atol], then for
the volumetric march the 8 emission slots at VOL_BLOCK_KERR, then
(dt_max, dt_min) at KERR_RK45_BOUNDS[vol], then the scatter block at
KERR_SCATTER_OFF.
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.integrate.rk45 import CAPPED, DP_A, DP_B4, DP_B5, _comb
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.kerr_cuda import (VOL_BLOCK_KERR, _flat_f32,
                                            kerr_rhs_plain, kerr_scalars,
                                            kerr_vol_emission_plain)
from curvis_tpu_torch.physics.planar import _CHECK_EVERY
from curvis_tpu_torch.utils.device import common_device

# slot of (dt_max, dt_min): after rtol, atol, or after the emission slots
KERR_RK45_BOUNDS = {False: 10, True: VOL_BLOCK_KERR + 8}

launches = 0             # kernel launches since the last reset


def kerr_rk45_scalars(metric, dt0, escape_radius, *, rtol, atol, dt_min,
                      dt_max, capture_radius=None, disk=None, vol_disk=None,
                      vol_row=None, scatter_block=None):
    """The kernel's scalar row as Python floats: kernel #7's row
    (``kerr_scalars``) with (rtol, atol) in its (axis_u0, far_r0) slots and
    (dt_max, dt_min) at KERR_RK45_BOUNDS[vol], in place of the volumetric
    row's two spares or appended to the bare row."""
    row = kerr_scalars(metric, dt0, escape_radius, capture_radius,
                       disk=disk, vol_disk=vol_disk, vol_row=vol_row,
                       scatter_block=scatter_block, axis_u0=rtol,
                       far_r0=atol)
    b = KERR_RK45_BOUNDS[vol_disk is not None]
    return row[:b] + [float(dt_max), float(dt_min)] + row[b + 2:]


def default_max_iters(max_steps, max_iters=None):
    """4 max_steps unless given, rounded up to even (the Pallas wrapper's
    rounding to its unroll of 2)."""
    mi = 4 * int(max_steps) if max_iters is None else int(max_iters)
    return -(-mi // 2) * 2


def march_kerr_rk45_plain(flags, scal, r, th, ph, p_r, p_th, E, L, *,
                          max_steps, max_iters):
    """Plain version of kernel #8 on rays of any dtype and device, with the
    scalar row of ``kerr_rk45_scalars`` and ``flags`` = (track_disk, vol,
    blackbody, beaming, scatter) -> (r, theta, phi, p_r, p_theta, sign,
    steps), then the six hit rows with track_disk or (tau, em_r, em_g,
    em_b) with vol, and last iters.  ``max_iters`` is taken as given."""
    track, vol, blackbody, beaming, scatter = flags
    row = torch.tensor(scal, dtype=r.dtype, device=r.device)
    dt0, R, M, r_cap, r_in, r_out = (row[0], row[1], row[2], row[5], row[6],
                                     row[7])
    rtol, atol = row[8], row[9]
    b = KERR_RK45_BOUNDS[vol]
    dt_max, dt_min = row[b], row[b + 1]
    zero = torch.zeros_like(r)
    one = torch.ones_like(r)
    dt = one * dt0
    ct_prev = torch.cos(th)
    hits = [zero] * 6
    tau = zero
    em = [zero] * 3
    b_ph = L / E
    sign = torch.zeros(r.shape, dtype=torch.int32, device=r.device)
    steps = torch.zeros_like(sign)
    iters = torch.zeros_like(sign)
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        alive = sign == 0
        iters = iters + alive.to(torch.int32)
        ks = []
        for i in range(7):
            ri, ti, pri, pti = r, th, p_r, p_th
            for j, aa in enumerate(DP_A[i]):
                ri = ri + dt * aa * ks[j][0]
                ti = ti + dt * aa * ks[j][1]
                pri = pri + dt * aa * ks[j][3]
                pti = pti + dt * aa * ks[j][4]
            ks.append(kerr_rhs_plain(row, E, L, ri, ti, pri, pti))
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

        # torch.maximum propagates NaN, as the kernel's max_nan
        err = torch.maximum(
            torch.maximum(ec(e[0], r, r1), ec(e[1], th, th1)),
            torch.maximum(ec(e[2], p_r, pr1), ec(e[3], p_th, pth1)))
        accept = alive & (err <= 1.0)
        # boundary stepping: reject a gross overshoot of R and retry
        esc = accept & (r1 > R)
        den = r1 - r
        den = torch.where(torch.abs(den) < 1e-30, one, den)
        frac = (R - r) / den
        over = esc & (frac < 0.9) & (r1 > R * (1.0 + 1e-3))
        accept = accept & ~over
        esc = esc & ~over
        if track:
            ct = torch.cos(th1)
            crossed = accept & (ct_prev * ct < 0.0)
            cden = torch.abs(ct_prev) + torch.abs(ct)
            cfrac = torch.abs(ct_prev) / torch.clamp(cden, min=1e-30)
            r_hit = r + cfrac * (r1 - r)
            ph_hit = ph + cfrac * (ph1 - ph)
            side = torch.where(ct_prev > 0.0, one, -one)
            in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
            new1 = in_disk & (hits[0] == 0.0)
            new2 = in_disk & (hits[0] != 0.0) & (hits[3] == 0.0)
            for k, (new, val) in enumerate(((new1, r_hit), (new1, ph_hit),
                                            (new1, side), (new2, r_hit),
                                            (new2, ph_hit), (new2, side))):
                hits[k] = torch.where(new, val, hits[k])
            ct_prev = torch.where(accept, ct, ct_prev)
        r, th, ph, p_r, p_th = (torch.where(accept, y1, y0) for y0, y1 in zip(
            (r, th, ph, p_r, p_th), (r1, th1, ph1, pr1, pth1)))
        m_chk = (torch.abs(r) + torch.abs(th) + torch.abs(ph)
                 + torch.abs(p_r) + torch.abs(p_th))
        ok = m_chk <= 1e8
        if vol:
            dtau, dem = kerr_vol_emission_plain(
                row, (blackbody, beaming, scatter), r, th, b_ph, tau)
            gate = accept & ok
            em = [x + torch.where(gate, dt * d, zero) for x, d in zip(em, dem)]
            tau = tau + torch.where(gate, dt * dtau, zero)
        new_sign = torch.where(ok, esc.to(torch.int32)
                               + 2 * (r < r_cap).to(torch.int32), 3)
        sign = torch.where(accept, new_sign, sign).to(torch.int32)
        if vol:
            # the tau_max freeze (OPAQUE_SIGN == CAPTURED == 2)
            sign = torch.where((sign == 0) & (tau > row[VOL_BLOCK_KERR + 3]),
                               2, sign).to(torch.int32)
        # a reject at dt_min can never pass (over-rejects included)
        stalled = alive & ~accept & (dt <= dt_min * 1.01)
        sign = torch.where(stalled, 3, sign).to(torch.int32)
        steps = steps + accept.to(torch.int32)
        # controller; a NaN err gives a NaN factor, which becomes 0.2
        err_s = torch.clamp(err, min=1e-10)
        factor = torch.clamp(0.9 * torch.exp(-0.2 * torch.log(err_s)), 0.2,
                             5.0)
        factor = torch.where(factor > 0.0, factor, 0.2)
        dt_b = torch.clamp(dt * frac * 1.05, dt_min, dt_max)
        live = alive & (sign == 0)
        dt = torch.where(live, torch.clamp(dt * factor, dt_min, dt_max), dt)
        dt = torch.where(over & (sign == 0), dt_b, dt)
        if vol:
            # the anticipatory clamp on the distance to the gas slab
            r_cyl = r * torch.abs(torch.sin(th))
            gap_r = r_cyl - (r_out + 2.0 * M)
            h_rel5 = 5.0 * torch.sqrt(row[VOL_BLOCK_KERR])
            gap_z = r * torch.abs(torch.cos(th)) - h_rel5 * r_cyl
            dt_gas = torch.maximum(dt0, 0.5 * torch.maximum(gap_r, gap_z))
            dt = torch.where(sign == 0, torch.minimum(dt, dt_gas), dt)
        elif track:
            near = r < (r_out + 2.0 * M)
            dt = torch.where(near & (sign == 0), torch.minimum(dt, dt0), dt)
        sign = torch.where((sign == 0) & (steps >= max_steps), CAPPED,
                           sign).to(torch.int32)
    sign = torch.where(sign == CAPPED, 0, sign).to(torch.int32)
    extra = hits if track else (tau, *em) if vol else ()
    return (r, th, ph, p_r, p_th, sign, steps, *extra, iters)


def march_kerr_rk45_cuda(metric, x0, p0, *, dt0=0.1, max_steps=4_000,
                         max_iters=None, escape_radius, rtol=1e-4,
                         atol=1e-7, dt_min=1e-5, dt_max=None,
                         capture_radius=None, disk=None, vol_disk=None,
                         vol_row=None, scatter_block=None,
                         return_iters=False):
    """Adaptive DP5(4) march of the BL bundle (x0, p0) with the contract
    and defaults of ``march_kerr_rk45_pallas``: (x, p, sign, steps), plus
    ((h1, h1_phi, h1_side), (h2, h2_phi, h2_side)) with ``disk`` or (tau,
    (em_r, em_g, em_b)) with ``vol_disk``, plus iters with
    ``return_iters``.  ``dt_max`` defaults to escape_radius / 8;
    ``vol_row`` is the gas's emission row (``ops/kerr_cuda.py:
    kerr_scalars``).  The CUDA kernel for CUDA tensors (float32), the
    plain version for CPU tensors."""
    dev = common_device(metric, x0, p0)
    if dt_max is None:
        dt_max = float(escape_radius) / 8.0
    scal = kerr_rk45_scalars(metric, dt0, escape_radius, rtol=rtol,
                             atol=atol, dt_min=dt_min, dt_max=dt_max,
                             capture_radius=capture_radius, disk=disk,
                             vol_disk=vol_disk, vol_row=vol_row,
                             scatter_block=scatter_block)
    mi = default_max_iters(max_steps, max_iters)
    vol = vol_disk is not None
    flags = (disk is not None, vol,
             vol and vol_disk.color_mode == "blackbody",
             vol and bool(vol_disk.redshift or vol_disk.doppler),
             scatter_block is not None)
    E = -p0[:, 0]
    L = p0[:, 3]
    ins = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2], E, L)
    if dev.type == "cpu":
        outs = march_kerr_rk45_plain(flags, scal, *ins, max_steps=max_steps,
                                     max_iters=mi)
    elif dev.type == "cuda":
        outs = launch(flags, scal, *(_flat_f32(t) for t in ins),
                      max_steps=max_steps, max_iters=mi)
    else:
        raise ValueError(f"march_kerr_rk45_cuda: unsupported device {dev}")
    r, th, ph, p_r, p_th, sign, steps = outs[:7]
    x = torch.stack([torch.zeros_like(r), r, th, ph], dim=-1)
    p = torch.stack([-E, p_r, p_th, L], dim=-1)
    ret = [x, p, sign, steps]
    if vol:
        ret.append((outs[7], tuple(outs[8:11])))
    elif disk is not None:
        ret.append((tuple(outs[7:10]), tuple(outs[10:13])))
    if return_iters:
        ret.append(outs[-1])
    return tuple(ret)


def launch(flags, scal, r, th, ph, p_r, p_th, E, L, *, max_steps,
           max_iters):
    """One kernel launch on flat contiguous float32 CUDA tensors of one
    device, with the host row of ``kerr_rk45_scalars`` and ``flags`` =
    (track_disk, vol, blackbody, beaming, scatter) -> the outputs of
    ``march_kerr_rk45_plain``."""
    global launches
    track, vol = flags[0], flags[1]
    n = r.numel()
    dev = r.device
    nf = 5 + (6 if track else 4 if vol else 0)
    fout = torch.empty((nf, n), dtype=torch.float32, device=dev)
    iout = torch.empty((3, n), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_march_kerr_rk45(
        int(bool(track)), int(bool(vol)), int(bool(flags[4])),
        int(bool(flags[2])), int(bool(flags[3])), row, len(scal),
        r.data_ptr(), th.data_ptr(), ph.data_ptr(), p_r.data_ptr(),
        p_th.data_ptr(), E.data_ptr(), L.data_ptr(), fout.data_ptr(),
        iout.data_ptr(), n, int(max_steps), int(max_iters), dev.index,
        stream)
    _build.check(lib, err, "march_kerr_rk45_kernel")
    launches += 1
    return (*fout[:5], iout[0], iout[1], *fout[5:], iout[2])
