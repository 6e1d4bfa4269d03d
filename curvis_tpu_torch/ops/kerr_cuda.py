"""Boyer-Lindquist RK4 march of Kerr / Kerr-Newman photons on the GPU:
wrapper of the CUDA kernel ``csrc/kerr.cu`` (replacing
``curvis_tpu/ops/march_pallas.py``'s ``_kerr_kernel`` with ``_kerr_rhs``
and ``_kerr_vol_emission``), and its plain PyTorch version.

``march_kerr_cuda`` has the contract of the JAX package's
``march_kerr_pallas`` (without its TPU tiling): (N, 4) BL positions and
covariant momenta in, (x, p, sign, steps[, extra]) out, with x's t
component 0 and p rebuilt as (-E, p_r, p_theta, L).  ``disk=(r_in,
r_out)`` records the first two equatorial crossings in the band as
(radius, BL azimuth, approach side) triples; ``vol_disk`` (a volumetric
DiskParams) accumulates the transfer through the gas disk instead, with
``scatter_block`` its starlight source.  The kernel runs for CUDA tensors
(float32), the plain version for CPU tensors; a CUDA tensor never falls
back: a failure to build or launch raises.

``march_kerr_plain`` transcribes the kernel's arithmetic, which is the TPU
kernel's: the hand-inlined RHS (not the autodiff RHS of
``physics/hamiltonian.py``, which the render routes run on the CPU), a
lock-step loop whose ended rays are masked by select (never by
multiplying, so no 0 * inf reaches a frozen state), hits written by
select, emission at the post-step state with the pre-step tau.

The scalar row (``kerr_scalars``) is the JAX package's Kerr row, built once
per call from Python floats: [dt, R, M, a, q^2, r_cap, r_in, r_out,
axis_u0, far_r0], then for the volumetric march the 8 emission slots of
``ops/disk_vol_cuda.py:vol_param_slots`` at VOL_BLOCK_KERR and 2 spares,
then the scatter block at KERR_SCATTER_OFF.
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.disk_vol_cuda import (SCATTER_BLOCK,
                                                scatter_source_plain,
                                                vol_color_plain,
                                                vol_param_slots)
from curvis_tpu_torch.physics.planar import _CHECK_EVERY
from curvis_tpu_torch.utils.device import common_device

VOL_BLOCK_KERR = 10      # the emission slots follow the 10 march scalars
KERR_SCATTER_OFF = 20    # the scatter block follows the slots and 2 spares

launches = 0             # kernel launches since the last reset


def kerr_scalars(metric, dt, escape_radius, capture_radius=None, *,
                 disk=None, vol_disk=None, vol_row=None, scatter_block=None,
                 axis_u0=0.01, far_r0=None):
    """The kernel's scalar row as Python floats (one host read of the
    metric's parameters, and one of the scatter block).  ``vol_row`` (the
    traced (10,) row of ``integrate/kerr_surface_adjoint.py:
    build_vol_row``: r_in, r_out and the 8 emission slots) replaces the
    values of ``vol_disk``, so that a march and its replay read one row."""
    if disk is not None and vol_disk is not None:
        raise ValueError("pass disk=(r_in, r_out) OR vol_disk, not both")
    if scatter_block is not None and vol_disk is None:
        raise ValueError("scatter_block needs vol_disk")
    if vol_row is not None and vol_disk is None:
        raise ValueError("vol_row needs vol_disk")
    if capture_radius is None:
        capture_radius = metric.capture_radius
    slots = None
    if vol_row is not None:
        vals = [float(v) for v in
                torch.as_tensor(vol_row).detach().reshape(-1).cpu().tolist()]
        if len(vals) != 10:
            raise ValueError(f"vol_row has {len(vals)} values, not 10")
        r_in, r_out, slots = vals[0], vals[1], vals[2:]
    elif vol_disk is not None:
        r_in, r_out = vol_disk.r_inner, vol_disk.r_outer
    else:
        r_in, r_out = disk if disk is not None else (0.0, 0.0)
    row = [dt, escape_radius, metric.m, metric.a, metric.q2, capture_radius,
           r_in, r_out, axis_u0, 1e30 if far_r0 is None else far_r0]
    row = [float(v.detach()) if torch.is_tensor(v) else float(v)
           for v in row]
    assert len(row) == VOL_BLOCK_KERR
    if vol_disk is not None:
        row += (vol_param_slots(vol_disk) if slots is None else slots) \
            + [0.0, 0.0]
        if scatter_block is not None:
            assert len(row) == KERR_SCATTER_OFF
            block = torch.as_tensor(scatter_block).detach().reshape(-1)
            if block.numel() != SCATTER_BLOCK:
                raise ValueError(f"scatter_block has {block.numel()} "
                                 f"values, not {SCATTER_BLOCK}")
            row += [float(x) for x in block.cpu().tolist()]
    return row


def kerr_rhs_plain(row, E, L, r, th, p_r, p_th):
    """d(r, theta, phi, p_r, p_theta) of the kernel's kerr_rhs."""
    return kerr_rhs_theta(row[2], row[3], row[4], E, L, r, th, p_r, p_th)


def kerr_rhs_theta(M, a, q2, E, L, r, th, p_r, p_th):
    """The kernel's kerr_rhs with the metric slots as arguments: the JAX
    package's ``_kerr_rhs`` form for form, which the Kerr adjoints
    (``integrate/kerr_adjoint.py``) differentiate."""
    s = torch.sin(th)
    c = torch.cos(th)
    u = torch.clamp(s * s, min=1e-12)
    invu = 1.0 / u
    ac = a * c
    sigma = r * r + ac * ac
    inv_sigma = 1.0 / sigma
    delta = r * (r - 2.0 * M) + a * a + q2
    inv_delta = 1.0 / delta
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


def kerr_vol_emission_plain(row, flags, r, th, b_ph, tau):
    """(dtau, [dem_r, dem_g, dem_b]) of the kernel's kerr_vol_emission at
    a BL state; ``flags`` (blackbody, beaming, scatter)."""
    blackbody, beaming, scatter = flags
    M, a, q2, r_in, r_out = row[2], row[3], row[4], row[6], row[7]
    V = VOL_BLOCK_KERR
    slots = row[V:V + 8]
    h2, inv_norm, kappa, _, _, _, s_spin, _ = slots
    ct = torch.cos(th)
    zq2 = ct * ct
    s2 = torch.clamp(1.0 - zq2, 1e-12, 1.0)
    r_cyl = r * torch.sqrt(s2)
    dens = torch.exp(-zq2 / (2.0 * h2 * s2)) * (inv_norm / r_cyl)
    w_edge = r_out - r_in
    edge_in = torch.clamp((r_cyl - r_in) / (0.1 * w_edge), 0.0, 1.0)
    edge_out = torch.clamp((r_out - r_cyl) / (0.3 * w_edge), 0.0, 1.0)
    base = dens * edge_in * edge_out
    rr = torch.maximum(r_cyl, r_in)
    g = torch.ones_like(rr)
    if beaming:
        sq = torch.sqrt(torch.clamp(M * rr - q2, min=1e-12))
        rr2 = rr * rr
        omega = s_spin * sq / (rr2 + s_spin * a * sq)
        under = torch.clamp(1.0 - (3.0 * M - 2.0 * q2 / rr) / rr
                            + 2.0 * s_spin * a * sq / rr2, min=1e-3)
        g = torch.sqrt(under) / torch.clamp(1.0 - omega * b_ph, 0.2, 5.0)
    trans = torch.exp(-tau)
    dtau = kappa * base
    block = row[KERR_SCATTER_OFF:]
    scat = (scatter_source_plain(block, r_cyl, r_in, r_out, trans * base)
            if scatter else None)
    return dtau, vol_color_plain(slots, r_in, rr, g, trans * base, block,
                                 scat, blackbody)


def march_kerr_plain(flags, scal, r, th, ph, p_r, p_th, E, L, *,
                     max_steps):
    """Plain version of kernel #7 on rays of any dtype and device, with the
    scalar row of ``kerr_scalars`` and ``flags`` = (track_disk, vol,
    blackbody, beaming, scatter) -> (r, theta, phi, p_r, p_theta, sign,
    steps), then the six hit rows (h1, h1_phi, h1_side, h2, h2_phi,
    h2_side) with track_disk or (tau, em_r, em_g, em_b) with vol."""
    track, vol, blackbody, beaming, scatter = flags
    row = torch.tensor(scal, dtype=r.dtype, device=r.device)
    dt, R, r_cap, r_in, r_out = row[0], row[1], row[5], row[6], row[7]
    ax_u0, far_r0 = row[8], row[9]
    zero = torch.zeros_like(r)
    one = torch.ones_like(r)
    ct_prev = torch.cos(th)
    hits = [zero] * 6
    tau = zero
    em = [zero] * 3
    b_ph = L / E
    sign = torch.zeros(r.shape, dtype=torch.int32, device=r.device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        live = sign == 0
        alive = live.to(r.dtype)
        s_ax = torch.sin(th)
        scale = torch.clamp((s_ax * s_ax + 1e-12)
                            / torch.clamp(ax_u0, min=1e-12), 1.0 / 16.0, 1.0)
        fscale = torch.clamp(r / torch.clamp(far_r0, min=1e-12), 1.0, 8.0)
        dte = dt * alive * scale * fscale
        hd = 0.5 * dte
        k1 = kerr_rhs_plain(row, E, L, r, th, p_r, p_th)
        k2 = kerr_rhs_plain(row, E, L, r + hd * k1[0], th + hd * k1[1],
                            p_r + hd * k1[3], p_th + hd * k1[4])
        k3 = kerr_rhs_plain(row, E, L, r + hd * k2[0], th + hd * k2[1],
                            p_r + hd * k2[3], p_th + hd * k2[4])
        k4 = kerr_rhs_plain(row, E, L, r + dte * k3[0], th + dte * k3[1],
                            p_r + dte * k3[3], p_th + dte * k3[4])
        w = dte * (1.0 / 6.0)
        y0 = (r, th, ph, p_r, p_th)
        y1 = [y + w * (a + 2.0 * (b + c) + d)
              for y, a, b, c, d in zip(y0, k1, k2, k3, k4)]
        if track:
            ct = torch.cos(y1[1])
            crossed = live & (ct_prev * ct < 0.0)
            den = torch.abs(ct_prev) + torch.abs(ct)
            frac = torch.abs(ct_prev) / torch.clamp(den, min=1e-30)
            r_hit = r + frac * (y1[0] - r)
            ph_hit = ph + frac * (y1[2] - ph)
            side = torch.where(ct_prev > 0.0, one, -one)
            in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
            new1 = in_disk & (hits[0] == 0.0)
            new2 = in_disk & (hits[0] != 0.0) & (hits[3] == 0.0)
            for k, (new, val) in enumerate(((new1, r_hit), (new1, ph_hit),
                                            (new1, side), (new2, r_hit),
                                            (new2, ph_hit), (new2, side))):
                hits[k] = torch.where(new, val, hits[k])
            ct_prev = torch.where(live, ct, ct_prev)
        r, th, ph, p_r, p_th = (torch.where(live, b, a)
                                for a, b in zip(y0, y1))
        m_chk = (torch.abs(r) + torch.abs(th) + torch.abs(ph)
                 + torch.abs(p_r) + torch.abs(p_th))
        ok = m_chk <= 1e8
        if vol:
            dtau, dem = kerr_vol_emission_plain(
                row, (blackbody, beaming, scatter), r, th, b_ph, tau)
            gate = live & ok
            em = [torch.where(gate, e + dte * d, e) for e, d in zip(em, dem)]
            tau = torch.where(gate, tau + dte * dtau, tau)
        new_sign = torch.where(ok, (r > R).to(torch.int32)
                               + 2 * (r < r_cap).to(torch.int32), 3)
        sign = torch.where(live, new_sign, sign).to(torch.int32)
        if vol:
            # the tau_max freeze (OPAQUE_SIGN == CAPTURED == 2)
            sign = torch.where((sign == 0) & (tau > row[VOL_BLOCK_KERR + 3]),
                               2, sign).to(torch.int32)
        steps = steps + live.to(torch.int32)
    extra = hits if track else (tau, *em) if vol else ()
    return (r, th, ph, p_r, p_th, sign, steps, *extra)


def _flat_f32(t):
    if t.dtype != torch.float32:
        raise TypeError(f"the Kerr kernel takes float32 rays, got {t.dtype}")
    return t.reshape(-1).contiguous()


def march_kerr_cuda(metric, x0, p0, *, dt, max_steps, escape_radius,
                    capture_radius=None, disk=None, vol_disk=None,
                    vol_row=None, scatter_block=None, axis_u0=0.01,
                    far_r0=None):
    """RK4 march of the BL bundle (x0, p0) with the contract of
    ``march_kerr_pallas``: (x, p, sign, steps), plus ((h1, h1_phi,
    h1_side), (h2, h2_phi, h2_side)) with ``disk`` or (tau, (em_r, em_g,
    em_b)) with ``vol_disk`` (its emission row ``vol_row`` when given, see
    ``kerr_scalars``).  The CUDA kernel for CUDA tensors (float32), the
    plain version for CPU tensors."""
    dev = common_device(metric, x0, p0)
    scal = kerr_scalars(metric, dt, escape_radius, capture_radius,
                        disk=disk, vol_disk=vol_disk, vol_row=vol_row,
                        scatter_block=scatter_block, axis_u0=axis_u0,
                        far_r0=far_r0)
    vol = vol_disk is not None
    flags = (disk is not None, vol,
             vol and vol_disk.color_mode == "blackbody",
             vol and bool(vol_disk.redshift or vol_disk.doppler),
             scatter_block is not None)
    E = -p0[:, 0]
    L = p0[:, 3]
    ins = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2], E, L)
    if dev.type == "cpu":
        outs = march_kerr_plain(flags, scal, *ins, max_steps=max_steps)
    elif dev.type == "cuda":
        outs = launch(flags, scal, *(_flat_f32(t) for t in ins),
                      max_steps=max_steps)
    else:
        raise ValueError(f"march_kerr_cuda: unsupported device {dev}")
    r, th, ph, p_r, p_th, sign, steps = outs[:7]
    x = torch.stack([torch.zeros_like(r), r, th, ph], dim=-1)
    p = torch.stack([-E, p_r, p_th, L], dim=-1)
    if vol:
        return x, p, sign, steps, (outs[7], tuple(outs[8:11]))
    if disk is not None:
        return x, p, sign, steps, (tuple(outs[7:10]), tuple(outs[10:13]))
    return x, p, sign, steps


def launch(flags, scal, r, th, ph, p_r, p_th, E, L, *, max_steps):
    """One kernel launch on flat contiguous float32 CUDA tensors of one
    device, with the host row of ``kerr_scalars`` and ``flags`` =
    (track_disk, vol, blackbody, beaming, scatter) -> the outputs of
    ``march_kerr_plain``."""
    global launches
    track, vol = flags[0], flags[1]
    n = r.numel()
    dev = r.device
    nf = 5 + (6 if track else 4 if vol else 0)
    fout = torch.empty((nf, n), dtype=torch.float32, device=dev)
    iout = torch.empty((2, n), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_march_kerr(
        int(bool(track)), int(bool(vol)), int(bool(flags[4])),
        int(bool(flags[2])), int(bool(flags[3])), row, len(scal),
        r.data_ptr(), th.data_ptr(), ph.data_ptr(), p_r.data_ptr(),
        p_th.data_ptr(), E.data_ptr(), L.data_ptr(), fout.data_ptr(),
        iout.data_ptr(), n, int(max_steps), dev.index, stream)
    _build.check(lib, err, "march_kerr_kernel")
    launches += 1
    return (*fout[:5], iout[0], iout[1], *fout[5:])
