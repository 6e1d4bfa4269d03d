"""Planar Euler march with volumetric disk transfer on the GPU: wrapper of
the CUDA kernel ``csrc/disk_vol.cu`` (replacing
``curvis_tpu/ops/march_pallas.py``'s ``_disk_vol_kernel`` with its
per-step ``_vol_emission``), and its plain PyTorch version.

``march_planar_disk_volumetric_cuda`` has the contract of the JAX package's
``march_planar_disk_volumetric_pallas``: the kernel for CUDA tensors
(float32), the plain version for CPU tensors.  A CUDA tensor never falls
back to the plain version: a failure to build or launch raises.

``march_planar_disk_volumetric_plain`` transcribes the kernel's arithmetic,
which is the TPU kernel's: r = rsqrt(1 / r^2) of the shape function (r = l
for the lapse kinds), and the Planck chromaticity from
ln(e^x - 1) = x + ln(1 - e^-x), where ``render/disk.py``'s XLA twin takes
r(l) and ``blackbody_rgb``'s clipped expm1 form.

The scalar row (``vol_scalars``) is the planar volumetric row of the JAX
package: the six march scalars, r_in, r_out, the eight emission slots of
``vol_param_slots``, and, when scattering is on, the ``SCATTER_BLOCK``
scalars of ``render/starlight.py:starlight_scatter_block``.  It is built
once per call from Python floats.
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.ckpt_adjoint_cuda import _dneg_shape, planar_deriv
from curvis_tpu_torch.ops.disk_cuda import LAPSE_KINDS, _flat_f32, step_sign
from curvis_tpu_torch.ops.march_cuda import (KINDS, march_scalars,
                                             refuse_table)
from curvis_tpu_torch.physics.planar import (_CHECK_EVERY, PlanarResult,
                                             PlanarRays)
from curvis_tpu_torch.utils.device import common_device

# The starlight single-scattering block: [tint_r, tint_g, tint_b], then per
# channel the SCATTER_DEG + 1 monomial coefficients of kappa_s albedo_c
# Ebar_c(t), t = 2 (r_cyl - r_in) / (r_out - r_in) - 1.
SCATTER_DEG = 7
SCATTER_BLOCK = 3 + 3 * (SCATTER_DEG + 1)             # = 27
N_VOL_SCALARS = 16       # march scalars, r_in, r_out, 8 emission slots

# c2 / lambda and -5 ln lambda at 610, 550 and 465 nm
_BB_K = tuple(1.4388e-2 / lam for lam in (610e-9, 550e-9, 465e-9))
_BB_L5 = tuple(-5.0 * math.log(lam) for lam in (610e-9, 550e-9, 465e-9))

launches = 0             # kernel launches since the last reset


# The 8 emission scalars after (r_in, r_out), in the order of the row (and
# of curvis::VolSlots in csrc/vol_common.cuh).
VOL_SLOT_NAMES = ("h2", "inv_norm", "kappa", "tau_max", "t_peak", "emis_q",
                  "spin_sign", "t_scale")


def vol_param_slots(disk):
    """The 8 emission scalars after (r_in, r_out), in the order of
    ``VOL_SLOT_NAMES``: [h^2, inv_norm, kappa, tau_max, t_peak,
    emissivity_index, spin_sign, t_scale], as Python floats (``disk``: a
    DiskParams)."""
    h2 = disk.h_rel * disk.h_rel
    inv_norm = 1.0 / (math.sqrt(2.0 * math.pi) * disk.h_rel)
    rp = (49.0 / 36.0) * disk.r_inner       # Shakura-Sunyaev peak radius
    f_peak = rp ** -0.75 * (1.0 / 7.0) ** 0.25
    return [float(v) for v in (h2, inv_norm, disk.kappa, disk.tau_max,
                               disk.t_peak, disk.emissivity_index,
                               disk.spin_sign, disk.t_peak / f_peak)]


def vol_scalars(metric: Metric, dt, escape_radius, disk,
                scatter_block=None):
    """(kind, the kernel's scalar row as Python floats): one host read of
    the metric parameters and, with scattering, one of the block."""
    refuse_table(metric, "volumetric march (kernel #6)")
    kind, head = march_scalars(metric, dt, escape_radius)
    row = head + [float(disk.r_inner), float(disk.r_outer)]
    return kind, row + vol_param_slots(disk) + scatter_row(scatter_block)


def scatter_row(scatter_block):
    """The scatter block as Python floats (one host read), [] for None."""
    if scatter_block is None:
        return []
    block = torch.as_tensor(scatter_block).detach().reshape(-1)
    if block.numel() != SCATTER_BLOCK:
        raise ValueError(f"scatter_block has {block.numel()} values, "
                         f"not {SCATTER_BLOCK}")
    return [float(x) for x in block.cpu().tolist()]


def inv_r2_plain(kind, p, l):
    """1 / r^2 of a capture-free kind, as csrc/planar.cuh:planar_inv_r2."""
    p0, p1, p2 = p
    if kind == "ellis":
        return 1.0 / (p0 * p0 + l * l)
    if kind == "interstellar":
        ir = 1.0 / _dneg_shape(p0, p1, p2, l)[0]
        return ir * ir
    return 1.0 / (l * l)


def _radius(kind, p, l):
    """r of the kernel: l for the lapse kinds, else rsqrt(1 / r^2)."""
    if kind in LAPSE_KINDS:
        return l
    return torch.rsqrt(inv_r2_plain(kind, p, l))


def vol_row_of(p, surf):
    """The scalar row that ``vol_emission_plain`` reads, from traced pieces:
    the metric slots ``p`` = (p0, p1, p2) and ``surf`` = (r_in, r_out, the
    8 slots[, the scatter block]); dt, R and r_cap, which it does not read,
    are zeros."""
    zero = torch.zeros_like(surf[0])
    return torch.cat([torch.stack([zero, zero, *p, zero]), surf])


def vol_emission_plain(kind, flags, row, l, p_l, b, zq, tau, nz):
    """(dtau, (dem_r, dem_g, dem_b)) at the post-step state, as the
    kernel's vol_emission; ``row`` is the scalar row as a tensor and
    ``flags`` (blackbody, redshift, doppler, scatter).  torch.clamp and
    torch.maximum propagate NaN, as the kernel's clip_nan and max_nan."""
    blackbody, redshift, doppler, scatter = flags
    p = (row[2], row[3], row[4])
    r_in, r_out = row[6], row[7]
    h2, inv_norm, kappa, _, _, _, spin_sign, _ = row[8:16]
    r = _radius(kind, p, l)
    zq2 = zq * zq
    s2 = torch.clamp(1.0 - zq2, 1e-12, 1.0)
    r_cyl = r * torch.sqrt(s2)
    dens = torch.exp(-zq2 / (2.0 * h2 * s2)) * (inv_norm / r_cyl)
    w_edge = r_out - r_in
    edge_in = torch.clamp((r_cyl - r_in) / (0.1 * w_edge), 0.0, 1.0)
    edge_out = torch.clamp((r_out - r_cyl) / (0.3 * w_edge), 0.0, 1.0)
    base = dens * edge_in * edge_out
    rr = torch.maximum(r_cyl, r_in)
    g = torch.ones_like(r_cyl)
    if kind in LAPSE_KINDS and (redshift or doppler):
        M = p[0]
        if kind == "rn":
            q2 = p[1]
            A = torch.clamp(1.0 - (2.0 * M - q2 / rr) / rr, 1e-3, 1.0)
            vsq = (M - q2 / rr) / rr
        else:
            A = torch.clamp(1.0 - 2.0 * M / rr, 1e-3, 1.0)
            vsq = M / rr
        sqA = torch.sqrt(A)
        if redshift:
            g = sqA
        if doppler:
            v = torch.clamp(torch.sqrt(vsq) / sqA, 0.0, 0.99)
            gamma = torch.rsqrt(1.0 - v * v)
            u_l = p_l * sqA
            u_psi = b / rr
            inv = torch.rsqrt(u_l * u_l + u_psi * u_psi + 1e-30)
            cos_xi = (u_psi * inv) * nz * spin_sign
            g = g / (gamma * (1.0 - v * cos_xi))
    trans = torch.exp(-tau)
    dtau = kappa * base
    block = row[N_VOL_SCALARS:]
    scat = (scatter_source_plain(block, r_cyl, r_in, r_out, trans * base)
            if scatter else None)
    return dtau, vol_color_plain(row[8:16], r_in, rr, g, trans * base, block,
                                 scat, blackbody)


def scatter_source_plain(block, r_cyl, r_in, r_out, sw):
    """The lensed-sky scattering source of csrc/vol_common.cuh: per channel
    sw times the Horner sum of ``block``'s monomials in the compactified
    radius, clipped at 0."""
    t = torch.clamp(2.0 * (r_cyl - r_in) / (r_out - r_in) - 1.0, -1.0, 1.0)
    scat = []
    for c in range(3):
        c0 = 3 + c * (SCATTER_DEG + 1)
        acc = block[c0 + SCATTER_DEG]
        for k in range(SCATTER_DEG - 1, -1, -1):
            acc = acc * t + block[c0 + k]
        scat.append(sw * torch.clamp(acc, min=0.0))
    return scat


def vol_color_plain(slots, r_in, rr, g, tb, block, scat, blackbody):
    """[dem_r, dem_g, dem_b], the colour tail of csrc/vol_common.cuh:
    ``slots`` the 8 emission scalars, ``tb`` = e^-tau density, ``scat``
    the scattering source or None."""
    _, _, _, _, t_peak, emis_q, _, t_scale = slots
    if blackbody:
        sq = torch.sqrt(r_in / rr)
        ln_r = torch.log(rr)
        f = torch.exp(-0.75 * ln_r
                      + 0.25 * torch.log(torch.clamp(1.0 - sq, min=1e-20)))
        t_obs = g * t_scale * f
        rel_sq = t_obs / t_peak
        rel = rel_sq * rel_sq
        rel = rel * rel
        inv_T = 1.0 / torch.clamp(t_obs, min=1.0)
        logs = []
        for k_c, l5 in zip(_BB_K, _BB_L5):
            x = k_c * inv_T
            logs.append(l5 - (x + torch.log(
                torch.clamp(1.0 - torch.exp(-x), min=1e-30))))
        m = torch.maximum(logs[0], torch.maximum(logs[1], logs[2]))
        w = tb * rel
        dem = [w * torch.exp(lg - m) for lg in logs]
        if scat is not None:
            dem = [d + s for d, s in zip(dem, scat)]
        return dem
    emis = torch.exp(emis_q * torch.log(r_in / rr))
    cg = torch.clamp(g, 0.0, 4.0)
    w = tb * emis * (cg * cg * cg)
    if scat is not None:
        return [w * block[c] + scat[c] for c in range(3)]
    return [w, w, w]


def march_planar_disk_volumetric_plain(kind, flags, scal, l, psi, p_l, b, c1,
                                       c2, nz, *, max_steps):
    """Plain version of kernel #6 on rays of any dtype and device, with the
    scalar row of ``vol_scalars`` and ``flags`` = (blackbody, redshift,
    doppler, scatter) -> (l, psi, p_l, sign, steps, tau, em_r, em_g,
    em_b)."""
    row = torch.tensor(scal, dtype=l.dtype, device=l.device)
    dt, R, r_cap, tau_max = row[0], row[1], row[5], row[11]
    p = (row[2], row[3], row[4])
    u, v = torch.cos(psi), torch.sin(psi)
    tau = torch.zeros_like(l)
    em = [torch.zeros_like(l) for _ in range(3)]
    sign = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        alive = sign == 0
        dl, dpsi, dpl = planar_deriv(kind, p, l, p_l, b)
        l1 = l + dt * dl
        psi1 = psi + dt * dpsi
        pl1 = p_l + dt * dpl
        du = dt * dpsi
        u1 = u - v * du
        v1 = v + u * du
        zq = c1 * u1 + c2 * v1
        dtau, dem = vol_emission_plain(kind, flags, row, l1, pl1, b, zq, tau,
                                       nz)
        em = [torch.where(alive, e + dt * d, e) for e, d in zip(em, dem)]
        tau1 = torch.where(alive, tau + dt * dtau, tau)
        l = torch.where(alive, l1, l)
        psi = torch.where(alive, psi1, psi)
        p_l = torch.where(alive, pl1, p_l)
        u = torch.where(alive, u1, u)
        v = torch.where(alive, v1, v)
        tau = tau1
        sign = step_sign(kind, alive, l, R, r_cap, sign)
        # the tau_max freeze after escape / capture (OPAQUE_SIGN = 2)
        sign = torch.where(alive & (sign == 0) & (tau > tau_max), 2,
                           sign).to(torch.int32)
        steps = steps + alive.to(torch.int32)
    return (l, psi, p_l, sign, steps, tau, *em)


def march_planar_disk_volumetric_cuda(metric: Metric, rays: PlanarRays, c1,
                                      c2, nz, *, dt, max_steps,
                                      escape_radius, disk,
                                      scatter_block=None):
    """Euler march of ``rays`` through the volumetric disk ``disk`` (a
    DiskParams) with the contract of ``render/disk.py:
    march_planar_disk_volumetric``: (PlanarResult, tau, (em_r, em_g,
    em_b)).  ``scatter_block``: the (SCATTER_BLOCK,) starlight-scattering
    coefficients that switch the in-gas source on.  The CUDA kernel for
    CUDA tensors (f32 only), the plain version for CPU tensors."""
    dev = common_device(metric, rays.l, rays.psi, rays.p_l, rays.b, c1, c2,
                        nz)
    kind, scal = vol_scalars(metric, dt, escape_radius, disk, scatter_block)
    flags = (disk.color_mode == "blackbody", bool(disk.redshift),
             bool(disk.doppler), scatter_block is not None)
    shape = rays.l.shape
    ins = [torch.broadcast_to(t, shape)
           for t in (rays.l, rays.psi, rays.p_l, rays.b, c1, c2, nz)]
    if dev.type == "cpu":
        outs = march_planar_disk_volumetric_plain(kind, flags, scal, *ins,
                                                  max_steps=max_steps)
    elif dev.type == "cuda":
        outs = launch(kind, flags, scal, *(_flat_f32(t) for t in ins),
                      max_steps=max_steps)
        outs = [o.reshape(shape) for o in outs]
    else:
        raise ValueError("march_planar_disk_volumetric_cuda: unsupported "
                         f"device {dev}")
    return PlanarResult(*outs[:5]), outs[5], tuple(outs[6:9])


def launch(kind, flags, scal, l, psi, p_l, b, c1, c2, nz, *, max_steps):
    """One kernel launch on flat contiguous float32 CUDA tensors of one
    device, with the host scalars of ``vol_scalars`` and ``flags`` =
    (blackbody, redshift, doppler, scatter) ->
    (l, psi, p_l, sign, steps, tau, em_r, em_g, em_b)."""
    global launches
    n = l.numel()
    dev = l.device
    fout = torch.empty((7, n), dtype=torch.float32, device=dev)
    iout = torch.empty((2, n), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_march_disk_vol(
        KINDS[kind], *(int(bool(f)) for f in flags), row, len(scal),
        l.data_ptr(), psi.data_ptr(), p_l.data_ptr(), b.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), nz.data_ptr(), fout.data_ptr(),
        iout.data_ptr(), n, int(max_steps), dev.index, stream)
    _build.check(lib, err, "march_disk_vol_kernel")
    launches += 1
    return (fout[0], fout[1], fout[2], iout[0], iout[1], *fout[3:])
