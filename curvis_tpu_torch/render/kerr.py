"""Kerr / Kerr-Newman black-hole rendering: spinning shadows and
frame-dragged disks (PyTorch).

Counterpart of ``curvis_tpu/render/kerr.py`` for its fixed-step RK4 and
adaptive DP5(4) routes.
Per-pixel photons spawn from the static tetrad at the camera
(``physics/hamiltonian.py:spawn_photon``), march the full Boyer-Lindquist
system to escape or capture and shade from the sky, with an optional
equatorial disk: thin (the first two crossings in the band, shaded with
the circular-orbit g-factor
    g = sqrt(1 - 3M/r + 2Q^2/r^2 + 2 s a sqrt(M r - Q^2) / r^2)
        / (1 - Omega_s b),    Omega_s = s sqrt(M r - Q^2) / (r^2 + s a ...),
b = L / E per ray) or volumetric (transfer through the flared gas disk).

Routes, by the stepper and the device of the inputs:

- ``stepper='rk4'`` (the default) on CUDA tensors (float32) marches
  through the hand-written RK4 kernel ``ops/kerr_cuda.py`` (kernel #7) in
  every route, as the JAX package's ``backend='pallas'`` does; on CPU
  tensors through the ports of the JAX package's XLA marches:
  ``physics/hamiltonian.py:march_hamiltonian`` and ``march_kerr_disk`` /
  ``march_kerr_volumetric`` below, whose RHS is the autodiff one;
- ``stepper='rk45'`` (error control by ``rtol``, atol = rtol 1e-3, ``dt``
  the initial step, ``max_steps`` accepted steps, no far-field or axis
  scaling) marches through the hand-written DP5(4) kernel
  ``ops/kerr_rk45_cuda.py`` (kernel #8) in every route on CUDA tensors.
  On CPU tensors it splits as the JAX package does off the TPU: the bare
  march runs the autodiff twin ``integrate/rk45.py:march_kerr_rk45``, the
  disk and volumetric marches the kernel's plain version (the JAX package
  runs the Pallas kernel in interpret mode there; it has no twin for
  them).

The differentiable backends give exact discrete gradients with respect
to the metric's parameters (m, a, q), the camera pose and so ``x0`` and
``p0`` and, with a disk, the tensors of ``disk_theta`` (the knobs of
``render/disk.py:DIFF_DISK_KEYS``), with either stepper:

- ``backend='adjoint'``: the bare march through ``integrate/
  kerr_adjoint.py:march_kerr_adjoint`` (RK4) or ``integrate/
  rk45_adjoint.py:march_kerr_rk45_adjoint`` (DP5(4)), a thin or
  volumetric disk through ``integrate/kerr_surface_adjoint.py``
  (``march_kerr_disk_adjoint``, ``march_kerr_vol_adjoint`` and their
  ``rk45`` twins): kernel #7 or #8 forward and the checkpoint kernels #9 /
  #10's Kerr families backward on CUDA tensors, the twin pairs on CPU
  tensors;
- ``backend='scan'``: RK4 bare through ``physics/hamiltonian.py:
  march_hamiltonian_scan`` (the autodiff RHS under a checkpointed scan),
  everything else through the twin pairs (``backend='twin'`` of the
  adjoint marches), plain PyTorch on any device, as the JAX package's
  scans are plain XLA.

Captured and blown-up rays keep the spawn-state substitution of
``_kerr_shade``.  ``disk_theta`` shades every route through
``render/disk.py:disk_view`` and builds the in-gas scatter block from it;
the volumetric RK4 march reads its emission row (``build_vol_row``) on
the differentiable route, on the CPU and, through ``vol_row=``, on the
GPU.  As in the JAX package, ``stepper='rk45'`` with ``backend='auto'``
and a volumetric disk neither marches nor shades with ``disk_theta``
(only its scatter block sees it).
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.camera.camera import Camera, aberrate_directions
from curvis_tpu_torch.env.spherical_image import SphericalImage, filter_lookup
from curvis_tpu_torch.geometry.rotations import frame_matrix
from curvis_tpu_torch.integrate.kerr_adjoint import march_kerr_adjoint
from curvis_tpu_torch.integrate.kerr_surface_adjoint import (
    build_vol_row, march_kerr_disk_adjoint, march_kerr_rk45_disk_adjoint,
    march_kerr_rk45_vol_adjoint, march_kerr_vol_adjoint)
from curvis_tpu_torch.integrate.rk45 import march_kerr_rk45
from curvis_tpu_torch.integrate.rk45_adjoint import march_kerr_rk45_adjoint
from curvis_tpu_torch.ops.disk_vol_cuda import scatter_source_plain
from curvis_tpu_torch.ops.kerr_cuda import march_kerr_cuda
from curvis_tpu_torch.ops.kerr_rk45_cuda import march_kerr_rk45_cuda
from curvis_tpu_torch.physics import hamiltonian as ham
from curvis_tpu_torch.render.disk import (OPAQUE_SIGN, DiskParams,
                                          _emission_rgb, _volumetric_rgb,
                                          _rgb, blackbody_rgb,
                                          disk_temperature, disk_view)
from curvis_tpu_torch.render.fast import (_contrast_topk,
                                          _dirs_for_pixel_coords,
                                          _pixel_dirs_soa, _subpixel_coords,
                                          _texture_uv)
from curvis_tpu_torch.render.starlight import (starlight_lookup,
                                               starlight_scatter_block)
from curvis_tpu_torch.utils.device import common_device


def check_kerr_route(stepper="rk4", backend="auto"):
    """Raise ValueError for the options of the Kerr routes the port does
    not know."""
    if stepper not in ("rk4", "rk45"):
        raise ValueError(f"the Kerr routes march with stepper='rk4' or "
                         f"'rk45', got {stepper!r}")
    if backend not in ("auto", "scan", "adjoint"):
        raise ValueError(f"unknown backend {backend!r}: 'auto' (the march "
                         "by the device of the inputs), 'scan' or "
                         "'adjoint'")


def _far_r0(metric, disk, far_accel):
    """The far-field radius of a render: max(8M, r_out + 2M) with a disk,
    8M without (the threshold clears the disk, so crossings and the gas
    quadrature keep the base step); None when off."""
    if not far_accel:
        return None
    far_r0 = 8.0 * metric.m
    if disk is not None:
        far_r0 = torch.maximum(far_r0, disk.r_outer + 2.0 * metric.m)
    return far_r0


def _bl_step(metric, x, p, dt, axis_u0, far_r0):
    """One masked-free RK4 step of the autodiff flow with the axis and
    far-field dt scales; returns (x1, p1, dte)."""
    dte = dt * ham.axis_dt_scale(x[:, 2], axis_u0) \
        * ham.far_dt_scale(x[:, 1], far_r0)
    x1, p1 = ham.rk4_step_batched(metric, x, p, dte[:, None])
    return x1, p1, dte


def march_kerr_disk(metric, x0, p0, *, dt, max_steps, escape_radius,
                    r_inner, r_outer, axis_u0=0.01, far_r0=None):
    """Masked RK4 march recording the first two equatorial crossings (sign
    changes of cos theta) with BL radius in [r_inner, r_outer] -> (x, p,
    sign, ((h1_r, h1_phi, h1_side), (h2_r, h2_phi, h2_side))), 0 marking
    no hit; the azimuth and the approach side (sign of cos theta just
    before) are the Kerr starlight map's lookup coordinates."""
    dt = torch.as_tensor(dt, dtype=x0.dtype, device=x0.device)
    far_r0 = 1e30 if far_r0 is None else far_r0
    cap = metric.capture_radius
    x, p = x0, p0
    zeros = torch.zeros(x0.shape[:1], dtype=x0.dtype, device=x0.device)
    h1 = h1f = h1d = h2 = h2f = h2d = zeros
    ct_prev = torch.cos(x0[:, 2])
    sign = torch.zeros(x0.shape[:1], dtype=torch.int32, device=x0.device)
    for it in range(max_steps):
        if it % ham._CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        r_prev, ph_prev = x[:, 1], x[:, 3]
        x1, p1, _ = _bl_step(metric, x, p, dt, axis_u0, far_r0)
        am = active[:, None]
        x = torch.where(am, x1, x)
        p = torch.where(am, p1, p)
        ct = torch.cos(x[:, 2])
        crossed = active & (ct_prev * ct < 0.0)
        frac = torch.abs(ct_prev) / torch.clamp(
            torch.abs(ct_prev) + torch.abs(ct), min=1e-30)
        r_hit = r_prev + frac * (x[:, 1] - r_prev)
        ph_hit = ph_prev + frac * (x[:, 3] - ph_prev)
        side = torch.where(ct_prev > 0.0, 1.0, -1.0).to(x0.dtype)
        in_disk = crossed & (r_hit >= r_inner) & (r_hit <= r_outer)
        new2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
        new1 = in_disk & (h1 == 0.0)
        h2 = torch.where(new2, r_hit, h2)
        h2f = torch.where(new2, ph_hit, h2f)
        h2d = torch.where(new2, side, h2d)
        h1 = torch.where(new1, r_hit, h1)
        h1f = torch.where(new1, ph_hit, h1f)
        h1d = torch.where(new1, side, h1d)
        sign = ham.update_sign(sign, active, x, p, escape_radius, cap)
        ct_prev = torch.where(active, ct, ct_prev)
    return x, p, sign, ((h1, h1f, h1d), (h2, h2f, h2d))


def _kerr_circular_g(metric, rr, b_photon, spin_sign):
    """g-factor through a photon of impact parameter b = L/E from gas on a
    prograde (spin_sign 1) or retrograde circular equatorial orbit at rr,
    Kerr-Newman form (Q = 0 for Kerr), s = sqrt(M r - Q^2):
        Omega_s = s_spin s / (r^2 + s_spin a s),
        g = sqrt(1 - 3M/r + 2Q^2/r^2 + 2 s_spin a s / r^2) / (1 - Omega b)."""
    M, a, q2 = metric.m, metric.a, metric.q2
    s = spin_sign
    sq = torch.sqrt(torch.clamp(M * rr - q2, min=1e-12))
    rr2 = rr * rr
    omega = s * sq / (rr2 + s * a * sq)
    under = torch.clamp(1.0 - (3.0 * M - 2.0 * q2 / rr) / rr
                        + 2.0 * s * a * sq / rr2, min=1e-3)
    return torch.sqrt(under) / torch.clamp(1.0 - omega * b_photon, 0.2, 5.0)


def march_kerr_volumetric(metric, x0, p0, *, dt, max_steps, escape_radius,
                          params: DiskParams, axis_u0=0.01, far_r0=None,
                          scatter_block=None):
    """Masked RK4 march with per-step transfer through the flared gas disk
    (zq = cos theta, r_cyl = r sin theta): dtau = kappa rho ds and
    emission e^-tau w(r_cyl, g) rho ds per step, at the post-step state
    with the pre-step tau, only for rays that stay finite; a ray is frozen
    (OPAQUE_SIGN) once tau > tau_max.  Returns (x, p, sign, tau, (em_r,
    em_g, em_b))."""
    dtype = x0.dtype
    dt = torch.as_tensor(dt, dtype=dtype, device=x0.device)
    far_r0 = 1e30 if far_r0 is None else far_r0
    cap = metric.capture_radius
    blackbody = params.color_mode == "blackbody"
    h2 = params.h_rel * params.h_rel
    inv_norm = 1.0 / (math.sqrt(2.0 * math.pi) * params.h_rel)
    w_edge = params.r_outer - params.r_inner
    b_photon = p0[:, 3] / (-p0[:, 0])
    beaming = params.redshift or params.doppler

    def step_emission(r, th, tau):
        zq2 = torch.cos(th) ** 2
        s2 = torch.clamp(1.0 - zq2, 1e-12, 1.0)
        r_cyl = r * torch.sqrt(s2)
        dens = torch.exp(-zq2 / (2.0 * h2 * s2)) * (inv_norm / r_cyl)
        edge_in = torch.clamp((r_cyl - params.r_inner) / (0.1 * w_edge),
                              0.0, 1.0)
        edge_out = torch.clamp((params.r_outer - r_cyl) / (0.3 * w_edge),
                               0.0, 1.0)
        base = dens * edge_in * edge_out
        rr = torch.clamp(r_cyl, min=params.r_inner)
        g = (_kerr_circular_g(metric, rr, b_photon, params.spin_sign)
             if beaming else torch.ones_like(r_cyl))
        trans = torch.exp(-tau)
        dtau = params.kappa * base
        scat = None
        if scatter_block is not None:
            scat = scatter_source_plain(scatter_block, r_cyl, params.r_inner,
                                        params.r_outer, trans * base)
        if blackbody:
            t_obs = g * disk_temperature(rr, params)
            rel = (t_obs / params.t_peak) ** 4
            chroma = blackbody_rgb(t_obs)
            w = trans * base * rel
            out = [w * chroma[..., c] for c in range(3)]
            if scat is not None:
                out = [o + sc for o, sc in zip(out, scat)]
            return dtau, out
        emis = (params.r_inner / rr) ** params.emissivity_index
        w = trans * base * emis * torch.clamp(g, 0.0, 4.0) ** 3
        if scat is not None:
            # coloured scattering: the tint folds in per channel
            return dtau, [w * scatter_block[c] + scat[c] for c in range(3)]
        return dtau, [w, w, w]

    x, p = x0, p0
    zeros = torch.zeros(x0.shape[:1], dtype=dtype, device=x0.device)
    tau = zeros
    em = [zeros] * 3
    sign = torch.zeros(x0.shape[:1], dtype=torch.int32, device=x0.device)
    for it in range(max_steps):
        if it % ham._CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        x1, p1, dte = _bl_step(metric, x, p, dt, axis_u0, far_r0)
        am = active[:, None]
        x = torch.where(am, x1, x)
        p = torch.where(am, p1, p)
        dtau, dem = step_emission(x[:, 1], x[:, 2], tau)
        gate = active & ~ham.blown_up(x, p)
        em = [e + torch.where(gate, dte * d, 0.0) for e, d in zip(em, dem)]
        tau = tau + torch.where(gate, dte * dtau, 0.0)
        sign = ham.update_sign(sign, active, x, p, escape_radius, cap)
        sign = torch.where((sign == 0) & (tau > params.tau_max), OPAQUE_SIGN,
                           sign).to(torch.int32)
    return x, p, sign, tau, tuple(em)


def _kerr_disk_rgb(metric, r_hit, b_photon, params: DiskParams, dtype,
                   starlight=None):
    """Colour and alpha of a thin-disk crossing with the Kerr circular-orbit
    g-factor (the planar shader's colour and alpha assembly)."""
    rr = torch.clamp(r_hit, min=params.r_inner)
    g = (_kerr_circular_g(metric, rr, b_photon, params.spin_sign)
         if (params.doppler or params.redshift) else torch.ones_like(r_hit))
    return _emission_rgb(r_hit, g, params, dtype, starlight=starlight)


def _spawn_from_dirs(metric, pos, dx, dy, dz):
    """BL bundle (x0 (N, 4), p0 (N, 4)) for world-frame look directions at
    the camera position ``pos``: the directions in the asymptotic frame
    [r_hat, theta_hat, phi_hat] at the camera angles, spawned from one
    static tetrad."""
    comps = torch.stack([dx, dy, dz], dim=-1) @ frame_matrix(pos[2], pos[3])
    p0 = ham.spawn_photon(metric, pos, comps)
    return pos.expand(p0.shape[0], 4), p0


def _spawn_kerr_rays(metric, camera: Camera, velocity=None):
    """The pixel rays' BL bundle (x0, p0, delta): ``velocity`` (the
    camera's 3-velocity relative to the local static observer) aberrates
    the pixel directions, delta being the per-ray Doppler factor (None
    without a velocity)."""
    dx, dy, dz = _pixel_dirs_soa(camera, False)
    delta = None
    if velocity is not None:
        dx, dy, dz, delta = aberrate_directions(dx, dy, dz, velocity)
    x0, p0 = _spawn_from_dirs(metric, camera.position, dx, dy, dz)
    return x0, p0, delta


def _asymptotic_dirs(metric, x, p):
    """World escape directions (wx, wy, wz) of a BL bundle: the
    contravariant momentum in the asymptotic frame [r_hat, theta_hat,
    phi_hat] at the exit angles."""
    pup = torch.einsum("nij,nj->ni", metric.inverse_metric(x), p)
    r = x[:, 1]
    st = torch.clamp(torch.sin(x[:, 2]), min=1e-6)
    u = torch.stack([pup[:, 1], pup[:, 2] * r, pup[:, 3] * r * st], dim=-1)
    u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    w = torch.einsum("nij,nj->ni", frame_matrix(x[:, 2], x[:, 3]), u)
    return w[:, 0], w[:, 1], w[:, 2]


def _march(metric, x0, p0, *, disk, scatter_block, stepper, rtol, dt,
           max_steps, escape_radius, far_r0, backend="auto", disk_theta=None):
    """The march of a render route -> (x, p, sign, tau, em, h1, h2, the
    disk_theta to shade with), unused parts None.  Routed as the JAX
    package's ``_kerr_march_and_shade`` (module docstring): RK4 by kernel
    #7 on a GPU and the autodiff twins on the CPU; rk45 by kernel #8 on a
    GPU and, on the CPU, the autodiff twin for the bare march and kernel
    #8's plain version for the disk and volumetric ones; the
    differentiable backends by the adjoint marches ('adjoint': the
    kernels on a GPU, the twin pairs on the CPU; 'scan': the twin pairs,
    the RK4 bare march by the checkpointed autodiff scan)."""
    vol = disk is not None and disk.volumetric
    gpu = x0.device.type != "cpu"
    tau = em = h1 = h2 = None
    diff = backend != "auto"
    mback = "twin" if backend == "scan" else "auto"
    if stepper == "rk45":
        kw = dict(dt0=dt, max_steps=max_steps, escape_radius=escape_radius,
                  rtol=rtol, atol=rtol * 1e-3)
        if diff and vol:
            x, p, sign, _, tau, em = march_kerr_rk45_vol_adjoint(
                metric, x0, p0, disk, disk_theta=disk_theta,
                scatter_block=scatter_block, backend=mback, **kw)
        elif diff and disk is not None:
            x, p, sign, _, (h1, h2) = march_kerr_rk45_disk_adjoint(
                metric, x0, p0, r_inner=disk.r_inner, r_outer=disk.r_outer,
                backend=mback, **kw)
        elif diff:
            x, p, sign, _ = march_kerr_rk45_adjoint(metric, x0, p0,
                                                    backend=mback, **kw)
        elif vol:
            x, p, sign, _, (tau, em) = march_kerr_rk45_cuda(
                metric, x0, p0, vol_disk=disk, scatter_block=scatter_block,
                **kw)
            disk_theta = None      # the JAX package's route ignores it
        elif disk is not None:
            x, p, sign, _, (h1, h2) = march_kerr_rk45_cuda(
                metric, x0, p0, disk=(disk.r_inner, disk.r_outer), **kw)
        elif gpu:
            x, p, sign, _ = march_kerr_rk45_cuda(metric, x0, p0, **kw)
        else:
            x, p, sign, _ = march_kerr_rk45(
                metric, x0, p0, capture_radius=metric.capture_radius, **kw)
        return x, p, sign, tau, em, h1, h2, disk_theta
    kw = dict(dt=dt, max_steps=max_steps, escape_radius=escape_radius,
              far_r0=far_r0)
    if vol:
        if diff or (disk_theta and not gpu):
            x, p, sign, _, tau, em = march_kerr_vol_adjoint(
                metric, x0, p0, disk, disk_theta=disk_theta,
                scatter_block=scatter_block, backend=mback, **kw)
        elif gpu:
            vol_row = (build_vol_row(disk, disk_theta, dtype=x0.dtype,
                                     device=x0.device) if disk_theta
                       else None)
            x, p, sign, _, (tau, em) = march_kerr_cuda(
                metric, x0, p0, vol_disk=disk, vol_row=vol_row,
                scatter_block=scatter_block, **kw)
        else:
            x, p, sign, tau, em = march_kerr_volumetric(
                metric, x0, p0, params=disk, scatter_block=scatter_block,
                **kw)
    elif disk is not None:
        band = dict(r_inner=disk.r_inner, r_outer=disk.r_outer)
        if diff:
            x, p, sign, _, (h1, h2) = march_kerr_disk_adjoint(
                metric, x0, p0, backend=mback, **band, **kw)
        elif gpu:
            x, p, sign, _, (h1, h2) = march_kerr_cuda(
                metric, x0, p0, disk=(disk.r_inner, disk.r_outer), **kw)
        else:
            x, p, sign, (h1, h2) = march_kerr_disk(metric, x0, p0, **band,
                                                   **kw)
    elif backend == "scan":
        x, p, sign, _ = ham.march_hamiltonian_scan(
            metric, x0, p0, capture_radius=metric.capture_radius, **kw)
    elif diff:
        x, p, sign, _ = march_kerr_adjoint(metric, x0, p0, **kw)
    elif gpu:
        x, p, sign, _ = march_kerr_cuda(metric, x0, p0, **kw)
    else:
        x, p, sign, _ = ham.march_hamiltonian(
            metric, x0, p0, capture_radius=metric.capture_radius, **kw)
    return x, p, sign, tau, em, h1, h2, disk_theta


def _kerr_march_and_shade(metric, x0, p0, bg, dt, *, max_steps,
                          escape_radius, disk, filtering, far_accel=True,
                          stepper="rk4", rtol=1e-4, starlight_map=None,
                          backend="auto", disk_theta=None):
    """March an (N,)-ray BL bundle and shade it -> (N, 3) colours; shared by
    the single-frame, frames-batched and adaptive renderers."""
    scatter_block = None
    if disk is not None and disk.volumetric and disk.starlight:
        if starlight_map is None:
            raise ValueError(
                "disk.starlight=True with volumetric=True for Kerr needs a "
                "precomputed starlight_map=compute_kerr_starlight_map(...)")
        scatter_block = starlight_scatter_block(
            starlight_map, disk_view(disk, disk_theta), x0.dtype)
    x, p, sign, tau, em, h1, h2, shade_theta = _march(
        metric, x0, p0, disk=disk, scatter_block=scatter_block,
        stepper=stepper, rtol=rtol, dt=dt, max_steps=max_steps,
        escape_radius=escape_radius, far_r0=_far_r0(metric, disk, far_accel),
        backend=backend, disk_theta=disk_theta)
    return _kerr_shade(metric, x0, p0, bg, x, p, sign, disk, filtering, tau,
                       em, h1, h2, starlight_map,
                       scatter=scatter_block is not None,
                       disk_theta=shade_theta)


def _kerr_shade(metric, x0, p0, bg, x, p, sign, disk, filtering, tau, em,
                h1, h2, starlight_map=None, scatter=False, disk_theta=None):
    """The shading of every Kerr march -> (N, 3) colours: the sky along the
    escaped rays' asymptotic directions (others black; their states are
    replaced by the spawn state first, so NaN never reaches the readout),
    then the volumetric composite or the two thin-disk crossings, with the
    disk's knobs overridden by ``disk_theta``."""
    esc = (sign == 1)[:, None]
    x = torch.where(esc, x, x0)
    p = torch.where(esc, p, p0)
    wx, wy, wz = _asymptotic_dirs(metric, x, p)
    uu, vv = _texture_uv(bg, wx, wy, wz)
    colors = filter_lookup(bg.texture.reshape(-1, 3),
                           torch.zeros_like(uu, dtype=torch.int64), uu, vv,
                           bg.width, bg.height, filtering)
    colors = torch.where(esc, colors, torch.zeros_like(colors))
    dtype = x.dtype
    if disk is None:
        return colors
    shade = disk_view(disk, disk_theta)
    if disk.volumetric:
        rgb, trans = _volumetric_rgb(tau, em, shade, dtype, scatter=scatter)
        return torch.clamp(rgb + trans[:, None] * colors, 0.0, 1.0)
    b_photon = -p0[:, 3] / p0[:, 0]                  # L / E per ray
    star1 = star2 = None
    if disk.starlight:
        if starlight_map is None:
            raise ValueError(
                "disk.starlight=True for Kerr needs a precomputed map: pass "
                "starlight_map=compute_kerr_starlight_map(...)")
        albedo = _rgb(shade.albedo, dtype, x.device)[None, :]
        star1 = albedo * starlight_lookup(starlight_map, *h1)
        star2 = albedo * starlight_lookup(starlight_map, *h2)
    rgb1, a1 = _kerr_disk_rgb(metric, h1[0], b_photon, shade, dtype,
                              starlight=star1)
    rgb2, a2 = _kerr_disk_rgb(metric, h2[0], b_photon, shade, dtype,
                              starlight=star2)
    behind = rgb2 * a2[:, None] + colors * (1.0 - a2[:, None])
    return torch.clamp(rgb1 * a1[:, None] + behind * (1.0 - a1[:, None]),
                       0.0, 1.0)


def _doppler_boost(colors, delta):
    """Received surface brightness ~ delta^3 of a moving camera, on the
    whole received field."""
    if delta is None:
        return colors
    return torch.clamp(colors * (delta ** 3)[:, None], 0.0, 1.0)


def _velocity(v, camera):
    if v is None:
        return None
    return torch.as_tensor(v, dtype=camera.position.dtype,
                           device=camera.device)


def render_kerr(metric, camera: Camera, bg: SphericalImage, *, dt=0.1,
                max_steps=20_000, escape_radius=None,
                disk: DiskParams | None = None, filtering="bilinear",
                backend="auto", camera_velocity=None, far_accel=True,
                stepper="rk4", rtol=1e-4, disk_theta=None,
                starlight_map=None):
    """(H, W, 3): Kerr shadow + lensed sky (+ an optional disk).

    The camera position is (t, r, theta, phi) in Boyer-Lindquist; pixel
    directions are decomposed in the asymptotic frame at the camera angles.
    ``escape_radius=None`` is twice the camera radius.  ``far_accel`` grows
    dt linearly beyond max(8M, r_out + 2M) (at most 8x).  The RK4 march is
    kernel #7 on a GPU, the autodiff RK4 march on the CPU;
    ``stepper='rk45'`` marches with error control ``rtol`` (``dt`` the
    initial step, ``max_steps`` accepted steps) through kernel #8 (module
    docstring)."""
    check_kerr_route(stepper, backend)
    common_device(metric, camera, bg)
    return _render_kerr_impl(metric, camera, bg, dt, max_steps=max_steps,
                             escape_radius=escape_radius, disk=disk,
                             filtering=filtering,
                             camera_velocity=_velocity(camera_velocity,
                                                       camera),
                             far_accel=far_accel, stepper=stepper, rtol=rtol,
                             starlight_map=starlight_map, backend=backend,
                             disk_theta=disk_theta)


def _render_kerr_impl(metric, camera, bg, dt, *, max_steps, escape_radius,
                      disk, filtering, camera_velocity=None, far_accel=True,
                      stepper="rk4", rtol=1e-4, starlight_map=None,
                      backend="auto", disk_theta=None):
    if escape_radius is None:
        escape_radius = 2.0 * camera.position[1]
    x0, p0, delta = _spawn_kerr_rays(metric, camera, camera_velocity)
    colors = _kerr_march_and_shade(metric, x0, p0, bg, dt,
                                   max_steps=max_steps,
                                   escape_radius=escape_radius, disk=disk,
                                   filtering=filtering, far_accel=far_accel,
                                   stepper=stepper, rtol=rtol,
                                   starlight_map=starlight_map,
                                   backend=backend, disk_theta=disk_theta)
    colors = _doppler_boost(colors, delta)
    W, H = camera.resolution_x, camera.resolution_y
    return colors.reshape(W, H, 3).permute(1, 0, 2)


def render_kerr_frames_batched(metric, cameras, bg: SphericalImage, *,
                               dt=0.1, max_steps=20_000, escape_radius=None,
                               disk: DiskParams | None = None,
                               filtering="bilinear", backend="auto",
                               camera_velocities=None, far_accel=True,
                               stepper="rk4", rtol=1e-4, disk_theta=None,
                               starlight_map=None):
    """Several Kerr camera poses with ONE march -> (F, H, W, 3): every
    stage is per ray, so the frames' bundles concatenate (the cameras must
    share a resolution).  ``escape_radius=None`` is twice the largest
    camera radius; ``camera_velocities``: (F, 3) or None."""
    check_kerr_route(stepper, backend)
    cams = list(cameras)
    W, H = cams[0].resolution_x, cams[0].resolution_y
    if any((c.resolution_x, c.resolution_y) != (W, H) for c in cams):
        raise ValueError("all cameras in a batch must share a resolution")
    common_device(metric, bg, *cams)
    F = len(cams)
    vels = [None] * F
    if camera_velocities is not None:
        v = _velocity(camera_velocities, cams[0])
        if v.shape != (F, 3):
            raise ValueError("camera_velocities must be (n_frames, 3)")
        vels = list(v)
    if escape_radius is None:
        escape_radius = 2.0 * torch.max(torch.stack(
            [c.position[1] for c in cams]))
    bundles = [_spawn_kerr_rays(metric, c, v) for c, v in zip(cams, vels)]
    x0 = torch.cat([b[0] for b in bundles])
    p0 = torch.cat([b[1] for b in bundles])
    colors = _kerr_march_and_shade(metric, x0, p0, bg, dt,
                                   max_steps=max_steps,
                                   escape_radius=escape_radius, disk=disk,
                                   filtering=filtering, far_accel=far_accel,
                                   stepper=stepper, rtol=rtol,
                                   starlight_map=starlight_map,
                                   backend=backend, disk_theta=disk_theta)
    if camera_velocities is not None:
        colors = _doppler_boost(colors, torch.cat([b[2] for b in bundles]))
    return colors.reshape(F, W, H, 3).permute(0, 2, 1, 3)


def render_kerr_adaptive(metric, camera: Camera, bg: SphericalImage, *,
                         dt=0.1, max_steps=20_000, escape_radius=None,
                         disk: DiskParams | None = None,
                         filtering="bilinear", backend="auto",
                         refine_frac=0.1, supersample=3,
                         camera_velocity=None, far_accel=True,
                         stepper="rk4", rtol=1e-4, disk_theta=None,
                         starlight_map=None):
    """Edge-adaptive antialiasing: a base render, then k x k centred
    sub-rays (k = ``supersample``) for the ``refine_frac`` highest-contrast
    pixels only, marched as one second bundle; each refined pixel becomes
    the mean of its sub-rays."""
    check_kerr_route(stepper, backend)
    common_device(metric, camera, bg)
    W, H = camera.resolution_x, camera.resolution_y
    n_refine = max(1, int(refine_frac * W * H))
    velocity = _velocity(camera_velocity, camera)
    kw = dict(max_steps=max_steps, disk=disk, filtering=filtering,
              far_accel=far_accel, stepper=stepper, rtol=rtol,
              starlight_map=starlight_map, backend=backend,
              disk_theta=disk_theta)
    base = _render_kerr_impl(metric, camera, bg, dt,
                             escape_radius=escape_radius,
                             camera_velocity=velocity, **kw)
    if escape_radius is None:
        escape_radius = 2.0 * camera.position[1]
    iy, ix = _contrast_topk(base, n_refine)
    k = int(supersample)
    px, py = _subpixel_coords(iy, ix, k, n_refine, base.dtype)
    dxs, dys, dzs = _dirs_for_pixel_coords(camera, px, py)
    delta = None
    if velocity is not None:
        dxs, dys, dzs, delta = aberrate_directions(dxs, dys, dzs, velocity)
    x0, p0 = _spawn_from_dirs(metric, camera.position, dxs, dys, dzs)
    colors = _kerr_march_and_shade(metric, x0, p0, bg, dt,
                                   escape_radius=escape_radius, **kw)
    colors = _doppler_boost(colors, delta)
    img = base.clone()
    img[iy, ix] = colors.reshape(n_refine, k * k, 3).mean(dim=1)
    return img
