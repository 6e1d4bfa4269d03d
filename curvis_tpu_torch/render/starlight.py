"""Starlight on the disk: the lensed sky illuminating the accretion-disk
surface (PyTorch; the planar part of ``curvis_tpu/render/starlight.py``).

Each disk face is a Lambertian reflector, L_out = albedo / pi * E with
E = int_hemi L_in cos(th) dw, where L_in is the sky radiance arriving
along the curved photon path.  By spherical symmetry a secondary ray's
reduced orbit depends only on its launch radius and its angle from the
radial direction, so ONE march of n_r x n_samples reduced rays (a
cosine-weighted hemisphere set per radius) covers every disk point, both
faces and every azimuth; the (2, n_r, n_phi, 3) map of E / pi is a basis
rotation of those escape angles followed by sky lookups.  The map does not
depend on the camera: compute it once per (metric, sky, disk).

The map's march is the thin-disk march of ``render/disk.py`` (annulus
crossings give the self-shadow): kernel #5 (``ops/disk_cuda.py``) for CUDA
tensors, the XLA twin for CPU tensors; with ``stepper='rk45'`` kernel #4's
disk tracker (``ops/rk45_disk_cuda.py``) and the DP5(4) twin.
``compute_kerr_starlight_map`` is the Kerr / Kerr-Newman map, marched by
kernel #7 (RK4) or #8 (DP5(4)) on a GPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from curvis_tpu_torch.metrics.base import (EllisMetric, FlatSphericalMetric,
                                           InterstellarMetric, Metric,
                                           ReissnerNordstromMetric,
                                           SchwarzschildMetric)
from curvis_tpu_torch.ops.disk_vol_cuda import SCATTER_BLOCK, SCATTER_DEG
from curvis_tpu_torch.ops.kerr_cuda import march_kerr_cuda
from curvis_tpu_torch.ops.kerr_rk45_cuda import march_kerr_rk45_cuda
from curvis_tpu_torch.ops.march_cuda import refuse_table
from curvis_tpu_torch.physics.hamiltonian import spawn_photon
from curvis_tpu_torch.physics import planar as pl
from curvis_tpu_torch.render.disk import (_check_route, _emission_rgb,
                                          _march_thin, _rgb)
from curvis_tpu_torch.render.fast import _shade_soa
from curvis_tpu_torch.utils.device import common_device

# the metrics whose l -> -l mirror is themselves
_SYMMETRIC = (EllisMetric, InterstellarMetric, FlatSphericalMetric,
              SchwarzschildMetric, ReissnerNordstromMetric)


class StarlightMap(NamedTuple):
    """Reflected-sky map over the disk: values[(1 - side) // 2, i, j] is
    E / pi at radius radii[i], world azimuth 2 pi j / n_phi, on the +z
    (index 0) or -z (index 1) face.  ``values_neg``: the negative-sheet
    table of a two-sheet wormhole map; hits select their sheet by the sign
    of the recorded hit coordinate."""
    radii: torch.Tensor             # (n_r,)
    values: torch.Tensor            # (2, n_r, n_phi, 3)
    values_neg: Optional[torch.Tensor] = None


def mirror_metric(metric):
    """The l -> -l mirrored metric, r_m(l) = r(-l): the metric itself for
    the five planar kinds, whose shapes are even in l.  Tabulated metrics
    (whose mirror flips the parity of their Chebyshev tables) are ROADMAP
    Queue 1 item 4b."""
    if isinstance(metric, _SYMMETRIC):
        return metric
    raise NotImplementedError(
        f"mirror_metric: {type(metric).__name__} is not a ported planar "
        "metric (tabulated metrics are ROADMAP Queue 1 item 4b)")


def _cosine_hemisphere(n_samples: int):
    """Deterministic cosine-weighted hemisphere set around the face normal,
    in local (r_hat, phi_hat, n_hat) coordinates (a_r, a_p, a_n): a
    Fibonacci lattice in (u, phi) with cos(th) = sqrt(1 - u)."""
    k = np.arange(n_samples)
    u = (k + 0.5) / n_samples
    ang = np.pi * (3.0 - np.sqrt(5.0)) * k          # golden angle
    sin_t = np.sqrt(u)
    a_n = np.sqrt(1.0 - u)                          # cos(th) > 0: upper hemi
    a_r = sin_t * np.cos(ang)
    a_p = sin_t * np.sin(ang)
    return a_r, a_p, a_n


def hit_phi_side(r_hit, psi_hit, b, c1, c2, e1, e2):
    """World azimuth and approach side of a recorded disk crossing.

    ``e1``, ``e2``: per-ray orbital-plane basis as component tuples.  The
    hit lies at r_hit (e1 cos psi + e2 sin psi), azimuth atan2(p_y, p_x);
    the approach side is the sign of z just before the crossing,
    -sign(b) sign(c2 cos psi - c1 sin psi).  Returns (phi_world, side),
    side in {+1, -1} (meaningless where r_hit == 0)."""
    cu = torch.cos(psi_hit)
    sv = torch.sin(psi_hit)
    px = e1[0] * cu + e2[0] * sv
    py = e1[1] * cu + e2[1] * sv
    phi = torch.atan2(py, px)
    dz = c2 * cu - c1 * sv
    side = -torch.sign(b) * torch.sign(dz)
    side = torch.where(side == 0.0, torch.ones_like(side), side)
    return phi, side


def map_rays(metric: Metric, r_inner, r_outer, n_r, n_samples, dtype,
             device):
    """The map's reduced rays: (radii (n_r,), PlanarRays of the n_r x
    n_samples hemisphere samples at (r_i, alpha_k), sin(alpha) per ray,
    the hemisphere set (a_r, a_p, a_n) as tensors).  The planar spawn of
    physics/planar.spawn_planar with a per-ray launch radius."""
    rr = torch.linspace(float(r_inner), float(r_outer), n_r, dtype=dtype,
                        device=device)
    hemi = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in _cosine_hemisphere(n_samples))
    l0 = rr[:, None].expand(n_r, n_samples).reshape(-1)
    cos_a = hemi[0][None, :].expand(n_r, n_samples).reshape(-1)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    p_l0 = cos_a
    b0 = sin_a * metric.r(l0)
    if not pl._unit_lapse(metric):
        A0 = metric.lapse(l0)
        B0 = metric.radial_B(l0)
        p_l0 = cos_a * torch.sqrt(B0 / A0)
        b0 = b0 / torch.sqrt(A0)
    rays = pl.PlanarRays(l0, torch.zeros_like(l0), p_l0, b0, None, None)
    return rr, rays, sin_a, hemi


def compute_disk_starlight_map(
        metric: Metric, bg_positive, bg_negative=None, *, r_inner, r_outer,
        escape_radius, dt=0.02, max_steps=100_000, n_r=48, n_phi=128,
        n_samples=128, filtering="bilinear", sample_filtering="nearest",
        stepper="euler", rtol=1e-5, blueshift=True, shadow_params=None,
        two_sheet=False) -> StarlightMap:
    """March the (n_r x n_samples) reduced secondary-ray table and expand
    it to the (2, n_r, n_phi, 3) reflected-sky map.

    ``shadow_params`` (a render/disk.DiskParams or None): each secondary
    ray is attenuated by (1 - alpha) at its first two annulus crossings
    (the disk shadowing itself).  ``sample_filtering``: the texture filter
    of the per-sample sky lookups (each texel averages n_samples of them);
    ``filtering`` is passed on to the second sheet only, as in the JAX
    package.  ``two_sheet``: a second table for the mirrored metric with
    the skies swapped (capture-free metrics only)."""
    _check_route(stepper)
    refuse_table(metric, "compute_disk_starlight_map")
    tex = bg_positive.texture
    dtype, dev = tex.dtype, tex.device
    if bg_negative is None:
        bg_negative = bg_positive
    rr, rays, sin_a, (_, a_p, a_n) = map_rays(metric, r_inner, r_outer, n_r,
                                              n_samples, dtype, dev)
    # the launch point sits ON the plane (c1 = 0, c2 = 1): crossings at
    # psi = m pi for every sample
    c1 = torch.zeros_like(rays.l)
    c2 = torch.ones_like(rays.l)
    res, h1, h2 = _march_thin(metric, rays, c1, c2, stepper=stepper,
                              rtol=rtol, dt=dt, max_steps=max_steps,
                              escape_radius=escape_radius, r_inner=r_inner,
                              r_outer=r_outer)

    beta = pl.escape_angle_beta(metric, res, rays.b).reshape(n_r, n_samples)
    sign = res.sign.reshape(n_r, n_samples)

    # self-shadow: Beer attenuation at the first two annulus crossings
    att = torch.ones((n_r, n_samples), dtype=dtype, device=dev)
    if shadow_params is not None:
        g1 = torch.ones_like(h1[0])
        _, alpha1 = _emission_rgb(torch.abs(h1[0]), g1, shadow_params, dtype)
        _, alpha2 = _emission_rgb(torch.abs(h2[0]), g1, shadow_params, dtype)
        att = ((1.0 - alpha1) * (1.0 - alpha2)).reshape(n_r, n_samples)

    # expand: w(side, i, j, k) = cos(beta_ik) r_hat_j + sin(beta_ik) t_hat,
    # t_hat = (a_p phi_hat_j + a_n side z_hat) / sin(alpha_k)
    pp = (2.0 * math.pi / n_phi) * torch.arange(n_phi, dtype=dtype,
                                                device=dev)
    cj = torch.cos(pp)[None, None, :, None]          # (1, 1, n_phi, 1)
    sj = torch.sin(pp)[None, None, :, None]
    cb = torch.cos(beta)[None, :, None, :]           # (1, n_r, 1, K)
    sb = torch.sin(beta)[None, :, None, :]
    inv_s = (1.0 / torch.clamp(sin_a.reshape(n_r, n_samples), min=1e-12)
             )[None, :, None, :]
    apk = a_p[None, None, None, :]
    ank = a_n[None, None, None, :]
    sides = torch.tensor([1.0, -1.0], dtype=dtype,
                         device=dev)[:, None, None, None]
    shape = (2, n_r, n_phi, n_samples)
    wx = (cb * cj + sb * inv_s * apk * (-sj)).expand(shape).reshape(-1)
    wy = (cb * sj + sb * inv_s * apk * cj).expand(shape).reshape(-1)
    wz = (sb * inv_s * ank * sides).expand(shape).reshape(-1)
    esc_pos = (sign == 1)[None, :, None, :, None]
    esc_neg = (sign == -1)[None, :, None, :, None]
    L = _shade_soa(bg_positive, wx, wy, wz,
                   sample_filtering).reshape(shape + (3,))
    L = torch.where(esc_pos, L, torch.zeros_like(L))
    if pl._capture_radius(metric) is None:
        Ln = _shade_soa(bg_negative, wx, wy, wz,
                        sample_filtering).reshape(shape + (3,))
        L = torch.where(esc_neg, Ln, L)
    L = L * att[None, :, None, :, None]
    E = torch.mean(L, dim=3)                         # (2, n_r, n_phi, 3)
    if blueshift and not pl._unit_lapse(metric):
        A = torch.clamp(metric.lapse(rr), 1e-3, 1.0)
        E = E * (1.0 / (A * A))[None, :, None, None]
    values_neg = None
    if two_sheet:
        # the negative sheet's own table: the mirrored metric with the two
        # universes' skies swapped
        if pl._capture_radius(metric) is not None:
            raise ValueError("two_sheet=True needs a two-universe "
                             "(capture-free) metric")
        neg = compute_disk_starlight_map(
            mirror_metric(metric), bg_negative, bg_positive,
            r_inner=r_inner, r_outer=r_outer, escape_radius=escape_radius,
            dt=dt, max_steps=max_steps, n_r=n_r, n_phi=n_phi,
            n_samples=n_samples, filtering=filtering,
            sample_filtering=sample_filtering, stepper=stepper, rtol=rtol,
            blueshift=blueshift, shadow_params=shadow_params,
            two_sheet=False)
        values_neg = neg.values
    return StarlightMap(radii=rr, values=E, values_neg=values_neg)


def compute_kerr_starlight_map(
        metric, bg, *, r_inner, r_outer, escape_radius, dt=0.1,
        max_steps=20_000, n_r=48, n_phi=128, n_samples=128,
        sample_filtering="nearest", backend="auto", stepper="rk4",
        rtol=1e-4, boost="static", shadow_params=None,
        far_accel=True) -> StarlightMap:
    """The lensed-sky illumination map of a Kerr / Kerr-Newman disk.

    Kerr is stationary and axisymmetric: the escape direction of a
    secondary ray launched at disk azimuth phi0 is the phi0 = 0 ray's
    rotated by phi0 about the spin axis, and the equatorial reflection maps
    the -z face onto the +z face's marches.  So ONE bundle of n_r x
    n_samples BL marches (a cosine-weighted hemisphere in the local static
    frame at (r_i, pi/2, 0), local energy 1) covers both faces and every
    azimuth, with the annulus crossings for the self-shadow
    (``shadow_params``).  Each escaped sample is weighted by the
    bolometric boost (nu_loc / nu_inf)^4: nu_loc = 1 (``boost='static'``)
    or the circular-orbit material frame's u^t (E - Omega L) (``'orbit'``,
    ratio clipped to [0.2, 4]); captured samples are black.  The RK4 march
    is kernel #7 with its disk tracker on a GPU, ``render/kerr.py:
    march_kerr_disk`` on the CPU; ``stepper='rk45'`` (error control
    ``rtol``, ``dt`` the initial step) is kernel #8 with its disk tracker,
    or its plain version on the CPU (the JAX package runs that kernel in
    interpret mode off the TPU).  ``backend='scan'`` or ``'adjoint'``
    marches the same way, without gradients through the march, as the JAX
    package's map does.  Camera-independent: compute once per (metric,
    sky, disk) and pass to every frame."""
    from curvis_tpu_torch.render import kerr as rk
    rk.check_kerr_route(stepper, backend)
    tex = bg.texture
    dtype, dev = tex.dtype, tex.device
    common_device(metric, bg)
    rr = torch.linspace(float(r_inner), float(r_outer), n_r, dtype=dtype,
                        device=dev)
    a_r, a_p, a_n = (torch.as_tensor(a, dtype=dtype, device=dev)
                     for a in _cosine_hemisphere(n_samples))
    N = n_r * n_samples
    r0 = rr[:, None].expand(n_r, n_samples).reshape(-1)
    zeros = torch.zeros((N,), dtype=dtype, device=dev)
    x0 = torch.stack([zeros, r0, torch.full_like(r0, math.pi / 2), zeros],
                     dim=-1)

    def tile(a):
        return a[None, :].expand(n_r, n_samples).reshape(-1)

    # +z-face hemisphere in the static tetrad (e_r, e_theta, e_phi): at the
    # equator e_theta points along -z, so the vertical component is -a_n
    d3 = torch.stack([tile(a_r), -tile(a_n), tile(a_p)], dim=-1)
    p0 = spawn_photon(metric, x0, d3)
    E = -p0[:, 0]                                 # nu_inf per sample
    far_r0 = None
    if far_accel:
        far_r0 = torch.maximum(8.0 * metric.m, r_outer + 2.0 * metric.m)
    kw = dict(dt=dt, max_steps=max_steps, escape_radius=escape_radius,
              far_r0=far_r0)
    if stepper == "rk45":
        x, p, sign, _, (h1, h2) = march_kerr_rk45_cuda(
            metric, x0, p0, dt0=dt, max_steps=max_steps,
            escape_radius=escape_radius, rtol=rtol, atol=rtol * 1e-3,
            disk=(r_inner, r_outer))
    elif dev.type == "cpu":
        x, p, sign, (h1, h2) = rk.march_kerr_disk(
            metric, x0, p0, r_inner=r_inner, r_outer=r_outer, **kw)
    else:
        x, p, sign, _, (h1, h2) = march_kerr_cuda(
            metric, x0, p0, disk=(r_inner, r_outer), **kw)

    esc = (sign == 1)[:, None]
    wx, wy, wz = rk._asymptotic_dirs(metric, torch.where(esc, x, x0),
                                     torch.where(esc, p, p0))
    weight = (sign == 1).to(dtype)
    if boost:
        if boost == "orbit":
            M, aspin = metric.m, metric.a
            sqM = torch.sqrt(M)
            r32 = r0 * torch.sqrt(r0)
            omega = sqM / (r32 + aspin * sqM)
            under = torch.clamp(1.0 - 3.0 * M / r0
                                + 2.0 * aspin * sqM / r32, min=1e-3)
            u_t = 1.0 / torch.sqrt(under)
            nu_loc = u_t * (E - omega * p0[:, 3])
        else:                                     # "static"
            nu_loc = torch.ones_like(E)
        ratio = nu_loc / torch.clamp(E, min=1e-12)
        if boost == "orbit":
            ratio = torch.clamp(ratio, 0.2, 4.0)
        r2 = ratio * ratio
        weight = weight * r2 * r2
    if shadow_params is not None:
        g1 = torch.ones_like(h1[0])
        _, alpha1 = _emission_rgb(h1[0], g1, shadow_params, dtype)
        _, alpha2 = _emission_rgb(h2[0], g1, shadow_params, dtype)
        weight = weight * (1.0 - alpha1) * (1.0 - alpha2)

    # axisymmetry: azimuth j rotates (wx, wy) by phi_j about z; the -z face
    # (index 1) is the reflection wz -> -wz
    wx, wy, wz, weight = (t.reshape(n_r, n_samples)
                          for t in (wx, wy, wz, weight))
    pp = (2.0 * math.pi / n_phi) * torch.arange(n_phi, dtype=dtype,
                                                device=dev)
    cj = torch.cos(pp)[None, :, None]             # (1, n_phi, 1)
    sj = torch.sin(pp)[None, :, None]
    rx = wx[:, None, :] * cj - wy[:, None, :] * sj
    ry = wx[:, None, :] * sj + wy[:, None, :] * cj
    shape = (2, n_r, n_phi, n_samples)
    sides = torch.tensor([1.0, -1.0], dtype=dtype,
                         device=dev)[:, None, None, None]
    wxa = rx[None].expand(shape).reshape(-1)
    wya = ry[None].expand(shape).reshape(-1)
    wza = (wz[None, :, None, :] * sides).expand(shape).reshape(-1)
    L = _shade_soa(bg, wxa, wya, wza, sample_filtering).reshape(shape + (3,))
    L = L * weight[None, :, None, :, None]
    return StarlightMap(radii=rr, values=torch.mean(L, dim=3))


def starlight_lookup(smap: StarlightMap, r_hit, phi_world, side):
    """Bilinear (r, phi) lookup with azimuthal wraparound; ``side`` in
    {+1, -1} selects the face.  ``r_hit`` may be signed (sign = sheet):
    the radius is |r_hit| and, when the map has a negative-sheet table,
    r_hit < 0 selects it.  Returns (N, 3) E / pi."""
    if smap.values_neg is not None:
        pos = starlight_lookup(smap._replace(values_neg=None),
                               torch.abs(r_hit), phi_world, side)
        neg = starlight_lookup(StarlightMap(smap.radii, smap.values_neg),
                               torch.abs(r_hit), phi_world, side)
        return torch.where((r_hit < 0.0)[:, None], neg, pos)
    vals = smap.values
    _, n_r, n_phi, _ = vals.shape
    r0 = smap.radii[0]
    r1 = smap.radii[-1]
    r_hit = torch.abs(r_hit)
    tr = torch.clamp((r_hit - r0) / (r1 - r0), 0.0, 1.0) * (n_r - 1)
    i0 = torch.clamp(torch.floor(tr).to(torch.int64), 0, n_r - 2)
    fr = (tr - i0)[:, None]
    tp = torch.remainder(phi_world / (2.0 * math.pi), 1.0) * n_phi
    j0 = torch.clamp(torch.floor(tp).to(torch.int64), 0, n_phi - 1)
    fp = (tp - j0)[:, None]
    j1 = torch.remainder(j0 + 1, n_phi)
    s = ((1.0 - side) * 0.5).to(torch.int64)         # +1 -> 0, -1 -> 1
    rows = vals.reshape(-1, 3)
    base = (s * n_r + i0) * n_phi

    def gather(i_off, j):
        return rows[base + i_off * n_phi + j]

    top = gather(0, j0) * (1.0 - fp) + gather(0, j1) * fp
    bot = gather(1, j0) * (1.0 - fp) + gather(1, j1) * fp
    return top * (1.0 - fr) + bot * fr


def starlight_scatter_block(smap: StarlightMap, disk, dtype=torch.float32):
    """The (SCATTER_BLOCK,) in-gas scattering coefficients of the
    volumetric marches: [tint_rgb, then per channel the SCATTER_DEG-degree
    monomial fit of kappa_s albedo_c Ebar_c(t)], Ebar the face- and
    azimuth-averaged map profile over t = 2 (r - r_in) / (r_out - r_in) - 1
    and kappa_s = disk.starlight_scatter * disk.kappa."""
    prof = torch.mean(smap.values, dim=(0, 2))        # (n_r, 3)
    if smap.values_neg is not None:
        prof = 0.5 * (prof + torch.mean(smap.values_neg, dim=(0, 2)))
    n_r = prof.shape[0]
    t = np.linspace(-1.0, 1.0, n_r)
    pinv = np.linalg.pinv(np.vander(t, SCATTER_DEG + 1, increasing=True))
    dev = prof.device
    coefs = torch.as_tensor(pinv, dtype=dtype, device=dev) @ prof.to(dtype)
    # tensors of a DiskView (render/disk.py) stay in the graph
    albedo = _rgb(disk.albedo, dtype, dev)
    ks = torch.as_tensor(disk.starlight_scatter * disk.kappa, dtype=dtype,
                         device=dev)
    coefs = coefs * albedo[None, :] * ks
    tint = _rgb(disk.tint, dtype, dev)
    block = torch.cat([tint, coefs.T.reshape(-1)])
    assert block.shape == (SCATTER_BLOCK,)
    return block
