"""Accretion-disk rendering around the planar black holes (PyTorch).

Counterpart of ``curvis_tpu/render/disk.py`` for the Euler march: a thin,
luminous disk in the world equatorial plane (z = 0) between r_inner and
r_outer, or a flared Gaussian gas disk marched volumetrically, composited
over the lensed sky.  During the planar march each ray tracks its world
z = r(l) (c1 cos psi + c2 sin psi), with (cos psi, sin psi) advanced
incrementally; a sign change of z within a step is a disk crossing, and
the first two in-band crossings are recorded as signed (l, p_l, psi)
triples (sign = sheet: a wormhole's far-sheet hits are negative).

Routes, by the stepper and the device of the inputs:

- Euler on CUDA tensors (float32) marches through the hand-written
  kernels ``ops/disk_cuda.py`` (thin disk and the starlight map) and
  ``ops/disk_vol_cuda.py`` (volumetric);
- Euler on CPU tensors marches through ``march_planar_disk`` and
  ``march_planar_disk_volumetric`` below, the ports of the JAX package's
  XLA marches (what it runs off the TPU).  Their arithmetic is the XLA
  march's (z = r(l) zq, ``blackbody_rgb``'s expm1 form), not the kernels';
- ``stepper='rk45'`` (the error-controlled DP5(4) pair, accuracy set by
  ``rtol``, atol = rtol 1e-3; ``dt`` is the initial step, to which the
  step clamps near the disk, and ``max_steps`` counts accepted steps)
  marches through kernel #4's surface variants
  (``ops/rk45_disk_cuda.py``) on CUDA tensors and through the port of the
  JAX package's XLA twin (``integrate/rk45.py:march_planar_rk45``) on CPU
  tensors.

The shading (``DiskParams``, ``blackbody_rgb``, ``disk_temperature``,
``_emission_rgb``, ``_disk_rgb``, ``_volumetric_rgb``) is the JAX
package's, form for form.

``differentiable='adjoint' | 'scan' | True`` marches through the planar
surface adjoints (``integrate/planar_surface_adjoint.py``) with either
stepper (rk45 with ``rtol`` and atol = rtol 1e-3, as the JAX package
passes them): 'adjoint' and True run the forward kernel (#5 or #6 for
Euler, #4's surface variants for rk45) and the surface checkpoint kernels
backward on CUDA tensors, the step twins on CPU tensors; 'scan' runs the
twins on any device (as the JAX package maps only 'scan' to its XLA
pair).  ``disk_theta`` (tensors keyed by
``DIFF_DISK_KEYS``) overrides the shading knobs on every route, and the
volumetric march's emission row on the differentiable one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from curvis_tpu_torch.camera.camera import Camera
from curvis_tpu_torch.env.spherical_image import SphericalImage
from curvis_tpu_torch.integrate.rk45 import march_planar_rk45
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops.disk_cuda import march_planar_disk_cuda
from curvis_tpu_torch.ops.march_cuda import refuse_table
from curvis_tpu_torch.ops.disk_vol_cuda import (
    march_planar_disk_volumetric_cuda, scatter_source_plain)
from curvis_tpu_torch.ops.rk45_disk_cuda import march_planar_rk45_disk_cuda
from curvis_tpu_torch.physics import planar as pl
from curvis_tpu_torch.render.fast import (_readout, _shade_two_skies,
                                          _spawn_frames)
from curvis_tpu_torch.utils.device import common_device


@dataclasses.dataclass(frozen=True)
class DiskParams:
    """The disk's geometry and shading (the JAX package's DiskParams, same
    fields and defaults; see its docstrings for the physics)."""
    r_inner: float = 6.0          # ~ISCO for M=1
    r_outer: float = 14.0
    emissivity_index: float = 2.0
    brightness: float = 1.0
    tint: tuple = (1.0, 0.71, 0.42)     # hot thermal white-orange
    opacity: float = 0.85               # per crossing
    redshift: bool = True
    doppler: bool = True                # relativistic beaming (g^3)
    spin_sign: float = 1.0              # disk rotation sense
    # 'tint': power-law emissivity x tint, intensity ~ g^3; 'blackbody':
    # Shakura-Sunyaev T(r), Planck colours, observed T = g T_emit
    color_mode: str = "tint"
    t_peak: float = 9000.0              # peak emitted temperature [K]
    thickness: float = 0.0              # slab aspect (0: the thin model)
    volumetric: bool = False            # per-step transfer through gas
    h_rel: float = 0.08                 # disk scale height H / r_cyl
    kappa: float = 2.0                  # absorption per vertical column
    tau_max: float = 12.0               # stop marching once this opaque
    starlight: bool = False             # lensed sky reflected off the disk
    albedo: tuple = (0.4, 0.4, 0.4)     # Lambertian surface albedo (RGB)
    starlight_samples: int = 128        # hemisphere rays per map texel row
    starlight_grid: tuple = (48, 128)   # (n_r, n_phi) map resolution
    starlight_blueshift: bool = True    # A^-2 infall boost (Liouville)
    starlight_self_shadow: bool = True  # annulus attenuates its own sky
    starlight_scatter: float = 1.0      # in-gas scattering / kappa
    starlight_two_sheet: bool = False   # second map for the l < 0 sheet


_BB_C2 = 1.4388e-2                      # Planck c2 = h c / k_B  [m K]
_BB_LAMBDA = (610e-9, 550e-9, 465e-9)   # RGB sample wavelengths [m]

# Rays frozen by the tau_max cutoff: rendered with their accumulated
# emission only; they share the captured rays' black background.
OPAQUE_SIGN = pl.CAPTURED

# The numeric DiskParams fields that a differentiable render may override
# with tensors (the smooth knobs; mode switches such as color_mode,
# volumetric, starlight and thickness stay static).
DIFF_DISK_KEYS = frozenset({
    "r_inner", "r_outer", "h_rel", "kappa", "t_peak", "emissivity_index",
    "spin_sign", "brightness", "opacity", "tint", "albedo",
    "starlight_scatter"})


class DiskView:
    """A DiskParams with some numeric fields overridden by tensors.

    The static ``DiskParams`` keeps the mode flags and the thin march's
    recording band; ``disk_theta`` (tensors keyed by the names of
    ``DIFF_DISK_KEYS``) overrides the smooth shading and emission knobs, so
    that gradients reach them.  The THIN disk's march records crossings in
    the static [r_inner, r_outer] band while the shader reads the
    overridden edges, which should stay inside it; the volumetric march
    reads the overrides itself on the differentiable route
    (``integrate/kerr_surface_adjoint.py:build_vol_row``)."""

    __slots__ = ("_base", "_over")

    def __init__(self, base, over):
        bad = set(over) - DIFF_DISK_KEYS
        if bad:
            raise ValueError(f"disk_theta: non-differentiable or unknown "
                             f"keys {sorted(bad)}; allowed: "
                             f"{sorted(DIFF_DISK_KEYS)}")
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "_over", dict(over))

    def __getattr__(self, name):
        over = object.__getattribute__(self, "_over")
        if name in over:
            return over[name]
        return getattr(object.__getattribute__(self, "_base"), name)


def disk_view(params, disk_theta=None):
    """``params`` itself without overrides, else a DiskView."""
    if not disk_theta:
        return params
    return DiskView(params, disk_theta)


def _rgb(value, dtype, device):
    """An RGB triple (a tensor, or a sequence of floats or tensors) as a
    (3,) tensor that keeps a tensor-valued triple in the graph."""
    if torch.is_tensor(value):
        return value.to(device=device, dtype=dtype).reshape(3)
    return torch.stack([torch.as_tensor(v, dtype=dtype, device=device)
                        for v in value])


_DIFFERENTIABLE = (None, False, True, "scan", "adjoint")


def _check_route(stepper, differentiable=None):
    """Raise for a stepper the disk routes do not run, or an unknown
    ``differentiable``."""
    pl.check_stepper(stepper, ported=("euler", "rk45"))
    if differentiable not in _DIFFERENTIABLE:
        raise ValueError(f"differentiable must be one of {_DIFFERENTIABLE}, "
                         f"got {differentiable!r}")


def blackbody_rgb(T):
    """Linear-RGB chromaticity of a Planck radiator sampled at 610 / 550 /
    465 nm, normalised to max channel 1 per element; in log space, so cold
    temperatures stay finite.  (...,) -> (..., 3)."""
    T = torch.clamp(T, min=1.0)
    lams = torch.tensor(_BB_LAMBDA, dtype=T.dtype, device=T.device)
    x = _BB_C2 / (lams * T[..., None])
    # ln(expm1(x)) ~ x for large x; the min() keeps expm1 finite everywhere
    log_denom = torch.where(x < 20.0,
                            torch.log(torch.expm1(torch.clamp(x, max=20.0))),
                            x)
    log_i = -5.0 * torch.log(lams) - log_denom
    log_i = log_i - torch.amax(log_i, dim=-1, keepdim=True)
    return torch.exp(log_i)


def disk_temperature(r, params: DiskParams):
    """Shakura-Sunyaev T(r) ~ r^{-3/4} (1 - sqrt(r_in/r))^{1/4}, peaking at
    ``t_peak`` at r = 49/36 r_in; zero at the inner edge.  The fourth root
    is taken of 1 where its argument is 0 and the result selected away:
    the same values, but a finite gradient at the inner edge (and for
    pixels without a hit, which sit there), where d/dx x^{1/4} is
    infinite and a zero cotangent times it is NaN."""
    r_in = params.r_inner
    r = torch.clamp(r, min=r_in)
    x = 1.0 - torch.sqrt(r_in / r)
    pos = x > 0.0
    f = torch.where(pos, r ** -0.75 * torch.where(pos, x, 1.0) ** 0.25,
                    0.0)
    rp = (49.0 / 36.0) * r_in
    f_peak = rp ** -0.75 * (1.0 / 7.0) ** 0.25   # 1 - sqrt(36/49) = 1/7
    return params.t_peak * f / f_peak


def _emission_rgb(r_hit, g, params: DiskParams, dtype, path=None,
                  starlight=None):
    """Colour and alpha of a crossing at radius r_hit (0 = no hit) with
    total shift factor g; ``path``: the slab chord (finite thickness);
    ``starlight``: (N, 3) reflected-sky radiance at the hit."""
    hit = r_hit > 0.0
    w = params.r_outer - params.r_inner
    edge_in = torch.clamp((r_hit - params.r_inner) / (0.1 * w), 0.0, 1.0)
    edge_out = torch.clamp((params.r_outer - r_hit) / (0.3 * w), 0.0, 1.0)
    column = 1.0 if path is None else path
    if params.color_mode == "blackbody":
        t_obs = g * disk_temperature(r_hit, params)
        rel = (t_obs / params.t_peak) ** 4         # Stefan-Boltzmann
        lum = 1.0 - torch.exp(-params.brightness * rel * column)   # filmic
        glow = lum * edge_out
        rgb = blackbody_rgb(t_obs) * glow[:, None]
    else:
        rr = torch.clamp(r_hit, min=params.r_inner)
        emis = (params.r_inner / rr) ** params.emissivity_index
        glow = params.brightness * emis * edge_in * edge_out * column
        glow = glow * torch.clamp(g, 0.0, 4.0) ** 3
        tint = _rgb(params.tint, dtype, r_hit.device)
        rgb = glow[:, None] * tint[None, :]
    if starlight is not None:
        beam = edge_in * edge_out * torch.clamp(g, 0.0, 4.0) ** 3
        rgb = rgb + starlight * beam[:, None]
    alpha_thin = params.opacity * torch.clamp(glow, 0.25, 1.0)
    if path is not None:
        alpha_thin = 1.0 - (1.0 - alpha_thin) ** path
    alpha = torch.where(hit, alpha_thin, torch.zeros_like(alpha_thin))
    return rgb, alpha


def march_planar_disk(metric: Metric, rays: pl.PlanarRays, c1, c2, *, dt,
                      max_steps, escape_radius, r_inner, r_outer):
    """Masked Euler march that also records the first two disk-plane
    crossings with radius in [r_inner, r_outer] (the JAX package's XLA
    march): (PlanarResult, (h1, h1p, h1s), (h2, h2p, h2s)), h = 0 marking
    no hit, h signed (sign = sheet), p the radial momentum and psi the
    in-plane angle at the crossing."""
    l, psi, p_l, b = rays.l, rays.psi, rays.p_l, rays.b
    dt = torch.as_tensor(dt, dtype=l.dtype, device=l.device)
    r_cap = pl._capture_radius(metric)
    u = torch.cos(psi)
    v = torch.sin(psi)
    z = metric.r(l) * (c1 * u + c2 * v)
    zeros = torch.zeros_like(l)
    h1 = h1p = h1s = h2 = h2p = h2s = zeros
    sign = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % pl._CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        dl, dpsi, dpl = pl.planar_rhs(metric, l, psi, p_l, b)
        l1 = l + dt * dl
        psi1 = psi + dt * dpsi
        pl1 = p_l + dt * dpl
        du = dt * dpsi
        u1 = u - v * du
        v1 = v + u * du
        z1 = metric.r(l1) * (c1 * u1 + c2 * v1)
        crossed = active & (z * z1 < 0.0)
        frac = torch.abs(z) / torch.clamp(torch.abs(z) + torch.abs(z1),
                                          min=1e-30)
        lh = l + frac * (l1 - l)      # SIGNED: |lh| = radius, sign = sheet
        r_hit = torch.abs(lh)
        in_disk = crossed & (r_hit >= r_inner) & (r_hit <= r_outer)
        pl_hit = p_l + frac * (pl1 - p_l)
        psi_hit = psi + frac * (psi1 - psi)
        new_h1 = in_disk & (h1 == 0.0)
        new_h2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
        h1 = torch.where(new_h1, lh, h1)
        h1p = torch.where(new_h1, pl_hit, h1p)
        h1s = torch.where(new_h1, psi_hit, h1s)
        h2 = torch.where(new_h2, lh, h2)
        h2p = torch.where(new_h2, pl_hit, h2p)
        h2s = torch.where(new_h2, psi_hit, h2s)
        l = torch.where(active, l1, l)
        psi = torch.where(active, psi1, psi)
        p_l = torch.where(active, pl1, p_l)
        u = torch.where(active, u1, u)
        v = torch.where(active, v1, v)
        z = torch.where(active, z1, z)
        sign = torch.where(active & (l > escape_radius), 1,
                           torch.where(active & (l < -escape_radius), -1,
                                       sign))
        if r_cap is not None:
            sign = torch.where(active & (l < r_cap), pl.CAPTURED, sign)
        sign = sign.to(torch.int32)
        steps = steps + active.to(torch.int32)
    return (pl.PlanarResult(l, psi, p_l, sign, steps), (h1, h1p, h1s),
            (h2, h2p, h2s))


def march_planar_disk_volumetric(metric: Metric, rays: pl.PlanarRays, c1,
                                 c2, nz, *, dt, max_steps, escape_radius,
                                 params: DiskParams, scatter_block=None):
    """Masked Euler march with per-step volumetric transfer through the
    flared Gaussian disk (the JAX package's XLA march): optical depth
    dtau = kappa rho ds and emission e^-tau w rho ds per step, emission at
    the post-step state with the pre-update tau; a ray is frozen
    (OPAQUE_SIGN) once tau > tau_max.  Returns (PlanarResult, tau,
    (em_r, em_g, em_b)).  ``scatter_block``: the in-gas starlight source
    (render/starlight.py:starlight_scatter_block)."""
    l, psi, p_l, b = rays.l, rays.psi, rays.p_l, rays.b
    dt = torch.as_tensor(dt, dtype=l.dtype, device=l.device)
    r_cap = pl._capture_radius(metric)
    general = not pl._unit_lapse(metric)
    blackbody = params.color_mode == "blackbody"
    h2 = params.h_rel * params.h_rel
    inv_norm = float(1.0 / (np.sqrt(2.0 * np.pi) * params.h_rel))
    w_edge = params.r_outer - params.r_inner

    def step_emission(l, p_l, zq, r, tau):
        zq2 = zq * zq
        s2 = torch.clamp(1.0 - zq2, 1e-12, 1.0)
        r_cyl = r * torch.sqrt(s2)
        dens = torch.exp(-zq2 / (2.0 * h2 * s2)) * (inv_norm / r_cyl)
        edge_in = torch.clamp((r_cyl - params.r_inner) / (0.1 * w_edge),
                              0.0, 1.0)
        edge_out = torch.clamp((params.r_outer - r_cyl) / (0.3 * w_edge),
                               0.0, 1.0)
        base = dens * edge_in * edge_out
        rr = torch.clamp(r_cyl, min=params.r_inner)
        g = torch.ones_like(r_cyl)
        if general:
            A = torch.clamp(metric.lapse(rr), 1e-3, 1.0)
            sqA = torch.sqrt(A)
            if params.redshift:
                g = sqA
            if params.doppler:
                M = metric.m
                q = getattr(metric, "q", None)      # Reissner-Nordstrom
                vsq = (M - q * q / rr) / rr if q is not None else M / rr
                v = torch.clamp(torch.sqrt(vsq) / sqA, 0.0, 0.99)
                gamma = torch.rsqrt(1.0 - v * v)
                u_l = p_l * sqA
                u_psi = b / rr
                inv = torch.rsqrt(u_l * u_l + u_psi * u_psi + 1e-30)
                cos_xi = (u_psi * inv) * nz * params.spin_sign
                g = g / (gamma * (1.0 - v * cos_xi))
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
            out = [w * chroma[..., 0], w * chroma[..., 1],
                   w * chroma[..., 2]]
            if scat is not None:
                out = [o + sc for o, sc in zip(out, scat)]
            return dtau, out
        emis = (params.r_inner / rr) ** params.emissivity_index
        w = trans * base * emis * torch.clamp(g, 0.0, 4.0) ** 3
        if scat is not None:
            # coloured scattering: the tint folds in per channel
            return dtau, [w * scatter_block[c] + scat[c] for c in range(3)]
        return dtau, [w, w, w]

    u = torch.cos(psi)
    v = torch.sin(psi)
    zeros = torch.zeros_like(l)
    tau = zeros
    em = [zeros, zeros, zeros]
    sign = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % pl._CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        active = sign == 0
        dte = torch.where(active, dt, torch.zeros_like(dt))
        dl, dpsi, dpl = pl.planar_rhs(metric, l, psi, p_l, b)
        l = l + dte * dl
        psi = psi + dte * dpsi
        p_l = p_l + dte * dpl
        du = dte * dpsi
        u, v = u - v * du, v + u * du
        zq = c1 * u + c2 * v
        dtau, dem = step_emission(l, p_l, zq, metric.r(l), tau)
        em = [e + dte * d for e, d in zip(em, dem)]
        tau = tau + dte * dtau
        sign = torch.where(active & (l > escape_radius), 1,
                           torch.where(active & (l < -escape_radius), -1,
                                       sign))
        if r_cap is not None:
            sign = torch.where(active & (l < r_cap), pl.CAPTURED, sign)
        # escape / capture this step wins over the opacity freeze
        sign = torch.where((sign == 0) & (tau > params.tau_max), OPAQUE_SIGN,
                           sign).to(torch.int32)
        steps = steps + active.to(torch.int32)
    return pl.PlanarResult(l, psi, p_l, sign, steps), tau, tuple(em)


def _volumetric_rgb(tau, em, params: DiskParams, dtype, scatter=False):
    """Colour and transmittance of the volumetric integral: the filmic
    exposure (blackbody) or the tint (tint mode) on the accumulated
    emission; ``scatter``: the march already folded the tint per channel."""
    emr, emg, emb = em
    if params.color_mode == "blackbody":
        rgb = 1.0 - torch.exp(-params.brightness
                              * torch.stack([emr, emg, emb], dim=-1))
    elif scatter:
        rgb = torch.clamp(params.brightness
                          * torch.stack([emr, emg, emb], dim=-1), 0.0, 1.0)
    else:
        tint = _rgb(params.tint, dtype, tau.device)
        rgb = torch.clamp(params.brightness * emr, 0.0, 1.0)[:, None] * tint
    return rgb, torch.exp(-tau)


def _disk_rgb(metric, r_hit, pl_hit, b, nz, params: DiskParams, dtype,
              starlight=None):
    """Emission colour and alpha of a disk crossing at radius r_hit (0 =
    none), with the gravitational redshift sqrt(A), the Doppler factor of
    the orbiting material and, for a slab, the chord through it."""
    r_hit = torch.abs(r_hit)      # planar hits are SIGNED (sheet = sign)
    rr = torch.clamp(r_hit, min=params.r_inner)
    g = torch.ones_like(r_hit)
    general = not pl._unit_lapse(metric)
    # a pixel without a hit has no colour whatever g and the chord are;
    # its photon speed is set to 1, so that a ray with b = 0 (the image
    # centre) gets a finite gradient (rsqrt and sqrt of ~0 overflow)
    hit = r_hit > 0.0
    A = (torch.clamp(metric.lapse(rr), 1e-3, 1.0) if general
         else torch.ones_like(rr))
    if general and (params.redshift or params.doppler):
        if params.redshift:
            g = torch.sqrt(A)
        if params.doppler:
            M = metric.m
            q = getattr(metric, "q", None)          # Reissner-Nordstrom
            vsq = (M - q * q / rr) / rr if q is not None else M / rr
            v = torch.sqrt(vsq) / torch.sqrt(A)
            v = torch.clamp(v, 0.0, 0.99)
            gamma = torch.rsqrt(1.0 - v * v)
            u_l = pl_hit * torch.sqrt(A)
            u_psi = b / rr
            inv = torch.rsqrt(torch.where(
                hit, u_l * u_l + u_psi * u_psi + 1e-30, 1.0))
            cos_xi = (u_psi * inv) * nz * params.spin_sign
            g = g / (gamma * (1.0 - v * cos_xi))
    path = None
    if params.thickness > 0.0:
        # chord through the slab in units of its thickness, 1/|cos xi_z|:
        # the crossing's z-velocity is u_psi sqrt(1 - nz^2)
        u_l = pl_hit * torch.sqrt(A)
        u_psi = b / rr
        speed = torch.sqrt(torch.where(hit, u_l * u_l + u_psi * u_psi,
                                       1.0))
        tz = torch.sqrt(torch.clamp(1.0 - nz * nz, 0.0, 1.0))
        zvel = torch.abs(u_psi) * tz
        cap = float(np.clip(1.0 / params.thickness, 1.0, 8.0))
        path = torch.clamp(speed / torch.clamp(zvel, min=1e-30), 1.0, cap)
    return _emission_rgb(r_hit, g, params, dtype, path=path,
                         starlight=starlight)


def _rk45_kw(dt, max_steps, escape_radius, rtol):
    """The DP5(4) march keywords of a render route: dt is the initial step
    and atol = rtol 1e-3, as in the JAX package."""
    return dict(dt0=dt, max_steps=max_steps, escape_radius=escape_radius,
                rtol=rtol, atol=rtol * 1e-3)


def _march_thin(metric, rays, c1, c2, *, stepper, rtol, dt, max_steps,
                escape_radius, r_inner, r_outer):
    """The thin-disk march of a render route: Euler by kernel #5 on a GPU
    and the XLA twin on the CPU; rk45 by kernel #4's disk tracker on a GPU
    and the XLA twin on the CPU."""
    cpu = rays.l.device.type == "cpu"
    if stepper == "rk45":
        march = march_planar_rk45 if cpu else march_planar_rk45_disk_cuda
        return march(metric, rays, c1=c1, c2=c2, disk=(r_inner, r_outer),
                     **_rk45_kw(dt, max_steps, escape_radius, rtol))
    march = march_planar_disk if cpu else march_planar_disk_cuda
    return march(metric, rays, c1, c2, dt=dt, max_steps=max_steps,
                 escape_radius=escape_radius, r_inner=r_inner,
                 r_outer=r_outer)


def _march_vol(metric, rays, c1, c2, nz, *, disk, scatter_block, stepper,
               rtol, dt, max_steps, escape_radius):
    """The volumetric march of a render route: Euler by kernel #6 on a GPU
    and the XLA twin on the CPU; rk45 by kernel #4's vol variant on a GPU
    and the XLA twin on the CPU."""
    cpu = rays.l.device.type == "cpu"
    if stepper == "rk45":
        march = march_planar_rk45 if cpu else march_planar_rk45_disk_cuda
        return march(metric, rays, c1=c1, c2=c2, nz=nz, vol_disk=disk,
                     scatter_block=scatter_block,
                     **_rk45_kw(dt, max_steps, escape_radius, rtol))
    kw = dict(dt=dt, max_steps=max_steps, escape_radius=escape_radius,
              scatter_block=scatter_block)
    if cpu:
        return march_planar_disk_volumetric(metric, rays, c1, c2, nz,
                                            params=disk, **kw)
    return march_planar_disk_volumetric_cuda(metric, rays, c1, c2, nz,
                                             disk=disk, **kw)


def render_blackhole_disk(metric: Metric, camera: Camera,
                          bg: SphericalImage, *, dt=0.02, max_steps=100_000,
                          escape_radius=100.0, disk: DiskParams = None,
                          filtering="bilinear", stepper="euler", rtol=1e-5,
                          starlight_map=None, differentiable=None,
                          disk_theta=None):
    """(H, W, 3): lensed background + shadow + accretion disk (thin two-
    crossing, slab or volumetric, with optional starlight).  The march
    runs as a CUDA kernel when the inputs lie on a GPU and as the XLA
    twin on the CPU.  ``stepper='rk45'``: the error-controlled DP5(4)
    march at tolerance ``rtol`` (``dt`` the initial step, ``max_steps``
    accepted steps).  ``starlight_map``: a precomputed
    render/starlight.StarlightMap (camera-independent; None computes it
    in this call, with the same stepper, when the disk asks for
    starlight).

    ``differentiable='adjoint' | 'scan' | True`` makes the image
    differentiable through the march (module docstring; a differentiable
    volumetric starlit render needs ``starlight_map``), and
    ``disk_theta`` (a dict of tensors keyed by ``DIFF_DISK_KEYS``)
    overrides smooth disk parameters so that d(image)/d(brightness,
    kappa, r_inner, ...) flows.  The thin march records crossings in the
    static [disk.r_inner, disk.r_outer] band while the shader reads the
    overridden edges."""
    return render_disk_frames_batched(
        metric, [camera], bg, dt=dt, max_steps=max_steps,
        escape_radius=escape_radius, disk=disk, filtering=filtering,
        stepper=stepper, rtol=rtol, starlight_map=starlight_map,
        differentiable=differentiable, disk_theta=disk_theta)[0]


def render_disk_frames_batched(metric: Metric, cameras, bg: SphericalImage,
                               *, dt=0.02, max_steps=100_000,
                               escape_radius=100.0, disk: DiskParams = None,
                               filtering="bilinear", stepper="euler",
                               rtol=1e-5, starlight_map=None,
                               differentiable=None, disk_theta=None):
    """Several disk frames with ONE march -> (F, H, W, 3): all frames'
    rays in one bundle (the cameras must share a resolution).
    ``starlight_map``: see render_blackhole_disk (precompute it once per
    video)."""
    _check_route(stepper, differentiable)
    refuse_table(metric, "render_disk_frames_batched")
    cams = list(cameras)
    common_device(metric, bg, *cams)
    return _render_disk_impl(metric, cams, bg, dt, escape_radius,
                             starlight_map, max_steps=max_steps,
                             disk=disk or DiskParams(), filtering=filtering,
                             stepper=stepper, rtol=rtol,
                             differentiable=differentiable,
                             disk_theta=disk_theta)


def compute_starlight_map(metric: Metric, bg: SphericalImage,
                          disk: DiskParams, *, dt=0.02, max_steps=100_000,
                          escape_radius=100.0, filtering="bilinear",
                          stepper="euler", rtol=1e-5):
    """The camera-independent starlight map for ``disk`` around ``metric``
    under sky ``bg``: compute it once and pass it as ``starlight_map=`` to
    the disk renderers of every frame.  Its march is kernel #5 on a GPU
    (kernel #4's disk tracker with ``stepper='rk45'``)."""
    _check_route(stepper)
    refuse_table(metric, "compute_starlight_map")
    common_device(metric, bg)
    return _starlight_map(metric, bg, dt, escape_radius,
                          max_steps=max_steps, disk=disk, filtering=filtering,
                          stepper=stepper, rtol=rtol)


def _starlight_map(metric, bg, dt, escape_radius, *, max_steps, disk,
                   filtering, stepper, rtol):
    from curvis_tpu_torch.render.starlight import compute_disk_starlight_map
    n_r, n_phi = disk.starlight_grid
    return compute_disk_starlight_map(
        metric, bg, bg, r_inner=disk.r_inner, r_outer=disk.r_outer,
        escape_radius=escape_radius, dt=dt, max_steps=max_steps, n_r=n_r,
        n_phi=n_phi, n_samples=disk.starlight_samples, filtering=filtering,
        stepper=stepper, rtol=rtol, blueshift=disk.starlight_blueshift,
        shadow_params=disk if disk.starlight_self_shadow else None,
        two_sheet=disk.starlight_two_sheet)


def _march_adjoint(metric, state, planes, *, disk, disk_theta,
                   scatter_block, differentiable, stepper, rtol, dt,
                   max_steps, escape_radius):
    """The differentiable march of a render route
    (``integrate/planar_surface_adjoint.py``): 'adjoint' and True run the
    forward kernel (#5 or #6 for Euler, #4's surface variants for rk45) and
    the surface checkpoint kernels backward on a GPU, the twin pair on the
    CPU; 'scan' runs the twin pair on any device.  Returns (PlanarResult,
    extras) as the non-differentiable marches do."""
    from curvis_tpu_torch.integrate.planar_surface_adjoint import (
        march_planar_disk_adjoint, march_planar_vol_adjoint)
    c1, c2, nz = planes
    kw = dict(dt=dt, max_steps=max_steps, escape_radius=escape_radius,
              stepper=stepper,
              backend="twin" if differentiable == "scan" else "auto")
    if stepper == "rk45":
        kw.update(rtol=rtol, atol=rtol * 1e-3)
    if disk.volumetric:
        out = march_planar_vol_adjoint(metric, state[:3], state[3], c1, c2,
                                       nz, disk, disk_theta=disk_theta,
                                       scatter_block=scatter_block, **kw)
        return pl.PlanarResult(*out[:5]), out[5]
    out = march_planar_disk_adjoint(metric, state[:3], state[3], c1, c2,
                                    r_inner=disk.r_inner,
                                    r_outer=disk.r_outer, **kw)
    return pl.PlanarResult(*out[:5]), out[5]


def _render_disk_impl(metric, cams, bg, dt, escape_radius, smap, *,
                      max_steps, disk, filtering, stepper, rtol,
                      differentiable=None, disk_theta=None):
    from curvis_tpu_torch.render.starlight import (hit_phi_side,
                                                   starlight_lookup,
                                                   starlight_scatter_block)
    W, H = cams[0].resolution_x, cams[0].resolution_y
    F = len(cams)
    (l, psi, p_l, b), r_hat, e2 = _spawn_frames(metric, cams)
    dtype = l.dtype
    # world z-components of each ray's in-plane basis (e1 = r_hat, e2), and
    # the photon plane normal's n_z = e1x e2y - e1y e2x
    c1, c2 = r_hat[2], e2[2]
    nz = r_hat[0] * e2[1] - r_hat[1] * e2[0]
    rays = pl.PlanarRays(l, psi, p_l, b, None, None)
    kw = dict(dt=dt, max_steps=max_steps, escape_radius=escape_radius,
              stepper=stepper, rtol=rtol)
    # the shading reads the overrides; the thin march keeps the static band
    shade = disk_view(disk, disk_theta)
    if disk.starlight and smap is None:
        if differentiable and disk.volumetric:
            raise ValueError(
                "differentiable volumetric starlight needs a precomputed "
                "starlight_map= (the map is data to the gradient: compute "
                "it once with compute_starlight_map)")
        smap = _starlight_map(metric, bg, dt, escape_radius,
                              max_steps=max_steps, disk=disk,
                              filtering=filtering, stepper=stepper,
                              rtol=rtol)
    scatter_block = (starlight_scatter_block(smap, shade, dtype)
                     if disk.starlight and disk.volumetric else None)
    if differentiable:
        res, extra = _march_adjoint(
            metric, (l, psi, p_l, b), (c1, c2, nz), disk=disk,
            disk_theta=disk_theta, scatter_block=scatter_block,
            differentiable=differentiable, stepper=stepper, rtol=rtol,
            dt=dt, max_steps=max_steps, escape_radius=escape_radius)
        if disk.volumetric:
            tau, em = extra
        else:
            h1, h2 = extra
    elif disk.volumetric:
        res, tau, em = _march_vol(metric, rays, c1, c2, nz, disk=disk,
                                  scatter_block=scatter_block, **kw)
    else:
        res, h1, h2 = _march_thin(metric, rays, c1, c2,
                                  r_inner=disk.r_inner,
                                  r_outer=disk.r_outer, **kw)
    # the background: the render routes' readout and two-sky shading, with
    # the one sky on both sides, in ray order
    wx, wy, wz = _readout(metric, res, b, r_hat, e2)
    bg_colors = _shade_two_skies(bg, bg, wx, wy, wz, res.sign, filtering)
    if disk.volumetric:
        rgb, trans = _volumetric_rgb(tau, em, shade, dtype,
                                     scatter=disk.starlight)
        out = torch.clamp(rgb + trans[:, None] * bg_colors, 0.0, 1.0)
        return out.reshape(F, W, H, 3).permute(0, 2, 1, 3)
    star1 = star2 = None
    if disk.starlight:
        albedo = _rgb(shade.albedo, dtype, l.device)[None, :]
        phi1, side1 = hit_phi_side(h1[0], h1[2], b, c1, c2, r_hat, e2)
        phi2, side2 = hit_phi_side(h2[0], h2[2], b, c1, c2, r_hat, e2)
        star1 = albedo * starlight_lookup(smap, h1[0], phi1, side1)
        star2 = albedo * starlight_lookup(smap, h2[0], phi2, side2)
    rgb1, a1 = _disk_rgb(metric, h1[0], h1[1], b, nz, shade, dtype,
                         starlight=star1)
    rgb2, a2 = _disk_rgb(metric, h2[0], h2[1], b, nz, shade, dtype,
                         starlight=star2)
    # composite: hit1 over hit2 over background
    behind = rgb2 * a2[:, None] + bg_colors * (1.0 - a2[:, None])
    out = rgb1 * a1[:, None] + behind * (1.0 - a1[:, None])
    out = torch.clamp(out, 0.0, 1.0)
    return out.reshape(F, W, H, 3).permute(0, 2, 1, 3)

