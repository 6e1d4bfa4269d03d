"""Fused render: camera ray + planar spawn + march + world-direction
readout in one CUDA kernel (``csrc/render_fused.cu``), then the two-sky
texture gather in PyTorch.  The Euler march replaces
``curvis_tpu/ops/render_fused.py``'s ``_fused_kernel``, the adaptive DP5(4)
march (``stepper='rk45'``) its ``_fused_rk45_kernel``.

``fused_directions`` launches the kernel for a camera on a GPU and runs
``render_planar_fused_plain``, the plain PyTorch version of the same spawn +
march + readout, for a camera on the CPU.  A CUDA camera never falls back
to the plain version: a failure to build or launch raises.
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.camera.camera import Camera, camera_rotation
from curvis_tpu_torch.env.spherical_image import SphericalImage
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.march_cuda import KINDS, march_scalars
from curvis_tpu_torch.ops.rk45_cuda import march_planar_rk45_plain
from curvis_tpu_torch.physics.planar import (PlanarRays, _unit_lapse,
                                             check_stepper,
                                             march_planar_while)
from curvis_tpu_torch.render.fast import _shade_two_skies
from curvis_tpu_torch.utils.device import common_device

launches = {"euler": 0, "rk45": 0}   # kernel launches since a reset

RK45_UNROLL = 2          # the JAX kernel's unroll, which rounds max_iters up


def _fused_row(metric: Metric, camera: Camera, dt, escape_radius):
    """(kind, row): the 29 float32 scalars of one camera in the layout of
    curvis::FusedScalars — [dt, R, p0, p1, p2, r_cap, focal, sw, sh, 1/W,
    1/H, camera rotation (row-major), r_hat, theta_hat, l0, s_pl, s_b]."""
    kind, head = march_scalars(metric, dt, escape_radius)
    f32 = torch.float32
    pos = camera.position.to(f32)
    W, H = camera.resolution_x, camera.resolution_y
    th, ph = pos[2], pos[3]
    st, ct = torch.sin(th), torch.cos(th)
    sp, cp = torch.sin(ph), torch.cos(ph)
    rot = camera_rotation(camera).to(f32)
    aspect = W / H
    sh = torch.sqrt(camera.sensor_diagonal.to(f32) ** 2
                    / (aspect * aspect + 1.0))
    sw = aspect * sh
    l0 = pos[1]
    if _unit_lapse(metric):
        s_pl = torch.ones_like(l0)
        s_b = metric.r(l0)
    else:
        A0 = metric.lapse(l0)
        s_pl = torch.sqrt(metric.radial_B(l0) / A0)
        s_b = metric.r(l0) / torch.sqrt(A0)
    cam = [camera.focal_length, sw, sh, torch.ones_like(l0) / W,
           torch.ones_like(l0) / H, *rot.reshape(-1),
           st * cp, st * sp, ct,                       # r_hat
           ct * cp, ct * sp, -st,                      # theta_hat
           l0, s_pl, s_b]
    tail = torch.stack([t.detach().to(f32).reshape(()) for t in cam])
    return kind, head + tail.cpu().tolist()


def _rk45_tail(rtol, atol, dt_max, max_steps, max_iters):
    """([rtol, atol, dt_max], the per-ray iteration cap) of the JAX fused
    rk45 path: atol defaults to rtol * 1e-3, max_iters to 4 max_steps,
    rounded up to a multiple of RK45_UNROLL."""
    if atol is None:
        atol = rtol * 1e-3
    mi = 4 * max_steps if max_iters is None else int(max_iters)
    mi += (RK45_UNROLL - mi % RK45_UNROLL) % RK45_UNROLL
    return [float(rtol), float(atol), float(dt_max)], mi


def render_planar_fused_plain(metric: Metric, camera: Camera, *, dt,
                              max_steps, escape_radius, stepper="euler",
                              rtol=1e-4, atol=None, dt_max=10.0,
                              max_iters=None):
    """Plain PyTorch version of the fused kernels on any device:
    (wx, wy, wz, sign), each (W*H,) in pixel order idx = x * H + y.  With
    ``stepper='rk45'`` ``dt`` is the initial step and the march is
    ``ops/rk45_cuda.py:march_planar_rk45_plain``."""
    check_stepper(stepper, ("euler", "rk45"))
    dev = common_device(metric, camera)
    kind, row = _fused_row(metric, camera, dt, escape_radius)
    s = torch.tensor(row, dtype=torch.float32, device=dev)
    W, H = camera.resolution_x, camera.resolution_y
    n = W * H
    focal, sw, sh, inv_w, inv_h = s[6], s[7], s[8], s[9], s[10]
    rot = s[11:20].reshape(3, 3)
    rx, ry, rz = s[20], s[21], s[22]
    fx, fy, fz = s[23], s[24], s[25]
    l0, s_pl, s_b = s[26], s[27], s[28]

    idx = torch.arange(n, dtype=torch.int64, device=dev)
    xpix = idx // H
    ypix = idx - xpix * H
    wfrac = xpix.to(torch.float32) * inv_w - 0.5
    hfrac = 0.5 - ypix.to(torch.float32) * inv_h
    vx = focal.expand(n)
    vy = -sw * wfrac
    vz = sh * hfrac
    inv = 1.0 / torch.sqrt(vx * vx + vy * vy + vz * vz)
    vx, vy, vz = vx * inv, vy * inv, vz * inv
    dx = rot[0, 0] * vx + rot[0, 1] * vy + rot[0, 2] * vz
    dy = rot[1, 0] * vx + rot[1, 1] * vy + rot[1, 2] * vz
    dz = rot[2, 0] * vx + rot[2, 1] * vy + rot[2, 2] * vz

    cos_a = torch.clamp(dx * rx + dy * ry + dz * rz, -1.0, 1.0)
    nx = ry * dz - rz * dy
    ny = rz * dx - rx * dz
    nz = rx * dy - ry * dx
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    n2 = nx * nx + ny * ny + nz * nz
    deg = n2 < 1e-12
    nn = 1.0 / torch.sqrt(torch.where(deg, torch.ones_like(n2), n2))
    nx = torch.where(deg, fx, nx * nn)
    ny = torch.where(deg, fy, ny * nn)
    nz = torch.where(deg, fz, nz * nn)
    e2x = ny * rz - nz * ry
    e2y = nz * rx - nx * rz
    e2z = nx * ry - ny * rx
    p_l = cos_a * s_pl
    b = sin_a * s_b
    l, psi = l0.expand(n), torch.zeros_like(p_l)
    if stepper == "rk45":
        tail, mi = _rk45_tail(rtol, atol, dt_max, max_steps, max_iters)
        l, psi, p_l, sign, _, _ = march_planar_rk45_plain(
            kind, row[:6] + tail, l, psi, p_l, b, max_steps=max_steps,
            max_iters=mi)
    else:
        unused = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        res = march_planar_while(
            metric, PlanarRays(l=l, psi=psi, p_l=p_l, b=b, r_hat=unused,
                               e2=unused),
            dt=row[0], max_steps=max_steps, escape_radius=row[1])
        l, psi, p_l, sign = res.l, res.psi, res.p_l, res.sign

    # readout with the kernel's clamps: lapse >= 1e-6, |u|^2 >= 1e-30
    if kind == "schwarzschild":
        u_l = p_l * torch.sqrt(torch.clamp(1.0 - 2.0 * s[2] / l, min=1e-6))
    elif kind == "rn":
        A = 1.0 - (2.0 * s[2] - s[3] / l) / l
        u_l = p_l * torch.sqrt(torch.clamp(A, min=1e-6))
    else:
        u_l = p_l
    r = metric.r(l) if kind in ("ellis", "interstellar") else torch.abs(l)
    u_psi = b / r
    invu = 1.0 / torch.sqrt(torch.clamp(u_l * u_l + u_psi * u_psi,
                                        min=1e-30))
    cg = u_l * invu
    sg = u_psi * invu
    cp, sp = torch.cos(psi), torch.sin(psi)
    cb = cp * cg - sp * sg
    sb = sp * cg + cp * sg
    return (cb * rx + sb * e2x, cb * ry + sb * e2y, cb * rz + sb * e2z,
            sign)


def fused_directions(metric: Metric, camera: Camera, *, dt, max_steps,
                     escape_radius, stepper="euler", rtol=1e-4, atol=None,
                     dt_max=10.0, max_iters=None):
    """(wx, wy, wz, sign) of every pixel, (W*H,) each: the CUDA kernel of
    ``stepper`` for a camera on a GPU, the plain version for a camera on
    the CPU."""
    check_stepper(stepper, ("euler", "rk45"))
    rk45 = dict(rtol=rtol, atol=atol, dt_max=dt_max, max_iters=max_iters)
    dev = common_device(metric, camera)
    if dev.type == "cpu":
        return render_planar_fused_plain(metric, camera, dt=dt,
                                         max_steps=max_steps,
                                         escape_radius=escape_radius,
                                         stepper=stepper, **rk45)
    if dev.type != "cuda":
        raise ValueError(f"fused_directions: unsupported device {dev}")
    if camera.position.dtype != torch.float32:
        raise TypeError("fused kernel takes a float32 camera, got "
                        f"{camera.position.dtype}")
    kind, row = _fused_row(metric, camera, dt, escape_radius)
    W, H = camera.resolution_x, camera.resolution_y
    if stepper == "rk45":
        tail, mi = _rk45_tail(rtol, atol, dt_max, max_steps, max_iters)
        return launch_rk45(kind, row + tail, W, H, max_steps, mi, dev)
    return launch(kind, row, W, H, max_steps, dev)


def _outputs(n, dev):
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(3)]
    outs.append(torch.empty(n, dtype=torch.int32, device=dev))
    return outs


def launch(kind, row, W, H, max_steps, dev):
    """One Euler kernel launch for a W x H camera with the host scalars of
    ``_fused_row`` on CUDA device ``dev`` -> (wx, wy, wz, sign)."""
    n = W * H
    outs = _outputs(n, dev)
    lib = _build.load_library()
    host = _build.host_floats(row)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_render_fused(KINDS[kind], host, len(row),
                                  *(o.data_ptr() for o in outs), H, n,
                                  int(max_steps), dev.index, stream)
    _build.check(lib, err, "render_fused_kernel")
    launches["euler"] += 1
    return tuple(outs)


def launch_rk45(kind, row, W, H, max_steps, max_iters, dev):
    """One rk45 kernel launch for a W x H camera: ``row`` is the row of
    ``_fused_row`` followed by [rtol, atol, dt_max] -> (wx, wy, wz,
    sign)."""
    n = W * H
    outs = _outputs(n, dev)
    lib = _build.load_library()
    host = _build.host_floats(row)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_render_fused_rk45(KINDS[kind], host, len(row),
                                       *(o.data_ptr() for o in outs), H, n,
                                       int(max_steps), int(max_iters),
                                       dev.index, stream)
    _build.check(lib, err, "render_fused_rk45_kernel")
    launches["rk45"] += 1
    return tuple(outs)


def render_planar_fused(metric: Metric, camera: Camera,
                        bg_positive: SphericalImage,
                        bg_negative: SphericalImage, *, dt, max_steps,
                        escape_radius, filtering="nearest", stepper="euler",
                        rtol=1e-4, atol=None, dt_max=10.0, max_iters=None):
    """(H, W, 3) image: spawn + march + readout in one kernel, then one
    gather from the two skies, which must have equal shapes.  The march
    runs in float32 whatever the inputs' dtype, as the kernel does.

    ``stepper='rk45'`` (the JAX package's quality mode) marches with the
    adaptive DP5(4) kernel: ``dt`` is the initial step, ``max_steps``
    counts accepted steps, the error is bounded by ``rtol`` and ``atol``
    (default rtol * 1e-3), dt grows at most to ``dt_max``, and each ray
    takes at most ``max_iters`` iterations (default 4 max_steps, rounded
    up to even as in the JAX package)."""
    check_stepper(stepper, ("euler", "rk45"))
    common_device(metric, camera, bg_positive, bg_negative)
    if bg_positive.texture.shape != bg_negative.texture.shape:
        raise ValueError("fused renderer requires equal background shapes")
    wx, wy, wz, sign = fused_directions(metric, camera, dt=dt,
                                        max_steps=max_steps,
                                        escape_radius=escape_radius,
                                        stepper=stepper, rtol=rtol,
                                        atol=atol, dt_max=dt_max,
                                        max_iters=max_iters)
    colors = _shade_two_skies(bg_positive, bg_negative, wx, wy, wz, sign,
                              filtering)
    W, H = camera.resolution_x, camera.resolution_y
    return colors.reshape(W, H, 3).permute(1, 0, 2)
