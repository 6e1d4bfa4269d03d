"""Structure-of-arrays planar render pipeline (PyTorch).

Counterpart of ``curvis_tpu/render/fast.py``: pixel rays, planar spawn,
march, world-direction readout and the two-sky texture lookup, with every
vector quantity as three (N,) tensors.  The march goes through
``ops/march_cuda.py:march_planar_cuda`` — the CUDA kernel for CUDA tensors,
the plain PyTorch march for CPU tensors.  Everything runs on the device of
the inputs; inputs on different devices raise.

Rays are numbered column-major like the reference, idx = x * H + y, so the
flat colours reshape to (W, H, 3) and transpose to the (H, W, 3) image.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from curvis_tpu_torch.camera.camera import (Camera, aberrate_directions,
                                            camera_rotation)
from curvis_tpu_torch.env.spherical_image import SphericalImage
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops.march_cuda import march_planar_cuda
from curvis_tpu_torch.physics.planar import (PlanarRays, _unit_lapse,
                                             check_stepper)
from curvis_tpu_torch.utils.device import common_device


def _pixel_dirs_soa(camera: Camera, center_pixels=False):
    """World-space unit ray directions as three (W*H,) tensors."""
    dtype, dev = camera.position.dtype, camera.device
    W, H = camera.resolution_x, camera.resolution_y
    off = 0.5 if center_pixels else 0.0
    xs = torch.arange(W, dtype=dtype, device=dev) + off
    ys = torch.arange(H, dtype=dtype, device=dev) + off
    wfrac = xs / W - 0.5
    hfrac = 0.5 - ys / H
    aspect = W / H
    sh = torch.sqrt(camera.sensor_diagonal ** 2 / (aspect * aspect + 1.0))
    sw = aspect * sh
    vx = camera.focal_length.expand(W, H)
    vy = (-sw * wfrac)[:, None].expand(W, H)
    vz = (sh * hfrac)[None, :].expand(W, H)
    inv = torch.rsqrt(vx * vx + vy * vy + vz * vz)
    vx, vy, vz = vx * inv, vy * inv, vz * inv
    R = camera_rotation(camera)
    dx = R[0, 0] * vx + R[0, 1] * vy + R[0, 2] * vz
    dy = R[1, 0] * vx + R[1, 1] * vy + R[1, 2] * vz
    dz = R[2, 0] * vx + R[2, 1] * vy + R[2, 2] * vz
    return dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)


def _spawn_planar_soa(metric: Metric, camera: Camera, dx, dy, dz):
    """Planar decomposition with scalar camera geometry ->
    ((l, psi, p_l, b), r_hat, e2); the r_hat components are 0-d, the rest
    (N,)."""
    pos = camera.position
    l0, th, ph = pos[1], pos[2], pos[3]
    st, ct = torch.sin(th), torch.cos(th)
    sp, cp = torch.sin(ph), torch.cos(ph)
    rx, ry, rz = st * cp, st * sp, ct                     # r_hat (0-d)
    cos_a = torch.clamp(dx * rx + dy * ry + dz * rz, -1.0, 1.0)
    nx = ry * dz - rz * dy
    ny = rz * dx - rx * dz
    nz = rx * dy - ry * dx
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    # radial rays: any plane through r_hat works (b = 0), use theta_hat;
    # the degeneracy is gated on the computed cross norm, not on sin_a
    fx, fy, fz = ct * cp, ct * sp, -st
    n2 = nx * nx + ny * ny + nz * nz
    deg = n2 < 1e-12
    nn = torch.rsqrt(torch.where(deg, torch.ones_like(n2), n2))
    nx = torch.where(deg, fx, nx * nn)
    ny = torch.where(deg, fy, ny * nn)
    nz = torch.where(deg, fz, nz * nn)
    e2x = ny * rz - nz * ry
    e2y = nz * rx - nx * rz
    e2z = nx * ry - ny * rx
    b = sin_a * metric.r(l0)
    p_l0 = cos_a
    if not _unit_lapse(metric):
        A0 = metric.lapse(l0)
        B0 = metric.radial_B(l0)
        p_l0 = cos_a * torch.sqrt(B0 / A0)
        b = b / torch.sqrt(A0)
    l = torch.full_like(cos_a, 1.0) * l0
    psi = torch.zeros_like(cos_a)
    return (l, psi, p_l0, b), (rx, ry, rz), (e2x, e2y, e2z)


def _texture_uv(img: SphericalImage, wx, wy, wz):
    """Continuous equirect coordinates (u, v) in [0, 1) from world
    directions: rotate into image space with R^T, then
    u = (0.5 - phi / 2 pi) mod 1, v = theta / pi."""
    R = img.rotation
    ix = R[0, 0] * wx + R[1, 0] * wy + R[2, 0] * wz
    iy = R[0, 1] * wx + R[1, 1] * wy + R[2, 1] * wz
    iz = R[0, 2] * wx + R[1, 2] * wy + R[2, 2] * wz
    inv = torch.rsqrt(ix * ix + iy * iy + iz * iz)
    theta = torch.arccos(torch.clamp(iz * inv, -1.0, 1.0))
    phi = torch.atan2(iy, ix)
    u = torch.remainder(0.5 - phi / (2.0 * math.pi), 1.0)
    v = theta / math.pi
    return u, v


def _filter_lookup(rows, base, u, v, W, H, filtering):
    """Gather from (M, 3) texture rows at per-ray page offset ``base`` +
    (u, v).  Nearest truncates; bilinear wraps horizontally and reflects at
    the poles (a row beyond a pole is the same row half a turn around)."""
    if filtering == "nearest":
        xi = torch.clamp((u * W).to(torch.int64), 0, W - 1)
        yi = torch.clamp((v * H).to(torch.int64), 0, H - 1)
        return rows[base + yi * W + xi]                    # (N, 3)
    if filtering != "bilinear":
        raise ValueError(f"unknown filtering {filtering!r}")
    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wxf = (fx - x0)[:, None]
    wyf = (fy - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), W)
    x1i = torch.remainder(x0i + 1, W)

    def pole(yr):
        over = (yr < 0) | (yr > H - 1)
        yc = torch.clamp(torch.where(yr < 0, -1 - yr, 2 * H - 1 - yr),
                         0, H - 1)
        yc = torch.where(over, yc, yr)
        xs = torch.where(over, W // 2, 0)
        return yc, xs

    y0r = y0.to(torch.int64)
    y0c, xs0 = pole(y0r)
    y1c, xs1 = pole(y0r + 1)
    x0t = torch.remainder(x0i + xs0, W)
    x1t = torch.remainder(x1i + xs0, W)
    x0b = torch.remainder(x0i + xs1, W)
    x1b = torch.remainder(x1i + xs1, W)
    y0i = base + y0c * W
    y1i = base + y1c * W
    top = rows[y0i + x0t] * (1.0 - wxf) + rows[y0i + x1t] * wxf
    bot = rows[y1i + x0b] * (1.0 - wxf) + rows[y1i + x1b] * wxf
    return top * (1.0 - wyf) + bot * wyf


def _shade_soa(img: SphericalImage, wx, wy, wz, filtering):
    u, v = _texture_uv(img, wx, wy, wz)
    rows = img.texture.reshape(-1, 3)
    return _filter_lookup(rows, torch.zeros_like(u, dtype=torch.int64), u, v,
                          img.width, img.height, filtering)


def _shade_two_skies(bg_positive, bg_negative, wx, wy, wz, sign, filtering):
    """(N, 3) colours: the positive sky for sign +1, the negative sky for
    sign -1, black for rays that did not escape (0) or were captured (2)."""
    if bg_positive.texture.shape == bg_negative.texture.shape:
        # one gather from the concatenated [positive; negative] rows
        up, vp = _texture_uv(bg_positive, wx, wy, wz)
        un, vn = _texture_uv(bg_negative, wx, wy, wz)
        neg = sign == -1
        u = torch.where(neg, un, up)
        v = torch.where(neg, vn, vp)
        H, W = bg_positive.height, bg_positive.width
        rows = torch.cat([bg_positive.texture.reshape(-1, 3),
                          bg_negative.texture.reshape(-1, 3)])
        base = torch.where(neg, H * W, 0).to(torch.int64)
        colors = _filter_lookup(rows, base, u, v, W, H, filtering)
    else:
        pos_rgb = _shade_soa(bg_positive, wx, wy, wz, filtering)
        neg_rgb = _shade_soa(bg_negative, wx, wy, wz, filtering)
        colors = torch.where((sign == 1)[:, None], pos_rgb, neg_rgb)
    lit = (sign == 1) | (sign == -1)
    return torch.where(lit[:, None], colors, torch.zeros_like(colors))


def _readout(metric, res, b, r_hat, e2):
    """World escape directions w = cos(beta) r_hat + sin(beta) e2 with
    beta = psi + atan2(b / r, u_l), componentwise -> (wx, wy, wz)."""
    rx, ry, rz = r_hat
    e2x, e2y, e2z = e2
    u_l = res.p_l
    if not _unit_lapse(metric):
        u_l = u_l * torch.sqrt(metric.lapse(res.l))
    beta = res.psi + torch.atan2(b / metric.r(res.l), u_l)
    cb, sb = torch.cos(beta), torch.sin(beta)
    return (cb * rx + sb * e2x, cb * ry + sb * e2y, cb * rz + sb * e2z)


def _finish_render(metric, camera, bg_positive, bg_negative, state, r_hat,
                   e2, *, dt, max_steps, escape_radius, filtering, stepper,
                   n_frames):
    """March + readout + shade + image assembly.  ``r_hat``/``e2``
    components may be 0-d (one frame) or (N,) (frame batches)."""
    l, psi, p_l, b = state
    unused = torch.zeros((1, 3), dtype=l.dtype, device=l.device)
    rays = PlanarRays(l=l, psi=psi, p_l=p_l, b=b, r_hat=unused, e2=unused)
    res = march_planar_cuda(metric, rays, dt=dt, max_steps=max_steps,
                            escape_radius=escape_radius, stepper=stepper)
    wx, wy, wz = _readout(metric, res, b, r_hat, e2)
    colors = _shade_two_skies(bg_positive, bg_negative, wx, wy, wz, res.sign,
                              filtering)
    W, H = camera.resolution_x, camera.resolution_y
    if n_frames == 1:
        return colors.reshape(W, H, 3).permute(1, 0, 2)
    return colors.reshape(n_frames, W, H, 3).permute(0, 2, 1, 3)


def _spawn_frames(metric, cams, center_pixels=False):
    """One ray bundle of all frames: (l, psi, p_l, b), r_hat and e2, each
    component (F*W*H,), frame after frame."""
    W, H = cams[0].resolution_x, cams[0].resolution_y
    if any((c.resolution_x, c.resolution_y) != (W, H) for c in cams):
        raise ValueError("all cameras in a batch must share a resolution")
    per = []
    for cam in cams:
        dx, dy, dz = _pixel_dirs_soa(cam, center_pixels)
        per.append(_spawn_planar_soa(metric, cam, dx, dy, dz))
    n = W * H

    def chain(idx, comp):
        return torch.cat([p[idx][comp].expand(n) for p in per])

    state = tuple(chain(0, i) for i in range(4))
    r_hat = tuple(chain(1, i) for i in range(3))
    e2 = tuple(chain(2, i) for i in range(3))
    return state, r_hat, e2


def render_frames_batched(metric: Metric, cameras, bg_positive: SphericalImage,
                          bg_negative: SphericalImage, *, dt, max_steps,
                          escape_radius, filtering="nearest",
                          center_pixels=False, stepper="euler"):
    """Render several camera poses with ONE march -> (F, H, W, 3).  All
    frames' rays are concatenated into a single bundle; the cameras must
    share a resolution."""
    check_stepper(stepper)
    cams = list(cameras)
    common_device(metric, bg_positive, bg_negative, *cams)
    state, r_hat, e2 = _spawn_frames(metric, cams, center_pixels)
    return _finish_render(metric, cams[0], bg_positive, bg_negative, state,
                          r_hat, e2, dt=dt, max_steps=max_steps,
                          escape_radius=escape_radius, filtering=filtering,
                          stepper=stepper, n_frames=len(cams))


def _render_one(metric, camera, bg_positive, bg_negative, *, dt, max_steps,
                escape_radius, filtering, center_pixels, stepper,
                camera_velocity):
    dx, dy, dz = _pixel_dirs_soa(camera, center_pixels)
    delta = None
    if camera_velocity is not None:
        # special-relativistic aberration of the pixel directions + delta^3
        # surface-brightness scaling of the received field
        dx, dy, dz, delta = aberrate_directions(dx, dy, dz, camera_velocity)
    state, r_hat, e2 = _spawn_planar_soa(metric, camera, dx, dy, dz)
    img = _finish_render(metric, camera, bg_positive, bg_negative, state,
                         r_hat, e2, dt=dt, max_steps=max_steps,
                         escape_radius=escape_radius, filtering=filtering,
                         stepper=stepper, n_frames=1)
    if delta is not None:
        W, H = camera.resolution_x, camera.resolution_y
        boost = (delta ** 3).reshape(W, H).T[..., None]
        img = torch.clamp(img * boost, 0.0, 1.0)
    return img


def render_planar_fast(metric: Metric, camera: Camera,
                       bg_positive: SphericalImage,
                       bg_negative: SphericalImage, *, dt, max_steps,
                       escape_radius, filtering="nearest",
                       center_pixels=False, stepper="euler", supersample=1,
                       camera_velocity=None):
    """(H, W, 3) image.  The march runs as the CUDA kernel when the inputs
    lie on a GPU and as the plain PyTorch march when they lie on the CPU.

    ``supersample=k`` renders k x k centred rays per pixel and box-filters.
    ``camera_velocity`` (3-velocity, fraction of c) applies aberration and
    Doppler brightness.

    f32 caveat: rays crossing the throat amplify rounding differences
    exponentially, so f32 images of two implementations differ in the
    lensed-disk band; compare f64 on the CPU for parity."""
    check_stepper(stepper)
    dev = common_device(metric, camera, bg_positive, bg_negative)
    if camera_velocity is not None:
        camera_velocity = torch.as_tensor(
            camera_velocity, dtype=camera.position.dtype, device=dev)
    kw = dict(dt=dt, max_steps=max_steps, escape_radius=escape_radius,
              filtering=filtering, stepper=stepper,
              camera_velocity=camera_velocity)
    if supersample > 1:
        k = int(supersample)
        big = dataclasses.replace(camera,
                                  resolution_x=camera.resolution_x * k,
                                  resolution_y=camera.resolution_y * k)
        img = _render_one(metric, big, bg_positive, bg_negative,
                          center_pixels=True, **kw)
        H, W = camera.resolution_y, camera.resolution_x
        return img.reshape(H, k, W, k, 3).mean(dim=(1, 3))
    return _render_one(metric, camera, bg_positive, bg_negative,
                       center_pixels=center_pixels, **kw)
