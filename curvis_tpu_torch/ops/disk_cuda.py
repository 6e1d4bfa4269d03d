"""Planar Euler march with disk-crossing capture on the GPU: wrapper of the
CUDA kernel ``csrc/disk.cu`` (replacing ``curvis_tpu/ops/march_pallas.py``'s
``_disk_kernel``), and its plain PyTorch version.

``march_planar_disk_cuda`` has the contract of the JAX package's
``march_planar_disk_pallas`` (without its TPU tiling): the kernel for CUDA
tensors (float32), the plain version for CPU tensors.  A CUDA tensor never
falls back to the plain version: a failure to build or launch raises.

``march_planar_disk_plain`` transcribes the kernel's arithmetic, which is
the TPU kernel's: the crossing is detected and interpolated on
zq = c1 u + c2 v without r(l) (``render/disk.py:march_planar_disk``, the
XLA twin and the render routes' CPU march, uses z = r(l) zq, so its
crossing fractions and hit radii differ from these at ~1e-3 in float32),
psi at the hit is psi + frac du, and a hit accumulates as
h + new * value.  The lock-step loop masks every ray that has ended, so
an ended ray never changes, as in the kernel's per-thread loop.

A tabulated metric (``metrics/table.py``) runs as the kind
``ops/table_cuda.py:TableKind``: the kernel takes its ``ChebTable`` beside
the row, and the plain version evaluates its series in the kernel's order
(``ops/table_cuda.py:table_shape``).
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.ckpt_adjoint_cuda import planar_deriv
from curvis_tpu_torch.ops.march_cuda import KINDS, march_scalars
from curvis_tpu_torch.ops.table_cuda import kernel_table, slot_params
from curvis_tpu_torch.physics.planar import (_CHECK_EVERY, PlanarResult,
                                             PlanarRays)
from curvis_tpu_torch.utils.device import common_device

LAPSE_KINDS = ("schwarzschild", "rn")   # the kinds that capture photons

launches = 0             # kernel launches since the last reset


def disk_scalars(metric: Metric, dt, escape_radius, r_inner, r_outer):
    """(kind, [dt, R, p0, p1, p2, r_cap, r_in, r_out]) as Python floats:
    the layout of curvis::DiskScalars (a table: TableKind, s^2 in p0)."""
    kind, head = march_scalars(metric, dt, escape_radius)
    return kind, head + [float(r_inner), float(r_outer)]


def step_sign(kind, alive, l, R, r_cap, sign):
    """The sign after a step of the live rays: +1 beyond +R, -1 beyond -R,
    2 below the capture radius (lapse kinds), in that order."""
    new = torch.where(l > R, 1, torch.where(l < -R, -1, 0))
    if kind in LAPSE_KINDS:
        new = torch.where((new == 0) & (l < r_cap), 2, new)
    return torch.where(alive, new, sign).to(torch.int32)


def march_planar_disk_plain(kind, scal, l, psi, p_l, b, c1, c2, *,
                            max_steps):
    """Plain version of kernel #5 on rays of any dtype and device, with the
    scalar row of ``disk_scalars`` -> (l, psi, p_l, sign, steps, h1, h1p,
    h1s, h2, h2p, h2s)."""
    row = torch.tensor(scal, dtype=l.dtype, device=l.device)
    dt, R, r_cap, r_in, r_out = row[0], row[1], row[5], row[6], row[7]
    p = slot_params(kind, row)
    u, v = torch.cos(psi), torch.sin(psi)
    zq = c1 * u + c2 * v
    hits = [torch.zeros_like(l) for _ in range(6)]
    sign = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    steps = torch.zeros_like(sign)
    for it in range(max_steps):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        alive = sign == 0
        dl, dpsi, dpl = planar_deriv(kind, p, l, p_l, b)
        l1 = l + dt * dl
        pl1 = p_l + dt * dpl
        du = dt * dpsi
        u1 = u - v * du
        v1 = v + u * du
        zq1 = c1 * u1 + c2 * v1
        crossed = zq * zq1 < 0.0
        # torch.clamp propagates NaN, as the kernel's max_nan
        frac = torch.abs(zq) / torch.clamp(torch.abs(zq) + torch.abs(zq1),
                                           min=1e-30)
        lh = l + frac * (l1 - l)
        r_hit = torch.abs(lh)
        in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
        pl_hit = p_l + frac * (pl1 - p_l)
        psi_hit = psi + frac * du
        h1, h2 = hits[0], hits[3]
        new1 = (in_disk & (h1 == 0.0)).to(l.dtype)
        new2 = (in_disk & (h1 != 0.0) & (h2 == 0.0)).to(l.dtype)
        for k, (new, val) in enumerate(((new1, lh), (new1, pl_hit),
                                        (new1, psi_hit), (new2, lh),
                                        (new2, pl_hit), (new2, psi_hit))):
            hits[k] = torch.where(alive, hits[k] + new * val, hits[k])
        l = torch.where(alive, l1, l)
        psi = torch.where(alive, psi + du, psi)
        p_l = torch.where(alive, pl1, p_l)
        u = torch.where(alive, u1, u)
        v = torch.where(alive, v1, v)
        zq = torch.where(alive, zq1, zq)
        sign = step_sign(kind, alive, l, R, r_cap, sign)
        steps = steps + alive.to(torch.int32)
    return (l, psi, p_l, sign, steps, *hits)


def march_planar_disk_cuda(metric: Metric, rays: PlanarRays, c1, c2, *, dt,
                           max_steps, escape_radius, r_inner, r_outer):
    """Euler march of ``rays`` recording the first two crossings of the
    equatorial band [r_inner, r_outer], with the contract of
    ``render/disk.py:march_planar_disk``: (PlanarResult, (h1, h1p, h1s),
    (h2, h2p, h2s)), h1 == 0 marking no hit and the hit coordinate signed
    (sign = sheet).  ``c1``, ``c2``: per-ray z-components of the
    orbital-plane basis.  The CUDA kernel for CUDA tensors (f32 only), the
    plain version for CPU tensors."""
    dev = common_device(metric, rays.l, rays.psi, rays.p_l, rays.b, c1, c2)
    kind, scal = disk_scalars(metric, dt, escape_radius, r_inner, r_outer)
    shape = rays.l.shape
    ins = [torch.broadcast_to(t, shape)
           for t in (rays.l, rays.psi, rays.p_l, rays.b, c1, c2)]
    if dev.type == "cpu":
        outs = march_planar_disk_plain(kind, scal, *ins, max_steps=max_steps)
    elif dev.type == "cuda":
        outs = launch(kind, scal, *(_flat_f32(t) for t in ins),
                      max_steps=max_steps)
        outs = [o.reshape(shape) for o in outs]
    else:
        raise ValueError(f"march_planar_disk_cuda: unsupported device {dev}")
    return (PlanarResult(*outs[:5]), tuple(outs[5:8]), tuple(outs[8:11]))


def _flat_f32(t):
    if t.dtype != torch.float32:
        raise TypeError(f"disk kernels take float32 rays, got {t.dtype}")
    return t.reshape(-1).contiguous()


def launch(kind, scal, l, psi, p_l, b, c1, c2, *, max_steps):
    """One kernel launch on flat contiguous float32 CUDA tensors of one
    device, with the host scalars of ``disk_scalars`` ->
    (l, psi, p_l, sign, steps, h1, h1p, h1s, h2, h2p, h2s)."""
    global launches
    n = l.numel()
    dev = l.device
    fout = torch.empty((9, n), dtype=torch.float32, device=dev)
    iout = torch.empty((2, n), dtype=torch.int32, device=dev)
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_march_disk(
        KINDS[kind], row, len(scal), _build.table_ptr(tab), l.data_ptr(),
        psi.data_ptr(), p_l.data_ptr(), b.data_ptr(), c1.data_ptr(),
        c2.data_ptr(), fout.data_ptr(), iout.data_ptr(), n, int(max_steps),
        dev.index, stream)
    _build.check(lib, err, "march_disk_kernel")
    launches += 1
    return (fout[0], fout[1], fout[2], iout[0], iout[1], *fout[3:])
