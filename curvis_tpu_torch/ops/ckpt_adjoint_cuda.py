"""Checkpointed-recompute adjoint of the planar Euler march on the GPU:
wrapper of the CUDA kernels ``csrc/ckpt_adjoint.cu``, which replace
``curvis_tpu/ops/ckpt_adjoint_pallas.py``'s ``_ckpt_gen_kernel`` (#9) and
``_ckpt_bwd_kernel`` (#10) for the planar Euler step family, and their
plain PyTorch versions.  A tabulated metric's kind (``ops/table_cuda.py``)
gives per-ray cotangents of (s^2, c1..., c2..., b) in place of (p0, p1,
p2, b); its VJP runs the series' recurrences in reverse
(``csrc/table.cuh:table_shape_vjp``, transcribed in ``ops/table_cuda.py``).

``ckpt_adjoint_backward_cuda`` pulls a cotangent of the march's output
state back to its spawn state and parameters: the kernel pair for CUDA
tensors, the plain pair for CPU tensors.  A CUDA tensor never falls back to
the plain pair: a failure to build or launch raises.

One thread per ray loops over its own ray's ceil(steps[i] / seg) segments
(the TPU grid ran ceil(max_steps / seg) segments for every ray; the extra
ones are masked identities).  The checkpoint buffer is sized by the longest
ray, ceil(max_i steps[i] / seg) x 3 x n floats, which costs one device-to-
host read of ``steps.max()`` per backward.  What bounds the kernels on the
H100 (FP32 issue and warp divergence; the buffer's bytes are a few percent)
is set out at the top of ``csrc/ckpt_adjoint.cu``.

The plain versions run vectorised over rays with masks, on any device:
``ckpt_gen_plain`` is the masked march writing segment starts,
``ckpt_bwd_plain`` the reverse-segment sweep with ``euler_step_vjp``, a
line-by-line transcription of the kernels' hand-written VJP in
``csrc/planar.cuh``; ``planar_deriv`` transcribes the RHS forms it
differentiates (the march kernel's, not ``physics/planar.py:planar_rhs``).
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.march_cuda import KINDS
from curvis_tpu_torch.ops.table_cuda import (TableKind, kernel_table,
                                             slot_params, table_shape,
                                             table_shape_vjp)

SEG = 32                 # default segment: 32 Euler steps per recompute
MAX_SEG = 64             # longest segment the backward kernel can hold

launches = {"ckpt_gen": 0, "ckpt_bwd": 0}   # kernel launches since a reset


# ------------------------------------------------- plain versions (PyTorch)

def _slots(kind, scal, like):
    """(dt, p) of a march scalar row [dt, R, p0, p1, p2, r_cap] as 0-d
    tensors of ``like``'s dtype and device: p = (p0, p1, p2), or a table's
    (s^2, c1..., c2...)."""
    row = torch.tensor(scal, dtype=like.dtype, device=like.device)
    return row[0], slot_params(kind, row)


def n_theta(kind):
    """Entries of a ray's parameter cotangent: (p0, p1, p2, b), or a
    table's (s^2, c1..., c2..., b)."""
    return 2 * kind.n + 2 if isinstance(kind, TableKind) else 4


def _dneg_shape(m, a, rho, l):
    """r(l), r'(l) of the DNEG wormhole, as csrc/planar.cuh:dneg_shape."""
    x = 2.0 * (torch.abs(l) - a) / (math.pi * m)
    at = torch.atan(x)
    outside = torch.abs(l) > a
    r = torch.where(outside, rho + m * (x * at - 0.5 * torch.log1p(x * x)),
                    rho)
    sgn = torch.where(l < 0.0, -1.0, 1.0).to(l.dtype)
    dr = torch.where(outside, sgn * (2.0 / math.pi) * at,
                     torch.zeros_like(l))
    return r, dr


def planar_deriv(kind, p, l, p_l, b):
    """(dl, dpsi, dpl) in the forms of csrc/planar.cuh:planar_deriv."""
    b2 = b * b
    if kind == "table":
        inv, dr3 = table_shape(kind, p, l)
        return p_l, b * inv, b2 * dr3
    p0, p1, p2 = p
    if kind == "ellis":
        inv = 1.0 / (p0 * p0 + l * l)
        return p_l, b * inv, b2 * (l * inv * inv)
    if kind == "flat":
        r2 = l * l
        inv = 1.0 / r2
        return p_l, b * inv, b2 * (inv / torch.sqrt(r2))
    if kind == "interstellar":
        r, dr = _dneg_shape(p0, p1, p2, l)
        ir = 1.0 / r
        inv = ir * ir
        return p_l, b * inv, b2 * (dr * inv * ir)
    invl = 1.0 / l
    invl2 = invl * invl
    if kind == "schwarzschild":
        A = 1.0 - 2.0 * p0 * invl
        invA = 1.0 / A
        return (A * p_l, b * invl2,
                (-p0 * invl2) * (invA * invA + p_l * p_l)
                + b2 * invl2 * invl)
    if kind == "rn":
        A = 1.0 - (2.0 * p0 - p1 * invl) * invl
        invA = 1.0 / A
        return (A * p_l, b * invl2,
                (-(p0 - p1 * invl) * invl2) * (invA * invA + p_l * p_l)
                + b2 * invl2 * invl)
    raise ValueError(f"unknown planar metric kind {kind!r}")


def euler_step(kind, dt, p, l, psi, p_l, b):
    """One Euler step of (l, psi, p_l), as csrc/planar.cuh:euler_step."""
    dl, dpsi, dpl = planar_deriv(kind, p, l, p_l, b)
    return l + dt * dl, psi + dt * dpsi, p_l + dt * dpl


def _lapse_rhs_vjp(M, q2, l, p_l, b, u, v, w):
    """csrc/planar.cuh:lapse_rhs_vjp -> (g_l, g_pl, g_b, g_m, g_q2), the
    increments from the RHS cotangents (u, v, w)."""
    b2 = b * b
    invl = 1.0 / l
    invl2 = invl * invl
    A = 1.0 - (2.0 * M - q2 * invl) * invl
    invA = 1.0 / A
    C = -(M - q2 * invl) * invl2
    Q = invA * invA + p_l * p_l
    gC = w * Q
    gQ = w * C
    gA = u * p_l - gQ * 2.0 * invA * invA * invA
    g_pl = u * A + gQ * 2.0 * p_l
    g_b = v * invl2 + w * 2.0 * b * invl2 * invl
    g_m = gA * (-2.0 * invl) - gC * invl2
    g_q2 = gA * invl2 + gC * invl * invl2
    g_invl2 = v * b + w * b2 * invl - gC * (M - q2 * invl)
    g_invl = (w * b2 * invl2 + g_invl2 * 2.0 * invl
              + gA * (-2.0 * M + 2.0 * q2 * invl) + gC * q2 * invl2)
    return g_invl * (-invl * invl), g_pl, g_b, g_m, g_q2


def euler_step_vjp(kind, dt, p, l, p_l, b, lam):
    """VJP of one Euler step at (l, p_l), as csrc/planar.cuh:
    euler_step_vjp: ``lam`` = (lam_l, lam_psi, lam_pl), the cotangent of
    the step's output -> (that of its input, (g_p0, g_p1, g_p2, g_b)), a
    table's parameter cotangents (g_s2, g_c1..., g_c2..., g_b)."""
    lam_l, lam_psi, lam_pl = lam
    u, v, w = dt * lam_l, dt * lam_psi, dt * lam_pl
    b2 = b * b
    if kind == "table":
        inv, dr3, g_l, g_s2, gc = table_shape_vjp(kind, p, l, v * b, w * b2)
        gb = v * inv + w * 2.0 * b * dr3
        return (lam_l + g_l, lam_psi, lam_pl + u), (g_s2, *gc, gb)
    p0, p1, p2 = p
    zero = torch.zeros_like(l)
    g0 = g1 = g2 = zero
    if kind == "ellis":
        inv = 1.0 / (p0 * p0 + l * l)
        inv2 = inv * inv
        g_inv = v * b + w * b2 * l * 2.0 * inv
        g_r2 = -g_inv * inv2
        g_l = lam_l + w * b2 * inv2 + g_r2 * 2.0 * l
        g_pl = lam_pl + u
        g0 = g_r2 * 2.0 * p0
        gb = v * inv + w * 2.0 * b * l * inv2
    elif kind == "flat":
        r2 = l * l
        inv = 1.0 / r2
        r = torch.sqrt(r2)
        g_inv = v * b + w * b2 / r
        g_r = -w * b2 * inv / (r * r)
        g_r2 = -g_inv * inv * inv + g_r * 0.5 / r
        g_l = lam_l + g_r2 * 2.0 * l
        g_pl = lam_pl + u
        gb = v * inv + w * 2.0 * b * inv / r
    elif kind == "interstellar":
        m, a = p0, p1
        r, dr = _dneg_shape(m, a, p2, l)
        ir = 1.0 / r
        inv = ir * ir
        g_inv = v * b + w * b2 * dr * ir
        g_ir = g_inv * 2.0 * ir + w * b2 * dr * inv
        g_r = -g_ir * ir * ir
        g_dr = w * b2 * inv * ir
        g2 = g_r
        sg = torch.where(l < 0.0, -1.0, 1.0).to(l.dtype)
        c = 2.0 / (math.pi * m)
        x = c * (torch.abs(l) - a)
        at = torch.atan(x)
        g_x = g_r * m * at + g_dr * sg * (2.0 / math.pi) / (1.0 + x * x)
        outside = torch.abs(l) > a
        g0 = torch.where(outside, g_r * (x * at - 0.5 * torch.log1p(x * x))
                         - g_x * x / m, zero)
        g1 = torch.where(outside, -g_x * c, zero)
        g_l = lam_l + torch.where(outside, g_x * sg * c, zero)
        g_pl = lam_pl + u
        gb = v * inv + w * 2.0 * b * dr * inv * ir
    elif kind in ("schwarzschild", "rn"):
        q2 = p1 if kind == "rn" else torch.zeros_like(p1)
        dl_, dpl_, gb, g0, g1 = _lapse_rhs_vjp(p0, q2, l, p_l, b, u, v, w)
        g_l, g_pl = lam_l + dl_, lam_pl + dpl_
        if kind == "schwarzschild":
            g1 = zero
    else:
        raise ValueError(f"unknown planar metric kind {kind!r}")
    return (g_l, lam_psi, g_pl), (g0, g1, g2, gb)


def n_segments(steps, seg):
    """Segments of the longest ray, ceil(max_i steps[i] / seg): one
    device-to-host read."""
    return -(-int(steps.max()) // seg) if steps.numel() else 0


def segment_offsets(steps, seg):
    """(offsets, total): ray i's first checkpoint row, the exclusive
    prefix sum of ceil(steps / seg), and the number of rows (one
    device-to-host read)."""
    counts = torch.div(steps.long() + (seg - 1), seg, rounding_mode="floor")
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if ends.numel() else 0
    return ends - counts, total


def ckpt_gen_plain(kind, scal, y0, b, steps, *, seg, n_seg):
    """Plain version of kernel #9: the masked march from ``y0`` writing the
    state at the start of each segment -> (n_seg, 3, n).  A ray past its
    own count stays frozen, so its later segments hold its final state
    (the kernel leaves them unwritten)."""
    dt, p = _slots(kind, scal, y0[0])
    y = tuple(y0)
    out = torch.empty((n_seg, 3, y[0].numel()), dtype=y[0].dtype,
                      device=y[0].device)
    for s in range(n_seg):
        for c in range(3):
            out[s, c] = y[c]
        for k in range(seg):
            act = s * seg + k < steps
            y1 = euler_step(kind, dt, p, *y, b)
            y = tuple(torch.where(act, a1, a0) for a0, a1 in zip(y, y1))
    return out


def ckpt_bwd_plain(kind, scal, ckpt, b, steps, cot, *, seg):
    """Plain version of kernel #10: re-march each segment from its
    checkpoint, last to first, and pull ``cot`` back through its steps with
    ``euler_step_vjp`` -> (per-ray (g_p0, g_p1, g_p2, g_b) or a table's
    (g_s2, g_c1..., g_c2..., g_b), (lam_l, lam_psi, lam_pl)).  A step at or
    past a ray's count is the identity."""
    dt, p = _slots(kind, scal, ckpt)
    lam = tuple(cot)
    g = tuple(torch.zeros_like(lam[0]) for _ in range(n_theta(kind)))
    for s in range(ckpt.shape[0] - 1, -1, -1):
        y = (ckpt[s, 0], ckpt[s, 1], ckpt[s, 2])
        starts = []
        for _ in range(seg):
            starts.append((y[0], y[2]))
            y = euler_step(kind, dt, p, *y, b)
        for k in range(seg - 1, -1, -1):
            act = s * seg + k < steps
            new, dg = euler_step_vjp(kind, dt, p, *starts[k], b, lam)
            lam = tuple(torch.where(act, a1, a0) for a0, a1 in zip(lam, new))
            g = tuple(gi + torch.where(act, d, torch.zeros_like(d))
                      for gi, d in zip(g, dg))
    return g, lam


# ------------------------------------------------------------ the kernels

def _check_rays(steps, *arrays):
    n = steps.numel()
    for a in arrays:
        if a.dtype != torch.float32:
            raise TypeError(f"checkpoint kernels take float32, got {a.dtype}")
        if a.shape != (n,) or not a.is_contiguous():
            raise ValueError("checkpoint kernels take contiguous (n,) rays, "
                             f"got {tuple(a.shape)}")
    if steps.dtype != torch.int32 or steps.shape != (n,):
        raise TypeError("steps must be a (n,) int32 tensor")


def launch_gen(kind, scal, l, psi, p_l, b, steps, *, seg, n_seg):
    """Kernel #9 on flat contiguous CUDA tensors of one device (float32
    rays, int32 steps) -> the (n_seg, 3, n) checkpoint buffer."""
    _check_rays(steps, l, psi, p_l, b)
    n = l.numel()
    dev = l.device
    ckpt = torch.empty((n_seg, 3, n), dtype=torch.float32, device=dev)
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_ckpt_gen(KINDS[kind], row, len(scal),
                              _build.table_ptr(tab), l.data_ptr(),
                              psi.data_ptr(), p_l.data_ptr(), b.data_ptr(),
                              steps.data_ptr(), ckpt.data_ptr(), n, seg,
                              dev.index, stream)
    _build.check(lib, err, "ckpt_gen_kernel")
    launches["ckpt_gen"] += 1
    return ckpt


def launch_bwd(kind, scal, ckpt, b, steps, cot, *, seg):
    """Kernel #10 on the checkpoint buffer of ``launch_gen`` ->
    (per-ray (g_p0, g_p1, g_p2, g_b) or a table's (g_s2, g_c1..., g_c2...,
    g_b), (lam_l, lam_psi, lam_pl))."""
    _check_rays(steps, b, *cot)
    n = b.numel()
    dev = b.device
    if ckpt.dtype != torch.float32 or ckpt.shape[1:] != (3, n) \
            or not ckpt.is_contiguous():
        raise ValueError(f"bad checkpoint buffer {tuple(ckpt.shape)}")
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(7)]
    tab = kernel_table(kind, scal)
    gc = (torch.empty((2 * kind.n, n), dtype=torch.float32, device=dev)
          if tab is not None else None)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_ckpt_bwd(KINDS[kind], row, len(scal),
                              _build.table_ptr(tab), ckpt.data_ptr(),
                              b.data_ptr(), steps.data_ptr(),
                              *(c.data_ptr() for c in cot),
                              *(o.data_ptr() for o in outs),
                              None if gc is None else gc.data_ptr(), n, seg,
                              dev.index, stream)
    _build.check(lib, err, "ckpt_bwd_kernel")
    launches["ckpt_bwd"] += 1
    g = tuple(outs[3:])
    if gc is not None:      # (g_s2, g_c1..., g_c2..., g_b)
        g = (g[0], *gc.unbind(), g[3])
    return g, tuple(outs[:3])


def ckpt_adjoint_backward_cuda(kind, scal, y0, b, steps, cot, *, seg=SEG):
    """Exact pullback of the masked Euler march of ``kind`` (ray i takes
    ``steps[i]`` steps from ``y0`` = (l, psi, p_l) with impact parameter
    ``b``) for the output cotangent ``cot`` -> ``(d_theta, d_y0)``:
    ``d_theta`` = per-ray (g_p0, g_p1, g_p2, g_b) for the metric slots of
    the scalar row ``scal`` (``ops/march_cuda.py:march_scalars``) and b,
    or a table's (g_s2, g_c1..., g_c2..., g_b), which the caller sums;
    ``d_y0`` = (lam_l, lam_psi, lam_pl).  This is the order of the JAX
    package's XLA twin (its Pallas front door returns the transpose).  CUDA tensors run kernels #9/#10, CPU tensors their
    plain versions.  No ray or no step returns d_y0 = cot, d_theta = 0."""
    if not 1 <= seg <= MAX_SEG:
        raise ValueError(f"segment {seg} outside [1, {MAX_SEG}]")
    n_seg = n_segments(steps, seg)
    if n_seg == 0:
        return (tuple(torch.zeros_like(b) for _ in range(n_theta(kind))),
                tuple(c.clone() for c in cot))
    dev = b.device
    if dev.type == "cpu":
        ckpt = ckpt_gen_plain(kind, scal, y0, b, steps, seg=seg, n_seg=n_seg)
        return ckpt_bwd_plain(kind, scal, ckpt, b, steps, cot, seg=seg)
    if dev.type != "cuda":
        raise ValueError(f"ckpt_adjoint_backward_cuda: unsupported device "
                         f"{dev}")
    ckpt = launch_gen(kind, scal, *y0, b, steps, seg=seg, n_seg=n_seg)
    return launch_bwd(kind, scal, ckpt, b, steps, cot, seg=seg)
