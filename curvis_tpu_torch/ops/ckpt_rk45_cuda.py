"""Checkpointed-recompute adjoint of the adaptive DP5(4) planar march on the
GPU: wrapper of the CUDA kernels ``csrc/ckpt_rk45.cu``, the planar rk45
variant of ``curvis_tpu/ops/ckpt_adjoint_pallas.py``'s ``_ckpt_gen_kernel``
(#9) and ``_ckpt_bwd_kernel`` (#10), and their plain PyTorch versions.

The step family is one iteration of kernel #4 (``csrc/rk45.cuh:
rk45_iter``), the map of ``curvis_tpu/integrate/rk45_adjoint_planar.py:
_planar_rk45_iter``: state y = (l, psi, p_l, dt), parameters theta = (p0,
p1, p2, b), the metric slots of kernel #4's scalar row
(``ops/rk45_cuda.py:rk45_scalars``: dt0, R, p0, p1, p2, r_cap, rtol, atol,
dt_max) and the per-ray b; for a tabulated metric theta = (s^2, c1...,
c2..., b).  Ray i takes ``iters[i]`` iterations from
y0 = (l, psi, p_l, dt0), the iterations it was live for in the forward
march, accepted and rejected, and is frozen after.  ``freeze`` drops the
cotangent of each iteration's next dt (the JAX package's
``freeze_controller``).

``ckpt_rk45_backward_cuda`` pulls a cotangent of the final state back to
y0 and theta: kernels #9 / #10 for CUDA tensors, the plain pair for CPU
tensors, never a fallback from the one to the other.  The checkpoint buffer
is compacted as ``ops/ckpt_surface_cuda.py``'s: ray i owns
ceil(iters[i] / seg) rows of 4 floats from the exclusive prefix sum of
those counts.

The plain versions run vectorised over rays with masks, on any device, in
the kernel's arithmetic:

  * ``rk45_iter_plain`` is one iteration built from ``ops/rk45_cuda.py``'s
    ``rk45_trial_plain`` / ``rk45_control_plain`` (kernel #4's plain
    version, whose clips are jnp.clip's max-then-min, so autograd splits a
    tie as the JAX package does);
  * ``rk45_iter_vjp_plain`` transcribes the kernels' hand-written VJP
    (``csrc/rk45_vjp.cuh``) line by line: the forward recomputed with the
    unguarded RHS of ``ops/ckpt_adjoint_cuda.py:planar_deriv``, the RHS
    partials guarded (l and p_l clipped to +-1e4, reciprocals sign(x) /
    max(|x|, eps)); off the guards it equals ``torch.func.vjp`` of
    ``rk45_iter_plain``.
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.integrate.rk45 import DP_A, DP_B4, DP_B5
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.ckpt_adjoint_cuda import (_dneg_shape, n_theta,
                                                    segment_offsets)
from curvis_tpu_torch.ops.march_cuda import KINDS
from curvis_tpu_torch.ops.table_cuda import (kernel_table, slot_params,
                                             table_shape_vjp)
from curvis_tpu_torch.ops.rk45_cuda import (DT_FLOOR, rk45_control_plain,
                                            rk45_trial_plain,
                                            trial_rec_plain)

SEG = 16                 # default segment: the JAX package's _PALLAS_SEG
MAX_SEG = 32             # longest segment the backward kernels can hold
N_STATE = 4
STALL_DT = DT_FLOOR * 1.01   # the kernel's stall threshold, in the dtype

launches = {"rk45_gen": 0, "rk45_bwd": 0}   # since the last reset


def scalar_row(scal, like):
    """Kernel #4's scalar row as a tensor of ``like``'s dtype and device."""
    return torch.tensor(scal, dtype=like.dtype, device=like.device)


# ------------------------------------------------------- the iteration

def _all(like):
    return torch.ones(like.shape, dtype=torch.bool, device=like.device)


def rk45_iter_plain(kind, row, theta, y, freeze=False):
    """One iteration of kernel #4 on every ray: ``row`` the scalar row
    tensor, theta = (p0, p1, p2, b) (a table's (s^2, c1..., c2..., b)),
    y = (l, psi, p_l, dt) -> the state after it.  ``freeze`` detaches the
    next dt."""
    p, b = theta[:-1], theta[-1]
    l, psi, p_l, dt = y
    alive = _all(l)
    l, psi, p_l, *trial = rk45_trial_plain(kind, p, row[1], row[6], row[7],
                                           l, psi, p_l, b, dt, alive)
    zero = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    _, _, dtn = rk45_control_plain(row[5], row[8], alive, trial, l, dt, zero,
                                   zero)
    return l, psi, p_l, dtn.detach() if freeze else dtn


# ------------------------------------------------------- the VJP pieces

def _max_share(a, b):
    """a's share of the cotangent of max(a, b): 1, 0 or 1/2 at a tie."""
    one = torch.ones_like(a)
    return torch.where(a > b, one, torch.where(a < b, 0.0 * one, 0.5 * one))


def _clip_share(x, lo, hi):
    """x's share of the cotangent of min(max(x, lo), hi)."""
    return _max_share(x, lo) * _max_share(hi + 0.0 * x, x)


def _ginv(x, eps):
    return torch.sign(x) / torch.clamp(torch.abs(x), min=eps)


def planar_deriv_vjp_plain(kind, p, l, p_l, b, u, v, w):
    """csrc/rk45_vjp.cuh:planar_deriv_vjp: cotangents of (l, p_l) and
    (p0, p1, p2, b) (a table's (s^2, c1..., c2..., b)) of one RHS
    evaluation at (l, p_l) for the cotangents (u, v, w) of (dl, dpsi, dpl),
    from the guarded forms."""
    b2 = b * b
    zero = torch.zeros_like(l)
    sl = _clip_share(l, -1e4, 1e4)
    lc = torch.clamp(l, -1e4, 1e4)
    if kind == "table":
        inv, dr3, g_lc, g_s2, gc = table_shape_vjp(kind, p, lc, v * b,
                                                   w * b2, guard=True)
        gb = v * inv + w * 2.0 * b * dr3
        return (zero + g_lc) * sl, u, (g_s2, *gc, gb)
    p0, p1, p2 = p
    g0 = g1 = g2 = zero
    if kind == "ellis":
        r2 = p0 * p0 + lc * lc
        inv = 1.0 / torch.clamp(r2, min=1e-12)
        inv2 = inv * inv
        g_inv = v * b + w * b2 * lc * 2.0 * inv
        g_r2 = -g_inv * inv2 * _max_share(r2, 1e-12)
        g_l = (w * b2 * inv2 + g_r2 * 2.0 * lc) * sl
        g_pl = u
        g0 = g_r2 * 2.0 * p0
        gb = v * inv + w * 2.0 * b * (lc * inv * inv)
    elif kind == "flat":
        r2 = torch.clamp(lc * lc, min=1e-8)
        inv = 1.0 / r2
        r = torch.sqrt(r2)
        g_inv = v * b + w * b2 / r
        g_r = -w * b2 * inv / (r * r)
        g_r2 = -g_inv * inv * inv + g_r * 0.5 / r
        g_l = g_r2 * _max_share(lc * lc, 1e-8) * 2.0 * lc * sl
        g_pl = u
        gb = v * inv + w * 2.0 * b * (inv / r)
    elif kind == "interstellar":
        m, a = p0, p1
        r, dr = _dneg_shape(m, a, p2, lc)
        ir = 1.0 / torch.clamp(r, min=1e-6)
        inv = ir * ir
        g_inv = v * b + w * b2 * dr * ir
        g_ir = g_inv * 2.0 * ir + w * b2 * dr * inv
        g_r = -g_ir * ir * ir * _max_share(r, 1e-6)
        g_dr = w * b2 * inv * ir
        g2 = g_r
        sg = torch.where(lc < 0.0, -1.0, 1.0).to(l.dtype)
        c = 2.0 / (math.pi * m)
        x = c * (torch.abs(lc) - a)
        at = torch.atan(x)
        outside = torch.abs(lc) > a
        g_x = g_r * m * at + g_dr * sg * (2.0 / math.pi) / (1.0 + x * x)
        g0 = torch.where(outside, g_r * (x * at - 0.5 * torch.log1p(x * x))
                         - g_x * x / m, zero)
        g1 = torch.where(outside, -g_x * c, zero)
        g_l = torch.where(outside, g_x * sg * c * sl, zero)
        g_pl = u
        gb = v * inv + w * 2.0 * b * dr * inv * ir
    elif kind in ("schwarzschild", "rn"):
        M = p0
        q2 = p1 if kind == "rn" else torch.zeros_like(p1)
        pc = torch.clamp(p_l, -1e4, 1e4)
        invl = _ginv(lc, 1e-4)
        invl2 = invl * invl
        A = 1.0 - (2.0 * M - q2 * invl) * invl
        invA = _ginv(A, 1e-4)
        C = -(M - q2 * invl) * invl2
        Q = invA * invA + pc * pc
        gC = w * Q
        gQ = w * C
        gA = u * pc - gQ * 2.0 * invA * invA * invA * _max_share(
            torch.abs(A), 1e-4)
        g_pl = (u * A + gQ * 2.0 * pc) * _clip_share(p_l, -1e4, 1e4)
        gb = v * invl2 + w * 2.0 * b * invl2 * invl
        g0 = gA * (-2.0 * invl) - gC * invl2
        if kind == "rn":
            g1 = gA * invl2 + gC * invl * invl2
        g_invl2 = v * b + w * b2 * invl - gC * (M - q2 * invl)
        g_invl = (w * b2 * invl2 + g_invl2 * 2.0 * invl
                  + gA * (-2.0 * M + 2.0 * q2 * invl) + gC * q2 * invl2)
        g_l = g_invl * (-invl * invl) * _max_share(torch.abs(lc), 1e-4) * sl
    else:
        raise ValueError(f"unknown planar metric kind {kind!r}")
    return g_l, g_pl, (g0, g1, g2, gb)


def terminal_plain(row, r, opaque=None):
    """csrc/rk45_vjp.cuh:rk45_terminal: where the controller keeps dt."""
    t = (r["esc_pos"] | r["esc_neg"] | (r["accept"] & (r["out"][0] < row[5]))
         | (~r["accept"] & (r["dt"] <= STALL_DT)))
    return t if opaque is None else t | opaque


def control_vjp_plain(row, r, terminal, g_next):
    """csrc/rk45_vjp.cuh:rk45_control_vjp -> (g_dt, g_err)."""
    dt, err = r["dt"], r["err"]
    err_s = torch.clamp(err, min=1e-10)
    f_raw = 0.9 * torch.exp(-0.2 * torch.log(err_s))
    f_c = torch.clamp(f_raw, 0.2, 5.0)
    pos = f_c > 0.0
    factor = torch.where(pos, f_c, 0.2)
    x = dt * factor
    g_x = g_next * _clip_share(x, DT_FLOOR, row[8])
    g_fc = torch.where(pos, g_x * dt, torch.zeros_like(g_x))
    g_fraw = g_fc * _clip_share(f_raw, 0.2, 5.0)
    zero = torch.zeros_like(g_next)
    # added only where it is not zero (csrc/dp54.cuh:dp54_control_vjp)
    g_err = torch.where(g_fraw != 0.0, g_fraw * (-0.2) * f_raw / err_s
                        * _max_share(err, 1e-10), zero)
    return (torch.where(terminal, g_next, g_x * factor),
            torch.where(terminal, zero, g_err))


def masked(act, x):
    """x where the iteration is live (``act`` None: everywhere), else 0: a
    term the kernel adds only for live iterations."""
    return x if act is None else torch.where(act, x, torch.zeros_like(x))


def trial_vjp_plain(kind, row, p, b, r, g_out, g_err, g_y, g_dt, g,
                    act=None, series_at=None):
    """csrc/rk45_vjp.cuh:rk45_trial_vjp: adds the cotangents of the start
    (l, psi, p_l), dt and theta for those of the written-back state
    ``g_out`` and of the error norm ``g_err`` -> (g_y, g_dt, g).  ``g``
    (p0, p1, p2, b, ...; a table's s^2, c1..., c2..., b) are the running
    per-ray sums, to which each stage adds its terms as the kernel does (in
    its order, so that the sums round alike; ``act`` masks the terms).
    ``series_at``: the disk families' layout, a table's s^2 in slot 0, b in
    3 and its series from that row."""
    dt, a = r["dt"], r["a"]
    rtol = row[6]
    zero = torch.zeros_like(dt)
    g_y = list(g_y)
    g_y5 = []
    g_a = zero
    for c in range(3):
        g_y5.append(a * g_out[c])
        g_y[c] = g_y[c] + (1.0 - a) * g_out[c]
        g_a = g_a + g_out[c] * (r["y5"][c] - r["y"][c])
    esc = r["accept"] & (r["esc_pos"] | r["esc_neg"])
    g_q = torch.where(esc, g_a * _clip_share(r["q"], 0.0, 1.0), zero)
    g_y[0] = g_y[0] - g_q / r["denom"]
    g_den = torch.where(r["small"], zero, -g_q * r["q"] / r["denom"])
    g_y5[0] = g_y5[0] + g_den
    g_y[0] = g_y[0] - g_den
    ec = r["ec"]
    on = g_err != 0.0
    s0 = _max_share(ec[0], torch.maximum(ec[1], ec[2]))
    s1 = _max_share(ec[1], ec[2])
    g_ec = (g_err * s0, g_err * (1.0 - s0) * s1,
            g_err * (1.0 - s0) * (1.0 - s1))
    g_e = []
    for c in range(3):
        x = dt * r["e"][c]
        g_x = torch.where(on, g_ec[c] / r["den"][c] * torch.sign(x), zero)
        g_dt = g_dt + g_x * r["e"][c]
        g_e.append(g_x * dt)
        g_mx = torch.where(on, -g_ec[c] * ec[c] / r["den"][c] * rtol, zero)
        sh = _max_share(torch.abs(r["y"][c]), torch.abs(r["y5"][c]))
        g_y[c] = g_y[c] + g_mx * sh * torch.sign(r["y"][c])
        g_y5[c] = g_y5[c] + g_mx * (1.0 - sh) * torch.sign(r["y5"][c])
    gk = [[None] * 3 for _ in range(7)]
    for c in range(3):
        g_y[c] = g_y[c] + g_y5[c]
        g_dt = g_dt + g_y5[c] * r["d5"][c]
        g_d5 = g_y5[c] * dt + g_e[c]
        for i in range(7):
            gk[i][c] = DP_B5[i] * g_d5 - DP_B4[i] * g_e[c]
    g = list(g)
    for i in range(6, -1, -1):
        g_li, g_pli, gi = planar_deriv_vjp_plain(
            kind, p, r["li"][i], r["pli"][i], b, *gk[i])
        if series_at is not None and kind == "table":
            idx = [0, *range(series_at, series_at + len(gi) - 2), 3]
        else:
            idx = range(len(gi))
        for j, gb in zip(idx, gi):
            g[j] = g[j] + masked(act, gb)
        g_y[0] = g_y[0] + g_li
        g_y[2] = g_y[2] + g_pli
        for j, a_ij in enumerate(DP_A[i]):
            if a_ij != 0.0:
                coef = dt * a_ij
                gk[j][0] = gk[j][0] + coef * g_li
                gk[j][2] = gk[j][2] + coef * g_pli
                g_dt = g_dt + a_ij * (r["k"][j][0] * g_li
                                      + r["k"][j][2] * g_pli)
    return g_y, g_dt, g


def rk45_iter_vjp_plain(kind, row, start, b, lam, freeze=False, g=None,
                        act=None):
    """VJP of ``rk45_iter_plain`` at the start (l, psi, p_l, dt), as
    csrc/rk45_vjp.cuh:rk45_iter_vjp: ``lam`` (4) is the cotangent of the
    state after the iteration -> (that of the state before it (4), the
    per-ray sums ``g`` of (g_p0, g_p1, g_p2, g_b) with this iteration's
    terms added (from zeros when None; ``act`` masks them))."""
    p = slot_params(kind, row)
    r = trial_rec_plain(kind, p, row[1], row[6], row[7], *start[:3], b,
                        start[3])
    zero = torch.zeros_like(start[0])
    g_dt, g_err = zero, zero
    if not freeze:
        g_dt, g_err = control_vjp_plain(row, r, terminal_plain(row, r),
                                        lam[3])
    g_y, g_dt, g = trial_vjp_plain(kind, row, p, b, r, lam[:3], g_err,
                                   (zero, zero, zero), g_dt,
                                   [zero] * n_theta(kind) if g is None
                                   else g, act)
    return (*g_y, g_dt), tuple(g)


# ------------------------------------------------------- plain kernel pair

def ckpt_rk45_gen_plain(kind, scal, l, psi, p_l, b, iters, *, seg, offsets,
                        total):
    """Plain version of kernel #9's planar rk45 variant: the masked march of
    ``iters[i]`` iterations from (l, psi, p_l, dt0), writing each ray's
    segment starts into the compacted (total, 4) buffer -> (ckpt, final
    state (4, n))."""
    row = scalar_row(scal, l)
    theta = (*slot_params(kind, row), b)
    y = (l, psi, p_l, torch.ones_like(l) * row[0])
    ckpt = torch.zeros((total, N_STATE), dtype=l.dtype, device=l.device)
    n_seg = -(-int(iters.max()) // seg) if iters.numel() else 0
    for s in range(n_seg):
        has = s * seg < iters
        ckpt[offsets[has] + s] = torch.stack(y, 1)[has]
        for k in range(seg):
            act = s * seg + k < iters
            y1 = rk45_iter_plain(kind, row, theta, y)
            y = tuple(torch.where(act, a1, a0) for a0, a1 in zip(y, y1))
    return ckpt, torch.stack(y)


def ckpt_rk45_bwd_plain(kind, scal, freeze, ckpt, b, iters, cot, *, seg,
                        offsets):
    """Plain version of kernel #10's planar rk45 variant: each segment,
    last to first, re-marched from its checkpoint and pulled back through
    its iterations with ``rk45_iter_vjp_plain`` -> (per-ray theta
    cotangents (4, n) or a table's (2 K + 4, n), lam (4, n)).  An
    iteration at or past a ray's count is the identity."""
    row = scalar_row(scal, b)
    theta = (*slot_params(kind, row), b)
    lam = tuple(cot)
    g = [torch.zeros_like(b) for _ in range(n_theta(kind))]
    n_seg = -(-int(iters.max()) // seg) if iters.numel() else 0
    for s in range(n_seg - 1, -1, -1):
        has = s * seg < iters
        rows = ckpt[torch.where(has, offsets + s, 0)]
        y = tuple(rows[:, c] for c in range(N_STATE))
        starts = []
        for _ in range(seg):
            starts.append(y)
            y = rk45_iter_plain(kind, row, theta, y)
        for k in range(seg - 1, -1, -1):
            act = s * seg + k < iters
            new, g = rk45_iter_vjp_plain(kind, row, starts[k], b, lam,
                                         freeze, g, act)
            lam = tuple(torch.where(act, a1, a0) for a0, a1 in zip(lam, new))
    return torch.stack(g), torch.stack(lam)


# ------------------------------------------------------------ the kernels

def _check_f32(n, *arrays):
    for a in arrays:
        if a.dtype != torch.float32:
            raise TypeError(f"rk45 checkpoint kernels take float32, got "
                            f"{a.dtype}")
        if a.shape != (n,) or not a.is_contiguous():
            raise ValueError("rk45 checkpoint kernels take contiguous (n,) "
                             f"rays, got {tuple(a.shape)}")


def launch_gen(kind, scal, l, psi, p_l, b, iters, *, seg, offsets, total):
    """Kernel #9's planar rk45 variant on flat contiguous CUDA tensors of one
    device (float32 rays, int32 iters, int64 offsets) -> (the (total, 4)
    checkpoint buffer, the final state (4, n))."""
    n = l.numel()
    _check_f32(n, l, psi, p_l, b)
    if iters.dtype != torch.int32 or offsets.dtype != torch.int64:
        raise TypeError("iters must be int32 and offsets int64")
    dev = l.device
    ckpt = torch.empty((max(total, 1), N_STATE), dtype=torch.float32,
                       device=dev)
    final = torch.empty((N_STATE, n), dtype=torch.float32, device=dev)
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_ckpt_rk45_gen(
        KINDS[kind], row, len(scal), _build.table_ptr(tab), l.data_ptr(),
        psi.data_ptr(),
        p_l.data_ptr(), b.data_ptr(), iters.data_ptr(), offsets.data_ptr(),
        ckpt.data_ptr(), final.data_ptr(), n, seg, dev.index, stream)
    _build.check(lib, err, "ckpt_rk45_gen_kernel")
    launches["rk45_gen"] += 1
    return ckpt, final


def launch_bwd(kind, scal, freeze, ckpt, b, iters, cot, *, seg, offsets):
    """Kernel #10's planar rk45 variant on the buffer of ``launch_gen`` and
    the (4, n) cotangent ``cot`` -> (per-ray theta cotangents (4, n), or a
    table's (2 K + 4, n), lam (4, n))."""
    n = b.numel()
    _check_f32(n, b)
    dev = b.device
    if cot.dtype != torch.float32 or cot.shape != (N_STATE, n) \
            or not cot.is_contiguous():
        raise ValueError(f"bad cotangent {tuple(cot.shape)}")
    if ckpt.dtype != torch.float32 or ckpt.shape[1:] != (N_STATE,) \
            or not ckpt.is_contiguous():
        raise ValueError(f"bad checkpoint buffer {tuple(ckpt.shape)}")
    lam = torch.empty((N_STATE, n), dtype=torch.float32, device=dev)
    g = torch.empty((n_theta(kind), n), dtype=torch.float32, device=dev)
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_ckpt_rk45_bwd(
        KINDS[kind], row, len(scal), _build.table_ptr(tab),
        int(bool(freeze)), ckpt.data_ptr(),
        b.data_ptr(), iters.data_ptr(), offsets.data_ptr(), cot.data_ptr(),
        lam.data_ptr(), g.data_ptr(), n, seg, dev.index, stream)
    _build.check(lib, err, "ckpt_rk45_bwd_kernel")
    launches["rk45_bwd"] += 1
    return g, lam


def ckpt_rk45_backward_cuda(kind, scal, freeze, y0, b, iters, cot, *,
                            seg=SEG):
    """Exact pullback of the masked DP5(4) march of ``kind`` with kernel
    #4's scalar row ``scal``: ray i takes ``iters[i]`` iterations from
    (y0 = (l, psi, p_l), dt0); ``cot`` is the (4, n) cotangent of the final
    (l, psi, p_l, dt) -> ``(g_theta (4, n) or a table's (2 K + 4, n),
    lam (4, n))``, lam the cotangent of (l, psi, p_l, dt0).  CUDA tensors
    run kernels #9 / #10, CPU tensors their plain versions."""
    if not 1 <= seg <= MAX_SEG:
        raise ValueError(f"segment {seg} outside [1, {MAX_SEG}]")
    if scal[0] <= 0.0:
        raise ValueError("dt0 must be positive")
    offsets, total = segment_offsets(iters, seg)
    dev = b.device
    if total == 0:
        return (torch.zeros((n_theta(kind), b.numel()), dtype=b.dtype,
                            device=dev), cot.clone())
    if dev.type == "cpu":
        ckpt, _ = ckpt_rk45_gen_plain(kind, scal, *y0, b, iters, seg=seg,
                                      offsets=offsets, total=total)
        return ckpt_rk45_bwd_plain(kind, scal, freeze, ckpt, b, iters, cot,
                                   seg=seg, offsets=offsets)
    if dev.type != "cuda":
        raise ValueError(f"ckpt_rk45_backward_cuda: unsupported device {dev}")
    ckpt, _ = launch_gen(kind, scal, *y0, b, iters, seg=seg, offsets=offsets,
                         total=total)
    return launch_bwd(kind, scal, freeze, ckpt, b, iters, cot, seg=seg,
                      offsets=offsets)
