"""Adaptive DP5(4) planar march on the GPU: wrapper of the CUDA kernel
``csrc/planar_rk45.cu`` (replacing ``curvis_tpu/ops/march_pallas.py``'s
``_rk45_kernel``, bare variant), and its plain PyTorch version.

``march_planar_rk45_cuda`` has the contract of the JAX package's
``march_planar_rk45_pallas`` (without its TPU tiling): the kernel for CUDA
tensors (float32), the plain version for CPU tensors.  A CUDA tensor never
falls back to the plain version: a failure to build or launch raises.

``march_planar_rk45_plain`` is a line-by-line transcription of the
kernel's body (``csrc/rk45.cuh``), for any dtype and device: the error
|dt (d5 - d4)|, the factor 0.9 exp(-0.2 log err), the writeback
y + a frac (y5 - y) on every live ray, the fixed dt floor 1e-6 and the
per-ray iteration count.  It is not ``integrate/rk45.py:
march_planar_rk45``, the port of the JAX package's XLA march, whose norm
|y5 - y4|, pow factor and where-writeback differ from these by ulps; such
ulps flip knife-edge accepts, so the kernel is held against this version.
The lock-step loop masks every ray that is no longer live, so a frozen ray
never changes, as in the kernel's per-thread loop.  A tabulated metric's
plain RHS is ``ops/table_cuda.py:table_shape``, the kernel's series in its
order.
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.integrate.rk45 import (CAPPED, DP_A, DP_B4, DP_B5,
                                             _comb)
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.ckpt_adjoint_cuda import planar_deriv
from curvis_tpu_torch.ops.march_cuda import KINDS, march_scalars
from curvis_tpu_torch.ops.table_cuda import kernel_table, slot_params
from curvis_tpu_torch.physics.planar import (_CHECK_EVERY, PlanarResult,
                                             PlanarRays)
from curvis_tpu_torch.utils.device import common_device

DT_FLOOR = 1e-6          # the kernel contract's dt floor (not an option)

launches = 0             # kernel launches since the last reset


def rk45_scalars(metric: Metric, dt0, escape_radius, rtol, atol, dt_max):
    """(kind, [dt0, R, p0, p1, p2, r_cap, rtol, atol, dt_max]) as Python
    floats: the layout of curvis::Rk45Scalars."""
    kind, head = march_scalars(metric, dt0, escape_radius)
    return kind, head + [float(rtol), float(atol), float(dt_max)]


def default_max_iters(max_steps, max_iters):
    return 4 * max_steps if max_iters is None else int(max_iters)


def jclip(x, lo, hi):
    """min(max(x, lo), hi), jnp.clip's form: the values of torch.clamp
    (NaN propagates), and at a tie with either bound autograd passes half
    the cotangent, as the JAX package's gradients do.  ``lo`` or ``hi``
    None is no bound."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def trial_rec_plain(kind, p, R, rtol, atol, l, psi, p_l, b, dt):
    """One trial on every ray with what the replay's VJP reads, as a dict
    (csrc/rk45.cuh:rk45_trial_rec): the seven stages, the error |dt (d5 -
    d4)| / (atol + rtol max(|y|, |y5|)), accept and escape, the write-back
    y + a (y5 - y) with a = frac on accept (interpolated onto |l| = R on an
    escaping step), else 0."""
    li, pli, ks = [], [], []
    for i in range(7):
        a_, b_ = l, p_l
        for j, a in enumerate(DP_A[i]):
            a_ = a_ + dt * a * ks[j][0]
            b_ = b_ + dt * a * ks[j][2]
        li.append(a_)
        pli.append(b_)
        ks.append(planar_deriv(kind, p, a_, b_, b))
    y = (l, psi, p_l)
    d5, e, y5 = [], [], []
    for c in range(3):
        d5.append(_comb(DP_B5, ks, c, l))
        e.append(d5[c] - _comb(DP_B4, ks, c, l))
        y5.append(y[c] + dt * d5[c])
    # torch.maximum propagates NaN, as the kernel's max_nan
    den = [atol + rtol * torch.maximum(torch.abs(y[c]), torch.abs(y5[c]))
           for c in range(3)]
    ec = [torch.abs(dt * e[c]) / den[c] for c in range(3)]
    err = torch.maximum(ec[0], torch.maximum(ec[1], ec[2]))
    accept = err <= 1.0
    esc_pos = accept & (y5[0] > R)
    esc_neg = accept & (y5[0] < -R)
    target = torch.where(esc_pos, R, -R)
    denom = y5[0] - l
    small = torch.abs(denom) < 1e-30
    denom = torch.where(small, 1.0, denom)
    q = (target - l) / denom
    frac = torch.where(esc_pos | esc_neg, jclip(q, 0.0, 1.0), 1.0)
    a = torch.where(accept, frac, 0.0)
    out = tuple(y[c] + a * (y5[c] - y[c]) for c in range(3))
    return dict(li=li, pli=pli, k=ks, y=y, y5=y5, d5=d5, e=e, ec=ec, den=den,
                out=out, dt=dt, err=err, q=q, denom=denom, a=a, small=small,
                accept=accept, esc_pos=esc_pos, esc_neg=esc_neg)


def rk45_trial_plain(kind, p, R, rtol, atol, l, psi, p_l, b, dt, alive):
    """The first half of one iteration of the live rays ``alive``
    (csrc/rk45.cuh:rk45_trial): ``trial_rec_plain`` written back where
    live -> (l, psi, p_l, err, accept, esc_pos, esc_neg)."""
    r = trial_rec_plain(kind, p, R, rtol, atol, l, psi, p_l, b, dt)
    l, psi, p_l = (torch.where(alive, o, y) for o, y in zip(r["out"],
                                                          (l, psi, p_l)))
    return (l, psi, p_l, r["err"], alive & r["accept"], alive & r["esc_pos"],
            alive & r["esc_neg"])


def next_dt_plain(dt_max, err, dt):
    """csrc/rk45.cuh:rk45_next_dt: clip(dt 0.9 exp(-0.2 log max(err,
    1e-10)), the dt floor, dt_max), the factor clipped to [0.2, 5] and a
    NaN factor 0.2."""
    err_s = jclip(err, 1e-10, None)
    factor = jclip(0.9 * torch.exp(-0.2 * torch.log(err_s)), 0.2, 5.0)
    factor = torch.where(factor > 0.0, factor, 0.2)
    return jclip(dt * factor, DT_FLOOR, dt_max)


def rk45_control_plain(r_cap, dt_max, alive, trial, l, dt, sign, steps,
                       opaque=None):
    """The second half (csrc/rk45.cuh:rk45_control) after ``trial`` =
    (err, accept, esc_pos, esc_neg) at the written-back ``l``: the sign
    (escape, capture, then 2 where ``opaque`` for a ray still at 0, then
    the stall), the accepted steps and the next dt -> (sign, steps, dt)."""
    err, accept, esc_pos, esc_neg = trial
    captured = accept & (l < r_cap)
    sign = torch.where(alive, esc_pos.to(torch.int32)
                       - esc_neg.to(torch.int32)
                       + 2 * captured.to(torch.int32), sign)
    if opaque is not None:
        sign = torch.where(alive & (sign == 0) & opaque, 2, sign)
    steps = steps + accept.to(torch.int32)
    # the stall threshold is the dtype's value of 1e-6 * 1.01
    stalled = alive & ~accept & (dt <= DT_FLOOR * 1.01) & (sign == 0)
    sign = torch.where(stalled, 3, sign).to(torch.int32)
    dt = torch.where(alive & ~(esc_pos | esc_neg) & (sign == 0),
                     next_dt_plain(dt_max, err, dt), dt)
    return sign, steps, dt


def march_planar_rk45_plain(kind, scal, l, psi, p_l, b, *, max_steps,
                            max_iters):
    """Plain version of kernel #4 on rays of any dtype and device, with the
    scalar row of ``rk45_scalars`` -> (l, psi, p_l, sign, steps, iters)."""
    row = torch.tensor(scal, dtype=l.dtype, device=l.device)
    dt0, R, r_cap = row[0], row[1], row[5]
    p = slot_params(kind, row)
    rtol, atol, dt_max = row[6], row[7], row[8]
    dt = torch.ones_like(l) * dt0
    sign = torch.zeros(l.shape, dtype=torch.int32, device=l.device)
    steps = torch.zeros_like(sign)
    iters = torch.zeros_like(sign)
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool((sign == 0).any()):
            break
        alive = (sign == 0) & (steps < max_steps)
        iters = iters + alive.to(torch.int32)
        l, psi, p_l, *trial = rk45_trial_plain(kind, p, R, rtol, atol, l,
                                               psi, p_l, b, dt, alive)
        sign, steps, dt = rk45_control_plain(r_cap, dt_max, alive, trial, l,
                                             dt, sign, steps)
        sign = torch.where((sign == 0) & (steps >= max_steps), CAPPED,
                           sign).to(torch.int32)
    sign = torch.where(sign == CAPPED, 0, sign).to(torch.int32)
    return l, psi, p_l, sign, steps, iters


def march_planar_rk45_cuda(metric: Metric, rays: PlanarRays, *,
                           escape_radius, max_steps=10_000, max_iters=None,
                           rtol=1e-5, atol=1e-7, dt0=0.05, dt_max=10.0,
                           return_iters=False):
    """Adaptive DP5(4) march of ``rays`` with the contract and defaults of
    the JAX package's ``march_planar_rk45_pallas`` (bare variant): the CUDA
    kernel for CUDA tensors (f32 only), the plain version for CPU tensors.
    ``steps`` counts accepted steps; ``max_iters`` (default 4 max_steps)
    caps each ray's iterations, accepted and rejected.  ``return_iters``
    also returns each ray's live iteration count."""
    dev = common_device(metric, rays.l, rays.psi, rays.p_l, rays.b)
    kind, scal = rk45_scalars(metric, dt0, escape_radius, rtol, atol,
                              dt_max)
    mi = default_max_iters(max_steps, max_iters)
    shape = rays.l.shape
    ins = [torch.broadcast_to(getattr(rays, name), shape)
           for name in ("l", "psi", "p_l", "b")]
    if dev.type == "cpu":
        outs = march_planar_rk45_plain(kind, scal, *ins, max_steps=max_steps,
                                       max_iters=mi)
    elif dev.type == "cuda":
        for name, t in zip(("l", "psi", "p_l", "b"), ins):
            if t.dtype != torch.float32:
                raise TypeError(f"rk45 kernel takes float32 rays, got "
                                f"{name}: {t.dtype}")
        outs = launch(kind, scal, *(t.reshape(-1).contiguous() for t in ins),
                      max_steps=max_steps, max_iters=mi)
        outs = [o.reshape(shape) for o in outs]
    else:
        raise ValueError(f"march_planar_rk45_cuda: unsupported device {dev}")
    res = PlanarResult(*outs[:5])
    return (res, outs[5]) if return_iters else res


def launch(kind, scal, l, psi, p_l, b, *, max_steps, max_iters):
    """One kernel launch on flat contiguous float32 CUDA tensors of one
    device, with the host scalars of ``rk45_scalars`` ->
    (l, psi, p_l, sign, steps, iters)."""
    global launches
    n = l.numel()
    dev = l.device
    outs = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3)]
    outs += [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_march_planar_rk45(
        KINDS[kind], row, len(scal), _build.table_ptr(tab), l.data_ptr(),
        psi.data_ptr(),
        p_l.data_ptr(), b.data_ptr(), *(o.data_ptr() for o in outs), n,
        int(max_steps), int(max_iters), dev.index, stream)
    _build.check(lib, err, "march_planar_rk45_kernel")
    launches += 1
    return outs
