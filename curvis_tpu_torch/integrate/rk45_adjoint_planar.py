"""Guarded right-hand sides of the planar system (PyTorch).

Counterpart of the part of ``curvis_tpu/integrate/rk45_adjoint_planar.py``
that the differentiable disk marches use: ``_guarded_deriv_fns``.  The
differentiable error-controlled planar march itself (the rest of that
module) is ROADMAP Queue 1 item 3 and comes later; it will reuse this.

A checkpointed-recompute backward under autograd (``integrate/ckpt.py``)
evaluates each step on every ray, frozen or not, and discards the frozen
rays' results with a mask.  A ray frozen at capture sits near or inside the
horizon (A -> 0) or, after an overshooting step, near l = 0, where raw
reciprocals give infinite partials, and the mask's zero cotangent times an
infinite partial is NaN.  So every reciprocal here is guarded,
``sign(x) / max(|x|, eps)``, and l and p_l are bounded.  The operations
are grouped as in the JAX closures, so off the guards the four closed-form
kinds are the unguarded forms of the march kernels
(``ops/ckpt_adjoint_cuda.py:planar_deriv``, which transcribes
``csrc/planar.cuh:planar_deriv``) bit for bit: ``sign(x) / |x|`` has the
bits of ``1 / x``.

DNEG (``interstellar``) keeps the JAX closure's shape form (x clamped at
0, log(1 + x^2)), which equals the kernels' (log1p, a select at the
throat) to rounding, and differs by method from the JAX closure, which
evaluates atan with the degree-6 polynomial ``_ATAN6`` of the TPU kernels
even on its XLA route: here ``torch.atan`` is exact (the polynomial is on
the port's "do not port" list).  The difference is the polynomial's error,
about 1e-6 absolute in (2 / pi) atan.
"""
from __future__ import annotations

import math

import torch


def _guarded_inv(x, eps):
    """sign(x) / max(|x|, eps): 1 / x off the guard, bounded on it."""
    return torch.sign(x) / torch.clamp(torch.abs(x), min=eps)


def _guarded_deriv_fns(kind):
    """``fns(p, l, p_l, b, b2) -> (dl, dpsi, dpl)`` with the metric slots
    ``p = (p0, p1, p2)`` of ``ops/march_cuda.py:metric_kind_and_params``:
    finite outputs and finite partials for any finite state (module
    docstring).  ``cheb{K}`` kinds raise: tabulated metrics are ROADMAP
    Queue 1 item 4."""
    if kind == "schwarzschild":
        def fns(p, l, p_l, b, b2):
            M = p[0]
            l = torch.clamp(l, -1e4, 1e4)
            p_l = torch.clamp(p_l, -1e4, 1e4)
            invl = _guarded_inv(l, 1e-4)
            invl2 = invl * invl
            A = 1.0 - 2.0 * M * invl
            invA = _guarded_inv(A, 1e-4)
            dl = A * p_l
            dpsi = b * invl2
            dpl = (-M * invl2) * (invA * invA + p_l * p_l) + b2 * invl2 * invl
            return dl, dpsi, dpl
        return fns
    if kind == "rn":
        def fns(p, l, p_l, b, b2):
            M, q2 = p[0], p[1]
            l = torch.clamp(l, -1e4, 1e4)
            p_l = torch.clamp(p_l, -1e4, 1e4)
            invl = _guarded_inv(l, 1e-4)
            invl2 = invl * invl
            A = 1.0 - (2.0 * M - q2 * invl) * invl
            invA = _guarded_inv(A, 1e-4)
            dl = A * p_l
            dpsi = b * invl2
            dpl = ((-(M - q2 * invl) * invl2) * (invA * invA + p_l * p_l)
                   + b2 * invl2 * invl)
            return dl, dpsi, dpl
        return fns
    if kind == "ellis":
        def fns(p, l, p_l, b, b2):
            rho = p[0]
            l = torch.clamp(l, -1e4, 1e4)
            r2 = rho * rho + l * l
            inv = 1.0 / torch.clamp(r2, min=1e-12)
            return p_l, b * inv, b2 * (l * inv * inv)
        return fns
    if kind == "flat":
        def fns(p, l, p_l, b, b2):
            l = torch.clamp(l, -1e4, 1e4)
            r2 = torch.clamp(l * l, min=1e-8)
            inv = 1.0 / r2
            r = torch.sqrt(r2)
            return p_l, b * inv, b2 * (inv / r)
        return fns
    if kind == "interstellar":
        def fns(p, l, p_l, b, b2):
            m, a, rho = p[0], p[1], p[2]
            l = torch.clamp(l, -1e4, 1e4)
            c = 2.0 / (math.pi * m)
            x = torch.clamp(c * (torch.abs(l) - a), min=0.0)
            atx2 = (2.0 / math.pi) * torch.atan(x)       # exact atan
            L = torch.log(1.0 + x * x)
            r = (rho + (0.5 * math.pi * m) * (x * atx2)) - (0.5 * m) * L
            dr = torch.where(l < 0, -atx2, atx2)
            ir = 1.0 / torch.clamp(r, min=1e-6)
            inv = ir * ir
            return p_l, b * inv, b2 * (dr * inv * ir)
        return fns
    if kind.startswith("cheb"):
        raise NotImplementedError(
            f"metric kind {kind!r}: tabulated (cheb{{K}}) metrics are "
            "ROADMAP Queue 1 item 4")
    raise NotImplementedError(
        f"planar guarded RHS: unsupported metric kind {kind!r}")
