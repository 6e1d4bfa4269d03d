"""Checkpointed-recompute adjoint of a masked lock-step march (PyTorch).

Counterpart of ``curvis_tpu/integrate/ckpt.py``, and the plain version of
the checkpoint kernels #9/#10 (``ops/ckpt_adjoint_cuda.py``) for any step
function.  Every marcher here is one discrete map: a per-ray state ``y``
advanced by a smooth step while a per-ray count says the ray is still
active, then frozen.  Its exact reverse-mode gradient re-marches the
trajectory from the spawn state in segments and pulls the cotangent back
through each segment under autograd; memory is O(max_steps / segment)
segment starts plus one segment, never O(max_steps).

Contract (the JAX package's):

  ``step_fn(theta, y) -> y`` is one unmasked step; ``y`` is a tuple of
  per-ray tensors and ``theta`` a tuple of tensors (metric parameters,
  conserved quantities, impact parameters).  Masking -- ray ``i`` is
  advanced only while ``j < steps[i]`` -- is applied OUTSIDE ``step_fn``,
  exactly as the forward marchers do, so frozen rays are bit-frozen and
  contribute nothing to ``theta``'s cotangent.

NaN-safety invariant (callers must uphold): ``step_fn`` is *evaluated*
(then discarded by the mask) on frozen states every step, and the masked
select's backward multiplies the discarded branch by zero, so every frozen
state must be one where the step math is finite: exclude captured or
blown-up rays by zeroing their cotangents AND their ``steps`` and passing a
benign state (the spawn state).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _n_segments(steps, max_steps, segment):
    longest = min(int(max_steps), int(steps.max())) if steps.numel() else 0
    return -(-longest // segment)


def _segment(step_fn, theta, y, steps, s, segment):
    """Segment ``s`` of the masked march from its start ``y``."""
    for k in range(segment):
        y1 = step_fn(theta, y)
        act = s * segment + k < steps
        y = tuple(torch.where(act, a1, a0) for a0, a1 in zip(y, y1))
    return y


def march_masked(step_fn, theta, y0, steps, *, max_steps, segment):
    """Forward recompute of the masked march: ``y0`` advanced ``steps[i]``
    times per ray, in segments of ``segment`` steps, each under
    ``torch.utils.checkpoint``.  Differentiable in ``theta`` and ``y0``;
    ``steps`` is data.  Segments past the longest ray's count are identity
    maps and are not run."""
    y = tuple(y0)
    for s in range(_n_segments(steps, max_steps, segment)):
        y = checkpoint(lambda s_, *y_: _segment(step_fn, theta, y_, steps,
                                                s_, segment),
                       s, *y, use_reentrant=False)
    return y


def ckpt_adjoint_backward(step_fn, theta, y0, steps, cot, *, max_steps,
                          segment):
    """Exact reverse-mode pullback of :func:`march_masked` at ``(theta,
    y0)`` for the output cotangent ``cot`` (a tuple matching ``y``).
    Returns ``(d_theta, d_y0)``, in this order (the JAX package's XLA
    twin's); an input the march does not reach gets zeros.  The segment
    starts are marched without a graph, then each segment, last to first,
    is re-marched under autograd and pulled back alone."""
    th = tuple(t.detach() for t in theta)
    y = tuple(a.detach() for a in y0)
    n_seg = _n_segments(steps, max_steps, segment)
    starts = []
    with torch.no_grad():
        for s in range(n_seg):
            starts.append(y)
            y = _segment(step_fn, th, y, steps, s, segment)
    d_th = [torch.zeros_like(t) for t in th]
    lam = tuple(cot)
    for s in range(n_seg - 1, -1, -1):
        with torch.enable_grad():
            th_g = tuple(t.requires_grad_() for t in
                         (t_.detach() for t_ in th))
            y_g = tuple(a.detach().requires_grad_() for a in starts[s])
            out = _segment(step_fn, th_g, y_g, steps, s, segment)
            grads = torch.autograd.grad(out, th_g + y_g, grad_outputs=lam,
                                        allow_unused=True)
        for i, g in enumerate(grads[:len(th)]):
            if g is not None:
                d_th[i] = d_th[i] + g
        lam = tuple(torch.zeros_like(a) if g is None else g
                    for g, a in zip(grads[len(th):], y_g))
    return tuple(d_th), lam
