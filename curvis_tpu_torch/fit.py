"""Inverse-problem harness: multi-start Adam over the differentiable
renderers (PyTorch).

Counterpart of ``curvis_tpu/fit.py``.  ``fit`` minimises ``loss_fn`` from
one or several starts and reports every start's loss history; the JAX
package runs the starts as one vmapped program, here they run one after
the other (the kernels' autograd path does not vmap).  Parameters are a
tensor, or a dict, list or tuple of tensors.

The optimiser is ``torch.optim.Adam`` with optax's defaults (beta1 0.9,
beta2 0.999, eps 1e-8 outside the square root), whose update is
optax.adam's, behind the NaN guard of ``optax.zero_nans``: a NaN gradient
entry is set to zero (infinities are kept), so one knife-edge iteration
skips its update instead of poisoning Adam's moments.  (The JAX package
also takes any optax transformation in place of both; no caller uses
that, and the port leaves it out.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class FitResult:
    """Outcome of :func:`fit`.  ``params`` is the best start's final
    parameters; ``history`` its (iters + 1,) loss curve -- ``history[i]`` is
    the loss before update ``i`` and ``history[-1]`` the loss of the
    RETURNED params; ``all_params`` / ``all_finals`` keep every start
    (leading axis ``n_starts``) for basin analysis."""
    params: Any
    loss: float
    history: np.ndarray
    best_index: int
    all_params: Any
    all_finals: np.ndarray
    all_histories: np.ndarray

    def converged(self, rel_drop=1e-3, window=20):
        """Heuristic: the improvement over the last ``window`` iterations
        is below ``rel_drop`` of the TOTAL improvement.  Non-finite
        histories, fits with no net improvement, and runs whose tail
        climbed away from the best point report False."""
        h = np.asarray(self.history, dtype=np.float64)
        if len(h) <= window or not np.all(np.isfinite(h)):
            return False
        total = float(h[0] - h[-1])
        if total <= 0.0:
            return False
        if float(h[-1]) > float(np.min(h)) + rel_drop * total:
            return False
        recent = abs(float(h[-window] - h[-1]))
        return recent <= rel_drop * total


def _leaves(p):
    if isinstance(p, dict):
        return list(p.values())
    if isinstance(p, (list, tuple)):
        return list(p)
    return [p]


def _rebuild(like, leaves):
    if isinstance(like, dict):
        return dict(zip(like, leaves))
    if isinstance(like, (list, tuple)):
        return type(like)(leaves)
    return leaves[0]


def _one_start(loss_at, p0, aux, lr, project):
    """Adam from ``p0`` for len(aux) iterations -> (final leaves,
    (iters + 1,) loss history)."""
    leaves = [torch.as_tensor(x).detach().clone().requires_grad_(True)
              for x in _leaves(p0)]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    hist = []
    for aux_i in aux:
        v = loss_at(_rebuild(p0, leaves), aux_i)
        grads = torch.autograd.grad(v, leaves, allow_unused=True)
        for x, g in zip(leaves, grads):
            g = torch.zeros_like(x) if g is None else g
            x.grad = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        opt.step()
        if project is not None:
            with torch.no_grad():
                new = _leaves(project(_rebuild(p0, leaves)))
                for x, y in zip(leaves, new):
                    x.copy_(y)
        hist.append(v.detach())
    # hist[i] is the loss BEFORE update i; the final entry is the loss of
    # the returned params, so history[-1] and the finals rank what returns
    with torch.no_grad():
        hist.append(loss_at(_rebuild(p0, leaves), aux[-1]).detach())
    return ([x.detach() for x in leaves],
            torch.stack(hist).to(torch.float64).cpu().numpy())


def fit(loss_fn: Callable, init_params, *, iters=300, lr=1e-2,
        n_starts: int = 1, init_sampler: Optional[Callable] = None,
        schedule: Optional[Callable] = None,
        project: Optional[Callable] = None, seed=0) -> FitResult:
    """Minimise ``loss_fn`` with multi-start Adam.

    ``loss_fn``: ``params -> scalar`` or, with ``schedule``, ``(params,
    aux) -> scalar`` where ``aux = schedule(i)`` for iteration i.
    ``init_params``: the parameters of one start or -- when ``n_starts >
    1`` and no ``init_sampler`` is given -- tensors with a leading
    ``n_starts`` axis.  ``init_sampler``: ``(numpy rng, index) -> params``
    drawing one start from ``numpy.random.default_rng(seed)``, the draws of
    the JAX package.  ``project``: ``params -> params``, applied without
    gradient after every update.
    """
    if iters < 1:
        raise ValueError(f"fit() needs iters >= 1, got {iters}")
    if init_sampler is not None:
        rng = np.random.default_rng(seed)
        starts = [init_sampler(rng, i) for i in range(n_starts)]
    elif n_starts > 1:
        starts = [_rebuild(init_params, [torch.as_tensor(x)[i]
                                         for x in _leaves(init_params)])
                  for i in range(n_starts)]
    else:
        starts = [init_params]
    if schedule is not None:
        aux = [schedule(i) for i in range(iters)]
        loss_at = loss_fn
    else:
        aux = list(range(iters))
        loss_at = lambda p, _aux: loss_fn(p)          # noqa: E731
    runs = [_one_start(loss_at, p0, aux, lr, project) for p0 in starts]
    hists = np.stack([h for _, h in runs])
    finals = hists[:, -1]
    # every start diverged to NaN: return start 0 (loss nan, converged()
    # False) instead of failing
    best = 0 if np.all(np.isnan(finals)) else int(np.nanargmin(finals))
    all_params = _rebuild(starts[0], [torch.stack(xs)
                                      for xs in zip(*(r[0] for r in runs))])
    return FitResult(params=_rebuild(starts[0], runs[best][0]),
                     loss=float(finals[best]), history=hists[best],
                     best_index=best, all_params=all_params,
                     all_finals=finals, all_histories=hists)
