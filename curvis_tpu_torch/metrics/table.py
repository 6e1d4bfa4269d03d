"""User-defined metrics at kernel speed: an r(l) compiled into Chebyshev or
monomial coefficient tables (PyTorch).

Counterpart of ``curvis_tpu/metrics/table.py``.  The planar right-hand
side needs two shape functions, ``inv = 1/r^2(l)`` and
``dr3 = r'(l)/r^3(l)``.  Both decay like powers of 1/l, so l is
compactified,

    w = 1/sqrt(l^2 + s^2),   t = l * w  in (-1, 1),

and the known asymptotics factored out, leaving bounded remainders on
t in [-1, 1]:

    inv(l) = w^2 * H1(t),    H1 = (l^2 + s^2) / r^2
    dr3(l) = w^3 * H2(t),    H2 = (l^2 + s^2)^{3/2} r' / r^3.

H1 and H2 are fitted on Chebyshev-Gauss nodes (numpy, float64) and
evaluated with the Clenshaw recurrence or, where its float32 round-off was
measured small enough at fit time, a converted monomial series by Horner's
rule.  The CUDA kernels of the planar families evaluate the same series in
the same operation order (``csrc/table.cuh``, kind ``kTable``).

The user metric must be asymptotically flat (r ~ |l| + O(1)) and keep
r(l) > 0 everywhere (wormhole-like); ``tabulate_metric`` checks it.

A ``TabulatedMetric`` is an ``nn.Module`` whose buffers are the
coefficients: gradients reach them through every route, and through
``tabulate_metric_diff`` the parameters of a shape r(l) itself.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.utils.device import resolve_device

BASES = ("horner", "clenshaw")


def cheb_eval(coeffs, t):
    """Clenshaw evaluation of a Chebyshev series; ``coeffs`` is any
    indexable of scalars (a 1-D tensor or a sequence of 0-d tensors)."""
    b1 = t * 0.0
    b2 = t * 0.0
    two_t = 2.0 * t
    for k in range(len(coeffs) - 1, 0, -1):
        b1, b2 = coeffs[k] + two_t * b1 - b2, b1
    return coeffs[0] + t * b1 - b2


def horner_eval(coeffs, t):
    """Horner evaluation of a monomial series (same indexable contract)."""
    acc = coeffs[-1] + t * 0.0
    for k in range(len(coeffs) - 2, -1, -1):
        acc = acc * t + coeffs[k]
    return acc


def poly_eval(coeffs, t, basis):
    return horner_eval(coeffs, t) if basis == "horner" else \
        cheb_eval(coeffs, t)


class TabulatedMetric(Metric):
    """Chebyshev-tabulated wormhole-class metric (module docstring): the
    metric protocol computed from the table, so every route evaluates the
    same polynomials.  ``c1``, ``c2``: (K + 1,) coefficients of H1, H2 in
    ``basis`` ('clenshaw' or 'horner'); ``s``: the compactification
    scale."""

    fields = ("c1", "c2", "s")

    def __init__(self, c1, c2, s, basis="clenshaw", *, device=None,
                 dtype=None):
        super().__init__()
        if basis not in BASES:
            raise ValueError(f"basis must be horner|clenshaw, got {basis!r}")
        self.basis = basis
        self._set_fields((c1, c2, s), device, dtype)
        if self.c1.dim() != 1 or self.c1.shape != self.c2.shape:
            raise ValueError("c1 and c2 must be 1-D of one length, got "
                             f"{tuple(self.c1.shape)}, {tuple(self.c2.shape)}")

    def _tw(self, l):
        w = 1.0 / torch.sqrt(l * l + self.s * self.s)
        return l * w, w

    def shape_fns(self, l):
        """(inv, dr3) = (1/r^2, r'/r^3): the planar RHS pair."""
        t, w = self._tw(l)
        w2 = w * w
        return (w2 * poly_eval(self.c1, t, self.basis),
                w2 * w * poly_eval(self.c2, t, self.basis))

    def r_squared(self, l):
        t, w = self._tw(l)
        return 1.0 / ((w * w) * poly_eval(self.c1, t, self.basis))

    def r(self, l):
        return torch.sqrt(self.r_squared(l))

    def r_derivative(self, l):
        inv, dr3 = self.shape_fns(l)
        r2 = 1.0 / inv
        return dr3 * r2 * torch.sqrt(r2)

    @property
    def degree(self):
        return self.c1.shape[0] - 1


def tabulate_metric(metric, *, degree=12, s=None, dtype=torch.float32,
                    check_range=30.0, tol=1e-4, basis="auto", device=None):
    """Fit ``metric`` (any object with r / r_derivative, or a plain
    callable r(l) of torch tensors) into a :class:`TabulatedMetric` of
    ``dtype`` on ``device`` (the current CUDA device unless given).

    Returns ``(tab, report)``: the measured max relative errors of 1/r^2
    and r'/r^3 over |l| <= check_range (r' relative to the function scale
    1/r^2 * r) and the chosen basis.  ``basis``: 'clenshaw', 'horner', or
    'auto', which measures the float32 Horner round-off of the converted
    coefficients and takes Horner only below both tol/4 and the fit error.
    Raises a ValueError if r <= 0 somewhere (not wormhole-class) or the fit
    misses ``tol``.  The user metric is evaluated on float64 tensors."""
    m = _FnMetric(metric) if callable(metric) and not hasattr(metric, "r") \
        else metric
    dev = getattr(m, "device", None) or torch.device("cpu")

    def exact(l):
        l = torch.as_tensor(np.asarray(l, np.float64), device=dev)
        r, rp = m.r(l), m.r_derivative(l)
        return (r.detach().cpu().numpy().astype(np.float64),
                rp.detach().cpu().numpy().astype(np.float64))

    if s is None:
        s, _ = exact(0.0)
        s = float(s)
        if not np.isfinite(s) or s <= 0:
            s = 1.0
    s = float(s)

    # Chebyshev-Gauss nodes in t (interior: no infinities); the map gives
    # |l| up to ~s N / pi, far beyond any escape radius
    N = max(8 * (degree + 1), 512)
    t = np.cos(np.pi * (np.arange(N) + 0.5) / N)
    l_nodes = s * t / np.sqrt(1.0 - t * t)
    r, rp = exact(l_nodes)
    r_probe, _ = exact(np.linspace(-4.0 * s, 4.0 * s, 257))  # holds l = 0
    if not (np.isfinite(r).all() and (r > 0).all()
            and np.isfinite(r_probe).all() and (r_probe > 0).all()):
        raise ValueError(
            "tabulate_metric needs r(l) > 0 everywhere (wormhole-class); "
            f"got min r = {min(np.nanmin(r), np.nanmin(r_probe))}")
    ls2 = l_nodes * l_nodes + s * s
    H1 = ls2 / (r * r)
    H2 = ls2 ** 1.5 * rp / r ** 3
    c1 = np.polynomial.chebyshev.chebfit(t, H1, degree)
    c2 = np.polynomial.chebyshev.chebfit(t, H2, degree)

    # the basis: measured, not guessed
    tg_dense = np.cos(np.pi * (np.arange(4001) + 0.5) / 4001)
    chosen = basis
    if basis in ("auto", "horner"):
        err_h = 0.0
        for c in (c1, c2):
            p = np.polynomial.chebyshev.cheb2poly(c)
            acc = np.full_like(tg_dense, p[-1], np.float32)
            t32 = tg_dense.astype(np.float32)
            for k in range(len(p) - 2, -1, -1):
                acc = acc * t32 + np.float32(p[k])
            ref = np.polynomial.chebyshev.chebval(tg_dense, c)
            err_h = max(err_h, float(np.max(np.abs(acc - ref))
                                     / max(np.max(np.abs(ref)), 1e-30)))
        if basis == "horner" or err_h < tol / 4:
            chosen = "horner"
            c1 = np.polynomial.chebyshev.cheb2poly(c1)
            c2 = np.polynomial.chebyshev.cheb2poly(c2)
        else:
            chosen = "clenshaw"
    elif basis != "clenshaw":
        raise ValueError(f"basis must be horner|clenshaw|auto, got {basis}")

    tab = TabulatedMetric(torch.as_tensor(c1), torch.as_tensor(c2), s,
                          chosen, device=device, dtype=dtype)

    # accuracy on a dense uniform grid of the marching range
    lg = np.linspace(-check_range, check_range, 4001)
    r, rp = exact(lg)
    inv_e, dr3_e = 1.0 / (r * r), rp / r ** 3
    tg = lg / np.sqrt(lg * lg + s * s)
    wg2 = (1.0 - tg * tg) / (s * s)
    ev = (np.polynomial.polynomial.polyval if chosen == "horner"
          else np.polynomial.chebyshev.chebval)
    inv_f = wg2 * ev(tg, np.asarray(c1))
    dr3_f = wg2 ** 1.5 * ev(tg, np.asarray(c2))
    err_inv = float(np.max(np.abs(inv_f - inv_e) / np.abs(inv_e)))
    scale = np.abs(inv_e) * r            # = 1/r^2 * r, the scale of dr3
    err_dr3 = float(np.max(np.abs(dr3_f - dr3_e) / np.maximum(scale, 1e-30)))
    report = {"err_inv_rel": err_inv, "err_dr3_rel": err_dr3,
              "degree": degree, "s": s, "basis": chosen}
    if not (err_inv <= tol and err_dr3 <= tol):       # NaN fails too
        raise ValueError(
            f"tabulate_metric: degree-{degree} fit error "
            f"{max(err_inv, err_dr3):.2e} exceeds tol={tol:g}; raise the "
            f"degree or loosen tol. {report}")
    return tab, report


@functools.lru_cache(maxsize=16)
def _diff_fit_operator(degree: int, n_nodes: int, s: float, basis: str):
    """(FIT matrix, node l values): the Chebyshev-Gauss collocation fit as
    one fixed linear operator from node values to coefficients in
    ``basis`` ('horner' = monomial via cheb2poly, 'clenshaw' = Chebyshev),
    numpy float64, cached per (degree, nodes, s, basis)."""
    t = np.cos(np.pi * (np.arange(n_nodes) + 0.5) / n_nodes)
    l_nodes = s * t / np.sqrt(1.0 - t * t)
    V = np.polynomial.chebyshev.chebvander(t, degree)
    FIT = np.linalg.pinv(V)
    if basis == "horner":
        C2M = np.zeros((degree + 1, degree + 1))
        for j in range(degree + 1):
            e = np.zeros(degree + 1)
            e[j] = 1.0
            pcoef = np.polynomial.chebyshev.cheb2poly(e)
            C2M[:len(pcoef), j] = pcoef
        FIT = C2M @ FIT
    return FIT, l_nodes


def tabulate_metric_diff(r_fn, *, degree=12, s=1.0, n_nodes=128,
                         basis="auto", device=None, dtype=torch.float32):
    """Differentiable twin of :func:`tabulate_metric` for parameterised
    shapes: ``r_fn(l)`` (elementwise in a tensor l) may close over tensors
    that require gradients, and the returned :class:`TabulatedMetric`
    (``dtype`` on ``device``, the current CUDA device unless given)
    carries their gradients through its coefficients.

    The collocation fit is a fixed linear operator on the node values of
    the compactified (1/r^2, r'/r^3), so tabulation is one matrix-vector
    product per series; r' comes from autograd with ``create_graph=True``,
    so that the coefficients of H2 stay differentiable too.  No accuracy
    report or tol gate (validate a final shape with
    :func:`tabulate_metric`).  ``basis='auto'`` picks by degree: 'horner'
    up to degree 16, 'clenshaw' above."""
    if basis == "auto":
        basis = "horner" if degree <= 16 else "clenshaw"
    if basis not in BASES:
        raise ValueError(f"basis must be horner|clenshaw|auto, got {basis}")
    FIT, l_nodes = _diff_fit_operator(int(degree), int(n_nodes), float(s),
                                      basis)
    dev = resolve_device(device)
    fit_t = torch.as_tensor(FIT, dtype=dtype, device=dev)
    with torch.enable_grad():
        ln = torch.as_tensor(l_nodes, dtype=dtype,
                             device=dev).requires_grad_(True)
        r = r_fn(ln)
        (rp,) = torch.autograd.grad(r.sum(), ln, create_graph=True)
        ls2 = ln.detach() * ln.detach() + s * s
        c1 = fit_t @ (ls2 / (r * r))
        c2 = fit_t @ (ls2 ** 1.5 * rp / r ** 3)
    return TabulatedMetric(c1, c2, torch.as_tensor(s, dtype=dtype,
                                                   device=dev),
                           basis, device=dev, dtype=dtype)


class _FnMetric:
    """Adapter: a bare r(l) callable -> the metric protocol, with r' from
    ``torch.func.grad``."""

    device = None

    def __init__(self, r_fn):
        self._r = r_fn

    def r(self, l):
        return self._r(l)

    def r_squared(self, l):
        r = self._r(l)
        return r * r

    def r_derivative(self, l):
        flat = torch.atleast_1d(l).reshape(-1)
        d = torch.func.vmap(torch.func.grad(lambda x: self._r(x).reshape(())))
        return d(flat).reshape(l.shape)
