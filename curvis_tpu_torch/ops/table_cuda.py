"""The host side of ``csrc/table.cuh``: the table kind that the kernels of
the planar families take for a tabulated metric (``metrics/table.py``),
the ``ChebTable`` argument their host entries copy into the kernel, and the
plain PyTorch versions of the table's evaluation and of its reverse mode.

A tabulated metric has the kind ``TableKind``: the string ``'table'`` (the
name ``ops/march_cuda.py:KINDS`` numbers as ``kTable``) carrying the two
coefficient series and the basis.  It travels through the same
``(kind, scalar row)`` pairs as the analytic kinds, whose metric slot p0
holds s^2 as in the JAX package's row; the coefficients leave the kind only
as the ``ChebTable`` of a launch, or as 0-d tensors of a plain version.

In the plain versions the metric parameters ``p`` of a table are
``(s^2, c1[0..K], c2[0..K])``, the order of the JAX package's theta, and
every VJP returns its parameter cotangents in that order.
"""
from __future__ import annotations

import ctypes

import torch

from curvis_tpu_torch.metrics.table import poly_eval

MAX_DEGREE = 32          # csrc/table.cuh:kChebMaxDegree
CAP = MAX_DEGREE + 1     # coefficients per series the kernels hold


class ChebTable(ctypes.Structure):
    """csrc/table.cuh:ChebTable, field for field."""
    _fields_ = [("s2", ctypes.c_float), ("n", ctypes.c_int),
                ("horner", ctypes.c_int), ("c1", ctypes.c_float * CAP),
                ("c2", ctypes.c_float * CAP)]


class TableKind(str):
    """The kind ``'table'`` of a tabulated metric with its series ``c1``,
    ``c2`` (Python floats, the metric's precision) and its basis."""

    def __new__(cls, c1, c2, basis):
        kind = super().__new__(cls, "table")
        kind.c1, kind.c2 = tuple(c1), tuple(c2)
        kind.basis = basis
        return kind

    @property
    def n(self):
        """Coefficients per series, degree + 1."""
        return len(self.c1)

    def ctable(self, s2) -> ChebTable:
        """The kernel argument, with s^2 from the scalar row.  Raises a
        ValueError above the kernels' capacity."""
        if self.n > CAP:
            raise ValueError(
                f"the CUDA kernels hold tables up to degree {MAX_DEGREE}; "
                f"this one has degree {self.n - 1}")
        tab = ChebTable(s2=float(s2), n=self.n,
                        horner=int(self.basis == "horner"))
        tab.c1[:self.n] = self.c1
        tab.c2[:self.n] = self.c2
        return tab


def kernel_table(kind, scal):
    """The ``ChebTable`` argument of a launch of ``kind`` with the scalar
    row ``scal`` (s^2 in slot 2), or None for an analytic kind."""
    return kind.ctable(scal[2]) if isinstance(kind, TableKind) else None


def slot_params(kind, row):
    """The metric parameters of a plain version: (p0, p1, p2) of the row
    tensor ``row``, or a table's (s^2, c1..., c2...)."""
    if isinstance(kind, TableKind):
        coef = torch.tensor(kind.c1 + kind.c2, dtype=row.dtype,
                            device=row.device)
        return (row[2], *coef.unbind())
    return row[2], row[3], row[4]


def _series(p):
    """(c1, c2) of a table's parameters (s^2, c1..., c2...)."""
    n = (len(p) - 1) // 2
    return p[1:1 + n], p[1 + n:]


# ------------------------------------------------------ the plain versions

def table_shape(kind, p, l):
    """(inv, dr3) = (1 / r^2, r' / r^3) at ``l``, as csrc/table.cuh:
    table_shape."""
    c1, c2 = _series(p)
    w = 1.0 / torch.sqrt(l * l + p[0])
    t = l * w
    w2 = w * w
    return (w2 * poly_eval(c1, t, kind.basis),
            w2 * w * poly_eval(c2, t, kind.basis))


def table_poly_vjp(c, horner, t, g_y):
    """csrc/table.cuh:table_poly_vjp -> (d/dt, [d/dc[k]])."""
    n = len(c)
    zero = t * 0.0
    if horner:
        seq = [None] * n
        acc = c[n - 1] + zero
        seq[n - 1] = acc
        for k in range(n - 2, -1, -1):
            acc = acc * t + c[k]
            seq[k] = acc
        g_acc, g_t, gc = g_y, torch.zeros_like(t), []
        for k in range(n - 1):
            gc.append(g_acc)
            g_t = g_t + g_acc * seq[k + 1]
            g_acc = g_acc * t
        gc.append(g_acc)
        return g_t, gc
    two_t = 2.0 * t
    b1, b2 = zero, zero
    seq = [None] * (n + 1)
    seq[n], seq[n - 1] = b2, b1
    for k in range(n - 1, 0, -1):
        b1, b2 = c[k] + two_t * b1 - b2, b1
        seq[k - 1] = b1
    gc = [g_y]
    g_t = g_y * seq[0]
    g_b1, g_b2, g_two_t = g_y * t, -g_y, torch.zeros_like(t)
    for k in range(1, n):
        gc.append(g_b1)
        g_two_t = g_two_t + g_b1 * seq[k]
        g_b1, g_b2 = g_b1 * two_t + g_b2, -g_b1
    return g_t + 2.0 * g_two_t, gc


def table_shape_vjp(kind, p, l, g_inv, g_dr3, guard=False):
    """csrc/table.cuh:table_shape_vjp: (inv, dr3, d/dl, d/ds^2,
    [d/dc1[k]] + [d/dc2[k]]) for the cotangents (g_inv, g_dr3); ``guard``
    floors l^2 + s^2 at 1e-12 (the caller clips l)."""
    c1, c2 = _series(p)
    x = l * l + p[0]
    xg = torch.clamp(x, min=1e-12) if guard else x
    q = torch.sqrt(xg)
    w = 1.0 / q
    t = l * w
    w2 = w * w
    w3 = w2 * w
    horner = kind.basis == "horner"
    p1 = poly_eval(c1, t, kind.basis)
    p2 = poly_eval(c2, t, kind.basis)
    g_w3 = g_dr3 * p2
    g_w2 = g_inv * p1 + g_w3 * w
    g_t1, gc1 = table_poly_vjp(c1, horner, t, g_inv * w2)
    g_t2, gc2 = table_poly_vjp(c2, horner, t, g_dr3 * w3)
    g_t = g_t1 + g_t2
    g_w = g_w3 * w2 + g_w2 * 2.0 * w + g_t * l
    g_q = -g_w * w * w
    g_x = g_q * 0.5 / q
    if guard:
        one = torch.ones_like(x)
        g_x = g_x * torch.where(x > 1e-12, one,
                                torch.where(x < 1e-12, 0.0 * one, 0.5 * one))
    return (w2 * p1, w3 * p2, g_t * w + g_x * 2.0 * l, g_x, gc1 + gc2)
