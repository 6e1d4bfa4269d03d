"""Metrics of diagonal, spherically symmetric spacetimes (PyTorch).

Counterpart of ``curvis_tpu/metrics/base.py``.  A metric is a small
``nn.Module`` whose parameters are 0-d tensors registered as buffers, so
``.to(device)`` moves them, and a tensor passed in stays in its caller's
autograd graph: a loss built from ``EllisMetric(rho=t)`` reaches ``t``.
Metrics are built on the current CUDA device unless ``device`` is given
(``device='cpu'`` for the CPU).  It exposes the shape functions
``r(l)``, ``r_squared(l)``, ``r_derivative(l)``; the static black holes add
``lapse``, ``lapse_deriv``, ``radial_B`` and ``capture_radius``.

Coordinates are (t, l, theta, phi); the unit-lapse line element is
    ds^2 = -dt^2 + dl^2 + r(l)^2 (dtheta^2 + sin^2(theta) dphi^2).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from curvis_tpu_torch.utils.device import resolve_device


class Metric(nn.Module):
    """Base class: every metric provides r, r_squared and r_derivative."""

    unit_lapse = True          # g00 = -1, g11 = 1 (the reference family)
    capture_radius = None      # no photon capture
    fields: tuple = ()         # parameter names, in constructor order

    def _set_fields(self, values, device, dtype):
        """Register each value as a 0-d buffer on ``device``.  A tensor is
        moved and cast differentiably, so it stays in its caller's graph."""
        dev = resolve_device(device)
        for name, v in zip(self.fields, values):
            t = (v.to(device=dev, dtype=dtype or v.dtype) if torch.is_tensor(v)
                 else torch.as_tensor(v, dtype=dtype, device=dev))
            self.register_buffer(name, t)

    def r(self, l):
        raise NotImplementedError

    def r_squared(self, l):
        raise NotImplementedError

    def r_derivative(self, l):
        raise NotImplementedError

    @property
    def device(self):
        """Device of the parameters (None for a metric without any)."""
        for t in self.buffers():
            return t.device
        return None


class EllisMetric(Metric):
    """Ellis wormhole: r(l) = sqrt(rho^2 + l^2)."""

    fields = ("rho",)

    def __init__(self, rho, *, device=None, dtype=None):
        super().__init__()
        self._set_fields((rho,), device, dtype)

    def r(self, l):
        return torch.sqrt(self.r_squared(l))

    def r_squared(self, l):
        return self.rho * self.rho + l * l

    def r_derivative(self, l):
        return l / self.r(l)


class InterstellarMetric(Metric):
    """DNEG (Interstellar movie) wormhole, James et al. 2015 eq. (5).

    Mass ``m``, throat half-length ``a``, throat radius ``rho``.  Outside the
    throat (|l| > a), with x = 2(|l| - a) / (pi m):
        r   = rho + m (x atan x - 0.5 ln(1 + x^2))
        r'  = (2/pi) sign(l) atan x
    Inside the throat r = rho, r' = 0.
    """

    fields = ("m", "a", "rho")

    def __init__(self, m, a, rho, *, device=None, dtype=None):
        super().__init__()
        self._set_fields((m, a, rho), device, dtype)

    def _x(self, l):
        return 2.0 * (torch.abs(l) - self.a) / (math.pi * self.m)

    def r(self, l):
        x = self._x(l)
        outside = self.rho + self.m * (x * torch.atan(x)
                                       - 0.5 * torch.log1p(x * x))
        return torch.where(torch.abs(l) > self.a, outside, self.rho)

    def r_squared(self, l):
        r = self.r(l)
        return r * r

    def r_derivative(self, l):
        x = self._x(l)
        outside = (2.0 / math.pi) * torch.sign(l) * torch.atan(x)
        return torch.where(torch.abs(l) > self.a, outside,
                           torch.zeros_like(outside))


class FlatSphericalMetric(Metric):
    """Flat 3-space in polar coordinates: r(l) = l.  Straight-line photon
    propagation — the analytic oracle for the renderer."""

    def r(self, l):
        return l

    def r_squared(self, l):
        return l * l

    def r_derivative(self, l):
        return torch.ones_like(l)


class SchwarzschildMetric(Metric):
    """Schwarzschild black hole, areal radius l = r:
        ds^2 = -A dt^2 + dl^2/A + l^2 dOmega^2,    A(l) = 1 - 2M/l.
    Photons that sink below ``capture_radius`` (between the horizon 2M and
    the photon sphere 3M) are captured (sign 2) and render black."""

    unit_lapse = False
    fields = ("m",)

    def __init__(self, m, *, device=None, dtype=None):
        super().__init__()
        self._set_fields((m,), device, dtype)

    def r(self, l):
        return l

    def r_squared(self, l):
        return l * l

    def r_derivative(self, l):
        return torch.ones_like(l)

    def lapse(self, l):
        return 1.0 - 2.0 * self.m / l

    def lapse_deriv(self, l):
        return 2.0 * self.m / (l * l)

    def radial_B(self, l):
        return 1.0 / self.lapse(l)

    @property
    def capture_radius(self):
        return 2.5 * self.m


class ReissnerNordstromMetric(Metric):
    """Reissner-Nordstrom (charged, non-rotating) black hole:
        A(l) = 1 - 2M/l + Q^2/l^2,  B = 1/A.
    Capture radius midway between the outer horizon and the photon sphere."""

    unit_lapse = False
    fields = ("m", "q")

    def __init__(self, m, q, *, device=None, dtype=None):
        super().__init__()
        self._set_fields((m, q), device, dtype)

    def r(self, l):
        return l

    def r_squared(self, l):
        return l * l

    def r_derivative(self, l):
        return torch.ones_like(l)

    def lapse(self, l):
        return 1.0 - (2.0 * self.m - self.q * self.q / l) / l

    def lapse_deriv(self, l):
        return (2.0 * self.m - 2.0 * self.q * self.q / l) / (l * l)

    def radial_B(self, l):
        return 1.0 / self.lapse(l)

    @property
    def horizon_radius(self):
        return self.m + torch.sqrt(torch.clamp(self.m ** 2 - self.q ** 2,
                                               min=0.0))

    @property
    def photon_sphere_radius(self):
        return 0.5 * (3.0 * self.m
                      + torch.sqrt(9.0 * self.m ** 2 - 8.0 * self.q ** 2))

    @property
    def critical_impact_parameter(self):
        r_ph = self.photon_sphere_radius
        return r_ph / torch.sqrt(self.lapse(r_ph))

    @property
    def capture_radius(self):
        return 0.5 * (self.horizon_radius + self.photon_sphere_radius)


_REGISTRY = {
    "ellis": EllisMetric,
    "interstellar": InterstellarMetric,
    "dneg": InterstellarMetric,
    "flat": FlatSphericalMetric,
    "schwarzschild": SchwarzschildMetric,
    "reissner-nordstrom": ReissnerNordstromMetric,
    "rn": ReissnerNordstromMetric,
}


def make_metric(kind: str, *, device=None, dtype=torch.float32,
                **params) -> Metric:
    """Build a metric by name with validated parameters (the checks of
    ``curvis_tpu.metrics.base.make_metric``), on the current CUDA device
    unless ``device`` is given."""
    kind = kind.lower()
    if kind not in _REGISTRY:
        raise ValueError(f"Unknown metric {kind!r}; known: {sorted(_REGISTRY)}")
    cls = _REGISTRY[kind]
    kw = dict(device=device, dtype=dtype)
    if cls is EllisMetric:
        rho = float(params.get("rho", 1.0))
        if rho <= 0:
            raise ValueError("Ellis metric requires rho > 0.")
        return EllisMetric(rho, **kw)
    if cls is InterstellarMetric:
        m = float(params.get("m", 0.1))
        a = float(params.get("a", 1e-4))
        rho = float(params.get("rho", 1.0))
        for name, v in (("m", m), ("a", a), ("rho", rho)):
            if v <= 0:
                raise ValueError(f"Interstellar metric requires {name} > 0.")
        return InterstellarMetric(m, a, rho, **kw)
    if cls is SchwarzschildMetric:
        m = float(params.get("m", 1.0))
        if m <= 0:
            raise ValueError("Schwarzschild metric requires m > 0.")
        return SchwarzschildMetric(m, **kw)
    if cls is ReissnerNordstromMetric:
        m = float(params.get("m", 1.0))
        q = float(params.get("q", 0.5))
        if m <= 0:
            raise ValueError("Reissner-Nordstrom metric requires m > 0.")
        if abs(q) >= m:
            raise ValueError(
                "Reissner-Nordstrom metric requires |q| < m (sub-extremal).")
        return ReissnerNordstromMetric(m, q, **kw)
    return FlatSphericalMetric()
