"""Kerr (rotating) and Kerr-Newman black holes in Boyer-Lindquist
coordinates (PyTorch).

Counterpart of ``curvis_tpu/metrics/kerr.py``; same closed forms.  With
x = (t, r, theta, phi),
    Sigma = r^2 + a^2 cos^2(theta),   Delta = r^2 - 2 M r + a^2 + Q^2,
and hmr = 2 M r - Q^2 in place of 2 M r wherever the mass couples to
Sigma (Q = 0 for Kerr).  Photons are uncharged, so the charge enters their
geodesics only through these two substitutions.  The geodesic equations
come from the Hamiltonian by automatic differentiation
(``physics/hamiltonian.py``); no Christoffel symbols are derived here.

As the metrics of ``metrics/base.py``, a metric is an ``nn.Module`` whose
parameters are 0-d buffers that hold the caller's tensors (a loss built
from ``KerrMetric(m, a=t)`` reaches ``t``), built on the current CUDA
device unless ``device`` is given.
"""
from __future__ import annotations

import torch
from torch import nn

from curvis_tpu_torch.metrics.base import Metric


def _bl_pieces(m, a, q2, x):
    """Common Boyer-Lindquist scalars: (r, sin^2 theta (guarded), Sigma,
    Delta, hmr = 2 M r - Q^2)."""
    r = x[..., 1]
    th = x[..., 2]
    ct = torch.cos(th)
    st2 = torch.clamp(torch.sin(th) ** 2, min=1e-12)
    sigma = r * r + a * a * ct * ct
    delta = r * r - 2.0 * m * r + a * a + q2
    hmr = 2.0 * m * r - q2
    return r, st2, sigma, delta, hmr


def _sym4(tt, rr, thth, phph, tph):
    """(..., 4, 4) from the five independent components of a BL metric."""
    z = torch.zeros_like(tt)
    return torch.stack([torch.stack([tt, z, z, tph], dim=-1),
                        torch.stack([z, rr, z, z], dim=-1),
                        torch.stack([z, z, thth, z], dim=-1),
                        torch.stack([tph, z, z, phph], dim=-1)], dim=-2)


def _bl_metric(m, a, q2, x):
    """Covariant g_{mu nu} -> (..., 4, 4) for Kerr(-Newman)."""
    r, st2, sigma, delta, hmr = _bl_pieces(m, a, q2, x)
    g_tt = -(1.0 - hmr / sigma)
    g_rr = sigma / delta
    g_thth = sigma
    g_phph = (r * r + a * a + hmr * a * a * st2 / sigma) * st2
    g_tph = -hmr * a * st2 / sigma
    return _sym4(g_tt, g_rr, g_thth, g_phph, g_tph)


def _bl_components(m, a, q2, x):
    """The 5 independent contravariant components (g^tt, g^rr, g^thth,
    g^phph, g^tph); g^tph = -a hmr / (Delta Sigma)."""
    r, st2, sigma, delta, hmr = _bl_pieces(m, a, q2, x)
    A = (r * r + a * a) ** 2 - delta * a * a * st2
    inv_ds = 1.0 / (delta * sigma)
    g_tt = -A * inv_ds
    g_rr = delta / sigma
    g_thth = 1.0 / sigma
    g_phph = (delta - a * a * st2) * inv_ds / st2
    g_tph = -hmr * a * inv_ds
    return g_tt, g_rr, g_thth, g_phph, g_tph


def _bl_inverse_metric(m, a, q2, x):
    """Contravariant g^{mu nu} -> (..., 4, 4) (closed form)."""
    return _sym4(*_bl_components(m, a, q2, x))


class _BLMetric(nn.Module):
    """Base of the Boyer-Lindquist metrics: parameter buffers (as
    ``metrics/base.py:Metric``) and the closed forms above; ``q2`` is the
    charge squared (0 for Kerr)."""

    fields: tuple = ()
    _set_fields = Metric._set_fields
    device = Metric.device

    @property
    def q2(self):
        return 0.0

    def metric(self, x):
        """Covariant g_{mu nu} -> (..., 4, 4)."""
        return _bl_metric(self.m, self.a, self.q2, x)

    def inverse_metric(self, x):
        """Contravariant g^{mu nu} -> (..., 4, 4)."""
        return _bl_inverse_metric(self.m, self.a, self.q2, x)

    def inverse_components(self, x):
        """The five contravariant components as separate tensors."""
        return _bl_components(self.m, self.a, self.q2, x)

    @property
    def horizon_radius(self):
        return self.m + torch.sqrt(torch.clamp(
            self.m ** 2 - self.a ** 2 - self.q2, min=0.0))

    @property
    def capture_radius(self):
        return 1.05 * self.horizon_radius


class KerrMetric(_BLMetric):
    """Kerr black hole of mass ``m`` and spin ``a`` (|a| < m)."""

    fields = ("m", "a")

    def __init__(self, m, a, *, device=None, dtype=None):
        super().__init__()
        self._set_fields((m, a), device, dtype)

    def critical_impact_parameter(self, prograde: bool):
        """Equatorial photon-orbit critical |b| = |L/E| (Bardeen):
        b = s a + 6 M cos[(1/3) arccos(s a / M)], s = -1 prograde, +1
        retrograde; a = 0 gives 3 sqrt(3) M."""
        s = -1.0 if prograde else 1.0
        return (s * self.a + 6.0 * self.m
                * torch.cos(torch.arccos(s * self.a / self.m) / 3.0))


class KerrNewmanMetric(_BLMetric):
    """Kerr-Newman (charged, rotating) black hole: the Kerr flow with
    Delta -> Delta + Q^2 and 2 M r -> 2 M r - Q^2 (a^2 + q^2 < m^2)."""

    fields = ("m", "a", "q")

    def __init__(self, m, a, q, *, device=None, dtype=None):
        super().__init__()
        self._set_fields((m, a, q), device, dtype)

    @property
    def q2(self):
        return self.q * self.q


def make_kerr(m=1.0, a=0.6, *, device=None,
              dtype=torch.float32) -> KerrMetric:
    """Validated Kerr metric (the checks of ``curvis_tpu.metrics.kerr.
    make_kerr``), on the current CUDA device unless ``device`` is given."""
    m, a = float(m), float(a)
    if m <= 0:
        raise ValueError("Kerr metric requires m > 0")
    if not (0 <= abs(a) < m):
        raise ValueError("Kerr metric requires |a| < m (sub-extremal)")
    return KerrMetric(m, a, device=device, dtype=dtype)


def make_kerr_newman(m=1.0, a=0.6, q=0.4, *, device=None,
                     dtype=torch.float32) -> KerrNewmanMetric:
    """Validated Kerr-Newman metric, on the current CUDA device unless
    ``device`` is given."""
    m, a, q = float(m), float(a), float(q)
    if m <= 0:
        raise ValueError("Kerr-Newman metric requires m > 0")
    if a * a + q * q >= m * m:
        raise ValueError(
            "Kerr-Newman metric requires a^2 + q^2 < m^2 (sub-extremal)")
    return KerrNewmanMetric(m, a, q, device=device, dtype=dtype)


def photon_shell_constants(metric, r):
    """(xi, eta) = (L/E, Q/E^2) of the spherical photon orbit at BL radius
    ``r`` (Bardeen 1973, with the charge in Delta):
        (r^2 + a^2) - a xi = 4 r Delta / Delta',
        eta = (4 r Delta / Delta')^2 / Delta - (xi - a)^2.
    Degenerate at a = 0 (xi ~ 1/a)."""
    m, a = metric.m, metric.a
    delta = r * r - 2.0 * m * r + a * a + metric.q2
    w = 4.0 * r * delta / (2.0 * r - 2.0 * m)
    xi = (r * r + a * a - w) / a
    eta = w * w / delta - (xi - a) ** 2
    return xi, eta


def shadow_outline(metric, inclination, n=512):
    """Analytic shadow boundary seen by a distant observer at polar
    ``inclination`` -> (alpha, beta), each (n,): alpha = -xi / sin i,
    beta = sqrt(eta + a^2 cos^2 i - xi^2 cot^2 i), over photon-shell radii
    from just outside the horizon to 4M + a/2; radii whose orbits are not
    visible from this inclination give NaN.  Needs a != 0."""
    m = metric.m
    r_h = metric.horizon_radius
    r0 = r_h * (1.0 + 1e-4)
    r1 = 4.0 * m + 0.5 * torch.abs(metric.a)
    t = torch.linspace(0.0, 1.0, n, dtype=m.dtype, device=m.device)
    r = r0 + (r1 - r0) * t
    xi, eta = photon_shell_constants(metric, r)
    inclination = torch.as_tensor(inclination, dtype=m.dtype,
                                  device=m.device)
    si = torch.sin(inclination)
    ci = torch.cos(inclination)
    rad = eta + (metric.a * ci) ** 2 - (xi * ci / si) ** 2
    nan = torch.full_like(rad, float("nan"))
    alpha = torch.where(rad >= 0.0, -xi / si, nan)
    beta = torch.sqrt(torch.where(rad >= 0.0, rad, nan))
    return alpha, beta
