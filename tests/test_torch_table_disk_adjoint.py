"""PyTorch port vs the JAX package: gradients of the disk routes with a
tabulated user metric, on the CPU, in float64.

A table's parameters are (s^2, series c1[0..K], series c2[0..K]): they
lead the step twins' theta, as in the JAX package, while the kernels and
their plain versions keep s^2 in the metric slot p0 and add the 2 (K + 1)
series cotangents after each family's theta (``ops/ckpt_surface_cuda.py``).
Held here:

- the plain surface VJPs of the table kind (the Euler thin and volumetric
  steps, kernel #4's tracker and gas iterations) against
  ``torch.func.vjp`` of their twins, the series' cotangents included;
- the plain surface checkpoint pairs against ``integrate/ckpt.py`` under
  autograd on the twins, directly and through the autograd Function's
  kernel-route map onto the table's parameters;
- d loss / d shape through ``tabulate_metric_diff`` and the volumetric
  march (the series in the RHS and in the emission's radius) against
  ``jax.grad`` of the JAX package's march
  (``tests/test_surface_adjoint_planar.py:test_table_metric_vol_grad``),
  Euler and DP5(4);
- ``render_blackhole_disk(differentiable='adjoint')`` with a table against
  the JAX package's ``differentiable='scan'`` render and gradient.
"""
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import vjp

import curvis_tpu as cv
from curvis_tpu.integrate.planar_surface_adjoint import \
    march_planar_vol_adjoint as jax_vol_adjoint
from curvis_tpu.metrics import table as jtable
from curvis_tpu.render import disk as jd

from curvis_tpu_torch import convert
from curvis_tpu_torch.integrate import planar_surface_adjoint as tpsa
from curvis_tpu_torch.metrics import table as ttable
from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
from curvis_tpu_torch.ops import rk45_disk_cuda as r4
from curvis_tpu_torch.ops.disk_vol_cuda import vol_param_slots
from curvis_tpu_torch.ops.march_cuda import metric_kind_and_params
from curvis_tpu_torch.ops.table_cuda import slot_params
from curvis_tpu_torch.render import disk as td

F64 = torch.float64
N = 48
R_ESC = 25.0
RTOL = 1e-5
_VDISK = dict(r_inner=3.0, r_outer=12.0, volumetric=True, h_rel=0.1,
              kappa=2.0, tau_max=8.0)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _scale_err(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _tbell(l):
    rho = 1.0 + 0.35 * torch.tanh(l / 1.4)
    return torch.sqrt(rho * rho + l * l)


@functools.lru_cache(maxsize=None)
def _table(basis):
    """The Bell wormhole's degree-12 table, f64, and its kind."""
    tab, _ = ttable.tabulate_metric(_tbell, degree=12, tol=5e-3, basis=basis,
                                    device="cpu", dtype=F64)
    return tab, metric_kind_and_params(tab)[0]


def _surf(flags):
    disk = td.DiskParams(**_VDISK, t_peak=8000.0,
                         color_mode="blackbody" if flags[0] else "tint")
    row = [disk.r_inner, disk.r_outer] + vol_param_slots(disk)
    if flags[3]:
        row += list(np.random.default_rng(4).uniform(-0.2, 1.0, 27))
    return row


def _split(kind, flags, g):
    """The plain VJPs' per-ray theta (the family's, then the series) ->
    (the metric's cotangents in the twins' order (s^2, c1..., c2...),
    summed over rays; the family's rows from b on)."""
    nt = cs.n_theta(flags)
    metric = torch.cat([g[0].sum()[None], g[nt:].sum(1)])
    assert bool((g[1] == 0).all() and (g[2] == 0).all())
    return metric, g[3:nt]


def _states(seed):
    """Seeded per-ray states on both sheets: (l, psi, p_l, b, c1, c2, nz);
    the planes chosen so that about half the thin steps cross the plane."""
    rng = np.random.default_rng(seed)
    l = rng.uniform(3.0, 11.0, N) * rng.choice([1.0, -1.0], N)
    psi = rng.uniform(0.0, 2 * np.pi, N)
    p_l = rng.normal(size=N)
    b = rng.uniform(-4.0, 4.0, N)
    c2 = rng.uniform(-0.6, 0.6, N)
    c1 = -c2 * np.sin(psi) / np.cos(psi) + 1e-3 * rng.normal(size=N)
    nz = rng.uniform(-0.9, 0.9, N)
    return tuple(_t(a) for a in (l, psi, p_l, b, c1, c2, nz))


# ------------------------------------------------------ the step VJPs

STEP_CASES = {"thin_horner": (None, "horner"),
              "vol_tint_clenshaw": ((False, False, False, False),
                                    "clenshaw"),
              "vol_blackbody_scatter_horner": ((True, False, False, True),
                                               "horner")}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_euler_step_vjps_match_autograd(case):
    """disk_step_vjp_plain / vol_step_vjp_plain of a table (the series'
    cotangents through the RHS and, for the gas, through the emission's
    radius) against torch.func.vjp of the step twins, to 1e-12."""
    flags, basis = STEP_CASES[case]
    tab, kind = _table(basis)
    dt = _t(0.3)
    l, psi, p_l, b, c1, c2, nz = _states(7)
    u, v = torch.cos(psi), torch.sin(psi)
    rng = np.random.default_rng(8)
    if flags is None:
        row = torch.stack([dt, _t(80.0), tab.s * tab.s, _t(0.0), _t(0.0),
                           _t(-1e30), _t(3.0), _t(12.0)])
    else:
        row = torch.cat([torch.stack([dt, _t(80.0), tab.s * tab.s, _t(0.0),
                                      _t(0.0), _t(-1e30)]), _t(_surf(flags))])
        c1, c2 = (_t(0.05 * rng.normal(size=N)) for _ in range(2))
    p = slot_params(kind, row)
    if flags is None:
        hits = [np.where(rng.random(N) < 0.5, 0.0, rng.uniform(3, 9, N))
                for _ in range(3)] + [np.zeros(N)] * 3
        y = (l, psi, p_l, u, v, *map(_t, hits))
        theta = (*p, b, c1, c2, row[6], row[7])
        _, new1, new2 = cs.disk_step(kind, dt, theta, y)
        assert bool(new1.any())
        lam = tuple(_t(rng.normal(size=N)) for _ in range(11))
        _, pull = vjp(lambda th, yy: cs.disk_step(kind, dt, th, yy)[0],
                      theta, y)
        lam_in, g = cs.disk_step_vjp_plain(kind, row, (l, p_l, u, v), new1,
                                           new2, b, c1, c2, lam)
    else:
        y = (l, psi, p_l, u, v, _t(rng.uniform(0, 2, N)),
             *(_t(rng.uniform(0, 1, N)) for _ in range(3)))
        theta = (*p, b, c1, c2, nz, row[6:])
        lam = tuple(_t(rng.normal(size=N)) for _ in range(9))
        _, pull = vjp(lambda th, yy: cs.vol_step(kind, flags, dt, th, yy),
                      theta, y)
        lam_in, g = cs.vol_step_vjp_plain(kind, flags, row,
                                          (l, p_l, u, v, y[5]), b, c1, c2,
                                          nz, lam)
    g_th, g_y = pull(lam)
    for want, got in zip(g_y, lam_in):
        assert _scale_err(_np(want), _np(got)) < 1e-12
    g = torch.stack(g)
    assert g.shape[0] == cs.n_theta(flags, kind)
    metric, fam = _split(kind, flags, g)
    nm = len(p)
    assert _scale_err(_np(torch.stack(g_th[:nm])), _np(metric)) < 1e-12
    assert float(metric[1:].abs().max()) > 0       # the series move
    for i, want in enumerate(g_th[nm:nm + 3 + (flags is not None)]):
        assert _scale_err(_np(want), _np(fam[i])) < 1e-12
    if flags is not None:                          # the emission row
        assert _scale_err(_np(g_th[-1]), _np(fam[4:].sum(1))) < 1e-12


ITER_CASES = {"thin_clenshaw": (None, "clenshaw"),
              "vol_scatter_horner": ((False, False, False, True), "horner")}


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_rk45_iter_vjps_match_autograd(case):
    """The table kind's DP5(4) surface iteration VJPs (the tracker and the
    gas, the clamps' radius through the series too) against torch.func.vjp
    of kernel #4's plain surface iteration, both controller modes."""
    flags, basis = ITER_CASES[case]
    tab, kind = _table(basis)
    l, psi, p_l, b, c1, c2, nz = _states(9)
    rng = np.random.default_rng(10)
    psi = torch.atan2(-c1, c2) + _t(rng.uniform(-0.03, 0.01, N))  # zq ~ 0
    dt = np.exp(rng.uniform(np.log(0.02), np.log(0.8), N))
    dt[:8] = rng.uniform(3.0, 8.0, 8)                 # rejected trials
    dt = _t(dt)
    if flags is None:
        _, scal = r4.rk45_disk_scalars(tab, 0.2, R_ESC, RTOL, RTOL * 1e-3,
                                       10.0, disk=(3.0, 12.0))
        extra = [_t(np.where(rng.random(N) < 0.5, rng.uniform(3, 9, N),
                             0.0)) for _ in range(3)] + [_t(np.zeros(N))] * 3
    else:
        disk = td.DiskParams(**_VDISK, t_peak=8000.0)
        block = np.random.default_rng(4).uniform(-0.2, 1.0, 27)
        _, scal = r4.rk45_disk_scalars(tab, 0.2, R_ESC, RTOL, RTOL * 1e-3,
                                       10.0, vol_disk=disk,
                                       scatter_block=block)
        extra = [_t(rng.uniform(0.0, 0.3, N))] + [
            _t(rng.uniform(0.0, 0.1, N)) for _ in range(3)]
    row = _t(scal)
    y = (l, psi, p_l, dt, *extra)
    theta = r4.surface_theta(flags, row, b, c1, c2, nz, kind)
    y1, (_, accept, new1, new2) = r4.rk45_surface_iter_plain(kind, flags,
                                                            row, theta, y)
    assert bool(accept.any()) and bool((~accept).any())
    lam = tuple(_t(c) for c in np.random.default_rng(14).standard_normal(
        (len(y), N)))
    nm = len(theta) - 5
    for freeze in (False, True):
        _, pull = vjp(lambda th, yy: r4.rk45_surface_iter_plain(
            kind, flags, row, th, yy, freeze)[0], theta, y)
        g_th, g_y = pull(lam)
        if flags is None:
            lam_in, g = cs.rk45_thin_iter_vjp_plain(
                kind, row, y[:4], new1, new2, b, c1, c2, lam, freeze)
        else:
            lam_in, g = cs.rk45_vol_iter_vjp_plain(
                kind, flags, row, y[:5], b, c1, c2, nz, lam, freeze)
        tol = 1e-12 if freeze else 1e-9
        for want, got in zip(g_y, lam_in):
            assert _scale_err(_np(want), _np(got)) <= tol
        metric, fam = _split(kind, flags, torch.stack(g))
        assert _scale_err(_np(torch.stack(g_th[:nm])), _np(metric)) <= tol
        for i in range(3 + (flags is not None)):     # b, c1, c2, (nz)
            assert _scale_err(_np(g_th[nm + i]), _np(fam[i])) <= tol


# ---------------------------------------------------- the plain pairs

@pytest.mark.parametrize("stepper", ["euler", "rk45"])
def test_plain_pairs_match_twin_backward(stepper):
    """The table kind's plain checkpoint pairs (the Euler gas in tint, the
    DP5(4) tracker) against integrate/ckpt.py under autograd on the twins,
    over marches of several segments, with the Function's fate policy."""
    tab, kind = _table("horner")
    rng = np.random.default_rng(11)
    n = 24
    l0 = _t(np.full(n, 14.0))
    psi0 = _t(rng.uniform(0, 2 * np.pi, n))
    alpha = np.pi - (0.12 + 0.5 * rng.random(n))
    p_l0 = _t(np.cos(alpha))
    b = tab.r(l0) * _t(np.sin(alpha))
    c1, c2 = _t(0.3 * rng.normal(size=n)), _t(0.3 * rng.normal(size=n))
    nz = _t(rng.uniform(-0.9, 0.9, n))
    state = (l0, psi0, p_l0)
    if stepper == "euler":
        flags = (False, False, False, False)
        surf = _t(_surf(flags))
        dt = 0.1
        with torch.no_grad():
            outs = tpsa._forward_twin_route(tab, flags, dt, 200, R_ESC,
                                            *state, b, c1, c2, nz, surf)
        counts = outs[4]
        scal = [dt, R_ESC, float(tab.s) ** 2, 0.0, 0.0, -1e30] + _surf(flags)
        rk = None
    else:
        flags = None
        surf = _t([3.0, 12.0])
        dt = 0.2
        rk = (RTOL, RTOL * 1e-3, 1e-6, 10.0, 96, 16, False)
        with torch.no_grad():
            outs, counts = tpsa._forward_twin_rk45_route(
                tab, flags, dt, 300, R_ESC, rk, *state, b, c1, c2, nz, surf)
        _, scal = r4.rk45_disk_scalars(tab, dt, R_ESC, RTOL, RTOL * 1e-3,
                                       10.0, disk=(3.0, 12.0))
    sign = outs[3]
    counts = torch.where(sign != 3, counts, torch.zeros_like(counts))
    assert int(counts.max()) > 32                  # several segments
    ns = cs.n_state(flags) if rk is None else cs.n_state_rk45(flags)
    cot = _t(np.random.default_rng(16).standard_normal((ns, n)))
    cot[3:5 if rk is None else 4] = 0.0           # (u, v) or dt: none
    cot[:3] = torch.where(sign.abs() <= 1, cot[:3], torch.zeros_like(cot[:3]))
    want = tpsa._backward_twin(300 if rk else 200, rk, tab, flags, dt, R_ESC,
                               surf, *state, b, c1, c2, nz, counts,
                               tuple(cot))
    if rk is None:
        g, lam = cs.ckpt_surface_backward_cuda(
            kind, flags, scal, state, b, c1, c2, nz, counts.to(torch.int32),
            cot, seg=16)
    else:
        g, lam = cs.ckpt_surface_rk45_backward_cuda(
            kind, flags, scal, False, state, b, c1, c2, nz,
            counts.to(torch.int32), cot)
    for a, c in zip(want[-1], lam):
        assert _scale_err(_np(a), _np(c)) <= 1e-8
    metric, fam = _split(kind, flags, g)
    assert _scale_err(_np(torch.stack(want[0])), _np(metric)) <= 1e-8
    assert float(metric[1:].abs().max()) > 0
    for i, w in enumerate(want[1:4]):                # b, c1, c2
        assert _scale_err(_np(w), _np(fam[i])) <= 1e-8
    k0 = 4 if flags is not None else 3
    assert _scale_err(_np(want[5]), _np(fam[k0:].sum(1))) <= 1e-8


@pytest.mark.parametrize("stepper", ["euler", "rk45"])
def test_kernel_route_backward_matches_twin(stepper):
    """The autograd Function's kernel route backward (on the CPU the
    kernels' plain pairs, then the Function's map of the per-ray theta
    onto the table's parameters, b, c1, c2, nz and the surface row)
    against its twin route on the same inputs: the Euler thin disk and
    the DP5(4) gas in tint, the two families the plain-pair test above
    leaves out."""
    tab, _ = _table("clenshaw")
    rng = np.random.default_rng(21)
    n = 24
    l0 = _t(np.full(n, 14.0))
    psi0 = _t(rng.uniform(0, 2 * np.pi, n))
    alpha = np.pi - (0.12 + 0.5 * rng.random(n))
    pl0 = _t(np.cos(alpha))
    b = tab.r(l0) * _t(np.sin(alpha))
    c1, c2 = _t(0.3 * rng.normal(size=n)), _t(0.3 * rng.normal(size=n))
    nz = _t(rng.uniform(-0.9, 0.9, n))
    if stepper == "euler":
        flags, rk, dt, steps = None, None, 0.1, 200
        surf = _t([3.0, 12.0])
        outs = tpsa._forward_twin_route(tab, flags, dt, steps, R_ESC, l0,
                                        psi0, pl0, b, c1, c2, nz, surf)
        counts = outs[4]
    else:
        flags, dt, steps = (False, False, False, False), 0.2, 300
        rk = (RTOL, RTOL * 1e-3, 1e-6, 10.0, 96, 16, False)
        surf = _t(_surf(flags))
        outs, counts = tpsa._forward_twin_rk45_route(
            tab, flags, dt, steps, R_ESC, rk, l0, psi0, pl0, b, c1, c2, nz,
            surf)
    sign = outs[3]
    counts = torch.where(sign != 3, counts, torch.zeros_like(counts))
    assert int(counts.max()) > 32                  # several segments
    ns = cs.n_state(flags) if rk is None else cs.n_state_rk45(flags)
    cot = _t(np.random.default_rng(22).standard_normal((ns, n)))
    cot[3:5 if rk is None else 4] = 0.0           # (u, v) or dt: none
    cot[:3] = torch.where(sign.abs() <= 1, cot[:3], torch.zeros_like(cot[:3]))
    args = (tab, flags, dt, R_ESC, surf, l0, psi0, pl0, b, c1, c2, nz,
            counts.to(torch.int32), tuple(cot))
    want = tpsa._backward_twin(steps, rk, *args)
    g_theta, lam = (tpsa._backward_kernel(*args) if rk is None
                    else tpsa._backward_kernel_rk45(rk, *args))
    got = tpsa._kernel_theta_grads(tab, flags, g_theta, surf.shape[0])
    assert len(got[0]) == len(want[0]) == 1 + 2 * tab.c1.shape[0]
    assert _scale_err(_np(torch.stack(want[0])),
                      _np(torch.stack(got[0]))) <= 1e-8
    assert float(torch.stack(got[0])[1:].abs().max()) > 0
    for w, g in zip(want[1:6], got[1:]):          # b, c1, c2, nz, surf
        if w is None:
            assert g is None and flags is None
            continue
        assert _scale_err(_np(w), _np(g)) <= 1e-8
    for a, c in zip(want[-1], lam):
        assert _scale_err(_np(a), _np(c)) <= 1e-8


# -------------------------------------- d loss / d shape against JAX

def _fan(n=16, seed=2):
    rng = np.random.default_rng(seed)
    alpha = np.pi - (0.12 + 0.5 * rng.random(n))
    ang = rng.random(n) * 2 * np.pi
    return (np.full(n, 18.0), np.zeros(n), alpha, 0.3 * np.cos(ang),
            0.8 * np.sin(ang) + 0.1, 0.5 + 0.4 * rng.random(n))


@pytest.mark.parametrize("stepper", ["euler", "rk45"])
def test_shape_gradient_vol_matches_jax(stepper):
    """d(sum of the gas emission and depth)/d(throat radius) through
    tabulate_metric_diff, the table in the RHS and in the emission's
    radius, and march_planar_vol_adjoint, against jax.grad of the JAX
    package's march (tests/test_surface_adjoint_planar.py:
    test_table_metric_vol_grad) on the same fan of rays."""
    l0, psi0, alpha, c1, c2, nz = _fan()
    kw = dict(dt=0.1, max_steps=400, escape_radius=25.0)
    if stepper == "rk45":
        kw.update(max_steps=150, rtol=1e-6)

    def jloss(rho):
        met = jtable.tabulate_metric_diff(
            lambda l: jnp.sqrt(rho * rho + l * l), degree=8, s=1.0)
        lj = jnp.asarray(l0)
        out = jax_vol_adjoint(
            met, (lj, jnp.asarray(psi0), jnp.cos(jnp.asarray(alpha))),
            met.r(lj) * jnp.sin(jnp.asarray(alpha)), jnp.asarray(c1),
            jnp.asarray(c2), jnp.asarray(nz), jd.DiskParams(**_VDISK),
            stepper=stepper, backend="xla", **kw)
        tau, em = out[5]
        return jnp.sum(em[0]) + 0.1 * jnp.sum(tau)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(1.2))
    rho = _t(1.2).requires_grad_()
    met = ttable.tabulate_metric_diff(lambda l: torch.sqrt(rho * rho + l * l),
                                      degree=8, s=1.0, device="cpu",
                                      dtype=F64)
    lt = _t(l0)
    out = tpsa.march_planar_vol_adjoint(
        met, (lt, _t(psi0), torch.cos(_t(alpha))),
        met.r(lt) * torch.sin(_t(alpha)), _t(c1), _t(c2), _t(nz),
        td.DiskParams(**_VDISK), stepper=stepper, **kw)
    tau, em = out[5]
    loss = torch.sum(em[0]) + 0.1 * torch.sum(tau)
    (g,) = torch.autograd.grad(loss, rho)
    assert float(tau.detach().max()) > 0.1
    assert abs(float(loss.detach()) - float(jl)) <= 1e-9 * abs(float(jl))
    assert abs(float(g) - float(jg)) <= 1e-7 * abs(float(jg)), (g, jg)


def test_render_differentiable_table_matches_jax():
    """render_blackhole_disk(differentiable='adjoint') of a table's thin
    disk (the twin pair on the CPU): image and d(weighted image)/d(shape
    parameters, brightness) against the JAX package's
    differentiable='scan' render and jax.grad."""
    res = (16, 10)
    th_c = math.pi / 2 - 0.4
    w, h = 48, 27
    yy, xx = np.mgrid[0:h, 0:w]
    sky = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                    0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    jb = cv.make_spherical_image(sky, dtype=jnp.float64)
    jc = cv.make_camera([0.0, 14.0, th_c, 0.0],
                        [-np.sin(th_c), 0.0, -np.cos(th_c)], [0.0, 0.0, 1.0],
                        30.0, 43.0, *res, dtype=jnp.float64)
    tb = convert.spherical_image_from_arrays(
        np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
        dtype=F64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        *res, device="cpu", dtype=F64)
    kw = dict(dt=0.2, max_steps=200, escape_radius=25.0)
    weights = np.random.default_rng(13).random((res[1], res[0], 3))
    th0 = np.array([0.1, 0.2, -0.1, 0.8])

    def jloss(t):
        def r(l):
            u = jnp.tanh(l / 1.5)
            rho = jnp.exp(t[0] + t[1] * u + t[2] * u * u)
            return jnp.sqrt(rho * rho + l * l)
        tab = jtable.tabulate_metric_diff(r, degree=8)
        img = jd.render_blackhole_disk(
            tab, jc, jb, disk=jd.DiskParams(r_inner=2.0, r_outer=9.0),
            differentiable="scan", disk_theta={"brightness": t[3]}, **kw)
        return jnp.sum(img * weights), img

    # eager: jit lets XLA regroup the series' arithmetic (3e-7 here)
    (_, jimg), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(th0))
    theta = _t(th0).requires_grad_()

    def r_fn(l):
        u = torch.tanh(l / 1.5)
        rho = torch.exp(theta[0] + theta[1] * u + theta[2] * u * u)
        return torch.sqrt(rho * rho + l * l)
    tab = ttable.tabulate_metric_diff(r_fn, degree=8, device="cpu",
                                      dtype=F64)
    img = td.render_blackhole_disk(
        tab, tc, tb, disk=td.DiskParams(r_inner=2.0, r_outer=9.0),
        differentiable="adjoint", disk_theta={"brightness": theta[3]}, **kw)
    (g,) = torch.autograd.grad(torch.sum(img * _t(weights)), theta)
    assert _scale_err(np.asarray(jimg), _np(img)) < 1e-10
    assert _scale_err(np.asarray(jg), _np(g)) < 1e-8
    assert bool((g.abs() > 0).all())
