"""PyTorch port vs the JAX package: the differentiable rk45 disk marches
(the rk45 half of ``integrate/planar_surface_adjoint.py``) and the plain
versions of their checkpoint kernels (``ops/ckpt_surface_cuda.py``), on
the CPU in float64.

Held against their JAX counterparts on the same numpy inputs:

- the twin iteration ``_pl_rk45_surface_iter`` against JAX's, one
  iteration on seeded states near the plane (crossings into empty and
  filled hit slots, emission, rejects, stalls), the disk tracker and the
  volumetric flag sets, values and VJPs in both controller modes: values
  to 1e-13 of the outputs' scale (DNEG 1e-5: the JAX closure's atan
  polynomial), VJPs to 1e-9 with the controller on and 1e-11 frozen (see
  tests/test_torch_rk45_adjoint.py for why the controller chain is
  ill-conditioned);
- the kernels' hand-written iteration VJPs (``rk45_thin_iter_vjp_plain``,
  ``rk45_vol_iter_vjp_plain``) against ``torch.func.vjp`` of kernel #4's
  plain surface iteration (``ops/rk45_disk_cuda.py:
  rk45_surface_iter_plain``), to the same tolerances;
- the plain rk45 surface checkpoint pair against ``integrate/ckpt.py``
  under autograd on the twin, to 1e-8;
- ``render_blackhole_disk(stepper='rk45', differentiable='adjoint')``
  against JAX ``differentiable='scan'`` at 32 x 18, thin and volumetric:
  images to 1e-8 and gradients w.r.t. (M, brightness, kappa) to 1e-7
  relative (the f64 XLA loop rounds some operations otherwise, which the
  adaptive march amplifies, as in the bare march); True takes the
  'adjoint' route and 'scan' the twin pair (on the CPU both routes are
  the twin pair).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vjp

import curvis_tpu as cv
from curvis_tpu.integrate import planar_surface_adjoint as jpsa
from curvis_tpu.metrics.base import SchwarzschildMetric as JSchwarzschild
from curvis_tpu.render import disk as jd

from curvis_tpu_torch import convert
from curvis_tpu_torch.integrate import planar_surface_adjoint as tpsa
from curvis_tpu_torch.metrics.base import SchwarzschildMetric
from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
from curvis_tpu_torch.ops import rk45_disk_cuda as r4
from curvis_tpu_torch.ops.disk_vol_cuda import vol_param_slots
from curvis_tpu_torch.render import disk as td

F64 = torch.float64
SLOTS = {"schwarzschild": (1.0, 0.0, 0.0), "rn": (1.0, 0.36, 0.0),
         "ellis": (1.0, 0.0, 0.0), "interstellar": (0.1, 0.5, 1.0)}
LAPSE = ("schwarzschild", "rn")
R_CAP = {"schwarzschild": 2.0, "rn": 1.8}
N = 48
R_ESC = 25.0
DT0 = 0.05
RTOL = 1e-5
_VDISK = dict(r_inner=3.0, r_outer=12.0, volumetric=True, h_rel=0.15,
              kappa=4.0)
# (kind, flags): None is the disk tracker, else (blackbody, redshift,
# doppler, scatter)
FAMILIES = [("schwarzschild", None), ("schwarzschild", (False, True, True,
                                                        False)),
            ("schwarzschild", (True, True, True, False)),
            ("schwarzschild", (True, False, False, True)), ("rn", None),
            ("rn", (True, True, True, False)), ("ellis", None),
            ("ellis", (False, False, False, False)), ("interstellar", None)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _np(t):
    return t.detach().cpu().numpy()


def _scale_err(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _surf(flags):
    """The surf row: (r_in, r_out) for the tracker; the band, the 8 slots
    and, with scatter, a seeded block for vol."""
    if flags is None:
        return [3.0, 12.0]
    disk = td.DiskParams(**_VDISK, t_peak=8000.0,
                         color_mode="blackbody" if flags[0] else "tint")
    row = [disk.r_inner, disk.r_outer] + vol_param_slots(disk)
    if flags[3]:
        row += list(np.random.default_rng(4).uniform(-0.2, 1.0, 27))
    return row


def _states(kind, flags, seed):
    """Seeded (l, psi, p_l, dt, extras, b, c1, c2, nz): rays near the plane
    inside the band, a sixth stepping far (reject), a sixth at the dt
    floor (stall), a sixth near R (escape); half the tracker's first hit
    slots filled; optical depths up to near tau_max."""
    rng = np.random.default_rng(seed)
    sheet = 1.0 if kind in LAPSE else rng.choice([1.0, -1.0], N)
    l = rng.uniform(4.0, 11.0, N) * sheet
    k = N // 6
    l[-k:] = (R_ESC - rng.uniform(0.01, 0.2, k)) * sheet[-k:] \
        if kind not in LAPSE else R_ESC - rng.uniform(0.01, 0.2, k)
    p_l = rng.uniform(-1.0, 1.0, N)
    p_l[-k:] = np.abs(p_l[-k:]) * np.sign(l[-k:]) + 0.2 * np.sign(l[-k:])
    b = rng.uniform(0.5, 4.0, N)
    c2 = rng.uniform(0.3, 0.9, N)
    c1 = rng.uniform(-0.6, 0.6, N)
    psi = np.arctan2(-c1, c2) + rng.uniform(-0.03, 0.01, N)  # zq ~ 0
    dt = np.exp(rng.uniform(np.log(0.02), np.log(0.8), N))
    dt[:k] = rng.uniform(3.0, 8.0, k)
    dt[k:2 * k] = 1e-6
    nz = rng.uniform(-0.9, 0.9, N)
    if flags is None:
        filled = rng.random(N) < 0.5
        h = [np.where(filled, rng.uniform(3.0, 9.0, N), 0.0)
             for _ in range(3)] + [np.zeros(N)] * 3
    else:
        tau = rng.uniform(0.0, 0.3, N)
        tau[2 * k: 3 * k] = 7.99
        h = [tau] + [rng.uniform(0.0, 0.1, N) for _ in range(3)]
    return (l, psi, p_l, dt, *h), b, c1, c2, nz


def _consts(kind):
    return (RTOL, RTOL * 1e-3, 1e-6, 10.0, R_ESC, R_CAP.get(kind, -1e30),
            DT0)


# ------------------------------------------------------- one iteration

@pytest.mark.parametrize("kind,flags", FAMILIES)
def test_twin_iteration_matches_jax(kind, flags):
    y, b, c1, c2, nz = _states(kind, flags, seed=11)
    surf = _surf(flags)
    vol = flags is not None
    cot = np.random.default_rng(12).standard_normal((len(y), N))
    cot[3] = 0.0
    fl = flags or (False, False, False, False)
    dneg = kind == "interstellar"
    for freeze in (False, True):
        cj = tuple(jnp.asarray(c) for c in _consts(kind))

        def fj(theta, yy):
            return jpsa._pl_rk45_surface_iter(kind, cj, theta, yy, not vol,
                                              vol, *fl[:3], freeze)[0]

        theta_j = (tuple(jnp.asarray(s) for s in SLOTS[kind])
                   + tuple(jnp.asarray(a) for a in (b, c1, c2))
                   + ((jnp.asarray(nz),) if vol else ())
                   + tuple(jnp.asarray(s) for s in surf))
        out_j, pull_j = jax.vjp(fj, theta_j, tuple(jnp.asarray(a)
                                                   for a in y))
        g_theta_j, g_y_j = pull_j(tuple(jnp.asarray(c) for c in cot))
        ct = tuple(_t(c) for c in _consts(kind))

        def ft(theta, yy):
            return tpsa._pl_rk45_surface_iter(kind, flags, ct, theta, yy,
                                              freeze)[0]

        theta_t = (tuple(_t(s) for s in SLOTS[kind])
                   + tuple(_t(a) for a in (b, c1, c2))
                   + ((_t(nz),) if vol else ()) + (_t(surf),))
        out_t, pull_t = vjp(ft, theta_t, tuple(_t(a) for a in y))
        g_theta_t, g_y_t = pull_t(tuple(_t(c) for c in cot))
        for a, c in zip(out_j, out_t):
            assert _scale_err(a, _np(c)) <= (1e-5 if dneg else 1e-13)
        tol = 1e-4 if dneg else (1e-11 if freeze else 1e-9)
        for a, c in zip(g_y_j, g_y_t):
            assert _scale_err(a, _np(c)) <= tol
        n_per = 6 + vol
        for a, c in zip(g_theta_j[3:n_per], g_theta_t[3:n_per]):
            assert _scale_err(a, _np(c)) <= tol
        want = np.array([float(v) for v in g_theta_j[n_per:]])
        assert _scale_err(want, _np(g_theta_t[n_per])) <= tol
        if kind in LAPSE:
            assert abs(float(g_theta_j[0]) - float(g_theta_t[0])) <= tol * \
                max(abs(float(g_theta_j[0])), 1.0)


def _plain_inputs(kind, flags, seed, dt0=DT0):
    y, b, c1, c2, nz = _states(kind, flags, seed)
    met = {"schwarzschild": lambda: SchwarzschildMetric(1.0, device="cpu",
                                                        dtype=F64)}.get(
        kind, lambda: convert.metric_from_arrays(
            kind, device="cpu", dtype=F64,
            **{"rn": dict(m=np.float64(1.0), q=np.float64(0.6)),
               "ellis": dict(rho=np.float64(1.0)),
               "interstellar": dict(m=np.float64(0.1), a=np.float64(0.5),
                                    rho=np.float64(1.0))}[kind]))()
    if flags is None:
        _, scal = r4.rk45_disk_scalars(met, dt0, R_ESC, RTOL, RTOL * 1e-3,
                                       10.0, disk=(3.0, 12.0))
    else:
        disk = td.DiskParams(**_VDISK, t_peak=8000.0,
                             color_mode="blackbody" if flags[0] else "tint",
                             redshift=flags[1], doppler=flags[2])
        block = (np.random.default_rng(4).uniform(-0.2, 1.0, 27)
                 if flags[3] else None)
        _, scal = r4.rk45_disk_scalars(met, dt0, R_ESC, RTOL, RTOL * 1e-3,
                                       10.0, vol_disk=disk,
                                       scatter_block=block)
    return (met, _t(scal), tuple(_t(a) for a in y),
            *(_t(a) for a in (b, c1, c2, nz)))


@pytest.mark.parametrize("kind,flags", FAMILIES)
def test_iter_vjp_plain_matches_autograd(kind, flags):
    """The kernels' hand-written iteration VJPs against torch.func.vjp of
    kernel #4's plain surface iteration, both controller modes."""
    _, row, y, b, c1, c2, nz = _plain_inputs(kind, flags, seed=13)
    theta = r4.surface_theta(flags, row, b, c1, c2, nz, kind)
    y1, (_, accept, new1, new2) = r4.rk45_surface_iter_plain(kind, flags,
                                                            row, theta, y)
    assert bool(accept.any()) and bool((~accept).any())
    if flags is None:
        assert bool(new1.any()) and bool(new2.any())
    else:
        assert float(y1[5].abs().max()) > 0.0
    lam = tuple(_t(c) for c in np.random.default_rng(14).standard_normal(
        (len(y), N)))
    for freeze in (False, True):
        _, pull = vjp(lambda th, yy: r4.rk45_surface_iter_plain(
            kind, flags, row, th, yy, freeze)[0], theta, y)
        g_theta, g_y = pull(lam)
        if flags is None:
            lam_in, g = cs.rk45_thin_iter_vjp_plain(
                kind, row, y[:4], new1, new2, b, c1, c2, lam, freeze)
        else:
            lam_in, g = cs.rk45_vol_iter_vjp_plain(
                kind, flags, row, y[:5], b, c1, c2, nz, lam, freeze)
        tol = 1e-12 if freeze else 1e-9
        for want, got in zip(g_y, lam_in):
            assert _scale_err(_np(want), _np(got)) <= tol
        for i in range(3, 6 + (flags is not None)):     # b, c1, c2, (nz)
            assert _scale_err(_np(g_theta[i]), _np(g[i])) <= tol
        # the scalar-row entries: the metric slots and the surf row, which
        # the per-ray cotangents sum into
        k0 = 6 + (flags is not None)
        want = np.concatenate([[float(g_theta[i]) for i in range(3)],
                               _np(g_theta[k0]) if flags is not None
                               else [float(g_theta[6]), float(g_theta[7])]])
        got = np.concatenate([[float(g[i].sum()) for i in range(3)],
                              [float(g[i].sum()) for i in range(
                                  k0, len(g))]])
        assert _scale_err(want, got) <= tol


@pytest.mark.parametrize("kind,flags,freeze", [
    ("schwarzschild", None, False),
    ("schwarzschild", (True, True, True, False), True),
    ("ellis", (False, False, False, True), False)])
def test_plain_pair_matches_twin_backward(kind, flags, freeze):
    """The plain rk45 surface checkpoint pair against integrate/ckpt.py
    under autograd on the twin, over marches of up to 96 iterations from
    the seeded states (dt0 0.2: the plane clamp keeps base steps near the
    disk), with the Function's fate policy."""
    dt0 = 0.2
    met, row, y, b, c1, c2, nz = _plain_inputs(kind, flags, seed=15,
                                               dt0=dt0)
    state = tuple(a.clone() for a in y[:3])
    scal = row.tolist()
    surf = row[9:]
    rk = (RTOL, RTOL * 1e-3, 1e-6, 10.0, 96, 16, freeze)
    with torch.no_grad():
        outs, iters = tpsa._forward_twin_rk45_route(
            met, flags, dt0, 300, R_ESC, rk, *state, b, c1, c2, nz, surf)
    sign = outs[3]
    counts = torch.where(sign != 3, iters, torch.zeros_like(iters))
    assert int(counts.max()) > 16                 # several segments
    ns = cs.n_state_rk45(flags)
    cot = _t(np.random.default_rng(16).standard_normal((ns, N)))
    cot[3] = 0.0
    cot[:3] = torch.where(sign.abs() <= 1, cot[:3],
                          torch.zeros_like(cot[:3]))
    want = tpsa._backward_twin(300, rk, met, flags, dt0, R_ESC, surf,
                               *state, b, c1, c2, nz, counts, tuple(cot))
    g, lam = cs.ckpt_surface_rk45_backward_cuda(
        kind, flags, scal, freeze, state, b, c1, c2, nz,
        counts.to(torch.int32), cot)
    for a, c in zip(want[-1], lam):
        assert _scale_err(_np(a), _np(c)) <= 1e-8
    for i, w in ((3, want[1]), (4, want[2]), (5, want[3])):
        assert _scale_err(_np(w), _np(g[i])) <= 1e-8
    k0 = 7 if flags is not None else 6
    assert _scale_err(_np(want[5]), _np(g[k0:].sum(1))) <= 1e-8
    for i in range(3):
        assert abs(float(want[0][i]) - float(g[i].sum())) <= 1e-8 * max(
            abs(float(want[0][i])), 1e-12)
    assert float(g[0].abs().max()) > 0


# ------------------------------------------------------- the render route

RES = (32, 18)
TH = math.pi / 2 - 0.4
_RENDER = dict(dt=0.2, max_steps=240, escape_radius=25.0, stepper="rk45",
               rtol=1e-6)


def _smooth_sky():
    w, h = 48, 27
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                     0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)


@functools.lru_cache(maxsize=None)
def _render_scene():
    jb = cv.make_spherical_image(_smooth_sky(), dtype=jnp.float64)
    jc = cv.make_camera([0.0, 18.0, TH, 0.0],
                        [-np.sin(TH), 0.0, -np.cos(TH)], [0.0, 0.0, 1.0],
                        30.0, 43.0, *RES, dtype=jnp.float64)
    tb = convert.spherical_image_from_arrays(
        np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
        dtype=F64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        *RES, device="cpu", dtype=F64)
    return jb, jc, tb, tc


@functools.lru_cache(maxsize=None)
def _jax_render(vol):
    jb, jc, _, _ = _render_scene()
    disk = (jd.DiskParams(**_VDISK) if vol
            else jd.DiskParams(r_inner=3.0, r_outer=12.0))
    w = np.random.default_rng(13).random((RES[1], RES[0], 3))

    def f(m, br, kappa):
        th = {"brightness": br}
        if vol:
            th["kappa"] = kappa
        img = jd.render_blackhole_disk(
            JSchwarzschild(m=m), jc, jb, disk=disk, differentiable="scan",
            disk_theta=th, **_RENDER)
        return jnp.sum(img * w), img

    g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))
    (_, img), grads = g(jnp.asarray(1.0), jnp.asarray(0.8),
                        jnp.asarray(4.0))
    return np.asarray(img), [float(x) for x in grads], w


def _port_render(vol, differentiable="adjoint"):
    _, _, tb, tc = _render_scene()
    _, _, w = _jax_render(vol)
    m, br, kappa = (_t(v).requires_grad_() for v in (1.0, 0.8, 4.0))
    th = {"brightness": br}
    if vol:
        th["kappa"] = kappa
    disk = (td.DiskParams(**_VDISK) if vol
            else td.DiskParams(r_inner=3.0, r_outer=12.0))
    img = td.render_blackhole_disk(
        SchwarzschildMetric(m, device="cpu", dtype=F64), tc, tb, disk=disk,
        differentiable=differentiable, disk_theta=th, **_RENDER)
    grads = torch.autograd.grad(torch.sum(img * _t(w)), (m, br, kappa),
                                allow_unused=True)
    return _np(img), [0.0 if g is None else float(g) for g in grads]


@pytest.mark.parametrize("vol", [False, True])
def test_render_rk45_differentiable_matches_jax_scan(vol):
    want_img, want_g, _ = _jax_render(vol)
    img, got = _port_render(vol)
    assert _scale_err(want_img, img) <= 1e-8
    assert got[0] != 0.0 and got[1] != 0.0
    for a, b in zip(want_g, got):
        assert abs(a - b) <= 1e-7 * max(abs(a), 1e-12), (want_g, got)


class _Routed(Exception):
    pass


@pytest.mark.parametrize("vol", [False, True])
def test_render_rk45_differentiable_routes(vol, monkeypatch):
    """differentiable=True takes the 'adjoint' route (the kernels on a GPU)
    and 'scan' the twin pair on every device, each with the rk45 stepper,
    rtol and atol = rtol 1e-3, as the JAX package passes them."""
    name = "march_planar_vol_adjoint" if vol else "march_planar_disk_adjoint"
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        raise _Routed
    monkeypatch.setattr(tpsa, name, spy)
    for how in ("adjoint", True, "scan"):
        with pytest.raises(_Routed):
            _port_render(vol, how)
    assert [c["backend"] for c in calls] == ["auto", "auto", "twin"]
    for c in calls:
        assert (c["stepper"], c["rtol"], c["atol"]) == (
            "rk45", _RENDER["rtol"], _RENDER["rtol"] * 1e-3)
