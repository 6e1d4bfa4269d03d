"""PyTorch port vs the JAX package: the differentiable disk renders, on the
CPU in float64.

Held against their JAX counterparts on the same numpy inputs:

- the step twins ``_disk_step`` / ``_vol_step`` of
  ``integrate/planar_surface_adjoint.py`` against JAX ``_pl_disk_step`` /
  ``_pl_vol_step``, one step on seeded states, for every planar kind and
  every volumetric flag combination, guard cases included (l -> 0,
  A -> 0, a frozen captured state): to 1e-13 of the outputs' scale,
  except DNEG, whose JAX closure evaluates atan with the degree-6
  polynomial ``_ATAN6`` (7.4e-7 absolute error in (2 / pi) atan; the port
  uses ``torch.atan``): to 1e-5 relative;
- the hand-written step VJPs (``ops/ckpt_surface_cuda.py``, the plain
  versions of the CUDA kernels' VJPs) against ``torch.func.vjp`` of the
  twins, to 1e-12 of the cotangents' scale;
- the plain surface checkpoint pair against ``integrate/ckpt.py`` under
  autograd on the twin, to 1e-10;
- ``march_planar_disk_adjoint`` / ``march_planar_vol_adjoint`` against the
  JAX package's ``backend='xla'`` pair on the 32-ray fan of
  ``tests/test_surface_adjoint_planar.py``: outputs to 1e-12, gradients
  of a seeded linear loss w.r.t. (M, l0, b, c1, kappa) to 1e-8 relative
  (two f64 replays of ~1000 steps, summed in different orders);
- ``render_blackhole_disk(differentiable='adjoint', disk_theta=...)``
  against JAX ``differentiable='scan'`` at 32 x 18, thin and volumetric:
  images to 1e-10, gradients w.r.t. (M, brightness, kappa) to 1e-8;
- a central difference of the port's own render, and the options that
  still raise.

Sizes are small because tier-1 is near its time limit.
"""
import functools
import itertools
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
from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.integrate.kerr_surface_adjoint import build_vol_row
from curvis_tpu_torch.metrics.base import SchwarzschildMetric
from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
from curvis_tpu_torch.ops.disk_vol_cuda import vol_param_slots
from curvis_tpu_torch.render import disk as td

F64 = torch.float64
KINDS = {"schwarzschild": (1.0, 0.0, 0.0), "rn": (1.0, 0.36, 0.0),
         "ellis": (1.0, 0.0, 0.0), "flat": (0.0, 0.0, 0.0),
         "interstellar": (0.1, 0.5, 1.0)}
LAPSE = ("schwarzschild", "rn")
STEP_TOL = 1e-13
DNEG_TOL = 1e-5
VJP_TOL = 1e-12
N = 48
_VDISK = dict(r_inner=3.0, r_outer=12.0, volumetric=True, h_rel=0.1,
              kappa=2.0, tau_max=8.0)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _np(t):
    return t.detach().cpu().numpy()


def _scale_err(want, got):
    """max |got - want| over the largest |want| (or 1 when it is 0)."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _flag_sets(kind):
    """(blackbody, redshift, doppler, scatter): every combination for the
    lapse kinds; the shifts act only there, so blackbody x scatter else."""
    if kind in LAPSE:
        return list(itertools.product([False, True], repeat=4))
    return [(bb, False, False, sc)
            for bb, sc in itertools.product([False, True], repeat=2)]


def _states(kind, seed, guard=False):
    """Seeded per-ray states: (l, psi, p_l, b, c1, c2, nz) as numpy; the
    planes chosen so that about half the thin steps cross the plane."""
    rng = np.random.default_rng(seed)
    lapse = kind in LAPSE
    sheet = 1.0 if lapse else rng.choice([1.0, -1.0], N)
    l = rng.uniform(4.0, 12.0, N) * sheet
    if guard:
        # the guards' cases: l -> 0 (flat, the lapse kinds), A -> 0 just
        # above the horizon, and frozen captured states inside it
        l[:4] = [1e-7, -3e-6, 2.0 * (1.0 + 1e-9), 2.0 * (1.0 + 1e-6)]
        l[4:8] = [1.5, 0.7, 1.9, 0.05]
    psi = rng.uniform(0.0, 2 * np.pi, N)
    p_l = rng.normal(size=N)
    b = rng.uniform(-4.0, 4.0, N)
    c2 = rng.uniform(-0.6, 0.6, N)
    c1 = -c2 * np.sin(psi) / np.cos(psi) + 1e-3 * rng.normal(size=N)
    nz = rng.uniform(-0.9, 0.9, N)
    return l, psi, p_l, b, c1, c2, nz


def _surf(flags, seed=4):
    disk = td.DiskParams(**_VDISK, t_peak=8000.0, emissivity_index=2.5,
                         color_mode="blackbody" if flags[0] else "tint")
    row = [disk.r_inner, disk.r_outer] + vol_param_slots(disk)
    if flags[3]:
        row += list(np.random.default_rng(seed).uniform(-0.2, 1.0, 27))
    return row


def _hits(seed):
    """Hit slots: each triple empty (0) or filled, slot 2 only after 1."""
    rng = np.random.default_rng(seed)
    m1 = rng.random(N) < 0.5
    m2 = m1 | (rng.random(N) < 0.5)
    return [np.where(m, 0.0, rng.uniform(3.0, 9.0, N))
            for m in (m1, m1, m1, m2, m2, m2)]


@pytest.mark.parametrize("family", ["thin", "vol"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_step_twins_match_jax(kind, family):
    dt = 0.3
    p = KINDS[kind]
    tol = DNEG_TOL if kind == "interstellar" else STEP_TOL
    for guard in (False, True):
        l, psi, p_l, b, c1, c2, nz = _states(kind, 1 + guard, guard)
        if family == "thin":
            y = [l, psi, p_l, np.cos(psi), np.sin(psi), *_hits(3)]
            theta = [*p, b, c1, c2, 3.0, 12.0]
            want = jpsa._pl_disk_step(kind, dt, tuple(map(jnp.asarray,
                                                          theta)),
                                      tuple(map(jnp.asarray, y)))
            got = tpsa._disk_step(kind, dt, tuple(map(_t, theta)),
                                  tuple(map(_t, y)))
            cases = [(want, got)]
        else:
            cases = []
            rng = np.random.default_rng(5)
            y = [l, psi, p_l, np.cos(psi), np.sin(psi),
                 rng.uniform(0.0, 2.0, N), *rng.uniform(0.0, 1.0, (3, N))]
            c1v, c2v = 0.05 * rng.normal(size=(2, N))
            for flags in _flag_sets(kind):
                surf = _surf(flags)
                theta = [*p, b, c1v, c2v, nz, *surf]
                want = jpsa._pl_vol_step(
                    kind, *flags[:3], dt, tuple(map(jnp.asarray, theta)),
                    tuple(map(jnp.asarray, y)))
                got = tpsa._vol_step(kind, flags, dt,
                                     (*map(_t, theta[:7]), _t(surf)),
                                     tuple(map(_t, y)))
                cases.append((want, got))
        for want, got in cases:
            for w, g in zip(want, got):
                assert np.all(np.isfinite(_np(g)))
                assert _scale_err(w, _np(g)) < tol


def _vjp_case(kind, family, flags=None, seed=7):
    """(twin outputs' cotangents by torch.func.vjp, by the plain VJP)."""
    dt = _t(0.3)
    p = tuple(_t(v) for v in KINDS[kind])
    l, psi, p_l, b, c1, c2, nz = map(_t, _states(kind, seed))
    u, v = torch.cos(psi), torch.sin(psi)
    rng = np.random.default_rng(seed)
    if family == "thin":
        y = (l, psi, p_l, u, v, *map(_t, _hits(seed)))
        theta = (*p, b, c1, c2, _t(3.0), _t(12.0))
        lam = tuple(_t(rng.normal(size=N)) for _ in range(11))
        _, pull = vjp(lambda th, yy: tpsa._disk_step(kind, dt, th, yy),
                      theta, y)
        row = torch.stack([dt, _t(80.0), *p, _t(-1e30), _t(3.0), _t(12.0)])
        _, new1, new2 = cs.disk_step(kind, dt, theta, y)
        got = cs.disk_step_vjp_plain(kind, row, (l, p_l, u, v), new1, new2,
                                     b, c1, c2, lam)
        return pull(lam), got
    surf = _t(_surf(flags))
    c1, c2 = (_t(0.05 * rng.normal(size=N)) for _ in range(2))
    y = (l, psi, p_l, u, v, _t(rng.uniform(0, 2, N)),
         *(_t(rng.uniform(0, 1, N)) for _ in range(3)))
    theta = (*p, b, c1, c2, nz, surf)
    lam = tuple(_t(rng.normal(size=N)) for _ in range(9))
    _, pull = vjp(lambda th, yy: tpsa._vol_step(kind, flags, dt, th, yy),
                  theta, y)
    row = torch.cat([torch.stack([dt, _t(80.0), *p, _t(-1e30)]), surf])
    got = cs.vol_step_vjp_plain(kind, flags, row, (l, p_l, u, v, y[5]), b,
                                c1, c2, nz, lam)
    (g_th, g_y) = pull(lam)
    return (tuple(g_th[:7]) + tuple(g_th[7]), g_y), got


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_step_vjp_matches_autograd(kind):
    cases = [_vjp_case(kind, "thin")]
    cases += [_vjp_case(kind, "vol", flags) for flags in _flag_sets(kind)]
    for (g_th, g_y), (lam_in, g) in cases:
        for want, got in zip(g_y, lam_in):
            assert _scale_err(_np(want), _np(got)) < VJP_TOL
        assert len(g_th) == len(g)
        for want, got in zip(g_th, g):
            got = got if want.dim() else got.sum()
            assert _scale_err(_np(want), _np(got)) < VJP_TOL


@pytest.mark.parametrize("flags", [None, (True, True, True, False),
                                   (False, True, True, True)])
def test_ckpt_surface_plain_matches_ckpt_autograd(flags):
    """The plain kernel pair (compacted checkpoints, reverse segments, the
    hand VJP) against integrate/ckpt.py under autograd on the twin."""
    kind = "schwarzschild"
    rng = np.random.default_rng(11)
    n, dt = 24, 0.05
    l0 = _t(np.full(n, 14.0))
    psi0 = _t(rng.uniform(0, 2 * np.pi, n))
    alpha = np.pi - (0.12 + 0.5 * rng.random(n))
    p_l0, b = _t(np.cos(alpha)), _t(14.0 * np.sin(alpha))
    c1, c2 = _t(0.3 * rng.normal(size=n)), _t(0.3 * rng.normal(size=n))
    nz = _t(rng.uniform(-0.9, 0.9, n))
    steps = torch.from_numpy(rng.integers(0, 90, n).astype(np.int32))
    scal = [dt, 25.0, 1.0, 0.0, 0.0, 2.0 * 1.01, 3.0, 12.0]
    if flags is not None:
        scal = scal[:6] + _surf(flags)
    ns = cs.n_state(flags)
    cot = _t(rng.normal(size=(ns, n)))
    g, lam = cs.ckpt_surface_backward_cuda(
        kind, flags, scal, (l0, psi0, p_l0), b, c1, c2, nz, steps, cot,
        seg=16)
    p = (_t(1.0), _t(0.0), _t(0.0))
    zero = torch.zeros_like(l0)
    y0 = (l0, psi0, p_l0, torch.cos(psi0), torch.sin(psi0))
    surf = _t(scal[6:])
    if flags is None:
        y0 += (zero,) * 6
        theta = (*p, b, c1, c2, surf)

        def step(th, y):
            return tpsa._disk_step(kind, dt, (*th[:6], th[6][0], th[6][1]),
                                   y)
    else:
        y0 += (zero,) * 4
        theta = (*p, b, c1, c2, nz, surf)

        def step(th, y):
            return tpsa._vol_step(kind, flags, dt, th, y)
    d_th, d_y = ckpt_adjoint_backward(step, theta, y0, steps, tuple(cot),
                                      max_steps=90, segment=11)
    for c in range(ns):
        assert _scale_err(_np(d_y[c]), _np(lam[c])) < 1e-10
    k = len(theta) - 1
    for i in range(k):
        got = g[i] if d_th[i].dim() else g[i].sum()
        assert _scale_err(_np(d_th[i]), _np(got)) < 1e-10
    assert _scale_err(_np(d_th[k]), _np(g[k:].sum(1))) < 1e-10


# ------------------------------------------------------- the march pair

def _fan(n=32, seed=2):
    """tests/test_surface_adjoint_planar.py:_fan"""
    rng = np.random.default_rng(seed)
    l0 = np.full((n,), 18.0)
    psi0 = np.zeros((n,))
    alpha = np.pi - (0.12 + 0.5 * rng.random(n))
    ang = rng.random(n) * 2 * np.pi
    c1 = 0.3 * np.cos(ang)
    c2 = 0.8 * np.sin(ang) + 0.1
    nz = 0.5 + 0.4 * rng.random(n)
    return l0, psi0, alpha, c1, c2, nz


_MARCH = dict(dt=0.2, max_steps=300, escape_radius=25.0)


def _march_inputs():
    l0, psi0, alpha, c1, c2, nz = _fan()
    p_l0 = np.cos(alpha) * np.sqrt(1.0 / (1.0 - 2.0 / l0))  # B0/A0, M = 1
    b = l0 * np.sin(alpha) / np.sqrt(1.0 - 2.0 / l0)
    w = np.random.default_rng(9).normal(size=(14, l0.size))
    return l0, psi0, p_l0, b, c1, c2, nz, w


def _lin_loss(outs, w, xp):
    """sum_k w_k . out_k over the float outputs (hits, tau, emission)."""
    return sum(xp.sum(wk * o) for wk, o in zip(w, outs))


@functools.lru_cache(maxsize=None)
def _jax_march(vol):
    l0, psi0, p_l0, b, c1, c2, nz, w = _march_inputs()
    disk = jd.DiskParams(**_VDISK)

    def f(m, l0_, b_, c1_, kappa):
        met = JSchwarzschild(m=m)
        if vol:
            out = jpsa.march_planar_vol_adjoint(
                met, (l0_, jnp.asarray(psi0), jnp.asarray(p_l0)), b_, c1_,
                jnp.asarray(c2), jnp.asarray(nz), disk,
                disk_theta={"kappa": kappa}, backend="xla", **_MARCH)
            tau, em = out[5]
            flo = [out[0], out[1], out[2], tau, *em]
        else:
            out = jpsa.march_planar_disk_adjoint(
                met, (l0_, jnp.asarray(psi0), jnp.asarray(p_l0)), b_, c1_,
                jnp.asarray(c2), r_inner=3.0, r_outer=12.0, backend="xla",
                **_MARCH)
            flo = [out[0], out[1], out[2], *out[5][0], *out[5][1]]
        # final states only for the smooth fates (their cotangent policy)
        smooth = jnp.abs(out[3]) < 2
        flo[:3] = [jnp.where(smooth, o, 0.0) for o in flo[:3]]
        return _lin_loss(flo, jnp.asarray(w), jnp), (out, flo)

    g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4), has_aux=True))
    return g(jnp.asarray(1.0), jnp.asarray(l0), jnp.asarray(b),
             jnp.asarray(c1), jnp.asarray(2.0))


@pytest.mark.parametrize("vol", [False, True])
def test_march_adjoint_matches_jax_xla(vol):
    (_, (jout, jflo)), jg = _jax_march(vol)
    l0, psi0, p_l0, b, c1, c2, nz, w = _march_inputs()
    m = _t(1.0).requires_grad_()
    tl0, tb, tc1 = (_t(a).requires_grad_() for a in (l0, b, c1))
    kappa = _t(2.0).requires_grad_()
    met = SchwarzschildMetric(m, device="cpu", dtype=F64)
    state = (tl0, _t(psi0), _t(p_l0))
    if vol:
        out = tpsa.march_planar_vol_adjoint(
            met, state, tb, tc1, _t(c2), _t(nz), td.DiskParams(**_VDISK),
            disk_theta={"kappa": kappa}, **_MARCH)
        flo = [out[0], out[1], out[2], out[5][0], *out[5][1]]
    else:
        out = tpsa.march_planar_disk_adjoint(
            met, state, tb, tc1, _t(c2), r_inner=3.0, r_outer=12.0, **_MARCH)
        flo = [out[0], out[1], out[2], *out[5][0], *out[5][1]]
    np.testing.assert_array_equal(_np(out[3]), np.asarray(jout[3]))
    np.testing.assert_array_equal(_np(out[4]), np.asarray(jout[4]))
    assert (np.asarray(jout[3]) == 2).any()      # captured rays included
    smooth = out[3].abs() < 2
    flo[:3] = [torch.where(smooth, o, torch.zeros_like(o)) for o in flo[:3]]
    for want, got in zip(jflo, flo):
        assert _scale_err(np.asarray(want), _np(got)) < 1e-12
    loss = _lin_loss(flo, _t(w), torch)
    grads = torch.autograd.grad(loss, (m, tl0, tb, tc1, kappa),
                                allow_unused=True)
    for want, got in zip(jg, grads):
        got = np.zeros(np.shape(want)) if got is None else _np(got)
        assert _scale_err(np.asarray(want), got) < 1e-8


# ------------------------------------------------------- the render route

RES = (32, 18)
TH = math.pi / 2 - 0.4


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


_RENDER = dict(dt=0.2, max_steps=240, escape_radius=25.0)


def _disk(vol):
    return (td.DiskParams(**_VDISK) if vol
            else td.DiskParams(r_inner=3.0, r_outer=12.0))


@functools.lru_cache(maxsize=None)
def _jax_render(vol):
    jb, jc, _, _ = _render_scene()
    disk = jd.DiskParams(**_VDISK) if vol else jd.DiskParams(r_inner=3.0,
                                                             r_outer=12.0)
    theta_w = np.random.default_rng(13).random((RES[1], RES[0], 3))

    def f(m, br, kappa):
        th = {"brightness": br}
        if vol:
            th["kappa"] = kappa
        img = jd.render_blackhole_disk(
            JSchwarzschild(m=m), jc, jb, disk=disk, differentiable="scan",
            disk_theta=th, **_RENDER)
        return jnp.sum(img * theta_w), img

    g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))
    (_, img), grads = g(jnp.asarray(1.0), jnp.asarray(0.8),
                        jnp.asarray(2.0))
    return np.asarray(img), [float(x) for x in grads], theta_w


def _port_render(vol, m=1.0, br=0.8, kappa=2.0, differentiable="adjoint"):
    _, _, tb, tc = _render_scene()
    m, br, kappa = (_t(v).requires_grad_() for v in (m, br, kappa))
    th = {"brightness": br}
    if vol:
        th["kappa"] = kappa
    img = td.render_blackhole_disk(
        SchwarzschildMetric(m, device="cpu", dtype=F64), tc, tb,
        disk=_disk(vol), differentiable=differentiable, disk_theta=th,
        **_RENDER)
    return img, (m, br, kappa)


@functools.lru_cache(maxsize=None)
def _port_grads(vol, differentiable):
    """(image, gradients of the weighted image sum w.r.t. (M, brightness,
    kappa), 0.0 where unused) of the port's render."""
    _, _, w = _jax_render(vol)
    img, params = _port_render(vol, differentiable=differentiable)
    grads = torch.autograd.grad(torch.sum(img * _t(w)), params,
                                allow_unused=True)
    return _np(img), [0.0 if g is None else float(g) for g in grads]


@pytest.mark.parametrize("vol", [False, True])
def test_render_differentiable_matches_jax_scan(vol):
    want_img, want_g, _ = _jax_render(vol)
    img, got = _port_grads(vol, "adjoint")
    assert _scale_err(want_img, img) < 1e-10
    for a, b in zip(want_g, got):
        assert abs(a - b) <= 1e-8 * max(abs(a), 1e-12), (want_g, got)


class _Routed(Exception):
    pass


@pytest.mark.parametrize("vol", [False, True])
def test_render_differentiable_true_is_adjoint(vol, monkeypatch):
    """differentiable=True takes the 'adjoint' route (the kernels on a GPU)
    and only 'scan' forces the twin pair on every device, as in the JAX
    package; on the CPU True and 'adjoint' give the same image and
    gradients."""
    name = "march_planar_vol_adjoint" if vol else "march_planar_disk_adjoint"
    backends = []

    def spy(*args, **kw):
        backends.append(kw["backend"])
        raise _Routed
    with monkeypatch.context() as mp:
        mp.setattr(tpsa, name, spy)
        for how in ("adjoint", True, "scan"):
            with pytest.raises(_Routed):
                _port_render(vol, differentiable=how)
    assert backends == ["auto", "auto", "twin"]
    img, grads = _port_grads(vol, "adjoint")
    img_t, grads_t = _port_grads(vol, True)
    np.testing.assert_array_equal(img, img_t)
    assert grads == grads_t


def test_render_gradient_matches_central_difference():
    """d(weighted image sum)/d(brightness, M) of the thin disk against a
    central difference of the port's own render (the twin route)."""
    _, _, w = _jax_render(False)
    img, (m, br, _) = _port_render(False, differentiable="scan")
    g_m, g_br = torch.autograd.grad(torch.sum(img * _t(w)), (m, br))

    def f(**kw):
        with torch.no_grad():
            return float(torch.sum(_port_render(False, **kw)[0] * _t(w)))
    for name, g, x0, eps in (("br", g_br, 0.8, 1e-5), ("m", g_m, 1.0, 1e-6)):
        fd = (f(**{name: x0 + eps}) - f(**{name: x0 - eps})) / (2 * eps)
        assert abs(float(g) - fd) <= 1e-5 * abs(fd), (name, float(g), fd)


def test_build_vol_row_matches_slots_and_chains():
    disk = td.DiskParams(**_VDISK)
    row = build_vol_row(disk, dtype=F64)
    np.testing.assert_array_equal(
        _np(row), [disk.r_inner, disk.r_outer] + vol_param_slots(disk))
    h = _t(0.1).requires_grad_()
    r_in = _t(3.0).requires_grad_()
    row = build_vol_row(disk, {"h_rel": h, "r_inner": r_in,
                               "brightness": _t(2.0)}, dtype=F64)
    g_h, g_r = torch.autograd.grad(row[3] + row[9], (h, r_in))
    assert float(g_h) == pytest.approx(-1.0 / (math.sqrt(2 * math.pi) * 0.01))
    assert float(g_r) == pytest.approx(
        0.75 * float(row[9].detach()) / 3.0, rel=1e-12)
    with pytest.raises(ValueError, match="thickness"):
        build_vol_row(disk, {"thickness": _t(0.1)})


def test_disk_theta_from_arrays():
    th = convert.disk_theta_from_arrays(
        {"kappa": np.float64(2.5), "tint": np.array([1.0, 0.5, 0.2])},
        device="cpu", dtype=F64)
    assert th["kappa"].shape == () and float(th["kappa"]) == 2.5
    assert th["tint"].dtype == F64 and th["tint"].shape == (3,)


def test_unported_differentiable_options_raise():
    _, _, tb, tc = _render_scene()
    met = SchwarzschildMetric(1.0, device="cpu", dtype=F64)
    kw = dict(dt=0.1, max_steps=10, escape_radius=25.0)
    # the rk45 marches are differentiable now: finite images and gradients
    img = td.render_blackhole_disk(met, tc, tb, stepper="rk45",
                                   differentiable="adjoint", **kw)
    assert torch.isfinite(img).all()
    b = _t([1.0]).requires_grad_()
    out = tpsa.march_planar_disk_adjoint(
        met, (_t([18.0]), _t([0.0]), _t([-1.0])), b, _t([0.1]), _t([0.2]),
        r_inner=3.0, r_outer=12.0, stepper="rk45", **kw)
    (g,) = torch.autograd.grad(out[1].sum(), b)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    star = td.DiskParams(**_VDISK, starlight=True)
    with pytest.raises(ValueError, match="starlight_map"):
        td.render_blackhole_disk(met, tc, tb, disk=star,
                                 differentiable="scan", **kw)
    with pytest.raises(ValueError, match="differentiable"):
        td.render_blackhole_disk(met, tc, tb, differentiable="xla", **kw)
