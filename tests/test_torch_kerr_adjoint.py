"""PyTorch port vs the JAX package: the fixed-step RK4 Kerr / Kerr-Newman
gradients (``integrate/kerr_adjoint.py``, ``physics/hamiltonian.py:
march_hamiltonian_scan``, ``render_kerr(backend='adjoint' | 'scan')``) and
the checkpoint kernels' Kerr RK4 family's plain versions
(``ops/ckpt_kerr_cuda.py``), on the CPU in float64.

Held against their JAX counterparts on the same numpy inputs:

- the step: ``step5`` (the twin's) and ``kerr_step5_plain`` (the kernels'
  arithmetic) against JAX ``kerr_adjoint.step5`` to 1e-13, with the axis
  and far-field scales of dt binding on some rays;
- the twin forward against JAX ``_forward_xla``: equal signs and steps,
  states to 1e-12 (escaped rays; captured ones r and theta, whose phi and
  momenta diverge as 1 / Delta at the capture radius);
- ``kerr_step5_vjp_plain`` (the kernels' hand-written VJP) against
  ``torch.func.vjp`` of ``kerr_step5_plain`` and ``jax.vjp`` of
  ``_step5_theta`` to 1e-11;
- the plain checkpoint pair against JAX ``ckpt_adjoint_backward_pallas(
  _kerr_make_step, interpret=True)`` to 1e-9;
- d / d(M, a, q, x0, p0) of a loss of ``march_kerr_adjoint``'s escaped
  states against ``jax.grad`` of JAX's, Kerr-Newman, to 1e-9 relative;
- ``march_hamiltonian_scan``'s sign, steps and states against JAX's, and
  its gradients against the adjoint march's (to 1e-8, as the JAX package
  holds its own pair);
- ``render_kerr(backend='adjoint' | 'scan')`` on the spin-recovery view of
  ``examples/inverse_problem.py`` (shadow out of view), Kerr: the image
  against JAX ``render_kerr`` of the same backend and d / d(m, a) against
  JAX's adjoint, to 1e-8 relative;
- a zero cotangent for the captured rays, and a finite gradient with the
  shadow in view.

Sizes are small (48 rays, dt 0.25 and <= 160 steps, 8 x 5 cameras)
because tier-1 is near its time limit.
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
from curvis_tpu.integrate import kerr_adjoint as jka
from curvis_tpu.metrics.kerr import KerrMetric as JKerr
from curvis_tpu.metrics.kerr import KerrNewmanMetric as JKerrNewman
from curvis_tpu.ops.ckpt_adjoint_pallas import ckpt_adjoint_backward_pallas
from curvis_tpu.physics import hamiltonian as jham
from curvis_tpu.render import kerr as jrk

from curvis_tpu_torch import convert
from curvis_tpu_torch.integrate import kerr_adjoint as tka
from curvis_tpu_torch.metrics.kerr import KerrMetric, KerrNewmanMetric
from curvis_tpu_torch.ops import ckpt_kerr_cuda as ck
from curvis_tpu_torch.ops.kerr_cuda import kerr_scalars
from curvis_tpu_torch.physics import hamiltonian as tham
from curvis_tpu_torch.render import kerr as trk

F64 = torch.float64
TH0 = math.pi / 2 - 0.3              # the example's inclination
KW = dict(dt=0.25, max_steps=80, escape_radius=20.0)
FAR = 8.0
PARAMS = {"kerr": dict(m=1.0, a=0.8), "kerr-newman": dict(m=1.0, a=0.6,
                                                          q=0.4)}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _np(t):
    return t.detach().cpu().numpy()


def _scale_err(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _metrics(kind, **over):
    """(JAX metric, port metric) on the same float64 values; the port's
    fields are leaf tensors that require grad."""
    params = dict(PARAMS[kind], **over)
    jcls = JKerr if kind == "kerr" else JKerrNewman
    tcls = KerrMetric if kind == "kerr" else KerrNewmanMetric
    jm = jcls(**{k: jnp.asarray(v) for k, v in params.items()})
    tm = tcls(*(_t(v).requires_grad_() for v in params.values()),
              device="cpu", dtype=F64)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _bundle(kind="kerr", n=48, r0=15.0, seed=1):
    """The 48-ray bundle of tests/test_rk45_adjoint.py (camera at r0, the
    example's inclination, looking past the hole), its last 8 rays aimed at
    the hole -> (x0, p0) as numpy."""
    rng = np.random.default_rng(seed)
    pos = np.stack([np.zeros(n), np.full(n, r0), np.full(n, TH0),
                    np.zeros(n)], -1)
    dirs = np.stack([-np.ones(n), 1.3 + 0.3 * rng.standard_normal(n),
                     0.3 * rng.standard_normal(n)], -1)
    dirs[-8:, 1:] = 0.1 * rng.standard_normal((8, 2))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jm, _ = _metrics(kind)
    p0 = np.asarray(jham.spawn_photon(jm, jnp.asarray(pos),
                                      jnp.asarray(dirs)))
    return pos, p0


@functools.lru_cache(maxsize=None)
def _states(seed=3, n=64):
    """Seeded BL states and (E, L): radii across the far-field threshold,
    a quarter of the rays inside the polar band (sin^2 theta < 0.01)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(3.0, 30.0, n)
    th = rng.uniform(0.2, math.pi - 0.2, n)
    th[: n // 4] = rng.choice([0.04, math.pi - 0.04], n // 4) \
        + rng.uniform(-0.03, 0.03, n // 4)
    ph = rng.uniform(-3.0, 3.0, n)
    p_r = rng.uniform(-1.0, 1.0, n)
    p_th = rng.uniform(-3.0, 3.0, n)
    E = rng.uniform(0.8, 1.2, n)
    L = rng.uniform(-4.0, 4.0, n)
    return (r, th, ph, p_r, p_th), E, L


# ------------------------------------------------------------ the step

def test_step_matches_jax():
    """step5 (the twin's) and kerr_step5_plain (the kernels' arithmetic)
    against JAX step5, Kerr and Kerr-Newman."""
    y, E, L = _states()
    for kind in PARAMS:
        jm, tm = _metrics(kind)
        want = jka.step5(jm, tuple(jnp.asarray(v) for v in y),
                         jnp.asarray(E), jnp.asarray(L), 0.4, 0.01, FAR)
        yt = tuple(_t(v) for v in y)
        with torch.no_grad():
            got = tka.step5(tm, yt, _t(E), _t(L), 0.4, 0.01, FAR)
            row = ck.row_tensor(kerr_scalars(tm, 0.4, 25.0, axis_u0=0.01,
                                             far_r0=FAR), yt[0])
            plain = ck.kerr_step5_plain(row, _t(E), _t(L), yt)
        for w, g, p in zip(want, got, plain):
            assert _scale_err(w, _np(g)) <= 1e-13
            assert _scale_err(w, _np(p)) <= 1e-13
        # the scales bind: some rays in the polar band, some past far_r0
        s2 = np.sin(y[1]) ** 2
        assert (s2 < 0.01).sum() >= 8 and (y[0] > FAR).sum() >= 8


def test_step_vjp_plain_matches_autograd_and_jax():
    """The kernels' hand-written VJP of the RK4 step against torch.func.vjp
    of kerr_step5_plain and jax.vjp of _step5_theta, Kerr-Newman (q^2
    reaches every term)."""
    y, E, L = _states(seed=4)
    jm, tm = _metrics("kerr-newman")
    yt = tuple(_t(v) for v in y)
    row = ck.row_tensor(kerr_scalars(tm, 0.4, 25.0, axis_u0=0.01,
                                     far_r0=FAR), yt[0])
    lam = tuple(_t(c) for c in np.random.default_rng(5).standard_normal(
        (5, E.size)))
    q2 = float(tm.q.detach()) ** 2
    theta_t = (row[2], row[3], row[4], _t(E), _t(L))

    def f(theta, yy):
        r = torch.cat([row[:2], torch.stack(theta[:3]), row[5:]])
        return ck.kerr_step5_plain(r, theta[3], theta[4], yy)
    _, pull = vjp(f, theta_t, yt)
    g_theta, g_y = pull(lam)
    lam_in, g = ck.kerr_step5_vjp_plain(row, _t(E), _t(L), yt, lam)
    for want, got in zip(g_y, lam_in):
        assert _scale_err(_np(want), _np(got)) <= 1e-11
    for i in range(3):
        assert abs(float(g_theta[i]) - float(g[i].sum())) <= 1e-11 * float(
            g[i].abs().sum())
    for i in (3, 4):
        assert _scale_err(_np(g_theta[i]), _np(g[i])) <= 1e-11

    theta_j = (jnp.asarray(1.0), jnp.asarray(0.6), jnp.asarray(q2),
               jnp.asarray(E), jnp.asarray(L))
    @jax.jit
    def pull_j(th, yy, ct):
        return jax.vjp(lambda t_, y_: jka._step5_theta(0.4, 0.01, FAR, t_,
                                                       y_), th, yy)[1](ct)
    gj_theta, gj_y = pull_j(theta_j, tuple(jnp.asarray(v) for v in y),
                            tuple(jnp.asarray(_np(c)) for c in lam))
    for want, got in zip(gj_y, lam_in):
        assert _scale_err(np.asarray(want), _np(got)) <= 1e-11
    for i in range(3):
        assert abs(float(gj_theta[i]) - float(g[i].sum())) <= 1e-11 * float(
            g[i].abs().sum())
    del jm


# ------------------------------------------------------- the forward

@functools.lru_cache(maxsize=None)
def _twin_forward(kind, kw=tuple(KW.items())):
    jm, tm = _metrics(kind)
    x0, p0 = _bundle(kind)
    kw = dict(kw)
    E, L = -p0[:, 0], p0[:, 3]
    y0 = tuple(x0[:, c] for c in (1, 2, 3)) + (p0[:, 1], p0[:, 2])
    args = (kw["dt"], kw["max_steps"], kw["escape_radius"], 0.01, FAR)
    want = jka._forward_xla(jm, jnp.asarray(x0), jnp.asarray(p0), *args)
    theta = (tm.m.detach(), tm.a.detach(), tka.q2_of(tm, tm.m).detach(),
             _t(E), _t(L))
    got = tka._forward_xla(theta, tuple(_t(v) for v in y0), *args,
                           float(tm.capture_radius.detach()))
    return want, got


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_twin_forward_matches_jax(kind):
    """At the JAX package's own parameters (tests/test_gradients.py:351:
    dt 0.1, escape radius 25): at dt 0.25 the two frameworks' rounding
    apart grows to 5e-11 relative on a few rays."""
    kw = dict(dt=0.1, max_steps=400, escape_radius=25.0)
    (wy, wsign, wsteps), (gy, gsign, gsteps) = _twin_forward(
        kind, tuple(kw.items()))
    np.testing.assert_array_equal(_np(gsign), np.asarray(wsign))
    np.testing.assert_array_equal(_np(gsteps), np.asarray(wsteps))
    sign = np.asarray(wsign)
    esc = sign == 1
    assert esc.sum() >= 20 and (sign == 2).sum() >= 1
    for c, (w, g) in enumerate(zip(wy, gy)):
        keep = esc | ((sign == 2) & (c < 2))
        np.testing.assert_allclose(_np(g)[keep], np.asarray(w)[keep],
                                   rtol=1e-12, atol=1e-12)


# ------------------------------------------------------- the plain pair

def _pair_inputs(kind, seed):
    (_, _, _), (_, sign, steps) = _twin_forward(kind)
    _, tm = _metrics(kind)
    x0, p0 = _bundle(kind)
    E, L = _t(-p0[:, 0]), _t(p0[:, 3])
    y0 = tuple(_t(x0[:, c]) for c in (1, 2, 3)) + (_t(p0[:, 1]),
                                                    _t(p0[:, 2]))
    smooth = (sign == 0) | (sign == 1)
    counts = torch.where(smooth, steps, torch.zeros_like(steps))
    cot = _t(np.random.default_rng(seed).standard_normal((5, E.numel())))
    cot = torch.where(smooth, cot, torch.zeros_like(cot))
    scal = kerr_scalars(tm, KW["dt"], KW["escape_radius"], axis_u0=0.01,
                        far_r0=FAR)
    return tm, y0, E, L, counts, cot, scal


def test_plain_pair_matches_jax_pallas_interpret():
    """The plain pair against JAX's Pallas pair (interpret mode, JAX's own
    step and autodiff) on the same replay counts and cotangent,
    Kerr-Newman."""
    tm, y0, E, L, counts, cot, scal = _pair_inputs("kerr-newman", 7)
    g, lam = ck.ckpt_kerr_backward_cuda("rk4", scal, y0, E, L,
                                        counts.to(torch.int32), cot)
    one = jnp.ones(E.numel())
    theta = (1.0 * one, 0.6 * one, float(tm.q.detach()) ** 2 * one,
             jnp.asarray(_np(E)), jnp.asarray(_np(L)))
    params = jnp.asarray([[KW["dt"], 0.01, FAR, 0.0]])
    lam_j, g_j = ckpt_adjoint_backward_pallas(
        jka._kerr_make_step, params, tuple(jnp.asarray(_np(a)) for a in y0),
        theta, jnp.asarray(_np(counts), jnp.float64),
        tuple(jnp.asarray(_np(c)) for c in cot),
        max_steps=int(counts.max()), seg=ck.SEG["rk4"], interpret=True)
    for want, got in zip(lam_j, lam):
        assert _scale_err(np.asarray(want), _np(got)) <= 1e-9
    for i in (3, 4):
        assert _scale_err(np.asarray(g_j[i]), _np(g[i])) <= 1e-9
    for i in range(3):
        want = float(jnp.sum(g_j[i]))
        assert abs(want - float(g[i].sum())) <= 1e-9 * abs(want)


# ------------------------------------------------------- the gradients

def _escape_loss(x, p, sign, xp):
    return xp.mean(xp.where(sign == 1,
                            xp.sin(x[:, 3]) * p[:, 1] + xp.cos(x[:, 2]),
                            0.0))


def test_march_gradients_match_jax():
    """d loss / d(M, a, q, x0, p0) of march_kerr_adjoint against jax.grad
    of JAX's (its XLA route), Kerr-Newman, x0 and p0 as independent inputs;
    and the captured rays' exclusion.  (Kerr's d / d(M, a) through this
    march are held against JAX by the render test below.)"""
    kind = "kerr-newman"
    x0, p0 = _bundle(kind)
    names = list(PARAMS[kind])

    def fj(params, xx, pp):
        metric = JKerrNewman(**dict(zip(names, params)))
        x, p, sign, _ = jka.march_kerr_adjoint(metric, xx, pp, far_r0=FAR,
                                               **KW)
        return _escape_loss(x, p, sign, jnp)

    vals = tuple(jnp.asarray(PARAMS[kind][k]) for k in names)
    jv, jg = jax.jit(jax.value_and_grad(fj, argnums=(0, 1, 2)))(
        vals, jnp.asarray(x0), jnp.asarray(p0))
    _, tm = _metrics(kind)
    xt, pt = _t(x0).requires_grad_(), _t(p0).requires_grad_()
    x, p, sign, _ = tka.march_kerr_adjoint(tm, xt, pt, far_r0=FAR, **KW)
    tv = _escape_loss(x, p, sign, torch)
    fields = [getattr(tm, k) for k in names]
    tg = torch.autograd.grad(tv, fields + [xt, pt], retain_graph=True)
    assert abs(float(tv.detach()) - float(jv)) <= 1e-12
    for want, got in zip(list(jg[0]) + [jg[1], jg[2]], tg):
        assert _scale_err(np.asarray(want), _np(got)) <= 1e-9
    assert all(float(g.abs().max()) > 0 for g in tg[:len(names)])
    # captured rays are excluded: no cotangent reaches their spawn state
    # (they replay no step), whatever the loss reads of them
    cap = sign == 2
    assert int(cap.sum()) >= 4
    gx, gp = torch.autograd.grad(x[:, 1:].sum() + p[:, 1:3].sum(), [xt, pt])
    assert bool((gx[cap] == 0).all()) and bool((gp[cap] == 0).all())
    assert bool((gx[~cap] != 0).any())


# ------------------------------------------------------- the scan

def test_march_hamiltonian_scan_matches_jax():
    """The checkpointed autodiff scan: sign, steps and escaped states
    against JAX march_hamiltonian_scan, and d / d(a, x0 shift) against the
    adjoint march on the same bundle (both the exact discrete gradient of
    RK4 of one flow, so they agree to rounding: the JAX package holds its
    own scan and adjoint to 1e-8)."""
    x0, p0 = _bundle("kerr")
    kw = dict(KW, far_r0=FAR)

    @jax.jit
    def fj(x, p):
        metric = JKerr(m=jnp.asarray(1.0), a=jnp.asarray(0.8))
        return jham.march_hamiltonian_scan(
            metric, x, p, capture_radius=metric.capture_radius, **kw)

    jres = fj(jnp.asarray(x0), jnp.asarray(p0))
    _, tm = _metrics("kerr")
    grads = []
    for march in ("scan", "adjoint"):
        shift = _t(0.0).requires_grad_()
        if march == "scan":
            res = tham.march_hamiltonian_scan(
                tm, _t(x0) + shift, _t(p0), capture_radius=tm.capture_radius,
                **kw)
        else:
            res = tka.march_kerr_adjoint(tm, _t(x0) + shift, _t(p0), **kw)
        loss = _escape_loss(res[0], res[1], res[2], torch)
        grads.append(torch.autograd.grad(loss, [tm.a, shift]))
        if march == "scan":
            np.testing.assert_array_equal(_np(res.sign),
                                          np.asarray(jres.sign))
            np.testing.assert_array_equal(_np(res.steps),
                                          np.asarray(jres.steps))
            sign = np.asarray(jres.sign)
            esc = sign == 1
            assert esc.sum() >= 20 and (sign == 0).sum() >= 1
            np.testing.assert_allclose(_np(res.x)[esc],
                                       np.asarray(jres.x)[esc], rtol=1e-10,
                                       atol=1e-10)
            np.testing.assert_allclose(_np(res.p)[esc],
                                       np.asarray(jres.p)[esc], rtol=1e-10,
                                       atol=1e-10)
    for want, got in zip(grads[1], grads[0]):
        assert abs(float(want) - float(got)) <= 1e-8 * abs(float(want))


# ------------------------------------------------------- render_kerr

def _smooth_sky():
    h, w = 16, 32
    yy, xx = np.mgrid[0:h, 0:w]
    tex = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                    0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    jb = cv.make_spherical_image(tex, dtype=jnp.float64)
    tb = convert.spherical_image_from_arrays(
        np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
        dtype=F64)
    return jb, tb


def _camera(side=1.3, res=(8, 5)):
    """The spin-recovery camera of examples/inverse_problem.py:116-121 (r =
    15, tilted by ``side``; side 0 looks at the hole)."""
    f = np.array([-np.sin(TH0), side, -np.cos(TH0)])
    f /= np.linalg.norm(f)
    jc = cv.make_camera([0.0, 15.0, TH0, 0.0], list(f), [0.0, 0.0, 1.0],
                        35.0, 43.0, *res, dtype=jnp.float64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, k)) for k in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        *res, device="cpu", dtype=F64)
    return jc, tc


RENDER = dict(dt=0.25, max_steps=160, escape_radius=20.0)
WGT = np.linspace(0.5, 1.5, 5)[:, None, None]


@functools.lru_cache(maxsize=None)
def _jax_render(backend):
    """JAX render_kerr's image and, for 'adjoint', d mean(img w) / d(m,
    a) on the spin-recovery view (a = 0.7)."""
    jb, _ = _smooth_sky()
    jc, _ = _camera()

    def fj(m, a):
        img = jrk.render_kerr(JKerr(m=m, a=a), jc, jb, backend=backend,
                              **RENDER)
        return jnp.mean(img * WGT), img

    args = (jnp.asarray(1.0), jnp.asarray(0.7))
    if backend == "scan":
        return np.asarray(jax.jit(fj)(*args)[1]), None
    (_, img), g = jax.jit(jax.value_and_grad(fj, argnums=(0, 1),
                                             has_aux=True))(*args)
    return np.asarray(img), tuple(float(v) for v in g)


@pytest.mark.parametrize("backend", ["adjoint", "scan"])
def test_render_kerr_image_and_gradients_match_jax(backend):
    """The image against JAX render_kerr of the same backend; d / d(m, a)
    against JAX's adjoint.  The scan's d / da only: its d / dm also
    follows far_r0 = 8 m, whose path the adjoints drop (as in JAX; JAX's
    own scan and adjoint agree on d / da to 1e-8)."""
    _, tb = _smooth_sky()
    _, tc = _camera()
    want, _ = _jax_render(backend)
    _, jg = _jax_render("adjoint")
    _, tm = _metrics("kerr", a=0.7)
    img = trk.render_kerr(tm, tc, tb, backend=backend, **RENDER)
    assert img.shape == (5, 8, 3)
    np.testing.assert_allclose(_np(img), want, rtol=1e-8, atol=1e-10)
    g = torch.autograd.grad(torch.mean(img * _t(WGT)), [tm.m, tm.a])
    for w, v in list(zip(jg, g))[1 if backend == "scan" else 0:]:
        assert abs(float(v) - w) <= 1e-8 * abs(w) and w != 0.0


def test_render_kerr_gradient_finite_with_the_shadow_in_view():
    _, tb = _smooth_sky()
    _, tc = _camera(side=0.0)
    _, tm = _metrics("kerr", a=0.7)
    img = trk.render_kerr(tm, tc, tb, backend="adjoint", **RENDER)
    assert bool((img.detach().sum(-1) == 0).any())         # the shadow
    (g,) = torch.autograd.grad(img.mean(), tm.a)
    assert math.isfinite(float(g)) and float(g) != 0.0
