"""PyTorch port vs the JAX package: the inverse-rendering path on the CPU.

The checkpointed-recompute adjoint (``integrate/ckpt.py``), the plain
versions of the checkpoint kernels #9/#10 with their hand-written step VJP
(``ops/ckpt_adjoint_cuda.py``), the differentiable march
(``integrate/adjoint.py``), ``render_direct(differentiable='adjoint')`` and
``fit``, each against its JAX twin on the same inputs (made with numpy from
a seed), in float64.  The JAX Pallas kernel pair runs in interpret mode, as
the JAX package's own tests run it.  Also the two repairs of the port:
factories build on the GPU unless asked for the CPU, and a tensor passed as
a metric parameter receives its gradient.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import curvis_tpu as cv
from curvis_tpu.camera.camera import pixel_rays_world as jax_pixel_rays
from curvis_tpu.fit import FitResult as JaxFitResult
from curvis_tpu.fit import fit as jax_fit
from curvis_tpu.integrate import adjoint as jadj
from curvis_tpu.integrate import ckpt as jckpt
from curvis_tpu.ops.ckpt_adjoint_pallas import ckpt_adjoint_backward_pallas
from curvis_tpu.physics import planar as jpl

import curvis_tpu_torch as ct
from curvis_tpu_torch import convert
from curvis_tpu_torch.config.settings import MetricSettings
from curvis_tpu_torch.fit import FitResult, fit
from curvis_tpu_torch.integrate import adjoint as tadj
from curvis_tpu_torch.integrate import ckpt as tckpt
from curvis_tpu_torch.metrics.base import EllisMetric
from curvis_tpu_torch.ops import ckpt_adjoint_cuda as ca
from curvis_tpu_torch.physics import planar as tpl
from curvis_tpu_torch.render.direct import render_direct
from curvis_tpu_torch.utils import device as tdevice

F64 = torch.float64
KW = dict(dt=0.05, max_steps=2000, escape_radius=20.0)
_FIELDS = {"ellis": ("rho",), "interstellar": ("m", "a", "rho"),
           "schwarzschild": ("m",), "rn": ("m", "q")}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _np(t):
    return t.detach().cpu().numpy()


def _metric_pair(kind, **params):
    jm = cv.make_metric(kind, **params)
    tm = convert.metric_from_arrays(
        kind, device="cpu", dtype=F64,
        **{k: np.asarray(getattr(jm, k)) for k in _FIELDS[kind]})
    return jm, tm


def _camera_pair(position, forward, res):
    jc = cv.make_camera(position, forward, [0.0, 0.0, 1.0], 15.0, 43.0,
                        res[0], res[1], dtype=jnp.float64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        jc.resolution_x, jc.resolution_y, device="cpu", dtype=F64)
    return jc, tc


def _smooth_skies():
    yy, xx = np.mgrid[0:32, 0:64]
    smooth = np.stack([np.sin(2 * np.pi * xx / 64) * 0.5 + 0.5, yy / 32,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / 32)], -1)
    pairs = []
    for tex in (smooth, smooth[::-1].copy()):
        js = cv.make_spherical_image(tex, dtype=jnp.float64)
        ts = convert.spherical_image_from_arrays(
            np.asarray(js.texture), np.asarray(js.rotation), device="cpu",
            dtype=F64)
        pairs.append((js, ts))
    return pairs


@pytest.mark.parametrize("filtering", ["nearest", "bilinear"])
def test_sample_matches_jax(filtering):
    """env sample of world directions through an oriented sky, and the
    bilinear lookup's gradient with respect to the direction."""
    from curvis_tpu.env.spherical_image import sample as jax_sample
    from curvis_tpu_torch.env.spherical_image import sample
    rng = np.random.default_rng(6)
    tex = rng.random((16, 32, 3))
    js = cv.make_spherical_image(tex, forward=[0.3, 1.0, 0.2],
                                 up=[0.0, 0.1, 1.0], dtype=jnp.float64)
    ts = convert.spherical_image_from_arrays(
        np.asarray(js.texture), np.asarray(js.rotation), device="cpu",
        dtype=F64)
    d = rng.normal(size=(4, 50, 3))
    want = jax_sample(js, jnp.asarray(d), filtering=filtering)
    td = _t(d).requires_grad_()
    got = sample(ts, td, filtering=filtering)
    assert tuple(got.shape) == (4, 50, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-12)
    if filtering == "bilinear":
        gj = jax.grad(lambda v: jnp.sum(jax_sample(js, v, filtering=filtering)
                                        * jnp.arange(3.0)))(jnp.asarray(d))
        (gt,) = torch.autograd.grad(torch.sum(got * torch.arange(3.0)), td)
        np.testing.assert_allclose(_np(gt), np.asarray(gj), rtol=1e-9,
                                   atol=1e-12)


# -------------------------------------------- (1) integrate/ckpt.py vs JAX

def _toy_step(lib):
    sin = jnp.sin if lib is jnp else torch.sin

    def step(theta, y):
        a, c = theta
        return (y[0] + 0.1 * a * sin(y[1]), y[1] * (1.0 - 0.05 * c * y[0]))
    return step


def test_ckpt_backward_matches_jax_toy_step():
    rng = np.random.default_rng(1)
    n = 40
    y0 = [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)]
    theta = [rng.uniform(0.5, 1.5, n), np.asarray(0.7)]
    steps = rng.integers(0, 23, n).astype(np.int32)
    cot = [rng.standard_normal(n), rng.standard_normal(n)]
    kw = dict(max_steps=23, segment=5)
    (jth, jy) = jckpt.ckpt_adjoint_backward(
        _toy_step(jnp), tuple(map(jnp.asarray, theta)),
        tuple(map(jnp.asarray, y0)), jnp.asarray(steps),
        tuple(map(jnp.asarray, cot)), **kw)
    (tth, ty) = tckpt.ckpt_adjoint_backward(
        _toy_step(torch), tuple(map(_t, theta)), tuple(map(_t, y0)),
        torch.from_numpy(steps), tuple(map(_t, cot)), **kw)
    for got, want in zip((*tth, *ty), (*jth, *jy)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12,
                                   atol=1e-15)
    # the forward recompute is the masked march: frozen rays bit-frozen
    y = tckpt.march_masked(_toy_step(torch), tuple(map(_t, theta)),
                           tuple(map(_t, y0)), torch.from_numpy(steps), **kw)
    still = steps == 0
    np.testing.assert_array_equal(_np(y[0])[still], y0[0][still])


def test_ckpt_backward_matches_jax_planar_step():
    """The planar Euler step with theta = (metric field, b): d_theta and
    d_y0 equal the JAX XLA twin's (same order) within 1e-10 relative."""
    rng = np.random.default_rng(2)
    n = 48
    alpha = rng.uniform(0.3, 2.8, n)
    l0 = np.full(n, 5.0)
    b = np.sin(alpha) * np.sqrt(1.0 + l0 ** 2)
    y0 = [l0, np.zeros(n), np.cos(alpha)]
    steps = rng.integers(0, 120, n).astype(np.int32)
    cot = [rng.standard_normal(n) for _ in range(3)]
    kw = dict(max_steps=120, segment=11)
    dt = 0.05
    jm = cv.make_metric("ellis", rho=1.0)
    (jg_m, jg_b), jlam = jckpt.ckpt_adjoint_backward(
        partial(jadj._step_theta, jnp.asarray(dt)), (jm, jnp.asarray(b)),
        tuple(map(jnp.asarray, y0)), jnp.asarray(steps),
        tuple(map(jnp.asarray, cot)), **kw)

    def step(theta, y):
        metric = EllisMetric(theta[0], device="cpu")
        return tpl.planar_euler_step(metric, *y, theta[1], dt)
    (tg_rho, tg_b), tlam = tckpt.ckpt_adjoint_backward(
        step, (_t(1.0), _t(b)), tuple(map(_t, y0)), torch.from_numpy(steps),
        tuple(map(_t, cot)), **kw)
    np.testing.assert_allclose(float(tg_rho), float(jg_m.rho), rtol=1e-10)
    np.testing.assert_allclose(_np(tg_b), np.asarray(jg_b), rtol=1e-10,
                               atol=1e-13)
    for got, want in zip(tlam, jlam):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10,
                                   atol=1e-13)


# ------------------- (2) plain gen/bwd with the hand-written VJP vs JAX

# metric slots (p0, p1, p2) of each kind, and where its states live
_SLOTS = {"ellis": ((1.3, 0.0, 0.0), (-6.0, 6.0)),
          "flat": ((0.0, 0.0, 0.0), (2.0, 9.0)),
          "interstellar": ((0.4, 0.5, 1.0), (-3.0, 3.0)),
          "schwarzschild": ((1.0, 0.0, 0.0), (4.0, 30.0)),
          "rn": ((1.0, 0.36, 0.0), (4.0, 30.0))}


@pytest.mark.parametrize("kind", sorted(_SLOTS))
def test_step_vjp_matches_torch_func_vjp(kind):
    """The hand-written VJP of one Euler step (transcribed from
    csrc/planar.cuh) equals torch.func.vjp of the step in the same forms,
    to 1e-14 relative (DNEG: rays inside and outside the throat)."""
    (pv, (lo, hi)) = _SLOTS[kind]
    rng = np.random.default_rng(3)
    n = 64
    l = _t(rng.uniform(lo, hi, n))
    if kind == "interstellar":
        assert (l.abs() < pv[1]).any() and (l.abs() > pv[1]).any()
    psi, p_l, b = (_t(rng.uniform(-1.0, 1.0, n)) for _ in range(3))
    lam = tuple(_t(rng.standard_normal(n)) for _ in range(3))
    dt = _t(0.05)
    p = tuple(_t(v) for v in pv)

    def f(l, psi, p_l, b, p0, p1, p2):
        return ca.euler_step(kind, dt, (p0, p1, p2), l, psi, p_l, b)
    _, pull = torch.func.vjp(f, l, psi, p_l, b,
                             *(v.expand(n) for v in p))
    want = pull(lam)
    lam_in, g = ca.euler_step_vjp(kind, dt, p, l, p_l, b, lam)
    for got, w in zip((*lam_in, g[3], *g[:3]), want):
        scale = float(w.abs().max()) or 1.0
        assert float((got - w).abs().max()) <= 1e-14 * scale


def _dneg_make_step(params_ref):
    """make_step in the forms of csrc/planar.cuh for DNEG (jnp.arctan,
    log1p): the JAX package's own DNEG step carries a degree-6 atan fit,
    which the port dropped."""
    dt = params_ref[0, 0]

    def step(theta, y):
        m, a, rho, b = theta
        l, psi, p_l = y
        x = 2.0 * (jnp.abs(l) - a) / (jnp.pi * m)
        at = jnp.arctan(x)
        out = jnp.abs(l) > a
        r = jnp.where(out, rho + m * (x * at - 0.5 * jnp.log1p(x * x)), rho)
        dr = jnp.where(out, jnp.where(l < 0, -1.0, 1.0) * (2 / jnp.pi) * at,
                       0.0)
        ir = 1.0 / r
        return (l + dt * p_l, psi + dt * (b * ir * ir),
                p_l + dt * (b * b * (dr * ir * ir * ir)))
    return step


@pytest.mark.parametrize("kind", ["ellis", "interstellar", "schwarzschild",
                                  "rn"])
def test_plain_ckpt_pair_matches_pallas_interpret(kind):
    """The plain gen/bwd pair (kernels #9/#10's plain versions) against the
    JAX Pallas kernel pair in interpret mode on the same inputs: 256 rays,
    steps up to 64, segment 16; lam and per-ray g_theta within 1e-10."""
    (pv, (lo, hi)) = _SLOTS[kind]
    rng = np.random.default_rng(4)
    n, max_steps, seg, dt = 256, 64, 16, 0.05
    y0 = [rng.uniform(lo, hi, n), rng.uniform(-1, 1, n),
          rng.uniform(-1, 1, n)]
    b = rng.uniform(-1.5, 1.5, n)
    steps = rng.integers(0, max_steps + 1, n).astype(np.int32)
    steps[:4] = [0, max_steps, seg, seg + 1]
    cot = [rng.standard_normal(n) for _ in range(3)]
    scal = [dt, 100.0, *pv, 0.0]

    make_step = (_dneg_make_step if kind == "interstellar"
                 else jadj._planar_make_step(kind))
    row = jnp.asarray([scal + [0.0] * 4])
    one = jnp.ones(n)
    theta = tuple(v * one for v in pv) + (jnp.asarray(b),)
    jlam, jg = ckpt_adjoint_backward_pallas(
        make_step, row, tuple(map(jnp.asarray, y0)), theta,
        jnp.asarray(steps, jnp.float64), tuple(map(jnp.asarray, cot)),
        max_steps=max_steps, seg=seg, tile_rows=8, interpret=True)
    tg, tlam = ca.ckpt_adjoint_backward_cuda(
        kind, scal, tuple(map(_t, y0)), _t(b), torch.from_numpy(steps),
        tuple(map(_t, cot)), seg=seg)
    for got, want in zip((*tlam, *tg), (*jlam, *jg)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10,
                                   atol=1e-12)
    # the checkpoint at segment s is the state after s*seg masked steps
    ck = ca.ckpt_gen_plain(kind, scal, tuple(map(_t, y0)), _t(b),
                           torch.from_numpy(steps), seg=seg, n_seg=4)
    want = jckpt.march_masked(make_step(row), theta, tuple(map(jnp.asarray,
                                                               y0)),
                              jnp.asarray(steps), max_steps=2 * seg,
                              segment=seg)
    np.testing.assert_allclose(_np(ck[2]), np.stack(want), rtol=1e-12,
                               atol=1e-12)


# -------------------------------------------------- (3) degenerate inputs

def test_ckpt_degenerate_inputs():
    """No step or no ray: d_y0 = cot and d_theta = 0 exactly (the JAX
    package's guard, tests/test_gradients.py), through the kernel
    wrapper, the generic adjoint and the march Function; steps stay int32."""
    cot = (torch.linspace(1.0, 2.0, 6, dtype=F64),) * 3
    y0 = tuple(torch.arange(6.0, dtype=F64) + 1.0 for _ in range(3))
    b = torch.ones(6, dtype=F64)
    zero = torch.zeros(6, dtype=torch.int32)
    g, lam = ca.ckpt_adjoint_backward_cuda("ellis", [0.1, 1.0, 1.0, 0, 0, 0],
                                           y0, b, zero, cot)
    for a, c in zip(lam, cot):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert all(bool((x == 0).all()) for x in g)
    e = torch.zeros(0, dtype=F64)
    g0, lam0 = ca.ckpt_adjoint_backward_cuda(
        "ellis", [0.1, 1.0, 1.0, 0, 0, 0], (e, e, e), e,
        torch.zeros(0, dtype=torch.int32), (e, e, e))
    assert lam0[0].shape == (0,) and g0[0].shape == (0,)
    th, ly = tckpt.ckpt_adjoint_backward(
        lambda th, y: (y[0] + th[0] * 0.1,), (torch.ones(6, dtype=F64),),
        (y0[0],), torch.full((6,), 3), (cot[0],), max_steps=0, segment=16)
    torch.testing.assert_close(ly[0], cot[0], rtol=0, atol=0)
    assert bool((th[0] == 0).all())
    with pytest.raises(ValueError, match="segment"):
        ca.ckpt_adjoint_backward_cuda("ellis", [0.1] * 6, y0, b, zero, cot,
                                      seg=65)
    # a march of zero steps: the Function's gradient is the identity
    rho = torch.tensor(1.0, dtype=F64, requires_grad=True)
    l = y0[0].clone().requires_grad_()
    out = tadj.march_planar_adjoint(EllisMetric(rho, device="cpu"),
                                    (l, y0[1], y0[2]), b, 0.05, 0, 20.0)
    assert out[4].dtype == torch.int32 and bool((out[4] == 0).all())
    out[0].sum().backward()
    assert bool((l.grad == 1).all()) and float(rho.grad) == 0.0


# ----------------------------- (4) march_planar_adjoint_rays vs JAX (xla)

_ADJ = {
    "ellis": (dict(rho=1.0), [0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2]),
    "interstellar": (dict(m=0.3, a=0.6, rho=1.0), [0.0, 5.0, np.pi / 2, 0.0],
                     [-1.0, 0.35, 0.2]),
    "rn": (dict(m=1.0, q=0.6), [0.0, 12.0, np.pi / 2, 0.0],
           [-1.0, 0.3, 0.15]),
    "schwarzschild": (dict(m=1.0), [0.0, 15.0, np.pi / 2, 0.0],
                      [-1.0, 0.1, 0.05]),
}


@pytest.mark.parametrize("kind", sorted(_ADJ))
def test_march_adjoint_matches_jax_xla(kind):
    """Same sign and steps; gradients of a loss of the escape angles with
    respect to the metric's fields, a shift of l and every ray's b equal
    the JAX package's (backend 'xla') within rtol 1e-8."""
    params, pos, fwd = _ADJ[kind]
    jm, tm = _metric_pair(kind, **params)
    jc, _ = _camera_pair(pos, fwd, (12, 8))
    jr = jpl.spawn_planar(jm, jc.position, jax_pixel_rays(jc))
    names = _FIELDS[kind]

    def jloss(fields, l_shift, b):
        metric = type(jm)(**dict(zip(names, fields)))
        rays = jr._replace(l=jr.l + l_shift, b=b)
        res = jadj.march_planar_adjoint_rays(metric, rays, backend="xla",
                                             **KW)
        beta = res.psi + jnp.arctan2(b / metric.r(res.l), res.p_l)
        return jnp.mean(jnp.where(res.sign != 0, jnp.sin(beta), 0.0)), res

    fields0 = tuple(jnp.asarray(getattr(jm, f)) for f in names)
    (jv, jres), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                        has_aux=True)(
        fields0, jnp.asarray(0.0), jr.b)

    tf = tuple(_t(np.asarray(f)).requires_grad_() for f in fields0)
    shift = _t(0.0).requires_grad_()
    tb = _t(np.asarray(jr.b)).requires_grad_()
    metric = type(tm)(*tf, device="cpu")
    tr = tpl.PlanarRays(*(_t(np.asarray(a)) for a in jr))
    tr = tr._replace(l=tr.l + shift, b=tb)
    res = tadj.march_planar_adjoint_rays(metric, tr, **KW)
    beta = res.psi + torch.atan2(tb / metric.r(res.l), res.p_l)
    tv = torch.mean(torch.where(res.sign != 0, torch.sin(beta),
                                torch.zeros_like(beta)))
    tg = torch.autograd.grad(tv, (*tf, shift, tb), retain_graph=True)

    np.testing.assert_array_equal(_np(res.sign), np.asarray(jres.sign))
    np.testing.assert_array_equal(_np(res.steps), np.asarray(jres.steps))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-12)
    want = (*jg[0], jg[1], jg[2])
    for got, w in zip(tg, want):
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=1e-8,
                                   atol=1e-14)
    assert float(tg[0].abs().max()) > 0
    if kind == "schwarzschild":
        # captured rays' cotangent is excluded: through the march alone,
        # their b receives nothing
        cap = res.sign == tpl.CAPTURED
        assert bool(cap.any())
        (gb,) = torch.autograd.grad((res.l + res.psi + res.p_l).sum(), tb)
        assert bool((gb[cap] == 0).all()) and bool((gb[~cap] != 0).any())


# ------------------------ (5) render_direct(differentiable='adjoint') vs JAX

def test_render_direct_adjoint_matches_jax_and_fd():
    (jp, tp), (jn, tn) = _smooth_skies()
    jc, tc = _camera_pair([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2],
                          (16, 10))
    w_j = jnp.linspace(0.5, 1.5, 10)[:, None, None]
    w_t = torch.linspace(0.5, 1.5, 10, dtype=F64)[:, None, None]

    def jrender(rho):
        return cv.render_direct(cv.EllisMetric(rho=rho), jc, jp, jn,
                                method="planar", filtering="bilinear",
                                differentiable="adjoint", **KW)

    def trender(rho, mode="adjoint"):
        return render_direct(EllisMetric(rho, device="cpu"), tc, tp, tn,
                             filtering="bilinear", differentiable=mode, **KW)

    rho0 = 1.0
    jimg = jrender(jnp.asarray(rho0))
    jgrad = jax.grad(lambda r: jnp.mean(jrender(r) * w_j))(jnp.asarray(rho0))
    rho = _t(rho0).requires_grad_()
    img = trender(rho)
    assert tuple(img.shape) == (10, 16, 3)
    np.testing.assert_allclose(_np(img), np.asarray(jimg), rtol=0,
                               atol=1e-10)
    (g,) = torch.autograd.grad(torch.mean(img * w_t), rho)
    assert abs(float(g)) > 1e-7
    np.testing.assert_allclose(float(g), float(jgrad), rtol=1e-6)
    eps = 1e-5
    with torch.no_grad():
        fd = (torch.mean(trender(_t(rho0 + eps), False) * w_t)
              - torch.mean(trender(_t(rho0 - eps), False) * w_t)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=5e-3)


def test_render_direct_scan_and_refusals():
    """differentiable=True runs the checkpointed scan: same image and
    gradient as the adjoint; frame3d and other steppers raise naming their
    ROADMAP items."""
    (_, tp), (_, tn) = _smooth_skies()
    _, tc = _camera_pair([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2],
                         (8, 6))
    kw = dict(dt=0.05, max_steps=600, escape_radius=12.0,
              filtering="bilinear")
    grads, imgs = [], []
    for mode in ("adjoint", True):
        rho = _t(1.0).requires_grad_()
        img = render_direct(EllisMetric(rho, device="cpu"), tc, tp, tn,
                            differentiable=mode, **kw)
        imgs.append(img.detach())
        grads.append(torch.autograd.grad(img.mean(), rho)[0])
    torch.testing.assert_close(imgs[0], imgs[1], rtol=0, atol=1e-13)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-9, atol=0)
    m = EllisMetric(1.0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        render_direct(m, tc, tp, tn, method="frame3d", **kw)
    with pytest.raises(NotImplementedError, match="render_planar_fast"):
        render_direct(m, tc, tp, tn, stepper="rk45", **kw)


# --------------------------------------------------------- (6) fit vs JAX

def test_fit_quadratic_matches_jax():
    res_j = jax_fit(lambda p: jnp.sum((p - 3.0) ** 2), jnp.zeros(2),
                    iters=50, lr=2e-1)
    res_t = fit(lambda p: torch.sum((p - 3.0) ** 2),
                torch.zeros(2, dtype=F64), iters=50, lr=2e-1)
    assert len(res_t.history) == 51
    np.testing.assert_allclose(res_t.history, res_j.history, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(_np(res_t.params), np.asarray(res_j.params),
                               rtol=0, atol=1e-9)
    assert abs(res_t.loss - float(torch.sum((res_t.params - 3.0) ** 2))) \
        < 1e-12


def test_fit_schedule_and_dict_params_match_jax():
    target = [2.0, -1.0]

    def jloss(p, tau):
        return jnp.sum((p["x"] - jnp.asarray(target)) ** 2) \
            + tau * jnp.sum(p["x"] ** 2)

    def tloss(p, tau):
        return torch.sum((p["x"] - _t(target)) ** 2) \
            + tau * torch.sum(p["x"] ** 2)

    sched = lambda i: max(0.0, 1.0 - i / 100.0)            # noqa: E731
    res_j = jax_fit(jloss, {"x": jnp.zeros(2)}, iters=200, lr=5e-2,
                    schedule=sched)
    res_t = fit(tloss, {"x": torch.zeros(2, dtype=F64)}, iters=200,
                lr=5e-2, schedule=sched)
    np.testing.assert_allclose(res_t.history, res_j.history, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(_np(res_t.params["x"]), target, atol=1e-2)
    assert res_t.converged() and res_j.converged()


def test_fit_nan_guard_matches_optax_zero_nans():
    """A NaN gradient entry is zeroed (its parameter stays put, the others
    descend); an infinite one is kept, as optax.zero_nans does, and drives
    its parameter to NaN in both packages."""
    init = np.array([-0.5, 2.0, 0.0])

    def jloss(p):
        return (jnp.sum((p[1:] - 1.0) ** 2)
                + jnp.where(p[0] > 0, jnp.sqrt(p[0]), 0.0)    # NaN grad
                + jnp.sqrt(p[2]))                             # inf grad

    def tloss(p):
        return (torch.sum((p[1:] - 1.0) ** 2)
                + torch.where(p[0] > 0, torch.sqrt(p[0]), torch.zeros(()))
                + torch.sqrt(p[2]))

    res_j = jax_fit(jloss, jnp.asarray(init), iters=20, lr=1e-1)
    res_t = fit(tloss, _t(init), iters=20, lr=1e-1)
    pj, pt = np.asarray(res_j.params), _np(res_t.params)
    assert pt[0] == pj[0] == -0.5
    np.testing.assert_allclose(pt[1], pj[1], rtol=0, atol=1e-9)
    assert np.isnan(pt[2]) and np.isnan(pj[2])
    np.testing.assert_array_equal(np.isnan(res_t.history),
                                  np.isnan(res_j.history))


def test_fit_multistart_matches_jax():
    """Multi-start from init_sampler (the same numpy draws), and from
    stacked starts; every start's history as JAX's vmapped run."""
    def sampler(lib):
        return lambda rng, i: lib(rng.standard_normal(2) * 2.0)

    kw = dict(iters=30, lr=1e-1, n_starts=3)
    res_j = jax_fit(lambda p: jnp.sum((p ** 2 - 1.0) ** 2), None,
                    init_sampler=sampler(jnp.asarray), **kw)
    res_t = fit(lambda p: torch.sum((p ** 2 - 1.0) ** 2), None,
                init_sampler=sampler(_t), **kw)
    np.testing.assert_allclose(res_t.all_histories, res_j.all_histories,
                               rtol=0, atol=1e-9)
    assert res_t.best_index == res_j.best_index
    assert tuple(res_t.all_params.shape) == (3, 2)
    stacked = np.array([[0.5, 2.0], [-1.5, 0.2]])
    rj = jax_fit(lambda p: jnp.sum((p - 1.0) ** 2), jnp.asarray(stacked),
                 iters=10, lr=1e-1, n_starts=2)
    rt = fit(lambda p: torch.sum((p - 1.0) ** 2), _t(stacked), iters=10,
             lr=1e-1, n_starts=2)
    np.testing.assert_allclose(rt.all_histories, rj.all_histories, rtol=0,
                               atol=1e-9)


def test_fit_all_nan_and_converged_match_jax():
    def sampler(lib):
        return lambda rng, i: lib(rng.standard_normal(2))

    res_j = jax_fit(lambda p: jnp.sum(p ** 2) * jnp.nan, None, iters=10,
                    lr=1e-2, n_starts=2, init_sampler=sampler(jnp.asarray))
    res_t = fit(lambda p: torch.sum(p ** 2) * torch.nan, None, iters=10,
                lr=1e-2, n_starts=2, init_sampler=sampler(_t))
    assert np.isnan(res_t.loss) and res_t.best_index == res_j.best_index == 0
    assert res_t.all_histories.shape == (2, 11)
    assert not res_t.converged() and not res_j.converged()
    with pytest.raises(ValueError, match="iters"):
        fit(lambda p: p.sum(), torch.zeros(1), iters=0)
    h = np.concatenate([np.linspace(1.0, 0.1, 50), np.linspace(0.1, 0.9, 50)])
    for hist in (np.linspace(1.0, 9.0, 100), h, np.geomspace(1.0, 1e-6, 80),
                 np.full(30, 2.0)):
        kw = dict(params=None, loss=float(hist[-1]), history=hist,
                  best_index=0, all_params=None,
                  all_finals=hist[-1:], all_histories=None)
        assert FitResult(**kw).converged() == JaxFitResult(**kw).converged()


# ------------------------------------------------------- (7) the repairs

def test_factories_target_the_gpu_unless_asked(monkeypatch):
    """Without ``device`` every factory builds on the current CUDA device;
    with no card (here) that raises instead of building on the CPU."""
    makers = [
        lambda: ct.make_metric("ellis", rho=1.0),
        lambda: EllisMetric(1.0),
        lambda: ct.make_camera([0, 5, 1.5, 0], [-1, 0, 0], [0, 0, 1], 15.0,
                               43.0, 4, 4),
        lambda: ct.make_spherical_image(np.zeros((4, 8, 3))),
        lambda: convert.metric_from_arrays("rn", m=1.0, q=0.5),
        lambda: convert.camera_from_arrays([0, 5, 1.5, 0], [-1, 0, 0],
                                           [0, 0, 1], 15.0, 43.0, 4, 4),
        lambda: convert.spherical_image_from_arrays(np.zeros((4, 8, 3)),
                                                    np.eye(3)),
        lambda: MetricSettings(kind="ellis").make(),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert ct.make_metric("ellis", device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tdevice.resolve_device(None) == torch.device("cuda", 0)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_metric_tensor_parameters_keep_their_graph():
    """A tensor passed to a metric stays in the caller's graph (also after
    ``.to``), so a loss of ``EllisMetric(rho=params['rho'])`` reaches it."""
    params = {"rho": torch.tensor(1.2, dtype=F64, requires_grad=True)}
    metric = EllisMetric(rho=params["rho"], device="cpu")
    assert metric.rho is params["rho"] and metric.device.type == "cpu"
    l = torch.linspace(-3.0, 3.0, 7, dtype=F64)
    metric.to(torch.float32).r(l.float()).sum().backward()
    want = torch.sum(1.2 / torch.sqrt(1.44 + l * l))
    torch.testing.assert_close(params["rho"].grad, want, rtol=1e-6, atol=0)
    q = torch.tensor(0.5, dtype=F64, requires_grad=True)
    rn = ct.ReissnerNordstromMetric(1.0, q, device="cpu")
    (g,) = torch.autograd.grad(rn.lapse(_t(4.0)), q)
    np.testing.assert_allclose(float(g), 2 * 0.5 / 16.0, rtol=1e-12)
    # the headline recipe: fit() recovers rho through the adjoint render
    (_, tp), (_, tn) = _smooth_skies()
    _, tc = _camera_pair([0.0, 5.0, np.pi / 2, 0.0], [1.0, 0.6, 0.3], (8, 6))
    kw = dict(dt=0.05, max_steps=600, escape_radius=12.0,
              filtering="bilinear", differentiable="adjoint")
    target = render_direct(EllisMetric(1.6, device="cpu"), tc, tp, tn, **kw)

    def loss(p):
        img = render_direct(EllisMetric(rho=p["rho"], device="cpu"), tc, tp,
                            tn, **kw)
        return torch.mean((img - target) ** 2)
    res = fit(loss, {"rho": _t(1.0)}, iters=3, lr=5e-2)
    assert res.history[-1] < res.history[0]
    assert float(res.params["rho"]) > 1.0
