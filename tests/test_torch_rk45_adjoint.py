"""PyTorch port vs the JAX package: the differentiable error-controlled
planar march (``integrate/rk45_adjoint_planar.py``) and its checkpoint
kernels' plain versions (``ops/ckpt_rk45_cuda.py``), on the CPU in float64.

Held against their JAX counterparts on the same numpy inputs:

- the twin iteration ``_planar_rk45_iter`` against JAX's, one iteration on
  seeded states that reject, escape and stall, both controller modes:
  values to 1e-13 of the outputs' scale, VJPs to 1e-11 (sums of many
  terms in another order; DNEG: the JAX closure evaluates atan with the
  degree-6 polynomial ``_ATAN6``, the port with ``torch.atan``: 1e-5 and
  1e-4);
- ``march_planar_rk45_adjoint`` against JAX ``backend='xla'``: equal sign
  and steps, final states to 1e-9 (XLA fuses the f64 while loop and
  rounds some operations differently, one ulp at the first iteration that
  the adaptive march amplifies to ~1e-10 over a few hundred iterations;
  DNEG, whose trajectories differ by the atan polynomial's error, to
  1e-3), and the gradients of a loss of the escape angles with respect to
  the metric's fields, a shift of l and every ray's b, with
  ``freeze_controller`` off and on, to 1e-8 relative (DNEG 1e-3);
- ``rk45_iter_vjp_plain`` (the kernels' hand-written VJP) against
  ``torch.func.vjp`` of ``rk45_iter_plain`` (the kernels' arithmetic) to
  1e-12 with the controller frozen and 1e-9 with it on, and at a tie of
  jnp.clip, where both split the cotangent in halves as ``jax.grad``
  does;
- the plain checkpoint pair against ``integrate/ckpt.py`` under autograd
  on the twin to 1e-8, and against JAX's Pallas pair in interpret mode
  (JAX's own closures and autodiff) to 1e-7.

The VJP tolerances are those of sums taken in another order.  With the
controller on (``freeze_controller=False``) the cotangent of the error
norm reaches every stage through its slope e = d5 - d4, a difference that
cancels four to six digits, scaled by 1 / (atol + rtol |y|): two correct
VJPs of one map then differ by up to ~1e-9 of the outputs' scale on a
ray whose step the controller grows (err ~ 1e-3); frozen, ~1e-14.
- ``render_direct(stepper='rk45', differentiable='adjoint')`` against the
  JAX call: the image and d / d rho.

Sizes are small (48 rays, a few hundred iterations) because tier-1 is
near its time limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vjp

import curvis_tpu as cv
from curvis_tpu.camera.camera import pixel_rays_world as jax_pixel_rays
from curvis_tpu.integrate import rk45_adjoint_planar as jrk
from curvis_tpu.ops.ckpt_adjoint_pallas import ckpt_adjoint_backward_pallas
from curvis_tpu.physics import planar as jpl

from curvis_tpu_torch import convert
from curvis_tpu_torch.integrate import rk45_adjoint_planar as trk
from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.metrics.base import EllisMetric
from curvis_tpu_torch.ops import ckpt_rk45_cuda as cr
from curvis_tpu_torch.ops.rk45_cuda import (jclip, march_planar_rk45_plain,
                                            rk45_scalars, trial_rec_plain)
from curvis_tpu_torch.physics import planar as tpl
from curvis_tpu_torch.render.direct import render_direct

F64 = torch.float64
_FIELDS = {"ellis": ("rho",), "interstellar": ("m", "a", "rho"),
           "schwarzschild": ("m",), "rn": ("m", "q"), "flat": ()}
# metric parameters, camera position and forward direction of each kind
_CASES = {
    "ellis": (dict(rho=1.0), [0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2]),
    "interstellar": (dict(m=0.1, a=0.5, rho=1.0), [0.0, 6.0, np.pi / 2, 0.0],
                     [-1.0, 0.1, 0.05]),
    "rn": (dict(m=1.0, q=0.6), [0.0, 12.0, np.pi / 2, 0.0],
           [-1.0, 0.3, 0.15]),
    "schwarzschild": (dict(m=1.0), [0.0, 15.0, np.pi / 2, 0.0],
                      [-1.0, 0.1, 0.05]),
    "flat": (dict(), [0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2]),
}
# the slots (p0, p1, p2) of each kind's metric above
_SLOTS = {"ellis": (1.0, 0.0, 0.0), "interstellar": (0.1, 0.5, 1.0),
          "rn": (1.0, 0.36, 0.0), "schwarzschild": (1.0, 0.0, 0.0),
          "flat": (0.0, 0.0, 0.0)}
KW = dict(dt0=0.05, max_steps=400, escape_radius=20.0)
CONSTS = (1e-5, 1e-7, 1e-6, 10.0, 20.0)          # rtol atol dt_min dt_max R


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _np(t):
    return t.detach().cpu().numpy()


def _scale_err(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _metric_pair(kind):
    params = _CASES[kind][0]
    jm = cv.make_metric(kind, **params)
    tm = convert.metric_from_arrays(
        kind, device="cpu", dtype=F64,
        **{k: np.asarray(getattr(jm, k)) for k in _FIELDS[kind]})
    return jm, tm


def _r_cap(kind):
    return {"schwarzschild": 2.0, "rn": 1.8}.get(kind, -1e30)


def _states(kind, seed, n=48):
    """Seeded (l, psi, p_l, dt, b): a third of the rays step far (reject),
    a third start near +-R (escape), a sixth sit at the dt floor (stall)."""
    rng = np.random.default_rng(seed)
    lo = 3.0 if kind in ("schwarzschild", "rn") else -12.0
    l = rng.uniform(lo, 19.0, n)
    l[n // 3: 2 * n // 3] = rng.choice([-1.0, 1.0], n // 3) * rng.uniform(
        19.8, 19.99, n // 3)
    if kind in ("schwarzschild", "rn"):
        l[n // 3: 2 * n // 3] = np.abs(l[n // 3: 2 * n // 3])
    psi = rng.uniform(-2.0, 2.0, n)
    p_l = rng.uniform(-1.0, 1.0, n)
    b = rng.uniform(0.2, 4.0, n)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.5), n))
    dt[: n // 3] = rng.uniform(2.0, 8.0, n // 3)
    dt[-n // 6:] = 1e-6
    return l, psi, p_l, dt, b


# ------------------------------------------------------- one iteration

@pytest.mark.parametrize("kind", sorted(_CASES))
def test_twin_iteration_matches_jax(kind):
    """The twin map and its VJP against JAX's, eagerly (no fused loop), in
    both controller modes."""
    l, psi, p_l, dt, b = _states(kind, seed=3)
    slots = _SLOTS[kind]
    consts_j = tuple(jnp.asarray(c) for c in CONSTS + (_r_cap(kind),))
    consts_t = tuple(_t(c) for c in CONSTS + (_r_cap(kind),))
    cot = np.random.default_rng(4).standard_normal((4, l.size))
    tol = 1e-5 if kind == "interstellar" else 1e-13
    for freeze in (False, True):
        def fj(theta, y):
            return jrk._planar_rk45_iter(kind, consts_j, theta, y, freeze)[0]

        theta_j = tuple(jnp.asarray(s) for s in slots) + (jnp.asarray(b),)
        y_j = tuple(jnp.asarray(a) for a in (l, psi, p_l, dt))
        out_j, pull_j = jax.vjp(fj, theta_j, y_j)
        gj = pull_j(tuple(jnp.asarray(c) for c in cot))

        def ft(theta, y):
            return trk._planar_rk45_iter(kind, consts_t, theta, y, freeze)[0]

        theta_t = tuple(_t(s) for s in slots) + (_t(b),)
        out_t, pull_t = vjp(ft, theta_t, tuple(_t(a) for a in (l, psi, p_l,
                                                                dt)))
        gt = pull_t(tuple(_t(c) for c in cot))
        for a, c in zip(out_j, out_t):
            assert _scale_err(a, _np(c)) <= tol
        used = 3 if kind == "flat" else len(_FIELDS[kind]) or 3
        for a, c in zip(list(gj[0][:used]) + [gj[0][3], *gj[1]],
                        list(gt[0][:used]) + [gt[0][3], *gt[1]]):
            assert _scale_err(a, _np(c)) <= (1e-4 if kind == "interstellar"
                                             else 1e-11)


def _iter_inputs(kind, seed):
    l, psi, p_l, dt, b = _states(kind, seed)
    _, scal = rk45_scalars(_metric_pair(kind)[1], 0.05, 20.0, 1e-5, 1e-7,
                           10.0)
    row = _t(scal)
    return row, tuple(_t(a) for a in (l, psi, p_l, dt)), _t(b)


@pytest.mark.parametrize("kind", sorted(_CASES))
def test_iter_vjp_plain_matches_autograd(kind):
    """The kernels' hand-written VJP against torch.func.vjp of the plain
    iteration (the kernels' arithmetic), rejected, escaping and stalling
    rays included, with freeze_controller off and on."""
    row, y, b = _iter_inputs(kind, seed=5)
    r = trial_rec_plain(kind, (row[2], row[3], row[4]), row[1], row[6],
                        row[7], *y[:3], b, y[3])
    assert bool((~r["accept"]).any()) and bool((r["esc_pos"]
                                                | r["esc_neg"]).any())
    assert bool((y[3] <= cr.STALL_DT).any())
    lam = tuple(_t(c) for c in np.random.default_rng(6).standard_normal(
        (4, b.numel())))
    for freeze in (False, True):
        theta = (row[2], row[3], row[4], b)
        _, pull = vjp(lambda th, yy: cr.rk45_iter_plain(kind, row, th, yy,
                                                        freeze), theta, y)
        g_theta, g_y = pull(lam)
        lam_in, g = cr.rk45_iter_vjp_plain(kind, row, y, b, lam, freeze)
        tol = 1e-12 if freeze else 1e-9
        for want, got in zip(g_y, lam_in):
            assert _scale_err(_np(want), _np(got)) <= tol
        assert _scale_err(_np(g_theta[3]), _np(g[3])) <= tol
        for i in range(3):
            assert abs(float(g_theta[i]) - float(g[i].sum())) <= tol * max(
                float(g[i].abs().sum()), 1e-300)


def test_clip_tie_splits_like_jax():
    """At a tie with a bound, jnp.clip (a max then a min) passes half the
    cotangent; ``jclip`` and the hand VJPs' shares do the same, where
    torch.clamp would pass all of it."""
    for x0, lo, hi in ((0.0, 0.0, 1.0), (1.0, 0.0, 1.0), (0.5, 0.0, 1.0)):
        gj = float(jax.grad(lambda x: jnp.clip(x, lo, hi))(x0))
        x = _t(x0).requires_grad_()
        (gt,) = torch.autograd.grad(jclip(x, lo, hi), x)
        assert float(gt) == gj == float(cr._clip_share(_t(x0), lo, hi))
    assert float(cr._max_share(_t(1.0), 1.0)) == float(
        jax.grad(lambda a: jnp.maximum(a, 1.0))(1.0)) == 0.5


# ------------------------------------------------------- the march

def _spawn(kind, res=(8, 6)):
    jm, tm = _metric_pair(kind)
    _, pos, fwd = _CASES[kind]
    jc = cv.make_camera(pos, fwd, [0.0, 0.0, 1.0], 15.0, 43.0, *res,
                        dtype=jnp.float64)
    jr = jpl.spawn_planar(jm, jc.position, jax_pixel_rays(jc))
    return jm, tm, jr, jr.l * jnp.ones_like(jr.psi)


def _beta_loss(res, b, r_of, xp, atan2):
    beta = res[1] + atan2(b / r_of(res[0]), res[2])
    return xp.mean(xp.where(res[3] != 0, xp.sin(beta), 0.0 * beta))


def _jax_march(kind, freeze):
    jm, _, jr, l0 = _spawn(kind)
    names = _FIELDS[kind]

    def f(fields, shift, b):
        metric = type(jm)(**dict(zip(names, fields)))
        out = jrk.march_planar_rk45_adjoint(
            metric, (l0 + shift, jr.psi, jr.p_l), b, backend="xla",
            freeze_controller=freeze, **KW)
        return _beta_loss(out, b, metric.r, jnp, jnp.arctan2), out

    fields0 = tuple(jnp.asarray(getattr(jm, k)) for k in names)
    (v, out), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        fields0, jnp.asarray(0.0), jr.b)
    return float(v), [np.asarray(o) for o in out], g, fields0


def _port_march(kind, freeze, fields0):
    _, tm, jr, l0 = _spawn(kind)
    tf = tuple(_t(np.asarray(f)).requires_grad_() for f in fields0)
    shift = _t(0.0).requires_grad_()
    tb = _t(np.asarray(jr.b)).requires_grad_()
    metric = type(tm)(*tf, device="cpu") if tf else tm
    out = trk.march_planar_rk45_adjoint(
        metric, (_t(np.asarray(l0)) + shift, _t(np.asarray(jr.psi)),
                 _t(np.asarray(jr.p_l))), tb, freeze_controller=freeze, **KW)
    return out, metric, (*tf, shift, tb)


@pytest.mark.parametrize("kind,freeze", [("ellis", False), ("ellis", True),
                                         ("schwarzschild", True)])
def test_march_gradients_match_jax_xla(kind, freeze):
    """Equal sign and steps, final states to 1e-9, and the gradients of a
    loss of the escape angles w.r.t. the metric's fields, a shift of l
    and every ray's b to 1e-8 relative."""
    jv, jout, jg, fields0 = _jax_march(kind, freeze)
    out, metric, params = _port_march(kind, freeze, fields0)
    np.testing.assert_array_equal(_np(out[3]), jout[3])
    np.testing.assert_array_equal(_np(out[4]), jout[4])
    for i in range(3):
        assert _scale_err(jout[i], _np(out[i])) <= 1e-9
    tb = params[-1]
    tv = _beta_loss(out, tb, metric.r, torch, torch.atan2)
    assert abs(float(tv.detach()) - jv) <= 1e-9 * abs(jv)
    tg = torch.autograd.grad(tv, params, retain_graph=True)
    for got, want in zip(tg, (*jg[0], jg[1], jg[2])):
        assert _scale_err(np.asarray(want), _np(got)) <= 1e-8
    assert float(tg[0].abs().max()) > 0
    if kind == "schwarzschild":
        # captured rays' cotangent is excluded, their replay has length 0
        cap = out[3] == tpl.CAPTURED
        assert bool(cap.any())
        (gb,) = torch.autograd.grad((out[0] + out[1] + out[2]).sum(), tb)
        assert bool((gb[cap] == 0).all()) and bool((gb[~cap] != 0).any())


@pytest.mark.parametrize("kind", ["rn", "flat", "interstellar"])
def test_march_forward_matches_jax_xla(kind):
    """The forward alone: equal sign and steps, final states to 1e-9; DNEG
    (the atan polynomial) equal signs and states to 1e-3."""
    jm, _, jr, l0 = _spawn(kind)
    jout = [np.asarray(o) for o in jrk.march_planar_rk45_adjoint(
        jm, (l0, jr.psi, jr.p_l), jr.b, backend="xla", **KW)]
    fields0 = tuple(jnp.asarray(getattr(jm, k)) for k in _FIELDS[kind])
    out, _, _ = _port_march(kind, False, fields0)
    dneg = kind == "interstellar"
    np.testing.assert_array_equal(_np(out[3]), jout[3])
    if not dneg:
        np.testing.assert_array_equal(_np(out[4]), jout[4])
    for i in range(3):
        assert _scale_err(jout[i], _np(out[i])) <= (1e-3 if dneg else 1e-9)


@pytest.mark.parametrize("kind", ["ellis", "schwarzschild", "rn", "flat"])
def test_twin_forward_is_the_kernels_map(kind):
    """Off the guards the twin's map is the kernels' in f64: the twin march
    and kernel #4's plain version give the same sign, steps and iteration
    counts and states to 1e-12."""
    _, tm, jr, l0 = _spawn(kind)
    state = (_t(np.asarray(l0)), _t(np.asarray(jr.psi)),
             _t(np.asarray(jr.p_l)))
    tb = _t(np.asarray(jr.b))
    k, p = trk.metric_slots(tm, state[0])
    consts = trk._consts(tm, 1e-5, 1e-7, 1e-6, 10.0, 20.0, state[0])
    out, iters = trk._forward_twin(k, consts, (*p, tb), state, 0.05, 400,
                                   1600)
    _, scal = rk45_scalars(tm, 0.05, 20.0, 1e-5, 1e-7, 10.0)
    ref = march_planar_rk45_plain(k, scal, *state, tb, max_steps=400,
                                  max_iters=1600)
    for i in (3, 4):
        assert torch.equal(out[i], ref[i])
    assert torch.equal(iters, ref[5])
    for i in range(3):
        assert _scale_err(_np(ref[i]), _np(out[i])) <= 1e-12


# ------------------------------------------------------- the plain pair

def _pair_inputs(kind, seed):
    _, tm, jr, l0 = _spawn(kind)
    state = (_t(np.asarray(l0)), _t(np.asarray(jr.psi)),
             _t(np.asarray(jr.p_l)))
    tb = _t(np.asarray(jr.b))
    k, p = trk.metric_slots(tm, state[0])
    consts = trk._consts(tm, 1e-5, 1e-7, 1e-6, 10.0, 20.0, state[0])
    out, iters = trk._forward_twin(k, consts, (*p, tb), state, 0.05, 400,
                                   1600)
    smooth = out[3].abs() <= 1
    counts = torch.where(smooth, iters, torch.zeros_like(iters))
    cot = _t(np.random.default_rng(seed).standard_normal((4, tb.numel())))
    cot[3] = 0.0
    cot[:3] = torch.where(smooth, cot[:3], torch.zeros_like(cot[:3]))
    _, scal = rk45_scalars(tm, 0.05, 20.0, 1e-5, 1e-7, 10.0)
    return tm, k, p, consts, state, tb, counts, cot, scal


@pytest.mark.parametrize("kind,freeze", [("ellis", False),
                                         ("schwarzschild", True),
                                         ("rn", False)])
def test_plain_pair_matches_twin_backward(kind, freeze):
    """Kernels #9 / #10's plain versions against integrate/ckpt.py under
    autograd on the twin: the same map off the guards, so 1e-9."""
    _, k, p, consts, state, tb, counts, cot, scal = _pair_inputs(kind, 8)
    y0 = state + (torch.full_like(state[0], 0.05),)
    d_theta, lam = ckpt_adjoint_backward(
        lambda th, y: trk._planar_rk45_step(k, consts, th, y, freeze),
        (*p, tb), y0, counts, tuple(cot), max_steps=1600, segment=16)
    g, lam_p = cr.ckpt_rk45_backward_cuda(k, scal, freeze, state, tb,
                                          counts.to(torch.int32), cot)
    for want, got in zip(lam, lam_p):
        assert _scale_err(_np(want), _np(got)) <= 1e-8
    assert _scale_err(_np(d_theta[3]), _np(g[3])) <= 1e-8
    for i in range(3):
        assert abs(float(d_theta[i]) - float(g[i].sum())) <= 1e-8 * max(
            abs(float(d_theta[i])), 1e-12)
    assert float(g[0].abs().max()) > 0


def test_plain_pair_matches_jax_pallas_interpret():
    """The plain pair against JAX's Pallas pair (interpret mode) on the
    same replay counts and cotangent: Ellis, freeze_controller off."""
    tm, k, p, consts, state, tb, counts, cot, scal = _pair_inputs("ellis",
                                                                  9)
    g, lam = cr.ckpt_rk45_backward_cuda(k, scal, False, state, tb,
                                        counts.to(torch.int32), cot)
    one = jnp.ones(tb.numel())
    theta = (1.0 * one, 0.0 * one, 0.0 * one, jnp.asarray(_np(tb)))
    params = jnp.asarray([[1e-5, 1e-7, 1e-6, 10.0, 20.0, -1e30]])
    y0 = tuple(jnp.asarray(_np(a)) for a in state) + (0.05 * one,)
    lam_j, g_j = ckpt_adjoint_backward_pallas(
        jrk._planar_rk45_make_step("ellis", False), params, y0, theta,
        jnp.asarray(_np(counts), jnp.float64),
        tuple(jnp.asarray(_np(c)) for c in cot),
        max_steps=int(counts.max()), seg=cr.SEG, interpret=True)
    for want, got in zip(lam_j, lam):
        assert _scale_err(np.asarray(want), _np(got)) <= 1e-7
    assert _scale_err(np.asarray(g_j[3]), _np(g[3])) <= 1e-7
    assert abs(float(jnp.sum(g_j[0])) - float(g[0].sum())) <= 1e-7 * abs(
        float(jnp.sum(g_j[0])))


# ------------------------------------------------------- render_direct

def _skies():
    yy, xx = np.mgrid[0:32, 0:64]
    smooth = np.stack([np.sin(2 * np.pi * xx / 64) * 0.5 + 0.5, yy / 32,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / 32)], -1)
    out = []
    for tex in (smooth, smooth[::-1].copy()):
        jb = cv.make_spherical_image(tex, dtype=jnp.float64)
        out.append((jb, convert.spherical_image_from_arrays(
            np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
            dtype=F64)))
    return out


def test_render_direct_rk45_adjoint_matches_jax():
    (jp, tp), (jn, tn) = _skies()
    jc = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2],
                        [0.0, 0.0, 1.0], 15.0, 43.0, 12, 8,
                        dtype=jnp.float64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        12, 8, device="cpu", dtype=F64)
    kw = dict(dt=0.05, max_steps=400, escape_radius=20.0, stepper="rk45",
              filtering="bilinear", differentiable="adjoint")
    w = np.linspace(0.5, 1.5, 8)[:, None, None]

    def jrender(rho):
        return cv.render_direct(cv.EllisMetric(rho=rho), jc, jp, jn,
                                method="planar", **kw)

    jimg = np.asarray(jrender(jnp.asarray(1.0)))
    jg = float(jax.grad(lambda r: jnp.mean(jrender(r) * w))(
        jnp.asarray(1.0)))
    rho = _t(1.0).requires_grad_()
    img = render_direct(EllisMetric(rho, device="cpu"), tc, tp, tn, **kw)
    assert tuple(img.shape) == (8, 12, 3)
    assert _scale_err(jimg, _np(img)) <= 1e-8
    (g,) = torch.autograd.grad(torch.mean(img * _t(w)), rho)
    assert abs(float(g)) > 1e-7
    assert abs(float(g) - jg) <= 1e-7 * abs(jg)
    m = EllisMetric(1.0, device="cpu")
    for mode in (False, True, "scan"):
        with pytest.raises(NotImplementedError, match="render_planar_fast"):
            render_direct(m, tc, tp, tn, **dict(kw, differentiable=mode))
