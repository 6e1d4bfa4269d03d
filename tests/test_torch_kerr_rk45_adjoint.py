"""PyTorch port vs the JAX package: the adaptive DP5(4) Kerr / Kerr-Newman
gradients (``integrate/rk45_adjoint.py``) and the checkpoint kernels' Kerr
DP5(4) family's plain versions (``ops/ckpt_kerr_cuda.py``), on the CPU in
float64.

Held against their JAX counterparts on the same numpy inputs:

- the twin iteration ``_rk45_iter`` against JAX's (eagerly), one iteration
  on seeded states that reject, escape, over-reject at R and stall, the
  controller on: the written-back state to 1e-13 of the outputs' scale,
  the next dt to 1e-9 (err inherits the cancellation of its slope e = d5 -
  d4, four to six digits: measured 1.6e-10), the VJP to 1e-9;
- the masked forward against JAX ``_forward_xla_rk45``: equal sign, steps
  and iterations, escaped states to 1e-9 (as the planar DP5(4) adjoint's
  test);
- ``kerr_rk45_iter_vjp_plain`` (the kernels' hand-written VJP) against
  ``torch.func.vjp`` of ``kerr_rk45_iter_plain`` (the kernels'
  arithmetic): 1e-11 frozen, 1e-9 with the controller on;
- the backward against JAX's Pallas pair in interpret mode (JAX's own map
  and autodiff) on one cotangent, the controller on: the plain checkpoint
  pair to 1e-7, and the gradients of ``march_kerr_rk45_adjoint`` with
  respect to (M, a, q, x0, p0) (its autograd Function on the twin route,
  with E and L's identity terms) to 1e-8 relative; ``freeze_controller``
  gives another gradient;
- ``render_kerr(stepper='rk45', backend='adjoint' | 'scan')``: the image
  against JAX's, and a finite d / da;
- an odd ``max_iters`` rounded up to even.

The VJP tolerances are those of sums taken in another order.  With the
controller on, the cotangent of the error norm reaches every stage through
e, scaled by 1 / (atol + rtol |y|): two correct VJPs of one map then differ
by up to ~1e-9 of the outputs' scale.  A jax.grad of the whole march takes
~40 s to compile here (the XLA backward of the DP5(4) map), so the
gradients are held against the Pallas pair, which compiles in ~15 s.  Sizes
are small (48 rays, rtol 1e-5, < 60 iterations) because tier-1 is near its
time limit.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import vjp

import curvis_tpu as cv
from curvis_tpu.integrate import rk45_adjoint as jra
from curvis_tpu.metrics.kerr import KerrMetric as JKerr
from curvis_tpu.metrics.kerr import KerrNewmanMetric as JKerrNewman
from curvis_tpu.ops.ckpt_adjoint_pallas import ckpt_adjoint_backward_pallas
from curvis_tpu.physics import hamiltonian as jham
from curvis_tpu.render import kerr as jrk

from curvis_tpu_torch import convert
from curvis_tpu_torch.integrate import kerr_adjoint as tka
from curvis_tpu_torch.integrate import rk45_adjoint as tra
from curvis_tpu_torch.metrics.kerr import KerrMetric, KerrNewmanMetric
from curvis_tpu_torch.ops import ckpt_kerr_cuda as ck
from curvis_tpu_torch.ops.kerr_rk45_cuda import kerr_rk45_scalars
from curvis_tpu_torch.render import kerr as trk

F64 = torch.float64
TH0 = math.pi / 2 - 0.3
KW = dict(dt0=0.1, max_steps=100, escape_radius=20.0, rtol=1e-5,
          atol=1e-8, dt_min=1e-7)
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
    params = dict(PARAMS[kind], **over)
    jcls = JKerr if kind == "kerr" else JKerrNewman
    tcls = KerrMetric if kind == "kerr" else KerrNewmanMetric
    jm = jcls(**{k: jnp.asarray(v) for k, v in params.items()})
    tm = tcls(*(_t(v).requires_grad_() for v in params.values()),
              device="cpu", dtype=F64)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _bundle(kind="kerr", n=48, r0=15.0, seed=1):
    """tests/test_rk45_adjoint.py's bundle, its last 8 rays aimed at the
    hole -> (x0, p0) as numpy."""
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


def _consts(kind):
    """(rtol, atol, dt_min, dt_max, R, r_cap) of KW."""
    _, tm = _metrics(kind)
    R = KW["escape_radius"]
    return (KW["rtol"], KW["atol"], KW["dt_min"], R / 8.0, R,
            float(tm.capture_radius.detach()))


ITER_DT_MIN = 1e-3    # the one-iteration tests' dt floor: stalls need a
                      # trial that fails at the floor


@functools.lru_cache(maxsize=None)
def _iter_states(seed=3):
    """One iteration's inputs: the bundle's spawn states with dt spread
    over [1e-3, 8] (accepts and rejects), a quarter moved to just inside R
    with a step of ~1.05 of the gap (accepted escapes; dr / dlambda ~ 0.9
    p_r at r ~ 20) or a long one (over-rejects), a sixth near the horizon
    with a huge p_r at the dt floor (some stall)."""
    x0, p0 = _bundle("kerr-newman")
    rng = np.random.default_rng(seed)
    n = x0.shape[0]
    r = x0[:, 1].copy()
    p_r = p0[:, 1].copy()
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(8.0), n))
    q = n // 4
    gap = rng.uniform(0.01, 0.5, q)
    r[:q] = KW["escape_radius"] - gap
    p_r[:q] = np.abs(p_r[:q])
    dt[:q] = rng.uniform(0.5, 8.0, q)
    dt[: q // 2] = 1.05 * gap[: q // 2] / (0.9 * p_r[: q // 2])
    r[-n // 6:] = 2.2
    p_r[-n // 6:] = 1e3
    dt[-n // 6:] = ITER_DT_MIN
    y = (r, x0[:, 2], x0[:, 3], p_r, p0[:, 2], dt)
    return y, -p0[:, 0], p0[:, 3]


# ------------------------------------------------------- one iteration

def test_twin_iteration_matches_jax():
    """The twin map and its VJP against JAX's _rk45_iter, Kerr-Newman, the
    controller on."""
    y, E, L = _iter_states()
    _, tm = _metrics("kerr-newman")
    cs = list(_consts("kerr-newman"))
    cs[2] = ITER_DT_MIN
    theta = (1.0, 0.6, float(tm.q.detach()) ** 2, E, L)
    cot = np.random.default_rng(4).standard_normal((6, E.size))

    # eagerly: a jit of this VJP takes ~14 s to compile, eager ~3 s
    consts_j = tuple(jnp.asarray(c) for c in cs)
    th_j = tuple(jnp.asarray(v) for v in theta)
    y_j = tuple(jnp.asarray(v) for v in y)
    out_j, flags = jra._rk45_iter(consts_j, th_j, y_j)
    _, pull_j = jax.vjp(lambda t_, y_: jra._rk45_iter(consts_j, t_, y_)[0],
                        th_j, y_j)
    gj_theta, gj_y = pull_j(tuple(jnp.asarray(c) for c in cot))
    consts = tuple(_t(c) for c in cs)
    out_t, pull = vjp(lambda t_, y_: tra._rk45_iter(consts, t_, y_)[0],
                      tuple(_t(v) for v in theta), tuple(_t(v) for v in y))
    gt_theta, gt_y = pull(tuple(_t(c) for c in cot))
    for k, (a, b) in enumerate(zip(out_j, out_t)):
        assert _scale_err(a, _np(b)) <= (1e-9 if k == 5 else 1e-13)
    for a, b in zip(list(gj_y) + list(gj_theta[3:]),
                    list(gt_y) + list(gt_theta[3:])):
        assert _scale_err(a, _np(b)) <= 1e-9
    for i in range(3):
        assert abs(float(gj_theta[i]) - float(gt_theta[i])) <= 1e-9 * abs(
            float(gj_theta[i]))
    accept, esc, _, _, stall = (np.asarray(f) for f in flags)
    assert (~accept).sum() >= 4 and esc.sum() >= 2 and stall.sum() >= 4


def _iter_inputs():
    y, E, L = _iter_states()
    _, tm = _metrics("kerr-newman")
    scal = kerr_rk45_scalars(tm, KW["dt0"], KW["escape_radius"],
                             rtol=KW["rtol"], atol=KW["atol"],
                             dt_min=ITER_DT_MIN,
                             dt_max=KW["escape_radius"] / 8.0)
    yt = tuple(_t(v) for v in y)
    return ck.row_tensor(scal, yt[0]), yt, _t(E), _t(L)


def test_iter_vjp_plain_matches_autograd():
    """The kernels' hand-written VJP of one iteration against
    torch.func.vjp of kerr_rk45_iter_plain (the kernels' arithmetic), with
    rejects, escapes, over-rejects and stalls, both controller modes."""
    row, y, E, L = _iter_inputs()
    t = ck.kerr_rk45_trial_plain(row, E, L, y[:5], y[5])
    assert bool(t["over"].any()) and bool(t["esc"].any())
    assert bool((~t["accept"] & ~t["over"]).any())
    stall = ~t["accept"] & (y[5] <= row[11] * 1.01)
    assert bool(stall.any()) and bool(ck.kerr_rk45_terminal_plain(row, t).any())
    lam = tuple(_t(c) for c in np.random.default_rng(6).standard_normal(
        (6, E.numel())))
    for freeze in (False, True):
        def f(theta, yy):
            r = torch.cat([row[:2], torch.stack(theta[:3]), row[5:]])
            return ck.kerr_rk45_iter_plain(r, theta[3], theta[4], yy, freeze)
        theta = (row[2], row[3], row[4], E, L)
        _, pull = vjp(f, theta, y)
        g_theta, g_y = pull(lam)
        lam_in, g = ck.kerr_rk45_iter_vjp_plain(row, E, L, y, lam, freeze)
        tol = 1e-11 if freeze else 1e-9
        for want, got in zip(g_y, lam_in):
            assert _scale_err(_np(want), _np(got)) <= tol
        for i in (3, 4):
            assert _scale_err(_np(g_theta[i]), _np(g[i])) <= tol
        for i in range(3):
            assert abs(float(g_theta[i]) - float(g[i].sum())) <= tol * float(
                g[i].abs().sum())


# ------------------------------------------------------- the forward

@functools.lru_cache(maxsize=None)
def _forward(kind):
    jm, tm = _metrics(kind)
    x0, p0 = _bundle(kind)
    cs = _consts(kind)
    mi = tra.default_max_iters(KW["max_steps"])
    want = jra._forward_xla_rk45(tuple(jnp.asarray(c) for c in cs), jm,
                                 jnp.asarray(x0), jnp.asarray(p0),
                                 KW["dt0"], KW["max_steps"], mi)
    theta = (tm.m.detach(), tm.a.detach(), tka.q2_of(tm, tm.m).detach(),
             _t(-p0[:, 0]), _t(p0[:, 3]))
    y0 = tuple(_t(x0[:, c]) for c in (1, 2, 3)) + (_t(p0[:, 1]),
                                                    _t(p0[:, 2]))
    got = tra._forward_xla_rk45(tuple(_t(c) for c in cs), theta, y0,
                                KW["dt0"], KW["max_steps"], mi)
    return want, got, y0, theta


def test_forward_matches_jax():
    want, got, _, _ = _forward("kerr-newman")
    x, p, sign, steps, iters = (np.asarray(w) for w in want)
    y, gsign, gsteps, giters = got
    np.testing.assert_array_equal(_np(gsign), sign)
    np.testing.assert_array_equal(_np(gsteps), steps)
    np.testing.assert_array_equal(_np(giters), iters)
    assert (sign == 1).sum() >= 20 and (sign == 2).sum() >= 1
    esc = sign == 1
    wy = (x[:, 1], x[:, 2], x[:, 3], p[:, 1], p[:, 2])
    for w, g in zip(wy, y):
        assert _scale_err(w[esc], _np(g)[esc]) <= 1e-9


# ------------------------------------------------------- the backward

def _fn_grads(freeze, cx, cp):
    """Gradients of sum(cx x) + sum(cp p) of march_kerr_rk45_adjoint (its
    autograd Function, the twin route) w.r.t. (M, a, q, x0, p0)."""
    kind = "kerr-newman"
    x0, p0 = _bundle(kind)
    _, tm = _metrics(kind)
    xt, pt = _t(x0).requires_grad_(), _t(p0).requires_grad_()
    x, p, sign, _ = tra.march_kerr_rk45_adjoint(tm, xt, pt,
                                                freeze_controller=freeze,
                                                **KW)
    loss = (x * cx).sum() + (p * cp).sum()
    fields = [getattr(tm, k) for k in PARAMS[kind]]
    return torch.autograd.grad(loss, fields + [xt, pt])


def test_backward_matches_jax_pallas_interpret():
    """One cotangent pulled back by JAX's Pallas pair (interpret mode, JAX's
    own map and autodiff), the controller on, against the plain pair (1e-7)
    and the Function's gradients (1e-8), Kerr-Newman; freezing the
    controller gives another gradient."""
    _, got, y0, theta = _forward("kerr-newman")
    _, tm = _metrics("kerr-newman")
    sign, iters = got[1], got[3]
    smooth = (sign == 0) | (sign == 1)
    counts = torch.where(smooth, iters, torch.zeros_like(iters))
    assert int((~smooth).sum()) >= 4
    n = counts.numel()
    rng = np.random.default_rng(9)
    cx, cp = _t(rng.standard_normal((n, 4))), _t(rng.standard_normal((n, 4)))
    cot = torch.stack([cx[:, 1], cx[:, 2], cx[:, 3], cp[:, 1], cp[:, 2],
                       torch.zeros(n, dtype=F64)])
    cot = torch.where(smooth, cot, torch.zeros_like(cot))
    one = jnp.ones(n)
    q2 = float(tm.q.detach()) ** 2
    th_j = (1.0 * one, 0.6 * one, q2 * one, jnp.asarray(_np(theta[3])),
            jnp.asarray(_np(theta[4])))
    y0_j = tuple(jnp.asarray(_np(a)) for a in y0) + (KW["dt0"] * one,)
    lam_j, g_j = ckpt_adjoint_backward_pallas(
        jra._rk45_make_step, jnp.asarray([_consts("kerr-newman")]), y0_j,
        th_j, jnp.asarray(_np(counts), jnp.float64),
        tuple(jnp.asarray(_np(c)) for c in cot),
        max_steps=int(counts.max()), seg=ck.SEG["rk45"], interpret=True)
    lam_j = [np.asarray(v) for v in lam_j]
    sums = [float(jnp.sum(g_j[i])) for i in range(3)]
    # the plain pair
    scal = kerr_rk45_scalars(tm, KW["dt0"], KW["escape_radius"],
                             rtol=KW["rtol"], atol=KW["atol"],
                             dt_min=KW["dt_min"],
                             dt_max=KW["escape_radius"] / 8.0)
    g, lam = ck.ckpt_kerr_backward_cuda("rk45", scal, y0, theta[3],
                                        theta[4], counts.to(torch.int32),
                                        cot)
    for w, v in zip(lam_j[:5], lam[:5]):
        assert _scale_err(w, _np(v)) <= 1e-7
    for i in (3, 4):
        assert _scale_err(np.asarray(g_j[i]), _np(g[i])) <= 1e-7
    for i in range(3):
        assert abs(sums[i] - float(g[i].sum())) <= 1e-7 * abs(sums[i])
    # the Function: E = -p0[:, 0] and L = p0[:, 3] reach p0 twice (the
    # identity of p's t and phi components, and every step's sensitivity),
    # and q through q^2
    gE, gL = np.asarray(g_j[3]), np.asarray(g_j[4])
    want = [sums[0], sums[1], 2.0 * 0.4 * sums[2],
            np.stack([0 * lam_j[0], lam_j[0], lam_j[1], lam_j[2]], -1),
            np.stack([_np(cp[:, 0]) - gE, lam_j[3], lam_j[4],
                      _np(cp[:, 3]) + gL], -1)]
    tg = _fn_grads(False, cx, cp)
    for w, v in zip(want, tg):
        assert _scale_err(w, _np(v)) <= 1e-8
    frozen = _fn_grads(True, cx, cp)
    assert any(abs(float(a) - float(b)) > 1e-6 * abs(float(b))
               for a, b in zip(frozen[:3], tg[:3]))

def test_odd_max_iters_rounds_up_to_even():
    assert tra.default_max_iters(100) == 200
    assert tra.default_max_iters(100, 15) == 16
    assert tra.default_max_iters(100, 16) == 16
    _, tm = _metrics("kerr")
    x0, p0 = _bundle("kerr")
    kw = dict(KW, max_iters=15)
    with torch.no_grad():
        x, p, sign, steps = tra.march_kerr_rk45_adjoint(tm, _t(x0), _t(p0),
                                                        **kw)
        y0 = tuple(_t(x0[:, c]) for c in (1, 2, 3)) + (_t(p0[:, 1]),
                                                        _t(p0[:, 2]))
        theta = (tm.m, tm.a, tka.q2_of(tm, tm.m), _t(-p0[:, 0]),
                 _t(p0[:, 3]))
        consts = tuple(_t(c) for c in _consts("kerr"))
        *_, iters = tra._forward_xla_rk45(consts, theta, y0, KW["dt0"],
                                          KW["max_steps"], 16)
    assert int(iters.max()) == 16 and bool((sign == 0).any())


# ------------------------------------------------------- render_kerr

def test_render_kerr_rk45_matches_jax():
    """render_kerr(stepper='rk45', backend='adjoint' | 'scan') on the
    spin-recovery view (8 x 5): the image against JAX's 'adjoint' render
    (both the twin march on the CPU), and a finite, non-zero d / da."""
    h, w = 16, 32
    yy, xx = np.mgrid[0:h, 0:w]
    tex = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                    0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    jb = cv.make_spherical_image(tex, dtype=jnp.float64)
    tb = convert.spherical_image_from_arrays(
        np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
        dtype=F64)
    f = np.array([-np.sin(TH0), 1.3, -np.cos(TH0)])
    f /= np.linalg.norm(f)
    jc = cv.make_camera([0.0, 15.0, TH0, 0.0], list(f), [0.0, 0.0, 1.0],
                        35.0, 43.0, 8, 5, dtype=jnp.float64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, k)) for k in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        8, 5, device="cpu", dtype=F64)
    kw = dict(dt=0.1, max_steps=100, escape_radius=20.0, stepper="rk45",
              rtol=1e-5)
    want = np.asarray(jax.jit(lambda a: jrk.render_kerr(
        JKerr(m=jnp.asarray(1.0), a=a), jc, jb, backend="adjoint", **kw))(
            jnp.asarray(0.7)))
    _, tm = _metrics("kerr", a=0.7)
    img = trk.render_kerr(tm, tc, tb, backend="adjoint", **kw)
    np.testing.assert_allclose(_np(img), want, rtol=1e-8, atol=1e-10)
    scan = trk.render_kerr(tm, tc, tb, backend="scan", **kw)
    assert torch.equal(scan, img)
    (g,) = torch.autograd.grad(img.mean(), tm.a)
    assert math.isfinite(float(g)) and float(g) != 0.0
