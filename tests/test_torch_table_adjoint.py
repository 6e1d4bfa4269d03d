"""PyTorch port vs the JAX package: gradients through tabulated user
metrics on the CPU, in float64.

The hand-written table VJPs of the checkpoint kernels' plain versions
(the Euler step, ``ops/ckpt_adjoint_cuda.py:euler_step_vjp``, and the
DP5(4) iteration, ``ops/ckpt_rk45_cuda.py:rk45_iter_vjp_plain``) against
``torch.func.vjp`` of the same forms and ``jax.vjp`` of the JAX package's
``cheb{K}`` step closures; the plain #9 / #10 pairs against JAX's Pallas
pair in interpret mode; the DP5(4) twin map against JAX's; and
``render_direct(table, differentiable='adjoint')``'s image and gradients
with respect to the table (c1, c2, s) and, through
``tabulate_metric_diff``, to a shape's parameters, against ``jax.grad``
(Euler) or JAX central differences (DP5(4): a ``jax.grad`` of the DP5(4)
march compiles for ~40-50 s on this CPU).  Theta of a table is (s^2,
c1..., c2..., b) in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vjp

import curvis_tpu as cv
from curvis_tpu.integrate import adjoint as jadj
from curvis_tpu.integrate import rk45_adjoint_planar as jrk
from curvis_tpu.metrics import table as jtable
from curvis_tpu.ops.ckpt_adjoint_pallas import ckpt_adjoint_backward_pallas

from curvis_tpu_torch import convert
from curvis_tpu_torch.integrate import rk45_adjoint_planar as trk
from curvis_tpu_torch.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu_torch.metrics import table as ttable
from curvis_tpu_torch.ops import ckpt_adjoint_cuda as ca
from curvis_tpu_torch.ops import ckpt_rk45_cuda as cr
from curvis_tpu_torch.ops.march_cuda import march_scalars
from curvis_tpu_torch.ops.rk45_cuda import rk45_scalars
from curvis_tpu_torch.ops.table_cuda import slot_params
from curvis_tpu_torch.render.direct import render_direct

F64 = torch.float64
CONSTS = (1e-5, 1e-7, 1e-6, 10.0, 20.0, -1e30)   # rtol atol dt_min dt_max R
BASES = ["horner", "clenshaw"]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _np(t):
    return t.detach().cpu().numpy()


def _scale_err(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _jbell(l):
    rho = 1.0 + 0.35 * jnp.tanh(l / 1.4)
    return jnp.sqrt(rho * rho + l * l)


def _tables(basis, degree=16):
    """(JAX table, port table, JAX kind 'cheb{K}{h|c}', port kind, port
    scalar row) of the Bell wormhole at ``degree`` (16, or 8 where a JAX
    compile of the whole march would take long), float64."""
    jtab, _ = jtable.tabulate_metric(_jbell, degree=degree,
                                     tol=5e-4 if degree >= 16 else 1e-2,
                                     basis=basis, dtype=jnp.float64)
    ttab = convert.table_from_arrays(
        np.asarray(jtab.c1), np.asarray(jtab.c2), np.asarray(jtab.s),
        basis, device="cpu", dtype=F64)
    kind, scal = march_scalars(ttab, 0.05, 20.0)
    return jtab, ttab, f"cheb{degree}{basis[0]}", kind, scal


def _theta_j(jtab, b):
    s = float(jtab.s)
    one = jnp.ones(len(b))
    return ((s * s * one,) + tuple(c * one for c in np.asarray(jtab.c1))
            + tuple(c * one for c in np.asarray(jtab.c2)) + (jnp.asarray(b),))


def _states(seed, n=48):
    """Seeded (l, psi, p_l, dt, b): steps that reject, start near +-R
    (escape) and sit at the dt floor (stall)."""
    rng = np.random.default_rng(seed)
    l = rng.uniform(-12.0, 19.0, n)
    l[n // 3: 2 * n // 3] = rng.choice([-1.0, 1.0], n // 3) * rng.uniform(
        19.8, 19.99, n // 3)
    psi = rng.uniform(-2.0, 2.0, n)
    p_l = rng.uniform(-1.0, 1.0, n)
    b = rng.uniform(0.2, 4.0, n)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.5), n))
    dt[: n // 3] = rng.uniform(2.0, 8.0, n // 3)
    dt[-n // 6:] = 1e-6
    return l, psi, p_l, dt, b


# ------------------------------------------------------------- the VJPs

@pytest.mark.parametrize("basis", BASES)
def test_euler_step_vjp_matches_autograd_and_jax(basis):
    """euler_step_vjp of a table (reverse Horner / Clenshaw, as
    csrc/table.cuh:table_shape_vjp) against torch.func.vjp of the step in
    the kernel's forms (per-ray b and lam, ray-summed table slots) to
    1e-13 of the outputs' scale, and against jax.vjp of the JAX package's
    cheb step closure (integrate/adjoint.py:_planar_make_step), per ray,
    to 1e-12."""
    jtab, _, jkind, kind, scal = _tables(basis)
    rng = np.random.default_rng(3)
    n = 64
    l, psi, p_l = rng.uniform(-15.0, 15.0, n), *rng.uniform(-1, 1, (2, n))
    b = rng.uniform(-2.0, 2.0, n)
    lam = rng.standard_normal((3, n))
    dt, p = ca._slots(kind, scal, _t(0.0))
    lam_in, g = ca.euler_step_vjp(kind, dt, p, _t(l), _t(p_l), _t(b),
                                  tuple(map(_t, lam)))
    assert len(g) == 2 * 17 + 2

    def f(l, psi, p_l, b, *pp):
        return ca.euler_step(kind, dt, pp, l, psi, p_l, b)
    _, pull = vjp(f, _t(l), _t(psi), _t(p_l), _t(b), *p)
    want = pull(tuple(map(_t, lam)))
    for got, w in zip((*lam_in, g[-1]), want[:4]):
        assert _scale_err(_np(w), _np(got)) <= 1e-13
    for gi, w in zip(g[:-1], want[4:]):
        assert abs(float(gi.sum()) - float(w)) <= 1e-12 * max(
            float(gi.abs().sum()), 1e-300)

    step = jadj._planar_make_step(jkind)(jnp.asarray([[0.05] + [0.0] * 9]))
    _, jpull = jax.vjp(step, _theta_j(jtab, b),
                       tuple(map(jnp.asarray, (l, psi, p_l))))
    jg, jlam = jpull(tuple(map(jnp.asarray, lam)))
    for got, w in zip((*lam_in, *g), (*jlam, *jg)):
        assert _scale_err(np.asarray(w), _np(got)) <= 1e-12


@pytest.mark.parametrize("basis", BASES)
def test_rk45_iter_vjp_matches_autograd(basis):
    """rk45_iter_vjp_plain of a table (the guarded partials of the table
    form) against torch.func.vjp of rk45_iter_plain (the kernel's
    arithmetic), rejected, escaping and stalling rays included: 1e-12 of
    the outputs' scale frozen, 1e-9 with the controller on (module
    docstring of tests/test_torch_rk45_adjoint.py)."""
    _, ttab, _, _, _ = _tables(basis)
    kind, scal = rk45_scalars(ttab, 0.05, 20.0, 1e-5, 1e-7, 10.0)
    row = _t(scal)
    l, psi, p_l, dt, b = _states(seed=5)
    y = tuple(_t(a) for a in (l, psi, p_l, dt))
    lam = tuple(_t(c) for c in np.random.default_rng(6).standard_normal(
        (4, l.size)))
    theta = (*slot_params(kind, row), _t(b))
    for freeze in (False, True):
        _, pull = vjp(lambda th, yy: cr.rk45_iter_plain(kind, row, th, yy,
                                                        freeze), theta, y)
        g_theta, g_y = pull(lam)
        lam_in, g = cr.rk45_iter_vjp_plain(kind, row, y, theta[-1], lam,
                                           freeze)
        tol = 1e-12 if freeze else 1e-9
        for want, got in zip(g_y, lam_in):
            assert _scale_err(_np(want), _np(got)) <= tol
        assert _scale_err(_np(g_theta[-1]), _np(g[-1])) <= tol
        for i in range(len(g) - 1):
            assert abs(float(g_theta[i]) - float(g[i].sum())) <= tol * max(
                float(g[i].abs().sum()), 1e-300)


@pytest.mark.parametrize("basis", BASES)
def test_twin_iteration_matches_jax(basis):
    """The DP5(4) twin map of a table (integrate/rk45_adjoint_planar.py,
    the guarded table form) and its VJP against JAX's
    _planar_rk45_iter with the cheb kind, eagerly, both controller modes:
    values to 1e-13, VJPs to 1e-11 of the outputs' scale."""
    jtab, ttab, jkind, _, _ = _tables(basis)
    kind, p = trk.metric_slots(ttab, _t(0.0))
    l, psi, p_l, dt, b = _states(seed=7)
    cot = np.random.default_rng(8).standard_normal((4, l.size))
    consts_j = tuple(jnp.asarray(c) for c in CONSTS)
    consts_t = tuple(_t(c) for c in CONSTS)
    for freeze in (False, True):
        def fj(theta, y):
            return jrk._planar_rk45_iter(jkind, consts_j, theta, y,
                                         freeze)[0]

        def ft(theta, y):
            return trk._planar_rk45_iter(kind, consts_t, theta, y,
                                         freeze)[0]

        out_j, pull_j = jax.vjp(fj, _theta_j(jtab, b),
                                tuple(map(jnp.asarray, (l, psi, p_l, dt))))
        gj = pull_j(tuple(map(jnp.asarray, cot)))
        out_t, pull_t = vjp(ft, (*(q.detach() for q in p), _t(b)),
                            tuple(map(_t, (l, psi, p_l, dt))))
        gt = pull_t(tuple(map(_t, cot)))
        for a, c in zip(out_j, out_t):
            assert _scale_err(a, _np(c)) <= 1e-13
        for a, c in zip(gj[1], gt[1]):
            assert _scale_err(a, _np(c)) <= 1e-11
        assert _scale_err(gj[0][-1], _np(gt[0][-1])) <= 1e-11
        for a, c in zip(gj[0][:-1], gt[0][:-1]):
            assert abs(float(jnp.sum(a)) - float(c)) <= 1e-11 * max(
                float(jnp.sum(jnp.abs(a))), 1e-300)


# ---------------------------------------------------- the plain pairs

def test_plain_euler_pair_matches_pallas_interpret():
    """The plain #9 / #10 Euler pair on a table (ckpt_adjoint_backward_cuda
    on CPU tensors) against JAX's Pallas pair in interpret mode with the
    cheb step closure: 256 rays, steps up to 64, segment 16; lam and the
    per-ray (s^2, c1..., c2..., b) cotangents within 1e-10."""
    jtab, _, jkind, kind, scal = _tables("clenshaw")
    rng = np.random.default_rng(4)
    n, max_steps, seg = 256, 64, 16
    y0 = [rng.uniform(-12.0, 12.0, n), rng.uniform(-1, 1, n),
          rng.uniform(-1, 1, n)]
    b = rng.uniform(-1.5, 1.5, n)
    steps = rng.integers(0, max_steps + 1, n).astype(np.int32)
    steps[:4] = [0, max_steps, seg, seg + 1]
    cot = [rng.standard_normal(n) for _ in range(3)]
    jlam, jg = ckpt_adjoint_backward_pallas(
        jadj._planar_make_step(jkind), jnp.asarray([[0.05] + [0.0] * 9]),
        tuple(map(jnp.asarray, y0)), _theta_j(jtab, b),
        jnp.asarray(steps, jnp.float64), tuple(map(jnp.asarray, cot)),
        max_steps=max_steps, seg=seg, tile_rows=8, interpret=True)
    tg, tlam = ca.ckpt_adjoint_backward_cuda(
        kind, scal, tuple(map(_t, y0)), _t(b), torch.from_numpy(steps),
        tuple(map(_t, cot)), seg=seg)
    assert len(tg) == len(jg) == 2 * 17 + 2
    for got, want in zip((*tlam, *tg), (*jlam, *jg)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("freeze", [False, True])
def test_plain_rk45_pair_matches_twin_and_pallas(freeze):
    """The plain DP5(4) pair on a table against integrate/ckpt.py under
    autograd on the twin map (1e-8 of the outputs' scale) and, unfrozen,
    against JAX's Pallas pair in interpret mode with the cheb closure
    (1e-7), on the forward's live iteration counts."""
    jtab, ttab, jkind, _, _ = _tables("horner", degree=8)
    kind, scal = rk45_scalars(ttab, 0.05, 20.0, 1e-5, 1e-7, 10.0)
    rng = np.random.default_rng(9)
    n = 48
    l = rng.uniform(4.0, 6.0, n)
    p_l = -rng.uniform(0.2, 1.0, n)
    b = rng.uniform(0.2, 3.0, n)
    state = (_t(l), torch.zeros(n, dtype=F64), _t(p_l))
    consts = tuple(_t(c) for c in CONSTS)
    _, p = trk.metric_slots(ttab, _t(0.0))
    p = tuple(q.detach() for q in p)
    with torch.no_grad():
        (_, _, _, sign, _), iters = trk._forward_twin(
            kind, consts, (*p, _t(b)), state, 0.05, 200, 40)
    counts = torch.where(sign.abs() <= 1, iters, torch.zeros_like(iters))
    assert int(counts.max()) > 16 and bool((sign.abs() == 1).any())
    cot = torch.from_numpy(rng.standard_normal((4, n)))
    cot[3] = 0.0
    y0 = (*state, torch.full((n,), 0.05, dtype=F64))
    d_theta, lam = ckpt_adjoint_backward(
        lambda th, y: trk._planar_rk45_step(kind, consts, th, y, freeze),
        (*p, _t(b)), y0, counts, tuple(cot), max_steps=40, segment=16)
    g, lam_p = cr.ckpt_rk45_backward_cuda(kind, scal, freeze, state, _t(b),
                                          counts.to(torch.int32), cot)
    assert g.shape == (2 * 9 + 2, n)
    for want, got in zip(lam, lam_p):
        assert _scale_err(_np(want), _np(got)) <= 1e-8
    assert _scale_err(_np(d_theta[-1]), _np(g[-1])) <= 1e-8
    for i in range(len(g) - 1):
        assert abs(float(d_theta[i]) - float(g[i].sum())) <= 1e-8 * max(
            float(g[i].abs().sum()), 1e-300)
    if freeze:
        return
    lam_j, g_j = ckpt_adjoint_backward_pallas(
        jrk._planar_rk45_make_step(jkind, False),
        jnp.asarray([[*CONSTS[:5], CONSTS[5]]]),
        tuple(jnp.asarray(_np(a)) for a in y0), _theta_j(jtab, b),
        jnp.asarray(_np(counts), jnp.float64),
        tuple(jnp.asarray(_np(c)) for c in cot),
        max_steps=int(counts.max()), seg=cr.SEG, interpret=True)
    for want, got in zip(lam_j, lam_p):
        assert _scale_err(np.asarray(want), _np(got)) <= 1e-7
    for want, got in zip(g_j, g):
        assert _scale_err(np.asarray(want), _np(got)) <= 1e-7


# ------------------------------------------------------- render_direct

def _scene(res=(12, 8)):
    yy, xx = np.mgrid[0:16, 0:32]
    tex = np.stack([np.sin(2 * np.pi * xx / 32) * 0.5 + 0.5, yy / 16,
                    0.3 + 0.4 * np.cos(2 * np.pi * yy / 16)], -1)
    jb = cv.make_spherical_image(tex, dtype=jnp.float64)
    tb = convert.spherical_image_from_arrays(
        np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
        dtype=F64)
    jc = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.2, 0.1],
                        [0.0, 0.0, 1.0], 15.0, 43.0, res[0], res[1],
                        dtype=jnp.float64)
    tcam = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        res[0], res[1], device="cpu", dtype=F64)
    return jb, tb, jc, tcam


def test_render_direct_table_gradient_matches_jax():
    """render_direct(table, differentiable='adjoint') (Euler): the image
    to 1e-10 and d loss / d(c1, c2, s) to 1e-8 of their scale against
    jax.grad of the JAX call (tests/test_table.py:136-165); the
    coefficients' gradient is not zero."""
    jtab, _, _, _, _ = _tables("horner", degree=8)
    jb, tb, jc, tcam = _scene()
    kw = dict(method="planar", filtering="bilinear",
              differentiable="adjoint", dt=0.05, max_steps=600,
              escape_radius=15.0)

    def jloss(t):
        img = cv.render_direct(t, jc, jb, jb, **kw)
        return jnp.mean(img ** 2), img

    (jv, want), jg = jax.value_and_grad(jloss, has_aux=True)(jtab)
    c1, c2, s = (_t(np.asarray(getattr(jtab, k))).requires_grad_()
                 for k in ("c1", "c2", "s"))
    tab = ttable.TabulatedMetric(c1, c2, s, "horner", device="cpu")
    img = render_direct(tab, tcam, tb, tb, **kw)
    np.testing.assert_allclose(_np(img), np.asarray(want), rtol=0,
                               atol=1e-10)
    v = torch.mean(img ** 2)
    assert float(v.detach()) == pytest.approx(float(jv), rel=1e-12)
    g = torch.autograd.grad(v, [c1, c2, s])
    for got, name in zip(g, ("c1", "c2", "s")):
        assert _scale_err(np.asarray(getattr(jg, name)), _np(got)) <= 1e-8
    assert float(g[0].abs().max()) > 0


def test_rk45_adjoint_table_gradient_vs_jax_central_difference():
    """march_planar_rk45_adjoint on a table (the CPU twin pair, the DP5(4)
    route of render_direct) at rtol 1e-9: d / d c1[2] and d / d s of a sum
    of escape angles of a fan of rays against central differences of the
    JAX package's rk45 march (integrate/rk45.py) on the same tables, within
    1e-4 (measured 1.5e-5 and 1.3e-6); with freeze_controller, which drops
    the err -> dt chain, within 1e-2 of the full gradient (measured 3e-3
    at this rtol, 1.6e-3 at 1e-11)."""
    from curvis_tpu.integrate.rk45 import march_planar_rk45 as jrk45
    from curvis_tpu.physics import planar as jpl
    jtab, _, _, _, _ = _tables("clenshaw")
    n = 24
    alpha = np.linspace(0.25, 1.3, n)
    l0, p0, b0 = np.full(n, 5.0), -np.cos(alpha), np.sin(alpha)
    w = np.linspace(0.5, 1.5, n)
    kw = dict(escape_radius=15.0, rtol=1e-9, atol=1e-12, max_steps=4000)

    @jax.jit
    def jloss(t):
        b = t.r(jnp.asarray(l0)) * b0
        rays = jpl.PlanarRays(jnp.asarray(l0), jnp.zeros(n),
                              jnp.asarray(p0), b, jnp.zeros((n, 3)),
                              jnp.zeros((n, 3)))
        res = jrk45(t, rays, **kw)
        beta = res.psi + jnp.arctan2(b / t.r(res.l), res.p_l)
        return jnp.sum(jnp.where(jnp.abs(res.sign) == 1, w * beta, 0.0))

    cds = []
    for bump in (lambda t, h: dataclasses.replace(t, c1=t.c1.at[2].add(h)),
                 lambda t, h: dataclasses.replace(t, s=t.s + h)):
        h = 1e-4
        cds.append((float(jloss(bump(jtab, h)))
                    - float(jloss(bump(jtab, -h)))) / (2 * h))
    full = None
    for freeze in (False, True):
        c1, c2, s = (_t(np.asarray(getattr(jtab, k))).requires_grad_()
                     for k in ("c1", "c2", "s"))
        tab = ttable.TabulatedMetric(c1, c2, s, "clenshaw", device="cpu")
        b = tab.r(_t(l0)) * _t(b0)
        l, psi, p_l, sign, _ = trk.march_planar_rk45_adjoint(
            tab, (_t(l0), torch.zeros(n, dtype=F64), _t(p0)), b, dt0=0.05,
            freeze_controller=freeze, **kw)
        beta = psi + torch.atan2(b / tab.r(l), p_l)
        loss = torch.sum(torch.where(sign.abs() == 1, _t(w) * beta,
                                     torch.zeros_like(beta)))
        g1, gs = torch.autograd.grad(loss, [c1, s])
        assert int((sign.abs() == 1).sum()) == n
        if full is None:
            full = (float(g1[2]), float(gs))
            for got, cd in zip(full, cds):
                assert abs(got - cd) <= 1e-4 * abs(cd)
        else:
            for got, want in zip((float(g1[2]), float(gs)), full):
                assert abs(got - want) <= 1e-2 * abs(want)


def test_shape_gradient_through_tabulate_metric_diff_matches_jax():
    """The shape trainer's chain (examples/shape_recovery.py): d loss /
    d theta through tabulate_metric_diff, the table and
    render_direct(differentiable='adjoint') against jax.grad of the JAX
    chain, to 1e-8 of its scale; every parameter receives a gradient."""
    jb, tb, jc, tcam = _scene((12, 8))
    kw = dict(method="planar", filtering="bilinear",
              differentiable="adjoint", dt=0.05, max_steps=600,
              escape_radius=15.0)
    th = np.array([0.05, 0.2, -0.1])

    def jloss(t):
        def r(l):
            u = jnp.tanh(l / 1.5)
            rho = jnp.exp(t[0] + t[1] * u + t[2] * u * u)
            return jnp.sqrt(rho * rho + l * l)
        tab = jtable.tabulate_metric_diff(r, degree=8)
        return jnp.mean(cv.render_direct(tab, jc, jb, jb, **kw) ** 2)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(th)))
    theta = _t(th).requires_grad_()

    def r_fn(l):
        u = torch.tanh(l / 1.5)
        rho = torch.exp(theta[0] + theta[1] * u + theta[2] * u * u)
        return torch.sqrt(rho * rho + l * l)
    tab = ttable.tabulate_metric_diff(r_fn, degree=8, device="cpu",
                                      dtype=F64)
    (g,) = torch.autograd.grad(torch.mean(render_direct(
        tab, tcam, tb, tb, **kw) ** 2), theta)
    assert _scale_err(jg, _np(g)) <= 1e-8
    assert bool((g.abs() > 0).all())
