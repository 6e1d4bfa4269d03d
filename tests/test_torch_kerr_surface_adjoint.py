"""PyTorch port vs the JAX package: the fixed-step RK4 Kerr / Kerr-Newman
surface gradients (``integrate/kerr_surface_adjoint.py``:
``march_kerr_disk_adjoint``, ``march_kerr_vol_adjoint``,
``render_kerr(disk=..., backend='adjoint' | 'scan', disk_theta=...)``) and
the plain versions of the checkpoint kernels' Kerr RK4 surface families
(``ops/ckpt_kerr_surface_cuda.py``), on the CPU in float64.

Held against their JAX counterparts on the same numpy inputs:

- the step maps: the twin's ``_disk_step`` / ``_vol_step`` and the
  kernels' ``kerr_rk4_surface_step_plain`` against JAX ``_disk_step`` /
  ``_vol_step`` (tint without beaming, blackbody with beaming, tint with
  beaming and the scatter block) to 1e-12, with crossings and gas on the
  seeded states;
- the kernels' hand-written VJPs against ``torch.func.vjp`` of the plain
  steps and ``jax.vjp`` of JAX's to 1e-11;
- the plain checkpoint pair against JAX ``ckpt_adjoint_backward_pallas(
  _fixed_make_step(...), interpret=True)`` to 1e-9, one case per family;
- the twin forward against JAX ``_forward_xla_fixed``: equal signs and
  steps, hits, tau and emission to 1e-10 (escaped states to 1e-10, r and
  theta of captured rays);
- d / d(M, a, q, x0, p0, band) of a loss of ``march_kerr_disk_adjoint``
  against ``jax.grad`` of JAX's (``backend='xla'``), Kerr-Newman, to 1e-8
  relative; a captured ray's hit carries a gradient, its final state
  none;
- ``render_kerr(disk=..., backend='adjoint' | 'scan', disk_theta=...)``:
  the image and d / d(a, brightness) (thin) or d / d(a, kappa, r_inner,
  h_rel) (gas: ``march_kerr_vol_adjoint``'s emission row) against JAX
  ``render_kerr`` (``backend='adjoint'``, whose CPU march is the XLA
  pair, as both port backends' on the CPU) to 1e-8.

Sizes are small (48 rays, dt 0.25, <= 160 steps, 8 x 5 cameras) because
tier-1 is near its time limit.
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
from curvis_tpu.integrate import kerr_surface_adjoint as jks
from curvis_tpu.metrics.kerr import KerrMetric as JKerr
from curvis_tpu.metrics.kerr import KerrNewmanMetric as JKerrNewman
from curvis_tpu.ops.ckpt_adjoint_pallas import ckpt_adjoint_backward_pallas
from curvis_tpu.physics import hamiltonian as jham
from curvis_tpu.render import kerr as jrk
from curvis_tpu.render.disk import DiskParams as JDisk

from curvis_tpu_torch import convert
from curvis_tpu_torch.integrate import kerr_surface_adjoint as tks
from curvis_tpu_torch.metrics.kerr import KerrMetric, KerrNewmanMetric
from curvis_tpu_torch.ops import ckpt_kerr_cuda as ck
from curvis_tpu_torch.ops import ckpt_kerr_surface_cuda as cks
from curvis_tpu_torch.ops.kerr_cuda import kerr_scalars, march_kerr_plain
from curvis_tpu_torch.render import kerr as trk
from curvis_tpu_torch.render.disk import DiskParams

F64 = torch.float64
TH0 = math.pi / 2 - 0.3
KW = dict(dt=0.25, max_steps=160, escape_radius=22.0)
FAR = 12.0
BAND = (2.6, 10.0)
PARAMS = {"kerr": dict(m=1.0, a=0.8), "kerr-newman": dict(m=1.0, a=0.6,
                                                          q=0.4)}
GAS = dict(r_inner=2.6, r_outer=10.0, volumetric=True, h_rel=0.15,
           kappa=0.8, tau_max=6.0)
# name -> (DiskParams overrides, scatter block on)
FLAGS = {"tint": (dict(redshift=False, doppler=False), False),
         "blackbody_beaming": (dict(color_mode="blackbody"), False),
         "tint_beaming_scatter": (dict(), True)}


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


def _disks(name):
    over, sc = FLAGS[name]
    kw = dict(GAS, **over)
    return JDisk(**kw), DiskParams(**kw), sc


def _block():
    return np.random.default_rng(9).uniform(0.0, 0.5, 27)


@functools.lru_cache(maxsize=None)
def _bundle(kind="kerr-newman", n=48, r0=13.0, seed=1):
    """48 rays from r0 at the example's inclination, fanned past the hole
    through the disk band, the last 8 aimed at the hole -> (x0, p0)."""
    rng = np.random.default_rng(seed)
    pos = np.stack([np.zeros(n), np.full(n, r0), np.full(n, TH0),
                    np.zeros(n)], -1)
    dirs = np.stack([-np.ones(n), 0.8 + 0.5 * rng.standard_normal(n),
                     0.5 * rng.standard_normal(n)], -1)
    dirs[-8:, 1:] = 0.1 * rng.standard_normal((8, 2))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jm, _ = _metrics(kind)
    p0 = np.asarray(jham.spawn_photon(jm, jnp.asarray(pos),
                                      jnp.asarray(dirs)))
    return pos, p0


@functools.lru_cache(maxsize=None)
def _states(seed=3, n=64):
    """Seeded mid-march states near the equator and in the gas: r in the
    band, theta within 0.25 of pi / 2 and p_theta large enough that about
    half of the rays cross in one step; (E, L); ct_prev = cos theta, the
    first hit slot filled on a quarter of them."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(3.5, 9.5, n)
    th = math.pi / 2 + rng.uniform(-0.25, 0.25, n)
    ph = rng.uniform(-3.0, 3.0, n)
    p_r = rng.uniform(-1.0, 1.0, n)
    p_th = -np.sign(th - math.pi / 2) * rng.uniform(2.0, 12.0, n)
    E = rng.uniform(0.9, 1.1, n)
    L = rng.uniform(-4.0, 4.0, n)
    hits = np.zeros((6, n))
    hits[0, : n // 4] = rng.uniform(3.0, 9.0, n // 4)
    hits[1, : n // 4] = rng.uniform(-3.0, 3.0, n // 4)
    hits[2, : n // 4] = 1.0
    tau = rng.uniform(0.0, 1.0, n)
    em = rng.uniform(0.0, 0.2, (3, n))
    return (r, th, ph, p_r, p_th), E, L, hits, tau, em


def _theta_j(jm, E, L, surf):
    q2 = float(getattr(jm, "q", 0.0)) ** 2
    return (jnp.asarray(float(jm.m)), jnp.asarray(float(jm.a)),
            jnp.asarray(q2), jnp.asarray(E), jnp.asarray(L)) \
        + tuple(jnp.asarray(v) for v in surf)


def _family(name):
    """(flags, the JAX step kind, JAX disk, port disk, the surf row as
    numpy) of a family name ('disk' or a FLAGS key)."""
    if name == "disk":
        return None, "disk", None, None, np.array(BAND)
    jd, td, sc = _disks(name)
    row = np.asarray(jks.build_vol_row(jd, None, jnp.float64))
    if sc:
        row = np.concatenate([row, _block()])
    flags = (td.color_mode == "blackbody", bool(td.redshift or td.doppler),
             sc)
    return flags, ("vol", flags[0], flags[1]), jd, td, row


def _state_y(name):
    y, E, L, hits, tau, em = _states()
    if name == "disk":
        return tuple(y) + (np.cos(y[1]),) + tuple(hits), E, L
    return tuple(y) + (tau,) + tuple(em), E, L


def _scal(name, tm, td, row):
    if name == "disk":
        return kerr_scalars(tm, 0.4, 25.0, disk=BAND, axis_u0=0.01,
                            far_r0=FAR)
    return kerr_scalars(tm, 0.4, 25.0, vol_disk=td, vol_row=_t(row[:10]),
                        scatter_block=_t(row[10:]) if row.size > 10
                        else None, axis_u0=0.01, far_r0=FAR)


# ------------------------------------------------------------ the steps

@pytest.mark.parametrize("name", ["disk"] + sorted(FLAGS))
def test_step_maps_match_jax(name):
    """The twin's step and the kernels' plain step against JAX's step map
    of the family, Kerr-Newman."""
    flags, kind, _, td, row = _family(name)
    jm, tm = _metrics("kerr-newman")
    y, E, L = _state_y(name)
    th_j = _theta_j(jm, E, L, row)
    yj = tuple(jnp.asarray(v) for v in y)
    if name == "disk":
        want = jks._disk_step(0.4, 0.01, FAR, th_j, yj)
    else:
        want = jks._vol_step(kind[1], kind[2], 0.4, 0.01, FAR, th_j, yj)
    yt = tuple(_t(v) for v in y)
    theta_t = tuple(_t(np.asarray(v)) for v in th_j)
    with torch.no_grad():
        if name == "disk":
            twin = tks._disk_step(0.4, 0.01, FAR, theta_t, yt)
        else:
            twin = tks._vol_step(kind[1], kind[2], 0.4, 0.01, FAR, theta_t,
                                 yt)
        rowt = ck.row_tensor(_scal(name, tm, td, row), yt[0])
        plain, _, _ = cks.kerr_rk4_surface_step_plain(
            flags, rowt, _t(E), _t(L), _t(L / E), yt)
    for w, g, p in zip(want, twin, plain):
        assert _scale_err(w, _np(g)) <= 1e-12
        assert _scale_err(w, _np(p)) <= 1e-12
    if name == "disk":           # crossings recorded in both slots
        h1 = np.asarray(want[6])
        assert (h1 != y[6]).sum() >= 8
        assert (np.asarray(want[9]) != 0.0).sum() >= 2
    else:                        # the gas emits on every ray
        assert (np.asarray(want[6]) > y[6]).all()


@pytest.mark.parametrize("name", ["disk", "blackbody_beaming",
                                  "tint_beaming_scatter"])
def test_step_vjps_match_autograd_and_jax(name):
    """The kernels' hand-written VJP of the step against torch.func.vjp of
    the plain step and jax.vjp of JAX's step map: the state's cotangent
    and every theta entry's."""
    flags, kind, _, td, row = _family(name)
    jm, tm = _metrics("kerr-newman")
    y, E, L = _state_y(name)
    yt = tuple(_t(v) for v in y)
    rowt = ck.row_tensor(_scal(name, tm, td, row), yt[0])
    Et, Lt = _t(E), _t(L)
    lam = tuple(_t(c) for c in np.random.default_rng(5).standard_normal(
        (len(y), E.size)))
    idx = [2, 3, 4] + ([] if flags is None else
                       [6, 7] + list(range(10, 18))
                       + list(range(20, rowt.numel())))

    def f(vals, EE, LL, yy):
        parts = list(rowt)
        for k, v in zip(idx, vals):
            parts[k] = v
        return cks.kerr_rk4_surface_step_plain(flags, torch.stack(parts), EE,
                                               LL, LL / EE, yy)[0]

    _, pull = vjp(f, tuple(rowt[k] for k in idx), Et, Lt, yt)
    g_vals, g_E, g_L, g_y = pull(lam)
    _, n1, n2 = cks.kerr_rk4_surface_step_plain(flags, rowt, Et, Lt, Lt / Et,
                                                yt)
    if flags is None:
        lam_in, g = cks.kerr_rk4_disk_vjp_plain(rowt, Et, Lt, yt[:5], yt[5],
                                                n1, n2, lam)
        assert int((n1 | n2).sum()) >= 8
    else:
        lam_in, g = cks.kerr_rk4_vol_vjp_plain(flags, rowt, Et, Lt, Lt / Et,
                                               yt[:5], yt[5], lam)
    for want, got in zip(g_y, lam_in):
        assert _scale_err(_np(want), _np(got)) <= 1e-11
    assert _scale_err(_np(g_E), _np(g[3])) <= 1e-11
    assert _scale_err(_np(g_L), _np(g[4])) <= 1e-11
    rows = [0, 1, 2] + list(range(5, len(g)))
    for want, r in zip(g_vals, rows):
        assert abs(float(want) - float(g[r].sum())) <= 1e-11 * max(
            float(g[r].abs().sum()), 1e-300)
    # jax.vjp of JAX's step map on the same inputs (theta per ray summed)
    th_j = _theta_j(jm, E, L, row if flags is not None else BAND)
    if flags is None:
        step_j = functools.partial(jks._disk_step, 0.4, 0.01, FAR)
    else:
        step_j = functools.partial(jks._vol_step, kind[1], kind[2], 0.4,
                                   0.01, FAR)
    _, pull_j = jax.vjp(step_j, th_j, tuple(jnp.asarray(v) for v in y))
    gj_th, gj_y = pull_j(tuple(jnp.asarray(_np(c)) for c in lam))
    for want, got in zip(gj_y, lam_in):
        assert _scale_err(np.asarray(want), _np(got)) <= 1e-11
    for i in (3, 4):
        assert _scale_err(np.asarray(gj_th[i]), _np(g[i])) <= 1e-11
    for i in [0, 1, 2] + list(range(5, len(g))):
        want = float(jnp.sum(gj_th[i]))
        assert abs(want - float(g[i].sum())) <= 1e-11 * max(
            float(g[i].abs().sum()), 1e-300)


# ------------------------------------------------------- the forward

def _twin_forward(name, kind="kerr-newman"):
    flags, jkind, jd, td, row = _family(name)
    jm, tm = _metrics(kind)
    x0, p0 = _bundle(kind)
    E, L = -p0[:, 0], p0[:, 3]
    th_j = _theta_j(jm, E, L, row)
    cap = float(jm.capture_radius)
    zero = np.zeros_like(E)
    if name == "disk":
        extras = (jnp.cos(x0[:, 2]),) + (jnp.asarray(zero),) * 6
        step_j = functools.partial(jks._disk_step, KW["dt"], 0.01, FAR, th_j)
        opq = None
    else:
        extras = (jnp.asarray(zero),) * 4
        step_j = functools.partial(jks._vol_step, jkind[1], jkind[2],
                                   KW["dt"], 0.01, FAR, th_j)
        tmax = float(row[5])
        opq = lambda yy: yy[5] > tmax                       # noqa: E731
    want = jax.jit(lambda: jks._forward_xla_fixed(
        step_j, jnp.asarray(x0), jnp.asarray(p0), extras,
        KW["escape_radius"], cap, KW["max_steps"], opaque_of=opq))()
    theta = tuple(_t(np.asarray(v)) for v in th_j)
    y0 = tuple(_t(x0[:, c]) for c in (1, 2, 3)) + (_t(p0[:, 1]),
                                                    _t(p0[:, 2]))
    cfg = dict(family="rk4", flags=flags, dt=KW["dt"], axis_u0=0.01,
               far_r0=FAR, R=KW["escape_radius"], r_cap=cap,
               max_steps=KW["max_steps"])
    with torch.no_grad():
        got = tks._twin_forward(cfg, theta, y0)
    return want, got


def test_twin_forward_matches_jax():
    for name in ("disk", "blackbody_beaming"):
        _check_twin_forward(name)


def _check_twin_forward(name):
    (wy, wsign, wsteps), (gy, gsign, gsteps, _) = _twin_forward(name)
    np.testing.assert_array_equal(_np(gsign), np.asarray(wsign))
    np.testing.assert_array_equal(_np(gsteps), np.asarray(wsteps))
    sign = np.asarray(wsign)
    esc = sign == 1
    assert esc.sum() >= 20 and (sign == 2).sum() >= 4
    for c, (w, g) in enumerate(zip(wy, gy)):
        if c < 5:
            keep = esc | ((sign == 2) & (c < 2))
        else:
            keep = np.ones_like(esc)
        np.testing.assert_allclose(_np(g)[keep], np.asarray(w)[keep],
                                   rtol=1e-10, atol=1e-10)
    extra = np.asarray(wy[6 if name == "disk" else 5])
    assert (extra != 0).sum() >= 10           # hits / gas on many rays


# ------------------------------------------------------- the plain pair

@pytest.mark.parametrize("name", ["disk", "tint_beaming_scatter"])
def test_plain_pair_matches_jax_pallas_interpret(name):
    """The plain pair against JAX's Pallas pair (interpret mode, JAX's
    own step map and autodiff) on the fates and steps of the kernels'
    forward (``march_kerr_plain``: the guarded twin can give a ray that
    grazes the horizon another fate), the fate policy's replay counts and
    a seeded cotangent, Kerr-Newman."""
    flags, jkind, _, td, row = _family(name)
    jm, tm = _metrics("kerr-newman")
    x0, p0 = _bundle()
    E, L = _t(-p0[:, 0]), _t(p0[:, 3])
    y0 = tuple(_t(x0[:, c]) for c in (1, 2, 3)) + (_t(p0[:, 1]),
                                                    _t(p0[:, 2]))
    scal = (kerr_scalars(tm, KW["dt"], KW["escape_radius"], disk=BAND,
                         axis_u0=0.01, far_r0=FAR) if name == "disk" else
            kerr_scalars(tm, KW["dt"], KW["escape_radius"], vol_disk=td,
                         vol_row=_t(row[:10]), scatter_block=_t(row[10:]),
                         axis_u0=0.01, far_r0=FAR))
    mflags = (name == "disk", name != "disk") + (flags or (False,) * 3)
    out = march_kerr_plain(mflags, scal, *y0, E, L,
                           max_steps=KW["max_steps"])
    sign, steps = _np(out[5]), _np(out[6])
    assert (sign == 2).sum() >= 4 and (sign == 1).sum() >= 20
    smooth = (sign == 0) | (sign == 1)
    replay = sign != 3
    counts = torch.from_numpy(np.where(replay, steps, 0).astype(np.int32))
    ns = cks.n_state("rk4", flags)
    cot = np.random.default_rng(7).standard_normal((ns, E.numel()))
    cot[:5] *= smooth
    cot[5] = 0.0 if name == "disk" else cot[5] * replay
    cot[5 + (name == "disk"):] *= replay
    g, lam = cks.ckpt_kerr_surface_backward_cuda("rk4", flags, scal, y0, E, L,
                                                 counts, _t(cot))
    one = jnp.ones(E.numel())
    th_j = tuple(v * one for v in _theta_j(jm, _np(E), _np(L), row))
    params = jnp.asarray([[KW["dt"], 0.01, FAR, 0.0]])
    y0_j = tuple(jnp.asarray(_np(a)) for a in cks.start_state(
        "rk4", flags, scal, y0))
    lam_j, g_j = ckpt_adjoint_backward_pallas(
        jks._fixed_make_step(jkind), params, y0_j, th_j,
        jnp.asarray(_np(counts), jnp.float64),
        tuple(jnp.asarray(c) for c in cot), max_steps=int(counts.max()),
        seg=cks.SEG["rk4"], interpret=True)
    for want, got in zip(lam_j, lam):
        assert _scale_err(np.asarray(want), _np(got)) <= 1e-9
    for i in (3, 4):
        assert _scale_err(np.asarray(g_j[i]), _np(g[i])) <= 1e-9
    for i in [0, 1, 2] + list(range(5, g.shape[0])):
        want = float(jnp.sum(g_j[i]))
        assert abs(want - float(g[i].sum())) <= 1e-9 * max(
            float(g[i].abs().sum()), 1e-300)
    if name == "disk":             # the band is a gate
        assert float(jnp.abs(g_j[5]).max()) == 0.0


# ------------------------------------------------------- the gradients

def _loss(out, xp):
    x, p, sign = out[:3]
    esc = xp.where(sign == 1, xp.sin(x[:, 3]) * p[:, 1] + xp.cos(x[:, 2]),
                   0.0)
    (h1, h2) = out[4]
    extra = h1[0] + 0.2 * xp.sin(h1[1]) + 0.5 * h2[0]
    return xp.mean(esc) + xp.mean(extra)


def test_march_gradients_match_jax():
    """d loss / d(metric, x0, p0, band) of the port's thin-disk adjoint
    march (its CPU route) against jax.grad of JAX's (backend='xla'),
    Kerr-Newman: the band's gradients zero in both; a captured ray's hit
    carries a gradient (as tests/test_surface_adjoint.py:120), its final
    state none.  The gas's march gradients, with a disk_theta row, are
    held through the render test below (one JAX compile of the gas, not
    two: tier-1's time)."""
    x0, p0 = _bundle("kerr-newman")
    names = list(PARAMS["kerr-newman"])

    def fj(params, xx, pp, band):
        metric = JKerrNewman(**dict(zip(names, params)))
        out = jks.march_kerr_disk_adjoint(
            metric, xx, pp, r_inner=band[0], r_outer=band[1], far_r0=FAR,
            backend="xla", **KW)
        return _loss(out, jnp)

    vals = tuple(jnp.asarray(PARAMS["kerr-newman"][k]) for k in names)
    bj = tuple(jnp.asarray(v) for v in BAND)
    jv, jg = jax.jit(jax.value_and_grad(fj, argnums=(0, 1, 2, 3)))(
        vals, jnp.asarray(x0), jnp.asarray(p0), bj)
    _, tm = _metrics("kerr-newman")
    xt, pt = _t(x0).requires_grad_(), _t(p0).requires_grad_()
    bt = [_t(v).requires_grad_() for v in BAND]
    out = tks.march_kerr_disk_adjoint(tm, xt, pt, r_inner=bt[0],
                                      r_outer=bt[1], far_r0=FAR, **KW)
    tv = _loss(out, torch)
    fields = [getattr(tm, k) for k in names]
    tg = torch.autograd.grad(tv, fields + [xt, pt] + bt, retain_graph=True)
    assert abs(float(tv.detach()) - float(jv)) <= 1e-10 * abs(float(jv))
    want = list(jg[0]) + [jg[1], jg[2]] + list(jg[3])
    for w, g in zip(want, tg):
        w = np.asarray(w)
        if np.max(np.abs(w)) == 0.0:
            assert float(g.abs().max()) == 0.0
        else:
            assert _scale_err(w, _np(g)) <= 1e-8
    assert all(float(g.abs().max()) > 0 for g in tg[:len(names)])
    # a ray captured after crossing the band keeps its hit's gradient (the
    # disk in front of the shadow), while its final state has none
    # (the loss reads the hits of every ray, and a captured ray's final
    # state not at all)
    x, sign, h1 = out[0], out[2], out[4][0]
    cap = (sign == 2) & (h1[0] != 0)
    assert int(cap.sum()) >= 1
    assert float(tg[len(names)][cap].abs().sum()) > 0
    (gs,) = torch.autograd.grad(x[:, 1].sum(), xt)
    assert float(gs[cap].abs().max()) == 0.0


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


def _camera(res=(8, 5)):
    """A view of the hole and the disk from r = 15 at the inclination."""
    f = np.array([-np.sin(TH0), 0.15, -np.cos(TH0)])
    f /= np.linalg.norm(f)
    jc = cv.make_camera([0.0, 15.0, TH0, 0.0], list(f), [0.0, 0.0, 1.0],
                        30.0, 43.0, *res, dtype=jnp.float64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, k)) for k in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        *res, device="cpu", dtype=F64)
    return jc, tc


RENDER = dict(dt=0.25, max_steps=160, escape_radius=22.0)
WGT = np.linspace(0.5, 1.5, 5)[:, None, None]
THIN = dict(r_inner=2.6, r_outer=10.0, color_mode="blackbody")
# name -> (disk keywords, the disk_theta knobs)
SCENES = {"thin": (THIN, ("brightness",)),
          "gas": (GAS, ("kappa", "r_inner", "h_rel"))}


@functools.lru_cache(maxsize=None)
def _jax_render(scene):
    """JAX render_kerr's image and d mean(img w) / d(a, the knobs)."""
    disk_kw, knobs = SCENES[scene]
    jb, _ = _smooth_sky()
    jc, _ = _camera()
    disk = JDisk(**disk_kw)

    def fj(a, ks):
        img = jrk.render_kerr(JKerr(m=jnp.asarray(1.0), a=a), jc, jb,
                              disk=disk, backend="adjoint",
                              disk_theta=dict(zip(knobs, ks)), **RENDER)
        return jnp.mean(img * WGT), img

    k0 = tuple(jnp.asarray(getattr(disk, k)) for k in knobs)
    (_, img), (ga, gk) = jax.jit(jax.value_and_grad(
        fj, argnums=(0, 1), has_aux=True))(jnp.asarray(0.7), k0)
    return np.asarray(img), tuple(float(v) for v in (ga, *gk))


@pytest.mark.parametrize("scene", ["thin", "gas"])
def test_render_kerr_surface_image_and_gradients_match_jax(scene):
    """Each port backend ('adjoint', 'scan') against JAX's: the image,
    and d / d(a, the disk_theta knobs; the gas's reach the march through
    its emission row)."""
    disk_kw, knobs = SCENES[scene]
    _, tb = _smooth_sky()
    _, tc = _camera()
    want, jg = _jax_render(scene)
    disk = DiskParams(**disk_kw)
    for backend in ("adjoint", "scan"):
        _, tm = _metrics("kerr", a=0.7)
        ks = [_t(getattr(disk, k)).requires_grad_() for k in knobs]
        img = trk.render_kerr(tm, tc, tb, disk=disk, backend=backend,
                              disk_theta=dict(zip(knobs, ks)), **RENDER)
        assert img.shape == (5, 8, 3)
        np.testing.assert_allclose(_np(img), want, rtol=1e-8, atol=1e-10)
        g = torch.autograd.grad(torch.mean(img * _t(WGT)), [tm.a, *ks])
        for w, v in zip(jg, g):
            assert abs(float(v) - w) <= 1e-8 * abs(w) and w != 0.0
