"""PyTorch port vs the JAX package: the adaptive DP5(4) Kerr / Kerr-Newman
surface gradients (``integrate/kerr_surface_adjoint.py``:
``march_kerr_rk45_disk_adjoint``, ``march_kerr_rk45_vol_adjoint``,
``render_kerr(stepper='rk45', disk=..., backend='adjoint' | 'scan',
disk_theta=...)``) and the plain versions of the checkpoint kernels' Kerr
DP5(4) surface families (``ops/ckpt_kerr_surface_cuda.py``), on the CPU
in float64.

Held against their JAX counterparts on the same numpy inputs:

- the iteration: the twin's ``_rk45_surface_iter`` and the kernels'
  ``kerr_rk45_surface_iter_plain`` against JAX ``_rk45_surface_iter``
  (the thin disk, the gas blackbody with beaming, the gas tint with
  beaming and the scatter block; freeze on and off) to 1e-12, with
  accepted and rejected
  trials, crossings, gas and both clamps near the disk binding on the
  seeded states;
- the kernels' hand-written VJPs of the iteration against
  ``torch.func.vjp`` of the plain iteration and ``jax.vjp`` of JAX's to
  1e-11;
- the plain checkpoint pair against JAX ``ckpt_adjoint_backward_pallas(
  _rk45_surface_make_step(key), interpret=True)`` to 1e-9, one case per
  family (the gas frozen);
- the twin forward against JAX ``_forward_xla_rk45_surface``: equal
  signs, steps and iterations, hits, tau and emission to 1e-10;
- d / d(M, a, q, x0, p0, surface row) of the port's DP5(4) surface
  march (its autograd Function on the CPU route) against that Pallas
  pair's on the same cotangent, Kerr-Newman, to 1e-8 relative;
- ``render_kerr(stepper='rk45', disk=..., backend='adjoint' | 'scan',
  disk_theta=...)``: the image against JAX ``render_kerr`` to 1e-8 and d /
  d(a, brightness | kappa) against JAX's central differences to 1e-6; and
  the JAX package's route that ignores ``disk_theta`` (``stepper='rk45'``,
  ``backend='auto'``, a volumetric disk).

jax.grad of the JAX DP5(4) surface march or render compiles for ~50 s on
this CPU, so the gradients are held against JAX's Pallas pair (~20 s, once
per family) and its central differences (the jitted forward compiles in
~3 s).

Sizes are small (48 rays, dt0 0.5, max_steps <= 40, 8 x 5 cameras)
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
from curvis_tpu_torch.ops.kerr_rk45_cuda import (kerr_rk45_scalars,
                                                 march_kerr_rk45_plain)
from curvis_tpu_torch.render import kerr as trk
from curvis_tpu_torch.render.disk import DiskParams

F64 = torch.float64
TH0 = math.pi / 2 - 0.3
R = 22.0
KW = dict(dt0=0.5, max_steps=40, escape_radius=R, rtol=1e-4, atol=1e-7,
          dt_min=1e-5)
MAX_ITERS = 80
BAND = (2.6, 10.0)
PARAMS = {"kerr": dict(m=1.0, a=0.8), "kerr-newman": dict(m=1.0, a=0.6,
                                                          q=0.4)}
GAS = dict(r_inner=2.6, r_outer=10.0, volumetric=True, h_rel=0.15,
           kappa=0.8, tau_max=6.0)
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


def _family(name):
    """(flags, JAX disk, port disk, the surf row as numpy) of a family
    name ('disk' or a FLAGS key)."""
    if name == "disk":
        return None, None, None, np.array(BAND)
    over, sc = FLAGS[name]
    jd, td = JDisk(**dict(GAS, **over)), DiskParams(**dict(GAS, **over))
    row = np.asarray(jks.build_vol_row(jd, None, jnp.float64))
    if sc:
        row = np.concatenate([row, np.random.default_rng(9).uniform(
            0.0, 0.5, 27)])
    return ((td.color_mode == "blackbody", bool(td.redshift or td.doppler),
             sc), jd, td, row)


def _key(flags, freeze):
    if flags is None:
        return (True, False, False, False, freeze)
    return (False, True, flags[0], flags[1], freeze)


def _theta_j(jm, E, L, surf):
    q2 = float(getattr(jm, "q", 0.0)) ** 2
    return (jnp.asarray(float(jm.m)), jnp.asarray(float(jm.a)),
            jnp.asarray(q2), jnp.asarray(E), jnp.asarray(L)) \
        + tuple(jnp.asarray(v) for v in surf)


def _consts(jm):
    return (KW["rtol"], KW["atol"], KW["dt_min"], R / 8.0, R,
            float(jm.capture_radius), KW["dt0"])


def _scal(name, tm, td, row):
    kw = dict(rtol=KW["rtol"], atol=KW["atol"], dt_min=KW["dt_min"],
              dt_max=R / 8.0)
    if name == "disk":
        return kerr_rk45_scalars(tm, KW["dt0"], R, disk=BAND, **kw)
    return kerr_rk45_scalars(tm, KW["dt0"], R, vol_disk=td,
                             vol_row=_t(row[:10]),
                             scatter_block=_t(row[10:]) if row.size > 10
                             else None, **kw)


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
def _states(seed=4, n=64):
    """Seeded mid-march states near the equator and in the gas (r in the
    band, theta within 0.25 of pi / 2, p_theta towards the equator), a
    per-ray dt from 0.05 to 8 (some trials rejected), (E, L), ct_prev =
    cos theta, the first hit slot filled on a quarter of them, tau and
    emission sums."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(3.5, 9.5, n)
    th = math.pi / 2 + rng.uniform(-0.25, 0.25, n)
    ph = rng.uniform(-3.0, 3.0, n)
    p_r = rng.uniform(-1.0, 1.0, n)
    p_th = -np.sign(th - math.pi / 2) * rng.uniform(2.0, 12.0, n)
    dt = np.exp(rng.uniform(np.log(0.05), np.log(8.0), n))
    E = rng.uniform(0.9, 1.1, n)
    L = rng.uniform(-4.0, 4.0, n)
    hits = np.zeros((6, n))
    hits[0, : n // 4] = rng.uniform(3.0, 9.0, n // 4)
    hits[1, : n // 4] = rng.uniform(-3.0, 3.0, n // 4)
    hits[2, : n // 4] = 1.0
    tau = rng.uniform(0.0, 1.0, n)
    em = rng.uniform(0.0, 0.2, (3, n))
    y = (r, th, ph, p_r, p_th, dt)
    return y, E, L, hits, tau, em


def _state_y(name):
    y, E, L, hits, tau, em = _states()
    if name == "disk":
        return tuple(y) + (np.cos(y[1]),) + tuple(hits), E, L
    return tuple(y) + (tau,) + tuple(em), E, L


# ------------------------------------------------------------ the iteration

@pytest.mark.parametrize("name,freeze", [("disk", False),
                                         ("blackbody_beaming", True),
                                         ("tint_beaming_scatter", False)])
def test_iter_maps_match_jax(name, freeze):
    """The twin's iteration and the kernels' plain iteration against JAX's
    on the same states, Kerr-Newman."""
    flags, _, td, row = _family(name)
    jm, tm = _metrics("kerr-newman")
    y, E, L = _state_y(name)
    th_j = _theta_j(jm, E, L, row)
    key = _key(flags, freeze)
    cj = tuple(jnp.asarray(v) for v in _consts(jm))
    want, wflags = jks._rk45_surface_iter(
        cj, th_j, tuple(jnp.asarray(v) for v in y), *key[:4], freeze=freeze)
    yt = tuple(_t(v) for v in y)
    with torch.no_grad():
        twin, tflags = tks._rk45_surface_iter(
            tuple(_t(v) for v in _consts(jm)),
            tuple(_t(np.asarray(v)) for v in th_j), yt, *key[:4], freeze)
        rowt = ck.row_tensor(_scal(name, tm, td, row), yt[0])
        plain, _, _ = cks.kerr_rk45_surface_iter_plain(
            flags, rowt, _t(E), _t(L), _t(L / E), yt, freeze)
    for w, g, p in zip(want, twin, plain):
        assert _scale_err(w, _np(g)) <= 1e-12
        assert _scale_err(w, _np(p)) <= 1e-12
    acc = np.asarray(wflags[0])
    np.testing.assert_array_equal(_np(tflags[0]), acc)
    assert 8 <= acc.sum() <= acc.size - 4          # accepts and rejects
    if name == "disk":
        assert (np.asarray(want[7]) != y[7]).sum() >= 4   # new hits


@pytest.mark.parametrize("name,freeze", [("disk", False),
                                         ("blackbody_beaming", False),
                                         ("tint_beaming_scatter", True)])
def test_iter_vjps_match_autograd_and_jax(name, freeze):
    """The kernels' hand-written VJP of the iteration against
    torch.func.vjp of the plain iteration and jax.vjp of JAX's: the
    state's cotangent and every theta entry's."""
    flags, _, td, row = _family(name)
    jm, tm = _metrics("kerr-newman")
    y, E, L = _state_y(name)
    yt = tuple(_t(v) for v in y)
    rowt = ck.row_tensor(_scal(name, tm, td, row), yt[0])
    Et, Lt = _t(E), _t(L)
    lam = tuple(_t(c) for c in np.random.default_rng(6).standard_normal(
        (len(y), E.size)))
    idx = [2, 3, 4] + ([] if flags is None else
                       [6, 7] + list(range(10, 18))
                       + list(range(20, rowt.numel())))

    def f(vals, EE, LL, yy):
        parts = list(rowt)
        for k, v in zip(idx, vals):
            parts[k] = v
        return cks.kerr_rk45_surface_iter_plain(
            flags, torch.stack(parts), EE, LL, LL / EE, yy, freeze)[0]

    _, pull = vjp(f, tuple(rowt[k] for k in idx), Et, Lt, yt)
    g_vals, g_E, g_L, g_y = pull(lam)
    _, n1, n2 = cks.kerr_rk45_surface_iter_plain(flags, rowt, Et, Lt,
                                                 Lt / Et, yt)
    if flags is None:
        lam_in, g = cks.kerr_rk45_disk_vjp_plain(rowt, Et, Lt, yt[:5], yt[5],
                                                 yt[6], n1, n2, lam, freeze)
    else:
        lam_in, g = cks.kerr_rk45_vol_vjp_plain(flags, rowt, Et, Lt, Lt / Et,
                                                yt[:5], yt[5], yt[6], lam,
                                                freeze)
    for want, got in zip(g_y, lam_in):
        assert _scale_err(_np(want), _np(got)) <= 1e-11
    assert _scale_err(_np(g_E), _np(g[3])) <= 1e-11
    assert _scale_err(_np(g_L), _np(g[4])) <= 1e-11
    rows = [0, 1, 2] + list(range(5, len(g)))
    for want, r in zip(g_vals, rows):
        assert abs(float(want) - float(g[r].sum())) <= 1e-11 * max(
            float(g[r].abs().sum()), 1e-300)
    key = _key(flags, freeze)
    th_j = _theta_j(jm, E, L, row)
    cj = tuple(jnp.asarray(v) for v in _consts(jm))
    _, pull_j = jax.vjp(lambda t_, y_: jks._rk45_surface_iter(
        cj, t_, y_, *key[:4], freeze=freeze)[0], th_j,
        tuple(jnp.asarray(v) for v in y))
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

def test_twin_forward_matches_jax():
    for name in ("disk", "blackbody_beaming"):
        _check_twin_forward(name)


def _check_twin_forward(name):
    flags, _, _, row = _family(name)
    jm, tm = _metrics("kerr-newman")
    x0, p0 = _bundle()
    E, L = -p0[:, 0], p0[:, 3]
    th_j = _theta_j(jm, E, L, row)
    key = _key(flags, False)
    zero = jnp.zeros(E.size)
    extras = ((jnp.cos(x0[:, 2]),) + (zero,) * 6 if flags is None
              else (zero,) * 4)
    cj = tuple(jnp.asarray(v) for v in _consts(jm))
    wy, wsign, wsteps, witers = jax.jit(
        lambda: jks._forward_xla_rk45_surface(
            cj, th_j, jnp.asarray(x0), jnp.asarray(p0), extras, KW["dt0"],
            KW["max_steps"], MAX_ITERS, *key[:4]))()
    theta = tuple(_t(np.asarray(v)) for v in th_j)
    y0 = tuple(_t(x0[:, c]) for c in (1, 2, 3)) + (_t(p0[:, 1]),
                                                    _t(p0[:, 2]))
    cfg = dict(family="rk45", flags=flags, dt=KW["dt0"],
               max_steps=KW["max_steps"], max_iters=MAX_ITERS, R=R,
               rtol=KW["rtol"], atol=KW["atol"], dt_min=KW["dt_min"],
               dt_max=R / 8.0, r_cap=float(jm.capture_radius),
               freeze=False)
    with torch.no_grad():
        gy, gsign, gsteps, giters = tks._twin_forward(cfg, theta, y0)
    np.testing.assert_array_equal(_np(gsign), np.asarray(wsign))
    np.testing.assert_array_equal(_np(gsteps), np.asarray(wsteps))
    np.testing.assert_array_equal(_np(giters), np.asarray(witers))
    sign = np.asarray(wsign)
    esc = sign == 1
    assert esc.sum() >= 10 and (sign == 2).sum() >= 4
    for c, (w, g) in enumerate(zip(wy, gy)):
        if c < 5:
            keep = esc | ((sign == 2) & (c < 2))
        else:
            keep = np.ones_like(esc)
        np.testing.assert_allclose(_np(g)[keep], np.asarray(w)[keep],
                                   rtol=1e-10, atol=1e-10)
    assert (np.asarray(wy[7 if flags is None else 6]) != 0).sum() >= 10


# ------------------------------------------------------- the backward

PAIR = {"disk": False, "tint_beaming_scatter": True}      # name -> freeze


@functools.lru_cache(maxsize=None)
def _pallas_pair(name):
    """JAX's Pallas pair (interpret mode, JAX's own iteration map and
    autodiff) on the bundle, Kerr-Newman: the fates and iterations of the
    kernels' forward (``march_kerr_rk45_plain``; on this bundle the twin's
    are the same), the fate policy's replay counts and a seeded
    cotangent -> (sign, counts, cot, lam, g)."""
    flags, _, td, row = _family(name)
    jm, tm = _metrics("kerr-newman")
    x0, p0 = _bundle()
    E, L = _t(-p0[:, 0]), _t(p0[:, 3])
    y0 = tuple(_t(x0[:, c]) for c in (1, 2, 3)) + (_t(p0[:, 1]),
                                                    _t(p0[:, 2]))
    scal = _scal(name, tm, td, row)
    mflags = (flags is None, flags is not None) + (flags or (False,) * 3)
    out = march_kerr_rk45_plain(mflags, scal, *y0, E, L,
                                max_steps=KW["max_steps"],
                                max_iters=MAX_ITERS)
    sign, iters = _np(out[5]), _np(out[-1])
    smooth = (sign == 0) | (sign == 1)
    replay = sign != 3
    counts = np.where(replay, iters, 0).astype(np.int32)
    ns = cks.n_state("rk45", flags)
    cot = np.random.default_rng(8).standard_normal((ns, E.numel()))
    cot[:5] *= smooth
    cot[5] = 0.0                                       # dt
    if flags is None:
        cot[6] = 0.0                                   # ct_prev
    cot[6 + (flags is None):] *= replay
    one = jnp.ones(E.numel())
    th_j = tuple(v * one for v in _theta_j(jm, _np(E), _np(L), row))
    y0_j = tuple(jnp.asarray(_np(a)) for a in cks.start_state(
        "rk45", flags, scal, y0))
    lam_j, g_j = ckpt_adjoint_backward_pallas(
        jks._rk45_surface_make_step(_key(flags, PAIR[name])),
        jnp.asarray([_consts(jm)]), y0_j, th_j,
        jnp.asarray(counts, jnp.float64), tuple(jnp.asarray(c) for c in cot),
        max_steps=int(counts.max()), seg=cks.SEG["rk45"], interpret=True)
    return (sign, counts, cot, tuple(np.asarray(v) for v in lam_j),
            tuple(np.asarray(v) for v in g_j))


@pytest.mark.parametrize("name", sorted(PAIR))
def test_plain_pair_matches_jax_pallas_interpret(name):
    """The plain pair against JAX's Pallas pair on the same replay counts
    and cotangent (one case per family; the gas frozen)."""
    flags, _, td, row = _family(name)
    sign, counts, cot, lam_j, g_j = _pallas_pair(name)
    assert (sign == 2).sum() >= 4 and (sign == 1).sum() >= 10
    _, tm = _metrics("kerr-newman")
    x0, p0 = _bundle()
    E, L = _t(-p0[:, 0]), _t(p0[:, 3])
    y0 = tuple(_t(x0[:, c]) for c in (1, 2, 3)) + (_t(p0[:, 1]),
                                                    _t(p0[:, 2]))
    g, lam = cks.ckpt_kerr_surface_backward_cuda(
        "rk45", flags, _scal(name, tm, td, row), y0, E, L,
        torch.from_numpy(counts), _t(cot), freeze=PAIR[name])
    for c, (want, got) in enumerate(zip(lam_j, lam)):
        if c != 5:                   # dt0: a knob, its cotangent dropped
            assert _scale_err(want, _np(got)) <= 1e-9
    for i in (3, 4):
        assert _scale_err(g_j[i], _np(g[i])) <= 1e-9
    for i in [0, 1, 2] + list(range(5, g.shape[0])):
        want = float(g_j[i].sum())
        assert abs(want - float(g[i].sum())) <= 1e-9 * max(
            float(g[i].abs().sum()), 1e-300)


@pytest.mark.parametrize("name", sorted(PAIR))
def test_march_gradients_match_jax(name):
    """d / d(M, a, q, x0, p0, surface row) of the port's DP5(4) surface
    march (its autograd Function on the CPU: the twin forward and the twin
    pair) against JAX's Pallas pair on the same cotangent (a loss linear
    in the outputs) and the same iterations, with E and L's identity
    terms, Kerr-Newman.  (jax.grad of the JAX march takes ~50 s to compile
    here: the Pallas pair, JAX's own map and autodiff, compiles in ~20 s
    and is computed once for both tests.)"""
    flags, _, td, row = _family(name)
    sign, counts, cot, lam_j, g_j = _pallas_pair(name)
    jm, tm = _metrics("kerr-newman")
    x0, p0 = _bundle()
    xt, pt = _t(x0).requires_grad_(), _t(p0).requires_grad_()
    surf = _t(row).requires_grad_()
    kw = dict(KW, max_iters=MAX_ITERS, freeze_controller=PAIR[name])
    cfg = (tks._rk45_cfg(kw["dt0"], kw["max_steps"], R, kw["rtol"],
                         kw["atol"], kw["dt_min"], None, MAX_ITERS,
                         PAIR[name]))
    out = tks._run(tm, xt, pt, surf, dict(cfg, flags=flags, disk=td),
                   "auto")
    x, p, osign = out[0], out[1], out[2]
    np.testing.assert_array_equal(_np(osign), sign)
    ct = _t(cot)
    loss = ((x[:, 1] * ct[0]).sum() + (x[:, 2] * ct[1]).sum()
            + (x[:, 3] * ct[2]).sum() + (p[:, 1] * ct[3]).sum()
            + (p[:, 2] * ct[4]).sum()
            + sum((e * c).sum() for e, c in zip(
                out[4:], ct[6 + (flags is None):])))
    fields = [getattr(tm, k) for k in PARAMS["kerr-newman"]]
    g_m, g_a, g_q, gx, gp, gs = torch.autograd.grad(
        loss, fields + [xt, pt, surf])
    q = float(tm.q.detach())
    want = (g_j[0].sum(), g_j[1].sum(), 2.0 * q * g_j[2].sum())
    for w, v in zip(want, (g_m, g_a, g_q)):
        assert abs(float(v) - w) <= 1e-8 * abs(w)
    assert _scale_err(lam_j[0], _np(gx[:, 1])) <= 1e-8
    assert _scale_err(lam_j[2], _np(gx[:, 3])) <= 1e-8
    th = lam_j[1] + (lam_j[6] * -np.sin(x0[:, 2]) if flags is None else 0.0)
    assert _scale_err(th, _np(gx[:, 2])) <= 1e-8
    assert _scale_err(-g_j[3], _np(gp[:, 0])) <= 1e-8
    assert _scale_err(lam_j[3], _np(gp[:, 1])) <= 1e-8
    assert _scale_err(lam_j[4], _np(gp[:, 2])) <= 1e-8
    assert _scale_err(g_j[4], _np(gp[:, 3])) <= 1e-8
    if flags is None:
        assert float(gs.abs().max()) == 0.0          # the band: a gate
    else:
        assert _scale_err(np.array([v.sum() for v in g_j[5:]]),
                          _np(gs)) <= 1e-8


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


RENDER = dict(dt=0.5, max_steps=40, escape_radius=22.0, stepper="rk45",
              rtol=1e-4)
WGT = np.linspace(0.5, 1.5, 5)[:, None, None]
THIN = dict(r_inner=2.6, r_outer=10.0, color_mode="blackbody")
SCENES = {"thin": (THIN, "brightness"), "gas": (GAS, "kappa")}


FD_H = 1e-6


@functools.lru_cache(maxsize=None)
def _jax_render(scene):
    """JAX render_kerr's image at (a, knob) = (0.7, the disk's) and the
    central differences of mean(image w) in a and in the knob (steps
    FD_H relative; jax.grad of the DP5(4) render compiles ~50 s here)."""
    disk_kw, knob = SCENES[scene]
    jb, _ = _smooth_sky()
    jc, _ = _camera()
    disk = JDisk(**disk_kw)

    @jax.jit
    def fj(a, k):
        img = jrk.render_kerr(JKerr(m=jnp.asarray(1.0), a=a), jc, jb,
                              disk=disk, backend="adjoint",
                              disk_theta={knob: k}, **RENDER)
        return jnp.mean(img * WGT), img

    a0, k0 = 0.7, float(getattr(disk, knob))
    img = np.asarray(fj(jnp.asarray(a0), jnp.asarray(k0))[1])
    fd = []
    for i, v0 in enumerate((a0, k0)):
        h = FD_H * v0
        vals = []
        for s_ in (1.0, -1.0):
            args = [a0, k0]
            args[i] = v0 + s_ * h
            vals.append(float(fj(*(jnp.asarray(v) for v in args))[0]))
        fd.append((vals[0] - vals[1]) / (2.0 * h))
    return img, tuple(fd)


@pytest.mark.parametrize("scene", ["thin", "gas"])
def test_render_kerr_rk45_surface_image_and_gradients_match_jax(scene):
    """Each port backend's image ('adjoint', 'scan': both march the twin
    pair on the CPU, as JAX's 'adjoint' does off the TPU) against JAX
    render_kerr of the same scene to 1e-8; d / d(a, knob) against JAX's
    central differences to 1e-6 relative (their truncation and
    rounding)."""
    disk_kw, knob = SCENES[scene]
    _, tb = _smooth_sky()
    _, tc = _camera()
    want, jg = _jax_render(scene)
    disk = DiskParams(**disk_kw)
    for backend in ("adjoint", "scan"):
        _, tm = _metrics("kerr", a=0.7)
        k = _t(getattr(disk, knob)).requires_grad_()
        img = trk.render_kerr(tm, tc, tb, disk=disk, backend=backend,
                              disk_theta={knob: k}, **RENDER)
        assert img.shape == (5, 8, 3)
        np.testing.assert_allclose(_np(img), want, rtol=1e-8, atol=1e-10)
        g = torch.autograd.grad(torch.mean(img * _t(WGT)), [tm.a, k])
        for w, v in zip(jg, g):
            assert abs(float(v) - w) <= 1e-6 * abs(w) and w != 0.0


def test_rk45_auto_gas_route_ignores_disk_theta():
    """As the JAX package's (curvis_tpu/render/kerr.py: the rk45 'auto'
    volumetric route marches kernel #8 on the static disk and shades
    without disk_theta), render_kerr(stepper='rk45', backend='auto') of a
    volumetric disk gives the image of the static disk whatever
    disk_theta says, and no gradient reaches its tensors."""
    _, tb = _smooth_sky()
    _, tc = _camera()
    _, tm = _metrics("kerr", a=0.7)
    disk = DiskParams(**GAS)
    k = _t(2.5).requires_grad_()
    b = _t(0.4).requires_grad_()
    img = trk.render_kerr(tm, tc, tb, disk=disk,
                          disk_theta={"kappa": k, "brightness": b}, **RENDER)
    ref = trk.render_kerr(tm, tc, tb, disk=disk, **RENDER)
    np.testing.assert_array_equal(_np(img), _np(ref))
    assert float((_np(ref).sum(-1) > 0).mean()) > 0.5
    g = torch.autograd.grad(img.sum(), [k, b], allow_unused=True)
    assert g == (None, None)
