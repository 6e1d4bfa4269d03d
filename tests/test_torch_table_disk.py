"""PyTorch port vs the JAX package: tabulated user metrics on the disk
routes, on the CPU, in float64.

The asymmetric Bell wormhole, r(l) = sqrt(rho(l)^2 + l^2) with rho(l) =
1 + 0.35 tanh(l / 1.4), tabulated by the JAX package (degree 12) and
carried across with ``convert.table_from_arrays``, so both sides evaluate
the same series.  Held against their JAX counterparts on the same rays:

- ``render/starlight.py:mirror_metric`` of a table, the parity flip of
  its series, in r(l) and in the coefficients, both bases;
- the plain versions of the table kind of kernels #5 (thin disk), #6
  (volumetric, with and without the scatter block) and #4's surface
  variants (tracker and gas) against the Pallas kernels in interpret mode;
- ``compute_disk_starlight_map(two_sheet=True)``, whose negative sheet
  marches the mirrored table (bilinear per-sample lookups, as in
  ``tests/test_torch_disk.py``);
- ``render_blackhole_disk`` with the table, thin (with the two-sheet
  starlight) and volumetric, each stepper, against the JAX package's
  ``backend='while'`` renders.

Sizes are tiny (48 rays, 24 x 12 images, a (4, 8) map of 8 samples) to keep
tier-1 within its time limit.
"""
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import curvis_tpu as cv
from curvis_tpu.metrics import table as jtable
from curvis_tpu.ops.march_pallas import (march_planar_disk_pallas,
                                         march_planar_disk_volumetric_pallas,
                                         march_planar_rk45_pallas)
from curvis_tpu.physics import planar as jpl
from curvis_tpu.render import disk as jd
from curvis_tpu.render import starlight as js

from curvis_tpu_torch import convert
from curvis_tpu_torch.ops.disk_cuda import march_planar_disk_cuda
from curvis_tpu_torch.ops.disk_vol_cuda import (
    march_planar_disk_volumetric_cuda)
from curvis_tpu_torch.ops.rk45_disk_cuda import march_planar_rk45_disk_cuda
from curvis_tpu_torch.physics import planar as tpl
from curvis_tpu_torch.render import disk as td
from curvis_tpu_torch.render import fast as tfast
from curvis_tpu_torch.render import starlight as ts

F64 = torch.float64
TH = math.pi / 2 - 0.2               # the example's camera inclination
L0 = 10.0                            # camera radius
BAND = (1.5, 7.0)                    # a band both sheets cross
KW = dict(dt=0.1, max_steps=300, escape_radius=25.0)
RK45 = dict(dt0=0.1, max_steps=60, max_iters=60, escape_radius=25.0,
            rtol=1e-5, atol=1e-8)
MAP = dict(n_r=4, n_phi=8, n_samples=8)
TOL = 1e-9                           # march outputs, f64
RK45_TOL = 1e-8                      # the DP5(4) marches' (its controller
                                     # grows last-bit differences of XLA's
                                     # and torch's exp / log, as in
                                     # tests/test_torch_rk45_disk.py)
IMG_TOL = 1e-6                       # images, f64 ...
IMG_FRAC = 0.99                      # ... on this fraction of pixels


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _jbell(l):
    rho = 1.0 + 0.35 * jnp.tanh(l / 1.4)
    return jnp.sqrt(rho * rho + l * l)


@functools.lru_cache(maxsize=None)
def _tables(basis="horner"):
    """(JAX table, the port's table with its arrays), float64."""
    jtab, _ = jtable.tabulate_metric(_jbell, degree=12, tol=5e-3,
                                     basis=basis, dtype=jnp.float64)
    ttab = convert.table_from_arrays(
        np.asarray(jtab.c1), np.asarray(jtab.c2), np.asarray(jtab.s),
        jtab.basis, device="cpu", dtype=F64)
    return jtab, ttab


def _camera_pair(res, l0=L0):
    jc = cv.make_camera([0.0, l0, TH, 0.0],
                        [-math.sin(TH), 0.0, -math.cos(TH)],
                        [0.0, 0.0, 1.0], 30.0, 43.0, res[0], res[1],
                        dtype=jnp.float64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        res[0], res[1], device="cpu", dtype=F64)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _rays():
    """(JAX rays, port rays, (c1, c2, nz) as torch and as jnp): 8 x 6
    pixel rays of the view, spawned by the port in f64."""
    _, ttab = _tables()
    _, tc = _camera_pair((8, 6))
    (l, psi, p_l, b), r_hat, e2 = tfast._spawn_frames(ttab, [tc])
    planes = (r_hat[2], e2[2], r_hat[0] * e2[1] - r_hat[1] * e2[0])
    tr = tpl.PlanarRays(l, psi, p_l, b, None, None)
    z = jnp.zeros((1, 3))
    jr = jpl.PlanarRays(*(jnp.asarray(_np(t)) for t in tr[:4]), z, z)
    return jr, tr, tuple(t.contiguous() for t in planes), tuple(
        jnp.asarray(_np(t)) for t in planes)


@functools.lru_cache(maxsize=None)
def _sky():
    rng = np.random.default_rng(0)
    jb = cv.make_spherical_image(0.3 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    tb = convert.spherical_image_from_arrays(
        np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
        dtype=F64)
    return jb, tb


def _scatter_block():
    return np.random.default_rng(7).uniform(0.0, 0.3, 27)


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _vol(mod, **over):
    return mod.DiskParams(r_inner=BAND[0], r_outer=BAND[1], volumetric=True,
                          h_rel=0.1, kappa=2.0, **over)


# --------------------------------------------------------------- mirror

@pytest.mark.parametrize("basis", ["horner", "clenshaw"])
def test_mirror_metric_matches_jax(basis):
    """mirror_metric(table): the series flipped as the JAX package flips
    them, r_m(l) = r(-l) to the table's rounding, and the flip an
    involution that keeps the series in the graph."""
    jtab, ttab = _tables(basis)
    jm, tm = js.mirror_metric(jtab), ts.mirror_metric(ttab)
    _close(jm.c1, tm.c1, 0.0)
    _close(jm.c2, tm.c2, 0.0)
    assert tm.basis == ttab.basis and float(tm.s) == float(ttab.s)
    l = torch.linspace(-20.0, 20.0, 81, dtype=F64)
    _close(_np(ttab.r(-l)), tm.r(l), 1e-12)
    _close(_np(-ttab.r_derivative(-l)), tm.r_derivative(l), 1e-12)
    _close(jm.r(jnp.asarray(_np(l))), tm.r(l), 1e-12)
    twice = ts.mirror_metric(tm)
    _close(_np(ttab.c1), twice.c1, 0.0)
    c1 = ttab.c1.clone().requires_grad_()
    flipped = ts.mirror_metric(type(ttab)(c1, ttab.c2, ttab.s, ttab.basis,
                                          device="cpu"))
    (g,) = torch.autograd.grad(flipped.c1.sum(), c1)
    _close(np.array([(-1.0) ** k for k in range(c1.shape[0])]), g, 0.0)


# ------------------------------------------------------ kernels' plain

def test_disk_plain_matches_pallas_interpret():
    """Kernel #5's plain version with the table (march_planar_disk_cuda on
    CPU tensors) against the Pallas disk kernel in interpret mode: equal
    signs and steps, state and hits within 1e-9."""
    jtab, ttab = _tables()
    jr, tr, (c1, c2, _), (jc1, jc2, _) = _rays()
    kw = dict(KW, r_inner=BAND[0], r_outer=BAND[1])
    want = march_planar_disk_pallas(jtab, jr, jc1, jc2, interpret=True,
                                    tile_rows=8, unroll=1, **kw)
    res, h1, h2 = march_planar_disk_cuda(ttab, tr, c1, c2, **kw)
    np.testing.assert_array_equal(_np(res.sign), np.asarray(want[0].sign))
    np.testing.assert_array_equal(_np(res.steps), np.asarray(want[0].steps))
    for x, y in zip((want[0].l, want[0].psi, want[0].p_l, *want[1],
                     *want[2]), (res.l, res.psi, res.p_l, *h1, *h2)):
        _close(x, y)
    assert (h1[0] != 0).sum() > 5 and (h2[0] != 0).any()


VOL_CASES = {"tint": (dict(), False),
             "blackbody_scatter": (dict(color_mode="blackbody",
                                        t_peak=7000.0), True)}


@pytest.mark.parametrize("case", sorted(VOL_CASES))
def test_vol_plain_matches_pallas_interpret(case):
    """Kernel #6's plain version with the table against the Pallas
    volumetric kernel in interpret mode (its emission radius from the
    table's 1 / r^2): equal signs and steps, tau and emission within
    1e-9."""
    over, scatter = VOL_CASES[case]
    jtab, ttab = _tables()
    jr, tr, (c1, c2, nz), (jc1, jc2, jnz) = _rays()
    block = _scatter_block() if scatter else None
    ra, taua, ema = march_planar_disk_volumetric_pallas(
        jtab, jr, jc1, jc2, jnz, disk=_vol(jd, **over),
        scatter_block=None if block is None else jnp.asarray(block),
        interpret=True, tile_rows=8, unroll=1, **KW)
    rb, taub, emb = march_planar_disk_volumetric_cuda(
        ttab, tr, c1, c2, nz, disk=_vol(td, **over),
        scatter_block=None if block is None else torch.tensor(block), **KW)
    np.testing.assert_array_equal(_np(rb.sign), np.asarray(ra.sign))
    np.testing.assert_array_equal(_np(rb.steps), np.asarray(ra.steps))
    for x, y in zip((ra.l, ra.p_l, taua, *ema), (rb.l, rb.p_l, taub, *emb)):
        _close(x, y)
    assert float(taub.max()) > 0.1


@pytest.mark.parametrize("vol", [False, True])
def test_rk45_disk_plain_matches_pallas_interpret(vol):
    """Kernel #4's surface variants with the table (the tracker, and the
    gas in blackbody with the scatter block) against
    march_planar_rk45_pallas in interpret mode: equal signs, steps and
    iterations, every float within RK45_TOL."""
    jtab, ttab = _tables()
    jr, tr, (c1, c2, nz), (jc1, jc2, jnz) = _rays()
    if vol:
        block = _scatter_block()
        over = dict(color_mode="blackbody", t_peak=7000.0)
        jkw = dict(nz=jnz, vol_disk=_vol(jd, **over),
                   scatter_block=jnp.asarray(block))
        tkw = dict(nz=nz, vol_disk=_vol(td, **over),
                   scatter_block=torch.tensor(block))
    else:
        jkw = tkw = dict(disk=BAND)
    want = march_planar_rk45_pallas(jtab, jr, c1=jc1, c2=jc2, interpret=True,
                                    tile_rows=8, return_iters=True, **jkw,
                                    **RK45)
    got = march_planar_rk45_disk_cuda(ttab, tr, c1=c1, c2=c2,
                                      return_iters=True, **tkw, **RK45)
    for a, b in ((want[0].sign, got[0].sign), (want[0].steps, got[0].steps),
                 (want[-1], got[-1])):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    flat_w = jax.tree.leaves(want[:-1])
    flat_g = [t for t in (got[0].l, got[0].psi, got[0].p_l, got[0].sign,
                          got[0].steps, *((got[1], *got[2]) if vol
                                          else (*got[1], *got[2])))]
    for x, y in zip(flat_w, flat_g):
        _close(x, y, RK45_TOL)
    assert (_np(got[1] if vol else got[1][0]) != 0).sum() > 5


# ----------------------------------------------------------- the routes

@functools.lru_cache(maxsize=None)
def _maps():
    """The two-sheet starlight maps of the table (JAX, port), bilinear
    per-sample lookups, two skies."""
    jtab, ttab = _tables()
    rng = np.random.default_rng(4)
    skies = [cv.make_spherical_image(0.3 * rng.random((16, 32, 3)),
                                     dtype=jnp.float64) for _ in range(2)]
    tsk = [convert.spherical_image_from_arrays(
        np.asarray(s.texture), np.asarray(s.rotation), device="cpu",
        dtype=F64) for s in skies]
    kw = dict(r_inner=BAND[0], r_outer=BAND[1], two_sheet=True, **MAP, **KW)
    want = jax.jit(lambda m, a, b: js.compute_disk_starlight_map(
        m, a, b, sample_filtering="bilinear", **kw))(jtab, *skies)
    got = ts.compute_disk_starlight_map(ttab, *tsk,
                                        sample_filtering="bilinear", **kw)
    return want, got


def test_two_sheet_starlight_map_matches_jax():
    """compute_disk_starlight_map(two_sheet=True) of the asymmetric table
    (the negative sheet marched with the mirrored table, the skies
    swapped) against the JAX package's, both sheets to 1e-9; the two
    sheets differ, as the wormhole is asymmetric."""
    want, got = _maps()
    _close(want.radii, got.radii)
    _close(want.values, got.values)
    _close(want.values_neg, got.values_neg)
    assert float((got.values - got.values_neg).abs().max()) > 1e-3


RENDER_CASES = {
    "thin_euler_two_sheet": ("euler", dict(
        color_mode="blackbody", t_peak=7000.0, brightness=14.0,
        starlight=True, starlight_two_sheet=True,
        starlight_grid=(MAP["n_r"], MAP["n_phi"]),
        starlight_samples=MAP["n_samples"])),
    "thin_rk45": ("rk45", dict()),
    "volumetric_euler": ("euler", dict(volumetric=True, kappa=3.0)),
    "volumetric_rk45": ("rk45", dict(volumetric=True, kappa=3.0)),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_blackhole_disk_matches_jax(case):
    """render_blackhole_disk with the table at 24 x 12 against the JAX
    package's backend='while' render, each stepper, thin and volumetric
    (the starlit thin disk reads the two-sheet maps of _maps)."""
    stepper, over = RENDER_CASES[case]
    jtab, ttab = _tables()
    jb, tb = _sky()
    jc, tc = _camera_pair((24, 12))
    kw = dict(r_inner=BAND[0], r_outer=BAND[1], **over)
    jp, tp = jd.DiskParams(**kw), td.DiskParams(**kw)
    jmap, tmap = _maps() if jp.starlight else (None, None)
    q = dict(KW, stepper=stepper)
    if stepper == "rk45":
        q.update(rtol=RK45["rtol"])
    want = jd.render_blackhole_disk(jtab, jc, jb, backend="while", disk=jp,
                                    starlight_map=jmap, **q)
    got = td.render_blackhole_disk(ttab, tc, tb, disk=tp, starlight_map=tmap,
                                   **q)
    assert got.shape == (12, 24, 3)
    d = np.abs(np.asarray(want) - _np(got)).max(-1)
    assert (d <= IMG_TOL).mean() >= IMG_FRAC, d.max()
    assert (_np(got).sum(-1) > 0.1).mean() > 0.05       # a lit disk
