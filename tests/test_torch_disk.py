"""PyTorch port vs the JAX package: the black-hole accretion-disk path, on
the CPU.

Held against their JAX counterparts on the same numpy inputs, in float64:

- the shading functions of ``render/disk.py`` (to 1e-12);
- the XLA twins ``march_planar_disk`` and ``march_planar_disk_volumetric``
  (the render routes' CPU marches) against the JAX package's, on
  Schwarzschild, Reissner-Nordstrom and an Ellis wormhole with far-sheet
  hits: equal signs and steps, hits, tau and emission within 1e-9;
- the plain versions of the CUDA kernels, ``ops/disk_cuda.py:
  march_planar_disk_plain`` and ``ops/disk_vol_cuda.py:
  march_planar_disk_volumetric_plain`` (reached through their wrappers on
  CPU tensors), against the Pallas kernels ``_disk_kernel`` and
  ``_disk_vol_kernel`` in interpret mode, whose arithmetic they transcribe
  (crossing on zq without r, rsqrt radius, log-space Planck): equal signs
  and steps, outputs within 1e-9, NaN rays and an exact step cap included;
- ``render_blackhole_disk`` and ``render_disk_frames_batched`` against the
  JAX package's ``backend='while'`` renders (1e-6 on >= 99.9 % of pixels),
  the starlight map, lookup and scatter block, ``convert.starlight_map``
  and the CLI's ``image --disk``.

The starlight maps are compared with bilinear per-sample lookups: with
the default nearest lookups, jitting the JAX map moves a few per-sample
directions across texel seams (0.039 on one texel of an (8, 16) map of
16 samples, JAX jit against JAX eager), and the port's map matches the
eager one to 1e-12.  Inputs are made
with numpy from a seed; the sizes are tiny (24 x 12 rays, 32 x 18 images,
an (8, 16) map of 16 samples) because tier-1 is near its time limit.
"""
import dataclasses
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import curvis_tpu as cv
from curvis_tpu.cli import main as jax_cli
from curvis_tpu.ops.march_pallas import (march_planar_disk_pallas,
                                         march_planar_disk_volumetric_pallas)
from curvis_tpu.physics import planar as jpl
from curvis_tpu.render import disk as jd
from curvis_tpu.render import starlight as js

from curvis_tpu_torch import convert
from curvis_tpu_torch.cli import main as port_cli
from curvis_tpu_torch.metrics.base import Metric
from curvis_tpu_torch.ops.disk_cuda import march_planar_disk_cuda
from curvis_tpu_torch.ops.disk_vol_cuda import (
    march_planar_disk_volumetric_cuda)
from curvis_tpu_torch.physics import planar as tpl
from curvis_tpu_torch.render import disk as td
from curvis_tpu_torch.render import fast as tfast
from curvis_tpu_torch.render import starlight as ts

F64 = torch.float64
TH = math.pi / 2 - 0.2               # the example's camera inclination
KW = dict(dt=0.125, max_steps=2000, escape_radius=32.0)
METRICS = {"schwarzschild": (dict(m=1.0), 28.0),
           "rn": (dict(m=1.0, q=0.6), 28.0),
           "ellis": (dict(rho=1.0), 10.0)}
BAND = {"schwarzschild": (5.2, 14.0), "rn": (5.2, 14.0),
        "ellis": (1.5, 14.0)}
MAP = dict(n_r=8, n_phi=16, n_samples=16)
MAP_DISK = dict(starlight_grid=(8, 16), starlight_samples=16)
TOL = 1e-9                           # march outputs, f64
SHADE_TOL = 1e-12                    # shading functions, f64
IMG_TOL = 1e-6                       # images, f64 ...
IMG_FRAC = 0.999                     # ... on this fraction of pixels


def _np(t):
    return t.detach().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _metric_pair(kind):
    params, _ = METRICS[kind]
    jm = cv.make_metric(kind, **params)
    tm = convert.metric_from_arrays(
        kind, device="cpu", dtype=F64,
        **{k: np.asarray(getattr(jm, k), np.float64) for k in params})
    return jm, tm


def _camera_pair(l0, res, phi=0.0):
    jc = cv.make_camera([0.0, l0, TH, phi],
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
def _rays(kind):
    """(JAX rays, port rays, (c1, c2, nz) as torch and as jnp): the 24 x 12
    pixel rays of the example's view, spawned by the port in f64."""
    _, tm = _metric_pair(kind)
    _, tc = _camera_pair(METRICS[kind][1], (24, 12))
    (l, psi, p_l, b), r_hat, e2 = tfast._spawn_frames(tm, [tc])
    planes = (r_hat[2], e2[2], r_hat[0] * e2[1] - r_hat[1] * e2[0])
    tr = tpl.PlanarRays(l, psi, p_l, b, None, None)
    z = jnp.zeros((1, 3))
    jr = jpl.PlanarRays(*(jnp.asarray(_np(t)) for t in tr[:4]), z, z)
    return jr, tr, tuple(t.contiguous() for t in planes), tuple(
        jnp.asarray(_np(t)) for t in planes)


def _poisoned(kind, n_nan):
    """The rays of ``kind`` with ``n_nan`` evenly spread l set to NaN."""
    jr, tr, planes, jplanes = _rays(kind)
    l = tr.l.clone()
    l[np.linspace(0, l.numel() - 1, n_nan).astype(int)] = math.nan
    tr = tr._replace(l=l)
    return jr._replace(l=jnp.asarray(_np(l))), tr, planes, jplanes


@functools.lru_cache(maxsize=None)
def _sky():
    rng = np.random.default_rng(0)
    jb = cv.make_spherical_image(0.3 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    tb = convert.spherical_image_from_arrays(
        np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
        dtype=F64)
    return jb, tb


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ----------------------------------------------------------- (a) shading

def _hits(rng, n=40):
    r = rng.uniform(4.0, 15.0, n)
    r[::7] = 0.0                                   # no hit
    return (r, rng.uniform(-0.8, 0.8, n), rng.uniform(-8.0, 8.0, n),
            rng.uniform(-1.0, 1.0, n))


SHADE_CASES = {
    "tint": dict(),
    "tint_slab_spin": dict(thickness=0.15, spin_sign=-1.0),
    "blackbody": dict(color_mode="blackbody", t_peak=7000.0,
                      brightness=14.0),
    "blackbody_slab_no_shift": dict(color_mode="blackbody", thickness=0.4,
                                    redshift=False, doppler=False),
}


@pytest.mark.parametrize("case", sorted(SHADE_CASES))
@pytest.mark.parametrize("kind", ["schwarzschild", "rn", "ellis"])
def test_disk_shading_matches_jax_f64(kind, case):
    """_disk_rgb (redshift, Doppler, slab chord, starlight term) and
    _emission_rgb to 1e-12 in f64."""
    rng = np.random.default_rng(1)
    jm, tm = _metric_pair(kind)
    r, p, b, nz = _hits(rng)
    star = rng.random((r.size, 3))
    kw = dict(r_inner=5.2, r_outer=14.0, **SHADE_CASES[case])
    jp, tp = jd.DiskParams(**kw), td.DiskParams(**kw)
    for s_j, s_t in ((None, None), (jnp.asarray(star), torch.tensor(star))):
        want = jd._disk_rgb(jm, jnp.asarray(r), jnp.asarray(p),
                            jnp.asarray(b), jnp.asarray(nz), jp,
                            jnp.float64, starlight=s_j)
        got = td._disk_rgb(tm, *(torch.tensor(a) for a in (r, p, b, nz)),
                           tp, F64, starlight=s_t)
        for w, g in zip(want, got):
            _close(w, g, SHADE_TOL)


def test_blackbody_temperature_and_volumetric_rgb_match_jax_f64():
    """blackbody_rgb (cold to hot, finite at T = 0), disk_temperature and
    _volumetric_rgb in its three modes, to 1e-12 in f64."""
    rng = np.random.default_rng(2)
    T = np.array([0.0, 1.0, 10.0, 300.0, 2000.0, 6600.0, 15000.0, 1e6])
    _close(jd.blackbody_rgb(jnp.asarray(T)), td.blackbody_rgb(
        torch.tensor(T)), SHADE_TOL)
    assert torch.isfinite(td.blackbody_rgb(torch.tensor(T))).all()
    r = np.linspace(4.0, 30.0, 57)
    for kw in (dict(r_inner=6.0, t_peak=9000.0), dict(r_inner=5.2)):
        _close(jd.disk_temperature(jnp.asarray(r), jd.DiskParams(**kw)),
               td.disk_temperature(torch.tensor(r), td.DiskParams(**kw)),
               SHADE_TOL)
    tau = rng.uniform(0.0, 5.0, 30)
    em = tuple(rng.uniform(0.0, 2.0, 30) for _ in range(3))
    for mode, scatter in (("tint", False), ("tint", True),
                          ("blackbody", False)):
        jp = jd.DiskParams(color_mode=mode, brightness=1.7)
        tp = td.DiskParams(color_mode=mode, brightness=1.7)
        want = jd._volumetric_rgb(jnp.asarray(tau),
                                  tuple(jnp.asarray(e) for e in em), jp,
                                  jnp.float64, scatter=scatter)
        got = td._volumetric_rgb(torch.tensor(tau),
                                 tuple(torch.tensor(e) for e in em), tp, F64,
                                 scatter=scatter)
        for w, g in zip(want, got):
            _close(w, g, SHADE_TOL)


def test_disk_params_match_jax():
    """The same fields and defaults as the JAX package's DiskParams."""
    want = {f.name: f.default for f in dataclasses.fields(jd.DiskParams)}
    got = {f.name: f.default for f in dataclasses.fields(td.DiskParams)}
    assert got == want
    assert td.OPAQUE_SIGN == jd.OPAQUE_SIGN == 2


# ------------------------------------------------------ (b) the XLA twins

def _check_thin(want, got):
    (ra, h1a, h2a), (rb, h1b, h2b) = want, got
    np.testing.assert_array_equal(_np(rb.sign), np.asarray(ra.sign))
    np.testing.assert_array_equal(_np(rb.steps), np.asarray(ra.steps))
    for x, y in zip((ra.l, ra.psi, ra.p_l, *h1a, *h2a),
                    (rb.l, rb.psi, rb.p_l, *h1b, *h2b)):
        _close(x, y)
    return rb, h1b, h2b


@pytest.mark.parametrize("kind", ["schwarzschild", "rn", "ellis"])
def test_march_disk_twin_matches_jax_f64(kind):
    """The thin-disk XLA twin: equal signs and steps, the march state and
    both signed hit triples within 1e-9; the wormhole has far-sheet hits."""
    jm, tm = _metric_pair(kind)
    jr, tr, (c1, c2, _), (jc1, jc2, _) = _rays(kind)
    r_in, r_out = BAND[kind]
    want = jd.march_planar_disk(jm, jr, jc1, jc2, r_inner=r_in,
                                r_outer=r_out, **KW)
    got = td.march_planar_disk(tm, tr, c1, c2, r_inner=r_in, r_outer=r_out,
                               **KW)
    _, h1, h2 = _check_thin(want, got)
    assert (h1[0] != 0).sum() > 20 and (h2[0] != 0).any()
    if kind == "ellis":
        assert (h1[0] < 0).any()          # hits on the far sheet


VOL_TWIN_CASES = {
    # kind, DiskParams overrides, scatter: a kappa that freezes rays
    "schwarzschild_tint_freeze": ("schwarzschild", dict(kappa=40.0), False),
    "rn_blackbody_scatter": ("rn", dict(color_mode="blackbody",
                                        t_peak=7000.0), True),
    "ellis_tint_scatter": ("ellis", dict(), True),
}


def _vol_params(module, kind, over):
    r_in, _ = BAND[kind]
    kw = dict(r_inner=r_in, r_outer=13.0, volumetric=True, h_rel=0.08,
              kappa=3.0)
    return module.DiskParams(**{**kw, **over})


def _scatter_block():
    return np.random.default_rng(3).uniform(0.0, 0.5, 27)


@pytest.mark.parametrize("case", sorted(VOL_TWIN_CASES))
def test_march_vol_twin_matches_jax_f64(case):
    """The volumetric XLA twin: equal signs and steps, tau and the three
    emission channels within 1e-9 (tint, blackbody, scatter, and the
    tau_max freeze)."""
    kind, over, scatter = VOL_TWIN_CASES[case]
    jm, tm = _metric_pair(kind)
    jr, tr, (c1, c2, nz), (jc1, jc2, jnz) = _rays(kind)
    block = _scatter_block() if scatter else None
    ra, taua, ema = jd.march_planar_disk_volumetric(
        jm, jr, jc1, jc2, jnz, params=_vol_params(jd, kind, over),
        scatter_block=None if block is None else jnp.asarray(block), **KW)
    rb, taub, emb = td.march_planar_disk_volumetric(
        tm, tr, c1, c2, nz, params=_vol_params(td, kind, over),
        scatter_block=None if block is None else torch.tensor(block), **KW)
    np.testing.assert_array_equal(_np(rb.sign), np.asarray(ra.sign))
    np.testing.assert_array_equal(_np(rb.steps), np.asarray(ra.steps))
    for x, y in zip((ra.l, taua, *ema), (rb.l, taub, *emb)):
        _close(x, y)
    assert float(taub.max()) > 0.5
    if "freeze" in case:
        frozen = (rb.sign == td.OPAQUE_SIGN) & (rb.l > tm.capture_radius)
        assert frozen.sum() > 5


# ---------------------------------- (c) plain versions vs Pallas kernels

DISK_PLAIN_CASES = {
    # kind, step cap, NaN rays: Schwarzschild with a cap that many rays
    # reach and two poisoned rays
    "schwarzschild_cap_nan": ("schwarzschild", 200, 2),
    "rn": ("rn", KW["max_steps"], 0),
    "ellis": ("ellis", KW["max_steps"], 0),
}


@pytest.mark.parametrize("case", sorted(DISK_PLAIN_CASES))
def test_disk_plain_matches_pallas_interpret_f64(case):
    """march_planar_disk_cuda on CPU tensors (kernel #5's plain version)
    against the Pallas disk kernel in interpret mode: equal signs and
    steps, state and hits within 1e-9 (NaN where the kernel gives NaN)."""
    kind, cap, n_nan = DISK_PLAIN_CASES[case]
    jm, tm = _metric_pair(kind)
    jr, tr, (c1, c2, _), (jc1, jc2, _) = _poisoned(kind, n_nan)
    r_in, r_out = BAND[kind]
    kw = dict(KW, max_steps=cap, r_inner=r_in, r_outer=r_out)
    want = march_planar_disk_pallas(jm, jr, jc1, jc2, interpret=True,
                                    tile_rows=8, unroll=1, **kw)
    got = march_planar_disk_cuda(tm, tr, c1, c2, **kw)
    res, h1, _ = _check_thin(want, got)
    assert (h1[0] != 0).sum() > 20
    if n_nan:
        bad = torch.isnan(tr.l)
        assert (res.sign[bad] == 0).all() and (res.steps[bad] == cap).all()
        assert torch.isnan(h1[0][bad]).all()
        capped = (res.sign == 0) & ~bad
        assert capped.any() and (res.steps[capped] == cap).all()


VOL_PLAIN_CASES = {
    # kind, DiskParams overrides, scatter, step cap, NaN rays: the four flag
    # sets of the render path (tint / blackbody x scatter, shifts on), the
    # shifts off, a kappa that freezes rays, and the wormhole
    "schwarzschild_tint": ("schwarzschild", dict(kappa=40.0), False, 200,
                           2),
    "schwarzschild_tint_scatter": ("schwarzschild", dict(), True,
                                   KW["max_steps"], 0),
    "schwarzschild_blackbody": ("schwarzschild",
                                dict(color_mode="blackbody", t_peak=7000.0),
                                False, KW["max_steps"], 0),
    "schwarzschild_blackbody_scatter": ("schwarzschild",
                                        dict(color_mode="blackbody"), True,
                                        KW["max_steps"], 0),
    "rn_tint_redshift_only": ("rn", dict(doppler=False), False,
                              KW["max_steps"], 0),
    "ellis_blackbody": ("ellis", dict(color_mode="blackbody"), False,
                        KW["max_steps"], 0),
}


@pytest.mark.parametrize("case", sorted(VOL_PLAIN_CASES))
def test_vol_plain_matches_pallas_interpret_f64(case):
    """march_planar_disk_volumetric_cuda on CPU tensors (kernel #6's plain
    version) against the Pallas volumetric kernel in interpret mode: equal
    signs and steps, tau and emission within 1e-9."""
    kind, over, scatter, cap, n_nan = VOL_PLAIN_CASES[case]
    jm, tm = _metric_pair(kind)
    jr, tr, (c1, c2, nz), (jc1, jc2, jnz) = _poisoned(kind, n_nan)
    block = _scatter_block() if scatter else None
    kw = dict(KW, max_steps=cap)
    ra, taua, ema = march_planar_disk_volumetric_pallas(
        jm, jr, jc1, jc2, jnz, disk=_vol_params(jd, kind, over),
        scatter_block=None if block is None else jnp.asarray(block),
        interpret=True, tile_rows=8, unroll=1, **kw)
    rb, taub, emb = march_planar_disk_volumetric_cuda(
        tm, tr, c1, c2, nz, disk=_vol_params(td, kind, over),
        scatter_block=None if block is None else torch.tensor(block), **kw)
    np.testing.assert_array_equal(_np(rb.sign), np.asarray(ra.sign))
    np.testing.assert_array_equal(_np(rb.steps), np.asarray(ra.steps))
    for x, y in zip((ra.l, ra.p_l, taua, *ema), (rb.l, rb.p_l, taub, *emb)):
        _close(x, y)
    if "kappa" in over:
        frozen = (rb.sign == 2) & (rb.l > tm.capture_radius)
        assert frozen.sum() > 5
    if n_nan:
        bad = torch.isnan(tr.l)
        assert (rb.sign[bad] == 0).all() and torch.isnan(taub[bad]).all()
        assert (rb.steps[bad] == cap).all()


# ---------------------------------------------------------- (d) renders

def _jax_map(jm, skies, **kw):
    """The JAX package's compute_disk_starlight_map under jax.jit, with
    bilinear per-sample lookups (see the module docstring)."""
    return jax.jit(lambda m, a, b: js.compute_disk_starlight_map(
        m, a, b, sample_filtering="bilinear", **kw))(jm, *skies)


@functools.lru_cache(maxsize=None)
def _maps():
    """The self-shadowed starlight maps of the Schwarzschild disk, (JAX,
    port), from the same inputs."""
    jm, tm = _metric_pair("schwarzschild")
    jb, tb = _sky()
    kw = dict(r_inner=5.2, r_outer=14.0, **MAP, **KW)
    want = _jax_map(jm, (jb, jb), shadow_params=jd.DiskParams(
        r_inner=5.2, r_outer=14.0), **kw)
    got = ts.compute_disk_starlight_map(
        tm, tb, tb, sample_filtering="bilinear",
        shadow_params=td.DiskParams(r_inner=5.2, r_outer=14.0), **kw)
    return want, got


RENDER_CASES = {
    "thin_tint_slab": dict(r_outer=14.0, thickness=0.15),
    "thin_blackbody": dict(r_outer=14.0, color_mode="blackbody",
                           t_peak=7000.0, brightness=14.0),
    "volumetric_tint": dict(volumetric=True, kappa=3.0),
    "thin_starlight": dict(r_outer=14.0, starlight=True, **MAP_DISK),
    "volumetric_blackbody_starlight": dict(volumetric=True, kappa=3.0,
                                           color_mode="blackbody",
                                           t_peak=7000.0, starlight=True,
                                           **MAP_DISK),
}


def _image_close(want, got):
    d = np.abs(np.asarray(want) - _np(got)).max(-1)
    assert (d <= IMG_TOL).mean() >= IMG_FRAC, d.max()


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_blackhole_disk_matches_jax_f64(case):
    """render_blackhole_disk at 32 x 18 against the JAX package's
    backend='while' render (the starlit cases with the maps of _maps)."""
    jm, tm = _metric_pair("schwarzschild")
    jb, tb = _sky()
    jc, tc = _camera_pair(28.0, (32, 18))
    kw = {"r_inner": 5.2, "r_outer": 13.0, **RENDER_CASES[case]}
    jp, tp = jd.DiskParams(**kw), td.DiskParams(**kw)
    jmap, tmap = _maps() if jp.starlight else (None, None)
    want = jd.render_blackhole_disk(jm, jc, jb, backend="while", disk=jp,
                                    starlight_map=jmap, **KW)
    got = td.render_blackhole_disk(tm, tc, tb, disk=tp, starlight_map=tmap,
                                   **KW)
    assert got.shape == (18, 32, 3)
    _image_close(want, got)
    assert (_np(got).sum(-1) > 0.3).mean() > 0.05     # a bright disk


def test_render_disk_frames_batched_matches_jax_f64():
    """Two poses in one march bundle against the JAX package's batched
    render, and each frame against the single-frame route."""
    jm, tm = _metric_pair("rn")
    jb, tb = _sky()
    pairs = [_camera_pair(28.0, (32, 18), phi) for phi in (0.0, 0.7)]
    kw = dict(r_inner=5.2, r_outer=14.0, color_mode="blackbody")
    want = jd.render_disk_frames_batched(
        jm, [p[0] for p in pairs], jb, backend="while",
        disk=jd.DiskParams(**kw), **KW)
    got = td.render_disk_frames_batched(tm, [p[1] for p in pairs], tb,
                                        disk=td.DiskParams(**kw), **KW)
    assert got.shape == (2, 18, 32, 3)
    _image_close(want, got)
    one = td.render_blackhole_disk(tm, pairs[1][1], tb,
                                   disk=td.DiskParams(**kw), **KW)
    torch.testing.assert_close(one, got[1], rtol=0.0, atol=1e-12)


# ----------------------------------------------------- (e) starlight

def test_starlight_map_matches_jax_f64():
    """compute_disk_starlight_map (the self-shadowed Schwarzschild map)
    against the JAX package's, to 1e-12; compute_starlight_map is that
    map for the disk's own grid, nearest lookups and shadow."""
    want, got = _maps()
    assert got.values.shape == (2, 8, 16, 3) and got.values_neg is None
    _close(want.radii, got.radii, SHADE_TOL)
    _close(want.values, got.values, SHADE_TOL)
    assert float(got.values.max()) > 0.01
    _, tm = _metric_pair("schwarzschild")
    _, tb = _sky()
    disk = td.DiskParams(r_inner=5.2, r_outer=14.0, **MAP_DISK)
    direct = ts.compute_disk_starlight_map(
        tm, tb, tb, r_inner=5.2, r_outer=14.0, shadow_params=disk, **MAP,
        **KW)
    torch.testing.assert_close(
        td.compute_starlight_map(tm, tb, disk, **KW).values, direct.values,
        rtol=0.0, atol=0.0)


def test_two_sheet_starlight_map_matches_jax_f64():
    """The two-sheet map of the Ellis wormhole (the mirrored metric is the
    metric, the skies swap), to 1e-12; its lookup, and that of the JAX map
    carried over by convert.starlight_map, selects the sheet by the sign
    of the hit."""
    jm, tm = _metric_pair("ellis")
    rng = np.random.default_rng(4)
    skies = [cv.make_spherical_image(0.3 * rng.random((16, 32, 3)),
                                     dtype=jnp.float64) for _ in range(2)]
    tsk = [convert.spherical_image_from_arrays(
        np.asarray(s.texture), np.asarray(s.rotation), device="cpu",
        dtype=F64) for s in skies]
    kw = dict(r_inner=1.5, r_outer=6.0, two_sheet=True, n_r=4, n_phi=8,
              n_samples=8, **KW)
    want = _jax_map(jm, skies, **kw)
    got = ts.compute_disk_starlight_map(tm, *tsk,
                                        sample_filtering="bilinear", **kw)
    _close(want.values, got.values, SHADE_TOL)
    _close(want.values_neg, got.values_neg, SHADE_TOL)
    r = np.concatenate([rng.uniform(1.5, 6.0, 20), -rng.uniform(1.5, 6.0,
                                                                20)])
    phi = rng.uniform(-4.0, 4.0, 40)
    side = np.where(rng.random(40) < 0.5, -1.0, 1.0)
    carried = convert.starlight_map(
        *(np.asarray(a) for a in (want.radii, want.values, want.values_neg)),
        device="cpu", dtype=F64)
    want_l = js.starlight_lookup(want, *(jnp.asarray(a) for a in
                                         (r, phi, side)))
    for smap in (got, carried):
        _close(want_l, ts.starlight_lookup(smap, *(torch.tensor(a) for a in
                                                   (r, phi, side))),
               SHADE_TOL)


def test_starlight_lookup_phi_side_and_scatter_block_match_jax():
    """starlight_lookup (wraparound, both faces, clipped radii) on a JAX
    map carried over by convert.starlight_map, hit_phi_side and
    starlight_scatter_block, to 1e-12."""
    want, _ = _maps()
    port_map = convert.starlight_map(np.asarray(want.radii),
                                     np.asarray(want.values), device="cpu",
                                     dtype=F64)
    _close(want.values, port_map.values, 0.0)
    rng = np.random.default_rng(5)
    n = 60
    r = rng.uniform(3.0, 16.0, n) * np.where(rng.random(n) < 0.3, -1, 1)
    psi = rng.uniform(-7.0, 7.0, n)
    b = rng.uniform(-6.0, 6.0, n)
    b[:3] = 0.0
    c1, c2 = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    e1 = tuple(rng.uniform(-1, 1, n) for _ in range(3))
    e2 = tuple(rng.uniform(-1, 1, n) for _ in range(3))
    jphi, jside = js.hit_phi_side(
        jnp.asarray(r), jnp.asarray(psi), jnp.asarray(b), jnp.asarray(c1),
        jnp.asarray(c2), tuple(map(jnp.asarray, e1)),
        tuple(map(jnp.asarray, e2)))
    tphi, tside = ts.hit_phi_side(
        torch.tensor(r), torch.tensor(psi), torch.tensor(b),
        torch.tensor(c1), torch.tensor(c2), tuple(map(torch.tensor, e1)),
        tuple(map(torch.tensor, e2)))
    _close(jphi, tphi, SHADE_TOL)
    _close(jside, tside, 0.0)
    _close(js.starlight_lookup(want, jnp.asarray(r), jphi, jside),
           ts.starlight_lookup(port_map, torch.tensor(r), tphi, tside),
           SHADE_TOL)
    for kw in (dict(), dict(albedo=(0.2, 0.5, 0.9), starlight_scatter=0.5,
                            kappa=3.0)):
        _close(js.starlight_scatter_block(want, jd.DiskParams(**kw),
                                          jnp.float64),
               ts.starlight_scatter_block(port_map, td.DiskParams(**kw),
                                          F64), SHADE_TOL)


# ------------------------------------------------------------- (f) CLI

@pytest.fixture()
def disk_scene(tmp_path):
    """Two tiny skies and the settings TOMLs of a Schwarzschild view."""
    rng = np.random.default_rng(0)
    for name in ("bg1.png", "bg2.png"):
        arr = (rng.random((16, 32, 3)) * 120).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / name)
    (tmp_path / "cam.toml").write_text(
        "resolution_x = 24\nresolution_y = 16\n"
        "diagonal = 43.0\nfocal_length = 30.0\n")
    (tmp_path / "sim.toml").write_text(
        "escape_radius = 32.0\nray_integration_max_iterations = 2000\n"
        "ray_integration_step = 0.125\n")
    (tmp_path / "metric.toml").write_text('kind = "schwarzschild"\nm = 1.0\n')
    (tmp_path / "img.toml").write_text(
        f"l = 28.0\ntheta = {TH!r}\nphi = 0.0\n"
        f"forward_x = {-math.sin(TH)!r}\nforward_y = 0.0\n"
        f"forward_z = {-math.cos(TH)!r}\n")
    return tmp_path


@pytest.mark.parametrize("extra", [(), ("--disk-volumetric",
                                        "--disk-color", "blackbody")])
def test_cli_image_disk_matches_jax_cli(disk_scene, extra):
    """``image --disk`` under the default (symmetric) renderer, as the JAX
    CLI takes it: the JAX CLI's PNG to 8-bit rounding on >= 95 % of
    pixels (nearest lookup: texel seams)."""
    d = disk_scene

    def args(out):
        return ["image", str(d / "bg1.png"), str(d / "bg2.png"),
                str(d / out), "-m", str(d / "metric.toml"), "-c",
                str(d / "cam.toml"), "-s", str(d / "sim.toml"), "-i",
                str(d / "img.toml"), "--f64", "--disk", *extra]

    assert jax_cli(args("jax")) == 0
    assert port_cli(args("port")) == 0
    a = np.asarray(Image.open(d / "jax" / "output_image.png")).astype(int)
    b = np.asarray(Image.open(d / "port" / "output_image.png")).astype(int)
    assert a.shape == b.shape == (16, 24, 3)
    # the centre column's rays escape on the sky's phi = +-pi seam, where
    # the nearest texel flips with the sign of a zero world y
    assert (np.abs(a - b).max(-1) > 1).mean() <= 0.05
    assert (b.sum(-1) > 100).mean() > 0.05


# -------------------------------------------------------- (g) refusals

class _Tabulated(Metric):
    """A metric the CUDA marches do not know (like a tabulated one)."""

    def r(self, l):
        return torch.sqrt(1.0 + l * l)


def test_unported_disk_options_raise():
    jm, tm = _metric_pair("schwarzschild")
    _, tb = _sky()
    _, tc = _camera_pair(28.0, (4, 2))
    disk = td.DiskParams()
    kw = dict(dt=0.1, max_steps=10, escape_radius=40.0)
    for call in (lambda **k: td.render_blackhole_disk(tm, tc, tb, **k),
                 lambda **k: td.render_disk_frames_batched(tm, [tc], tb,
                                                           **k),
                 lambda **k: td.compute_starlight_map(tm, tb, disk, **k)):
        assert torch.isfinite(call(stepper="rk45", **kw)[0]).all()
        with pytest.raises(NotImplementedError, match="item 7"):
            call(stepper="rk4", **kw)
    # both steppers' routes are differentiable
    img = td.render_blackhole_disk(tm, tc, tb, stepper="rk45",
                                   differentiable="adjoint", **kw)
    assert torch.isfinite(img).all()
    with pytest.raises(NotImplementedError, match="tabulate"):
        ts.mirror_metric(_Tabulated())
    _, tr, (c1, c2, nz), _ = _rays("schwarzschild")
    with pytest.raises(NotImplementedError, match="tabulate"):
        march_planar_disk_cuda(_Tabulated(), tr, c1, c2, r_inner=5.0,
                               r_outer=9.0, **kw)
    with pytest.raises(NotImplementedError, match="tabulate"):
        march_planar_disk_volumetric_cuda(_Tabulated(), tr, c1, c2, nz,
                                          disk=disk, **kw)
