"""PyTorch port vs the JAX package: the adaptive DP5(4) disk routes
(``stepper='rk45'`` in ``render_blackhole_disk``,
``render_disk_frames_batched`` and the starlight map), on the CPU in
float64.

Three references, as for the other rk45 marches:

- ``integrate/rk45.py:march_planar_rk45`` with ``disk=`` / ``vol_disk=``
  (the render routes' CPU march) against the JAX XLA twin of the same
  name: the thin disk on Schwarzschild, Reissner-Nordstrom and an Ellis
  wormhole (signed far-sheet hits); the volumetric disk in tint, in
  blackbody with redshift and Doppler, with a real scatter block, on the
  wormhole and with a kappa that freezes rays at tau_max;
- ``ops/rk45_disk_cuda.py:march_planar_rk45_disk_plain``, the plain
  version of the CUDA kernel ``csrc/planar_rk45_disk.cu``, against the
  Pallas kernel ``march_planar_rk45_pallas`` in interpret mode, whose
  arithmetic it transcribes (|dt (d5 - d4)| norm, exp / log factor,
  y + a frac (y5 - y) write-back, zq without r): the same modes, a step
  cap and NaN rays, with the iteration counts;
- ``render_blackhole_disk(stepper='rk45')`` (thin, starlit, volumetric,
  volumetric starlit), ``render_disk_frames_batched`` over 2 poses and
  ``compute_starlight_map(stepper='rk45')`` against the JAX package's
  ``backend='while'`` routes.  The starlit renders get the same map on
  both sides, and the maps are compared with bilinear per-sample lookups
  (jitting the JAX map moves nearest texels at seams).

The tolerances.  Signs, accepted steps and iteration counts are equal.
Every float is held to TOL = 1e-8 (absolute and relative), not to the
~1e-13 of the Euler disk renders.  XLA and PyTorch round the same
formulas differently at the last bit (the bare DP5(4) twins already
differ by ~2e-11 in psi on these rays); the disk clamps hold dt near dt0
around the disk, so a ray takes several times more steps, and rays that
pass near the photon sphere (r = 3M) amplify each difference along their
path.  Measured on these inputs: up to 4e-10 in psi and the hit radius of
escaped rays and 4e-9 (1.6e-9 relative) in the radial momentum of
captured rays, which diverges as 1 / A near the horizon (thin disk, twin
and plain version alike); up to 1e-10 in tau and 2e-11 elsewhere on the
volumetric disk.  Images are held to IMG_TOL = 1e-8.

Inputs are made with numpy from a seed at the sizes of
``tests/test_torch_disk.py``: 24 x 12 rays, 32 x 18 images, an (8, 16)
map of 16 samples.
"""
import functools
import inspect
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import curvis_tpu as cv
from curvis_tpu.integrate.rk45 import march_planar_rk45 as jax_twin
from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
from curvis_tpu.physics import planar as jpl
from curvis_tpu.render import disk as jd
from curvis_tpu.render import starlight as js

from curvis_tpu_torch import convert
from curvis_tpu_torch.integrate.rk45 import march_planar_rk45
from curvis_tpu_torch.metrics.base import make_metric
from curvis_tpu_torch.ops import rk45_disk_cuda
from curvis_tpu_torch.ops.rk45_disk_cuda import march_planar_rk45_disk_cuda
from curvis_tpu_torch.physics import planar as tpl
from curvis_tpu_torch.render import disk as td
from curvis_tpu_torch.render import fast as tfast
from curvis_tpu_torch.render import starlight as ts

F64 = torch.float64
TH = math.pi / 2 - 0.2               # the example's camera inclination
# the render routes' march: dt the initial step, atol = rtol 1e-3
KW = dict(dt=0.125, max_steps=2000, escape_radius=32.0)
MARCH = dict(dt0=0.125, max_steps=2000, escape_radius=32.0, rtol=1e-5,
             atol=1e-8)
METRICS = {"schwarzschild": (dict(m=1.0), 28.0),
           "rn": (dict(m=1.0, q=0.6), 28.0),
           "ellis": (dict(rho=1.0), 10.0)}
BAND = {"schwarzschild": (5.2, 14.0), "rn": (5.2, 14.0),
        "ellis": (1.5, 14.0)}
MAP = dict(n_r=8, n_phi=16, n_samples=16)
MAP_DISK = dict(starlight_grid=(8, 16), starlight_samples=16)
TOL = 1e-8                           # march outputs (module docstring)
IMG_TOL = 1e-8                       # images


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
                        [-math.sin(TH) * math.cos(phi),
                         -math.sin(TH) * math.sin(phi), -math.cos(TH)],
                        [0.0, 0.0, 1.0], 30.0, 43.0, res[0], res[1],
                        dtype=jnp.float64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        res[0], res[1], device="cpu", dtype=F64)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _rays(kind, n_nan=0):
    """(JAX rays, port rays, (c1, c2, nz) as torch, as jnp): the 24 x 12
    pixel rays of the example's view, spawned by the port in f64, with
    ``n_nan`` evenly spread l set to NaN."""
    _, tm = _metric_pair(kind)
    _, tc = _camera_pair(METRICS[kind][1], (24, 12))
    (l, psi, p_l, b), r_hat, e2 = tfast._spawn_frames(tm, [tc])
    if n_nan:
        l = l.clone()
        l[np.linspace(0, l.numel() - 1, n_nan).astype(int)] = math.nan
    planes = tuple(t.contiguous() for t in (
        r_hat[2], e2[2], r_hat[0] * e2[1] - r_hat[1] * e2[0]))
    tr = tpl.PlanarRays(l, psi, p_l, b, None, None)
    z = jnp.zeros((1, 3))
    jr = jpl.PlanarRays(*(jnp.asarray(_np(t)) for t in tr[:4]), z, z)
    return jr, tr, planes, tuple(jnp.asarray(_np(t)) for t in planes)


@functools.lru_cache(maxsize=None)
def _sky():
    rng = np.random.default_rng(0)
    jb = cv.make_spherical_image(0.3 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    tb = convert.spherical_image_from_arrays(
        np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
        dtype=F64)
    return jb, tb


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` under one jax.jit (an eager call also compiles
    each operation around the loop): the arrays of ``kw`` are traced, the
    rest static."""
    arrays = {k: v for k, v in kw.items() if isinstance(v, jax.Array)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    return jax.jit(functools.partial(fn, **static))(*args, **arrays)


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _scatter_block():
    return np.random.default_rng(3).uniform(0.0, 0.5, 27)


def _vol_params(module, kind, over):
    r_in, _ = BAND[kind]
    kw = dict(r_inner=r_in, r_outer=13.0, volumetric=True, h_rel=0.08,
              kappa=3.0)
    return module.DiskParams(**{**kw, **over})


def _check(want, got, *, iters=False):
    """Equal signs and steps (and iterations), and every float of the
    result within TOL; returns the port's outputs as numpy."""
    res_w, *rest_w = want
    res_g, *rest_g = got
    sign = _np(res_g.sign)
    np.testing.assert_array_equal(sign, np.asarray(res_w.sign))
    np.testing.assert_array_equal(_np(res_g.steps), np.asarray(res_w.steps))
    if iters:
        np.testing.assert_array_equal(_np(rest_g.pop()),
                                      np.asarray(rest_w.pop()))
    flat_w = [res_w.l, res_w.psi, res_w.p_l]
    flat_g = [res_g.l, res_g.psi, res_g.p_l]
    for w, g in zip(rest_w, rest_g):
        flat_w += list(w) if isinstance(w, tuple) else [w]
        flat_g += list(g) if isinstance(g, tuple) else [g]
    for w, g in zip(flat_w, flat_g):
        _close(w, g)
    return sign, [_np(g) for g in flat_g]


# ------------------------------------------------ (a) the CPU twin

@pytest.mark.parametrize("kind", ["schwarzschild", "rn", "ellis"])
def test_march_rk45_disk_twin_matches_jax_f64(kind):
    """The thin-disk variant of the DP5(4) twin against the JAX XLA twin:
    equal signs and steps, the state and both signed hit triples within
    TOL; the wormhole has hits on the far sheet."""
    jm, tm = _metric_pair(kind)
    jr, tr, (c1, c2, _), (jc1, jc2, _) = _rays(kind)
    band = BAND[kind]
    want = _jit(jax_twin, jm, jr, c1=jc1, c2=jc2, disk=band, **MARCH)
    got = march_planar_rk45(tm, tr, c1=c1, c2=c2, disk=band, **MARCH)
    _, (*_, h1, _, _, h2, _, _) = _check(want, got)
    assert (h1 != 0).sum() > 20 and (h2 != 0).any()
    if kind == "ellis":
        assert (h1 < 0).any()             # hits on the far sheet


VOL_CASES = {
    # kind, DiskParams overrides, scatter block (redshift and Doppler are
    # on by default)
    "schwarzschild_tint_freeze": ("schwarzschild", dict(kappa=40.0), False),
    "rn_blackbody_shifts": ("rn", dict(color_mode="blackbody",
                                       t_peak=7000.0), False),
    "schwarzschild_blackbody_scatter": ("schwarzschild",
                                        dict(color_mode="blackbody"), True),
}


@pytest.mark.parametrize("case", sorted(VOL_CASES))
def test_march_rk45_vol_twin_matches_jax_f64(case):
    """The volumetric variant of the DP5(4) twin against the JAX XLA twin:
    equal signs and steps, state, tau and emission within TOL; the kappa
    40 case freezes rays at tau_max (sign 2 outside the capture radius)."""
    kind, over, scatter = VOL_CASES[case]
    jm, tm = _metric_pair(kind)
    jr, tr, (c1, c2, nz), (jc1, jc2, jnz) = _rays(kind)
    block = _scatter_block() if scatter else None
    want = _jit(jax_twin, jm, jr, c1=jc1, c2=jc2, nz=jnz,
                vol_disk=_vol_params(jd, kind, over),
                scatter_block=None if block is None else jnp.asarray(block),
                **MARCH)
    got = march_planar_rk45(tm, tr, c1=c1, c2=c2, nz=nz,
                            vol_disk=_vol_params(td, kind, over),
                            scatter_block=None if block is None
                            else torch.tensor(block), **MARCH)
    sign, (l, *_, tau, _, _, _) = _check(want, got)
    assert tau.max() > 0.5
    if "freeze" in case:
        assert ((sign == td.OPAQUE_SIGN)
                & (l > float(tm.capture_radius))).sum() > 5


def test_march_rk45_surface_variants_refuse_both():
    _, tm = _metric_pair("schwarzschild")
    _, tr, (c1, c2, nz), _ = _rays("schwarzschild")
    with pytest.raises(ValueError, match="not both"):
        march_planar_rk45(tm, tr, c1=c1, c2=c2, nz=nz, disk=(5.0, 9.0),
                          vol_disk=td.DiskParams(volumetric=True), **MARCH)
    with pytest.raises(ValueError, match="not both"):
        march_planar_rk45_disk_cuda(tm, tr, c1=c1, c2=c2, nz=nz,
                                    disk=(5.0, 9.0),
                                    vol_disk=td.DiskParams(), **MARCH)


# ------------------------------ (b) the kernel's plain version vs Pallas

PLAIN_CASES = {
    # kind, None (the disk tracker) or (DiskParams overrides, scatter),
    # step cap, NaN rays: the lapse kinds' and the wormhole's clamps, a
    # cap that most rays reach, NaN rays in both modes, the tau_max freeze,
    # blackbody with the shifts and a scatter block
    "thin_schwarzschild_cap_nan": ("schwarzschild", None, 30, 3),
    "thin_ellis": ("ellis", None, 2000, 0),
    "vol_tint_freeze": ("schwarzschild", (dict(kappa=40.0), False), 2000,
                        0),
    "vol_blackbody_scatter_cap_nan": ("schwarzschild",
                                      (dict(color_mode="blackbody"), True),
                                      30, 3),
    "vol_ellis_blackbody": ("ellis", (dict(color_mode="blackbody"), False),
                            2000, 0),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_rk45_disk_plain_matches_pallas_interpret_f64(case):
    """march_planar_rk45_disk_cuda on CPU tensors (the plain version of
    kernel #4's surface variants) against march_planar_rk45_pallas in
    interpret mode: equal signs, steps and iterations, every float within
    TOL.

    A step cap that most rays reach stops them with sign 0 after exactly
    that many accepted steps.  NaN rays: the disk tracker freezes them as
    sign 3 (a reject at the dt floor); the volumetric clamp turns their dt
    NaN, so they run to max_iters with sign 0 and no step, in the Pallas
    kernel as in the port.  The Pallas kernel starts its hit, tau and
    iteration carries at l * 0 (a Mosaic layout workaround that the port
    leaves out), so on NaN rays it reports NaN there and an iteration
    count cast from NaN; the port reports zeros and the iterations the
    ray was live for, and those rays are compared on sign and steps."""
    kind, vol, cap, n_nan = PLAIN_CASES[case]
    jm, tm = _metric_pair(kind)
    jr, tr, (c1, c2, nz), (jc1, jc2, jnz) = _rays(kind, n_nan)
    kw = dict(MARCH, max_steps=cap)
    if vol is None:
        band = BAND[kind]
        want = _jit(march_planar_rk45_pallas, jm, jr, c1=jc1, c2=jc2,
                    disk=band, interpret=True, tile_rows=8,
                    return_iters=True, **kw)
        got = march_planar_rk45_disk_cuda(tm, tr, c1=c1, c2=c2, disk=band,
                                          return_iters=True, **kw)
    else:
        over, scatter = vol
        block = _scatter_block() if scatter else None
        want = _jit(march_planar_rk45_pallas, jm, jr, c1=jc1, c2=jc2, nz=jnz,
                    vol_disk=_vol_params(jd, kind, over),
                    scatter_block=None if block is None
                    else jnp.asarray(block),
                    interpret=True, tile_rows=8, return_iters=True, **kw)
        got = march_planar_rk45_disk_cuda(
            tm, tr, c1=c1, c2=c2, nz=nz, vol_disk=_vol_params(td, kind, over),
            scatter_block=None if block is None else torch.tensor(block),
            return_iters=True, **kw)
    bad = np.isnan(_np(tr.l))
    iters = _np(got[-1])
    if n_nan:
        res = got[0]
        np.testing.assert_array_equal(_np(res.sign)[bad],
                                      np.asarray(want[0].sign)[bad])
        np.testing.assert_array_equal(_np(res.steps)[bad], 0)
        if vol is None:
            assert (_np(res.sign)[bad] == 3).all() and (iters[bad] < 40).all()
        else:
            assert (_np(res.sign)[bad] == 0).all()
            assert (iters[bad] == 4 * cap).all()
        ok = torch.from_numpy(~bad)
        want = jax.tree.map(lambda a: a[~bad], want)
        got = jax.tree.map(lambda t: t[ok], got)
    sign, flat = _check(want, got, iters=True)
    assert (_np(got[-1]) >= _np(got[0].steps)).all()
    if cap < 100:
        capped = sign == 0
        assert capped.mean() > 0.5 and (_np(got[0].steps)[capped]
                                        == cap).all()
    if vol is None:
        assert (flat[3] != 0).sum() > 10          # first hits
        if kind == "ellis":
            assert (flat[3] < 0).any()           # far-sheet hits
    elif "kappa" in vol[0]:
        assert ((sign == 2) & (flat[0] > float(tm.capture_radius))).sum() > 5


def test_rk45_disk_scalar_row_and_wrapper_refusals():
    """The kernel's host row: the rk45 row, the band, the 8 emission slots
    and the scatter block (the Pallas rk45 rows without their padding);
    a tracker with a scatter block, vol without nz and a device the kernel
    does not know are refused."""
    _, tm = _metric_pair("rn")
    kind, row = rk45_disk_scalars_of(tm, disk=(5.2, 14.0))
    assert kind == "rn" and len(row) == 11 and row[9:] == [5.2, 14.0]
    assert row[6:9] == [1e-5, 1e-8, 10.0]
    vd = td.DiskParams(volumetric=True, r_inner=5.2, r_outer=13.0)
    _, row = rk45_disk_scalars_of(tm, vol_disk=vd)
    assert len(row) == 19 and row[11] == pytest.approx(0.08 ** 2)
    _, row = rk45_disk_scalars_of(tm, vol_disk=vd,
                                  scatter_block=_scatter_block())
    assert len(row) == 46 and row[19:] == list(_scatter_block())
    with pytest.raises(ValueError, match="needs vol_disk"):
        rk45_disk_scalars_of(tm, disk=(5.2, 14.0),
                             scatter_block=_scatter_block())
    _, tr, (c1, c2, _), _ = _rays("rn")
    with pytest.raises(ValueError, match="nz"):
        march_planar_rk45_disk_cuda(tm, tr, c1=c1, c2=c2, vol_disk=vd,
                                    **MARCH)
    meta = tpl.PlanarRays(*(torch.zeros(4, device="meta")
                            for _ in range(4)), None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        march_planar_rk45_disk_cuda(make_metric("flat"), meta, c1=meta.l,
                                    c2=meta.l, disk=(5.2, 14.0), **MARCH)


def rk45_disk_scalars_of(metric, **kw):
    return rk45_disk_cuda.rk45_disk_scalars(metric, 0.125, 32.0, 1e-5, 1e-8,
                                            10.0, **kw)


# ---------------------------------------------------------- (c) renders

def _jax_map(jm, jb, disk, **kw):
    """The JAX package's compute_disk_starlight_map for ``disk``'s grid and
    self-shadow under jax.jit, with bilinear per-sample lookups."""
    n_r, n_phi = disk.starlight_grid
    return jax.jit(lambda m, a: js.compute_disk_starlight_map(
        m, a, a, r_inner=disk.r_inner, r_outer=disk.r_outer, n_r=n_r,
        n_phi=n_phi, n_samples=disk.starlight_samples,
        sample_filtering="bilinear", stepper="rk45", rtol=1e-5,
        shadow_params=disk, **kw))(jm, jb)


@functools.lru_cache(maxsize=None)
def _maps():
    """The rk45 starlight maps of the Schwarzschild disk, (JAX, port), with
    bilinear per-sample lookups, from the same inputs."""
    jm, tm = _metric_pair("schwarzschild")
    jb, tb = _sky()
    kw = dict(r_inner=5.2, r_outer=13.0, **MAP_DISK)
    want = _jax_map(jm, jb, jd.DiskParams(**kw), **KW)
    got = ts.compute_disk_starlight_map(
        tm, tb, tb, r_inner=5.2, r_outer=13.0, **MAP, stepper="rk45",
        rtol=1e-5, sample_filtering="bilinear",
        shadow_params=td.DiskParams(**kw), **KW)
    return want, got


RENDER_CASES = {
    "thin_blackbody_starlight": dict(color_mode="blackbody", t_peak=7000.0,
                                     brightness=14.0, starlight=True,
                                     **MAP_DISK),
    "volumetric_tint": dict(volumetric=True, kappa=3.0),
    "volumetric_blackbody_starlight": dict(volumetric=True, kappa=3.0,
                                           color_mode="blackbody",
                                           t_peak=7000.0, starlight=True,
                                           **MAP_DISK),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_blackhole_disk_rk45_matches_jax_f64(case):
    """render_blackhole_disk(stepper='rk45') at 32 x 18 against the JAX
    package's backend='while' render within IMG_TOL (the starlit cases
    with the maps of _maps, in-gas scatter for the volumetric one)."""
    jm, tm = _metric_pair("schwarzschild")
    jb, tb = _sky()
    jc, tc = _camera_pair(28.0, (32, 18))
    kw = {"r_inner": 5.2, "r_outer": 13.0, **RENDER_CASES[case]}
    jp, tp = jd.DiskParams(**kw), td.DiskParams(**kw)
    jmap, tmap = _maps() if jp.starlight else (None, None)
    want = jd.render_blackhole_disk(jm, jc, jb, backend="while", disk=jp,
                                    stepper="rk45", starlight_map=jmap, **KW)
    got = td.render_blackhole_disk(tm, tc, tb, disk=tp, stepper="rk45",
                                   starlight_map=tmap, **KW)
    assert got.shape == (18, 32, 3)
    _close(want, got, IMG_TOL)
    assert (_np(got).sum(-1) > 0.3).mean() > 0.05     # a bright disk


def test_render_disk_frames_batched_rk45_matches_jax_f64():
    """Two poses in one rk45 march bundle against the JAX package's
    batched render."""
    jm, tm = _metric_pair("rn")
    jb, tb = _sky()
    pairs = [_camera_pair(28.0, (32, 18), phi) for phi in (0.0, 0.7)]
    kw = dict(r_inner=5.2, r_outer=14.0, color_mode="blackbody")
    want = jd.render_disk_frames_batched(
        jm, [p[0] for p in pairs], jb, backend="while", stepper="rk45",
        disk=jd.DiskParams(**kw), **KW)
    got = td.render_disk_frames_batched(tm, [p[1] for p in pairs], tb,
                                        stepper="rk45",
                                        disk=td.DiskParams(**kw), **KW)
    assert got.shape == (2, 18, 32, 3)
    _close(want, got, IMG_TOL)


def test_starlight_map_rk45_matches_jax_f64():
    """compute_disk_starlight_map(stepper='rk45') (the self-shadowed
    Schwarzschild map, its march the DP5(4) disk tracker on the n_r x
    n_samples bundle with c1 = 0, c2 = 1) against the JAX package's within
    TOL; compute_starlight_map(stepper='rk45') is that map for the disk's
    own grid and shadow, and its march differs from Euler's."""
    want, got = _maps()
    assert got.values.shape == (2, 8, 16, 3)
    _close(want.radii, got.radii)
    _close(want.values, got.values)
    assert float(got.values.max()) > 0.01
    _, tm = _metric_pair("schwarzschild")
    _, tb = _sky()
    disk = td.DiskParams(r_inner=5.2, r_outer=13.0, **MAP_DISK)
    direct = ts.compute_disk_starlight_map(
        tm, tb, tb, r_inner=5.2, r_outer=13.0, stepper="rk45", rtol=1e-5,
        shadow_params=disk, **MAP, **KW)
    rk45 = td.compute_starlight_map(tm, tb, disk, stepper="rk45", **KW)
    torch.testing.assert_close(rk45.values, direct.values, rtol=0.0,
                               atol=0.0)
    euler = td.compute_starlight_map(tm, tb, disk, **KW)
    assert not torch.equal(euler.values, rk45.values)


def test_disk_routes_rtol_default_matches_jax():
    """rtol (the DP5(4) tolerance) defaults as in the JAX package on every
    disk route, and the map's march takes it."""
    for jf, tf in ((jd.render_blackhole_disk, td.render_blackhole_disk),
                   (jd.render_disk_frames_batched,
                    td.render_disk_frames_batched),
                   (jd.compute_starlight_map, td.compute_starlight_map),
                   (js.compute_disk_starlight_map,
                    ts.compute_disk_starlight_map)):
        want = inspect.signature(jf).parameters["rtol"].default
        assert inspect.signature(tf).parameters["rtol"].default == want
        assert want == 1e-5
