"""PyTorch port vs the JAX package: the Kerr / Kerr-Newman RK4 path, on
the CPU.

Held against their JAX counterparts on the same numpy inputs, in float64:

- the metrics (covariant and contravariant forms, horizon and capture
  radii, critical impact parameters, photon-shell constants and the shadow
  outline), ``frame_matrix``, the static tetrad and ``spawn_photon``, to
  1e-12;
- ``physics/hamiltonian.py:march_hamiltonian`` (the autodiff RK4 march of
  the CPU routes) on a 16-ray bundle like ``tests/test_kerr.py:164``:
  equal signs and steps, escaped states within 1e-10;
- the plain version of kernel #7, ``ops/kerr_cuda.py:march_kerr_plain``
  (through ``march_kerr_cuda`` on CPU tensors), against the Pallas kernel
  ``_kerr_kernel`` in interpret mode, whose arithmetic it transcribes:
  bare Kerr and Kerr-Newman, the disk tracker, the volumetric variants
  (tint with a tau_max freeze, blackbody, beaming on and off, scatter), an
  odd step cap and a NaN ray (sign 3): equal signs, steps and sides,
  states, hits, tau and emission within 1e-9.  A captured ray ends
  between the horizon and the capture radius, where phi and the momenta
  diverge as 1 / Delta (to ~2e7 in this bundle, whose captured rays then
  differ by up to a relative 1.5e-7): of those rays r and theta are
  compared (the JAX package's own kernel test compares escaped states
  only, tests/test_kerr.py:164);
- the scalar row's layout constants against ``ops/march_pallas.py``'s;
- ``render_kerr`` (bare, thin blackbody Doppler disk, volumetric,
  Kerr-Newman, starlit with one map passed to both),
  ``render_kerr_adaptive``, ``compute_kerr_starlight_map``,
  ``convert.metric_from_arrays`` and the CLI's Kerr ``image`` against the
  JAX package's XLA routes; ``render_kerr_frames_batched`` against the
  single-frame renders.

Images agree to 1e-8 except where a ray crosses the polar axis: there the
theta equation is stiff and the two frameworks' autodiff RHS round
differently, which one step can amplify (in the bare 24 x 16 view one
pixel, row 5 column 7, differs by 9.5e-8: its ray leaves through the axis
region at r ~ 1 400 in one far-field step).  So images are held to 1e-8 on
>= 99 % of pixels and 1e-6 on all.  Inputs are made with numpy from a
seed; the sizes are tiny (24 x 16 images, <= 128-ray bundles, short
escape radii) because tier-1 is near its time limit.
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
from curvis_tpu.geometry.rotations import frame_matrix as jax_frame_matrix
from curvis_tpu.metrics import kerr as jk
from curvis_tpu.ops import march_pallas as jmp
from curvis_tpu.physics import hamiltonian as jham
from curvis_tpu.render import kerr as jrk
from curvis_tpu.render import starlight as js
from curvis_tpu.render.disk import DiskParams as JaxDiskParams

from curvis_tpu_torch import convert
from curvis_tpu_torch.cli import main as port_cli
from curvis_tpu_torch.config.settings import MetricSettings
from curvis_tpu_torch.geometry.rotations import frame_matrix
from curvis_tpu_torch.metrics import kerr as tk
from curvis_tpu_torch.ops import disk_vol_cuda, kerr_cuda
from curvis_tpu_torch.physics import hamiltonian as tham
from curvis_tpu_torch.render import kerr as trk
from curvis_tpu_torch.render import starlight as ts
from curvis_tpu_torch.render.disk import DiskParams

F64 = torch.float64
TH = math.pi / 2 - 0.2               # the example's camera inclination
METRICS = {"kerr": dict(m=1.0, a=0.9), "kerr-newman": dict(m=1.0, a=0.7,
                                                           q=0.5)}
RENDER = dict(dt=0.35, max_steps=150, escape_radius=30.0)
BAND = dict(r_inner=2.6, r_outer=10.0)
TOL = 1e-9                           # march outputs, f64
METRIC_TOL = 1e-12
IMG_TOL = 1e-8                       # images, f64 ...
IMG_FRAC = 0.99                      # ... on this fraction of pixels
IMG_MAX = 1e-6                       # and everywhere (axis rays)


def _np(t):
    return t.detach().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _metric_pair(kind):
    params = METRICS[kind]
    jm = (jk.make_kerr(**params) if kind == "kerr"
          else jk.make_kerr_newman(**params))
    tm = convert.metric_from_arrays(
        kind, device="cpu", dtype=F64,
        **{k: np.asarray(getattr(jm, k), np.float64) for k in params})
    return jm, tm


def _camera_pair(r0=15.0, res=(24, 16), focal=24.0, phi=0.0):
    fwd = [-math.sin(TH) * math.cos(phi), -math.sin(TH) * math.sin(phi),
           -math.cos(TH)]
    jc = cv.make_camera([0.0, r0, TH, phi], fwd, [0.0, 0.0, 1.0], focal,
                        43.0, res[0], res[1], dtype=jnp.float64)
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        res[0], res[1], device="cpu", dtype=F64)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _sky():
    rng = np.random.default_rng(0)
    jb = cv.make_spherical_image(0.2 + 0.6 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    tb = convert.spherical_image_from_arrays(
        np.asarray(jb.texture), np.asarray(jb.rotation), device="cpu",
        dtype=F64)
    return jb, tb


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _images_close(want, got):
    d = np.abs(np.asarray(want) - _np(got)).max(-1)
    assert (d <= IMG_TOL).mean() >= IMG_FRAC, np.sort(d.ravel())[-5:]
    assert d.max() <= IMG_MAX, d.max()


# ------------------------------------------------------------ (a) metric

def _points():
    rng = np.random.default_rng(1)
    return np.stack([np.zeros(12), rng.uniform(2.5, 30.0, 12),
                     rng.uniform(0.2, math.pi - 0.2, 12),
                     rng.uniform(-3.0, 3.0, 12)], -1)


@pytest.mark.parametrize("kind", sorted(METRICS))
def test_metric_tetrad_and_spawn_match_jax_f64(kind):
    jm, tm = _metric_pair(kind)
    x = _points()
    xt = torch.tensor(x, dtype=F64)
    _close(jm.metric(jnp.asarray(x)), tm.metric(xt), METRIC_TOL)
    _close(jm.inverse_metric(jnp.asarray(x)), tm.inverse_metric(xt),
           METRIC_TOL)
    for a, b in zip(jm.inverse_components(jnp.asarray(x)),
                    tm.inverse_components(xt)):
        _close(a, b, METRIC_TOL)
    for name in ("horizon_radius", "capture_radius"):
        _close(getattr(jm, name), getattr(tm, name), METRIC_TOL)
    rng = np.random.default_rng(2)
    x0 = x.copy()
    x0[:, 1] += 4.0                      # outside the ergosphere
    d = rng.standard_normal((12, 3))
    want_tet = jax.vmap(lambda p: jham.static_tetrad(jm, p))(
        jnp.asarray(x0))
    _close(want_tet, tham.static_tetrad(tm, torch.tensor(x0)), METRIC_TOL)
    _close(jham.spawn_photon(jm, jnp.asarray(x0), jnp.asarray(d)),
           tham.spawn_photon(tm, torch.tensor(x0), torch.tensor(d)),
           METRIC_TOL)
    _close(jham.hamiltonian(jm, jnp.asarray(x0), jnp.asarray(d @ np.ones(
        (3, 4)))), tham.hamiltonian(tm, torch.tensor(x0), torch.tensor(
            d @ np.ones((3, 4)))), METRIC_TOL)
    _close(jax_frame_matrix(jnp.asarray(x[:, 2]), jnp.asarray(x[:, 3])),
           frame_matrix(xt[:, 2], xt[:, 3]), METRIC_TOL)
    r = np.linspace(2.0, 4.0, 9)
    for a, b in zip(jk.photon_shell_constants(jm, jnp.asarray(r)),
                    tk.photon_shell_constants(tm, torch.tensor(r))):
        _close(a, b, METRIC_TOL)
    for a, b in zip(jk.shadow_outline(jm, 1.2, n=64),
                    tk.shadow_outline(tm, 1.2, n=64)):
        a, b = np.asarray(a), _np(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(b, a, rtol=METRIC_TOL, atol=METRIC_TOL)
        assert np.isfinite(a).sum() > 10
    if kind == "kerr":
        for prograde in (True, False):
            _close(jm.critical_impact_parameter(prograde),
                   tm.critical_impact_parameter(prograde), METRIC_TOL)


def test_metric_tensor_parameters_keep_their_graph():
    """A spin passed as a tensor stays in its caller's graph, and the
    factories validate as the JAX package's do."""
    a = torch.tensor(0.6, dtype=F64, requires_grad=True)
    m = tk.KerrMetric(1.0, a, device="cpu", dtype=F64)
    m.horizon_radius.backward()
    assert a.grad is not None and float(a.grad) < 0.0
    with pytest.raises(ValueError, match="sub-extremal"):
        tk.make_kerr(1.0, 1.0, device="cpu")
    with pytest.raises(ValueError, match="sub-extremal"):
        tk.make_kerr_newman(1.0, 0.8, 0.7, device="cpu")


# ------------------------------------------------ (b) march_hamiltonian

@functools.lru_cache(maxsize=None)
def _bundle():
    """The 16-ray bundle of tests/test_kerr.py:164 (camera at r = 30)."""
    jm, _ = _metric_pair("kerr")
    rng = np.random.default_rng(0)
    n = 16
    ths = np.concatenate([np.full(8, np.pi / 2),
                          np.pi / 2 + 0.4 * rng.standard_normal(8)])
    x0 = np.stack([np.zeros(n), np.full(n, 30.0), ths, np.zeros(n)], -1)
    dirs = rng.standard_normal((n, 3))
    dirs[:, 0] = -np.abs(dirs[:, 0]) - 0.5
    d = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    p0 = np.asarray(jham.spawn_photon(jm, jnp.asarray(x0), jnp.asarray(d)))
    return x0, p0


def test_march_hamiltonian_matches_jax_f64():
    jm, tm = _metric_pair("kerr")
    x0, p0 = _bundle()
    kw = dict(dt=0.25, max_steps=20_000, escape_radius=40.0, far_r0=8.0)
    want = jham.march_hamiltonian(jm, jnp.asarray(x0), jnp.asarray(p0),
                                  capture_radius=float(jm.capture_radius),
                                  **kw)
    with torch.no_grad():
        got = tham.march_hamiltonian(tm, torch.tensor(x0), torch.tensor(p0),
                                     capture_radius=tm.capture_radius, **kw)
    np.testing.assert_array_equal(_np(got.sign), np.asarray(want.sign))
    np.testing.assert_array_equal(_np(got.steps), np.asarray(want.steps))
    esc = np.asarray(want.sign) == 1
    assert esc.sum() >= 8
    np.testing.assert_allclose(_np(got.x)[esc], np.asarray(want.x)[esc],
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_np(got.p)[esc], np.asarray(want.p)[esc],
                               rtol=1e-10, atol=1e-10)


# ------------------------------------- (c) kernel #7's plain version

@functools.lru_cache(maxsize=None)
def _view_rays(kind):
    """The spawned (x0, p0) of the 16 x 8 example view at r = 15, as numpy
    (128 rays: one Pallas tile)."""
    _, tm = _metric_pair(kind)
    _, tc = _camera_pair(res=(16, 8))
    x0, p0, _ = trk._spawn_kerr_rays(tm, tc)
    return _np(x0).copy(), _np(p0)


@functools.lru_cache(maxsize=None)
def _scatter_block():
    rng = np.random.default_rng(3)
    return np.concatenate([[1.0, 0.7, 0.4], 0.05 * rng.random(24)])


_VOL = dict(**BAND, volumetric=True, h_rel=0.07, kappa=3.0, doppler=True)
PLAIN_CASES = {
    # metric, march options, cap, NaN ray
    "kerr_nan": ("kerr", {}, 300, True),
    "kerr_newman": ("kerr-newman", {}, 300, False),
    "kerr_odd_cap": ("kerr", {}, 37, False),
    "disk": ("kerr", dict(disk=True), 300, False),
    "vol_tint_tau_max": ("kerr", dict(vol=dict(kappa=40.0)), 300, False),
    "vol_tint_no_beaming": ("kerr", dict(vol=dict(doppler=False,
                                                  redshift=False)), 300,
                            False),
    "vol_blackbody": ("kerr-newman", dict(vol=dict(color_mode="blackbody",
                                                   t_peak=6500.0)), 300,
                      False),
    "vol_blackbody_scatter": ("kerr", dict(vol=dict(color_mode="blackbody"),
                                           scatter=True), 300, False),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_kerr_plain_matches_pallas_interpret_f64(case):
    """march_kerr_cuda on CPU tensors (kernel #7's plain version) against
    the Pallas Kerr kernel in interpret mode."""
    kind, opts, cap, nan = PLAIN_CASES[case]
    jm, tm = _metric_pair(kind)
    x0, p0 = _view_rays(kind)
    x0 = x0.copy()
    if nan:
        x0[5, 1] = math.nan
    kw = dict(dt=0.25, max_steps=cap, escape_radius=30.0, far_r0=14.0)
    jkw, tkw = dict(kw), dict(kw)
    if opts.get("disk"):
        jkw["disk"] = tkw["disk"] = (BAND["r_inner"], BAND["r_outer"])
    if "vol" in opts:
        jkw["vol_disk"] = JaxDiskParams(**{**_VOL, **opts["vol"]})
        tkw["vol_disk"] = DiskParams(**{**_VOL, **opts["vol"]})
    if opts.get("scatter"):
        jkw["scatter_block"] = jnp.asarray(_scatter_block())
        tkw["scatter_block"] = torch.tensor(_scatter_block())
    want = jmp.march_kerr_pallas(jm, jnp.asarray(x0), jnp.asarray(p0),
                                 interpret=True, tile_rows=1, unroll=2,
                                 **jkw)
    got = kerr_cuda.march_kerr_cuda(tm, torch.tensor(x0), torch.tensor(p0),
                                    **tkw)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(_np(got[3]), np.asarray(want[3]))
    sign, steps = _np(got[2]), _np(got[3])
    live = sign <= 1                     # escaped or at the cap
    for a, b in zip(want[:2], got[:2]):
        a, b = np.asarray(a), _np(b)
        np.testing.assert_allclose(b[live], a[live], rtol=TOL, atol=TOL)
    # a captured ray's r and theta (its phi and momenta diverge there)
    cap_x = [np.asarray(want[0])[sign == 2, 1:3], _np(got[0])[sign == 2, 1:3]]
    np.testing.assert_allclose(cap_x[1], cap_x[0], rtol=TOL, atol=TOL)
    assert int(steps.max()) <= cap
    assert (steps[sign == 0] == cap).all()
    if cap < 100:
        assert (sign == 0).mean() > 0.5
    else:
        assert {1, 2} <= set(sign.tolist())
    if nan:
        assert sign[5] == 3 and steps[5] == 1
    if opts.get("disk"):
        for hw, hg in zip(want[4], got[4]):
            _close(hw[0], hg[0])
            _close(hw[1], hg[1])
            np.testing.assert_array_equal(_np(hg[2]), np.asarray(hw[2]))
        assert (_np(got[4][0][0]) != 0).sum() > 10
    if "vol" in opts:
        (tau_w, em_w), (tau_g, em_g) = want[4], got[4]
        _close(tau_w, tau_g)
        for a, b in zip(em_w, em_g):
            _close(a, b)
            assert np.isfinite(_np(b)).all()
        if opts["vol"].get("kappa", 0) > 10:
            frozen = (sign == 2) & (_np(got[0])[:, 1] > 2.0)
            assert frozen.sum() > 5


def test_kerr_scalar_row_layout_matches_jax():
    """The port's Kerr row is the JAX package's: the emission slots at
    VOL_BLOCK_KERR in VOL_SLOT order, the scatter block at
    KERR_SCATTER_OFF (a cheb-tail-like offset bug shipped twice in the JAX
    package, ops/march_pallas.py:48)."""
    assert kerr_cuda.VOL_BLOCK_KERR == jmp.VOL_BLOCK_KERR == 10
    assert kerr_cuda.KERR_SCATTER_OFF == jmp.KERR_SCATTER_OFF == 20
    assert disk_vol_cuda.SCATTER_BLOCK == jmp.SCATTER_BLOCK == 27
    assert disk_vol_cuda.SCATTER_DEG == jmp.SCATTER_DEG
    assert list(jmp.VOL_SLOT) == ["h2", "inv_norm", "kappa", "tau_max",
                                  "t_peak", "emis_q", "spin_sign", "t_scale"]
    assert [jmp.VOL_SLOT[k] for k in jmp.VOL_SLOT] == list(range(8))
    _, tm = _metric_pair("kerr-newman")
    over = dict(color_mode="blackbody", spin_sign=-1.0, tau_max=9.0)
    row = kerr_cuda.kerr_scalars(tm, 0.1, 40.0, vol_disk=DiskParams(
        **_VOL, **over), scatter_block=torch.tensor(_scatter_block()),
        far_r0=14.0)
    assert len(row) == 20 + 27
    np.testing.assert_allclose(row[:10], [0.1, 40.0, 1.0, 0.7, 0.25,
                                          float(tm.capture_radius), 2.6,
                                          10.0, 0.01, 14.0], rtol=1e-15)
    want = jmp._vol_param_slots(JaxDiskParams(**_VOL, **over))
    np.testing.assert_allclose(row[10:18], np.asarray(want, float),
                               rtol=1e-15)
    assert row[18:20] == [0.0, 0.0]
    np.testing.assert_allclose(row[20:], _scatter_block(), rtol=1e-15)
    assert len(kerr_cuda.kerr_scalars(tm, 0.1, 40.0)) == 10


# ------------------------------------------------------ (d) the renders

_THIN = dict(**BAND, doppler=True, color_mode="blackbody", t_peak=7000.0,
             brightness=14.0)
_GAS = dict(**BAND, volumetric=True, h_rel=0.07, kappa=3.0, doppler=True,
            color_mode="blackbody", t_peak=6500.0, brightness=14.0)
_STAR = dict(_THIN, brightness=10.0, starlight=True, albedo=(0.5, 0.5, 0.55))
_MAP = dict(**BAND, escape_radius=30.0, dt=0.35, max_steps=150, n_r=6,
            n_phi=8, n_samples=16, sample_filtering="bilinear")

RENDER_CASES = {
    # metric, disk fields, camera (r, focal)
    "bare": ("kerr", None, (15.0, 24.0)),
    "thin_blackbody": ("kerr", _THIN, (15.0, 24.0)),
    "volumetric": ("kerr", _GAS, (13.0, 28.0)),
    "kerr_newman_thin": ("kerr-newman", dict(_THIN, color_mode="tint"),
                         (15.0, 24.0)),
    "starlit": ("kerr", _STAR, (15.0, 24.0)),
}


@functools.lru_cache(maxsize=None)
def _maps():
    """One Kerr starlight map (orbit boost, self-shadow) from each package,
    and the JAX map carried across with convert.starlight_map."""
    jm, tm = _metric_pair("kerr")
    jb, tb = _sky()
    shadow = dict(**BAND, opacity=0.85)
    want = js.compute_kerr_starlight_map(
        jm, jb, boost="orbit", shadow_params=JaxDiskParams(**shadow),
        backend="xla", **_MAP)
    got = ts.compute_kerr_starlight_map(
        tm, tb, boost="orbit", shadow_params=DiskParams(**shadow), **_MAP)
    carried = convert.starlight_map(np.asarray(want.radii),
                                    np.asarray(want.values), device="cpu",
                                    dtype=F64)
    return want, got, carried


@functools.lru_cache(maxsize=None)
def _render_pair(case):
    kind, disk, (r0, focal) = RENDER_CASES[case]
    jm, tm = _metric_pair(kind)
    jb, tb = _sky()
    jc, tc = _camera_pair(r0, focal=focal)
    jkw, tkw = dict(RENDER), dict(RENDER)
    if disk is not None:
        jkw["disk"], tkw["disk"] = JaxDiskParams(**disk), DiskParams(**disk)
    if case == "starlit":
        want_map, _, carried = _maps()
        jkw["starlight_map"], tkw["starlight_map"] = want_map, carried
    want = np.asarray(jrk.render_kerr(jm, jc, jb, backend="xla", **jkw))
    with torch.no_grad():                # torch.func.grad still runs
        got = trk.render_kerr(tm, tc, tb, **tkw)
    return want, got


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_kerr_matches_jax_f64(case):
    want, got = _render_pair(case)
    assert got.shape == want.shape == (16, 24, 3)
    _images_close(want, got)
    if case == "volumetric":             # the gas covers the shadow
        assert want.max() > 0.5
    else:
        assert 0.01 < (want.sum(-1) == 0).mean() < 0.5       # the shadow
    if case not in ("bare", "volumetric"):
        bare = _render_pair("bare")[0]
        assert (np.abs(want - bare).max(-1) > 1e-3).mean() > 0.05


def test_render_kerr_frames_batched_matches_single_f64():
    _, tm = _metric_pair("kerr")
    _, tb = _sky()
    cams = [_camera_pair()[1], _camera_pair(16.0, phi=0.5)[1]]
    disk = DiskParams(**_THIN)
    kw = dict(RENDER, disk=disk)
    batch = trk.render_kerr_frames_batched(tm, cams, tb, **kw)
    assert batch.shape == (2, 16, 24, 3)
    for f, cam in enumerate(cams):
        single = (_render_pair("thin_blackbody")[1] if f == 0
                  else trk.render_kerr(tm, cam, tb, **kw))
        torch.testing.assert_close(batch[f], single, rtol=0, atol=1e-12)


def test_render_kerr_adaptive_matches_jax_f64():
    """The adaptive supersampler with a thin disk and a moving camera: the
    refined pixels and the untouched base pixels against JAX."""
    jm, tm = _metric_pair("kerr")
    jb, tb = _sky()
    jc, tc = _camera_pair()
    kw = dict(RENDER, refine_frac=0.1, supersample=2,
              camera_velocity=[0.0, 0.3, 0.0])
    want = np.asarray(jrk.render_kerr_adaptive(
        jm, jc, jb, disk=JaxDiskParams(**_THIN), backend="xla", **kw))
    got = trk.render_kerr_adaptive(tm, tc, tb, disk=DiskParams(**_THIN),
                                   **kw)
    assert got.shape == (16, 24, 3)
    _images_close(want, got)


def test_kerr_starlight_map_matches_jax_f64():
    want, got, _ = _maps()
    _close(want.radii, got.radii)
    assert got.values.shape == (2, 6, 8, 3)
    _close(want.values, got.values)
    assert float(got.values.max()) > 0.0


# ------------------------------------------- (e) convert, settings, CLI

def test_convert_and_settings_build_kerr_metrics():
    for kind, cls in (("kerr", tk.KerrMetric),
                      ("kerr-newman", tk.KerrNewmanMetric)):
        jm, tm = _metric_pair(kind)
        assert type(tm) is cls and tm.m.dtype == F64
        for f in cls.fields:
            assert float(getattr(tm, f)) == float(getattr(jm, f))
    kn = convert.metric_from_arrays("kn", m=np.asarray(1.0),
                                    a=np.asarray(0.5), q=np.asarray(0.3),
                                    device="cpu")
    assert type(kn) is tk.KerrNewmanMetric
    with pytest.raises(ValueError, match="takes parameters"):
        convert.metric_from_arrays("kerr", m=np.asarray(1.0), device="cpu")
    m = MetricSettings(kind="kerr", m=1.0, a=0.5).make(device="cpu")
    assert type(m) is tk.KerrMetric and float(m.a) == 0.5
    m = MetricSettings(kind="kn", m=1.0, a=0.5, q=0.3).make(device="cpu")
    assert type(m) is tk.KerrNewmanMetric and float(m.q) == pytest.approx(
        0.3)


@pytest.fixture()
def kerr_scene(tmp_path):
    """Two tiny skies and the settings TOMLs of a Kerr view."""
    rng = np.random.default_rng(0)
    for name in ("bg1.png", "bg2.png"):
        arr = (40 + rng.random((16, 32, 3)) * 120).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / name)
    (tmp_path / "cam.toml").write_text(
        "resolution_x = 24\nresolution_y = 16\n"
        "diagonal = 43.0\nfocal_length = 24.0\n")
    (tmp_path / "sim.toml").write_text(
        "escape_radius = 30.0\nray_integration_max_iterations = 150\n"
        "ray_integration_step = 0.35\n")
    (tmp_path / "metric.toml").write_text('kind = "kerr"\nm = 1.0\na = 0.9\n')
    (tmp_path / "img.toml").write_text(
        f"l = 15.0\ntheta = {TH!r}\nphi = 0.0\n"
        f"forward_x = {-math.sin(TH)!r}\nforward_y = 0.0\n"
        f"forward_z = {-math.cos(TH)!r}\n")
    return tmp_path


def test_cli_kerr_image_matches_jax_cli(kerr_scene):
    """``image`` with a Kerr metric and a thin blackbody disk under the
    default (symmetric) renderer and Euler stepper, which the JAX CLI
    takes as the RK4 Kerr march: the JAX CLI's PNG to 8-bit rounding."""
    d = kerr_scene

    def args(out):
        return ["image", str(d / "bg1.png"), str(d / "bg2.png"),
                str(d / out), "-m", str(d / "metric.toml"), "-c",
                str(d / "cam.toml"), "-s", str(d / "sim.toml"), "-i",
                str(d / "img.toml"), "--f64", "--filtering", "bilinear",
                "--disk", "--disk-color", "blackbody"]

    assert jax_cli(args("jax")) == 0
    assert port_cli(args("port")) == 0
    a = np.asarray(Image.open(d / "jax" / "output_image.png")).astype(int)
    b = np.asarray(Image.open(d / "port" / "output_image.png")).astype(int)
    assert a.shape == b.shape == (16, 24, 3)
    assert (np.abs(a - b).max(-1) <= 1).mean() >= 0.99
    assert (b.sum(-1) == 0).mean() > 0.01             # the shadow


def test_unported_kerr_options_raise():
    """Every Kerr route runs: the differentiable backends with either
    stepper, bare, with a thin or a volumetric disk and with disk_theta
    (their gradients: tests/test_torch_kerr_adjoint.py,
    test_torch_kerr_rk45_adjoint.py, test_torch_kerr_surface_adjoint.py,
    test_torch_kerr_rk45_surface_adjoint.py), and disk_theta on the
    non-differentiable routes; unknown options raise ValueError; the
    starlight map marches without gradients under either backend."""
    _, tm = _metric_pair("kerr")
    _, tb = _sky()
    _, tc = _camera_pair(res=(4, 2))
    kw = dict(dt=0.25, max_steps=5, escape_radius=30.0)
    calls = (lambda **k: trk.render_kerr(tm, tc, tb, **k),
             lambda **k: trk.render_kerr_frames_batched(tm, [tc], tb, **k),
             lambda **k: trk.render_kerr_adaptive(tm, tc, tb, **k))
    thin, gas = DiskParams(**_THIN), DiskParams(**_GAS)
    theta = {"kappa": torch.tensor(2.0, dtype=torch.float64),
             "brightness": torch.tensor(0.9, dtype=torch.float64)}
    for call in calls:
        for stepper in ("rk4", "rk45"):
            for backend in ("auto", "scan", "adjoint"):
                if backend != "auto":
                    img = call(stepper=stepper, backend=backend, **kw)
                    assert bool(torch.isfinite(img).all())
                for disk in (thin, gas):
                    img = call(stepper=stepper, backend=backend, disk=disk,
                               disk_theta=theta, **kw)
                    assert bool(torch.isfinite(img).all())
        with pytest.raises(ValueError, match="backend"):
            call(backend="pallas", **kw)
        with pytest.raises(ValueError, match="stepper"):
            call(stepper="euler", **kw)
    for backend in ("scan", "adjoint"):
        smap = ts.compute_kerr_starlight_map(
            tm, tb, r_inner=3.0, r_outer=9.0, stepper="rk45",
            backend=backend, n_r=4, n_phi=8, n_samples=8, **kw)
        assert bool(torch.isfinite(smap.values).all())
    with pytest.raises(ValueError, match="OR vol_disk"):
        kerr_cuda.kerr_scalars(tm, 0.1, 30.0, disk=(3.0, 9.0),
                               vol_disk=DiskParams(volumetric=True))
    disk = dataclasses.replace(DiskParams(**_GAS), starlight=True)
    with pytest.raises(ValueError, match="starlight_map"):
        trk.render_kerr(tm, tc, tb, disk=disk, **kw)
