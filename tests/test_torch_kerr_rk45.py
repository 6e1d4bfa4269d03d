"""PyTorch port vs the JAX package: the Kerr / Kerr-Newman DP5(4) path, on
the CPU, in float64.

Held against their JAX counterparts on the same numpy inputs:

- (a) the scalar row of kernel #8 (``ops/kerr_rk45_cuda.py:
  kerr_rk45_scalars``) against the row ``march_kerr_rk45_pallas`` builds,
  for the bare, disk, volumetric and volumetric + scatter marches: 12, 12,
  20 and 47 floats with (dt_max, dt_min) at 10-11 or 18-19 (a cheb-tail
  offset bug shipped twice in the JAX package, ops/march_pallas.py:48);
- (b) the plain version of kernel #8, ``march_kerr_rk45_plain`` (through
  ``march_kerr_rk45_cuda`` on CPU tensors), against the Pallas kernel
  ``_kerr_rk45_kernel`` in interpret mode, whose arithmetic it
  transcribes: bare Kerr and Kerr-Newman, the disk tracker, the
  volumetric variants (tint, blackbody with beaming, scatter, a tau_max
  freeze), a step cap, a small odd max_iters, NaN rays and a ray parked on
  the escape radius.  Signs, accepted steps and iterations are equal;
  hits, tau, emission and the states of escaped rays, of rays frozen at
  tau_max and of rays stopped by a cap are within TOL = 1e-9.  Two kinds
  of ray are held to EDGE_TOL = 1e-7, because an ulp between XLA's and
  PyTorch's sin and cos (the two agree to 3e-14 after two iterations)
  grows fast there: a captured ray, in r and theta (its phi and momenta
  diverge as 1 / Delta between the horizon and the capture radius; in
  the volumetric cases, whose steps are clamped near the gas, r differs
  by up to 2.4e-8 at capture), and a ray stopped inside the polar band
  sin^2 theta < 0.01, where the theta equation is stiff (one ray of this
  view, stopped at theta = 3.10 after 22 iterations, differs by 1.3e-8
  in p_theta);
- (c) the bare route's CPU march, ``integrate/rk45.py:march_kerr_rk45``
  (the autodiff twin), against the JAX package's XLA twin with
  ``return_iters``, for Kerr and Kerr-Newman: equal signs, steps and
  iterations, escaped states within TOL;
- (d) ``render_kerr(stepper='rk45')`` (bare through the twin; thin,
  volumetric, starlit, scatter and Kerr-Newman through the plain version
  of #8) against the JAX package's renders, ``render_kerr_adaptive``
  against JAX, ``compute_kerr_starlight_map(stepper='rk45')`` against JAX
  with bilinear per-sample lookups (nearest lookups move at texel seams
  between a jitted and an eager JAX map), and
  ``render_kerr_frames_batched`` against single frames;
- (e) the CLI's ``image --stepper rk45`` with a Kerr TOML against the JAX
  CLI, to 8-bit rounding.

Images agree to IMG_TOL = 1e-8 on >= 99 % of pixels and IMG_MAX = 1e-6
on all, the tolerances of tests/test_torch_kerr.py (rays through the polar
axis region round differently between the two frameworks' autodiff
RHS).  Inputs are made with numpy from a seed; the sizes are tiny (24 x 16
images, 128-ray bundles, escape radius 30) because tier-1 is near its
time limit.
"""
import functools
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import curvis_tpu as cv
from curvis_tpu.cli import main as jax_cli
from curvis_tpu.integrate.rk45 import march_kerr_rk45 as jax_twin
from curvis_tpu.metrics import kerr as jk
from curvis_tpu.ops import march_pallas as jmp
from curvis_tpu.render import kerr as jrk
from curvis_tpu.render import starlight as js
from curvis_tpu.render.disk import DiskParams as JaxDiskParams

from curvis_tpu_torch import convert
from curvis_tpu_torch.cli import main as port_cli
from curvis_tpu_torch.integrate.rk45 import march_kerr_rk45
from curvis_tpu_torch.ops import kerr_rk45_cuda as kr
from curvis_tpu_torch.physics import hamiltonian as tham
from curvis_tpu_torch.render import kerr as trk
from curvis_tpu_torch.render import starlight as ts
from curvis_tpu_torch.render.disk import DiskParams

F64 = torch.float64
TH = math.pi / 2 - 0.2               # the example's camera inclination
METRICS = {"kerr": dict(m=1.0, a=0.9), "kerr-newman": dict(m=1.0, a=0.7,
                                                           q=0.5)}
R_ESC = 30.0
MARCH = dict(dt0=0.25, escape_radius=R_ESC, rtol=1e-4, atol=1e-7)
RENDER = dict(dt=0.35, max_steps=150, escape_radius=R_ESC, stepper="rk45")
BAND = dict(r_inner=2.6, r_outer=10.0)
TOL = 1e-9                           # march outputs
EDGE_TOL = 1e-7                      # captured rays, rays stopped at the axis
AXIS_U = 0.01                        # the polar band: sin^2 theta below this
IMG_TOL = 1e-8                       # images ...
IMG_FRAC = 0.99                      # ... on this fraction of pixels
IMG_MAX = 1e-6                       # and everywhere


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


@functools.lru_cache(maxsize=None)
def _scatter_block():
    rng = np.random.default_rng(3)
    return np.concatenate([[1.0, 0.7, 0.4], 0.05 * rng.random(24)])


_VOL = dict(**BAND, volumetric=True, h_rel=0.07, kappa=3.0, doppler=True)


def _march_kwargs(opts):
    """The (JAX, port) keyword arguments of a case's disk options."""
    jkw, tkw = {}, {}
    if opts.get("disk"):
        jkw["disk"] = tkw["disk"] = (BAND["r_inner"], BAND["r_outer"])
    if "vol" in opts:
        jkw["vol_disk"] = JaxDiskParams(**{**_VOL, **opts["vol"]})
        tkw["vol_disk"] = DiskParams(**{**_VOL, **opts["vol"]})
    if opts.get("scatter"):
        jkw["scatter_block"] = jnp.asarray(_scatter_block())
        tkw["scatter_block"] = torch.tensor(_scatter_block())
    return jkw, tkw


# ------------------------------------------------------ (a) scalar row

ROW_CASES = {
    # disk options, row length, slot of (dt_max, dt_min)
    "bare": ({}, 12, 10),
    "disk": (dict(disk=True), 12, 10),
    "vol": (dict(vol=dict(color_mode="blackbody", spin_sign=-1.0)), 20, 18),
    "vol_scatter": (dict(vol={}, scatter=True), 47, 18),
}


class _RowSeen(Exception):
    pass


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_kerr_rk45_scalar_row_matches_jax(case, monkeypatch):
    """The row kerr_rk45_scalars builds is the one the JAX wrapper hands
    its Pallas kernel (caught at the call, before any march)."""
    opts, length, bounds = ROW_CASES[case]
    jm, tm = _metric_pair("kerr-newman")
    x0, p0 = _view_rays("kerr-newman")
    jkw, tkw = _march_kwargs(opts)
    seen = {}

    def spy(params, *args, **kw):
        seen["row"] = np.asarray(params).reshape(-1)
        raise _RowSeen

    monkeypatch.setattr(jmp, "_kerr_rk45_flat_arrays", spy)
    with pytest.raises(_RowSeen):
        jmp.march_kerr_rk45_pallas(jm, jnp.asarray(x0), jnp.asarray(p0),
                                   **MARCH, **jkw)
    row = kr.kerr_rk45_scalars(tm, MARCH["dt0"], R_ESC, rtol=1e-4,
                               atol=1e-7, dt_min=1e-5, dt_max=R_ESC / 8.0,
                               **tkw)
    assert kr.KERR_RK45_BOUNDS == jmp.KERR_RK45_BOUNDS
    assert len(row) == len(seen["row"]) == length
    np.testing.assert_allclose(row, seen["row"], rtol=1e-15, atol=0)
    assert row[bounds:bounds + 2] == [R_ESC / 8.0, 1e-5]
    assert row[8:10] == [1e-4, 1e-7]
    assert kr.default_max_iters(13) == 52 and kr.default_max_iters(13, 21) \
        == 22


def test_kerr_rk45_wrapper_refusals():
    """kerr_rk45_scalars refuses disk and vol_disk together, a scatter block
    without vol_disk or of the wrong length; the wrapper refuses rays on
    another device than the metric's."""
    _, tm = _metric_pair("kerr")
    kw = dict(rtol=1e-4, atol=1e-7, dt_min=1e-5, dt_max=1.0)
    gas = DiskParams(**_VOL)
    with pytest.raises(ValueError, match="OR vol_disk"):
        kr.kerr_rk45_scalars(tm, 0.1, R_ESC, disk=(3.0, 9.0), vol_disk=gas,
                             **kw)
    with pytest.raises(ValueError, match="needs vol_disk"):
        kr.kerr_rk45_scalars(tm, 0.1, R_ESC, scatter_block=torch.zeros(27),
                             **kw)
    with pytest.raises(ValueError, match="not 27"):
        kr.kerr_rk45_scalars(tm, 0.1, R_ESC, vol_disk=gas,
                             scatter_block=torch.zeros(5), **kw)
    meta = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="one device"):
        kr.march_kerr_rk45_cuda(tm, meta, meta, escape_radius=R_ESC)


# ------------------------------------- (b) kernel #8's plain version

@functools.lru_cache(maxsize=None)
def _view_rays(kind):
    """The spawned (x0, p0) of the 16 x 8 example view at r = 15, as numpy
    (128 rays: one Pallas tile)."""
    _, tm = _metric_pair(kind)
    _, tc = _camera_pair(res=(16, 8))
    x0, p0, _ = trk._spawn_kerr_rays(tm, tc)
    return _np(x0).copy(), _np(p0).copy()


def _rays(kind, special):
    """The view's rays, with 2 NaN rays or 8 rays parked exactly on the
    escape radius looking outward (tests/test_kerr.py:655-685) swapped
    in; the bundle keeps its 128 rays (one compile for the bare cases)."""
    x0, p0 = (a.copy() for a in _view_rays(kind))
    if special == "nan":
        x0[5, 1] = math.nan
        p0[77, 2] = math.nan
    elif special == "parked":
        _, tm = _metric_pair(kind)
        xp = np.tile([0.0, R_ESC, TH, 0.0], (8, 1))
        d = np.tile(np.asarray([1.0, 0.3, 0.1]) / np.linalg.norm(
            [1.0, 0.3, 0.1]), (8, 1))
        x0[:8] = xp
        p0[:8] = _np(tham.spawn_photon(tm, torch.tensor(xp),
                                       torch.tensor(d)))
    return x0, p0


PLAIN_CASES = {
    # metric, disk options, max_steps, max_iters, swapped-in rays
    "kerr": ("kerr", {}, 300, None, None),
    "kerr_newman": ("kerr-newman", {}, 300, None, None),
    "nan_rays": ("kerr", {}, 300, None, "nan"),
    "boundary_parked": ("kerr", {}, 300, None, "parked"),
    "step_cap": ("kerr", {}, 13, None, None),
    "odd_max_iters": ("kerr", {}, 300, 21, None),
    "disk": ("kerr", dict(disk=True), 300, None, None),
    "vol_tint": ("kerr", dict(vol=dict(doppler=False)), 300, None, None),
    "vol_tau_max": ("kerr", dict(vol=dict(doppler=False, kappa=40.0)), 300,
                    None, None),
    "vol_blackbody_beaming": ("kerr-newman",
                              dict(vol=dict(color_mode="blackbody",
                                            t_peak=6500.0)), 300, None,
                              None),
    "vol_scatter": ("kerr", dict(vol=dict(color_mode="blackbody"),
                                 scatter=True), 300, None, None),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_kerr_rk45_plain_matches_pallas_interpret_f64(case):
    """march_kerr_rk45_cuda on CPU tensors (kernel #8's plain version)
    against the Pallas Kerr DP5(4) kernel in interpret mode."""
    kind, opts, cap, max_iters, special = PLAIN_CASES[case]
    jm, tm = _metric_pair(kind)
    x0, p0 = _rays(kind, special)
    jkw, tkw = _march_kwargs(opts)
    kw = dict(MARCH, max_steps=cap, max_iters=max_iters, return_iters=True)
    want = jmp.march_kerr_rk45_pallas(jm, jnp.asarray(x0), jnp.asarray(p0),
                                      interpret=True, tile_rows=1, **kw,
                                      **jkw)
    got = kr.march_kerr_rk45_cuda(tm, torch.tensor(x0), torch.tensor(p0),
                                  **kw, **tkw)
    assert len(got) == len(want)
    for a, b in zip((want[2], want[3], want[-1]), (got[2], got[3], got[-1])):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    sign, steps, iters = _np(got[2]), _np(got[3]), _np(got[-1])
    x = _np(got[0])
    axis = np.sin(x[:, 2]) ** 2 < AXIS_U
    captured = (sign == 2) & (x[:, 1] < float(tm.capture_radius))
    whole = ((sign == 1) | ((sign == 2) & ~captured)
             | ((sign == 0) & ~axis), (sign == 0) & axis)
    for rows, tol in zip(whole, (TOL, EDGE_TOL)):
        for a, b in zip(want[:2], got[:2]):
            np.testing.assert_allclose(_np(b)[rows], np.asarray(a)[rows],
                                       rtol=tol, atol=tol)
    np.testing.assert_allclose(x[captured, 1:3],
                               np.asarray(want[0])[captured, 1:3],
                               rtol=EDGE_TOL, atol=EDGE_TOL)
    mi = kr.default_max_iters(cap, max_iters)
    assert int(steps.max()) <= cap and int(iters.max()) <= mi
    assert (iters >= steps).all()
    assert (steps[(sign == 0) & (iters < mi)] == cap).all()
    if case == "step_cap":
        assert (steps == cap).mean() > 0.5
    elif case == "odd_max_iters":
        assert mi == 22 and ((iters == mi) & (sign == 0)).sum() > 10
    else:
        assert {1, 2} <= set(sign.tolist())
    if special == "nan":
        assert sign[5] == sign[77] == 3 and steps[5] == steps[77] == 0
    if special == "parked":
        assert (sign[:8] == 1).all() and (steps[:8] == 1).all()
        assert (_np(got[0])[:8, 1] <= R_ESC * (1 + 1e-3)).all()
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
        assert float(_np(tau_g).max()) > 0.1
        if opts["vol"].get("kappa", 0) > 10:
            frozen = (sign == 2) & (_np(got[0])[:, 1] > 2.0)
            assert frozen.sum() > 5


# ------------------------------------------- (c) the autodiff twin

@pytest.mark.parametrize("kind", sorted(METRICS))
def test_march_kerr_rk45_twin_matches_jax_f64(kind):
    jm, tm = _metric_pair(kind)
    x0, p0 = _view_rays(kind)
    kw = dict(MARCH, max_steps=300, return_iters=True)
    want, want_it = jax_twin(jm, jnp.asarray(x0), jnp.asarray(p0),
                             capture_radius=float(jm.capture_radius), **kw)
    with torch.no_grad():
        got, got_it = march_kerr_rk45(tm, torch.tensor(x0), torch.tensor(p0),
                                      capture_radius=tm.capture_radius, **kw)
    for a, b in ((want.sign, got.sign), (want.steps, got.steps),
                 (want_it, got_it)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    esc = np.asarray(want.sign) == 1
    assert esc.sum() > 60 and (np.asarray(want.sign) == 2).sum() > 5
    for a, b in ((want.x, got.x), (want.p, got.p)):
        np.testing.assert_allclose(_np(b)[esc], np.asarray(a)[esc],
                                   rtol=TOL, atol=TOL)


# ------------------------------------------------------ (d) the renders

_THIN = dict(**BAND, doppler=True, color_mode="blackbody", t_peak=7000.0,
             brightness=14.0)
_GAS = dict(**BAND, volumetric=True, h_rel=0.07, kappa=3.0, doppler=True,
            color_mode="blackbody", t_peak=6500.0, brightness=14.0)
_STAR = dict(_THIN, brightness=10.0, starlight=True, albedo=(0.5, 0.5, 0.55))
_SCATTER = dict(_GAS, brightness=8.0, starlight=True,
                albedo=(0.45, 0.45, 0.5), starlight_scatter=0.4)
_MAP = dict(**BAND, escape_radius=R_ESC, dt=0.35, max_steps=150, n_r=6,
            n_phi=8, n_samples=16, sample_filtering="bilinear",
            stepper="rk45")

RENDER_CASES = {
    # metric, disk fields, camera (r, focal)
    "bare": ("kerr", None, (15.0, 24.0)),
    "thin_blackbody": ("kerr", _THIN, (15.0, 24.0)),
    "volumetric": ("kerr", _GAS, (13.0, 28.0)),
    "kerr_newman_thin": ("kerr-newman", dict(_THIN, color_mode="tint"),
                         (15.0, 24.0)),
    "starlit": ("kerr", _STAR, (15.0, 24.0)),
    "scatter": ("kerr", _SCATTER, (13.0, 28.0)),
}


@functools.lru_cache(maxsize=None)
def _maps():
    """One rk45 Kerr starlight map (orbit boost, self-shadow) from each
    package, and the JAX map carried across with convert.starlight_map."""
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
    if disk is not None and disk.get("starlight"):
        want_map, _, carried = _maps()
        jkw["starlight_map"], tkw["starlight_map"] = want_map, carried
    want = np.asarray(jrk.render_kerr(jm, jc, jb, backend="xla", **jkw))
    with torch.no_grad():                # torch.func.grad still runs
        got = trk.render_kerr(tm, tc, tb, **tkw)
    return want, got


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_kerr_rk45_matches_jax_f64(case):
    want, got = _render_pair(case)
    assert got.shape == want.shape == (16, 24, 3)
    _images_close(want, got)
    if RENDER_CASES[case][1] is not None and \
            RENDER_CASES[case][1].get("volumetric"):
        assert want.max() > 0.5          # the gas covers the shadow
    else:
        assert 0.01 < (want.sum(-1) == 0).mean() < 0.5       # the shadow
    if case not in ("bare", "volumetric"):
        base = _render_pair("volumetric" if case == "scatter"
                            else "bare")[0]
        assert (np.abs(want - base).max(-1) > 1e-3).mean() > 0.05


def test_render_kerr_rk45_frames_batched_matches_single_f64():
    _, tm = _metric_pair("kerr")
    _, tb = _sky()
    cams = [_camera_pair()[1], _camera_pair(16.0, phi=0.5)[1]]
    kw = dict(RENDER, disk=DiskParams(**_THIN))
    batch = trk.render_kerr_frames_batched(tm, cams, tb, **kw)
    assert batch.shape == (2, 16, 24, 3)
    for f, cam in enumerate(cams):
        single = (_render_pair("thin_blackbody")[1] if f == 0
                  else trk.render_kerr(tm, cam, tb, **kw))
        torch.testing.assert_close(batch[f], single, rtol=0, atol=1e-12)


def test_render_kerr_rk45_adaptive_matches_jax_f64():
    """The adaptive supersampler with the bare shadow (both marches through
    the twin) and a moving camera, against JAX."""
    jm, tm = _metric_pair("kerr")
    jb, tb = _sky()
    jc, tc = _camera_pair()
    kw = dict(RENDER, refine_frac=0.1, supersample=2,
              camera_velocity=[0.0, 0.3, 0.0])
    want = np.asarray(jrk.render_kerr_adaptive(jm, jc, jb, backend="xla",
                                               **kw))
    got = trk.render_kerr_adaptive(tm, tc, tb, **kw)
    assert got.shape == (16, 24, 3)
    _images_close(want, got)


def test_kerr_rk45_starlight_map_matches_jax_f64():
    want, got, _ = _maps()
    _close(want.radii, got.radii)
    assert got.values.shape == (2, 6, 8, 3)
    _close(want.values, got.values)
    assert float(got.values.max()) > 0.0


# ------------------------------------------------------------ (e) CLI

def test_cli_kerr_rk45_image_matches_jax_cli(tmp_path):
    """``image --stepper rk45`` with a Kerr metric TOML and a thin
    blackbody disk: the JAX CLI's PNG to 8-bit rounding."""
    rng = np.random.default_rng(0)
    for name in ("bg1.png", "bg2.png"):
        arr = (40 + rng.random((16, 32, 3)) * 120).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / name)
    (tmp_path / "cam.toml").write_text(
        "resolution_x = 24\nresolution_y = 16\n"
        "diagonal = 43.0\nfocal_length = 24.0\n")
    (tmp_path / "sim.toml").write_text(
        f"escape_radius = {R_ESC}\nray_integration_max_iterations = 150\n"
        "ray_integration_step = 0.35\n")
    (tmp_path / "metric.toml").write_text(
        'kind = "kerr"\nm = 1.0\na = 0.9\n')
    (tmp_path / "img.toml").write_text(
        f"l = 15.0\ntheta = {TH!r}\nphi = 0.0\n"
        f"forward_x = {-math.sin(TH)!r}\nforward_y = 0.0\n"
        f"forward_z = {-math.cos(TH)!r}\n")

    def args(out):
        return ["image", str(tmp_path / "bg1.png"),
                str(tmp_path / "bg2.png"), str(tmp_path / out), "-m",
                str(tmp_path / "metric.toml"), "-c",
                str(tmp_path / "cam.toml"), "-s", str(tmp_path / "sim.toml"),
                "-i", str(tmp_path / "img.toml"), "--f64", "--filtering",
                "bilinear", "--stepper", "rk45", "--disk", "--disk-color",
                "blackbody"]

    assert jax_cli(args("jax")) == 0
    assert port_cli(args("port")) == 0
    a = np.asarray(Image.open(tmp_path / "jax" / "output_image.png"))
    b = np.asarray(Image.open(tmp_path / "port" / "output_image.png"))
    assert a.shape == b.shape == (16, 24, 3)
    assert (np.abs(a.astype(int) - b.astype(int)).max(-1) <= 1).mean() \
        >= 0.99
    assert (b.astype(int).sum(-1) == 0).mean() > 0.01     # the shadow
