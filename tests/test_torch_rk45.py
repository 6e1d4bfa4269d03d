"""PyTorch port vs the JAX package: the adaptive DP5(4) (rk45) render path,
on the CPU.

Three marches are held against their JAX counterparts:

- ``integrate/rk45.py:march_planar_rk45`` (the CPU route of
  ``render_planar_fast(stepper='rk45')``) against the JAX XLA march of the
  same name, in f64;
- ``ops/rk45_cuda.py:march_planar_rk45_plain``, the plain version of the
  CUDA kernel ``csrc/planar_rk45.cu``, against the Pallas kernel
  ``march_planar_rk45_pallas`` in interpret mode.  The kernel's arithmetic
  (error |dt (d5 - d4)|, factor exp(-0.2 log err), writeback y + a frac
  (y5 - y)) is not the XLA march's, and the ulps between the two flip
  knife-edge accepts, so it is not held against the XLA march;
- ``render_planar_fused_plain(stepper='rk45')``, the plain version of the
  fused CUDA kernel, against the Pallas fused rk45 kernel in interpret mode.

Metric, camera and sky parameters cross the boundary through the existing
``curvis_tpu_torch.convert`` functions (``metric_from_arrays``,
``camera_from_arrays``, ``spherical_image_from_arrays``): the rk45 path
needs no converter of its own.  Inputs are made with numpy from a seed.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import curvis_tpu as cv
from curvis_tpu.integrate.rk45 import march_planar_rk45 as jax_rk45
from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
from curvis_tpu.ops.render_fused import render_planar_fused as jax_fused
from curvis_tpu.physics import planar as jpl
from curvis_tpu.render import fast as jfast

from curvis_tpu_torch import convert
from curvis_tpu_torch.cli import main as port_cli
from curvis_tpu_torch.env.spherical_image import load_spherical_image
from curvis_tpu_torch.integrate.rk45 import march_planar_rk45
from curvis_tpu_torch.metrics.base import make_metric
from curvis_tpu_torch.ops import render_fused
from curvis_tpu_torch.ops.rk45_cuda import (march_planar_rk45_cuda,
                                            march_planar_rk45_plain,
                                            rk45_scalars)
from curvis_tpu_torch.physics import planar as tpl
from curvis_tpu_torch.render import fast as tfast

PARAMS = {"ellis": dict(rho=1.0), "interstellar": dict(m=0.1, a=0.5, rho=1.0),
          "schwarzschild": dict(m=1.0)}
L0 = {"ellis": 5.0, "interstellar": 5.0, "schwarzschild": 15.0}
TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def _metric_pair(kind, dtype):
    jm = jax.tree.map(lambda x: x.astype(dtype),
                      cv.make_metric(kind, **PARAMS[kind]))
    tm = convert.metric_from_arrays(
        kind, device="cpu", dtype=TDTYPE[dtype],
        **{k: np.asarray(getattr(jm, k)) for k in PARAMS[kind]})
    return jm, tm


def _camera_pair(l0, forward, res, dtype, phi=0.0):
    jc = cv.make_camera([0.0, l0, np.pi / 2, phi], forward, [0.0, 0.0, 1.0],
                        15.0, 43.0, res[0], res[1], dtype=jnp.dtype(dtype))
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        jc.resolution_x, jc.resolution_y, device="cpu", dtype=TDTYPE[dtype])
    return jc, tc


def _ray_pair(kind, dtype, forward=(-1.0, 0.1, 0.05), res=(16, 8)):
    """(JAX metric, port metric, JAX rays, port rays, readout): the pixel
    rays of a camera, spawned in f64 by the port and cast to dtype, the
    same values on both sides.  ``readout(res)`` is a march result's escape
    directions (port readout, f64 numpy), for results of either package."""
    jm, tm = _metric_pair(kind, dtype)
    tm64 = make_metric(kind, device="cpu", dtype=torch.float64,
                       **PARAMS[kind])
    _, tc = _camera_pair(L0[kind], list(forward), res, np.float64)
    state, r_hat, e2 = tfast._spawn_frames(tm64, [tc])
    tr = tpl.PlanarRays(*(t.to(TDTYPE[dtype]) for t in state), None, None)
    zeros = jnp.zeros((1, 3), dtype)
    jr = jpl.PlanarRays(*(jnp.asarray(_np(t)) for t in tr[:4]), zeros, zeros)

    def readout(res):
        res = tpl.PlanarResult(*(torch.from_numpy(np.array(a, np.float64))
                                 if not torch.is_tensor(a) else a.double()
                                 for a in res))
        return np.stack([_np(c) for c in tfast._readout(
            tm64, res, state[3], r_hat, e2)], -1)
    return jm, tm, jr, tr, readout


def _angles(a, b):
    """Angle between rows of two direction arrays (atan2: accurate at 0)."""
    return np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1),
                      (a * b).sum(-1))


def _np(t):
    return t.detach().cpu().numpy()


def _smooth_skies(dtype):
    yy, xx = np.mgrid[0:32, 0:64]
    smooth = np.stack([np.sin(2 * np.pi * xx / 64) * 0.5 + 0.5, yy / 32,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / 32)], -1)
    out = []
    for tex in (smooth, smooth[::-1].copy()):
        js = cv.make_spherical_image(tex.astype(dtype),
                                     dtype=jnp.dtype(dtype))
        ts = convert.spherical_image_from_arrays(
            np.asarray(js.texture), np.asarray(js.rotation), device="cpu",
            dtype=TDTYPE[dtype])
        out.append((js, ts))
    return out


# ------------------------------------------------ module 1: the XLA march

@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_march_rk45_matches_jax_f64(kind):
    """Signs equal, accepted steps within 1 and escape directions within
    1e-6 rad of the JAX XLA march (f64, its defaults rtol 1e-6, atol
    1e-9).  DNEG's accepts differ by one step on a few rays: its |l| and
    atan rounding differ at the ulp level between the two packages."""
    jm, tm, jr, tr, readout = _ray_pair(kind, np.float64)
    kw = dict(escape_radius=30.0, max_steps=400)
    want = jax_rk45(jm, jr, **kw)
    got = march_planar_rk45(tm, tr, **kw)
    np.testing.assert_array_equal(_np(got.sign), np.asarray(want.sign))
    assert np.abs(_np(got.steps) - np.asarray(want.steps)).max() <= 1
    ang = _angles(readout(want), readout(got))
    esc = np.abs(np.asarray(want.sign)) == 1
    assert esc.any() and ang[esc].max() < 1e-6
    if kind == "schwarzschild":
        assert (np.asarray(want.sign) == 2).any()      # captured rays too


def test_march_rk45_escape_lands_on_radius():
    """Escaping steps are interpolated onto |l| = R."""
    _, tm, _, tr, _ = _ray_pair("ellis", np.float64,
                                forward=(1.0, 0.3, 0.1), res=(8, 6))
    res = march_planar_rk45(tm, tr, escape_radius=50.0)
    s = _np(res.sign)
    assert (s != 0).all()
    np.testing.assert_allclose(np.abs(_np(res.l)), 50.0, rtol=1e-12)


def test_march_rk45_not_escaped_cap():
    """A ray that cannot escape within max_steps reports sign 0 after
    exactly max_steps accepted steps."""
    tm = make_metric("ellis", rho=1.0, device="cpu", dtype=torch.float64)
    one = torch.ones(1, dtype=torch.float64)
    rays = tpl.PlanarRays(5.0 * one, 0.0 * one, one, 0.0 * one, None, None)
    res = march_planar_rk45(tm, rays, escape_radius=1e9, max_steps=50)
    assert int(res.sign[0]) == 0 and int(res.steps[0]) == 50


def test_march_rk45_cap_boundary_ray_keeps_escape_fate():
    """A ray whose max_steps-th accepted step also escapes keeps sign 1;
    every ray needing more accepted steps stops at the cap with sign 0."""
    _, tm, _, tr, _ = _ray_pair("ellis", np.float64,
                                forward=(-1.0, 0.2, 0.1), res=(12, 8))
    kw = dict(escape_radius=100.0, rtol=1e-6, atol=1e-9)
    full = march_planar_rk45(tm, tr, **kw)
    steps, sign = _np(full.steps), _np(full.sign)
    assert (sign != 0).all()
    smin = int(steps[sign == 1].min())
    capped = march_planar_rk45(tm, tr, max_steps=smin, **kw)
    boundary = (steps == smin) & (sign == 1)
    assert boundary.any()
    np.testing.assert_array_equal(_np(capped.sign)[boundary], sign[boundary])
    assert (_np(capped.sign)[steps > smin] == 0).all()
    assert (_np(capped.steps)[steps > smin] == smin).all()


def test_march_rk45_refuses_disk_variants():
    """The disk and volumetric variants run (tests/test_torch_rk45_disk.py
    holds them against the JAX package); the two together are refused, as
    in the JAX twin."""
    _, tm, _, tr, _ = _ray_pair("ellis", np.float64, res=(2, 2))
    one = torch.ones_like(tr.l)
    with pytest.raises(ValueError, match="not both"):
        march_planar_rk45(tm, tr, escape_radius=30.0, c1=0.0 * one,
                          c2=one, nz=one, disk=(3.0, 9.0),
                          vol_disk=object())


# ------------------------------- module 4: the kernel's plain version

@pytest.fixture(scope="module")
def pallas_rk45():
    """march_planar_rk45_pallas in interpret mode (tile_rows 8) with its
    iteration counts, per (kind, dtype), computed once."""
    cache = {}

    def run(kind, dtype):
        if (kind, dtype) not in cache:
            jm, tm, jr, tr, _ = _ray_pair(kind, dtype,
                                          forward=(-1.0, 0.1, 0.0))
            res, iters = march_planar_rk45_pallas(
                jm, jr, escape_radius=50.0, max_steps=400, interpret=True,
                tile_rows=8, return_iters=True)
            cache[kind, dtype] = (jm, tm, jr, tr, res, np.asarray(iters))
        return cache[kind, dtype]
    return run


@pytest.mark.parametrize("kind, dtype", [
    ("ellis", np.float32), ("ellis", np.float64),
    ("schwarzschild", np.float64)])
def test_plain_rk45_matches_pallas_interpret(pallas_rk45, kind, dtype):
    """The plain version of kernel #4 (with return_iters) against the
    Pallas kernel at its defaults (rtol 1e-5, atol 1e-7).  f32 (Ellis, the
    view of the JAX package's own Pallas-vs-XLA test): its bounds (signs
    equal, |dpsi| < 1e-3, |dsteps| <= 2), and iterations within 4: at
    rtol 1e-5 the f32
    error estimate sits near 1 on many steps, so exp / log ulps flip
    rejects (measured: up to 3, on about half the rays, as between the
    JAX package's own two marches).  f64 (Ellis; Schwarzschild with
    captured rays): no flips, so equal steps and iterations and psi within
    1e-9 on escaped rays (a captured ray stops at its first accepted step
    below r_cap).  Schwarzschild in f32 is held through the fused kernel
    below: its near-shadow rays amplify the flips past 1e-3 in psi
    (measured 1.6e-3).  DNEG is not held here: the Pallas
    kernel's atan is a polynomial and the port's exact, a difference of
    method (~3e-4 in psi in f64, up to 3 steps and 9 iterations in f32)
    that the f64 test of the XLA march above does not have."""
    jm, tm, jr, tr, want, iters_w = pallas_rk45(kind, dtype)
    got, iters = march_planar_rk45_cuda(tm, tr, escape_radius=50.0,
                                        max_steps=400, return_iters=True)
    assert got.l.dtype == TDTYPE[dtype] and iters.dtype == torch.int32
    np.testing.assert_array_equal(_np(got.sign), np.asarray(want.sign))
    dsteps = np.abs(_np(got.steps) - np.asarray(want.steps)).max()
    diters = np.abs(_np(iters) - iters_w).max()
    esc = np.abs(np.asarray(want.sign)) == 1
    dpsi = np.abs(_np(got.psi) - np.asarray(want.psi))[esc].max()
    assert (_np(iters) >= _np(got.steps)).all()
    if dtype == np.float32:
        assert dsteps <= 2 and diters <= 4 and dpsi < 1e-3
    else:
        assert dsteps == 0 and diters == 0 and dpsi < 1e-9


def test_plain_rk45_cap_and_max_iters():
    """The kernel contract's caps: sign 0 and steps == max_steps at the
    step cap; a ray out of max_iters keeps sign 0 with iters == max_iters;
    iters counts accepted and rejected iterations while live."""
    _, tm, _, tr, _ = _ray_pair("ellis", np.float32)
    kind, scal = rk45_scalars(tm, 0.05, 50.0, 1e-5, 1e-7, 10.0)
    args = [t.reshape(-1) for t in tr[:4]]
    l, psi, p_l, sign, steps, iters = march_planar_rk45_plain(
        kind, scal, *args, max_steps=5, max_iters=20)
    assert (sign == 0).all() and (steps == 5).all()
    assert (iters >= 5).all() and (iters <= 20).all()
    *_, sign, steps, iters = march_planar_rk45_plain(
        kind, scal, *args, max_steps=400, max_iters=3)
    assert (sign == 0).all() and (iters == 3).all() and (steps <= 3).all()


@pytest.mark.parametrize("plain", ["xla_port", "kernel_plain"])
def test_rk45_nonfinite_ray_freezes_not_spins(plain):
    """A ray whose state is NaN makes err NaN: rejected, dt shrinks to the
    floor through the NaN guard on the factor, and the ray freezes as sign
    3 instead of spinning to max_iters.  Healthy rays escape as usual."""
    tm = make_metric("ellis", rho=1.0, device="cpu")
    n = 8
    l = torch.full((n,), 5.0)
    l[3] = float("nan")
    alpha = torch.from_numpy(np.linspace(0.3, 1.0, n).astype(np.float32))
    rays = tpl.PlanarRays(l, torch.zeros(n), -torch.cos(alpha),
                          5.0 * torch.sin(alpha), None, None)
    kw = dict(escape_radius=30.0, max_steps=400, rtol=1e-5, atol=1e-7)
    if plain == "xla_port":
        sign = march_planar_rk45(tm, rays, max_iters=200, **kw).sign
    else:
        res, iters = march_planar_rk45_cuda(tm, rays, return_iters=True, **kw)
        sign = res.sign
        assert int(iters[3]) < 40          # froze after a few rejects
    sign = _np(sign)
    assert sign[3] == 3, sign
    assert (sign[np.arange(n) != 3] == 1).all(), sign


def test_rk45_wrapper_refuses_what_it_cannot_run():
    tm = make_metric("ellis", device="cpu")
    on_meta = tpl.PlanarRays(*(torch.zeros(4, device="meta")
                               for _ in range(4)), None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        march_planar_rk45_cuda(make_metric("flat"), on_meta,
                               escape_radius=30.0)
    mixed = tpl.PlanarRays(torch.zeros(4), torch.zeros(4), torch.zeros(4),
                           torch.zeros(4, device="meta"), None, None)
    with pytest.raises(ValueError, match="one device"):
        march_planar_rk45_cuda(tm, mixed, escape_radius=30.0)


# --------------------------------------------- the fused rk45 kernel

def _jax_fused_directions(monkeypatch, jm, jc, jp, jn, **kw):
    """The Pallas fused rk45 kernel's escape directions and sign class (+1,
    -1 or 0 for a dark pixel), caught where render_planar_fused hands them
    to the texture lookup."""
    seen = {}
    texture_uv, filter_lookup = jfast._texture_uv, jfast._filter_lookup

    def uv(bg, wx, wy, wz):
        seen.setdefault("w", np.stack([np.asarray(wx), np.asarray(wy),
                                       np.asarray(wz)], -1))
        return texture_uv(bg, wx, wy, wz)

    def lookup(rows, base, *a):
        seen["neg"] = np.asarray(base) != 0
        return filter_lookup(rows, base, *a)

    monkeypatch.setattr(jfast, "_texture_uv", uv)
    monkeypatch.setattr(jfast, "_filter_lookup", lookup)
    img = np.asarray(jax_fused(jm, jc, jp, jn, interpret=True, tile_rows=8,
                               **kw))
    lit = img.transpose(1, 0, 2).reshape(-1, 3).sum(-1) > 0
    return seen["w"], np.where(lit, np.where(seen["neg"], -1, 1), 0)


def test_fused_rk45_plain_matches_pallas_interpret(monkeypatch):
    """render_planar_fused_plain(stepper='rk45') against the Pallas fused
    rk45 kernel in interpret mode, f32, at the quality row's rtol 1e-3, on
    a Schwarzschild view with escaping and captured rays: sign classes
    equal, escape directions within 1e-5 rad at the median and 2e-3 rad
    at most.  The f32 knife-edge accepts move near-critical rays by an
    rtol-level angle (measured: median 1.9e-6, max 9.7e-4 rad)."""
    jm, tm = _metric_pair("schwarzschild", np.float32)
    jc, tc = _camera_pair(L0["schwarzschild"], [-1.0, 0.1, 0.05], (16, 8),
                          np.float32)
    (jp, tp), (jn, tn) = _smooth_skies(np.float32)
    kw = dict(dt=0.05, max_steps=2000, escape_radius=50.0, stepper="rk45",
              rtol=1e-3)
    w_want, cls_want = _jax_fused_directions(monkeypatch, jm, jc, jp, jn,
                                             filtering="bilinear", **kw)
    *w, sign = render_fused.render_planar_fused_plain(tm, tc, **kw)
    cls = np.where(np.abs(_np(sign)) == 1, _np(sign), 0)
    np.testing.assert_array_equal(cls, cls_want)
    ang = _angles(np.stack([_np(c) for c in w], -1).astype(np.float64),
                  w_want.astype(np.float64))
    assert (cls == 0).any() and (cls == 1).any()
    assert np.median(ang[cls != 0]) < 1e-5 and ang[cls != 0].max() < 2e-3


def test_fused_rk45_iteration_cap_rounds_up_to_unroll():
    """The per-ray iteration cap is JAX's max_iters rounded up to its
    unroll, 2; atol defaults to rtol * 1e-3."""
    assert render_fused._rk45_tail(1e-3, None, 10.0, 4000, None) == (
        [1e-3, 1e-3 * 1e-3, 10.0], 16000)
    assert render_fused._rk45_tail(1e-4, 1e-8, 5.0, 100, 7)[1] == 8
    assert render_fused._rk45_tail(1e-4, 1e-8, 5.0, 100, 8)[1] == 8


# ------------------------------------------ the slice against JAX

@pytest.fixture(scope="module")
def scene64():
    jm, tm = _metric_pair("ellis", np.float64)
    cams = [_camera_pair(5.0, [-1.0, 0.1, 0.05], (16, 8), np.float64,
                         phi=0.2 * k) for k in range(2)]
    return jm, tm, cams, _smooth_skies(np.float64)


def test_render_planar_fast_rk45_matches_jax(scene64):
    """stepper='rk45' on the CPU: the port's march_planar_rk45 against
    the JAX XLA march (both rtol 1e-6, atol 1e-9), f64, bilinear on a
    smooth sky: every pixel within 1e-6, median below 1e-9."""
    jm, tm, cams, ((jp, tp), (jn, tn)) = scene64
    kw = dict(dt=0.05, max_steps=400, escape_radius=30.0,
              filtering="bilinear", stepper="rk45")
    want = np.asarray(jfast.render_planar_fast(jm, cams[0][0], jp, jn, **kw))
    got = tfast.render_planar_fast(tm, cams[0][1], tp, tn, **kw)
    d = np.abs(want - _np(got)).max(-1)
    assert got.shape == (8, 16, 3) and d.max() < 1e-6
    assert np.median(d) < 1e-9


def test_render_frames_batched_rk45_matches_jax(scene64):
    """Both frames of one rk45 bundle against the JAX package's render of
    each pose, to the bound of the single-frame test.  The JAX package's
    render_frames_batched is its per-frame render stacked (its own tests
    pin that); its compile alone would take ~8 s of this file's budget."""
    jm, tm, cams, ((jp, tp), (jn, tn)) = scene64
    kw = dict(dt=0.05, max_steps=400, escape_radius=30.0,
              filtering="bilinear", stepper="rk45")
    got = tfast.render_frames_batched(tm, [c[1] for c in cams], tp, tn, **kw)
    assert got.shape == (2, 8, 16, 3)
    for k, (jc, _) in enumerate(cams):
        want = np.asarray(jfast.render_planar_fast(jm, jc, jp, jn, **kw))
        assert np.abs(want - _np(got[k])).max() < 1e-6


@pytest.mark.parametrize("stepper", ["euler", "rk45"])
def test_render_planar_adaptive_matches_jax(scene64, stepper):
    """Edge-adaptive AA: the same refined pixels (the top-k contrast set of
    the base render, in lax.top_k's order) and the same image, f64."""
    jm, tm, cams, ((jp, tp), (jn, tn)) = scene64
    kw = dict(dt=0.05, max_steps=2000, escape_radius=30.0,
              filtering="bilinear", stepper=stepper, refine_frac=0.1,
              supersample=2, camera_velocity=[0.2, 0.1, 0.0])
    want = np.asarray(jfast.render_planar_adaptive(jm, cams[0][0], jp, jn,
                                                   **kw))
    got = tfast.render_planar_adaptive(tm, cams[0][1], tp, tn, **kw)
    assert got.shape == (8, 16, 3)
    d = np.abs(want - _np(got)).max(-1)
    assert d.max() < 1e-6 and np.median(d) < 1e-9
    base_kw = {k: v for k, v in kw.items()
               if k not in ("refine_frac", "supersample")}
    base = tfast.render_planar_fast(tm, cams[0][1], tp, tn, **base_kw)
    n = max(1, int(0.1 * 16 * 8))
    iy, ix = tfast._contrast_topk(base, n)
    jy, jx = jfast._contrast_topk(jnp.asarray(_np(base)), n)
    np.testing.assert_array_equal(_np(iy), np.asarray(jy))
    np.testing.assert_array_equal(_np(ix), np.asarray(jx))
    refined = np.zeros((8, 16), bool)
    refined[_np(iy), _np(ix)] = True
    assert (d[~refined] == 0).all() or d[~refined].max() < 1e-9


def test_contrast_topk_breaks_ties_like_lax_top_k():
    """Flat regions tie: the selection keeps lax.top_k's order, lower flat
    index first."""
    rng = np.random.default_rng(5)
    img = np.zeros((9, 13, 3))
    img[2:7, 4:10] = rng.choice([0.25, 0.5], size=(5, 6, 1))
    iy, ix = tfast._contrast_topk(torch.from_numpy(img), 37)
    jy, jx = jfast._contrast_topk(jnp.asarray(img), 37)
    np.testing.assert_array_equal(_np(iy), np.asarray(jy))
    np.testing.assert_array_equal(_np(ix), np.asarray(jx))


def test_render_routes_refuse_rk4(scene64):
    _, tm, cams, ((_, tp), (_, tn)) = scene64
    kw = dict(dt=0.05, max_steps=10, escape_radius=30.0, stepper="rk4")
    for render in (tfast.render_planar_fast, tfast.render_planar_adaptive,
                   render_fused.render_planar_fused):
        with pytest.raises(NotImplementedError, match="item 7"):
            render(tm, cams[0][1], tp, tn, **kw)
    with pytest.raises(NotImplementedError, match="item 7"):
        tfast.render_frames_batched(tm, [cams[0][1]], tp, tn, **kw)


# ----------------------------------------------------------------- CLI

@pytest.fixture()
def scene(tmp_path):
    """Two tiny skies and the settings TOMLs of tests/test_cli.py."""
    rng = np.random.default_rng(0)
    for name in ("bg1.png", "bg2.png"):
        arr = (rng.random((16, 32, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / name)
    (tmp_path / "cam.toml").write_text(
        "resolution_x = 16\nresolution_y = 10\n"
        "diagonal = 43.0\nfocal_length = 15.0\n")
    (tmp_path / "sim.toml").write_text(
        "escape_radius = 20.0\nray_integration_max_iterations = 400\n"
        "ray_integration_step = 0.05\n")
    (tmp_path / "metric.toml").write_text("rho = 1.0\n")
    return tmp_path


@pytest.mark.parametrize("extra", [
    ("--stepper", "rk45"),
    ("--adaptive-aa", "0.1"),
])
def test_cli_rk45_and_adaptive_equal_library(scene, extra):
    """`image --renderer direct --f64` with --stepper rk45 and/or
    --adaptive-aa writes the PNG of the library call it names."""
    args = ["image", str(scene / "bg1.png"), str(scene / "bg2.png"),
            str(scene / "port"), "-m", str(scene / "metric.toml"),
            "-c", str(scene / "cam.toml"), "-s", str(scene / "sim.toml"),
            "--f64", "--renderer", "direct", *extra]
    assert port_cli(args) == 0
    got = np.asarray(Image.open(scene / "port" / "output_image.png"))

    from curvis_tpu_torch.config.settings import ImageSettings
    img_s = ImageSettings.from_toml(None)
    kw = dict(device="cpu", dtype=torch.float64)
    bgp = load_spherical_image(scene / "bg1.png", **kw)
    bgn = load_spherical_image(scene / "bg2.png", **kw)
    metric = make_metric("ellis", rho=1.0, **kw)
    from curvis_tpu_torch.camera.camera import make_camera
    cam = make_camera(img_s.position, img_s.forward, img_s.up, 15.0, 43.0,
                      16, 10, **kw)
    stepper = "rk45" if "rk45" in extra else "euler"
    rkw = dict(dt=0.05, max_steps=400, escape_radius=20.0,
               filtering="nearest", stepper=stepper)
    if "--adaptive-aa" in extra:
        img = tfast.render_planar_adaptive(metric, cam, bgp, bgn,
                                           refine_frac=0.1, **rkw)
    else:
        img = tfast.render_planar_fast(metric, cam, bgp, bgn, **rkw)
    from curvis_tpu_torch.env.spherical_image import save_image
    save_image(img, scene / "lib.png")
    want = np.asarray(Image.open(scene / "lib.png"))
    assert got.shape == (10, 16, 3)
    np.testing.assert_array_equal(got, want)
