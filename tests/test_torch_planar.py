"""PyTorch port vs the JAX package: metrics, camera, spawn and the planar
march, on the CPU.

Both packages get the same state: the JAX objects are built first and
carried across with ``curvis_tpu_torch.convert``.  The JAX side runs as its
own tests run it (f64 XLA on the CPU; Pallas in interpret mode); the port's
CPU tensors take the plain PyTorch versions of its CUDA kernels.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import curvis_tpu as cv
from curvis_tpu.camera.camera import camera_rotation as jax_camera_rotation
from curvis_tpu.camera.camera import pixel_rays_world
from curvis_tpu.ops.march_pallas import march_planar_pallas
from curvis_tpu.physics import planar as jpl
from curvis_tpu.render import fast as jfast

from curvis_tpu_torch import convert
from curvis_tpu_torch.camera.camera import camera_rotation
from curvis_tpu_torch.metrics.base import make_metric
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.march_cuda import march_planar_cuda
from curvis_tpu_torch.physics import planar as tpl
from curvis_tpu_torch.render import fast as tfast

METRICS = {
    "ellis": dict(rho=1.3),
    "interstellar": dict(m=0.1, a=0.5, rho=1.0),
    "flat": {},
    "schwarzschild": dict(m=1.0),
    "rn": dict(m=1.0, q=0.6),
}
_PARAMS = {"ellis": ("rho",), "interstellar": ("m", "a", "rho"),
           "flat": (), "schwarzschild": ("m",), "rn": ("m", "q")}


def _pair(kind, dtype=np.float64, **params):
    """(JAX metric, port metric) with the same parameters."""
    jm = cv.make_metric(kind, **(params or METRICS[kind]))
    arrays = {k: np.asarray(getattr(jm, k), dtype) for k in _PARAMS[kind]}
    tm = convert.metric_from_arrays(kind, dtype=torch.from_numpy(
        np.zeros((), dtype)).dtype, **arrays)
    if dtype == np.float32:
        import jax
        jm = jax.tree.map(lambda x: x.astype(jnp.float32), jm)
    return jm, tm


def _camera_pair(position, forward, res, dtype=np.float64):
    jc = cv.make_camera(position, forward, [0.0, 0.0, 1.0], 15.0, 43.0,
                        res[0], res[1], dtype=jnp.dtype(dtype))
    tc = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        jc.resolution_x, jc.resolution_y,
        dtype=torch.from_numpy(np.zeros((), dtype)).dtype)
    return jc, tc


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rays_pair(jm, jc, dtype=np.float64):
    """Planar rays of every pixel (JAX spawn), as (JAX, port) bundles."""
    jr = jpl.spawn_planar(jm, jc.position, pixel_rays_world(jc))
    jr = jpl.PlanarRays(*(a.astype(dtype) for a in jr))
    tr = tpl.PlanarRays(*(torch.from_numpy(np.array(a)) for a in jr))
    return jr, tr


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("kind", sorted(METRICS))
def test_metric_functions_match(kind):
    jm, tm = _pair(kind)
    rng = np.random.default_rng(11)
    if kind in ("schwarzschild", "rn"):
        l = rng.uniform(2.0, 60.0, 64)
    else:
        l = rng.uniform(-20.0, 20.0, 64)
    names = ["r", "r_squared", "r_derivative"]
    if not tm.unit_lapse:
        names += ["lapse", "lapse_deriv", "radial_B"]
    for name in names:
        want = np.asarray(getattr(jm, name)(jnp.asarray(l)))
        got = _np(getattr(tm, name)(torch.from_numpy(l)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=name)
    if not tm.unit_lapse:
        np.testing.assert_allclose(float(tm.capture_radius),
                                   float(jm.capture_radius), rtol=1e-12)


@pytest.mark.parametrize("kind, params, message", [
    ("ellis", dict(rho=0.0), "rho > 0"),
    ("interstellar", dict(m=-1.0), "m > 0"),
    ("schwarzschild", dict(m=0.0), "m > 0"),
    ("rn", dict(m=1.0, q=1.0), "sub-extremal"),
    ("kerr", {}, "Unknown metric"),
])
def test_make_metric_validation(kind, params, message):
    with pytest.raises(ValueError, match=message):
        make_metric(kind, **params)
    with pytest.raises(ValueError, match=message):
        cv.make_metric(kind, **params)


def test_metric_parameters_are_module_parameters():
    m = make_metric("interstellar", m=0.2, a=0.01, rho=2.0,
                    dtype=torch.float64)
    params = dict(m.named_parameters())
    assert sorted(params) == ["a", "m", "rho"]
    assert all(p.dtype == torch.float64 and p.dim() == 0
               and not p.requires_grad for p in params.values())
    assert make_metric("flat").device is None


def test_rotation_helpers_and_rn_radii_match():
    from curvis_tpu.camera.camera import sensor_size as jax_sensor_size
    from curvis_tpu.geometry import rotations as jrot
    from curvis_tpu_torch.camera.camera import sensor_size
    from curvis_tpu_torch.geometry import rotations as trot
    rng = np.random.default_rng(5)
    v = rng.normal(size=(32, 3))
    up = rng.normal(size=(32, 3))
    theta, phi = rng.uniform(-3, 3, 32), rng.uniform(-7, 7, 32)
    tv, tup = torch.from_numpy(v), torch.from_numpy(up)
    pairs = [
        (trot.vector3_from_theta_phi(torch.from_numpy(theta),
                                     torch.from_numpy(phi)),
         jrot.vector3_from_theta_phi(jnp.asarray(theta), jnp.asarray(phi))),
        (torch.stack(trot.theta_phi_from_vector3(tv)),
         jnp.stack(jrot.theta_phi_from_vector3(jnp.asarray(v)))),
        (trot.rotation_from_forward_up(tv, tup),
         jrot.rotation_from_forward_up(jnp.asarray(v), jnp.asarray(up))),
        (trot.orthogonal_up(tv, tup),
         jrot.orthogonal_up(jnp.asarray(v), jnp.asarray(up))),
        (trot._any_perpendicular(tv), jrot._any_perpendicular(jnp.asarray(v))),
    ]
    jc, tc = _camera_pair([0.0, 5.0, 1.0, 0.0], [-1.0, 0.0, 0.0], (16, 9))
    pairs.append((torch.stack(sensor_size(tc)),
                  jnp.stack(jax_sensor_size(jc))))
    jm, tm = _pair("rn")
    for name in ("horizon_radius", "photon_sphere_radius",
                 "critical_impact_parameter"):
        pairs.append((getattr(tm, name), getattr(jm, name)))
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-12)


# ------------------------------------------------------ camera and spawn

@pytest.mark.parametrize("kind", ["ellis", "schwarzschild"])
def test_camera_pixel_dirs_and_spawn_match(kind):
    jm, tm = _pair(kind)
    jc, tc = _camera_pair([0.0, 5.0, 1.2, 0.7], [-1.0, -0.8, 0.3], (16, 8))
    np.testing.assert_allclose(_np(camera_rotation(tc)),
                               np.asarray(jax_camera_rotation(jc)),
                               rtol=0, atol=1e-12)
    jd = jfast._pixel_dirs_soa(jc)
    td = tfast._pixel_dirs_soa(tc)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-12)
    (js, jr, je) = jfast._spawn_planar_soa(jm, jc, *jd)
    (ts, tr, te) = tfast._spawn_planar_soa(tm, tc, *td)
    for a, b in zip((*ts, *tr, *te), (*js, *jr, *je)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-12)


def test_near_radial_spawn_always_finite():
    """The planar basis must be gated on the computed cross norm: f32
    directions within microradians of -r_hat (and exactly anti-parallel)
    give finite bases in both spawn functions."""
    metric = make_metric("ellis", rho=1.0)
    th, ph = np.float32(np.pi / 2 - 0.22), np.float32(0.0)
    r_hat = np.array([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                      np.cos(th)], np.float32)
    eps = np.concatenate([[0.0], np.geomspace(1e-9, 1e-3, 64)]
                         ).astype(np.float32)
    d = -r_hat[None] + eps[:, None] * np.array([0.0, 1.0, 0.0], np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cam = convert.camera_from_arrays([0.0, 28.0, th, ph], -r_hat,
                                     [0.0, 0.0, 1.0], 30.0, 43.0, 4, 4)
    dt = torch.from_numpy(d)
    (l, psi, p_l, b), rh, e2 = tfast._spawn_planar_soa(
        metric, cam, dt[:, 0], dt[:, 1], dt[:, 2])
    for a in (l, psi, p_l, b, *e2):
        assert torch.isfinite(a).all()
    assert abs(float(b[0])) < 1e-6
    rays = tpl.spawn_planar(metric, cam.position, dt)
    for a in rays:
        assert torch.isfinite(a).all()


# ---------------------------------------------------------------- march

_MARCH_CASES = {
    "ellis": ([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.2, 0.1]),
    "interstellar": ([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.2, 0.1]),
    "schwarzschild": ([0.0, 15.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.05]),
    "rn": ([0.0, 12.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.05]),
}


@pytest.mark.parametrize("kind", sorted(_MARCH_CASES))
def test_march_while_matches_jax_f64(kind):
    jm, tm = _pair(kind, **({"m": 0.1, "a": 1e-4, "rho": 1.0}
                            if kind == "interstellar" else {}))
    pos, fwd = _MARCH_CASES[kind]
    jc, _ = _camera_pair(pos, fwd, (16, 8))
    jr, tr = _rays_pair(jm, jc)
    kw = dict(dt=0.05, max_steps=4000, escape_radius=30.0)
    want = jpl.march_planar_while(jm, jr, **kw)
    got = tpl.march_planar_while(tm, tr, **kw)
    np.testing.assert_array_equal(_np(got.sign), np.asarray(want.sign))
    np.testing.assert_array_equal(_np(got.steps), np.asarray(want.steps))
    for name in ("l", "psi", "p_l"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    if kind in ("schwarzschild", "rn"):
        assert (_np(got.sign) == tpl.CAPTURED).any()
    w_t = tpl.planar_world_directions(tm, tr, got)
    w_j = jpl.planar_world_directions(jm, jr, want)
    np.testing.assert_allclose(_np(w_t), np.asarray(w_j), rtol=0, atol=1e-7)


@pytest.mark.parametrize("cap", [1899, 1900, 1901, 1902, 2101])
def test_march_step_cap_matches_jax(cap):
    """Rays ending within +-2 steps of max_steps: sign and steps equal to
    the JAX while march at every cap (the radial ray escapes exactly at
    step 1901)."""
    jm, tm = _pair("ellis", rho=1.0)
    alphas = np.array([0.0, np.pi, 1.2, 2.2, 2.95])
    l = np.full(5, 5.0)
    jr = jpl.PlanarRays(l=jnp.asarray(l), psi=jnp.zeros(5),
                        p_l=jnp.cos(jnp.asarray(alphas)),
                        b=jnp.sin(jnp.asarray(alphas)) * jm.r(jnp.asarray(l)),
                        r_hat=jnp.zeros((1, 3)), e2=jnp.zeros((1, 3)))
    tr = tpl.PlanarRays(*(torch.from_numpy(np.array(a)) for a in jr))
    kw = dict(dt=0.05, escape_radius=100.0, max_steps=cap)
    want = jpl.march_planar_while(jm, jr, **kw)
    got = march_planar_cuda(tm, tr, **kw)
    np.testing.assert_array_equal(_np(got.sign), np.asarray(want.sign))
    np.testing.assert_array_equal(_np(got.steps), np.asarray(want.steps))
    assert int(got.sign[0]) == (1 if cap >= 1901 else 0)


def test_march_wrapper_matches_pallas_interpret():
    """The march wrapper on CPU tensors (the kernel's plain version)
    against the Pallas kernel in interpret mode, f32."""
    jm, tm = _pair("ellis", np.float32, rho=1.0)
    jc, _ = _camera_pair([0.0, 5.0, 1.2, 0.7], [-1.0, 0.0, 0.0], (16, 8))
    jr, tr = _rays_pair(jm, jc, np.float32)
    kw = dict(dt=0.05, max_steps=4000, escape_radius=30.0)
    want = march_planar_pallas(jm, jr, interpret=True, sort=False,
                               tile_rows=8, **kw)
    got = march_planar_cuda(tm, tr, **kw)
    assert got.l.dtype == torch.float32
    np.testing.assert_array_equal(_np(got.sign), np.asarray(want.sign))
    assert np.abs(_np(got.psi) - np.asarray(want.psi)).max() < 1e-5


def test_march_wrapper_refuses_what_it_cannot_run():
    metric = make_metric("ellis")
    rays = tpl.PlanarRays(*(torch.zeros(4) for _ in range(4)),
                          r_hat=torch.zeros(1, 3), e2=torch.zeros(1, 3))
    kw = dict(dt=0.05, max_steps=10, escape_radius=30.0)
    with pytest.raises(NotImplementedError, match="rk4"):
        march_planar_cuda(metric, rays, stepper="rk4", **kw)
    meta = rays._replace(l=torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="one device"):
        march_planar_cuda(metric, meta, **kw)
    on_meta = tpl.PlanarRays(*(torch.zeros(4, device="meta")
                               for _ in range(4)), r_hat=None, e2=None)
    with pytest.raises(ValueError, match="unsupported device"):
        march_planar_cuda(make_metric("flat"), on_meta, **kw)


def test_build_command_targets_hopper():
    """The nvcc command (never run on import or on the CPU) compiles every
    csrc/*.cu for sm_90a into one shared library."""
    cmd = _build.nvcc_command("nvcc", _build.BUILD_DIR / _build.LIB_NAME)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    assert "-use_fast_math" not in cmd
    cu = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert cu == ["planar_march.cu", "render_fused.cu"]
    assert all(any(c.endswith(name) for c in cmd) for name in cu)
    assert len(_build.source_hash()) == 64
    assert not _build.is_loaded()
