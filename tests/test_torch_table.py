"""PyTorch port vs the JAX package: tabulated user metrics on the CPU.

``curvis_tpu_torch/metrics/table.py`` (the fit, its differentiable twin and
the metric protocol computed from the table) against
``curvis_tpu/metrics/table.py``, and the plain versions of the table kind
of kernels #1-#4 against the JAX Pallas kernels in interpret mode, on the
same tables (carried across with ``convert.table_from_arrays``) and the
same rays.  Also the layout of the ``ChebTable`` kernel argument and of
the table-scalar structs of the planar and disk families.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import curvis_tpu as cv
from curvis_tpu.camera.camera import pixel_rays_world
from curvis_tpu.metrics import table as jtable
from curvis_tpu.ops.march_pallas import (march_planar_pallas,
                                         march_planar_rk45_pallas)
from curvis_tpu.ops.render_fused import render_planar_fused as jax_fused
from curvis_tpu.physics import planar as jpl
from curvis_tpu.render.fast import render_planar_fast as jax_fast

import curvis_tpu_torch as ct
from curvis_tpu_torch import convert
from curvis_tpu_torch.metrics import table as ttable
from curvis_tpu_torch.ops import march_cuda, rk45_cuda
from curvis_tpu_torch.ops import table_cuda as tc
from curvis_tpu_torch.ops.render_fused import render_planar_fused
from curvis_tpu_torch.physics import planar as tpl

F64 = torch.float64
CSRC = Path(ct.__file__).resolve().parent / "csrc"


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _jbell(l):
    """The asymmetric Bell wormhole of benchmarks/parity_gates.py."""
    rho = 1.0 + 0.35 * jnp.tanh(l / 1.4)
    return jnp.sqrt(rho * rho + l * l)


def _tbell(l):
    rho = 1.0 + 0.35 * torch.tanh(l / 1.4)
    return torch.sqrt(rho * rho + l * l)


def _carry(jtab, dtype=F64):
    """The port's table with the arrays of a JAX one."""
    return convert.table_from_arrays(np.asarray(jtab.c1), np.asarray(jtab.c2),
                                     np.asarray(jtab.s), jtab.basis,
                                     device="cpu", dtype=dtype)


def _tables(basis, dtype=jnp.float64, degree=16):
    jtab, _ = jtable.tabulate_metric(_jbell, degree=degree, tol=5e-4,
                                     basis=basis, dtype=dtype)
    return jtab, _carry(jtab, torch.float32 if dtype == jnp.float32
                        else F64)


def _camera_pair(res, dtype=np.float64, forward=(-1.0, 0.1, 0.05)):
    jc = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], list(forward),
                        [0.0, 0.0, 1.0], 15.0, 43.0, res[0], res[1],
                        dtype=jnp.dtype(dtype))
    tcam = convert.camera_from_arrays(
        *(np.asarray(getattr(jc, f)) for f in ("position", "forward", "up",
                                                "focal_length",
                                                "sensor_diagonal")),
        res[0], res[1], device="cpu",
        dtype=torch.from_numpy(np.zeros((), dtype)).dtype)
    return jc, tcam


def _rays_pair(jm, jc, dtype=np.float32):
    jr = jpl.spawn_planar(jm, jc.position, pixel_rays_world(jc))
    jr = jpl.PlanarRays(*(a.astype(dtype) for a in jr))
    return jr, tpl.PlanarRays(*(torch.from_numpy(np.array(a)) for a in jr))


# ------------------------------------------------------------- the fit

@pytest.mark.parametrize("which", ["ellis_metric_deg12", "bell_fn_deg16"])
def test_tabulate_metric_matches_jax(which):
    """Coefficients, basis and report against the JAX package's, float64:
    the Ellis metric object at degree 12 and the Bell callable (r' by
    autodiff in both) at degree 16; coefficients to 1e-12 of their
    scale, reported errors to 1e-9 relative."""
    if which.startswith("ellis"):
        jm = cv.make_metric("ellis", rho=1.3)
        tm = convert.metric_from_arrays("ellis", rho=np.asarray(jm.rho),
                                        device="cpu", dtype=F64)
        kw = dict(degree=12)
    else:
        jm, tm = _jbell, _tbell
        kw = dict(degree=16, tol=5e-4)
    jtab, jrep = jtable.tabulate_metric(jm, dtype=jnp.float64, **kw)
    ttab, trep = ttable.tabulate_metric(tm, dtype=F64, device="cpu", **kw)
    assert isinstance(ttab, ct.TabulatedMetric)
    assert ttab.basis == jtab.basis == trep["basis"] == jrep["basis"]
    assert ttab.degree == jtab.degree == kw["degree"]
    for name in ("c1", "c2"):
        want = np.asarray(getattr(jtab, name))
        got = _np(getattr(ttab, name))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert float(ttab.s) == float(jtab.s) == trep["s"]
    for key in ("err_inv_rel", "err_dr3_rel"):
        assert trep[key] == pytest.approx(jrep[key], rel=1e-9, abs=1e-15)


def test_tabulate_metric_raises_as_jax():
    """The ValueErrors of tests/test_table.py:67-78: an insufficient degree
    (the Bell metric at 8, DNEG's C^1 throat at 16) and r(0) = 0."""
    dneg = convert.metric_from_arrays("interstellar", m=0.5, a=0.3, rho=1.0,
                                      device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="exceeds tol"):
        ttable.tabulate_metric(_tbell, degree=8, device="cpu")
    with pytest.raises(ValueError, match="exceeds tol"):
        ttable.tabulate_metric(dneg, degree=16, device="cpu")
    with pytest.raises(ValueError, match="wormhole-class"):
        ttable.tabulate_metric(lambda l: torch.abs(l), degree=8,
                               device="cpu")
    with pytest.raises(ValueError, match="basis"):
        ttable.tabulate_metric(_tbell, degree=16, basis="power",
                               device="cpu")


@pytest.mark.parametrize("basis", ["horner", "clenshaw"])
def test_metric_protocol_matches_jax(basis):
    """shape_fns, r, r_squared and r_derivative of the same table against
    the JAX TabulatedMetric's, float64, to 1e-13 relative; and the plain
    kernels' shape (ops/table_cuda.py:table_shape) equals shape_fns."""
    jtab, ttab = _tables(basis)
    l = np.linspace(-40.0, 40.0, 101)
    tl = torch.from_numpy(l)
    for name in ("r", "r_squared", "r_derivative"):
        want = np.asarray(getattr(jtab, name)(jnp.asarray(l)))
        got = _np(getattr(ttab, name)(tl))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)
    for want, got in zip(jtab.shape_fns(jnp.asarray(l)), ttab.shape_fns(tl)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-13,
                                   atol=1e-16)
    kind, scal = march_cuda.march_scalars(ttab, 0.05, 30.0)
    assert kind == "table" and kind.basis == basis and kind.n == 17
    p = tc.slot_params(kind, torch.tensor(scal, dtype=F64))
    for a, b in zip(tc.table_shape(kind, p, tl), ttab.shape_fns(tl)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-14, atol=0)


def test_tabulate_metric_diff_and_its_jacobian_match_jax():
    """The differentiable tabulation of examples/shape_recovery.py's shape
    family: coefficients and their Jacobian with respect to the shape's
    parameters against jax.jacobian, float64, to 1e-10 of their scale.
    r' must stay in the graph (create_graph): the Jacobian of c2 holds
    its terms."""
    th = np.array([0.05, 0.2, -0.1])

    def jr_of(t):
        def r(l):
            u = jnp.tanh(l / 1.5)
            rho = jnp.exp(t[0] + t[1] * u + t[2] * u * u)
            return jnp.sqrt(rho * rho + l * l)
        return r

    def tr_of(t):
        def r(l):
            u = torch.tanh(l / 1.5)
            rho = torch.exp(t[0] + t[1] * u + t[2] * u * u)
            return torch.sqrt(rho * rho + l * l)
        return r

    for degree, basis in ((12, "horner"), (20, "clenshaw")):
        def jcoef(t):
            tab = jtable.tabulate_metric_diff(jr_of(t), degree=degree)
            return jnp.concatenate([tab.c1, tab.c2])

        jtab = jtable.tabulate_metric_diff(jr_of(jnp.asarray(th)),
                                           degree=degree)
        ttab = ttable.tabulate_metric_diff(tr_of(torch.from_numpy(th)),
                                           degree=degree, device="cpu",
                                           dtype=F64)
        assert ttab.basis == jtab.basis == basis
        want = np.asarray(jcoef(jnp.asarray(th)))
        got = np.concatenate([_np(ttab.c1), _np(ttab.c2)])
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
        jac_j = np.asarray(jax.jacobian(jcoef)(jnp.asarray(th)))
        jac_t = _np(torch.autograd.functional.jacobian(
            lambda t: torch.cat([*(lambda m: (m.c1, m.c2))(
                ttable.tabulate_metric_diff(tr_of(t), degree=degree,
                                            device="cpu", dtype=F64))]),
            torch.from_numpy(th)))
        assert np.abs(jac_t - jac_j).max() <= 1e-10 * np.abs(jac_j).max()
        n = degree + 1
        assert np.abs(jac_t[n:]).max() > 1e-3     # r' reaches theta


# ------------------------------------------------- the plain kernels

@pytest.mark.parametrize("basis", ["horner", "clenshaw"])
def test_march_plain_matches_pallas_interpret(basis):
    """Kernel #1's route on CPU tensors (the plain march) against
    march_planar_pallas in interpret mode on the same table and rays
    (tests/test_table.py:103-133), float64: signs and steps equal, psi
    within 1e-12."""
    jtab, ttab = _tables(basis)
    jc, _ = _camera_pair((16, 10))
    jr, tr = _rays_pair(jtab, jc, np.float64)
    kw = dict(dt=0.05, max_steps=3000, escape_radius=20.0)
    want = march_planar_pallas(jtab, jr, interpret=True, sort=False,
                               tile_rows=8, **kw)
    got = march_cuda.march_planar_cuda(ttab, tr, **kw)
    np.testing.assert_array_equal(_np(got.sign), np.asarray(want.sign))
    np.testing.assert_array_equal(_np(got.steps), np.asarray(want.steps))
    assert (np.abs(np.asarray(want.sign)) == 1).mean() > 0.9
    np.testing.assert_allclose(_np(got.psi), np.asarray(want.psi), rtol=0,
                               atol=1e-12)


def test_rk45_plain_matches_pallas_interpret():
    """Kernel #4's plain version (march_planar_rk45_plain, the kernel's
    arithmetic and table order) against march_planar_rk45_pallas in
    interpret mode (tests/test_table.py:168-185), float64, Horner and
    Clenshaw: signs and accepted steps equal, psi within 1e-8 (the
    controller's exp / log differ by ulps between the two)."""
    jc, _ = _camera_pair((16, 8), forward=(-1.0, 0.1, 0.0))
    kw = dict(escape_radius=30.0, rtol=1e-5, atol=1e-7)
    for basis in ("horner", "clenshaw"):
        jtab, ttab = _tables(basis)
        jr, tr = _rays_pair(jtab, jc, np.float64)
        want = march_planar_rk45_pallas(jtab, jr, interpret=True,
                                        tile_rows=8, **kw)
        got = rk45_cuda.march_planar_rk45_cuda(ttab, tr, **kw)
        np.testing.assert_array_equal(_np(got.sign), np.asarray(want.sign))
        np.testing.assert_array_equal(_np(got.steps),
                                      np.asarray(want.steps))
        np.testing.assert_allclose(_np(got.psi), np.asarray(want.psi),
                                   rtol=0, atol=1e-8)


@pytest.mark.parametrize("stepper", ["euler", "rk45"])
def test_fused_plain_matches_pallas_interpret(stepper):
    """Kernels #2 / #3's route on a CPU camera (the plain spawn + march +
    readout, the readout's r = 1 / sqrt(inv)) against the JAX fused
    kernel in interpret mode on the same float32 table: images within
    1e-3 on all but 3 % of pixels (texel seams)."""
    jtab, ttab = _tables("horner", jnp.float32)
    jc, tcam = _camera_pair((12, 8), np.float32)
    rng = np.random.default_rng(1)
    tex = rng.random((16, 32, 3)).astype(np.float32)
    jsky = cv.make_spherical_image(tex, dtype=jnp.float32)
    tsky = convert.spherical_image_from_arrays(
        np.asarray(jsky.texture), np.asarray(jsky.rotation), device="cpu")
    kw = dict(dt=0.05, max_steps=2000 if stepper == "euler" else 400,
              escape_radius=20.0, stepper=stepper, filtering="nearest")
    want = np.asarray(jax_fused(jtab, jc, jsky, jsky, interpret=True,
                                tile_rows=8, **kw))
    got = _np(render_planar_fused(ttab, tcam, tsky, tsky, **kw))
    assert got.shape == want.shape == (8, 12, 3)
    assert (np.abs(got - want).max(-1) > 1e-3).mean() <= 0.03


def test_render_routes_take_tables_and_match_jax():
    """render_planar_fast, render_frames_batched and render_planar_adaptive
    with a float64 table on the CPU, Euler and rk45, against the JAX
    package's render_planar_fast (XLA) on the same table: images within
    1e-6 (rk45: 1e-3 on all but 5 % of pixels, the twins' knife-edge
    accepts)."""
    jtab, ttab = _tables("clenshaw", degree=20)
    jc, tcam = _camera_pair((10, 8))
    rng = np.random.default_rng(2)
    tex = rng.random((16, 32, 3))
    jsky = cv.make_spherical_image(tex, dtype=jnp.float64)
    tsky = convert.spherical_image_from_arrays(
        np.asarray(jsky.texture), np.asarray(jsky.rotation), device="cpu",
        dtype=F64)
    for stepper, steps in (("euler", 2000), ("rk45", 500)):
        kw = dict(dt=0.05, max_steps=steps, escape_radius=20.0,
                  filtering="bilinear", stepper=stepper)
        want = np.asarray(jax_fast(jtab, jc, jsky, jsky, backend="tiled",
                                   **kw))
        got = _np(ct.render_planar_fast(ttab, tcam, tsky, tsky, **kw))
        batch = _np(ct.render_frames_batched(ttab, [tcam, tcam], tsky, tsky,
                                             **kw))
        np.testing.assert_array_equal(batch[0], got)
        adaptive = _np(ct.render_planar_adaptive(ttab, tcam, tsky, tsky,
                                                 refine_frac=0.2, **kw))
        assert adaptive.shape == got.shape and np.isfinite(adaptive).all()
        if stepper == "euler":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            assert (np.abs(got - want).max(-1) > 1e-3).mean() <= 0.05


# ------------------------------------------------------------ layout

def test_chebtable_layout_pin():
    """The host argument each wrapper builds (ops/table_cuda.py:ChebTable,
    via kernel_table) places s^2, n, the basis and the coefficients where
    csrc/table.cuh:ChebTable reads them: the same fields in the same
    order and capacity, kind kTable = KINDS['table'], s^2 taken from slot
    2 of every family's scalar row (the disk marches' too); a degree above
    the capacity raises.  The disk families' scalar structs hold the
    kind's march scalars (ScalarsOf<KIND>, TableScalars for kTable) first,
    so the host's analytic row keeps its layout, and their kernels take
    them __grid_constant__; a table's theta cotangents add its 2 (K + 1)
    series rows after each family's."""
    src = (CSRC / "table.cuh").read_text()
    cap = int(re.search(r"kChebMaxDegree = (\d+);", src).group(1))
    assert cap == tc.MAX_DEGREE and tc.CAP == cap + 1
    body = re.search(r"struct ChebTable \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(float|int) (\w+)(\[kChebCap\])?;", body,
                        re.M)
    ctype = {"float": ctypes.c_float, "int": ctypes.c_int}
    want = [(name, ctype[t] * tc.CAP if arr else ctype[t])
            for t, name, arr in fields]
    assert [n for n, _ in want] == ["s2", "n", "horner", "c1", "c2"]
    for (name, t), (hname, ht) in zip(want, tc.ChebTable._fields_):
        assert name == hname and ctypes.sizeof(t) == ctypes.sizeof(ht)
        assert getattr(t, "_type_", t) == getattr(ht, "_type_", ht)
    assert tc.ChebTable.c1.offset == 12
    assert tc.ChebTable.c2.offset == 12 + 4 * tc.CAP
    planar = (CSRC / "planar.cuh").read_text()
    assert int(re.search(r"kTable = (\d+)", planar).group(1)) \
        == march_cuda.KINDS["table"]
    jtab, ttab = _tables("horner", jnp.float32)
    s2 = float(np.float32(jtab.s) * np.float32(jtab.s))
    from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
    from curvis_tpu_torch.ops import disk_cuda, disk_vol_cuda, rk45_disk_cuda
    disk = ct.DiskParams(volumetric=True)
    rows = (march_cuda.march_scalars(ttab, 0.05, 30.0),
            rk45_cuda.rk45_scalars(ttab, 0.05, 30.0, 1e-5, 1e-7, 10.0),
            disk_cuda.disk_scalars(ttab, 0.05, 30.0, 3.0, 12.0),
            disk_vol_cuda.vol_scalars(ttab, 0.05, 30.0, disk),
            rk45_disk_cuda.rk45_disk_scalars(ttab, 0.05, 30.0, 1e-5, 1e-7,
                                             10.0, vol_disk=disk))
    for kind, scal in rows:
        assert scal[2] == s2
        tab = tc.kernel_table(kind, scal)
        assert (tab.s2, tab.n, tab.horner) == (s2, 17, 1)
        np.testing.assert_array_equal(np.array(tab.c1[:17], np.float32),
                                      np.asarray(jtab.c1, np.float32))
        np.testing.assert_array_equal(np.array(tab.c2[:17], np.float32),
                                      np.asarray(jtab.c2, np.float32))
        assert list(tab.c1[17:]) == [0.0] * (tc.CAP - 17)
    for flags in (None, (False, False, False, False),
                  (True, False, False, True)):
        assert cs.n_theta(flags, kind) == cs.n_theta(flags) + 2 * 17
    structs = {"disk.cu": "DiskScalarsT", "planar_vol.cuh": "VolScalarsT",
               "planar_rk45_disk.cu": "Rk45DiskScalarsT"}
    for name, struct in structs.items():
        body = re.search(r"template <class M>\s*struct " + struct
                         + r" \{(.*?)\};", (CSRC / name).read_text(),
                         re.S).group(1)
        assert re.match(r"\s*M m;", body), (name, body)
    surf = (CSRC / "ckpt_surface_rk45.cuh").read_text()
    assert re.search(r"struct Rk45SurfScalarsT \{\s*Rk45Control c;\s*"
                     r"VolScalarsT<M> vs;", surf)
    for name, arg in (("disk.cu", "DiskScalarsT<ScalarsOf<KIND>> s"),
                      ("disk_vol.cu", "VolScalarsOf<KIND> s"),
                      ("planar_rk45_disk.cu",
                       "Rk45DiskScalarsT<ScalarsOf<KIND>> s"),
                      ("ckpt_surface.cu", "VolScalarsOf<KIND> s"),
                      ("ckpt_surface_rk45.cuh", "Rk45SurfScalarsOf<KIND> s")):
        src_k = re.sub(r"\s+", " ", (CSRC / name).read_text())
        assert "const __grid_constant__ " + arg in src_k, name
    big, _ = ttable.tabulate_metric(
        ct.make_metric("ellis", rho=1.0, device="cpu"), degree=cap + 1,
        device="cpu")
    kind, scal = march_cuda.march_scalars(big, 0.05, 30.0)
    with pytest.raises(ValueError, match=f"degree {cap}"):
        tc.kernel_table(kind, scal)
