"""Planar Euler march on the GPU: wrapper of the CUDA kernel
``csrc/planar_march.cu`` (replacing ``curvis_tpu/ops/march_pallas.py``'s
``_march_kernel``).

``march_planar_cuda`` launches the kernel for CUDA tensors and runs the plain
PyTorch version, ``physics/planar.py:march_planar_while``, for CPU tensors.
A CUDA tensor never falls back to the plain version: a failure to build or
launch raises.

A tabulated metric (``metrics/table.py``) has the kind
``ops/table_cuda.py:TableKind``, which carries its coefficient series: the
kernels of the planar families take it as ``kTable`` with a ``ChebTable``
argument.  The disk kernels do not take it yet (ROADMAP Queue 1 item 4b).
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.metrics.base import (EllisMetric, FlatSphericalMetric,
                                           InterstellarMetric, Metric,
                                           ReissnerNordstromMetric,
                                           SchwarzschildMetric)
from curvis_tpu_torch.metrics.table import TabulatedMetric
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.table_cuda import TableKind, kernel_table
from curvis_tpu_torch.physics.planar import (PlanarResult, PlanarRays,
                                             check_stepper,
                                             march_planar_while)
from curvis_tpu_torch.utils.device import common_device

# metric kinds, as numbered by curvis::MetricKind in csrc/planar.cuh
KINDS = {"ellis": 0, "interstellar": 1, "flat": 2, "schwarzschild": 3,
         "rn": 4, "table": 5}

_NO_CAPTURE = -1e30      # capture radius of metrics without capture (unused)

launches = 0             # kernel launches since the last reset


def metric_kind_and_params(metric: Metric):
    """(kind, [p0, p1, p2]) of the metric slots of the scalar row; a
    tabulated metric is (TableKind, [s^2])."""
    if isinstance(metric, EllisMetric):
        return "ellis", [metric.rho]
    if isinstance(metric, InterstellarMetric):
        return "interstellar", [metric.m, metric.a, metric.rho]
    if isinstance(metric, FlatSphericalMetric):
        return "flat", []
    if isinstance(metric, SchwarzschildMetric):
        return "schwarzschild", [metric.m]
    if isinstance(metric, ReissnerNordstromMetric):
        return "rn", [metric.m, metric.q * metric.q]
    if isinstance(metric, TabulatedMetric):
        coef = torch.cat([metric.c1, metric.c2]).detach().cpu().tolist()
        n = metric.c1.shape[0]
        return (TableKind(coef[:n], coef[n:], metric.basis),
                [metric.s * metric.s])
    raise NotImplementedError(
        f"CUDA march: unsupported metric {type(metric).__name__}: tabulate "
        "it with metrics/table.py:tabulate_metric (tables on the disk "
        "routes are ROADMAP Queue 1 item 4b)")


def refuse_table(metric: Metric, what: str):
    """Raise NotImplementedError for a tabulated metric on a route that
    does not take tables yet, before anything is launched."""
    if isinstance(metric, TabulatedMetric):
        raise NotImplementedError(
            f"{what}: tabulated metrics on the disk routes are ROADMAP "
            "Queue 1 item 4b")


def march_scalars(metric: Metric, dt, escape_radius):
    """(kind, [dt, R, p0, p1, p2, r_cap]) as Python floats: the layout of
    curvis::MarchScalars.  Tensor values reach the host in one copy."""
    kind, params = metric_kind_and_params(metric)
    r_cap = metric.capture_radius
    tensors = params + ([r_cap] if r_cap is not None else [])
    host = (torch.stack([t.detach().reshape(()) for t in tensors]).cpu()
            .tolist() if tensors else [])
    vals = host[:len(params)] + [0.0] * (3 - len(params))
    cap = host[-1] if r_cap is not None else _NO_CAPTURE
    return kind, [float(dt), float(escape_radius), *vals, cap]


def march_planar_cuda(metric: Metric, rays: PlanarRays, *, dt, max_steps,
                      escape_radius, stepper="euler") -> PlanarResult:
    """Euler march of ``rays`` with the contract of march_planar_while:
    the CUDA kernel for CUDA tensors (f32 only), the plain version for CPU
    tensors."""
    check_stepper(stepper)
    dev = common_device(metric, rays.l, rays.psi, rays.p_l, rays.b)
    if dev.type == "cpu":
        return march_planar_while(metric, rays, dt=dt, max_steps=max_steps,
                                  escape_radius=escape_radius)
    if dev.type != "cuda":
        raise ValueError(f"march_planar_cuda: unsupported device {dev}")
    return _launch(metric, rays, dt=dt, max_steps=max_steps,
                   escape_radius=escape_radius)


def _launch(metric, rays, *, dt, max_steps, escape_radius) -> PlanarResult:
    kind, scal = march_scalars(metric, dt, escape_radius)
    shape = rays.l.shape
    ins = []
    for name in ("l", "psi", "p_l", "b"):
        t = getattr(rays, name)
        if t.dtype != torch.float32:
            raise TypeError(f"march kernel takes float32 rays, got "
                            f"{name}: {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"ray arrays differ in shape: {name} "
                             f"{tuple(t.shape)} vs l {tuple(shape)}")
        ins.append(t.reshape(-1).contiguous())
    outs = launch(kind, scal, *ins, max_steps=max_steps)
    return PlanarResult(*(o.reshape(shape) for o in outs))


def launch(kind, scal, l, psi, p_l, b, *, max_steps):
    """One kernel launch on flat contiguous float32 CUDA tensors of one
    device, with the host scalars of ``march_scalars`` ->
    (l, psi, p_l, sign, steps)."""
    global launches
    n = l.numel()
    dev = l.device
    outs = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3)]
    outs += [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    tab = kernel_table(kind, scal)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curvis_march_planar(
        KINDS[kind], row, len(scal), _build.table_ptr(tab), l.data_ptr(),
        psi.data_ptr(), p_l.data_ptr(), b.data_ptr(),
        *(o.data_ptr() for o in outs), n, int(max_steps), dev.index, stream)
    _build.check(lib, err, "march_planar_kernel")
    launches += 1
    return outs
