"""Where a tabulated metric's disk gradient parts from float64, on an H100.

Run from the root of the repo on a machine with one CUDA card:

    python3 table_disk_witness.py

It builds the kernels (``chip_smoke.py`` phases 0-1), then, for the shape
loss of ``chip_smoke.py`` phase 30 (a thin disk around a degree-12
Chebyshev table of ``shape_fn`` at ``TABLE_DISK_THETA``, the smooth sky),
on three 128^2 views (the central 128^2 pixels of the 1024^2 disk view, the
disk view itself at 128^2, and l = 12) and each stepper, prints:

- how far the kernel frame (float32) lies from the float32 twin's
  (``differentiable='scan'``) and the float32 twin's from the float64 one,
  and the share of rays whose fate (sign, steps, hits) each pair shares;
- d mean(image) / d theta through the kernels (``'adjoint'``), the float32
  twin and the float64 twin, over every pixel and over the pixels whose
  float32 and float64 frames agree within 1e-4, and float64 / float32
  central differences in theta1 of the same means.

It takes about 20 minutes: the twins are step-by-step PyTorch loops.
"""
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as c  # noqa: E402

F32, F64 = torch.float32, torch.float64
VIEWS = (("crop of the 1024^2 path view (central 128^2)", 28.0, 128,
          43.0 / 8, (3.0, 12.0)),
         ("path view at 128^2", 28.0, 128, 43.0, (3.0, 12.0)),
         ("l=12 128^2", 12.0, 128, 43.0, (2.0, 9.0)))


def cam(l, res, sensor, dtype):
    from curvis_tpu_torch.camera.camera import make_camera
    st, ct = math.sin(c.DISK_TH), math.cos(c.DISK_TH)
    return make_camera([0.0, l, c.DISK_TH, 0.0], [-st, 0, -ct], [0, 0, 1],
                       c.DISK_FOCAL, sensor, res, res, device="cuda",
                       dtype=dtype)


def table_of(theta, dtype):
    from curvis_tpu_torch.metrics.table import tabulate_metric_diff
    return tabulate_metric_diff(c.shape_fn(theta), degree=12, s=1.0,
                                basis="clenshaw", device="cuda", dtype=dtype)


def rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)


def main():
    if not torch.cuda.is_available():
        print("table_disk_witness: no CUDA device")
        return 1
    c.phase0_toolchain()
    c.phase1_build()
    from curvis_tpu_torch.env.spherical_image import make_spherical_image
    from curvis_tpu_torch.integrate.planar_surface_adjoint import \
        march_planar_disk_adjoint
    from curvis_tpu_torch.render import disk as rd
    from curvis_tpu_torch.render.disk import DiskParams
    h, w = c.SKY[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    tex = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                    0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    skies = {F32: make_spherical_image(tex.astype(np.float32),
                                       device="cuda"),
             F64: make_spherical_image(tex, device="cuda", dtype=F64)}
    th0 = torch.tensor(c.TABLE_DISK_THETA, device="cuda", dtype=F64)
    for name, l0, res, sensor, band in VIEWS:
        disk = DiskParams(**{**c.DISK_THIN, "r_inner": band[0],
                             "r_outer": band[1]})
        for stepper in ("euler", "rk45"):
            t0 = time.perf_counter()
            kw = dict(dt=c.DT, max_steps=c.MAX_STEPS,
                      escape_radius=c.DISK_R, stepper=stepper,
                      rtol=c.RK45_DISK_RTOL)

            def frame(theta, dtype, diff=None):
                return rd.render_blackhole_disk(
                    table_of(theta.to(dtype), dtype),
                    cam(l0, res, sensor, dtype), skies[dtype], disk=disk,
                    differentiable=diff, **kw)
            with torch.no_grad():
                ik = frame(th0, F32).double()
                it32 = frame(th0, F32, "scan").double()
                it64 = frame(th0, F64, "scan")
            dk = (ik - it32).abs().amax(-1)
            dp = (it32 - it64).abs().amax(-1)
            agree = (dp <= 1e-4)[..., None].double()
            fates = {}
            rk = ({"rtol": c.RK45_DISK_RTOL, "atol": c.RK45_DISK_RTOL * 1e-3}
                  if stepper == "rk45" else {})
            with torch.no_grad():
                for who, dtype, backend in (("kernel", F32, "auto"),
                                            ("twin32", F32, "twin"),
                                            ("twin64", F64, "twin")):
                    met = table_of(th0.to(dtype), dtype)
                    state, planes = c.disk_rays(
                        met, [cam(l0, res, sensor, dtype)])
                    out = march_planar_disk_adjoint(
                        met, state[:3], state[3], planes[0], planes[1],
                        dt=c.DT, max_steps=c.MAX_STEPS,
                        escape_radius=c.DISK_R, r_inner=band[0],
                        r_outer=band[1], stepper=stepper, backend=backend,
                        **rk)
                    fates[who] = (out[3], out[4], out[5][0][0] != 0,
                                  out[5][1][0] != 0)

            def feq(a, b):
                return [f"{(x == y).double().mean().item():.5f}"
                        for x, y in zip(fates[a], fates[b])]
            fk = (dk > 1e-3).double().mean().item()
            fp = (dp > 1e-3).double().mean().item()
            print(f"== {name}, {stepper}: image max |kernel - twin32| "
                  f"{dk.max().item():.3e} ({fk:.5f} of px > 1e-3); max "
                  f"|twin32 - twin64| {dp.max().item():.3e} ({fp:.5f} > "
                  f"1e-3, {1 - agree.mean().item():.5f} > 1e-4); fates "
                  f"equal (sign, steps, hit1, hit2) kernel~twin32 "
                  f"{feq('kernel', 'twin32')}, twin32~twin64 "
                  f"{feq('twin32', 'twin64')}; steps mean "
                  f"{fates['kernel'][1].double().mean().item():.1f} max "
                  f"{int(fates['kernel'][1].max())}", flush=True)
            g = {}
            for who, dtype, diff in (("kernel", F32, "adjoint"),
                                     ("twin32", F32, "scan"),
                                     ("twin64", F64, "scan")):
                for mname, mask in (("all", None), ("agree", agree)):
                    th = th0.to(dtype).clone().requires_grad_()
                    img = frame(th, dtype, diff).double()
                    loss = (img if mask is None else img * mask).mean()
                    (gg,) = torch.autograd.grad(loss, th)
                    g[(who, mname)] = gg.double()
            hh = 0.02
            e1 = torch.tensor([0, hh, 0], device="cuda", dtype=F64)
            with torch.no_grad():
                ip, im = (frame(th0 + e1, F64, "scan"),
                          frame(th0 - e1, F64, "scan"))
                kp, km = (frame(th0 + e1, F32).double(),
                          frame(th0 - e1, F32).double())
            lin = ((ip + im - 2 * it64).abs()
                   <= 0.1 * (ip - im).abs() + 1e-6).double()
            cd64 = {"all": ((ip - im).mean() / (2 * hh)).item(),
                    "agree": (((ip - im) * agree).mean() / (2 * hh)).item()}
            cd32 = {"all": ((kp - km).mean() / (2 * hh)).item(),
                    "agree": (((kp - km) * agree).mean() / (2 * hh)).item()}
            for mname in ("all", "agree"):
                gk, g32, g64 = (g[("kernel", mname)], g[("twin32", mname)],
                                g[("twin64", mname)])
                r64 = abs(g64[1].item() - cd64[mname]) / abs(cd64[mname])
                rk_ = abs(gk[1].item() - cd32[mname]) / abs(cd32[mname])
                print(f"   loss mean(image"
                      f"{'' if mname == 'all' else ' * agree'}): kernel "
                      f"{[f'{x:.6e}' for x in gk.tolist()]} twin32 "
                      f"{[f'{x:.6e}' for x in g32.tolist()]} twin64 "
                      f"{[f'{x:.6e}' for x in g64.tolist()]}; rel max "
                      f"kernel~twin32 {rel(gk, g32):.3e}, kernel~twin64 "
                      f"{rel(gk, g64):.3e}, twin32~twin64 {rel(g32, g64):.3e}"
                      f"; d/dtheta1 cd64 {cd64[mname]:.6e} (twin64 rel "
                      f"{r64:.3e}), cd32 {cd32[mname]:.6e} (kernel rel "
                      f"{rk_:.3e})", flush=True)
            print(f"   lin share (f64) {lin.mean().item():.5f}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
