"""Command-line interface of the PyTorch / CUDA port.

The argument parser of ``curvis_tpu/cli.py``:

    curvis-tpu-torch image BG1 BG2 [OUTPUT_FOLDER] [-i IMAGE.toml]
                           [-m METRIC.toml] [-c CAMERA.toml] [-s SIM.toml]
                           --renderer direct ...

What the port runs so far: ``image --renderer direct`` with the Euler
stepper and any planar metric (Ellis, Interstellar, Schwarzschild,
Reissner-Nordstrom), ``--filtering``, ``--supersample``,
``--camera-velocity``, ``--bg1-orient`` / ``--bg2-orient`` and
``--flip-negative``.  It renders on the GPU in float32, or with ``--f64``
on the CPU in float64 (as the JAX CLI's ``--f64`` does).  Everything else
raises NotImplementedError naming its ROADMAP item.

Run as ``python -m curvis_tpu_torch.cli ...`` or via ``curvis-tpu-torch``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="curvis-tpu-torch",
                                description=__doc__.splitlines()[0])

    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("background_image_1", type=Path,
                        help="equirect background for the positive-l side")
        sp.add_argument("background_image_2", type=Path,
                        help="equirect background for the negative-l side")
        sp.add_argument("output_folder", type=Path, nargs="?",
                        default=Path.cwd())
        sp.add_argument("--settings", type=Path, default=None,
                        help="ONE all-in-one TOML with [image] [video] "
                             "[camera] [simulation] [metric] sections (any "
                             "subset). Per-category flags below override "
                             "their section.")
        sp.add_argument("-m", "--metric-settings", type=Path, default=None)
        sp.add_argument("-c", "--camera-settings", type=Path, default=None)
        sp.add_argument("-s", "--simulation-settings", type=Path,
                        default=None)
        sp.add_argument("--renderer", choices=["symmetric", "direct"],
                        default="symmetric",
                        help="symmetric = the reference's efficient 1-D "
                             "reduction (not ported yet); direct = "
                             "per-pixel march")
        sp.add_argument("--filtering", choices=["nearest", "bilinear"],
                        default="nearest")
        sp.add_argument("--seam", choices=["exact", "nearest_side"],
                        default="exact",
                        help="exact = reference black seam parity "
                             "(symmetric renderer)")
        sp.add_argument("--stepper", choices=["euler", "rk4", "rk45"],
                        default="euler",
                        help="euler = reference parity (the only ported "
                             "stepper)")
        sp.add_argument("--disk", action="store_true",
                        help="render an accretion disk (not ported yet)")
        sp.add_argument("--disk-color", choices=["tint", "blackbody"],
                        default="tint")
        sp.add_argument("--disk-thickness", type=float, default=0.0)
        sp.add_argument("--disk-volumetric", action="store_true")
        sp.add_argument("--disk-h", type=float, default=0.08)
        sp.add_argument("--disk-starlight", action="store_true")
        sp.add_argument("--disk-albedo", type=float, nargs=3,
                        default=(0.4, 0.4, 0.4), metavar=("R", "G", "B"))
        sp.add_argument("--camera-velocity", type=float, nargs=3,
                        default=None, metavar=("VX", "VY", "VZ"),
                        help="camera 3-velocity (fraction of c, world "
                             "frame): special-relativistic aberration + "
                             "Doppler brightness of the received field")
        sp.add_argument("--supersample", type=int, default=1,
                        help="k x k rays per pixel, box-filtered")
        sp.add_argument("--adaptive-aa", type=float, default=0.0,
                        metavar="FRAC",
                        help="edge-adaptive antialiasing (not ported yet)")
        sp.add_argument("--f64", action="store_true",
                        help="double precision (CPU)")
        sp.add_argument("--bg1-orient", type=float, nargs=6, default=None,
                        metavar=("FX", "FY", "FZ", "UX", "UY", "UZ"),
                        help="forward+up orientation of background 1")
        sp.add_argument("--bg2-orient", type=float, nargs=6, default=None,
                        metavar=("FX", "FY", "FZ", "UX", "UY", "UZ"),
                        help="forward+up orientation of background 2")
        sp.add_argument("--flip-negative", action="store_true",
                        help="mirror the negative-l background "
                             "horizontally")

    img = sub.add_parser("image", help="render a single image")
    common(img)
    img.add_argument("-i", "--image-settings", type=Path, default=None)

    vid = sub.add_parser("video", help="render camera-path video frames "
                                       "(not ported yet)")
    common(vid)
    vid.add_argument("-v", "--video-settings", type=Path, default=None)
    vid.add_argument("--gif", action="store_true")
    vid.add_argument("--clean", action="store_true")
    vid.add_argument("--frames-per-batch", type=int, default=1)

    sub.add_parser("custom", help="custom-script hook (stub)")
    return p


def _check_ported(args):
    """Raise NotImplementedError for options the port does not run yet."""
    if args.disk:
        raise NotImplementedError(
            "--disk: disks and starlight are ROADMAP Queue 1 item 12")
    if args.renderer == "symmetric":
        raise NotImplementedError(
            "--renderer symmetric (the default) needs the on-device adaptive "
            "sampler, ROADMAP Queue 1 item 7; use --renderer direct")
    if args.adaptive_aa > 0:
        raise NotImplementedError(
            "--adaptive-aa: render_planar_adaptive is ROADMAP Queue 1 item 5")
    if args.stepper != "euler":
        raise NotImplementedError(
            f"--stepper {args.stepper}: rk4 / rk45 are ROADMAP Queue 1 items "
            "4 and 10")


def image_main(args) -> int:
    import torch
    from curvis_tpu_torch.config.settings import (CameraSettings,
                                                  ImageSettings,
                                                  MetricSettings,
                                                  SimulationSettings,
                                                  load_settings)
    from curvis_tpu_torch.env.spherical_image import (SphericalImage,
                                                      load_spherical_image,
                                                      save_image)
    from curvis_tpu_torch.camera.camera import make_camera
    from curvis_tpu_torch.render.fast import render_planar_fast

    for bg in (args.background_image_1, args.background_image_2):
        if not bg.exists():
            raise SystemExit(f"error: background image {bg} does not exist")
    allinone = load_settings(args.settings) if args.settings else None

    def pick(flag, cls, section):
        if flag or allinone is None:
            return cls.from_toml(flag)
        return getattr(allinone, section)

    metric_s = pick(args.metric_settings, MetricSettings, "metric")
    camera_s = pick(args.camera_settings, CameraSettings, "camera")
    sim = pick(args.simulation_settings, SimulationSettings, "simulation")
    img_s = pick(args.image_settings, ImageSettings, "image")
    if metric_s.kind in ("kerr", "kerr-newman", "kn"):
        raise NotImplementedError(
            f"metric {metric_s.kind!r}: Kerr and Kerr-Newman are ROADMAP "
            "Queue 1 item 13")
    _check_ported(args)

    device, dtype = (("cpu", torch.float64) if args.f64
                     else ("cuda", torch.float32))

    def orient(o):
        return (o[:3], o[3:]) if o else (None, None)

    f1, u1 = orient(args.bg1_orient)
    f2, u2 = orient(args.bg2_orient)
    bgp = load_spherical_image(args.background_image_1, forward=f1, up=u1,
                               device=device, dtype=dtype)
    bgn = load_spherical_image(args.background_image_2, forward=f2, up=u2,
                               device=device, dtype=dtype)
    if args.flip_negative:
        bgn = SphericalImage(texture=torch.flip(bgn.texture, dims=(1,)),
                             rotation=bgn.rotation)
    metric = metric_s.make(device=device, dtype=dtype)
    camera = make_camera(img_s.position, img_s.forward, img_s.up,
                         camera_s.focal_length, camera_s.diagonal,
                         camera_s.resolution_x, camera_s.resolution_y,
                         device=device, dtype=dtype)
    args.output_folder.mkdir(parents=True, exist_ok=True)
    img = render_planar_fast(metric, camera, bgp, bgn,
                             dt=sim.ray_integration_step,
                             max_steps=sim.ray_integration_max_iterations,
                             escape_radius=sim.escape_radius,
                             filtering=args.filtering,
                             stepper=args.stepper,
                             supersample=args.supersample,
                             camera_velocity=args.camera_velocity)
    out = args.output_folder / f"{img_s.image_name}.png"
    save_image(img, out)
    print(f"saved {out}")
    return 0


def video_main(args) -> int:
    raise NotImplementedError("video: the video renderer is ROADMAP Queue 1 "
                              "item 8")


def custom_main(args) -> int:
    print("error: custom_main() is not implemented. Modify "
          "curvis_tpu_torch/cli.py:custom_main to use it.", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "image":
        return image_main(args)
    if args.command == "video":
        return video_main(args)
    return custom_main(args)


if __name__ == "__main__":
    sys.exit(main())
