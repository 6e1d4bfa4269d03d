#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (``curvis_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU, ``nvcc`` and the repository checkout around this file;
it exits non-zero without them.  Phases, each of which raises on failure:

  0. toolchain: torch / CUDA / nvcc versions, the card's name and power limit;
  1. build the CUDA kernels from curvis_tpu_torch/csrc (nvcc, sm_90a);
  2. the march kernel against its plain PyTorch version on the card:
     Ellis on the headline 4 x 1024^2 ray bundle, DNEG and Schwarzschild
     at 256^2, and Schwarzschild with a step cap of 2000 that many rays
     reach (every ray must stop at or before it, exactly at it if still
     marching);
  3. the fused kernel against its plain version (Ellis, 1024^2), and the
     fused image against the march-kernel image;
  4. the headline job through both kernels: an Ellis wormhole, 4 camera
     poses at 1024^2, Euler dt = 0.05, 40 000 steps, escape radius 100,
     nearest lookup into two 512 x 1024 skies made from seed 0;
  5. the launch counters of that headline run.

The line before the last is a JSON object with each kernel's launches,
error against its plain version and times; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

RES = 1024
SMALL = 256               # side of the DNEG / Schwarzschild march checks
CAP = 2000                # a step cap below the mean step count: many
                          # rays stop at it, and must stop exactly there
FRAMES = 4
SKY = (512, 1024, 3)
DT = 0.05
MAX_STEPS = 40_000
R_ESC = 100.0
REPS = 5
DEVICE = "cuda"

SIGN_EQ_MIN = 0.995        # fraction of rays with equal sign
STEPS_EQ_MIN = 0.99        # fraction of rays with equal step count
ANGLE_P99_MAX = 1e-3       # rad, escape-direction angle over escaped rays
IMAGE_DIFF_MAX = 0.05      # fraction of pixels differing by > 1e-6
LIT_MIN = 0.9              # lit-pixel fraction of a wormhole view


def require(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase0_toolchain():
    import torch
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false: a CUDA GPU is required")
    require((ROOT / "curvis_tpu_torch" / "__init__.py").is_file(),
            f"no curvis_tpu_torch package beside {Path(__file__).name}: run "
            "it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from curvis_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    release = [v for v in ver if "release" in v]
    print(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    print(f"[0] nvcc: {ver[0]} | {release[0] if release else '?'}")
    print(f"[0] device 0: {torch.cuda.get_device_name(0)}, "
          f"device_count {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    return smi[0]


def phase1_build():
    from curvis_tpu_torch.ops import _build
    fresh = not (_build.BUILD_DIR / _build.LIB_NAME).exists()
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f"[1] kernels built{' (fresh)' if fresh else ''} in {secs:.1f} s "
          f"-> {_build.BUILD_DIR / _build.LIB_NAME}")
    log = (_build.BUILD_DIR / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1]   {line.strip()}")
    return secs


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Median wall time of ``fn`` between CUDA events, in ms."""
    import torch
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def camera(l, phi, res):
    from curvis_tpu_torch.camera.camera import make_camera
    return make_camera([0.0, l, math.pi / 2, phi], [-1.0, 0.0, 0.0],
                       [0.0, 0.0, 1.0], 15.0, 43.0, res, res, device=DEVICE)


def compare(sign_k, sign_p, w_k, w_p):
    """Agreement of a kernel with its plain version: fraction of equal
    signs, the p99 angle between escape directions and their max abs
    difference, over rays whose sign is +-1 in both."""
    import torch
    sign_eq = (sign_k == sign_p).double().mean().item()
    esc = ((sign_k.abs() == 1) & (sign_p.abs() == 1))
    a = torch.stack(w_k, -1)[esc].double()
    b = torch.stack(w_p, -1)[esc].double()
    ang = torch.atan2(torch.linalg.cross(a, b).norm(dim=-1),
                      (a * b).sum(-1)).cpu().numpy()
    import numpy as np
    p99 = float(np.percentile(ang, 99)) if ang.size else 0.0
    max_abs = float((a - b).abs().max()) if ang.size else 0.0
    return sign_eq, p99, max_abs, float(esc.double().mean())


def phase2_march():
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import march_cuda
    from curvis_tpu_torch.physics.planar import PlanarRays, march_planar_while
    from curvis_tpu_torch.render.fast import _readout, _spawn_frames
    schwarzschild = make_metric("schwarzschild", m=1.0, device=DEVICE)
    configs = [
        (f"ellis {FRAMES}x{RES}^2", make_metric("ellis", rho=1.0, device=DEVICE),
         [camera(5.0, 0.001 * k, RES) for k in range(FRAMES)], MAX_STEPS),
        (f"dneg {SMALL}^2", make_metric("interstellar", m=0.1, a=1e-4, rho=1.0,
                                   device=DEVICE), [camera(5.0, 0.0, SMALL)],
         MAX_STEPS),
        (f"schwarzschild {SMALL}^2", schwarzschild,
         [camera(15.0, 0.0, SMALL)], MAX_STEPS),
        (f"schwarzschild {SMALL}^2 cap {CAP}", schwarzschild,
         [camera(15.0, 0.0, SMALL)], CAP),
    ]
    out = {}
    for name, metric, cams, cap in configs:
        kw = dict(dt=DT, max_steps=cap, escape_radius=R_ESC)
        state, r_hat, e2 = _spawn_frames(metric, cams)
        unused = torch.zeros((1, 3), device=DEVICE)
        rays = PlanarRays(*state, r_hat=unused, e2=unused)
        res_k = march_cuda.march_planar_cuda(metric, rays, **kw)
        sync()
        t0 = time.perf_counter()
        res_p = march_planar_while(metric, rays, **kw)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        w_k = _readout(metric, res_k, state[3], r_hat, e2)
        w_p = _readout(metric, res_p, state[3], r_hat, e2)
        sign_eq, p99, max_abs, esc = compare(res_k.sign, res_p.sign, w_k, w_p)
        steps_eq = (res_k.steps == res_p.steps).double().mean().item()
        kind, scal = march_cuda.march_scalars(metric, DT, R_ESC)
        flat = [t.reshape(-1).contiguous() for t in state]
        kernel_ms = cuda_ms(lambda: march_cuda.launch(
            kind, scal, *flat, max_steps=cap), 3)
        n = rays.l.numel()
        counts = {s: int((res_k.sign == s).sum()) for s in (-1, 0, 1, 2)}
        print(f"[2] march {name}: {n} rays, signs {counts}, sign equal "
              f"{sign_eq:.6f}, steps equal {steps_eq:.6f}, angle p99 "
              f"{p99:.3e} rad over {esc:.4f} of rays, max |dw| {max_abs:.3e}, "
              f"mean steps {res_k.steps.double().mean().item():.1f}, "
              f"max steps {int(res_k.steps.max())}; kernel {kernel_ms:.2f} ms "
              f"({n / kernel_ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms")
        require(sign_eq >= SIGN_EQ_MIN, f"march {name}: sign equal {sign_eq}")
        require(steps_eq >= STEPS_EQ_MIN,
                f"march {name}: steps equal {steps_eq}")
        require(p99 < ANGLE_P99_MAX, f"march {name}: angle p99 {p99}")
        for who, res in (("kernel", res_k), ("plain", res_p)):
            require(int(res.steps.max()) <= cap
                    and bool((res.steps[res.sign == 0] == cap).all()),
                    f"march {name}: {who} overshot or undershot the cap")
        out[name] = dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms)
    return out[f"ellis {FRAMES}x{RES}^2"]


def phase3_fused(bgp, bgn):
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import render_fused
    from curvis_tpu_torch.render.fast import render_planar_fast
    metric = make_metric("ellis", rho=1.0, device=DEVICE)
    cam = camera(5.0, 0.0, RES)
    kw = dict(dt=DT, max_steps=MAX_STEPS, escape_radius=R_ESC)
    *w_k, sign_k = render_fused.fused_directions(metric, cam, **kw)
    sync()
    t0 = time.perf_counter()
    *w_p, sign_p = render_fused.render_planar_fused_plain(metric, cam, **kw)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    sign_eq, p99, max_abs, esc = compare(sign_k, sign_p, w_k, w_p)
    kind, row = render_fused._fused_row(metric, cam, DT, R_ESC)
    kernel_ms = cuda_ms(lambda: render_fused.launch(
        kind, row, RES, RES, MAX_STEPS, cam.device), 3)
    neg_share = (sign_k == -1).double().mean().item()
    n = RES * RES
    print(f"[3] fused ellis {RES}^2: sign equal {sign_eq:.6f}, angle p99 "
          f"{p99:.3e} rad over {esc:.4f} of rays, max |dw| {max_abs:.3e}; "
          f"kernel {kernel_ms:.2f} ms ({n / kernel_ms / 1e3:.1f} Mrays/s), "
          f"plain {plain_ms:.1f} ms")
    require(sign_eq >= SIGN_EQ_MIN, f"fused: sign equal {sign_eq}")
    require(p99 < ANGLE_P99_MAX, f"fused: angle p99 {p99}")
    img_f = render_fused.render_planar_fused(metric, cam, bgp, bgn, **kw)
    img_m = render_planar_fast(metric, cam, bgp, bgn, **kw)
    diff = ((img_f - img_m).abs().amax(-1) > 1e-6).double().mean().item()
    print(f"[3] fused image vs march-kernel image: {diff:.6f} of pixels "
          f"differ by > 1e-6")
    require(diff <= IMAGE_DIFF_MAX, f"fused vs march image: {diff}")
    return dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                neg_share=neg_share)


def phase4_headline(bgp, bgn):
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import march_cuda, render_fused
    from curvis_tpu_torch.ops.render_fused import render_planar_fused
    from curvis_tpu_torch.render.fast import render_frames_batched
    metric = make_metric("ellis", rho=1.0, device=DEVICE)
    cams = [camera(5.0, 0.001 * k, RES) for k in range(FRAMES)]
    kw = dict(dt=DT, max_steps=MAX_STEPS, escape_radius=R_ESC,
              filtering="nearest")
    rays = FRAMES * RES * RES

    def fused():
        return [render_planar_fused(metric, c, bgp, bgn, **kw) for c in cams]

    def batched():
        return render_frames_batched(metric, cams, bgp, bgn, **kw)

    march_cuda.launches = 0
    render_fused.launches = 0
    imgs_f = torch.stack(fused())                      # warm-up
    ms_f = cuda_ms(fused, REPS)
    imgs_b = batched()                                 # warm-up
    ms_b = cuda_ms(batched, REPS)
    launches = {"march": march_cuda.launches, "fused": render_fused.launches}
    for name, imgs, ms in (("render_planar_fused", imgs_f, ms_f),
                           ("render_frames_batched", imgs_b, ms_b)):
        require(tuple(imgs.shape) == (FRAMES, RES, RES, 3),
                f"{name}: shape {tuple(imgs.shape)}")
        require(bool(torch.isfinite(imgs).all()), f"{name}: non-finite")
        lit = [(im.sum(-1) > 0).double().mean().item() for im in imgs]
        print(f"[4] {name}: {FRAMES} x {RES}^2 in {ms:.2f} ms (median of "
              f"{REPS}) = {rays / ms / 1e3:.1f} Mrays/s; lit fraction "
              f"{min(lit):.6f}..{max(lit):.6f}")
        require(min(lit) > LIT_MIN, f"{name}: lit fraction {min(lit)}")
    diff = ((imgs_f - imgs_b).abs().amax(-1) > 1e-6).double().mean().item()
    print(f"[4] fused vs batched headline images: {diff:.6f} of pixels "
          f"differ by > 1e-6")
    require(diff <= IMAGE_DIFF_MAX, f"fused vs batched images: {diff}")
    return launches, ms_f, ms_b


def main():
    smi = phase0_toolchain()
    import numpy as np
    import torch
    from curvis_tpu_torch.env.spherical_image import make_spherical_image
    build_s = phase1_build()
    rng = np.random.default_rng(0)
    bgp = make_spherical_image(rng.random(SKY, dtype=np.float32),
                               device=DEVICE)
    bgn = make_spherical_image(rng.random(SKY, dtype=np.float32),
                               device=DEVICE)
    march = phase2_march()
    fused = phase3_fused(bgp, bgn)
    print(f"[3] share of pixels from the negative-side sky (ellis {RES}^2, "
          f"phi = 0): {fused['neg_share']:.6f}")
    launches, ms_f, ms_b = phase4_headline(bgp, bgn)
    print(f"[5] launch counters over the headline run: {launches}")
    require(launches["march"] > 0 and launches["fused"] > 0,
            f"a kernel of the main path was not launched: {launches}")
    kernels = [
        dict(name="march_planar_kernel", route="cuda",
             source="curvis_tpu_torch/csrc/planar_march.cu",
             replaces="curvis_tpu/ops/march_pallas.py:303",
             launches=launches["march"], max_abs_err=march["max_abs_err"],
             ms=march["ms"], plain_ms=march["plain_ms"]),
        dict(name="render_fused_kernel", route="cuda",
             source="curvis_tpu_torch/csrc/render_fused.cu",
             replaces="curvis_tpu/ops/render_fused.py:150",
             launches=launches["fused"], max_abs_err=fused["max_abs_err"],
             ms=fused["ms"], plain_ms=fused["plain_ms"]),
    ]
    print(f"[5] build {build_s:.1f} s; headline fused {ms_f:.2f} ms, "
          f"batched {ms_b:.2f} ms on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
