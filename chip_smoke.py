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
  5. the launch counters of that headline run;
  6. the checkpoint kernels (gen #9, bwd #10) against their plain versions
     on the same (y0, theta, steps, seeded random cotangent): Ellis and
     DNEG at 256^2, Schwarzschild at 256^2 (with captured rays), RN at
     128^2; the checkpoints against the march kernel run to s * seg steps;
  7. the headline trainer: fit() takes 5 Adam steps on rho through
     render_direct(differentiable='adjoint') (Ellis, 1024^2, bilinear
     lookup, the weak-deflection viewpoint), with the gradient of the
     kernel pair against the plain pair at 128^2, the per-step time split
     into forward, gen and bwd, and the launch counts of the trainer run;
  8. the adaptive DP5(4) march kernel (#4) against its plain version at
     its default tolerances (rtol 1e-5, atol 1e-7): Ellis on the headline
     ray bundle, DNEG and Schwarzschild at 256^2, Schwarzschild with a cap
     of 20 accepted steps that most rays reach (exactly), and Ellis 256^2
     with 16 rays poisoned to NaN (which must freeze as sign 3); exact
     equality (the source is built without FMA contraction), with a
     digest of the outputs;
  9. the fused rk45 kernel (#3) against its plain version (Ellis 1024^2,
     rtol 1e-3), the fused rk45 image against the rk45 march-kernel image,
     rk45 against the Euler march kernel on the headline view, and the
     quality-mode headline: render_planar_fused(stepper='rk45', rtol=1e-3,
     max_steps=4000) over the 4 headline poses, render_frames_batched(
     stepper='rk45') on the same poses, DNEG fused rk45 at 1024^2 and
     render_planar_adaptive(stepper='rk45') on the headline view, with the
     launch counts of that run and a profile of the fused job;
 10. the disk-crossing march kernel (#5) against its plain version: the
     black-hole disk view (Schwarzschild, r = 28, theta = pi/2 - 0.2,
     30 mm, escape radius 80) at 1024^2, RN and an Ellis wormhole disk at
     256^2, a step cap of 1500 that most rays reach, 16 NaN rays, and the
     starlight map's 64 x 256 reduced rays;
 11. the volumetric-transfer march kernel (#6) against its plain version:
     tint at 1024^2; blackbody, redshift / Doppler on and off and the
     starlight scatter source (a real map's block) at 512^2; a kappa that
     freezes rays at tau_max, RN and Ellis at 256^2;
 12. the disk path end to end at 1024^2 (examples/render_blackholes.py):
     render_blackhole_disk thin blackbody, the starlight map (64 x 128,
     256 samples) and the starlit frame, volumetric tint / blackbody /
     blackbody + scatter, render_disk_frames_batched over 4 poses and the
     CLI's image --disk at 256^2, with each job's launches of #5 and #6,
     the thin frame against the route with #5's plain version, and
     profiles of a thin and a volumetric frame;
 13. the Kerr RK4 march kernel (#7) against its plain version: the
     example's bare Kerr view (a = 0.9, r = 28, theta = pi/2 - 0.2, 24 mm,
     dt 0.1, escape radius 56) at 960 x 540, Kerr-Newman at 256^2, the
     disk tracker and the volumetric variants (tint / blackbody, beaming
     on and off, the scatter source of a real Kerr starlight map) at
     480 x 270 (the volumetric ones capped at 1000 steps), a kappa that
     freezes rays at tau_max, a step cap of 150 that most rays reach, 16
     NaN rays (sign 3) and the starlight map's 48 x 128 ray bundle;
 14. the Kerr path end to end at 960 x 540 (examples/render_blackholes.py:
     72-133): the bare shadow, the thin blackbody disk, the volumetric gas
     disk, the Kerr starlight map, the starlit thin disk, the in-gas
     scatter and Kerr-Newman, render_kerr_frames_batched over 4 poses,
     render_kerr_adaptive and the CLI's Kerr image at 256^2, with each
     job's launches of #7, the shadow's captured fraction and its spin
     asymmetry, and profiles of a thin and a volumetric frame;
 15. the Kerr DP5(4) march kernel (#8) against its plain version at rtol
     1e-4: the bare Kerr view at 960 x 540, Kerr-Newman at 256^2, the
     disk tracker and the volumetric variants at 480 x 270 (the
     volumetric ones capped at 250 accepted steps), a tau_max
     freeze, a step cap of 8 and a max_iters of 15 (16) that most rays
     reach, 16 NaN rays (sign 3), rays parked on the escape radius (which
     must escape) and the starlight map's 48 x 128 bundle, with a digest
     of each case's outputs;
 16. the Kerr path with stepper='rk45' end to end at 960 x 540: the jobs
     of phase 14 and the CLI's image --stepper rk45 at 256^2, with each
     job's launches of #8 (and none of #7), the disk-fraction and shadow
     gates, the bare, thin and volumetric frames against their RK4
     renders over a smooth sky, and profiles of a thin and a volumetric
     frame;
 17. kernel #4's surface variants (csrc/planar_rk45_disk.cu) against
     their plain version at rtol 1e-5 on the disk view of phases 10-12:
     the disk tracker at 1024^2, the volumetric variant with every flag
     set (tint / blackbody, redshift and Doppler on and off, the scatter
     source of a real rk45 starlight map) at 512^2 and 256^2 (capped at
     300 accepted steps), an Ellis
     wormhole disk with far-sheet hits, a kappa that freezes rays at
     tau_max, a step cap that most rays reach, 16 NaN rays in the tracker
     (sign 3) and in the gas (sign 0 at max_iters, as in the TPU kernel:
     the gas clamp turns their dt NaN) and the starlight map's 64 x 256
     bundle; exact equality, as the source is built without FMA
     contraction;
 18. the disk path with stepper='rk45' (rtol 1e-5) end to end at 1024^2:
     the thin blackbody frame, the rk45 starlight map and the starlit
     frame, the volumetric blackbody frame, the volumetric starlit frame
     (in-gas scatter) and render_disk_frames_batched over 4 poses, with
     each job's launches of the new kernel (and none of #5 or #6), the
     thin, starlit and volumetric frames against their Euler renders over
     a smooth sky, tau and emission against the Euler quadrature, and
     profiles of a thin and a volumetric frame;
 19. the surface variants of the checkpoint kernels #9 / #10
     (csrc/ckpt_surface.cu) against their plain versions with a step cap
     of 640: the thin disk on the path's view at 1024^2 and an Ellis
     wormhole disk (far-sheet hits) at 256^2, the volumetric tint,
     blackbody + redshift + Doppler and blackbody + scatter at 256^2;
     checkpoints, lam and g_theta within rtol 1e-3, the ray-summed slot
     cotangents, gen's final state against the forward kernel (hits equal
     on >= 99.9 % of rays, tau and emission within rtol 1e-3);
 20. the differentiable disk path at 1024^2: render_blackhole_disk(...,
     differentiable='adjoint', disk_theta=...) on the thin blackbody, the
     volumetric tint and the starlit volumetric frame (map precomputed),
     each image equal to the non-differentiable render, the launches of
     #5 / #6 and the surface kernels (none of #1 or #4), the step's time
     split and the checkpoint buffer; d loss / d brightness (1 %),
     kappa and M (5 %) against central differences over a black sky;
     fit() of kappa from 30 % off on the volumetric frame, the loss
     falling every step; profiles of a thin frame's and a volumetric
     trainer step's forward + backward;
 21. the planar rk45 variants of the checkpoint kernels #9 / #10
     (csrc/ckpt_rk45.cu, csrc/ckpt_surface_rk45.cu) against their plain
     versions at rtol 1e-5: bare Ellis on the trainer view at 1024^2 (and
     256^2 with freeze_controller), DNEG, Schwarzschild (captured rays) and
     RN (freeze_controller) at 256^2, a max_iters of 30 that most rays
     reach, 16 NaN rays (sign 3, zero lam); the thin disk and the
     volumetric tint on the disk view at 1024^2, blackbody + redshift +
     Doppler (freeze_controller) and blackbody + scatter at 256^2, RN and
     Ellis thin and Ellis vol at 256^2, every surface case capped at 128
     iterations; gen's final state bit for bit against #4 on every ray
     (one step source), checkpoints equal, lam and g_theta within rtol
     1e-3, the ray-summed slot cotangents;
 22. the planar rk45 gradients at full width: the 1024^2 Ellis trainer
     through render_direct(stepper='rk45', differentiable='adjoint'):
     one step's launches (#4 and the rk45 pair once, no Euler kernel),
     the image against render_planar_fast(stepper='rk45'), the time split,
     d / d rho of the kernel pair against the plain pair at 128^2 and
     against a central difference, fit() 5 Adam steps on rho; one
     differentiable rk45 disk step at the disk view, 1024^2: thin
     blackbody (d / d M, brightness) and volumetric tint (d / d kappa,
     brightness), each image equal to the non-differentiable rk45 render,
     central differences over a black sky, differentiable=True through
     the kernels;
 23. the Kerr RK4 and DP5(4) families of the checkpoint kernels #9 / #10
     (csrc/ckpt_kerr.cu, csrc/ckpt_kerr_rk45.cu) against their plain
     versions: RK4 on the bare 960 x 540 view of phase 13 capped at 320
     steps, Kerr-Newman (q 0.6) at 256^2 and 16 NaN rays (sign 3, zero
     lam) capped at 160; DP5(4) at rtol 1e-4 on the bare view, frozen at
     256^2, Kerr-Newman at 256^2 and 16 NaN rays capped at 48 iterations,
     a max_iters of 16 most rays reach; gen's final state bit for bit
     against #7 / #8 on every ray
     (one step source, one set of flags), checkpoints equal, lam and
     g_theta within rtol 1e-3, the ray-summed metric slots;
 24. the Kerr gradients at full width: one render_kerr(backend='adjoint')
     loss-and-gradient step on the a = 0.9 view at 960 x 540 (RK4, dt 0.1,
     32 000 steps; and stepper='rk45', rtol 1e-4), each image equal to the
     non-differentiable render, #7 or #8 launched once and its pair once
     (no other kernel), the time split and the checkpoint buffer; d / d(M,
     a) of the kernel pair against the plain pair at 128^2; d / da against
     a central difference on the spin-recovery view of
     examples/inverse_problem.py (r = 15, shadow out of view, escape
     radius 20) over a smooth sky, and descent steps on a with the loss
     falling every step; render_kerr(backend='scan') on that view at
     128^2 for each stepper (the plain-PyTorch routes: RK4 through
     march_hamiltonian_scan, DP5(4) through the twin pair), its image and
     d / da against the adjoint's, and no kernel launched;
 25. the Kerr surface families of the checkpoint kernels #9 / #10
     (csrc/ckpt_kerr_surface.cu, csrc/ckpt_kerr_surface_rk45.cu) against
     their plain versions: RK4 on the thin disk of the 960 x 540 view
     capped at 400 steps, the gas tint, blackbody + beaming and blackbody +
     beaming + a seeded scatter block at 128^2 capped at 150, 16 NaN rays
     in the thin disk (sign 3, zero lam and g_theta); DP5(4) at rtol 1e-4
     on the same families (the thin disk at 480 x 270 capped at 96
     iterations, the gas at 40; frozen twice); gen's final state (hits,
     tau, emission) bit for bit
     against #7 / #8 on every ray, checkpoints equal, lam and g_theta within
     rtol 1e-3, the ray-summed theta rows;
 26. the Kerr surface gradients at full width: one render_kerr(disk=...,
     backend='adjoint', disk_theta=...) loss-and-gradient step at 960 x 540
     on the thin disk and the gas, RK4 and rk45, each image equal to the
     backend='auto' render, #7 or #8 and the surface pair launched once,
     the time split and the checkpoint buffer; d / da, d / dr_in and d /
     dkappa against central differences over the pixel channels in the
     linear regime; two descent steps on examples/disk_image_recovery.py's
     view with the loss falling; backend='scan' against the adjoint at
     48^2 on the gas, each stepper (black sky, outside the grown shadow;
     rk45's float32 d/da printed, not gated), with no kernel launched;
 27. the tabulated user metrics (metrics/table.py; csrc/table.cuh) in
     kernels #1-#4 and #9 / #10's planar Euler and DP5(4) families against
     their plain versions: the asymmetric Bell wormhole of
     benchmarks/parity_gates.py:402-425 as a degree-16 Horner and a
     degree-24 Clenshaw table; #1 on the headline 4 x 1024^2 bundle (h16)
     (c24's march is held through the Euler pair's checkpoints), #2 (h16)
     and #3 (c24, rtol 1e-3) at 1024^2 by
     phases 2, 3 and 9's gates, #4 bare at 1024^2 (h16) and 256^2 (c24)
     exactly, with digests; the Euler pair at 256^2 capped at 640 steps
     (checkpoints against #1's trajectory, the per-ray table cotangents
     against the plain pair) and the DP5(4) pair at 256^2 capped at 48
     iterations (exact; c24 frozen); a degree-40 table raises before any
     launch;
 28. the slice's path at full width: the JAX package's cheb headline row
     (an Ellis degree-12 table, 4 poses x 1024^2, Euler dt 0.05, 40 000
     steps, R 100, nearest) through render_planar_fused and
     render_frames_batched, and its quality mode (rk45, rtol 1e-3), each
     against the analytic Ellis render of the same poses (signs, angle
     percentiles) with its launch counts; the shape trainer: fit() takes 5
     Adam steps on the three coefficients of a tabulate_metric_diff shape
     through render_direct(differentiable='adjoint') at 1024^2, Euler and
     DP5(4), with the step split into forward, gen and bwd, the
     checkpoint MiB and the launch counts; d loss / d theta1 against a
     central difference at 128^2.

The line before the last is a JSON object with each kernel's launches,
error against its plain version, times and bound; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import re
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

SEG = 32                   # checkpoint segment of the backward kernels
CKPT_CAP = 4000            # step cap of the checkpoint-kernel checks
CKPT_EQ_MIN = 0.999        # rays whose checkpoints equal the march kernel's
GRAD_RTOL = 1e-3           # kernel pair vs plain pair, per ray and summed
GRAD_FRAC_MIN = 0.99       # rays within GRAD_RTOL (all 7 outputs)
TRAIN_ITERS = 5
TRAIN_LR = 5e-2
GRAD_RES = 128             # side of the kernel-vs-plain gradient check

RK45_MAX_STEPS = 4_000     # the quality mode's budget of accepted steps
RK45_RTOL = 1e-3           # the quality row's tolerance (bench.py:349-384)
RK45_CAP = 20              # below the mean accepted steps at rtol 1e-5:
                           # most rays stop at it, and must stop exactly there
STEPS_NEAR = 2             # accepted steps within which kernel and plain agree
N_POISON = 16              # rays set to NaN, which must freeze as sign 3
ACC_RES = 128              # side of the accuracy check against f64 rk45
ACC_RTOL = 1e-10           # its reference's tolerance (atol 1e-3 rtol)

# The black-hole disk path (examples/render_blackholes.py:43-70): a
# Schwarzschild hole (M = 1) seen from r = 28 at theta = pi/2 - 0.2 through
# a 30 mm lens, Euler dt = 0.05, 40 000 steps, escape radius 80.
DISK_L = 28.0
DISK_TH = math.pi / 2 - 0.2
DISK_FOCAL = 30.0
DISK_R = 80.0
DISK_VOL_RES = 512         # side of most volumetric kernel-vs-plain cases
DISK_VOL_CHECK_CAP = 1000  # step cap of #6's kernel-vs-plain cases: rays
                           # cross the gas by then (mean ~1 930 to escape);
                           # the plain loop ran to the slowest (~2 430)
DISK_CAP = 1500            # a step cap below the mean (~1 980): most rays
                           # stop at it, and must stop exactly there
DISK_NAN_CAP = 3000        # the cap of the NaN case (NaN rays never end)
DISK_THIN = dict(r_inner=5.2, r_outer=14.0, color_mode="blackbody",
                 t_peak=7000.0, brightness=14.0)
DISK_STAR = dict(r_inner=5.2, r_outer=14.0, brightness=0.35, starlight=True,
                 albedo=(0.55, 0.55, 0.6), starlight_samples=256,
                 starlight_grid=(64, 128))
DISK_VOL = dict(r_inner=5.2, r_outer=13.0, volumetric=True, h_rel=0.08,
                kappa=3.0)     # the parity gate's (parity_gates.py:159-161)
HIT_EQ_MIN = 0.995         # rays whose hit presence (h1 != 0) is equal
HIT_P99_MAX = 1e-3         # p99 relative hit radius and |dpsi| at the hit
DISK_IMG_TOL = 1e-3        # thin-disk image vs the plain route: at most
DISK_IMG_FRAC_MAX = 0.01   # this fraction of pixels beyond DISK_IMG_TOL
DISK_FRAC = (0.05, 0.6)    # fraction of disk pixels in a disk frame
DISK_LIT_MIN = 0.8         # lit pixels (sky and disk) of a disk frame
# The Kerr path (examples/render_blackholes.py:72-133 at its 960 x 540): a =
# 0.9, camera at r = 28, theta = pi/2 - 0.2, 24 mm lens, dt 0.1, 32 000
# steps, escape radius 2 r_cam, disk band 2.6-12; the volumetric jobs at
# r = 24, 28 mm, dt 0.08, 12 000 steps, escape radius 60, kappa 3, h 0.07.
KERR_RES = (960, 540)
KERR_SMALL = (480, 270)    # side of most thin / volumetric kernel cases
KERR_A = 0.9
KERR_L = 28.0
KERR_DT = 0.1
KERR_STEPS = 32_000
KERR_BAND = (2.6, 12.0)
KERR_VOL = dict(l=24.0, focal=28.0, dt=0.08, steps=12_000, R=60.0)
KERR_VOL_CHECK_CAP = 700   # step cap of the volumetric #7-vs-plain cases:
                           # mean ~630 steps, but the plain loop runs to the
                           # slowest ray's (~2 300), ~30 ms a step (at
                           # 1 000 a slower host took 9-12 s a case)
KERR_CHECK_CAP = 600       # step cap of #7's bare, tracker, NaN and map
                           # kernel-vs-plain cases (means ~275-515; their
                           # plain loops ran to the slowest ray, ~1 100-1 700)
KERR_CAP = 150             # a step cap below the mean (~320): most rays
                           # reach it
KERR_ANGLE_P99 = 1e-3      # p99 escape angle, kernel vs plain (rad)
KERR_SHADOW = (0.02, 0.2)  # captured fraction of the bare 960 x 540 view
KERR_SHIFT_MIN = 10.0      # shadow centroid shift, a = 0.9 vs 0.001 (px)
KERR_VOL_FRAC = (0.05, 0.85)   # disk pixels of the volumetric frames: the
                               # gas covers ~63 % of that view (a CPU count
                               # at 96 x 54), more than a thin disk

# Roofline of one H100 SXM (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations counted from csrc/planar.cuh (a division counts as one):
# an Ellis Euler step (RHS + update), its hand-written VJP, and the fused
# kernel's per-pixel camera ray + spawn + readout (csrc/render_fused.cu).
FLOP_STEP = 14
FLOP_VJP = 33
FLOP_FUSED_PIXEL = 100
# One DP5(4) iteration of an Ellis ray (csrc/rk45.cuh:rk45_iter): 7 RHS of 8,
# the 21 stage terms of l and p_l (105, dt * a shared), the 5th- and
# 4th-order combinations (69), y5 (6), the error norm (26), escape,
# writeback, capture, stall and controller (~18); an exp or a log counts
# as one.
FLOP_RK45_ITER = 280
# A Schwarzschild Euler step of kernel #5 (csrc/disk.cu; an FMA counts as
# two): RHS 15, Euler + rotation 12, crossing test and hit bookkeeping 33,
# psi and sign 4.  Kernel #6 (csrc/disk_vol.cu): the step, density, edges,
# transmittance, accumulation and sign 66; redshift + Doppler 27 (lapse
# kinds); tint 11 or blackbody 51; the scatter source 60.
FLOP_DISK_STEP = 64
FLOP_VOL = dict(base=66, shift=27, tint=11, blackbody=51, scatter=60)
# One RK4 step of kernel #7 (csrc/kerr.cu): four Carter-form RHS of 77
# (sincos as two, three divisions), the stage and update arithmetic, the
# axis and far-field dt scales, the blowup guard and the sign: 390; the
# disk tracker 8; the volumetric emission 40, its beaming g 25, tint 10 or
# blackbody 51, the scatter source 60.
FLOP_KERR_STEP = 390
FLOP_KERR = dict(disk=8, vol=40, beaming=25, tint=10, blackbody=51,
                 scatter=60)
# The Kerr DP5(4) path: the jobs above with stepper='rk45' at the JAX
# default rtol 1e-4 (atol = rtol 1e-3, dt_max = R / 8, dt_min = 1e-5; dt is
# the initial step and max_steps counts accepted steps).
KERR_RTOL = 1e-4
KERR_RK45_CAP = 8          # below the mean accepted steps (~20 bare): most
                           # rays stop at it
KERR_RK45_VOL_CHECK_CAP = 250   # accepted-step cap of the volumetric
                           # #8-vs-plain cases: mean ~193, slowest ~490
KERR_RK45_ITERS = 15       # a small odd max_iters (rounded up to 16) that
                           # many rays reach (~25 iterations on average)
RK45_DIFF = 0.1            # a pixel differs from the RK4 render by more,
RK45_DIFF_MAX = dict(bare=0.02, thin=0.03, vol=0.02)  # on at most this share
RK45_FLUX_MAX = 0.02       # relative total flux, volumetric rk45 vs RK4
# One DP5(4) iteration of kernel #8 (csrc/kerr_rk45.cu; an FMA counts as
# two, a division, sin, cos, exp or log as one): seven Carter RHS of 77
# (539), the 21 stage terms on four components (189), the 5th- and
# 4th-order sums (102), y1 (10), the error norm (35), boundary stepping,
# writeback, guard and sign (20), the controller (15): 910; the disk
# tracker and its clamp 8, the gas-slab clamp 15 an iteration; the
# emission of an accepted step as #7's (FLOP_KERR) plus 8 for its sums.
FLOP_KERR_RK45_ITER = 910
FLOP_KERR_RK45 = dict(disk=8, vol_clamp=15, vol_sum=8)
# The disk path with stepper='rk45' (kernel #4's surface variants): the JAX
# disk routes' default rtol 1e-5 (atol = rtol 1e-3, dt_max 10; dt the
# initial step, to which the step clamps near the disk, and max_steps
# counts accepted steps).
RK45_DISK_RTOL = 1e-5
RK45_DISK_CAP = 40         # below the mean accepted steps of the path's
                           # thin view (~69): most rays stop at it
RK45_DISK_VOL_CHECK_CAP = 300   # accepted-step cap of the volumetric
                           # #4-vs-plain cases: mean ~237, slowest ~860
RK45_DISK_NAN_CAP = 100    # the vol NaN case's cap: NaN rays run to
                           # max_iters = 4 x this (module docstring)
RK45_DISK_DIFF_MAX = 0.03  # rk45 vs Euler frames over a smooth sky: share
                           # of pixels differing by > RK45_DIFF
                           # (tests/test_rk45.py:233-259)
RK45_DISK_L1_MAX = 0.03    # relative L1 of tau and emission, rk45 vs the
                           # Euler quadrature (tests/test_rk45.py:209-230)
# One DP5(4) iteration of kernel #4 on a lapse kind (csrc/rk45.cuh): the
# bare iteration of FLOP_RK45_ITER with seven Schwarzschild RHS of 18 in
# place of Ellis's 8 (350); the surface variants (csrc/planar_rk45_disk.cu)
# add per iteration zq (sincos as two, 5) and the crossing test and plane
# clamp (10), or zq and the gas clamp (22), and per accepted vol step the
# emission's density, edges and transmittance and the four sums (48), the
# shifts, colour and scatter source as kernel #6's (FLOP_VOL).
FLOP_RK45_ITER_LAPSE = 350
FLOP_RK45_DISK = dict(track=15, vol_clamp=22, emission=48)
# The surface checkpoint kernels (csrc/ckpt_surface.cu; an FMA counts as
# two, a division, exp, log or sqrt as one): gen takes the forward step
# (FLOP_DISK_STEP, or kernel #6's FLOP_VOL); bwd re-takes it (the re-march,
# counted once, as for every other family) and adds its VJP's reverse
# work: thin 116 (the crossing's and rotation's reverse 68, a Schwarzschild
# RHS VJP 48); volumetric the RHS VJP 48, the emission's reverse by part as
# FLOP_SURF_VOL_VJP.  The kernels recompute the step inside the VJP on top.
FLOP_SURF_THIN_VJP = 116
FLOP_SURF_VOL_VJP = dict(base=48, emission=70, shift=50, tint=20,
                         blackbody=90, scatter=100)
SURF_CAP = 640             # step cap of the surface kernel-vs-plain checks:
                           # rays reach the disk (~280-560 steps from r = 28)
                           # and the plain pair takes seconds
SURF_EQ_MIN = 0.999        # rays whose gen final hits equal kernel #5's
SURF_FD = dict(brightness=0.01, kappa=0.01, m=1e-4)   # relative CD steps
SURF_FD_LIN = 0.1          # a pixel channel whose second difference at
                           # the CD step exceeds this share of its first
                           # is not in the linear regime there
SURF_FD_KEEP = 0.9         # least share of pixel channels in that regime
SURF_FD_TOL = dict(brightness=0.01, kappa=0.05, m=0.05, a=0.05,
                   r_inner=0.05)
SURF_TRAIN = dict(iters=5, lr=0.15, start=1.3)   # kappa from 30 % off
# The planar rk45 gradients (the rk45 checkpoint kernels, csrc/ckpt_rk45.cu
# and csrc/ckpt_surface_rk45.cu): segments of 16 iterations (the JAX
# package's _PALLAS_SEG); the trainer marches from dt 0.05 as the first
# step, up to 4 000 accepted steps, at #4's defaults (rtol 1e-5, atol 1e-7).
RK45_SEG = 16
RK45_TRAIN_STEPS = 4000
RK45_ADJ_ITERS = 26        # a max_iters most rays of the 256^2 view reach
RK45_SURF_ITERS = 96       # the iteration cap of the surface kernel-vs-
                           # plain cases: the plain pair takes ~30 ms an
                           # iteration at 1024^2 (the path's rays take ~70
                           # on the thin view, ~170 through the gas)
RK45_GRAD_FRAC_MIN = 0.999 # entries of lam and g_theta within GRAD_RTOL
RK45_FD_H = 0.1            # the trainer's central-difference step in rho:
                           # an accept that flips between the two renders
                           # moves a ray by ~rtol, so the step must make
                           # the weak-deflection view's change large
                           # against that (the JAX tests take rtol 1e-9,
                           # below float32)
RK45_FD_TOL = 0.01
RK45_DISK_FD = dict(brightness=0.01, kappa=0.01, m=1e-4)   # relative steps
RK45_DISK_FD_RTOL = 1e-6   # the central differences' rtol: at 1e-5 the
                           # float32 march's d/dM (kernels and twin pair
                           # alike) missed the float64 difference by 6-15 %
                           # on the H100, at 1e-6 by 1.1 % (PERF.md);
                           # the 1e-5 comparison is printed beside it
# The reverse work of one DP5(4) iteration's VJP (csrc/rk45_vjp.cuh; an
# FMA counts as two): seven RHS VJPs (25 Ellis, 45 lapse), the 21 stage
# terms reversed on l and p_l (168), the combinations (63), the error norm
# (40), escape, write-back and controller (30).  The surface VJPs
# (csrc/ckpt_surface_rk45.cu) add the reverse of the crossing or the gas
# clamp and of the emission.  The bound counts the iteration once (bwd's
# re-march); the kernels recompute it in the VJP on top.
FLOP_RK45_VJP = 476
FLOP_RK45_VJP_LAPSE = 616
FLOP_RK45_SURF_VJP = dict(track=40, vol=150)
# The Kerr gradients (the checkpoint kernels' Kerr families,
# csrc/ckpt_kerr.cu and csrc/ckpt_kerr_rk45.cu): RK4 in segments of 32
# steps, DP5(4) in segments of 16 iterations (the JAX package's
# _PALLAS_SEG of each).
KERR_SEG = {"rk4": 32, "rk45": 16}
KERR_CKPT_CAP = 240        # step cap of the RK4 kernel-vs-plain checks: the
                           # plain pair takes ~30 ms a step at 960 x 540
                           # (the view's rays take ~310 on average; 640
                           # until the Kerr surface phases, 320 until the
                           # table disk phases needed the time)
KERR_CKPT_ITERS = 36       # and the iteration cap of the 256^2 DP5(4) ones
                           # (their longest rays took ~100 iterations)
KERR_ADJ_ITERS = 16        # a max_iters most rays of the 256^2 rk45 view
                           # reach (~25 iterations on average)
# The VJPs' reverse work (csrc/kerr_vjp.cuh; an FMA counts as two, a
# division, sin, cos, exp or log as one): one Carter RHS's VJP reverses its
# ~60 forward operations in ~150 (~10 more guarded); the RK4 step's VJP
# reverses four RHS (840), the stage sums and the dt scales (~110): 950;
# the DP5(4) iteration's VJP reverses seven guarded RHS (1540), the 21
# stage terms on four components (~340), y1, the error norm and the
# controller (~130): 2010.  The bound counts the forward work once a step
# (bwd's re-march, FLOP_KERR_STEP or FLOP_KERR_RK45_ITER), as a bwd that
# kept the re-march's stages would; the kernels recompute the stages in
# the VJP (~350 an RK4 step, ~850 a DP5(4) iteration) on top.
FLOP_KERR_VJP = 950
FLOP_KERR_RK45_VJP = 2010
# The spin-recovery view of examples/inverse_problem.py:116-121: r = 15,
# theta = pi/2 - 0.3, 35 mm, tilted (forward (-sin, 1.3, -cos)), the shadow
# out of view; RK4 dt 0.1, 800 steps, escape radius 20.
SPIN_L = 15.0
SPIN_TH = math.pi / 2 - 0.3
SPIN_FD_H = 0.02           # the central difference's step in a
SPIN_FD_TOL = 0.02         # d/da of the kernels vs the central difference
SPIN_DESCENT = dict(steps=4, start=0.6, target=0.85, gain=2e2, cap=0.08)
# backend='scan' against 'adjoint' on the spin-recovery view at
# GRAD_RES^2: the scan marches plain PyTorch (the autodiff-Hamiltonian RK4
# or the DP5(4) twin with its guarded RHS), the adjoint kernels #7 / #8,
# so the two round apart in float32 (and DP5(4) accepts may flip, moving a
# ray by ~rtol): each pixel channel within SCAN_IMG_TOL on a share of at
# least SCAN_IMG_FRAC, d mean(image) / da within SCAN_GRAD_RTOL.
SCAN_IMG_TOL = 1e-3
SCAN_IMG_FRAC = 0.999
SCAN_GRAD_RTOL = dict(rk4=1e-3, rk45=1e-2)
# The Kerr surface gradients (the checkpoint kernels' Kerr surface families,
# csrc/ckpt_kerr_surface.cu and csrc/ckpt_kerr_surface_rk45.cu) on the thin
# disk KERR_BAND and the gas KERR_VOL of phases 13-16.  Their plain pairs
# take ~50 ms a step or iteration at any ray count up to the path's
# 518 400 (launch bound), so the kernel-vs-plain cases run on the path's
# 960 x 540 views capped in steps or iterations, not in rays: the thin
# view at KERR_SURF_CAP (a fifth of its rays cross the band by 400; ~500
# RK4 steps to escape; the clamps near the disk hold dt0, so DP5(4) takes
# ~140-190 iterations), the gas view at KERR_SURF_GAS (the gas lit on
# ~45-75 % of its rays), the NaN rays at KERR_SURF_NAN (they end in the
# first steps).
KERR_SURF_CAP = dict(rk4=320, rk45=80)
KERR_SURF_GAS = dict(rk4=120, rk45=32)
KERR_SURF_NAN = dict(rk4=64, rk45=24)
KERR_SURF_BLOCK = 0.3      # scale of the seeded scatter block of phase 25
# The surfaces' reverse work (csrc/kerr_surface_vjp.cuh; an FMA counts as
# two, a division, sin, cos, exp, log or sqrt as one), beside the RHS and
# stage VJPs of FLOP_KERR_VJP / FLOP_KERR_RK45_VJP: the hit's (the crossing
# fraction, the two mixes, cos theta's chain) 30, counted on every step;
# the emission's geometry head, transmittance, edges and density 150, its
# beaming g 80, the colour tails as the planar FLOP_SURF_VOL_VJP (tint 20,
# blackbody 90, scatter 100), and DP5(4)'s gas-slab clamp 30.
FLOP_KERR_SURF_VJP = dict(hit=30, vol=150, beaming=80, tint=20,
                          blackbody=90, scatter=100, clamp=30)
KERR_SURF_FD = dict(a=1e-3, kappa=0.05, r_inner=0.02)   # relative CD steps
KERR_FD_RING = 0.02        # the shadow grown by this share of the image
                           # width: rays that skim the photon sphere move
                           # their hits and gas paths exponentially in a,
                           # so the central difference of a 2 % step in a
                           # missed d/da by 40 % at 960 x 540 (and, float64
                           # on the CPU, 25 % at 192 x 108 even at 0.1 %,
                           # 0.1 % with the grown shadow left out)
KERR_SCAN_RES = 48         # side of the backend='scan' checks on the card,
KERR_SCAN_STEPS = dict(rk4=160, rk45=60)   # and their step caps: the scan
                           # is launch-bound (~0.13 s an RK4 step: 114 s for
                           # the thin view's full 1 821), and capped rays
                           # compare as well as escaped ones (sign 0 is a
                           # smooth fate); the gas is lit by then
# examples/disk_image_recovery.py's view (96 x 54, r = 18, theta = pi/2 -
# 0.4, its gas disk and knobs): two descent steps on (a, r_in, r_out) from
# its init towards its truth, each knob moved by this share of its value
# against its gradient's sign
KERR_DESCENT = dict(steps=2, rel=0.02)

# The tabulated user metrics (metrics/table.py, csrc/table.cuh): the
# asymmetric Bell wormhole of benchmarks/parity_gates.py:402-425, rho(l) =
# 1 + 0.35 tanh(l / 1.4), as a degree-16 Horner table and a degree-24
# Clenshaw one (the basis tabulate_metric measures for it), and the JAX
# package's cheb headline row (benchmarks/run_benchmarks.py:102-126): an
# Ellis wormhole as a degree-12 table.
TABLE_BELL = dict(h16=dict(degree=16, basis="horner", tol=5e-4),
                  c24=dict(degree=24, basis="clenshaw", tol=1e-4))
TABLE_CKPT_CAP = 640       # step cap of the Euler table pair checks: the
                           # plain pair evaluates the series op by op
TABLE_RK45_ITERS = 36      # iteration cap of the DP5(4) table pair checks
TABLE_SIGN_MIN = 0.97      # table vs analytic Ellis render: signs equal
TABLE_ANGLE = 1e-3         # an escape direction differs beyond this angle
TABLE_MISS_MAX = 0.05      # on at most this share of the rays (gate_table)
TABLE_SUM_TOL = 1e-6       # a ray-summed table cotangent that cancels:
                           # |kernel - plain| within this share of the sum
                           # of its terms' magnitudes
TABLE_SHAPE = dict(rho0=0.1, rho1=0.2, rho2=-0.1)   # the trainer's target
TABLE_FD_H = 0.05          # central-difference step in the trainer's theta1
TABLE_FD_TOL = 0.05
TABLE_TRAIN_LR = 0.01      # the shape trainer's Adam rate: the loss sees
                           # mostly theta0 + theta1 + theta2, which is 0.2
                           # from its target
TABLE_KERNELS = ("march_planar_kernel", "render_fused_kernel",
                 "render_fused_rk45_kernel", "march_planar_rk45_kernel",
                 "ckpt_gen_kernel", "ckpt_bwd_kernel", "ckpt_rk45_gen_kernel",
                 "ckpt_rk45_bwd_kernel", "march_disk_kernel",
                 "march_disk_vol_kernel", "march_planar_rk45_disk_kernel",
                 "ckpt_surface_gen_kernel", "ckpt_surface_bwd_kernel",
                 "ckpt_surface_rk45_gen_kernel",
                 "ckpt_surface_rk45_bwd_kernel")
# The tables on the disk routes (phases 29-30): the Bell h16 table at the
# disk view of phases 10-12 (l = 28, theta = pi/2 - 0.2, 30 mm, dt 0.05,
# 40 000 steps, R 80) with a band both of the wormhole's sheets cross, and
# a degree-12 Ellis table's thin frame against the analytic Ellis frame.
TABLE_DISK_BAND = (3.0, 12.0)
TABLE_DISK_CAP = 800       # step cap of #5 / #6's table plain checks: rays
                           # cross the band by then (~300 steps from
                           # l = 28), and the plain versions sum the series
                           # op by op
TABLE_DISK_ITERS = 128     # iteration cap of #4's surface table checks
TABLE_SURF_CAP = 480       # step cap of the Euler surface table pairs
TABLE_SURF_VOL_CAP = 400   # and of their gas pairs (~100 steps in the gas)
TABLE_SURF_ITERS = 48      # iteration cap of the DP5(4) surface table pairs
TABLE_SURF_SUM_TOL = 1e-4  # a table's ray-summed cotangent of the contracted
                           # Euler surface pairs: |kernel - plain| within
                           # this share of the sum of its terms' magnitudes
                           # (H100: 2.6e-5 read; such sums are ~1e-3 of it)
TABLE_DISK_THETA = (0.1, 0.2, -0.1)   # the disk shape loss's point (shape_fn)
TABLE_FD_VIEW = (12.0, (2.0, 9.0))    # l and band of its central difference
TABLE_WITNESS_RES = 128    # the twin witness: the path's view at this side
TABLE_WITNESS_AGREE = 1e-4  # it leaves out a pixel whose float32 and
                           # float64 frames part by more than this
TABLE_WITNESS_TOL = 1e-2   # and holds the kernels' d loss / d theta to the
                           # float64 twin's on the rest (H100: 1.5e-4 Euler,
                           # 1.4e-4 DP5(4) capped as below; uncapped 1.8e-4,
                           # 3.6e-5 in table_disk_witness.py)
TABLE_WITNESS_STEPS = dict(euler=1200, rk45=100)   # the witness's step
                           # caps: the twin loop runs to the slowest ray
                           # (Euler 2 293 steps, mean 2 101, 41-47 s on an
                           # H100; DP5(4) 437, mean 57, 149 s uncapped)
TABLE_DISK_FD_H = 0.02     # its step in theta1: at 0.05, 11-12 % of the
                           # pixel channels bend within the step there


def table_disk_flops(degree, basis):
    """FP32 operations of the disk families with a table, from table_flops:
    #5's step (FLOP_DISK_STEP with the table's RHS in place of its
    Schwarzschild RHS of 15), #6's step for a flag set (its RHS the table's
    and the emission's radius one more shape evaluation), the Euler surface
    VJPs (the table's RHS VJP in place of FLOP_SURF_*'s 48; the gas one
    more for the radius), and #4's surface iteration and its VJP before
    FLOP_RK45_DISK's surface terms (the gas: one shape and one VJP more for
    the clamp's radius and one each for the emission's)."""
    t = table_flops(degree, basis)
    rhs = t["shape"] + 2

    def vol(flags):
        return vol_flops("table", flags) - FLOP_STEP + t["step"] + t["shape"]

    def vol_vjp(flags):
        return surf_flops("table", flags)[1] - 48 + 2 * t["vjp"]
    return dict(shape=t["shape"], step=FLOP_DISK_STEP - 15 + rhs, vol=vol,
                thin_vjp=FLOP_SURF_THIN_VJP - 48 + t["vjp"], vol_vjp=vol_vjp,
                rk45_iter=t["rk45_iter"], rk45_vjp=t["rk45_vjp"],
                vjp=t["vjp"])


def table_flops(degree, basis):
    """FP32 operations (an FMA counts as two) of a table metric: one shape
    evaluation (csrc/table.cuh:table_shape: w, t and the scalings 8, then
    two series of ~2 (Horner) or ~3 (Clenshaw) operations a degree), its
    reverse work (the series' reverse sweeps, 4 or 6 operations a
    coefficient, the shape's chain 20 and the RHS's 12), an Euler step
    (shape + 8), a DP5(4) iteration (FLOP_RK45_ITER with seven table RHS
    in place of Ellis's 8) and its VJP (seven table RHS VJPs in place of
    Ellis's 25)."""
    horner = basis == "horner"
    shape = 8 + (2 if horner else 3) * 2 * degree
    vjp = 32 + (4 if horner else 6) * 2 * (degree + 1)
    rhs = shape + 2
    return dict(shape=shape, step=shape + 8, vjp=vjp,
                rk45_iter=FLOP_RK45_ITER - 7 * 8 + 7 * rhs,
                rk45_vjp=FLOP_RK45_VJP - 7 * 25 + 7 * vjp)


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
    # per kernel: the range of registers, stack bytes and spill bytes over
    # its instances (kinds and flags), from ptxas's report in build.log
    log = (_build.BUILD_DIR / "build.log").read_text()
    stats, name, inst = {}, None, {}
    for line in log.splitlines():
        # mangled entry names: _ZN6curvis<len><name>, then the template
        # arguments (IL{i,b}<first>E...) or the parameters
        entry = re.search(r"entry function '_ZN6curvis(\d+)(\w+)", line)
        if entry:
            name = entry.group(2)[:int(entry.group(1))]
            args = entry.group(2)[int(entry.group(1)):]
            # the table instances (kind kTable = 5) of the planar kernels,
            # each listed with its template arguments too
            if args.startswith("ILi5E") and name in TABLE_KERNELS:
                name += " [table]"
                inst[(name, args)] = {}
            stats.setdefault(name, {"n": 0, "regs": [], "stack": [],
                                    "spill": []})["n"] += 1
        elif name is not None:
            st = stats[name]
            for key, pat in (("regs", r"Used (\d+) registers"),
                             ("stack", r"(\d+) bytes stack frame"),
                             ("spill", r"(\d+) bytes spill stores")):
                m = re.search(pat, line)
                if m:
                    st[key].append(int(m.group(1)))
                    if name.endswith(" [table]"):
                        inst[(name, args)][key] = int(m.group(1))
    secs_by_src = re.findall(r"^== (\S+) \(([\d.]+) s\)$", log, re.M)
    slow = sorted(secs_by_src, key=lambda t: -float(t[1]))[:4]
    print("[1]   slowest nvcc: " + ", ".join(
        f"{Path(src).name} {secs} s" for src, secs in slow))
    for name, st in sorted(stats.items()):
        rng = {k: (f"{min(v)}-{max(v)}" if v and min(v) != max(v)
                   else str(v[0]) if v else "?")
               for k, v in st.items() if k != "n"}
        print(f"[1]   {name}: {st['n']} instances, {rng['regs']} registers, "
              f"{rng['stack']} B stack frame, {rng['spill']} B spill stores")
    for (name, args), st in sorted(inst.items()):
        print(f"[1]     {name} <{args.split('E', 1)[1][:40]}>: "
              f"{st.get('regs', '?')} registers, {st.get('stack', '?')} B "
              f"stack, {st.get('spill', '?')} B spill stores")
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


def bound(n_bytes, n_flops):
    """(least time in ms the card could take, what bounds it): bytes over
    the memory rate against FP32 operations over the FP32 peak."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def camera(l, phi, res, dtype=None):
    import torch
    from curvis_tpu_torch.camera.camera import make_camera
    return make_camera([0.0, l, math.pi / 2, phi], [-1.0, 0.0, 0.0],
                       [0.0, 0.0, 1.0], 15.0, 43.0, res, res, device=DEVICE,
                       dtype=dtype or torch.float32)


def angles(w_a, w_b, mask):
    """Angles between the escape directions (three components each) of the
    rays in ``mask``, as a numpy array, and the rows compared."""
    import torch
    a = torch.stack(w_a, -1)[mask].double()
    b = torch.stack(w_b, -1)[mask].double()
    return torch.atan2(torch.linalg.cross(a, b).norm(dim=-1),
                       (a * b).sum(-1)).cpu().numpy(), a, b


def compare(sign_k, sign_p, w_k, w_p):
    """Agreement of a kernel with its plain version: fraction of equal
    signs, the p99 angle between escape directions and their max abs
    difference, over rays whose sign is +-1 in both."""
    import numpy as np
    sign_eq = (sign_k == sign_p).double().mean().item()
    esc = ((sign_k.abs() == 1) & (sign_p.abs() == 1))
    ang, a, b = angles(w_k, w_p, esc)
    p99 = float(np.percentile(ang, 99)) if ang.size else 0.0
    max_abs = float((a - b).abs().max()) if ang.size else 0.0
    return sign_eq, p99, max_abs, float(esc.double().mean())


def march_vs_plain(tag, name, metric, cams, cap, step_flops):
    """Kernel #1 against march_planar_while on the rays of ``cams``: signs,
    steps and escape directions (the contracted kernel's gates), the step
    cap, the timings and the bound (``step_flops`` a step)."""
    import torch
    from curvis_tpu_torch.ops import march_cuda
    from curvis_tpu_torch.physics.planar import PlanarRays, march_planar_while
    from curvis_tpu_torch.render.fast import _readout, _spawn_frames
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
    print(f"{tag} march {name}: {n} rays, signs {counts}, sign equal "
          f"{sign_eq:.6f}, steps equal {steps_eq:.6f}, angle p99 {p99:.3e} "
          f"rad over {esc:.4f} of rays, max |dw| {max_abs:.3e}, mean steps "
          f"{res_k.steps.double().mean().item():.1f}, max steps "
          f"{int(res_k.steps.max())}; kernel {kernel_ms:.2f} ms "
          f"({n / kernel_ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms")
    require(sign_eq >= SIGN_EQ_MIN, f"march {name}: sign equal {sign_eq}")
    require(steps_eq >= STEPS_EQ_MIN, f"march {name}: steps equal {steps_eq}")
    require(p99 < ANGLE_P99_MAX, f"march {name}: angle p99 {p99}")
    for who, res in (("kernel", res_k), ("plain", res_p)):
        require(int(res.steps.max()) <= cap
                and bool((res.steps[res.sign == 0] == cap).all()),
                f"march {name}: {who} overshot or undershot the cap")
    # 16 bytes read and 20 written per ray; step_flops a step
    total = res_k.steps.double().sum().item()
    b_ms, b_by = bound(36 * n, step_flops * total)
    return dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def phase2_march():
    from curvis_tpu_torch.metrics.base import make_metric
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
    out = {name: march_vs_plain("[2]", name, metric, cams, cap, FLOP_STEP)
           for name, metric, cams, cap in configs}
    return out[f"ellis {FRAMES}x{RES}^2"]


def phase3_fused(bgp, bgn):
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import march_cuda, render_fused
    from curvis_tpu_torch.render.fast import _spawn_frames, render_planar_fast
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
    # the steps of this camera's rays, from the march kernel, for the bound:
    # 16 bytes written per pixel, the spawn / readout and FLOP_STEP a step
    state, _, _ = _spawn_frames(metric, [cam])
    steps = march_cuda.launch(kind, row[:6], *state,
                              max_steps=MAX_STEPS)[4]
    b_ms, b_by = bound(16 * n, FLOP_FUSED_PIXEL * n
                       + FLOP_STEP * steps.double().sum().item())
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
                neg_share=neg_share, bound_ms=b_ms, bound_by=b_by)


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
    render_fused.launches.update(euler=0, rk45=0)
    imgs_f = torch.stack(fused())                      # warm-up
    ms_f = cuda_ms(fused, REPS)
    imgs_b = batched()                                 # warm-up
    ms_b = cuda_ms(batched, REPS)
    launches = {"march": march_cuda.launches,
                "fused": render_fused.launches["euler"]}
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


def close_fraction(kernel, plain):
    """Fraction of rays whose every output is within GRAD_RTOL of the
    plain version's: |k - p| <= GRAD_RTOL * (|p| + 1e-6 max|p|), the floor
    keeping entries that are zero in exact arithmetic from counting as
    misses; and the largest absolute difference."""
    import torch
    ok = None
    worst = 0.0
    for k, p in zip(kernel, plain):
        k, p = k.double(), p.double()
        floor = 1e-6 * float(p.abs().max())
        good = (k - p).abs() <= GRAD_RTOL * (p.abs() + floor)
        ok = good if ok is None else ok & good
        worst = max(worst, float((k - p).abs().max()))
    return float(ok.double().mean()), worst


def ckpt_inputs(metric, cam, cap, seed):
    """(kind, scal, y0, b, steps, cot) of a camera's rays: the march
    kernel's step counts with captured rays excluded (steps 0, cotangent
    0), and a seeded random cotangent."""
    import numpy as np
    import torch
    from curvis_tpu_torch.ops import march_cuda
    from curvis_tpu_torch.physics.planar import CAPTURED
    from curvis_tpu_torch.render.fast import _spawn_frames
    state, _, _ = _spawn_frames(metric, [cam])
    kind, scal = march_cuda.march_scalars(metric, DT, R_ESC)
    sign, steps = march_cuda.launch(kind, scal, *state, max_steps=cap)[3:]
    keep = sign != CAPTURED
    steps = torch.where(keep, steps, torch.zeros_like(steps))
    n = steps.numel()
    cot = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (3, n)).astype(np.float32)).to(DEVICE)
    cot = tuple(torch.where(keep, c, torch.zeros_like(c)) for c in cot)
    return kind, scal, tuple(state[:3]), state[3], steps, cot


def kernel_vs_plain(kind, scal, y0, b, steps, cot, label, tag="[6]",
                    flops=(FLOP_STEP, FLOP_VJP)):
    """Both checkpoint kernels against their plain versions on the same
    inputs, the checkpoints against the march kernel, and the timings;
    ``flops`` = (a step's, its VJP's) FP32 operations for the bound."""
    import torch
    from curvis_tpu_torch.ops import ckpt_adjoint_cuda as ca
    from curvis_tpu_torch.ops import march_cuda
    n_seg = ca.n_segments(steps, SEG)
    ckpt = ca.launch_gen(kind, scal, *y0, b, steps, seg=SEG, n_seg=n_seg)
    g_k, lam_k = ca.launch_bwd(kind, scal, ckpt, b, steps, cot, seg=SEG)
    sync()
    t0 = time.perf_counter()
    ck_p = ca.ckpt_gen_plain(kind, scal, y0, b, steps, seg=SEG, n_seg=n_seg)
    sync()
    t1 = time.perf_counter()
    g_p, lam_p = ca.ckpt_bwd_plain(kind, scal, ck_p, b, steps, cot, seg=SEG)
    sync()
    gen_plain_ms = 1e3 * (t1 - t0)
    bwd_plain_ms = 1e3 * (time.perf_counter() - t1)
    gen_ms = cuda_ms(lambda: ca.launch_gen(kind, scal, *y0, b, steps,
                                           seg=SEG, n_seg=n_seg), 3)
    bwd_ms = cuda_ms(lambda: ca.launch_bwd(kind, scal, ckpt, b, steps, cot,
                                           seg=SEG), 3)
    # checkpoint s holds the state after s * SEG steps of every ray still
    # marching then: the march kernel's state with that cap, bit for bit
    eq = []
    for s_ in sorted({1, n_seg // 2, n_seg - 1} - {0}):
        m = march_cuda.launch(kind, scal, *y0, b, max_steps=s_ * SEG)
        live = steps > s_ * SEG
        same = ((ckpt[s_, 0] == m[0]) & (ckpt[s_, 1] == m[1])
                & (ckpt[s_, 2] == m[2]))
        eq.append((s_, same[live].double().mean().item(),
                   int(live.sum())))
    eq_min = min(f for _, f, _ in eq) if eq else 1.0
    # the plain gen writes frozen states past a ray's own segments, the
    # kernel leaves them unwritten: compare the segments each ray has
    seg_idx = torch.arange(n_seg, device=steps.device)[:, None]
    valid = (seg_idx * SEG < steps[None, :])[:, None, :].expand_as(ckpt)
    gen_err = float((ckpt - ck_p).abs()[valid].max()) if n_seg else 0.0
    table = kind == "table"
    if table:
        # a table's 2 (K + 1) coefficient cotangents a ray sum terms that
        # cancel through the series' reverse sweeps, where the contracted
        # kernel and the plain pair round apart (without contraction the
        # two are equal, bit for bit, on a CPU build of the kernel): the
        # rays' state and b cotangents keep the per-ray gate, the
        # coefficients are held entry by entry (entry_fraction)
        frac, bwd_err = close_fraction((*lam_k, g_k[-1]), (*lam_p, g_p[-1]))
        coef_frac, coef_err = entry_fraction(torch.stack(g_k[:-1]),
                                             torch.stack(g_p[:-1]))
        bwd_err = max(bwd_err, coef_err)
    else:
        frac, bwd_err = close_fraction((*lam_k, *g_k), (*lam_p, *g_p))
    sums = []
    for i in range(len(g_k) - 1):      # the metric slots; the last is b
        sk, sp = g_k[i].double().sum().item(), g_p[i].double().sum().item()
        mag = g_p[i].double().abs().sum().item()
        if sp != 0.0 or sk != 0.0:
            sums.append((i, sk, sp, abs(sk - sp) / max(abs(sp), 1e-300),
                         mag))
    total = steps.double().sum().item()
    n = steps.numel()
    segs = (-(-steps.long() // SEG)).double().sum().item()
    print(f"{tag} ckpt {label}: {n} rays, {int((steps > 0).sum())} marched, "
          f"mean / max steps {total / n:.1f} / {int(steps.max())}, "
          f"{n_seg} segments ({n_seg * 3 * n * 4 / 2**20:.1f} MiB buffer)")
    print(f"{tag}   checkpoints == march kernel at s*{SEG} steps: "
          + ", ".join(f"s={a}: {f:.6f} of {c}" for a, f, c in eq)
          + f" (bound >= {CKPT_EQ_MIN})")
    print(f"{tag}   lam and g_theta within rtol {GRAD_RTOL}: {frac:.6f} of "
          f"rays (bound >= {GRAD_FRAC_MIN}); max |d| gen {gen_err:.3e}, "
          f"bwd {bwd_err:.3e}")
    if table:
        print(f"{tag}   (the rays' lam and g_b;) the table's coefficient "
              f"cotangents within rtol {GRAD_RTOL}: {coef_frac:.6f} of "
              f"entries (bound >= {GRAD_FRAC_MIN})")
    for i, sk, sp, rel, _ in sums[:3]:
        print(f"{tag}   sum g_p{i}: kernel {sk:.9e}, plain {sp:.9e}, rel "
              f"{rel:.3e} (bound {GRAD_RTOL})")
    if len(sums) > 3:
        print(f"{tag}   ... and {len(sums) - 3} more slot sums, worst rel "
              f"{max(r[3] for r in sums[3:]):.3e}")
    print(f"{tag}   gen {gen_ms:.3f} ms (plain {gen_plain_ms:.1f} ms), bwd "
          f"{bwd_ms:.3f} ms (plain {bwd_plain_ms:.1f} ms)")
    require(eq_min >= CKPT_EQ_MIN, f"ckpt {label}: checkpoints {eq}")
    require(frac >= GRAD_FRAC_MIN, f"ckpt {label}: close fraction {frac}")
    require(not table or coef_frac >= GRAD_FRAC_MIN,
            f"ckpt {label}: coefficient entries {table and coef_frac}")
    for i, sk, sp, rel, mag in sums:
        # a table's coefficient sum that cancels to far below its terms'
        # size is held against that size (TABLE_SUM_TOL) instead
        require(rel <= GRAD_RTOL or (table and abs(sk - sp)
                                     <= TABLE_SUM_TOL * mag),
                f"ckpt {label}: sum g_p{i} {sk} vs {sp}")
    require(all(bool(torch.isfinite(t).all()) for t in (*lam_k, *g_k)),
            f"ckpt {label}: non-finite gradient")
    # gen reads 20 bytes a ray and writes 12 per segment; bwd reads those
    # segments and 20 bytes, writes 12 + 4 per theta entry; flops[0] a
    # step, + flops[1] in bwd
    gen_b = bound(20 * n + 12 * segs, flops[0] * total)
    bwd_b = bound(12 * segs + 20 * n + 4 * (3 + len(g_k)) * n,
                  (flops[0] + flops[1]) * total)
    return dict(gen=dict(max_abs_err=gen_err, ms=gen_ms,
                         plain_ms=gen_plain_ms, bound_ms=gen_b[0],
                         bound_by=gen_b[1]),
                bwd=dict(max_abs_err=bwd_err, ms=bwd_ms,
                         plain_ms=bwd_plain_ms, bound_ms=bwd_b[0],
                         bound_by=bwd_b[1]),
                buffer_mib=n_seg * 3 * n * 4 / 2**20)


def phase6_ckpt():
    from curvis_tpu_torch.metrics.base import make_metric
    configs = [
        (f"ellis {SMALL}^2", make_metric("ellis", rho=1.0, device=DEVICE),
         camera(5.0, 0.0, SMALL)),
        (f"dneg {SMALL}^2", make_metric("interstellar", m=0.1, a=0.5,
                                        rho=1.0, device=DEVICE),
         camera(5.0, 0.0, SMALL)),
        (f"schwarzschild {SMALL}^2",
         make_metric("schwarzschild", m=1.0, device=DEVICE),
         camera(15.0, 0.0, SMALL)),
        ("rn 128^2", make_metric("rn", m=1.0, q=0.6, device=DEVICE),
         camera(12.0, 0.0, 128)),
    ]
    for k, (label, metric, cam) in enumerate(configs):
        kernel_vs_plain(*ckpt_inputs(metric, cam, CKPT_CAP, seed=k), label)


def trainer_camera(res):
    """The weak-deflection viewpoint of tests/test_gradients.py: looking
    away from the throat, so every ray bends smoothly with rho."""
    from curvis_tpu_torch.camera.camera import make_camera
    return make_camera([0.0, 5.0, math.pi / 2, 0.0], [1.0, 0.6, 0.3],
                       [0.0, 0.0, 1.0], 15.0, 43.0, res, res, device=DEVICE)


def grad_check(bgp, bgn):
    """d loss / d rho at GRAD_RES^2 through the Function (kernel pair), and
    the same chain with the march's pullback done by the kernel pair and by
    the plain pair, called by hand."""
    import torch
    from curvis_tpu_torch.geometry.rotations import normalize
    from curvis_tpu_torch.integrate.adjoint import march_planar_adjoint_rays
    from curvis_tpu_torch.metrics.base import EllisMetric
    from curvis_tpu_torch.ops import ckpt_adjoint_cuda as ca
    from curvis_tpu_torch.ops import march_cuda
    from curvis_tpu_torch.physics import planar as pl
    from curvis_tpu_torch.render.direct import render_direct, shade
    from curvis_tpu_torch.render.fast import _pixel_dirs_soa
    cam = trainer_camera(GRAD_RES)
    kw = dict(dt=DT, max_steps=MAX_STEPS, escape_radius=R_ESC)
    with torch.no_grad():
        target = render_direct(EllisMetric(1.6, device=DEVICE), cam, bgp,
                               bgn, filtering="bilinear", **kw)
    target = target.permute(1, 0, 2).reshape(-1, 3)

    def loss_of(metric, rays, res):
        w = normalize(pl.planar_world_directions(metric, rays, res))
        colors = shade(bgp, bgn, w, res.sign, filtering="bilinear")
        return torch.mean((colors - target) ** 2)

    def spawn(rho):
        metric = EllisMetric(rho, device=DEVICE)
        dirs = torch.stack(_pixel_dirs_soa(cam), dim=-1)
        return metric, pl.spawn_planar(metric, cam.position, dirs)

    rho = torch.tensor(1.0, device=DEVICE, requires_grad=True)
    metric, rays = spawn(rho)
    res = march_planar_adjoint_rays(metric, rays, **kw)
    (g_fn,) = torch.autograd.grad(loss_of(metric, rays, res), rho)

    def by_hand(pullback):
        rho = torch.tensor(1.0, device=DEVICE, requires_grad=True)
        metric, rays = spawn(rho)
        kind, scal = march_cuda.march_scalars(metric, DT, R_ESC)
        y0 = tuple(t.detach().contiguous() for t in rays[:4])
        out = march_cuda.launch(kind, scal, *y0, max_steps=MAX_STEPS)
        ys = [t.clone().requires_grad_() for t in out[:3]]
        res = pl.PlanarResult(*ys, out[3], out[4])
        loss = loss_of(metric, rays, res)
        g_direct, *cot = torch.autograd.grad(loss, [rho, *ys],
                                             retain_graph=True)
        keep = out[3] != pl.CAPTURED
        steps = torch.where(keep, out[4], torch.zeros_like(out[4]))
        cot = tuple(torch.where(keep, c, torch.zeros_like(c)) for c in cot)
        g, lam = pullback(kind, scal, y0[:3], y0[3], steps, cot)
        outs = [(t, c) for t, c in zip(rays[:4], (*lam, g[3]))
                if t.requires_grad]
        (g_spawn,) = torch.autograd.grad([t for t, _ in outs], rho,
                                         grad_outputs=[c for _, c in outs])
        return (g_direct + g_spawn + g[0].double().sum()).item()

    def plain(kind, scal, y0, b, steps, cot):
        ck = ca.ckpt_gen_plain(kind, scal, y0, b, steps, seg=SEG,
                               n_seg=ca.n_segments(steps, SEG))
        return ca.ckpt_bwd_plain(kind, scal, ck, b, steps, cot, seg=SEG)

    g_k = by_hand(lambda *a: ca.ckpt_adjoint_backward_cuda(*a, seg=SEG))
    g_p = by_hand(plain)
    rel = abs(g_k - g_p) / abs(g_p)
    print(f"[7] d loss / d rho at {GRAD_RES}^2: Function {g_fn.item():.9e}, "
          f"kernel pair {g_k:.9e}, plain pair {g_p:.9e}; rel "
          f"{rel:.3e} (bound {GRAD_RTOL})")
    require(rel <= GRAD_RTOL, f"gradient kernel vs plain: {g_k} vs {g_p}")
    require(abs(g_fn.item() - g_k) <= GRAD_RTOL * abs(g_k),
            f"gradient Function vs kernel pair: {g_fn.item()} vs {g_k}")


def profile_window(fn, tag, what):
    """``fn`` once under torch.profiler: device time by kernel, and the
    device's busy share of the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: a CPU op's self device time repeats the
    # kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0.0:
        print(f"{tag} profile: no device time recorded (not measured)")
        return
    print(f"{tag} profile of {what}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), top kernels:")
    for e in events[:8]:
        print(f"{tag}   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


def phase7_trainer(bgp, bgn):
    """The headline trainer at full width; returns the launch counts of the
    trainer run and the checkpoint kernels' numbers at its shapes."""
    import torch
    from curvis_tpu_torch.fit import fit
    from curvis_tpu_torch.metrics.base import EllisMetric
    from curvis_tpu_torch.ops import ckpt_adjoint_cuda as ca
    from curvis_tpu_torch.ops import march_cuda
    from curvis_tpu_torch.render.direct import render_direct
    cam = trainer_camera(RES)
    kw = dict(dt=DT, max_steps=MAX_STEPS, escape_radius=R_ESC,
              filtering="bilinear", differentiable="adjoint")
    with torch.no_grad():
        target = render_direct(EllisMetric(1.6, device=DEVICE), cam, bgp,
                               bgn, **kw)

    def loss(p):
        img = render_direct(EllisMetric(rho=p["rho"], device=DEVICE), cam,
                            bgp, bgn, **kw)
        return torch.mean((img - target) ** 2)

    # one step by hand, timed with CUDA events: forward, then backward
    rho = torch.tensor(1.0, device=DEVICE, requires_grad=True)
    fwd, bwd = [], []
    for _ in range(3):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        v = loss({"rho": rho})
        e[1].record()
        (g,) = torch.autograd.grad(v, rho)
        e[2].record()
        e[2].synchronize()
        fwd.append(e[0].elapsed_time(e[1]))
        bwd.append(e[1].elapsed_time(e[2]))
    g = g.item()
    print(f"[7] d loss / d rho at rho = 1, {RES}^2: {g:.9e} (loss "
          f"{v.item():.9e})")
    require(math.isfinite(g) and g != 0.0, f"trainer gradient {g}")

    profile_window(lambda: torch.autograd.grad(loss({"rho": rho}), rho),
                   "[7]", "one step")
    # warm-up: the optimiser's first step pays one-off imports
    fit(loss, {"rho": torch.tensor(1.0, device=DEVICE)}, iters=1,
        lr=TRAIN_LR)
    march_cuda.launches = 0
    ca.launches.update(ckpt_gen=0, ckpt_bwd=0)
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    res = fit(loss, {"rho": torch.tensor(1.0, device=DEVICE)},
              iters=TRAIN_ITERS, lr=TRAIN_LR)
    sync()
    fit_s = time.perf_counter() - t0
    launches = {"march": march_cuda.launches, **ca.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = res.history
    print(f"[7] fit: {TRAIN_ITERS} Adam steps (lr {TRAIN_LR}) in {fit_s:.2f} "
          f"s, rho 1.0 -> {float(res.params['rho']):.6f} (target 1.6); "
          f"history {', '.join(f'{h:.6e}' for h in hist)}")
    print(f"[7] launches over the trainer run: {launches}; peak device "
          f"memory {peak:.3f} GiB")
    require(all(math.isfinite(h) for h in hist), f"history {hist}")
    require(hist[-1] < hist[0], f"loss did not drop: {hist}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the trainer was not launched: {launches}")

    # the checkpoint kernels at the trainer's shapes, against their plain
    # versions, with the cotangent seeded at random
    metric = EllisMetric(1.0, device=DEVICE)
    inputs = ckpt_inputs(metric, cam, MAX_STEPS, seed=7)
    nums = kernel_vs_plain(*inputs, f"trainer ellis {RES}^2")
    fwd_ms, bwd_total = statistics.median(fwd), statistics.median(bwd)
    print(f"[7] per step (median of 3, CUDA events): forward {fwd_ms:.2f} ms "
          f"+ backward {bwd_total:.2f} ms, of which gen "
          f"{nums['gen']['ms']:.2f} ms and bwd {nums['bwd']['ms']:.2f} ms; "
          f"checkpoint buffer {nums['buffer_mib']:.1f} MiB")
    grad_check(bgp, bgn)
    return launches, nums


def poison_rays(l, n_nan):
    """``l`` with ``n_nan`` evenly spread rays set to NaN, and their mask."""
    import torch
    bad = torch.zeros(l.shape, dtype=torch.bool, device=l.device)
    if n_nan:
        bad[torch.linspace(0, l.numel() - 1, n_nan,
                           device=l.device).long()] = True
    return torch.where(bad, torch.full_like(l, math.nan), l), bad


def rk45_vs_plain(tag, name, metric, cams, cap, n_nan, iter_flops):
    """Kernel #4 bare against march_planar_rk45_plain on the rays of
    ``cams``, ``n_nan`` of them poisoned to NaN, at #4's default
    tolerances: every output equal (both round every operation), with
    digests, the step cap, the timings and the bound (``iter_flops`` an
    iteration)."""
    from curvis_tpu_torch.ops import rk45_cuda
    from curvis_tpu_torch.physics.planar import PlanarResult
    from curvis_tpu_torch.render.fast import _readout, _spawn_frames
    state, r_hat, e2 = _spawn_frames(metric, cams)
    l, bad = poison_rays(state[0].reshape(-1).contiguous(), n_nan)
    flat = [l] + [t.reshape(-1).contiguous() for t in state[1:]]
    kind, scal = rk45_cuda.rk45_scalars(metric, DT, R_ESC, rtol=1e-5,
                                        atol=1e-7, dt_max=10.0)
    mi = rk45_cuda.default_max_iters(cap, None)
    out_k = rk45_cuda.launch(kind, scal, *flat, max_steps=cap, max_iters=mi)
    sync()
    t0 = time.perf_counter()
    out_p = rk45_cuda.march_planar_rk45_plain(kind, scal, *flat,
                                              max_steps=cap, max_iters=mi)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    res_k, res_p = PlanarResult(*out_k[:5]), PlanarResult(*out_p[:5])
    w_k = _readout(metric, res_k, flat[3], r_hat, e2)
    w_p = _readout(metric, res_p, flat[3], r_hat, e2)
    sign_eq, p99, max_abs, esc = compare(res_k.sign, res_p.sign, w_k, w_p)
    near = ((res_k.steps - res_p.steps).abs() <= STEPS_NEAR)
    steps_near = near.double().mean().item()
    iters_eq = (out_k[5] == out_p[5]).double().mean().item()
    kernel_ms = cuda_ms(lambda: rk45_cuda.launch(
        kind, scal, *flat, max_steps=cap, max_iters=mi), 3)
    n = l.numel()
    steps, iters = res_k.steps.double(), out_k[5].double()
    counts = {s: int((res_k.sign == s).sum()) for s in (-1, 0, 1, 2, 3)}
    print(f"{tag} rk45 march {name}: {n} rays, signs {counts}, sign equal "
          f"{sign_eq:.6f}, steps within {STEPS_NEAR} {steps_near:.6f}, iters "
          f"equal {iters_eq:.6f}, angle p99 {p99:.3e} rad over {esc:.4f} of "
          f"rays, max |dw| {max_abs:.3e}")
    print(f"{tag}   steps mean / max {steps.mean().item():.2f} / "
          f"{int(steps.max())}, iters mean / max {iters.mean().item():.2f} / "
          f"{int(iters.max())}; kernel {kernel_ms:.3f} ms "
          f"({n / kernel_ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms")
    # built without FMA contraction, as its plain version rounds: every
    # output equal
    n_diff, worst = outputs_differ(out_k, out_p)
    print(f"{tag}   {n_diff} output entries differ from the plain version's "
          f"(bound 0), max finite |d| {worst:.3e}; digest of the kernel's "
          f"outputs {digest(out_k)}, of the plain version's "
          f"{digest(out_p)}")
    require(n_diff == 0, f"rk45 {name}: {n_diff} output entries differ")
    require(sign_eq >= SIGN_EQ_MIN, f"rk45 {name}: sign equal {sign_eq}")
    require(steps_near >= STEPS_EQ_MIN,
            f"rk45 {name}: steps within {STEPS_NEAR} {steps_near}")
    require(p99 < ANGLE_P99_MAX, f"rk45 {name}: angle p99 {p99}")
    for who, res in (("kernel", res_k), ("plain", res_p)):
        require(int(res.steps.max()) <= cap
                and bool((res.steps[res.sign == 0] == cap).all()),
                f"rk45 {name}: {who} overshot or undershot the cap")
        if n_nan:
            require(bool((res.sign[bad] == 3).all()),
                    f"rk45 {name}: {who} left a NaN ray unfrozen: "
                    f"{res.sign[bad].tolist()}")
    if cap == RK45_CAP:
        capped = (res_k.sign == 0).double().mean().item()
        print(f"{tag}   {capped:.4f} of rays stopped at the cap of {cap}")
        require(capped > 0.5, f"rk45 {name}: only {capped} capped")
    # 16 bytes read and 24 written per ray; iter_flops an iteration
    b_ms, b_by = bound(40 * n, iter_flops * iters.sum().item())
    return dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def phase8_rk45_march():
    """Kernel #4 against march_planar_rk45_plain, at #4's default
    tolerances (rtol 1e-5, atol 1e-7)."""
    from curvis_tpu_torch.metrics.base import make_metric
    ellis = make_metric("ellis", rho=1.0, device=DEVICE)
    schwarzschild = make_metric("schwarzschild", m=1.0, device=DEVICE)
    configs = [
        (f"ellis {FRAMES}x{RES}^2", ellis,
         [camera(5.0, 0.001 * k, RES) for k in range(FRAMES)],
         RK45_MAX_STEPS, 0),
        (f"dneg {SMALL}^2", make_metric("interstellar", m=0.1, a=1e-4,
                                        rho=1.0, device=DEVICE),
         [camera(5.0, 0.0, SMALL)], RK45_MAX_STEPS, 0),
        (f"schwarzschild {SMALL}^2", schwarzschild,
         [camera(15.0, 0.0, SMALL)], RK45_MAX_STEPS, 0),
        (f"schwarzschild {SMALL}^2 cap {RK45_CAP}", schwarzschild,
         [camera(15.0, 0.0, SMALL)], RK45_CAP, 0),
        (f"ellis {SMALL}^2 with {N_POISON} NaN rays", ellis,
         [camera(5.0, 0.0, SMALL)], RK45_MAX_STEPS, N_POISON),
    ]
    out = {name: rk45_vs_plain("[8]", name, metric, cams, cap, n_nan,
                               FLOP_RK45_ITER)
           for name, metric, cams, cap, n_nan in configs}
    return out[f"ellis {FRAMES}x{RES}^2"]


def accuracy(metric, q):
    """Escape-direction error of the fused rk45 kernel (``q``) and of the
    Euler march kernel (the parity config) on the headline view at
    ACC_RES^2, against integrate/rk45.py:march_planar_rk45 in float64 at
    rtol ACC_RTOL (plain PyTorch on the card)."""
    import numpy as np
    import torch
    from curvis_tpu_torch.integrate.rk45 import march_planar_rk45
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import march_cuda, render_fused
    from curvis_tpu_torch.physics.planar import PlanarRays
    from curvis_tpu_torch.render.fast import _readout, _spawn_frames
    f64 = torch.float64
    m64 = make_metric("ellis", rho=1.0, device=DEVICE, dtype=f64)
    s64, r64, e64 = _spawn_frames(m64, [camera(5.0, 0.0, ACC_RES, f64)])
    ref = march_planar_rk45(m64, PlanarRays(*s64, r_hat=None, e2=None),
                            escape_radius=R_ESC, dt0=DT, max_steps=100_000,
                            rtol=ACC_RTOL, atol=ACC_RTOL * 1e-3)
    w_ref = _readout(m64, ref, s64[3], r64, e64)
    cam = camera(5.0, 0.0, ACC_RES)
    *w_q, sign_q = render_fused.fused_directions(metric, cam, **q)
    state, r_hat, e2 = _spawn_frames(metric, [cam])
    unused = torch.zeros((1, 3), device=DEVICE)
    eul = march_cuda.march_planar_cuda(
        metric, PlanarRays(*state, r_hat=unused, e2=unused), dt=DT,
        max_steps=MAX_STEPS, escape_radius=R_ESC)
    w_e = _readout(metric, eul, state[3], r_hat, e2)
    for name, w, sign in ((f"rk45 rtol {RK45_RTOL} (fused kernel)", w_q,
                           sign_q),
                          (f"Euler dt {DT} (march kernel)", w_e, eul.sign)):
        both = (sign.abs() == 1) & (ref.sign.abs() == 1)
        ang, _, _ = angles([c.double() for c in w], w_ref, both)
        p50, p99, top = np.percentile(ang, [50, 99, 100])
        print(f"[9] accuracy at {ACC_RES}^2 against f64 rk45 rtol "
              f"{ACC_RTOL}: {name}: sign equal "
              f"{(sign == ref.sign).double().mean().item():.6f}, angle p50 "
              f"{p50:.3e}, p99 {p99:.3e}, max {top:.3e} rad")


def phase9_quality(bgp, bgn):
    """Kernel #3 against its plain version, the fused rk45 image against the
    rk45 march-kernel image, rk45 against Euler on the headline view, and
    the quality-mode headline through both entry points (its launch
    counts)."""
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import march_cuda, render_fused, rk45_cuda
    from curvis_tpu_torch.physics.planar import PlanarRays
    from curvis_tpu_torch.render.fast import (_readout, _spawn_frames,
                                              render_frames_batched,
                                              render_planar_adaptive,
                                              render_planar_fast)
    ellis = make_metric("ellis", rho=1.0, device=DEVICE)
    cam = camera(5.0, 0.0, RES)
    q = dict(dt=DT, max_steps=RK45_MAX_STEPS, escape_radius=R_ESC,
             stepper="rk45", rtol=RK45_RTOL)
    *w_k, sign_k = render_fused.fused_directions(ellis, cam, **q)
    sync()
    t0 = time.perf_counter()
    *w_p, sign_p = render_fused.render_planar_fused_plain(ellis, cam, **q)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    sign_eq, p99, max_abs, esc = compare(sign_k, sign_p, w_k, w_p)
    kind, row = render_fused._fused_row(ellis, cam, DT, R_ESC)
    tail, mi = render_fused._rk45_tail(RK45_RTOL, None, 10.0, RK45_MAX_STEPS,
                                       None)
    kernel_ms = cuda_ms(lambda: render_fused.launch_rk45(
        kind, row + tail, RES, RES, RK45_MAX_STEPS, mi, cam.device), 3)
    # this camera's iterations at the same tolerances, from kernel #4, for
    # the bound: 16 bytes written a pixel, spawn / readout, FLOP_RK45_ITER
    # an iteration
    state, r_hat, e2 = _spawn_frames(ellis, [cam])
    iters = rk45_cuda.launch(kind, row[:6] + tail, *state,
                             max_steps=RK45_MAX_STEPS, max_iters=mi)[5]
    n = RES * RES
    b_ms, b_by = bound(16 * n, FLOP_FUSED_PIXEL * n
                       + FLOP_RK45_ITER * iters.double().sum().item())
    print(f"[9] fused rk45 ellis {RES}^2 (rtol {RK45_RTOL}): sign equal "
          f"{sign_eq:.6f}, angle p99 {p99:.3e} rad over {esc:.4f} of rays, "
          f"max |dw| {max_abs:.3e}; iters mean / max "
          f"{iters.double().mean().item():.2f} / {int(iters.max())}; kernel "
          f"{kernel_ms:.3f} ms ({n / kernel_ms / 1e3:.1f} Mrays/s), plain "
          f"{plain_ms:.1f} ms")
    require(sign_eq >= SIGN_EQ_MIN, f"fused rk45: sign equal {sign_eq}")
    require(p99 < ANGLE_P99_MAX, f"fused rk45: angle p99 {p99}")

    # the fused rk45 image against the march-kernel route's, both at #4's
    # default tolerances
    kw = dict(dt=DT, max_steps=RK45_MAX_STEPS, escape_radius=R_ESC,
              filtering="nearest", stepper="rk45")
    img_f = render_fused.render_planar_fused(ellis, cam, bgp, bgn, rtol=1e-5,
                                             atol=1e-7, **kw)
    img_m = render_planar_fast(ellis, cam, bgp, bgn, **kw)
    diff = ((img_f - img_m).abs().amax(-1) > 1e-6).double().mean().item()
    print(f"[9] fused rk45 image vs rk45 march-kernel image: {diff:.6f} of "
          f"pixels differ by > 1e-6")
    require(diff <= IMAGE_DIFF_MAX, f"fused vs march rk45 image: {diff}")

    # the quality mode's distance from parity: rk45 (rtol 1e-3) against the
    # Euler march kernel (dt 0.05, 40 000 steps) on the headline view
    unused = torch.zeros((1, 3), device=DEVICE)
    eul = march_cuda.march_planar_cuda(
        ellis, PlanarRays(*state, r_hat=unused, e2=unused), dt=DT,
        max_steps=MAX_STEPS, escape_radius=R_ESC)
    w_e = _readout(ellis, eul, state[3], r_hat, e2)
    _, p99_e, _, esc_e = compare(sign_k, eul.sign, w_k, w_e)
    print(f"[9] rk45 (rtol {RK45_RTOL}) vs Euler (dt {DT}) on the headline "
          f"view: angle p99 {p99_e:.3e} rad over {esc_e:.4f} of rays")
    accuracy(ellis, q)

    # the quality-mode headline: the main path of kernels #3 and #4
    cams = [camera(5.0, 0.001 * k, RES) for k in range(FRAMES)]
    dneg = make_metric("interstellar", m=0.1, a=1e-4, rho=1.0, device=DEVICE)
    cam_d = [camera(5.0, 0.0, RES)]

    def fused(metric=ellis, poses=cams):
        return [render_fused.render_planar_fused(metric, c, bgp, bgn,
                                                 rtol=RK45_RTOL, **kw)
                for c in poses]

    def batched():
        return render_frames_batched(ellis, cams, bgp, bgn, **kw)

    def adaptive():
        return render_planar_adaptive(ellis, cam, bgp, bgn,
                                      refine_frac=0.1, **kw)

    march_cuda.launches = 0
    rk45_cuda.launches = 0
    render_fused.launches.update(euler=0, rk45=0)
    imgs_f = torch.stack(fused())                      # warm-up
    ms_f = cuda_ms(fused, REPS)
    imgs_b = batched()                                 # warm-up
    ms_b = cuda_ms(batched, REPS)
    imgs_d = torch.stack(fused(dneg, cam_d))           # warm-up
    ms_d = cuda_ms(lambda: fused(dneg, cam_d), REPS)
    imgs_a = adaptive()[None]                          # warm-up
    ms_a = cuda_ms(adaptive, REPS)
    launches = {"march": march_cuda.launches, "rk45": rk45_cuda.launches,
                **{f"fused_{k}": v for k, v in render_fused.launches.items()}}
    for name, imgs, ms in (
            (f"render_planar_fused rk45 rtol {RK45_RTOL}", imgs_f, ms_f),
            ("render_frames_batched rk45", imgs_b, ms_b),
            (f"render_planar_fused rk45 rtol {RK45_RTOL} dneg", imgs_d, ms_d),
            ("render_planar_adaptive rk45 (10 % of pixels 3 x 3)", imgs_a,
             ms_a)):
        require(tuple(imgs.shape[1:]) == (RES, RES, 3),
                f"{name}: shape {tuple(imgs.shape)}")
        require(bool(torch.isfinite(imgs).all()), f"{name}: non-finite")
        lit = [(im.sum(-1) > 0).double().mean().item() for im in imgs]
        rays = len(imgs) * RES * RES
        print(f"[9] {name}: {len(imgs)} x {RES}^2 in {ms:.2f} ms (median of "
              f"{REPS}) = {rays / ms / 1e3:.1f} Mrays/s; lit fraction "
              f"{min(lit):.6f}..{max(lit):.6f}")
        require(min(lit) > LIT_MIN, f"{name}: lit fraction {min(lit)}")
    print(f"[9] launch counters over the quality-mode run: {launches}")
    require(launches["rk45"] > 0 and launches["fused_rk45"] > 0,
            f"a kernel of the rk45 path was not launched: {launches}")
    profile_window(fused, "[9]", f"the quality-mode headline "
                   f"(render_planar_fused rk45, {FRAMES} x {RES}^2)")
    return launches, dict(max_abs_err=max_abs, ms=kernel_ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def disk_camera(res, phi=0.0, l=DISK_L, dtype=None):
    """The example's camera at azimuth ``phi`` (and radius ``l``), looking
    at the hole (float32 unless ``dtype``)."""
    import torch
    from curvis_tpu_torch.camera.camera import make_camera
    st, ct = math.sin(DISK_TH), math.cos(DISK_TH)
    return make_camera([0.0, l, DISK_TH, phi],
                       [-st * math.cos(phi), -st * math.sin(phi), -ct],
                       [0.0, 0.0, 1.0], DISK_FOCAL, 43.0, res, res,
                       device=DEVICE, dtype=dtype or torch.float32)


def disk_rays(metric, cams):
    """Flat (l, psi, p_l, b) and (c1, c2, nz) of the cameras' pixel rays, as
    render/disk.py's routes make them."""
    from curvis_tpu_torch.render.fast import _spawn_frames
    state, r_hat, e2 = _spawn_frames(metric, cams)
    planes = (r_hat[2], e2[2], r_hat[0] * e2[1] - r_hat[1] * e2[0])
    return ([t.reshape(-1).contiguous() for t in state],
            [t.reshape(-1).contiguous() for t in planes])


def hit_agreement(out_k, out_p):
    """Kernel #5 against its plain version, both (l, psi, p_l, sign, steps,
    h1, h1p, h1s, h2, h2p, h2s): fractions of equal sign, steps and hit
    presence (h != 0, NaN counting as present), and over the hits present
    and finite in both the p99 relative radius error, the p99 |dpsi| and
    the max |dr|."""
    import numpy as np
    import torch
    sign_eq = (out_k[3] == out_p[3]).double().mean().item()
    steps_eq = (out_k[4] == out_p[4]).double().mean().item()
    pres, rel, dpsi, dr = [], [], [], []
    for r_i, s_i in ((5, 7), (8, 10)):
        hk, hp = out_k[r_i].double(), out_p[r_i].double()
        pres.append(((hk != 0) == (hp != 0)).double().mean().item())
        both = (hk != 0) & (hp != 0) & torch.isfinite(hk) & torch.isfinite(hp)
        rel.append(((hk - hp).abs() / hp.abs())[both])
        dr.append((hk - hp).abs()[both])
        dpsi.append((out_k[s_i].double() - out_p[s_i].double()).abs()[both])
    rel, dpsi, dr = (torch.cat(x).cpu().numpy() for x in (rel, dpsi, dr))

    def p99(x):
        return float(np.percentile(x, 99)) if x.size else 0.0
    return dict(sign_eq=sign_eq, steps_eq=steps_eq, hit_eq=min(pres),
                rel_p99=p99(rel), dpsi_p99=p99(dpsi),
                max_abs=float(dr.max()) if dr.size else 0.0,
                n_hits=int(rel.size))


def phase10_disk_march():
    """Kernel #5 against march_planar_disk_plain on the card: the path's
    view at 1024^2, RN and an Ellis wormhole disk at 256^2, an exact step
    cap, 16 NaN rays and the starlight map's reduced rays."""
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import disk_cuda
    from curvis_tpu_torch.render.starlight import map_rays
    bh = make_metric("schwarzschild", m=1.0, device=DEVICE)
    band = (5.2, 14.0)
    configs = [
        (f"schwarzschild {RES}^2 (the path's view)", bh,
         [disk_camera(RES)], band, MAX_STEPS, 0),
        (f"rn {SMALL}^2", make_metric("rn", m=1.0, q=0.6, device=DEVICE),
         [disk_camera(SMALL)], band, MAX_STEPS, 0),
        (f"ellis {SMALL}^2 (wormhole disk)",
         make_metric("ellis", rho=1.0, device=DEVICE),
         [disk_camera(SMALL)], (1.5, 14.0), MAX_STEPS, 0),
        (f"schwarzschild {SMALL}^2 cap {DISK_CAP}", bh,
         [disk_camera(SMALL)], band, DISK_CAP, 0),
        (f"schwarzschild {SMALL}^2 with {N_POISON} NaN rays", bh,
         [disk_camera(SMALL)], band, DISK_NAN_CAP, N_POISON),
        ("starlight map rays 64 x 256", bh, None, band, MAX_STEPS, 0),
    ]
    out = {}
    for name, metric, cams, (r_in, r_out), cap, n_nan in configs:
        if cams is None:
            _, rays, _, _ = map_rays(metric, r_in, r_out, 64, 256,
                                     torch.float32, DEVICE)
            state = [t.contiguous() for t in rays[:4]]
            planes = [torch.zeros_like(rays.l), torch.ones_like(rays.l)]
        else:
            state, planes = disk_rays(metric, cams)
        state[0], bad = poison_rays(state[0], n_nan)
        ins = state + planes[:2]
        kind, scal = disk_cuda.disk_scalars(metric, DT, DISK_R, r_in, r_out)
        out_k = disk_cuda.launch(kind, scal, *ins, max_steps=cap)
        sync()
        t0 = time.perf_counter()
        out_p = disk_cuda.march_planar_disk_plain(kind, scal, *ins,
                                                  max_steps=cap)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        a = hit_agreement(out_k, out_p)
        kernel_ms = cuda_ms(lambda: disk_cuda.launch(kind, scal, *ins,
                                                     max_steps=cap), 3)
        n = ins[0].numel()
        steps = out_k[4].double()
        counts = {s: int((out_k[3] == s).sum()) for s in (-1, 0, 1, 2)}
        hits = [int((out_k[i] != 0).sum()) for i in (5, 8)]
        print(f"[10] disk march {name}: {n} rays, signs {counts}, hits "
              f"{hits[0]} / {hits[1]} (first / second); sign equal "
              f"{a['sign_eq']:.6f}, steps equal {a['steps_eq']:.6f}, hit "
              f"presence equal {a['hit_eq']:.6f}; over {a['n_hits']} hits "
              f"p99 rel radius {a['rel_p99']:.3e}, p99 |dpsi| "
              f"{a['dpsi_p99']:.3e}, max |dr| {a['max_abs']:.3e}")
        print(f"[10]   steps mean / max {steps.mean().item():.1f} / "
              f"{int(steps.max())}; kernel {kernel_ms:.3f} ms "
              f"({n / kernel_ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms")
        require(a["sign_eq"] >= SIGN_EQ_MIN,
                f"disk {name}: sign equal {a['sign_eq']}")
        require(a["steps_eq"] >= STEPS_EQ_MIN,
                f"disk {name}: steps equal {a['steps_eq']}")
        require(a["hit_eq"] >= HIT_EQ_MIN,
                f"disk {name}: hit presence equal {a['hit_eq']}")
        require(a["rel_p99"] < HIT_P99_MAX,
                f"disk {name}: p99 relative hit radius {a['rel_p99']}")
        require(a["dpsi_p99"] < HIT_P99_MAX,
                f"disk {name}: p99 |dpsi| at the hit {a['dpsi_p99']}")
        require(hits[0] > 0, f"disk {name}: no disk hit")
        for who, o in (("kernel", out_k), ("plain", out_p)):
            require(int(o[4].max()) <= cap
                    and bool((o[4][o[3] == 0] == cap).all()),
                    f"disk {name}: {who} overshot or undershot the cap")
            if n_nan:
                require(bool((o[3][bad] == 0).all())
                        and bool(torch.isnan(o[5][bad]).all()),
                        f"disk {name}: {who} NaN rays not sign 0 / NaN hit")
        if cap == DISK_CAP:
            capped = (out_k[3] == 0).double().mean().item()
            print(f"[10]   {capped:.4f} of rays stopped at the cap of {cap}")
            require(capped > 0.5, f"disk {name}: only {capped} capped")
        # 24 bytes read and 44 written per ray; FLOP_DISK_STEP a step
        b_ms, b_by = bound(68 * n, FLOP_DISK_STEP * steps.sum().item())
        out[name] = dict(max_abs_err=a["max_abs"], ms=kernel_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    return out[f"schwarzschild {RES}^2 (the path's view)"]


def vol_flops(kind, flags):
    """FP32 operations of one kernel #6 step for a kind and its flags."""
    blackbody, redshift, doppler, scatter = flags
    n = FLOP_VOL["base"]
    if kind in ("schwarzschild", "rn") and (redshift or doppler):
        n += FLOP_VOL["shift"]
    n += FLOP_VOL["blackbody" if blackbody else "tint"]
    return n + (FLOP_VOL["scatter"] if scatter else 0)


def phase11_disk_vol(sky):
    """Kernel #6 against march_planar_disk_volumetric_plain on the card:
    tint and blackbody, redshift and Doppler on and off, the scatter
    source with a real starlight map's block, the tau_max freeze, RN and
    an Ellis wormhole."""
    import dataclasses
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import disk_vol_cuda as dv
    from curvis_tpu_torch.render.disk import DiskParams, compute_starlight_map
    from curvis_tpu_torch.render.starlight import starlight_scatter_block
    bh = make_metric("schwarzschild", m=1.0, device=DEVICE)
    tint = DiskParams(**DISK_VOL)
    bb = dataclasses.replace(tint, color_mode="blackbody", t_peak=7000.0)
    smap = compute_starlight_map(
        bh, sky, dataclasses.replace(bb, starlight=True, starlight_samples=256,
                                     starlight_grid=(64, 128)),
        dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R)
    block = starlight_scatter_block(smap, bb)
    V = DISK_VOL_RES
    configs = [
        (f"tint {RES}^2 (the path's view)", bh, RES, tint, None),
        (f"blackbody {V}^2", bh, V, bb, None),
        (f"tint, redshift only {V}^2", bh, V,
         dataclasses.replace(tint, doppler=False), None),
        (f"tint, no shift {V}^2", bh, V,
         dataclasses.replace(tint, redshift=False, doppler=False), None),
        (f"tint + scatter {V}^2", bh, V, tint, block),
        (f"blackbody + scatter {V}^2", bh, V, bb, block),
        (f"tint kappa 40 (tau_max freeze) {SMALL}^2", bh, SMALL,
         dataclasses.replace(tint, kappa=40.0), None),
        (f"rn blackbody {SMALL}^2", make_metric("rn", m=1.0, q=0.6,
                                                device=DEVICE), SMALL, bb,
         None),
        (f"ellis tint {SMALL}^2 (wormhole disk)",
         make_metric("ellis", rho=1.0, device=DEVICE), SMALL,
         dataclasses.replace(tint, r_inner=1.5), None),
    ]
    out = {}
    frozen_seen = [0, 0]
    for name, metric, res, disk, blk in configs:
        state, planes = disk_rays(metric, [disk_camera(res)])
        ins = state + planes
        kind, scal = dv.vol_scalars(metric, DT, DISK_R, disk, blk)
        flags = (disk.color_mode == "blackbody", disk.redshift, disk.doppler,
                 blk is not None)
        out_k = dv.launch(kind, flags, scal, *ins,
                          max_steps=DISK_VOL_CHECK_CAP)
        sync()
        t0 = time.perf_counter()
        out_p = dv.march_planar_disk_volumetric_plain(
            kind, flags, scal, *ins, max_steps=DISK_VOL_CHECK_CAP)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        sign_eq = (out_k[3] == out_p[3]).double().mean().item()
        steps_eq = (out_k[4] == out_p[4]).double().mean().item()
        frac, worst = close_fraction(out_k[5:9], out_p[5:9])
        cap_r = metric.capture_radius
        frozen = [int(((o[3] == 2) & (o[0] > (cap_r if cap_r is not None
                                               else -1e30))).sum())
                  for o in (out_k, out_p)]
        frozen_seen = [a + b for a, b in zip(frozen_seen, frozen)]
        kernel_ms = cuda_ms(lambda: dv.launch(kind, flags, scal, *ins,
                                              max_steps=DISK_VOL_CHECK_CAP),
                             3)
        n = ins[0].numel()
        steps = out_k[4].double()
        print(f"[11] vol march {name}: {n} rays, sign equal {sign_eq:.6f}, "
              f"steps equal {steps_eq:.6f}, tau and em within rtol "
              f"{GRAD_RTOL} on {frac:.6f} of rays (max |d| {worst:.3e}); "
              f"frozen by tau_max {frozen[0]} / {frozen[1]} (kernel / "
              f"plain); tau max {out_k[5].max().item():.3f}")
        print(f"[11]   steps mean / max {steps.mean().item():.1f} / "
              f"{int(steps.max())}; kernel {kernel_ms:.3f} ms "
              f"({n / kernel_ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms")
        require(sign_eq >= SIGN_EQ_MIN, f"vol {name}: sign equal {sign_eq}")
        require(frac >= GRAD_FRAC_MIN, f"vol {name}: close fraction {frac}")
        require(all(bool(torch.isfinite(t).all()) for t in out_k[5:9]),
                f"vol {name}: non-finite tau or emission")
        if disk.kappa > 10.0:
            require(min(frozen) > 0, f"vol {name}: no tau_max freeze "
                    f"{frozen}")
        # 28 bytes read and 36 written per ray
        b_ms, b_by = bound(64 * n, vol_flops(kind, flags)
                           * steps.sum().item())
        out[name] = dict(max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
    print(f"[11] tau_max freeze seen on {frozen_seen[0]} / {frozen_seen[1]} "
          f"rays (kernel / plain) over all cases")
    return out[f"tint {RES}^2 (the path's view)"]


def disk_image_gates(name, imgs, bare, tag="[12]"):
    """Shape, finite pixels, lit and disk-pixel fractions of disk frames;
    a disk pixel differs by > DISK_IMG_TOL from ``bare``, the same frames
    rendered with a disk of zero brightness and opacity (the lensed sky
    and the shadow)."""
    import torch
    require(imgs.shape == bare.shape and imgs.shape[-3:] == (RES, RES, 3),
            f"{name}: shape {tuple(imgs.shape)}")
    require(bool(torch.isfinite(imgs).all()), f"{name}: non-finite pixel")
    imgs = imgs.reshape(-1, RES, RES, 3)
    bare = bare.reshape(-1, RES, RES, 3)
    lit = min((im.sum(-1) > 0).double().mean().item() for im in imgs)
    disk = [((im - b).abs().amax(-1) > DISK_IMG_TOL).double().mean().item()
            for im, b in zip(imgs, bare)]
    print(f"{tag}   {name}: lit fraction {lit:.6f}, disk-pixel fraction "
          f"{min(disk):.6f}..{max(disk):.6f}")
    require(lit > DISK_LIT_MIN, f"{name}: lit fraction {lit}")
    require(DISK_FRAC[0] < min(disk) and max(disk) < DISK_FRAC[1],
            f"{name}: disk-pixel fraction {disk}")


def run_disk_cli(tmp, sky_np, extra):
    """``image --disk`` through the CLI's main on a 256^2 view of the path's
    scene, with the skies written as PNGs; returns the saved image."""
    import numpy as np
    from PIL import Image
    from curvis_tpu_torch.cli import main as cli_main
    for name in ("bg1.png", "bg2.png"):
        Image.fromarray((255 * sky_np).astype(np.uint8)).save(tmp / name)
    (tmp / "cam.toml").write_text(
        f"resolution_x = 256\nresolution_y = 256\ndiagonal = 43.0\n"
        f"focal_length = {DISK_FOCAL}\n")
    (tmp / "sim.toml").write_text(
        f"escape_radius = {DISK_R}\nray_integration_max_iterations = "
        f"{MAX_STEPS}\nray_integration_step = {DT}\n")
    (tmp / "metric.toml").write_text('kind = "schwarzschild"\nm = 1.0\n')
    (tmp / "img.toml").write_text(
        f"l = {DISK_L}\ntheta = {DISK_TH!r}\nphi = 0.0\n"
        f"forward_x = {-math.sin(DISK_TH)!r}\nforward_y = 0.0\n"
        f"forward_z = {-math.cos(DISK_TH)!r}\n")
    out = tmp / "out"
    rc = cli_main(["image", str(tmp / "bg1.png"), str(tmp / "bg2.png"),
                   str(out), "-m", str(tmp / "metric.toml"), "-c",
                   str(tmp / "cam.toml"), "-s", str(tmp / "sim.toml"), "-i",
                   str(tmp / "img.toml"), "--filtering", "bilinear",
                   "--disk", *extra])
    require(rc == 0, f"cli image --disk {extra}: exit code {rc}")
    return np.asarray(Image.open(out / "output_image.png"))


def phase12_disk_path(sky, sky_np):
    """The disk path end to end at 1024^2 through its entry points, with
    the launch counts of kernels #5 and #6 in each job."""
    import dataclasses
    import tempfile
    from unittest import mock
    import numpy as np
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import disk_cuda
    from curvis_tpu_torch.ops import disk_vol_cuda
    from curvis_tpu_torch.physics.planar import PlanarResult
    from curvis_tpu_torch.render import disk as rd
    bh = make_metric("schwarzschild", m=1.0, device=DEVICE)
    cam = disk_camera(RES)
    kw = dict(dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R)
    thin = rd.DiskParams(**DISK_THIN)
    star = rd.DiskParams(**DISK_STAR)
    vol_t = rd.DiskParams(**DISK_VOL)
    vol_b = dataclasses.replace(vol_t, color_mode="blackbody", t_peak=7000.0)
    vol_s = dataclasses.replace(vol_b, starlight=True, starlight_samples=256,
                                starlight_grid=(64, 128))
    poses = [disk_camera(RES, 0.5 * k) for k in range(FRAMES)]
    maps = {}

    def frame(disk, smap=None):
        return rd.render_blackhole_disk(bh, cam, sky, disk=disk,
                                        starlight_map=smap, **kw)

    # the frames without the disk's light and opacity, for the disk-pixel
    # gates
    dark = rd.DiskParams(brightness=0.0, opacity=0.0)
    bare = frame(dark)
    bare_batch = rd.render_disk_frames_batched(bh, poses, sky, disk=dark,
                                               **kw)

    jobs = [
        ("thin blackbody frame", lambda: frame(thin), bare, "disk"),
        ("starlight map (64 x 128, 256 samples)",
         lambda: maps.__setitem__("star", rd.compute_starlight_map(
             bh, sky, star, **kw)), None, "disk"),
        ("starlight frame (map precomputed)",
         lambda: frame(star, maps["star"]), bare, "disk"),
        ("volumetric tint frame", lambda: frame(vol_t), bare, "vol"),
        ("volumetric blackbody frame", lambda: frame(vol_b), bare, "vol"),
        ("volumetric blackbody + scatter frame (map precomputed)",
         lambda: frame(vol_s, maps["vol"]), bare, "vol"),
        (f"render_disk_frames_batched thin blackbody, {FRAMES} poses",
         lambda: rd.render_disk_frames_batched(bh, poses, sky, disk=thin,
                                               **kw), bare_batch, "disk"),
    ]
    maps["vol"] = rd.compute_starlight_map(bh, sky, vol_s, **kw)
    totals = {"disk": 0, "vol": 0}
    results = {}
    for name, fn, ref, which in jobs:
        disk_cuda.launches = 0
        disk_vol_cuda.launches = 0
        img = fn()                                         # warm-up
        ms = cuda_ms(fn, REPS)
        counts = {"disk": disk_cuda.launches, "vol": disk_vol_cuda.launches}
        totals = {k: totals[k] + counts[k] for k in totals}
        rays = 0 if ref is None else ref.numel() // 3
        rate = f" = {rays / ms / 1e3:.1f} Mrays/s" if rays else ""
        print(f"[12] {name}: {ms:.2f} ms (median of {REPS}){rate}; launches "
              f"#5 {counts['disk']}, #6 {counts['vol']}")
        require(counts[which] > 0, f"{name}: kernel {which} not launched: "
                f"{counts}")
        if ref is not None:
            disk_image_gates(name, img, ref)
        results[name] = (img, ms)
    require(maps["star"].values.shape == (2, 64, 128, 3)
            and bool(torch.isfinite(maps["star"].values).all()),
            "starlight map: shape or non-finite values")

    # the thin frame against the same route with kernel #5's plain version
    def plain_thin(metric, rays, c1, c2, *, stepper, rtol, dt, max_steps,
                   escape_radius, r_inner, r_outer):
        require(stepper == "euler", f"plain thin route with {stepper}")
        kind, scal = disk_cuda.disk_scalars(metric, dt, escape_radius,
                                            r_inner, r_outer)
        out = disk_cuda.march_planar_disk_plain(
            kind, scal, rays.l, rays.psi, rays.p_l, rays.b, c1, c2,
            max_steps=max_steps)
        return PlanarResult(*out[:5]), tuple(out[5:8]), tuple(out[8:11])

    disk_cuda.launches = 0
    with mock.patch.object(rd, "_march_thin", plain_thin):
        img_p = frame(thin)
    require(disk_cuda.launches == 0, "the plain route launched kernel #5")
    img_k = results["thin blackbody frame"][0]
    diff = ((img_k - img_p).abs().amax(-1) > DISK_IMG_TOL).double().mean()
    print(f"[12] thin blackbody frame vs the plain route: {diff.item():.6f} "
          f"of pixels differ by > {DISK_IMG_TOL}")
    require(diff.item() <= DISK_IMG_FRAC_MAX,
            f"thin frame vs plain route: {diff.item()}")

    # the CLI at 256^2, thin and volumetric
    with tempfile.TemporaryDirectory() as tmp:
        for extra, which in ((("--disk-color", "blackbody"), "disk"),
                             (("--disk-volumetric",), "vol")):
            disk_cuda.launches = 0
            disk_vol_cuda.launches = 0
            t0 = time.perf_counter()
            png = run_disk_cli(Path(tmp), sky_np, extra)
            secs = time.perf_counter() - t0
            counts = {"disk": disk_cuda.launches,
                      "vol": disk_vol_cuda.launches}
            totals = {k: totals[k] + counts[k] for k in totals}
            # a disk pixel is brighter than the dim sky's brightest texel
            sky_max = int((255 * sky_np).astype(np.uint8).sum(-1).max())
            frac = (png.astype(int).sum(-1) > sky_max).mean()
            print(f"[12] cli image --disk {' '.join(extra)}: {png.shape} in "
                  f"{secs:.2f} s (host clock, first call); launches #5 "
                  f"{counts['disk']}, #6 {counts['vol']}; disk-pixel "
                  f"fraction {frac:.6f}")
            require(counts[which] > 0, f"cli {extra}: kernel {which} not "
                    f"launched: {counts}")
            require(png.shape == (256, 256, 3)
                    and DISK_FRAC[0] < frac < DISK_FRAC[1],
                    f"cli {extra}: shape {png.shape} or disk fraction "
                    f"{frac}")
    print(f"[12] launches over the disk path: #5 {totals['disk']}, #6 "
          f"{totals['vol']}")
    profile_window(lambda: frame(thin), "[12]",
                   f"the thin blackbody frame ({RES}^2)")
    profile_window(lambda: frame(vol_b), "[12]",
                   f"the volumetric blackbody frame ({RES}^2)")
    return totals


def kerr_camera(res, l=KERR_L, focal=24.0, phi=0.0):
    """The example's Kerr camera at azimuth ``phi``, looking at the hole."""
    from curvis_tpu_torch.camera.camera import make_camera
    st, ct = math.sin(DISK_TH), math.cos(DISK_TH)
    return make_camera([0.0, l, DISK_TH, phi],
                       [-st * math.cos(phi), -st * math.sin(phi), -ct],
                       [0.0, 0.0, 1.0], focal, 43.0, res[0], res[1],
                       device=DEVICE)


def kerr_map_bundle(metric):
    """The Kerr starlight map's 48 x 128 secondary rays (x0, p0): a
    cosine-weighted hemisphere at each of 48 radii of the band."""
    import torch
    from curvis_tpu_torch.physics.hamiltonian import spawn_photon
    from curvis_tpu_torch.render.starlight import _cosine_hemisphere
    rr = torch.linspace(KERR_BAND[0], KERR_BAND[1], 48, device=DEVICE)
    hemi = [torch.as_tensor(h, dtype=torch.float32, device=DEVICE)
            for h in _cosine_hemisphere(128)]
    r0 = rr[:, None].expand(48, 128).reshape(-1)
    z = torch.zeros_like(r0)
    x0 = torch.stack([z, r0, torch.full_like(r0, math.pi / 2), z], -1)
    d3 = torch.stack([h[None, :].expand(48, 128).reshape(-1)
                      for h in (hemi[0], -hemi[2], hemi[1])], -1)
    return x0, spawn_photon(metric, x0, d3)


def kerr_flops(flags):
    """FP32 operations of one kernel #7 step for its flags."""
    track, vol, blackbody, beaming, scatter = flags
    n = FLOP_KERR_STEP + (FLOP_KERR["disk"] if track else 0)
    if vol:
        n += FLOP_KERR["vol"] + (FLOP_KERR["beaming"] if beaming else 0)
        n += FLOP_KERR["blackbody" if blackbody else "tint"]
        n += FLOP_KERR["scatter"] if scatter else 0
    return n


def kerr_agreement(metric, flags, out_k, out_p, E, L):
    """Kernel #7 against its plain version, both (r, theta, phi, p_r,
    p_theta, sign, steps, extra...) of rays with constants (E, L):
    fractions of equal sign and steps, the p99 angle between the escape
    directions of the rays escaped in both and their largest component
    difference, and per variant the hit or transfer agreement."""
    import numpy as np
    import torch
    from curvis_tpu_torch.render.kerr import _asymptotic_dirs
    sign_k, sign_p = out_k[5], out_p[5]
    a = dict(sign_eq=(sign_k == sign_p).double().mean().item(),
             steps_eq=(out_k[6] == out_p[6]).double().mean().item())
    esc = (sign_k == 1) & (sign_p == 1)

    def dirs(o):
        x = torch.stack([torch.zeros_like(o[0]), o[0], o[1], o[2]], -1)
        p = torch.stack([-E, o[3], o[4], L], -1)
        return _asymptotic_dirs(metric, x[esc].double(), p[esc].double())

    w_k, w_p = dirs(out_k), dirs(out_p)
    ang, d_k, d_p = angles(w_k, w_p, torch.ones_like(w_k[0],
                                                     dtype=torch.bool))
    a["angle_p99"] = float(np.percentile(ang, 99)) if ang.size else 0.0
    a["max_abs"] = float((d_k - d_p).abs().max()) if ang.size else 0.0
    if flags[0]:
        pres, rel, dph, side = [], [], [], []
        for i in (7, 10):
            hk, hp = out_k[i].double(), out_p[i].double()
            pres.append(((hk != 0) == (hp != 0)).double().mean().item())
            both = (hk != 0) & (hp != 0)
            rel.append(((hk - hp).abs() / hp.abs())[both])
            dph.append((out_k[i + 1].double()
                        - out_p[i + 1].double()).abs()[both])
            side.append((out_k[i + 2] == out_p[i + 2])[both])
        rel, dph = (torch.cat(t).cpu().numpy() for t in (rel, dph))
        a.update(hit_eq=min(pres), n_hits=int(rel.size),
                 rel_p99=float(np.percentile(rel, 99)) if rel.size else 0.0,
                 dphi_p99=float(np.percentile(dph, 99)) if dph.size else 0.0,
                 side_ne=int((~torch.cat(side)).sum()))
    if flags[1]:
        a["close"], a["em_max_abs"] = close_fraction(out_k[7:11],
                                                     out_p[7:11])
    return a


def kerr_variant_gates(tag, name, metric, flags, vd, a, out_k, out_p):
    """The disk-tracker and volumetric gates of a Kerr kernel against its
    plain version (``a`` from kerr_agreement); returns the rays frozen by
    tau_max in (kernel, plain)."""
    import torch
    if flags[0]:
        print(f"{tag}   hits {a['n_hits']} in both; presence equal "
              f"{a['hit_eq']:.6f}, p99 rel radius {a['rel_p99']:.3e}, "
              f"p99 |dphi| {a['dphi_p99']:.3e}, sides differing "
              f"{a['side_ne']}")
        require(a["n_hits"] > 0, f"{name}: no disk hit")
        require(a["hit_eq"] >= HIT_EQ_MIN,
                f"{name}: hit presence equal {a['hit_eq']}")
        require(a["rel_p99"] < HIT_P99_MAX and a["dphi_p99"] < HIT_P99_MAX,
                f"{name}: hit radius / phi {a}")
        require(a["side_ne"] == 0, f"{name}: {a['side_ne']} sides differ")
    if not flags[1]:
        return [0, 0]
    r_cap = float(metric.capture_radius)
    frozen = [int(((o[5] == 2) & (o[0] > r_cap)).sum())
              for o in (out_k, out_p)]
    print(f"{tag}   tau and em within rtol {GRAD_RTOL} on "
          f"{a['close']:.6f} of rays (max |d| {a['em_max_abs']:.3e}); "
          f"frozen by tau_max {frozen[0]} / {frozen[1]} (kernel / plain); "
          f"tau max {out_k[7].max().item():.3f}")
    require(a["close"] >= GRAD_FRAC_MIN,
            f"{name}: close fraction {a['close']}")
    require(all(bool(torch.isfinite(t).all()) for t in out_k[7:11]),
            f"{name}: non-finite tau or emission")
    if vd.kappa > 10.0:
        require(min(frozen) > 0, f"{name}: no tau_max freeze {frozen}")
    return frozen


def phase13_kerr_march(sky):
    """Kernel #7 against march_kerr_plain on the card: the example's bare
    view at 960 x 540, Kerr-Newman at 256^2, the disk tracker, the
    volumetric variants (tint / blackbody, beaming on and off, the scatter
    source with a real Kerr starlight map's block), a kappa that freezes
    rays at tau_max, an exact step cap, 16 NaN rays and the starlight map's
    ray bundle."""
    import dataclasses
    import torch
    from curvis_tpu_torch.metrics.kerr import make_kerr, make_kerr_newman
    from curvis_tpu_torch.ops import kerr_cuda as kc
    from curvis_tpu_torch.render import kerr as rk
    from curvis_tpu_torch.render.disk import DiskParams
    from curvis_tpu_torch.render.starlight import (
        compute_kerr_starlight_map, starlight_scatter_block)
    kerr = make_kerr(1.0, KERR_A, device=DEVICE)
    kn = make_kerr_newman(1.0, 0.7, 0.5, device=DEVICE)
    far_bare = 8.0
    far_disk = max(8.0, KERR_BAND[1] + 2.0)
    R = 2.0 * KERR_L
    V = KERR_VOL
    tint = DiskParams(r_inner=KERR_BAND[0], r_outer=KERR_BAND[1],
                      volumetric=True, h_rel=0.07, kappa=3.0, doppler=True)
    bb = dataclasses.replace(tint, color_mode="blackbody", t_peak=6500.0)
    smap = compute_kerr_starlight_map(
        kerr, sky, r_inner=KERR_BAND[0], r_outer=KERR_BAND[1],
        escape_radius=30.0, dt=KERR_DT, max_steps=20_000, boost="orbit")
    block = starlight_scatter_block(smap, dataclasses.replace(
        bb, starlight=True, starlight_scatter=0.4))

    # name, metric, ray bundle, row keywords, dt, cap, escape radius, far
    # radius, NaN rays
    cam_bare = (kerr_camera(KERR_RES),)
    small = (kerr_camera(KERR_SMALL),)
    vol_cam = (kerr_camera(KERR_SMALL, V["l"], V["focal"]),)
    vkw = (V["dt"], KERR_VOL_CHECK_CAP, V["R"], far_disk)
    configs = [
        (f"bare {KERR_RES[0]}x{KERR_RES[1]} (the path's view)", kerr,
         cam_bare, {}, KERR_DT, KERR_CHECK_CAP, R, far_bare, 0),
        ("kerr-newman 256^2", kn, (kerr_camera((SMALL, SMALL)),), {},
         KERR_DT, KERR_CHECK_CAP, R, far_bare, 0),
        (f"disk tracker {KERR_SMALL[0]}x{KERR_SMALL[1]}", kerr, small,
         dict(disk=KERR_BAND), KERR_DT, KERR_CHECK_CAP, R, far_disk, 0),
        (f"vol tint {KERR_SMALL[0]}x{KERR_SMALL[1]}", kerr, vol_cam,
         dict(vol_disk=tint), *vkw, 0),
        ("vol tint, no beaming", kerr, vol_cam,
         dict(vol_disk=dataclasses.replace(tint, doppler=False,
                                           redshift=False)), *vkw, 0),
        ("vol blackbody", kerr, vol_cam, dict(vol_disk=bb), *vkw, 0),
        ("vol blackbody, no beaming", kerr, vol_cam,
         dict(vol_disk=dataclasses.replace(bb, doppler=False,
                                           redshift=False)), *vkw, 0),
        ("vol tint + scatter", kerr, vol_cam,
         dict(vol_disk=tint, scatter_block=block), *vkw, 0),
        ("vol blackbody + scatter", kerr, vol_cam,
         dict(vol_disk=bb, scatter_block=block), *vkw, 0),
        ("vol kappa 40 (tau_max freeze) 256^2", kerr,
         (kerr_camera((SMALL, SMALL), V["l"], V["focal"]),),
         dict(vol_disk=dataclasses.replace(tint, kappa=40.0)), *vkw, 0),
        (f"bare 256^2 cap {KERR_CAP}", kerr, (kerr_camera((SMALL, SMALL)),),
         {}, KERR_DT, KERR_CAP, R, far_bare, 0),
        (f"bare 256^2 with {N_POISON} NaN rays", kerr,
         (kerr_camera((SMALL, SMALL)),), {}, KERR_DT, KERR_CHECK_CAP, R,
         far_bare, N_POISON),
        ("starlight map rays 48 x 128", kerr, None, dict(disk=KERR_BAND),
         KERR_DT, KERR_CHECK_CAP, 30.0, far_disk, 0),
    ]
    out = {}
    frozen_seen = [0, 0]
    for name, metric, cams, row_kw, dt, cap, esc_r, far_r0, n_nan in configs:
        if cams is None:
            x0, p0 = kerr_map_bundle(kerr)
        else:
            x0, p0, _ = rk._spawn_kerr_rays(metric, cams[0])
        scal = kc.kerr_scalars(metric, dt, esc_r, axis_u0=0.01,
                               far_r0=far_r0, **row_kw)
        vd = row_kw.get("vol_disk")
        flags = ("disk" in row_kw, vd is not None,
                 vd is not None and vd.color_mode == "blackbody",
                 vd is not None and bool(vd.redshift or vd.doppler),
                 "scatter_block" in row_kw)
        ins = [t.contiguous() for t in (x0[:, 1], x0[:, 2], x0[:, 3],
                                        p0[:, 1], p0[:, 2], -p0[:, 0],
                                        p0[:, 3])]
        ins[0], bad = poison_rays(ins[0], n_nan)
        out_k = kc.launch(flags, scal, *ins, max_steps=cap)
        sync()
        t0 = time.perf_counter()
        out_p = kc.march_kerr_plain(flags, scal, *ins, max_steps=cap)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        a = kerr_agreement(metric, flags, out_k, out_p, ins[5], ins[6])
        kernel_ms = cuda_ms(lambda: kc.launch(flags, scal, *ins,
                                              max_steps=cap), 3)
        n = ins[0].numel()
        steps = out_k[6].double()
        counts = {s_: int((out_k[5] == s_).sum()) for s_ in range(4)}
        print(f"[13] kerr march {name}: {n} rays, signs {counts}; sign "
              f"equal {a['sign_eq']:.6f}, steps equal {a['steps_eq']:.6f}, "
              f"p99 escape angle {a['angle_p99']:.3e} rad, max |dw| "
              f"{a['max_abs']:.3e}")
        print(f"[13]   steps mean / max {steps.mean().item():.1f} / "
              f"{int(steps.max())}; kernel {kernel_ms:.3f} ms "
              f"({n / kernel_ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms")
        require(a["sign_eq"] >= SIGN_EQ_MIN,
                f"kerr {name}: sign equal {a['sign_eq']}")
        require(a["steps_eq"] >= STEPS_EQ_MIN,
                f"kerr {name}: steps equal {a['steps_eq']}")
        require(a["angle_p99"] < KERR_ANGLE_P99,
                f"kerr {name}: p99 escape angle {a['angle_p99']}")
        frozen = kerr_variant_gates("[13]", f"kerr {name}", metric, flags,
                                    vd, a, out_k, out_p)
        frozen_seen = [f + g for f, g in zip(frozen_seen, frozen)]
        for who, o in (("kernel", out_k), ("plain", out_p)):
            require(int(o[6].max()) <= cap
                    and bool((o[6][o[5] == 0] == cap).all()),
                    f"kerr {name}: {who} overshot or undershot the cap")
            if n_nan:
                require(bool((o[5][bad] == 3).all())
                        and bool((o[6][bad] == 1).all()),
                        f"kerr {name}: {who} NaN rays not sign 3 at step 1")
        if cap == KERR_CAP:
            capped = (out_k[5] == 0).double().mean().item()
            print(f"[13]   {capped:.4f} of rays stopped at the cap of {cap}")
            require(capped > 0.5, f"kerr {name}: only {capped} capped")
        # 28 bytes read; 28 written, and 24 (hits) or 16 (transfer) more
        n_bytes = (56 + (24 if flags[0] else 16 if flags[1] else 0)) * n
        b_ms, b_by = bound(n_bytes, kerr_flops(flags) * steps.sum().item())
        out[name] = dict(max_abs_err=a["max_abs"], ms=kernel_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"[13]   bound {b_ms:.3f} ms ({b_by}); kernel at "
              f"{100 * b_ms / kernel_ms:.1f} % of it")
    print(f"[13] tau_max freeze seen on {frozen_seen[0]} / {frozen_seen[1]} "
          f"rays (kernel / plain) over the volumetric cases")
    return out[configs[0][0]]


def kerr_disk_gates(name, img, dark, frac_range, tag="[14]"):
    """Finite pixels and the disk-pixel fraction (inside ``frac_range``) of
    a Kerr disk frame: a disk pixel differs by > DISK_IMG_TOL from
    ``dark``, the same view rendered with a disk of zero brightness and
    opacity."""
    import torch
    require(img.shape == dark.shape, f"{name}: shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), f"{name}: non-finite pixel")
    imgs = img.reshape(-1, *img.shape[-3:])
    darks = dark.reshape(-1, *dark.shape[-3:])
    disk = [((im - d).abs().amax(-1) > DISK_IMG_TOL).double().mean().item()
            for im, d in zip(imgs, darks)]
    print(f"{tag}   {name}: disk-pixel fraction {min(disk):.6f}.."
          f"{max(disk):.6f}")
    require(frac_range[0] < min(disk) and max(disk) < frac_range[1],
            f"{name}: disk-pixel fraction {disk}")


def shadow_stats(img):
    """(captured fraction, centroid column offset from the image centre)
    of a frame over a sky without black texels."""
    import torch
    black = img.sum(-1) == 0
    cols = torch.nonzero(black)[:, 1].double()
    shift = float(cols.mean()) - (img.shape[1] - 1) / 2 if cols.numel() else 0
    return black.double().mean().item(), shift


def run_kerr_cli(tmp, sky_np, extra):
    """``image`` with a ``kind = "kerr"`` TOML through the CLI's main on a
    256^2 view of the Kerr path's scene; returns the saved image."""
    import numpy as np
    from PIL import Image
    from curvis_tpu_torch.cli import main as cli_main
    for name in ("bg1.png", "bg2.png"):
        Image.fromarray((255 * sky_np).astype(np.uint8)).save(tmp / name)
    (tmp / "cam.toml").write_text(
        "resolution_x = 256\nresolution_y = 256\ndiagonal = 43.0\n"
        "focal_length = 24.0\n")
    (tmp / "sim.toml").write_text(
        f"escape_radius = {2 * KERR_L}\nray_integration_max_iterations = "
        f"{KERR_STEPS}\nray_integration_step = {KERR_DT}\n")
    (tmp / "metric.toml").write_text(
        f'kind = "kerr"\nm = 1.0\na = {KERR_A}\n')
    (tmp / "img.toml").write_text(
        f"l = {KERR_L}\ntheta = {DISK_TH!r}\nphi = 0.0\n"
        f"forward_x = {-math.sin(DISK_TH)!r}\nforward_y = 0.0\n"
        f"forward_z = {-math.cos(DISK_TH)!r}\n")
    out = tmp / "out"
    rc = cli_main(["image", str(tmp / "bg1.png"), str(tmp / "bg2.png"),
                   str(out), "-m", str(tmp / "metric.toml"), "-c",
                   str(tmp / "cam.toml"), "-s", str(tmp / "sim.toml"), "-i",
                   str(tmp / "img.toml"), "--filtering", "bilinear",
                   "--disk", *extra])
    require(rc == 0, f"cli image kerr {extra}: exit code {rc}")
    return np.asarray(Image.open(out / "output_image.png"))


def kerr_path(tag, sky, sky_np, bright, rk45):
    """The Kerr path end to end at 960 x 540 through its entry points (the
    six jobs of examples/render_blackholes.py, frames batched, adaptive and
    the CLI at 256^2) with RK4 or, with ``rk45``, stepper='rk45' at
    KERR_RTOL: each job's launches of the march kernel (#7, or #8 and none
    of #7), the disk-pixel and shadow gates, and profiles of a thin and a
    volumetric frame.  Returns the total launches and the (camera, disk,
    keywords) of the bare, thin and volumetric frames."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from curvis_tpu_torch.metrics.kerr import make_kerr, make_kerr_newman
    from curvis_tpu_torch.ops import kerr_cuda, kerr_rk45_cuda
    from curvis_tpu_torch.render import kerr as rk
    from curvis_tpu_torch.render.disk import DiskParams
    from curvis_tpu_torch.render.starlight import compute_kerr_starlight_map
    counter, knum = (kerr_rk45_cuda, "#8") if rk45 else (kerr_cuda, "#7")
    label = "rk45 " if rk45 else ""
    step_kw = dict(stepper="rk45", rtol=KERR_RTOL) if rk45 else {}
    kerr = make_kerr(1.0, KERR_A, device=DEVICE)
    kn = make_kerr_newman(1.0, 0.7, 0.5, device=DEVICE)
    V = KERR_VOL
    cam = kerr_camera(KERR_RES)
    vcam = kerr_camera(KERR_RES, V["l"], V["focal"])
    poses = [kerr_camera(KERR_RES, phi=0.5 * k) for k in range(FRAMES)]
    band = dict(r_inner=KERR_BAND[0], r_outer=KERR_BAND[1])
    kdisk = DiskParams(**band, doppler=True, color_mode="blackbody",
                       t_peak=7000.0, brightness=14.0)
    voldisk = DiskParams(**band, volumetric=True, h_rel=0.07, kappa=3.0,
                         doppler=True, color_mode="blackbody", t_peak=6500.0,
                         brightness=14.0)
    kstar = dataclasses.replace(kdisk, brightness=10.0, starlight=True,
                                albedo=(0.5, 0.5, 0.55))
    volstar = dataclasses.replace(voldisk, brightness=8.0, starlight=True,
                                  albedo=(0.45, 0.45, 0.5),
                                  starlight_scatter=0.4)
    dark = DiskParams(**band, brightness=0.0, opacity=0.0)
    kw = dict(dt=KERR_DT, max_steps=KERR_STEPS, **step_kw)
    vkw = dict(dt=V["dt"], max_steps=V["steps"], escape_radius=V["R"],
               **step_kw)
    maps = {}

    def smap():
        return compute_kerr_starlight_map(
            kerr, sky, **band, escape_radius=30.0, dt=KERR_DT,
            max_steps=20_000, n_r=48, n_phi=128, n_samples=128,
            boost="orbit", **step_kw)

    def launches():
        return counter.launches, kerr_cuda.launches if rk45 else 0

    def reset():
        counter.launches = 0
        kerr_cuda.launches = 0

    maps["star"] = smap()
    # the views with a dark disk, for the disk-pixel gates
    dark_k = rk.render_kerr(kerr, cam, sky, disk=dark, **kw)
    dark_v = rk.render_kerr(kerr, vcam, sky, disk=dark, **vkw)
    dark_kn = rk.render_kerr(kn, cam, sky, disk=dark, **kw)
    dark_b = rk.render_kerr_frames_batched(kerr, poses, sky, disk=dark,
                                           **kw)
    jobs = [
        ("bare shadow", lambda: rk.render_kerr(kerr, cam, bright, **kw),
         None),
        ("thin blackbody disk",
         lambda: rk.render_kerr(kerr, cam, sky, disk=kdisk, **kw), dark_k),
        ("volumetric gas disk",
         lambda: rk.render_kerr(kerr, vcam, sky, disk=voldisk, **vkw),
         dark_v),
        ("starlight map (48 x 128, 128 samples, orbit boost)",
         lambda: maps.__setitem__("star", smap()), None),
        ("starlit thin disk (map precomputed)",
         lambda: rk.render_kerr(kerr, cam, sky, disk=kstar,
                                starlight_map=maps["star"], **kw), dark_k),
        ("in-gas scatter (map precomputed)",
         lambda: rk.render_kerr(kerr, vcam, sky, disk=volstar,
                                starlight_map=maps["star"], **vkw), dark_v),
        ("kerr-newman a 0.7 q 0.5, thin disk",
         lambda: rk.render_kerr(kn, cam, sky, disk=kdisk, **kw), dark_kn),
        (f"render_kerr_frames_batched thin disk, {FRAMES} poses",
         lambda: rk.render_kerr_frames_batched(kerr, poses, sky, disk=kdisk,
                                               **kw), dark_b),
        ("render_kerr_adaptive thin disk, refine_frac 0.1",
         lambda: rk.render_kerr_adaptive(kerr, cam, sky, disk=kdisk,
                                         refine_frac=0.1, **kw), dark_k),
    ]
    total = 0
    results = {}
    for name, fn, ref in jobs:
        reset()
        img = fn()                                         # warm-up
        ms = cuda_ms(fn, REPS)
        n, n7 = launches()
        total += n
        px = 0 if img is None else img.numel() // 3
        rate = f" = {px / ms / 1e3:.1f} Mpixels/s" if px else ""
        print(f"{tag} {label}{name}: {ms:.2f} ms (median of {REPS}){rate}; "
              f"launches {knum} {n}" + (f", #7 {n7}" if rk45 else ""))
        require(n > 0 and n7 == 0,
                f"{label}{name}: launches {knum} {n}, #7 {n7}")
        if ref is not None:
            kerr_disk_gates(f"{label}{name}", img, ref,
                            KERR_VOL_FRAC if ref is dark_v else DISK_FRAC,
                            tag=tag)
        results[name] = (img, ms)
    star = maps["star"].values
    require(star.shape == (2, 48, 128, 3) and bool(torch.isfinite(star).all()),
            f"{label}kerr starlight map: shape or non-finite values")

    # the shadow: captured fraction and the spin's displacement of it
    shadow = results["bare shadow"][0]
    require(bool(torch.isfinite(shadow).all()),
            f"{label}bare shadow: non-finite")
    frac, shift = shadow_stats(shadow)
    slow = rk.render_kerr(make_kerr(1.0, 1e-3, device=DEVICE), cam, bright,
                          **kw)
    frac0, shift0 = shadow_stats(slow)
    print(f"{tag} {label}shadow: captured fraction {frac:.6f} (a = "
          f"{KERR_A}) / {frac0:.6f} (a = 0.001); centroid column offset "
          f"{shift:.2f} / {shift0:.2f} px")
    require(KERR_SHADOW[0] < frac < KERR_SHADOW[1],
            f"{label}shadow captured fraction {frac}")
    require(abs(shift - shift0) > KERR_SHIFT_MIN,
            f"{label}no prograde / retrograde shadow asymmetry: {shift} vs "
            f"{shift0}")

    # the CLI at 256^2, thin and volumetric
    cli_step = ("--stepper", "rk45") if rk45 else ()
    with tempfile.TemporaryDirectory() as tmp:
        for extra in ((*cli_step, "--disk-color", "blackbody"),
                      (*cli_step, "--disk-volumetric", "--disk-color",
                       "blackbody")):
            reset()
            t0 = time.perf_counter()
            png = run_kerr_cli(Path(tmp), sky_np, extra)
            secs = time.perf_counter() - t0
            n, n7 = launches()
            total += n
            sky_max = int((255 * sky_np).astype(np.uint8).sum(-1).max())
            frac = (png.astype(int).sum(-1) > sky_max).mean()
            print(f"{tag} cli image kerr --disk {' '.join(extra)}: "
                  f"{png.shape} in {secs:.2f} s (host clock, first call); "
                  f"launches {knum} {n}" + (f", #7 {n7}" if rk45 else "")
                  + f"; disk-pixel fraction {frac:.6f}")
            require(n > 0 and n7 == 0,
                    f"cli {extra}: launches {knum} {n}, #7 {n7}")
            require(png.shape == (256, 256, 3)
                    and DISK_FRAC[0] < frac < DISK_FRAC[1],
                    f"cli {extra}: shape {png.shape} or disk fraction "
                    f"{frac}")
    print(f"{tag} launches of {knum} over the Kerr {label}path: {total}")
    profile_window(lambda: rk.render_kerr(kerr, cam, sky, disk=kdisk, **kw),
                   tag, f"the thin blackbody Kerr {label}frame (960 x 540)")
    profile_window(lambda: rk.render_kerr(kerr, vcam, sky, disk=voldisk,
                                          **vkw),
                   tag, f"the volumetric Kerr {label}frame (960 x 540)")
    return total, dict(bare=(cam, None, kw), thin=(cam, kdisk, kw),
                       vol=(vcam, voldisk, vkw))


def phase14_kerr_path(sky, sky_np, bright):
    """The Kerr path end to end at 960 x 540 with RK4 (kerr_path); returns
    the launches of kernel #7."""
    return kerr_path("[14]", sky, sky_np, bright, rk45=False)[0]


def kerr_rk45_flops(flags, iters, steps):
    """FP32 operations of kernel #8 for its flags over ``iters`` iterations
    of which ``steps`` were accepted."""
    track, vol, blackbody, beaming, scatter = flags
    per_iter = FLOP_KERR_RK45_ITER
    per_iter += FLOP_KERR_RK45["disk"] if track else 0
    per_step = 0
    if vol:
        per_iter += FLOP_KERR_RK45["vol_clamp"]
        per_step = FLOP_KERR["vol"] + FLOP_KERR_RK45["vol_sum"]
        per_step += FLOP_KERR["beaming"] if beaming else 0
        per_step += FLOP_KERR["blackbody" if blackbody else "tint"]
        per_step += FLOP_KERR["scatter"] if scatter else 0
    return per_iter * iters + per_step * steps


def parked_rays(metric, R, n=128):
    """``n`` rays parked exactly on the escape radius R, looking outward
    (the regression of tests/test_kerr.py:655-685: a frac-only boundary
    rule over-rejects them forever)."""
    import torch
    from curvis_tpu_torch.physics.hamiltonian import spawn_photon
    x0 = torch.tensor([0.0, R, DISK_TH, 0.0], device=DEVICE).expand(n, 4)
    d = torch.tensor([1.0, 0.3, 0.1], device=DEVICE)
    return x0, spawn_photon(metric, x0, (d / d.norm()).expand(n, 3))


def phase15_kerr_rk45_march(sky):
    """Kernel #8 against march_kerr_rk45_plain on the card at rtol 1e-4:
    the example's bare view at 960 x 540, Kerr-Newman at 256^2, the disk
    tracker and the volumetric variants (tint / blackbody, beaming on and
    off, the scatter source of a real rk45 Kerr starlight map) at 480 x
    270, a kappa that freezes rays at tau_max, a step cap and a small odd
    max_iters that most rays reach, 16 NaN rays, rays parked on the escape
    radius and the starlight map's ray bundle.  The smaller cases run at
    480 x 270 and 256^2 to keep the plain version's time down."""
    import dataclasses
    import torch
    from curvis_tpu_torch.metrics.kerr import make_kerr, make_kerr_newman
    from curvis_tpu_torch.ops import kerr_rk45_cuda as kr
    from curvis_tpu_torch.render import kerr as rk
    from curvis_tpu_torch.render.disk import DiskParams
    from curvis_tpu_torch.render.starlight import (
        compute_kerr_starlight_map, starlight_scatter_block)
    kerr = make_kerr(1.0, KERR_A, device=DEVICE)
    kn = make_kerr_newman(1.0, 0.7, 0.5, device=DEVICE)
    R = 2.0 * KERR_L
    V = KERR_VOL
    tint = DiskParams(r_inner=KERR_BAND[0], r_outer=KERR_BAND[1],
                      volumetric=True, h_rel=0.07, kappa=3.0, doppler=True)
    bb = dataclasses.replace(tint, color_mode="blackbody", t_peak=6500.0)
    smap = compute_kerr_starlight_map(
        kerr, sky, r_inner=KERR_BAND[0], r_outer=KERR_BAND[1],
        escape_radius=30.0, dt=KERR_DT, max_steps=20_000, boost="orbit",
        stepper="rk45", rtol=KERR_RTOL)
    block = starlight_scatter_block(smap, dataclasses.replace(
        bb, starlight=True, starlight_scatter=0.4))

    def view(res, l=KERR_L, focal=24.0, metric=kerr):
        return lambda: rk._spawn_kerr_rays(metric, kerr_camera(res, l,
                                                               focal))[:2]

    small = (SMALL, SMALL)
    vol_view = view(KERR_SMALL, V["l"], V["focal"])
    vkw = (V["dt"], KERR_RK45_VOL_CHECK_CAP, None, V["R"])
    # name, metric, rays, row keywords, dt0, cap, max_iters, escape radius,
    # NaN rays
    configs = [
        (f"bare {KERR_RES[0]}x{KERR_RES[1]} (the path's view)", kerr,
         view(KERR_RES), {}, KERR_DT, KERR_STEPS, None, R, 0),
        ("kerr-newman 256^2", kn, view(small, metric=kn), {}, KERR_DT,
         KERR_STEPS, None, R, 0),
        (f"disk tracker {KERR_SMALL[0]}x{KERR_SMALL[1]}", kerr,
         view(KERR_SMALL), dict(disk=KERR_BAND), KERR_DT, KERR_STEPS, None,
         R, 0),
        (f"vol tint {KERR_SMALL[0]}x{KERR_SMALL[1]}", kerr, vol_view,
         dict(vol_disk=tint), *vkw, 0),
        ("vol tint, no beaming", kerr, vol_view,
         dict(vol_disk=dataclasses.replace(tint, doppler=False,
                                           redshift=False)), *vkw, 0),
        ("vol blackbody", kerr, vol_view, dict(vol_disk=bb), *vkw, 0),
        ("vol blackbody, no beaming", kerr, vol_view,
         dict(vol_disk=dataclasses.replace(bb, doppler=False,
                                           redshift=False)), *vkw, 0),
        ("vol tint + scatter", kerr, vol_view,
         dict(vol_disk=tint, scatter_block=block), *vkw, 0),
        ("vol blackbody + scatter", kerr, vol_view,
         dict(vol_disk=bb, scatter_block=block), *vkw, 0),
        ("vol kappa 40 (tau_max freeze) 256^2", kerr,
         view(small, V["l"], V["focal"]),
         dict(vol_disk=dataclasses.replace(tint, kappa=40.0)), *vkw, 0),
        (f"bare 256^2 cap {KERR_RK45_CAP}", kerr, view(small), {}, KERR_DT,
         KERR_RK45_CAP, None, R, 0),
        (f"bare 256^2 max_iters {KERR_RK45_ITERS}", kerr, view(small), {},
         KERR_DT, KERR_STEPS, KERR_RK45_ITERS, R, 0),
        (f"bare 256^2 with {N_POISON} NaN rays", kerr, view(small), {},
         KERR_DT, KERR_STEPS, None, R, N_POISON),
        ("128 rays parked on the escape radius", kerr,
         lambda: parked_rays(kerr, R), {}, KERR_DT, KERR_STEPS, None, R, 0),
        ("starlight map rays 48 x 128", kerr, lambda: kerr_map_bundle(kerr),
         dict(disk=KERR_BAND), KERR_DT, 20_000, None, 30.0, 0),
    ]
    out = {}
    frozen_seen = [0, 0]
    for (name, metric, rays, row_kw, dt, cap, max_iters, esc_r,
         n_nan) in configs:
        x0, p0 = rays()
        scal = kr.kerr_rk45_scalars(metric, dt, esc_r, rtol=KERR_RTOL,
                                    atol=KERR_RTOL * 1e-3, dt_min=1e-5,
                                    dt_max=esc_r / 8.0, **row_kw)
        mi = kr.default_max_iters(cap, max_iters)
        vd = row_kw.get("vol_disk")
        flags = ("disk" in row_kw, vd is not None,
                 vd is not None and vd.color_mode == "blackbody",
                 vd is not None and bool(vd.redshift or vd.doppler),
                 "scatter_block" in row_kw)
        ins = [t.contiguous() for t in (x0[:, 1], x0[:, 2], x0[:, 3],
                                        p0[:, 1], p0[:, 2], -p0[:, 0],
                                        p0[:, 3])]
        ins[0], bad = poison_rays(ins[0], n_nan)
        kw = dict(max_steps=cap, max_iters=mi)
        out_k = kr.launch(flags, scal, *ins, **kw)
        sync()
        t0 = time.perf_counter()
        out_p = kr.march_kerr_rk45_plain(flags, scal, *ins, **kw)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        a = kerr_agreement(metric, flags, out_k, out_p, ins[5], ins[6])
        steps_near = ((out_k[6] - out_p[6]).abs()
                      <= STEPS_NEAR).double().mean().item()
        iters_eq = (out_k[-1] == out_p[-1]).double().mean().item()
        kernel_ms = cuda_ms(lambda: kr.launch(flags, scal, *ins, **kw), 3)
        n = ins[0].numel()
        steps, iters = out_k[6].double(), out_k[-1].double()
        counts = {s_: int((out_k[5] == s_).sum()) for s_ in range(4)}
        print(f"[15] kerr rk45 march {name}: {n} rays, signs {counts}; sign "
              f"equal {a['sign_eq']:.6f}, steps within {STEPS_NEAR} "
              f"{steps_near:.6f} (equal {a['steps_eq']:.6f}), iters equal "
              f"{iters_eq:.6f}, p99 escape angle {a['angle_p99']:.3e} rad, "
              f"max |dw| {a['max_abs']:.3e}")
        print(f"[15]   steps mean / max {steps.mean().item():.2f} / "
              f"{int(steps.max())}, iters mean / max "
              f"{iters.mean().item():.2f} / {int(iters.max())}; kernel "
              f"{kernel_ms:.3f} ms ({n / kernel_ms / 1e3:.1f} Mrays/s), plain "
              f"{plain_ms:.1f} ms")
        print(f"[15]   digest of the kernel's outputs {digest(out_k)}, of "
              f"the plain version's {digest(out_p)}")
        require(a["sign_eq"] >= SIGN_EQ_MIN,
                f"kerr rk45 {name}: sign equal {a['sign_eq']}")
        require(steps_near >= STEPS_EQ_MIN,
                f"kerr rk45 {name}: steps within {STEPS_NEAR} {steps_near}")
        require(a["angle_p99"] < KERR_ANGLE_P99,
                f"kerr rk45 {name}: p99 escape angle {a['angle_p99']}")
        frozen = kerr_variant_gates("[15]", f"kerr rk45 {name}", metric,
                                    flags, vd, a, out_k, out_p)
        frozen_seen = [f + g for f, g in zip(frozen_seen, frozen)]
        for who, o in (("kernel", out_k), ("plain", out_p)):
            st, it, sg = o[6], o[-1], o[5]
            require(int(st.max()) <= cap and int(it.max()) <= mi
                    and bool((it >= st).all())
                    and bool((st[(sg == 0) & (it < mi)] == cap).all()),
                    f"kerr rk45 {name}: {who} overshot or undershot a cap")
            if n_nan:
                require(bool((sg[bad] == 3).all())
                        and bool((st[bad] == 0).all()),
                        f"kerr rk45 {name}: {who} NaN rays not sign 3 "
                        "without a step")
            if name.startswith("128 rays parked"):
                require(bool((sg == 1).all())
                        and float(o[0].max()) <= R * (1.0 + 1e-3),
                        f"kerr rk45 {name}: {who} parked rays did not "
                        f"escape at R: {counts}")
        if cap == KERR_RK45_CAP:
            capped = (out_k[5] == 0).double().mean().item()
            print(f"[15]   {capped:.4f} of rays stopped at the cap of {cap}")
            require(capped > 0.5, f"kerr rk45 {name}: only {capped} capped")
        if max_iters is not None:
            at_mi = ((out_k[-1] == mi) & (out_k[5] == 0)).double().mean()
            print(f"[15]   {at_mi.item():.4f} of rays stopped at max_iters "
                  f"{mi} (given {max_iters})")
            require(at_mi.item() > 0.05,
                    f"kerr rk45 {name}: only {at_mi.item()} at max_iters")
        # 28 bytes read; 20 + 12 written, and 24 (hits) or 16 (transfer)
        n_bytes = (60 + (24 if flags[0] else 16 if flags[1] else 0)) * n
        b_ms, b_by = bound(n_bytes, kerr_rk45_flops(
            flags, iters.sum().item(), steps.sum().item()))
        out[name] = dict(max_abs_err=a["max_abs"], ms=kernel_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"[15]   bound {b_ms:.3f} ms ({b_by}); kernel at "
              f"{100 * b_ms / kernel_ms:.1f} % of it")
    print(f"[15] tau_max freeze seen on {frozen_seen[0]} / {frozen_seen[1]} "
          f"rays (kernel / plain) over the volumetric cases")
    return out[configs[0][0]]


def smooth_sky(dtype=None):
    """The smooth sky of tests/test_kerr.py:749-820 at the path's sky size:
    colours that vary slowly with direction, so a pixel differs between
    two steppers only where their rays really part (float32 unless
    ``dtype``)."""
    import numpy as np
    import torch
    from curvis_tpu_torch.env.spherical_image import make_spherical_image
    h, w = SKY[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    tex = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                    0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    if dtype is None or dtype == torch.float32:
        return make_spherical_image(tex.astype(np.float32), device=DEVICE)
    return make_spherical_image(tex, device=DEVICE, dtype=dtype)


def phase16_kerr_rk45_path(sky, sky_np, bright):
    """The Kerr path with stepper='rk45' (rtol 1e-4) end to end at 960 x 540
    (kerr_path), and its bare, thin and volumetric frames against their RK4
    renders over a smooth sky; returns the launches of kernel #8."""
    import torch
    from curvis_tpu_torch.metrics.kerr import make_kerr
    from curvis_tpu_torch.render import kerr as rk
    total, views = kerr_path("[16]", sky, sky_np, bright, rk45=True)
    kerr = make_kerr(1.0, KERR_A, device=DEVICE)
    smooth = smooth_sky()
    for key, (c, disk, k45) in views.items():
        k4 = {k: v for k, v in k45.items() if k not in ("stepper", "rtol")}
        a4 = rk.render_kerr(kerr, c, smooth, disk=disk, **k4)
        a45 = rk.render_kerr(kerr, c, smooth, disk=disk, **k45)
        diff = ((a4 - a45).abs().amax(-1) > RK45_DIFF).double().mean().item()
        flux = abs(a45.double().sum().item() / a4.double().sum().item() - 1)
        print(f"[16] rk45 vs RK4, {key} over a smooth sky: {diff:.6f} of "
              f"pixels differ by > {RK45_DIFF}; total flux {flux:.6f} apart")
        require(bool(torch.isfinite(a45).all())
                and diff < RK45_DIFF_MAX[key],
                f"rk45 vs RK4 {key}: {diff} of pixels differ")
        if key == "vol":
            require(flux < RK45_FLUX_MAX, f"rk45 vs RK4 vol: flux {flux}")
    return total


def rk45_disk_flops(kind, flags, iters, steps):
    """FP32 operations of kernel #4's surface variants for a kind and its
    flags over ``iters`` iterations of which ``steps`` were accepted."""
    vol, blackbody, redshift, doppler, scatter = flags
    lapse = kind in ("schwarzschild", "rn")
    per_iter = FLOP_RK45_ITER_LAPSE if lapse else FLOP_RK45_ITER
    if not vol:
        return (per_iter + FLOP_RK45_DISK["track"]) * iters
    per_step = FLOP_RK45_DISK["emission"]
    per_step += FLOP_VOL["shift"] if lapse and (redshift or doppler) else 0
    per_step += FLOP_VOL["blackbody" if blackbody else "tint"]
    per_step += FLOP_VOL["scatter"] if scatter else 0
    return (per_iter + FLOP_RK45_DISK["vol_clamp"]) * iters \
        + per_step * steps


def outputs_differ(out_k, out_p):
    """Entries of the kernel's outputs that differ from the plain
    version's (NaN equals NaN), and the largest finite difference."""
    import torch
    n, worst = 0, 0.0
    for k, p in zip(out_k, out_p):
        same = k == p
        if k.is_floating_point():
            same |= torch.isnan(k) & torch.isnan(p)
            both = torch.isfinite(k) & torch.isfinite(p)
            if bool(both.any()):
                d = (k.double() - p.double()).abs()[both].max().item()
                worst = max(worst, d)
        n += int((~same).sum())
    return n, worst


def phase17_rk45_disk_march(sky):
    """Kernel #4's surface variants against march_planar_rk45_disk_plain on
    the card at rtol 1e-5 (the disk view of phases 10-12)."""
    import dataclasses
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import _build
    from curvis_tpu_torch.ops import rk45_disk_cuda as rd
    from curvis_tpu_torch.render.disk import DiskParams, compute_starlight_map
    from curvis_tpu_torch.render.starlight import (map_rays,
                                                   starlight_scatter_block)
    exact = "--fmad=false" in _build.SOURCE_FLAGS.get("planar_rk45_disk.cu",
                                                      [])
    bh = make_metric("schwarzschild", m=1.0, device=DEVICE)
    ellis = make_metric("ellis", rho=1.0, device=DEVICE)
    band = (5.2, 14.0)
    tint = DiskParams(**DISK_VOL)
    bb = dataclasses.replace(tint, color_mode="blackbody", t_peak=7000.0)
    smap = compute_starlight_map(
        bh, sky, dataclasses.replace(bb, starlight=True, starlight_samples=256,
                                     starlight_grid=(64, 128)),
        dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R, stepper="rk45",
        rtol=RK45_DISK_RTOL)
    block = starlight_scatter_block(smap, bb)
    V, S, VC = DISK_VOL_RES, SMALL, RK45_DISK_VOL_CHECK_CAP
    # name, metric, side (None: the map bundle), row keywords, cap, NaN rays;
    # the wormhole's camera at l = 10, close enough that rays through the
    # throat cross the disk on the far sheet
    configs = [
        (f"disk tracker {RES}^2 (the path's view)", bh, RES,
         dict(disk=band), MAX_STEPS, 0),
        (f"vol tint {V}^2", bh, V, dict(vol_disk=tint), VC, 0),
        (f"vol blackbody {V}^2", bh, V, dict(vol_disk=bb), VC, 0),
        (f"vol tint, redshift only {S}^2", bh, S,
         dict(vol_disk=dataclasses.replace(tint, doppler=False)), VC, 0),
        (f"vol tint, Doppler only {S}^2", bh, S,
         dict(vol_disk=dataclasses.replace(tint, redshift=False)), VC, 0),
        (f"vol blackbody, no shift {S}^2", bh, S,
         dict(vol_disk=dataclasses.replace(bb, redshift=False,
                                           doppler=False)), VC, 0),
        (f"vol tint + scatter {S}^2", bh, S,
         dict(vol_disk=tint, scatter_block=block), VC, 0),
        (f"vol blackbody + scatter {V}^2", bh, V,
         dict(vol_disk=bb, scatter_block=block), VC, 0),
        (f"vol tint kappa 40 (tau_max freeze) {S}^2", bh, S,
         dict(vol_disk=dataclasses.replace(tint, kappa=40.0)), VC, 0),
        (f"ellis disk tracker {S}^2 (wormhole disk)", ellis, S,
         dict(disk=(1.5, 14.0)), MAX_STEPS, 0),
        (f"ellis vol blackbody {S}^2", ellis, S,
         dict(vol_disk=dataclasses.replace(bb, r_inner=1.5)), VC, 0),
        (f"disk tracker {S}^2 cap {RK45_DISK_CAP}", bh, S, dict(disk=band),
         RK45_DISK_CAP, 0),
        (f"disk tracker {S}^2 with {N_POISON} NaN rays", bh, S,
         dict(disk=band), MAX_STEPS, N_POISON),
        (f"vol tint {S}^2 with {N_POISON} NaN rays, cap "
         f"{RK45_DISK_NAN_CAP}", bh, S, dict(vol_disk=tint),
         RK45_DISK_NAN_CAP, N_POISON),
        ("starlight map rays 64 x 256", bh, None, dict(disk=band), MAX_STEPS,
         0),
    ]
    out = {}
    frozen_seen = [0, 0]
    for name, metric, side, row_kw, cap, n_nan in configs:
        if side is None:
            _, rays, _, _ = map_rays(metric, *band, 64, 256, torch.float32,
                                     DEVICE)
            state = [t.contiguous() for t in rays[:4]]
            planes = [torch.zeros_like(rays.l), torch.ones_like(rays.l),
                      torch.zeros_like(rays.l)]
        else:
            l_cam = 10.0 if metric is ellis else DISK_L
            state, planes = disk_rays(metric, [disk_camera(side, l=l_cam)])
        state[0], bad = poison_rays(state[0], n_nan)
        kind, scal = rd.rk45_disk_scalars(metric, DT, DISK_R, RK45_DISK_RTOL,
                                          RK45_DISK_RTOL * 1e-3, 10.0,
                                          **row_kw)
        vd = row_kw.get("vol_disk")
        flags = rd.disk_flags(vd, row_kw.get("scatter_block"))
        ins = state + planes[:2] + [planes[2] if flags[0] else None]
        mi = 4 * cap
        kw = dict(max_steps=cap, max_iters=mi)
        out_k = rd.launch(kind, flags, scal, *ins, **kw)
        sync()
        t0 = time.perf_counter()
        out_p = rd.march_planar_rk45_disk_plain(kind, flags, scal, *ins,
                                                **kw)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        n_diff, worst = outputs_differ(out_k, out_p)
        sign_k, steps_k, iters_k = out_k[-3:]
        sign_eq = (sign_k == out_p[-3]).double().mean().item()
        steps_near = ((steps_k - out_p[-2]).abs()
                      <= STEPS_NEAR).double().mean().item()
        iters_eq = (iters_k == out_p[-1]).double().mean().item()
        kernel_ms = cuda_ms(lambda: rd.launch(kind, flags, scal, *ins, **kw),
                            3)
        n = state[0].numel()
        steps, iters = steps_k.double(), iters_k.double()
        counts = {s_: int((sign_k == s_).sum()) for s_ in (-1, 0, 1, 2, 3)}
        print(f"[17] rk45 disk march {name}: {n} rays, signs {counts}; sign "
              f"equal {sign_eq:.6f}, steps within {STEPS_NEAR} "
              f"{steps_near:.6f}, iters equal {iters_eq:.6f}; {n_diff} "
              f"output entries differ, max finite |d| {worst:.3e}")
        print(f"[17]   digest of the kernel's outputs {digest(out_k)}, of "
              f"the plain version's {digest(out_p)}")
        print(f"[17]   steps mean / max {steps.mean().item():.2f} / "
              f"{int(steps.max())}, iters mean / max "
              f"{iters.mean().item():.2f} / {int(iters.max())}; kernel "
              f"{kernel_ms:.3f} ms ({n / kernel_ms / 1e3:.1f} Mrays/s), plain "
              f"{plain_ms:.1f} ms")
        require(sign_eq >= SIGN_EQ_MIN, f"rk45 disk {name}: sign equal "
                f"{sign_eq}")
        require(steps_near >= STEPS_EQ_MIN,
                f"rk45 disk {name}: steps within {STEPS_NEAR} {steps_near}")
        if exact:
            require(n_diff == 0, f"rk45 disk {name}: {n_diff} output "
                    "entries differ from the plain version")
        if flags[0]:
            cap_r = metric.capture_radius
            r_cap = float(cap_r) if cap_r is not None else -1e30
            frozen = [int(((o[-3] == 2) & (o[0] > r_cap)).sum())
                      for o in (out_k, out_p)]
            frozen_seen = [f + g for f, g in zip(frozen_seen, frozen)]
            ok = ~bad
            close, em_worst = close_fraction([t[ok] for t in out_k[3:7]],
                                             [t[ok] for t in out_p[3:7]])
            print(f"[17]   tau and em within rtol {GRAD_RTOL} on "
                  f"{close:.6f} of rays (max |d| {em_worst:.3e}); frozen by "
                  f"tau_max {frozen[0]} / {frozen[1]} (kernel / plain); tau "
                  f"max {out_k[3][ok].max().item():.3f}")
            require(close >= GRAD_FRAC_MIN,
                    f"rk45 disk {name}: close fraction {close}")
            require(all(bool(torch.isfinite(t[ok]).all())
                        for t in out_k[3:7]),
                    f"rk45 disk {name}: non-finite tau or emission")
            if vd.kappa > 10.0:
                require(min(frozen) > 0, f"rk45 disk {name}: no tau_max "
                        f"freeze {frozen}")
        else:
            # hit_agreement's layout: (l, psi, p_l, sign, steps, hits...)
            a = hit_agreement(*((o[:3] + o[-3:-1] + o[3:9])
                                for o in (out_k, out_p)))
            hits = [int((out_k[i] != 0).sum()) for i in (3, 6)]
            far = int((out_k[3] < 0).sum())
            print(f"[17]   hits {hits[0]} / {hits[1]} (first / second, "
                  f"{far} on the far sheet); presence equal "
                  f"{a['hit_eq']:.6f}; over {a['n_hits']} hits p99 rel "
                  f"radius {a['rel_p99']:.3e}, p99 |dpsi| "
                  f"{a['dpsi_p99']:.3e}")
            require(hits[0] > 0, f"rk45 disk {name}: no disk hit")
            require(a["hit_eq"] >= HIT_EQ_MIN,
                    f"rk45 disk {name}: hit presence equal {a['hit_eq']}")
            require(a["rel_p99"] < HIT_P99_MAX
                    and a["dpsi_p99"] < HIT_P99_MAX,
                    f"rk45 disk {name}: hit radius / psi {a}")
            if metric is ellis:
                require(far > 0, f"rk45 disk {name}: no far-sheet hit")
        for who, o in (("kernel", out_k), ("plain", out_p)):
            sg, st, it = o[-3:]
            require(int(st.max()) <= cap and int(it.max()) <= mi
                    and bool((it >= st).all())
                    and bool((st[(sg == 0) & (it < mi)] == cap).all()),
                    f"rk45 disk {name}: {who} overshot or undershot a cap")
            if n_nan:
                want = 0 if flags[0] else 3
                require(bool((sg[bad] == want).all())
                        and bool((st[bad] == 0).all()),
                        f"rk45 disk {name}: {who} NaN rays not sign {want} "
                        f"without a step: {sg[bad].tolist()}")
                if flags[0]:
                    require(bool((it[bad] == mi).all()),
                            f"rk45 disk {name}: {who} NaN rays in the gas "
                            "did not run to max_iters")
        if cap == RK45_DISK_CAP:
            capped = (sign_k == 0).double().mean().item()
            print(f"[17]   {capped:.4f} of rays stopped at the cap of {cap}")
            require(capped > 0.5, f"rk45 disk {name}: only {capped} capped")
        # 24 or 28 bytes read, 48 or 40 written per ray
        n_bytes = (68 if flags[0] else 72) * n
        b_ms, b_by = bound(n_bytes, rk45_disk_flops(
            kind, flags, iters.sum().item(), steps.sum().item()))
        out[name] = dict(max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
        print(f"[17]   bound {b_ms:.3f} ms ({b_by}); kernel at "
              f"{100 * b_ms / kernel_ms:.1f} % of it")
    print(f"[17] built {'without' if exact else 'with'} FMA contraction; "
          f"tau_max freeze seen on {frozen_seen[0]} / {frozen_seen[1]} rays "
          f"(kernel / plain) over the volumetric cases")
    return out[configs[0][0]]


def phase18_rk45_disk_path(sky, sky_np):
    """The disk path with stepper='rk45' end to end at 1024^2 through its
    entry points, with each job's launches of the new kernel and of #5 and
    #6; the thin, starlit and volumetric frames against their Euler
    renders over a smooth sky; returns the new kernel's launches."""
    import dataclasses
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import disk_cuda, disk_vol_cuda, rk45_disk_cuda
    from curvis_tpu_torch.physics.planar import PlanarRays
    from curvis_tpu_torch.render import disk as rd
    bh = make_metric("schwarzschild", m=1.0, device=DEVICE)
    cam = disk_camera(RES)
    kw = dict(dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R)
    k45 = dict(kw, stepper="rk45", rtol=RK45_DISK_RTOL)
    thin = rd.DiskParams(**DISK_THIN)
    star = rd.DiskParams(**DISK_STAR)
    vol_b = dataclasses.replace(rd.DiskParams(**DISK_VOL),
                                color_mode="blackbody", t_peak=7000.0)
    vol_s = dataclasses.replace(vol_b, starlight=True, starlight_samples=256,
                                starlight_grid=(64, 128))
    poses = [disk_camera(RES, 0.5 * k) for k in range(FRAMES)]
    maps = {}

    def frame(disk, smap=None, **extra):
        return rd.render_blackhole_disk(bh, cam, sky, disk=disk,
                                        starlight_map=smap, **k45, **extra)

    dark = rd.DiskParams(brightness=0.0, opacity=0.0)
    bare = frame(dark)
    bare_batch = rd.render_disk_frames_batched(bh, poses, sky, disk=dark,
                                               **k45)
    maps["vol"] = rd.compute_starlight_map(bh, sky, vol_s, **k45)
    jobs = [
        ("thin blackbody frame", lambda: frame(thin), bare),
        ("rk45 starlight map (64 x 128, 256 samples)",
         lambda: maps.__setitem__("star", rd.compute_starlight_map(
             bh, sky, star, **k45)), None),
        ("starlight frame (map precomputed)",
         lambda: frame(star, maps["star"]), bare),
        ("volumetric blackbody frame", lambda: frame(vol_b), bare),
        ("volumetric blackbody + scatter frame (map precomputed)",
         lambda: frame(vol_s, maps["vol"]), bare),
        (f"render_disk_frames_batched thin blackbody, {FRAMES} poses",
         lambda: rd.render_disk_frames_batched(bh, poses, sky, disk=thin,
                                               **k45), bare_batch),
    ]
    total = 0
    for name, fn, ref in jobs:
        rk45_disk_cuda.launches = 0
        disk_cuda.launches = 0
        disk_vol_cuda.launches = 0
        img = fn()                                         # warm-up
        ms = cuda_ms(fn, REPS)
        n45 = rk45_disk_cuda.launches
        n5, n6 = disk_cuda.launches, disk_vol_cuda.launches
        total += n45
        rays = 0 if ref is None else ref.numel() // 3
        rate = f" = {rays / ms / 1e3:.1f} Mrays/s" if rays else ""
        print(f"[18] {name}: {ms:.2f} ms (median of {REPS}){rate}; launches "
              f"rk45 disk {n45}, #5 {n5}, #6 {n6}")
        require(n45 > 0 and n5 == 0 and n6 == 0,
                f"{name}: launches rk45 disk {n45}, #5 {n5}, #6 {n6}")
        if ref is not None:
            disk_image_gates(name, img, ref, "[18]")
    require(maps["star"].values.shape == (2, 64, 128, 3)
            and bool(torch.isfinite(maps["star"].values).all()),
            "rk45 starlight map: shape or non-finite values")

    # rk45 against Euler over a smooth sky: thin, starlit (each with its
    # own stepper's map) and volumetric
    smooth = smooth_sky()
    for key, disk in (("thin", thin), ("starlit", star), ("vol", vol_b)):
        imgs = []
        for stepper_kw in (kw, k45):
            smap = (rd.compute_starlight_map(bh, smooth, disk, **stepper_kw)
                    if disk.starlight else None)
            imgs.append(rd.render_blackhole_disk(bh, cam, smooth, disk=disk,
                                                 starlight_map=smap,
                                                 **stepper_kw))
        diff = ((imgs[0] - imgs[1]).abs().amax(-1)
                > RK45_DIFF).double().mean().item()
        print(f"[18] rk45 vs Euler, {key} frame over a smooth sky: "
              f"{diff:.6f} of pixels differ by > {RK45_DIFF}")
        require(bool(torch.isfinite(imgs[1]).all())
                and diff < RK45_DISK_DIFF_MAX,
                f"rk45 vs Euler {key}: {diff} of pixels differ")
    # tau and emission against the Euler quadrature on the path's rays
    state, planes = disk_rays(bh, [cam])
    rays = PlanarRays(*state, None, None)
    _, tau_e, em_e = disk_vol_cuda.march_planar_disk_volumetric_cuda(
        bh, rays, *planes, disk=vol_b, **kw)
    _, tau_a, em_a = rk45_disk_cuda.march_planar_rk45_disk_cuda(
        bh, rays, c1=planes[0], c2=planes[1], nz=planes[2], vol_disk=vol_b,
        dt0=DT, max_steps=MAX_STEPS, escape_radius=DISK_R,
        rtol=RK45_DISK_RTOL, atol=RK45_DISK_RTOL * 1e-3)
    for what, a, e in (("tau", [tau_a], [tau_e]), ("emission", em_a, em_e)):
        a, e = torch.stack(a).double(), torch.stack(e).double()
        l1 = ((a - e).abs().sum() / e.abs().sum().clamp(min=1e-9)).item()
        print(f"[18] volumetric {what}, rk45 vs the Euler quadrature: "
              f"relative L1 {l1:.6f}")
        require(l1 < RK45_DISK_L1_MAX, f"rk45 vs Euler {what}: L1 {l1}")
    print(f"[18] launches of the rk45 disk kernel over the path: {total}")
    profile_window(lambda: frame(thin), "[18]",
                   f"the rk45 thin blackbody frame ({RES}^2)")
    profile_window(lambda: frame(vol_b), "[18]",
                   f"the rk45 volumetric blackbody frame ({RES}^2)")
    return total


def surf_flops(kind, flags):
    """(FP32 operations of one step, of its VJP) of a surface family:
    ``flags`` None for the thin disk, else (blackbody, redshift, doppler,
    scatter)."""
    if flags is None:
        return FLOP_DISK_STEP, FLOP_SURF_THIN_VJP
    blackbody, redshift, doppler, scatter = flags
    v = FLOP_SURF_VOL_VJP
    n = v["base"] + v["emission"]
    if kind in ("schwarzschild", "rn") and (redshift or doppler):
        n += v["shift"]
    n += v["blackbody" if blackbody else "tint"]
    return vol_flops(kind, flags), n + (v["scatter"] if scatter else 0)


def surface_inputs(metric, cams, flags, cap, seed, band=None, disk=None,
                   block=None):
    """The inputs of the surface kernel pair at a view: the forward
    kernel's (#5 or #6) outputs with step cap ``cap`` and a seeded random
    cotangent of the final state, with the Function's fate policy (state
    cotangents only for signs 0 and +-1; u, v none)."""
    import numpy as np
    import torch
    from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
    from curvis_tpu_torch.ops import disk_cuda, disk_vol_cuda
    state, planes = disk_rays(metric, cams)
    if flags is None:
        kind, scal = disk_cuda.disk_scalars(metric, DT, DISK_R, *band)
        fwd = disk_cuda.launch(kind, scal, *state, *planes[:2],
                               max_steps=cap)
        planes[2] = torch.zeros_like(planes[2])
    else:
        kind, scal = disk_vol_cuda.vol_scalars(metric, DT, DISK_R, disk,
                                               block)
        fwd = disk_vol_cuda.launch(kind, flags, scal, *state, *planes,
                                   max_steps=cap)
    sign, steps = fwd[3], fwd[4]
    counts = torch.where(sign != 3, steps, torch.zeros_like(steps))
    n = steps.numel()
    ns = cs.n_state(flags)
    cot = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (ns, n)).astype(np.float32)).to(DEVICE)
    smooth = (sign.abs() <= 1)
    cot[:3] = torch.where(smooth, cot[:3], torch.zeros_like(cot[:3]))
    cot[3:5] = 0.0
    return kind, scal, state, planes, counts, cot.contiguous(), fwd


def entry_fraction(kernel, plain):
    """Fraction of entries within SURF rtol (GRAD_RTOL) of the plain
    version's, |k - p| <= GRAD_RTOL (|p| + 1e-6 max|p|) per row, and the
    largest absolute difference."""
    import torch
    k, p = kernel.double(), plain.double()
    floor = 1e-6 * p.abs().amax(dim=-1, keepdim=True)
    good = (k - p).abs() <= GRAD_RTOL * (p.abs() + floor)
    return good.double().mean().item(), float((k - p).abs().max())


def surface_vs_plain(label, kind, flags, scal, state, planes, counts, cot,
                     fwd, tag="[19]", flops=None):
    """Kernels #9 / #10's surface variant against their plain versions on
    the same inputs, gen's final state against the forward kernel, and the
    timings and bounds.  ``flops`` = (a step's, its VJP's) FP32 operations
    for the bound, if not surf_flops'; a table's series cotangents are held
    as the other theta rows, entry by entry and summed."""
    import torch
    from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
    y0 = state[:3]
    b, (c1, c2, nz) = state[3], planes
    off, total = cs.segment_offsets(counts, SEG)
    ck, fin = cs.launch_gen(kind, flags, scal, *y0, b, c1, c2, nz, counts,
                            seg=SEG, offsets=off, total=total)
    g_k, lam_k = cs.launch_bwd(kind, flags, scal, ck, b, c1, c2, nz, counts,
                               cot, seg=SEG, offsets=off)
    sync()
    t0 = time.perf_counter()
    ck_p, _ = cs.ckpt_surface_gen_plain(kind, flags, scal, *y0, b, c1, c2,
                                        nz, counts, seg=SEG, offsets=off,
                                        total=total)
    sync()
    t1 = time.perf_counter()
    g_p, lam_p = cs.ckpt_surface_bwd_plain(kind, flags, scal, ck_p, b, c1,
                                           c2, nz, counts, cot, seg=SEG,
                                           offsets=off)
    sync()
    gen_plain_ms = 1e3 * (t1 - t0)
    bwd_plain_ms = 1e3 * (time.perf_counter() - t1)
    gen_ms = cuda_ms(lambda: cs.launch_gen(
        kind, flags, scal, *y0, b, c1, c2, nz, counts, seg=SEG, offsets=off,
        total=total), 3)
    bwd_ms = cuda_ms(lambda: cs.launch_bwd(
        kind, flags, scal, ck, b, c1, c2, nz, counts, cot, seg=SEG,
        offsets=off), 3)
    n = counts.numel()
    ns, nt = cs.n_state(flags), cs.n_theta(flags, kind)
    # gen's final state against the forward kernel's outputs: the same
    # step code, but nvcc contracts the hit interpolation differently in
    # the two kernels, so hits are held by presence and to rtol 1e-3
    if flags is None:
        pres = ((fin[5] != 0) == (fwd[5] != 0)) & \
            ((fin[8] != 0) == (fwd[8] != 0))
        vals = min(entry_fraction(fin[c][None], fwd[c][None])[0]
                   for c in range(5, 11))
        exact = torch.ones_like(pres)
        for c in range(5, 11):
            exact &= fin[c] == fwd[c]
        fin_eq = min(pres.double().mean().item(), vals)
        what = (f"hit presence equal {pres.double().mean().item():.6f}, "
                f"values within rtol {GRAD_RTOL} {vals:.6f}, bit-equal "
                f"{exact.double().mean().item():.6f}; min")
    else:
        fin_eq = min(entry_fraction(fin[5 + c][None], fwd[5 + c][None])[0]
                     for c in range(4))
        what = f"tau / emission within rtol {GRAD_RTOL}"
    state_ne = int((~((fin[0] == fwd[0]) & (fin[1] == fwd[1])
                      & (fin[2] == fwd[2]))).sum())
    ck_frac, ck_err = entry_fraction(ck.T, ck_p.T)
    # (lam_u, lam_v), the cotangents of (u0, v0) = (cos, sin) psi0, are
    # held by what reaches psi0, -lam_u sin psi0 + lam_v cos psi0: the
    # thin family's crossing fraction does not change when (u, v) is
    # scaled, so the component along (u0, v0) is 0 in exact arithmetic
    # and its float32 values are rounding noise
    psi0 = state[1]

    def to_psi0(lam):
        return torch.cat([lam[:3], (lam[4] * torch.cos(psi0)
                                    - lam[3] * torch.sin(psi0))[None],
                          lam[5:]])
    lam_frac, lam_err = entry_fraction(to_psi0(lam_k), to_psi0(lam_p))
    raw_frac = entry_fraction(lam_k, lam_p)[0]
    g_rows = [r for r in range(nt) if bool((g_p[r] != 0).any())]
    g_frac, g_err = entry_fraction(g_k[g_rows], g_p[g_rows])
    sums = []
    for r in g_rows:
        if r in (3, 4, 5, 6):              # b, c1, c2, nz: per ray
            continue
        sk, sp = g_k[r].double().sum().item(), g_p[r].double().sum().item()
        mag = g_p[r].double().abs().sum().item()
        sums.append((r, sk, sp, abs(sk - sp) / max(abs(sp), 1e-300), mag))
    total_steps = counts.double().sum().item()
    segs = (-(-counts.long() // SEG)).double().sum().item()
    hits = (int((fwd[5] != 0).sum()), int((fwd[8] != 0).sum())) \
        if flags is None else None
    signs = {s_: int((fwd[3] == s_).sum()) for s_ in (-1, 0, 1, 2)}
    print(f"{tag} {label}: {n} rays, signs {signs}"
          + (f", hits {hits[0]} / {hits[1]}" if hits else "")
          + f", mean / max steps {total_steps / n:.1f} / "
          f"{int(counts.max())}, {total} checkpoint rows "
          f"({total * ns * 4 / 2**20:.1f} MiB)")
    print(f"{tag}   gen final state == forward kernel: (l, psi, p_l) "
          f"differs on {state_ne} of {n} rays (bound 0: one step source), "
          f"{what} {fin_eq:.6f} of rays (bound >= {SURF_EQ_MIN})")
    print(f"{tag}   within rtol {GRAD_RTOL}: checkpoints {ck_frac:.6f}, lam "
          f"{lam_frac:.6f}, g_theta {g_frac:.6f} of entries (bound >= "
          f"{GRAD_FRAC_MIN}; lam with raw lam_u, lam_v {raw_frac:.6f}); "
          f"max |d| ckpt {ck_err:.3e}, lam {lam_err:.3e}, g {g_err:.3e}")
    if sums:
        r, sk, sp, rel, mag = max(sums, key=lambda t: t[3])
        print(f"{tag}   {len(sums)} ray-summed slot cotangents, the worst "
              f"g_theta[{r}]: kernel {sk:.9e}, plain {sp:.9e}, rel "
              f"{rel:.3e} (sum |g| {mag:.3e}; bound {GRAD_RTOL})")
        r, sk, sp, rel, mag = max(sums, key=lambda t: abs(t[1] - t[2])
                                  / max(t[4], 1e-300))
        print(f"{tag}   largest |kernel - plain| of a sum over the sum of "
              f"its terms' magnitudes: {abs(sk - sp) / max(mag, 1e-300):.3e}"
              + (f" (bound {TABLE_SURF_SUM_TOL} for a table; that sum, "
                 f"g_theta[{r}], is {abs(sp) / max(mag, 1e-300):.3e} of its "
                 f"terms' magnitudes)" if kind == "table" else ""))
    print(f"{tag}   gen {gen_ms:.3f} ms (plain {gen_plain_ms:.1f} ms), bwd "
          f"{bwd_ms:.3f} ms (plain {bwd_plain_ms:.1f} ms)")
    require(state_ne == 0, f"surface {label}: gen's (l, psi, p_l) differ "
            f"from the forward kernel's on {state_ne} rays")
    require(fin_eq >= SURF_EQ_MIN, f"surface {label}: gen final {fin_eq}")
    require(ck_frac >= GRAD_FRAC_MIN, f"surface {label}: ckpt {ck_frac}")
    require(lam_frac >= GRAD_FRAC_MIN, f"surface {label}: lam {lam_frac}")
    require(g_frac >= GRAD_FRAC_MIN, f"surface {label}: g_theta {g_frac}")
    for r, sk, sp, rel, mag in sums:
        # a table's ray sums cancel to ~1/1000 of their terms' magnitude
        # (the series' cotangents alternate, the slots' follow), and the
        # contracted Euler pair's rays differ from the plain pair's by
        # ~1e-5 of theirs: such a sum is held within TABLE_SURF_SUM_TOL of
        # the sum of their magnitudes, a tenth of the sum's own size
        require(rel <= GRAD_RTOL or (kind == "table" and abs(sk - sp)
                                     <= TABLE_SURF_SUM_TOL * mag),
                f"surface {label}: sum g_theta[{r}] {sk} vs {sp}")
    require(all(bool(torch.isfinite(t).all()) for t in (lam_k, g_k, ck)),
            f"surface {label}: non-finite output")
    if hits is not None:
        require(hits[0] > 0, f"surface {label}: no disk hit")
    step_f, vjp_f = surf_flops(kind, flags) if flops is None else flops
    # gen reads 7 floats, steps and the offset a ray, writes ns floats a
    # segment and the final state; bwd reads the segments, 6 values and
    # the cotangent a ray, writes lam and g_theta
    gen_b = bound(40 * n + 4 * ns * (segs + n), step_f * total_steps)
    bwd_b = bound(4 * ns * segs + (32 + 4 * ns) * n + 4 * (ns + nt) * n,
                  (step_f + vjp_f) * total_steps)
    print(f"{tag}   bound gen {gen_b[0]:.3f} ms ({gen_b[1]}), bwd "
          f"{bwd_b[0]:.3f} ms ({bwd_b[1]})")
    return dict(gen=dict(max_abs_err=ck_err, ms=gen_ms,
                         plain_ms=gen_plain_ms, bound_ms=gen_b[0],
                         bound_by=gen_b[1]),
                bwd=dict(max_abs_err=max(lam_err, g_err), ms=bwd_ms,
                         plain_ms=bwd_plain_ms, bound_ms=bwd_b[0],
                         bound_by=bwd_b[1]))


def phase19_surface_ckpt(sky):
    """Kernels #9 / #10's surface variants (csrc/ckpt_surface.cu) against
    their plain versions: the thin disk on the path's view at 1024^2 and
    an Ellis wormhole disk (far-sheet hits) at 256^2; the volumetric tint
    at 1024^2 (the path's ray count) and 256^2, blackbody + redshift +
    Doppler, and blackbody + scatter (a real map's block) at 256^2; every
    case with the step cap SURF_CAP."""
    import dataclasses
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.render.disk import DiskParams, compute_starlight_map
    from curvis_tpu_torch.render.starlight import starlight_scatter_block
    bh = make_metric("schwarzschild", m=1.0, device=DEVICE)
    ellis = make_metric("ellis", rho=1.0, device=DEVICE)
    tint = DiskParams(**DISK_VOL)
    bb = dataclasses.replace(tint, color_mode="blackbody", t_peak=7000.0)
    smap = compute_starlight_map(
        bh, sky, dataclasses.replace(bb, starlight=True, starlight_samples=64,
                                     starlight_grid=(64, 128)),
        dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R)
    block = starlight_scatter_block(smap, bb)
    cases = [
        (f"schwarzschild thin {RES}^2 (the path's view)", bh, RES, None,
         dict(band=(5.2, 14.0))),
        (f"ellis thin {SMALL}^2 (wormhole disk)", ellis, SMALL, None,
         dict(band=(1.5, 14.0))),
        (f"schwarzschild vol tint {RES}^2 (the path's view)", bh, RES,
         (False, True, True, False), dict(disk=tint)),
        (f"schwarzschild vol tint {SMALL}^2", bh, SMALL,
         (False, True, True, False), dict(disk=tint)),
        (f"schwarzschild vol blackbody + redshift + doppler {SMALL}^2", bh,
         SMALL, (True, True, True, False), dict(disk=bb)),
        (f"schwarzschild vol blackbody + scatter {SMALL}^2", bh, SMALL,
         (True, False, False, True),
         dict(disk=dataclasses.replace(bb, redshift=False, doppler=False),
              block=block)),
    ]
    out = {}
    for k, (label, metric, res, flags, extra) in enumerate(cases):
        inputs = surface_inputs(metric, [disk_camera(res)], flags, SURF_CAP,
                                seed=19 + k, **extra)
        out[label] = surface_vs_plain(f"{label}, cap {SURF_CAP}",
                                      inputs[0], flags, *inputs[1:])
    return out[cases[0][0]]


def surface_frame(bh, cam, sky, disk, theta, smap=None, differentiable=None,
                  **kw):
    """One render_blackhole_disk call on the path's view with the overrides
    ``theta`` (a dict of floats, made tensors that require grad); ``kw``
    (stepper, rtol) passes on."""
    import torch
    from curvis_tpu_torch.render import disk as rd
    params = {k: torch.tensor(v, device=DEVICE, requires_grad=True)
              for k, v in theta.items()}
    metric = bh
    if "m" in params:
        from curvis_tpu_torch.metrics.base import SchwarzschildMetric
        metric = SchwarzschildMetric(params["m"], device=DEVICE)
    img = rd.render_blackhole_disk(
        metric, cam, sky, disk=disk, starlight_map=smap,
        dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R,
        differentiable=differentiable,
        disk_theta={k: v for k, v in params.items() if k != "m"}, **kw)
    return img, params


def twin_witness(cam, disk, linear, fd_out):
    """d loss / d M over the pixel channels outside the linear regime of a
    volumetric frame on a black sky, through the kernel route
    (backend 'auto': #6, then the surface kernels) and the twin pair
    (backend 'twin', what differentiable='scan' runs: the PyTorch step
    under autograd) on those pixels' rays alone: if the two agree, the gap
    to the central difference there is the method's (fate flips,
    photon-ring rays), not the kernels'."""
    import torch
    from curvis_tpu_torch.integrate.planar_surface_adjoint import \
        march_planar_vol_adjoint
    from curvis_tpu_torch.metrics.base import SchwarzschildMetric
    from curvis_tpu_torch.render.disk import _volumetric_rgb, disk_view
    out = (linear == 0)                           # (H, W, 3)
    hh, ww = torch.nonzero(out.any(-1), as_tuple=True)
    idx = ww * RES + hh                           # ray order (W, H)
    ch = out[hh, ww].double()
    got, fates = {}, {}
    t0 = time.perf_counter()
    for backend in ("auto", "twin"):
        m = torch.tensor(1.0, device=DEVICE, requires_grad=True)
        metric = SchwarzschildMetric(m, device=DEVICE)
        state, planes = disk_rays(metric, [cam])
        state = [t[idx] for t in state]
        planes = [t[idx] for t in planes]
        res = march_planar_vol_adjoint(
            metric, state[:3], state[3], *planes, disk, dt=DT,
            max_steps=MAX_STEPS, escape_radius=DISK_R, backend=backend)
        tau, em = res[5]
        rgb, _ = _volumetric_rgb(tau, em, disk_view(disk, None),
                                 torch.float32)
        loss = (torch.clamp(rgb, 0.0, 1.0).double() * ch).sum() \
            / linear.numel()
        (g,) = torch.autograd.grad(loss, [m])
        got[backend] = float(g)
        fates[backend] = (res[3], res[4])
    sync()
    same = ((fates["auto"][0] == fates["twin"][0])
            & (fates["auto"][1] == fates["twin"][1])).double().mean().item()
    rel = abs(got["auto"] - got["twin"]) / max(abs(got["twin"]), 1e-300)
    print(f"[20]   witness on the {idx.numel()} rays of the "
          f"{int(out.sum())} channels outside the linear regime: d / d m "
          f"kernels {got['auto']:.9e}, twin pair {got['twin']:.9e}, rel "
          f"{rel:.3e} (bound {SURF_FD_TOL['m']}); central difference there "
          f"{fd_out:.9e}; sign and steps equal on {same:.6f} of the rays; "
          f"{time.perf_counter() - t0:.1f} s")
    require(rel <= SURF_FD_TOL["m"], f"witness d/dm: kernels {got['auto']} "
            f"vs twin {got['twin']}")


def phase20_surface_path(sky):
    """The differentiable disk path at 1024^2: render_blackhole_disk(...,
    differentiable='adjoint') on the thin, volumetric and starlit
    volumetric frames; the image against the non-differentiable render,
    d loss / d (brightness, kappa, M) against central differences, a fit of
    kappa from 30 % off, the time split and the launches."""
    import dataclasses
    import torch
    from curvis_tpu_torch.env.spherical_image import make_spherical_image
    from curvis_tpu_torch.fit import fit
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
    from curvis_tpu_torch.ops import (disk_cuda, disk_vol_cuda, march_cuda,
                                      rk45_cuda, rk45_disk_cuda)
    from curvis_tpu_torch.render import disk as rd
    from curvis_tpu_torch.render.disk import DiskParams, compute_starlight_map
    bh = make_metric("schwarzschild", m=1.0, device=DEVICE)
    cam = disk_camera(RES)
    dark = make_spherical_image(torch.zeros(SKY), device=DEVICE)
    thin = DiskParams(**DISK_THIN)
    vol = DiskParams(**DISK_VOL)
    vol_s = dataclasses.replace(vol, starlight=True, starlight_samples=256,
                                starlight_grid=(64, 128))
    smap = compute_starlight_map(bh, sky, vol_s, dt=DT, max_steps=MAX_STEPS,
                                 escape_radius=DISK_R)
    # every frame differentiates a parameter of the march (M, kappa), so
    # that its backward runs the surface kernels
    frames = [("thin blackbody", thin, None,
               dict(m=1.0, brightness=thin.brightness)),
              ("volumetric tint", vol, None,
               dict(brightness=vol.brightness, kappa=vol.kappa)),
              ("volumetric tint + scatter (map precomputed)", vol_s, smap,
               dict(brightness=vol.brightness, kappa=vol.kappa))]
    counters = (disk_cuda, disk_vol_cuda, march_cuda, rk45_cuda,
                rk45_disk_cuda)

    def reset():
        for mod in counters:
            mod.launches = 0
        cs.launches.update(surface_gen=0, surface_bwd=0)

    total = {"surface_gen": 0, "surface_bwd": 0}
    for name, disk, sm, theta in frames:
        reset()
        img, params = surface_frame(bh, cam, sky, disk, theta, sm,
                                    "adjoint")
        loss = img.double().mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        n5, n6 = disk_cuda.launches, disk_vol_cuda.launches
        n1 = march_cuda.launches
        n4 = rk45_cuda.launches + rk45_disk_cuda.launches
        launches = dict(cs.launches)
        for k in total:
            total[k] += launches[k]
        with torch.no_grad():
            ref, _ = surface_frame(bh, cam, sky, disk, theta, sm)
        diff = float((img.detach() - ref).abs().max())
        print(f"[20] {name}: launches #5 {n5}, #6 {n6}, surface gen / bwd "
              f"{launches['surface_gen']} / {launches['surface_bwd']}, #1 "
              f"{n1}, #4 {n4}; image vs the non-differentiable render: "
              f"max |d| {diff:.3e}; d loss / d "
              + ", ".join(f"{k} {float(g):.9e}"
                          for k, g in zip(params, grads)))
        require((n5 if disk.volumetric is False else n6) > 0
                and launches["surface_gen"] > 0
                and launches["surface_bwd"] > 0 and n1 == 0 and n4 == 0,
                f"{name}: launches #5 {n5} #6 {n6} {launches} #1 {n1} #4 "
                f"{n4}")
        require(diff == 0.0, f"{name}: image differs from the "
                f"non-differentiable render by {diff}")
        require(all(math.isfinite(float(g)) for g in grads),
                f"{name}: non-finite gradient")
        # time split: forward, backward (CUDA events, median of 3)
        fwd, bwd = [], []
        for _ in range(3):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            img, params = surface_frame(bh, cam, sky, disk, theta, sm,
                                        "adjoint")
            loss = img.double().mean()
            e[1].record()
            torch.autograd.grad(loss, list(params.values()))
            e[2].record()
            e[2].synchronize()
            fwd.append(e[0].elapsed_time(e[1]))
            bwd.append(e[1].elapsed_time(e[2]))
        # the kernel pair alone on this frame's rays, full step counts
        flags = None if not disk.volumetric else (
            disk.color_mode == "blackbody", disk.redshift, disk.doppler,
            disk.starlight)
        block = None
        if disk.starlight:
            from curvis_tpu_torch.render.starlight import \
                starlight_scatter_block
            block = starlight_scatter_block(sm, disk)
        extra = (dict(band=(disk.r_inner, disk.r_outer)) if flags is None
                 else dict(disk=disk, block=block))
        kind, scal, state, planes, counts, cot, _ = surface_inputs(
            bh, [cam], flags, MAX_STEPS, seed=20, **extra)
        off, n_rows = cs.segment_offsets(counts, SEG)
        args = (kind, flags, scal, *state[:3], state[3], *planes, counts)
        ck, _ = cs.launch_gen(*args, seg=SEG, offsets=off, total=n_rows)
        gen_ms = cuda_ms(lambda: cs.launch_gen(*args, seg=SEG, offsets=off,
                                               total=n_rows), 3)
        bwd_ms = cuda_ms(lambda: cs.launch_bwd(
            kind, flags, scal, ck, state[3], *planes, counts, cot, seg=SEG,
            offsets=off), 3)
        mib = n_rows * cs.n_state(flags) * 4 / 2**20
        print(f"[20]   step (median of 3, CUDA events): forward "
              f"{statistics.median(fwd):.2f} ms + backward "
              f"{statistics.median(bwd):.2f} ms; the kernel pair alone: gen "
              f"{gen_ms:.2f} ms, bwd {bwd_ms:.2f} ms, mean steps "
              f"{counts.double().mean().item():.1f}, checkpoint buffer "
              f"{mib:.1f} MiB")
        del ck

    # differentiable=True is the 'adjoint' route (the kernels), as in JAX
    reset()
    img, params = surface_frame(bh, cam, sky, thin, frames[0][3], None, True)
    torch.autograd.grad(img.double().mean(), list(params.values()))
    n5, launches = disk_cuda.launches, dict(cs.launches)
    print(f"[20] thin blackbody, differentiable=True: launches #5 {n5}, "
          f"surface gen / bwd {launches['surface_gen']} / "
          f"{launches['surface_bwd']}")
    require(n5 > 0 and launches["surface_gen"] > 0
            and launches["surface_bwd"] > 0,
            f"differentiable=True: launches #5 {n5} {launches}")
    for k in total:
        total[k] += launches[k]

    # central differences on a black sky (no shadow-edge jumps), over the
    # pixels in the linear regime at step h, |f(+h) - 2 f(0) + f(-h)| <=
    # SURF_FD_LIN |f(+h) - f(-h)| + 1e-6: a ray whose fate flips between
    # the renders (captured against escaping past the gas) jumps, a
    # boundary term that no pathwise derivative has, and a ray near the
    # photon sphere has a derivative that changes over far less than h;
    # the adjoint differentiates the same masked mean
    checks = [("thin blackbody", thin, None, "brightness",
               dict(brightness=thin.brightness)),
              ("volumetric tint", vol, None, "brightness",
               dict(brightness=vol.brightness, kappa=vol.kappa)),
              ("volumetric tint", vol, None, "kappa",
               dict(brightness=vol.brightness, kappa=vol.kappa)),
              ("volumetric tint", vol, None, "m",
               dict(m=1.0, kappa=vol.kappa)),
              ("volumetric tint + scatter", vol_s, smap, "brightness",
               dict(brightness=vol.brightness, kappa=vol.kappa))]
    for name, disk, sm, key, theta in checks:
        h = SURF_FD[key] * theta[key]
        ims = []
        for sgn_ in (1.0, -1.0):
            # the differentiable route's forward: the volumetric march
            # reads the overrides only there
            with torch.no_grad():
                im, _ = surface_frame(bh, cam, dark, disk,
                                      dict(theta, **{key: theta[key]
                                                     + sgn_ * h}), sm,
                                      "adjoint")
            ims.append(im.double())
        img, params = surface_frame(bh, cam, dark, disk, theta, sm,
                                    "adjoint")
        curv = (ims[0] - 2.0 * img.detach().double() + ims[1]).abs()
        linear = (curv <= SURF_FD_LIN * (ims[0] - ims[1]).abs()
                  + 1e-6).double()
        fd = ((ims[0] - ims[1]) * linear).mean().item() / (2 * h)
        (g,) = torch.autograd.grad((img.double() * linear).mean(),
                                   [params[key]])
        rel = abs(float(g) - fd) / max(abs(fd), 1e-300)
        kept = linear.mean().item()
        print(f"[20] {name}: d loss / d {key} adjoint {float(g):.9e}, "
              f"central difference (h = {h:.3g}) {fd:.9e}, rel {rel:.3e} "
              f"(bound {SURF_FD_TOL[key]}); {int((linear == 0).sum())} of "
              f"{linear.numel()} pixel channels outside the linear regime, "
              f"{kept:.6f} kept (bound >= {SURF_FD_KEEP})")
        require(rel <= SURF_FD_TOL[key], f"{name}: d/d{key} {float(g)} vs "
                f"{fd}")
        require(kept >= SURF_FD_KEEP, f"{name}: d/d{key} kept only {kept} "
                f"of the pixel channels")
        if key == "m":
            fd_out = ((ims[0] - ims[1]) * (1.0 - linear)).mean().item() \
                / (2 * h)
            twin_witness(cam, disk, linear, fd_out)

    # the trainer: fit kappa from 30 % off on the volumetric frame
    with torch.no_grad():
        target, _ = surface_frame(bh, cam, sky, vol, dict(kappa=vol.kappa))

    def loss(p):
        img = rd.render_blackhole_disk(
            bh, cam, sky, disk=vol, dt=DT, max_steps=MAX_STEPS,
            escape_radius=DISK_R, differentiable="adjoint",
            disk_theta={"kappa": p["kappa"]})
        return torch.mean((img - target) ** 2)

    reset()
    k0 = SURF_TRAIN["start"] * vol.kappa
    t0 = time.perf_counter()
    res = fit(loss, {"kappa": torch.tensor(k0, device=DEVICE)},
              iters=SURF_TRAIN["iters"], lr=SURF_TRAIN["lr"])
    sync()
    fit_s = time.perf_counter() - t0
    hist = res.history
    print(f"[20] fit: {SURF_TRAIN['iters']} Adam steps (lr "
          f"{SURF_TRAIN['lr']}) in {fit_s:.2f} s, kappa {k0:.3f} -> "
          f"{float(res.params['kappa']):.6f} (target {vol.kappa}); history "
          f"{', '.join(f'{h:.6e}' for h in hist)}; launches {cs.launches}")
    require(all(math.isfinite(h) for h in hist), f"fit history {hist}")
    require(all(b < a for a, b in zip(hist[:-1], hist[1:])),
            f"fit: the loss did not fall every step: {hist}")
    for k in total:
        total[k] += cs.launches[k]
    def thin_step():
        img, params = surface_frame(bh, cam, sky, thin, frames[0][3], None,
                                    "adjoint")
        torch.autograd.grad(img.double().mean(), list(params.values()))

    profile_window(thin_step, "[20]", f"a differentiable thin frame, "
                   f"forward + backward ({RES}^2)")
    profile_window(lambda: loss({"kappa": torch.tensor(
        vol.kappa, device=DEVICE, requires_grad=True)}).backward(), "[20]",
        f"a volumetric trainer step, forward + backward ({RES}^2)")
    print(f"[20] launches of the surface kernels over the path: {total}")
    require(total["surface_gen"] > 0 and total["surface_bwd"] > 0,
            f"surface kernels not launched: {total}")
    return total


def bits_differ(a, b):
    """Rays whose float32 values differ in any bit (NaN payloads too)."""
    import torch
    return a.contiguous().view(torch.int32) != b.contiguous().view(
        torch.int32)


def digest(tensors):
    """SHA-256 (first 16 hex digits) of the tensors' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rk45_family_vs_plain(label, kind, flags, scal, state, planes, fwd, seed,
                         freeze=False, tag="[21]", flops=None):
    """Kernels #9 / #10's rk45 variant of one family (``flags`` 'bare',
    None for the thin disk, else the vol flags) against their plain
    versions on the forward kernel's outputs ``fwd`` (#4 bare or surface):
    gen's final state bit for bit against #4 on every ray, then the
    checkpoints, lam and g_theta with the Function's fate policy (state
    cotangents for signs 0, +-1; the replay for every sign but 3).
    ``flops`` = (an iteration's, its VJP's) FP32 operations for the bound,
    if not the analytic kinds' FLOP_RK45_*."""
    import numpy as np
    import torch
    from curvis_tpu_torch.ops import ckpt_adjoint_cuda as ca
    from curvis_tpu_torch.ops import ckpt_rk45_cuda as cr
    from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
    bare = flags == "bare"
    l, psi, p_l, b = state
    c1, c2, nz = planes if planes is not None else (None,) * 3
    sign, iters = fwd[-3], fwd[-1]
    n = l.numel()
    if bare:
        ns, nt, n_out = cr.N_STATE, ca.n_theta(kind), 3
        gen = lambda cnt, off, tot: cr.launch_gen(          # noqa: E731
            kind, scal, l, psi, p_l, b, cnt, seg=RK45_SEG, offsets=off,
            total=tot)
        bwd = lambda ck, cnt, cot, off: cr.launch_bwd(      # noqa: E731
            kind, scal, freeze, ck, b, cnt, cot, seg=RK45_SEG, offsets=off)
        gen_p = lambda cnt, off, tot: cr.ckpt_rk45_gen_plain(  # noqa: E731
            kind, scal, l, psi, p_l, b, cnt, seg=RK45_SEG, offsets=off,
            total=tot)
        bwd_p = lambda ck, cnt, cot, off: cr.ckpt_rk45_bwd_plain(  # noqa
            kind, scal, freeze, ck, b, cnt, cot, seg=RK45_SEG, offsets=off)
    else:
        ns, nt = cs.n_state_rk45(flags), cs.n_theta(flags, kind)
        n_out = ns - 1                          # #4 returns no dt
        args = (kind, flags, scal)
        gen = lambda cnt, off, tot: cs.launch_rk45_gen(     # noqa: E731
            *args, l, psi, p_l, b, c1, c2, nz, cnt, seg=RK45_SEG,
            offsets=off, total=tot)
        bwd = lambda ck, cnt, cot, off: cs.launch_rk45_bwd(  # noqa: E731
            kind, flags, scal, freeze, ck, b, c1, c2, nz, cnt, cot,
            seg=RK45_SEG, offsets=off)
        gen_p = lambda cnt, off, tot: cs.ckpt_surface_rk45_gen_plain(  # noqa
            *args, l, psi, p_l, b, c1, c2, nz, cnt, seg=RK45_SEG,
            offsets=off, total=tot)
        bwd_p = lambda ck, cnt, cot, off: cs.ckpt_surface_rk45_bwd_plain(  # noqa
            kind, flags, scal, freeze, ck, b, c1, c2, nz, cnt, cot,
            seg=RK45_SEG, offsets=off)
    # gen replays every ray's live iterations: its final state is #4's
    off_all, tot_all = cs.segment_offsets(iters, RK45_SEG)
    _, fin = gen(iters, off_all, tot_all)
    fin_out = torch.cat([fin[:3], fin[4:]]) if not bare else fin[:3]
    ne = torch.zeros(n, dtype=torch.bool, device=l.device)
    for c in range(n_out):
        ne |= bits_differ(fin_out[c], fwd[c])
    fin_ne = int(ne.sum())
    # the Function's fate policy
    smooth = sign.abs() <= 1
    counts = torch.where(sign != 3, iters, torch.zeros_like(iters))
    if bare:
        counts = torch.where(smooth, iters, torch.zeros_like(iters))
    cot = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (ns, n)).astype(np.float32)).to(DEVICE)
    cot[:3] = torch.where(smooth, cot[:3], torch.zeros_like(cot[:3]))
    cot[3] = 0.0
    if bare:
        cot = torch.where(smooth, cot, torch.zeros_like(cot))
    cot = cot.contiguous()
    off, total = cs.segment_offsets(counts, RK45_SEG)
    ck, _ = gen(counts, off, total)
    g_k, lam_k = bwd(ck, counts, cot, off)
    sync()
    t0 = time.perf_counter()
    ck_p, _ = gen_p(counts, off, total)
    sync()
    t1 = time.perf_counter()
    g_p, lam_p = bwd_p(ck_p, counts, cot, off)
    sync()
    gen_plain_ms = 1e3 * (t1 - t0)
    bwd_plain_ms = 1e3 * (time.perf_counter() - t1)
    gen_ms = cuda_ms(lambda: gen(counts, off, total), 3)
    bwd_ms = cuda_ms(lambda: bwd(ck, counts, cot, off), 3)
    ck_ne = int((ck[:total] != ck_p).any(dim=1).sum()) if total else 0
    ck_err = float((ck[:total] - ck_p).abs().max()) if total else 0.0
    lam_frac, lam_err = entry_fraction(lam_k, lam_p)
    g_rows = [r for r in range(nt) if bool((g_p[r] != 0).any())]
    g_frac, g_err = entry_fraction(g_k[g_rows], g_p[g_rows])
    sums = []
    shared = range(nt - 1) if bare else [r for r in g_rows
                                         if r not in (3, 4, 5, 6)]
    for r in shared:
        sk, sp = g_k[r].double().sum().item(), g_p[r].double().sum().item()
        if sp != 0.0 or sk != 0.0:
            mag = g_p[r].double().abs().sum().item()
            sums.append((r, sk, sp, abs(sk - sp) / max(abs(sp), 1e-300),
                         mag))
    tot_it = counts.double().sum().item()
    segs = (-(-counts.long() // RK45_SEG)).double().sum().item()
    signs = {s_: int((sign == s_).sum()) for s_ in (-1, 0, 1, 2, 3)}
    print(f"{tag} {label}{' (freeze)' if freeze else ''}: {n} rays, signs "
          f"{signs}, replayed iterations mean / max {tot_it / n:.1f} / "
          f"{int(counts.max())}, {total} checkpoint rows "
          f"({total * ns * 4 / 2**20:.1f} MiB)")
    print(f"{tag}   gen's final state (every ray, its full iters) == #4's "
          f"outputs: {fin_ne} of {n} rays differ in a bit (bound 0); "
          f"checkpoints == plain gen's on {total - ck_ne} of {total} rows, "
          f"max |d| {ck_err:.3e}")
    print(f"{tag}   within rtol {GRAD_RTOL}: lam {lam_frac:.6f}, g_theta "
          f"{g_frac:.6f} of entries (bound >= {RK45_GRAD_FRAC_MIN}); max "
          f"|d| lam {lam_err:.3e}, g {g_err:.3e}")
    for r, sk, sp, rel, mag in sums[:3]:
        print(f"{tag}   sum g_theta[{r}]: kernel {sk:.9e}, plain {sp:.9e}, "
              f"rel {rel:.3e} (bound {GRAD_RTOL})")
    if len(sums) > 3:
        print(f"{tag}   ... and {len(sums) - 3} more theta sums, worst rel "
              f"{max(r_[3] for r_ in sums[3:]):.3e}")
    print(f"{tag}   gen {gen_ms:.3f} ms (plain {gen_plain_ms:.1f} ms), bwd "
          f"{bwd_ms:.3f} ms (plain {bwd_plain_ms:.1f} ms)")
    require(fin_ne == 0, f"rk45 ckpt {label}: gen's final state differs "
            f"from #4 on {fin_ne} rays")
    require(ck_ne == 0, f"rk45 ckpt {label}: {ck_ne} checkpoint rows differ "
            f"from the plain gen's")
    require(lam_frac >= RK45_GRAD_FRAC_MIN,
            f"rk45 ckpt {label}: lam {lam_frac}")
    require(g_frac >= RK45_GRAD_FRAC_MIN, f"rk45 ckpt {label}: g {g_frac}")
    table = kind == "table"
    for r, sk, sp, rel, mag in sums:
        require(rel <= GRAD_RTOL or (table and abs(sk - sp)
                                     <= TABLE_SUM_TOL * mag),
                f"rk45 ckpt {label}: sum g_theta[{r}] {sk} vs {sp}")
    require(all(bool(torch.isfinite(t).all()) for t in (lam_k, g_k)),
            f"rk45 ckpt {label}: non-finite output")
    lapse = kind in ("schwarzschild", "rn")
    it_f = FLOP_RK45_ITER_LAPSE if lapse else FLOP_RK45_ITER
    vjp_f = FLOP_RK45_VJP_LAPSE if lapse else FLOP_RK45_VJP
    if flops is not None:
        it_f, vjp_f = flops
    if not bare:
        extra = (FLOP_RK45_DISK["track"] if flags is None
                 else FLOP_RK45_DISK["vol_clamp"] + FLOP_RK45_DISK["emission"])
        it_f += extra
        vjp_f += extra + (FLOP_RK45_SURF_VJP["track"] if flags is None
                          else FLOP_RK45_SURF_VJP["vol"])
    # gen reads the rays (4 or 7 floats), iters and the offset a ray and
    # writes ns floats a segment and the final state; bwd reads the
    # segments, the per-ray inputs and the cotangent and writes lam and g
    n_in = 4 if bare else 7
    gen_b = bound((4 * n_in + 12) * n + 4 * ns * (segs + n), it_f * tot_it)
    bwd_b = bound(4 * ns * segs + (4 * (n_in - 3) + 12) * n
                  + 4 * (2 * ns + nt) * n, (it_f + vjp_f) * tot_it)
    print(f"{tag}   bound gen {gen_b[0]:.3f} ms ({gen_b[1]}), bwd "
          f"{bwd_b[0]:.3f} ms ({bwd_b[1]})")
    return dict(gen=dict(max_abs_err=ck_err, ms=gen_ms,
                         plain_ms=gen_plain_ms, bound_ms=gen_b[0],
                         bound_by=gen_b[1]),
                bwd=dict(max_abs_err=max(lam_err, g_err), ms=bwd_ms,
                         plain_ms=bwd_plain_ms, bound_ms=bwd_b[0],
                         bound_by=bwd_b[1]),
                lam=lam_k, sign=sign)


def phase21_rk45_ckpt(sky):
    """Kernels #9 / #10's planar rk45 families (csrc/ckpt_rk45.cu,
    csrc/ckpt_surface_rk45.cu) against their plain versions at rtol 1e-5."""
    import dataclasses
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.ops import rk45_cuda, rk45_disk_cuda
    from curvis_tpu_torch.render.disk import DiskParams, compute_starlight_map
    from curvis_tpu_torch.render.fast import _spawn_frames
    from curvis_tpu_torch.render.starlight import starlight_scatter_block
    t_start = time.perf_counter()
    ellis = make_metric("ellis", rho=1.0, device=DEVICE)
    bh = make_metric("schwarzschild", m=1.0, device=DEVICE)
    rn = make_metric("rn", m=1.0, q=0.6, device=DEVICE)
    dneg = make_metric("interstellar", m=0.1, a=0.5, rho=1.0, device=DEVICE)
    out = {}
    bare = [
        (f"bare ellis {RES}^2 (the trainer view)", ellis,
         trainer_camera(RES), RK45_TRAIN_STEPS, None, 0, False),
        (f"bare ellis {SMALL}^2 (the trainer view)", ellis,
         trainer_camera(SMALL), RK45_TRAIN_STEPS, None, 0, True),
        (f"bare dneg {SMALL}^2", dneg, camera(5.0, 0.0, SMALL),
         RK45_TRAIN_STEPS, None, 0, True),
        (f"bare schwarzschild {SMALL}^2", bh, camera(15.0, 0.0, SMALL),
         RK45_TRAIN_STEPS, None, 0, False),
        (f"bare rn {SMALL}^2", rn, camera(12.0, 0.0, SMALL),
         RK45_TRAIN_STEPS, None, 0, False),
        (f"bare ellis {SMALL}^2, max_iters {RK45_ADJ_ITERS}", ellis,
         camera(5.0, 0.0, SMALL), RK45_TRAIN_STEPS, RK45_ADJ_ITERS, 0,
         False),
        (f"bare ellis {SMALL}^2 with {N_POISON} NaN rays", ellis,
         camera(5.0, 0.0, SMALL), RK45_TRAIN_STEPS, None, N_POISON, False),
    ]
    for k, (label, metric, cam, cap, mi, n_nan, freeze) in enumerate(bare):
        state, _, _ = _spawn_frames(metric, [cam])
        l, bad = poison_rays(state[0].reshape(-1).contiguous(), n_nan)
        flat = [l] + [t.reshape(-1).contiguous() for t in state[1:]]
        kind, scal = rk45_cuda.rk45_scalars(metric, DT, R_ESC, rtol=1e-5,
                                            atol=1e-7, dt_max=10.0)
        mi = rk45_cuda.default_max_iters(cap, mi)
        fwd = rk45_cuda.launch(kind, scal, *flat, max_steps=cap, max_iters=mi)
        nums = rk45_family_vs_plain(label, kind, "bare", scal, flat, None,
                                    fwd, seed=21 + k, freeze=freeze)
        if mi < 4 * cap:
            at = (fwd[5] == mi).double().mean().item()
            print(f"[21]   {at:.4f} of rays ran to max_iters = {mi}")
            require(at > 0.5, f"{label}: only {at} at max_iters")
        if n_nan:
            lam_bad = nums["lam"][:, bad]
            print(f"[21]   NaN rays: signs {nums['sign'][bad].tolist()}, "
                  f"max |lam| {float(lam_bad.abs().max()):.1e}")
            require(bool((nums["sign"][bad] == 3).all())
                    and bool((lam_bad == 0).all()),
                    f"{label}: NaN rays not frozen with zero lam")
        out.setdefault(label, nums)
    tint = DiskParams(**DISK_VOL)
    bb = dataclasses.replace(tint, color_mode="blackbody", t_peak=7000.0)
    smap = compute_starlight_map(
        bh, sky, dataclasses.replace(bb, starlight=True, starlight_samples=64,
                                     starlight_grid=(64, 128)),
        dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R, stepper="rk45")
    block = starlight_scatter_block(smap, bb)
    surf = [
        (f"thin schwarzschild {RES}^2 (the path's view)", bh, RES, None,
         dict(disk=(5.2, 14.0)), False),
        (f"vol tint schwarzschild {RES}^2 (the path's view)", bh, RES,
         (False, True, True, False), dict(vol_disk=tint), False),
        (f"vol blackbody + redshift + doppler {SMALL}^2", bh, SMALL,
         (True, True, True, False), dict(vol_disk=bb), True),
        (f"vol blackbody + scatter {SMALL}^2", bh, SMALL,
         (True, False, False, True),
         dict(vol_disk=dataclasses.replace(bb, redshift=False,
                                           doppler=False),
              scatter_block=block), False),
        (f"thin rn {SMALL}^2", rn, SMALL, None, dict(disk=(3.0, 14.0)), True),
        (f"thin ellis {SMALL}^2 (wormhole disk)", ellis, SMALL, None,
         dict(disk=(1.5, 14.0)), False),
        (f"vol tint ellis {SMALL}^2", ellis, SMALL,
         (False, True, True, False), dict(vol_disk=tint), False),
    ]
    for k, (label, metric, res, flags, extra, freeze) in enumerate(surf):
        state, planes = disk_rays(metric, [disk_camera(res)])
        kind, scal = rk45_disk_cuda.rk45_disk_scalars(
            metric, DT, DISK_R, RK45_DISK_RTOL, RK45_DISK_RTOL * 1e-3, 10.0,
            **extra)
        mode = rk45_disk_cuda.disk_flags(extra.get("vol_disk"),
                                         extra.get("scatter_block"))
        ins = state + (planes if flags is not None else planes[:2] + [None])
        fwd = rk45_disk_cuda.launch(kind, mode, scal, *ins,
                                    max_steps=MAX_STEPS,
                                    max_iters=RK45_SURF_ITERS)
        if flags is None:
            planes = [planes[0], planes[1], torch.zeros_like(planes[2])]
            hits = int((fwd[3] != 0).sum())
            print(f"[21] {label}: {hits} rays hit the disk")
            require(hits > 0, f"{label}: no disk hit")
        out.setdefault(label, rk45_family_vs_plain(
            label, kind, flags, scal, state, planes, fwd, seed=40 + k,
            freeze=freeze))
    print(f"[21] {time.perf_counter() - t_start:.1f} s")
    return out[bare[0][0]], out[surf[0][0]]


def phase22_rk45_paths(bgp, bgn, sky):
    """The planar rk45 gradients at full width: the 1024^2 Ellis trainer
    through render_direct(stepper='rk45', differentiable='adjoint') and one
    differentiable rk45 disk step (thin blackbody, volumetric tint) at the
    disk view; returns the launches of the rk45 checkpoint kernels."""
    import torch
    from curvis_tpu_torch.env.spherical_image import make_spherical_image
    from curvis_tpu_torch.fit import fit
    from curvis_tpu_torch.geometry.rotations import normalize
    from curvis_tpu_torch.metrics.base import EllisMetric, make_metric
    from curvis_tpu_torch.ops import ckpt_adjoint_cuda as ca
    from curvis_tpu_torch.ops import ckpt_rk45_cuda as cr
    from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
    from curvis_tpu_torch.ops import (disk_cuda, disk_vol_cuda, march_cuda,
                                      rk45_cuda, rk45_disk_cuda)
    from curvis_tpu_torch.physics import planar as pl
    from curvis_tpu_torch.camera.camera import make_camera
    from curvis_tpu_torch.metrics.base import SchwarzschildMetric
    from curvis_tpu_torch.render import disk as rd
    from curvis_tpu_torch.render.direct import render_direct, shade
    from curvis_tpu_torch.render.disk import DiskParams
    from curvis_tpu_torch.render.fast import (_pixel_dirs_soa,
                                              render_planar_fast)
    t_start = time.perf_counter()
    counters = (march_cuda, rk45_cuda, rk45_disk_cuda, disk_cuda,
                disk_vol_cuda)

    def reset():
        for mod in counters:
            mod.launches = 0
        ca.launches.update(ckpt_gen=0, ckpt_bwd=0)
        cr.launches.update(rk45_gen=0, rk45_bwd=0)
        cs.launches.update(surface_gen=0, surface_bwd=0, surface_rk45_gen=0,
                           surface_rk45_bwd=0)

    def counts():
        return dict(euler=march_cuda.launches + ca.launches["ckpt_gen"]
                    + disk_cuda.launches + disk_vol_cuda.launches
                    + cs.launches["surface_gen"],
                    rk45=rk45_cuda.launches,
                    rk45_disk=rk45_disk_cuda.launches, **cr.launches,
                    surface_rk45_gen=cs.launches["surface_rk45_gen"],
                    surface_rk45_bwd=cs.launches["surface_rk45_bwd"])

    total = dict(rk45_gen=0, rk45_bwd=0, surface_rk45_gen=0,
                 surface_rk45_bwd=0)
    # (a) the trainer
    cam = trainer_camera(RES)
    kw = dict(dt=DT, max_steps=RK45_TRAIN_STEPS, escape_radius=R_ESC,
              filtering="bilinear", stepper="rk45")
    with torch.no_grad():
        target = render_direct(EllisMetric(1.6, device=DEVICE), cam, bgp,
                               bgn, differentiable="adjoint", **kw)

    def loss(p):
        img = render_direct(EllisMetric(rho=p["rho"], device=DEVICE), cam,
                            bgp, bgn, differentiable="adjoint", **kw)
        return torch.mean((img - target) ** 2)

    reset()
    rho = torch.tensor(1.0, device=DEVICE, requires_grad=True)
    img = render_direct(EllisMetric(rho=rho, device=DEVICE), cam, bgp, bgn,
                        differentiable="adjoint", **kw)
    (g,) = torch.autograd.grad(torch.mean((img - target) ** 2), rho)
    step = counts()
    # the image against render_planar_fast's: the two routes spawn the rays
    # with other operations (ulps apart), so the adaptive marches differ
    # at their tolerance; held as phase 9 holds its rk45 images, with the
    # nearest lookup, and the bilinear difference printed
    with torch.no_grad():
        ell = EllisMetric(1.0, device=DEVICE)
        fast = render_planar_fast(ell, cam, bgp, bgn, **kw)
        near = dict(kw, filtering="nearest")
        img_n = render_direct(ell, cam, bgp, bgn, differentiable="adjoint",
                              **near)
        fast_n = render_planar_fast(ell, cam, bgp, bgn, **near)
    d = (img.detach() - fast).abs()
    off = ((img_n - fast_n).abs().amax(-1) > 1e-6).double().mean().item()
    print(f"[22] trainer ellis {RES}^2 rk45: d loss / d rho {float(g):.9e}; "
          f"launches of one step {step}; image vs render_planar_fast("
          f"stepper='rk45'): nearest lookup {off:.6f} of pixels beyond 1e-6 "
          f"(bound {IMAGE_DIFF_MAX}); bilinear max |d| {float(d.max()):.3e}, "
          f"mean {float(d.mean()):.3e}")
    require(math.isfinite(float(g)) and float(g) != 0.0,
            f"rk45 trainer gradient {float(g)}")
    require(step["rk45"] == 1 and step["rk45_gen"] == 1
            and step["rk45_bwd"] == 1 and step["euler"] == 0,
            f"rk45 trainer launches {step}")
    require(off <= IMAGE_DIFF_MAX, f"rk45 trainer image vs render_planar_"
            f"fast: {off} of pixels differ")
    for k_ in total:
        total[k_] += step.get(k_, 0)
    # the step's time split (CUDA events, median of 3), the kernel pair
    # alone on the step's rays
    fwd_t, bwd_t = [], []
    for _ in range(3):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        v = loss({"rho": rho})
        e[1].record()
        torch.autograd.grad(v, rho)
        e[2].record()
        e[2].synchronize()
        fwd_t.append(e[0].elapsed_time(e[1]))
        bwd_t.append(e[1].elapsed_time(e[2]))
    metric = EllisMetric(1.0, device=DEVICE)
    dirs = torch.stack(_pixel_dirs_soa(cam), dim=-1)
    rays = pl.spawn_planar(metric, cam.position, dirs)
    flat = [t.expand(rays.psi.shape).reshape(-1).contiguous()
            for t in rays[:4]]
    kind, scal = rk45_cuda.rk45_scalars(metric, DT, R_ESC, 1e-5, 1e-7, 10.0)
    fwd = rk45_cuda.launch(kind, scal, *flat, max_steps=RK45_TRAIN_STEPS,
                           max_iters=4 * RK45_TRAIN_STEPS)
    cnt = torch.where(fwd[3].abs() <= 1, fwd[5], torch.zeros_like(fwd[5]))
    off_, tot_ = cs.segment_offsets(cnt, RK45_SEG)
    ck, _ = cr.launch_gen(kind, scal, *flat, cnt, seg=RK45_SEG, offsets=off_,
                          total=tot_)
    cot = torch.ones((4, cnt.numel()), device=DEVICE)
    gen_ms = cuda_ms(lambda: cr.launch_gen(kind, scal, *flat, cnt,
                                           seg=RK45_SEG, offsets=off_,
                                           total=tot_), 3)
    bwd_ms = cuda_ms(lambda: cr.launch_bwd(kind, scal, False, ck, flat[3],
                                           cnt, cot, seg=RK45_SEG,
                                           offsets=off_), 3)
    fwd_ms = cuda_ms(lambda: rk45_cuda.launch(
        kind, scal, *flat, max_steps=RK45_TRAIN_STEPS,
        max_iters=4 * RK45_TRAIN_STEPS), 3)
    print(f"[22]   step (median of 3, CUDA events): forward "
          f"{statistics.median(fwd_t):.2f} ms + backward "
          f"{statistics.median(bwd_t):.2f} ms; #4 alone {fwd_ms:.2f} ms, "
          f"gen {gen_ms:.2f} ms, bwd {bwd_ms:.2f} ms; mean / max iterations "
          f"{fwd[5].double().mean().item():.1f} / {int(fwd[5].max())}, "
          f"checkpoint buffer {tot_ * 16 / 2**20:.1f} MiB")
    del ck
    # d / d rho of the kernel pair against the plain pair at GRAD_RES^2,
    # the march's pullback called by hand
    small = trainer_camera(GRAD_RES)
    with torch.no_grad():
        tgt = render_direct(EllisMetric(1.6, device=DEVICE), small, bgp, bgn,
                            differentiable="adjoint", **kw)
    tgt = tgt.permute(1, 0, 2).reshape(-1, 3)

    def by_hand(pullback):
        rho = torch.tensor(1.0, device=DEVICE, requires_grad=True)
        metric = EllisMetric(rho, device=DEVICE)
        rays = pl.spawn_planar(metric, small.position, torch.stack(
            _pixel_dirs_soa(small), dim=-1))
        y0 = [t.expand(rays.psi.shape).detach().reshape(-1).contiguous()
              for t in rays[:4]]
        kind, scal = rk45_cuda.rk45_scalars(metric, DT, R_ESC, 1e-5, 1e-7,
                                            10.0)
        out = rk45_cuda.launch(kind, scal, *y0, max_steps=RK45_TRAIN_STEPS,
                               max_iters=4 * RK45_TRAIN_STEPS)
        ys = [t.clone().requires_grad_() for t in out[:3]]
        res = pl.PlanarResult(*ys, out[3], out[4])
        w = normalize(pl.planar_world_directions(metric, rays, res))
        lo = torch.mean((shade(bgp, bgn, w, res.sign, filtering="bilinear")
                         - tgt) ** 2)
        g_direct, *cot = torch.autograd.grad(lo, [rho, *ys],
                                             retain_graph=True)
        keep = out[3].abs() <= 1
        cnt = torch.where(keep, out[5], torch.zeros_like(out[5]))
        cot = torch.stack([torch.where(keep, c, torch.zeros_like(c))
                           for c in cot] + [torch.zeros_like(cot[0])])
        g, lam = pullback(kind, scal, y0[:3], y0[3], cnt, cot.contiguous())
        outs = [(t, c) for t, c in zip(rays[:4], (*lam[:3], g[3]))
                if t.requires_grad]
        (g_spawn,) = torch.autograd.grad([t for t, _ in outs], rho,
                                         grad_outputs=[c for _, c in outs])
        return (g_direct + g_spawn + g[0].double().sum()).item()

    def plain(kind, scal, y0, b, cnt, cot):
        off, tot = cs.segment_offsets(cnt, RK45_SEG)
        ck, _ = cr.ckpt_rk45_gen_plain(kind, scal, *y0, b, cnt, seg=RK45_SEG,
                                       offsets=off, total=tot)
        return cr.ckpt_rk45_bwd_plain(kind, scal, False, ck, b, cnt, cot,
                                      seg=RK45_SEG, offsets=off)

    g_k = by_hand(lambda *a: cr.ckpt_rk45_backward_cuda(
        a[0], a[1], False, *a[2:], seg=RK45_SEG))
    g_p = by_hand(plain)
    rel = abs(g_k - g_p) / abs(g_p)
    print(f"[22]   d loss / d rho at {GRAD_RES}^2: kernel pair {g_k:.9e}, "
          f"plain pair {g_p:.9e}; rel {rel:.3e} (bound {GRAD_RTOL})")
    require(rel <= GRAD_RTOL, f"rk45 gradient kernel vs plain: {g_k} vs "
            f"{g_p}")
    # central difference over the pixels in the linear regime, on a smooth
    # sky (the noise sky's bilinear texels bend each pixel's colour within
    # the step)
    h = RK45_FD_H
    sm = smooth_sky()
    ims = []
    for s_ in (1.0, -1.0):
        with torch.no_grad():
            ims.append(render_direct(EllisMetric(1.0 + s_ * h, device=DEVICE),
                                     cam, sm, sm, differentiable="adjoint",
                                     **kw).double())
    rho = torch.tensor(1.0, device=DEVICE, requires_grad=True)
    img = render_direct(EllisMetric(rho=rho, device=DEVICE), cam, sm, sm,
                        differentiable="adjoint", **kw)
    curv = (ims[0] - 2.0 * img.detach().double() + ims[1]).abs()
    linear = (curv <= SURF_FD_LIN * (ims[0] - ims[1]).abs() + 1e-6).double()
    fd = ((ims[0] - ims[1]) * linear).mean().item() / (2 * h)
    (g,) = torch.autograd.grad((img.double() * linear).mean(), rho)
    rel = abs(float(g) - fd) / max(abs(fd), 1e-300)
    kept = linear.mean().item()
    print(f"[22]   d mean(image) / d rho adjoint {float(g):.9e}, central "
          f"difference (h = {h}) {fd:.9e}, rel {rel:.3e} (bound "
          f"{RK45_FD_TOL}); {kept:.6f} of pixel channels in the linear "
          f"regime (bound >= {SURF_FD_KEEP})")
    require(rel <= RK45_FD_TOL, f"rk45 trainer d/drho {float(g)} vs {fd}")
    require(kept >= SURF_FD_KEEP, f"rk45 trainer: kept only {kept}")
    # fit: 5 Adam steps on rho
    fit(loss, {"rho": torch.tensor(1.0, device=DEVICE)}, iters=1,
        lr=TRAIN_LR)
    reset()
    t0 = time.perf_counter()
    res = fit(loss, {"rho": torch.tensor(1.0, device=DEVICE)},
              iters=TRAIN_ITERS, lr=TRAIN_LR)
    sync()
    fit_s = time.perf_counter() - t0
    step = counts()
    hist = res.history
    print(f"[22]   fit: {TRAIN_ITERS} Adam steps in {fit_s:.2f} s, rho 1.0 "
          f"-> {float(res.params['rho']):.6f} (target 1.6); history "
          f"{', '.join(f'{x:.6e}' for x in hist)}; launches {step}")
    require(all(math.isfinite(x) for x in hist), f"rk45 fit {hist}")
    require(hist[-1] < hist[0], f"rk45 fit: the loss did not drop: {hist}")
    require(step["euler"] == 0 and step["rk45_gen"] >= TRAIN_ITERS
            and step["rk45_bwd"] >= TRAIN_ITERS, f"rk45 fit launches {step}")
    for k_ in total:
        total[k_] += step.get(k_, 0)

    # (b) one differentiable rk45 disk step at the disk view
    bh = make_metric("schwarzschild", m=1.0, device=DEVICE)
    dcam = disk_camera(RES)
    dark = make_spherical_image(torch.zeros(SKY), device=DEVICE)
    thin = DiskParams(**DISK_THIN)
    vol = DiskParams(**DISK_VOL)
    rk = dict(stepper="rk45", rtol=RK45_DISK_RTOL)
    f64 = torch.float64
    st, ct_ = math.sin(DISK_TH), math.cos(DISK_TH)
    dcam64 = make_camera([0.0, DISK_L, DISK_TH, 0.0], [-st, 0.0, -ct_],
                         [0.0, 0.0, 1.0], DISK_FOCAL, 43.0, RES, RES,
                         device=DEVICE, dtype=f64)
    dark64 = make_spherical_image(torch.zeros(SKY, dtype=f64), device=DEVICE,
                                  dtype=f64)

    def f64_frame(disk, theta, kw):
        """The frame of ``theta`` through the twin route in float64."""
        th = {k: torch.tensor(v, dtype=f64, device=DEVICE)
              for k, v in theta.items()}
        metric = SchwarzschildMetric(th.pop("m", torch.tensor(
            1.0, dtype=f64, device=DEVICE)), device=DEVICE, dtype=f64)
        return rd.render_blackhole_disk(
            metric, dcam64, dark64, disk=disk, dt=DT, max_steps=MAX_STEPS,
            escape_radius=DISK_R, differentiable="scan", disk_theta=th,
            **kw)

    frames = [("thin blackbody", thin, dict(m=1.0, brightness=thin.brightness),
               ("m", "brightness")),
              ("volumetric tint", vol, dict(brightness=vol.brightness,
                                            kappa=vol.kappa),
               ("kappa", "brightness"))]
    for name, disk, theta, keys in frames:
        reset()
        img, params = surface_frame(bh, dcam, sky, disk, theta, None,
                                    "adjoint", **rk)
        grads = torch.autograd.grad(img.double().mean(),
                                    list(params.values()))
        step = counts()
        with torch.no_grad():
            ref, _ = surface_frame(bh, dcam, sky, disk, theta, None, **rk)
        diff = float((img.detach() - ref).abs().max())
        print(f"[22] disk {name} rk45 {RES}^2: launches {step}; image vs "
              f"the non-differentiable rk45 render: max |d| {diff:.3e}; "
              f"d loss / d " + ", ".join(f"{k} {float(g_):.9e}"
                                         for k, g_ in zip(params, grads)))
        require(diff == 0.0, f"rk45 disk {name}: image differs by {diff}")
        require(step["rk45_disk"] == 1 and step["surface_rk45_gen"] == 1
                and step["surface_rk45_bwd"] == 1 and step["euler"] == 0,
                f"rk45 disk {name}: launches {step}")
        for k_ in total:
            total[k_] += step.get(k_, 0)
        fwd_t, bwd_t = [], []
        for _ in range(3):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            img, params = surface_frame(bh, dcam, sky, disk, theta, None,
                                        "adjoint", **rk)
            v = img.double().mean()
            e[1].record()
            torch.autograd.grad(v, list(params.values()))
            e[2].record()
            e[2].synchronize()
            fwd_t.append(e[0].elapsed_time(e[1]))
            bwd_t.append(e[1].elapsed_time(e[2]))
        print(f"[22]   step (median of 3, CUDA events): forward "
              f"{statistics.median(fwd_t):.2f} ms + backward "
              f"{statistics.median(bwd_t):.2f} ms")
        checks = [(key, RK45_DISK_FD_RTOL, True) for key in keys]
        if "m" in keys:
            checks.append(("m", RK45_DISK_RTOL, False))
        mids = {}
        for key, fd_rtol, gate in checks:
            fd_kw = dict(stepper="rk45", rtol=fd_rtol)
            # the central difference of the same march in float64 (the
            # twin route, 'scan', on the card): in float32 the error
            # norm's slope d5 - d4 keeps ~3 digits, so the renders at
            # +-h take other accepts on some rays (jumps of ~rtol), which
            # no pathwise derivative has
            hh = RK45_DISK_FD[key] * theta[key]
            ims = []
            for s_ in (1.0, -1.0):
                with torch.no_grad():
                    ims.append(f64_frame(disk, dict(
                        theta, **{key: theta[key] + s_ * hh}), fd_kw))
            if fd_rtol not in mids:
                with torch.no_grad():
                    mids[fd_rtol] = f64_frame(disk, theta, fd_kw)
            mid = mids[fd_rtol]
            img, params = surface_frame(bh, dcam, dark, disk, theta, None,
                                        "adjoint", **fd_kw)
            # the kernel route's float32 renders at +-h: their linear
            # regime, and their difference printed beside the gated one
            ims32 = []
            for s_ in (1.0, -1.0):
                with torch.no_grad():
                    im, _ = surface_frame(bh, dcam, dark, disk, dict(
                        theta, **{key: theta[key] + s_ * hh}), None,
                        "adjoint", **fd_kw)
                ims32.append(im.double())
            # the linear regime of both precisions: a pixel channel whose
            # float32 renders jump (accepts flipped by rounding) or whose
            # float64 ones bend within the step is left out
            linear = None
            for a, m_, b_ in ((ims[0], mid, ims[1]),
                              (ims32[0], img.detach().double(), ims32[1])):
                lin = ((a - 2.0 * m_ + b_).abs()
                       <= SURF_FD_LIN * (a - b_).abs() + 1e-6)
                linear = lin if linear is None else linear & lin
            linear = linear.double()
            fd = ((ims[0] - ims[1]) * linear).mean().item() / (2 * hh)
            (g_,) = torch.autograd.grad((img.double() * linear).mean(),
                                        [params[key]])
            rel = abs(float(g_) - fd) / max(abs(fd), 1e-300)
            kept = linear.mean().item()
            fd32 = ((ims32[0] - ims32[1]) * linear).mean().item() / (2 * hh)
            print(f"[22]   d loss / d {key} at rtol {fd_rtol:g}: adjoint "
                  f"(kernels, float32) {float(g_):.9e}, central difference "
                  f"(float64, h = {hh:.3g}) {fd:.9e}, rel {rel:.3e} "
                  + (f"(bound {SURF_FD_TOL[key]})" if gate else
                     "(not gated)")
                  + f"; of the float32 renders {fd32:.9e}; {kept:.6f} of "
                  f"pixel channels kept"
                  + (f" (bound >= {SURF_FD_KEEP})" if gate else ""))
            if gate:
                require(rel <= SURF_FD_TOL[key], f"rk45 disk {name}: "
                        f"d/d{key} {float(g_)} vs {fd}")
                require(kept >= SURF_FD_KEEP, f"rk45 disk {name}: d/d{key} "
                        f"kept only {kept}")
    # differentiable=True is the 'adjoint' route (the kernels)
    reset()
    img, params = surface_frame(bh, dcam, sky, thin, frames[0][2], None,
                                True, **rk)
    torch.autograd.grad(img.double().mean(), list(params.values()))
    step = counts()
    print(f"[22] thin blackbody rk45, differentiable=True: launches {step}")
    require(step["surface_rk45_gen"] == 1 and step["surface_rk45_bwd"] == 1,
            f"differentiable=True: launches {step}")
    for k_ in total:
        total[k_] += step.get(k_, 0)
    print(f"[22] launches of the rk45 checkpoint kernels over the paths: "
          f"{total}; {time.perf_counter() - t_start:.1f} s")
    return total


def kerr_family_vs_plain(label, family, scal, ins, fwd, seed, freeze=False):
    """Kernels #9 / #10's Kerr ``family`` ('rk4' or 'rk45') against their
    plain versions on the forward kernel's outputs ``fwd`` (#7 or #8) for
    the rays ``ins`` (r, theta, phi, p_r, p_theta, E, L): gen's final state
    bit for bit against the forward kernel on every ray (its full steps or
    iterations), then the checkpoints, lam and g_theta with the Function's
    fate policy (state cotangents and replays for signs 0 and 1)."""
    import numpy as np
    import torch
    from curvis_tpu_torch.ops import ckpt_kerr_cuda as ck
    seg = KERR_SEG[family]
    y0, E, L = ins[:5], ins[5], ins[6]
    sign = fwd[5]
    full = fwd[-1] if family == "rk45" else fwd[6]
    n, ns = E.numel(), ck.N_STATE[family]

    def gen(cnt, off, tot):
        return ck.launch_gen(family, scal, y0, E, L, cnt, seg=seg,
                             offsets=off, total=tot)

    def bwd(ckpt, cnt, cot, off):
        return ck.launch_bwd(family, scal, ckpt, E, L, cnt, cot, seg=seg,
                             offsets=off, freeze=freeze)

    # gen replays every ray's steps: its final state is the forward's
    off_all, tot_all = ck.segment_offsets(full, seg)
    _, fin = gen(full, off_all, tot_all)
    ne = torch.zeros(n, dtype=torch.bool, device=E.device)
    for c in range(5):
        ne |= bits_differ(fin[c], fwd[c])
    fin_ne = int(ne.sum())
    # the Function's fate policy
    smooth = (sign == 0) | (sign == 1)
    counts = torch.where(smooth, full, torch.zeros_like(full))
    cot = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (ns, n)).astype(np.float32)).to(DEVICE)
    if family == "rk45":
        cot[5] = 0.0
    cot = torch.where(smooth, cot, torch.zeros_like(cot)).contiguous()
    off, total = ck.segment_offsets(counts, seg)
    ck_k, _ = gen(counts, off, total)
    g_k, lam_k = bwd(ck_k, counts, cot, off)
    sync()
    t0 = time.perf_counter()
    ck_p, _ = ck.ckpt_kerr_gen_plain(family, scal, y0, E, L, counts,
                                     seg=seg, offsets=off, total=total)
    sync()
    t1 = time.perf_counter()
    g_p, lam_p = ck.ckpt_kerr_bwd_plain(family, scal, ck_p, E, L, counts,
                                        cot, seg=seg, offsets=off,
                                        freeze=freeze)
    sync()
    gen_plain_ms = 1e3 * (t1 - t0)
    bwd_plain_ms = 1e3 * (time.perf_counter() - t1)
    gen_ms = cuda_ms(lambda: gen(counts, off, total), 3)
    bwd_ms = cuda_ms(lambda: bwd(ck_k, counts, cot, off), 3)
    ck_ne = int((ck_k[:total] != ck_p).any(dim=1).sum()) if total else 0
    ck_err = float((ck_k[:total] - ck_p).abs().max()) if total else 0.0
    lam_frac, lam_err = entry_fraction(lam_k, lam_p)
    g_rows = [r for r in range(5) if bool((g_p[r] != 0).any())]
    g_frac, g_err = entry_fraction(g_k[g_rows], g_p[g_rows])
    sums = []
    for r in (0, 1, 2):
        sk, sp = g_k[r].double().sum().item(), g_p[r].double().sum().item()
        if sp != 0.0 or sk != 0.0:
            sums.append((r, sk, sp, abs(sk - sp) / max(abs(sp), 1e-300)))
    tot_steps = counts.double().sum().item()
    segs = (-(-counts.long() // seg)).double().sum().item()
    signs = {s_: int((sign == s_).sum()) for s_ in range(4)}
    what = "iterations" if family == "rk45" else "steps"
    print(f"[23] {label}{' (freeze)' if freeze else ''}: {n} rays, signs "
          f"{signs}, replayed {what} mean / max {tot_steps / n:.1f} / "
          f"{int(counts.max())}, {total} checkpoint rows "
          f"({total * ns * 4 / 2**20:.1f} MiB)")
    print(f"[23]   gen's final state (every ray, its full {what}) == the "
          f"forward kernel's: {fin_ne} of {n} rays differ in a bit (bound "
          f"0); checkpoints == plain gen's on {total - ck_ne} of {total} "
          f"rows, max |d| {ck_err:.3e}")
    print(f"[23]   within rtol {GRAD_RTOL}: lam {lam_frac:.6f}, g_theta "
          f"{g_frac:.6f} of entries (bound >= {RK45_GRAD_FRAC_MIN}); max "
          f"|d| lam {lam_err:.3e}, g {g_err:.3e}")
    for r, sk, sp, rel in sums:
        print(f"[23]   sum g_theta[{'M a q2'.split()[r]}]: kernel {sk:.9e}, "
              f"plain {sp:.9e}, rel {rel:.3e} (bound {GRAD_RTOL})")
    print(f"[23]   gen {gen_ms:.3f} ms (plain {gen_plain_ms:.1f} ms), bwd "
          f"{bwd_ms:.3f} ms (plain {bwd_plain_ms:.1f} ms)")
    require(fin_ne == 0, f"kerr ckpt {label}: gen's final state differs "
            f"from the forward kernel on {fin_ne} rays")
    require(ck_ne == 0, f"kerr ckpt {label}: {ck_ne} checkpoint rows "
            f"differ from the plain gen's")
    require(lam_frac >= RK45_GRAD_FRAC_MIN,
            f"kerr ckpt {label}: lam {lam_frac}")
    require(g_frac >= RK45_GRAD_FRAC_MIN, f"kerr ckpt {label}: g {g_frac}")
    for r, sk, sp, rel in sums:
        require(rel <= GRAD_RTOL, f"kerr ckpt {label}: sum g_theta[{r}] "
                f"{sk} vs {sp}")
    require(all(bool(torch.isfinite(t).all()) for t in (lam_k, g_k)),
            f"kerr ckpt {label}: non-finite output")
    step_f = FLOP_KERR_RK45_ITER if family == "rk45" else FLOP_KERR_STEP
    vjp_f = FLOP_KERR_RK45_VJP if family == "rk45" else FLOP_KERR_VJP
    # gen reads 7 floats, the count and the offset a ray and writes ns
    # floats a segment and the final state; bwd reads the segments, E, L,
    # the count, the offset and the cotangent, and writes lam and g
    gen_b = bound(40 * n + 4 * ns * (segs + n), step_f * tot_steps)
    bwd_b = bound(4 * ns * segs + 20 * n + 4 * (2 * ns + 5) * n,
                  (step_f + vjp_f) * tot_steps)
    print(f"[23]   bound gen {gen_b[0]:.3f} ms ({gen_b[1]}), bwd "
          f"{bwd_b[0]:.3f} ms ({bwd_b[1]})")
    return dict(gen=dict(max_abs_err=ck_err, ms=gen_ms,
                         plain_ms=gen_plain_ms, bound_ms=gen_b[0],
                         bound_by=gen_b[1]),
                bwd=dict(max_abs_err=max(lam_err, g_err), ms=bwd_ms,
                         plain_ms=bwd_plain_ms, bound_ms=bwd_b[0],
                         bound_by=bwd_b[1]),
                lam=lam_k, sign=sign)


def phase23_kerr_ckpt():
    """Kernels #9 / #10's Kerr RK4 and DP5(4) families (csrc/ckpt_kerr.cu,
    csrc/ckpt_kerr_rk45.cu) against their plain versions: RK4 on the bare
    960 x 540 view capped at KERR_CKPT_CAP steps, Kerr-Newman (q 0.6) and
    16 NaN rays at 256^2 capped at half that; DP5(4) at rtol 1e-4 on the
    bare view, frozen at 256^2, Kerr-Newman at 256^2 and 16 NaN rays (these
    three capped at KERR_CKPT_ITERS iterations), a max_iters most rays
    reach."""
    import torch
    from curvis_tpu_torch.metrics.kerr import make_kerr, make_kerr_newman
    from curvis_tpu_torch.ops import kerr_cuda as kc
    from curvis_tpu_torch.ops import kerr_rk45_cuda as k45
    from curvis_tpu_torch.render import kerr as rk
    t_start = time.perf_counter()
    kerr = make_kerr(1.0, KERR_A, device=DEVICE)
    kn = make_kerr_newman(1.0, 0.7, 0.6, device=DEVICE)
    R = 2.0 * KERR_L
    full = kerr_camera(KERR_RES)
    small = kerr_camera((SMALL, SMALL))
    res = f"{KERR_RES[0]}x{KERR_RES[1]}"
    out = {}
    # name, family, metric, camera, cap (steps; max_iters for rk45), NaN
    # rays, freeze
    cases = [
        (f"rk4 bare {res} (the path's view), cap {KERR_CKPT_CAP}", "rk4",
         kerr, full, KERR_CKPT_CAP, 0, False),
        (f"rk4 kerr-newman q 0.6 {SMALL}^2, cap {KERR_CKPT_CAP // 2}",
         "rk4", kn, small, KERR_CKPT_CAP // 2, 0, False),
        (f"rk4 bare {SMALL}^2 with {N_POISON} NaN rays, cap "
         f"{KERR_CKPT_CAP // 2}", "rk4", kerr, small, KERR_CKPT_CAP // 2,
         N_POISON, False),
        (f"rk45 bare {res} (the path's view)", "rk45", kerr, full, None, 0,
         False),
        (f"rk45 bare {SMALL}^2, max_iters {KERR_CKPT_ITERS}", "rk45", kerr,
         small, KERR_CKPT_ITERS, 0, True),
        (f"rk45 kerr-newman q 0.6 {SMALL}^2, max_iters {KERR_CKPT_ITERS}",
         "rk45", kn, small, KERR_CKPT_ITERS, 0, False),
        (f"rk45 bare {SMALL}^2, max_iters {KERR_ADJ_ITERS}", "rk45", kerr,
         small, KERR_ADJ_ITERS, 0, True),
        (f"rk45 bare {SMALL}^2 with {N_POISON} NaN rays, max_iters "
         f"{KERR_CKPT_ITERS}", "rk45", kerr, small, KERR_CKPT_ITERS,
         N_POISON, False),
    ]
    for k, (label, family, metric, cam, cap, n_nan, freeze) in enumerate(
            cases):
        x0, p0, _ = rk._spawn_kerr_rays(metric, cam)
        ins = [t.contiguous() for t in (x0[:, 1], x0[:, 2], x0[:, 3],
                                        p0[:, 1], p0[:, 2], -p0[:, 0],
                                        p0[:, 3])]
        ins[0], bad = poison_rays(ins[0], n_nan)
        if family == "rk4":
            scal = kc.kerr_scalars(metric, KERR_DT, R, axis_u0=0.01,
                                   far_r0=8.0)
            fwd = kc.launch((False,) * 5, scal, *ins, max_steps=cap)
        else:
            scal = k45.kerr_rk45_scalars(metric, KERR_DT, R, rtol=KERR_RTOL,
                                         atol=KERR_RTOL * 1e-3, dt_min=1e-5,
                                         dt_max=R / 8.0)
            mi = 2 * KERR_STEPS if cap is None else cap
            fwd = k45.launch((False,) * 5, scal, *ins, max_steps=KERR_STEPS,
                             max_iters=mi)
        nums = kerr_family_vs_plain(label, family, scal, ins, fwd,
                                    seed=230 + k, freeze=freeze)
        if family == "rk45" and cap == KERR_ADJ_ITERS:
            at = (fwd[-1] == cap).double().mean().item()
            print(f"[23]   {at:.4f} of rays ran to max_iters = {cap}")
            require(at > 0.5, f"{label}: only {at} at max_iters")
        if family == "rk4":
            capped = (fwd[5] == 0).double().mean().item()
            print(f"[23]   {capped:.4f} of rays stopped at the cap of {cap}")
        if n_nan:
            lam_bad = nums["lam"][:, bad]
            print(f"[23]   NaN rays: signs {nums['sign'][bad].tolist()}, "
                  f"max |lam| {float(lam_bad.abs().max()):.1e}")
            require(bool((nums["sign"][bad] == 3).all())
                    and bool((lam_bad == 0).all()),
                    f"{label}: NaN rays not frozen with zero lam")
        out.setdefault(family, nums)
    print(f"[23] {time.perf_counter() - t_start:.1f} s")
    return out["rk4"], out["rk45"]


def kerr_grad_by_hand(family, metric_fn, cam, bg, target, cap, pullback):
    """d loss / d(M, a) of a Kerr render at ``cam`` (loss = mean((image -
    target)^2), the RK4 march capped at ``cap`` steps or DP5(4) at
    KERR_RTOL) with the march's pullback called by hand: the forward
    kernel, the shading's cotangents by autograd, ``pullback`` (the kernel
    pair or the plain pair) for the march, the spawn by autograd."""
    import torch
    from curvis_tpu_torch.ops import kerr_cuda as kc
    from curvis_tpu_torch.ops import kerr_rk45_cuda as k45
    from curvis_tpu_torch.render import kerr as rk
    m = torch.tensor(1.0, device=DEVICE, requires_grad=True)
    a = torch.tensor(KERR_A, device=DEVICE, requires_grad=True)
    metric = metric_fn(m, a)
    x0, p0, _ = rk._spawn_kerr_rays(metric, cam)
    ins = [t.detach().contiguous() for t in (x0[:, 1], x0[:, 2], x0[:, 3],
                                             p0[:, 1], p0[:, 2], -p0[:, 0],
                                             p0[:, 3])]
    R = 2.0 * float(cam.position[1])
    if family == "rk4":
        scal = kc.kerr_scalars(metric, KERR_DT, R, axis_u0=0.01, far_r0=8.0)
        out = kc.launch((False,) * 5, scal, *ins, max_steps=cap)
        counts = out[6]
    else:
        scal = k45.kerr_rk45_scalars(metric, KERR_DT, R, rtol=KERR_RTOL,
                                     atol=KERR_RTOL * 1e-3, dt_min=1e-5,
                                     dt_max=R / 8.0)
        out = k45.launch((False,) * 5, scal, *ins, max_steps=KERR_STEPS,
                         max_iters=2 * KERR_STEPS)
        counts = out[-1]
    sign = out[5]
    E, L = ins[5], ins[6]
    z = torch.zeros_like(E)
    xs = torch.stack([z, out[0], out[1], out[2]], -1).requires_grad_()
    ps = torch.stack([-E, out[3], out[4], L], -1).requires_grad_()
    colors = rk._kerr_shade(metric, x0, p0, bg, xs, ps, sign, None,
                            "bilinear", None, None, None, None)
    loss = torch.mean((colors - target) ** 2)
    g_m, g_a, gx, gp = torch.autograd.grad(loss, [m, a, xs, ps],
                                           retain_graph=True)
    smooth = (sign == 0) | (sign == 1)
    rows = [gx[:, 1], gx[:, 2], gx[:, 3], gp[:, 1], gp[:, 2]]
    if family == "rk45":
        rows.append(z)
    cot = torch.stack([torch.where(smooth, c, z) for c in rows]).contiguous()
    cnt = torch.where(smooth, counts, torch.zeros_like(counts))
    g, lam = pullback(family, scal, ins[:5], E, L, cnt, cot)
    g_x0 = torch.stack([z, lam[0], lam[1], lam[2]], -1)
    g_p0 = torch.stack([gp[:, 0] - g[3], lam[3], lam[4], gp[:, 3] + g[4]],
                       -1)
    outs = [(t, c) for t, c in ((x0, g_x0), (p0, g_p0)) if t.requires_grad]
    s_m, s_a = torch.autograd.grad([t for t, _ in outs], [m, a],
                                   grad_outputs=[c for _, c in outs],
                                   allow_unused=True)
    s_m = 0.0 if s_m is None else s_m
    s_a = 0.0 if s_a is None else s_a
    return ((g_m + s_m).double().item() + g[0].double().sum().item(),
            (g_a + s_a).double().item() + g[1].double().sum().item())


def spin_camera(res, side=1.3):
    """The spin-recovery camera of examples/inverse_problem.py:116-121."""
    from curvis_tpu_torch.camera.camera import make_camera
    f = [-math.sin(SPIN_TH), side, -math.cos(SPIN_TH)]
    norm = math.sqrt(sum(v * v for v in f))
    return make_camera([0.0, SPIN_L, SPIN_TH, 0.0], [v / norm for v in f],
                       [0.0, 0.0, 1.0], 35.0, 43.0, res[0], res[1],
                       device=DEVICE)


def phase24_kerr_paths(bright):
    """The Kerr gradients at full width: one render_kerr(backend='adjoint')
    loss-and-gradient step on phase 14's a = 0.9 view (RK4) and on phase
    16's (rk45), each image equal to the non-differentiable render, its
    launches and time split; d / d(M, a) of the kernel pair against the
    plain pair at 128^2; d / da against a central difference on the
    spin-recovery view, and a few descent steps on a there; backend='scan'
    against the adjoint there at 128^2, each stepper.  Returns the
    launches of the Kerr checkpoint kernels."""
    import torch
    from curvis_tpu_torch.metrics.kerr import KerrMetric, make_kerr
    from curvis_tpu_torch.ops import (ckpt_adjoint_cuda, ckpt_rk45_cuda,
                                      ckpt_surface_cuda, disk_cuda,
                                      disk_vol_cuda, kerr_cuda,
                                      kerr_rk45_cuda, march_cuda, rk45_cuda,
                                      rk45_disk_cuda)
    from curvis_tpu_torch.ops import ckpt_kerr_cuda as ck
    from curvis_tpu_torch.render import kerr as rk
    t_start = time.perf_counter()
    others = (march_cuda, rk45_cuda, rk45_disk_cuda, disk_cuda,
              disk_vol_cuda)
    dicts = (ckpt_adjoint_cuda.launches, ckpt_rk45_cuda.launches,
             ckpt_surface_cuda.launches)

    def reset():
        for mod in (*others, kerr_cuda, kerr_rk45_cuda):
            mod.launches = 0
        for d in (*dicts, ck.launches):
            for k_ in d:
                d[k_] = 0

    def counts():
        return dict(k7=kerr_cuda.launches, k8=kerr_rk45_cuda.launches,
                    **ck.launches,
                    other=sum(mod.launches for mod in others)
                    + sum(sum(d.values()) for d in dicts))

    total = dict(kerr_gen=0, kerr_bwd=0, kerr_rk45_gen=0, kerr_rk45_bwd=0)
    cam = kerr_camera(KERR_RES)
    res = f"{KERR_RES[0]}x{KERR_RES[1]}"
    views = [("rk4", dict(dt=KERR_DT, max_steps=KERR_STEPS)),
             ("rk45", dict(dt=KERR_DT, max_steps=KERR_STEPS, stepper="rk45",
                           rtol=KERR_RTOL))]
    for family, kw in views:
        with torch.no_grad():
            target = rk.render_kerr(make_kerr(1.0, 0.85, device=DEVICE), cam,
                                    bright, **kw)
            ref0 = rk.render_kerr(make_kerr(1.0, KERR_A, device=DEVICE),
                                  cam, bright, **kw)

        def metric_of_leaves():
            m = torch.tensor(1.0, device=DEVICE, requires_grad=True)
            a = torch.tensor(KERR_A, device=DEVICE, requires_grad=True)
            return KerrMetric(m, a, device=DEVICE), (m, a)

        def step():
            metric, params = metric_of_leaves()
            img = rk.render_kerr(metric, cam, bright, backend="adjoint", **kw)
            return img, torch.mean((img - target) ** 2), params

        reset()
        img, loss, params = step()
        g_m, g_a = torch.autograd.grad(loss, params)
        launched = counts()
        # the non-differentiable render on the same inputs: a metric whose
        # parameters require grad, so that the spawn records the same graph
        # (under torch.no_grad() its f32 results can differ by an ulp, and
        # a knife-edge ray then takes another fate)
        ref = rk.render_kerr(metric_of_leaves()[0], cam, bright, **kw)
        diff = float((img.detach() - ref.detach()).abs().max())
        d0 = (img.detach() - ref0).abs().amax(-1)
        print(f"[24] {family} adjoint step at {res}: loss "
              f"{float(loss):.9e}, d loss / d M {float(g_m):.9e}, d loss / "
              f"d a {float(g_a):.9e}; launches {launched}; image vs the "
              f"non-differentiable render: max |d| {diff:.3e} (vs that "
              f"render under torch.no_grad(): {int((d0 > 0).sum())} pixels "
              f"differ, max |d| {float(d0.max()):.3e})")
        pair = ("kerr_rk45_gen", "kerr_rk45_bwd") if family == "rk45" else (
            "kerr_gen", "kerr_bwd")
        fwd_key = "k8" if family == "rk45" else "k7"
        require(diff == 0.0, f"{family} adjoint image differs by {diff}")
        require(launched[fwd_key] == 1 and launched[pair[0]] == 1
                and launched[pair[1]] == 1 and launched["other"] == 0
                and launched["k7" if family == "rk45" else "k8"] == 0,
                f"{family} adjoint launches {launched}")
        require(all(math.isfinite(float(v)) and float(v) != 0.0
                    for v in (g_m, g_a)), f"{family} gradient {g_m} {g_a}")
        for k_ in total:
            total[k_] += launched.get(k_, 0)
        # the step's time split (CUDA events, median of 3), and the pair
        # alone on the step's rays
        fwd_t, bwd_t = [], []
        for _ in range(3):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            _, loss, params = step()
            e[1].record()
            torch.autograd.grad(loss, params)
            e[2].record()
            e[2].synchronize()
            fwd_t.append(e[0].elapsed_time(e[1]))
            bwd_t.append(e[1].elapsed_time(e[2]))
        kerr = make_kerr(1.0, KERR_A, device=DEVICE)
        x0, p0, _ = rk._spawn_kerr_rays(kerr, cam)
        ins = [t.contiguous() for t in (x0[:, 1], x0[:, 2], x0[:, 3],
                                        p0[:, 1], p0[:, 2], -p0[:, 0],
                                        p0[:, 3])]
        R = 2.0 * KERR_L
        if family == "rk4":
            scal = kerr_cuda.kerr_scalars(kerr, KERR_DT, R, axis_u0=0.01,
                                          far_r0=8.0)
            run = lambda: kerr_cuda.launch(                 # noqa: E731
                (False,) * 5, scal, *ins, max_steps=KERR_STEPS)
            fwd = run()
            cnt = torch.where(fwd[5] <= 1, fwd[6], torch.zeros_like(fwd[6]))
        else:
            scal = kerr_rk45_cuda.kerr_rk45_scalars(
                kerr, KERR_DT, R, rtol=KERR_RTOL, atol=KERR_RTOL * 1e-3,
                dt_min=1e-5, dt_max=R / 8.0)
            run = lambda: kerr_rk45_cuda.launch(            # noqa: E731
                (False,) * 5, scal, *ins, max_steps=KERR_STEPS,
                max_iters=2 * KERR_STEPS)
            fwd = run()
            cnt = torch.where(fwd[5] <= 1, fwd[-1],
                              torch.zeros_like(fwd[-1]))
        seg = KERR_SEG[family]
        off, tot = ck.segment_offsets(cnt, seg)
        ns = ck.N_STATE[family]
        ckpt, _ = ck.launch_gen(family, scal, ins[:5], ins[5], ins[6], cnt,
                                seg=seg, offsets=off, total=tot)
        cot = torch.ones((ns, cnt.numel()), device=DEVICE)
        fwd_ms = cuda_ms(run, 3)
        gen_ms = cuda_ms(lambda: ck.launch_gen(
            family, scal, ins[:5], ins[5], ins[6], cnt, seg=seg, offsets=off,
            total=tot), 3)
        bwd_ms = cuda_ms(lambda: ck.launch_bwd(
            family, scal, ckpt, ins[5], ins[6], cnt, cot, seg=seg,
            offsets=off), 3)
        print(f"[24]   step (median of 3, CUDA events): forward "
              f"{statistics.median(fwd_t):.2f} ms + backward "
              f"{statistics.median(bwd_t):.2f} ms; "
              f"{'#8' if family == 'rk45' else '#7'} alone {fwd_ms:.2f} ms, "
              f"gen {gen_ms:.2f} ms, bwd {bwd_ms:.2f} ms; replayed "
              f"{'iterations' if family == 'rk45' else 'steps'} mean / max "
              f"{cnt.double().mean().item():.1f} / {int(cnt.max())}, "
              f"checkpoint buffer {tot * ns * 4 / 2**20:.1f} MiB")
        del ckpt
        # d / d(M, a) of the kernel pair against the plain pair at
        # GRAD_RES^2 (the RK4 march capped at KERR_CKPT_CAP steps)
        small = kerr_camera((GRAD_RES, GRAD_RES))
        with torch.no_grad():
            tgt = rk.render_kerr(make_kerr(1.0, 0.85, device=DEVICE), small,
                                 bright, **kw)
        tgt = tgt.permute(1, 0, 2).reshape(-1, 3)

        def plain(fam, scal_, y0, E, L, cnt_, cot_):
            sg = KERR_SEG[fam]
            off_, tot_ = ck.segment_offsets(cnt_, sg)
            ckp, _ = ck.ckpt_kerr_gen_plain(fam, scal_, y0, E, L, cnt_,
                                            seg=sg, offsets=off_,
                                            total=tot_)
            return ck.ckpt_kerr_bwd_plain(fam, scal_, ckp, E, L, cnt_, cot_,
                                          seg=sg, offsets=off_)

        def mk(m, a):
            return KerrMetric(m, a, device=DEVICE)

        g_k = kerr_grad_by_hand(family, mk, small, bright, tgt,
                                KERR_CKPT_CAP, lambda *a_: ck.
                                ckpt_kerr_backward_cuda(*a_))
        g_p = kerr_grad_by_hand(family, mk, small, bright, tgt,
                                KERR_CKPT_CAP, plain)
        for name, k_, p_ in (("M", g_k[0], g_p[0]), ("a", g_k[1], g_p[1])):
            rel = abs(k_ - p_) / abs(p_)
            print(f"[24]   d loss / d {name} at {GRAD_RES}^2: kernel pair "
                  f"{k_:.9e}, plain pair {p_:.9e}; rel {rel:.3e} (bound "
                  f"{GRAD_RTOL})")
            require(rel <= GRAD_RTOL, f"{family} d/d{name} kernel vs plain: "
                    f"{k_} vs {p_}")
    # the spin-recovery view: d mean(image) / da against a central
    # difference over a smooth sky, the pixel channels in the linear regime
    sm = smooth_sky()
    scam = spin_camera(KERR_RES)
    skw = dict(dt=KERR_DT, max_steps=800, escape_radius=20.0)
    h = SPIN_FD_H
    ims = []
    for s_ in (1.0, -1.0):
        with torch.no_grad():
            ims.append(rk.render_kerr(make_kerr(1.0, 0.7 + s_ * h,
                                                device=DEVICE),
                                      scam, sm, **skw).double())
    reset()
    a = torch.tensor(0.7, device=DEVICE, requires_grad=True)
    img = rk.render_kerr(KerrMetric(torch.tensor(1.0, device=DEVICE), a,
                                    device=DEVICE), scam, sm,
                         backend="adjoint", **skw)
    curv = (ims[0] - 2.0 * img.detach().double() + ims[1]).abs()
    linear = (curv <= SURF_FD_LIN * (ims[0] - ims[1]).abs() + 1e-6).double()
    fd = ((ims[0] - ims[1]) * linear).mean().item() / (2 * h)
    (g,) = torch.autograd.grad((img.double() * linear).mean(), a)
    launched = counts()
    for k_ in total:
        total[k_] += launched.get(k_, 0)
    rel = abs(float(g) - fd) / max(abs(fd), 1e-300)
    kept = linear.mean().item()
    dark = (img.detach().sum(-1) == 0).double().mean().item()
    print(f"[24] spin-recovery view {res} (shadow pixels {dark:.4f}): d "
          f"mean(image) / d a adjoint {float(g):.9e}, central difference "
          f"(h = {h}) {fd:.9e}, rel {rel:.3e} (bound {SPIN_FD_TOL}); "
          f"{kept:.6f} of pixel channels in the linear regime (bound >= "
          f"{SURF_FD_KEEP})")
    require(rel <= SPIN_FD_TOL, f"spin d/da {float(g)} vs {fd}")
    require(kept >= SURF_FD_KEEP, f"spin d/da: kept only {kept}")
    # a few descent steps on a, from a = 0.6 towards 0.85 (the example's
    # update: a -= clip(gain * g, -cap, cap))
    D = SPIN_DESCENT
    with torch.no_grad():
        target = rk.render_kerr(make_kerr(1.0, D["target"], device=DEVICE),
                                scam, sm, **skw)
    a_val, hist = D["start"], []
    reset()
    for _ in range(D["steps"] + 1):
        a = torch.tensor(a_val, device=DEVICE, requires_grad=True)
        img = rk.render_kerr(KerrMetric(torch.tensor(1.0, device=DEVICE), a,
                                        device=DEVICE), scam, sm,
                             backend="adjoint", **skw)
        loss = torch.mean((img - target) ** 2)
        (g,) = torch.autograd.grad(loss, a)
        hist.append((a_val, float(loss)))
        a_val = a_val - max(-D["cap"], min(D["cap"], D["gain"] * float(g)))
    launched = counts()
    for k_ in total:
        total[k_] += launched.get(k_, 0)
    print(f"[24]   descent on a (target {D['target']}): "
          + ", ".join(f"a {a_:.5f} loss {l_:.6e}" for a_, l_ in hist)
          + f"; launches {launched}")
    losses = [l_ for _, l_ in hist]
    require(all(b < a_ for a_, b in zip(losses, losses[1:])),
            f"spin descent: the loss did not fall every step: {losses}")
    # backend='scan' on the card, each stepper, against the adjoint on the
    # spin-recovery view at GRAD_RES^2: the same image and d mean / da, and
    # no kernel launched by the scan
    gcam = spin_camera((GRAD_RES, GRAD_RES))
    for family, kw in (("rk4", {}), ("rk45", dict(stepper="rk45",
                                                  rtol=KERR_RTOL))):
        got = {}
        for be in ("adjoint", "scan"):
            a = torch.tensor(0.7, device=DEVICE, requires_grad=True)
            metric = KerrMetric(torch.tensor(1.0, device=DEVICE), a,
                                device=DEVICE)
            reset()
            sync()
            t0 = time.perf_counter()
            img = rk.render_kerr(metric, gcam, sm, backend=be, **skw, **kw)
            (g,) = torch.autograd.grad(img.double().mean(), a)
            sync()
            got[be] = (img.detach().double(), float(g), counts(),
                       time.perf_counter() - t0)
        (ia, ga, la, ta), (i_s, gs, ls, ts) = got["adjoint"], got["scan"]
        d = (i_s - ia).abs()
        frac = (d <= SCAN_IMG_TOL).double().mean().item()
        rel = abs(gs - ga) / max(abs(ga), 1e-300)
        print(f"[24] {family} scan vs adjoint, spin view {GRAD_RES}^2: "
              f"image max |d| {float(d.max()):.3e}, {frac:.6f} of channels "
              f"within {SCAN_IMG_TOL} (bound >= {SCAN_IMG_FRAC}); d mean / "
              f"d a scan {gs:.9e}, adjoint {ga:.9e}, rel {rel:.3e} (bound "
              f"{SCAN_GRAD_RTOL[family]}); scan {ts:.2f} s, adjoint "
              f"{ta:.2f} s (host clock, step with its first calls); "
              f"launches scan {ls}, adjoint {la}")
        require(bool(torch.isfinite(i_s).all()) and math.isfinite(gs)
                and gs != 0.0, f"{family} scan: image or d/da {gs}")
        require(frac >= SCAN_IMG_FRAC, f"{family} scan image vs adjoint: "
                f"{frac} within {SCAN_IMG_TOL}")
        require(rel <= SCAN_GRAD_RTOL[family], f"{family} scan d/da {gs} "
                f"vs adjoint {ga}")
        require(not any(ls.values()), f"{family} scan launched {ls}")
        for k_ in total:
            total[k_] += la.get(k_, 0)
    print(f"[24] launches of the Kerr checkpoint kernels over the paths: "
          f"{total}; {time.perf_counter() - t_start:.1f} s")
    return total


def kerr_surf_flops(family, flags, counts, accepted=None):
    """FP32 operations of gen (one march) and bwd (its re-march once and the
    VJP) of a Kerr surface family over ``counts`` steps (RK4) or
    iterations (DP5(4), of which ``accepted`` were accepted)."""
    mflags = (flags is None, flags is not None) + (flags or (False,) * 3)
    F = FLOP_KERR_SURF_VJP
    vjp = F["hit"] if flags is None else (
        F["vol"] + (F["beaming"] if flags[1] else 0)
        + F["blackbody" if flags[0] else "tint"]
        + (F["scatter"] if flags[2] else 0))
    if family == "rk4":
        gen = kerr_flops(mflags) * counts
        return gen, gen + (FLOP_KERR_VJP + vjp) * counts
    gen = kerr_rk45_flops(mflags, counts, accepted)
    clamp = F["clamp"] if flags is not None else 0
    return gen, gen + (FLOP_KERR_RK45_VJP + clamp) * counts + vjp * accepted


def kerr_surface_vs_plain(label, family, flags, scal, ins, fwd, seed,
                          freeze=False):
    """Kernels #9 / #10's Kerr surface family (``family`` 'rk4' or 'rk45',
    ``flags`` None for the thin disk, else the gas's (blackbody, beaming,
    scatter)) against their plain versions on the forward kernel's outputs
    ``fwd`` (#7's or #8's surface variant) for the rays ``ins`` (r, theta,
    phi, p_r, p_theta, E, L): gen's final state (the five, then the hits or
    tau and emission) bit for bit against the forward kernel on every ray,
    then the checkpoints, lam and g_theta with the Function's fate policy
    (state cotangents for signs 0 and 1, the surface's for every sign but
    3)."""
    import numpy as np
    import torch
    from curvis_tpu_torch.ops import ckpt_kerr_surface_cuda as cks
    seg = cks.SEG[family]
    y0, E, L = ins[:5], ins[5], ins[6]
    sign = fwd[5]
    full = fwd[-1] if family == "rk45" else fwd[6]
    n = E.numel()
    ns, nt = cks.n_state(family, flags), cks.n_theta(flags)
    lead = 5 + (family == "rk45") + (flags is None)   # the surface's rows
    n_ex = ns - lead

    def gen(cnt, off, tot):
        return cks.launch_gen(family, flags, scal, y0, E, L, cnt, seg=seg,
                              offsets=off, total=tot)

    def bwd(ckpt, cnt, cot, off):
        return cks.launch_bwd(family, flags, scal, ckpt, E, L, cnt, cot,
                              seg=seg, offsets=off, freeze=freeze)

    # gen replays every ray's steps: its final state is the forward's
    off_all, tot_all = cks.segment_offsets(full, seg)
    _, fin = gen(full, off_all, tot_all)
    ne = torch.zeros(n, dtype=torch.bool, device=E.device)
    for c in range(5):
        ne |= bits_differ(fin[c], fwd[c])
    for k in range(n_ex):
        ne |= bits_differ(fin[lead + k], fwd[7 + k])
    fin_ne = int(ne.sum())
    # the Function's fate policy
    smooth = (sign == 0) | (sign == 1)
    replay = sign != 3
    counts = torch.where(replay, full, torch.zeros_like(full))
    cot = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (ns, n)).astype(np.float32)).to(DEVICE)
    cot[:5] = torch.where(smooth, cot[:5], torch.zeros_like(cot[:5]))
    cot[5:lead] = 0.0                       # dt and ct_prev: no cotangent
    cot[lead:] = torch.where(replay, cot[lead:], torch.zeros_like(cot[lead:]))
    cot = cot.contiguous()
    off, total = cks.segment_offsets(counts, seg)
    ck_k, _ = gen(counts, off, total)
    g_k, lam_k = bwd(ck_k, counts, cot, off)
    sync()
    t0 = time.perf_counter()
    ck_p, _ = cks.ckpt_kerr_surface_gen_plain(family, flags, scal, y0, E, L,
                                              counts, seg=seg, offsets=off,
                                              total=total)
    sync()
    t1 = time.perf_counter()
    g_p, lam_p = cks.ckpt_kerr_surface_bwd_plain(
        family, flags, scal, ck_p, E, L, counts, cot, seg=seg, offsets=off,
        freeze=freeze)
    sync()
    gen_plain_ms = 1e3 * (t1 - t0)
    bwd_plain_ms = 1e3 * (time.perf_counter() - t1)
    gen_ms = cuda_ms(lambda: gen(counts, off, total), 3)
    bwd_ms = cuda_ms(lambda: bwd(ck_k, counts, cot, off), 3)
    ck_ne = int((ck_k[:total] != ck_p).any(dim=1).sum()) if total else 0
    ck_err = float((ck_k[:total] - ck_p).abs().max()) if total else 0.0
    lam_frac, lam_err = entry_fraction(lam_k, lam_p)
    g_rows = [r for r in range(nt) if bool((g_p[r] != 0).any())]
    g_frac, g_err = entry_fraction(g_k[g_rows], g_p[g_rows])
    sums = []
    for r in [0, 1, 2] + list(range(5, nt)):
        sk, sp = g_k[r].double().sum().item(), g_p[r].double().sum().item()
        if sp != 0.0 or sk != 0.0:
            sums.append((r, sk, sp, abs(sk - sp) / max(abs(sp), 1e-300)))
    tot_steps = counts.double().sum().item()
    accepted = torch.where(replay, fwd[6], torch.zeros_like(fwd[6]))
    acc_steps = accepted.double().sum().item()
    segs = (-(-counts.long() // seg)).double().sum().item()
    signs = {s_: int((sign == s_).sum()) for s_ in range(4)}
    what = "iterations" if family == "rk45" else "steps"
    print(f"[25] {label}{' (freeze)' if freeze else ''}: {n} rays, signs "
          f"{signs}, replayed {what} mean / max {tot_steps / n:.1f} / "
          f"{int(counts.max())}, {total} checkpoint rows "
          f"({total * ns * 4 / 2**20:.1f} MiB)")
    print(f"[25]   gen's final state (every ray, its full {what}) == the "
          f"forward kernel's: {fin_ne} of {n} rays differ in a bit (bound "
          f"0); checkpoints == plain gen's on {total - ck_ne} of {total} "
          f"rows, max |d| {ck_err:.3e}")
    print(f"[25]   within rtol {GRAD_RTOL}: lam {lam_frac:.6f}, g_theta "
          f"{g_frac:.6f} of entries (bound >= {RK45_GRAD_FRAC_MIN}); max "
          f"|d| lam {lam_err:.3e}, g {g_err:.3e}")
    worst = max(sums, key=lambda t: t[3]) if sums else None
    if worst is not None:
        print(f"[25]   ray sums of {len(sums)} g_theta rows: worst row "
              f"{worst[0]}: kernel {worst[1]:.9e}, plain {worst[2]:.9e}, "
              f"rel {worst[3]:.3e} (bound {GRAD_RTOL})")
    print(f"[25]   gen {gen_ms:.3f} ms (plain {gen_plain_ms:.1f} ms), bwd "
          f"{bwd_ms:.3f} ms (plain {bwd_plain_ms:.1f} ms)")
    require(fin_ne == 0, f"kerr surface ckpt {label}: gen's final state "
            f"differs from the forward kernel on {fin_ne} rays")
    require(ck_ne == 0, f"kerr surface ckpt {label}: {ck_ne} checkpoint "
            f"rows differ from the plain gen's")
    require(lam_frac >= RK45_GRAD_FRAC_MIN,
            f"kerr surface ckpt {label}: lam {lam_frac}")
    require(g_frac >= RK45_GRAD_FRAC_MIN,
            f"kerr surface ckpt {label}: g {g_frac}")
    for r, sk, sp, rel in sums:
        require(rel <= GRAD_RTOL, f"kerr surface ckpt {label}: sum "
                f"g_theta[{r}] {sk} vs {sp}")
    require(all(bool(torch.isfinite(t).all()) for t in (lam_k, g_k)),
            f"kerr surface ckpt {label}: non-finite output")
    gen_f, bwd_f = kerr_surf_flops(family, flags, tot_steps, acc_steps)
    # gen reads 7 floats, the count and the offset a ray and writes ns
    # floats a segment and the final state; bwd reads the segments, E, L,
    # the count, the offset and the cotangent, and writes lam and g
    gen_b = bound(40 * n + 4 * ns * (segs + n), gen_f)
    bwd_b = bound(4 * ns * segs + 20 * n + 4 * (2 * ns + nt) * n, bwd_f)
    print(f"[25]   bound gen {gen_b[0]:.3f} ms ({gen_b[1]}), bwd "
          f"{bwd_b[0]:.3f} ms ({bwd_b[1]})")
    return dict(gen=dict(max_abs_err=ck_err, ms=gen_ms,
                         plain_ms=gen_plain_ms, bound_ms=gen_b[0],
                         bound_by=gen_b[1]),
                bwd=dict(max_abs_err=max(lam_err, g_err), ms=bwd_ms,
                         plain_ms=bwd_plain_ms, bound_ms=bwd_b[0],
                         bound_by=bwd_b[1]),
                lam=lam_k, g=g_k, sign=sign)


def kerr_surface_disks():
    """The thin disk and the gas of the Kerr path (phase 14), and the gas
    with a tint and no beaming."""
    import dataclasses
    from curvis_tpu_torch.render.disk import DiskParams
    band = dict(r_inner=KERR_BAND[0], r_outer=KERR_BAND[1])
    thin = DiskParams(**band, doppler=True, color_mode="blackbody",
                      t_peak=7000.0, brightness=14.0)
    gas = DiskParams(**band, volumetric=True, h_rel=0.07, kappa=3.0,
                     doppler=True, color_mode="blackbody", t_peak=6500.0,
                     brightness=14.0)
    tint = dataclasses.replace(gas, color_mode="tint", redshift=False,
                               doppler=False, brightness=3.0)
    return thin, gas, tint


def phase25_kerr_surface_ckpt():
    """Kernels #9 / #10's Kerr surface families (csrc/ckpt_kerr_surface.cu,
    csrc/ckpt_kerr_surface_rk45.cu) against their plain versions on the
    inputs of phase 26's paths: the thin disk on the path's 960 x 540 view
    (RK4, and DP5(4) at rtol 1e-4) capped at KERR_SURF_CAP; the gas on its
    960 x 540 view (tint, blackbody + beaming, and blackbody + beaming + a
    seeded scatter block; DP5(4) frozen once) capped at KERR_SURF_GAS; and
    16 NaN rays (sign 3, zero lam and g_theta) in the thin disk at
    GRAD_RES^2.  The kernels line takes each family's thin case."""
    import numpy as np
    import torch
    from curvis_tpu_torch.metrics.kerr import make_kerr
    from curvis_tpu_torch.ops import kerr_cuda as kc
    from curvis_tpu_torch.ops import kerr_rk45_cuda as k45
    from curvis_tpu_torch.render import kerr as rk
    t_start = time.perf_counter()
    kerr = make_kerr(1.0, KERR_A, device=DEVICE)
    thin, gas, tint = kerr_surface_disks()
    V = KERR_VOL
    block = torch.from_numpy(KERR_SURF_BLOCK * np.random.default_rng(
        25).random(27).astype(np.float32))
    far = KERR_BAND[1] + 2.0
    res = f"{KERR_RES[0]}x{KERR_RES[1]}"
    G = GRAD_RES
    cam = kerr_camera(KERR_RES)
    vcam = kerr_camera(KERR_RES, V["l"], V["focal"])
    tsmall = kerr_camera((G, G))
    thin_kw = (KERR_DT, 2.0 * KERR_L)
    gas_kw = (V["dt"], V["R"])
    # name, family, disk, scatter, camera, dt, R, cap, NaN rays, freeze
    C, S, N = KERR_SURF_CAP, KERR_SURF_GAS, KERR_SURF_NAN
    cases = [
        (f"rk4 thin {res}", "rk4", thin, False, cam, *thin_kw, C["rk4"], 0,
         False),
        (f"rk4 gas tint {res}", "rk4", tint, False, vcam, *gas_kw,
         S["rk4"], 0, False),
        (f"rk4 gas blackbody + beaming {res}", "rk4", gas, False, vcam,
         *gas_kw, S["rk4"], 0, False),
        (f"rk4 gas blackbody + beaming + scatter {res}", "rk4", gas, True,
         vcam, *gas_kw, S["rk4"], 0, False),
        (f"rk4 thin {G}^2 with {N_POISON} NaN rays", "rk4", thin, False,
         tsmall, *thin_kw, N["rk4"], N_POISON, False),
        (f"rk45 thin {res}", "rk45", thin, False, cam, *thin_kw, C["rk45"],
         0, False),
        (f"rk45 gas tint {res}", "rk45", tint, False, vcam, *gas_kw,
         S["rk45"], 0, False),
        (f"rk45 gas blackbody + beaming {res}", "rk45", gas, False, vcam,
         *gas_kw, S["rk45"], 0, True),
        (f"rk45 gas blackbody + beaming + scatter {res}", "rk45", gas, True,
         vcam, *gas_kw, S["rk45"], 0, False),
        (f"rk45 thin {G}^2 with {N_POISON} NaN rays", "rk45", thin, False,
         tsmall, *thin_kw, N["rk45"], N_POISON, True),
    ]
    out = {}
    for k, (label, family, disk, sc, cam, dt, R, cap, n_nan,
            freeze) in enumerate(cases):
        x0, p0, _ = rk._spawn_kerr_rays(kerr, cam)
        ins = [t.contiguous() for t in (x0[:, 1], x0[:, 2], x0[:, 3],
                                        p0[:, 1], p0[:, 2], -p0[:, 0],
                                        p0[:, 3])]
        ins[0], bad = poison_rays(ins[0], n_nan)
        vol = disk.volumetric
        flags = ((disk.color_mode == "blackbody",
                  bool(disk.redshift or disk.doppler), sc) if vol else None)
        mflags = (not vol, vol) + (flags or (False,) * 3)
        surf = (dict(vol_disk=disk, scatter_block=block if sc else None)
                if vol else dict(disk=KERR_BAND))
        if family == "rk4":
            scal = kc.kerr_scalars(kerr, dt, R, axis_u0=0.01, far_r0=far,
                                   **surf)
            fwd = kc.launch(mflags, scal, *ins, max_steps=cap)
        else:
            scal = k45.kerr_rk45_scalars(kerr, dt, R, rtol=KERR_RTOL,
                                         atol=KERR_RTOL * 1e-3, dt_min=1e-5,
                                         dt_max=R / 8.0, **surf)
            fwd = k45.launch(mflags, scal, *ins, max_steps=KERR_STEPS,
                             max_iters=cap)
        if vol:
            lit = float((fwd[8] > 0).double().mean())
            print(f"[25] {label}: emission on {lit:.4f} of rays")
            require(lit > 0.05, f"{label}: no gas on the view")
        elif not n_nan:
            hits = int((fwd[7] != 0).sum())
            print(f"[25] {label}: {hits} rays hit the band")
            require(hits > 0, f"{label}: no hit")
        nums = kerr_surface_vs_plain(label, family, flags, scal, ins, fwd,
                                     seed=250 + k, freeze=freeze)
        if n_nan:
            lam_bad, g_bad = nums["lam"][:, bad], nums["g"][:, bad]
            print(f"[25]   NaN rays: signs {nums['sign'][bad].tolist()}, "
                  f"max |lam| {float(lam_bad.abs().max()):.1e}, max |g| "
                  f"{float(g_bad.abs().max()):.1e}")
            require(bool((nums["sign"][bad] == 3).all())
                    and bool((lam_bad == 0).all())
                    and bool((g_bad == 0).all()),
                    f"{label}: NaN rays not frozen with zero lam and g")
        out.setdefault(family, nums)
    print(f"[25] {time.perf_counter() - t_start:.1f} s")
    return out["rk4"], out["rk45"]


def kerr_surface_render(disk, cam, bg, a, theta, kw, backend="adjoint"):
    """render_kerr on a metric with leaf tensors (m = 1, a) and disk_theta
    leaves ``theta`` (floats) -> (image, [m, a, *theta leaves])."""
    import torch
    from curvis_tpu_torch.metrics.kerr import KerrMetric
    from curvis_tpu_torch.render import kerr as rk
    m_ = torch.tensor(1.0, device=DEVICE, requires_grad=True)
    a_ = torch.tensor(a, device=DEVICE, requires_grad=True)
    params = {k: torch.tensor(v, device=DEVICE, requires_grad=True)
              for k, v in theta.items()}
    img = rk.render_kerr(KerrMetric(m_, a_, device=DEVICE), cam, bg,
                         disk=disk, backend=backend, disk_theta=params, **kw)
    return img, [m_, a_, *params.values()]


def phase26_kerr_surface_paths(sky):
    """The Kerr surface gradients at full width: one render_kerr(disk=...,
    backend='adjoint', disk_theta=...) loss-and-gradient step at 960 x 540
    on the path's thin disk and gas views, RK4 and rk45, each image equal
    to the backend='auto' render, #7 or #8 and the family's pair launched
    once (no other kernel), the time split and the checkpoint buffer; d /
    da on each of the four views, d / dr_in (thin) and d / dkappa (gas)
    against central differences over the pixel channels in the linear
    regime; two descent steps on the
    view of examples/disk_image_recovery.py with the loss falling; and
    backend='scan' against 'adjoint' at KERR_SCAN_RES^2 on the gas, each
    stepper (no kernel launched by the scan).  Returns the launches of the
    Kerr surface checkpoint kernels."""
    import dataclasses
    import numpy as np
    import torch
    from curvis_tpu_torch.env.spherical_image import make_spherical_image
    from curvis_tpu_torch.metrics.kerr import make_kerr
    from curvis_tpu_torch.ops import (ckpt_adjoint_cuda, ckpt_kerr_cuda,
                                      ckpt_rk45_cuda, ckpt_surface_cuda,
                                      disk_cuda, disk_vol_cuda, kerr_cuda,
                                      kerr_rk45_cuda, march_cuda, rk45_cuda,
                                      rk45_disk_cuda)
    from curvis_tpu_torch.ops import ckpt_kerr_surface_cuda as cks
    from curvis_tpu_torch.render import kerr as rk
    from curvis_tpu_torch.render.disk import DiskParams
    t_start = time.perf_counter()
    others = (march_cuda, rk45_cuda, rk45_disk_cuda, disk_cuda,
              disk_vol_cuda)
    dicts = (ckpt_adjoint_cuda.launches, ckpt_rk45_cuda.launches,
             ckpt_surface_cuda.launches, ckpt_kerr_cuda.launches)

    def reset():
        for mod in (*others, kerr_cuda, kerr_rk45_cuda):
            mod.launches = 0
        for d in (*dicts, cks.launches):
            for k_ in d:
                d[k_] = 0

    def counts():
        return dict(k7=kerr_cuda.launches, k8=kerr_rk45_cuda.launches,
                    **cks.launches,
                    other=sum(mod.launches for mod in others)
                    + sum(sum(d.values()) for d in dicts))

    total = {k_: 0 for k_ in cks.launches}
    black = make_spherical_image(np.zeros(SKY, np.float32), device=DEVICE)
    white = make_spherical_image(np.ones(SKY, np.float32), device=DEVICE)
    thin, gas, _ = kerr_surface_disks()
    V = KERR_VOL
    cam = kerr_camera(KERR_RES)
    vcam = kerr_camera(KERR_RES, V["l"], V["focal"])
    res = f"{KERR_RES[0]}x{KERR_RES[1]}"
    kw = dict(dt=KERR_DT, max_steps=KERR_STEPS)
    vkw = dict(dt=V["dt"], max_steps=V["steps"], escape_radius=V["R"])
    r45 = dict(stepper="rk45", rtol=KERR_RTOL)
    # name, disk, camera, keywords, the disk_theta knobs (with their
    # values), the knobs held against central differences
    views = [
        ("rk4 thin", thin, cam, kw, dict(brightness=14.0, r_inner=2.6),
         ("a", "r_inner")),
        ("rk4 gas", gas, vcam, vkw, dict(kappa=3.0), ("a", "kappa")),
        ("rk45 thin", thin, cam, dict(kw, **r45),
         dict(brightness=14.0, r_inner=2.6), ("a", "r_inner")),
        ("rk45 gas", gas, vcam, dict(vkw, **r45), dict(kappa=3.0),
         ("a", "kappa")),
    ]
    for name, disk, cm, k_w, theta, fd_keys in views:
        family = "rk45" if "rk45" in name else "rk4"
        fwd_key = "k8" if family == "rk45" else "k7"
        pair = (("kerr_surface_rk45_gen", "kerr_surface_rk45_bwd")
                if family == "rk45" else ("kerr_surface_gen",
                                          "kerr_surface_bwd"))
        with torch.no_grad():
            target = rk.render_kerr(make_kerr(1.0, 0.85, device=DEVICE), cm,
                                    sky, disk=disk, **k_w)

        def step():
            img, leaves = kerr_surface_render(disk, cm, sky, KERR_A, theta,
                                              k_w)
            return img, torch.mean((img - target) ** 2), leaves

        reset()
        img, loss, leaves = step()
        grads = torch.autograd.grad(loss, leaves)
        launched = counts()
        ref, _ = kerr_surface_render(disk, cm, sky, KERR_A, theta, k_w,
                                     backend="auto")
        diff = float((img.detach() - ref.detach()).abs().max())
        lit = float((img.detach().sum(-1) > 0).double().mean())
        print(f"[26] {name} adjoint step at {res}: loss {loss.item():.9e}, "
              + ", ".join(f"d/d{k_} {float(g):.6e}" for k_, g in zip(
                  ["m", "a", *theta], grads))
              + f"; launches {launched}; image vs the backend='auto' "
              f"render: max |d| {diff:.3e}; lit pixels {lit:.4f}")
        require(diff == 0.0, f"{name} adjoint image differs by {diff}")
        require(launched[fwd_key] == 1 and launched[pair[0]] == 1
                and launched[pair[1]] == 1 and launched["other"] == 0
                and launched["k7" if family == "rk45" else "k8"] == 0
                and sum(launched[k_] for k_ in cks.launches) == 2,
                f"{name} adjoint launches {launched}")
        require(all(math.isfinite(float(g)) for g in grads)
                and float(grads[1]) != 0.0, f"{name} gradient {grads}")
        for k_ in total:
            total[k_] += launched.get(k_, 0)
        # the step's time split (CUDA events, median of 3)
        fwd_t, bwd_t = [], []
        for _ in range(3):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            _, loss, leaves = step()
            e[1].record()
            torch.autograd.grad(loss, leaves)
            e[2].record()
            e[2].synchronize()
            fwd_t.append(e[0].elapsed_time(e[1]))
            bwd_t.append(e[1].elapsed_time(e[2]))
        # the pair alone on the step's rays: gen and bwd by the launches'
        # own timing, the checkpoint buffer from the replay counts
        stats = {}
        real_gen, real_bwd = cks.launch_gen, cks.launch_bwd

        def timed_gen(*a, **k):
            out = real_gen(*a, **k)
            stats["gen"] = (a, k)
            stats["rows"] = k["total"]
            return out

        def timed_bwd(*a, **k):
            out = real_bwd(*a, **k)
            stats["bwd"] = (a, k)
            return out

        cks.launch_gen, cks.launch_bwd = timed_gen, timed_bwd
        try:
            _, loss, leaves = step()
            torch.autograd.grad(loss, leaves)
        finally:
            cks.launch_gen, cks.launch_bwd = real_gen, real_bwd
        ga, gk = stats["gen"]
        ba, bk = stats["bwd"]
        gen_ms = cuda_ms(lambda: real_gen(*ga, **gk), 3)
        bwd_ms = cuda_ms(lambda: real_bwd(*ba, **bk), 3)
        ns = cks.n_state(family, None if not disk.volumetric else (0, 0, 0))
        cnt = ga[6]
        print(f"[26]   step (median of 3, CUDA events): forward "
              f"{statistics.median(fwd_t):.2f} ms + backward "
              f"{statistics.median(bwd_t):.2f} ms; gen {gen_ms:.2f} ms, bwd "
              f"{bwd_ms:.2f} ms; replayed "
              f"{'iterations' if family == 'rk45' else 'steps'} mean / max "
              f"{cnt.double().mean().item():.1f} / {int(cnt.max())}, "
              f"checkpoint buffer {stats['rows'] * ns * 4 / 2**20:.1f} MiB")
        # central differences over a black sky (the disk's light alone),
        # over the pixel channels in the linear regime outside the shadow
        # grown by KERR_FD_RING (a captured ray's last step, across the
        # horizon, is wild, and a hit recorded on it moves by orders of
        # magnitude more than the central difference resolves; so do the
        # hits of rays that skim the photon sphere)
        with torch.no_grad():
            shadow = rk.render_kerr(make_kerr(1.0, KERR_A, device=DEVICE),
                                    cm, white, **k_w).sum(-1) == 0
            D = max(1, round(KERR_FD_RING * shadow.shape[1]))
            shadow = torch.nn.functional.max_pool2d(
                shadow.double()[None, None], 2 * D + 1, stride=1,
                padding=D)[0, 0] > 0
        outside = (~shadow).double()[..., None]
        for key in fd_keys:
            v0 = KERR_A if key == "a" else theta[key]
            h = KERR_SURF_FD[key] * v0
            ims = []
            for s_ in (1.0, -1.0):
                th_, d_, a_ = dict(theta), disk, KERR_A
                if key == "a":
                    a_ = KERR_A + s_ * h
                elif family == "rk45" and disk.volumetric:
                    # this route marches the static disk (module docstring
                    # of render/kerr.py): move the knob there
                    d_ = dataclasses.replace(disk, **{key: v0 + s_ * h})
                else:
                    th_[key] = v0 + s_ * h
                with torch.no_grad():
                    im, _ = kerr_surface_render(d_, cm, black, a_, th_, k_w,
                                                backend="auto")
                ims.append(im.double())
            reset()
            img, leaves = kerr_surface_render(disk, cm, black, KERR_A, theta,
                                              k_w)
            curv = (ims[0] - 2.0 * img.detach().double() + ims[1]).abs()
            linear = (curv <= SURF_FD_LIN * (ims[0] - ims[1]).abs()
                      + 1e-6).double() * outside
            fd = ((ims[0] - ims[1]) * linear).mean().item() / (2 * h)
            idx = 1 if key == "a" else 2 + list(theta).index(key)
            g = torch.autograd.grad((img.double() * linear).mean(),
                                    leaves[idx])[0]
            for k_, v in counts().items():
                if k_ in total:
                    total[k_] += v
            rel = abs(float(g) - fd) / max(abs(fd), 1e-300)
            kept = linear.sum().item() / (3.0 * outside.sum().item())
            print(f"[26]   d mean(image) / d {key} (black sky, "
                  f"{float(shadow.double().mean()):.4f} of pixels in the "
                  f"grown shadow left out): adjoint {float(g):.9e},"
                  f" central difference (h = {h:.4g}) {fd:.9e}, rel "
                  f"{rel:.3e} (bound {SURF_FD_TOL[key]}); {kept:.6f} of "
                  f"pixel channels in the linear regime (bound >= "
                  f"{SURF_FD_KEEP})")
            require(rel <= SURF_FD_TOL[key], f"{name} d/d{key} {float(g)} vs "
                    f"{fd}")
            require(kept >= SURF_FD_KEEP, f"{name} d/d{key}: kept {kept}")
    # two descent steps on examples/disk_image_recovery.py's view
    from curvis_tpu_torch.camera.camera import make_camera
    yy, xx = np.mgrid[0:64, 0:128]
    ex_sky = make_spherical_image(np.clip(np.stack(
        [0.1 + 0.1 * np.sin(6 * np.pi * xx / 128), 0.1 + yy / 320,
         0.2 + 0.1 * np.cos(4 * np.pi * yy / 64)], -1), 0, 1).astype(
             np.float32), device=DEVICE)
    th0 = math.pi / 2 - 0.4
    ex_cam = make_camera([0.0, 18.0, th0, 0.0],
                         [-math.sin(th0), 0.0, -math.cos(th0)],
                         [0.0, 0.0, 1.0], 30.0, 43.0, 96, 54, device=DEVICE)
    vdisk = DiskParams(r_inner=3.0, r_outer=12.0, volumetric=True, h_rel=0.1,
                       kappa=2.0, tau_max=8.0)
    ex_kw = dict(dt=0.25, max_steps=1200, escape_radius=25.0)
    with torch.no_grad():
        target, _ = kerr_surface_render(vdisk, ex_cam, ex_sky, 0.7,
                                        dict(r_inner=3.5, r_outer=11.0),
                                        ex_kw, backend="auto")
        noise = 0.01 * np.random.default_rng(0).standard_normal(
            tuple(target.shape))
        noise = torch.from_numpy(noise.astype(np.float32)).to(DEVICE)
        target = torch.clamp(target + noise, 0.0, 1.0)
    p = dict(a=0.4, r_inner=4.5, r_outer=10.0)
    hist = []
    reset()
    for _ in range(KERR_DESCENT["steps"] + 1):
        img, leaves = kerr_surface_render(
            vdisk, ex_cam, ex_sky, p["a"],
            dict(r_inner=p["r_inner"], r_outer=p["r_outer"]), ex_kw)
        loss = torch.mean((img - target) ** 2)
        g = torch.autograd.grad(loss, leaves[1:])
        hist.append((dict(p), loss.item()))
        for k_, gv in zip(("a", "r_inner", "r_outer"), g):
            p[k_] = p[k_] - KERR_DESCENT["rel"] * abs(p[k_]) * math.copysign(
                1.0, float(gv))
    launched = counts()
    for k_ in total:
        total[k_] += launched.get(k_, 0)
    print(f"[26] descent on examples/disk_image_recovery.py's view (96 x 54):"
          + ", ".join(f" (a {h_['a']:.4f}, r_in {h_['r_inner']:.4f}, r_out "
                      f"{h_['r_outer']:.4f}) loss {l_:.6e}" for h_, l_ in hist)
          + f"; launches {launched}")
    losses = [l_ for _, l_ in hist]
    require(all(b < a_ for a_, b in zip(losses, losses[1:])),
            f"disk descent: the loss did not fall every step: {losses}")
    # backend='scan' on the card against the adjoint at KERR_SCAN_RES^2 on
    # the gas, each stepper, over a black sky and outside the grown shadow
    # (the rays that skim the photon sphere part between the two routes'
    # roundings).  rk45's d/da is printed, not gated: with the controller
    # on, the error norm's cotangent cancels 4-6 digits through e = d5 -
    # d4, so a float32 d/da of an rk45 march is noise-limited (on this
    # view the CPU float64 twin gives +2.4e-3, its float32 -2.6e-3); the
    # full-width rk45 views above hold d/da against central differences
    n_ = KERR_SCAN_RES
    for name, disk, cm, k_w, theta, _ in (views[1], views[3]):
        family = "rk45" if "rk45" in name else "rk4"
        cm = kerr_camera((n_, n_), V["l"], V["focal"]) if disk.volumetric \
            else kerr_camera((n_, n_))
        knob = "kappa" if disk.volumetric else "brightness"
        with torch.no_grad():
            shadow = rk.render_kerr(make_kerr(1.0, KERR_A, device=DEVICE),
                                    cm, white, **k_w).sum(-1) == 0
            D = max(1, round(KERR_FD_RING * n_))
            shadow = torch.nn.functional.max_pool2d(
                shadow.double()[None, None], 2 * D + 1, stride=1,
                padding=D)[0, 0] > 0
        outside = (~shadow).double()[..., None]
        k_w = dict(k_w, max_steps=KERR_SCAN_STEPS[family])
        got = {}
        for be in ("adjoint", "scan"):
            reset()
            sync()
            t0 = time.perf_counter()
            img, leaves = kerr_surface_render(disk, cm, black, KERR_A,
                                              {knob: theta[knob]}, k_w, be)
            g = torch.autograd.grad((img.double() * outside).mean(),
                                    leaves[1:])
            sync()
            got[be] = (img.detach().double(), [float(v) for v in g],
                       counts(), time.perf_counter() - t0)
        (ia, ga, la, ta), (i_s, gs, ls, ts) = got["adjoint"], got["scan"]
        d = (i_s - ia).abs() * outside
        frac = (d <= SCAN_IMG_TOL).double().mean().item()
        rels = [abs(x - y) / max(abs(y), 1e-300) for x, y in zip(gs, ga)]
        print(f"[26] {name} scan vs adjoint {n_}^2, {KERR_SCAN_STEPS[family]}"
              f" steps, black sky outside the grown shadow: image max |d| "
              f"{float(d.max()):.3e}, {frac:.6f} of channels within "
              f"{SCAN_IMG_TOL} (bound >= {SCAN_IMG_FRAC}); d mean / d(a, "
              f"{knob}) scan {gs[0]:.6e}, {gs[1]:.6e}, adjoint {ga[0]:.6e}, "
              f"{ga[1]:.6e}, rel {rels[0]:.3e}, {rels[1]:.3e} (bound "
              f"{SCAN_GRAD_RTOL[family]}"
              + (", d/da not gated" if family == "rk45" else "")
              + f"); scan {ts:.2f} s, adjoint {ta:.2f} s (host clock); "
              f"launches scan {ls}, adjoint {la}")
        require(bool(torch.isfinite(i_s).all()) and all(
            math.isfinite(v) for v in gs), f"{name} scan: non-finite")
        require(frac >= SCAN_IMG_FRAC, f"{name} scan image vs adjoint: "
                f"{frac} within {SCAN_IMG_TOL}")
        require(float((ia * outside).sum()) > 0.0, f"{name} scan: a dark "
                f"view")
        gated = rels if family == "rk4" else rels[1:]
        require(max(gated) <= SCAN_GRAD_RTOL[family], f"{name} scan grads "
                f"{gs} vs adjoint {ga}")
        require(not any(ls.values()), f"{name} scan launched {ls}")
        for k_ in total:
            total[k_] += la.get(k_, 0)
    print(f"[26] launches of the Kerr surface checkpoint kernels over the "
          f"paths: {total}; {time.perf_counter() - t_start:.1f} s")
    require(all(v > 0 for v in total.values()),
            f"a Kerr surface kernel was not launched: {total}")
    return total


def bell_tables(tag="[27]", names=tuple(TABLE_BELL)):
    """The Bell wormhole's tables of TABLE_BELL, float32 on the card."""
    import torch
    from curvis_tpu_torch.metrics.table import tabulate_metric

    def r_fn(l):
        rho = 1.0 + 0.35 * torch.tanh(l / 1.4)
        return torch.sqrt(rho * rho + l * l)

    tabs = {}
    for name in names:
        tab, rep = tabulate_metric(r_fn, device=DEVICE, **TABLE_BELL[name])
        print(f"{tag} bell table {name}: basis {rep['basis']}, fit errors "
              f"{rep['err_inv_rel']:.3e} (1/r^2), {rep['err_dr3_rel']:.3e} "
              f"(r'/r^3)")
        tabs[name] = tab
    return tabs


def phase27_table_kernels():
    """The table kind of kernels #1-#4 and #9 / #10's planar Euler and
    DP5(4) families against their plain versions on the card."""
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.metrics.table import tabulate_metric
    from curvis_tpu_torch.ops import march_cuda, render_fused, rk45_cuda
    from curvis_tpu_torch.physics.planar import PlanarRays
    from curvis_tpu_torch.render.fast import _spawn_frames
    t_start = time.perf_counter()
    tabs = bell_tables()
    fl = {k: table_flops(v["degree"], v["basis"])
          for k, v in TABLE_BELL.items()}
    for k, f in fl.items():
        print(f"[27] {k}: FP32 operations a shape {f['shape']}, an Euler "
              f"step {f['step']}, its VJP {f['vjp']}, a DP5(4) iteration "
              f"{f['rk45_iter']}, its VJP {f['rk45_vjp']}")
    out = {}
    headline = [camera(5.0, 0.001 * k, RES) for k in range(FRAMES)]
    out["march"] = march_vs_plain("[27]", f"table h16 {FRAMES}x{RES}^2",
                                  tabs["h16"], headline, MAX_STEPS,
                                  fl["h16"]["step"])

    # #2 and #3: the fused kernels at 1024^2 (phases 3 and 9's gates)
    cam = camera(5.0, 0.0, RES)
    n = RES * RES
    for key, name, tab, q in (
            ("fused", "euler h16", tabs["h16"],
             dict(dt=DT, max_steps=MAX_STEPS, escape_radius=R_ESC)),
            ("fused_rk45", f"rk45 c24 rtol {RK45_RTOL}", tabs["c24"],
             dict(dt=DT, max_steps=RK45_MAX_STEPS, escape_radius=R_ESC,
                  stepper="rk45", rtol=RK45_RTOL))):
        *w_k, sign_k = render_fused.fused_directions(tab, cam, **q)
        sync()
        t0 = time.perf_counter()
        *w_p, sign_p = render_fused.render_planar_fused_plain(tab, cam, **q)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        sign_eq, p99, max_abs, esc = compare(sign_k, sign_p, w_k, w_p)
        kind, row = render_fused._fused_row(tab, cam, DT, R_ESC)
        state, _, _ = _spawn_frames(tab, [cam])
        f = fl[name.split()[1]]
        if key == "fused":
            kernel_ms = cuda_ms(lambda: render_fused.launch(
                kind, row, RES, RES, MAX_STEPS, cam.device), 3)
            work = march_cuda.launch(kind, row[:6], *state,
                                     max_steps=MAX_STEPS)[4]
            ops = f["step"] * work.double().sum().item()
        else:
            tail, mi = render_fused._rk45_tail(RK45_RTOL, None, 10.0,
                                               RK45_MAX_STEPS, None)
            kernel_ms = cuda_ms(lambda: render_fused.launch_rk45(
                kind, row + tail, RES, RES, RK45_MAX_STEPS, mi, cam.device),
                3)
            work = rk45_cuda.launch(kind, row[:6] + tail, *state,
                                    max_steps=RK45_MAX_STEPS,
                                    max_iters=mi)[5]
            ops = f["rk45_iter"] * work.double().sum().item()
        b_ms, b_by = bound(16 * n, (FLOP_FUSED_PIXEL + f["shape"]) * n + ops)
        print(f"[27] #{2 if key == 'fused' else 3} fused {name} {RES}^2: "
              f"sign equal {sign_eq:.6f}, angle p99 {p99:.3e} rad over "
              f"{esc:.4f} of rays, max |dw| {max_abs:.3e}; kernel "
              f"{kernel_ms:.3f} ms ({n / kernel_ms / 1e3:.1f} Mrays/s), "
              f"plain {plain_ms:.1f} ms")
        require(sign_eq >= SIGN_EQ_MIN, f"table {key}: sign equal {sign_eq}")
        require(p99 < ANGLE_P99_MAX, f"table {key}: angle p99 {p99}")
        out[key] = dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by)

    # #4 bare: exact
    out["rk45"] = rk45_vs_plain("[27]", f"table h16 {RES}^2", tabs["h16"],
                                [cam], RK45_MAX_STEPS, 0,
                                fl["h16"]["rk45_iter"])
    rk45_vs_plain("[27]", f"table c24 {SMALL}^2", tabs["c24"],
                  [camera(5.0, 0.0, SMALL)], RK45_MAX_STEPS, 0,
                  fl["c24"]["rk45_iter"])

    # #9 / #10: the Euler family (checkpoints against #1's trajectory) and
    # the DP5(4) family (gen's final state against #4's, bit for bit)
    for k, name in enumerate(("h16", "c24")):
        f = fl[name]
        nums = kernel_vs_plain(
            *ckpt_inputs(tabs[name], camera(5.0, 0.0, SMALL),
                         TABLE_CKPT_CAP, seed=270 + k),
            f"table {name} {SMALL}^2, cap {TABLE_CKPT_CAP}", tag="[27]",
            flops=(f["step"], f["vjp"]))
        out.setdefault("ckpt", nums)
        state, _, _ = _spawn_frames(tabs[name], [camera(5.0, 0.0, SMALL)])
        flat = [t.reshape(-1).contiguous() for t in state]
        kind, scal = rk45_cuda.rk45_scalars(tabs[name], DT, R_ESC, rtol=1e-5,
                                            atol=1e-7, dt_max=10.0)
        fwd = rk45_cuda.launch(kind, scal, *flat, max_steps=RK45_TRAIN_STEPS,
                               max_iters=TABLE_RK45_ITERS)
        nums = rk45_family_vs_plain(
            f"table {name} {SMALL}^2, max_iters {TABLE_RK45_ITERS}", kind,
            "bare", scal, flat, None, fwd, seed=275 + k, freeze=k == 1,
            tag="[27]", flops=(f["rk45_iter"], f["rk45_vjp"]))
        out.setdefault("rk45_ckpt", nums)

    # a degree above the kernels' capacity raises before any launch
    big, _ = tabulate_metric(make_metric("ellis", rho=1.0, device="cpu"),
                             degree=40, device=DEVICE)
    state, _, _ = _spawn_frames(big, [camera(5.0, 0.0, 16)])
    unused = torch.zeros((1, 3), device=DEVICE)
    before = march_cuda.launches
    try:
        march_cuda.march_planar_cuda(big, PlanarRays(*state, r_hat=unused,
                                                     e2=unused),
                                     dt=DT, max_steps=10, escape_radius=R_ESC)
        raised = ""
    except ValueError as e:
        raised = str(e)
    print(f"[27] a degree-40 table on the card: {raised!r}")
    require("degree 32" in raised and march_cuda.launches == before,
            "a table above the kernels' capacity did not raise before launch")
    print(f"[27] {time.perf_counter() - t_start:.1f} s")
    return out


def table_agreement(tag, name, w_t, sign_t, w_a, sign_a):
    """The table render's escape directions against the analytic ones
    (benchmarks/parity_gates.py:gate_table): the share of equal signs and
    of escaped rays whose directions differ beyond TABLE_ANGLE."""
    import numpy as np
    sign_eq = (sign_t == sign_a).double().mean().item()
    both = (sign_t.abs() == 1) & (sign_a.abs() == 1)
    ang, _, _ = angles(w_t, w_a, both)
    p50, p99 = np.percentile(ang, [50, 99]) if ang.size else (0.0, 0.0)
    miss = float((ang > TABLE_ANGLE).mean()) if ang.size else 0.0
    print(f"{tag} {name} vs the analytic Ellis render: sign equal "
          f"{sign_eq:.6f} (bound >= {TABLE_SIGN_MIN}), angle p50 {p50:.3e}, "
          f"p99 {p99:.3e} rad, {miss:.6f} of escaped rays beyond "
          f"{TABLE_ANGLE} rad (bound <= {TABLE_MISS_MAX})")
    require(sign_eq >= TABLE_SIGN_MIN, f"{name}: sign equal {sign_eq}")
    require(miss <= TABLE_MISS_MAX, f"{name}: {miss} of rays beyond "
            f"{TABLE_ANGLE} rad")


def shape_fn(theta):
    """The trainer's shape: r(l) = sqrt(rho^2 + l^2), rho = exp(theta0 +
    theta1 u + theta2 u^2), u = tanh(l / 1.5) (examples/shape_recovery.py's
    family, three coefficients)."""
    import torch

    def r_fn(l):
        u = torch.tanh(l / 1.5)
        rho = torch.exp(theta[0] + theta[1] * u + theta[2] * u * u)
        return torch.sqrt(rho * rho + l * l)
    return r_fn


def phase28_table_paths(bgp, bgn):
    """The slice's path at full width: the cheb headline row (Euler and the
    quality mode) and the shape trainer; returns the launch counts."""
    import torch
    from curvis_tpu_torch.fit import fit
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.metrics.table import (tabulate_metric,
                                                tabulate_metric_diff)
    from curvis_tpu_torch.ops import ckpt_adjoint_cuda as ca
    from curvis_tpu_torch.ops import ckpt_rk45_cuda as cr
    from curvis_tpu_torch.ops import march_cuda, render_fused, rk45_cuda
    from curvis_tpu_torch.render.direct import render_direct
    from curvis_tpu_torch.render.fast import render_frames_batched
    t_start = time.perf_counter()
    ellis = make_metric("ellis", rho=1.0, device=DEVICE)
    tab, rep = tabulate_metric(ellis, degree=12, tol=1e-3, device=DEVICE)
    print(f"[28] ellis degree-12 table: basis {rep['basis']}, fit errors "
          f"{rep['err_inv_rel']:.3e} / {rep['err_dr3_rel']:.3e}")
    cams = [camera(5.0, 0.001 * k, RES) for k in range(FRAMES)]
    rays = FRAMES * RES * RES
    launches = {}
    for mode, kw, rtol in (
            ("euler", dict(dt=DT, max_steps=MAX_STEPS, escape_radius=R_ESC,
                           filtering="nearest"), None),
            ("rk45", dict(dt=DT, max_steps=RK45_MAX_STEPS,
                          escape_radius=R_ESC, filtering="nearest",
                          stepper="rk45"), RK45_RTOL)):
        fkw = dict(rtol=rtol) if rtol else {}

        def fused():
            return [render_fused.render_planar_fused(tab, c, bgp, bgn, **kw,
                                                     **fkw) for c in cams]

        def batched():
            return render_frames_batched(tab, cams, bgp, bgn, **kw)

        march_cuda.launches = 0
        rk45_cuda.launches = 0
        render_fused.launches.update(euler=0, rk45=0)
        imgs_f = torch.stack(fused())                  # warm-up
        ms_f = cuda_ms(fused, REPS)
        imgs_b = batched()                             # warm-up
        ms_b = cuda_ms(batched, REPS)
        launches[mode] = {"march": march_cuda.launches,
                          "rk45": rk45_cuda.launches,
                          **{f"fused_{k}": v
                             for k, v in render_fused.launches.items()}}
        label = "Euler" if mode == "euler" else f"rk45 rtol {rtol} (fused)"
        for name, imgs, ms in ((f"render_planar_fused {label}", imgs_f,
                                ms_f),
                               (f"render_frames_batched {mode}", imgs_b,
                                ms_b)):
            require(tuple(imgs.shape) == (FRAMES, RES, RES, 3),
                    f"{name}: shape {tuple(imgs.shape)}")
            require(bool(torch.isfinite(imgs).all()), f"{name}: non-finite")
            lit = [(im.sum(-1) > 0).double().mean().item() for im in imgs]
            print(f"[28] table {name}: {FRAMES} x {RES}^2 in {ms:.2f} ms "
                  f"(median of {REPS}) = {rays / ms / 1e3:.1f} Mrays/s; lit "
                  f"fraction {min(lit):.6f}..{max(lit):.6f}")
            require(min(lit) > LIT_MIN, f"{name}: lit fraction {min(lit)}")
        print(f"[28] launch counters over the table {mode} headline: "
              f"{launches[mode]}")
        key = "march" if mode == "euler" else "rk45"
        fkey = "fused_euler" if mode == "euler" else "fused_rk45"
        require(launches[mode][key] > 0 and launches[mode][fkey] > 0,
                f"a kernel of the table {mode} path was not launched: "
                f"{launches[mode]}")
        # the directions against the analytic Ellis render of each pose
        q = {k: v for k, v in kw.items() if k != "filtering"}
        ws_t, ss_t, ws_a, ss_a = [], [], [], []
        for c in cams:
            *w, s_ = render_fused.fused_directions(tab, c, **q, **fkw)
            ws_t.append(w)
            ss_t.append(s_)
            *w, s_ = render_fused.fused_directions(ellis, c, **q, **fkw)
            ws_a.append(w)
            ss_a.append(s_)
        table_agreement("[28]", f"table {mode} headline", [
            torch.cat([w[i] for w in ws_t]) for i in range(3)],
            torch.cat(ss_t), [torch.cat([w[i] for w in ws_a])
                              for i in range(3)], torch.cat(ss_a))

    # the trainer: fit the shape's coefficients through the adjoint
    theta_true = torch.tensor([TABLE_SHAPE[k] for k in ("rho0", "rho1",
                                                        "rho2")],
                              device=DEVICE)

    # the Chebyshev basis: a monomial (Horner) table's coefficients depend
    # on theta through Jacobian entries of up to ~8 of either sign
    # (Chebyshev: <= 0.42) that cancel against the far rays' nearly equal
    # powers of t -> 1; with it the float32 adjoint and the float32
    # central difference of the check below parted by 7 % at 128^2, with
    # the Chebyshev table by 0.7 % (H100, PERF.md)
    def table_of(theta, dtype=torch.float32):
        return tabulate_metric_diff(shape_fn(theta), degree=12, s=1.0,
                                    basis="clenshaw", device=DEVICE,
                                    dtype=dtype)

    for stepper, steps in (("euler", MAX_STEPS), ("rk45", RK45_TRAIN_STEPS)):
        cam = trainer_camera(RES)
        kw = dict(dt=DT, max_steps=steps, escape_radius=R_ESC,
                  filtering="bilinear", differentiable="adjoint",
                  stepper=stepper)
        with torch.no_grad():
            target = render_direct(table_of(theta_true), cam, bgp, bgn, **kw)

        def loss(p):
            img = render_direct(table_of(p["theta"]), cam, bgp, bgn, **kw)
            return torch.mean((img - target) ** 2)

        theta = torch.zeros(3, device=DEVICE, requires_grad=True)
        fwd, bwd = [], []
        for _ in range(3):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            v = loss({"theta": theta})
            e[1].record()
            (g,) = torch.autograd.grad(v, theta)
            e[2].record()
            e[2].synchronize()
            fwd.append(e[0].elapsed_time(e[1]))
            bwd.append(e[1].elapsed_time(e[2]))
        print(f"[28] {stepper} trainer {RES}^2: d loss / d theta at 0 = "
              f"{[f'{x:.6e}' for x in g.tolist()]} (loss {v.item():.6e})")
        require(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
                f"table {stepper} trainer gradient {g.tolist()}")
        # the backward kernels alone, at the trainer's shapes
        tab0 = table_of(torch.zeros(3, device=DEVICE))
        if stepper == "euler":
            kind, scal, y0, b, cnt, cot = ckpt_inputs(tab0, cam, steps,
                                                      seed=280)
            n_seg = ca.n_segments(cnt, SEG)
            ck = ca.launch_gen(kind, scal, *y0, b, cnt, seg=SEG, n_seg=n_seg)
            gen_ms = cuda_ms(lambda: ca.launch_gen(
                kind, scal, *y0, b, cnt, seg=SEG, n_seg=n_seg), 3)
            bwd_ms = cuda_ms(lambda: ca.launch_bwd(
                kind, scal, ck, b, cnt, cot, seg=SEG), 3)
            mib = n_seg * 3 * cnt.numel() * 4 / 2**20
        else:
            from curvis_tpu_torch.render.fast import _spawn_frames
            state, _, _ = _spawn_frames(tab0, [cam])
            flat = [t.reshape(-1).contiguous() for t in state]
            kind, scal = rk45_cuda.rk45_scalars(tab0, DT, R_ESC, 1e-5, 1e-7,
                                                10.0)
            fwd_k = rk45_cuda.launch(kind, scal, *flat, max_steps=steps,
                                     max_iters=4 * steps)
            cnt = torch.where(fwd_k[3].abs() <= 1, fwd_k[5],
                              torch.zeros_like(fwd_k[5]))
            off, total = ca.segment_offsets(cnt, RK45_SEG)
            cot = torch.zeros((4, cnt.numel()), device=DEVICE)
            cot[0] = 1.0
            ck, _ = cr.launch_gen(kind, scal, *flat, cnt, seg=RK45_SEG,
                                  offsets=off, total=total)
            gen_ms = cuda_ms(lambda: cr.launch_gen(
                kind, scal, *flat, cnt, seg=RK45_SEG, offsets=off,
                total=total), 3)
            bwd_ms = cuda_ms(lambda: cr.launch_bwd(
                kind, scal, False, ck, flat[3], cnt, cot, seg=RK45_SEG,
                offsets=off), 3)
            mib = total * cr.N_STATE * 4 / 2**20
        print(f"[28] {stepper} trainer step (median of 3, CUDA events): "
              f"forward {statistics.median(fwd):.2f} ms + backward "
              f"{statistics.median(bwd):.2f} ms, of which gen {gen_ms:.2f} "
              f"ms and bwd {bwd_ms:.2f} ms; checkpoint buffer {mib:.1f} MiB")
        # warm-up, then the fit with the launch counters reset
        fit(loss, {"theta": torch.zeros(3, device=DEVICE)}, iters=1,
            lr=TABLE_TRAIN_LR)
        march_cuda.launches = 0
        rk45_cuda.launches = 0
        ca.launches.update(ckpt_gen=0, ckpt_bwd=0)
        cr.launches.update(rk45_gen=0, rk45_bwd=0)
        sync()
        t0 = time.perf_counter()
        res = fit(loss, {"theta": torch.zeros(3, device=DEVICE)},
                  iters=TRAIN_ITERS, lr=TABLE_TRAIN_LR)
        sync()
        fit_s = time.perf_counter() - t0
        key = f"train_{stepper}"
        launches[key] = ({"march": march_cuda.launches, **ca.launches}
                         if stepper == "euler" else
                         {"rk45": rk45_cuda.launches, **cr.launches})
        hist = res.history
        print(f"[28] {stepper} fit: {TRAIN_ITERS} Adam steps (lr "
              f"{TABLE_TRAIN_LR}) "
              f"in {fit_s:.2f} s, theta 0 -> "
              f"{[f'{x:.5f}' for x in res.params['theta'].tolist()]} (target "
              f"{theta_true.tolist()}); history "
              f"{', '.join(f'{h:.6e}' for h in hist)}; launches "
              f"{launches[key]}")
        require(all(math.isfinite(h) for h in hist), f"history {hist}")
        require(hist[-1] < hist[0], f"table {stepper} fit: loss did not "
                f"drop: {hist}")
        require(all(v_ > 0 for v_ in launches[key].values()),
                f"a kernel of the table {stepper} trainer was not launched: "
                f"{launches[key]}")

    # one coefficient's gradient against a central difference (Euler),
    # over a smooth sky (over the random one the loss wiggles at the texel
    # scale) and a view whose rays pass the throat at b >= ~1.6, where the
    # image depends on the shape ~40 times more than on the trainer's view
    # (there a float32 difference of losses is rounding noise at 10-20 %)
    from curvis_tpu_torch.camera.camera import make_camera
    cam = make_camera([0.0, 5.0, math.pi / 2, 0.0], [-0.3, 1.0, 0.2],
                      [0.0, 0.0, 1.0], 15.0, 43.0, GRAD_RES, GRAD_RES,
                      device=DEVICE)
    kw = dict(dt=DT, max_steps=MAX_STEPS, escape_radius=R_ESC,
              filtering="bilinear", differentiable="adjoint")
    sky = smooth_sky()
    with torch.no_grad():
        target = render_direct(table_of(theta_true), cam, sky, sky, **kw)

    def loss_s(theta):
        img = render_direct(table_of(theta), cam, sky, sky, **kw)
        return torch.mean((img - target) ** 2)

    theta = torch.zeros(3, device=DEVICE, requires_grad=True)
    (g,) = torch.autograd.grad(loss_s(theta), theta)
    step = torch.tensor([0.0, TABLE_FD_H, 0.0], device=DEVICE)
    cd = ((loss_s(theta + step) - loss_s(theta - step)) /
          (2 * TABLE_FD_H)).item()
    rel = abs(g[1].item() - cd) / abs(cd)
    print(f"[28] d loss / d theta1 at {GRAD_RES}^2: adjoint "
          f"{g[1].item():.6e}, central difference (h {TABLE_FD_H}) "
          f"{cd:.6e}, rel {rel:.3e} (bound {TABLE_FD_TOL})")
    require(rel <= TABLE_FD_TOL, f"table gradient vs central difference: "
            f"{g[1].item()} vs {cd}")
    print(f"[28] {time.perf_counter() - t_start:.1f} s")
    return launches


def phase29_table_disk_kernels(sky):
    """The table kind of kernels #5, #6, #4's surface variants and #9 /
    #10's four planar surface families against their plain versions on the
    card, on the Bell h16 table at the disk view, the plain versions capped
    in steps (iterations) and not in rays."""
    import dataclasses
    import torch
    from curvis_tpu_torch.ops import _build
    from curvis_tpu_torch.ops import disk_cuda, disk_vol_cuda
    from curvis_tpu_torch.ops import rk45_disk_cuda as rd
    from curvis_tpu_torch.render.disk import DiskParams, compute_starlight_map
    from curvis_tpu_torch.render.starlight import starlight_scatter_block
    t_start = time.perf_counter()
    tab = bell_tables("[29]", ("h16",))["h16"]
    f = table_disk_flops(TABLE_BELL["h16"]["degree"], "horner")
    exact = "--fmad=false" in _build.SOURCE_FLAGS.get("planar_rk45_disk.cu",
                                                      [])
    band = TABLE_DISK_BAND
    tint = dataclasses.replace(DiskParams(**DISK_VOL), r_inner=band[0],
                               r_outer=band[1])
    bb = dataclasses.replace(tint, color_mode="blackbody", t_peak=7000.0)
    smap = compute_starlight_map(
        tab, sky, dataclasses.replace(bb, starlight=True, starlight_samples=64,
                                      starlight_grid=(64, 128)),
        dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R)
    block = starlight_scatter_block(smap, bb)
    V, S = DISK_VOL_RES, SMALL
    out = {}
    print(f"[29] table h16: FP32 operations a #5 step {f['step']}, a #6 "
          f"tint step {f['vol']((False, False, False, False))}, a thin "
          f"surface VJP {f['thin_vjp']}, a DP5(4) iteration "
          f"{f['rk45_iter']}, its VJP {f['rk45_vjp']}")

    # #5: the path's view, capped
    state, planes = disk_rays(tab, [disk_camera(RES)])
    ins = state + planes[:2]
    kind, scal = disk_cuda.disk_scalars(tab, DT, DISK_R, *band)
    out_k = disk_cuda.launch(kind, scal, *ins, max_steps=TABLE_DISK_CAP)
    sync()
    t0 = time.perf_counter()
    out_p = disk_cuda.march_planar_disk_plain(kind, scal, *ins,
                                              max_steps=TABLE_DISK_CAP)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    a = hit_agreement(out_k, out_p)
    kernel_ms = cuda_ms(lambda: disk_cuda.launch(
        kind, scal, *ins, max_steps=TABLE_DISK_CAP), 3)
    full = disk_cuda.launch(kind, scal, *ins, max_steps=MAX_STEPS)
    full_ms = cuda_ms(lambda: disk_cuda.launch(kind, scal, *ins,
                                               max_steps=MAX_STEPS), 3)
    n = ins[0].numel()
    far = int((full[5] < 0).sum())
    print(f"[29] #5 table h16 {RES}^2 cap {TABLE_DISK_CAP}: sign equal "
          f"{a['sign_eq']:.6f}, steps equal {a['steps_eq']:.6f}, hit "
          f"presence equal {a['hit_eq']:.6f}; over {a['n_hits']} hits p99 "
          f"rel radius {a['rel_p99']:.3e}, p99 |dpsi| {a['dpsi_p99']:.3e}; "
          f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms; full counts "
          f"{full_ms:.3f} ms (mean steps {full[4].double().mean().item():.1f}"
          f", {int((full[5] != 0).sum())} first hits, {far} on the far "
          f"sheet)")
    require(a["sign_eq"] >= SIGN_EQ_MIN and a["steps_eq"] >= STEPS_EQ_MIN
            and a["hit_eq"] >= HIT_EQ_MIN and a["rel_p99"] < HIT_P99_MAX
            and a["dpsi_p99"] < HIT_P99_MAX, f"table #5: {a}")
    require(a["n_hits"] > 0 and far > 0, f"table #5: hits {a['n_hits']}, "
            f"far-sheet hits {far}")
    b_ms, b_by = bound(68 * n, f["step"] * out_k[4].double().sum().item())
    print(f"[29]   bound {b_ms:.3f} ms ({b_by}); kernel at "
          f"{100 * b_ms / kernel_ms:.1f} % of it")
    out["disk"] = dict(max_abs_err=a["max_abs"], ms=kernel_ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # #6: tint on the path's view, blackbody + scatter at DISK_VOL_RES^2
    for key, name, res, disk, blk in (
            ("vol", f"tint {RES}^2", RES, tint, None),
            ("vol_bb", f"blackbody + scatter {V}^2", V, bb, block)):
        state, planes = disk_rays(tab, [disk_camera(res)])
        ins = state + planes
        kind, scal = disk_vol_cuda.vol_scalars(tab, DT, DISK_R, disk, blk)
        flags = (disk.color_mode == "blackbody", False, False,
                 blk is not None)
        out_k = disk_vol_cuda.launch(kind, flags, scal, *ins,
                                     max_steps=TABLE_DISK_CAP)
        sync()
        t0 = time.perf_counter()
        out_p = disk_vol_cuda.march_planar_disk_volumetric_plain(
            kind, flags, scal, *ins, max_steps=TABLE_DISK_CAP)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        sign_eq = (out_k[3] == out_p[3]).double().mean().item()
        frac, worst = close_fraction(out_k[5:9], out_p[5:9])
        kernel_ms = cuda_ms(lambda: disk_vol_cuda.launch(
            kind, flags, scal, *ins, max_steps=TABLE_DISK_CAP), 3)
        n = ins[0].numel()
        print(f"[29] #6 table h16 {name} cap {TABLE_DISK_CAP}: sign equal "
              f"{sign_eq:.6f}, tau and em within rtol {GRAD_RTOL} on "
              f"{frac:.6f} of rays (max |d| {worst:.3e}), tau max "
              f"{out_k[5].max().item():.3f}; kernel {kernel_ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms")
        require(sign_eq >= SIGN_EQ_MIN and frac >= GRAD_FRAC_MIN,
                f"table #6 {name}: sign equal {sign_eq}, close {frac}")
        require(all(bool(torch.isfinite(t).all()) for t in out_k[5:9])
                and out_k[5].max().item() > 0.1,
                f"table #6 {name}: tau / emission")
        b_ms, b_by = bound(64 * n, f["vol"](flags)
                           * out_k[4].double().sum().item())
        print(f"[29]   bound {b_ms:.3f} ms ({b_by}); kernel at "
              f"{100 * b_ms / kernel_ms:.1f} % of it")
        out[key] = dict(max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by)

    # #4's surface variants: exact against the plain version
    for key, name, res, row_kw in (
            ("rk45_disk", f"disk tracker {RES}^2", RES, dict(disk=band)),
            ("rk45_vol", f"vol blackbody + scatter {V}^2", V,
             dict(vol_disk=bb, scatter_block=block))):
        state, planes = disk_rays(tab, [disk_camera(res)])
        kind, scal = rd.rk45_disk_scalars(tab, DT, DISK_R, RK45_DISK_RTOL,
                                          RK45_DISK_RTOL * 1e-3, 10.0,
                                          **row_kw)
        flags = rd.disk_flags(row_kw.get("vol_disk"),
                              row_kw.get("scatter_block"))
        ins = state + planes[:2] + [planes[2] if flags[0] else None]
        kw = dict(max_steps=MAX_STEPS, max_iters=TABLE_DISK_ITERS)
        out_k = rd.launch(kind, flags, scal, *ins, **kw)
        sync()
        t0 = time.perf_counter()
        out_p = rd.march_planar_rk45_disk_plain(kind, flags, scal, *ins,
                                                **kw)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        n_diff, worst = outputs_differ(out_k, out_p)
        kernel_ms = cuda_ms(lambda: rd.launch(kind, flags, scal, *ins, **kw),
                            3)
        n = state[0].numel()
        iters, steps = out_k[-1].double(), out_k[-2].double()
        hits = int((out_k[3] != 0).sum()) if not flags[0] else None
        print(f"[29] #4 table h16 {name} at {TABLE_DISK_ITERS} iterations: "
              f"{n_diff} output entries differ from the plain version, max "
              f"finite |d| {worst:.3e}; digests {digest(out_k)} / "
              f"{digest(out_p)}; mean iterations {iters.mean().item():.1f}"
              + (f", {hits} first hits" if hits is not None else
                 f", tau max {out_k[3].max().item():.3f}")
              + f"; kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms")
        if exact:
            require(n_diff == 0, f"table #4 {name}: {n_diff} output entries "
                    "differ from the plain version")
        require(hits is None or hits > 0, f"table #4 {name}: no disk hit")
        per_iter = f["rk45_iter"] + (FLOP_RK45_DISK["track"] if not flags[0]
                                     else FLOP_RK45_DISK["vol_clamp"]
                                     + f["shape"])
        per_step = 0 if not flags[0] else (
            FLOP_RK45_DISK["emission"] + f["shape"] + FLOP_VOL["blackbody"]
            + FLOP_VOL["scatter"])
        b_ms, b_by = bound((68 if flags[0] else 72) * n,
                           per_iter * iters.sum().item()
                           + per_step * steps.sum().item())
        print(f"[29]   bound {b_ms:.3f} ms ({b_by}); kernel at "
              f"{100 * b_ms / kernel_ms:.1f} % of it")
        out[key] = dict(max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by)

    # #9 / #10's Euler surface families (the mismatch gates of phase 19)
    for k, (key, name, res, flags, extra) in enumerate((
            ("surf", f"thin {RES}^2", RES, None, dict(band=band)),
            ("surf_tint", f"vol tint {S}^2", S, (False, False, False, False),
             dict(disk=tint)),
            ("surf_bb", f"vol blackbody + scatter {S}^2", S,
             (True, False, False, True), dict(disk=bb, block=block)))):
        cap = TABLE_SURF_CAP if flags is None else TABLE_SURF_VOL_CAP
        inputs = surface_inputs(tab, [disk_camera(res)], flags, cap,
                                seed=290 + k, **extra)
        fl = ((f["step"], f["thin_vjp"]) if flags is None
              else (f["vol"](flags), f["vol_vjp"](flags)))
        out[key] = surface_vs_plain(f"table h16 {name}, cap {cap}",
                                    inputs[0], flags, *inputs[1:],
                                    tag="[29]", flops=fl)

    # #9 / #10's DP5(4) surface families: replays bit-equal to #4
    for k, (key, name, res, flags, row_kw, freeze) in enumerate((
            ("rk45_surf", f"thin {RES}^2", RES, None, dict(disk=band),
             False),
            ("rk45_surf_tint", f"vol tint {S}^2", S,
             (False, False, False, False), dict(vol_disk=tint), True),
            ("rk45_surf_bb", f"vol blackbody + scatter {S}^2", S,
             (True, False, False, True),
             dict(vol_disk=bb, scatter_block=block), False))):
        state, planes = disk_rays(tab, [disk_camera(res)])
        kind, scal = rd.rk45_disk_scalars(tab, DT, DISK_R, RK45_DISK_RTOL,
                                          RK45_DISK_RTOL * 1e-3, 10.0,
                                          **row_kw)
        mode = rd.disk_flags(row_kw.get("vol_disk"),
                             row_kw.get("scatter_block"))
        ins = state + (planes if flags is not None else planes[:2] + [None])
        fwd = rd.launch(kind, mode, scal, *ins, max_steps=MAX_STEPS,
                        max_iters=TABLE_SURF_ITERS)
        if flags is None:
            planes = [planes[0], planes[1], torch.zeros_like(planes[2])]
        vol_extra = 0 if flags is None else 2
        fl = (f["rk45_iter"] + vol_extra * f["shape"] // 2,
              f["rk45_vjp"] + vol_extra * f["vjp"])
        out[key] = rk45_family_vs_plain(
            f"table h16 {name}, max_iters {TABLE_SURF_ITERS}", kind, flags,
            scal, state, planes, fwd, seed=295 + k, freeze=freeze,
            tag="[29]", flops=fl)
    print(f"[29] {time.perf_counter() - t_start:.1f} s")
    return out


def disk_far_fraction(metric, cam, disk, stepper):
    """The share of the view's rays that reach the far sheet: an escape to
    l < 0 or a first disk hit there."""
    from curvis_tpu_torch.physics.planar import PlanarRays
    from curvis_tpu_torch.render.disk import _march_thin
    state, planes = disk_rays(metric, [cam])
    res, h1, _ = _march_thin(metric, PlanarRays(*state, None, None),
                             planes[0], planes[1], stepper=stepper,
                             rtol=RK45_DISK_RTOL, dt=DT, max_steps=MAX_STEPS,
                             escape_radius=DISK_R, r_inner=disk.r_inner,
                             r_outer=disk.r_outer)
    return ((res.sign == -1) | (h1[0] < 0)).double().mean().item()


def table_twin_witness(stepper, table_of, disk):
    """d mean(image) / d theta of the table's thin disk on the path's view
    at TABLE_WITNESS_RES^2 through the kernels (differentiable='adjoint',
    float32) against the float64 twin pair (differentiable='scan': the
    PyTorch step under autograd, with table, camera and sky in float64),
    over the pixels whose float32 and float64 frames agree within
    TABLE_WITNESS_AGREE, capped at TABLE_WITNESS_STEPS steps on both
    routes alike.  The pixels left out are those whose float32 rays
    part from the float64 ones, by the throat and the photon ring: there
    the two frames, and so their derivatives, differ by precision, which
    no float32 route removes (table_disk_witness.py reads both sides)."""
    import torch
    from curvis_tpu_torch.render import disk as rd
    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    steps = TABLE_WITNESS_STEPS[stepper]
    kw = dict(disk=disk, dt=DT, max_steps=steps, escape_radius=DISK_R,
              stepper=stepper, rtol=RK45_DISK_RTOL)
    res = TABLE_WITNESS_RES
    th64 = torch.tensor(TABLE_DISK_THETA, device=DEVICE, dtype=f64,
                        requires_grad=True)
    img64 = rd.render_blackhole_disk(
        table_of(th64, f64), disk_camera(res, dtype=f64), smooth_sky(f64),
        differentiable="scan", **kw)
    cam, sky = disk_camera(res), smooth_sky()
    th = torch.tensor(TABLE_DISK_THETA, device=DEVICE, requires_grad=True)
    img = rd.render_blackhole_disk(table_of(th, f32), cam, sky,
                                   differentiable="adjoint", **kw).double()
    part = (img.detach() - img64.detach()).abs().amax(-1, keepdim=True)
    agree = (part <= TABLE_WITNESS_AGREE).double()
    (g64,) = torch.autograd.grad((img64 * agree).mean(), th64)
    (gk,) = torch.autograd.grad((img * agree).mean(), th)
    gk = gk.double()
    rel = float((gk - g64).abs().max() / g64.abs().max())
    sync()
    print(f"[30] table {stepper} twin witness, the path's view at {res}^2, "
          f"max_steps {steps}: {1.0 - agree.mean().item():.6f} of pixels "
          f"left out (float32 "
          f"and float64 frames part by more than {TABLE_WITNESS_AGREE}; "
          f"max {part.max().item():.3e}); d mean(image * kept) / d theta "
          f"kernels {[f'{x:.6e}' for x in gk.tolist()]}, float64 twin "
          f"{[f'{x:.6e}' for x in g64.tolist()]}, rel {rel:.3e} (bound "
          f"{TABLE_WITNESS_TOL}); {time.perf_counter() - t0:.1f} s")
    require(rel <= TABLE_WITNESS_TOL and agree.mean().item() > 0.5,
            f"table {stepper} twin witness: kernels {gk.tolist()} vs "
            f"float64 twin {g64.tolist()}")


def phase30_table_disk_paths(sky):
    """The disk path of a tabulated metric at 1024^2: render_blackhole_disk
    with the Bell h16 table, thin with two-sheet starlight and volumetric
    tint, Euler and DP5(4), and one differentiable step of a shape loss
    through tabulate_metric_diff each stepper (the adjoint against a
    float32 central difference); then a degree-12 Ellis table's thin frame
    against the analytic Ellis frame.  Returns the launch counts of the
    path."""
    import dataclasses
    import torch
    from curvis_tpu_torch.metrics.base import make_metric
    from curvis_tpu_torch.metrics.table import (tabulate_metric,
                                                tabulate_metric_diff)
    from curvis_tpu_torch.ops import ckpt_surface_cuda as cs
    from curvis_tpu_torch.ops import (disk_cuda, disk_vol_cuda, march_cuda,
                                      rk45_cuda, rk45_disk_cuda)
    from curvis_tpu_torch.ops.disk_cuda import march_planar_disk_cuda
    from curvis_tpu_torch.physics.planar import PlanarRays
    from curvis_tpu_torch.render import disk as rd
    from curvis_tpu_torch.render.disk import DiskParams, compute_starlight_map
    from curvis_tpu_torch.render.fast import _readout, _spawn_frames
    t_start = time.perf_counter()
    tab = bell_tables("[30]", ("h16",))["h16"]
    cam = disk_camera(RES)
    band = dict(r_inner=TABLE_DISK_BAND[0], r_outer=TABLE_DISK_BAND[1])
    thin = DiskParams(**{**DISK_STAR, **band, "starlight_samples": 64,
                         "starlight_two_sheet": True})
    vol = DiskParams(**{**DISK_VOL, **band})
    counters = (disk_cuda, disk_vol_cuda, march_cuda, rk45_cuda,
                rk45_disk_cuda)
    for mod in counters:
        mod.launches = 0
    cs.launches.update({k: 0 for k in cs.launches})
    for stepper in ("euler", "rk45"):
        kw = dict(dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R,
                  stepper=stepper, rtol=RK45_DISK_RTOL)
        smap = compute_starlight_map(tab, sky, thin, **kw)
        require(smap.values_neg is not None
                and bool(torch.isfinite(smap.values_neg).all()),
                f"table {stepper}: no two-sheet map")
        sheets = float((smap.values - smap.values_neg).abs().max())
        for name, disk, sm in (("thin + two-sheet starlight", thin, smap),
                               ("volumetric tint", vol, None)):
            def frame():
                return rd.render_blackhole_disk(tab, cam, sky, disk=disk,
                                                starlight_map=sm, **kw)
            img = frame()
            ms = cuda_ms(frame, REPS)
            require(tuple(img.shape) == (RES, RES, 3)
                    and bool(torch.isfinite(img).all()),
                    f"table {stepper} {name}: shape / finite")
            lit = (img.sum(-1) > 0).double().mean().item()
            bare = rd.render_blackhole_disk(
                tab, cam, sky, disk=dataclasses.replace(disk, brightness=0.0,
                                                        starlight=False),
                **kw)
            disk_px = ((img - bare).abs().sum(-1) > 1e-3).double().mean(
            ).item()
            far = disk_far_fraction(tab, cam, disk, stepper)
            print(f"[30] table h16 {stepper} {name} {RES}^2: "
                  f"{ms:.2f} ms (median of {REPS}); lit {lit:.6f}, disk "
                  f"pixels {disk_px:.6f}, far-sheet rays {far:.6f}"
                  + (f"; the two sheets' maps differ by up to {sheets:.3e}"
                     if sm is not None else ""))
            require(lit > DISK_LIT_MIN and disk_px > 0.0 and far > 0.0,
                    f"table {stepper} {name}: lit {lit}, disk {disk_px}, "
                    f"far {far}")

    # one differentiable step of a shape loss each stepper (thin disk,
    # smooth sky) at the path's view: time, image, gradient
    smooth = smooth_sky()
    grad_disk = DiskParams(**{**DISK_THIN, **band})

    def table_of(theta, dtype=torch.float32):
        return tabulate_metric_diff(shape_fn(theta), degree=12, s=1.0,
                                    basis="clenshaw", device=DEVICE,
                                    dtype=dtype)

    def frame(theta, view, disk, stepper, differentiable=None):
        return rd.render_blackhole_disk(
            table_of(theta), view, smooth, disk=disk,
            differentiable=differentiable, dt=DT, max_steps=MAX_STEPS,
            escape_radius=DISK_R, stepper=stepper, rtol=RK45_DISK_RTOL)

    def linear_regime(theta, view, disk, stepper, h):
        """Pixel channels in the linear regime at step h in theta1 and the
        central difference of their mean (phase 20's rule)."""
        e1 = torch.tensor([0.0, h, 0.0], device=DEVICE)
        with torch.no_grad():
            ims = [frame(theta + s_ * e1, view, disk, stepper)
                   for s_ in (1.0, -1.0, 0.0)]
        curv = (ims[0] + ims[1] - 2.0 * ims[2]).abs()
        linear = (curv <= SURF_FD_LIN * (ims[0] - ims[1]).abs()
                  + 1e-6).double()
        fd = ((ims[0] - ims[1]).double() * linear).mean().item() / (2 * h)
        return linear, fd

    theta0 = torch.tensor(TABLE_DISK_THETA, device=DEVICE)
    for stepper in ("euler", "rk45"):
        fwd_ms, bwd_ms = [], []
        for _ in range(3):
            theta = theta0.clone().requires_grad_()
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            img = frame(theta, cam, grad_disk, stepper, "adjoint")
            loss = img.double().mean()
            e[1].record()
            (g,) = torch.autograd.grad(loss, theta)
            e[2].record()
            e[2].synchronize()
            fwd_ms.append(e[0].elapsed_time(e[1]))
            bwd_ms.append(e[1].elapsed_time(e[2]))
        with torch.no_grad():
            ref = frame(theta0, cam, grad_disk, stepper)
        diff = float((img.detach() - ref).abs().max())
        print(f"[30] table {stepper} shape step {RES}^2 (the path's view): "
              f"d mean(image) / d theta {[f'{x:.6e}' for x in g.tolist()]}; "
              f"image vs the non-differentiable render max |d| {diff:.3e}; "
              f"forward {statistics.median(fwd_ms):.2f} ms + backward "
              f"{statistics.median(bwd_ms):.2f} ms (median of 3, CUDA "
              f"events)")
        require(diff == 0.0, f"table {stepper} step: image differs by {diff}")
        require(bool(torch.isfinite(g).all()) and bool((g != 0).all()),
                f"table {stepper} step: gradient {g.tolist()}")

    # d / d theta1 against a float32 central difference over the pixel
    # channels in the linear regime: at the path's view, printed, and at a
    # closer view (l = TABLE_FD_VIEW, its band), gated for Euler.  At the
    # path's view the mean rests on pixels by the throat whose float32
    # rays part from the float64 ones (the twin witness below leaves them
    # out; table_disk_witness.py reads them), so neither the float32
    # adjoint nor a float32 difference is a reference there.  As phase 22
    # does for a metric parameter, the DP5(4) march's difference is not
    # gated: it also moves with the controller's decisions, which the
    # adjoint differentiates as a path; the twin witness gates both
    # steppers
    l_fd, band_fd = TABLE_FD_VIEW
    fd_disk = DiskParams(**{**DISK_THIN, "r_inner": band_fd[0],
                            "r_outer": band_fd[1]})
    for stepper in ("euler", "rk45"):
        for where, view, disk in (
                ("the path's view", cam, grad_disk),
                (f"l = {l_fd}", disk_camera(RES, l=l_fd), fd_disk)):
            linear, fd = linear_regime(theta0, view, disk, stepper,
                                       TABLE_DISK_FD_H)
            theta = theta0.clone().requires_grad_()
            (g,) = torch.autograd.grad(
                (frame(theta, view, disk, stepper, "adjoint").double()
                 * linear).mean(), theta)
            rel = abs(float(g[1]) - fd) / max(abs(fd), 1e-300)
            kept = linear.mean().item()
            gate = stepper == "euler" and view is not cam
            print(f"[30] table {stepper} d loss / d theta1 at {where} "
                  f"{RES}^2: adjoint {float(g[1]):.6e}, central difference "
                  f"(h {TABLE_DISK_FD_H}) {fd:.6e}, rel {rel:.3e} "
                  + (f"(bound {TABLE_FD_TOL})" if gate else "(not gated)")
                  + f"; {kept:.6f} of pixel channels in the linear regime"
                  + (f" (bound >= {SURF_FD_KEEP})" if gate else ""))
            if gate:
                require(rel <= TABLE_FD_TOL and kept >= SURF_FD_KEEP,
                        f"table {stepper} d/dtheta1: {float(g[1])} vs {fd}, "
                        f"kept {kept}")
    for stepper in ("euler", "rk45"):
        table_twin_witness(stepper, table_of, grad_disk)

    launches = {
        "disk": disk_cuda.launches, "vol": disk_vol_cuda.launches,
        "rk45_disk": rk45_disk_cuda.launches, **cs.launches,
        "march": march_cuda.launches, "rk45": rk45_cuda.launches}
    print(f"[30] launch counters over the table disk path: {launches}")
    require(all(launches[k] > 0 for k in (
        "disk", "vol", "rk45_disk", "surface_gen", "surface_bwd",
        "surface_rk45_gen", "surface_rk45_bwd")),
        f"a kernel of the table disk path was not launched: {launches}")

    # the kernel pairs alone on the step's rays (full counts): gen, bwd and
    # the checkpoint buffer
    tab0 = table_of(torch.tensor(TABLE_DISK_THETA, device=DEVICE))
    kind, scal, state, planes, counts, cot, _ = surface_inputs(
        tab0, [cam], None, MAX_STEPS, seed=300,
        band=TABLE_DISK_BAND)
    off, n_rows = cs.segment_offsets(counts, SEG)
    args = (kind, None, scal, *state[:3], state[3], *planes, counts)
    ck, _ = cs.launch_gen(*args, seg=SEG, offsets=off, total=n_rows)
    gen_ms = cuda_ms(lambda: cs.launch_gen(*args, seg=SEG, offsets=off,
                                           total=n_rows), 3)
    bwd_ms = cuda_ms(lambda: cs.launch_bwd(
        kind, None, scal, ck, state[3], *planes, counts, cot, seg=SEG,
        offsets=off), 3)
    print(f"[30] euler step's pair alone: gen {gen_ms:.2f} ms, bwd "
          f"{bwd_ms:.2f} ms, mean steps {counts.double().mean().item():.1f}, "
          f"checkpoint buffer {n_rows * cs.n_state(None) * 4 / 2**20:.1f} "
          f"MiB")
    del ck
    state, planes = disk_rays(tab0, [cam])
    kind, scal = rk45_disk_cuda.rk45_disk_scalars(
        tab0, DT, DISK_R, RK45_DISK_RTOL, RK45_DISK_RTOL * 1e-3, 10.0,
        disk=TABLE_DISK_BAND)
    fwd = rk45_disk_cuda.launch(kind, (False,) * 5, scal, *state,
                                *planes[:2], None, max_steps=MAX_STEPS,
                                max_iters=4 * MAX_STEPS)
    cnt = torch.where(fwd[-3] != 3, fwd[-1], torch.zeros_like(fwd[-1]))
    off, n_rows = cs.segment_offsets(cnt, RK45_SEG)
    z = torch.zeros_like(planes[2])
    ck, _ = cs.launch_rk45_gen(kind, None, scal, *state[:3], state[3],
                               planes[0], planes[1], z, cnt, seg=RK45_SEG,
                               offsets=off, total=n_rows)
    cot = torch.zeros((cs.n_state_rk45(None), cnt.numel()), device=DEVICE)
    cot[4] = 1.0
    gen_ms = cuda_ms(lambda: cs.launch_rk45_gen(
        kind, None, scal, *state[:3], state[3], planes[0], planes[1], z, cnt,
        seg=RK45_SEG, offsets=off, total=n_rows), 3)
    bwd_ms = cuda_ms(lambda: cs.launch_rk45_bwd(
        kind, None, scal, False, ck, state[3], planes[0], planes[1], z, cnt,
        cot, seg=RK45_SEG, offsets=off), 3)
    print(f"[30] rk45 step's pair alone: gen {gen_ms:.2f} ms, bwd "
          f"{bwd_ms:.2f} ms, mean iterations "
          f"{cnt.double().mean().item():.1f}, checkpoint buffer "
          f"{n_rows * cs.n_state_rk45(None) * 4 / 2**20:.1f} MiB")
    del ck

    # a degree-12 Ellis table's thin frame against the analytic one, by
    # escape directions and hit coordinates
    ellis = make_metric("ellis", rho=1.0, device=DEVICE)
    etab, rep = tabulate_metric(ellis, degree=12, tol=1e-3, device=DEVICE)
    outs = {}
    for who, metric in (("table", etab), ("analytic", ellis)):
        (l, psi, p_l, b), r_hat, e2 = _spawn_frames(metric, [cam])
        res, h1, _ = march_planar_disk_cuda(
            metric, PlanarRays(l, psi, p_l, b, None, None), r_hat[2], e2[2],
            dt=DT, max_steps=MAX_STEPS, escape_radius=DISK_R,
            r_inner=1.5, r_outer=TABLE_DISK_BAND[1])
        outs[who] = (_readout(metric, res, b, r_hat, e2), res.sign, h1[0])
    (w_t, s_t, h_t), (w_a, s_a, h_a) = outs["table"], outs["analytic"]
    table_agreement("[30]", f"ellis degree-12 table thin disk {RES}^2", w_t,
                    s_t, w_a, s_a)
    both = (h_t != 0) & (h_a != 0)
    pres = ((h_t != 0) == (h_a != 0)).double().mean().item()
    rel = ((h_t - h_a).abs() / h_a.abs())[both]
    p99 = float(torch.quantile(rel.double(), 0.99)) if rel.numel() else 0.0
    print(f"[30]   hits: presence equal {pres:.6f}, {int(both.sum())} in "
          f"both, p99 relative hit coordinate {p99:.3e} (fit errors "
          f"{rep['err_inv_rel']:.3e} / {rep['err_dr3_rel']:.3e})")
    require(pres >= TABLE_SIGN_MIN and p99 <= HIT_P99_MAX,
            f"ellis table hits: presence {pres}, p99 {p99}")
    print(f"[30] {time.perf_counter() - t_start:.1f} s")
    return launches


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
    print(f"[5] build {build_s:.1f} s; headline fused {ms_f:.2f} ms, "
          f"batched {ms_b:.2f} ms on {smi}")
    phase6_ckpt()
    train_launches, ckpt = phase7_trainer(bgp, bgn)
    rk45 = phase8_rk45_march()
    quality_launches, fused_rk45 = phase9_quality(bgp, bgn)
    disk = phase10_disk_march()
    # a dim sky, so that the disk's pixels stand out (the example's
    # starfield is mostly black)
    disk_np = 0.05 * np.random.default_rng(1).random(SKY, dtype=np.float32)
    disk_sky = make_spherical_image(disk_np, device=DEVICE)
    vol = phase11_disk_vol(disk_sky)
    disk_launches = phase12_disk_path(disk_sky, disk_np)
    kerr = phase13_kerr_march(disk_sky)
    # the shadow gates need a sky without black texels
    bright = make_spherical_image(
        0.2 + 0.8 * np.random.default_rng(2).random(SKY, dtype=np.float32),
        device=DEVICE)
    kerr_launches = phase14_kerr_path(disk_sky, disk_np, bright)
    kerr_rk45 = phase15_kerr_rk45_march(disk_sky)
    kerr_rk45_launches = phase16_kerr_rk45_path(disk_sky, disk_np, bright)
    rk45_disk = phase17_rk45_disk_march(disk_sky)
    rk45_disk_launches = phase18_rk45_disk_path(disk_sky, disk_np)
    surf = phase19_surface_ckpt(disk_sky)
    surf_launches = phase20_surface_path(disk_sky)
    rk45_ckpt, rk45_surf = phase21_rk45_ckpt(disk_sky)
    rk45_launches = phase22_rk45_paths(bgp, bgn, disk_sky)
    kerr_ckpt, kerr_rk45_ckpt = phase23_kerr_ckpt()
    kerr_grad_launches = phase24_kerr_paths(bright)
    surf_k, surf_k45 = phase25_kerr_surface_ckpt()
    surf_k_launches = phase26_kerr_surface_paths(disk_sky)
    table = phase27_table_kernels()
    table_launches = phase28_table_paths(bgp, bgn)
    table_disk = phase29_table_disk_kernels(disk_sky)
    table_disk_launches = phase30_table_disk_paths(disk_sky)

    def entry(name, source, replaces, n_launches, nums):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=n_launches,
                    **{k: nums[k] for k in keys}, library_ms=None)

    kernels = [
        entry("march_planar_kernel", "curvis_tpu_torch/csrc/planar_march.cu",
              "curvis_tpu/ops/march_pallas.py:303", launches["march"], march),
        entry("render_fused_kernel", "curvis_tpu_torch/csrc/render_fused.cu",
              "curvis_tpu/ops/render_fused.py:150", launches["fused"], fused),
        entry("ckpt_gen_kernel", "curvis_tpu_torch/csrc/ckpt_adjoint.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              train_launches["ckpt_gen"], ckpt["gen"]),
        entry("ckpt_bwd_kernel", "curvis_tpu_torch/csrc/ckpt_adjoint.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              train_launches["ckpt_bwd"], ckpt["bwd"]),
        entry("march_planar_rk45_kernel",
              "curvis_tpu_torch/csrc/planar_rk45.cu",
              "curvis_tpu/ops/march_pallas.py:498",
              quality_launches["rk45"], rk45),
        entry("render_fused_rk45_kernel",
              "curvis_tpu_torch/csrc/render_fused.cu",
              "curvis_tpu/ops/render_fused.py:209",
              quality_launches["fused_rk45"], fused_rk45),
        entry("march_disk_kernel", "curvis_tpu_torch/csrc/disk.cu",
              "curvis_tpu/ops/march_pallas.py:913", disk_launches["disk"],
              disk),
        entry("march_disk_vol_kernel", "curvis_tpu_torch/csrc/disk_vol.cu",
              "curvis_tpu/ops/march_pallas.py:1213", disk_launches["vol"],
              vol),
        entry("march_kerr_kernel", "curvis_tpu_torch/csrc/kerr.cu",
              "curvis_tpu/ops/march_pallas.py:1521", kerr_launches, kerr),
        entry("march_kerr_rk45_kernel", "curvis_tpu_torch/csrc/kerr_rk45.cu",
              "curvis_tpu/ops/march_pallas.py:1861", kerr_rk45_launches,
              kerr_rk45),
        entry("march_planar_rk45_disk_kernel",
              "curvis_tpu_torch/csrc/planar_rk45_disk.cu",
              "curvis_tpu/ops/march_pallas.py:498", rk45_disk_launches,
              rk45_disk),
        entry("ckpt_surface_gen_kernel",
              "curvis_tpu_torch/csrc/ckpt_surface.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              surf_launches["surface_gen"], surf["gen"]),
        entry("ckpt_surface_bwd_kernel",
              "curvis_tpu_torch/csrc/ckpt_surface.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              surf_launches["surface_bwd"], surf["bwd"]),
        entry("ckpt_rk45_gen_kernel", "curvis_tpu_torch/csrc/ckpt_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              rk45_launches["rk45_gen"], rk45_ckpt["gen"]),
        entry("ckpt_rk45_bwd_kernel", "curvis_tpu_torch/csrc/ckpt_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              rk45_launches["rk45_bwd"], rk45_ckpt["bwd"]),
        entry("ckpt_surface_rk45_gen_kernel",
              "curvis_tpu_torch/csrc/ckpt_surface_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              rk45_launches["surface_rk45_gen"], rk45_surf["gen"]),
        entry("ckpt_surface_rk45_bwd_kernel",
              "curvis_tpu_torch/csrc/ckpt_surface_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              rk45_launches["surface_rk45_bwd"], rk45_surf["bwd"]),
        entry("ckpt_kerr_gen_kernel", "curvis_tpu_torch/csrc/ckpt_kerr.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              kerr_grad_launches["kerr_gen"], kerr_ckpt["gen"]),
        entry("ckpt_kerr_bwd_kernel", "curvis_tpu_torch/csrc/ckpt_kerr.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              kerr_grad_launches["kerr_bwd"], kerr_ckpt["bwd"]),
        entry("ckpt_kerr_rk45_gen_kernel",
              "curvis_tpu_torch/csrc/ckpt_kerr_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              kerr_grad_launches["kerr_rk45_gen"], kerr_rk45_ckpt["gen"]),
        entry("ckpt_kerr_rk45_bwd_kernel",
              "curvis_tpu_torch/csrc/ckpt_kerr_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              kerr_grad_launches["kerr_rk45_bwd"], kerr_rk45_ckpt["bwd"]),
        entry("ckpt_kerr_surface_gen_kernel",
              "curvis_tpu_torch/csrc/ckpt_kerr_surface.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              surf_k_launches["kerr_surface_gen"], surf_k["gen"]),
        entry("ckpt_kerr_surface_bwd_kernel",
              "curvis_tpu_torch/csrc/ckpt_kerr_surface.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              surf_k_launches["kerr_surface_bwd"], surf_k["bwd"]),
        entry("ckpt_kerr_surface_rk45_gen_kernel",
              "curvis_tpu_torch/csrc/ckpt_kerr_surface_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              surf_k_launches["kerr_surface_rk45_gen"], surf_k45["gen"]),
        entry("ckpt_kerr_surface_rk45_bwd_kernel",
              "curvis_tpu_torch/csrc/ckpt_kerr_surface_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              surf_k_launches["kerr_surface_rk45_bwd"], surf_k45["bwd"]),
        entry("march_planar_kernel (table)",
              "curvis_tpu_torch/csrc/planar_march.cu",
              "curvis_tpu/ops/march_pallas.py:303",
              table_launches["euler"]["march"], table["march"]),
        entry("render_fused_kernel (table)",
              "curvis_tpu_torch/csrc/render_fused.cu",
              "curvis_tpu/ops/render_fused.py:150",
              table_launches["euler"]["fused_euler"], table["fused"]),
        entry("render_fused_rk45_kernel (table)",
              "curvis_tpu_torch/csrc/render_fused.cu",
              "curvis_tpu/ops/render_fused.py:209",
              table_launches["rk45"]["fused_rk45"], table["fused_rk45"]),
        entry("march_planar_rk45_kernel (table)",
              "curvis_tpu_torch/csrc/planar_rk45.cu",
              "curvis_tpu/ops/march_pallas.py:498",
              table_launches["rk45"]["rk45"], table["rk45"]),
        entry("ckpt_gen_kernel (table)", "curvis_tpu_torch/csrc/ckpt_adjoint.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              table_launches["train_euler"]["ckpt_gen"],
              table["ckpt"]["gen"]),
        entry("ckpt_bwd_kernel (table)", "curvis_tpu_torch/csrc/ckpt_adjoint.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              table_launches["train_euler"]["ckpt_bwd"],
              table["ckpt"]["bwd"]),
        entry("ckpt_rk45_gen_kernel (table)",
              "curvis_tpu_torch/csrc/ckpt_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              table_launches["train_rk45"]["rk45_gen"],
              table["rk45_ckpt"]["gen"]),
        entry("ckpt_rk45_bwd_kernel (table)",
              "curvis_tpu_torch/csrc/ckpt_rk45.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              table_launches["train_rk45"]["rk45_bwd"],
              table["rk45_ckpt"]["bwd"]),
        entry("march_disk_kernel (table)", "curvis_tpu_torch/csrc/disk.cu",
              "curvis_tpu/ops/march_pallas.py:913",
              table_disk_launches["disk"], table_disk["disk"]),
        entry("march_disk_vol_kernel (table)",
              "curvis_tpu_torch/csrc/disk_vol.cu",
              "curvis_tpu/ops/march_pallas.py:1213",
              table_disk_launches["vol"], table_disk["vol"]),
        entry("march_planar_rk45_disk_kernel (table)",
              "curvis_tpu_torch/csrc/planar_rk45_disk.cu",
              "curvis_tpu/ops/march_pallas.py:498",
              table_disk_launches["rk45_disk"], table_disk["rk45_disk"]),
        entry("ckpt_surface_gen_kernel (table)",
              "curvis_tpu_torch/csrc/ckpt_surface.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              table_disk_launches["surface_gen"], table_disk["surf"]["gen"]),
        entry("ckpt_surface_bwd_kernel (table)",
              "curvis_tpu_torch/csrc/ckpt_surface.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              table_disk_launches["surface_bwd"], table_disk["surf"]["bwd"]),
        entry("ckpt_surface_rk45_gen_kernel (table)",
              "curvis_tpu_torch/csrc/ckpt_surface_rk45_table.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:69",
              table_disk_launches["surface_rk45_gen"],
              table_disk["rk45_surf"]["gen"]),
        entry("ckpt_surface_rk45_bwd_kernel (table)",
              "curvis_tpu_torch/csrc/ckpt_surface_rk45_table.cu",
              "curvis_tpu/ops/ckpt_adjoint_pallas.py:102",
              table_disk_launches["surface_rk45_bwd"],
              table_disk["rk45_surf"]["bwd"]),
    ]
    print(f"[30] the table disk kernels' ms, plain_ms and bound_ms in the "
          f"kernels line are phase 29's, on the Bell h16 table at the disk "
          f"view: #5 and #6 tint at {RES}^2 capped at {TABLE_DISK_CAP} "
          f"steps, #4's tracker at {RES}^2 capped at {TABLE_DISK_ITERS} "
          f"iterations, the Euler surface pair thin {RES}^2 capped at "
          f"{TABLE_SURF_CAP} steps, the DP5(4) one thin {RES}^2 capped at "
          f"{TABLE_SURF_ITERS} iterations; launches are phase 30's")
    print(f"[28] the table kernels' ms, plain_ms and bound_ms in the "
          f"kernels line are phase 27's: #1 on the Bell h16 table's "
          f"{FRAMES} x {RES}^2 bundle, #2 h16 and #3 c24 at {RES}^2, #4 h16 "
          f"at {RES}^2, the Euler pair h16 at {SMALL}^2 capped at "
          f"{TABLE_CKPT_CAP} steps, the DP5(4) pair h16 at {SMALL}^2 capped "
          f"at {TABLE_RK45_ITERS} iterations; launches are phase 28's")
    print(f"[26] done on {smi}; the surface kernels' ms, plain_ms and "
          f"bound_ms in the kernels line are phase 19's thin 1024^2 case "
          f"with every ray capped at {SURF_CAP} steps (phase 20 prints "
          f"the full counts); the rk45 pair's are phase 21's ellis trainer "
          f"view at {RES}^2 and the rk45 surface pair's its thin {RES}^2 "
          f"case capped at {RK45_SURF_ITERS} iterations; the Kerr RK4 "
          f"pair's phase 23's bare {KERR_RES[0]}x{KERR_RES[1]} view capped "
          f"at {KERR_CKPT_CAP} steps (phase 24 prints the full counts) and "
          f"the Kerr rk45 pair's its bare view at rtol {KERR_RTOL}; the "
          f"Kerr surface pairs' phase 25's thin {KERR_RES[0]}x"
          f"{KERR_RES[1]} view capped at {KERR_SURF_CAP['rk4']} steps (RK4)"
          f" or {KERR_SURF_CAP['rk45']} iterations (DP5(4)); phase 26 "
          f"prints the full counts")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
