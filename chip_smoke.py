#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vplines_slam_tpu_torch``) on one GPU.

Run from the root of a checkout:
  python3 chip_smoke.py [--kernels-only] [--profile] [--cold-witness] [--estimator-witness]

Phases (any failure exits nonzero; there is no CPU path):
  1. toolchain: torch/CUDA versions, nvcc, triton, the card's name and power limit;
  2. build: compiles csrc/*.cu with nvcc (one process per source, in
     parallel) into one library (timed);
  3. kernels: each CUDA kernel against its plain PyTorch twin on the card, at
     the main paths' shapes, with the tolerance stated, the wrapper's and the
     plain version's time per call (CUDA events), the kernel's device time
     (torch.profiler) and its bound (bytes over 3.35 TB/s or f32 operations
     over 67 TFLOP/s, from this run's inputs); then the estimator's K11-K14
     (window linearization, block normal equations, Schur solve,
     marginalization) on a points and a lines window (each slice's warm-up
     + N_EST_FRAMES frames on their plain twins), K11 at f32, K12-K14 at f64,
     f64 operations counted at the H100's 67 TFLOP/s FP64 tensor-core rate;
  4. points slice: the points-only device loop at EuRoC width (752x480,
     pinhole + radtan from configs/euroc.yaml) on a rendered figure-8 blob
     world: truth-seeded warm-up, then 44 frames through
     ``make_device_loop().run`` with the point kernels' launch counts read
     around that run; asserts no failure flag, finite BA cost and aligned
     ATE < 0.25 m;
  5. lines slice: the lines-on device loop (configs/euroc.yaml's estimator and
     line_frontend, equalize off): undistortion remap, line tracker (EDLine,
     matching, VPs) and the line/VP factors, in the same room and landmarks
     with the grid drawn as wide dark bands on a faint texture (in the
     default texture no line stays tracked over line_min_obs = 5 keyframes),
     from where the figure-8 runs sideways to the camera; truth-seeded
     warm-up with both trackers, then 24 frames with every kernel's launch
     count read around that run; asserts as phase 4, plus solved lines > 0.
     Phase 3 checks the line kernels on these frames.  Phases 4-5 keep CLAHE
     off; IMU preintegration (K10) runs in both;
  6. cold start: ``SlamSystem`` built from configs/euroc.yaml's values,
     written out here (camera, IMU noise, extrinsic, estimator, frontend and
     line_frontend with CLAHE on, and the pose_graph block: loop closure on,
     500 FAST + BRIEF per keyframe), fed 200 Hz IMU and 752x480 rendered
     frames at EuRoC-epoch stamps from t = 0 of the figure-8 in phase 5's
     world, the body mounted as EuRoC's: window fill, the visual-inertial
     initializer (it must succeed within N_INIT_MAX frames), then N_TRACK
     tracked frames, with every kernel's launch count read around the run;
     prints the init frame and the initializing call's wall time, ms/frame,
     the CUDA-event split (front ends, the two clahe calls, the VIO step and
     its preintegrate, the loop stage with its extract and retrieve spans),
     host syncs, solved lines, the keyframes inserted into the loop-closure
     database and the launches of K15-K17; asserts no reboot (failure flag),
     finite outputs, aligned ATE < 0.25 m, and p_corrected == p_vio (no loop
     can close within skip_recent = 50 keyframes, so verification, K18 and
     K19 stay idle).  Its launch counts of K1-K14 go to the kernels JSON;
  7. loop-closure circuit: the chain of loop closure (extract -> add ->
     retrieve -> candidate gate -> oldest-first verification -> record,
     then optimize_4dof and drift_correction) over 2 laps of
     loop_trajectory (radius 3 m, 64 keyframes a lap) at 752x480 with the
     EuRoC camera and the profile's PoseGraphConfig, the keyframes carrying
     a synthetic VIO drift; asserts >= 1 verified loop, each a true revisit
     (< 1.0 m), and that the PGO at least halves the last keyframe's
     position error; prints the loops, CUDA-event ms per stage, launches per
     keyframe and the error before/after.  Its launch counts of K15-K19 go
     to the kernels JSON.
  Phase 3 also holds loop closure's kernels against their plain twins at the
  profile's sizes: K15 FAST + NMS and K16 BRIEF on a 752x480 frame (exact),
  K17's 64 x 500 Hamming match in both gate settings (exact) and SimHash
  signature (codes exact, signature 1e-6, the projection matmul timed as its
  library call), K18's 256 PnP hypotheses against the f64 twin (full-rank
  counts exact, R/t 1e-6), K19's residuals and normal equations at K = 256
  (1e-12 of each one's largest entry, the dense f64 solve timed beside it).
  Phases 6-7 assert that no plain twin of K15-K19 ran.
  Phases 4-6 run the estimator through K11-K14 and assert that no plain twin
  of them (vmap of jvp, jacfwd, the plain assembly, Schur solve and
  marginalization) was called.
  --kernels-only stops after phase 3; --profile adds a torch.profiler run of
  4 extra frames of phases 4-6 (device busy share, launches per frame, top
  ops); --cold-witness runs phase 6 again with the plain twins of K9/K10,
  with a CPU run's random draws and with other draw seeds, and logs each
  run's ATE; --estimator-witness runs phases 4-6 again on the kernels (each
  must repeat its ATE) and phases 4-5 on the plain twins of K11-K14 (ATE
  within 0.01 m of the kernels').  Every profiler session (those and the
  kernels' device times) runs
  after phase 6: once the profiler has run, each later launch of the
  process costs more.
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
H, W = 480, 752
N_STEADY = 44  # steady-state frames of the points slice driven through run()
N_STEADY_LINES = 24  # steady-state frames of the lines slice
N_SYNC = 4  # extra frames run afterwards with sync debugging on
LINE_WORLD = dict(tex_gain=0.1, grid_band=0.2, grid_dark=0.0)  # BlobWorldRenderer settings
LINE_T0 = 2.5  # s: the figure-8 moves sideways to the camera, so lines get parallax
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FLOP_PER_S = 67e12  # H100 SXM: f32 outside the tensor cores, and f64 on them
FRAME_HZ, IMU_HZ = 10, 200


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, kernel_fn_name, n=20):
    """Device time per call of the CUDA kernel named kernel_fn_name (a
    substring of its symbol) over n calls, from torch.profiler; None when the
    profiler records no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if kernel_fn_name in e.key)
    return us / 1e3 / n if us > 0 else None


def bound(bytes_moved, flops):
    """(bound_ms, bound_by): the larger of the HBM time and the compute time
    (f32 or f64 operations, both 67 TFLOP/s on the H100)."""
    t_b, t_f = bytes_moved / HBM_BYTES_PER_S, flops / FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def record(rec, name, err, fn, plain_fn, kernel_fn_name, bytes_moved, flops, library_fn=None):
    """Time a kernel's wrapper against its plain twin (and a library call
    computing the same function, where there is one) and store the record;
    the device time is taken by ``device_times`` after the slices, because a
    profiler session slows every later launch of the process."""
    b_ms, b_by = bound(bytes_moved, flops)
    rec[name] = dict(err=float(err), ms=time_ms(fn), plain_ms=time_ms(plain_fn),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(library_fn) if library_fn is not None else None,
                     device_of=(fn, kernel_fn_name))


def device_times(rec):
    """Fill each record's device time (torch.profiler) and log the table."""
    for name, r in rec.items():
        r["device_ms"] = device_ms(*r.pop("device_of"))
        dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        lib = "" if r["library_ms"] is None else f", library call {r['library_ms']:.4f} ms"
        log(f"  {name}: kernel {r['ms']:.4f} ms/call (device {dms}), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}){lib}")


# ---------------------------------------------------------------------------
# phase 1-2: toolchain and build
# ---------------------------------------------------------------------------


def phase_toolchain():
    import torch

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    log("nvcc: " + (ver.stdout.strip().splitlines()[-1] if ver.returncode == 0 else "missing"))
    try:
        import triton  # noqa: F401

        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not installed")
    smi = nvidia_smi_line()
    log(f"nvidia-smi: {smi}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from vplines_slam_tpu_torch import kernels

    lib = kernels.build()
    log(f"build: {lib.path.name} in {lib.build_seconds:.2f} s")
    for line in lib.nvcc_output.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())


# ---------------------------------------------------------------------------
# staging: camera, world, frames, IMU
# ---------------------------------------------------------------------------


def stage(dev, n_frames, world=None, t0=0.0):
    """Camera, configs, rendered frames, IMU and random draws of a run of
    n_frames starting at trajectory time t0; world: BlobWorldRenderer
    settings (None: the default room)."""
    import torch

    from vplines_slam_tpu_torch.estimator.window import WindowConfig
    from vplines_slam_tpu_torch.models import camera as cam_mod
    from vplines_slam_tpu_torch.models import feature_tracker as ft_mod
    from vplines_slam_tpu_torch.models import imu as imu_mod
    from vplines_slam_tpu_torch.models import line_tracker as lt_mod
    from vplines_slam_tpu_torch.ops import image
    from vplines_slam_tpu_torch.ops.lines import LineDetectConfig
    from vplines_slam_tpu_torch.utils import demo
    from vplines_slam_tpu_torch.utils import synthetic as syn

    f32, f64 = torch.float32, torch.float64
    # configs/euroc.yaml camera: 752x480, fx fy cx cy + radtan k1 k2 p1 p2
    cam = cam_mod.pinhole(461.6, 460.3, 363.0, 248.1, -2.917e-01, 8.228e-02,
                          5.333e-05, -1.578e-04, width=W, height=H, dtype=f32, device=dev)
    tcfg = ft_mod.TrackerConfig(max_features=150, min_dist=30, equalize=False, quality=0.003)
    wcfg = WindowConfig(max_imu=64)
    params = imu_mod.default_params(f32, dev)
    q_ic, p_ic = demo.forward_camera_extrinsic(f32, dev)
    traj = syn.figure8_trajectory(radius=1.2, ypr_amp=(12.0, 5.0, 4.0))
    r = IMU_HZ // FRAME_HZ
    frame_t = t0 + torch.arange(n_frames, dtype=f64, device=dev) / FRAME_HZ
    imu_t = t0 + torch.arange((n_frames - 1) * r + 1, dtype=f64, device=dev) / IMU_HZ
    accs, gyrs = syn.imu_samples(traj, imu_t)
    p_gt, q_gt, v_gt = syn.ground_truth_states(traj, frame_t)
    rend = demo.BlobWorldRenderer(cam, q_ic, p_ic, n_pts=700, seed=4, dtype=f32, device=dev,
                                  **(world or {}))
    imgs = torch.stack([rend.render(q_gt[k], p_gt[k]) for k in range(n_frames)])
    batches = demo.imu_batches(accs.to(f32), gyrs.to(f32), 1.0 / IMU_HZ, r,
                               n_frames - 1, wcfg.max_imu)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ridx = torch.randint(0, tcfg.max_features, (n_frames, tcfg.ransac_hyps, 8),
                         generator=gen, device=dev)
    # configs/euroc.yaml line_frontend (64 lines, h/v caps 25/25, min length
    # 35, fit error 1.8, the fast 64x90 VP preset), CLAHE off as bench.py runs
    # it; its estimator block is WindowConfig's defaults (128 points, 32
    # lines, line factor 1500, VP factor 10, line_min_obs 5)
    lcfg = lt_mod.LineTrackerConfig(max_lines=64, max_h=25, max_v=25,
                                    detect=LineDetectConfig(min_len=35.0, fit_err=1.8),
                                    equalize=False)
    vp_u = torch.rand(n_frames, lcfg.vp.n_pairs, 2, generator=gen, device=dev)
    map_xy = cam_mod.undistort_rectify_map(cam)
    ideal = cam_mod.pinhole(461.6, 460.3, 363.0, 248.1, width=W, height=H, dtype=f32, device=dev)
    return dict(cam=cam, tcfg=tcfg, wcfg=wcfg, params=params, q_ic=q_ic, p_ic=p_ic,
                imgs=imgs, batches=batches, ridx=ridx, frame_t=frame_t,
                truth=(p_gt.to(f32), q_gt.to(f32), v_gt.to(f32)), lcfg=lcfg, vp_u=vp_u,
                map_xy=map_xy, plan=image.build_remap_plan(map_xy, dtype=f32, device=dev),
                ideal=ideal)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(S, SL):
    """S: the points slice's staging, SL: the lines slice's."""
    import torch
    import torch.nn.functional as F

    from vplines_slam_tpu_torch import kernels as kmod
    from vplines_slam_tpu_torch.models import camera as cam_mod
    from vplines_slam_tpu_torch.ops import corners, image, klt, line_match, lines, mvg, vp

    rec = {}
    img0, img1 = S["imgs"][0].contiguous(), S["imgs"][1].contiguous()
    cfg = S["tcfg"]
    n_px = H * W

    # K1 pyr_down at 480x752 (and the second level)
    errs = []
    for im in (img0, image.pyr_down_plain(img0)):
        errs.append(float((image.pyr_down(im) - image.pyr_down_plain(im)).abs().max()))
    err = max(errs)
    tol = 1e-6
    log(f"K1 pyr_down: max |kernel - plain| = {err:.3e} (tol {tol})")
    if not err <= tol:
        fail("K1 pyr_down disagrees with its plain version")
    taps = torch.tensor(image.PYR_TAPS, device=img0.device)
    k2d = (taps[:, None] * taps[None, :])[None, None]
    n_out = ((H + 1) // 2) * ((W + 1) // 2)
    record(rec, "pyr_down", err, lambda: image.pyr_down(img0), lambda: image.pyr_down_plain(img0),
           "pyr_down_kernel", 4 * (n_px + n_out), 50 * n_out,
           library_fn=lambda: F.conv2d(img0[None, None], k2d, stride=2, padding=2))

    # K2 klt level: 150 features detected on frame 0, every pyramid level
    xy0, _, valid0 = corners.detect(img0, cfg.max_features, cfg.min_dist, cfg.quality)
    pyr0 = image.build_pyramid(img0, cfg.klt.levels)
    pyr1 = image.build_pyramid(img1, cfg.klt.levels)
    flow_err, agree, n_ok = 0.0, 0, 0
    for lvl in range(cfg.klt.levels):
        s = 2.0 ** lvl
        guess = torch.zeros_like(xy0)
        fk, ok_k, rk = klt._track_level(pyr0[lvl], pyr1[lvl], xy0 / s, guess, cfg.klt)
        fp, ok_p, rp = klt._track_level_plain(pyr0[lvl], pyr1[lvl], xy0 / s, guess, cfg.klt)
        both = ok_k & ok_p & valid0
        if bool(both.any()):
            flow_err = max(flow_err, float((fk - fp)[both].abs().max()))
        agree += int((ok_k == ok_p).sum())
        n_ok += ok_k.numel()
    agreement = agree / n_ok
    log(f"K2 klt_track_level: max flow err (ok in both) = {flow_err:.3e} px (tol 1e-3), "
        f"ok agreement {agreement:.4f} (tol >= 0.99)")
    if not (flow_err <= 1e-3 and agreement >= 0.99):
        fail("K2 klt_track_level disagrees with its plain version")

    def klt_cost(n, kcfg):
        P, TS, MS = kcfg.win, kcfg.win + 3, kcfg.win + 1 + 2 * klt.DRIFT
        it = kcfg.iters + 1
        return (n * 4 * (TS * TS + 3 * MS * MS) + n * 13,
                n * (TS * TS * 12 + P * P * 20 + it * P * P * (12 + 8 * kcfg.illum_adapt)))

    lv0 = (pyr0[0], pyr1[0], xy0, torch.zeros_like(xy0), cfg.klt)
    record(rec, "klt_track_level", flow_err, lambda: klt._track_level(*lv0),
           lambda: klt._track_level_plain(*lv0), "klt_level_kernel",
           *klt_cost(xy0.shape[0], cfg.klt))

    # K3 corner response + cell selection, with the tracked features of frame 1
    pts1, ok1, _ = klt.track(img0, img1, xy0, cfg.klt)
    ok1 = ok1 & valid0
    ch, cw = -(-H // cfg.min_dist), -(-W // cfg.min_dist)
    occ = corners._occupied(pts1, ok1, cfg.min_dist, ch, cw, img1.device)
    resp_p = corners._nms(corners.min_eig_response(img1))
    nms = torch.empty_like(img1)
    gmax = torch.full((1,), -2**31, dtype=torch.int32, device=img1.device)

    def k3_response():
        gmax.fill_(-2**31)
        corners.CORNER_RESPONSE(kmod.check(img1, "img"), H, W, kmod.check(nms, "nms"),
                                kmod.check(gmax, "gmax", torch.int32))

    k3_response()
    err_r = float((nms - resp_p).abs().max())
    # response scale: min-eig of [0,1] images, ~1e-2 at blob peaks; f32 sums of
    # 9 products reorder, so compare absolutely at 1e-6
    tol_r = 1e-6
    log(f"K3 corner_response: max |kernel - plain| = {err_r:.3e} (tol {tol_r})")
    if not err_r <= tol_r:
        fail("K3 corner_response disagrees with its plain version")
    bv_k, bi_k = corners._cell_best_cuda(img1, cfg.min_dist, cfg.quality, occ, 5)
    bv_p, bi_p = corners._cell_best_plain(img1, cfg.min_dist, cfg.quality, occ, 5)
    above = bv_p > 0
    pos_same = bool((bi_k[above] == bi_p[above]).all())
    err_s = float((bv_k - bv_p).abs().max())
    log(f"K3 corner_select: {int(above.sum())} cells above threshold, positions identical: "
        f"{pos_same}, max |best value diff| = {err_s:.3e} (tol 1e-6)")
    if not (pos_same and err_s <= 1e-6):
        fail("K3 corner_select disagrees with its plain version")
    record(rec, "corner_response", err_r, k3_response,
           lambda: corners._nms(corners.min_eig_response(img1)), "corner_response_kernel",
           4 * 2 * n_px, 60 * n_px)
    record(rec, "corner_select", err_s,
           lambda: corners._cell_best_cuda(img1, cfg.min_dist, cfg.quality, occ, 5),
           lambda: corners._cell_best_plain(img1, cfg.min_dist, cfg.quality, occ, 5),
           "corner_select_kernel", 4 * n_px + 9 * ch * cw, 4 * n_px)

    # K4 Sampson scoring: 32 hypotheses over the 150 tracks of frame 0 -> 1
    cam = S["cam"]
    n0 = cam_mod.lift(cam, xy0)[:, :2].contiguous()
    n1 = cam_mod.lift(cam, pts1)[:, :2].contiguous()
    order = torch.argsort((~ok1).to(torch.int8), stable=True)
    n_valid = torch.clamp(ok1.sum(), min=8)
    idx = order[S["ridx"][0] % n_valid]
    sm = torch.zeros(cfg.ransac_hyps, xy0.shape[0], dtype=torch.bool,
                     device=img1.device).scatter(1, idx, True) & ok1
    Es = mvg.eight_point_essential(n0, n1, sm).contiguous()
    thr = cfg.f_threshold / 460.0
    c_k, i_k = mvg.sampson_score(Es, n0, n1, ok1, thr)
    c_p, i_p = mvg.sampson_score_plain(Es, n0, n1, ok1, thr)
    dcount = int((c_k - c_p).abs().max())
    log(f"K4 sampson_score: max per-hypothesis count diff = {dcount} (tol 1), "
        f"inlier-flag agreement {float((i_k == i_p).float().mean()):.4f}")
    if dcount > 1:
        fail("K4 sampson_score disagrees with its plain version")
    nh, nt = Es.shape[0], n0.shape[0]
    record(rec, "sampson_score", dcount, lambda: mvg.sampson_score(Es, n0, n1, ok1, thr),
           lambda: mvg.sampson_score_plain(Es, n0, n1, ok1, thr), "sampson_kernel",
           4 * (9 * nh + 4 * nt) + nt + 4 * nh + nh * nt, 40 * nh * nt)

    # ---- the line front-end's kernels, on the lines slice's undistorted frames
    lcfg, plan = SL["lcfg"], SL["plan"]
    limg0, limg1 = SL["imgs"][0].contiguous(), SL["imgs"][1].contiguous()
    # K5 remap_static at 480x752 with the EuRoC radtan plan
    u0_k, u0_p = image.remap_static(limg0, plan), image.remap_static_plain(limg0, plan)
    err5 = float((u0_k - u0_p).abs().max())
    tol5 = 1e-6
    log(f"K5 remap_static: band_v {plan.band_v}, band_h {plan.band_h}; "
        f"max |kernel - plain| = {err5:.3e} (tol {tol5}, images in [0, 1])")
    if not err5 <= tol5:
        fail("K5 remap_static disagrees with its plain version")
    record(rec, "remap_static", err5, lambda: image.remap_static(limg0, plan),
           lambda: image.remap_static_plain(limg0, plan), "remap_kernel", 4 * 5 * n_px,
           16 * n_px)
    u0 = u0_p
    u1 = image.remap_static_plain(limg1, plan)

    # K6 line_anchors: fields and per-cell best anchors of frame 0
    dcfg = lcfg.detect._replace(max_lines=lcfg.max_lines)
    ak = lines.line_anchors(u0, dcfg)
    ap = lines._anchors_plain(u0, dcfg)
    err_f = max(float((a - b).abs().max()) for a, b in zip(ak[:3], ap[:3]))
    cells_on = ap[3] > 0
    pos_agree = float((ak[4] == ap[4])[cells_on].float().mean())
    err_b = float((ak[3] - ap[3]).abs().max())
    log(f"K6 line_anchors: max |field diff| (mag, dx, dy) = {err_f:.3e} (tol 1e-6); "
        f"{int(cells_on.sum())} cells with an anchor, positions agree {pos_agree:.4f} "
        f"(tol >= 0.99), max |best value diff| = {err_b:.3e} (tol 1e-6)")
    if not (err_f <= 1e-6 and pos_agree >= 0.99 and err_b <= 1e-6):
        fail("K6 line_anchors disagrees with its plain version")
    ch6, cw6 = ap[3].shape
    record(rec, "line_anchors", max(err_f, err_b), lambda: lines.line_anchors(u0, dcfg),
           lambda: lines._anchors_plain(u0, dcfg), "line_anchors_kernel",
           4 * 4 * n_px + 8 * ch6 * cw6, 60 * n_px)

    # K6 line_grow: the walks of the 512 top anchors
    top_val, top_cell = torch.sort(ap[3].reshape(-1), descending=True, stable=True)
    top_cell = top_cell[:dcfg.max_anchors]
    a_ok = top_val[:dcfg.max_anchors] > 0
    by = torch.div(top_cell, cw6, rounding_mode="floor") * lines.CELL + ap[4].reshape(-1)[top_cell] // lines.CELL
    bx = (top_cell % cw6) * lines.CELL + ap[4].reshape(-1)[top_cell] % lines.CELL
    ax, ay = bx.float().contiguous(), by.float().contiguous()
    gk = lines.line_grow(ax, ay, *ap[:3], dcfg)
    gp = lines._grow_plain(ax, ay, *ap[:3], dcfg)

    def good(g):
        return a_ok & (g[1] >= dcfg.min_len) & (g[2] <= dcfg.fit_err) & (g[3] >= dcfg.min_len * 0.6)

    gk_ok, gp_ok = good(gk), good(gp)
    both = gk_ok & gp_ok
    seg_err = float((gk[0] - gp[0])[both].abs().max()) if bool(both.any()) else 0.0
    n_err = float((gk[3] - gp[3])[a_ok].abs().max())
    good_agree = float((gk_ok == gp_ok)[a_ok].float().mean())
    log(f"K6 line_grow: {int(a_ok.sum())} anchors, {int(gp_ok.sum())} good (plain) / "
        f"{int(gk_ok.sum())} (kernel); support counts max diff {n_err:.0f} (tol 0); "
        f"good-flag agreement {good_agree:.4f} (tol >= 0.98); max endpoint diff where good "
        f"in both {seg_err:.3e} px (tol 0.05: f32 moments summed in another order)")
    if not (n_err == 0 and good_agree >= 0.98 and seg_err <= 0.05):
        fail("K6 line_grow disagrees with its plain version")
    n_alive = float((gp[3] - 1).sum())
    A = ax.shape[0]
    record(rec, "line_grow", seg_err, lambda: lines.line_grow(ax, ay, *ap[:3], dcfg),
           lambda: lines._grow_plain(ax, ay, *ap[:3], dcfg), "line_grow_kernel",
           4 * (5 * n_alive + 6 * A + 9 * A), 60 * n_alive + 60 * A)

    # K2 in gain/bias mode: the line matcher's anchors of frame 0 -> 1
    s0, _, v0 = lines.detect_lines(u0, dcfg)
    s1, _, v1 = lines.detect_lines(u1, dcfg)
    mcfg = lcfg.match
    anchors, amask = line_match.sample_anchors(s0, v0, mcfg)
    apts = anchors.reshape(-1, 2).contiguous()
    upyr0 = image.build_pyramid(u0, mcfg.klt.levels)
    upyr1 = image.build_pyramid(u1, mcfg.klt.levels)
    flow_err2, agree2, n2 = 0.0, 0, 0
    am = amask.reshape(-1)
    for lvl in range(mcfg.klt.levels):
        sc = 2.0 ** lvl
        guess = torch.zeros_like(apts)
        fk, okk, rk = klt._track_level(upyr0[lvl], upyr1[lvl], apts / sc, guess, mcfg.klt)
        fp, okp, rp = klt._track_level_plain(upyr0[lvl], upyr1[lvl], apts / sc, guess, mcfg.klt)
        bth = okk & okp & am
        if bool(bth.any()):
            flow_err2 = max(flow_err2, float((fk - fp)[bth].abs().max()))
        agree2 += int((okk == okp)[am].sum())
        n2 += int(am.sum())
    agreement2 = agree2 / max(n2, 1)
    log(f"K2 klt_track_level (gain/bias, win {mcfg.klt.win}, {mcfg.klt.iters} iters): "
        f"{int(am.sum())} anchors of {int(v0.sum())} lines, max flow err (ok in both) = "
        f"{flow_err2:.3e} px (tol 1e-3), ok agreement {agreement2:.4f} (tol >= 0.99)")
    if not (flow_err2 <= 1e-3 and agreement2 >= 0.99):
        fail("K2 klt_track_level (gain/bias) disagrees with its plain version")
    lvg = (upyr0[0], upyr1[0], apts, torch.zeros_like(apts), mcfg.klt)
    record(rec, "klt_track_level_gain_bias", flow_err2, lambda: klt._track_level(*lvg),
           lambda: klt._track_level_plain(*lvg), "klt_level_kernel",
           *klt_cost(apts.shape[0], mcfg.klt))

    # K7 line_vote: the tracked anchors voting for frame 1's segments
    tracked, okt, _ = klt.track(u0, u1, apts, mcfg.klt)
    L0, Aa = amask.shape
    vote_in = (tracked.reshape(L0, Aa, 2).contiguous(), okt.reshape(L0, Aa) & amask, s0, v0,
               s1, v1, mcfg)
    mk, nvk = line_match.line_vote(*vote_in)
    mp, nvp = line_match.line_vote_plain(*vote_in)
    n_diff = int((mk != mp).sum())
    err7 = float((nvk - nvp).abs().max())
    log(f"K7 line_vote: {int((mp >= 0).sum())} of {int(v0.sum())} lines matched (plain); "
        f"matches differing {n_diff} (tol 0), max |votes diff| = {err7:.0f} (tol 0)")
    if not (n_diff == 0 and err7 == 0):
        fail("K7 line_vote disagrees with its plain version")
    L1 = s1.shape[0]
    record(rec, "line_vote", n_diff, lambda: line_match.line_vote(*vote_in),
           lambda: line_match.line_vote_plain(*vote_in), "line_vote_kernel",
           L0 * Aa * 9 + (L0 + L1) * 17 + 8 * L0, 25 * L0 * Aa * L1 + 30 * L0 * L0)

    # K8 vp_grid + vp_score: frame 0's lines
    vcfg = lcfg.vp
    ideal = SL["ideal"]
    line, length, angle = vp._line_params(s0, ideal.fx, ideal.cx, ideal.cy)
    gk8 = vp.vp_grid(line, length, angle, v0, vcfg)
    gp8 = vp.vp_grid_plain(line, length, angle, v0, vcfg)
    gmax8 = max(float(gp8.abs().max()), 1e-30)
    err8 = float((gk8 - gp8).abs().max()) / gmax8
    mass8 = abs(float(gk8.sum()) - float(gp8.sum())) / max(float(gp8.sum()), 1e-30)
    off8 = float(((gk8 - gp8).abs() > 1e-5 * gmax8).float().sum()
                 / (gp8 > 0).float().sum().clamp(min=1))
    log(f"K8 vp_grid: {int(v0.sum())} lines, grid max {gmax8:.4f}; total mass rel diff "
        f"{mass8:.3e} (tol 1e-5); cells off by > 1e-5 of the max: {100 * off8:.3f}% of the "
        f"voted cells (tol 1%: a pair whose direction lies on a bin edge can land one bin "
        f"over when torch's norm rounds differently); max |kernel - plain| / max = {err8:.3e}")
    if not (mass8 <= 1e-5 and off8 <= 0.01):
        fail("K8 vp_grid disagrees with its plain version")
    Lg = line.shape[0]
    record(rec, "vp_grid", err8, lambda: vp.vp_grid(line, length, angle, v0, vcfg),
           lambda: vp.vp_grid_plain(line, length, angle, v0, vcfg), "vp_grid_kernel",
           Lg * 21 + 4 * vcfg.grid_la * vcfg.grid_lo, 70 * Lg * (Lg - 1) // 2)
    u8 = SL["vp_u"][0]
    probs = v0.to(line.dtype) + 1e-6
    pidx = vp.choice_from_uniform(probs / probs.sum(), u8)
    from vplines_slam_tpu_torch.utils.geometry import cross

    vp1 = cross(line[pidx[:, 0]], line[pidx[:, 1]])
    vp1 = (vp1 / torch.clamp(torch.linalg.norm(vp1, dim=-1, keepdim=True), min=1e-12)).contiguous()
    ez = torch.tensor([0.0, 0.0, 1.0], device=line.device)
    ex = torch.tensor([1.0, 0.0, 0.0], device=line.device)
    b1 = cross(vp1, torch.where(torch.abs(vp1[:, 2:3]) < 0.95, ez, ex))
    b1 = (b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)).contiguous()
    b2 = cross(vp1, b1).contiguous()
    sweep = (torch.arange(vcfg.n_sweep, dtype=torch.float64, device=line.device)
             * (math.pi / vcfg.n_sweep)).float()
    cs, sn = torch.cos(sweep), torch.sin(sweep)
    sk = vp.vp_score(gp8, vp1, b1, b2, cs, sn, line, v0, vcfg)
    sp = vp.vp_score_plain(gp8, vp1, b1, b2, cs, sn, line, v0, vcfg)
    vps_dot = float(torch.abs(torch.sum(sk[0] * sp[0], dim=1)).min())
    id_agree = float((sk[1] == sp[1])[v0].float().mean()) if bool(v0.any()) else 1.0
    err_s8 = abs(float(sk[2]) - float(sp[2]))
    log(f"K8 vp_score: {vp1.shape[0]}x{vcfg.n_sweep} hypotheses, best score {float(sp[2]):.4f} "
        f"(|diff| {err_s8:.3e}, tol 1e-5 relative); min |vp_kernel . vp_plain| = {vps_dot:.6f} "
        f"(tol >= 0.9999); line label agreement {id_agree:.4f} (tol >= 0.95)")
    if not (err_s8 <= 1e-5 * max(abs(float(sp[2])), 1.0) and vps_dot >= 0.9999
            and id_agree >= 0.95):
        fail("K8 vp_score disagrees with its plain version")
    P8 = vp1.shape[0]
    record(rec, "vp_score", err_s8, lambda: vp.vp_score(gp8, vp1, b1, b2, cs, sn, line, v0, vcfg),
           lambda: vp.vp_score_plain(gp8, vp1, b1, b2, cs, sn, line, v0, vcfg),
           "vp_score_kernel",
           4 * (vcfg.grid_la * vcfg.grid_lo + 9 * P8 + 2 * vcfg.n_sweep + 3 * Lg + 10) + Lg * 5,
           P8 * vcfg.n_sweep * 3 * 45 + Lg * 3 * 30)

    # K9 clahe: the raw frame (point tracker) and the undistorted one (line
    # tracker), 8x8 tiles of 60x94 px, 32 bins, clip 3.0
    tiles, bins, clip = 8, 32, 3.0
    th, tw = H // tiles, W // tiles
    lut_err, out_err = 0.0, 0.0
    for im in (img0, u0.contiguous()):
        lk = torch.empty(tiles, tiles, bins, device=im.device)
        image.CLAHE_LUT(kmod.check(im, "img"), W, tiles, th, tw, bins, clip * th * tw / bins,
                        kmod.check(lk, "luts"))
        lp = image.clahe_luts_plain(im, clip, tiles, bins)
        lut_err = max(lut_err, float((lk - lp).abs().max()))
        out_err = max(out_err, float((image.clahe(im) - image.clahe_plain(im)).abs().max()))
    log(f"K9 clahe_lut: max |kernel - plain| = {lut_err:.3e} (tol 1e-6: exact counts; the "
        f"scan adds in another order); clahe_apply (whole clahe): max |kernel - plain| = "
        f"{out_err:.3e} (tol 1e-6, images in [0, 1])")
    if not (lut_err <= 1e-6 and out_err <= 1e-6):
        fail("K9 clahe disagrees with its plain version")
    luts9 = image.clahe_luts_plain(img0, clip, tiles, bins).contiguous()
    out9 = torch.empty_like(img0)

    def k9_lut():
        lk = torch.empty(tiles, tiles, bins, device=img0.device)
        image.CLAHE_LUT(kmod.check(img0, "img"), W, tiles, th, tw, bins,
                        clip * th * tw / bins, kmod.check(lk, "luts"))

    def k9_apply():
        image.CLAHE_APPLY(kmod.check(img0, "img"), kmod.check(luts9, "luts"), H, W, tiles, th,
                          tw, bins, kmod.check(out9, "out"))

    # no PyTorch call computes CLAHE (nor its tile histograms + CDFs): no library time
    record(rec, "clahe_lut", lut_err, k9_lut,
           lambda: image.clahe_luts_plain(img0, clip, tiles, bins), "clahe_lut_kernel",
           4 * th * tw * tiles * tiles + 4 * tiles * tiles * bins, 4 * th * tw * tiles * tiles)
    record(rec, "clahe_apply", out_err, k9_apply, lambda: image.clahe_apply_plain(img0, luts9),
           "clahe_apply_kernel", 4 * 2 * n_px + 4 * tiles * tiles * bins, 40 * n_px)

    # K10 preintegrate: one interval of 64 steps (every frame), the merged
    # interval of 128 (non-keyframes) and the 9 intervals of the initializer
    from vplines_slam_tpu_torch.models import imu

    dts_b, acc_b, gyr_b, m_b, _ = S["batches"]
    params = S["params"]
    nb = 9
    cases = {
        "B=1 N=64": (dts_b[:1], acc_b[:1], gyr_b[:1], m_b[:1]),
        "B=1 N=128": (torch.cat([dts_b[0], dts_b[1]])[None],
                      torch.cat([acc_b[0, :-1], acc_b[1]])[None],
                      torch.cat([gyr_b[0, :-1], gyr_b[1]])[None],
                      torch.cat([m_b[0], m_b[1]])[None]),
        f"B={nb} N=64": (dts_b[:nb], acc_b[:nb], gyr_b[:nb], m_b[:nb]),
    }
    gen = torch.Generator(device=img0.device).manual_seed(SEED + 1)
    err10 = 0.0
    for label, (d, a, g, m) in cases.items():
        B = d.shape[0]
        bias = lambda s: s * torch.randn(B, 3, generator=gen, device=d.device)
        ba, bg = bias(0.05), bias(0.01)
        pk = imu.preintegrate(d, a, g, m, ba, bg, params)
        pp = imu.preintegrate_plain(d, a, g, m, ba, bg, params)
        errs = {f: float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                for f, x, y in zip(pk._fields, pk, pp)}
        worst = max(errs, key=errs.get)
        err10 = max(err10, errs[worst])
        log(f"K10 preintegrate {label}: max |kernel - plain| / max |plain| per field "
            f"{errs[worst]:.3e} ({worst}; tol 1e-5: f32 sums in another order)")
    if not err10 <= 1e-5:
        fail("K10 preintegrate disagrees with its plain version")
    d1, a1, g1, m1 = cases["B=1 N=64"]
    z1 = torch.zeros(1, 3, device=d1.device)
    n10 = d1.shape[1]
    record(rec, "preintegrate", err10, lambda: imu.preintegrate(d1, a1, g1, m1, z1, z1, params),
           lambda: imu.preintegrate_plain(d1, a1, g1, m1, z1, z1, params),
           "preintegrate_kernel",
           4 * (n10 + 2 * (n10 + 1) * 3 + 6 + 4 + 10 + 2 * 225 + 1) + n10,
           n10 * preintegrate_step_ops())
    return rec


def preintegrate_step_ops():
    """The least operations of one preintegration step: ``F·J``, ``F·P·Fᵀ``
    and ``V·Q·Vᵀ`` over the non-zero entries of F [15, 15] and V [15, 18]
    only (an entry of an identity block adds without a multiply, Q is
    diagonal, and P's update is symmetric, so only its upper triangle is
    formed after ``F·P``), plus ~420 for the state update, the rotations and
    the scaled blocks of F and V."""
    blocks = {"Z": np.zeros((3, 3), int), "I": np.eye(3, dtype=int),
              "S": 2 * np.eye(3, dtype=int), "D": np.full((3, 3), 2)}
    pattern = lambda rows: np.block([[blocks[b] for b in row] for row in rows])
    F = pattern(["IDSDD", "ZDZZS", "ZDIDD", "ZZZIZ", "ZZZZI"])  # 0 zero, 1 one, 2 other
    V = pattern(["DDDDZZ", "ZSZSZZ", "DDDDZZ", "ZZZZSZ", "ZZZZZS"])
    # ops of one output entry of (F row) times a dense column: its multiplies
    # plus the adds that join its terms
    row_ops = [int((f == 2).sum() + max((f > 0).sum() - 1, 0)) for f in F]
    upper = [(i, j) for i in range(15) for j in range(i, 15)]
    fx = 15 * sum(row_ops)  # F times a dense 15 x 15: F·J and F·P alike
    fpf = sum(row_ops[j] for _, j in upper)  # (F·P)·Fᵀ, upper triangle
    vq = int((V > 0).sum())  # V·Q, Q diagonal
    common = lambda i, j: int(((V[i] > 0) & (V[j] > 0)).sum())
    vqv = sum(2 * common(i, j) - 1 for i, j in upper if common(i, j))
    return 2 * fx + fpf + vq + vqv + len(upper) + 420


# ---------------------------------------------------------------------------
# phase 3 (estimator): K11-K14 against their plain twins on staged windows
# ---------------------------------------------------------------------------

N_EST_FRAMES = 5  # frames after the warm-up that stage the estimator windows


@contextlib.contextmanager
def plain_estimator():
    """Run the estimator's device ops through the plain twins of K11-K14 on
    the card: the linearization by vmap of jvp, the block normal equations
    and the Schur solve in plain PyTorch, the marginalization stack by
    jacfwd + marginalize_window, and the prior-only marginalization's
    stage 1 plain."""
    from vplines_slam_tpu_torch.estimator import linearize, slide
    from vplines_slam_tpu_torch.estimator import window as win
    from vplines_slam_tpu_torch.solver import lm, marginalization as marg

    saved = (linearize.window_blocks, linearize.window_cost_residuals, lm.assemble_blocks,
             lm.schur_solve_blocks, marg._marg_stage1_cuda, slide._stack_prior_blocks)
    linearize.window_blocks = linearize.window_blocks_plain
    linearize.window_cost_residuals = win.window_residuals
    lm.assemble_blocks = lm.assemble_blocks_plain
    lm.schur_solve_blocks = lm.schur_solve_blocks_plain
    marg._marg_stage1_cuda = marg.marg_stage1_plain
    slide._stack_prior_blocks = slide.stack_prior_plain
    try:
        yield
    finally:
        (linearize.window_blocks, linearize.window_cost_residuals, lm.assemble_blocks,
         lm.schur_solve_blocks, marg._marg_stage1_cuda, slide._stack_prior_blocks) = saved


def estimator_window(S, lines):
    """A window of the points (lines=False) or lines slice: the truth-seeded
    warm-up and N_EST_FRAMES frames of the device loop on the plain twins of
    K11-K14 (a live prior, solved points and lines).  Returns (state, data,
    cfg, params)."""
    import torch

    from vplines_slam_tpu_torch.pipeline.device_loop import make_device_loop
    from vplines_slam_tpu_torch.utils import demo

    cfg, nf = S["wcfg"], S["wcfg"].nf
    kw = dict(line_cfg=S["lcfg"], map_xy=S["map_xy"]) if lines else {}
    start = demo.truth_seeded_start(
        S["cam"], S["tcfg"], cfg, S["params"], S["q_ic"], S["p_ic"],
        tuple(x[:nf] for x in S["truth"]), S["imgs"][: nf - 1],
        [b[: nf - 2] for b in S["batches"]], S["frame_t"].cpu().numpy(), 1.0 / FRAME_HZ,
        S["ridx"][: nf - 1], **kw, **({"vp_u": S["vp_u"][: nf - 1]} if lines else {}))
    loop = make_device_loop(S["cam"], S["tcfg"], cfg, S["params"], **kw)
    carry = loop.init_carry(*start[:3], *start[3:])
    s0, s1 = nf - 1, nf - 1 + N_EST_FRAMES
    args = (S["imgs"][s0:s1], tuple(b[s0 - 1: s1 - 1] for b in S["batches"]),
            torch.full((N_EST_FRAMES,), 1.0 / FRAME_HZ, device=S["imgs"].device),
            S["ridx"][s0:s1]) + ((S["vp_u"][s0:s1],) if lines else ())
    with plain_estimator():
        carry, _ = loop.run(carry, *args)
    return carry[-2], carry[-1], cfg, S["params"]


def _rel_err(a, b):
    """max |a - b| over max |b| (0 when both are 0)."""
    den = float(b.abs().max())
    return float((a.double() - b.double()).abs().max()) / den if den > 0 else float(
        a.abs().max())


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def phase_estimator_kernels(rec, windows):
    """K11-K14 against their twins on each window (points, lines): K11 at f32
    (the engine dtype) relative to each block's largest entry, K12-K14 at f64
    (their inputs are the same on both sides).  Times and bounds are taken
    on the lines window (the larger: the EuRoC profile runs lines)."""
    import torch

    from vplines_slam_tpu_torch.estimator import linearize, slide
    from vplines_slam_tpu_torch.estimator import window as win
    from vplines_slam_tpu_torch.solver import lm, marginalization as marg
    from vplines_slam_tpu_torch.utils.tree import tree_map

    f64 = torch.float64
    for label, (state, data, cfg, params) in windows.items():
        lines = label == "lines"
        x = (state, data.pt_inv_depth) + ((data.ln_orth,) if lines else ())
        # relo rows live (the smoke runs no loop closure): every solved track
        # re-observed from a relo pose near frame 1
        data_lo = data._replace(relo_valid=torch.ones_like(data.relo_valid),
                                relo_mask=data.pt_solved, relo_obs=data.pt_obs[:, 1].contiguous())
        x_lo = (x[0]._replace(p_relo=x[0].p[1] + 0.02, q_relo=x[0].q[1]),) + x[1:]
        layout = win.layout_for(cfg, lines)
        bk = linearize._window_lin_cuda(x_lo, data_lo, cfg, params, True, True, True)
        bp = linearize.window_blocks_plain(x_lo, data_lo, cfg, params)
        errs = {f: _rel_err(getattr(bk, f), getattr(bp, f)) for f in bk._fields
                if getattr(bp, f) is not None and f not in ("pt_start", "r")}
        tol11 = 1e-4
        # the rows themselves against an f64 evaluation of the same rows, the
        # kernel's error beside the twin's: the prior rows' r0 + J dx cancels
        # (whitened terms up to ~1e4), so an f32 sum is off by ~1e-4 of the
        # largest row in any order
        to64 = lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point() else t
        x64, d64, p64 = (tree_map(to64, v) for v in (x_lo, data_lo, params))
        zero = torch.zeros(layout.nd + cfg.max_points + (4 * cfg.max_lines if lines else 0),
                           dtype=f64, device=state.p.device)
        r64 = win.window_residuals(win.retract_all(x64, zero, cfg), d64, cfg, p64)
        rk = linearize._window_lin_cuda(x_lo, data_lo, cfg, params, True, True, False)
        rows = {"rows": (bk.r, bp.r, r64),
                "cost rows": (rk, win.window_residuals(x_lo, data_lo, cfg, params),
                              win.window_residuals(x64, d64, cfg, p64))}
        rows_ok = True
        for name, (a, b, ref) in rows.items():
            ek, ep = _rel_err(a, ref), _rel_err(b, ref)
            errs[f"{name} (f64 ref; plain {ep:.2e})"] = ek
            rows_ok = rows_ok and ek <= max(tol11, 2 * ep)
        live = {f: int((getattr(bp, f).abs().amax(dim=-1) > 0).sum()) for f in
                ("J_imu", "J_pt", "J_relo", "J_ln", "J_vp") if getattr(bp, f) is not None}
        err11 = max(errs.values())
        log(f"K11 window_lin ({label} window, relo rows live): live rows {live}; max |kernel - "
            f"plain| / max |plain| per block {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} "
            f"(tol {tol11}: f32 jets against f32 vmap(jvp), sums in another order; the rows "
            f"against f64: within {tol11} or twice the plain version's error)")
        if not (rows_ok and max(v for k, v in errs.items() if k.startswith("J_")) <= tol11):
            fail(f"K11 window_lin disagrees with its plain version ({label} window)")
        # K12 on K11's own blocks
        nek = lm._assemble_blocks_cuda(bk, layout)
        nep = lm.assemble_blocks_plain(bk, layout)
        err12 = max(_rel_err(a, b) for a, b in zip(nek, nep))
        tol12 = 1e-12
        log(f"K12 window_blocks ({label}): max |kernel - plain| / max |plain| over the "
            f"{len(nek)} blocks {err12:.2e} (tol {tol12}: f64 sums of the same f32 products "
            f"in another order)")
        if not err12 <= tol12:
            fail(f"K12 window_blocks disagrees with its plain version ({label} window)")
        # K13 on the same normal equations, small and large damping
        err13 = 0.0
        for lam in (1e-4, 10.0):
            lam_t = torch.tensor(lam, dtype=f64, device=state.p.device)
            dk = lm._schur_cuda(*nep[:5], lam_t, 1e-8, *(nep[5:] or (None,) * 3), f64)
            dp = lm.schur_solve_blocks_plain(*nep[:5], lam, 1e-8, *nep[5:], out_dtype=f64)
            err13 = max(err13, _rel_err(dk, dp))
        tol13 = 1e-6
        log(f"K13 schur_solve ({label}): max |kernel - plain| / max |plain| of the delta "
            f"{err13:.2e} at lambda 1e-4 and 10 (tol {tol13}: f64; a 177x177 Cholesky in "
            f"another order, condition up to ~1e6 after the Jacobi scaling)")
        if not err13 <= tol13:
            fail(f"K13 schur_solve disagrees with its plain version ({label} window)")
        # K14 on the marginalization stack's normal equations
        cfg_m = cfg._replace(marg_lines=True) if lines else cfg
        data_r = slide.marginalization_stack(data, cfg_m)
        lay_m = win.layout_for(cfg, lines, use_relo=False, use_vps=False)
        ne_m = lm._assemble_blocks_cuda(linearize._window_lin_cuda(
            x, data_r, cfg_m, params, False, False, True), lay_m)
        m_args = (*ne_m[:5], *(ne_m[5:] or (None,) * 3), 1e-12)
        mk = marg._marg_stage1_cuda(*m_args)
        mp = marg.marg_stage1_plain(*m_args)
        err14 = max(_rel_err(a, b) for a, b in zip(mk, mp))
        tol14 = 1e-9
        log(f"K14 marg_window ({label}, marg_lines {lines}): max |kernel - plain| / max "
            f"|plain| of H1, b1, c {err14:.2e} (tol {tol14}: f64; per-line Jacobi against "
            f"LAPACK eigh for the clipped inverses)")
        if not err14 <= tol14:
            fail(f"K14 marg_window disagrees with its plain version ({label} window)")
        if not lines:
            continue
        # times and bounds on the lines window as the main path gives it
        blocks = linearize._window_lin_cuda(x, data, cfg, params, True, True, True)
        ne = lm._assemble_blocks_cuda(blocks, layout)
        lam_t = torch.tensor(1e-4, dtype=f64, device=state.p.device)
        n_act = estimator_live_counts(blocks, ne)
        ins11 = [t for t in (*state, *x[1:], *data.imu_pre, data.imu_sqrt, data.prior.J,
                             data.prior.r0, data.prior_state.p, data.prior_state.q,
                             data.pt_obs, data.ln_obs, data.ln_vp) if torch.is_tensor(t)]
        outs11 = [t for t in blocks[:7] if t is not None]
        record(rec, "window_lin", err11,
               lambda: linearize._window_lin_cuda(x, data, cfg, params, True, True, True),
               lambda: linearize.window_blocks_plain(x, data, cfg, params), "wlin_",
               _nbytes(*ins11, *outs11), window_lin_ops(n_act, cfg))
        record(rec, "window_blocks", err12, lambda: lm._assemble_blocks_cuda(blocks, layout),
               lambda: lm.assemble_blocks_plain(blocks, layout), "wblk_",
               _nbytes(*outs11, *ne), window_blocks_ops(n_act, cfg))
        S_, rhs_, _ = lm.schur_system(*ne[:5], lam_t, 1e-8, *ne[5:])

        def library_k13():  # the dense solve alone, on the same S
            Lc, _ = torch.linalg.cholesky_ex(S_)
            torch.cholesky_solve(rhs_[:, None], Lc)

        record(rec, "schur_solve", err13,
               lambda: lm._schur_cuda(*ne[:5], lam_t, 1e-8, *ne[5:], torch.float32),
               lambda: lm.schur_solve_blocks_plain(*ne[:5], lam_t, 1e-8, *ne[5:],
                                                   out_dtype=torch.float32),
               "schur_", _nbytes(*ne, lam_t) + 4 * (cfg.nd + cfg.max_points + 4 * cfg.max_lines),
               schur_ops(n_act, cfg), library_fn=library_k13)
        record(rec, "marg_window", err14, lambda: marg._marg_stage1_cuda(*m_args),
               lambda: marg.marg_stage1_plain(*m_args), "marg_",
               _nbytes(*ne_m) + 8 * (cfg.nd * cfg.nd + 2 * cfg.nd), marg_ops(ne_m, cfg))


def live_landmarks(ne):
    """Points and lines in the solve (a non-zero diagonal block)."""
    lines = int((ne[6].diagonal(dim1=1, dim2=2).amax(dim=1) > 0).sum()) if len(ne) > 5 else 0
    return int((ne[3] > 0).sum()), lines


def estimator_live_counts(blocks, ne):
    """Rows with a non-zero Jacobian entry per family, and the landmarks in
    the solve: the work the window's data needs."""
    rows = lambda J: 0 if J is None else int((J.abs().amax(dim=-1) > 0).sum())
    n = {f: rows(getattr(blocks, f)) for f in ("J_prior", "J_imu", "J_pt", "J_relo", "J_ln",
                                               "J_vp")}
    n["points"], n["lines"] = live_landmarks(ne)
    return n


# jet arithmetic of one residual row, estimated from csrc/window_lin.cu: the
# scalar operations of the row's share of its observation's value (2 rows: a
# point, relo, line or VP observation; 15 rows: an IMU interval) times
# (1 + its tangents)
K11_ROW_OPS = dict(J_pt=125 * 20, J_relo=125 * 20, J_ln=260 * 17, J_vp=250 * 17,
                   J_imu=45 * 31)


def window_lin_ops(n, cfg):
    """K11's operations on the live rows: the jets, and per prior row its
    dot product with dx and its 3x3 block products."""
    prior = n["J_prior"] * (2 * cfg.nd + 18 * (cfg.nf + 2))
    return prior + sum(n[f] * K11_ROW_OPS[f] for f in K11_ROW_OPS)


def window_blocks_ops(n, cfg):
    """K12's operations: per live row, the upper triangle of its compact
    block's outer product and its gradient term (multiply-adds x 2)."""
    width = dict(J_prior=cfg.nd, J_imu=30, J_pt=19, J_relo=19, J_ln=16, J_vp=16)
    return sum(2 * n[f] * (w * (w + 1) // 2 + w) for f, w in width.items())


def schur_ops(n, cfg):
    """K13's operations: the Schur updates of S's lower triangle by the live
    points (3 per entry) and lines (32 per entry), the 4x4 inverses, a
    Cholesky (nd^3/3), two triangular solves and the back-substitution."""
    nd, tri = cfg.nd, cfg.nd * (cfg.nd + 1) // 2
    return (tri * (3 * n["points"] + 32 * n["lines"]) + 100 * n["lines"] + nd ** 3 // 3
            + 2 * nd * nd + 2 * nd * (n["points"] + 4 * n["lines"]))


def marg_ops(ne, cfg):
    """K14's operations: H1 (the whole nd x nd: its two triangles are used)
    updated by the live points (3 per entry) and lines (32 per entry), the
    per-line 4x4 eigen-decompositions (~6 Jacobi sweeps of 6 rotations)."""
    pts, lns = live_landmarks(ne)
    return cfg.nd * cfg.nd * (3 * pts + 32 * lns) + lns * 6 * 6 * 60


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 3, loop closure: K15-K19 against their plain twins
# ---------------------------------------------------------------------------


def loop_kernels():
    """K15-K19."""
    from vplines_slam_tpu_torch.models.pose_graph import PGO4
    from vplines_slam_tpu_torch.ops.brief import BRIEF, FAST, HAMMING_MATCH, SIMHASH
    from vplines_slam_tpu_torch.ops.mvg import PNP_HYPOTHESES

    return [FAST, BRIEF, HAMMING_MATCH, SIMHASH, PNP_HYPOTHESES, PGO4]


def loop_twin_check(where):
    """No plain twin of K15-K19 ran."""
    from vplines_slam_tpu_torch.kernels import TWIN_CALLS

    calls = dict(TWIN_CALLS)
    log(f"  calls of the plain twins of K15-K19: {calls}")
    if any(calls.values()):
        fail(f"{where}: the card path called a plain twin of K15-K19: {calls}")


def euroc_pose_graph():
    """configs/euroc.yaml's pose_graph block (n_features 500, loop closure
    on) over PoseGraphConfig's defaults, as load_profile reads it."""
    from vplines_slam_tpu_torch.models.pose_graph import PoseGraphConfig

    return PoseGraphConfig(n_features=500, skip_cnt=0, skip_dis=0.0, loop_edge_weight=1.0)


def pgo_database(dev, K=256, n=200, seed=SEED):
    """A K19 input at the profile's capacity: n keyframes along a 3 m circle
    with a drifting yaw and translation, 12 loop edges (one on an inactive
    row) and keyframe 3 of a loaded map (seq 0), in f32 as on the card."""
    import torch

    from vplines_slam_tpu_torch.models import pose_graph as pg_mod
    from vplines_slam_tpu_torch.utils import geometry as geo

    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(n) / 64
    yaw_d = np.cumsum(rng.normal(0, 0.3, n))
    t_d = np.cumsum(rng.normal(0, 0.02, (n, 3)), axis=0)
    p = np.stack([3 * np.cos(a), 3 * np.sin(a), 0.2 * np.sin(2 * a)], 1) + t_d
    ypr = np.stack([np.degrees(a) + 180.0 + yaw_d, 4 * np.sin(a), 3 * np.cos(a)], 1)
    f32 = torch.float32
    t = lambda x, dt=f32: torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dt)
    db = pg_mod.empty_db(pg_mod.PoseGraphConfig(max_keyframes=K, n_features=4, n_window_pts=4),
                         f32, dev)
    pad = lambda x, fill=0.0: np.concatenate([x, np.full((K - n,) + x.shape[1:], fill)])
    q = geo.rot_to_quat(geo.ypr_to_rot(t(pad(ypr), torch.float64))).to(f32)
    loop_to = np.full(K, -1)
    loop_t = np.zeros((K, 3))
    loop_yaw = np.zeros(K)
    for j in list(range(70, n, 11)) + [n + 5]:
        loop_to[j] = j - 64
        loop_t[j] = rng.normal(0, 0.1, 3)
        loop_yaw[j] = rng.normal(0, 2.0)
    seq = np.ones(K, np.int64)
    seq[3] = 0
    return db._replace(count=torch.tensor(n, device=dev), seq=t(seq, torch.int64),
                       p_vio=t(pad(p)), q_vio=q, p_pgo=t(pad(p)), yaw_pgo=t(pad(ypr[:, 0])),
                       loop_to=t(loop_to, torch.int64), loop_t=t(loop_t), loop_yaw=t(loop_yaw))


def phase_loop_kernels(rec, S):
    """K15-K19 at the profile's sizes: FAST + NMS on a 752x480 frame, BRIEF
    at its 500 corners and at 64 window points, the 64 x 500 Hamming match
    in both gate settings and the SimHash signature, 256 PnP hypotheses on
    64 points (~40% outliers), the 4-DoF pose graph at K = 256."""
    import torch

    from vplines_slam_tpu_torch.kernels import TWIN_CALLS
    from vplines_slam_tpu_torch.models import pose_graph as pg_mod
    from vplines_slam_tpu_torch.ops import brief, mvg
    from vplines_slam_tpu_torch.solver import lm

    img0 = S["imgs"][0].contiguous()
    dev = img0.device
    n_px = H * W
    F_, Wp = 500, 64

    # K15 FAST-9 + 7x7 NMS: score map and detections exact
    sk, sp = brief.fast_score(img0), brief.fast_score_plain(img0)
    xy_k, v_k = brief.detect_fast(img0, F_)
    xy_p, v_p = brief.detect_fast_plain(img0, F_)
    err15 = max(float((sk - sp).abs().max()), float((xy_k - xy_p).abs().max()))
    same15 = bool(torch.equal(v_k, v_p)) and err15 == 0.0
    log(f"K15 fast: score map max |kernel - plain| = {float((sk - sp).abs().max()):.3e}, "
        f"detections {int(v_k.sum())} of {F_} equal: {same15} (tol: exact)")
    if not same15:
        fail("K15 fast disagrees with its plain version")
    record(rec, "fast", err15, lambda: brief._fast_cuda(img0, 0.05, True),
           lambda: brief._nms_plain(brief.fast_score_plain(img0), 3), "fast_",
           4 * 2 * n_px, n_px * (16 * 8 + 40 + 49))

    # K16 blur + BRIEF at the 500 corners and at 64 window points (corners
    # moved by up to 2 px, so most fall between pixels)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    wxy = xy_k[:Wp] + 4.0 * torch.rand(Wp, 2, generator=gen, device=dev) - 2.0
    wv = torch.rand(Wp, generator=gen, device=dev) < 0.9
    d_k, d_p = brief.describe_brief(img0, xy_k, v_k), brief.describe_brief_plain(img0, xy_k, v_k)
    w_k, w_p = brief.describe_brief(img0, wxy, wv), brief.describe_brief_plain(img0, wxy, wv)
    same16 = bool(torch.equal(d_k, d_p)) and bool(torch.equal(w_k, w_p))
    n_diff = int((d_k != d_p).sum()) + int((w_k != w_p).sum())
    log(f"K16 brief: 500 corners and 64 window points, every bit equal: {same16} "
        f"({n_diff} words differ; tol: exact)")
    if not same16:
        fail("K16 brief disagrees with its plain version")
    record(rec, "brief", float(n_diff), lambda: brief.describe_brief(img0, xy_k, v_k),
           lambda: brief.describe_brief_plain(img0, xy_k, v_k), "brief_",
           4 * n_px + F_ * (8 + 1 + 32), n_px * 28 + F_ * 256 * 2 * 14)

    # K17 (a) match 64 x 500, the verification's gates and the default ones
    outs = {}
    for margin, mutual in ((16, True), (0, False)):
        ik, dk = brief.match_descriptors(w_k, wv, d_k, v_k, 80, margin, mutual)
        ip, dp = brief.match_descriptors_plain(w_k, wv, d_k, v_k, 80, margin, mutual)
        outs[(margin, mutual)] = (bool(torch.equal(ik, ip)) and bool(torch.equal(dk, dp)),
                                  int((ik >= 0).sum()))
    log(f"K17 hamming_match: (margin, mutual) -> (equal, matches): {outs} (tol: exact)")
    if not all(ok for ok, _ in outs.values()):
        fail("K17 hamming_match disagrees with its plain version")
    hd = brief.hamming_matrix(w_k, d_k)
    if not torch.equal(hd, brief.hamming_matrix_plain(w_k, d_k)):
        fail("K17's distance table disagrees with hamming_matrix_plain")
    record(rec, "hamming_match", 0.0,
           lambda: brief.match_descriptors(w_k, wv, d_k, v_k, 80, 16, True),
           lambda: brief.match_descriptors_plain(w_k, wv, d_k, v_k, 80, 16, True),
           "hamming_match", (Wp + F_) * 33 + Wp * 8, 2 * Wp * F_ * 8 * 3)

    # K17 (b) the signature of the 500 corners: codes exact, signature 1e-6
    codes = torch.empty(F_, 256, dtype=torch.int8, device=dev)
    sig_k = brief.global_signature(d_k, v_k, xy=xy_k, img_hw=(H, W), codes_out=codes)
    sig_p = brief.global_signature_plain(d_k, v_k, xy=xy_k, img_hw=(H, W))
    codes_p = brief.simhash_codes_plain(d_k, v_k)
    codes_same = bool(torch.equal(codes.to(torch.float32), codes_p))
    err17 = float((sig_k - sig_p).abs().max())
    log(f"K17 simhash_signature: codes equal: {codes_same} (tol: exact), signature max |kernel "
        f"- plain| = {err17:.3e} (tol 1e-6)")
    if not (codes_same and err17 <= 1e-6):
        fail("K17 simhash_signature disagrees with its plain version")
    bits = brief._unpack_bits(d_k) - 0.5
    Wv = torch.from_numpy(brief._random_vocab(256, 256)).to(device=dev, dtype=torch.float32)
    record(rec, "simhash_signature", err17,
           lambda: brief.global_signature(d_k, v_k, xy=xy_k, img_hw=(H, W)),
           lambda: brief.global_signature_plain(d_k, v_k, xy=xy_k, img_hw=(H, W)),
           "hamming_simhash", F_ * (32 + 1 + 8) + 256 * 32 + 4 * 1024, F_ * 256 * 8 * 3,
           library_fn=lambda: torch.sign(bits @ Wv))

    # K18: 256 six-point hypotheses over 64 points, ~40% outliers, against
    # the twin at f64 on the same (f32) inputs
    N, n_hyp = 64, 256
    g = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=torch.float64)
    from vplines_slam_tpu_torch.utils import geometry as geo

    R = geo.ypr_to_rot(torch.tensor([20.0, -5.0, 3.0], dtype=torch.float64, device=dev))
    tt = torch.tensor([0.2, -0.1, 0.3], dtype=torch.float64, device=dev)
    Xc = torch.stack([4 * g(N) - 2, 3 * g(N) - 1.5, 2 + 4 * g(N)], 1)
    X_w = (Xc - tt) @ R
    x = Xc[:, :2] / Xc[:, 2:3] + 2e-3 * (g(N, 2) - 0.5)
    bad = g(N) < 0.4
    x = torch.where(bad[:, None], 1.2 * g(N, 2) - 0.6, x)
    mask = g(N) < 0.9
    X32, x32 = X_w.float().contiguous(), x.float().contiguous()
    draws = torch.randint(0, N, (n_hyp, 6), generator=gen, device=dev)
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    idx = order[draws % torch.clamp(mask.sum(), min=6)]
    thr = 8.0 / 460.0
    Rk, tk, ck, ik = mvg.pnp_hypotheses(X32, x32, mask, idx, thr)
    Rp, tp, cp, ip_ = mvg.pnp_hypotheses_plain(X32.double(), x32.double(), mask, idx, thr)
    srt = torch.sort(idx, dim=1).values
    full = (srt[:, 1:] != srt[:, :-1]).all(1) & mask[idx].all(1)
    err18 = max(float((Rk - Rp)[full].abs().max()), float((tk - tp)[full].abs().max()))
    counts_same = bool(torch.equal(ck[full], cp[full]))
    chosen = int(torch.argmax(ck)), int(torch.argmax(cp))
    log(f"K18 pnp_hypotheses: {int(full.sum())} full-rank of {n_hyp}, counts equal: "
        f"{counts_same} (tol: exact), R/t max |kernel - f64 twin| = {err18:.3e} (tol 1e-6), "
        f"chosen {chosen} with {int(ck.max())} of {int(mask.sum())} inliers")
    if not (counts_same and err18 <= 1e-6 and chosen[0] == chosen[1]
            and bool(full[chosen[0]])):
        fail("K18 pnp_hypotheses disagrees with its plain version")
    n_s = 6
    record(rec, "pnp_hypotheses", err18, lambda: mvg.pnp_hypotheses(X32, x32, mask, idx, thr),
           lambda: mvg.pnp_hypotheses_plain(X32, x32, mask, idx, thr), "pnp_kernel",
           N * (20 + 1) + n_hyp * n_s * 8 + n_hyp * (12 * 8 + 4 + N),
           # per hypothesis: A^T A over the sample, a 12x12 symmetric eigen-
           # decomposition with vectors (~9 n^3), a 3x3 SVD, N reprojections
           n_hyp * (n_s * 78 * 4 + 9 * 12 ** 3 + 400 + N * 30))

    # K19 at K = 256: r, H and g against jacfwd + J^T J in f64
    cfg = euroc_pose_graph()
    db = pgo_database(dev)
    K = db.p_vio.shape[0]
    x0 = torch.cat([db.yaw_pgo[:, None], db.p_pgo], 1)
    xk = x0 + 0.05 * (torch.rand(K, 4, generator=gen, device=dev) - 0.5)
    ypr = pg_mod._ypr_vio(db)
    rk, Hk, gk = pg_mod.pgo_normal(xk, db, ypr, cfg)
    rp, Hp, gp = pg_mod.pgo_normal_plain(xk, db, ypr, cfg)
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
    errs19 = dict(r=rel(rk, rp), H=rel(Hk, Hp), g=rel(gk, gp))
    err19 = max(errs19.values())
    log(f"K19 pgo4: K = {K}, {int(db.count)} keyframes, {int((db.loop_to >= 0).sum())} loop "
        f"edges: max |kernel - plain| / max |plain| {errs19} (tol 1e-12, f64)")
    if not err19 <= 1e-12:
        fail("K19 pgo4 disagrees with its plain version")
    spec = lm.SchurSpec(dense_dim=4 * K)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    solve_ms = time_ms(lambda: lm.schur_solve(Hk, gk, spec, lam))
    log(f"  the dense {4 * K} x {4 * K} f64 solve beside it (solver/lm.schur_solve, "
        f"torch.linalg Cholesky): {solve_ms:.4f} ms/call")
    n_e = K * (cfg.seq_edges + 2)
    record(rec, "pgo4", err19, lambda: pg_mod.pgo_normal(xk, db, ypr, cfg),
           lambda: pg_mod.pgo_normal_plain(xk, db, ypr, cfg), "pgo4_",
           K * 8 * 20 + K * 4 * 3 + 8 * (16 * K * K + 4 * K + 4 * n_e), n_e * (150 + 4 * 2 * 64))
    rec["pgo4"]["solve_ms"] = solve_ms
    TWIN_CALLS.clear()
    return rec


# ---------------------------------------------------------------------------
# phase 7: the loop-closure circuit at the profile's size
# ---------------------------------------------------------------------------

N_LOOP_LAP = 64  # keyframes a lap of the circuit
R_BC_INWARD = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))  # camera z = body x


def phase_loop_circuit(dev, n_lap=N_LOOP_LAP, cam=None, cfg=None, profile=False):
    """The loop-closure chain over 2 laps of loop_trajectory (radius 3 m,
    64 keyframes a lap) at 752x480 with the EuRoC camera, with the
    profile's PoseGraphConfig, the keyframes carrying a synthetic VIO drift
    (yaw walk 0.15 deg, translation walk 0.01 m, numpy seed 0): extract ->
    add -> retrieve -> candidate gate -> oldest-first verification ->
    record, then optimize_4dof and drift_correction.  Bars: >= 1 verified
    loop, each a true revisit (< 1.0 m), the PGO at least halves the last
    keyframe's position error.  Then the last loop's verification 3 times
    more with host-sync debugging on (and, with profile, under
    torch.profiler).  A CPU rehearsal passes a small camera, fewer
    keyframes a lap and a PoseGraphConfig of that size (no CUDA events)."""
    import torch

    from vplines_slam_tpu_torch.kernels import TWIN_CALLS, all_kernels
    from vplines_slam_tpu_torch.models import camera as cam_mod
    from vplines_slam_tpu_torch.models import pose_graph as pg_mod
    from vplines_slam_tpu_torch.utils import demo
    from vplines_slam_tpu_torch.utils import geometry as geo
    from vplines_slam_tpu_torch.utils import synthetic as syn

    f32, f64 = torch.float32, torch.float64
    on_card = torch.device(dev).type == "cuda"
    cfg = cfg or euroc_pose_graph()
    cam = cam or cam_mod.pinhole(461.6, 460.3, 363.0, 248.1, -2.917e-01, 8.228e-02, 5.333e-05,
                                 -1.578e-04, width=W, height=H, dtype=f32, device=dev)
    Hc, Wc = int(cam.height), int(cam.width)
    q_ic = geo.rot_to_quat(torch.tensor(R_BC_INWARD, dtype=f64, device=dev)).to(f32)
    p_ic = torch.zeros(3, dtype=f32, device=dev)
    rend = demo.BlobWorldRenderer(cam, q_ic, p_ic, n_pts=700, seed=4, dtype=f32, device=dev)
    traj = syn.loop_trajectory(radius=3.0)
    times = np.linspace(0.0, 60.0, 2 * n_lap, endpoint=False)
    rng = np.random.default_rng(0)
    lift = lambda xy: cam_mod.lift(cam, xy)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def window_points(q_wb, p_wb):
        q_cw, p_cw = geo.pose_inverse(*geo.pose_compose(q_wb, p_wb, q_ic, p_ic))
        Xc = geo.transform_point(q_cw, p_cw, rend.X)
        uv, vis = cam_mod.project(cam, Xc)
        ok = (vis & (Xc[:, 2] > 0.5) & (uv[:, 0] >= 16) & (uv[:, 0] < Wc - 16)
              & (uv[:, 1] >= 16) & (uv[:, 1] < Hc - 16))
        idx = torch.argsort(torch.where(ok, Xc[:, 2], torch.full_like(Xc[:, 2], 1e9)),
                            stable=True)[:cfg.n_window_pts]
        return rend.X[idx], uv[idx], ok[idx]

    # truth, drift and frames first, so the timed chain runs on staged data
    staged = []
    yaw_d, t_d = 0.0, np.zeros(3)
    for t in times:
        tt = torch.tensor(float(t), dtype=f64, device=dev)
        q_gt, p_gt = traj.quat(tt).to(f32), traj.pos(tt).to(f32)
        yaw_d += rng.normal(0.0, 0.15)
        t_d = t_d + rng.normal(0.0, 0.01, 3)
        Rz = geo.ypr_to_rot(torch.tensor([yaw_d, 0.0, 0.0], dtype=f32, device=dev))
        td = torch.tensor(t_d, dtype=f32, device=dev)
        w3d, wxy, wv = window_points(q_gt, p_gt)
        staged.append(dict(p_gt=p_gt.cpu().numpy(), img=rend.render(q_gt, p_gt),
                           p_vio=Rz @ p_gt + td, q_vio=geo.rot_to_quat(Rz @ geo.quat_to_rot(q_gt)),
                           w3d=w3d @ Rz.T + td, wxy=wxy, wv=wv))
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    for k in all_kernels():
        k.launches = 0
    TWIN_CALLS.clear()
    db = pg_mod.empty_db(cfg, f32, dev)
    ev = {s: [] for s in ("extract", "retrieve", "verify", "pgo")}

    def timed(stage, fn):
        if not on_card:
            return fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        ev[stage].append((a, b))
        return out

    loops, n_verify = [], 0
    t0 = time.perf_counter()
    for k, kf in enumerate(staged):
        if k >= db.p_vio.shape[0]:
            db = pg_mod.grow_db(db)

        def extract(db=db, kf=kf):
            fb = pg_mod.extract_keyframe_features(kf["img"], lift, cfg,
                                                  window_xy=(kf["wxy"], kf["wv"]))
            return fb, pg_mod.add_keyframe(db, cfg, kf["p_vio"], kf["q_vio"], fb["sig"],
                                           fb["desc"], fb["kp_norm"], fb["kp_valid"],
                                           fb["wdesc"], kf["w3d"], kf["wv"])

        fb, db = timed("extract", extract)
        cand_i, cand_s, floor = (x.cpu().numpy() for x in timed(
            "retrieve", lambda db=db, fb=fb: pg_mod.retrieve_candidates(db, cfg, fb["sig"])))
        best = float(cand_s[0])
        if k <= cfg.skip_recent or best <= max(cfg.min_score, float(floor)):
            continue
        queue = sorted(int(c) for c, s in zip(cand_i, cand_s) if s >= best - cfg.rel_margin)
        for cand in queue:  # oldest first; the next one when a verification fails
            draws = torch.randint(0, cfg.n_window_pts, (256, 6), generator=gen, device=dev)
            lr = timed("verify", lambda cand=cand, draws=draws, db=db, fb=fb, kf=kf:
                       pg_mod.verify_loop(db, cfg, cand, fb["wdesc"], kf["w3d"], kf["wv"],
                                          kf["p_vio"], kf["q_vio"], draws, q_ic, p_ic))
            n_verify += 1
            if bool(lr.ok):
                db = pg_mod.record_loop(db, k, cand, lr.rel_t, lr.rel_yaw)
                loops.append((k, cand, int(lr.n_inliers), int(lr.n_matches)))
                break
    db2, out = timed("pgo", lambda: pg_mod.optimize_4dof(db, cfg))
    R_d, t_d = pg_mod.drift_correction(db2, cfg)
    sync()
    wall = time.perf_counter() - t0
    ms = {s: sum(a.elapsed_time(b) for a, b in v) for s, v in ev.items()}
    n_kf = len(staged)
    launches = {k.name: k.launches for k in loop_kernels()}
    gt = np.stack([kf["p_gt"] for kf in staged])
    err_before = np.linalg.norm(db.p_pgo[:n_kf].cpu().numpy() - gt, axis=1)
    err_after = np.linalg.norm(db2.p_pgo[:n_kf].cpu().numpy() - gt, axis=1)
    revisit = [float(np.linalg.norm(gt[k] - gt[c])) for k, c, _, _ in loops]
    log(f"  {n_kf} keyframes ({Wc}x{Hc}, {cfg.n_features} FAST + BRIEF, {cfg.n_window_pts} window "
        f"points, capacity {cfg.max_keyframes}, skip_recent {cfg.skip_recent}), "
        f"{n_verify} verifications, {len(loops)} loops: {[(k, c) for k, c, _, _ in loops]}")
    if loops:
        log(f"  loop inliers / matches: {[(i, m) for _, _, i, m in loops]}; true distance of "
            f"each loop's keyframes: max {max(revisit):.4f} m")
    log(f"  CUDA-event ms in all: extract + add {ms['extract']:.2f} ({ms['extract'] / n_kf:.3f} "
        f"per keyframe), retrieve {ms['retrieve']:.2f} ({ms['retrieve'] / n_kf:.3f} per "
        f"keyframe), verify {ms['verify']:.2f} ({ms['verify'] / max(n_verify, 1):.3f} per "
        f"verification), pgo {ms['pgo']:.2f} (one optimize_4dof, {cfg.pgo_iters} iterations); "
        f"wall {wall:.2f} s")
    log(f"  launches: {launches}; per keyframe: "
        f"{ {n: round(c / n_kf, 3) for n, c in launches.items()} }")
    log(f"  last keyframe's position error: before PGO {err_before[-1]:.4f} m, after "
        f"{err_after[-1]:.4f} m (bar: at most half); mean over keyframes {err_before.mean():.4f} "
        f"-> {err_after.mean():.4f} m; LM cost {float(out.cost0):.4f} -> {float(out.cost):.4f}")
    if on_card:
        loop_twin_check("loop-closure circuit")
    if on_card and loops:
        k, c = loops[-1][:2]
        kf = staged[k]
        wdesc = pg_mod.extract_keyframe_features(kf["img"], lift, cfg,
                                                 window_xy=(kf["wxy"], kf["wv"]))["wdesc"]
        draws = torch.randint(0, cfg.n_window_pts, (256, 6), generator=gen, device=dev)

        def verify_again():
            lr = pg_mod.verify_loop(db, cfg, c, wdesc, kf["w3d"], kf["wv"], kf["p_vio"],
                                    kf["q_vio"], draws, q_ic, p_ic)
            return bool(lr.ok)

        verify_again()
        torch.cuda.synchronize()
        n_again = 3
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t1 = time.perf_counter()
                for _ in range(n_again):
                    verify_again()
                wall_v = (time.perf_counter() - t1) / n_again
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message).lower() for w in caught) / n_again
        log(f"  one verification again ({k} onto {c}): {1e3 * wall_v:.2f} ms wall with sync "
            f"debugging on, {syncs:.1f} host syncs (the final ok readback included)")
        if profile:
            from torch.profiler import ProfilerActivity, profile as tprofile

            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n_again):
                    verify_again()
                torch.cuda.synchronize()
            log("  torch.profiler, 3 verifications (top ops by host time):")
            for line in prof.key_averages().table(sort_by="cpu_time_total",
                                                  row_limit=14).splitlines():
                log("    " + line)
    if not loops:
        fail("phase 7: no loop verified")
    if not max(revisit) < 1.0:
        fail(f"phase 7: a loop is no true revisit ({max(revisit):.3f} m apart)")
    if not err_after[-1] <= 0.5 * err_before[-1]:
        fail("phase 7: the PGO did not halve the last keyframe's error")
    if not bool(torch.isfinite(t_d).all()):
        fail("phase 7: non-finite drift correction")
    if on_card and any(c == 0 for c in launches.values()):
        fail(f"phase 7: a kernel of the loop-closure path never launched: {launches}")
    return launches, dict(loops=len(loops), n_verify=n_verify, ms=ms, n_kf=n_kf,
                          err_before=float(err_before[-1]), err_after=float(err_after[-1]))


def estimator_check(plain, where):
    """The plain twins of K11-K14 ran (plain) or not at all (the kernels)."""
    from vplines_slam_tpu_torch.solver.lm import TWIN_CALLS

    calls = dict(TWIN_CALLS)
    log(f"  calls of the plain twins of K11-K14 (vmap/jvp, jacfwd, assemble, schur, "
        f"marg stage 1): {calls}")
    if plain and not calls:
        fail(f"{where}: the plain-twin run called no twin")
    if not plain and any(calls.values()):
        fail(f"{where}: the card path called a plain twin of K11-K14: {calls}")


def estimator_kernels():
    """K11-K14."""
    from vplines_slam_tpu_torch.estimator.linearize import WINDOW_LIN
    from vplines_slam_tpu_torch.solver.lm import SCHUR_SOLVE, WINDOW_BLOCKS
    from vplines_slam_tpu_torch.solver.marginalization import MARG_WINDOW

    return [WINDOW_LIN, WINDOW_BLOCKS, SCHUR_SOLVE, MARG_WINDOW]


def phase_slice(S, plain=False):
    """Phase 4; plain=True runs it on the plain twins of K11-K14 (the
    --estimator-witness run)."""
    if plain:
        with plain_estimator():
            return _slice(S, True)
    return _slice(S, False)


def _slice(S, plain):
    import torch

    from vplines_slam_tpu_torch.kernels import all_kernels
    from vplines_slam_tpu_torch.pipeline.device_loop import make_device_loop
    from vplines_slam_tpu_torch.utils import demo
    from vplines_slam_tpu_torch.utils.evaluation import ate_rmse

    cfg, tcfg = S["wcfg"], S["tcfg"]
    nf = cfg.nf
    t0 = time.perf_counter()
    fe, state, data = demo.truth_seeded_start(
        S["cam"], tcfg, cfg, S["params"], S["q_ic"], S["p_ic"],
        tuple(x[:nf] for x in S["truth"]), S["imgs"][: nf - 1],
        [b[: nf - 2] for b in S["batches"]], S["frame_t"].cpu().numpy(),
        1.0 / FRAME_HZ, S["ridx"][: nf - 1])
    torch.cuda.synchronize()
    log(f"warm-up: {nf - 1} frames in {time.perf_counter() - t0:.2f} s, "
        f"{int((data.pt_id >= 0).sum())} tracks, {int(data.pt_solved.sum())} triangulated")

    loop = make_device_loop(S["cam"], tcfg, cfg, S["params"])
    carry = loop.init_carry(fe, state, data)
    s0, s1 = nf - 1, nf - 1 + N_STEADY
    sl = slice(s0, s1)
    args = (S["imgs"][sl], tuple(b[s0 - 1: s1 - 1] for b in S["batches"]),
            torch.full((N_STEADY,), 1.0 / FRAME_HZ, device=S["imgs"].device),
            S["ridx"][sl])

    from vplines_slam_tpu_torch.models.imu import PREINTEGRATE

    from vplines_slam_tpu_torch.utils.stats import SPANS

    from vplines_slam_tpu_torch.solver.lm import TWIN_CALLS

    # the point front-end's (K1-K4), K10 and the estimator's (K11-K14)
    kernels = all_kernels()[:5] + [PREINTEGRATE] + ([] if plain else estimator_kernels())
    for k in all_kernels():
        k.launches = 0
    TWIN_CALLS.clear()
    torch.cuda.synchronize()
    SPANS.start()
    t0 = time.perf_counter()
    carry, outs = loop.run(carry, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    SPANS.stop()
    estimator_check(plain, "points slice")
    launches = {k.name: k.launches for k in kernels}
    log(f"launches during the run: {launches}")
    unexpected = {k.name: k.launches for k in all_kernels() if k not in kernels and k.launches}
    if unexpected:
        fail(f"the points-only path (CLAHE off) launched other kernels: {unexpected}")

    p, q, v, is_kf, failure, cost = (o.cpu() for o in outs)
    per = SPANS.per_frame_ms()
    fe_ms = np.array([d["frontend"] for d in per])
    be_ms = np.array([d["track_step"] for d in per])
    # the first frames pay one-time costs (cuSOLVER/cuBLAS handles, caching
    # allocator growth); the steady figures skip them
    st = slice(4, None)
    ms_frame = 1e3 * wall / N_STEADY
    log(f"slice: {N_STEADY} frames in {wall:.3f} s -> {ms_frame:.2f} ms/frame, "
        f"{N_STEADY / wall:.2f} frames/s (first frame included)")
    log(f"  per-frame CUDA-event split, frames 5..{N_STEADY}: front end median "
        f"{np.median(fe_ms[st]):.2f} ms, track_step median {np.median(be_ms[st]):.2f} ms, "
        f"sum median {np.median(fe_ms[st] + be_ms[st]):.2f} ms")
    log(f"  keyframes {int(is_kf.sum())}/{N_STEADY}, failures {int(failure.sum())}, "
        f"ba_cost median {float(cost.median()):.4f}")

    # host syncs per frame, on extra frames (not part of the counted run)
    e0, e1 = s1, s1 + N_SYNC
    extra = (S["imgs"][e0:e1], tuple(b[e0 - 1: e1 - 1] for b in S["batches"]),
             torch.full((N_SYNC,), 1.0 / FRAME_HZ, device=S["imgs"].device),
             S["ridx"][e0:e1])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop.run(carry, *extra)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]
    log(f"  host syncs: {len(syncs) / N_SYNC:.1f} per frame (over {N_SYNC} frames)")

    gt_p = S["truth"][0][sl].cpu().numpy()
    ate = ate_rmse(p.numpy(), gt_p, align=True)
    log(f"  ATE (aligned) {ate:.4f} m over {N_STEADY} frames (bar 0.25 m)")

    if any(n == 0 for n in launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if bool(failure.any()):
        fail("failure flag raised during the run")
    if not bool(torch.isfinite(cost).all()):
        fail("non-finite BA cost")
    if not bool(torch.isfinite(p).all() & torch.isfinite(q).all() & torch.isfinite(v).all()):
        fail("non-finite pose output")
    if p.shape != (N_STEADY, 3) or q.shape != (N_STEADY, 4):
        fail(f"unexpected output shapes {tuple(p.shape)} {tuple(q.shape)}")
    if not ate < 0.25:
        fail(f"ATE {ate:.4f} m >= 0.25 m")
    return launches, dict(ms_frame=ms_frame, fe_ms=float(np.median(fe_ms[st])),
                          be_ms=float(np.median(be_ms[st])), ate=ate,
                          syncs=len(syncs) / N_SYNC), (
        lambda: loop.run(carry, *extra), N_SYNC, np.median(fe_ms[st] + be_ms[st]))


def phase_lines(S, plain=False):
    """Phase 5: the lines-on device loop on the same world; plain=True runs
    it on the plain twins of K11-K14."""
    if plain:
        with plain_estimator():
            return _lines(S, True)
    return _lines(S, False)


def _lines(S, plain):
    import torch

    from vplines_slam_tpu_torch.kernels import all_kernels
    from vplines_slam_tpu_torch.pipeline.device_loop import make_device_loop
    from vplines_slam_tpu_torch.utils import demo
    from vplines_slam_tpu_torch.utils.evaluation import ate_rmse

    cfg, tcfg, lcfg = S["wcfg"], S["tcfg"], S["lcfg"]
    nf = cfg.nf
    t0 = time.perf_counter()
    fe, state, data, ln = demo.truth_seeded_start(
        S["cam"], tcfg, cfg, S["params"], S["q_ic"], S["p_ic"],
        tuple(x[:nf] for x in S["truth"]), S["imgs"][: nf - 1],
        [b[: nf - 2] for b in S["batches"]], S["frame_t"].cpu().numpy(),
        1.0 / FRAME_HZ, S["ridx"][: nf - 1], line_cfg=lcfg, map_xy=S["map_xy"],
        vp_u=S["vp_u"][: nf - 1])
    torch.cuda.synchronize()
    log(f"lines warm-up: {nf - 1} frames in {time.perf_counter() - t0:.2f} s, "
        f"{int((data.pt_id >= 0).sum())} point tracks, {int((data.ln_id >= 0).sum())} line tracks")

    loop = make_device_loop(S["cam"], tcfg, cfg, S["params"], line_cfg=lcfg, map_xy=S["map_xy"])
    carry = loop.init_carry(fe, state, data, ln)
    n = N_STEADY_LINES
    s0, s1 = nf - 1, nf - 1 + n
    sl = slice(s0, s1)
    dts = lambda k: torch.full((k,), 1.0 / FRAME_HZ, device=S["imgs"].device)
    args = (S["imgs"][sl], tuple(b[s0 - 1: s1 - 1] for b in S["batches"]), dts(n),
            S["ridx"][sl], S["vp_u"][sl])

    from vplines_slam_tpu_torch.ops.image import CLAHE_APPLY, CLAHE_LUT

    from vplines_slam_tpu_torch.utils.stats import SPANS

    from vplines_slam_tpu_torch.solver.lm import TWIN_CALLS

    idle = ((CLAHE_LUT, CLAHE_APPLY) + tuple(loop_kernels())
            + (tuple(estimator_kernels()) if plain else ()))
    kernels = [k for k in all_kernels() if k not in idle]  # CLAHE off, no loop closure
    for k in all_kernels():
        k.launches = 0
    TWIN_CALLS.clear()
    torch.cuda.synchronize()
    SPANS.start()
    t0 = time.perf_counter()
    carry, outs = loop.run(carry, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    SPANS.stop()
    estimator_check(plain, "lines slice")
    launches = {k.name: k.launches for k in kernels}
    log(f"launches during the lines run: {launches}")
    data = carry[3]
    solved = int(data.ln_solved.sum())
    vp_live = int((data.ln_vp_mask & (data.ln_solved & (data.ln_id >= 0))[:, None]).sum())

    p, q, v, is_kf, failure, cost = (o.cpu() for o in outs)
    per = SPANS.per_frame_ms()
    fe_ms, ln_ms, be_ms = (np.array([d[k] for d in per])
                           for k in ("frontend", "line_frontend", "track_step"))
    st = slice(4, None)
    ms_frame = 1e3 * wall / n
    log(f"lines slice: {n} frames in {wall:.3f} s -> {ms_frame:.2f} ms/frame, "
        f"{n / wall:.2f} frames/s (first frame included)")
    log(f"  per-frame CUDA-event split, frames 5..{n}: point front end median "
        f"{np.median(fe_ms[st]):.2f} ms, remap + line tracker median {np.median(ln_ms[st]):.2f} ms, "
        f"track_step median {np.median(be_ms[st]):.2f} ms, sum median "
        f"{np.median(fe_ms[st] + ln_ms[st] + be_ms[st]):.2f} ms")
    log(f"  keyframes {int(is_kf.sum())}/{n}, failures {int(failure.sum())}, "
        f"ba_cost median {float(cost.median()):.4f}; at the end: {solved} solved lines, "
        f"{int((data.ln_id >= 0).sum())} line tracks, {vp_live} VP-valid observations of "
        f"solved lines")

    e0, e1 = s1, s1 + N_SYNC
    extra = (S["imgs"][e0:e1], tuple(b[e0 - 1: e1 - 1] for b in S["batches"]), dts(N_SYNC),
             S["ridx"][e0:e1], S["vp_u"][e0:e1])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop.run(carry, *extra)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]
    log(f"  host syncs: {len(syncs) / N_SYNC:.1f} per frame (over {N_SYNC} frames)")

    ate = ate_rmse(p.numpy(), S["truth"][0][sl].cpu().numpy(), align=True)
    log(f"  ATE (aligned) {ate:.4f} m over {n} frames (bar 0.25 m)")
    if any(c == 0 for c in launches.values()):
        fail(f"a kernel of the lines path never launched: {launches}")
    if bool(failure.any()):
        fail("failure flag raised during the lines run")
    if not bool(torch.isfinite(cost).all()):
        fail("non-finite BA cost in the lines run")
    if not bool(torch.isfinite(p).all() & torch.isfinite(q).all() & torch.isfinite(v).all()):
        fail("non-finite pose output in the lines run")
    if p.shape != (n, 3) or q.shape != (n, 4):
        fail(f"unexpected output shapes {tuple(p.shape)} {tuple(q.shape)}")
    if not ate < 0.25:
        fail(f"lines ATE {ate:.4f} m >= 0.25 m")
    if solved == 0:
        fail("no line was solved in the lines run")
    return launches, dict(ms_frame=ms_frame, fe_ms=float(np.median(fe_ms[st])),
                          ln_ms=float(np.median(ln_ms[st])), be_ms=float(np.median(be_ms[st])),
                          ate=ate, syncs=len(syncs) / N_SYNC, solved=solved, vp_live=vp_live), (
        lambda: loop.run(carry, *extra), N_SYNC, np.median(fe_ms[st] + ln_ms[st] + be_ms[st]))


# ---------------------------------------------------------------------------
# phase 6: cold start through SlamSystem on the EuRoC profile's values
# ---------------------------------------------------------------------------

EUROC_T0 = 1403636579.763555  # s: a MH_01 stamp, so the stamps are EuRoC-epoch
N_INIT_MAX = 16  # frames by which the VIO must have initialized
N_TRACK = 20  # tracked frames after the initializing one
# configs/euroc.yaml, written out (PyYAML is not a dependency of this script)
EUROC_R_BC = ((0.0148655429818, -0.999880929698, 0.00414029679422),
              (0.999557249008, 0.0149672133247, 0.025715529948),
              (-0.0257744366974, 0.00375618835797, 0.999660727178))
EUROC_P_BC = (-0.0216401454975, -0.064676986768, 0.00981073058949)


def stage_cold(dev, n_frames, world=None):
    """The EuRoC profile's system and a cold-start stream: 200 Hz IMU samples
    (host numpy) and 10 Hz rendered frames from t = 0 of the figure-8.  The
    body frame is mounted as EuRoC's (x up, z forward): the figure-8 attitude
    composed with the fixed rotation that points the EuRoC camera where the
    renderer's forward camera looks."""
    import torch

    from vplines_slam_tpu_torch.estimator.window import WindowConfig
    from vplines_slam_tpu_torch.models import camera as cam_mod
    from vplines_slam_tpu_torch.models import feature_tracker as ft_mod
    from vplines_slam_tpu_torch.models import imu as imu_mod
    from vplines_slam_tpu_torch.models import line_tracker as lt_mod
    from vplines_slam_tpu_torch.ops.lines import LineDetectConfig
    from vplines_slam_tpu_torch.utils import demo
    from vplines_slam_tpu_torch.utils import geometry as geo
    from vplines_slam_tpu_torch.utils import synthetic as syn

    f32, f64 = torch.float32, torch.float64
    cam = cam_mod.pinhole(461.6, 460.3, 363.0, 248.1, -2.917e-01, 8.228e-02,
                          5.333e-05, -1.578e-04, width=W, height=H, dtype=f32, device=dev)
    R_bc = torch.tensor(EUROC_R_BC, dtype=f64, device=dev)
    q_ic, p_ic = geo.rot_to_quat(R_bc), torch.tensor(EUROC_P_BC, dtype=f64, device=dev)
    q_fwd, _ = demo.forward_camera_extrinsic(f64, dev)
    q_fix = geo.rot_to_quat(geo.quat_to_rot(q_fwd) @ R_bc.T)
    fig8 = syn.figure8_trajectory(radius=1.2, ypr_amp=(12.0, 5.0, 4.0))
    traj = syn.Trajectory(pos=fig8.pos, quat=lambda t: geo.quat_mul(fig8.quat(t), q_fix))
    r = IMU_HZ // FRAME_HZ
    imu_rel = torch.arange((n_frames - 1) * r + 1, dtype=f64, device=dev) / IMU_HZ
    accs, gyrs = syn.imu_samples(traj, imu_rel)
    frame_rel = imu_rel[::r]
    p_gt, q_gt, v_gt = syn.ground_truth_states(traj, frame_rel)
    rend = demo.BlobWorldRenderer(cam, q_ic.to(f32), p_ic.to(f32), n_pts=700, seed=4,
                                  dtype=f32, device=dev, **(world or {}))
    imgs = torch.stack([rend.render(q_gt[k], p_gt[k]) for k in range(n_frames)])
    imu_t = EUROC_T0 + imu_rel.cpu().numpy()
    return dict(
        cam=cam, q_ic=q_ic.to(f32), p_ic=p_ic.to(f32), imgs=imgs, p_gt=p_gt.cpu().numpy(),
        v_gt=v_gt.cpu().numpy(),
        imu_t=imu_t, frame_t=imu_t[::r], accs=accs.cpu().numpy(), gyrs=gyrs.cpu().numpy(),
        params=imu_mod.default_params(f32, dev),  # configs/euroc.yaml imu block
        # configs/euroc.yaml estimator block (WindowConfig's defaults)
        wcfg=WindowConfig(max_points=128, max_lines=32, max_imu=64, min_parallax=10.0 / 460.0,
                          ba_iters=8, line_sqrt_info=1500.0, vp_sqrt_info=10.0,
                          line_min_obs=5),
        # frontend block: max_cnt 150, min_dist 30, F_threshold 1.0, CLAHE on
        tcfg=ft_mod.TrackerConfig(max_features=150, min_dist=30, f_threshold=1.0,
                                  equalize=True),
        # line_frontend block: 64 lines, h/v caps 25/25, min length 35, fit
        # error 1.8, VPs on (the fast preset), CLAHE on
        lcfg=lt_mod.LineTrackerConfig(max_lines=64, max_h=25, max_v=25,
                                      detect=LineDetectConfig(min_len=35.0, fit_err=1.8),
                                      equalize=True, use_vp=True),
    )


def use_draws(sysm, gen_device, seed):
    """Give the system's three random draws (the point tracker's RANSAC
    samples, the line tracker's VP pair uniforms, the initializer's SfM
    samples) generators on gen_device seeded with seed; the draws move to
    the system's device.  With the CPU and seed 0 they are a CPU run's."""
    import types

    import torch

    for obj, name in ((sysm.frontend, "ransac_draws"), (sysm.line_frontend, "vp_draws"),
                      (sysm.vio, "sfm_draws")):
        shim = types.SimpleNamespace(cfg=obj.cfg, device=torch.device(gen_device),
                                     _gen=torch.Generator(device=gen_device).manual_seed(seed))
        draw = getattr(type(obj), name)
        setattr(obj, name, lambda draw=draw, shim=shim: draw(shim).to(sysm.device))


@contextlib.contextmanager
def plain_twins_of_k9_k10():
    """Run CLAHE and preintegration through their plain twins, on the card."""
    from vplines_slam_tpu_torch.models import feature_tracker as ft_mod
    from vplines_slam_tpu_torch.models import imu as imu_mod
    from vplines_slam_tpu_torch.models import line_tracker as lt_mod
    from vplines_slam_tpu_torch.ops import image

    def pre_plain(dts, accs, gyrs, mask, ba, bg, params):
        if dts.dim() == 1:
            return imu_mod.Preintegration(*(x[0] for x in imu_mod.preintegrate_plain(
                *(x[None] for x in (dts, accs, gyrs, mask, ba, bg)), params)))
        return imu_mod.preintegrate_plain(dts, accs, gyrs, mask, ba, bg, params)

    saved = ft_mod.clahe, lt_mod.clahe, imu_mod.preintegrate
    ft_mod.clahe = lt_mod.clahe = image.clahe_plain
    imu_mod.preintegrate = pre_plain
    try:
        yield
    finally:
        ft_mod.clahe, lt_mod.clahe, imu_mod.preintegrate = saved


def phase_cold_start(C, profile=False, draws=None, plain=False):
    """Phase 6: SlamSystem from a cold start with the profile's loop closure,
    fill -> initializer -> tracking, with every kernel's launches counted
    over the run.  Works on CPU tensors too (a rehearsal: no events, no sync count).
    The witness runs of --cold-witness pass draws=(generator device, seed)
    for ``use_draws``, or plain=True for ``plain_twins_of_k9_k10``."""
    if plain:
        with plain_twins_of_k9_k10():
            return _cold_start(C, profile, draws, plain)
    return _cold_start(C, profile, draws, plain)


def _cold_start(C, profile, draws, plain):
    import torch

    from vplines_slam_tpu_torch.kernels import all_kernels
    from vplines_slam_tpu_torch.models.imu import PREINTEGRATE
    from vplines_slam_tpu_torch.native import available as native_available
    from vplines_slam_tpu_torch.ops.image import CLAHE_APPLY, CLAHE_LUT
    from vplines_slam_tpu_torch.pipeline.system import SlamSystem
    from vplines_slam_tpu_torch.utils.evaluation import ate_rmse, umeyama_alignment
    from vplines_slam_tpu_torch.utils.stats import SPANS

    on_card = C["imgs"].is_cuda
    dev = C["imgs"].device
    sysm = SlamSystem(C["cam"], C["wcfg"], C["tcfg"], C["lcfg"], pg_cfg=euroc_pose_graph(),
                      imu_params=C["params"], q_ic=C["q_ic"], p_ic=C["p_ic"],
                      use_loop_closure=True, dtype=torch.float32, device=dev)
    if draws is not None:
        use_draws(sysm, *draws)
    log(f"cold start: SlamSystem on the EuRoC profile's values (loop closure on: "
        f"{sysm.pg_cfg.n_features} FAST + BRIEF per keyframe, skip_recent "
        f"{sysm.pg_cfg.skip_recent}), native IMU synchronizer: {native_available()}, stamps "
        f"from {C['frame_t'][0]:.6f} s")
    n_total = C["imgs"].shape[0]
    imu_t, accs, gyrs, frame_t = C["imu_t"], C["accs"], C["gyrs"], C["frame_t"]
    state = dict(i=0)

    def feed(j):
        while state["i"] < len(imu_t) and imu_t[state["i"]] <= frame_t[j]:
            sysm.add_imu(imu_t[state["i"]], accs[state["i"]], gyrs[state["i"]])
            state["i"] += 1
        return sysm.add_image(frame_t[j], C["imgs"][j])

    def sync():
        if on_card:
            torch.cuda.synchronize()

    from vplines_slam_tpu_torch.kernels import TWIN_CALLS as LOOP_TWIN_CALLS
    from vplines_slam_tpu_torch.solver.lm import TWIN_CALLS

    for k in all_kernels():
        k.launches = 0
    TWIN_CALLS.clear()
    LOOP_TWIN_CALLS.clear()
    outs, walls, init_frame, init_wall = [], [], None, None
    j = 0
    t_track = None
    while j < n_total and (init_frame is None or j <= init_frame + N_TRACK):
        sync()
        t0 = time.perf_counter()
        out = feed(j)
        sync()
        walls.append(time.perf_counter() - t0)
        if out is not None:
            outs.append(out)
        if init_frame is None and sysm.vio.initialized:
            init_frame, init_wall = j, walls[-1]
            init_scale, init_speed = init_window_check(sysm, C)
            log(f"  initialized at frame {j} ({frame_t[j] - frame_t[0]:.1f} s into the "
                f"stream), the initializing call took {init_wall:.2f} s; the initialized "
                f"window against the truth: scale truth/estimate {init_scale:.4f}, mean "
                f"speed truth/estimate {init_speed:.4f}")
            if on_card:
                SPANS.start()  # add_image opens a span group per frame
            t_track = time.perf_counter()
        elif init_frame is not None and not sysm.vio.initialized:
            fail(f"failure flag: the VIO rebooted at frame {j}")
        if init_frame is None and j + 1 >= N_INIT_MAX:
            fail(f"the VIO did not initialize within {N_INIT_MAX} frames")
        j += 1
    last = sysm.flush()
    if last is not None:
        outs.append(last)
    sync()
    SPANS.stop()
    if on_card:
        estimator_check(False, "cold start")
        loop_twin_check("cold start")
    if init_frame is None:
        fail("the stream ended before the VIO initialized")
    n_tracked = j - 1 - init_frame
    track_wall = time.perf_counter() - t_track
    ms_frame = 1e3 * track_wall / n_tracked
    launches = {k.name: k.launches for k in all_kernels()}
    log(f"  launches during the cold-start run ({j} frames): {launches}")
    log(f"  fill + init: {init_frame + 1} frames in {sum(walls[:init_frame + 1]):.2f} s; "
        f"tracking: {n_tracked} frames in {track_wall:.3f} s -> {ms_frame:.2f} ms/frame "
        f"(add_image returns the previous frame's output; flush included)")
    split = {}
    if on_card:
        per = SPANS.per_frame_ms()[2:]  # the first tracked frames pay one-time costs
        spans = dict(frontend=("frontend",), line_frontend=("line_frontend",),
                     clahe=(CLAHE_LUT.name, CLAHE_APPLY.name), vio=("vio",),
                     preintegrate=(PREINTEGRATE.name,), loop_stage=("loop_stage",),
                     lc_extract=("lc_extract",), lc_retrieve=("lc_retrieve",))
        split = {k: float(np.median([sum(d.get(n, 0.0) for n in names) for d in per]))
                 for k, names in spans.items()}
        lc_sum = {k: float(sum(d.get(k, 0.0) for d in per))
                  for k in ("loop_stage", "lc_extract", "lc_retrieve")}
        log(f"  per-frame CUDA-event split, tracked frames 3..{n_tracked}: point front end "
            f"median {split['frontend']:.2f} ms, line front end (remap + line tracker) "
            f"{split['line_frontend']:.2f} ms, of which the two clahe calls {split['clahe']:.3f} "
            f"ms, VIO step {split['vio']:.2f} ms, of which preintegrate "
            f"{split['preintegrate']:.3f} ms; loop stage median {split['loop_stage']:.3f} ms "
            f"(over these frames in all: loop stage {lc_sum['loop_stage']:.2f} ms, of which "
            f"extract + add {lc_sum['lc_extract']:.2f} ms, retrieve "
            f"{lc_sum['lc_retrieve']:.2f} ms)")
        split["lc_sum"] = lc_sum
    # every output is one frame's pose; the initializing frame's is the
    # second-newest window frame, the others the newest
    ts = np.array([o.t for o in outs])
    idx = np.searchsorted(frame_t, ts - 1e-6)
    p_est = np.stack([o.p_vio for o in outs])
    p_gt = C["p_gt"][idx]
    ate = ate_rmse(p_est, p_gt, align=True)
    # the metric scale of the run, read as the similarity alignment's scale
    # (truth/estimate), what is left of the error once it is removed, and
    # how the rigidly aligned error develops over the run
    scale = umeyama_alignment(p_est, p_gt, with_scale=True)[2]
    ate_sim3 = ate_rmse(p_est, p_gt, align=True, with_scale=True)
    R, t, _ = umeyama_alignment(p_est, p_gt)
    err = np.linalg.norm(p_est @ R.T + t - p_gt, axis=1)
    data = sysm.vio.data
    solved = int(data.ln_solved.sum())
    n_kf = sum(o.is_keyframe for o in outs)
    log(f"  outputs {len(outs)}, keyframes {n_kf}, failures 0, solved lines at the end "
        f"{solved}, point tracks {int((data.pt_id >= 0).sum())}; ATE (aligned) {ate:.4f} m "
        f"over {len(outs)} frames (bar 0.25 m); scale truth/estimate {scale:.4f}, ATE "
        f"after a sim(3) alignment {ate_sim3:.4f} m; aligned error at the initializing "
        f"frame {err[0]:.4f} m, median {np.median(err):.4f} m, last {err[-1]:.4f} m, largest "
        f"{err.max():.4f} m at output {int(err.argmax())}")
    res = dict(init_frame=init_frame, init_s=init_wall, ms_frame=ms_frame, ate=ate,
               scale=scale, ate_sim3=ate_sim3, init_scale=init_scale, init_speed=init_speed,
               err_first=err[0], err_last=err[-1], solved=solved, split=split,
               n_tracked=n_tracked, syncs=None)
    if on_card:
        n_extra = min(N_SYNC, n_total - j)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for k in range(j, j + n_extra):
                    feed(k)
                sysm.flush()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]
        res["syncs"] = len(syncs) / max(n_extra, 1)
        log(f"  host syncs: {res['syncs']:.1f} per frame (over {n_extra} frames)")
        j += n_extra
        if profile and j + N_SYNC <= n_total:
            j0 = j

            def run_profiled():
                for k in range(j0, j0 + N_SYNC):
                    feed(k)
                sysm.flush()

            res["profile"] = (run_profiled, N_SYNC,
                              split["frontend"] + split["line_frontend"] + split["vio"])
    n_kf_db = sysm._db_count
    loop_l = {k.name: k.launches for k in loop_kernels()}
    lc_ms = sysm.stats.timers.mean("loop_stage")
    log(f"  loop closure: {n_kf_db} keyframes inserted, loop_stage timer mean {lc_ms:.3f} ms "
        f"per drain; launches of K15-K17: {loop_l}")
    res["n_kf_db"], res["loop_stage_ms"], res["loop_launches"] = n_kf_db, lc_ms, loop_l
    # no loop can close within skip_recent keyframes: verification, PnP and
    # the pose graph stay idle, and the corrected pose is the VIO pose
    idle = {k.name for k in loop_kernels()[2:3] + loop_kernels()[4:]}
    if plain:
        idle |= {CLAHE_LUT.name, CLAHE_APPLY.name, PREINTEGRATE.name}
    if n_kf_db == 0:
        fail("the cold-start run inserted no keyframe into the loop-closure database")
    if not all(np.array_equal(o.p_corrected, o.p_vio) for o in outs):
        fail("p_corrected differs from p_vio although no loop closed")
    if any(c == 0 for n, c in launches.items() if n not in idle):
        fail(f"a kernel of the cold-start path never launched: {launches}")
    if not np.all(np.isfinite(p_est)):
        fail("non-finite pose output in the cold-start run")
    if not all(np.isfinite(o.ba_cost) for o in outs):
        fail("non-finite BA cost in the cold-start run")
    if len(outs) != n_tracked + 1:
        fail(f"{len(outs)} outputs for {n_tracked} tracked frames + the initializing one")
    if not ate < 0.25:
        fail(f"cold-start ATE {ate:.4f} m >= 0.25 m")
    return launches, res


def init_window_check(sysm, C):
    """The window the initializer left against the truth at its frames'
    stamps: the similarity alignment's scale of its positions and the ratio
    of the mean true speed to the mean estimated one (1 = the right metric
    scale)."""
    from vplines_slam_tpu_torch.utils.evaluation import umeyama_alignment

    st, data = sysm.vio.state, sysm.vio.data
    k = np.searchsorted(C["frame_t"], data.frame_t.cpu().numpy() - 1e-6)
    p, v = st.p.cpu().numpy(), st.v.cpu().numpy()
    scale = umeyama_alignment(p, C["p_gt"][k], with_scale=True)[2]
    speed = np.linalg.norm(C["v_gt"][k], axis=1).mean() / np.linalg.norm(v, axis=1).mean()
    return scale, speed


def phase_cold_witness(C):
    """Phase 6 again, changing one thing at a time, to tell the kernels from
    the random draws in its ATE: the plain twins of K9/K10 in place of the
    kernels; the draws a CPU run of phase 6 makes (CPU generators, seed 0);
    the card's generators at seeds 1-3.  A run that fails its bars is
    logged, not fatal: these runs are diagnostics, not part of phase 6."""
    runs = [("plain twins of K9/K10, card draws seed 0", dict(plain=True)),
            ("kernels, CPU draws seed 0", dict(draws=("cpu", 0)))]
    runs += [(f"kernels, card draws seed {s}", dict(draws=("cuda", s))) for s in (1, 2, 3)]
    out = []
    for label, kw in runs:
        log(f"cold-start witness: {label}")
        try:
            _, r = phase_cold_start(C, **kw)
            res = (f"init frame {r['init_frame']} (window scale truth/estimate "
                   f"{r['init_scale']:.4f}, speed {r['init_speed']:.4f}), ATE {r['ate']:.4f} m "
                   f"over {r['n_tracked'] + 1} frames, scale truth/estimate {r['scale']:.4f}, "
                   f"sim(3) ATE {r['ate_sim3']:.4f} m, aligned error first / last "
                   f"{r['err_first']:.4f} / {r['err_last']:.4f} m, {r['solved']} solved lines")
        except SystemExit:
            res = "failed (see the message above)"
        out.append(f"{label}: {res}")
    for line in out:
        log(f"  witness: {line}")


def phase_estimator_witness(S, SL, C, sl, ll, cs, t_start):
    """Phases 4-6 again on the kernels (each must repeat its ATE to the last
    printed digit: K12-K14 reduce in a fixed order), then phases 4-5 on the
    plain twins of K11-K14 in the same call (ATE within 0.01 m of the
    kernels')."""
    runs = [("points slice", lambda: phase_slice(S)[1], sl),
            ("lines slice", lambda: phase_lines(SL)[1], ll),
            ("cold start", lambda: phase_cold_start(C)[1], cs)]
    for label, run, first in runs:
        log(f"[{time.perf_counter() - t_start:.0f} s] estimator witness: {label} again, kernels")
        again = run()
        same = f"{again['ate']:.4f}" == f"{first['ate']:.4f}"
        log(f"  witness: {label} ATE {first['ate']:.4f} m, again {again['ate']:.4f} m, "
            f"ms/frame {first['ms_frame']:.2f} / {again['ms_frame']:.2f}: "
            f"{'repeats' if same else 'DIFFERS'}")
        if not same:
            fail(f"the {label} did not repeat its ATE on the kernels")
    for label, run, first in (("points slice", lambda: phase_slice(S, plain=True)[1], sl),
                              ("lines slice", lambda: phase_lines(SL, plain=True)[1], ll)):
        log(f"[{time.perf_counter() - t_start:.0f} s] estimator witness: {label}, plain twins "
            f"of K11-K14")
        pl = run()
        d = abs(pl["ate"] - first["ate"])
        log(f"  witness: {label} ATE kernels {first['ate']:.4f} m, plain twins {pl['ate']:.4f} m "
            f"(|diff| {d:.4f}, bar 0.01 m); ms/frame {first['ms_frame']:.2f} against "
            f"{pl['ms_frame']:.2f}, track_step median {first['be_ms']:.2f} against "
            f"{pl['be_ms']:.2f} ms, host syncs/frame {first['syncs']:.1f} against "
            f"{pl['syncs']:.1f}")
        if not d <= 0.01:
            fail(f"the {label}'s ATE on the plain twins is {d:.4f} m from the kernels'")


def phase_profile(run, n, frame_ms):
    """torch.profiler over n extra frames driven by run() (the same frames
    ran once already, so the run is warm).

    Device busy time is the union of the device-activity intervals (kernels,
    memcpy, memset), so overlapping activities count once.  frame_ms is the
    unprofiled per-frame median from CUDA events: the profiler inflates host
    time, not device time, so busy/frame_ms estimates the unprofiled share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        fail("the profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3 / n
    n_kern = sum(not e.name.startswith(("Memcpy", "Memset")) for e in dev) / n
    n_launch = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel") / n
    log(f"profile ({n} frames): wall {wall_ms:.2f} ms/frame under the profiler, "
        f"device busy {busy_ms:.2f} ms/frame (union of {len(dev) / n:.0f} device "
        f"activities/frame) = {100 * busy_ms / wall_ms:.2f}% of the profiled wall, "
        f"{100 * busy_ms / frame_ms:.2f}% of the unprofiled {frame_ms:.2f} ms/frame; "
        f"{n_kern:.0f} kernels and {n_launch:.0f} cudaLaunchKernel calls per frame")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phase 3)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile each slice's extra frames with torch.profiler")
    ap.add_argument("--estimator-witness", action="store_true",
                    help="after phase 6, run phases 4-6 again with the kernels (their ATE "
                         "must repeat) and phases 4-5 with the plain twins of K11-K14 "
                         "(their ATE within 0.01 m of the kernels')")
    ap.add_argument("--cold-witness", action="store_true",
                    help="after phase 6, run it again with the plain twins of K9/K10, with "
                         "a CPU run's draws, and with other draw seeds (ATE of each)")
    args = ap.parse_args(argv)
    if not (ROOT / "vplines_slam_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout: vplines_slam_tpu_torch/ is missing beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = phase_toolchain()
    phase_build()
    from vplines_slam_tpu_torch.estimator.window import WindowConfig

    nf = WindowConfig().nf
    t0 = time.perf_counter()
    S = stage(dev, nf - 1 + N_STEADY + N_SYNC)
    SL = stage(dev, nf - 1 + N_STEADY_LINES + N_SYNC, world=LINE_WORLD, t0=LINE_T0)
    n_cold = N_INIT_MAX + N_TRACK + 1 + N_SYNC * (2 if args.profile else 1)
    C = None if args.kernels_only else stage_cold(dev, n_cold, world=LINE_WORLD)
    torch.cuda.synchronize()
    log(f"staged {S['imgs'].shape[0]} + {SL['imgs'].shape[0]} + "
        f"{0 if C is None else C['imgs'].shape[0]} frames {W}x{H} + IMU in "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 3: kernels against their plain twins")
    rec = phase_kernels(S, SL)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 3, loop closure: K15-K19")
    phase_loop_kernels(rec, S)
    t0 = time.perf_counter()
    windows = {"points": estimator_window(S, False), "lines": estimator_window(SL, True)}
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 3, estimator: K11-K14 on the windows "
        f"of the two slices' warm-ups + {N_EST_FRAMES} frames on the plain twins (staged in "
        f"{time.perf_counter() - t0:.1f} s)")
    phase_estimator_kernels(rec, windows)
    del windows
    if args.kernels_only:
        device_times(rec)
        return
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 4: points slice")
    _, sl, prof_points = phase_slice(S)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 5: lines slice")
    _, ll, prof_lines = phase_lines(SL)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 6: cold start")
    launches, cs = phase_cold_start(C, profile=args.profile)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 7: the loop-closure circuit")
    loop_launches, lc = phase_loop_circuit(dev, profile=args.profile)
    if args.cold_witness:
        log(f"[{time.perf_counter() - t_start:.0f} s] phase 6 witness runs")
        phase_cold_witness(C)
    if args.estimator_witness:
        phase_estimator_witness(S, SL, C, sl, ll, cs, t_start)
    # profiler sessions last: they slow every later launch of the process
    log(f"[{time.perf_counter() - t_start:.0f} s] kernel device times (torch.profiler)")
    device_times(rec)
    if args.profile:
        log(f"[{time.perf_counter() - t_start:.0f} s] profile of the points slice:")
        phase_profile(*prof_points)
        log(f"[{time.perf_counter() - t_start:.0f} s] profile of the lines slice:")
        phase_profile(*prof_lines)
        if "profile" in cs:
            log(f"[{time.perf_counter() - t_start:.0f} s] profile of the cold-start system's "
                f"tracked frames:")
            phase_profile(*cs["profile"])
    log(f"[{time.perf_counter() - t_start:.0f} s] done")

    from vplines_slam_tpu_torch.kernels import all_kernels

    # launches: K1-K14 from the cold-start run (phase 6), K15-K19 from the
    # loop-closure circuit (phase 7), the path that drives all of them
    kernels_json = []
    for k in all_kernels():
        short = k.name.removeprefix("vp_")
        r = rec[short]
        kernels_json.append(dict(
            name=short, route="cuda", source=k.source, replaces=k.replaces,
            launches=loop_launches.get(k.name, launches[k.name]), max_abs_err=r["err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], device_ms=r["device_ms"],
            **({"solve_ms": r["solve_ms"]} if "solve_ms" in r else {})))
    log(f"summary (points): {sl['ms_frame']:.2f} ms/frame, front end {sl['fe_ms']:.2f} ms, "
        f"track_step {sl['be_ms']:.2f} ms, {sl['syncs']:.1f} host syncs/frame, "
        f"ATE {sl['ate']:.4f} m")
    log(f"summary (lines): {ll['ms_frame']:.2f} ms/frame, point front end {ll['fe_ms']:.2f} ms, "
        f"remap + line tracker {ll['ln_ms']:.2f} ms, track_step {ll['be_ms']:.2f} ms, "
        f"{ll['syncs']:.1f} host syncs/frame, ATE {ll['ate']:.4f} m, {ll['solved']} solved "
        f"lines, {ll['vp_live']} VP-valid observations")
    sp = cs["split"]
    log(f"summary (cold start): initialized at frame {cs['init_frame']} in "
        f"{cs['init_s']:.2f} s, {cs['ms_frame']:.2f} ms/frame over {cs['n_tracked']} tracked "
        f"frames, CUDA-event medians: point front end {sp['frontend']:.2f} ms, line front end "
        f"{sp['line_frontend']:.2f} ms, clahe x2 {sp['clahe']:.3f} ms, VIO {sp['vio']:.2f} ms, "
        f"preintegrate {sp['preintegrate']:.3f} ms; {cs['syncs']:.1f} host syncs/frame, "
        f"ATE {cs['ate']:.4f} m (scale truth/estimate {cs['scale']:.4f}, sim(3) ATE "
        f"{cs['ate_sim3']:.4f} m), {cs['solved']} solved lines; loop closure: "
        f"{cs['n_kf_db']} keyframes inserted, loop_stage {cs['loop_stage_ms']:.3f} ms per drain, "
        f"loop-stage CUDA events {sp['lc_sum']['loop_stage']:.2f} ms over the tracked frames")
    ms7 = lc["ms"]
    log(f"summary (loop-closure circuit): {lc['n_kf']} keyframes, {lc['n_verify']} "
        f"verifications, {lc['loops']} loops; CUDA-event ms extract + add "
        f"{ms7['extract'] / lc['n_kf']:.3f}/keyframe, retrieve {ms7['retrieve'] / lc['n_kf']:.3f}"
        f"/keyframe, verify {ms7['verify'] / max(lc['n_verify'], 1):.3f}/verification, pgo "
        f"{ms7['pgo']:.2f}; last keyframe's error {lc['err_before']:.4f} -> "
        f"{lc['err_after']:.4f} m")
    log(smi)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
