#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vplines_slam_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--kernels-only] [--profile]

Phases (any failure exits nonzero; there is no CPU path):
  1. toolchain: torch/CUDA versions, nvcc, triton, the card's name and power limit;
  2. build: compiles csrc/*.cu with nvcc into one library (timed);
  3. kernels: each CUDA kernel against its plain PyTorch twin on the card, at
     the main paths' shapes, with the tolerance stated, the wrapper's and the
     plain version's time per call (CUDA events), the kernel's device time
     (torch.profiler) and its bound (bytes over 3.35 TB/s or f32 operations
     over 67 TFLOP/s, from this run's inputs);
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
     Phase 3 checks the line kernels on these frames.
  --kernels-only stops after phase 3; --profile adds a torch.profiler run of
  each slice's extra frames (device busy share, launches per frame, top ops).
  Every profiler session (those and the kernels' device times) runs after
  the slices: once the profiler has run, each later launch of the process
  costs more.
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
F32_FLOP_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
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
    """(bound_ms, bound_by): the larger of the HBM and f32-compute times."""
    t_b, t_f = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
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
                                    detect=LineDetectConfig(min_len=35.0, fit_err=1.8))
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

    return rec


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def phase_slice(S):
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

    kernels = all_kernels()[:5]  # the point front-end's (K1-K4)
    for k in all_kernels():
        k.launches = 0
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, outs = loop.run(carry, *args, stage_events=events)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"launches during the run: {launches}")
    unexpected = {k.name: k.launches for k in all_kernels()[5:] if k.launches}
    if unexpected:
        fail(f"the points-only path launched line kernels: {unexpected}")

    p, q, v, is_kf, failure, cost = (o.cpu() for o in outs)
    fe_ms = np.array([e[0].elapsed_time(e[1]) for e in events])
    be_ms = np.array([e[1].elapsed_time(e[2]) for e in events])
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
        loop, carry, extra, np.median(fe_ms[st] + be_ms[st]))


def phase_lines(S):
    """Phase 5: the lines-on device loop on the same world."""
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

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, outs = loop.run(carry, *args, stage_events=events)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"launches during the lines run: {launches}")
    data = carry[3]
    solved = int(data.ln_solved.sum())
    vp_live = int((data.ln_vp_mask & (data.ln_solved & (data.ln_id >= 0))[:, None]).sum())

    p, q, v, is_kf, failure, cost = (o.cpu() for o in outs)
    fe_ms = np.array([e[0].elapsed_time(e[1]) for e in events])
    ln_ms = np.array([e[1].elapsed_time(e[2]) for e in events])
    be_ms = np.array([e[2].elapsed_time(e[3]) for e in events])
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
        loop, carry, extra, np.median(fe_ms[st] + ln_ms[st] + be_ms[st]))


def phase_profile(loop, carry, extra, frame_ms):
    """torch.profiler over the extra frames (run once already, so warm).

    Device busy time is the union of the device-activity intervals (kernels,
    memcpy, memset), so overlapping activities count once.  frame_ms is the
    unprofiled per-frame median from CUDA events: the profiler inflates host
    time, not device time, so busy/frame_ms estimates the unprofiled share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = extra[0].shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run(carry, *extra)
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
    args = ap.parse_args(argv)
    if not (ROOT / "vplines_slam_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout: vplines_slam_tpu_torch/ is missing beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
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
    torch.cuda.synchronize()
    log(f"staged {S['imgs'].shape[0]} + {SL['imgs'].shape[0]} frames {W}x{H} + IMU in "
        f"{time.perf_counter() - t0:.2f} s")
    rec = phase_kernels(S, SL)
    if args.kernels_only:
        device_times(rec)
        return
    _, sl, prof_points = phase_slice(S)
    launches, ll, prof_lines = phase_lines(SL)
    # profiler sessions last: they slow every later launch of the process
    if args.profile:
        log("profile of the points slice:")
        phase_profile(*prof_points)
        log("profile of the lines slice:")
        phase_profile(*prof_lines)
    device_times(rec)

    from vplines_slam_tpu_torch.kernels import all_kernels

    # launches: the lines slice's run, which drives every kernel (phase 4
    # checked the point kernels on the points-only path)
    kernels_json = []
    for k in all_kernels():
        short = k.name.removeprefix("vp_")
        r = rec[short]
        kernels_json.append(dict(
            name=short, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[k.name], max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            device_ms=r["device_ms"]))
    log(f"summary (points): {sl['ms_frame']:.2f} ms/frame, front end {sl['fe_ms']:.2f} ms, "
        f"track_step {sl['be_ms']:.2f} ms, {sl['syncs']:.1f} host syncs/frame, "
        f"ATE {sl['ate']:.4f} m")
    log(f"summary (lines): {ll['ms_frame']:.2f} ms/frame, point front end {ll['fe_ms']:.2f} ms, "
        f"remap + line tracker {ll['ln_ms']:.2f} ms, track_step {ll['be_ms']:.2f} ms, "
        f"{ll['syncs']:.1f} host syncs/frame, ATE {ll['ate']:.4f} m, {ll['solved']} solved "
        f"lines, {ll['vp_live']} VP-valid observations")
    log(smi)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
