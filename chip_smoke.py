#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vplines_slam_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--kernels-only] [--profile]

Phases (any failure exits nonzero; there is no CPU path):
  1. toolchain: torch/CUDA versions, nvcc, triton, the card's name and power limit;
  2. build: compiles csrc/*.cu with nvcc into one library (timed);
  3. kernels: each CUDA kernel against its plain PyTorch twin on the card, at
     the main path's shapes, with the tolerance stated and both times;
  4. slice: the points-only device loop at EuRoC width (752x480, pinhole +
     radtan from configs/euroc.yaml) on a rendered figure-8 blob world:
     truth-seeded warm-up, then >= 40 frames through ``make_device_loop().run``
     with every kernel's launch count read around that run; asserts no
     failure flag, finite BA cost and aligned ATE < 0.25 m.
  --kernels-only stops after phase 3; --profile adds a torch.profiler run of
  the slice's extra frames (device busy share, launches per frame, top ops).
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
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
N_STEADY = 44  # steady-state frames driven through run()
N_SYNC = 4  # extra frames run afterwards with sync debugging on
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


def stage(dev, n_frames):
    import torch

    from vplines_slam_tpu_torch.estimator.window import WindowConfig
    from vplines_slam_tpu_torch.models import camera as cam_mod
    from vplines_slam_tpu_torch.models import feature_tracker as ft_mod
    from vplines_slam_tpu_torch.models import imu as imu_mod
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
    frame_t = torch.arange(n_frames, dtype=f64, device=dev) / FRAME_HZ
    imu_t = torch.arange((n_frames - 1) * r + 1, dtype=f64, device=dev) / IMU_HZ
    accs, gyrs = syn.imu_samples(traj, imu_t)
    p_gt, q_gt, v_gt = syn.ground_truth_states(traj, frame_t)
    rend = demo.BlobWorldRenderer(cam, q_ic, p_ic, n_pts=700, seed=4, dtype=f32, device=dev)
    imgs = torch.stack([rend.render(q_gt[k], p_gt[k]) for k in range(n_frames)])
    batches = demo.imu_batches(accs.to(f32), gyrs.to(f32), 1.0 / IMU_HZ, r,
                               n_frames - 1, wcfg.max_imu)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ridx = torch.randint(0, tcfg.max_features, (n_frames, tcfg.ransac_hyps, 8),
                         generator=gen, device=dev)
    return dict(cam=cam, tcfg=tcfg, wcfg=wcfg, params=params, q_ic=q_ic, p_ic=p_ic,
                imgs=imgs, batches=batches, ridx=ridx, frame_t=frame_t,
                truth=(p_gt.to(f32), q_gt.to(f32), v_gt.to(f32)))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(S):
    import torch

    from vplines_slam_tpu_torch.ops import corners, image, klt, mvg
    from vplines_slam_tpu_torch.models import camera as cam_mod

    rec = {}
    img0, img1 = S["imgs"][0].contiguous(), S["imgs"][1].contiguous()
    cfg = S["tcfg"]

    # K1 pyr_down at 480x752 (and the second level)
    errs = []
    for im in (img0, image.pyr_down_plain(img0)):
        errs.append(float((image.pyr_down(im) - image.pyr_down_plain(im)).abs().max()))
    err = max(errs)
    tol = 1e-6
    log(f"K1 pyr_down: max |kernel - plain| = {err:.3e} (tol {tol})")
    if not err <= tol:
        fail("K1 pyr_down disagrees with its plain version")
    rec["pyr_down"] = dict(err=err, ms=time_ms(lambda: image.pyr_down(img0)),
                           plain_ms=time_ms(lambda: image.pyr_down_plain(img0)))

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
    lv0 = (pyr0[0], pyr1[0], xy0, torch.zeros_like(xy0), cfg.klt)
    rec["klt_track_level"] = dict(err=flow_err, ms=time_ms(lambda: klt._track_level(*lv0)),
                                  plain_ms=time_ms(lambda: klt._track_level_plain(*lv0)))

    # K3 corner response + cell selection, with the tracked features of frame 1
    pts1, ok1, _ = klt.track(img0, img1, xy0, cfg.klt)
    ok1 = ok1 & valid0
    ch, cw = -(-H // cfg.min_dist), -(-W // cfg.min_dist)
    occ = corners._occupied(pts1, ok1, cfg.min_dist, ch, cw, img1.device)
    resp_p = corners._nms(corners.min_eig_response(img1))
    nms = torch.empty_like(img1)
    gmax = torch.full((1,), -2**31, dtype=torch.int32, device=img1.device)
    from vplines_slam_tpu_torch import kernels as kmod

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
    rec["corner_response"] = dict(
        err=err_r, ms=time_ms(k3_response),
        plain_ms=time_ms(lambda: corners._nms(corners.min_eig_response(img1))))
    rec["corner_select"] = dict(
        err=err_s,
        ms=time_ms(lambda: corners._cell_best_cuda(img1, cfg.min_dist, cfg.quality, occ, 5)),
        plain_ms=time_ms(lambda: corners._cell_best_plain(img1, cfg.min_dist, cfg.quality, occ, 5)))

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
    rec["sampson_score"] = dict(
        err=float(dcount), ms=time_ms(lambda: mvg.sampson_score(Es, n0, n1, ok1, thr)),
        plain_ms=time_ms(lambda: mvg.sampson_score_plain(Es, n0, n1, ok1, thr)))
    for name, r in rec.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return rec


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def phase_slice(S, profile=False):
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
    log(f"launches during the run: {launches}")

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
    if profile:
        phase_profile(loop, carry, extra, np.median(fe_ms[st] + be_ms[st]))

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
                          syncs=len(syncs) / N_SYNC)


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
                    help="also profile the slice's extra frames with torch.profiler")
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

    n_frames = WindowConfig().nf - 1 + N_STEADY + N_SYNC
    t0 = time.perf_counter()
    S = stage(dev, n_frames)
    torch.cuda.synchronize()
    log(f"staged {n_frames} frames {W}x{H} + IMU in {time.perf_counter() - t0:.2f} s")
    rec = phase_kernels(S)
    if args.kernels_only:
        return
    launches, sl = phase_slice(S, args.profile)

    from vplines_slam_tpu_torch.kernels import all_kernels

    kernels_json = []
    for k in all_kernels():
        short = k.name.removeprefix("vp_")
        r = rec[short]
        kernels_json.append(dict(name=short, route="cuda", source=k.source,
                                 replaces=k.replaces, launches=launches[k.name],
                                 max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"]))
    log(f"summary: {sl['ms_frame']:.2f} ms/frame, front end {sl['fe_ms']:.2f} ms, "
        f"track_step {sl['be_ms']:.2f} ms, {sl['syncs']:.1f} host syncs/frame, "
        f"ATE {sl['ate']:.4f} m")
    log(smi)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
