#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vplines_slam_tpu_torch``) on one GPU.

Run from the root of a checkout:
  python3 chip_smoke.py [--kernels-only] [--profile] [--cold-witness] [--estimator-witness]
                        [--imu-witness] [--klt-witness] [--against TREE]

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
     K11 and K12 each called twice and equal to the last bit, K11's
     residual-only mode (the LM's cost pass) timed on its own, K12 also on
     the marginalization stack's layout and with every point anchored at
     frame 0 (1e-12), its yardstick the dense f64 J_d^T J_d (H_dd alone) on
     the same blocks scattered to dense;
     K13 at lambda 1e-4, 10 and 1e4 (1e-6 of the delta's largest entry),
     its product launch's S tiles and rhs against torch's f64 (1e-12), an
     indefinite S (all NaN from both) and two calls equal to the last bit,
     with each of its three launches' device time; K14 on both windows and
     with no points, no lines and neither (1e-9, two calls equal to the
     last bit, H1 symmetric to the last bit), its yardstick the elimination
     product alone (one f64 addmm on prebuilt columns).  A library call
     timed beside a kernel is also timed on the device (torch.profiler);
  4. points slice: the points-only device loop at EuRoC width (752x480,
     pinhole + radtan from configs/euroc.yaml) on a rendered figure-8 blob
     world: truth-seeded warm-up, then 44 frames through
     ``make_device_loop().run`` with the point kernels' launch counts read
     around that run; asserts no failure flag, finite BA cost and aligned
     ATE < 0.25 m;
  5. lines slice: the lines-on device loop (configs/euroc.yaml's estimator and
     line_frontend, equalize off): undistortion remap, line tracker (EDLine,
     matching, VPs) and the line/VP factors, among the same landmarks with
     the grid drawn as wide dark bands on a faint texture in a room of 3 m
     radius (LINES_ROOM: the line front end keeps a track a few frames, so
     a track reaches line_min_obs = 5 keyframes only where keyframes come
     about every frame; in the 8 m room no track first seen after the
     warm-up did), from t = 5 s of the figure-8; truth-seeded warm-up with
     both trackers, then 24 frames with every kernel's launch count read
     around that run; asserts as phase 4, plus solved lines > 0 at the end,
     one of them first seen after the warm-up.
     Phase 3 checks the line kernels on frames of the same textures in the
     8 m room (LINE_WORLD) from t = 2.5 s, where the figure-8 moves
     sideways to the camera.  Every K2 track call
     of phases 4-5 runs again on track_plain: ok agreement >= 0.99, max
     |pts1 diff| 1e-3 px in point mode and GAIN_BIAS_TRACK_TOL_PX (0.05 px)
     in gain/bias mode.  Phases 4-5 keep CLAHE
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
     keyframe and per verification (K21, the refinement) and the error
     before/after.  Its launch counts of K15-K19 and K21 go to the kernels
     JSON;
  8. selector cold start: phase 6's construction and stream with the
     attention feature selector on and configs/euroc.yaml's selector block
     (max_features 30, init_threshold 30) loaded by name through the port's
     load_profile; prints per tracked frame the candidates, tracked ids,
     budget, kept ids and the selector stage's CUDA-event ms; asserts phase
     6's bars, every tracked id kept, kept <= max(max_features, tracked), K20
     launched on every tracked frame, each frame's greedy pass as it ran
     against its twin on that frame's inputs, and K20's greedy pass against
     its twin on the last frame's real inputs with budget = max_features
     (twice, equal to the last bit).  Its launch counts of K20 go to the
     kernels JSON;
  9. calibration cold start: phase 6's construction on a stream of the
     figure-8 with the wiring test's attitude swing (CALIB_YPR_AMP), from a
     cold start with online calibration: (a) no q_ic (hand-eye mode 2),
     bars extrinsic_ok, q_ic within 3 degrees of R_BC, initialized within
     N_CALIB_EX frames, ATE < 0.15 m; (b) the profile's q_ic, estimate_td
     and the IMU stamped TD_TRUE late, bars td solved and finite,
     initialized within N_CALIB_TD frames, ATE < 0.15 m (|td - truth| is
     printed: on rendered frames the yaw-curve ICP does not resolve 4 ms);
     each then N_CALIB_TRACK tracked frames, printing the converging and
     initializing frames, ms and host syncs a fill and a tracked frame and
     the launches of K22-K24; every hand-eye solve, IMU curve push and the
     last time-offset solve of (a) and (b) run again through K22-K24's
     checks.  (c) VioEngine on tests/test_online_calib_wiring.py's ray
     stream (calib_ray_stream) in both modes with that test's bars (q_ic
     within 3 degrees, td within 2 ms, ATE < 0.15 m).  Each run asserts
     that K4 and its calibration kernels launched and that no plain twin
     ran.  Their launch counts of K22-K24 ((a) and (b)) go to the kernels
     JSON.
  Phase 3 holds K22 (gyro_yaw) on 64-step batches crossing +-pi, on
  half-masked batches, on a ring overflow (M = 16) and as
  integrate_gyro_yaw (1e-12, counts exact), K23 (time_offset) on
  test_calibration_selector's curve, on a half-filled accumulator with the
  padding, on the perp = 0 NaN case (NaN from both) and at the capacities
  (1e-12 relative on td, c and the RMS, ok exact), and K24 (hand_eye) on
  the 30-pair hand-eye set, a padded 64-slot set and a degenerate set at
  f64 and f32 (1e-10 / 1e-6 on q and sigma_3 where the set is determined,
  the flag exact); each called twice, equal to the bit, one launch a call.
  Phase 3 holds K1 as track calls it (both 3-level pyramids in one launch)
  against its plain twin (1e-6, two calls equal to the bit), also at 2
  (pyr_down) and 4 levels, 5 refused, and at 2-4 levels on 61x97 and 40x3
  images, the two at once (two launches) and the frame one float off a
  16-byte boundary (K1's scalar loads); every pyramid pair of phases 4-6 is
  kept (by reference) and built again afterwards (to the bit, 1e-6 to the
  twin), and each of phases 4-6 launches K1 exactly as often as K2 (one
  launch a track call).  It holds K8's vp_score on an all-zero grid (flat
  index 0) and on the line sets of vp_line_cases, two calls equal to the
  bit; every vp_score call of phases 5-6 runs again, equal to the bit.
  Phase 3 holds K2 as track calls it (every pyramid level and the gates in
  one launch) against track_plain on 150 points of a frame and on a lines
  frame's anchors in gain/bias mode, from a zero and from a nonzero initial
  flow (|pts1 diff| 1e-3 px where both are ok, ok agreement 0.99, two calls
  equal to the bit, one launch a call), and each level through
  _track_level; K9 (two calls equal to the bit) against its twin (1e-6) on
  a raw and an undistorted frame.
  Phase 3 also holds K10 on the interval layouts of
  utils/synthetic.imu_interval_cases (a frame's 20 live steps of 64, merged
  intervals within and past the capacity, no live step, masked steps
  between live ones, nine biased intervals) against its twin at f32 (1e-5)
  and f64 (1e-12), two calls equal to the bit, J = I and P = 0 exactly with
  no live step, and pins its handling of non-finite padding (a NaN sample
  read by masked steps only: K10 finite, the twin NaN; an inf dt in a
  masked slot: both NaN); and K8's vp_grid on the line sets of
  utils/synthetic.vp_line_cases (hundreds of votes in one cell, both wraps,
  no and one valid line, pairs on the gate): the twin's mass and two calls
  equal to the bit.  Every vp_grid call of phases 5 and 6 is kept (by
  reference) and run again afterwards: equal to the bit.
  Phase 3 also holds loop closure's kernels against their plain twins at the
  profile's sizes: K15 (detect_fast in two launches, fast_tiles and
  fast_select; fast_score in one) on a 752x480 frame and on the images of
  utils/synthetic.fast_cases at max_corners 1, 60 and 500 (xy, valid and the
  score map exact, each call again equal to the bit, the candidate counts
  logged; torch.topk of the kept map timed as the selection's partial
  yardstick) and K16 BRIEF on the 752x480 frame (exact),
  K17's 64 x 500 Hamming match in both gate settings and on the cases of
  utils/synthetic.match_cases (exact, one launch a match, two calls equal;
  the distance table as one f16 matmul of the +-1 bits timed as its library
  call; every match of phase 7 again afterwards, exact) and SimHash
  signature at N = 0, 1, 37, 500 and 1,000 with and without xy (codes
  exact, signature 1e-6, two calls equal to the bit; the projection matmul
  timed as its library call), K18's 256 PnP hypotheses against the f64 twin
  (full-rank counts and inliers exact, R/t 1e-6, the same chosen
  hypothesis; eigh on the [256, 12, 12] A^T A batch timed as its library
  call) and on the cases of utils/synthetic.pnp_cases, K19's residuals and
  normal equations at K = 256, on the databases of
  utils/synthetic.pgo_cases and at K = 1,024 (1e-12 of each one's largest
  entry, two calls equal to the bit; J^T J on the dense f64 Jacobian timed
  as its library call, the dense f64 solve beside it), every K19 call with
  H and every K18 call of phase 7 again afterwards (kept by reference),
  and K20 and K21: selector_info on 150 candidates of a staged 752x480 frame
  with the horizon from the truth and on the cases of
  utils/synthetic.selector_info_cases (1e-12 of each candidate's largest
  entry, one launch, two calls equal to the bit, N = 0 launching nothing;
  torch.zeros of the output timed as its partial yardstick, N = 1,000 timed
  beside it),
  selector_greedy at supports 12 (the main path's), 15 and 45, budgets 0,
  7, 30 and max_features 30, 60 (sets identical, gains 1e-9, two calls
  equal to the last bit; 30 rounds of batched slogdet on the 12x12 Schur
  form timed as its library call; one 45x45 slogdet round and the pass at
  supports 15 and 45 timed on the device beside it), pnp_refine on the
  initializer's 11 x 128 and a verification's 1 x 64 batches and on the
  cases of utils/synthetic.pnp_refine_cases (f64 twin 1e-9, f32 twin 1e-5,
  at one point the f64 twin on the f32 inputs 1e-6; two calls equal to the
  bit; one 6x6 solve_ex timed as its library call; every call of phase 7
  again afterwards, to the bit).
  Phase 3 holds K4, the whole ransac_essential with the tracker's gate in
  one launch (k4_check), on frame 0 -> 1 (32 x 150), on the cases of
  utils/synthetic.ransac_cases at f32 and f64 (the initializer's 64 x 128
  among them): one launch, two calls equal to the bit; in the call's own
  dtype every count and flag exactly K4's rounded Sampson test of its own
  E (sampson_rounded) and E, inl, n exactly the plain pick and choice on
  its own hypotheses and refit; at f64 each determined hypothesis's E
  (essential_determined) within 1e-9 of an f64 SVD of A and within the f64
  plain path's own eps/gap error of it, every count and flag exactly
  sampson_score_plain of its own E, the final outputs where winner and
  refit are determined; the f32 call's fits (and its refit where the
  winners' inliers agree) the f64 call's rounded to the bit; undetermined
  winners counted; times it
  beside torch.linalg.eigh on the [32, 9, 9] A^T A batch and counts host
  syncs a call.  Every ransac_essential call of phases 4-6 and 8 runs
  again through k4_check, each one launch and equal to the bit.
  Phase 3 holds K3 (detect: two launches, corner_cells and corner_topk)
  against its plain twin (the same valid positions, scores 1e-6) on frame 1
  with frame 0's tracks, on frame 0 and on the cases of
  utils/synthetic.corner_cases, each call repeated to the bit; and K16
  (one launch for a keyframe's 500 corners and 64 window points) against
  its twin, every bit, also on the cases of utils/synthetic.brief_cases,
  each set alone, twice and split in two.
  Every detect call of phases 4-6 and 8 and every keyframe's corners and
  descriptors of phases 6-8 run again, equal to the bit, with one launch of
  each kernel a call, against the twins (K3 as above, K15 and K16 every
  bit), and every selector_info call of phase 8 (one launch, to the bit,
  1e-12 of the twin).
  Phases 6-8 assert that no plain twin of K15-K21 ran.
  Phases 4-6 run the estimator through K11-K14 and assert that no plain twin
  of them (vmap of jvp, jacfwd, the plain assembly, Schur solve and
  marginalization) was called.
  --imu-witness runs phases 4-5 again with K10's plain twin (f32, on the
  card) and prints their ATE beside the kernel's; --klt-witness does the
  same with K2's (track_plain).
  Phase 3 holds K6 (line_anchors' fields and best cells, line_select_grow's
  walks: a_ok identical, supports exact, good flags 0.98, endpoints 0.05
  px) against its twins on a frame, a 61x97 crop of it, a constant and an
  all-zero frame, and K7 exactly against its twin on a frame's tracked
  anchors and the cases of utils/synthetic.line_vote_cases (ties of
  distance and of votes, no valid target, L1 = 32, one valid source,
  collinear midpoints, zero-length targets, the gate, the vote ratio),
  each launch again equal to the bit; every detect_lines and line_vote
  call of phases 5-6 runs again, equal to the bit.
  --against TREE (alias --vp-grid-against) builds TREE's csrc/pyr_down.cu,
  vp.cu, klt.cu, clahe.cu, lines.cu and line_match.cu (another checkout,
  e.g. the parent commit unpacked with git archive) and runs them on this
  tree's inputs in this process: its K1 to the bit on every level of phase
  3's pyramids and of every track call of phases 4-6, its vp_grid and
  vp_score to the bit on phase 3's inputs, the vp_line_cases sets and every
  lines frame of phases 5 and 6 (with vp_score's labels on its grid), its
  K9 (LUTs and output) to the bit on phase 3's frames and on every clahe
  call of phase 6, its track beside this tree's on phase 3's tracks, its
  K6 (fields, best values and indices, the walks on the a_ok slots,
  detect_lines' outputs) and K7 (match, n_votes) to the bit on phase 3's
  frames and K7 cases and on every lines frame of phases 5 and 6, its K3
  (the previous design: its response and cell-select launches behind
  _occupied, the sort and the gathers) to the bit on phase 3's calls and
  cases and every detect call of phases 4-6 and 8, and its K16 (the
  previous design: a full-frame blur and a descriptor launch, twice a
  keyframe) to the bit on phase 3's keyframe and cases and every keyframe
  of phases 6-8, its K15 (the previous design: a score and an NMS launch,
  then the stable sort and the glue) to the bit on phase 3's frame and
  cases and every keyframe of phases 6-8, and its K20 selector_info (the
  previous design: 64 threads a candidate, one thread's adjugate) to the
  bit on phase 3's candidates and cases and every call of phase 8, and its
  whole ransac_essential (the previous design: the tracker's host gate, the
  plain glue with batched eigh and svd around its vp_sampson_score) on
  phase 3's calls and every call of phases 4-6 and 8 (the calls with the
  same inliers counted); each is timed on the same inputs.
  --kernels-only stops after phase 3; --profile adds a torch.profiler run of
  4 extra frames of phases 4-6 (device busy share, launches per frame, top
  ops); --cold-witness runs phase 6 again with the plain twins of K9/K10,
  with a CPU run's random draws and with other draw seeds, and logs each
  run's ATE; --estimator-witness runs phases 4-6 again on the kernels (each
  must repeat its ATE) and phases 4-5 on the plain twins of K11-K14 (ATE
  within 0.01 m of the kernels').  Every profiler session (those and the
  kernels' device times) runs
  after phase 8: once the profiler has run, each later launch of the
  process costs more (so do the launch counts of one loop verification,
  one selector call, one detect call and one extract_keyframe_features
  call, each beside the other tree's (the selector call with its
  selector_info, the extraction with its K15 and K16), taken under
  torch.profiler at the end).
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
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
LINE_T0 = 2.5  # s: phase 3's line frames, where the figure-8 moves sideways to the camera
# phase 5's room: 3 m to the wall, so keyframes come about every frame and
# tracks that the line front end keeps for a few frames reach line_min_obs
LINES_ROOM = dict(LINE_WORLD, wall_radius=3.0, grid_band=0.35)
LINES_T0 = 5.0  # s: phase 5's start on the figure-8
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


def bound(bytes_moved, flops):
    """(bound_ms, bound_by): the larger of the HBM time and the compute time
    (f32 or f64 operations, both 67 TFLOP/s on the H100)."""
    t_b, t_f = bytes_moved / HBM_BYTES_PER_S, flops / FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def device_kernels(fn, n=20):
    """Device activity per call of fn over n calls (torch.profiler): {kernel
    or copy name: ms per call}.  Times a library call, whose kernels are
    not ours to name, and splits a wrapper into its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / n
    return out


def device_split(fn, kernel_fn_name, tries=3):
    """Device ms per call of each kernel of fn whose name contains
    kernel_fn_name (a substring of its symbol), from one profiler session
    (another one when a session records none of them); {} when none
    records them."""
    for _ in range(tries):
        split = {k: v for k, v in device_kernels(fn).items() if kernel_fn_name in k}
        if split:
            return split
    return {}


def record(rec, name, err, fn, plain_fn, kernel_fn_name, bytes_moved, flops, library_fn=None,
           library_label=None):
    """Time a kernel's wrapper against its plain twin (and a library call
    computing the same function, or the part of it library_label names,
    where there is one) and store the record;
    the device times (each launch's, and the library call's) are taken by
    ``device_times`` after the slices, because a profiler session slows
    every later launch of the process."""
    b_ms, b_by = bound(bytes_moved, flops)
    rec[name] = dict(err=float(err), ms=time_ms(fn), plain_ms=time_ms(plain_fn),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(library_fn) if library_fn is not None else None,
                     device_of=(fn, kernel_fn_name), library_of=library_fn,
                     library_label=library_label)


# device time per call of the designs the current K3, K16, K1, K2, K9, K8
# vp_grid and vp_score, K10, K11, K12, K13, K14, K17 signature, K20 greedy
# pass, K6 and K7 replaced (K3's response over 16x16 tiles and a CTA a cell
# for the selection, both kernels alone; K16's full-frame blur and
# descriptor launches, twice a keyframe; a launch a level and image, a
# thread per output pixel: the four
# launches of a track call's two 3-level pyramids; a launch of
# a 256-thread CTA per feature for each of three levels; a CTA per tile
# with shared atomics, then a thread per pixel; one CTA holding
# the whole grid; one CTA scoring every hypothesis; a CTA of 256 threads
# per interval over every step; five
# launches, a thread per observation carrying all its tangents; a CTA per
# node-pair tile scanning every row; two launches, one-CTA Cholesky; a
# thread per entry of H1 over every slot; one CTA over all descriptors;
# 2 x 30 + 1 launches of 45x45 LUs; a CTA per 16x16 cell; a warp per
# anchor slot after detect_lines' sort and gathers, its kernel alone; one
# 512-thread CTA with a thread per anchor slot; a 128-thread CTA per PnP
# hypothesis with one warp's cyclic Jacobi; a thread per 4x4 block of H,
# both launches; K17's match on one CTA, its kernel alone; K21 with jets in
# every lane; K15's score and NMS passes, a thread a pixel, without the sort
# and glue after them; K20's selector_info with 64 threads a candidate), on
# phase 3's inputs, on an NVIDIA H100 80GB HBM3 at 700 W,
# for the log beside the new ones
PREVIOUS_DEVICE_MS = {"corner_cells": 0.0089 + 0.0036, "brief_patch": 2 * 0.0098,
                      "pyramids": 0.0089, "klt_track": 3 * 0.0167,
                      "klt_track_gain_bias": 3 * 0.0247, "clahe": 0.0068 + 0.0048,
                      "vp_grid": 0.1962, "vp_score": 0.0202, "preintegrate": 0.1431, "window_lin": 0.1340,
                      "window_blocks": 0.6102, "schur_solve": 1.0662, "marg_window": 0.2403,
                      "simhash_signature": 0.1194, "selector_greedy": 4.8784,
                      "line_anchors": 0.0106, "line_select_grow": 0.0054, "line_vote": 0.0151,
                      "pnp_hypotheses": 0.2588, "pgo4": 0.1707, "hamming_match_tiles": 0.1023,
                      "pnp_refine": 0.0483, "fast_tiles": 0.0073 + 0.0061, "selector_info": 0.0081}


def device_times(rec):
    """Fill each record's device time (torch.profiler), per kernel and in
    all, and its library call's, and log the table."""
    for name, r in rec.items():
        fn, kname = r.pop("device_of")
        lib = r.pop("library_of")
        r["device_split"] = device_split(fn, kname)
        r["device_ms"] = sum(r["device_split"].values()) or None
        r["library_device_ms"] = (sum(device_kernels(lib).values()) if lib is not None
                                  else None)
        dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        label = r.pop("library_label")
        lib_s = ("" if lib is None else f", library call{f' ({label})' if label else ''} "
                 f"{r['library_ms']:.4f} ms/call (device {r['library_device_ms']:.4f} ms)")
        b_ms = f"{r['bound_ms']:.5f}" if r["bound_ms"] >= 1e-4 else f"{r['bound_ms']:.2e}"
        log(f"  {name}: kernel {r['ms']:.4f} ms/call (device {dms}), plain "
            f"{r['plain_ms']:.4f} ms, bound {b_ms} ms ({r['bound_by']}){lib_s}")
        if len(r["device_split"]) > 1 or name in PREVIOUS_DEVICE_MS:
            log(f"    its kernels' device ms: " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["device_split"].items())
                + (f" (the previous design: {PREVIOUS_DEVICE_MS[name]:.4f} ms in all)"
                   if name in PREVIOUS_DEVICE_MS else ""))
        for label, fn2 in r.pop("extra_device_of", {}).items():
            # (fn, calls it makes[, a substring of the kernels to count])
            fn2, calls, kname2 = (fn2 + (None,))[:3] if isinstance(fn2, tuple) else (fn2, 1, None)
            times = device_kernels(fn2) if kname2 is None else device_split(fn2, kname2)
            ms = sum(times.values()) / calls
            r.setdefault("extra_device_ms", {})[label] = ms
            log(f"    {label}: device {ms:.4f} ms")
        if "solve_of" in r:
            r["solve_device_ms"] = sum(device_kernels(r.pop("solve_of")).values())
            log(f"    the dense solve beside it: {r['solve_ms']:.4f} ms/call, device "
                f"{r['solve_device_ms']:.4f} ms, bound {r['solve_bound_ms']:.5f} ms "
                f"({r['solve_bound_by']})")


# --against: another tree's K1, K8 (vp_grid, vp_score), K2, K9, K6, K7, K3,
# K15, K16, K17's match, K18, K19, K20's selector_info and K21, as functions
# of this tree's arguments (OtherTree)
AGAINST = None
# calls whose launches main counts under torch.profiler at the end:
# {"detect": (this tree's, the other tree's or None), "extract": ...}
PROBES = {}


class OtherTree:
    """Kernels of another checkout (the parent commit's, say, unpacked with
    ``git archive``): its ``csrc/pyr_down.cu``, ``vp.cu``, ``klt.cu``,
    ``clahe.cu``, ``lines.cu``, ``line_match.cu``, ``corners.cu``,
    ``brief.cu``, ``pgo4.cu``, ``pnp.cu``, ``hamming.cu``, ``pnp_refine.cu``,
    ``fast.cu``, ``selector.cu`` and ``ransac.cu`` (or the previous
    design's ``sampson.cu``, K4's scoring alone, behind the plain glue and the
    tracker's host gate), each built into a library of its own
    beside this tree's build (one nvcc a source, all started together),
    called with this tree's arguments, so that the two designs run on the
    same inputs in one process.  K1 comes as the previous design's one-level entry
    (``vp_pyr_down``, a launch a level and image) or as this tree's
    ``vp_pyramids``; vp_score with this tree's arguments; K2 as the
    previous design's per-level entry (``vp_klt_track_level``, with
    ``track``'s level loop and gates around it here) or as this tree's
    fused entry; K9 as the previous design's two entries or this tree's
    one; K6's anchors through the same entry, its selection and walks as
    this tree's ``vp_line_select_grow`` or as the previous design's
    ``vp_line_grow`` behind ``detect_lines``' sort and gathers, and K7 with
    this tree's masks or behind the previous design's conversions (the two
    changed together); K15 as this design's two launches or as the previous
    design's ``vp_fast`` behind ``_top_corners``' sort and gathers; K3,
    K16, K18, K19, K20's selector_info (and K17's match and K21 as this
    design's) through the same C entries and arguments as this tree's."""

    def __init__(self, tree):
        import ctypes
        import hashlib

        from vplines_slam_tpu_torch import kernels as kmod

        self.tree = Path(tree).resolve()
        csrc = self.tree / "vplines_slam_tpu_torch" / "csrc"
        # K4: this design's ransac.cu, or the previous design's scoring kernel
        # (sampson.cu)
        self.k4 = "ransac" if (csrc / "ransac.cu").exists() else "sampson"
        srcs = {n: csrc / f"{n}.cu"
                for n in ("pyr_down", "vp", "klt", "clahe", "lines", "line_match", "corners",
                          "brief", "pgo4", "pnp", "hamming", "pnp_refine", "fast", "selector",
                          self.k4)}
        libs, procs = {}, {}
        kmod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for n, src in srcs.items():
            h = hashlib.sha256(src.read_bytes())
            h.update((src.parent / "common.cuh").read_bytes())
            libs[n] = kmod.BUILD_DIR / f"libother_{n}_{h.hexdigest()[:16]}.so"
            if not libs[n].exists():
                procs[n] = subprocess.Popen(
                    [kmod._nvcc(), *kmod.NVCC_FLAGS, "-shared", "-o", str(libs[n]), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, pr in procs.items():
            out = pr.communicate()[0]
            if pr.returncode != 0:
                fail(f"nvcc failed on {srcs[n]}:\n{out}")
        self.lib = {n: ctypes.CDLL(str(so)) for n, so in libs.items()}
        self.fns = {}
        # K17's match as vp_hamming_match_tiles, writing int64 indices from
        # bool masks (this design), or as vp_hamming_match, int32 ones behind
        # its wrapper's conversions (PR 5-15's).  K21's C entry kept its
        # arguments; its wrapper, which changed with K17's, views a bool mask
        # as bytes (this design) or converted it with a launch (PR 6-15's).
        self.match_int64 = self.has("hamming", "vp_hamming_match_tiles")
        self.refine_u8_launch = not self.match_int64
        from vplines_slam_tpu_torch.models import selector as sel
        from vplines_slam_tpu_torch.ops import brief, mvg

        # the wrappers as they are before any block swaps them for these
        self._refine = mvg.pnp_refine
        self._brief_pair, self._info = brief.describe_brief_pair, sel.feature_information
        log(f"the other tree's K1, vp_grid, vp_score, K2, K9, K6, K7, K3, K15, K16, K17's match, "
            f"K18, K19, K20's selector_info, K21 and K4 ({self.k4}.cu): {self.tree}")

    def _fn(self, lib, name, argtypes):
        import ctypes

        if name not in self.fns:
            fn = getattr(self.lib[lib], name)
            fn.argtypes = list(argtypes) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.fns[name] = fn
        return self.fns[name]

    def _call(self, lib, name, argtypes, *args):
        import torch

        err = self._fn(lib, name, argtypes)(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"the other tree's {name} failed to launch: error {err}")

    def has(self, lib, name):
        return hasattr(self.lib[lib], name)

    def vp_grid(self, line, length, angle, valid, cfg):
        import torch

        from vplines_slam_tpu_torch.ops import vp

        line, length, angle = line.contiguous(), length.contiguous(), angle.contiguous()
        valid8 = valid.to(torch.uint8).contiguous()
        grid = torch.empty(cfg.grid_la, cfg.grid_lo, dtype=line.dtype, device=line.device)
        self._call("vp", "vp_vp_grid", vp.VP_GRID.argtypes, line.data_ptr(), length.data_ptr(),
                   angle.data_ptr(), valid8.data_ptr(), line.shape[0], cfg.grid_la,
                   cfg.grid_lo, float(cfg.pair_angle_gate), grid.data_ptr())
        return grid

    def vp_score(self, grid, vp1, b1, b2, cos_s, sin_s, line, valid, cfg):
        """The other tree's vp_score (the same C entry and arguments)."""
        from vplines_slam_tpu_torch.ops import vp

        return self._swapped(vp.VP_SCORE, "vp", lambda: vp.vp_score(grid, vp1, b1, b2, cos_s,
                                                                     sin_s, line, valid, cfg))

    def pyramids(self, imgs, levels):
        """The other tree's K1 on one or two images of one shape: a pyramid
        (a list of levels) each; the previous design launches once a level
        and image."""
        import torch

        from vplines_slam_tpu_torch import kernels as kmod
        from vplines_slam_tpu_torch.ops import image

        if self.has("pyr_down", "vp_pyramids"):
            return self._swapped(image.PYRAMIDS, "pyr_down",
                                 lambda: image._pyramids_cuda(imgs, levels))
        out = []
        for im in imgs:
            pyr = [im]
            for _ in range(levels - 1):
                H, W = pyr[-1].shape
                dst = torch.empty((H + 1) // 2, (W + 1) // 2, dtype=im.dtype, device=im.device)
                self._call("pyr_down", "vp_pyr_down", [kmod.P, kmod.P] + [kmod.I] * 4,
                           pyr[-1].data_ptr(), dst.data_ptr(), H, W, dst.shape[0], dst.shape[1])
                pyr.append(dst)
            out.append(pyr)
        return out

    def track_level(self, img0, img1, pts0, guess, cfg):
        """The other tree's K2 on one level: (flow, ok, resid)."""
        import ctypes

        import torch

        from vplines_slam_tpu_torch import kernels as kmod

        if not self.has("klt", "vp_klt_track_level"):
            return self._track_fused([img0], [img1], pts0, guess, cfg, False)
        H, W = img0.shape
        N = pts0.shape[0]
        flow = torch.empty(N, 2, dtype=img0.dtype, device=img0.device)
        ok = torch.empty(N, dtype=torch.uint8, device=img0.device)
        resid = torch.empty(N, dtype=img0.dtype, device=img0.device)
        P, I, F = kmod.P, kmod.I, ctypes.c_float
        self._call("klt", "vp_klt_track_level",
                   [P, P, I, I, P, P, I, I, I, F, I, P, P, P], img0.data_ptr(), img1.data_ptr(),
                   H, W, pts0.contiguous().data_ptr(), guess.contiguous().data_ptr(), N,
                   cfg.win, cfg.iters, float(cfg.min_eig), int(cfg.illum_adapt),
                   flow.data_ptr(), ok.data_ptr(), resid.data_ptr())
        return flow, ok.bool(), resid

    def _swapped(self, kernel, lib, fn):
        """fn() with kernel's C entry taken from the other tree's library (the
        same name and arguments), its launch count left as it was."""
        saved, launches = kernel._fn, kernel.launches
        kernel._fn = self._fn(lib, kernel.name, kernel.argtypes)
        try:
            return fn()
        finally:
            kernel._fn, kernel.launches = saved, launches

    def _track_fused(self, pyr0, pyr1, pts0, flow0, cfg, gate):
        from vplines_slam_tpu_torch.ops import klt

        return self._swapped(klt.KLT_TRACK, "klt",
                             lambda: klt._track_cuda(pyr0, pyr1, pts0, flow0, cfg, gate))

    def track(self, img0, img1, pts0, cfg, init_flow=None):
        """The other tree's ``track``: its fused K2, or (the previous
        design) a launch of its per-level K2 a level inside ``track``'s
        level loop and gates, as that design's ``track`` ran them."""
        from vplines_slam_tpu_torch.ops import klt
        from vplines_slam_tpu_torch.ops.image import build_pyramid

        if self.has("klt", "vp_klt_track_level"):
            return klt.track_levels(img0, img1, pts0, cfg, init_flow, self.track_level)
        pyr0, pyr1 = build_pyramid(img0, cfg.levels), build_pyramid(img1, cfg.levels)
        return self._track_fused(pyr0, pyr1, pts0, init_flow, cfg, True)

    def clahe(self, img, clip=3.0, tiles=8, bins=32):
        """The other tree's K9: (out, luts)."""
        import torch

        from vplines_slam_tpu_torch import kernels as kmod
        from vplines_slam_tpu_torch.ops import image

        H, W = img.shape
        th, tw = H // tiles, W // tiles
        luts = torch.empty(tiles, tiles, bins, dtype=img.dtype, device=img.device)
        out = torch.empty_like(img)
        P, I, F = kmod.P, kmod.I, kmod.F
        limit = clip * th * tw / bins
        if self.has("clahe", "vp_clahe_lut"):
            self._call("clahe", "vp_clahe_lut", [P, I, I, I, I, I, F, P], img.data_ptr(), W,
                       tiles, th, tw, bins, limit, luts.data_ptr())
            self._call("clahe", "vp_clahe_apply", [P, P, I, I, I, I, I, I, P], img.data_ptr(),
                       luts.data_ptr(), H, W, tiles, th, tw, bins, out.data_ptr())
        else:
            return self._swapped(image.CLAHE, "clahe", lambda: image.clahe_cuda(img, clip, tiles,
                                                                                 bins))
        return out, luts


    def new_lines(self):
        """Whether the other tree's K6 selects its anchors in the walk's launch
        (and its K7 reads bool masks and writes int64 matches): this design."""
        return self.has("lines", "vp_line_select_grow")

    def line_anchors(self, img, cfg):
        """The other tree's K6 line_anchors (the same C entry and arguments)."""
        from vplines_slam_tpu_torch.ops import lines

        return self._swapped(lines.LINE_ANCHORS, "lines", lambda: lines._anchors_cuda(img, cfg))

    def line_select_grow(self, best_val, best_idx, mag, dx, dy, cfg):
        """The other tree's top cells and walks: (segs, lens, fits, supports,
        a_ok).  The previous design took the top-k in detect_lines (a stable
        sort and gathers: ``select_cells_plain``, the same ops) and walked
        every slot with ``vp_line_grow``."""
        import math

        import torch

        from vplines_slam_tpu_torch import kernels as kmod
        from vplines_slam_tpu_torch.ops import lines

        if self.new_lines():
            return self._swapped(lines.LINE_SELECT_GROW, "lines",
                                 lambda: lines._select_grow_cuda(best_val, best_idx, mag, dx,
                                                                 dy, cfg))
        dev, dtype = mag.device, mag.dtype
        ax, ay, a_ok = lines.select_cells_plain(best_val, best_idx, cfg, dtype)
        H, W = mag.shape
        A = ax.shape[0]
        segs = torch.empty(A, 4, dtype=dtype, device=dev)
        lens = torch.empty(A, dtype=dtype, device=dev)
        fits_n = torch.empty(2, A, dtype=dtype, device=dev)
        P, I, F = kmod.P, kmod.I, kmod.F
        self._call("lines", "vp_line_grow", [P, P, P, P, P, I, I, I, I, F, F, P, P, P],
                   ax.data_ptr(), ay.data_ptr(), mag.data_ptr(), dx.data_ptr(), dy.data_ptr(), H,
                   W, A, int(cfg.max_steps), float(cfg.grad_thresh),
                   float(math.cos(cfg.angle_tol)), segs.data_ptr(), lens.data_ptr(),
                   fits_n.data_ptr())
        return segs, lens, fits_n[0], fits_n[1], a_ok

    def detect_lines(self, img, cfg):
        """This tree's detect_lines with the other tree's K6 in place."""
        from vplines_slam_tpu_torch.ops import lines

        saved = lines.line_anchors, lines.line_select_grow
        lines.line_anchors, lines.line_select_grow = self.line_anchors, self.line_select_grow
        try:
            return lines.detect_lines(img, cfg)
        finally:
            lines.line_anchors, lines.line_select_grow = saved

    def line_vote(self, tracked, ok, segs0, valid0, segs1, valid1, cfg):
        """The other tree's K7: (match int64, n_votes).  The previous design
        took uint8 masks and wrote int32 matches, converted around it."""
        import torch

        from vplines_slam_tpu_torch.ops import line_match

        if self.new_lines():
            return self._swapped(line_match.LINE_VOTE, "line_match",
                                 lambda: line_match._line_vote_cuda(tracked, ok, segs0, valid0,
                                                                    segs1, valid1, cfg))
        L0, A = ok.shape
        L1 = segs1.shape[0]
        tracked, segs0, segs1 = tracked.contiguous(), segs0.contiguous(), segs1.contiguous()
        ok8, v08, v18 = (x.to(torch.uint8).contiguous() for x in (ok, valid0, valid1))
        match = torch.empty(L0, dtype=torch.int32, device=segs0.device)
        n_votes = torch.empty(L0, dtype=segs0.dtype, device=segs0.device)
        self._call("line_match", "vp_line_vote", line_match.LINE_VOTE.argtypes,
                   tracked.data_ptr(), ok8.data_ptr(), segs0.data_ptr(), v08.data_ptr(),
                   segs1.data_ptr(), v18.data_ptr(), L0, A, L1, float(cfg.max_point_line_dist),
                   float(cfg.vote_ratio), int(cfg.min_votes), match.data_ptr(),
                   n_votes.data_ptr())
        return match.long(), n_votes

    def grow_kernel(self):
        """The symbol of the other tree's walk kernel (device time)."""
        return "line_select_grow_kernel" if self.new_lines() else "line_grow_kernel"

    def detect(self, img, max_corners, min_dist=30, quality=0.01, existing_xy=None,
               existing_mask=None, border=5):
        """The other tree's ``detect``: its two K3 launches (this design), or
        the previous design's response and cell-select launches behind this
        tree's ``_occupied``, the stable sort and the gathers (``_top_cells``),
        as that design's ``detect`` ran them."""
        import torch

        from vplines_slam_tpu_torch import kernels as kmod
        from vplines_slam_tpu_torch.ops import corners

        if self.has("corners", "vp_corner_cells"):
            run = lambda: corners._detect_cuda(img, max_corners, min_dist, quality, existing_xy,
                                               existing_mask, border)
            return self._swapped(corners.CORNER_CELLS, "corners", lambda: self._swapped(
                corners.CORNER_TOPK, "corners", run))
        H, W = img.shape
        ch, cw = -(-H // min_dist), -(-W // min_dist)
        occ = corners._occupied(existing_xy, existing_mask, min_dist, ch, cw, img.device)
        nms = torch.empty_like(img)
        gmax = torch.full((1,), -2**31, dtype=torch.int32, device=img.device)
        P, I, F = kmod.P, kmod.I, kmod.F
        self._call("corners", "vp_corner_response", [P, I, I, P, P], img.data_ptr(), H, W,
                   nms.data_ptr(), gmax.data_ptr())
        occ8 = occ.to(torch.uint8).contiguous()
        best_val = torch.empty(ch, cw, dtype=img.dtype, device=img.device)
        best_idx = torch.empty(ch, cw, dtype=torch.int32, device=img.device)
        self._call("corners", "vp_corner_select", [P, P, P, I, I, I, I, F, I, I, P, P],
                   nms.data_ptr(), gmax.data_ptr(), occ8.data_ptr(), H, W, ch, cw,
                   float(quality), int(min_dist), int(border), best_val.data_ptr(),
                   best_idx.data_ptr())
        return corners._top_cells(best_val, best_idx.long(), min_dist, max_corners, img.dtype)

    def new_fast(self):
        """Whether the other tree's K15 is this design (two launches: tiles,
        selection)."""
        return self.has("fast", "vp_fast_tiles")

    def fast_score(self, img, thresh=0.05):
        """The other tree's K15 score map: this design's score mode, or the
        previous design's score launch (``vp_fast`` without the NMS)."""
        import torch

        from vplines_slam_tpu_torch import kernels as kmod
        from vplines_slam_tpu_torch.ops import brief

        if self.new_fast():
            return self._swapped(brief.FAST_TILES, "fast", lambda: brief._fast_cuda(img, thresh))
        H, W = img.shape
        img = img.contiguous()
        score = torch.empty_like(img)
        self._call("fast", "vp_fast", [kmod.P, kmod.I, kmod.I, kmod.F, kmod.I, kmod.P, kmod.P],
                   img.data_ptr(), H, W, float(thresh), 0, score.data_ptr(), score.data_ptr())
        return score

    def detect_fast(self, img, max_corners=500, thresh=0.05, nms_radius=3):
        """The other tree's ``detect_fast``: its two launches (this design),
        or the previous design's score and NMS launches (``vp_fast``), then
        the stable sort and the glue (``_top_corners``), as that design's
        ``detect_fast`` ran them."""
        import torch

        from vplines_slam_tpu_torch import kernels as kmod
        from vplines_slam_tpu_torch.ops import brief

        if self.new_fast():
            run = lambda: brief._fast_cuda(img, thresh, max_corners)
            return self._swapped(brief.FAST_TILES, "fast", lambda: self._swapped(
                brief.FAST_SELECT, "fast", run))
        H, W = img.shape
        img = img.contiguous()
        score, out = torch.empty_like(img), torch.empty_like(img)
        self._call("fast", "vp_fast", [kmod.P, kmod.I, kmod.I, kmod.F, kmod.I, kmod.P, kmod.P],
                   img.data_ptr(), H, W, float(thresh), 1, score.data_ptr(), out.data_ptr())
        return brief._top_corners(out, max_corners, img.dtype)

    def selector_info(self, *args, **kwargs):
        """The other tree's K20 selector_info (the same C entry and
        arguments)."""
        from vplines_slam_tpu_torch.models import selector as sel

        return self._swapped(sel.SELECTOR_INFO, "selector", lambda: self._info(*args, **kwargs))

    @contextlib.contextmanager
    def keyframe_features(self):
        """Keyframe extractions inside the block run the other tree's K15 and
        K16."""
        from vplines_slam_tpu_torch.ops import brief

        saved = brief.detect_fast, brief.describe_brief_pair
        brief.detect_fast, brief.describe_brief_pair = self.detect_fast, self.brief_pair
        try:
            yield
        finally:
            brief.detect_fast, brief.describe_brief_pair = saved

    @contextlib.contextmanager
    def selector(self):
        """Selector calls inside the block run the other tree's selector_info."""
        from vplines_slam_tpu_torch.models import selector as sel

        saved = sel.feature_information
        sel.feature_information = self.selector_info
        try:
            yield
        finally:
            sel.feature_information = saved

    def pgo_normal(self, x, db, ypr_vio, cfg):
        """The other tree's K19 with H: (r, H, g), the same C entry and
        argument struct."""
        from vplines_slam_tpu_torch.models import pose_graph as pg

        return self._swapped(pg.PGO4, "pgo4",
                             lambda: pg._pgo_normal_cuda(x, db, ypr_vio, cfg, True))

    def _sampson_score(self, Es, x1, x2, mask, threshold):
        """The previous design's K4 wrapper, ``sampson_score``: a CTA a hypothesis, the
        mask converted and the inliers returned as bool by launches."""
        import torch

        from vplines_slam_tpu_torch import kernels as kmod

        Hn, N = Es.shape[0], x1.shape[0]
        Es, x1, x2 = Es.contiguous(), x1.contiguous(), x2.contiguous()
        m8 = mask.to(torch.uint8).contiguous()
        counts = torch.empty(Hn, dtype=torch.int32, device=Es.device)
        inl = torch.empty(Hn, N, dtype=torch.uint8, device=Es.device)
        P, I = kmod.P, kmod.I
        self._call("sampson", "vp_sampson_score", [P, P, P, P, I, I, kmod.F, P, P],
                   Es.data_ptr(), x1.data_ptr(), x2.data_ptr(), m8.data_ptr(), Hn, N,
                   float(threshold) ** 2, counts.data_ptr(), inl.data_ptr())
        return counts, inl.bool()

    def ransac_essential(self, x1, x2, mask, draws, threshold, min_valid=0):
        """The other tree's whole ransac_essential with the tracker's gate:
        this design's one launch through the same C entry, or the previous
        design's: the gate read on the host (the tracker's ``int(sum(ok))
        >= 12``), then the plain glue (the stable argsort, the scatter,
        batched eigh and svd, twice) around its scoring kernel, twice."""
        import torch

        from vplines_slam_tpu_torch.ops import mvg

        if self.k4 == "ransac":
            return self._swapped(mvg.RANSAC_ESSENTIAL, "ransac", lambda: mvg.ransac_essential(
                x1, x2, mask, draws, threshold, min_valid))
        if min_valid and int(torch.sum(mask)) < min_valid:
            return (torch.zeros(3, 3, dtype=x1.dtype, device=x1.device), mask.clone(),
                    torch.sum(mask.to(torch.int32), dtype=torch.int32))
        saved = mvg.sampson_score_plain
        mvg.sampson_score_plain = self._sampson_score
        try:
            return mvg.ransac_essential_plain(x1, x2, mask, draws, threshold)
        finally:
            mvg.sampson_score_plain = saved

    def pnp_hypotheses(self, X_w, x, mask, idx, threshold):
        """The other tree's K18: (Rs, ts, counts, inls), the same C entry."""
        from vplines_slam_tpu_torch.ops import mvg

        return self._swapped(mvg.PNP_HYPOTHESES, "pnp",
                             lambda: mvg.pnp_hypotheses(X_w, x, mask, idx, threshold))

    def match(self, da, va, db, vb, max_dist=80, margin=0, mutual=False, want_d=False):
        """The other tree's K17 match: (idx int64, dist, d or None), this
        design's wrapper, or the previous design's C entry behind its
        wrapper's conversions (masks to uint8, the int32 index to int64:
        three more launches)."""
        import torch

        from vplines_slam_tpu_torch import kernels as kmod
        from vplines_slam_tpu_torch.ops import brief

        if self.match_int64:
            return self._swapped(brief.HAMMING_MATCH, "hamming", lambda: brief._hamming_cuda(
                da, va, db, vb, max_dist, margin, mutual, want_d))
        N, M = da.shape[0], db.shape[0]
        da, db = da.to(torch.int32).contiguous(), db.to(torch.int32).contiguous()
        va8, vb8 = va.to(torch.uint8).contiguous(), vb.to(torch.uint8).contiguous()
        idx = torch.empty(N, dtype=torch.int32, device=da.device)
        dist = torch.empty(N, dtype=torch.int32, device=da.device)
        d = torch.empty(N, M, dtype=torch.int32, device=da.device) if want_d else None
        P, I = kmod.P, kmod.I
        self._call("hamming", "vp_hamming_match", [P, P, P, P, I, I, I, I, I, P, P, P],
                   da.data_ptr(), va8.data_ptr(), db.data_ptr(), vb8.data_ptr(), N, M,
                   int(max_dist), int(margin), int(bool(mutual)), idx.data_ptr(),
                   dist.data_ptr(), None if d is None else d.data_ptr())
        return idx.long(), dist, d

    def match_descriptors(self, da, va, db, vb, max_dist=80, margin=0, mutual=False):
        """``brief.match_descriptors`` on the other tree's K17."""
        return self.match(da, va, db, vb, max_dist, margin, mutual)[:2]

    def pnp_refine(self, R0, t0, X_w, x, mask, iters=5):
        """The other tree's K21 through the same C entry and arguments (the
        previous wrapper converted a bool mask with a launch)."""
        import torch

        from vplines_slam_tpu_torch.ops import mvg

        m = mask.to(torch.uint8) if self.refine_u8_launch else mask
        return self._swapped(mvg.PNP_REFINE, "pnp_refine",
                             lambda: self._refine(R0, t0, X_w, x, m, iters))

    @contextlib.contextmanager
    def verification(self):
        """Loop verifications inside the block run the other tree's K17 match
        and K21 (K18 is the same design in both trees since PR 15)."""
        from vplines_slam_tpu_torch.ops import brief, mvg

        saved = brief.match_descriptors, mvg.pnp_refine
        brief.match_descriptors, mvg.pnp_refine = self.match_descriptors, self.pnp_refine
        try:
            yield
        finally:
            brief.match_descriptors, mvg.pnp_refine = saved

    def brief_pair(self, img, xy, valid, xy2, valid2):
        """The other tree's K16 at two point sets: its one launch (this
        design), or two calls of the previous design's ``vp_brief`` (a
        full-frame blur launch and a descriptor launch each)."""
        import torch

        from vplines_slam_tpu_torch import kernels as kmod
        from vplines_slam_tpu_torch.ops import brief

        if self.has("brief", "vp_brief_patch"):
            return self._swapped(brief.BRIEF, "brief", lambda: self._brief_pair(
                img, xy, valid, xy2, valid2))
        H, W = img.shape
        pa, pb = brief._pattern_tensors(img.dtype, img.device)
        taps = torch.tensor(brief.gaussian_kernel1d(7, 2.0), dtype=torch.float32,
                            device=img.device)
        P, I = kmod.P, kmod.I
        out = []
        for p, v in ((xy, valid), (xy2, valid2)):
            p, v8 = p.contiguous(), v.to(torch.uint8).contiguous()
            blur = torch.empty_like(img)
            desc = torch.empty(p.shape[0], 8, dtype=torch.int32, device=img.device)
            self._call("brief", "vp_brief", [P, I, I, P, P, P, P, P, I, P, P], img.data_ptr(),
                       H, W, taps.data_ptr(), pa.data_ptr(), pb.data_ptr(), p.data_ptr(),
                       v8.data_ptr(), p.shape[0], blur.data_ptr(), desc.data_ptr())
            out.append(desc)
        return tuple(out)


@contextlib.contextmanager
def recording_lines(store):
    """Keep every detect_lines and line_vote call of the block in store
    ({"detect": [], "vote": []}), as references to their inputs and outputs
    (no copy, no launch, no sync), for ``line_frames_check``."""
    from vplines_slam_tpu_torch.ops import line_match, lines

    detect, vote = lines.detect_lines, line_match.line_vote

    def detect_rec(img, cfg=lines.LineDetectConfig()):
        out = detect(img, cfg)
        store["detect"].append(((img, cfg), out))
        return out

    def vote_rec(*a):
        out = vote(*a)
        store["vote"].append((a, out))
        return out

    lines.detect_lines, line_match.line_vote = detect_rec, vote_rec
    try:
        yield store
    finally:
        lines.detect_lines, line_match.line_vote = detect, vote


def _equal(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _bits_equal(a, b):
    """Tensors equal to the bit, NaN included."""
    import torch

    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return all(x.dtype == y.dtype and torch.equal(x.view(ints.get(x.dtype, x.dtype)),
                                                  y.view(ints.get(y.dtype, y.dtype)))
               for x, y in zip(a, b))


def walks_equal(a, b):
    """Two (segs, lens, fits, supports, a_ok): a_ok identical, the rest
    equal to the bit on the a_ok slots."""
    import torch

    k = a[4]
    return torch.equal(k, b[4]) and all(torch.equal(x[k], y[k]) for x, y in zip(a[:4], b[:4]))


def line_frames_check(rec, store, where):
    """Every recorded lines frame: K6 (detect_lines, both launches) and K7
    again on the frame's inputs, equal to the bit; with --against the other
    tree's K6 fields, best values and indices, walks on the a_ok slots and
    detect_lines' outputs, and its K7's match and n_votes, equal to the bit.
    Adds the kernels' device time per call over these frames to their
    records, the other tree's beside them."""
    from vplines_slam_tpu_torch.ops import line_match, lines

    det, vot = store["detect"], store["vote"]
    if not det or not vot:
        fail(f"{where}: no detect_lines or line_vote call recorded")
    again_d = all(_equal(lines.detect_lines(*args), out) for args, out in det)
    again_v = all(_equal(line_match.line_vote(*args), out) for args, out in vot)
    anchors = [(lines.line_anchors(img, cfg), cfg) for (img, cfg), _ in det]
    ok, other = again_d and again_v, ""
    if AGAINST is not None:
        same_f = all(_equal(AGAINST.line_anchors(img, cfg), a)
                     for ((img, cfg), _), (a, _) in zip(det, anchors))
        walks = [(lines.line_select_grow(a[3], a[4], *a[:3], cfg),
                  AGAINST.line_select_grow(a[3], a[4], *a[:3], cfg)) for a, cfg in anchors]
        same_w = all(walks_equal(m, t) for m, t in walks)
        n_ok = sum(int(m[4].sum()) for m, _ in walks)
        same_d = all(_equal(AGAINST.detect_lines(*args), out) for args, out in det)
        same_v = all(_equal(AGAINST.line_vote(*args), out) for args, out in vot)
        other = (f"; the other tree's kernels, equal to the bit: K6 fields, best values and "
                 f"indices {same_f}, walks on the {n_ok} a_ok slots {same_w}, detect_lines' "
                 f"segments, lengths and valid {same_d}, K7's match and n_votes {same_v}")
        ok = ok and same_f and same_w and same_d and same_v
    log(f"K6 / K7 on {where}'s {len(det)} detect_lines and {len(vot)} line_vote calls: again "
        f"on each call's inputs, equal to the bit: detect_lines {again_d}, line_vote "
        f"{again_v}{other}")
    if not ok:
        fail(f"K6 / K7 on {where}'s frames")
    times = (("line_anchors", "line_anchors_kernel", len(det),
              lambda: [lines.line_anchors(img, cfg) for (img, cfg), _ in det],
              AGAINST and (lambda: [AGAINST.line_anchors(img, cfg) for (img, cfg), _ in det]),
              "line_anchors_kernel"),
             ("line_select_grow", "line_select_grow_kernel", len(det),
              lambda: [lines.line_select_grow(a[3], a[4], *a[:3], cfg) for a, cfg in anchors],
              AGAINST and (lambda: [AGAINST.line_select_grow(a[3], a[4], *a[:3], cfg)
                                    for a, cfg in anchors]),
              AGAINST and AGAINST.grow_kernel()),
             ("line_vote", "line_vote_kernel", len(vot),
              lambda: [line_match.line_vote(*args) for args, _ in vot],
              AGAINST and (lambda: [AGAINST.line_vote(*args) for args, _ in vot]),
              "line_vote_kernel"))
    for name, kname, n, fn, other_fn, other_kname in times:
        extra = rec[name].setdefault("extra_device_of", {})
        extra[f"{where}'s {n} lines frames, per call"] = (fn, n, kname)
        if AGAINST is not None:
            extra[f"the other tree's kernel on {where}'s frames, per call"] = (other_fn, n,
                                                                              other_kname)


@contextlib.contextmanager
def recording_vp(store):
    """Keep every vp_grid and vp_score call of the block in store, as
    references to their inputs and outputs (no copy, no launch, no sync),
    for ``vp_frames_check``."""
    from vplines_slam_tpu_torch.ops import vp

    grid_fn, score_fn = vp.vp_grid, vp.vp_score

    def grid_rec(*a):
        g = grid_fn(*a)
        store.append(dict(grid_args=a, grid=g))
        return g

    def score_rec(*a):
        out = score_fn(*a)
        store[-1].update(score_args=a, score=out)
        return out

    vp.vp_grid, vp.vp_score = grid_rec, score_rec
    try:
        yield store
    finally:
        vp.vp_grid, vp.vp_score = grid_fn, score_fn


@contextlib.contextmanager
def recording_clahe(store):
    """Keep every clahe call of the two trackers in the block in store, as
    references to its input and output (no copy, no launch, no sync), for
    ``clahe_frames_check``."""
    from vplines_slam_tpu_torch.models import feature_tracker, line_tracker

    saved = feature_tracker.clahe, line_tracker.clahe

    def wrap(fn):
        def rec(img, *a):
            out = fn(img, *a)
            store.append((img, out))
            return out
        return rec

    feature_tracker.clahe, line_tracker.clahe = wrap(saved[0]), wrap(saved[1])
    try:
        yield store
    finally:
        feature_tracker.clahe, line_tracker.clahe = saved


def clahe_frames_check(rec, store, where):
    """Every recorded clahe call: K9 again on its image equal to the bit,
    the plain version within 1e-6; with --against the other tree's LUTs and
    output equal to the bit.  Adds K9's device time per call over these
    images to its record."""
    import torch

    from vplines_slam_tpu_torch.ops import image

    if not store:
        fail(f"{where}: no clahe call recorded")
    again = all(torch.equal(image.clahe(im), out) for im, out in store)
    err = max(float((image.clahe_plain(im) - out).abs().max()) for im, out in store)
    ok, other = again and err <= 1e-6, ""
    if AGAINST is not None:
        same = all(torch.equal(o, out) and torch.equal(lo, image.clahe_cuda(im)[1])
                   for (im, out), (o, lo) in zip(store, (AGAINST.clahe(im) for im, _ in store)))
        other = f"; the other tree's kernels: LUTs and output equal to the bit {same}"
        ok = ok and same
    log(f"K9 clahe on {where}'s {len(store)} calls: again on each image, equal to the bit: "
        f"{again}; max |kernel - plain| {err:.3e} (tol 1e-6){other}")
    if not ok:
        fail(f"K9 clahe on {where}'s images")
    extra = rec["clahe"].setdefault("extra_device_of", {})
    extra[f"{where}'s {len(store)} images, per call"] = (
        lambda: [image.clahe(im) for im, _ in store], len(store))
    if AGAINST is not None:
        extra[f"the other tree's K9 on {where}'s images, per call"] = (
            lambda: [AGAINST.clahe(im) for im, _ in store], len(store))


@contextlib.contextmanager
def recording_klt(store):
    """Keep every ``klt.track`` call of the block in store, as references to
    its inputs and outputs (no copy, no launch, no sync), for
    ``klt_frames_check``."""
    from vplines_slam_tpu_torch.ops import klt

    track = klt.track

    def rec(img0, img1, pts0, cfg=klt.KLTConfig(), init_flow=None):
        out = track(img0, img1, pts0, cfg, init_flow)
        store.append(((img0, img1, pts0, cfg, init_flow), out))
        return out

    klt.track = rec
    try:
        yield store
    finally:
        klt.track = track


# K2's gain/bias tracks against track_plain on the slice's calls: phase 5
# reads 0.0224 px (NVIDIA H100 80GB HBM3; the per-level design, to whose
# sums this one is equal to the bit, reads the same), phase 4 has no line
GAIN_BIAS_TRACK_TOL_PX = 0.05


def klt_frames_check(store, where):
    """Every recorded track call again on ``track_plain`` (on the card): ok
    agreement over the calls' points (tol >= 0.99) and, in point mode, max
    |pts1 diff| where both are ok (tol 1e-3 px).  In gain/bias mode the line
    anchors' flow along their edge is barely conditioned (the line matcher
    relaxes the gate for that), so f32 sums in another order move some of
    them by hundredths of a pixel: held at GAIN_BIAS_TRACK_TOL_PX.  With
    --against the other tree's track equal to the bit on every call."""
    import torch

    from vplines_slam_tpu_torch.ops import klt

    if not store:
        fail(f"{where}: no track call recorded")
    n = sum(int(args[2].shape[0]) for args, _ in store)
    err, err_gb, flips = 0.0, 0.0, 0
    for args, out in store:
        p = klt.track_plain(*args)
        both = out[1] & p[1]
        e = float((out[0] - p[0])[both].abs().max()) if bool(both.any()) else 0.0
        if args[3].illum_adapt:
            err_gb = max(err_gb, e)
        else:
            err = max(err, e)
        flips += int((out[1] != p[1]).sum())
    same, other = True, ""
    if AGAINST is not None:
        same = all(all(torch.equal(a, b) for a, b in zip(out, AGAINST.track(*args)))
                   for args, out in store)
        other = f"; equal to the other tree's track to the bit on every call: {same}"
    agree = 1.0 - flips / max(n, 1)
    log(f"K2 klt_track on {where}'s {len(store)} calls ({n} points): against track_plain "
        f"{flips} ok flags differ, agreement {agree:.5f} (tol >= 0.99); max |pts1 diff| (ok in "
        f"both) {err:.3e} px in point mode (tol 1e-3), {err_gb:.3e} px in gain/bias mode "
        f"(tol {GAIN_BIAS_TRACK_TOL_PX}){other}")
    if not (err <= 1e-3 and err_gb <= GAIN_BIAS_TRACK_TOL_PX and agree >= 0.99 and same):
        fail(f"K2 klt_track on {where}'s calls")


def vp_score_same(store):
    """(vp_score again on each recorded call's inputs equal to its outputs
    to the bit, with --against the other tree's vp_score equal to them to
    the bit)."""
    from vplines_slam_tpu_torch.ops import vp

    again = all(_equal(vp.vp_score(*r["score_args"]), r["score"]) for r in store)
    same = AGAINST is None or all(_equal(AGAINST.vp_score(*r["score_args"]), r["score"])
                                  for r in store)
    return again, same


def vp_frames_check(rec, store, where):
    """Every recorded lines frame: vp_grid and vp_score again on their
    inputs, equal to the bit; with --against the other tree's grid equal to
    the bit and vp_score's labels on it equal to the frame's, and the other
    tree's vp_score equal to the frame's to the bit.  Adds the kernels'
    device time per call over these frames to their records."""
    import torch

    from vplines_slam_tpu_torch.ops import vp

    if not store:
        fail(f"{where}: no vp_grid call recorded")
    again = all(torch.equal(vp.vp_grid(*r["grid_args"]), r["grid"]) for r in store)
    score_again, score_same = vp_score_same(store)
    ok, other = again and score_again, ""
    if AGAINST is not None:
        grids = [AGAINST.vp_grid(*r["grid_args"]) for r in store]
        same_grid = all(torch.equal(g, r["grid"]) for g, r in zip(grids, store))
        same_ids = all(torch.equal(vp.vp_score(g, *r["score_args"][1:])[1], r["score"][1])
                       for g, r in zip(grids, store))
        other = (f"; the other tree's kernels: grids equal to the bit {same_grid}, VP labels "
                 f"on them equal {same_ids}, vp_score's vps, labels and best equal to the bit "
                 f"{score_same}")
        ok = ok and same_grid and same_ids and score_same
    log(f"K8 on {where}'s {len(store)} lines frames: again on each frame's inputs, equal to "
        f"the bit: vp_grid {again}, vp_score {score_again}{other}")
    if not ok:
        fail(f"K8 vp_grid / vp_score on {where}'s frames")
    # the kernel alone (its symbol), not the wrappers' conversions
    for name, args_key, fn, other_fn in (
            ("vp_grid", "grid_args", vp.vp_grid, AGAINST and AGAINST.vp_grid),
            ("vp_score", "score_args", vp.vp_score, AGAINST and AGAINST.vp_score)):
        extra = rec[name].setdefault("extra_device_of", {})
        extra[f"{where}'s {len(store)} lines frames, per call"] = (
            lambda fn=fn, k=args_key: [fn(*r[k]) for r in store], len(store), f"{name}_kernel")
        if AGAINST is not None:
            extra[f"the other tree's {name} on {where}'s frames, per call"] = (
                lambda fn=other_fn, k=args_key: [fn(*r[k]) for r in store], len(store),
                f"{name}_kernel")


@contextlib.contextmanager
def recording_pyramids(store):
    """Keep every pyramid pair ``klt.track`` builds in the block in store,
    as references to its inputs and outputs (no copy, no launch, no sync),
    for ``pyramid_frames_check``."""
    from vplines_slam_tpu_torch.ops import klt

    build = klt.build_pyramids

    def rec(img0, img1, levels):
        out = build(img0, img1, levels)
        store.append(((img0, img1, levels), out))
        return out

    klt.build_pyramids = rec
    try:
        yield store
    finally:
        klt.build_pyramids = build


def pyramid_frames_check(rec, store, where):
    """Every recorded pyramid pair: K1 again on its images equal to the bit,
    the plain version within 1e-6 on every level; with --against every
    level equal to the other tree's K1 to the bit.  Adds K1's device time
    per call over these calls to its record."""
    import torch

    from vplines_slam_tpu_torch.ops import image

    if not store:
        fail(f"{where}: no pyramid built")

    def levels_of(out):
        return [lv for pyr in out for lv in pyr]

    again = all(all(torch.equal(a, b) for a, b in zip(levels_of(image.build_pyramids(*args)),
                                                       levels_of(out)))
                for args, out in store)
    err = 0.0
    for (img0, img1, n), out in store:
        for im, pyr in zip((img0, img1), out):
            for lv, ref in zip(pyr[1:], image.build_pyramid_plain(im, n)[1:]):
                err = max(err, float((lv - ref).abs().max()))
    ok, other = again and err <= 1e-6, ""
    if AGAINST is not None:
        same = all(all(torch.equal(a, b) for a, b in zip(
            levels_of(AGAINST.pyramids([args[0], args[1]], args[2])), levels_of(out)))
            for args, out in store)
        other = f"; every level equal to the other tree's K1 to the bit: {same}"
        ok = ok and same
    log(f"K1 pyramids on {where}'s {len(store)} track calls: again on each call's images, equal "
        f"to the bit: {again}; max |kernel - plain| {err:.3e} (tol 1e-6){other}")
    if not ok:
        fail(f"K1 pyramids on {where}'s track calls")
    extra = rec["pyramids"].setdefault("extra_device_of", {})
    extra[f"{where}'s {len(store)} track calls, per call"] = (
        lambda: [image.build_pyramids(*args) for args, _ in store], len(store), "pyr")
    if AGAINST is not None:
        extra[f"the other tree's K1 on {where}'s track calls, per call"] = (
            lambda: [AGAINST.pyramids([a[0], a[1]], a[2]) for a, _ in store], len(store), "pyr")


def one_pyramid_launch_a_track(launches, where):
    """Each track call with points builds both pyramids in one K1 launch and
    tracks in one K2 launch: the two counts of a run are equal."""
    from vplines_slam_tpu_torch.ops import image, klt

    n1, n2 = launches.get(image.PYRAMIDS.name), launches.get(klt.KLT_TRACK.name)
    log(f"{where}: K1 launches {n1}, K2 launches {n2} (one K1 launch a track call)")
    if n1 is None or n1 != n2:
        fail(f"{where}: K1 launched {n1} times for {n2} track calls")


def same_corners(a, b, tol=1e-6):
    """(agree, max |score diff|) of two ``detect`` outputs: the same valid
    slots' positions (as a set: near-equal scores may swap places) and their
    scores within tol at each position."""
    (xa, sa, va), (xb, sb, vb) = a, b
    ka = dict(zip(map(tuple, xa[va].tolist()), sa[va].tolist()))
    kb = dict(zip(map(tuple, xb[vb].tolist()), sb[vb].tolist()))
    if ka.keys() != kb.keys():
        return False, math.inf
    err = max((abs(ka[k] - kb[k]) for k in ka), default=0.0)
    return err <= tol, err


def k3_check(label, args, kwargs=None):
    """K3 on one ``detect`` call's inputs: two launches a call, a second call
    equal to the bit, the plain twin as ``same_corners`` (positions
    identical, scores 1e-6); with --against the other tree's detect equal to
    the bit.  Returns (ok, max |score diff| to the twin, log text)."""
    from vplines_slam_tpu_torch.ops import corners

    kwargs = kwargs or {}
    n0 = (corners.CORNER_CELLS.launches, corners.CORNER_TOPK.launches)
    out = corners.detect(*args, **kwargs)
    two = (corners.CORNER_CELLS.launches - n0[0], corners.CORNER_TOPK.launches - n0[1]) == (1, 1)
    again = _equal(corners.detect(*args, **kwargs), out)
    agree, err = same_corners(out, corners.detect_plain(*args, **kwargs))
    same = AGAINST is None or _equal(AGAINST.detect(*args, **kwargs), out)
    text = (f"{label}: {int(out[2].sum())} valid, two launches {two}, again equal {again}, "
            f"plain twin: positions identical {agree} (max |score diff| {err:.3e}, tol 1e-6)"
            + ("" if AGAINST is None else f", the other tree's detect equal to the bit {same}"))
    return two and again and agree and same, err, text


@contextlib.contextmanager
def recording_detect(store):
    """Keep every ``corners.detect`` call of the block in store, as
    references to its inputs and outputs with the K3 launches it made (no
    copy, no sync), for ``detect_frames_check``."""
    from vplines_slam_tpu_torch.ops import corners

    detect = corners.detect

    def rec(*args, **kwargs):
        n0 = (corners.CORNER_CELLS.launches, corners.CORNER_TOPK.launches)
        out = detect(*args, **kwargs)
        n = (corners.CORNER_CELLS.launches - n0[0], corners.CORNER_TOPK.launches - n0[1])
        store.append(((args, kwargs), out, n))
        return out

    corners.detect = rec
    try:
        yield store
    finally:
        corners.detect = detect


def detect_frames_check(rec, store, where):
    """Every recorded detect call: one launch of each K3 kernel, K3 again on
    its inputs equal to the bit, the plain twin as ``same_corners``; with
    --against the other tree's detect (the previous design: its kernels
    behind its glue) equal to the bit.  Adds K3's device time per call over
    these calls to its record, and the other tree's beside it."""
    from vplines_slam_tpu_torch.ops import corners

    if not store:
        fail(f"{where}: no detect call recorded")
    launches = all(n == (1, 1) for _, _, n in store)
    again = all(_equal(corners.detect(*a, **kw), out) for (a, kw), out, _ in store)
    err, agree = 0.0, True
    for (a, kw), out, _ in store:
        ok, e = same_corners(out, corners.detect_plain(*a, **kw))
        agree, err = agree and ok, max(err, e)
    ok, other = launches and again and agree, ""
    if AGAINST is not None:
        same = all(_equal(AGAINST.detect(*a, **kw), out) for (a, kw), out, _ in store)
        other = f"; the other tree's detect equal to the bit on every call: {same}"
        ok = ok and same
    log(f"K3 detect on {where}'s {len(store)} calls: one launch of each kernel a call "
        f"{launches}; again on each call's inputs, equal to the bit: {again}; plain twin: "
        f"positions identical {agree}, max |score diff| {err:.3e} (tol 1e-6){other}")
    if not ok:
        fail(f"K3 detect on {where}'s calls")
    calls = [(a, kw) for (a, kw), _, _ in store]
    extra = rec["corner_cells"].setdefault("extra_device_of", {})
    extra[f"{where}'s {len(store)} detect calls, both kernels, per call"] = (
        lambda: [corners.detect(*a, **kw) for a, kw in calls], len(store), "corner_")
    if AGAINST is not None:
        extra[f"the other tree's kernels on {where}'s detect calls, per call"] = (
            lambda: [AGAINST.detect(*a, **kw) for a, kw in calls], len(store), "corner_")
        extra[f"the other tree's whole detect (kernels and glue) on {where}'s calls, per call"] = (
            lambda: [AGAINST.detect(*a, **kw) for a, kw in calls], len(store))


@contextlib.contextmanager
def recording_ransac(store):
    """Keep every ``mvg.ransac_essential`` call of the block (the tracker's,
    gate included, and the initializer's) in store, as references to its
    inputs and outputs with the K4 launches it made (no copy, no sync), for
    ``ransac_frames_check``."""
    from vplines_slam_tpu_torch.ops import mvg

    fn = mvg.ransac_essential

    def rec(x1, x2, mask, sample_idx, threshold=3.0 / 460.0, min_valid=0,
            return_hypotheses=False):
        n0 = mvg.RANSAC_ESSENTIAL.launches
        out = fn(x1, x2, mask, sample_idx, threshold, min_valid, return_hypotheses)
        store.append(((x1, x2, mask, sample_idx, threshold, min_valid), out,
                      mvg.RANSAC_ESSENTIAL.launches - n0))
        return out

    mvg.ransac_essential = rec
    try:
        yield store
    finally:
        mvg.ransac_essential = fn


def ransac_frames_check(rec, store, where):
    """Every recorded ransac_essential call: one K4 launch and ``k4_check``
    on its inputs (again to the bit and equal to the path's outputs, the
    f64 checks); with --against the other tree's whole call on the same
    inputs, the calls with the same inliers counted (that design fits at
    f32).  Adds K4's device time per call over these calls to its record,
    and the other tree's whole calls' beside it."""
    import torch

    from vplines_slam_tpu_torch.ops import mvg

    if not store:
        fail(f"{where}: no ransac_essential call recorded")
    launches = all(n == 1 for _, _, n in store)
    ok, err, counts, shapes = launches, 0.0, collections.Counter(), collections.Counter()
    for a, out, _ in store:
        ok_c, st, text = k4_check(f"  {where}'s call", *a, out=out)
        if not ok_c:
            log(text)
        ok, err = ok and ok_c, max(err, st["e_ref"])
        counts.update(k for k in ("gated", "final", "undetermined") if st[k])
        shapes[f"{a[3].shape[0]} x {a[0].shape[0]}"] += 1
    other = ""
    if AGAINST is not None:
        same = sum(bool(torch.equal(AGAINST.ransac_essential(*a)[1], out[1]))
                   for a, out, _ in store)
        other = f"; the other tree's whole call gives the same inliers on {same}"
    log(f"K4 ransac_essential on {where}'s {len(store)} calls ({dict(shapes)}): one launch a "
        f"call {launches}; k4_check on each {ok}, E max err {err:.2e} to the SVD reference; "
        f"{counts['gated']} gated, final outputs compared on {counts['final']}, winners "
        f"undetermined on {counts['undetermined']}{other}")
    if not ok:
        fail(f"K4 ransac_essential on {where}'s calls")
    calls = [a for a, _, _ in store]
    extra = rec["ransac_essential"].setdefault("extra_device_of", {})
    extra[f"{where}'s {len(store)} calls, per call"] = (
        lambda: [mvg.ransac_essential(*a) for a in calls], len(store), "ransac_kernel")
    if AGAINST is not None:
        extra[f"the other tree's whole calls on {where}'s (kernels and glue), per call"] = (
            lambda: [AGAINST.ransac_essential(*a) for a in calls], len(store))


@contextlib.contextmanager
def recording_brief(store):
    """Keep every ``brief.describe_brief_pair`` call of the block (one a
    keyframe extraction) in store, as references to its inputs and outputs
    with the K16 launches it made, for ``brief_frames_check``."""
    from vplines_slam_tpu_torch.ops import brief

    pair = brief.describe_brief_pair

    def rec(*args):
        n0 = brief.BRIEF.launches
        out = pair(*args)
        store.append((args, out, brief.BRIEF.launches - n0))
        return out

    brief.describe_brief_pair = rec
    try:
        yield store
    finally:
        brief.describe_brief_pair = pair


def brief_frames_check(rec, store, where):
    """Every recorded keyframe's descriptors (both point sets): one K16
    launch, K16 again equal to the bit, the plain twin equal to the bit;
    with --against the other tree's K16 (the previous design: two calls of
    a blur and a descriptor launch) equal to the bit.  Adds K16's device
    time per keyframe over these calls to its record, the other tree's
    beside it."""
    from vplines_slam_tpu_torch.ops import brief

    if not store:
        fail(f"{where}: no keyframe described")
    launches = all(n == 1 for _, _, n in store)
    again = all(_equal(brief.describe_brief_pair(*a), out) for a, out, _ in store)
    plain = all(_equal((brief.describe_brief_plain(a[0], a[1], a[2]),
                        brief.describe_brief_plain(a[0], a[3], a[4])), out)
                for a, out, _ in store)
    n_desc = sum(int(o[0].shape[0] + o[1].shape[0]) for _, o, _ in store)
    ok, other = launches and again and plain, ""
    if AGAINST is not None:
        same = all(_equal(AGAINST.brief_pair(*a), out) for a, out, _ in store)
        other = f"; the other tree's K16 equal to the bit {same}"
        ok = ok and same
    log(f"K16 brief on {where}'s {len(store)} keyframes ({n_desc} descriptors): one launch a "
        f"keyframe {launches}; again on each keyframe's inputs, equal to the bit: {again}; "
        f"every bit equal to the plain twin {plain}{other}")
    if not ok:
        fail(f"K16 brief on {where}'s keyframes")
    calls = [a for a, _, _ in store]
    extra = rec["brief_patch"].setdefault("extra_device_of", {})
    extra[f"{where}'s {len(store)} keyframes, per keyframe"] = (
        lambda: [brief.describe_brief_pair(*a) for a in calls], len(store), "brief_")
    if AGAINST is not None:
        extra[f"the other tree's K16 on {where}'s keyframes, per keyframe"] = (
            lambda: [AGAINST.brief_pair(*a) for a in calls], len(store), "brief_")


@contextlib.contextmanager
def recording_fast(store):
    """Keep every ``brief.detect_fast`` call of the block (one a keyframe
    extraction) in store, as references to its inputs and outputs with the
    K15 launches it made (tiles, selection), for ``fast_frames_check``."""
    from vplines_slam_tpu_torch.ops import brief

    detect = brief.detect_fast

    def rec(*args, **kwargs):
        n0 = (brief.FAST_TILES.launches, brief.FAST_SELECT.launches)
        out = detect(*args, **kwargs)
        store.append(((args, kwargs), out, (brief.FAST_TILES.launches - n0[0],
                                            brief.FAST_SELECT.launches - n0[1])))
        return out

    brief.detect_fast = rec
    try:
        yield store
    finally:
        brief.detect_fast = detect


def fast_candidates(img, thresh=0.05):
    """Kept pixels with score > 0 (the candidates K15's selection ranks),
    from the plain twins."""
    from vplines_slam_tpu_torch.ops import brief

    return int((brief._nms_plain(brief.fast_score_plain(img, thresh), 3) > 0).sum())


def fast_frames_check(rec, store, where):
    """Every recorded keyframe's ``detect_fast``: two K15 launches (tiles,
    selection), K15 again equal to the bit, the plain twin equal to the bit
    (xy, valid); with --against the other tree's detect_fast (the previous
    design: its two launches, the sort and the glue) equal to the bit.
    Logs the candidate counts; adds K15's device time per call over these
    calls to its record, the other tree's beside it."""
    from vplines_slam_tpu_torch.ops import brief

    if not store:
        fail(f"{where}: no detect_fast call recorded")
    launches = all(n == (1, 1) for _, _, n in store)
    again = all(_equal(brief.detect_fast(*a, **kw), out) for (a, kw), out, _ in store)
    plain = all(_equal(brief.detect_fast_plain(*a, **kw), out) for (a, kw), out, _ in store)
    counts = [fast_candidates(a[0]) for (a, _), _, _ in store]
    n_valid = [int(out[1].sum()) for _, out, _ in store]
    ok, other = launches and again and plain, ""
    if AGAINST is not None:
        same = all(_equal(AGAINST.detect_fast(*a, **kw), out) for (a, kw), out, _ in store)
        other = f"; the other tree's detect_fast equal to the bit {same}"
        ok = ok and same
    log(f"K15 detect_fast on {where}'s {len(store)} keyframes: two launches a call (tiles, "
        f"selection) {launches}; again on each call's inputs, equal to the bit: {again}; equal "
        f"to the plain twin (xy, valid) {plain}{other}; candidates (kept, score > 0) min "
        f"{min(counts)}, median {int(np.median(counts))}, max {max(counts)}; valid corners min "
        f"{min(n_valid)}, max {max(n_valid)}")
    if not ok:
        fail(f"K15 detect_fast on {where}'s keyframes")
    calls = [(a, kw) for (a, kw), _, _ in store]
    extra = rec["fast_tiles"].setdefault("extra_device_of", {})
    extra[f"{where}'s {len(store)} detect_fast calls, both kernels, per call"] = (
        lambda: [brief.detect_fast(*a, **kw) for a, kw in calls], len(store), "fast_")
    if AGAINST is not None:
        extra[f"the other tree's whole detect_fast on {where}'s calls, per call"] = (
            lambda: [AGAINST.detect_fast(*a, **kw) for a, kw in calls], len(store))
        extra[f"the other tree's K15 launches on {where}'s calls, per call"] = (
            lambda: [AGAINST.detect_fast(*a, **kw) for a, kw in calls], len(store), "fast_")


@contextlib.contextmanager
def recording_info(store):
    """Keep every ``selector.feature_information`` call of the block (one a
    tracked frame with the selector on) in store, as references to its
    inputs and output with the K20 selector_info launches it made, for
    ``selector_info_frames_check``."""
    from vplines_slam_tpu_torch.models import selector as sel

    info = sel.feature_information

    def rec(*args, **kwargs):
        n0 = sel.SELECTOR_INFO.launches
        out = info(*args, **kwargs)
        store.append(((args, kwargs), out, sel.SELECTOR_INFO.launches - n0))
        return out

    sel.feature_information = rec
    try:
        yield store
    finally:
        sel.feature_information = info


def info_rel_err(a, b):
    """The largest |a - b| of each candidate over that candidate's largest
    |b| entry."""
    scale = b.abs().amax(dim=(1, 2)).clamp(min=1e-300)
    return float(((a - b).abs().amax(dim=(1, 2)) / scale).max()) if a.shape[0] else 0.0


def plain_info_args(rays, depths, track_valid, ps, qs, q_ic, p_ic, pix_sigma=None, img_fov=0.75,
                    obs_frame=1):
    """feature_information's arguments as feature_information_plain takes
    them (no pix_sigma)."""
    return rays, depths, track_valid, ps, qs, q_ic, p_ic, img_fov, obs_frame


def selector_info_frames_check(rec, store, where):
    """Every recorded selector_info call: one launch, again equal to the
    bit, within 1e-12 of each candidate's largest entry of the plain twin;
    with --against the other tree's kernel equal to the bit.  Adds the
    device time per call over these calls to its record, the other tree's
    beside it."""
    from vplines_slam_tpu_torch.models import selector as sel

    if not store:
        fail(f"{where}: no selector_info call recorded")
    launches = all(n == 1 for _, _, n in store)
    again = all(_bits_equal((sel.feature_information(*a, **kw),), (out,))
                for (a, kw), out, _ in store)
    err = max(info_rel_err(out, sel.feature_information_plain(*plain_info_args(*a, **kw)))
              for (a, kw), out, _ in store)
    ok, other = launches and again and err <= 1e-12, ""
    if AGAINST is not None:
        same = all(_bits_equal((AGAINST.selector_info(*a, **kw),), (out,))
                   for (a, kw), out, _ in store)
        other = f"; the other tree's kernel equal to the bit {same}"
        ok = ok and same
    log(f"K20 selector_info on {where}'s {len(store)} calls ({store[0][1].shape[0]} candidates "
        f"each): one launch a call {launches}; again equal to the bit {again}; max |kernel - "
        f"plain| / the candidate's largest entry {err:.3e} (tol 1e-12){other}")
    if not ok:
        fail(f"K20 selector_info on {where}'s calls")
    calls = [(a, kw) for (a, kw), _, _ in store]
    extra = rec["selector_info"].setdefault("extra_device_of", {})
    extra[f"{where}'s {len(store)} calls, per call"] = (
        lambda: [sel.feature_information(*a, **kw) for a, kw in calls], len(store),
        "selector_info")
    if AGAINST is not None:
        extra[f"the other tree's kernel on {where}'s calls, per call"] = (
            lambda: [AGAINST.selector_info(*a, **kw) for a, kw in calls], len(store),
            "selector_info")


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
    try:
        import yaml

        log(f"PyYAML {yaml.__version__} (phase 8 reads configs/euroc.yaml's selector block)")
    except ImportError:
        log("PyYAML: not installed (phase 8 needs it)")
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


def klt_fused_check(rec, name, img0, img1, pts0, valid, kcfg, cost):
    """K2 as ``track`` calls it (every level and the gates in one launch)
    against ``track_plain`` on the card, from a zero and from a nonzero
    initial flow: max |pts1 diff| where both are ok (tol 1e-3 px), ok
    agreement over the valid inputs (tol >= 0.99), two calls equal to the
    bit, one launch a call.  Stores the record; returns the kernel's (pts1, ok,
    resid).  Every sum is added in the previous design's order, so with
    --against the other tree's track must equal it to the bit."""
    import torch

    from vplines_slam_tpu_torch.ops import klt

    def errs(k, p):
        both = k[1] & p[1] & valid
        e = float((k[0] - p[0])[both].abs().max()) if bool(both.any()) else 0.0
        agree = float((k[1] == p[1])[valid].float().mean()) if bool(valid.any()) else 1.0
        return e, agree

    n0 = klt.KLT_TRACK.launches
    k = klt.track(img0, img1, pts0, kcfg)
    one = klt.KLT_TRACK.launches - n0 == 1
    same = all(torch.equal(a, b) for a, b in zip(k, klt.track(img0, img1, pts0, kcfg)))
    p = klt.track_plain(img0, img1, pts0, kcfg)
    e, agree = errs(k, p)
    # an initial flow: the plain track's flow plus 0.75 px
    init = (p[0] - pts0 + 0.75).contiguous()
    ei, agree_i = errs(klt.track(img0, img1, pts0, kcfg, init_flow=init),
                       klt.track_plain(img0, img1, pts0, kcfg, init_flow=init))
    other, same_o = "", True
    if AGAINST is not None:
        same_o = all(torch.equal(a, b) for a, b in zip(k, AGAINST.track(img0, img1, pts0, kcfg)))
        other = f"; equal to the other tree's track to the bit: {same_o}"
    log(f"K2 klt_track ({name}: {int(valid.sum())} of {pts0.shape[0]} inputs valid, win "
        f"{kcfg.win}, {kcfg.levels} levels, {kcfg.iters} iters, gain/bias "
        f"{kcfg.illum_adapt}): one launch a call {one}; against track_plain max |pts1 diff| "
        f"(ok in both) {e:.3e} px, ok agreement {agree:.4f}; with an init_flow {ei:.3e} px, "
        f"{agree_i:.4f} (tol 1e-3 px, >= 0.99); {int(k[1].sum())} tracks ok; two calls equal "
        f"to the last bit: {same}{other}")
    if not (one and same and e <= 1e-3 and agree >= 0.99 and ei <= 1e-3 and agree_i >= 0.99
            and same_o):
        fail(f"K2 klt_track ({name}) disagrees with track_plain or the other tree's track")
    # both with the K1 launch of the pyramids; the device time counts K2 alone
    record(rec, name, max(e, ei), lambda: klt.track(img0, img1, pts0, kcfg),
           lambda: klt.track_plain(img0, img1, pts0, kcfg), "klt_track_kernel", *cost)
    if AGAINST is not None:
        rec[name]["extra_device_of"] = {
            "the other tree's K2 on the same inputs":
                (lambda: AGAINST.track(img0, img1, pts0, kcfg), 1, "klt_"),
            "the other tree's whole track (K1, K2, scaling and gates)":
                lambda: AGAINST.track(img0, img1, pts0, kcfg),
            "this tree's whole track (K1, K2)": lambda: klt.track(img0, img1, pts0, kcfg)}
    return k


def count_syncs(fn, n=3):
    """Host syncs per call of fn (``torch.cuda.set_sync_debug_mode("warn")``
    over n calls after one more) and their call sites."""
    import torch

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's own notice, "Synchronization debug mode is a prototype
    # feature ...", is no sync)
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()
             and not str(w.message).startswith("Synchronization debug mode")]
    sites = collections.Counter(f"{Path(w.filename).parent.name}/{Path(w.filename).name}:"
                                f"{w.lineno}" for w in syncs)
    return len(syncs) / n, dict(sites)


def phase3_k4(rec, S, xy0, pts1, ok1):
    """K4, the whole ransac_essential in one launch, held by ``k4_check`` on
    phase 3's frame 0 -> 1 (32 hypotheses over 150 tracks, the tracker's 1 px
    gate and min_valid 12), on every case of utils/synthetic.ransac_cases at
    f32 and at f64, and its initializer's shape (64 x 128, the cases'
    "initializer 64 x 128", 3 px); two calls and more, each to the bit.
    Timed with its plain path and, as its partial yardstick, torch.linalg.eigh
    on the hypotheses' [32, 9, 9] A^T A batch (the eigensolve alone); host
    syncs and (at the end) launches a call counted, with --against beside
    the other tree's whole call, its gate included."""
    import torch

    from vplines_slam_tpu_torch.models import camera as cam_mod
    from vplines_slam_tpu_torch.ops import mvg
    from vplines_slam_tpu_torch.utils import synthetic as syn

    cfg, dev = S["tcfg"], xy0.device
    n0 = cam_mod.lift(S["cam"], xy0)[:, :2]
    n1 = cam_mod.lift(S["cam"], pts1)[:, :2]
    thr, draws = cfg.f_threshold / 460.0, S["ridx"][0]
    ok, st, text = k4_check("K4 ransac_essential on phase 3's frame (32 x 150, min_valid 12)", n0,
                            n1, ok1, draws, thr, 12)
    log(text)
    err, n_undet = st["e_ref"], int(st["undetermined"])
    cases = syn.ransac_cases()
    card = {}
    for name, c in cases.items():
        for dt in (torch.float32, torch.float64):
            x1, x2 = (torch.as_tensor(c[k], dtype=dt, device=dev) for k in ("x1", "x2"))
            m = torch.as_tensor(c["mask"], device=dev)
            d = torch.as_tensor(c["idx"], device=dev)
            card[name, dt] = (x1, x2, m, d, c["threshold"], c["min_valid"])
            ok_c, st_c, text = k4_check(f"  ransac_cases '{name}' at {dt}", *card[name, dt])
            log(text)
            ok, err, n_undet = ok and ok_c, max(err, st_c["e_ref"]), n_undet + st_c["undetermined"]
    log(f"  K4 on phase 3's calls: winners undetermined on {n_undet} of {1 + 2 * len(cases)}")
    if not ok:
        fail("K4 ransac_essential disagrees with its plain path")
    ix1, ix2, im, idr, ithr, _ = card["initializer 64 x 128", torch.float32]
    fn = lambda: mvg.ransac_essential(n0, n1, ok1, draws, thr, 12)
    fn_init = lambda: mvg.ransac_essential(ix1, ix2, im, idr, ithr)
    # the yardstick: the hypotheses' A^T A batches at f32, as the plain path forms them
    ata = lambda x1, x2, m, d: (lambda A: A.transpose(-1, -2) @ A)(
        syn.essential_rows(x1, x2, syn.essential_samples(m, d)[1]).float())
    ata_frame, ata_init = ata(n0, n1, ok1, draws), ata(ix1, ix2, im, idr)
    N, Ni = n0.shape[0], ix1.shape[0]
    nbytes = lambda n, nh: 2 * n * 2 * 4 + n + nh * 8 * 8 + 9 * 4 + n + 4
    record(rec, "ransac_essential", err, fn,
           lambda: mvg.ransac_essential_plain(n0, n1, ok1, draws, thr, 12), "ransac_kernel",
           nbytes(N, draws.shape[0]), ransac_ops(draws.shape[0], N, int(fn()[2])),
           library_fn=lambda: torch.linalg.eigh(ata_frame),
           library_label="the eigensolve alone: torch.linalg.eigh on the [32, 9, 9] A^T A batch")
    r = rec["ransac_essential"]
    r["init_ms"], r["init_plain_ms"] = time_ms(fn_init), time_ms(
        lambda: mvg.ransac_essential_plain(ix1, ix2, im, idr, ithr))
    r["init_bound_ms"] = bound(nbytes(Ni, idr.shape[0]),
                               ransac_ops(idr.shape[0], Ni, int(fn_init()[2])))[0]
    log(f"K4 bound: {r['bound_ms']:.2e} ms at 32 x 150, {r['init_bound_ms']:.2e} ms at 64 x "
        f"128 ({r['bound_by']})")
    r["init_library_ms"] = time_ms(lambda: torch.linalg.eigh(ata_init))
    extra = r["extra_device_of"] = {
        "the initializer's 64 x 128, per call": (fn_init, 1, "ransac_kernel"),
        "eigh on the initializer's [64, 9, 9] batch": (lambda: torch.linalg.eigh(ata_init), 1)}
    syncs = {"32 x 150 with the gate": count_syncs(fn), "64 x 128": count_syncs(fn_init)}
    probes = [(fn, None), (fn_init, None)]
    if AGAINST is not None:
        o_fn = lambda: AGAINST.ransac_essential(n0, n1, ok1, draws, thr, 12)
        o_init = lambda: AGAINST.ransac_essential(ix1, ix2, im, idr, ithr)
        r["other_ms"], r["other_init_ms"] = time_ms(o_fn), time_ms(o_init)
        extra["the other tree's whole call with the gate (kernels and glue), 32 x 150"] = (o_fn, 1)
        extra["the other tree's whole call (kernels and glue), 64 x 128"] = (o_init, 1)
        syncs["the other tree's 32 x 150 with the gate"] = count_syncs(o_fn)
        syncs["the other tree's 64 x 128"] = count_syncs(o_init)
        probes = [(fn, o_fn), (fn_init, o_init)]
        log(f"K4 per call (CUDA events): 32 x 150 {r['ms']:.4f} ms, the other tree's "
            f"{r['other_ms']:.4f} ms; 64 x 128 {r['init_ms']:.4f} ms, the other tree's "
            f"{r['other_init_ms']:.4f} ms")
    for label, (n_sync, sites) in syncs.items():
        log(f"K4 host syncs a call, {label}: {n_sync:.1f} (call sites {sites})")
    PROBES["ransac"], PROBES["ransac_init"] = probes


def k6_frame_check(img, dcfg, label):
    """K6 on one frame against its twins on the card: line_anchors' fields
    within 1e-6, best positions agreeing on >= 0.99 of the twin's cells with
    an anchor and best values within 1e-6; line_select_grow and
    select_and_grow_plain on the kernel's anchors: a_ok identical, the
    support counts equal on the a_ok slots, the good flags agreeing on >=
    0.98 of them, endpoints within 0.05 px where both are good (f32 moments
    summed in another order), zeros on the other slots; both launches again
    equal to the bit, and with --against equal to the other tree's to the
    bit (fields, best values and indices, walks on the a_ok slots).
    Returns the kernel's (anchors, walks) and the largest differences to the
    twins (fields and best values; endpoints)."""
    import torch

    from vplines_slam_tpu_torch.ops import lines

    ak = lines.line_anchors(img, dcfg)
    ap = lines._anchors_plain(img, dcfg)
    err_f = max(float((a - b).abs().max()) for a, b in zip(ak[:3], ap[:3]))
    cells_on = ap[3] > 0
    pos_agree = (float((ak[4] == ap[4])[cells_on].float().mean()) if bool(cells_on.any())
                 else 1.0)
    err_b = float((ak[3] - ap[3]).abs().max())
    gk = lines.line_select_grow(ak[3], ak[4], *ak[:3], dcfg)
    gp = lines.select_and_grow_plain(ak[3], ak[4], *ak[:3], dcfg)
    a_ok = gk[4]

    def good(g):
        return (g[4] & (g[1] >= dcfg.min_len) & (g[2] <= dcfg.fit_err)
                & (g[3] >= dcfg.min_len * 0.6))

    gk_ok, gp_ok = good(gk), good(gp)
    both = gk_ok & gp_ok
    seg_err = float((gk[0] - gp[0])[both].abs().max()) if bool(both.any()) else 0.0
    n_err = float((gk[3] - gp[3])[a_ok].abs().max()) if bool(a_ok.any()) else 0.0
    good_agree = (float((gk_ok == gp_ok)[a_ok].float().mean()) if bool(a_ok.any()) else 1.0)
    zeros = all(bool((x[~a_ok] == 0).all()) for x in gk[:4])
    again = (_equal(lines.line_anchors(img, dcfg), ak)
             and walks_equal(lines.line_select_grow(ak[3], ak[4], *ak[:3], dcfg), gk))
    same, other = True, ""
    if AGAINST is not None:
        same_a = _equal(AGAINST.line_anchors(img, dcfg), ak)
        same_w = walks_equal(AGAINST.line_select_grow(ak[3], ak[4], *ak[:3], dcfg), gk)
        same = same_a and same_w
        other = (f"; the other tree's kernels equal to the bit: fields and best {same_a}, "
                 f"walks on the a_ok slots {same_w}")
    log(f"K6 on {label} ({tuple(img.shape)}): line_anchors max |field diff| (mag, dx, dy) = "
        f"{err_f:.3e} (tol 1e-6), {int(cells_on.sum())} cells with an anchor, positions "
        f"agree {pos_agree:.4f} (tol >= 0.99), max |best value diff| = {err_b:.3e} (tol "
        f"1e-6); line_select_grow: a_ok identical {torch.equal(a_ok, gp[4])} "
        f"({int(a_ok.sum())} of {a_ok.shape[0]} slots), {int(gp_ok.sum())} good (plain) / "
        f"{int(gk_ok.sum())} (kernel), support counts max diff {n_err:.0f} (tol 0), good-flag "
        f"agreement {good_agree:.4f} (tol >= 0.98), max endpoint diff where good in both "
        f"{seg_err:.3e} px (tol 0.05: f32 moments summed in another order), zeros off a_ok "
        f"{zeros}; both launches again equal to the bit {again}{other}")
    if not (err_f <= 1e-6 and pos_agree >= 0.99 and err_b <= 1e-6
            and torch.equal(a_ok, gp[4]) and n_err == 0 and good_agree >= 0.98
            and seg_err <= 0.05 and zeros and again and same):
        fail(f"K6 on {label} disagrees with its plain versions, itself or the other tree's")
    return ak, gk, max(err_f, err_b), seg_err


def k7_check(label, args):
    """K7 on one input against its twin on the card (match and n_votes
    exact), twice equal to the bit, with --against equal to the other
    tree's to the bit.  Returns the number of differing matches (0)."""
    import torch

    from vplines_slam_tpu_torch.ops import line_match

    mk, nvk = line_match.line_vote(*args)
    mp, nvp = line_match.line_vote_plain(*args)
    n_diff = int((mk != mp).sum())
    err7 = float((nvk - nvp).abs().max())
    again = _equal(line_match.line_vote(*args), (mk, nvk))
    dtype_ok = mk.dtype == torch.int64
    same, other = True, ""
    if AGAINST is not None:
        same = _equal(AGAINST.line_vote(*args), (mk, nvk))
        other = f"; equal to the other tree's K7 to the bit: {same}"
    log(f"K7 line_vote on {label}: {int((mp >= 0).sum())} of {int(args[3].sum())} lines "
        f"matched (plain); matches differing {n_diff} (tol 0), max |votes diff| = {err7:.0f} "
        f"(tol 0), int64 {dtype_ok}; again equal to the bit {again}{other}")
    if not (n_diff == 0 and err7 == 0 and again and same and dtype_ok):
        fail(f"K7 line_vote on {label} disagrees with its plain version, itself or the other "
             f"tree's")
    return n_diff


def phase_kernels(S, SL):
    """S: the points slice's staging, SL: the lines slice's."""
    import torch
    import torch.nn.functional as F

    from vplines_slam_tpu_torch import kernels as kmod
    from vplines_slam_tpu_torch.ops import corners, image, klt, line_match, lines, vp

    rec = {}
    img0, img1 = S["imgs"][0].contiguous(), S["imgs"][1].contiguous()
    cfg = S["tcfg"]
    n_px = H * W

    # K1: both pyramids of a track call (frames 0 and 1, the KLT's levels) in
    # one launch, every level within 1e-6 of the plain twin (f32 sums in
    # another rounding: the kernel fuses its multiply-adds), two calls equal
    # to the bit; one image at 2 (pyr_down) and at 4 levels, and 5 levels
    # refused before a launch; with --against every level equal to the other
    # tree's K1 to the bit
    levels = cfg.klt.levels
    tol = 1e-6
    plain_pyr = image.build_pyramid_plain

    def pyr_err(got, ref):
        return max(float((a - b).abs().max()) for a, b in zip(got, ref))

    n0 = image.PYRAMIDS.launches
    pk = image.build_pyramids(img0, img1, levels)
    one = image.PYRAMIDS.launches - n0 == 1
    again = all(torch.equal(a, b) for a, b in zip(sum(pk, []),
                                                  sum(image.build_pyramids(img0, img1, levels),
                                                      [])))
    err = max(pyr_err(pk[0], plain_pyr(img0, levels)), pyr_err(pk[1], plain_pyr(img1, levels)))
    others = {f"{levels} levels, both frames": (pk, [img0, img1], levels),
              "2 levels (pyr_down)": ([[img0, image.pyr_down(img0)]], [img0], 2),
              "4 levels": ([image.build_pyramid(img0, 4)], [img0], 4)}
    for label, (got, _, n) in list(others.items())[1:]:
        err = max(err, pyr_err(got[0], plain_pyr(img0, n)))
    try:
        image.build_pyramids(img0, img1, image.MAX_LEVELS + 1)
        refused = False
    except ValueError as e:
        refused = f"MAX_LEVELS = {image.MAX_LEVELS}" in str(e)
    same_o, other = True, ""
    if AGAINST is not None:
        for label, (got, imgs, n) in others.items():
            same_o &= all(torch.equal(a, b) for a, b in zip(sum(got, []),
                                                            sum(AGAINST.pyramids(imgs, n), [])))
        other = f"; every level equal to the other tree's K1 to the bit: {same_o}"
    log(f"K1 pyramids ({levels} levels of two {H}x{W} frames; 2 and 4 levels of one): one "
        f"launch a call {one}; max |kernel - plain| = {err:.3e} (tol {tol}); two calls equal to "
        f"the bit: {again}; {image.MAX_LEVELS + 1} levels refused with a ValueError naming "
        f"the limit: {refused}{other}")
    if not (one and err <= tol and again and refused and same_o):
        fail("K1 pyramids disagree with the plain version, across two calls or with the other "
             "tree's K1")
    # K1 off the frame's shape, at 2-4 levels: the scalar loads (W % 4 != 0,
    # or a source 4 bytes past a 16-byte boundary: a contiguous view one
    # float into a buffer), a coarsest level one pixel wide (40x3), and two
    # images of different shapes (two launches); within 1e-6 of the plain
    # twin, with --against equal to the other tree's K1 to the bit
    gen = torch.Generator(device=img0.device).manual_seed(12)
    a61 = torch.rand(61, 97, generator=gen, device=img0.device)
    a40 = torch.rand(40, 3, generator=gen, device=img0.device)
    buf = torch.empty(H * W + 1, device=img0.device)
    mis = buf[1:].view(H, W)
    mis.copy_(img0)
    odd = {"61x97": [a61], "40x3": [a40], "61x97 beside 40x3": [a61, a40],
           "the frame misaligned": [mis], "the frame misaligned beside frame 1": [mis, img1]}
    err_odd, launches_ok, same_odd = 0.0, True, True
    for label, imgs in odd.items():
        for n in (2, 3, 4):
            n0 = image.PYRAMIDS.launches
            got = ([image.build_pyramid(imgs[0], n)] if len(imgs) == 1
                   else list(image.build_pyramids(imgs[0], imgs[1], n)))
            launches_ok &= image.PYRAMIDS.launches - n0 == (
                1 if imgs[0].shape == imgs[-1].shape else 2)
            for im, pyr in zip(imgs, got):
                err_odd = max(err_odd, pyr_err(pyr, plain_pyr(im, n)))
                if AGAINST is not None:
                    same_odd &= all(torch.equal(a, b)
                                    for a, b in zip(pyr, AGAINST.pyramids([im], n)[0]))
    other = (f"; every level equal to the other tree's K1 to the bit: {same_odd}"
             if AGAINST is not None else "")
    log(f"K1 pyramids off the frame's shape ({', '.join(odd)}; 2-4 levels): launches as "
        f"expected (two for different shapes) {launches_ok}; max |kernel - plain| = "
        f"{err_odd:.3e} (tol {tol}){other}")
    if not (launches_ok and err_odd <= tol and same_odd):
        fail("K1 pyramids off the frame's shape disagree with the plain version or the other "
             "tree's K1")
    sizes = [(H, W)]
    for _ in range(levels - 1):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    # the least work: each level-0 image read once, every level written once;
    # per output pixel 9 operations a 5-tap sum, horizontal and vertical
    n_lv = sum(h * w for h, w in sizes[1:])
    ops1 = sum(9 * h * (w + sizes[k][1]) for k, (h, w) in enumerate(sizes[1:]))
    taps = torch.tensor(image.PYR_TAPS, device=img0.device)
    k2d = (taps[:, None] * taps[None, :])[None, None]
    frames2 = torch.stack([img0, img1])[:, None]
    record(rec, "pyramids", err, lambda: image.build_pyramids(img0, img1, levels),
           lambda: (plain_pyr(img0, levels), plain_pyr(img1, levels)), "pyramids_kernel",
           2 * 4 * (n_px + n_lv), 2 * ops1,
           library_fn=lambda: F.conv2d(frames2, k2d, stride=2, padding=2),
           library_label="level 1 of both frames alone")
    if AGAINST is not None:
        rec["pyramids"]["extra_device_of"] = {
            "the other tree's K1 on the same two frames":
                (lambda: AGAINST.pyramids([img0, img1], levels), 1, "pyr")}

    # K2 klt level: 150 features detected on frame 0, every pyramid level
    xy0, _, valid0 = corners.detect(img0, cfg.max_features, cfg.min_dist, cfg.quality)
    pyr0 = image.build_pyramid(img0, cfg.klt.levels)
    pyr1 = image.build_pyramid(img1, cfg.klt.levels)
    flow_err, agree, n_ok, level_same = 0.0, 0, 0, True
    for lvl in range(cfg.klt.levels):
        s = 2.0 ** lvl
        guess = torch.zeros_like(xy0)
        fk, ok_k, rk = klt._track_level(pyr0[lvl], pyr1[lvl], xy0 / s, guess, cfg.klt)
        fp, ok_p, rp = klt._track_level_plain(pyr0[lvl], pyr1[lvl], xy0 / s, guess, cfg.klt)
        if AGAINST is not None:
            level_same &= all(torch.equal(a, b) for a, b in zip(
                (fk, ok_k, rk), AGAINST.track_level(pyr0[lvl], pyr1[lvl], xy0 / s, guess,
                                                    cfg.klt)))
        both = ok_k & ok_p & valid0
        if bool(both.any()):
            flow_err = max(flow_err, float((fk - fp)[both].abs().max()))
        agree += int((ok_k == ok_p).sum())
        n_ok += ok_k.numel()
    agreement = agree / n_ok
    log(f"K2 klt_track_level: max flow err (ok in both) = {flow_err:.3e} px (tol 1e-3), "
        f"ok agreement {agreement:.4f} (tol >= 0.99)"
        + ("" if AGAINST is None else
           f"; every level equal to the other tree's kernel to the bit: {level_same}"))
    if not (flow_err <= 1e-3 and agreement >= 0.99 and level_same):
        fail("K2 klt_track_level disagrees with its plain version or the other tree's kernel")

    def klt_cost(n, kcfg, shape, levels=1, io=29):
        """(bytes, operations) of K2 over n features and `levels` levels of
        a pyramid whose level 0 is `shape`: on each level one template
        superset from the first image and one moving region from the second
        a feature (the re-anchor moves the window at most DRIFT px, so both
        rounds read within about one region), each capped at the level's
        image (coarse levels hold fewer pixels than the features' regions);
        `io` bytes of points and outputs a feature (29 for a level's pts0,
        guess, flow, ok and residual, 21 for track's pts0, pts1, ok and
        residual); the iterations' arithmetic."""
        P, TS, MS = kcfg.win, kcfg.win + 3, kcfg.win + 1 + 2 * klt.DRIFT
        it = kcfg.iters + 1
        (h, w), nbytes = shape, n * io
        for _ in range(levels):
            nbytes += 4 * (min(n * TS * TS, h * w) + min(n * MS * MS, h * w))
            h, w = (h + 1) // 2, (w + 1) // 2
        return (nbytes, levels * n * (TS * TS * 12 + P * P * 20
                                      + it * P * P * (12 + 8 * kcfg.illum_adapt)))

    lv0 = (pyr0[0], pyr1[0], xy0, torch.zeros_like(xy0), cfg.klt)
    record(rec, "klt_track_level", flow_err, lambda: klt._track_level(*lv0),
           lambda: klt._track_level_plain(*lv0), "klt_track_kernel",
           *klt_cost(xy0.shape[0], cfg.klt, img0.shape))
    # K2 as the front end calls it: every level and the gates in one launch
    pts1, ok1, _ = klt_fused_check(rec, "klt_track", img0, img1, xy0, valid0, cfg.klt,
                                   klt_cost(xy0.shape[0], cfg.klt, img0.shape, cfg.klt.levels,
                                            io=21))

    # K3: detect on frame 1 with frame 0's tracks as the tracked features
    # (the front end's call), on frame 0 alone, and on the cases of
    # utils/synthetic.corner_cases (each image as float32 on the card)
    from vplines_slam_tpu_torch.utils import synthetic as syn

    ok1 = ok1 & valid0
    det_args = (img1, cfg.max_features, cfg.min_dist, cfg.quality)
    det_kw = dict(existing_xy=pts1, existing_mask=ok1)
    checks = [k3_check("frame 1 with frame 0's tracks", det_args, det_kw),
              k3_check("frame 0", (img0, cfg.max_features, cfg.min_dist, cfg.quality))]
    for name, c in syn.corner_cases(seed=SEED).items():
        T = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(img0.device)
        checks.append(k3_check(f"case {name!r}", (
            T(c["img"]).float(), c["max_corners"], c["min_dist"], c["quality"]), dict(
            existing_xy=None if c["existing_xy"] is None else T(c["existing_xy"]).float(),
            existing_mask=T(c["existing_mask"]))))
    for ok, _, text in checks:
        log(f"K3 detect, {text}")
    if not all(ok for ok, _, _ in checks):
        fail("K3 detect disagrees with its plain twin, across calls or with the other tree's "
             "detect")
    err3 = max(e for _, e, _ in checks)
    ch, cw = -(-H // cfg.min_dist), -(-W // cfg.min_dist)
    n_exist = pts1.shape[0]
    detect_k = lambda: corners.detect(*det_args, **det_kw)
    detect_p = lambda: corners.detect_plain(*det_args, **det_kw)
    # pass 1: the image read once and one 8-byte key a cell (response ~60
    # operations a pixel); pass 2: the keys, the tracked features and the
    # outputs once
    record(rec, "corner_cells", err3, detect_k, detect_p, "corner_cells_kernel",
           4 * n_px + 8 * ch * cw, 60 * n_px)
    record(rec, "corner_topk", err3, detect_k, detect_p, "corner_topk_kernel",
           8 * ch * cw + 9 * n_exist + 13 * cfg.max_features, ch * cw)
    extra = rec["corner_cells"]["extra_device_of"] = {
        "this tree's whole detect, per call": (detect_k, 1)}
    if AGAINST is not None:
        other_k = lambda: AGAINST.detect(*det_args, **det_kw)
        extra["the other tree's kernels, the same call"] = (other_k, 1, "corner_")
        extra["the other tree's whole detect (kernels and glue), the same call"] = (other_k, 1)
        rec["corner_cells"]["other_ms"] = time_ms(other_k)
        log(f"K3 detect per call (CUDA events): {rec['corner_cells']['ms']:.4f} ms, the other "
            f"tree's detect {rec['corner_cells']['other_ms']:.4f} ms")
    PROBES["detect"] = (detect_k, AGAINST and (lambda: AGAINST.detect(*det_args, **det_kw)))

    phase3_k4(rec, S, xy0, pts1, ok1)

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

    # K6 on frame 0 (both launches recorded) and on a 61x97 crop of it, a
    # constant frame (anchors on the zero-padded border only) and an all-zero
    # one (every cell 0: the top-k falls back to cell order, no anchor ok)
    dcfg = lcfg.detect._replace(max_lines=lcfg.max_lines)
    ak, gk, err_a, err_w = k6_frame_check(u0, dcfg, "frame 0")
    ch6, cw6 = ak[3].shape
    record(rec, "line_anchors", err_a, lambda: lines.line_anchors(u0, dcfg),
           lambda: lines._anchors_plain(u0, dcfg), "line_anchors_kernel",
           4 * 4 * n_px + 8 * ch6 * cw6, 60 * n_px)
    n_alive = float((gk[3] - 1).clamp(min=0).sum())
    n_cells, A = ch6 * cw6, dcfg.max_anchors
    n_ok = int(gk[4].sum())
    # bytes: the cell values and indices read once, each a_ok walk's anchor
    # direction and its live samples (mag, dx, dy and both tube sides),
    # the outputs written once; operations: the selection's n log n
    # comparisons and ~60 a sample and a walk
    record(rec, "line_select_grow", err_w,
           lambda: lines.line_select_grow(ak[3], ak[4], *ak[:3], dcfg),
           lambda: lines.select_and_grow_plain(ak[3], ak[4], *ak[:3], dcfg),
           "line_select_grow_kernel",
           8 * n_cells + 4 * (5 * n_alive + 2 * n_ok) + 4 * 7 * A + A,
           2 * n_cells * math.log2(n_cells) + 60 * n_alive + 60 * n_ok)
    if AGAINST is not None:
        rec["line_anchors"].setdefault("extra_device_of", {})[
            "the other tree's kernel on frame 0"] = (
            lambda: AGAINST.line_anchors(u0, dcfg), 1, "line_anchors_kernel")
        rec["line_select_grow"].setdefault("extra_device_of", {})[
            "the other tree's kernel on frame 0"] = (
            lambda: AGAINST.line_select_grow(ak[3], ak[4], *ak[:3], dcfg), 1,
            AGAINST.grow_kernel())
    for label, im in (("a 61x97 crop of frame 0", u0[:61, :97].contiguous()),
                      ("a constant frame", torch.full_like(u0, 0.5)),
                      ("an all-zero frame", torch.zeros_like(u0))):
        k6_frame_check(im, dcfg, label)

    # K2 in gain/bias mode: the line matcher's anchors of frame 0 -> 1
    s0, _, v0 = lines.detect_lines(u0, dcfg)
    s1, _, v1 = lines.detect_lines(u1, dcfg)
    mcfg = lcfg.match
    anchors, amask = line_match.sample_anchors(s0, v0, mcfg)
    apts = anchors.reshape(-1, 2).contiguous()
    upyr0 = image.build_pyramid(u0, mcfg.klt.levels)
    upyr1 = image.build_pyramid(u1, mcfg.klt.levels)
    flow_err2, agree2, n2, level_same = 0.0, 0, 0, True
    am = amask.reshape(-1)
    for lvl in range(mcfg.klt.levels):
        sc = 2.0 ** lvl
        guess = torch.zeros_like(apts)
        fk, okk, rk = klt._track_level(upyr0[lvl], upyr1[lvl], apts / sc, guess, mcfg.klt)
        fp, okp, rp = klt._track_level_plain(upyr0[lvl], upyr1[lvl], apts / sc, guess, mcfg.klt)
        if AGAINST is not None:
            level_same &= all(torch.equal(a, b) for a, b in zip(
                (fk, okk, rk), AGAINST.track_level(upyr0[lvl], upyr1[lvl], apts / sc, guess,
                                                   mcfg.klt)))
        bth = okk & okp & am
        if bool(bth.any()):
            flow_err2 = max(flow_err2, float((fk - fp)[bth].abs().max()))
        agree2 += int((okk == okp)[am].sum())
        n2 += int(am.sum())
    agreement2 = agree2 / max(n2, 1)
    log(f"K2 klt_track_level (gain/bias, win {mcfg.klt.win}, {mcfg.klt.iters} iters): "
        f"{int(am.sum())} anchors of {int(v0.sum())} lines, max flow err (ok in both) = "
        f"{flow_err2:.3e} px (tol 1e-3), ok agreement {agreement2:.4f} (tol >= 0.99)"
        + ("" if AGAINST is None else
           f"; every level equal to the other tree's kernel to the bit: {level_same}"))
    if not (flow_err2 <= 1e-3 and agreement2 >= 0.99 and level_same):
        fail("K2 klt_track_level (gain/bias) disagrees with its plain version or the other "
             "tree's kernel")
    lvg = (upyr0[0], upyr1[0], apts, torch.zeros_like(apts), mcfg.klt)
    record(rec, "klt_track_level_gain_bias", flow_err2, lambda: klt._track_level(*lvg),
           lambda: klt._track_level_plain(*lvg), "klt_track_kernel",
           *klt_cost(apts.shape[0], mcfg.klt, u0.shape))
    tracked, okt, _ = klt_fused_check(rec, "klt_track_gain_bias", u0, u1, apts, am, mcfg.klt,
                                      klt_cost(apts.shape[0], mcfg.klt, u0.shape,
                                               mcfg.klt.levels, io=21))

    # K7 line_vote: the tracked anchors voting for frame 1's segments, then
    # the cases of utils/synthetic.line_vote_cases (ties of distance and of
    # votes, no valid target, L1 = 32, one valid source, collinear
    # midpoints, zero-length targets, the gate, the vote ratio), each against
    # the twin exactly, twice equal to the bit, and with --against equal to
    # the other tree's K7 to the bit
    L0, Aa = amask.shape
    vote_in = (tracked.reshape(L0, Aa, 2).contiguous(), okt.reshape(L0, Aa) & amask, s0, v0,
               s1, v1, mcfg)
    n_diff = k7_check("frame 0 -> 1", vote_in)
    from vplines_slam_tpu_torch.utils import synthetic

    for name, case in synthetic.line_vote_cases().items():
        k7_check(f"case {name!r}", tuple(
            torch.as_tensor(x, device=u0.device,
                            dtype=torch.bool if x.dtype == bool else torch.float32)
            for x in case) + (mcfg,))
    L1 = s1.shape[0]
    record(rec, "line_vote", n_diff, lambda: line_match.line_vote(*vote_in),
           lambda: line_match.line_vote_plain(*vote_in), "line_vote_kernel",
           L0 * Aa * 9 + (L0 + L1) * 17 + 8 * L0, 25 * L0 * Aa * L1 + 30 * L0 * L0)
    if AGAINST is not None:
        rec["line_vote"].setdefault("extra_device_of", {})[
            "the other tree's kernel on frame 0 -> 1"] = (
            lambda: AGAINST.line_vote(*vote_in), 1, "line_vote_kernel")

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
    # the same frame and the synthetic line sets of utils/synthetic.vp_line_cases
    # (hundreds of votes in one cell; votes on both wraps; no and one valid
    # line; pairs on the gate): the twin's mass, two calls equal to the last
    # bit, and with --vp-grid-against the other tree's kernel equal to the bit
    from vplines_slam_tpu_torch.utils import synthetic

    fx8, cx8, cy8 = synthetic.VP_CAMERA[:3]
    k8_sets = {"phase 3's frame": (line, length, angle, v0)}
    for label, (segs, val, angs) in synthetic.vp_line_cases(seed=SEED,
                                                            dtype=np.float32).items():
        ls, les, ans = vp._line_params(torch.as_tensor(segs, dtype=torch.float32,
                                                       device=line.device), fx8, cx8, cy8)
        if angs is not None:
            ans = torch.as_tensor(angs, device=line.device)
        k8_sets[label] = (ls, les, ans, torch.as_tensor(val, device=line.device))
    for label, args8 in k8_sets.items():
        gk = vp.vp_grid(*args8, vcfg)
        gp = vp.vp_grid_plain(*args8, vcfg)
        mass = abs(float(gk.sum()) - float(gp.sum())) / max(float(gp.sum()), 1e-30)
        same = torch.equal(gk, vp.vp_grid(*args8, vcfg))
        other = ("" if AGAINST is None else
                 f"; equal to the other tree's kernel to the bit: "
                 f"{torch.equal(gk, AGAINST.vp_grid(*args8, vcfg))}")
        log(f"K8 vp_grid, {label}: {int(args8[3].sum())} valid lines, total mass "
            f"{float(gk.sum()):.4f}, rel diff to the plain version {mass:.3e} (tol 1e-5); two "
            f"calls equal to the last bit: {same}{other}")
        if not (mass <= 1e-5 and same and (AGAINST is None
                                            or torch.equal(gk, AGAINST.vp_grid(*args8, vcfg)))):
            fail(f"K8 vp_grid on {label}")
    if AGAINST is not None:
        rec["vp_grid"]["extra_device_of"] = {
            "the other tree's vp_grid on phase 3's frame":
                (lambda: AGAINST.vp_grid(line, length, angle, v0, vcfg), 1, "vp_grid_kernel")}
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
    # two calls equal to the bit; an all-zero grid ties everywhere and must
    # give flat index 0 (vp1[0], sweep position 0) with best 0; the line sets
    # of utils/synthetic.vp_line_cases through detect_vps (the recorded
    # calls again equal to the bit); with --against vps, labels and best
    # equal to the bit to the other tree's vp_score on all of them
    sargs = (gp8, vp1, b1, b2, cs, sn, line, v0, vcfg)
    zargs = (torch.zeros_like(gp8),) + sargs[1:]
    zk = vp.vp_score(*zargs)
    v2_00 = b1[0] * cs[0] + b2[0] * sn[0]
    zero_ok = (torch.equal(zk[0][0], vp1[0]) and float(zk[2]) == 0.0
               and float((zk[0][1] - v2_00).abs().max()) <= 1e-6)
    with recording_vp([]) as vcases:
        u_rng = np.random.default_rng(SEED + 8)
        for label, (segs, val, _) in synthetic.vp_line_cases(seed=SEED,
                                                           dtype=np.float32).items():
            vp.detect_vps(torch.as_tensor(segs, dtype=torch.float32, device=line.device),
                          torch.as_tensor(val, device=line.device), fx8, cx8, cy8,
                          torch.as_tensor(u_rng.uniform(0, 1, (vcfg.n_pairs, 2)),
                                          device=line.device), vcfg)
    score_calls = [dict(score_args=sargs, score=sk), dict(score_args=zargs, score=zk)] + vcases
    again, same_o = vp_score_same(score_calls)
    log(f"K8 vp_score: an all-zero grid gives flat index 0 with best 0: {zero_ok}; on phase 3's "
        f"frame, the zero grid and the {len(vcases)} line sets of vp_line_cases: two calls "
        f"equal to the bit {again}"
        + ("" if AGAINST is None else f", vps, labels and best equal to the other tree's "
                                      f"vp_score to the bit {same_o}"))
    if not (zero_ok and again and same_o):
        fail("K8 vp_score: the zero grid's index, two calls or the other tree's kernel")
    P8 = vp1.shape[0]
    record(rec, "vp_score", err_s8, lambda: vp.vp_score(gp8, vp1, b1, b2, cs, sn, line, v0, vcfg),
           lambda: vp.vp_score_plain(gp8, vp1, b1, b2, cs, sn, line, v0, vcfg),
           "vp_score_kernel",
           4 * (vcfg.grid_la * vcfg.grid_lo + 9 * P8 + 2 * vcfg.n_sweep + 3 * Lg + 10) + Lg * 5,
           P8 * vcfg.n_sweep * 3 * 45 + Lg * 3 * 30)
    if AGAINST is not None:
        rec["vp_score"]["extra_device_of"] = {
            "the other tree's vp_score on the same inputs":
                (lambda: AGAINST.vp_score(*sargs), 1, "vp_score_kernel")}

    # K9 clahe: the raw frame (point tracker) and the undistorted one (line
    # tracker), 8x8 tiles of 60x94 px, 32 bins, clip 3.0; two calls to the
    # bit; with --against the other tree's kernels to the bit
    tiles, bins, clip = 8, 32, 3.0
    th9, tw9 = H // tiles, W // tiles
    lut_err, out_err, calls_same, other_same = 0.0, 0.0, True, True
    for im in (img0, u0.contiguous()):
        ok9, lk = image.clahe_cuda(im, clip, tiles, bins)
        ok9b, lkb = image.clahe_cuda(im, clip, tiles, bins)
        calls_same &= torch.equal(ok9, ok9b) and torch.equal(lk, lkb)
        calls_same &= torch.equal(ok9, image.clahe(im))
        lut_err = max(lut_err, float((lk - image.clahe_luts_plain(im, clip, tiles, bins))
                                     .abs().max()))
        out_err = max(out_err, float((ok9 - image.clahe_plain(im)).abs().max()))
        if AGAINST is not None:
            oo, lo = AGAINST.clahe(im, clip, tiles, bins)
            other_same &= torch.equal(oo, ok9) and torch.equal(lo, lk)
    other = ("" if AGAINST is None else
             f"; LUTs and output equal to the other tree's kernels to the bit: {other_same}")
    log(f"K9 clahe: LUTs max |kernel - plain| = {lut_err:.3e} (tol 1e-6: exact counts; the "
        f"scan adds in another order), output max |kernel - plain| = {out_err:.3e} (tol 1e-6, "
        f"images in [0, 1]); two calls equal to the bit: {calls_same}{other}")
    if not (lut_err <= 1e-6 and out_err <= 1e-6 and calls_same and other_same):
        fail("K9 clahe disagrees with its plain version, across two calls or with the other "
             "tree's kernels")
    # no PyTorch call computes CLAHE (nor its tile histograms + CDFs): no library time
    record(rec, "clahe", max(lut_err, out_err), lambda: image.clahe(img0),
           lambda: image.clahe_plain(img0), "clahe_kernel",
           4 * 2 * n_px + 4 * tiles * tiles * bins, 4 * th9 * tw9 * tiles * tiles + 40 * n_px)
    if AGAINST is not None:
        rec["clahe"]["extra_device_of"] = {
            "the other tree's K9 on the same image": lambda: AGAINST.clahe(img0, clip, tiles, bins)}

    # K10 preintegrate: one interval of 64 steps (every frame), the merged
    # interval of 128 (non-keyframes) and the 9 intervals of the initializer
    from vplines_slam_tpu_torch.models import imu
    from vplines_slam_tpu_torch.utils import synthetic

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
    live = lambda d, m: int(((d * m.to(d.dtype)) != 0).sum())
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
        log(f"K10 preintegrate {label} ({live(d, m)} live steps): max |kernel - plain| / max "
            f"|plain| per field {errs[worst]:.3e} ({worst}; tol 1e-5: f32 sums in another "
            f"order)")
    # the layouts of utils/synthetic.imu_interval_cases, at f32 and f64: each
    # field within tol of the twin's largest entry, two calls equal to the
    # last bit; with no live step J = I and P = 0 exactly
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        worst_case, repeat, exact = (0.0, None), True, True
        for label, arrs in synthetic.imu_interval_cases(seed=SEED).items():
            d, a, g, m, ba, bg = (torch.as_tensor(x, device=img0.device) for x in arrs)
            d, a, g, ba, bg = (x.to(dtype) for x in (d, a, g, ba, bg))
            pk = imu.preintegrate(d, a, g, m, ba, bg, params)
            pk2 = imu.preintegrate(d, a, g, m, ba, bg, params)
            pp = imu.preintegrate_plain(d, a, g, m, ba, bg, params)
            e = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                    for x, y in zip(pk, pp))
            worst_case = max(worst_case, (e, label), key=lambda t: t[0])
            repeat &= all(torch.equal(x, y) for x, y in zip(pk, pk2))
            if label == "no live step":
                exact = (torch.equal(pk.jacobian[0], torch.eye(15, dtype=dtype, device=d.device))
                         and not bool(pk.covariance.any()))
        log(f"K10 preintegrate, {len(synthetic.imu_interval_cases())} synthetic layouts at "
            f"{str(dtype).removeprefix('torch.')}: max |kernel - plain| / max |plain| per field "
            f"{worst_case[0]:.3e} ({worst_case[1]}; tol {tol:g}); two calls equal to the last "
            f"bit: {repeat}; no live step gives J = I, P = 0 exactly: {exact}")
        if not (worst_case[0] <= tol and repeat and exact):
            fail(f"K10 preintegrate disagrees with its plain version at {dtype}")
        if dtype == torch.float32:
            err10 = max(err10, worst_case[0])
    if not err10 <= 1e-5:
        fail("K10 preintegrate disagrees with its plain version")
    # ROADMAP C's deliberate divergence: K10 skips the matrix work of masked
    # steps, so a NaN acceleration sample read by masked steps only leaves its
    # result finite where the twin (NaN * 0) gives NaN.  An inf dt in a masked
    # slot makes dt * mask NaN (inf * 0), which both read as a live step: both
    # give NaN.  Pinned: the check fails if either side changes
    d1, a1, g1, m1 = cases["B=1 N=64"]
    z1 = torch.zeros(1, 3, device=d1.device)
    masked = (m1[0] == 0).tolist()
    pair = [j for j in range(1, len(masked)) if masked[j - 1] and masked[j]]
    if len(pair) < 2:
        fail("K10 divergence check: the B=1 N=64 interval has no two masked steps in a row")
    finite = lambda pre: all(bool(torch.isfinite(x).all()) for x in pre)
    a_nan = a1.clone()
    a_nan[0, pair[0], 0] = float("nan")
    d_inf = d1.clone()
    d_inf[0, pair[-1]] = float("inf")
    div = {label: (finite(imu.preintegrate(d, a, g1, m1, z1, z1, params)),
                   finite(imu.preintegrate_plain(d, a, g1, m1, z1, z1, params)))
           for label, d, a in (("a NaN acceleration sample", d1, a_nan),
                               ("an inf dt", d_inf, a1))}
    log(f"K10 on masked slots (ROADMAP C's divergence): with a NaN acceleration sample read "
        f"by masked steps only, K10 finite {div['a NaN acceleration sample'][0]}, its twin "
        f"finite {div['a NaN acceleration sample'][1]} (pinned: True, False); with an inf dt "
        f"in a masked slot, K10 finite {div['an inf dt'][0]}, its twin finite "
        f"{div['an inf dt'][1]} (pinned: False, False)")
    if div != {"a NaN acceleration sample": (True, False), "an inf dt": (False, False)}:
        fail("K10's handling of non-finite padding changed (ROADMAP C's pinned divergence)")
    n10 = d1.shape[1]
    # a masked step multiplies J and P by an exact identity: only the live
    # steps' operations count
    record(rec, "preintegrate", err10, lambda: imu.preintegrate(d1, a1, g1, m1, z1, z1, params),
           lambda: imu.preintegrate_plain(d1, a1, g1, m1, z1, z1, params),
           "preintegrate_kernel",
           4 * (n10 + 2 * (n10 + 1) * 3 + 6 + 4 + 10 + 2 * 225 + 1) + n10,
           live(d1, m1) * preintegrate_step_ops())
    d9, a9, g9, m9 = cases[f"B={nb} N=64"]
    z9 = torch.zeros(nb, 3, device=d9.device)
    rec["preintegrate"]["extra_device_of"] = {
        f"B={nb} N=64, the initializer's batch ({live(d9, m9)} live steps)":
            lambda: imu.preintegrate(d9, a9, g9, m9, z9, z9, params)}
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
        bk2 = linearize._window_lin_cuda(x_lo, data_lo, cfg, params, True, True, True)
        rk2 = linearize._window_lin_cuda(x_lo, data_lo, cfg, params, True, True, False)
        if not (all(torch.equal(a, b) for a, b in zip(bk, bk2) if a is not None)
                and torch.equal(rk, rk2)):
            fail(f"K11 window_lin does not repeat to the last bit ({label} window)")
        log(f"K11 window_lin ({label}): two calls of each mode equal to the last bit")
        # K12 on K11's own blocks, then with every point anchored at frame 0
        # (one frame's tiles carry every observation; its own observation's
        # two pose columns merge, as the twin's scatter merges them) and on
        # the marginalization stack's blocks and layout
        cfg_m = cfg._replace(marg_lines=True) if lines else cfg
        data_r = slide.marginalization_stack(data, cfg_m)
        lay_m = win.layout_for(cfg, lines, use_relo=False, use_vps=False)
        blocks_m = linearize._window_lin_cuda(x, data_r, cfg_m, params, False, False, True)
        tol12, err12 = 1e-12, {}
        for case, (b12, lay12) in {
                "window": (bk, layout),
                "anchors at frame 0": (bk._replace(pt_start=torch.zeros_like(bk.pt_start)),
                                       layout),
                "marginalization": (blocks_m, lay_m)}.items():
            nek = lm._assemble_blocks_cuda(b12, lay12)
            nep = lm.assemble_blocks_plain(b12, lay12)
            err12[case] = max(_rel_err(a, b) for a, b in zip(nek, nep))
            if not all(torch.equal(a, b) for a, b in zip(nek, lm._assemble_blocks_cuda(b12,
                                                                                       lay12))):
                fail(f"K12 window_blocks does not repeat to the last bit ({label}, {case})")
        log(f"K12 window_blocks ({label}): max |kernel - plain| / max |plain| over the "
            f"blocks " + ", ".join(f"{k} {v:.2e}" for k, v in err12.items())
            + f" (tol {tol12}: f64 sums of the same f32 products in another order); two "
            f"calls equal to the last bit in each case")
        err12 = max(err12.values())
        if not err12 <= tol12:
            fail(f"K12 window_blocks disagrees with its plain version ({label} window)")
        nep = lm.assemble_blocks_plain(bk, layout)
        # K13 on the same normal equations, small to large damping
        err13 = errS = 0.0
        for lam in (1e-4, 10.0, 1e4):
            lam_t = torch.tensor(lam, dtype=f64, device=state.p.device)
            keep = {}
            dk = lm._schur_cuda(*nep[:5], lam_t, 1e-8, *(nep[5:] or (None,) * 3), f64, keep)
            dk2 = lm._schur_cuda(*nep[:5], lam_t, 1e-8, *(nep[5:] or (None,) * 3), f64)
            dp = lm.schur_solve_blocks_plain(*nep[:5], lam, 1e-8, *nep[5:], out_dtype=f64)
            err13 = max(err13, _rel_err(dk, dp))
            if not torch.equal(dk, dk2):
                fail(f"K13 schur_solve does not repeat to the last bit ({label}, lambda {lam})")
            # launch 2's tiles (the f64 MMA) against torch's f64 S
            S_p, rhs_p, _ = lm.schur_system(*nep[:5], lam_t, 1e-8, *nep[5:])
            S_k = schur_untile(keep["S"], layout.nd)
            errS = max(errS, _rel_err(torch.tril(S_k), torch.tril(S_p)),
                       _rel_err(keep["rhs"][:layout.nd], rhs_p))
        tol13, tolS = 1e-6, 1e-12
        log(f"K13 schur_solve ({label}): max |kernel - plain| / max |plain| of the delta "
            f"{err13:.2e} at lambda 1e-4, 10 and 1e4 (tol {tol13}: f64; a 177x177 Cholesky in "
            f"another order, condition up to ~1e6 after the Jacobi scaling); S's tiles and the "
            f"rhs of its product launch against torch's f64 {errS:.2e} (tol {tolS}: f64 sums of "
            f"the same products in another order); two calls equal to the last bit")
        if not (err13 <= tol13 and errS <= tolS):
            fail(f"K13 schur_solve disagrees with its plain version ({label} window)")
        # an indefinite S (a negative diagonal entry of H_dd): all NaN, as the twin
        bad = [t.clone() for t in nep]
        bad[0][3, 3] = -1.0
        nk = lm._schur_cuda(*bad[:5], 1e-4, 1e-8, *(bad[5:] or (None,) * 3), f64)
        npl = lm.schur_solve_blocks_plain(*bad[:5], 1e-4, 1e-8, *bad[5:], out_dtype=f64)
        log(f"K13 schur_solve ({label}), indefinite S: kernel all NaN {bool(nk.isnan().all())}, "
            f"plain all NaN {bool(npl.isnan().all())}")
        if not (bool(nk.isnan().all()) and bool(npl.isnan().all())):
            fail(f"K13 schur_solve: an indefinite S must give an all-NaN delta ({label})")
        # K14 on the marginalization stack's normal equations (the main
        # path's input), with no points, no lines and neither, and on the
        # whole window's (every landmark column live)
        ne_m = lm._assemble_blocks_cuda(blocks_m, lay_m)
        m_args = (*ne_m[:5], *(ne_m[5:] or (None,) * 3), 1e-12)
        nones = (None,) * 3
        err14 = {}
        for case, a14 in {"stack": m_args, "P = 0": (*m_args[:2], *nones, *m_args[5:]),
                          "L = 0": (*m_args[:5], *nones, m_args[8]),
                          "P = L = 0": (*m_args[:2], *nones, *nones, m_args[8]),
                          "the window's": (*nep[:5], *(nep[5:] or nones), 1e-12)}.items():
            mk = marg._marg_stage1_cuda(*a14)
            mk2 = marg._marg_stage1_cuda(*a14)
            mp = marg.marg_stage1_plain(*a14)
            err14[case] = max(_rel_err(a, b) for a, b in zip(mk, mp))
            if not all(torch.equal(a, b) for a, b in zip(mk, mk2)):
                fail(f"K14 marg_window does not repeat to the last bit ({label}, {case})")
            if not torch.equal(mk[0], mk[0].T):
                fail(f"K14 marg_window: H1 is not symmetric to the last bit ({label}, {case})")
        tol14 = 1e-9
        log(f"K14 marg_window ({label}, marg_lines {lines}; the stack's live points and lines "
            f"{live_landmarks(ne_m)}, the window's {live_landmarks(nep)}): max |kernel - plain| "
            f"/ max |plain| of H1, b1, c " + ", ".join(f"{k} {v:.2e}" for k, v in err14.items())
            + f" (tol {tol14}: f64; the f64-MMA product in another order, per-line Jacobi "
            f"against LAPACK eigh for the clipped inverses); two calls equal to the last bit, "
            f"H1 symmetric to the last bit")
        err14 = max(err14.values())
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
        record(rec, "window_lin_cost", err11,
               lambda: linearize._window_lin_cuda(x, data, cfg, params, True, True, False),
               lambda: win.window_residuals(x, data, cfg, params), "wlin_",
               _nbytes(*ins11, blocks.r), window_lin_ops(n_act, cfg, tangents=False))
        J_dense = lm.blocks_to_dense(blocks, layout)[1].double()
        record(rec, "window_blocks", err12, lambda: lm._assemble_blocks_cuda(blocks, layout),
               lambda: lm.assemble_blocks_plain(blocks, layout), "wblk_",
               _nbytes(*outs11, *ne), window_blocks_ops(n_act, cfg),
               library_fn=lambda: J_dense.T @ J_dense,
               library_label="J_d^T J_d in f64 on the dense scatter: H_dd alone, a part of "
                             "the output")
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
        Hs, Y, Cm = marg_columns(*m_args)
        record(rec, "marg_window", err14, lambda: marg._marg_stage1_cuda(*m_args),
               lambda: marg.marg_stage1_plain(*m_args), "marg_",
               _nbytes(*ne_m) + 8 * (cfg.nd * cfg.nd + 2 * cfg.nd), marg_ops(ne_m, cfg),
               library_fn=lambda: torch.addmm(Hs, Y, Cm.T, alpha=-1),
               library_label="the elimination product alone: addmm(H_dd / (c c^T), Y, C^T, "
                             "alpha=-1) in f64 on prebuilt columns")


def schur_untile(tiles, nd):
    """K13's lower 16x16 tiles [n, 16, 16] as the [nd, nd] matrix they tile
    (the upper tiles zero)."""
    import torch

    nb = int(round(((8 * tiles.shape[0] + 1) ** 0.5 - 1) / 2))
    M = torch.zeros(16 * nb, 16 * nb, dtype=tiles.dtype, device=tiles.device)
    k = 0
    for i in range(nb):
        for j in range(i + 1):
            M[16 * i:16 * i + 16, 16 * j:16 * j + 16] = tiles[k]
            k += 1
    return M[:nd, :nd]


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


def window_lin_ops(n, cfg, tangents=True):
    """K11's operations on the live rows: the jets (the values alone in the
    residual-only mode), and per prior row its dot product with dx and its
    3x3 block products."""
    widths = dict(J_pt=20, J_relo=20, J_ln=17, J_vp=17, J_imu=31)
    prior = n["J_prior"] * (2 * cfg.nd + (18 * (cfg.nf + 2) if tangents else 0))
    return prior + sum(n[f] * (K11_ROW_OPS[f] if tangents else K11_ROW_OPS[f] // widths[f])
                       for f in K11_ROW_OPS)


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


def marg_columns(H_dd, g_d, H_dp, h_p, g_p, H_dl, Hll_b, g_l, eps):
    """The operands of K14's elimination product, from the twin's plain ops:
    H_dd / (c c^T), the weighted columns Y = [Cp diag(dpi) | Cl blockdiag(D_l)]
    and the scaled columns C = [Cp | Cl] [nd, P + 4 L], f64."""
    import torch

    from vplines_slam_tpu_torch.solver import lm, marginalization as marg

    c = lm._jacobi(torch.diagonal(H_dd))
    c_p = lm._jacobi(h_p)
    Cp = H_dp / (c[:, None] * c_p[None, :])
    dp = h_p / (c_p * c_p)
    dpi = torch.where(marg._clip_gate(dp[None, :], eps)[0], 1.0 / torch.clamp(dp, min=1e-30),
                      torch.zeros_like(dp))
    c_l = lm._jacobi(torch.diagonal(Hll_b, dim1=1, dim2=2))
    Cl = H_dl / (c[:, None, None] * c_l[None])
    wl, Vl = torch.linalg.eigh(Hll_b / (c_l[:, :, None] * c_l[:, None, :]))
    wli = torch.where(marg._clip_gate(wl, eps), 1.0 / torch.clamp(wl, min=1e-30),
                      torch.zeros_like(wl))
    D = torch.einsum("lab,lb,lcb->lac", Vl, wli, Vl)
    Yl = torch.einsum("nla,lab->nlb", Cl, D)
    nd = H_dd.shape[0]
    return (H_dd / (c[:, None] * c[None, :]), torch.cat([Cp * dpi[None], Yl.reshape(nd, -1)], 1),
            torch.cat([Cp, Cl.reshape(nd, -1)], 1))


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 3, loop closure: K15-K19 against their plain twins
# ---------------------------------------------------------------------------


def loop_kernels():
    """K15-K19 and K21, the kernels of a loop verification's path."""
    from vplines_slam_tpu_torch.models.pose_graph import PGO4
    from vplines_slam_tpu_torch.ops.brief import (BRIEF, FAST_SELECT, FAST_TILES, HAMMING_MATCH,
                                                  SIMHASH)
    from vplines_slam_tpu_torch.ops.mvg import PNP_HYPOTHESES, PNP_REFINE

    return [FAST_TILES, FAST_SELECT, BRIEF, HAMMING_MATCH, SIMHASH, PNP_HYPOTHESES, PGO4,
            PNP_REFINE]


def selector_kernels():
    """K20."""
    from vplines_slam_tpu_torch.models.selector import SELECTOR_GREEDY, SELECTOR_INFO

    return [SELECTOR_INFO, SELECTOR_GREEDY]


def loop_twin_check(where):
    """No plain twin of K4 or K15-K24 ran."""
    from vplines_slam_tpu_torch.kernels import TWIN_CALLS

    calls = dict(TWIN_CALLS)
    log(f"  calls of the plain twins of K4 and K15-K24: {calls}")
    if any(calls.values()):
        fail(f"{where}: the card path called a plain twin of K4 or K15-K24: {calls}")


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


def pgo_case_db(case, dev):
    """A case of ``utils/synthetic.pgo_cases`` as the card holds a database
    (f32, grown by ``grow_db`` where the case says so)."""
    import torch

    from vplines_slam_tpu_torch.models import pose_graph as pg_mod

    K = case["p_vio"].shape[0]
    cfg = pg_mod.PoseGraphConfig(max_keyframes=K, n_features=4, n_window_pts=4)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    db = pg_mod.empty_db(cfg, torch.float32, dev)._replace(
        count=torch.tensor(case["count"], device=dev), seq=t(case["seq"]),
        loop_to=t(case["loop_to"]),
        **{f: t(case[f]).float() for f in ("p_vio", "q_vio", "p_pgo", "yaw_pgo", "loop_t",
                                           "loop_yaw")})
    return pg_mod.grow_db(db) if case["grow"] else db


def k19_check(label, x, db, cfg, ypr=None):
    """K19 with H on (x, db): one launch a call, again equal to the bit, r
    and H within 1e-12 of the f64 twin's largest entry and g within 1e-12 of
    its largest summand (max |J|^T |r|: near the LM's optimum g is a sum
    that cancels, and two orders of it differ by rounding of the summands,
    not of the sum); with --against the other tree's K19 equal to the bit.
    Logs whether H is symmetric to the bit (it is not where two loop edges
    join one pair: the blocks (a, b) and (b, a) sum them in opposite orders,
    as the previous design did).  Returns (ok, err, text)."""
    import torch
    from torch.func import jacfwd

    from vplines_slam_tpu_torch.models import pose_graph as pg_mod

    ypr = pg_mod._ypr_vio(db) if ypr is None else ypr
    n0 = pg_mod.PGO4.launches
    out = pg_mod.pgo_normal(x, db, ypr, cfg)
    one = pg_mod.PGO4.launches - n0 == 1
    again = _equal(pg_mod.pgo_normal(x, db, ypr, cfg), out)
    r, H, g = pg_mod.pgo_normal_plain(x, db, ypr, cfg)
    K = x.shape[0]
    db64, y64 = pg_mod._f64_db(db), ypr.double()
    J = jacfwd(lambda xf: pg_mod.pgo_residual(xf.reshape(K, 4), db64, y64, cfg))(
        x.double().reshape(-1))
    g_scale = float((J.abs().T @ r.abs()).max())
    rel = lambda a, b, scale: float((a - b).abs().max()) / max(scale, 1e-300)
    errs = dict(r=rel(out[0], r, float(r.abs().max())), H=rel(out[1], H, float(H.abs().max())),
                g=rel(out[2], g, g_scale))
    err = max(errs.values())
    sym = bool(torch.equal(out[1], out[1].T))
    ok = one and again and err <= 1e-12
    scaled = ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
    text = (f"{label}: K {K}, {int(db.count)} keyframes, {int((db.loop_to >= 0).sum())} loop "
            f"edges: max |kernel - plain| over the scale {scaled} (tol 1e-12), one launch "
            f"{one}, again equal {again}, H symmetric {sym}")
    if AGAINST is not None:
        same = _equal(AGAINST.pgo_normal(x, db, ypr, cfg), out)
        ok = ok and same
        text += f", the other tree's r, H, g equal to the bit {same}"
    return ok, err, text


def pnp_determined(X_w, x, mask, idx):
    """Per sample row of idx, whether its pose is determined by the data
    rather than by an eigensolver's rounding: six distinct unmasked points
    (``full``: full rank) whose 12x12 A^T A has a relative gap above 1e-10
    between its two smallest eigenvalues (so eps / gap bounds the
    eigenvector's error near 1e-6), whose sample depths under that vector
    sum to more than 1e-4 of their magnitudes (the sign fix is not a coin
    flip) and whose M = P[:, :3] has its smallest singular value above 1e-4
    of its largest (the polar factor R is unique).  Returns (full,
    determined)."""
    import torch

    srt = torch.sort(idx, dim=1).values
    full = (srt[:, 1:] != srt[:, :-1]).all(1) & mask[idx].all(1)
    Xh = torch.cat([X_w.double()[idx], torch.ones_like(X_w.double()[idx][..., :1])], -1)
    u = x.double()[idx]
    z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z, -u[..., :1] * Xh], -1),
                   torch.cat([z, Xh, -u[..., 1:] * Xh], -1)], 1)
    lam, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    gap = (lam[:, 1] - lam[:, 0]) / lam[:, -1]
    P = V[:, :, 0].reshape(-1, 3, 4)
    depths = (Xh * P[:, 2:3, :]).sum(-1)
    sign_ok = depths.sum(-1).abs() > 1e-4 * depths.abs().sum(-1)
    sv = torch.linalg.svdvals(P[:, :, :3])
    return full, full & (gap > 1e-10) & sign_ok & (sv[:, 2] > 1e-4 * sv[:, 0])


def essential_svd_reference(x1, x2, sm):
    """The E of each sample mask row of sm [n, N] from the f64 SVD of its A
    (the last right singular vector: the null vector without A^T A's squared
    condition, good to ~eps / sqrt(gap)), projected to sigma = (1, 1, 0) by
    an SVD."""
    import torch

    from vplines_slam_tpu_torch.utils.synthetic import essential_rows

    Vh = torch.linalg.svd(essential_rows(x1, x2, sm), full_matrices=True)[2]
    U, _, Wt = torch.linalg.svd(Vh[:, -1].reshape(-1, 3, 3))
    return (U * torch.tensor([1.0, 1.0, 0.0], dtype=U.dtype, device=U.device)) @ Wt


def essential_err(E, ref):
    """max |E - s ref| / max |ref| per matrix of [..., 3, 3], s = +-1 the
    closer (E is defined up to sign)."""
    import torch

    E, ref = E.double(), ref.double()
    s = torch.sign((E * ref).sum((-1, -2)))[..., None, None]
    return (E - s * ref).abs().amax((-1, -2)) / ref.abs().amax((-1, -2))


K4_E_TOL = 1e-9  # each determined E against the f64 SVD reference, of its largest entry


def ransac_ops(n_hyp, N, n_inl, sweeps=6):
    """Operations of one ransac_essential call: per hypothesis the
    Householder QR of the 9x8 A^T (~810), Q e_9 (~290), the rows (9) and the
    rank-2 projection (a 3x3 Jacobi, ~1,000); the refit's 45 sums over its
    n_inl rows (3 each), its 10x10 Jacobi (sweeps x 45 rotations x ~160)
    and projection; the Sampson test (34 a track) of every hypothesis and
    of the refit."""
    return (n_hyp * (810 + 290 + 9 + 1000) + 45 * 3 * n_inl + sweeps * 45 * 160 + 1000
            + 34 * (n_hyp + 1) * N)


def sampson_rounded(Es, x1, x2, mask, thr):
    """K4's Sampson test of each E of Es [n, 3, 3] in the inputs' dtype, every
    operation rounded on its own in the kernel's order (each torch operation
    here is one rounding; no contraction into FMAs): (counts [n] int32, inl
    [n, N] bool)."""
    import torch

    E = Es.reshape(-1, 9)[:, :, None]
    u1, v1, u2, v2 = (c[None] for c in (x1[:, 0], x1[:, 1], x2[:, 0], x2[:, 1]))
    row = lambda a, b, c, x, y: (E[:, a] * x + E[:, b] * y) + E[:, c]
    e0, e1, e2 = row(0, 1, 2, u1, v1), row(3, 4, 5, u1, v1), row(6, 7, 8, u1, v1)
    f0, f1 = row(0, 3, 6, u2, v2), row(1, 4, 7, u2, v2)
    num = (u2 * e0 + v2 * e1) + e2
    den = (((e0 * e0 + e1 * e1) + f0 * f0) + f1 * f1) + 1e-18
    thr2 = torch.tensor(thr * thr, dtype=torch.float64, device=x1.device).to(x1.dtype)
    inl = ((num * num) / den < thr2) & mask.bool()
    return inl.sum(1, dtype=torch.int32), inl


def k4_check(label, x1, x2, mask, draws, thr, min_valid=0, out=None):
    """K4 on one ransac_essential call's inputs (x1, x2 on the card in the
    main path's dtype): one launch, again equal to the bit (and to out, the
    call's recorded outputs); under the gate inl = mask, n = n_valid, E = 0.
    In the call's own dtype: every count and flag exactly K4's rounded
    Sampson test (``sampson_rounded``) of its own E, and the final (E, inl,
    n) exactly the plain pick, score and ``better`` choice applied to its own
    hypotheses and refit.  The kernel at f64 on the inputs cast to f64
    against the plain path at f64: each determined hypothesis's E
    (``essential_determined``) within K4_E_TOL of the f64 SVD reference and
    within the plain path's own error, 1e-9 + 10 eps / gap, of the plain
    path's; every count and flag exactly ``sampson_score_plain`` of the
    kernel's own E; where both winners and the refit are determined, the
    final E within those bounds and the inliers and count exact.  The main
    path's call fits as the f64 call does (its hypotheses' E, and its refit's
    where the two winners' inliers agree, are the f64 call's rounded, to the
    bit); its counts against the f32 plain path are printed.  Returns (ok,
    stats, text)."""
    import torch

    from vplines_slam_tpu_torch.ops import mvg
    from vplines_slam_tpu_torch.utils import synthetic as syn

    eps = float(torch.finfo(torch.float64).eps)
    n0 = mvg.RANSAC_ESSENTIAL.launches
    k = mvg.ransac_essential(x1, x2, mask, draws, thr, min_valid, return_hypotheses=True)
    one = mvg.RANSAC_ESSENTIAL.launches - n0 == 1
    again = _bits_equal(mvg.ransac_essential(x1, x2, mask, draws, thr, min_valid, True), k)
    same = out is None or _bits_equal(out, k[:3])
    st = dict(gated=False, undetermined=False, final=False, e_ref=0.0, e_plain=0.0, ratio=0.0,
              dcount=0, n_det=0)
    text = f"{label}: one launch {one}, again equal to the bit {again}"
    if out is not None:
        text += f", equal to the path's outputs {same}"
    if int(mask.sum()) < min_valid:
        st["gated"] = True
        gate = (torch.equal(k[1], mask.bool()) and int(k[2]) == int(mask.sum())
                and not bool(k[0].any()))
        return one and again and same and gate, st, text + f"; gated: inl = mask etc. {gate}"
    # the call in its own dtype: flags, pick, refit score and choice
    counts_r, inls_r = sampson_rounded(k[3], x1, x2, mask, thr)
    own_flags = torch.equal(counts_r, k[4]) and torch.equal(inls_r, k[5])
    b = int(torch.argmax(k[4]))
    n_ref, inl_ref = sampson_rounded(k[6][None], x1, x2, mask, thr)
    better = int(n_ref[0]) >= int(k[4][b])
    pick = (k[6] if better else k[3][b], inl_ref[0] if better else k[5][b],
            torch.maximum(n_ref[0], k[4][b]))
    own_pick = _bits_equal(k[:3], pick)
    f64 = torch.float64
    x1d, x2d = x1.to(f64), x2.to(f64)
    kd = k if x1.dtype == f64 else mvg.ransac_essential(x1d, x2d, mask, draws, thr, min_valid,
                                                       True)
    pd = mvg.ransac_essential_plain(x1d, x2d, mask, draws, thr, min_valid, True)
    idx, sm = syn.essential_samples(mask, draws)
    full, det = syn.essential_determined(x1, x2, mask, idx)
    gap = syn.essential_fit_determined(x1, x2, sm)[1]
    bound = 1e-9 + 10 * eps / gap.clamp(min=1e-300)
    err_ref, err_plain = essential_err(kd[3], essential_svd_reference(x1, x2, sm)), essential_err(
        kd[3], pd[3])
    if bool(det.any()):
        st.update(e_ref=float(err_ref[det].max()), e_plain=float(err_plain[det].max()),
                  ratio=float((err_plain / bound)[det].max()), n_det=int(det.sum()))
    hyp_ok = st["e_ref"] <= K4_E_TOL and st["ratio"] <= 1.0
    cs, is_ = mvg.sampson_score_plain(kd[3], x1d, x2d, mask, thr)
    flags = torch.equal(cs, kd[4]) and torch.equal(is_, kd[5])
    bk, bp = int(torch.argmax(kd[4])), int(torch.argmax(pd[4]))
    # the refit is the f64 call's where both calls refit the same inliers
    same_refit = b == bk and torch.equal(k[5][b], kd[5][bk])
    fits32 = _bits_equal((k[3],) + ((k[6],) if same_refit else ()),
                         (kd[3].to(x1.dtype),) + ((kd[6].to(x1.dtype),) if same_refit else ()))
    if x1.dtype != f64:
        st["dcount"] = int((k[4] - mvg.ransac_essential_plain(x1, x2, mask, draws, thr,
                                                              min_valid, True)[4]).abs().max())
    final_ok = True
    if bool(det[bk]) and bool(det[bp]):
        inl_w = kd[5][bk][None]
        refit_det, refit_gap = syn.essential_fit_determined(x1, x2, inl_w)
        if bool(refit_det[0]):
            st["final"] = True
            tol = 1e-9 + 10 * eps / float(torch.minimum(refit_gap[0], gap[bk]))
            e_svd = min(float(essential_err(kd[0], essential_svd_reference(x1, x2, inl_w))[0]),
                        float(err_ref[bk]))
            final_ok = (bk == bp and torch.equal(kd[1], pd[1]) and int(kd[2]) == int(pd[2])
                        and float(essential_err(kd[0], pd[0])) <= tol and e_svd <= K4_E_TOL)
    else:
        st["undetermined"] = True
    ok = (one and again and same and own_flags and own_pick and hyp_ok and flags and fits32
          and final_ok)
    text += (f"; {x1.dtype}: counts and flags = K4's rounded Sampson test of its own E "
             f"{own_flags}, E/inl/n = the plain pick and choice on its own hypotheses and refit "
             f"{own_pick} (better {better}); f64: {st['n_det']} of {draws.shape[0]} hypotheses "
             f"determined ({int(full.sum())} full-rank), E max err {st['e_ref']:.2e} to the SVD "
             f"reference (tol {K4_E_TOL}), {st['e_plain']:.2e} to the plain path "
             f"({st['ratio']:.2f} of its eps/gap bound); counts and flags = the plain scoring of "
             f"its E {flags}; winner {bk} (plain {bp}"
             + (", undetermined" if st["undetermined"] else "") + "), final "
             + (f"equal {final_ok}" if st["final"] else "not compared")
             + f"; main path's fits = the f64 call's rounded {fits32} (refit "
             + ("included" if same_refit else "left out: the winners' inliers differ")
             + f"), counts against the {x1.dtype} plain path max |diff| {st['dcount']}; "
             f"n {int(k[2])}")
    return ok, st, text


def pnp_normal_matrices(X_w, x, sm):
    """The hypotheses' DLT normal matrices A^T A [n_hyp, 12, 12] over each
    sample set sm [n_hyp, N], as the twin forms them."""
    import torch

    Xh = torch.cat([X_w, torch.ones_like(X_w[:, :1])], 1)
    z = torch.zeros_like(Xh)
    m = sm.to(X_w.dtype)[..., None]
    r0 = torch.cat([Xh, z, -x[:, :1] * Xh], 1) * m
    r1 = torch.cat([z, Xh, -x[:, 1:] * Xh], 1) * m
    A = torch.cat([r0, r1], 1)
    return A.transpose(-1, -2) @ A


def k18_check(label, X, x, mask, idx, thr, chosen_bar):
    """K18 on one call's inputs: one launch, again equal to the bit; on the
    rows whose pose is determined (``pnp_determined``) the counts and
    inlier masks equal to the f64 twin's and R, t within 1e-6 of them; with
    --against the other tree's counts and inliers equal on those rows; with
    chosen_bar the chosen hypothesis (the first with the most inliers) the
    same as the other tree's, or as the twin's without --against, wherever
    both chose a determined row.  Logs the full-rank rows left out and what
    the kernels gave there.  Returns (ok, err, text)."""
    import torch

    from vplines_slam_tpu_torch.ops import mvg

    n0 = mvg.PNP_HYPOTHESES.launches
    out = mvg.pnp_hypotheses(X, x, mask, idx, thr)
    one = mvg.PNP_HYPOTHESES.launches - n0 == 1
    again = _equal(mvg.pnp_hypotheses(X, x, mask, idx, thr), out)
    Rk, tk, ck, ik = out
    Rp, tp, cp, ip_ = mvg.pnp_hypotheses_plain(X.double(), x.double(), mask, idx, thr)
    distinct, full = pnp_determined(X, x, mask, idx)
    rt_err = lambda R, t, rows: (max(float((R - Rp)[rows].abs().max()),
                                     float((t - tp)[rows].abs().max()))
                                 if bool(rows.any()) else 0.0)
    err = rt_err(Rk, tk, full)
    same_twin = bool(torch.equal(ck[full], cp[full]) and torch.equal(ik[full], ip_[full]))
    left = distinct & ~full
    chosen, ref = int(torch.argmax(ck)), int(torch.argmax(cp))
    ok = one and again and same_twin and err <= 1e-6
    text = (f"{label}: {int(full.sum())} determined of {idx.shape[0]} ({int(distinct.sum())} "
            f"full-rank); counts and inliers equal to the twin's {same_twin}, R/t max |kernel - "
            f"f64 twin| {err:.2e} (tol 1e-6), one launch {one}, again equal {again}, chosen "
            f"{chosen} (the twin's {ref})")
    if bool(left.any()):
        text += (f"; on the {int(left.sum())} full-rank rows left out the counts equal the "
                 f"twin's on {int((ck[left] == cp[left]).sum())}, R/t max diff "
                 f"{rt_err(Rk, tk, left):.2e}")
    if AGAINST is not None:
        Ro, to_, co, io = AGAINST.pnp_hypotheses(X, x, mask, idx, thr)
        same = bool(torch.equal(ck[full], co[full]) and torch.equal(ik[full], io[full]))
        ref = int(torch.argmax(co))
        ok = ok and same
        text += (f", the other tree's counts and inliers equal {same}, its chosen {ref}, its R/t "
                 f"max |diff| to the twin {rt_err(Ro, to_, full):.2e}")
        if bool(left.any()):
            text += f" ({rt_err(Ro, to_, left):.2e} on the rows left out)"
    if chosen_bar:
        both = bool(full[chosen]) and bool(full[ref])
        ok = ok and (chosen == ref or not both)
        if chosen != ref:
            text += (f"; the chosen hypotheses differ: {chosen} "
                     f"{'determined' if bool(full[chosen]) else 'not determined'}, {ref} "
                     f"{'determined' if bool(full[ref]) else 'not determined'}")
    return ok, err, text


@contextlib.contextmanager
def recording_loop(store):
    """Keep every K19 call with H (``pose_graph.pgo_normal``, one an LM
    iteration of ``optimize_4dof``), every K18 call (``mvg.pnp_hypotheses``),
    every K17 match (``brief.match_descriptors``) and every K21 call
    (``mvg.pnp_refine``, each one a verification) of the block in store
    ({"pgo": [], "pnp": [], "match": [], "refine": []}), as references to
    their inputs and outputs, for ``loop_calls_check``."""
    from vplines_slam_tpu_torch.models import pose_graph as pg_mod
    from vplines_slam_tpu_torch.ops import brief, mvg

    pgo, pnp = pg_mod.pgo_normal, mvg.pnp_hypotheses
    match, refine = brief.match_descriptors, mvg.pnp_refine

    def rec_pgo(x, db, ypr_vio, cfg, with_h=True):
        out = pgo(x, db, ypr_vio, cfg, with_h)
        if with_h:
            store["pgo"].append(((x, db, ypr_vio, cfg), out))
        return out

    def recorder(fn, key):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            store[key].append(((args, kwargs), out))
            return out
        return rec

    pg_mod.pgo_normal, mvg.pnp_hypotheses = rec_pgo, recorder(pnp, "pnp")
    brief.match_descriptors, mvg.pnp_refine = recorder(match, "match"), recorder(refine, "refine")
    try:
        yield store
    finally:
        pg_mod.pgo_normal, mvg.pnp_hypotheses = pgo, pnp
        brief.match_descriptors, mvg.pnp_refine = match, refine


def _pose_gap(R, t, R2, t2):
    """The largest |R - R2| and |t - t2| entry, non-finite entries left out
    (their positions are compared apart)."""
    return max(float((R - R2).abs().nan_to_num(0.0).max()),
               float((t - t2).abs().nan_to_num(0.0).max()))


def loop_verification_check(rec, store, where):
    """Every recorded K17 match: again equal to the bit to the run's output,
    equal to the twin's and (with --against) the other tree's kernel's;
    every recorded K21 call: again equal to the bit, non-finite where the
    f64 twin and the other tree's kernel are, R/t within 1e-5 of the f64
    twin on the same inputs and of the other tree's kernel (both f64
    inside, the pose rounded to f32).  Adds both kernels' device times per
    call over these calls to their records, the other tree's beside them."""
    import torch

    from vplines_slam_tpu_torch.ops import brief, mvg

    ok17, n_match, n_pairs = True, 0, 0
    for (args, kw), out in store["match"]:
        ok = _equal(brief.match_descriptors(*args, **kw), out)
        plain = brief.match_descriptors_plain(*args, **kw)
        ok = ok and _equal(plain, out)
        if AGAINST is not None:
            ok = ok and _equal(AGAINST.match_descriptors(*args, **kw), out)
        ok17 &= ok
        n_match += int((out[0] >= 0).sum())
        n_pairs = args[0].shape[0] * args[2].shape[0]
    log(f"K17 match on {where}'s {len(store['match'])} verifications ({n_pairs} pairs each, "
        f"{n_match} matches in all): equal to the bit to the run's output, again, to the twin"
        + ("" if AGAINST is None else " and to the other tree's kernel") + f": {ok17}")
    ok21, gap_o, gap_t, worst, n_nonfinite = True, 0.0, 0.0, "", 0
    finite = lambda R, t: torch.cat([torch.isfinite(R).flatten(), torch.isfinite(t).flatten()])
    for (args, kw), out in store["refine"]:
        again = _bits_equal(mvg.pnp_refine(*args, **kw), out)
        # the twin through the wrapper (a single problem) on the CPU, in f64
        f64 = [a.cpu().double() if a.is_floating_point() else a.cpu() for a in args]
        Rt, tt = mvg.pnp_refine(*f64, **kw)
        fin = finite(*out)
        same_fin = bool(torch.equal(fin.cpu(), finite(Rt, tt)))
        e_t = _pose_gap(out[0].cpu().double(), out[1].cpu().double(), Rt, tt)
        e_o = 0.0
        if AGAINST is not None:
            Ro, to_ = AGAINST.pnp_refine(*args, **kw)
            e_o = _pose_gap(*out, Ro, to_)
            same_fin = same_fin and bool(torch.equal(fin, finite(Ro, to_)))
        if e_t > gap_t:
            worst = f" (the twin's largest gap at {int(args[4].sum())} unmasked points)"
        gap_o, gap_t = max(gap_o, e_o), max(gap_t, e_t)
        n_nonfinite += int(not bool(fin.all()))
        ok21 &= again and same_fin and e_t <= 1e-5 and e_o <= 1e-5
    log(f"K21 on {where}'s {len(store['refine'])} calls: equal to the bit to the run's output "
        f"again, non-finite where the f64 twin" + ("" if AGAINST is None else
                                                    " and the other tree's kernel")
        + f" are ({n_nonfinite} calls with a non-finite entry)"
        + ("" if AGAINST is None else f", R/t max |kernel - the other tree's kernel| "
           f"{gap_o:.3e} (tol 1e-5)")
        + f"; max |kernel - f64 twin on the same inputs| {gap_t:.3e}{worst} (tol 1e-5): "
        f"{ok21}")
    if not (ok17 and ok21):
        fail(f"K17's match or K21 on {where}'s verifications")
    m_calls = store["match"]
    r_calls = store["refine"]
    ex17 = rec["hamming_match_tiles"].setdefault("extra_device_of", {})
    ex21 = rec["pnp_refine"].setdefault("extra_device_of", {})
    ex17[f"{where}'s {len(m_calls)} calls, per call"] = (
        lambda: [brief.match_descriptors(*a, **k) for (a, k), _ in m_calls], len(m_calls),
        "hamming_match")
    ex21[f"{where}'s {len(r_calls)} calls, per call"] = (
        lambda: [mvg.pnp_refine(*a, **k) for (a, k), _ in r_calls], len(r_calls),
        "pnp_refine_kernel")
    if AGAINST is not None:
        ex17[f"the other tree's K17 match on {where}'s calls, per call (its kernel alone)"] = (
            lambda: [AGAINST.match_descriptors(*a, **k) for (a, k), _ in m_calls],
            len(m_calls), "hamming_match")
        ex21[f"the other tree's K21 on {where}'s calls, per call"] = (
            lambda: [AGAINST.pnp_refine(*a, **k) for (a, k), _ in r_calls], len(r_calls),
            "pnp_refine_kernel")


def loop_calls_check(rec, store, where):
    """Every recorded K19 call with H: again equal to the bit to the run's
    output, and ``k19_check``; every recorded K18 call: again equal to the
    bit, and ``k18_check`` with the chosen-hypothesis bar.  Adds both kernels'
    device times per call over these calls to their records, the other
    tree's beside them."""
    from vplines_slam_tpu_torch.models import pose_graph as pg_mod
    from vplines_slam_tpu_torch.ops import mvg

    if not store["pgo"] or not store["pnp"]:
        fail(f"{where}: no PGO iteration or no verification recorded")
    ok19, err19, texts = True, 0.0, []
    for (x, db, ypr, cfg), out in store["pgo"]:
        again = _equal(pg_mod.pgo_normal(x, db, ypr, cfg), out)
        ok, e, text = k19_check(f"  an iteration: equal to the run's output {again}; check", x,
                                db, cfg, ypr)
        ok19, err19 = ok19 and ok and again, max(err19, e)
        texts.append(text)
    log(f"K19 on {where}'s {len(store['pgo'])} PGO iterations with H: {ok19}\n"
        + "\n".join(texts))
    ok18, err18, n_full, n_det, notes = True, 0.0, 0, 0, []
    for k, ((args, _), out) in enumerate(store["pnp"]):
        again = _equal(mvg.pnp_hypotheses(*args), out)
        ok, e, text = k18_check(f"call {k}", *args, True)
        distinct, full = pnp_determined(*args[:4])
        n_full, n_det = n_full + int(distinct.sum()), n_det + int(full.sum())
        ok18, err18 = ok18 and ok and again, max(err18, e)
        if not (ok and again) or "left out" in text or "differ" in text:
            notes.append(f"{text}; equal to the run's output {again}")
    log(f"K18 on {where}'s {len(store['pnp'])} calls ({n_full} full-rank hypotheses, {n_det} "
        f"determined): equal to the bit to the run's output and again, counts and inliers "
        f"equal to the twin's" + ("" if AGAINST is None else " and the other tree's")
        + " on the determined rows, the same chosen hypothesis" + (
            "" if AGAINST is None else " as the other tree's")
        + f" where both chose a determined row, R/t max |kernel - f64 twin| {err18:.2e} (tol "
        f"1e-6): {ok18}" + "".join(f"\n    {b}" for b in notes))
    if not (ok19 and ok18):
        fail(f"K18 or K19 on {where}'s calls")
    pgo_calls = [a for a, _ in store["pgo"]]
    pnp_calls = [a for (a, _), _ in store["pnp"]]
    ex19 = rec["pgo4"].setdefault("extra_device_of", {})
    ex18 = rec["pnp_hypotheses"].setdefault("extra_device_of", {})
    ex19[f"{where}'s {len(pgo_calls)} calls with H, per call"] = (
        lambda: [pg_mod.pgo_normal(*a) for a in pgo_calls], len(pgo_calls), "pgo4_")
    ex18[f"{where}'s {len(pnp_calls)} calls, per call"] = (
        lambda: [mvg.pnp_hypotheses(*a) for a in pnp_calls], len(pnp_calls), "pnp_kernel")
    if AGAINST is not None:
        ex19[f"the other tree's K19 on {where}'s calls with H, per call"] = (
            lambda: [AGAINST.pgo_normal(*a) for a in pgo_calls], len(pgo_calls), "pgo4_")
        ex18[f"the other tree's K18 on {where}'s calls, per call"] = (
            lambda: [AGAINST.pnp_hypotheses(*a) for a in pnp_calls], len(pnp_calls),
            "pnp_kernel")


def phase_loop_kernels(rec, S):
    """K15-K19 at the profile's sizes: FAST + NMS on a 752x480 frame, BRIEF
    at its 500 corners and at 64 window points, the 64 x 500 Hamming match
    in both gate settings and the SimHash signature, 256 PnP hypotheses on
    64 points (~40% outliers), the 4-DoF pose graph at K = 256."""
    import torch

    from vplines_slam_tpu_torch.kernels import TWIN_CALLS
    from vplines_slam_tpu_torch.models import camera as cam_mod
    from vplines_slam_tpu_torch.models import pose_graph as pg_mod
    from torch.func import jacfwd

    from vplines_slam_tpu_torch.ops import brief, mvg
    from vplines_slam_tpu_torch.solver import lm

    img0 = S["imgs"][0].contiguous()
    dev = img0.device
    n_px = H * W
    F_, Wp = 500, 64

    # K15: the score map (one launch) and detect_fast (two launches: tiles,
    # selection) against the plain twins on phase 3's frame and on the
    # images of utils/synthetic.fast_cases at max_corners 1, 60 and 500:
    # exact, each call again equal to the bit, with --against the other
    # tree's K15 (the previous design: its two launches, the sort and the
    # glue) equal to the bit
    from vplines_slam_tpu_torch.utils import synthetic as syn

    def k15(img, k):
        n0 = (brief.FAST_TILES.launches, brief.FAST_SELECT.launches)
        out = brief.detect_fast(img, k)
        two = (brief.FAST_TILES.launches - n0[0], brief.FAST_SELECT.launches - n0[1]) == (1, 1)
        n1 = brief.FAST_TILES.launches
        sk = brief.fast_score(img)
        one = brief.FAST_TILES.launches - n1 == 1
        plain = (_equal(out, brief.detect_fast_plain(img, k))
                 and bool(torch.equal(sk, brief.fast_score_plain(img))))
        again = (_equal(brief.detect_fast(img, k), out)
                 and _bits_equal((brief.fast_score(img),), (sk,)))
        other = AGAINST is None or (_equal(AGAINST.detect_fast(img, k), out)
                                    and _bits_equal((AGAINST.fast_score(img),), (sk,)))
        err = float((out[0] - brief.detect_fast_plain(img, k)[0]).abs().max())
        return two and one and plain and again and other, err, int(out[1].sum())

    ok15, err15, n_v = k15(img0, F_)
    cnt0 = fast_candidates(img0)
    log(f"K15 fast on phase 3's frame: {cnt0} candidates (kept, score > 0), {n_v} of {F_} "
        f"valid; two launches, the score mode one, equal to the plain twins, again to the bit"
        + ("" if AGAINST is None else ", the other tree's K15 equal to the bit")
        + f": {ok15} (tol: exact)")
    n_cases = 0
    for name, img in syn.fast_cases(seed=SEED).items():
        img_c = torch.from_numpy(img).to(dev)
        res = [k15(img_c, k) for k in (1, 60, 500)]
        ok_c = all(r[0] for r in res)
        ok15 &= ok_c
        err15 = max([err15] + [r[1] for r in res])
        n_cases += 1
        log(f"  case {name!r} {tuple(img.shape)}: {fast_candidates(img_c)} candidates, valid at "
            f"k = 1, 60, 500: {[r[2] for r in res]}; as above: {ok_c}")
    if not ok15:
        fail("K15 fast disagrees with its plain twins, across calls or with the other tree's K15")
    xy_k, v_k = brief.detect_fast(img0, F_)
    detect_k = lambda: brief.detect_fast(img0, F_)
    detect_p = lambda: brief.detect_fast_plain(img0, F_)
    # the work counted: the ring's 16 tests and margins (8
    # operations each), the arc test (40) and the 7x7 window (49) a pixel;
    # bytes: the image read once, each candidate's key written and read once,
    # the outputs written once
    ops15 = n_px * (16 * 8 + 40 + 49)
    record(rec, "fast_tiles", err15, detect_k, detect_p, "fast_tiles_kernel",
           4 * n_px + 8 * cnt0, ops15)
    kept0 = brief._nms_plain(brief.fast_score_plain(img0), 3).reshape(-1)
    record(rec, "fast_select", err15, detect_k, detect_p, "fast_select_kernel",
           8 * cnt0 + 9 * F_, cnt0, library_fn=lambda: torch.topk(kept0, F_),
           library_label="the top-k alone: torch.topk of the kept map, k = 500; its tie order "
                         "is not lax.top_k's, a time only")
    b_ms, b_by = bound(4 * n_px + 16 * cnt0 + 9 * F_, ops15)
    rec["fast_tiles"]["whole_bound_ms"] = b_ms
    log(f"K15's whole detect_fast: bound {b_ms:.5f} ms ({b_by}) on phase 3's frame")
    extra = rec["fast_tiles"]["extra_device_of"] = {
        "this tree's whole detect_fast, per call": (detect_k, 1),
        "its score mode (fast_score), per call": (lambda: brief.fast_score(img0), 1)}
    if AGAINST is not None:
        other_k = lambda: AGAINST.detect_fast(img0, F_)
        extra["the other tree's whole detect_fast (kernels, sort and glue), the same call"] = (
            other_k, 1)
        extra["the other tree's K15 launches, the same call"] = (other_k, 1, "fast_")
        rec["fast_tiles"]["other_ms"] = time_ms(other_k)
        log(f"K15 detect_fast per call (CUDA events): {rec['fast_tiles']['ms']:.4f} ms, the "
            f"other tree's {rec['fast_tiles']['other_ms']:.4f} ms")

    # K16 BRIEF at the 500 corners and at 64 window points (corners moved by
    # up to 2 px, so most fall between pixels) in one launch, as a keyframe's
    # extraction calls it; then the cases of utils/synthetic.brief_cases
    # (each as float32 on the card), each set alone and split in two
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    wxy = xy_k[:Wp] + 4.0 * torch.rand(Wp, 2, generator=gen, device=dev) - 2.0
    wv = torch.rand(Wp, generator=gen, device=dev) < 0.9
    pair_args = (img0, xy_k, v_k, wxy, wv)
    n0 = brief.BRIEF.launches
    d_k, w_k = brief.describe_brief_pair(*pair_args)
    one = brief.BRIEF.launches - n0 == 1
    d_p, w_p = brief.describe_brief_plain(img0, xy_k, v_k), brief.describe_brief_plain(img0, wxy, wv)
    n_diff = int((d_k != d_p).sum()) + int((w_k != w_p).sum())
    again = _equal(brief.describe_brief_pair(*pair_args), (d_k, w_k))
    cases_ok, n_cases = True, 0
    for name, (img_c, xy_c, v_c) in syn.brief_cases(seed=SEED).items():
        T = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        img_c, xy_c, v_c = T(img_c).float(), T(xy_c).float(), T(v_c)
        ref = brief.describe_brief_plain(img_c, xy_c, v_c)
        got = brief.describe_brief(img_c, xy_c, v_c)
        h = xy_c.shape[0] // 2
        halves = brief.describe_brief_pair(img_c, xy_c[:h], v_c[:h], xy_c[h:], v_c[h:])
        cases_ok &= (torch.equal(got, ref) and torch.equal(brief.describe_brief(img_c, xy_c, v_c),
                                                           got)
                     and torch.equal(torch.cat(halves), ref))
        if AGAINST is not None:
            cases_ok &= torch.equal(torch.cat(AGAINST.brief_pair(img_c, xy_c[:h], v_c[:h],
                                                                 xy_c[h:], v_c[h:])), ref)
        n_cases += 1
    same16 = n_diff == 0 and one and again and cases_ok
    other = ""
    if AGAINST is not None:
        same_o = _equal(AGAINST.brief_pair(*pair_args), (d_k, w_k))
        other = f"; the other tree's K16 equal to the bit on the keyframe and the cases {same_o}"
        same16 &= same_o
    log(f"K16 brief: 500 corners and 64 window points in one launch {one}, every bit equal to "
        f"the plain twin ({n_diff} words differ; tol: exact), again equal {again}; the "
        f"{n_cases} brief_cases, each set alone, twice and split in two, equal to the plain "
        f"twin: {cases_ok}{other}")
    if not same16:
        fail("K16 brief disagrees with its plain version, across calls or with the other "
             "tree's K16")
    # the frame read once and each descriptor's keypoint, flag and 32 bytes;
    # a full-frame blur's 28 operations a pixel and 14 a bilinear sample
    K16 = F_ + Wp
    record(rec, "brief_patch", float(n_diff), lambda: brief.describe_brief_pair(*pair_args),
           lambda: (brief.describe_brief_plain(img0, xy_k, v_k),
                    brief.describe_brief_plain(img0, wxy, wv)), "brief_",
           4 * n_px + K16 * (8 + 1 + 32), n_px * 28 + K16 * 256 * 2 * 14)
    if AGAINST is not None:
        rec["brief_patch"]["extra_device_of"] = {
            "the other tree's K16 on the same keyframe": (lambda: AGAINST.brief_pair(*pair_args),
                                                          1, "brief_")}
        rec["brief_patch"]["other_ms"] = time_ms(lambda: AGAINST.brief_pair(*pair_args))
        log(f"K16 per keyframe (CUDA events): {rec['brief_patch']['ms']:.4f} ms, the other "
            f"tree's {rec['brief_patch']['other_ms']:.4f} ms")
    lift = lambda xy: cam_mod.lift(S["cam"], xy)
    pg_cfg = euroc_pose_graph()
    extract = lambda: pg_mod.extract_keyframe_features(img0, lift, pg_cfg, window_xy=(wxy, wv))

    def extract_other():
        with AGAINST.keyframe_features():
            return extract()

    PROBES["extract"] = (extract, AGAINST and extract_other)

    # K17 (a) match 64 x 500, the verification's gates and the default ones,
    # then the cases of utils/synthetic.match_cases: indices and distances
    # exact against the twin (and the other tree's kernel), one launch a
    # match, two calls equal, the distance table exact
    ok17a, outs = True, {}
    for margin, mutual in ((16, True), (0, False)):
        n0 = brief.HAMMING_MATCH.launches
        ik, dk = brief.match_descriptors(w_k, wv, d_k, v_k, 80, margin, mutual)
        one = brief.HAMMING_MATCH.launches - n0 == 1
        ip, dp = brief.match_descriptors_plain(w_k, wv, d_k, v_k, 80, margin, mutual)
        same = _equal((ik, dk), (ip, dp)) and ik.dtype == torch.int64
        again = _equal(brief.match_descriptors(w_k, wv, d_k, v_k, 80, margin, mutual), (ik, dk))
        other = (AGAINST is None
                 or _equal(AGAINST.match_descriptors(w_k, wv, d_k, v_k, 80, margin, mutual),
                           (ik, dk)))
        outs[(margin, mutual)] = (same, one, again, other, int((ik >= 0).sum()))
        ok17a &= same and one and again and other
    log(f"K17 hamming_match 64 x 500: (margin, mutual) -> (equal to the twin, one launch, again "
        f"equal, equal to the other tree's, matches): {outs} (tol: exact)")
    case_out, mcases = [], syn.match_cases(seed=SEED)
    for name, arrs in mcases.items():
        da_c, va_c, db_c, vb_c = (torch.from_numpy(a).to(dev) for a in arrs)
        for margin, mutual in ((16, True), (0, False)):
            got = brief.match_descriptors(da_c, va_c, db_c, vb_c, 80, margin, mutual)
            ok = (_equal(got, brief.match_descriptors_plain(da_c, va_c, db_c, vb_c, 80, margin,
                                                            mutual))
                  and _equal(brief.match_descriptors(da_c, va_c, db_c, vb_c, 80, margin,
                                                     mutual), got))
            if AGAINST is not None:
                ok = ok and _equal(AGAINST.match_descriptors(da_c, va_c, db_c, vb_c, 80, margin,
                                                             mutual), got)
            ok17a &= ok
            if not ok:
                case_out.append(f"{name} ({margin}, {mutual})")
        table = brief.hamming_matrix(da_c, db_c)
        if not torch.equal(table, brief.hamming_matrix_plain(da_c, db_c)):
            ok17a = False
            case_out.append(f"{name}: the distance table")
    log(f"K17 hamming_match on the {len(mcases)} match_cases, both gate "
        f"settings, equal to the twin" + ("" if AGAINST is None else " and the other tree's")
        + f", twice, and the distance table: {ok17a and not case_out} (tol: exact)"
        + (f"; differ: {case_out}" if case_out else ""))
    if not ok17a:
        fail("K17 hamming_match disagrees with its plain version, across calls or with the "
             "other tree's")
    hd = brief.hamming_matrix(w_k, d_k)
    if not torch.equal(hd, brief.hamming_matrix_plain(w_k, d_k)):
        fail("K17's distance table disagrees with hamming_matrix_plain")
    # the yardstick: the distance table alone, 128 - (a . b) / 2 for the +-1
    # bits, as one f16 product (exact: entries <= 256, f32 accumulation)
    pm = lambda d: (2.0 * brief._unpack_bits(d) - 1.0).to(torch.float16)
    A16, B16 = pm(w_k), pm(d_k).T.contiguous()
    match_args = (w_k, wv, d_k, v_k, 80, 16, True)
    record(rec, "hamming_match_tiles", 0.0, lambda: brief.match_descriptors(*match_args),
           lambda: brief.match_descriptors_plain(*match_args),
           "hamming_match", (Wp + F_) * 33 + Wp * 12, 2 * Wp * F_ * 8 * 3,
           library_fn=lambda: A16 @ B16,
           library_label=f"the distance table alone: one f16 matmul of the +-1 bits, [{Wp}, "
                         f"256] @ [256, {F_}]")
    if not torch.equal((128.0 - (A16 @ B16).float() / 2).to(torch.int32), hd):
        fail("the f16 yardstick's distance table is not exact")
    if AGAINST is not None:
        rec["hamming_match_tiles"]["extra_device_of"] = {
            "the other tree's K17 match on the same input (with its wrapper's conversions)": (
                lambda: AGAINST.match_descriptors(*match_args), 1)}
        r17 = rec["hamming_match_tiles"]
        r17["other_ms"] = time_ms(lambda: AGAINST.match_descriptors(*match_args))
        log(f"K17 match per call (CUDA events): {r17['ms']:.4f} ms, the other tree's "
            f"{r17['other_ms']:.4f} ms")

    # K17 (b) the signature at N = 0, 1, 37, 500 (the 500 corners) and 1,000
    # (the corners and 500 random descriptors, one at distance exactly 128
    # from vocabulary word 0: code 0), with and without xy: codes exact,
    # signature 1e-6, two calls equal to the last bit
    g17 = torch.Generator(device=dev).manual_seed(SEED + 17)
    rnd = torch.randint(-2 ** 31, 2 ** 31, (F_, 8), generator=g17, device=dev, dtype=torch.int64)
    rnd[0] = brief._vocab_words(256, dev)[0].to(torch.int64) ^ torch.tensor(
        [0x0000FFFF] * 8, device=dev)  # 16 bits of each word differ: 128 in all
    d_all = torch.cat([d_k, rnd.to(torch.int32)])
    v_all = torch.cat([v_k, torch.rand(F_, generator=g17, device=dev) < 0.9])
    v_all[F_] = True
    xy_all = torch.cat([xy_k, torch.rand(F_, 2, generator=g17, device=dev)
                        * torch.tensor([W, H], device=dev)])
    err17, ok17, seen17 = 0.0, True, []
    for n in (0, 1, 37, F_, 2 * F_):
        for with_xy in (False, True):
            kw = dict(xy=xy_all[:n], img_hw=(H, W)) if with_xy else {}
            codes = torch.empty(n, 256, dtype=torch.int8, device=dev)
            sig_k = brief.global_signature(d_all[:n], v_all[:n], codes_out=codes, **kw)
            sig_k2 = brief.global_signature(d_all[:n], v_all[:n], **kw)
            sig_p = brief.global_signature_plain(d_all[:n], v_all[:n], **kw)
            codes_p = brief.simhash_codes_plain(d_all[:n], v_all[:n])
            same = bool(torch.equal(codes.to(torch.float32), codes_p))
            e = float((sig_k - sig_p).abs().max())
            rep = bool(torch.equal(sig_k, sig_k2))
            err17, ok17 = max(err17, e), ok17 and same and rep and e <= 1e-6
            seen17.append(f"N {n}{' xy' if with_xy else ''}: {same}/{e:.1e}/{rep}")
    zero_code = int(brief.simhash_codes_plain(d_all[F_:F_ + 1], v_all[F_:F_ + 1])[0, 0])
    log(f"K17 simhash_signature (codes equal / signature max |kernel - plain| / repeats): "
        f"{'; '.join(seen17)} (tol: codes exact, signature 1e-6, repeats to the bit); the "
        f"crafted descriptor's code on word 0: {zero_code} (distance 128)")
    if not (ok17 and zero_code == 0):
        fail("K17 simhash_signature disagrees with its plain version")
    bits = brief._unpack_bits(d_k) - 0.5
    Wv = torch.from_numpy(brief._random_vocab(256, 256)).to(device=dev, dtype=torch.float32)
    record(rec, "simhash_signature", err17,
           lambda: brief.global_signature(d_k, v_k, xy=xy_k, img_hw=(H, W)),
           lambda: brief.global_signature_plain(d_k, v_k, xy=xy_k, img_hw=(H, W)),
           "hamming_simhash", F_ * (32 + 1 + 8) + 256 * 32 + 4 * 1024, F_ * 256 * 8 * 3,
           library_fn=lambda: torch.sign(bits @ Wv))

    # K18: 256 six-point hypotheses over 64 points, ~40% outliers, against
    # the twin at f64 on the same (f32) inputs, then the cases of
    # utils/synthetic.pnp_cases
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
    ok18, e, text = k18_check("K18 on phase 3's input", X32, x32, mask, idx, thr, True)
    log(text)
    cases_ok, case_texts = True, []
    for name, (Xc_, xc_, mc_, ic_, thr_c) in syn.pnp_cases(seed=SEED).items():
        T = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        ok, e, text = k18_check(f"K18 on pnp_cases' {name!r}", T(Xc_).float(), T(xc_).float(),
                                T(mc_), T(ic_), thr_c, False)
        cases_ok, err18 = cases_ok and ok, max(err18, e)
        case_texts.append(text)
    log("\n".join(case_texts))
    if not (ok18 and cases_ok):
        fail("K18 pnp_hypotheses disagrees with its plain version, across calls or with the "
             "other tree's K18")
    n_s = 6
    sm = torch.zeros(n_hyp, N, dtype=torch.bool, device=dev).scatter(1, idx, True) & mask
    S_dlt = pnp_normal_matrices(X32.double(), x32.double(), sm)
    record(rec, "pnp_hypotheses", err18, lambda: mvg.pnp_hypotheses(X32, x32, mask, idx, thr),
           lambda: mvg.pnp_hypotheses_plain(X32, x32, mask, idx, thr), "pnp_kernel",
           N * (20 + 1) + n_hyp * n_s * 8 + n_hyp * (12 * 8 + 4 + N),
           # per hypothesis: A^T A over the sample, a 12x12 symmetric eigen-
           # decomposition with vectors (~9 n^3), a 3x3 SVD, N reprojections
           n_hyp * (n_s * 78 * 4 + 9 * 12 ** 3 + 400 + N * 30),
           library_fn=lambda: torch.linalg.eigh(S_dlt),
           library_label=f"torch.linalg.eigh on the [{n_hyp}, 12, 12] A^T A batch: the "
                         f"eigensolve alone")
    if AGAINST is not None:
        pnp_args = (X32, x32, mask, idx, thr)
        rec["pnp_hypotheses"]["extra_device_of"] = {
            "the other tree's K18 on the same inputs": (
                lambda: AGAINST.pnp_hypotheses(*pnp_args), 1, "pnp_kernel")}
        rec["pnp_hypotheses"]["other_ms"] = time_ms(lambda: AGAINST.pnp_hypotheses(*pnp_args))
        log(f"K18 per call (CUDA events): {rec['pnp_hypotheses']['ms']:.4f} ms, the other "
            f"tree's {rec['pnp_hypotheses']['other_ms']:.4f} ms")

    # K19 at K = 256: r, H and g against jacfwd + J^T J in f64, then the
    # cases of utils/synthetic.pgo_cases and K = 1,024
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
    ok19, e, text = k19_check("K19 on phase 3's database", xk, db, cfg)
    log(text)
    cases_ok, case_texts = True, []
    for name, case in syn.pgo_cases(seed=SEED).items():
        db_c = pgo_case_db(case, dev)
        K_c = db_c.p_vio.shape[0]
        x_c = (torch.cat([db_c.yaw_pgo[:, None], db_c.p_pgo], 1)
               + 0.05 * (torch.rand(K_c, 4, generator=gen, device=dev) - 0.5))
        ok, e, text = k19_check(f"K19 on pgo_cases' {name!r}", x_c, db_c, cfg)
        cases_ok, err19 = cases_ok and ok, max(err19, e)
        case_texts.append(text)
    log("\n".join(case_texts))
    db_big = pgo_database(dev, K=1024)
    x_big = (torch.cat([db_big.yaw_pgo[:, None], db_big.p_pgo], 1)
             + 0.05 * (torch.rand(1024, 4, generator=gen, device=dev) - 0.5))
    ok_big, e, text = k19_check("K19 at K = 1,024", x_big, db_big, cfg)
    log(text)
    err19 = max(err19, e)
    if not (ok19 and cases_ok and ok_big):
        fail("K19 pgo4 disagrees with its plain version, across calls or with the other "
             "tree's K19")
    spec = lm.SchurSpec(dense_dim=4 * K)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    solve = lambda: lm.schur_solve(Hk, gk, spec, lam)
    solve_ms = time_ms(solve)
    log(f"  the dense {4 * K} x {4 * K} f64 solve beside it (solver/lm.schur_solve, "
        f"torch.linalg Cholesky): {solve_ms:.4f} ms/call")
    n_e = K * (cfg.seq_edges + 2)
    db64, y64 = pg_mod._f64_db(db), ypr.double()
    J19 = jacfwd(lambda xf: pg_mod.pgo_residual(xf.reshape(K, 4), db64, y64, cfg))(
        xk.double().reshape(-1))
    record(rec, "pgo4", err19, lambda: pg_mod.pgo_normal(xk, db, ypr, cfg),
           lambda: pg_mod.pgo_normal_plain(xk, db, ypr, cfg), "pgo4_",
           K * 8 * 20 + K * 4 * 3 + 8 * (16 * K * K + 4 * K + 4 * n_e), n_e * (150 + 4 * 2 * 64),
           library_fn=lambda: J19.T @ J19,
           library_label=f"J^T J in f64 on the dense [{J19.shape[0]}, {J19.shape[1]}] Jacobian: "
                         f"H alone")
    # the solve's bound: H and g read, the delta written; a Cholesky (n^3 / 3)
    # and two triangular solves
    n4 = 4 * K
    s_ms, s_by = bound(8 * (n4 * n4 + 2 * n4), n4 ** 3 / 3 + 2 * n4 * n4)
    rec["pgo4"].update(solve_ms=solve_ms, solve_of=solve, solve_bound_ms=s_ms,
                       solve_bound_by=s_by)
    big = (x_big, db_big, pg_mod._ypr_vio(db_big), cfg)
    extra = rec["pgo4"].setdefault("extra_device_of", {})
    extra["residual-only mode (the LM's cost pass), K = 256"] = (
        lambda: pg_mod.pgo_normal(xk, db, ypr, cfg, with_h=False), 1, "pgo4_")
    extra["K = 1,024, with H"] = (lambda: pg_mod.pgo_normal(*big), 1, "pgo4_")
    b_big, _ = bound(1024 * 8 * 20 + 1024 * 4 * 3
                     + 8 * (16 * 1024 ** 2 + 4 * 1024 + 4 * 1024 * 6), 0)
    rec["pgo4"]["bound_1024_ms"] = b_big
    log(f"K19 at K = 1,024 per call (CUDA events): "
        f"{time_ms(lambda: pg_mod.pgo_normal(*big)):.4f} ms, bound {b_big:.5f} ms (bytes)")
    if AGAINST is not None:
        args19 = (xk, db, ypr, cfg)
        extra["the other tree's K19 on the same inputs, K = 256"] = (
            lambda: AGAINST.pgo_normal(*args19), 1, "pgo4_")
        extra["the other tree's K19 at K = 1,024"] = (lambda: AGAINST.pgo_normal(*big), 1,
                                                     "pgo4_")
        rec["pgo4"]["other_ms"] = time_ms(lambda: AGAINST.pgo_normal(*args19))
        log(f"K19 per call (CUDA events), K = 256: {rec['pgo4']['ms']:.4f} ms, the other "
            f"tree's {rec['pgo4']['other_ms']:.4f} ms; K = 1,024: the other tree's "
            f"{time_ms(lambda: AGAINST.pgo_normal(*big), n=5):.4f} ms")
    TWIN_CALLS.clear()
    return rec


# ---------------------------------------------------------------------------
# phase 3, the selector and PnP refinement: K20 and K21 against their twins
# ---------------------------------------------------------------------------

SEL_FRAME = 10  # the staged points-slice frame whose corners are the candidates


def selector_inputs(S, k=SEL_FRAME, seed=SEED + 20):
    """K20's inputs at frame k of the points slice (752x480): its 150 Shi-
    Tomasi corners lifted to unit bearings (depths 1.5-8 m and ~80% of them
    new, from a seeded generator), the f64 horizon propagated from the truth
    state at frame k by the mean of the frame's IMU interval, and the prior
    of the profile's selector block (max_features 30) over it."""
    import torch

    from vplines_slam_tpu_torch.models import camera as cam_mod
    from vplines_slam_tpu_torch.models import selector as sel
    from vplines_slam_tpu_torch.ops import corners

    f64 = torch.float64
    img = S["imgs"][k].contiguous()
    dev = img.device
    cfg = S["tcfg"]
    xy, _, ok = corners.detect(img, cfg.max_features, cfg.min_dist, cfg.quality)
    rays = cam_mod.lift(S["cam"], xy).to(f64)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = rays.shape[0]
    depths = 1.5 + 6.5 * torch.rand(n, generator=gen, device=dev, dtype=f64)
    new = ok & (torch.rand(n, generator=gen, device=dev) < 0.8)
    p, q, v = (x[k].to(f64) for x in S["truth"])
    _, accs, gyrs, mask, _ = S["batches"]
    m = torch.cat([mask[k], mask[k][-1:]]).to(f64)[:, None]
    acc, gyr = (torch.sum(a[k].to(f64) * m, 0) / torch.sum(m) for a in (accs, gyrs))
    z3 = torch.zeros(3, dtype=f64, device=dev)
    dt = 1.0 / FRAME_HZ
    ps, qs, _ = sel.propagate_horizon(p, q, v, z3, z3, acc, gyr, dt, S["params"].g.to(f64))
    prior = sel.imu_prior_information(qs, dt, sel.SelectorConfig().acc_var)
    return dict(rays=rays.contiguous(), depths=depths, new=new, ps=ps, qs=qs,
                q_ic=S["q_ic"].to(f64), p_ic=S["p_ic"].to(f64), prior=prior)


def lu_flops(n):
    """f64 operations of one n x n LU with partial pivoting and its log-det:
    the multipliers and the trailing updates (2 per entry), plus n logs."""
    return sum((n - k - 1) + 2 * (n - k - 1) ** 2 for k in range(n)) + n


def schur_flops(dim, ns):
    """f64 operations of the greedy pass's one elimination of the dim - ns
    columns off the support (Sigma): per pivot step the multipliers and the
    trailing update of the whole remaining block."""
    return sum((dim - k - 1) + 2 * (dim - k - 1) ** 2 for k in range(dim - ns))


def greedy_work(selected, new, rounds):
    """(rounds run, matrices factored) by K20's greedy pass on this data: a
    round that selects nothing ends the pass (the later rounds return at
    once); each round factors the base and every new candidate not yet
    selected."""
    k, n_new = int(selected.sum()), int(new.sum())
    run = min(k + 1, rounds) if rounds > 0 else 1
    return run, sum(1 + n_new - r for r in range(run))


def pnp_batch(dev, B, N, dtype, seed):
    """A K21 input: B poses over N points at 2-6 m (one shared set, as the
    initializer's window), 1e-3 observation noise, ~20% masked, starts
    ~6 degrees and 5 cm off."""
    import torch

    from vplines_slam_tpu_torch.utils import geometry as geo

    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=f64)
    X = torch.stack([4 * g(N) - 2, 3 * g(N) - 1.5, 2 + 4 * g(N)], 1)
    R = geo.so3_exp_matrix(0.4 * (g(B, 3) - 0.5))
    t = 0.6 * (g(B, 3) - 0.5)
    Xc = X @ R.transpose(-1, -2) + t[:, None]
    x = Xc[..., :2] / Xc[..., 2:3] + 2e-3 * (g(B, N, 2) - 0.5)
    R0 = geo.so3_exp_matrix(0.2 * (g(B, 3) - 0.5)) @ R
    t0 = t + 0.1 * (g(B, 3) - 0.5)
    mask = g(B, N) < 0.8
    return [a.to(dtype).contiguous() for a in (R0, t0, X, x)] + [mask]


def pnp_refine_flops(B, N, iters=5):
    """f64 operations of K21: per problem and step, the rotation's jets
    (~800), per point the jet transform, projection and the 27 sums (~310),
    the 6x6 solve (~150)."""
    return B * iters * (800 + 310 * N + 150)


def phase_selector_kernels(rec, S):
    """K20 at a frame's size (150 candidates of a staged 752x480 frame, the
    horizon from the truth) and K21 at the initializer's (11 x 128) and a
    verification's (1 x 64) batches, against their plain twins."""
    import torch

    from vplines_slam_tpu_torch.kernels import TWIN_CALLS
    from vplines_slam_tpu_torch.models import selector as sel
    from vplines_slam_tpu_torch.ops import mvg
    from vplines_slam_tpu_torch.utils import synthetic as syn

    f64 = torch.float64
    I = selector_inputs(S)
    dev = I["rays"].device
    N, dim = I["rays"].shape[0], sel.DIM
    info_args = (I["rays"], I["depths"], I["new"], I["ps"], I["qs"], I["q_ic"], I["p_ic"])
    n0 = sel.SELECTOR_INFO.launches
    Fk = sel.feature_information(*info_args)
    one = sel.SELECTOR_INFO.launches - n0 == 1
    Fp = sel.feature_information_plain(*info_args)
    err20 = info_rel_err(Fk, Fp)
    live = int((Fp.abs().amax(dim=(1, 2)) > 0).sum())
    again = _bits_equal((sel.feature_information(*info_args),), (Fk,))
    other = AGAINST is None or _bits_equal((AGAINST.selector_info(*info_args),), (Fk,))
    log(f"K20 selector_info: {N} candidates of frame {SEL_FRAME} ({int(I['new'].sum())} new, "
        f"{live} with information), max |kernel - plain| / the candidate's largest entry = "
        f"{err20:.3e} (tol 1e-12, f64); one launch {one}, again equal to the bit {again}"
        + ("" if AGAINST is None else f", the other tree's kernel equal to the bit {other}"))
    if not (err20 <= 1e-12 and one and again and other):
        fail("K20 selector_info disagrees with its plain version, across calls or with the "
             "other tree's kernel")
    # the cases of utils/synthetic.selector_info_cases: the same bars
    T = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    case_args, ok_c = {}, True
    for name, c in syn.selector_info_cases(seed=SEED).items():
        a = tuple(T(c[k]) for k in ("rays", "depths", "track_valid", "ps", "qs", "q_ic",
                                    "p_ic"))
        kw = dict(obs_frame=c["obs_frame"])
        case_args[name] = (a, kw)
        n0 = sel.SELECTOR_INFO.launches
        Fc = sel.feature_information(*a, **kw)
        one_c = sel.SELECTOR_INFO.launches - n0 == 1
        e_c = info_rel_err(Fc, sel.feature_information_plain(*a, **kw))
        again_c = _bits_equal((sel.feature_information(*a, **kw),), (Fc,))
        other_c = AGAINST is None or _bits_equal((AGAINST.selector_info(*a, **kw),), (Fc,))
        ok = one_c and e_c <= 1e-12 and again_c and other_c
        ok_c &= ok
        err20 = max(err20, e_c)
        log(f"  case {name!r}: {tuple(Fc.shape)}, max rel err {e_c:.3e}, one launch, again and "
            f"the other tree's equal to the bit: {ok}")
    n0 = sel.SELECTOR_INFO.launches
    empty = sel.feature_information(*(x[:0] for x in info_args[:3]), *info_args[3:])
    ok_c &= empty.shape == (0, dim, dim) and sel.SELECTOR_INFO.launches == n0
    if not ok_c:
        fail("K20 selector_info on the cases of utils/synthetic.selector_info_cases")
    record(rec, "selector_info", err20, lambda: sel.feature_information(*info_args),
           lambda: sel.feature_information_plain(*info_args), "selector_info_kernel",
           N * (3 + 1) * 8 + N + 5 * 7 * 8 + 7 * 8 + N * dim * dim * 8,
           N * (5 * 420 + 60 + 5 * 45 + 25 * 9 * 6),
           library_fn=lambda: torch.zeros(N, dim, dim, dtype=f64, device=dev),
           library_label="the write alone: torch.zeros of the [N, 45, 45] f64 output")
    a1k, kw1k = case_args["N 1000 nh 5 obs 1"]
    n1k = a1k[0].shape[0]
    rec["selector_info"]["bound_1000_ms"] = bound(
        n1k * (3 + 1) * 8 + n1k + 5 * 7 * 8 + 7 * 8 + n1k * dim * dim * 8,
        n1k * (5 * 420 + 60 + 5 * 45 + 25 * 9 * 6))[0]
    extra = rec["selector_info"]["extra_device_of"] = {
        "N = 1,000 (selector_info_cases), per call": (
            lambda: sel.feature_information(*a1k, **kw1k), 1, "selector_info")}
    if AGAINST is not None:
        extra["the other tree's kernel, the same call"] = (
            lambda: AGAINST.selector_info(*info_args), 1, "selector_info")
        extra["the other tree's kernel at N = 1,000, per call"] = (
            lambda: AGAINST.selector_info(*a1k, **kw1k), 1, "selector_info")
        rec["selector_info"]["other_ms"] = time_ms(lambda: AGAINST.selector_info(*info_args))

    # greedy: budgets 0, 7, 30 at max_features 30 and 60 on the same matrices,
    # on the position support of the states a candidate is seen from (the
    # main path's Schur form, 12 indices), of all 5 states (15) and on all
    # 45 indices (the dense case), each kernel call twice
    errs, picks = {}, {}
    for obs in (1, 0, None):  # supports 12, 15 and 45
        for rounds in (30, 60):
            cfg = sel.SelectorConfig(max_features=rounds)
            for b in (0, 7, 30):
                budget = torch.tensor(b, device=dev)
                sk, gk = sel.select_features(I["prior"], Fk, I["new"], budget, cfg, obs_frame=obs)
                sk2, gk2 = sel.select_features(I["prior"], Fk, I["new"], budget, cfg,
                                               obs_frame=obs)
                sp, gp = sel.select_features_plain(I["prior"], Fk, I["new"], budget, cfg,
                                                   obs_frame=obs)
                key = (len(sel.greedy_support(dim, obs)), rounds, b)
                if not torch.equal(sk, sp):
                    fail(f"K20 selector_greedy (support {key[0]}, max_features {rounds}, budget "
                         f"{b}) selected {torch.nonzero(sk).flatten().tolist()}, its plain "
                         f"version {torch.nonzero(sp).flatten().tolist()}")
                if not (torch.equal(sk, sk2) and torch.equal(gk, gk2)):
                    fail(f"K20 selector_greedy does not repeat to the last bit {key}")
                errs[key] = float((gk - gp).abs().max())
                picks[key] = int(sk.sum())
    err_g = max(errs.values())
    log(f"K20 selector_greedy: (support, max_features, budget) -> picks {picks}, selected sets "
        f"identical, two calls equal to the last bit; first-round gains max |kernel - plain| = "
        f"{err_g:.3e} (tol 1e-9 absolute)")
    if not err_g <= 1e-9:
        fail("K20 selector_greedy's gains disagree with its plain version")
    cfg30 = sel.SelectorConfig(max_features=30)
    b30 = torch.tensor(30, device=dev)
    sk, _ = sel.select_features(I["prior"], Fk, I["new"], b30, cfg30, obs_frame=1)
    rounds_run, n_lu = greedy_work(sk, I["new"], 30)
    sup12 = sel.greedy_support(dim, 1)
    ns = len(sup12)
    idx = torch.tensor(sup12, device=dev)
    sigma = sel.schur_base_plain(I["prior"], sup12)
    batch12 = torch.cat([sigma[None], sigma + Fk[:, idx[:, None], idx[None, :]]])
    batch45 = torch.cat([I["prior"][None], I["prior"] + Fk]) + 1e-9 * torch.eye(
        dim, dtype=f64, device=dev)

    def library_k20():  # the pass's log-determinants alone: 30 rounds of slogdet
        for _ in range(30):
            torch.linalg.slogdet(batch12)

    record(rec, "selector_greedy", err_g,
           lambda: sel.select_features(I["prior"], Fk, I["new"], b30, cfg30, obs_frame=1),
           lambda: sel.select_features_plain(I["prior"], Fk, I["new"], b30, cfg30,
                                             obs_frame=1),
           "greedy_", (N * ns * ns + dim * dim) * 8 + N + 8 + N * 9,
           schur_flops(dim, ns) + n_lu * lu_flops(ns) + rounds_run * (N * 4 + ns * ns),
           library_fn=library_k20,
           library_label=f"30 rounds of torch.linalg.slogdet on the [{N + 1}, {ns}, {ns}] "
                         f"Schur-form batch")
    rec["selector_greedy"]["bound_45_ms"] = bound(
        (N + 1) * dim * dim * 8 + N + 8 + N * 9,
        n_lu * lu_flops(dim) + rounds_run * (N * 4 + dim * dim))[0]
    rec["selector_greedy"]["extra_device_of"] = {
        "one round of slogdet on the [151, 45, 45] batch (the previous design's yardstick)":
            lambda: torch.linalg.slogdet(batch45),
        "support 15 (every state's position block)":
            lambda: sel.select_features(I["prior"], Fk, I["new"], b30, cfg30, obs_frame=0),
        "the dense case (support 45)":
            lambda: sel.select_features(I["prior"], Fk, I["new"], b30, cfg30)}
    log(f"  max_features 30, budget 30: {rounds_run} rounds run, {n_lu} {ns}x{ns} LU "
        f"factorizations after one elimination of the {dim - ns} columns off the support (the "
        f"bound's work; on the 45x45 LUs of the previous design the bound is "
        f"{rec['selector_greedy']['bound_45_ms']:.5f} ms)")

    # K21 at the initializer's and a verification's batches, f64 and f32, then
    # the cases of utils/synthetic.pnp_refine_cases
    def k21_errs(a64):
        """(f64 error, f32 error, bit-repeating, the other tree's f64 gap or
        None, finite pattern equal) of one input against the twins."""
        a32 = [x.float() if x.is_floating_point() else x for x in a64]
        Rk, tk = mvg.pnp_refine(*a64)
        Rp, tp = mvg.pnp_refine_plain(*a64)
        fin = bool(torch.equal(torch.isfinite(Rk), torch.isfinite(Rp))
                   and torch.equal(torch.isfinite(tk), torch.isfinite(tp)))
        e64 = _pose_gap(Rk, tk, Rp, tp)
        again = _bits_equal(mvg.pnp_refine(*a64), (Rk, tk))
        Rk32, tk32 = mvg.pnp_refine(*a32)
        again &= _bits_equal(mvg.pnp_refine(*a32), (Rk32, tk32))
        Rp32, tp32 = mvg.pnp_refine_plain(*a32)
        e32 = _pose_gap(Rk32, tk32, Rp32, tp32)
        # the kernel rounds only its inputs and outputs to f32: against the
        # f64 twin on the same f32 inputs
        Rq, tq = mvg.pnp_refine_plain(*[x.double() if x.is_floating_point() else x
                                        for x in a32])
        e32q = _pose_gap(Rk32.double(), tk32.double(), Rq, tq)
        other = None
        if AGAINST is not None:
            Ro, to_ = AGAINST.pnp_refine(*a64)
            other = _pose_gap(Rk, tk, Ro, to_)
        return e64, e32, e32q, again, other, fin

    out = {}
    for B, Np in ((11, 128), (1, 64)):
        a64 = pnp_batch(dev, B, Np, f64, SEED + 21 + B)
        a32 = [x.float() if x.is_floating_point() else x for x in a64]
        e64, e32, _, again, other, fin = k21_errs(a64)
        n0 = mvg.PNP_REFINE.launches
        Rp, _ = mvg.pnp_refine_plain(*a64)
        mvg.pnp_refine(*a32)
        one = mvg.PNP_REFINE.launches - n0 == 1
        moved = float((Rp.double() - a64[0]).abs().max())
        out[(B, Np)] = (e64, e32, a64, a32)
        # f32: the twin rounds every step of its jacfwd Gauss-Newton to f32
        # (~1e-7 of the pose), the kernel only its inputs and outputs
        log(f"K21 pnp_refine {B} x {Np}: R/t max |kernel - f64 twin| = {e64:.3e} (tol 1e-9); "
            f"at f32 against the f32 twin {e32:.3e} (tol 1e-5); one launch {one}, two calls "
            f"equal to the bit {again}; the refinement moved R by {moved:.3e}"
            + ("" if other is None else f"; max |kernel - the other tree's kernel| at f64 "
               f"{other:.3e}"))
        if not (e64 <= 1e-9 and e32 <= 1e-5 and again and one and fin):
            fail(f"K21 pnp_refine ({B} x {Np}) disagrees with its plain version or does not "
                 f"repeat")
        if B == 11:
            log(f"  the initializer's batch: kernel {time_ms(lambda: mvg.pnp_refine(*a32)):.4f} "
                f"ms/call, plain {time_ms(lambda: mvg.pnp_refine_plain(*a32), n=5):.4f} ms, "
                f"bound {bound(0, pnp_refine_flops(B, Np))[0]:.5f} ms (operations)"
                + ("" if AGAINST is None else
                   f", the other tree's kernel {time_ms(lambda: AGAINST.pnp_refine(*a32)):.4f} "
                   f"ms/call"))
    # the cases: f64 within 1e-9 of the f64 twin, f32 within 1e-5 of the f32
    # twin, except at one point ("N 1"): J^T J has rank 2 there, and the f32
    # twin's null-space steps are its f32 rounding over the 1e-8 damping, so
    # the f32 kernel (f64 inside) is held within 1e-6 of the f64 twin on the
    # same f32 inputs; non-finite where the twin is (all masked)
    rows, ok21c, worst = [], True, 0.0
    for name, arrs in syn.pnp_refine_cases(seed=SEED).items():
        a64 = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
        e64, e32, e32q, again, other, fin = k21_errs(a64)
        ok = e64 <= 1e-9 and again and fin and (e32q <= 1e-6 if name == "N 1" else e32 <= 1e-5)
        ok21c &= ok
        worst = max(worst, e64)
        rows.append(f"{name}: {e64:.1e}/{e32:.1e}/{e32q:.1e}/{again}"
                    + ("" if other is None else f"/{other:.1e}") + ("" if ok else " FAILED"))
    log(f"K21 on the pnp_refine_cases (f64 |kernel - twin| / f32 |kernel - f32 twin| / f32 "
        f"|kernel - f64 twin on the f32 inputs| / two calls equal"
        + ("" if AGAINST is None else " / f64 |kernel - the other tree's|") + "): "
        + "; ".join(rows) + f" (tol 1e-9 / 1e-5, at N 1 the third 1e-6): {ok21c}")
    if not ok21c:
        fail("K21 pnp_refine disagrees with its plain version on a case")
    e64, e32, _, a32 = out[(1, 64)]
    R1 = torch.linalg.matrix_exp(0.1 * torch.randn(1, 6, 6, generator=torch.Generator(
        device=dev).manual_seed(SEED + 21), device=dev, dtype=f64))
    H1, g1 = R1 @ R1.transpose(-1, -2), torch.ones(1, 6, device=dev, dtype=f64)
    record(rec, "pnp_refine", max(e64, e32), lambda: mvg.pnp_refine(*a32),
           lambda: mvg.pnp_refine_plain(*a32), "pnp_refine_kernel",
           4 * (12 + 64 * 3 + 64 * 2 + 12) + 64, pnp_refine_flops(1, 64),
           library_fn=lambda: torch.linalg.solve_ex(H1, g1),
           library_label="one Gauss-Newton step's solve alone: torch.linalg.solve_ex on the "
                         "[1, 6, 6] f64 system")
    a11 = out[(11, 128)][3]
    ex21 = rec["pnp_refine"].setdefault("extra_device_of", {})
    ex21["the initializer's batch, 11 x 128"] = (lambda: mvg.pnp_refine(*a11), 1,
                                                  "pnp_refine_kernel")
    ex21["solve_ex on the initializer's [11, 6, 6] systems"] = (
        lambda: torch.linalg.solve_ex(H1.expand(11, 6, 6).contiguous(), g1.expand(11, 6)), 1)
    if AGAINST is not None:
        ex21["the other tree's K21 on the same input"] = (lambda: AGAINST.pnp_refine(*a32), 1,
                                                          "pnp_refine_kernel")
        ex21["the other tree's K21 on the initializer's batch"] = (
            lambda: AGAINST.pnp_refine(*a11), 1, "pnp_refine_kernel")
        rec["pnp_refine"]["other_ms"] = time_ms(lambda: AGAINST.pnp_refine(*a32))
        log(f"K21 per call at 1 x 64 (CUDA events): {rec['pnp_refine']['ms']:.4f} ms, the other "
            f"tree's {rec['pnp_refine']['other_ms']:.4f} ms")
    TWIN_CALLS.clear()
    return rec


# ---------------------------------------------------------------------------
# phase 7: the loop-closure circuit at the profile's size
# ---------------------------------------------------------------------------

N_LOOP_LAP = 64  # keyframes a lap of the circuit
R_BC_INWARD = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))  # camera z = body x
P_IC_RAYS = (0.05, 0.02, 0.03)  # tests/test_online_calib_wiring.py's camera offset


def phase_loop_circuit(dev, n_lap=N_LOOP_LAP, cam=None, cfg=None):
    """The loop-closure chain over 2 laps of loop_trajectory (radius 3 m,
    64 keyframes a lap) at 752x480 with the EuRoC camera, with the
    profile's PoseGraphConfig, the keyframes carrying a synthetic VIO drift
    (yaw walk 0.15 deg, translation walk 0.01 m, numpy seed 0): extract ->
    add -> retrieve -> candidate gate -> oldest-first verification ->
    record, then optimize_4dof and drift_correction.  Bars: >= 1 verified
    loop, each a true revisit (< 1.0 m), the PGO at least halves the last
    keyframe's position error.  Then the last loop's verification 3 times
    more with host-sync debugging on; it is returned as ``probe``, whose
    launches main counts under torch.profiler at the end.  A CPU rehearsal
    passes a small camera, fewer
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
        f"{ {n: round(c / n_kf, 3) for n, c in launches.items()} }; K21 (pnp_refine) per "
        f"verification: {launches.get('vp_pnp_refine', 0) / max(n_verify, 1):.2f}")
    log(f"  last keyframe's position error: before PGO {err_before[-1]:.4f} m, after "
        f"{err_after[-1]:.4f} m (bar: at most half); mean over keyframes {err_before.mean():.4f} "
        f"-> {err_after.mean():.4f} m; LM cost {float(out.cost0):.4f} -> {float(out.cost):.4f}")
    if on_card:
        loop_twin_check("loop-closure circuit")
    probe = None
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
        probe = verify_again  # its launches are counted under torch.profiler at the end
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
                          err_before=float(err_before[-1]), err_after=float(err_after[-1]),
                          probe=probe)


def count_launches(fn, n, label, table=False):
    """Kernel launches (cudaLaunchKernel calls) and device kernels per call
    of fn, over n calls under torch.profiler; with table, the top ops by host
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    n_launch = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel") / n
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3 / n
    log(f"  {label}: {n_launch:.0f} cudaLaunchKernel calls and {len(dev) / n:.0f} device "
        f"kernels per call, {busy:.3f} ms of kernel time per call (torch.profiler, {n} calls)")
    if table:
        for line in prof.key_averages().table(sort_by="cpu_time_total",
                                              row_limit=14).splitlines():
            log("    " + line)
    return n_launch


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


@contextlib.contextmanager
def plain_klt():
    """Run ``klt.track`` through ``track_plain`` (on the card: K1 builds
    the pyramids, the levels run as plain tensor code)."""
    from vplines_slam_tpu_torch.ops import klt

    saved = klt.track
    klt.track = klt.track_plain
    try:
        yield
    finally:
        klt.track = saved


def phase_slice(S, plain=False, imu_twin=False, klt_twin=False):
    """Phase 4; plain=True runs it on the plain twins of K11-K14 (the
    --estimator-witness run), imu_twin=True on K10's (--imu-witness),
    klt_twin=True on K2's (--klt-witness)."""
    with contextlib.ExitStack() as twins:
        if plain:
            twins.enter_context(plain_estimator())
        if imu_twin:
            twins.enter_context(plain_twins_of_k9_k10())
        if klt_twin:
            twins.enter_context(plain_klt())
        return _slice(S, plain, imu_twin, klt_twin)


def _slice(S, plain, imu_twin, klt_twin):
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

    from vplines_slam_tpu_torch.ops.klt import KLT_TRACK

    # the point front-end's (K1-K4), K10 and the estimator's (K11-K14)
    kernels = ([k for k in all_kernels()[:5] if not (klt_twin and k is KLT_TRACK)]
               + ([] if imu_twin else [PREINTEGRATE])
               + ([] if plain else estimator_kernels()))
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


def phase_lines(S, plain=False, imu_twin=False, klt_twin=False):
    """Phase 5: the lines-on device loop on the same world; plain=True runs
    it on the plain twins of K11-K14, imu_twin=True on K10's, klt_twin=True
    on K2's."""
    with contextlib.ExitStack() as twins:
        if plain:
            twins.enter_context(plain_estimator())
        if imu_twin:
            twins.enter_context(plain_twins_of_k9_k10())
        if klt_twin:
            twins.enter_context(plain_klt())
        return _lines(S, plain, imu_twin, klt_twin)


def _lines(S, plain, imu_twin, klt_twin):
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
    warm_next = int(ln.next_id)  # line ids from here on are first seen after the warm-up

    loop = make_device_loop(S["cam"], tcfg, cfg, S["params"], line_cfg=lcfg, map_xy=S["map_xy"])
    carry = loop.init_carry(fe, state, data, ln)
    n = N_STEADY_LINES
    s0, s1 = nf - 1, nf - 1 + n
    sl = slice(s0, s1)
    dts = lambda k: torch.full((k,), 1.0 / FRAME_HZ, device=S["imgs"].device)
    args = (S["imgs"][sl], tuple(b[s0 - 1: s1 - 1] for b in S["batches"]), dts(n),
            S["ridx"][sl], S["vp_u"][sl])

    from vplines_slam_tpu_torch.ops.image import CLAHE

    from vplines_slam_tpu_torch.utils.stats import SPANS

    from vplines_slam_tpu_torch.solver.lm import TWIN_CALLS

    from vplines_slam_tpu_torch.models.imu import PREINTEGRATE

    from vplines_slam_tpu_torch.ops.klt import KLT_TRACK

    idle = ((CLAHE,) + tuple(loop_kernels()) + tuple(selector_kernels())
            + tuple(calib_kernels())
            + (tuple(estimator_kernels()) if plain else ()) + ((PREINTEGRATE,) if imu_twin else ())
            + ((KLT_TRACK,) if klt_twin else ()))
    # CLAHE off, no loop closure, no selector
    kernels = [k for k in all_kernels() if k not in idle]
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
    # the tracks first seen after the warm-up: with line_min_obs observations, and solved
    fresh = data.ln_id >= warm_next
    fresh_obs = int((fresh & (data.ln_mask.sum(1) >= cfg.line_min_obs)).sum())
    fresh_solved = int((fresh & data.ln_solved).sum())

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
        f"solved lines; of the tracks first seen after the warm-up, {fresh_obs} with "
        f"line_min_obs = {cfg.line_min_obs} observations and {fresh_solved} solved")

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
    if fresh_solved == 0:
        fail("no line track first seen after the warm-up is solved at the end of the lines run")
    return launches, dict(ms_frame=ms_frame, fe_ms=float(np.median(fe_ms[st])),
                          ln_ms=float(np.median(ln_ms[st])), be_ms=float(np.median(be_ms[st])),
                          ate=ate, syncs=len(syncs) / N_SYNC, solved=solved, vp_live=vp_live,
                          fresh_solved=fresh_solved), (
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


def stage_cold(dev, n_frames, world=None, ypr_amp=(12.0, 5.0, 4.0)):
    """The EuRoC profile's system and a cold-start stream: 200 Hz IMU samples
    (host numpy) and 10 Hz rendered frames from t = 0 of the figure-8, its
    attitude swinging by ypr_amp (degrees).  The body frame is mounted as
    EuRoC's (x up, z forward): the figure-8 attitude composed with the fixed
    rotation that points the EuRoC camera where the renderer's forward camera
    looks."""
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
    fig8 = syn.figure8_trajectory(radius=1.2, ypr_amp=ypr_amp)
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


def phase_cold_start(C, profile=False, draws=None, plain=False, selector=None):
    """Phase 6: SlamSystem from a cold start with the profile's loop closure,
    fill -> initializer -> tracking, with every kernel's launches counted
    over the run.  Works on CPU tensors too (a rehearsal: no events, no sync count).
    The witness runs of --cold-witness pass draws=(generator device, seed)
    for ``use_draws``, or plain=True for ``plain_twins_of_k9_k10``.  Phase 8
    passes selector=<the profile's SelectorConfig>: the same run with the
    attention feature selector on (``selector_checks``)."""
    if plain:
        with plain_twins_of_k9_k10():
            return _cold_start(C, profile, draws, plain, selector)
    return _cold_start(C, profile, draws, plain, selector)


@contextlib.contextmanager
def recording_selector(sysm, frame):
    """Record each selector call of sysm (the frame index frame["j"], the
    candidate ids, the window's ids, the kept ids: device tensors, read
    after the run; the K20 launches it made) and the last inputs of
    select_features."""
    from vplines_slam_tpu_torch.models import selector as sel_mod

    calls, last = [], {}
    impl, greedy = sysm._select_impl, sel_mod.select_features
    k20 = lambda: sum(k.launches for k in selector_kernels())

    def select(ids, rays, state, data, *a):
        n0 = k20()
        out = impl(ids, rays, state, data, *a)
        calls.append((frame["j"], ids, data.pt_id, out, k20() - n0))
        last["args"] = (ids, rays, state, data, *a)
        return out

    def greedy_rec(prior, feats, mask, budget, cfg, obs_frame=None):
        last.update(prior=prior, feats=feats, mask=mask, cfg=cfg, obs_frame=obs_frame)
        out = greedy(prior, feats, mask, budget, cfg, obs_frame=obs_frame)
        last.setdefault("frames", []).append((prior, feats, mask, budget, out))
        return out

    sysm._select_impl, sel_mod.select_features = select, greedy_rec
    try:
        yield calls, last, impl
    finally:
        sysm._select_impl, sel_mod.select_features = impl, greedy


def selector_checks(calls, last, scfg, n_tracked, per, on_card):
    """Phase 8's per-frame table and bars: every tracked frame ran the
    selector, every tracked id was kept, kept <= max(max_features, tracked);
    then select_features on the last frame's real inputs with budget =
    max_features against its plain twin (the same picks, gains 1e-9)."""
    import torch

    from vplines_slam_tpu_torch.models import selector as sel_mod

    rows = []
    for i, (j, ids, pt_id, out, n_k20) in enumerate(calls):
        ids, pt_id, out = ids.cpu().numpy(), pt_id.cpu().numpy(), out.cpu().numpy()
        valid = ids >= 0
        tracked = valid & np.isin(ids, pt_id[pt_id >= 0])
        budget = max(scfg.max_features - int(tracked.sum()), 0)
        kept = int((out >= 0).sum())
        ms = per[i].get("selector", float("nan")) if per and i < len(per) else float("nan")
        rows.append((j, int(valid.sum()), int(tracked.sum()), budget, kept, ms, n_k20))
        if not np.array_equal(out[tracked], ids[tracked]):
            fail(f"selector: frame {j} dropped a tracked id")
        if not kept <= max(scfg.max_features, int(tracked.sum())):
            fail(f"selector: frame {j} kept {kept} > max(max_features, tracked)")
    for j, n_c, n_t, b, kept, ms, n_k20 in rows:
        log(f"  frame {j}: {n_c} candidates, {n_t} tracked, budget {b}, kept {kept} "
            f"({kept - n_t} new), selector stage {ms:.3f} ms (CUDA events), K20 wrapper "
            f"launches {n_k20} (selector_greedy's is one kernel)")
    if len(calls) != n_tracked:
        fail(f"selector: {len(calls)} selector calls for {n_tracked} tracked frames")
    if on_card and "feats" in last:
        cfg = last["cfg"]
        # every frame's greedy pass as it ran, against the twin on its inputs
        err_f, n_same = 0.0, 0
        for prior, feats, mask, budget, (sk, gk) in last["frames"]:
            sp, gp = sel_mod.select_features_plain(prior, feats, mask, budget, cfg,
                                                   obs_frame=last["obs_frame"])
            n_same += bool(torch.equal(sk, sp))
            err_f = max(err_f, float((gk - gp).abs().max()))
        log(f"  the greedy pass of each of the {len(last['frames'])} frames as it ran: selected "
            f"sets identical to the twin's on {n_same}; gains max |kernel - plain| = "
            f"{err_f:.3e} (tol 1e-9)")
        if not (n_same == len(last["frames"]) and err_f <= 1e-9):
            fail("selector_greedy disagrees with its plain twin on a phase 8 frame")
        budget = torch.tensor(cfg.max_features, device=last["feats"].device)
        obs = last["obs_frame"]
        sk, gk = sel_mod.select_features(last["prior"], last["feats"], last["mask"], budget, cfg,
                                         obs_frame=obs)
        sk2, gk2 = sel_mod.select_features(last["prior"], last["feats"], last["mask"], budget,
                                           cfg, obs_frame=obs)
        sp, gp = sel_mod.select_features_plain(last["prior"], last["feats"], last["mask"],
                                               budget, cfg, obs_frame=obs)
        if not (torch.equal(sk, sk2) and torch.equal(gk, gk2)):
            fail("selector_greedy does not repeat to the last bit on the frame's inputs")
        err = float((gk - gp).abs().max())
        log(f"  the last frame's real selector inputs ({int(last['mask'].sum())} new of "
            f"{last['mask'].numel()}) with budget = max_features = {cfg.max_features}: K20 "
            f"picks {int(sk.sum())}, its plain twin {int(sp.sum())}, identical: "
            f"{bool(torch.equal(sk, sp))}; gains max |kernel - plain| = {err:.3e} (tol 1e-9)")
        if not (torch.equal(sk, sp) and err <= 1e-9):
            fail("selector_greedy disagrees with its plain twin on the frame's inputs")
        from vplines_slam_tpu_torch.kernels import TWIN_CALLS

        TWIN_CALLS.clear()
    return rows


def _cold_start(C, profile, draws, plain, selector=None):
    import torch

    from vplines_slam_tpu_torch.native import available as native_available
    from vplines_slam_tpu_torch.pipeline.system import SlamSystem

    on_card = C["imgs"].is_cuda
    dev = C["imgs"].device
    sysm = SlamSystem(C["cam"], C["wcfg"], C["tcfg"], C["lcfg"], pg_cfg=euroc_pose_graph(),
                      imu_params=C["params"], q_ic=C["q_ic"], p_ic=C["p_ic"],
                      use_loop_closure=True, use_feature_selector=selector is not None,
                      selector_cfg=selector, dtype=torch.float32, device=dev)
    if draws is not None:
        use_draws(sysm, *draws)
    sel_note = ("" if selector is None else
                f", the feature selector on ({dict(selector._asdict())})")
    log(f"cold start: SlamSystem on the EuRoC profile's values (loop closure on: "
        f"{sysm.pg_cfg.n_features} FAST + BRIEF per keyframe, skip_recent "
        f"{sysm.pg_cfg.skip_recent}{sel_note}), native IMU synchronizer: "
        f"{native_available()}, stamps from {C['frame_t'][0]:.6f} s")
    imu_t, accs, gyrs, frame_t = C["imu_t"], C["accs"], C["gyrs"], C["frame_t"]
    state = dict(i=0, j=0)

    def feed(j):
        state["j"] = j
        while state["i"] < len(imu_t) and imu_t[state["i"]] <= frame_t[j]:
            sysm.add_imu(imu_t[state["i"]], accs[state["i"]], gyrs[state["i"]])
            state["i"] += 1
        return sysm.add_image(frame_t[j], C["imgs"][j])

    rec_sel = (recording_selector(sysm, state) if selector is not None
               else contextlib.nullcontext((None, None, None)))
    with rec_sel as (sel_calls, sel_last, sel_impl):
        res = _cold_start_run(C, sysm, feed, on_card, profile, plain, selector, sel_calls,
                              sel_last, sel_impl)
    return res


def _cold_start_run(C, sysm, feed, on_card, profile, plain, selector, sel_calls, sel_last,
                    sel_impl):
    import torch

    from vplines_slam_tpu_torch.kernels import TWIN_CALLS as LOOP_TWIN_CALLS
    from vplines_slam_tpu_torch.kernels import all_kernels
    from vplines_slam_tpu_torch.models.imu import PREINTEGRATE
    from vplines_slam_tpu_torch.ops.image import CLAHE
    from vplines_slam_tpu_torch.solver.lm import TWIN_CALLS
    from vplines_slam_tpu_torch.utils.evaluation import ate_rmse, umeyama_alignment
    from vplines_slam_tpu_torch.utils.stats import SPANS

    n_total = C["imgs"].shape[0]
    frame_t = C["frame_t"]
    where = "cold start" if selector is None else "selector cold start"

    def sync():
        if on_card:
            torch.cuda.synchronize()

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
    n_sel_calls = len(sel_calls) if sel_calls is not None else 0
    if on_card:
        estimator_check(False, where)
        loop_twin_check(where)
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
                     clahe=(CLAHE.name,), vio=("vio",),
                     preintegrate=(PREINTEGRATE.name,), loop_stage=("loop_stage",),
                     lc_extract=("lc_extract",), lc_retrieve=("lc_retrieve",),
                     selector=("selector",))
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
            f"{lc_sum['lc_retrieve']:.2f} ms)" + ("" if selector is None else
                                                  f"; selector stage median "
                                                  f"{split['selector']:.3f} ms"))
        split["lc_sum"] = lc_sum
    if selector is not None:
        k20 = {k.name: k.launches for k in selector_kernels()}
        selector_checks(sel_calls[:n_sel_calls], sel_last, selector, n_tracked,
                        SPANS.per_frame_ms() if on_card else None, on_card)
        log(f"  K20 launches over the {n_tracked} tracked frames: {k20}")
        if on_card and any(c != n_tracked for c in k20.values()):
            fail(f"K20 did not launch on every tracked frame: {k20}")
        probe_args = sel_last["args"]
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
        syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
        res["syncs"] = len(syncs) / max(n_extra, 1)
        sites = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in syncs)
        log(f"  host syncs: {res['syncs']:.1f} per frame (over {n_extra} frames); call sites: "
            f"{sites.most_common()}")
        j += n_extra
        if profile and j + N_SYNC <= n_total:
            j0 = j

            def run_profiled():
                for k in range(j0, j0 + N_SYNC):
                    feed(k)
                sysm.flush()

            res["profile"] = (run_profiled, N_SYNC,
                              split["frontend"] + split["line_frontend"] + split["vio"])
        if selector is not None:
            res["selector_probe"] = lambda: sel_impl(*probe_args)
    n_kf_db = sysm._db_count
    loop_l = {k.name: k.launches for k in loop_kernels()}
    lc_ms = sysm.stats.timers.mean("loop_stage")
    log(f"  loop closure: {n_kf_db} keyframes inserted, loop_stage timer mean {lc_ms:.3f} ms "
        f"per drain; launches of K15-K19 and K21: {loop_l}")
    res["n_kf_db"], res["loop_stage_ms"], res["loop_launches"] = n_kf_db, lc_ms, loop_l
    # no loop can close within skip_recent keyframes: verification, PnP and
    # the pose graph stay idle, and the corrected pose is the VIO pose
    from vplines_slam_tpu_torch.models.pose_graph import PGO4
    from vplines_slam_tpu_torch.ops.brief import HAMMING_MATCH
    from vplines_slam_tpu_torch.ops.mvg import PNP_HYPOTHESES

    idle = {HAMMING_MATCH.name, PNP_HYPOTHESES.name, PGO4.name}
    idle |= {k.name for k in calib_kernels()}  # the extrinsic is given, td not estimated
    if selector is None:
        idle |= {k.name for k in selector_kernels()}
    if plain:
        idle |= {CLAHE.name, PREINTEGRATE.name}
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


# ---------------------------------------------------------------------------
# phase 3, online calibration: K22-K24 against their plain twins
# ---------------------------------------------------------------------------


def calib_kernels():
    """K22-K24."""
    from vplines_slam_tpu_torch.models.calibration import GYRO_YAW, HAND_EYE, TIME_OFFSET

    return [GYRO_YAW, TIME_OFFSET, HAND_EYE]


def gyro_yaw_ops(I):
    """f64 operations of I gyro steps: the product with the half-angle
    quaternion (28), the norm and four divisions (12), the yaw with its
    atan2 (~25), the wrap and the sum (~8); a masked step costs the same."""
    return 73 * I


def time_offset_ops(C, M, iters=10):
    """f64 operations of the ICP: every camera sample against every IMU
    stamp (a subtraction, an absolute value, a comparison) in each of the
    iters + 1 passes, then ~40 a sample for r and J and 10 for the sums."""
    return (iters + 1) * C * (3 * M + 50)


def hand_eye_ops(K):
    """f64 operations of K24: a pair's weight (~30), its 4x4 block (16) and
    the 10 entries of B^T B (80), then a 4x4 Jacobi of ~6 sweeps (6 x 6
    rotations x ~60)."""
    return 126 * K + 2200


def gyro_batches(n, I, seed, yaw_rate, t0, mask_kind="prefix"):
    """n IMU batches as VioEngine._pack_imu passes them to push_imu_angles:
    stamps [I + 1] zero-padded past the live steps, gyros [I + 1, 3], mask
    [I]; yaw_rate (rad/s) about z makes the yaw cross +-pi; mask_kind
    "half" keeps every other step of a full batch."""
    rng = np.random.default_rng(seed)
    out, t = [], t0
    for b in range(n):
        live = I if mask_kind == "half" or b % 2 == 0 else int(rng.integers(1, I))
        ts = np.zeros(I + 1)
        ts[: live + 1] = t + np.cumsum(np.r_[0.0, rng.uniform(0.0045, 0.0055, live)])
        t = ts[live]
        gyrs = rng.standard_normal((I + 1, 3)) * 0.5
        gyrs[:, 2] += yaw_rate
        gyrs[live + 1:] = 0.0
        mask = np.arange(I) < live
        if mask_kind == "half":
            mask[1::2] = False
        out.append((ts, gyrs, mask))
    return out


def td_acc_stage(dev, C=128, M=4096, n_cam=100, n_imu=2000, td_true=0.004, t0=EUROC_T0,
                 seed=SEED):
    """A TimeOffsetCalib at phase 9's capacities, filled part way: camera
    samples at 10 Hz seeing a yaw curve at t + td_true (every fifth one
    invalid, a little noise), IMU samples at 200 Hz, EuRoC-epoch stamps."""
    import torch

    from vplines_slam_tpu_torch.estimator import online_calib as oc

    rng = np.random.default_rng(seed)
    yaw = lambda t: 0.6 * np.sin(1.1 * t) + 0.15 * t
    t_imu, a_imu = np.zeros(M), np.zeros(M)
    t_imu[:n_imu] = 0.05 + np.arange(n_imu) / IMU_HZ
    a_imu[:n_imu] = yaw(t_imu[:n_imu])
    t_cam, a_cam = np.zeros(C), np.zeros(C)
    t_cam[:n_cam] = 0.2 + np.arange(n_cam) / FRAME_HZ
    a_cam[:n_cam] = yaw(t_cam[:n_cam] + td_true) + 0.3 + rng.normal(0.0, 1e-4, n_cam)
    valid = np.zeros(C, bool)
    valid[:n_cam] = np.arange(n_cam) % 5 != 4
    t_cam[:n_cam] += t0
    t_imu[:n_imu] += t0
    f = lambda a: torch.from_numpy(a).to(dev)
    n = lambda k: torch.tensor(k, dtype=torch.int64, device=dev)
    qid = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64, device=dev)
    return oc.TimeOffsetCalib(t_cam=f(t_cam), ang_cam=f(a_cam), cam_valid=f(valid),
                              n_cam=n(n_cam), q_cam_cum=qid, t_imu=f(t_imu), ang_imu=f(a_imu),
                              n_imu=n(n_imu), q_imu_cum=qid.clone())


def td_solve_kernel(acc, min_cam=30):
    """solve_time_offset through K23, with c: ([td, c, rms], ok)."""
    from vplines_slam_tpu_torch.models import calibration as cal

    return cal.time_offset_cuda(acc.t_cam, acc.ang_cam, acc.cam_valid, acc.t_imu, acc.ang_imu,
                                n_cam=acc.n_cam, n_imu=acc.n_imu, min_cam=min_cam)


def td_solve_plain(acc, min_cam=30):
    """solve_time_offset's twin, with c: ([td, c, rms], ok)."""
    import torch

    from vplines_slam_tpu_torch.estimator import online_calib as oc
    from vplines_slam_tpu_torch.models import calibration as cal

    cam_ok = acc.cam_valid & (torch.arange(acc.t_cam.shape[0], device=acc.n_cam.device)
                              < acc.n_cam)
    out = torch.stack(cal.calibrate_time_offset_plain(acc.t_cam, acc.ang_cam, cam_ok,
                                                      *oc._padded_imu_curve(acc)))
    return out, (acc.n_cam >= min_cam) & torch.isfinite(out[0])


def gyro_err(a, b):
    """max |difference| over a TimeOffsetCalib's IMU fields, and whether its
    count agrees exactly."""
    err = max(float((a.t_imu - b.t_imu).abs().max()), float((a.ang_imu - b.ang_imu).abs().max()),
              float((a.q_imu_cum - b.q_imu_cum).abs().max()))
    return err, int(a.n_imu) == int(b.n_imu)


def k22_check(label, acc, batches):
    """K22 (push_imu_angles) against its twin over a sequence of batches,
    each output fed to the next call on both sides: the curve, the
    rotation (1e-12) and the count (exactly) after every batch; each call
    again on the same inputs equal to the bit, one launch a call."""
    import torch

    from vplines_slam_tpu_torch.estimator import online_calib as oc
    from vplines_slam_tpu_torch.models.calibration import GYRO_YAW

    dev = acc.t_imu.device
    ak, ap, err, same, again, one = acc, acc, 0.0, True, True, True
    for ts, gyrs, mask in batches:
        args = (torch.from_numpy(ts).to(dev), torch.from_numpy(gyrs).to(dev),
                torch.from_numpy(mask).to(dev))
        n0 = GYRO_YAW.launches
        k1 = oc.push_imu_angles(ak, *args)
        one &= GYRO_YAW.launches - n0 == 1
        again &= _bits_equal(tuple(oc.push_imu_angles(ak, *args)), tuple(k1))
        ap = oc.push_imu_angles_plain(ap, *args)
        ak = k1
        e, s = gyro_err(ak, ap)
        err, same = max(err, e), same and s
    ok = err <= 1e-12 and same and again and one
    log(f"K22 {label}: max |kernel - twin| over the curve and rotation {err:.3e} (tol 1e-12), "
        f"counts equal {same} (n_imu {int(ak.n_imu)} of {ak.t_imu.shape[0]}), two calls equal "
        f"to the bit {again}, one launch a call {one}")
    return ok, err, ak


def k23_check(label, fn_kernel, fn_plain, expect_nan=False):
    """K23 against its twin: td, c and the RMS within 1e-12 relative (1e-15
    absolute below), ok exactly; NaN on both sides where expected; two
    calls equal to the bit."""
    import torch

    from vplines_slam_tpu_torch.models.calibration import TIME_OFFSET

    n0 = TIME_OFFSET.launches
    out_k, ok_k = fn_kernel()
    one = TIME_OFFSET.launches - n0 == 1
    out_k2, ok_k2 = fn_kernel()
    again = _bits_equal((out_k, ok_k), (out_k2, ok_k2))
    out_p, ok_p = fn_plain()
    kk, pp = out_k.cpu().numpy(), out_p.cpu().numpy()
    if expect_nan:
        good = bool(np.isnan(kk[0]) and np.isnan(pp[0]) and np.isnan(kk[2]) and np.isnan(pp[2]))
        rel = float("nan")
    else:
        rel = float(np.max(np.abs(kk - pp) / np.maximum(np.maximum(np.abs(kk), np.abs(pp)),
                                                       1e-3)))
        good = bool(np.all(np.abs(kk - pp) <= 1e-12 * np.maximum(np.abs(kk), np.abs(pp))
                           + 1e-15))
    flags = bool(ok_k) == bool(ok_p)
    log(f"K23 {label}: kernel (td, c, rms) = ({kk[0]:.9e}, {kk[1]:.6e}, {kk[2]:.6e}), twin "
        f"({pp[0]:.9e}, {pp[1]:.6e}, {pp[2]:.6e}); max relative gap {rel:.3e} (tol 1e-12); "
        f"ok {bool(ok_k)} / {bool(ok_p)}; one launch {one}, two calls equal to the bit {again}"
        + ("; NaN on both sides as expected" if expect_nan else ""))
    return good and flags and one and again, (0.0 if expect_nan else rel)


def hand_eye_determined(qc, qi, v):
    """Whether the hand-eye problem has one solution: the relative gap of
    A^T A's two smallest eigenvalues (f64) above 1e-5, so an eigensolver's
    q errs by at most ~eps / gap."""
    import torch

    from vplines_slam_tpu_torch.utils.geometry import quat_left, quat_right

    qc, qi = qc.double(), qi.double()
    d = torch.abs(2 * torch.arccos(torch.clamp(qc[:, 0].abs(), 0, 1))
                  - 2 * torch.arccos(torch.clamp(qi[:, 0].abs(), 0, 1)))
    thr = math.radians(5.0)
    w = torch.where(d < thr, torch.ones_like(d), thr / torch.clamp(d, min=1e-9)) * v.double()
    A = ((quat_left(qi) - quat_right(qc)) * w[:, None, None]).reshape(-1, 4)
    lam = torch.linalg.eigvalsh(A.T @ A)
    return bool((lam[1] - lam[0]) > 1e-5 * max(float(lam[3]), 1e-300))


def k24_check(label, qc, qi, v, count=None, min_pairs=0, quiet=False):
    """K24 against the f64 twin (on the f64 inputs, or the f32 inputs
    widened): q within 1e-10 at f64, 1e-6 at f32 (its output rounding), on
    determined sets; σ₃ within 1e-10 / 1e-6; the flag exactly unless σ₃ is
    within that tolerance of the 0.25 gate; two calls equal to the bit, one
    launch.  Returns (ok, q error or None where undetermined)."""
    import torch

    from vplines_slam_tpu_torch.models import calibration as cal

    tol = 1e-10 if qc.dtype == torch.float64 else 1e-6
    n0 = cal.HAND_EYE.launches
    out = cal.calibrate_extrinsic_rotation(qc, qi, v, count=count, min_pairs=min_pairs)
    one = cal.HAND_EYE.launches - n0 == 1
    again = _bits_equal(out, cal.calibrate_extrinsic_rotation(qc, qi, v, count=count,
                                                              min_pairs=min_pairs))
    det = hand_eye_determined(qc, qi, v)
    qp, cp, sp = cal.calibrate_extrinsic_rotation_plain(qc.double(), qi.double(), v,
                                                        count=count, min_pairs=min_pairs)
    qk, ck, sk = out
    e_s = abs(float(sk) - float(sp))
    e_q = float((qk.double() - qp).abs().max())
    flag_ok = bool(ck) == bool(cp) or abs(float(sp) - 0.25) <= tol
    ok = one and again and e_s <= tol and flag_ok and (e_q <= tol or not det)
    if not quiet or not ok:
        log(f"K24 {label}: sigma_3 kernel {float(sk):.9f} twin {float(sp):.9f} (|diff| "
            f"{e_s:.2e}, tol {tol:.0e}), converged {bool(ck)} / {bool(cp)}, q |diff| {e_q:.2e}"
            f"{'' if det else ' (undetermined: not held)'}; one launch {one}, two calls equal "
            f"to the bit {again}")
    return ok, (e_q if det else None)


def hand_eye_sets(dev, dtype):
    """The hand-eye sets of phase 3: tests/test_calibration_selector.py:12's
    30 exact pairs, a padded 64-slot set (20 pairs, one invalid, 44 identity
    slots) and a degenerate one (64 identity pairs)."""
    import torch

    from vplines_slam_tpu_torch.utils import geometry as geo

    f64 = torch.float64
    rng = np.random.default_rng(1)
    q_ic = geo.so3_exp_quat(torch.tensor([0.1, -0.2, 1.5], dtype=f64))
    out = {}
    for name, K, n_pad in (("the 30 exact pairs of test_calibration_selector", 30, 0),
                           ("a padded 64-slot set", 20, 44)):
        qi = geo.so3_exp_quat(torch.from_numpy(rng.standard_normal((K, 3)) * 0.2))
        qc = geo.quat_mul(geo.quat_conj(q_ic), geo.quat_mul(qi, q_ic))
        ident = torch.zeros(n_pad, 4, dtype=f64)
        ident[:, 0] = 1.0
        v = torch.ones(K + n_pad, dtype=torch.bool)
        v[K:] = False
        if n_pad:
            v[4] = False
        out[name] = (torch.cat([qc, ident]), torch.cat([qi, ident]), v)
    ident = torch.zeros(64, 4, dtype=f64)
    ident[:, 0] = 1.0
    out["a degenerate set (64 identity pairs)"] = (ident, ident.clone(),
                                                   torch.ones(64, dtype=torch.bool))
    return {k: tuple(x.to(dev, dtype) if x.is_floating_point() else x.to(dev) for x in t)
            for k, t in out.items()}


def phase_calib_kernels(rec, dev):
    """K22-K24 against their plain twins at phase 9's shapes and on the
    cases, timed."""
    import torch

    from vplines_slam_tpu_torch.estimator import online_calib as oc
    from vplines_slam_tpu_torch.kernels import TWIN_CALLS
    from vplines_slam_tpu_torch.models import calibration as cal
    from vplines_slam_tpu_torch.utils import geometry as geo

    f32, f64 = torch.float32, torch.float64
    I = 64  # configs/euroc.yaml max_imu
    ok_all, worst22 = True, 0.0
    # K22: a frame's 64 steps crossing +-pi, half-masked batches, a ring
    # overflow at M = 16
    for label, M, Ib, kind, rate, nb in (
            ("64-step batches crossing +-pi (M 4,096)", 4096, I, "prefix", 40.0, 4),
            ("half-masked 64-step batches (M 4,096)", 4096, I, "half", 1.0, 3),
            ("a ring overflow (M 16, 6-step batches)", 16, 6, "prefix", 3.0, 6)):
        acc = oc.empty_td_calib(cam_capacity=8, imu_capacity=M, device=dev)
        ok, err, acc_k = k22_check(label, acc, gyro_batches(nb, Ib, SEED + 22, rate, EUROC_T0,
                                                           kind))
        ok_all &= ok
        worst22 = max(worst22, err)
        if kind == "prefix" and M == 4096:
            cross = float(acc_k.ang_imu.abs().max())
            log(f"  the unwrapped curve reaches {cross:.3f} rad (crosses +-pi: {cross > math.pi})")
    # integrate_gyro_yaw on the figure-8's gyro (400 samples)
    from vplines_slam_tpu_torch.utils import synthetic as syn

    ts = torch.linspace(0.0, 2.0, 400, dtype=f64, device=dev)
    _, gy = syn.imu_samples(syn.figure8_trajectory(), ts)
    yk = cal.integrate_gyro_yaw(ts, gy)
    yp = cal.integrate_gyro_yaw_plain(ts, gy)
    e_int = float((yk - yp).abs().max())
    log(f"K22 integrate_gyro_yaw on 400 figure-8 samples: max |kernel - twin| {e_int:.3e} "
        f"(tol 1e-12)")
    ok_all &= e_int <= 1e-12
    worst22 = max(worst22, e_int)
    # the main path's shape: a fill frame's 64 steps into a curve of 4,096
    acc = oc.empty_td_calib(device=dev)
    for ts_b, gy_b, m_b in gyro_batches(16, I, SEED + 23, 1.0, EUROC_T0):
        acc = oc.push_imu_angles(acc, *(torch.from_numpy(x).to(dev) for x in (ts_b, gy_b, m_b)))
    ts_b, gy_b, m_b = (torch.from_numpy(x).to(dev)
                       for x in gyro_batches(1, I, SEED + 24, 1.0, EUROC_T0 + 10.0)[0])
    M = acc.t_imu.shape[0]
    record(rec, "gyro_yaw", worst22, lambda: oc.push_imu_angles(acc, ts_b, gy_b, m_b),
           lambda: oc.push_imu_angles_plain(acc, ts_b, gy_b, m_b), "gyro_yaw_kernel",
           8 * (I + 1) * 4 + I + 2 * 4 * 8 + 2 * 8 + 2 * 2 * 8 * M, gyro_yaw_ops(I))
    # K23: test_calibration_selector.py:33's curve, a half-filled accumulator
    # with the padding, the perp = 0 NaN case, and the main path's shape
    t_imu = torch.linspace(0.0, 7.0, 700, dtype=f64, device=dev)
    yaw = 0.5 * torch.sin(1.3 * t_imu) + 0.2 * t_imu
    t_cam = torch.linspace(0.3, 6.5, 40, dtype=f64, device=dev)
    yaw_cam = 0.5 * torch.sin(1.3 * (t_cam + 0.035)) + 0.2 * (t_cam + 0.035)
    v40 = torch.ones(40, dtype=torch.bool, device=dev)
    worst23 = 0.0
    ok, e = k23_check("on test_calibration_selector's curve (40 x 700)",
                      lambda: cal.time_offset_cuda(t_cam, yaw_cam, v40, t_imu, yaw),
                      lambda: (torch.stack(cal.calibrate_time_offset_plain(
                          t_cam, yaw_cam, v40, t_imu, yaw)), torch.tensor(True)))
    ok_all &= ok
    worst23 = max(worst23, e)
    half = td_acc_stage(dev, n_cam=60, n_imu=1300)
    kern_solve, plain_solve = td_solve_kernel, td_solve_plain
    ok, e = k23_check("on a half-filled accumulator (60 of 128 camera, 1,300 of 4,096 IMU "
                      "samples, the padding)", lambda: kern_solve(half),
                      lambda: plain_solve(half))
    ok_all &= ok
    worst23 = max(worst23, e)
    # a masked camera slot exactly on the IMU curve's first sample
    t_c, a_c = half.t_cam.clone(), half.ang_cam.clone()
    t_c[60], a_c[60] = half.t_imu[0], half.ang_imu[0]
    nan_acc = half._replace(t_cam=t_c, ang_cam=a_c)
    ok, _ = k23_check("on the perp = 0 case (a masked sample on the curve)",
                      lambda: kern_solve(nan_acc), lambda: plain_solve(nan_acc), expect_nan=True)
    ok_all &= ok
    full = td_acc_stage(dev, n_cam=128, n_imu=4096)
    ok, e = k23_check("at the capacities (128 x 4,096, all filled)", lambda: kern_solve(full),
                      lambda: plain_solve(full))
    ok_all &= ok
    worst23 = max(worst23, e)
    C = full.t_cam.shape[0]
    nn_q = (full.t_cam + 0.004).contiguous()
    record(rec, "time_offset", worst23, lambda: oc.solve_time_offset(full),
           lambda: oc.solve_time_offset_plain(full), "time_offset_kernel",
           8 * (2 * 4096 + 3 * C) + C + 16 + 24 + 1, time_offset_ops(C, 4096),
           library_fn=lambda: torch.searchsorted(full.t_imu, nn_q),
           library_label="the nearest-neighbour step alone: torch.searchsorted of the 128 "
                         "shifted camera stamps in the filled curve")
    # K24: the 30-pair set, a padded 64-slot set, a degenerate set, at f64
    # and f32
    worst24 = 0.0
    for dt in (f64, f32):
        for label, (qc, qi, v) in hand_eye_sets(dev, dt).items():
            ok, e = k24_check(f"{label} ({str(dt).removeprefix('torch.')})", qc, qi, v)
            ok_all &= ok
            worst24 = max(worst24, e or 0.0)
    qc, qi, v = hand_eye_sets(dev, f32)["a padded 64-slot set"]
    cnt = torch.tensor(20, dtype=torch.int64, device=dev)
    A = ((geo.quat_left(qi.double()) - geo.quat_right(qc.double()))).reshape(-1, 4)
    record(rec, "hand_eye", worst24,
           lambda: cal.calibrate_extrinsic_rotation(qc, qi, v, count=cnt, min_pairs=12),
           lambda: cal.calibrate_extrinsic_rotation_plain(qc, qi, v, count=cnt, min_pairs=12),
           "hand_eye_kernel", 2 * 64 * 16 + 64 + 8 + 16 + 1 + 4, hand_eye_ops(64),
           library_fn=lambda: torch.linalg.svd(A, full_matrices=False),
           library_label="torch.linalg.svd of the [256, 4] f64 A")
    TWIN_CALLS.clear()
    if not ok_all:
        fail("a calibration kernel (K22-K24) disagrees with its plain twin or does not repeat")


# ---------------------------------------------------------------------------
# phase 9: calibration cold start (extrinsic mode 2, then the time offset)
# ---------------------------------------------------------------------------

N_CALIB_EX = 70  # frames by which mode 2 must have initialized
N_CALIB_TD = 90  # frames by which the time-offset run must have initialized
N_CALIB_TRACK = 10  # tracked frames after the initializing one
TD_TRUE = 0.004  # s: the IMU stamps run 4 ms late (tests/test_online_calib_wiring.py:95)
# the figure-8's attitude swing (degrees) in phase 9: figure8_trajectory's
# defaults, the stream of tests/test_online_calib_wiring.py; at the cold
# start's (12, 5, 4) a frame pair turns 0.3-0.8 degrees, sigma_3 stays
# below 0.05 and the hand-eye solve wanders 4-35 degrees from the truth
CALIB_YPR_AMP = (25.0, 8.0, 6.0)


@contextlib.contextmanager
def recording_calib(store):
    """Record every hand-eye solve (its inputs and outputs), every IMU curve
    push (inputs and output) and every time-offset solve (its accumulator
    and outputs) of a run; all inputs are kept by reference (the
    accumulators are never written in place)."""
    from vplines_slam_tpu_torch.estimator import online_calib as oc
    from vplines_slam_tpu_torch.models import calibration as cal

    he, push, solve = cal.calibrate_extrinsic_rotation, oc.push_imu_angles, oc.solve_time_offset

    def he_rec(*a, **kw):
        out = he(*a, **kw)
        store.setdefault("hand_eye", []).append((a, kw, out))
        return out

    def push_rec(acc, *a):
        out = push(acc, *a)
        store.setdefault("push", []).append((acc, a, out))
        return out

    def solve_rec(acc, *a, **kw):
        out = solve(acc, *a, **kw)
        store.setdefault("solve", []).append((acc, out))
        return out

    cal.calibrate_extrinsic_rotation, oc.push_imu_angles, oc.solve_time_offset = (
        he_rec, push_rec, solve_rec)
    try:
        yield store
    finally:
        cal.calibrate_extrinsic_rotation, oc.push_imu_angles, oc.solve_time_offset = (
            he, push, solve)


def calib_calls_check(rec, store, where):
    """Every hand-eye solve of the run through k24_check (and again equal to
    the bit to what ran), every IMU curve push through K22 again (to the bit)
    and its twin (1e-12), the last time-offset solve through k23_check."""
    from vplines_slam_tpu_torch.estimator import online_calib as oc

    from vplines_slam_tpu_torch.models import calibration as cal

    ok_all, n_undet, worst = True, 0, 0.0
    for i, (a, kw, out) in enumerate(store.get("hand_eye", [])):
        again = _bits_equal(out, cal.calibrate_extrinsic_rotation(*a, **kw))
        ok, e = k24_check(f"{where}'s solve {i}", *a, **kw, quiet=True)
        ok_all &= ok and again
        n_undet += e is None
        worst = max(worst, e or 0.0)
    n_he = len(store.get("hand_eye", []))
    if n_he:
        log(f"  K24 on the {n_he} hand-eye solves of {where}: each again equal to the bit, q "
            f"within {worst:.2e} of the f64 twin on the widened inputs (tol 1e-6: f32 outputs), "
            f"sigma_3 and the flag as k24_check holds them; undetermined {n_undet}: {ok_all}")
    ok22, e22 = True, 0.0
    for acc, a, out in store.get("push", []):
        ok22 &= _bits_equal(tuple(out), tuple(oc.push_imu_angles(acc, *a)))
        e, same = gyro_err(out, oc.push_imu_angles_plain(acc, *a))
        ok22 &= same and e <= 1e-12
        e22 = max(e22, e)
    n_push = len(store.get("push", []))
    if n_push:
        log(f"  K22 on the {n_push} IMU curve pushes of {where}: again equal to the bit and "
            f"within {e22:.3e} of the twin (tol 1e-12), counts exact: {ok22}")
    ok_all &= ok22
    solves = store.get("solve", [])
    if solves:
        acc, (td, rms, _) = solves[-1]
        kern, plain = (lambda: td_solve_kernel(acc)), (lambda: td_solve_plain(acc))
        same = _bits_equal((td, rms), tuple(kern()[0][[0, 2]]))
        log(f"  the last solve of {where} again through K23: td and rms equal to the bit to "
            f"what ran: {same}")
        ok_all &= same
        ok, _ = k23_check(f"on {where}'s last real accumulator ({int(acc.n_cam)} camera, "
                          f"{int(acc.n_imu)} IMU samples; solve {len(solves)} of the run)",
                          kern, plain)
        ok_all &= ok
    from vplines_slam_tpu_torch.kernels import TWIN_CALLS

    TWIN_CALLS.clear()
    if not ok_all:
        fail(f"{where}: a calibration kernel disagrees on the run's calls")


def phase_calibration(C9, mode, on_card=True):
    """Phase 9, one run: SlamSystem on the EuRoC profile's values from a cold
    start with online calibration, mode "extrinsic" (no q_ic: hand-eye mode
    2) or "td" (the profile's q_ic, estimate_td, the IMU stamps 4 ms late),
    through the calibrated initialization and N_CALIB_TRACK tracked
    frames, with the host syncs of every frame counted."""
    import torch

    from vplines_slam_tpu_torch.kernels import TWIN_CALLS as LOOP_TWIN_CALLS
    from vplines_slam_tpu_torch.kernels import all_kernels
    from vplines_slam_tpu_torch.pipeline.system import SlamSystem
    from vplines_slam_tpu_torch.solver.lm import TWIN_CALLS
    from vplines_slam_tpu_torch.utils import geometry as geo
    from vplines_slam_tpu_torch.utils.evaluation import ate_rmse

    ex = mode == "extrinsic"
    n_max = N_CALIB_EX if ex else N_CALIB_TD
    dev = C9["imgs"].device
    kw = (dict(q_ic=None, p_ic=None) if ex
          else dict(q_ic=C9["q_ic"], p_ic=C9["p_ic"], estimate_td=True))
    sysm = SlamSystem(C9["cam"], C9["wcfg"], C9["tcfg"], C9["lcfg"], pg_cfg=euroc_pose_graph(),
                      imu_params=C9["params"], use_loop_closure=True, dtype=torch.float32,
                      device=dev, **kw)
    shift = 0.0 if ex else TD_TRUE
    imu_t, accs, gyrs, frame_t = C9["imu_t"] + shift, C9["accs"], C9["gyrs"], C9["frame_t"]
    what = ("extrinsic mode 2: no q_ic" if ex
            else "time offset: the profile's q_ic, estimate_td, the IMU stamps 4 ms late")
    log(f"calibration cold start ({what}): SlamSystem on the EuRoC profile's values, "
        f"estimate_extrinsic "
        f"{sysm.vio.estimate_extrinsic}, estimate_td {sysm.vio.estimate_td}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for k in all_kernels():
        k.launches = 0
    TWIN_CALLS.clear()
    LOOP_TWIN_CALLS.clear()
    state = dict(i=0)
    outs, rows, conv_frame, init_frame = [], [], None, None
    j, n_total = 0, C9["imgs"].shape[0]
    while j < n_total and (init_frame is None or j <= init_frame + N_CALIB_TRACK):
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                while state["i"] < len(imu_t) and imu_t[state["i"]] <= frame_t[j] + shift + 1e-9:
                    sysm.add_imu(imu_t[state["i"]], accs[state["i"]], gyrs[state["i"]])
                    state["i"] += 1
                out = sysm.add_image(frame_t[j], C9["imgs"][j])
                sync()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        wall = time.perf_counter() - t0
        n_sync = sum("synchroniz" in str(w.message).lower() for w in caught)
        if out is not None:
            outs.append(out)
        phase = "fill" if init_frame is None else "tracked"
        if conv_frame is None and ((sysm.vio.extrinsic_ok if ex else sysm.vio._td_solved)):
            conv_frame = j
        if init_frame is None and sysm.vio.initialized:
            init_frame, phase = j, "init"
        elif init_frame is not None and not sysm.vio.initialized:
            fail(f"phase 9 ({mode}): the VIO rebooted at frame {j}")
        rows.append((j, phase, wall, n_sync))
        if init_frame is None and j + 1 >= n_max:
            fail(f"phase 9 ({mode}): the VIO did not initialize within {n_max} frames "
                 f"(calibration converged: {conv_frame})")
        j += 1
    if init_frame is None:
        fail(f"phase 9 ({mode}): the stream ended before the VIO initialized")
    last = sysm.flush()
    outs += [] if last is None else [last]
    sync()
    if on_card:
        estimator_check(False, f"phase 9 ({mode})")
        loop_twin_check(f"phase 9 ({mode})")
    launches = {k.name: k.launches for k in all_kernels()}
    fill = [r for r in rows if r[1] == "fill"]
    tracked = [r for r in rows if r[1] == "tracked"]
    med = lambda rr, i: float(np.median([r[i] for r in rr])) if rr else float("nan")
    ms_fill, ms_track = 1e3 * med(fill, 2), 1e3 * med(tracked, 2)
    sync_fill = float(np.mean([r[3] for r in fill])) if fill else float("nan")
    sync_track = float(np.mean([r[3] for r in tracked])) if tracked else float("nan")
    init_s = [r[2] for r in rows if r[1] == "init"][0]
    ts = np.array([o.t for o in outs])
    idx = np.searchsorted(frame_t, ts - 1e-6)
    p_est = np.stack([o.p_vio for o in outs])
    ate = ate_rmse(p_est, C9["p_gt"][idx], align=True)
    cal_launches = {k.name: launches[k.name] for k in calib_kernels()}
    res = dict(conv_frame=conv_frame, init_frame=init_frame, ms_fill=ms_fill,
               ms_track=ms_track, syncs_fill=sync_fill, syncs_track=sync_track, ate=ate,
               init_s=init_s, launches=launches, calib_launches=cal_launches,
               n_out=len(outs), n_fill=len(fill), n_tracked=len(tracked))
    if ex:
        q_err = geo.quat_mul(geo.quat_conj(sysm.vio.state.q_ic.double().cpu()),
                             C9["q_ic"].double().cpu())
        res["q_err_deg"] = math.degrees(2.0 * math.acos(min(1.0, abs(float(q_err[0])))))
        calib_text = (f"extrinsic_ok {sysm.vio.extrinsic_ok} at frame {conv_frame} (pairs "
                      f"{int(sysm.vio._ex_acc.count)}), q_ic {res['q_err_deg']:.3f} deg from "
                      f"the profile's R_BC (bar 3)")
    else:
        res["td"] = sysm.vio.td
        calib_text = (f"td solved {sysm.vio._td_solved} at frame {conv_frame}: td "
                      f"{1e3 * sysm.vio.td:.4f} ms (truth {1e3 * TD_TRUE:.1f}, bar 2 ms)")
    log(f"  {calib_text}; initialized at frame {init_frame} (bar {n_max}), the initializing "
        f"call {init_s:.2f} s; ATE (aligned) {ate:.4f} m over {len(outs)} outputs (bar 0.15)")
    log(f"  ms a frame (wall, median): fill {ms_fill:.2f} over {len(fill)} frames, tracked "
        f"{ms_track:.2f} over {len(tracked)}; host syncs a frame: fill {sync_fill:.2f}, tracked "
        f"{sync_track:.2f}; K22-K24 launches {cal_launches}")
    if not (sysm.vio.extrinsic_ok if ex else sysm.vio._td_solved):
        fail(f"phase 9 ({mode}): the calibration never converged")
    if ex and not res["q_err_deg"] < 3.0:
        fail(f"phase 9 (extrinsic): q_ic {res['q_err_deg']:.3f} deg from the truth >= 3")
    if not ex:
        # not a bar here: on rendered frames the reference's yaw-curve ICP
        # does not resolve 4 ms (PERF.md section 6, ROADMAP C); the solve is held
        # to K23's twin on its accumulator (calib_calls_check), and td's
        # bar to the truth is phase 9 (c)'s, on the wiring test's stream
        log(f"  |td - truth| {1e3 * abs(sysm.vio.td - TD_TRUE):.4f} ms (the reference's bar "
            f"of 2 ms is held in phase 9 (c))")
        if not math.isfinite(sysm.vio.td):
            fail("phase 9 (td): td is not finite")
    if not np.all(np.isfinite(p_est)) or not ate < 0.15:
        fail(f"phase 9 ({mode}): ATE {ate:.4f} m >= 0.15 m or a non-finite pose")
    from vplines_slam_tpu_torch.models.calibration import GYRO_YAW, HAND_EYE, TIME_OFFSET
    from vplines_slam_tpu_torch.ops.mvg import RANSAC_ESSENTIAL

    need = [RANSAC_ESSENTIAL] + ([HAND_EYE] if ex else [GYRO_YAW, TIME_OFFSET])
    if on_card and any(launches[k.name] == 0 for k in need):
        fail(f"phase 9 ({mode}): a kernel of the calibration path never launched: {launches}")
    return res


def calib_ray_stream(dev, duration, shift=0.0, M=96, seed=0):
    """tests/test_online_calib_wiring.py's drive stream, made on dev: 10 Hz
    frames of the default figure-8 seen by a camera mounted with R_BC_INWARD
    at P_IC_RAYS, ids and noise-free rays of the first M - 8 of 400 landmarks
    in view, and 200 Hz IMU whose samples carrying the motion of true time
    tau are stamped tau + shift."""
    import torch

    from vplines_slam_tpu_torch.utils import geometry as geo
    from vplines_slam_tpu_torch.utils import synthetic as syn

    f64 = torch.float64
    traj = syn.figure8_trajectory()
    X = syn.scatter_landmarks(400, seed=seed, device=dev)
    frame_t = np.arange(0.0, duration, 0.1)
    imu_true = np.arange(-shift if shift < 0 else 0.0, duration + 1e-9, 0.005)
    accs, gyrs = syn.imu_samples(traj, torch.tensor(imu_true, dtype=f64, device=dev))
    p_wb, q_wb, _ = syn.ground_truth_states(traj, torch.tensor(frame_t, dtype=f64, device=dev))
    q_ic = geo.rot_to_quat(torch.tensor(R_BC_INWARD, dtype=f64, device=dev))
    p_ic = torch.tensor(P_IC_RAYS, dtype=f64, device=dev)
    q_wc, p_wc = geo.pose_compose(q_wb, p_wb, q_ic, p_ic)
    q_cw, p_cw = geo.pose_inverse(q_wc, p_wc)
    Xc = geo.transform_point(q_cw[:, None], p_cw[:, None], X[None])  # [F, 400, 3]
    uv = (Xc[..., :2] / Xc[..., 2:3]).cpu().numpy()
    vis = ((Xc[..., 2] > 0.3).cpu().numpy() & (np.abs(uv[..., 0]) < 0.82)
           & (np.abs(uv[..., 1]) < 0.55))
    frames = []
    for k in range(len(frame_t)):
        sel = np.flatnonzero(vis[k])[: M - 8]
        ids = np.full(M, -1, np.int64)
        rays = np.zeros((M, 3))
        rays[:, 2] = 1.0
        ids[: len(sel)] = sel
        rays[: len(sel), :2] = uv[k, sel]
        frames.append((ids, rays))
    return dict(frame_t=frame_t, imu_t=imu_true + shift, accs=accs.cpu().numpy(),
                gyrs=gyrs.cpu().numpy(), frames=frames, p_gt=p_wb.cpu().numpy(), q_ic=q_ic,
                p_ic=p_ic)


def phase_calibration_rays(dev, mode):
    """Phase 9 (c), one run: the port's VioEngine on the card (f64, the
    wiring test's WindowConfig) fed tests/test_online_calib_wiring.py's
    stream with that test's bars: mode "extrinsic" (no q_ic, 7 s: extrinsic_ok,
    q_ic within 3 degrees, initialized, ATE < 0.15 m) or "td" (the mount's
    q_ic, estimate_td, the IMU stamped 4 ms late, 9 s: td solved within 2
    ms, initialized, ATE < 0.15 m)."""
    import torch

    from vplines_slam_tpu_torch.estimator.vio import VioEngine
    from vplines_slam_tpu_torch.estimator.window import WindowConfig
    from vplines_slam_tpu_torch.kernels import TWIN_CALLS as LOOP_TWIN_CALLS
    from vplines_slam_tpu_torch.kernels import all_kernels
    from vplines_slam_tpu_torch.models import imu as imu_mod
    from vplines_slam_tpu_torch.models.calibration import GYRO_YAW, HAND_EYE, TIME_OFFSET
    from vplines_slam_tpu_torch.ops.mvg import RANSAC_ESSENTIAL
    from vplines_slam_tpu_torch.solver.lm import TWIN_CALLS
    from vplines_slam_tpu_torch.utils import geometry as geo
    from vplines_slam_tpu_torch.utils.evaluation import ate_rmse

    ex = mode == "extrinsic"
    shift = 0.0 if ex else TD_TRUE
    R = calib_ray_stream(dev, 7.0 if ex else 9.0, shift=shift)
    cfg = WindowConfig(max_points=96, max_lines=8, max_imu=32)
    kw = (dict(q_ic=None, p_ic=None) if ex
          else dict(q_ic=R["q_ic"], p_ic=R["p_ic"], estimate_td=True))
    eng = VioEngine(cfg, imu_mod.default_params(device=dev), device=dev, **kw)
    for k in all_kernels():
        k.launches = 0
    TWIN_CALLS.clear()
    LOOP_TWIN_CALLS.clear()
    frame_t, imu_t, accs, gyrs = R["frame_t"], R["imu_t"], R["accs"], R["gyrs"]
    i, est_k, est_p, conv_frame, init_frame = 0, [], [], None, None
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for k, ft in enumerate(frame_t):
        while i < len(imu_t) and imu_t[i] <= ft + shift + 1e-9:
            eng.add_imu(imu_t[i], accs[i], gyrs[i])
            i += 1
        out = eng.add_frame(ft, *R["frames"][k])
        if conv_frame is None and (eng.extrinsic_ok if ex else eng._td_solved):
            conv_frame = k
        if init_frame is None and eng.initialized:
            init_frame = k
        if out is not None and eng.initialized:
            est_k.append(k)
            est_p.append(np.asarray(out.p))
    sync()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in all_kernels() if k in calib_kernels()}
    if dev.type == "cuda":
        estimator_check(False, f"phase 9 (c, {mode})")
        loop_twin_check(f"phase 9 (c, {mode})")
        need = [RANSAC_ESSENTIAL] + ([HAND_EYE] if ex else [GYRO_YAW, TIME_OFFSET])
        if any(k.launches == 0 for k in need):
            fail(f"phase 9 (c, {mode}): a kernel of the calibration path never launched")
    ate = ate_rmse(np.stack(est_p), R["p_gt"][est_k], align=True) if est_p else float("nan")
    if ex:
        q_err = geo.quat_mul(geo.quat_conj(eng.state.q_ic.double().cpu()),
                             R["q_ic"].double().cpu())
        err = math.degrees(2.0 * math.acos(min(1.0, abs(float(q_err[0])))))
        calib_text, calib_ok = f"q_ic {err:.3f} deg from R_BC (bar 3)", err < 3.0
    else:
        err = abs(eng.td - TD_TRUE)
        calib_text = f"td {1e3 * eng.td:.4f} ms (truth {1e3 * TD_TRUE:.1f}, bar 2 ms)"
        calib_ok = err < 0.002
    log(f"calibration on the wiring test's ray stream ({mode}): VioEngine f64, "
        f"{len(frame_t)} frames in {wall:.2f} s; converged at frame {conv_frame}, {calib_text}; "
        f"initialized at frame {init_frame}; ATE (aligned) {ate:.4f} m over {len(est_p)} "
        f"outputs (bar 0.15); K22-K24 launches {launches}")
    if conv_frame is None or init_frame is None or not calib_ok:
        fail(f"phase 9 (c, {mode}): the calibration or the initialization missed its bar")
    if not np.all(np.isfinite(est_p)) or not ate < 0.15:
        fail(f"phase 9 (c, {mode}): ATE {ate:.4f} m >= 0.15 m or a non-finite pose")
    return dict(conv_frame=conv_frame, init_frame=init_frame, err=err, ate=ate,
                launches=launches, wall_s=wall)


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


def phase_imu_witness(S, SL, sl, ll, t_start):
    """Phases 4-5 again with K10's plain twin (f32, on the card) in place of
    the kernel: how far the preintegration's rounding alone moves the
    slices' ATE (printed beside the kernels')."""
    for label, run, first in (("points slice", lambda: phase_slice(S, imu_twin=True)[1], sl),
                              ("lines slice", lambda: phase_lines(SL, imu_twin=True)[1], ll)):
        log(f"[{time.perf_counter() - t_start:.0f} s] IMU witness: {label}, K10's plain twin")
        tw = run()
        log(f"  witness: {label} ATE with K10 {first['ate']:.4f} m, with its plain twin "
            f"{tw['ate']:.4f} m (|diff| {abs(tw['ate'] - first['ate']):.4f} m)")


def phase_klt_witness(S, SL, sl, ll, t_start):
    """Phases 4-5 again with K2's plain twin (``track_plain`` on the card) in
    place of the kernel: how far K2's rounding alone moves the slices' ATE
    (printed beside the kernel's)."""
    for label, run, first in (("points slice", lambda: phase_slice(S, klt_twin=True)[1], sl),
                              ("lines slice", lambda: phase_lines(SL, klt_twin=True)[1], ll)):
        log(f"[{time.perf_counter() - t_start:.0f} s] KLT witness: {label}, K2's plain twin")
        tw = run()
        log(f"  witness: {label} ATE with K2 {first['ate']:.4f} m, with its plain twin "
            f"{tw['ate']:.4f} m (|diff| {abs(tw['ate'] - first['ate']):.4f} m)")


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
    global AGAINST
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
    ap.add_argument("--imu-witness", action="store_true",
                    help="after phase 8, run phases 4-5 again with K10's plain twin in place "
                         "of the kernel (the ATE that the preintegration's rounding alone "
                         "moves)")
    ap.add_argument("--klt-witness", action="store_true",
                    help="after phase 8, run phases 4-5 again with K2's plain twin "
                         "(track_plain) in place of the kernel (the ATE that K2's rounding "
                         "alone moves)")
    ap.add_argument("--against", "--vp-grid-against", dest="against", metavar="TREE",
                    help="another checkout (e.g. the parent commit unpacked with git "
                         "archive): build its K1, K8 (vp_grid, vp_score), K2, K9, K6, K7, K3, "
                         "K15, K16, K17, K18, K19, K20's selector_info and K21 and run them on "
                         "this tree's inputs in this process: "
                         "K1 to "
                         "the bit on phase 3's frames and every track call of phases 4-6, "
                         "vp_grid and vp_score to the bit on phase 3's inputs and every lines "
                         "frame of phases 5-6, K9 to the bit on every clahe call of phase 6, "
                         "K6 (fields, best cells, walks, detect_lines) and K7 to the bit on "
                         "phase 3's frames and cases and every lines frame of phases 5-6, K3 "
                         "(detect) to the bit on phase 3's calls and cases and every detect "
                         "call of phases 4-6 and 8, K16 to the bit on phase 3's keyframe and "
                         "cases and every keyframe of phases 6-8, K15 (detect_fast, the score "
                         "map) to the bit on phase 3's frame and cases and every keyframe of "
                         "phases 6-8, selector_info to the bit on phase 3's candidates and "
                         "cases and every call of phase 8, K19 to the bit on phase 3's "
                         "database, the PGO cases, K = 1,024 and every PGO iteration of phase "
                         "7, K18's counts and inliers on every hypothesis whose pose is "
                         "determined and its chosen hypothesis where both choices are, on "
                         "phase 3's input and every verification of phase 7 (the counts also "
                         "on the PnP cases), K17's match to the bit on phase 3's input, the "
                         "match cases and every verification of phase 7, K21 on phase 3's "
                         "batches, the PnP refinement cases (its f64 gap logged) and every "
                         "verification of phase 7 (1e-5), each timed beside this tree's, and "
                         "one verification's launches and device time with both")
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
    if args.against:
        AGAINST = OtherTree(args.against)
    from vplines_slam_tpu_torch.estimator.window import WindowConfig

    nf = WindowConfig().nf
    t0 = time.perf_counter()
    S = stage(dev, nf - 1 + N_STEADY + N_SYNC)
    SL = stage(dev, nf - 1 + N_STEADY_LINES + N_SYNC, world=LINE_WORLD, t0=LINE_T0)
    S5 = stage(dev, nf - 1 + N_STEADY_LINES + N_SYNC, world=LINES_ROOM, t0=LINES_T0)
    n_cold = N_INIT_MAX + N_TRACK + 1 + N_SYNC * (2 if args.profile else 1)
    C = None if args.kernels_only else stage_cold(dev, n_cold, world=LINE_WORLD)
    C9 = (None if args.kernels_only
          else stage_cold(dev, N_CALIB_TD + N_CALIB_TRACK + 1, world=LINE_WORLD,
                           ypr_amp=CALIB_YPR_AMP))
    torch.cuda.synchronize()
    log(f"staged {S['imgs'].shape[0]} + {SL['imgs'].shape[0]} + {S5['imgs'].shape[0]} + "
        f"{0 if C is None else C['imgs'].shape[0]} + {0 if C9 is None else C9['imgs'].shape[0]} "
        f"frames {W}x{H} + IMU in {time.perf_counter() - t0:.2f} s")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 3: kernels against their plain twins")
    rec = phase_kernels(S, SL)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 3, loop closure: K15-K19")
    phase_loop_kernels(rec, S)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 3, the selector and PnP refinement: "
        f"K20-K21")
    phase_selector_kernels(rec, S)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 3, online calibration: K22-K24")
    phase_calib_kernels(rec, dev)
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
    with (recording_klt([]) as klt4, recording_pyramids([]) as pyr4,
          recording_detect([]) as det4, recording_ransac([]) as ra4):
        launches4, sl, prof_points = phase_slice(S)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 5: lines slice")
    with (recording_vp([]) as vp5, recording_klt([]) as klt5, recording_pyramids([]) as pyr5,
          recording_lines({"detect": [], "vote": []}) as ln5, recording_detect([]) as det5,
          recording_ransac([]) as ra5):
        launches5, ll, prof_lines = phase_lines(S5)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 6: cold start")
    with (recording_vp([]) as vp6, recording_clahe([]) as cl6, recording_pyramids([]) as pyr6,
          recording_lines({"detect": [], "vote": []}) as ln6, recording_detect([]) as det6,
          recording_brief([]) as br6, recording_fast([]) as fa6, recording_ransac([]) as ra6):
        launches, cs = phase_cold_start(C, profile=args.profile)
    for where, counted, pyrs in (("phase 4", launches4, pyr4), ("phase 5", launches5, pyr5),
                                 ("phase 6", launches, pyr6)):
        one_pyramid_launch_a_track(counted, where)
        pyramid_frames_check(rec, pyrs, where)
    klt_frames_check(klt4, "phase 4")
    klt_frames_check(klt5, "phase 5")
    vp_frames_check(rec, vp5, "phase 5")
    vp_frames_check(rec, vp6, "phase 6")
    line_frames_check(rec, ln5, "phase 5")
    line_frames_check(rec, ln6, "phase 6")
    clahe_frames_check(rec, cl6, "phase 6")
    for where, store in (("phase 4", det4), ("phase 5", det5), ("phase 6", det6)):
        detect_frames_check(rec, store, where)
    brief_frames_check(rec, br6, "phase 6")
    fast_frames_check(rec, fa6, "phase 6")
    for where, store in (("phase 4", ra4), ("phase 5", ra5), ("phase 6", ra6)):
        ransac_frames_check(rec, store, where)
    del det4, det5, det6, br6, fa6, ra4, ra5, ra6
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 7: the loop-closure circuit")
    with (recording_brief([]) as br7, recording_fast([]) as fa7,
          recording_loop({"pgo": [], "pnp": [], "match": [], "refine": []}) as lp7):
        loop_launches, lc = phase_loop_circuit(dev)
    brief_frames_check(rec, br7, "phase 7")
    fast_frames_check(rec, fa7, "phase 7")
    loop_calls_check(rec, lp7, "phase 7")
    loop_verification_check(rec, lp7, "phase 7")
    del br7, fa7, lp7
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 8: the selector cold start")
    from vplines_slam_tpu_torch.utils.config import load_profile

    sel_cfg = load_profile(str(ROOT / "configs" / "euroc.yaml"), dtype=torch.float32,
                           device=dev).selector
    with (recording_detect([]) as det8, recording_brief([]) as br8, recording_fast([]) as fa8,
          recording_info([]) as in8, recording_ransac([]) as ra8):
        launches8, s8 = phase_cold_start(C, selector=sel_cfg)
    detect_frames_check(rec, det8, "phase 8")
    brief_frames_check(rec, br8, "phase 8")
    fast_frames_check(rec, fa8, "phase 8")
    selector_info_frames_check(rec, in8, "phase 8")
    ransac_frames_check(rec, ra8, "phase 8")
    del det8, br8, fa8, in8, ra8
    sel_launches = {k.name: launches8[k.name] for k in selector_kernels()}
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 9: calibration cold start")
    with recording_calib({}) as st9a:
        r9a = phase_calibration(C9, "extrinsic")
    calib_calls_check(rec, st9a, "phase 9 (a)")
    with recording_calib({}) as st9b:
        r9b = phase_calibration(C9, "td")
    calib_calls_check(rec, st9b, "phase 9 (b)")
    del st9a, st9b, C9
    calib_launches = {k.name: r9a["launches"][k.name] + r9b["launches"][k.name]
                      for k in calib_kernels()}
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 9 (c): the wiring test's ray stream")
    r9c = {mode: phase_calibration_rays(dev, mode) for mode in ("extrinsic", "td")}
    if args.cold_witness:
        log(f"[{time.perf_counter() - t_start:.0f} s] phase 6 witness runs")
        phase_cold_witness(C)
    if args.estimator_witness:
        phase_estimator_witness(S, S5, C, sl, ll, cs, t_start)
    if args.imu_witness:
        phase_imu_witness(S, S5, sl, ll, t_start)
    if args.klt_witness:
        phase_klt_witness(S, S5, sl, ll, t_start)
    # profiler sessions last: they slow every later launch of the process
    log(f"[{time.perf_counter() - t_start:.0f} s] kernel device times (torch.profiler)")
    device_times(rec)
    if lc["probe"] is not None:
        count_launches(lc["probe"], 3, "phase 7, one loop verification", table=args.profile)
        if AGAINST is not None:
            def probe_other():
                with AGAINST.verification():
                    return lc["probe"]()

            count_launches(probe_other, 3, "the other tree's K17 match and K21 in the same "
                                           "verification")
    count_launches(s8["selector_probe"], 3, "phase 8, one selector call (_select_impl)",
                   table=args.profile)
    if AGAINST is not None:
        def selector_other():
            with AGAINST.selector():
                return s8["selector_probe"]()

        count_launches(selector_other, 3, "the other tree's selector_info in the same selector "
                                          "call")
    for key, label, other_label in (
            ("detect", "one detect call (phase 3's frame 1 with its tracks)",
             "detect, the same call"),
            ("extract", "one extract_keyframe_features call (phase 3's frame 0, 500 corners, "
                        "64 window points)", "K15 and K16 in the same extraction"),
            ("ransac", "one ransac_essential call with the tracker's gate (phase 3's frame, "
                       "32 x 150)", "whole ransac_essential with the gate, the same call"),
            ("ransac_init", "one ransac_essential call at the initializer's 64 x 128",
             "whole ransac_essential, the same call")):
        this, other = PROBES[key]
        count_launches(this, 3, label, table=args.profile)
        if other is not None:
            count_launches(other, 3, "the other tree's " + other_label)
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

    # launches: K1-K14 from the cold-start run (phase 6), K15-K19 and K21 from
    # the loop-closure circuit (phase 7), K20 from the selector cold start
    # (phase 8), K22-K24 from both runs of the calibration cold start (phase
    # 9): the paths that drive them
    kernels_json = []
    for k in all_kernels():
        short = k.name.removeprefix("vp_")
        r = rec[short]
        kernels_json.append(dict(
            name=short, route="cuda", source=k.source, replaces=k.replaces,
            launches=calib_launches.get(k.name, sel_launches.get(
                k.name, loop_launches.get(k.name, launches[k.name]))),
            max_abs_err=r["err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], device_ms=r["device_ms"],
            library_device_ms=r["library_device_ms"],
            device_split=r["device_split"],
            **{k: r[k] for k in ("solve_ms", "solve_device_ms", "solve_bound_ms", "bound_45_ms",
                                 "bound_1024_ms", "extra_device_ms", "other_ms",
                                 "whole_bound_ms", "bound_1000_ms", "init_ms", "init_plain_ms",
                                 "init_bound_ms", "init_library_ms", "other_init_ms")
               if k in r}))
    log(f"summary (points): {sl['ms_frame']:.2f} ms/frame, front end {sl['fe_ms']:.2f} ms, "
        f"track_step {sl['be_ms']:.2f} ms, {sl['syncs']:.1f} host syncs/frame, "
        f"ATE {sl['ate']:.4f} m")
    log(f"summary (lines): {ll['ms_frame']:.2f} ms/frame, point front end {ll['fe_ms']:.2f} ms, "
        f"remap + line tracker {ll['ln_ms']:.2f} ms, track_step {ll['be_ms']:.2f} ms, "
        f"{ll['syncs']:.1f} host syncs/frame, ATE {ll['ate']:.4f} m, {ll['solved']} solved "
        f"lines ({ll['fresh_solved']} first seen after the warm-up), {ll['vp_live']} VP-valid "
        f"observations")
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
    sp8 = s8["split"]
    log(f"summary (selector cold start): initialized at frame {s8['init_frame']}, "
        f"{s8['ms_frame']:.2f} ms/frame over {s8['n_tracked']} tracked frames, selector stage "
        f"median {sp8['selector']:.3f} ms, VIO {sp8['vio']:.2f} ms; {s8['syncs']:.1f} host "
        f"syncs/frame; ATE {s8['ate']:.4f} m (scale truth/estimate {s8['scale']:.4f}); K20 "
        f"launches {sel_launches}")
    for label, r in (("(a) extrinsic mode 2", r9a), ("(b) time offset", r9b)):
        calib = (f"q_ic {r['q_err_deg']:.3f} deg from the truth" if "q_err_deg" in r
                 else f"td {1e3 * r['td']:.4f} ms")
        log(f"summary (calibration cold start {label}): converged at frame {r['conv_frame']}, "
            f"{calib}, initialized at frame {r['init_frame']}, ATE {r['ate']:.4f} m; ms a "
            f"frame fill {r['ms_fill']:.2f} / tracked {r['ms_track']:.2f}; host syncs a frame "
            f"fill {r['syncs_fill']:.2f} / tracked {r['syncs_track']:.2f}; K22-K24 launches "
            f"{r['calib_launches']}")
    for mode, r in r9c.items():
        err = (f"q_ic {r['err']:.3f} deg" if mode == "extrinsic"
               else f"|td - truth| {1e3 * r['err']:.4f} ms")
        log(f"summary (calibration on the wiring test's ray stream, {mode}): converged at "
            f"frame {r['conv_frame']}, {err}, initialized at frame {r['init_frame']}, ATE "
            f"{r['ate']:.4f} m, {r['wall_s']:.2f} s; K22-K24 launches {r['launches']}")
    log(smi)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
