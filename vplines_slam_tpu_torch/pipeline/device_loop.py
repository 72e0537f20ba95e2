"""The steady-state frame loop: point front-end (+ line front-end) + VIO step
over staged frames.

Port of ``vplines_slam_tpu/pipeline/device_loop.py``.  The reference's jitted
``lax.scan`` is a Python loop over frames; every tensor stays on the device
of the carry, and the outputs are stacked once at the end.  The VIO must
already be initialized (a carry from the reference converted with
``convert.py``, or the truth-seeded warm-up in ``utils/demo.py``).

  loop = make_device_loop(cam, tracker_cfg, window_cfg, params
                          [, line_cfg=..., map_xy=camera.undistort_rectify_map(cam)])
  carry = loop.init_carry(fe_state, vio_state, vio_data[, ln_state])
  carry, (p, q, v, is_kf, failure, ba_cost) = loop.run(
      carry, imgs [T,H,W], imu_batches, dts [T], ransac_idx [T, hyps, 8]
      [, vp_u [T, n_pairs, 2]])

With lines, each frame is also undistorted (``ops.image.remap_static``) and
run through ``models.line_tracker.step``, whose lines enter the estimator.
The random draws are inputs: the RANSAC samples and the uniforms of the VP
pair draw.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..estimator import vio as vio_mod
from ..models import camera as cam_mod
from ..models import feature_tracker as ft_mod
from ..models import imu as imu_mod
from ..models import line_tracker as lt_mod
from ..ops.image import build_remap_plan, remap_static


class DeviceLoop(NamedTuple):
    run: object  # (carry, imgs, imu_batches, dts, ransac_idx[, vp_u, stage_events])
    init_carry: object


def make_device_loop(cam: cam_mod.CameraModel, tracker_cfg: ft_mod.TrackerConfig,
                     window_cfg, params: imu_mod.ImuParams,
                     line_cfg: Optional[lt_mod.LineTrackerConfig] = None, map_xy=None):
    """Build the frame loop; line_cfg turns the line front-end on and then
    needs map_xy, the undistort-rectify map of the camera."""
    use_lines = line_cfg is not None
    if use_lines:
        dtype, dev = cam.fx.dtype, cam.fx.device
        ideal = cam_mod.pinhole(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                                width=cam.width, height=cam.height, dtype=dtype, device=dev)
        remap_plan = build_remap_plan(map_xy, dtype=dtype, device=dev)

    def frame_step(carry, img, imu_batch, dt, ransac_idx, vp_u, events):
        mark = (lambda k: events[k].record()) if events is not None else (lambda k: None)
        if use_lines:
            fe_state, ln_state, state, data = carry
        else:
            fe_state, state, data = carry
        mark(0)
        fe_state, feats = ft_mod.step(fe_state, img, cam, tracker_cfg, dt, ransac_idx)
        mark(1)
        ln_args = ()
        if use_lines:
            ln_state, lout = lt_mod.step(ln_state, remap_static(img, remap_plan), ideal,
                                         line_cfg, vp_u)
            ln_args = (lout.ids, lout.endpoints, lout.vp_dirs, lout.vp_valid)
            mark(2)
        state, data, out = vio_mod.track_step(
            state, data, feats.ids, feats.rays, imu_batch, window_cfg, params,
            ln_args=ln_args, use_lines=use_lines)
        mark(-1)
        emit = (out.p, out.q, out.v, out.is_keyframe, out.failure, out.ba_cost)
        carry = (fe_state, ln_state, state, data) if use_lines else (fe_state, state, data)
        return carry, emit

    def run(carry, imgs, imu_batches, dts, ransac_idx, vp_u=None, stage_events=None):
        """imgs [T,H,W]; imu_batches: tuple of [T, ...] tensors (dts, accs,
        gyrs, mask, has_imu); dts [T]; ransac_idx [T, ransac_hyps, 8] long;
        vp_u [T, n_pairs, 2] (lines only).  stage_events: optional list that
        receives, per frame, CUDA events at the frame's start, after the
        point front end, (with lines) after the line front end, and at its
        end."""
        if use_lines and vp_u is None:
            raise ValueError("the line front-end needs vp_u, the VP pair-draw uniforms")
        emits = []
        for t in range(imgs.shape[0]):
            events = None
            if stage_events is not None:
                events = [torch.cuda.Event(enable_timing=True) for _ in range(4 if use_lines else 3)]
                stage_events.append(events)
            batch = tuple(b[t] for b in imu_batches)
            carry, emit = frame_step(carry, imgs[t], batch, dts[t], ransac_idx[t],
                                     vp_u[t] if use_lines else None, events)
            emits.append(emit)
        outs = tuple(torch.stack(xs) for xs in zip(*emits))
        return carry, outs

    def init_carry(fe_state, vio_state, vio_data, ln_state=None):
        if use_lines:
            return (fe_state, ln_state, vio_state, vio_data)
        return (fe_state, vio_state, vio_data)

    return DeviceLoop(run=run, init_carry=init_carry)
