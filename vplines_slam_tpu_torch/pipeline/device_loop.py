"""The steady-state frame loop: point front-end + VIO step over staged frames.

Port of ``vplines_slam_tpu/pipeline/device_loop.py`` with ``line_cfg=None``.
The reference's jitted ``lax.scan`` is a Python loop over frames; every
tensor stays on the device of the carry, and the outputs are stacked once at
the end.  The VIO must already be initialized (a carry from the reference
converted with ``convert.py``, or the truth-seeded warm-up in
``utils/demo.py``).

  loop = make_device_loop(cam, tracker_cfg, window_cfg, params)
  carry = loop.init_carry(fe_state, vio_state, vio_data)
  carry, (p, q, v, is_kf, failure, ba_cost) = loop.run(
      carry, imgs [T,H,W], imu_batches, dts [T], ransac_idx [T, hyps, 8])
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..estimator import vio as vio_mod
from ..models import camera as cam_mod
from ..models import feature_tracker as ft_mod
from ..models import imu as imu_mod


class DeviceLoop(NamedTuple):
    run: object  # (carry, imgs, imu_batches, dts, ransac_idx[, stage_events]) -> (carry, outs)
    init_carry: object


def make_device_loop(cam: cam_mod.CameraModel, tracker_cfg: ft_mod.TrackerConfig,
                     window_cfg, params: imu_mod.ImuParams):
    """Build the points-only frame loop."""

    def frame_step(carry, img, imu_batch, dt, ransac_idx, events=None):
        fe_state, state, data = carry
        if events is not None:
            events[0].record()
        fe_state, feats = ft_mod.step(fe_state, img, cam, tracker_cfg, dt, ransac_idx)
        if events is not None:
            events[1].record()
        state, data, out = vio_mod.track_step(
            state, data, feats.ids, feats.rays, imu_batch, window_cfg, params)
        if events is not None:
            events[2].record()
        emit = (out.p, out.q, out.v, out.is_keyframe, out.failure, out.ba_cost)
        return (fe_state, state, data), emit

    def run(carry, imgs, imu_batches, dts, ransac_idx, stage_events=None):
        """imgs [T,H,W]; imu_batches: tuple of [T, ...] tensors (dts, accs,
        gyrs, mask, has_imu); dts [T]; ransac_idx [T, ransac_hyps, 8] long.
        stage_events: optional list that receives, per frame, three CUDA
        events (start, front end done, VIO step done)."""
        emits = []
        for t in range(imgs.shape[0]):
            events = None
            if stage_events is not None:
                events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                stage_events.append(events)
            batch = tuple(b[t] for b in imu_batches)
            carry, emit = frame_step(carry, imgs[t], batch, dts[t], ransac_idx[t], events)
            emits.append(emit)
        outs = tuple(torch.stack(xs) for xs in zip(*emits))
        return carry, outs

    def init_carry(fe_state, vio_state, vio_data):
        return (fe_state, vio_state, vio_data)

    return DeviceLoop(run=run, init_carry=init_carry)
