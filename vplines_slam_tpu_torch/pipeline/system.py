"""The SLAM system's entry point: images and IMU in, VIO poses out.

Port of ``vplines_slam_tpu/pipeline/system.py`` (``SystemOutput`` and
``SlamSystem``: ``add_imu``, ``add_image``, ``_drain_pending``, ``flush``,
``new_sequence``, ``_finish_frame``) without loop closure, GNSS fusion, the
feature selector, introspection and the K-frame batched fetch
(``fetch_every > 1``): the constructor raises when asked for any of them,
or given their configuration (``pg_cfg``, ``selector_cfg``,
``introspect_dir``).  Loop closure defaults to on, as in the reference, so
it must be turned off by name.  Without it the drift correction stays the
identity, so ``p_corrected``/``q_corrected`` are the VIO pose.

  sys = SlamSystem(cam, window_cfg, tracker_cfg, line_cfg, imu_params=...,
                   q_ic=..., p_ic=..., use_loop_closure=False)  # loop closure: not ported
  sys.add_imu(t, acc, gyr)          # every IMU sample, in time order
  out = sys.add_image(t, img)       # [H, W] in [0, 1]; the previous frame's output
  last = sys.flush()                # the tail at stream end

Pipelining (``fetch_every=1``): once the VIO is initialized, ``add_image``
enqueues the frame's device work and returns the previous frame's output,
fetched in one transfer before this frame's work is enqueued.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..estimator.vio import VioEngine, unpack_output
from ..estimator.window import WindowConfig
from ..models import camera as cam_mod
from ..models import imu as imu_mod
from ..models.feature_tracker import FeatureTrackerFrontend, TrackerConfig
from ..models.line_tracker import LineTrackerConfig, LineTrackerFrontend
from ..utils.stats import SPANS, Statistics


class SystemOutput(NamedTuple):
    t: float
    p_vio: np.ndarray
    q_vio: np.ndarray
    p_corrected: np.ndarray  # after drift correction (the identity here)
    q_corrected: np.ndarray
    is_keyframe: bool
    loop_closed: bool
    # host wall-clock ms per stage of the producing add_image call
    # (frontend / line_frontend / vio_dispatch / fetch_finish)
    timings: Optional[dict] = None
    ba_cost: float = float("nan")


class SlamSystem:
    """Monocular visual-inertial odometry with optional lines and VPs."""

    def __init__(self, cam: cam_mod.CameraModel, window_cfg: WindowConfig = WindowConfig(),
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 line_cfg: Optional[LineTrackerConfig] = None, pg_cfg=None, fusion_cfg=None,
                 imu_params: Optional[imu_mod.ImuParams] = None, q_ic=None, p_ic=None,
                 use_loop_closure: bool = True, stream_gap_restart: float = 1.0,
                 use_feature_selector: bool = False, selector_cfg=None,
                 estimate_extrinsic=None, estimate_td: bool = False,
                 print_stats_every: int = 0, introspect_every: int = 0,
                 introspect_dir: Optional[str] = None, fetch_every: int = 1, mesh=None,
                 dtype=torch.float32, device=torch.device("cuda")):
        unported = {
            "loop closure (use_loop_closure=True, the default)": use_loop_closure,
            "the pose graph (pg_cfg)": pg_cfg is not None,
            "GNSS fusion (fusion_cfg)": fusion_cfg is not None,
            "the feature selector (use_feature_selector=True)": use_feature_selector,
            "the feature selector (selector_cfg)": selector_cfg is not None,
            "introspection (introspect_every > 0)": introspect_every,
            "introspection (introspect_dir)": introspect_dir is not None,
            "the K-frame batched fetch (fetch_every > 1)": fetch_every > 1,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"not ported: {', '.join(asked)}")
        self.cam = cam
        self.dtype = dtype
        self.device = torch.device(device)
        self.frontend = FeatureTrackerFrontend(cam, tracker_cfg, dtype=dtype, device=self.device)
        self.line_frontend = (LineTrackerFrontend(cam, line_cfg, dtype=dtype, device=self.device)
                              if line_cfg else None)
        self.vio = VioEngine(window_cfg, imu_params or imu_mod.default_params(dtype, self.device),
                             q_ic=q_ic, p_ic=p_ic, dtype=dtype, use_lines=line_cfg is not None,
                             estimate_extrinsic=estimate_extrinsic, estimate_td=estimate_td,
                             mesh=mesh, device=self.device)
        self._gap_restart = stream_gap_restart
        self._last_img_t = None
        self._pending: list = []  # dispatched frames whose output is still on the device
        self.stats = Statistics(print_every=print_stats_every)

    # ------------------------------------------------------------------ API
    def add_imu(self, t, acc, gyr):
        self.vio.add_imu(t, acc, gyr)

    def new_sequence(self):
        """Restart after a stream discontinuity: the estimator reboots in a
        fresh VIO frame."""
        self.vio.reset()
        self._pending = []

    def add_image(self, t, img):
        """Process one grayscale frame [H, W] in [0, 1].  Returns the previous
        frame's SystemOutput (or None); ``flush()`` returns the last one."""
        if self._last_img_t is not None and t - self._last_img_t > self._gap_restart:
            self.new_sequence()
        self._last_img_t = t
        img = torch.as_tensor(img).to(device=self.device, dtype=self.dtype)
        tm = self.stats.timers
        SPANS.next_frame()
        # fetch the queued frame's output before this frame's work is enqueued
        results = self._drain_pending() if self._pending else []

        with tm.time("frontend"), SPANS.span("frontend"):
            feats = self.frontend.process(t, img)
        ln_kwargs = {}
        if self.line_frontend is not None:
            with tm.time("line_frontend"), SPANS.span("line_frontend"):
                lines = self.line_frontend.process(t, img)
            ln_kwargs = dict(ln_ids=lines.ids, ln_obs=lines.endpoints, ln_vps=lines.vp_dirs,
                             ln_vp_valid=lines.vp_valid)

        if not self.vio.initialized:
            out = self.vio.add_frame(t, feats.ids, feats.rays, **ln_kwargs)
            if out is not None and self.vio.initialized:
                results.append(self._finish_frame(t, out))
            return results[0] if results else None

        with tm.time("vio_dispatch"), SPANS.span("vio"):
            out_dev = self.vio.add_frame_async(t, feats.ids, feats.rays, packed=True,
                                               **ln_kwargs)
        self._pending.append(dict(t=t, out=out_dev))
        return results[0] if results else None

    def _drain_pending(self):
        """Fetch every queued frame output in one transfer and finish each in
        order; a failure reboots the estimator and drops the later ones."""
        pending, self._pending = self._pending, []
        results = []
        with self.stats.timers.time("fetch_finish"):
            out_mat = torch.stack([p["out"] for p in pending]).cpu().numpy()
        for p, row in zip(pending, out_mat):
            out_h = unpack_output(row)
            if out_h.failure:
                self.vio.reset()
                break
            results.append(self._finish_frame(p["t"], out_h))
        return results

    def flush(self):
        """Finish the in-flight frame at stream end; returns its output or
        None."""
        results = self._drain_pending() if self._pending else []
        return results[-1] if results else None

    def _finish_frame(self, t, out):
        """Host bookkeeping of a frame whose StepOutput is on the host."""
        p_vio = np.asarray(out.p)
        q_vio = np.asarray(out.q)
        cost = float(out.ba_cost)
        self.stats.update(p_vio, bool(out.is_keyframe), False, ba_cost=cost)
        st = self.stats
        if st.print_every and st.frames % st.print_every == 0:
            st.maybe_print(p_ic=self.vio.state.p_ic.cpu(), q_ic=self.vio.state.q_ic.cpu())
        # no loop closure: the drift correction is the identity
        return SystemOutput(t=t, p_vio=p_vio, q_vio=q_vio, p_corrected=p_vio, q_corrected=q_vio,
                            is_keyframe=bool(out.is_keyframe), loop_closed=False,
                            timings=dict(st.timers.last), ba_cost=cost)
