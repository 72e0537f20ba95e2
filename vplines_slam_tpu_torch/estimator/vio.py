"""The sliding-window VIO engine: one steady-state frame (``track_step``)
and the host engine that fills the window, initializes and tracks.

Port of ``vplines_slam_tpu/estimator/vio.py``: ``StepOutput``,
``pack_output``, ``unpack_output``, ``_propagate_interval``,
``_failure_detection``, ``track_step`` (points only, or with the line
channel) and ``VioEngine`` (fill / init / track; its jitted closures are
plain methods; ``set_relo`` arms fast relocalization for loop closure;
``_online_calibration`` runs the hand-eye extrinsic rotation, mode 2, and
the time offset during the fill phase, ``estimator/online_calib``).  Not
ported, and raising when asked for: the distributed BA (``mesh=``).

The reference's ``lax.cond`` between the keyframe and non-keyframe slides is
a Python branch on one ``bool()``: one host sync per frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import native as native_mod
from ..models import imu as imu_mod
from ..utils.geometry import quat_conj, quat_mul, quat_rotate, quat_to_rot, rot_to_ypr
from . import initializer as init_mod
from . import online_calib as oc_mod
from .slide import (
    _set_row,
    ingest_frame,
    keyframe_parallax,
    marginalize_old,
    set_imu_interval,
    slide_window_new,
    repropagate_all,
    slide_window_old,
)
from .window import (
    WindowConfig,
    WindowState,
    empty_state,
    empty_tracks,
    reject_outliers,
    settle_lines,
    solve_window,
    triangulate_lines,
    triangulate_points,
)


class StepOutput(NamedTuple):
    p: torch.Tensor  # latest body position
    q: torch.Tensor  # latest body orientation
    v: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor
    is_keyframe: torch.Tensor
    failure: torch.Tensor
    ba_cost: torch.Tensor
    # fast-relocalization feedback (valid when relo_valid)
    relo_valid: torch.Tensor
    relo_rel_t: torch.Tensor
    relo_rel_q: torch.Tensor
    relo_rel_yaw: torch.Tensor


def pack_output(out: StepOutput, dtype=torch.float32):
    """Flatten a StepOutput into one [28] vector on its device (f32 unless
    dtype says otherwise), so a host caller fetches it in one transfer."""
    sc = lambda x: torch.as_tensor(x).to(dtype).reshape(-1)
    return torch.cat([
        sc(out.p), sc(out.q), sc(out.v), sc(out.ba), sc(out.bg),
        sc(out.is_keyframe), sc(out.failure), sc(out.ba_cost),
        sc(out.relo_valid), sc(out.relo_rel_t), sc(out.relo_rel_q),
        sc(out.relo_rel_yaw),
    ])


def unpack_output(vec) -> StepOutput:
    """Host-side inverse of pack_output (numpy fields)."""
    v = np.asarray(vec)
    return StepOutput(
        p=v[0:3], q=v[3:7], v=v[7:10], ba=v[10:13], bg=v[13:16],
        is_keyframe=bool(v[16] > 0.5), failure=bool(v[17] > 0.5), ba_cost=float(v[18]),
        relo_valid=bool(v[19] > 0.5), relo_rel_t=v[20:23], relo_rel_q=v[23:27],
        relo_rel_yaw=float(v[27]),
    )


def _propagate_interval(state, cfg, dts, accs, gyrs, mask, params, k_from, k_to):
    """Seed frame k_to by world-frame IMU propagation from k_from."""
    g = params.g.to(state.p.dtype)
    dts_m = dts * mask.to(state.p.dtype)
    p, q, v = state.p[k_from], state.q[k_from], state.v[k_from]
    ba, bg = state.ba[k_from], state.bg[k_from]
    for i in range(dts.shape[0]):
        p, q, v = imu_mod.midpoint_propagate(
            p, q, v, ba, bg, accs[i], gyrs[i], accs[i + 1], gyrs[i + 1], dts_m[i], g)
    return state._replace(
        p=_set_row(state.p, k_to, p), q=_set_row(state.q, k_to, q),
        v=_set_row(state.v, k_to, v), ba=_set_row(state.ba, k_to, ba),
        bg=_set_row(state.bg, k_to, bg),
    )


def _failure_detection(state_old: WindowState, state_new: WindowState):
    """estimator.cpp failureDetection:902-948 thresholds."""
    big_ba = torch.linalg.norm(state_new.ba[-1]) > 2.5
    big_bg = torch.linalg.norm(state_new.bg[-1]) > 1.0
    jump = torch.linalg.norm(state_new.p[-1] - state_old.p[-1]) > 5.0
    z_jump = torch.abs(state_new.p[-1, 2] - state_old.p[-1, 2]) > 1.0
    return big_ba | big_bg | jump | z_jump


def _relo_frame(data):
    """(window index of the frame whose stamp matches the relo keyframe's,
    whether relo is armed and that match is within 2 ms).  The stamps are
    f64: in f32, EuRoC-epoch stamps round to multiples of 128 s and tie."""
    stamp_diff = torch.abs(data.frame_t - data.relo_stamp)
    kf_idx = torch.argmin(stamp_diff)
    return kf_idx, data.relo_valid & (stamp_diff[kf_idx] < 2e-3)


def track_step(state, data, pt_ids, pt_rays, imu_batch, cfg: WindowConfig, params, t=None,
               ln_args=(), use_lines=False):
    """One steady-state frame: IMU interval ingest + propagation, feature
    ingest, keyframe test, triangulation, window BA, outlier cull, and the
    keyframe / non-keyframe slide.  imu_batch = (dts, accs, gyrs, mask,
    has_imu); ln_args = (ids, endpoints, vp_dirs, vp_valid) of the line
    tracker when use_lines.  Returns (state, data, StepOutput)."""
    nf = cfg.nf
    dts, accs, gyrs, mask, _ = imu_batch
    state0 = state
    data = set_imu_interval(data, nf - 2, dts, accs, gyrs, mask,
                            ba=state.ba[nf - 2], bg=state.bg[nf - 2], params=params)
    state = _propagate_interval(state, cfg, dts, accs, gyrs, mask, params, nf - 2, nf - 1)
    data = ingest_frame(data, cfg, nf - 1, pt_ids, pt_rays, *ln_args)
    t_new = (data.frame_t[nf - 2] + 1.0 if t is None
             else torch.as_tensor(t, dtype=data.frame_t.dtype, device=data.frame_t.device))
    data = data._replace(frame_t=_set_row(data.frame_t, nf - 1, t_new))

    is_kf, _, _ = keyframe_parallax(data, cfg, nf - 1)
    data = triangulate_points(state, data, cfg)
    if use_lines:
        # line-only Cauchy settle with poses fixed + the line culls, so fresh
        # triangulations never drag the joint solve (onlyLineOpt)
        data = triangulate_lines(state, data, cfg)
        data = settle_lines(state, data, cfg)
        data = reject_outliers(state, data, cfg, cull_points=False, use_lines=True)
    state, data, lm_out = solve_window(state, data, cfg, params, use_lines=use_lines)
    data = reject_outliers(state, data, cfg, use_lines=use_lines)
    failure = _failure_detection(state0, state)

    # fast-relocalization feedback against the window frame matching the
    # loop keyframe's stamp
    kf_idx, relo_found = _relo_frame(data)
    q_relo_inv = quat_conj(state.q_relo)
    out = StepOutput(
        p=state.p[nf - 1], q=state.q[nf - 1], v=state.v[nf - 1],
        ba=state.ba[nf - 1], bg=state.bg[nf - 1],
        is_keyframe=is_kf, failure=failure, ba_cost=lm_out.cost,
        relo_valid=relo_found,
        relo_rel_t=quat_rotate(q_relo_inv, state.p[kf_idx] - state.p_relo),
        relo_rel_q=quat_mul(q_relo_inv, state.q[kf_idx]),
        relo_rel_yaw=(rot_to_ypr(quat_to_rot(state.q[kf_idx]))[0]
                      - rot_to_ypr(quat_to_rot(state.q_relo))[0]),
    )
    if bool(is_kf):  # host sync: the reference's lax.cond
        prior = marginalize_old(state, data, cfg, params, use_lines=use_lines)
        state, data = slide_window_old(state, data, cfg, params, prior)
    else:
        state, data = slide_window_new(state, data, cfg, params)
    return state, data, out


class VioEngine:
    """Host-facing monocular point (+ line) VIO.

      eng = VioEngine(cfg, imu_params, q_ic, p_ic, device=...)
      eng.add_imu(t, acc, gyr)                 # 100-1000 Hz
      out = eng.add_frame(t, ids, rays, ...)   # camera rate

    The first cfg.nf frames fill the window; then the visual-inertial
    initializer runs on every frame until it succeeds (a failed attempt
    drops the oldest frame); then every frame is one ``track_step``.  The
    random draws (the essential-matrix RANSAC of the initializer and of the
    calibration's frame pairs) come from the engine's ``torch.Generator``
    through ``sfm_draws``.

    Online calibration (the reference's estimator.cpp:141-173 hooks): with
    no q_ic the extrinsic rotation is unknown (mode 2) and hand-eye pairs
    accumulate over the fill phase; with estimate_td the camera and IMU yaw
    curves accumulate and, from 60 camera samples, their ICP gives td, which
    then shifts the IMU alignment.  The window holds (drops its oldest
    frame) until both have converged."""

    def __init__(self, cfg: WindowConfig = WindowConfig(),
                 params: Optional[imu_mod.ImuParams] = None, q_ic=None, p_ic=None,
                 dtype=torch.float64, use_lines: bool = False, seed: int = 0,
                 estimate_extrinsic: Optional[int] = None, estimate_td: bool = False,
                 mesh=None, device=torch.device("cuda")):
        if mesh is not None:
            raise NotImplementedError("the distributed BA (mesh=) is not ported")
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.params = params or imu_mod.default_params(dtype, self.device)
        self.use_lines = use_lines
        self.state = empty_state(cfg, dtype, self.device)
        if q_ic is not None:
            t = lambda x: (x if isinstance(x, torch.Tensor) else torch.tensor(
                np.asarray(x, float))).to(device=self.device, dtype=dtype)
            self.state = self.state._replace(
                q_ic=t(q_ic), p_ic=t(p_ic if p_ic is not None else np.zeros(3)))
        self.data = empty_tracks(cfg, dtype, self.device)
        self.frame_count = 0  # frames currently in the window
        self.initialized = False
        # IMU buffering: the native synchronizer when the library loads,
        # Python lists otherwise
        self._sync = native_mod.MeasurementSync() if native_mod.available() else None
        self._bound_sample = None  # previous boundary sample (native path)
        self._imu_times: list = []
        self._imu_acc: list = []
        self._imu_gyr: list = []
        self.last_frame_time = None  # the stamp of the last frame taken
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # extrinsic mode (parameters.h ESTIMATE_EXTRINSIC): 1 = given a priori
        # and refined in BA; 2 = unknown rotation, hand-eye during the fill
        # phase gates initialization
        if estimate_extrinsic is None:
            estimate_extrinsic = 1 if q_ic is not None else 2
        self.estimate_extrinsic = estimate_extrinsic
        self.extrinsic_ok = estimate_extrinsic < 2
        # online temporal calibration: estimated once from the rotation-curve
        # ICP, then applied as the measurement-alignment shift
        self.estimate_td = estimate_td
        self.td = 0.0
        self._td_solved = False
        self._ex_acc = oc_mod.empty_extrinsic_calib(dtype=dtype, device=self.device)
        self._ex_prev = None
        self._ex_stable = 0
        self._td_acc = oc_mod.empty_td_calib(device=self.device) if estimate_td else None
        self._td_n_cam = 0  # host mirror of _td_acc.n_cam

    # ------------------------------------------------------------- draws
    def sfm_draws(self):
        """[64, 8] RANSAC sample draws in [0, max_points) of one
        initialization attempt or one calibration frame pair."""
        return torch.randint(0, self.cfg.max_points, (64, 8), generator=self._gen,
                             device=self.device)

    # ------------------------------------------------------ device stages
    def fill_step(self, frame_idx, pt_ids, pt_rays, ln_args, imu_batch, t_stamp):
        """Ingest one frame at window slot frame_idx during the fill phase,
        with its IMU interval (preintegrated at the previous frame's bias)
        and the IMU-propagated state."""
        cfg, params = self.cfg, self.params
        dts, accs, gyrs, mask, has_imu = imu_batch
        state, data = self.state, self.data
        if has_imu and frame_idx > 0:
            k = frame_idx - 1
            data = set_imu_interval(data, k, dts, accs, gyrs, mask, ba=state.ba[k],
                                    bg=state.bg[k], params=params)
            state = _propagate_interval(state, cfg, dts, accs, gyrs, mask, params, k,
                                        frame_idx)
        data = ingest_frame(data, cfg, frame_idx, pt_ids, pt_rays, *ln_args)
        data = data._replace(frame_t=_set_row(
            data.frame_t, frame_idx,
            torch.tensor(float(t_stamp), dtype=torch.float64, device=self.device)))
        self.state, self.data = state, data

    def try_init(self, state, data, sample_idx):
        """Visual-inertial initialization of the full window.  Returns
        (state, data, ok) with the aligned states, fresh triangulations and
        the intervals re-preintegrated at the estimated gyro bias."""
        cfg, params = self.cfg, self.params
        obs = data.pt_obs[:, :, 0:2]
        mask = data.pt_mask & (data.pt_id >= 0)[:, None]
        l, found = init_mod.choose_reference_frame(
            obs, mask, min_parallax=cfg.init_min_parallax, min_corres=cfg.init_min_corres)
        n = data.imu_dt.shape[0]
        z = torch.zeros(n, 3, dtype=obs.dtype, device=obs.device)
        pre = imu_mod.preintegrate(data.imu_dt, data.imu_acc, data.imu_gyr, data.imu_mask, z,
                                   z, params)
        sfm, _, _ = init_mod.window_sfm(obs, mask, l, sample_idx)
        out = init_mod.visual_inertial_align(sfm, pre, data.imu_valid, state.q_ic, state.p_ic,
                                             cfg.g_norm)
        ok = found & out.ok
        state_new = state._replace(
            p=torch.where(ok, out.p, state.p), q=torch.where(ok, out.q, state.q),
            v=torch.where(ok, out.v, state.v),
            bg=torch.where(ok, out.bg.expand(cfg.nf, 3), state.bg),
            ba=torch.where(ok, torch.zeros_like(state.ba), state.ba),
        )
        # fresh triangulation at the aligned states
        data_new = data._replace(pt_solved=torch.zeros_like(data.pt_solved))
        data_new = triangulate_points(state_new, data_new, cfg)
        return state_new, repropagate_all(data_new, state_new, params), ok

    def init_finalize(self, state, data):
        """After a successful alignment: one full BA over the window, then
        marginalize the oldest frame and slide."""
        cfg, params = self.cfg, self.params
        state, data, lm_out = solve_window(state, data, cfg, params, use_lines=self.use_lines)
        prior = marginalize_old(state, data, cfg, params, use_lines=self.use_lines)
        state, data = slide_window_old(state, data, cfg, params, prior)
        return state, data, lm_out

    def init_drop_oldest(self, state, data):
        """Failed alignment: drop the oldest raw frame, keep collecting."""
        return slide_window_old(state, data, self.cfg, self.params, data.prior)

    # ------------------------------------------------------------ host API
    def add_imu(self, t, acc, gyr):
        if self._sync is not None:
            self._sync.push_imu(float(t), np.asarray(acc, float), np.asarray(gyr, float))
            # a host mirror of the last 64 samples serves the mean-IMU
            # consumers (the selector's horizon)
            self._imu_acc.append(np.asarray(acc, float))
            self._imu_gyr.append(np.asarray(gyr, float))
            if len(self._imu_acc) > 64:
                self._imu_acc = self._imu_acc[-64:]
                self._imu_gyr = self._imu_gyr[-64:]
            return
        self._imu_times.append(float(t))
        self._imu_acc.append(np.asarray(acc, float))
        self._imu_gyr.append(np.asarray(gyr, float))

    def _to_batch(self, dts, accs, gyrs, mask, has):
        """The padded host batch as device tensors; has_imu stays a host
        bool (the fill phase branches on it without a sync)."""
        t = lambda a: torch.from_numpy(a).to(device=self.device, dtype=self.dtype)
        return (t(dts), t(accs), t(gyrs), torch.from_numpy(mask).to(self.device), bool(has))

    def _push_imu_angles(self, batch_t, k, gyrs, mask):
        """Extend the time-offset IMU curve by this interval's k steps
        (stamps batch_t[:k + 1], zero-padded to I + 1)."""
        I = self.cfg.max_imu
        ts_pad = np.zeros(I + 1)
        ts_pad[: k + 1] = batch_t[: k + 1]
        tg = torch.from_numpy(np.concatenate([ts_pad, gyrs.reshape(-1)])).to(self.device)
        self._td_acc = oc_mod.push_imu_angles(self._td_acc, tg[: I + 1],
                                              tg[I + 1:].view(I + 1, 3), mask)

    def _pack_imu(self, frame_t=None):
        """Pad the IMU buffered since the previous frame to capacity.  The
        alignment boundary is frame_t + td, the time offset td applied on
        top of the frame_t the caller passes (add_frame passes its stamp +
        td, as the reference does, so the cut falls at stamp + 2 td on both
        routes): samples up to it join this interval, an interpolated
        boundary sample closes it and seeds the next one.  Uses the native
        synchronizer when loaded; frame_t=None consumes everything
        buffered.  While td is being calibrated, the interval's gyro
        samples extend its IMU yaw curve."""
        I = self.cfg.max_imu
        dts = np.zeros(I)
        accs = np.zeros((I + 1, 3))
        gyrs = np.zeros((I + 1, 3))
        mask = np.zeros(I, bool)
        push = None  # (stamps, steps) of the td curve's extension
        if self._sync is not None and frame_t is not None:
            self._sync.set_td(self.td)
            res = self._sync.drain_frame(float(frame_t), max_out=4 * I, allow_partial=True)
            has = False
            if res is not None:
                bt, ba, bg_ = res
                if self._bound_sample is not None:
                    pt, pa, pg = self._bound_sample
                    if len(bt) == 0 or bt[0] > pt:
                        bt = np.concatenate([[pt], bt])
                        ba = np.concatenate([pa[None], ba])
                        bg_ = np.concatenate([pg[None], bg_])
                if len(bt) >= 2:
                    has = True
                    k = min(len(bt) - 1, I)
                    dts[:k] = np.diff(bt)[:k]
                    mask[:k] = True
                    accs[: k + 1] = ba[: k + 1]
                    gyrs[: k + 1] = bg_[: k + 1]
                    self._bound_sample = (bt[k], ba[k].copy(), bg_[k].copy())
                    push = (bt, k)
                elif len(bt) == 1:
                    self._bound_sample = (bt[0], ba[0].copy(), bg_[0].copy())
            return self._batch_and_push(dts, accs, gyrs, mask, has, push)

        t_boundary = None if frame_t is None else float(frame_t) + self.td
        ts_all = np.asarray(self._imu_times)
        acc_all = np.stack(self._imu_acc) if self._imu_acc else np.zeros((0, 3))
        gyr_all = np.stack(self._imu_gyr) if self._imu_gyr else np.zeros((0, 3))
        n_all = len(ts_all)
        if t_boundary is None or n_all == 0:
            j = n_all
        else:
            j = int(np.searchsorted(ts_all, t_boundary + 1e-9, side="right"))
        batch_t, batch_a, batch_g = ts_all[:j], acc_all[:j], gyr_all[:j]
        if t_boundary is not None and 0 < j < n_all and ts_all[j] > t_boundary > ts_all[j - 1]:
            # synthesize the boundary sample by linear interpolation
            w = (t_boundary - ts_all[j - 1]) / (ts_all[j] - ts_all[j - 1])
            batch_t = np.concatenate([batch_t, [t_boundary]])
            batch_a = np.concatenate([batch_a, (1 - w) * acc_all[j - 1:j] + w * acc_all[j:j + 1]])
            batch_g = np.concatenate([batch_g, (1 - w) * gyr_all[j - 1:j] + w * gyr_all[j:j + 1]])
        n = len(batch_t)
        has = n >= 2
        if has:
            k = min(n - 1, I)
            dts[:k] = np.diff(batch_t)[:k]
            mask[:k] = True
            accs[: k + 1] = batch_a[: k + 1]
            gyrs[: k + 1] = batch_g[: k + 1]
            # keep the boundary sample (+ any later samples) for the next interval
            self._imu_times = [batch_t[-1]] + list(ts_all[j:])
            self._imu_acc = [batch_a[-1]] + list(acc_all[j:])
            self._imu_gyr = [batch_g[-1]] + list(gyr_all[j:])
            push = (batch_t, k)
        return self._batch_and_push(dts, accs, gyrs, mask, has, push)

    def _batch_and_push(self, dts, accs, gyrs, mask, has, push):
        batch = self._to_batch(dts, accs, gyrs, mask, has)
        if push is not None and self._td_acc is not None and not self._td_solved:
            self._push_imu_angles(*push, gyrs, batch[3])
        return batch

    def _pack_lines(self, ln_ids, ln_obs, ln_vps, ln_vp_valid):
        if not self.use_lines or ln_ids is None:
            return ()
        d, dev = self.dtype, self.device
        t = lambda x, dt: torch.as_tensor(x).to(device=dev, dtype=dt)
        if ln_vps is None:
            vps = torch.zeros(len(ln_ids), 3, dtype=d, device=dev)
            vps[:, 2] = 1.0
        else:
            vps = t(ln_vps, d)
        vpv = (t(ln_vp_valid, torch.bool) if ln_vp_valid is not None
               else torch.zeros(len(ln_ids), dtype=torch.bool, device=dev))
        return (t(ln_ids, torch.int64), t(ln_obs, d), vps, vpv)

    def _frame_inputs(self, t, pt_ids, pt_rays, ln_ids, ln_obs, ln_vps, ln_vp_valid):
        imu_batch = self._pack_imu(float(t) + self.td)
        pt_ids = torch.as_tensor(pt_ids).to(device=self.device, dtype=torch.int64)
        pt_rays = torch.as_tensor(pt_rays).to(device=self.device, dtype=self.dtype)
        ln_args = self._pack_lines(ln_ids, ln_obs, ln_vps, ln_vp_valid)
        return imu_batch, pt_ids, pt_rays, ln_args

    def add_frame(self, t, pt_ids, pt_rays, ln_ids=None, ln_obs=None, ln_vps=None,
                  ln_vp_valid=None):
        """Process one camera frame: pt_ids [M] (pad -1), pt_rays [M, 3].
        Returns None while filling / initializing, the StepOutput (numpy
        fields) of the initializing frame, then one per tracked frame."""
        cfg = self.cfg
        nf = cfg.nf
        imu_batch, pt_ids, pt_rays, ln_args = self._frame_inputs(
            t, pt_ids, pt_rays, ln_ids, ln_obs, ln_vps, ln_vp_valid)
        self.last_frame_time = float(t)
        if not self.initialized:
            self.fill_step(self.frame_count, pt_ids, pt_rays, ln_args, imu_batch, t)
            self.frame_count += 1
            self._online_calibration(t, self.frame_count - 1)
            if self.frame_count < nf:
                return None
            if self.calibrating():
                # calibration still converging: keep collecting frames
                self.state, self.data = self.init_drop_oldest(self.state, self.data)
                self.frame_count = nf - 1
                return None
            state2, data2, ok = self.try_init(self.state, self.data, self.sfm_draws())
            self.frame_count = nf - 1
            if not bool(ok):
                self.state, self.data = self.init_drop_oldest(self.state, self.data)
                return None
            self.state, self.data, lm_out = self.init_finalize(state2, data2)
            self.initialized = True
            s = self.state
            c = lambda *v: torch.tensor(v, dtype=self.dtype, device=self.device)
            out = StepOutput(
                p=s.p[nf - 2], q=s.q[nf - 2], v=s.v[nf - 2], ba=s.ba[nf - 2],
                bg=s.bg[nf - 2], is_keyframe=c(1.0), failure=c(0.0), ba_cost=lm_out.cost,
                relo_valid=c(0.0), relo_rel_t=c(0.0, 0.0, 0.0),
                relo_rel_q=c(1.0, 0.0, 0.0, 0.0), relo_rel_yaw=c(0.0))
            return unpack_output(pack_output(out, self.dtype).cpu())
        self.state, self.data, out = track_step(
            self.state, self.data, pt_ids, pt_rays, imu_batch, cfg, self.params, t=float(t),
            ln_args=ln_args, use_lines=self.use_lines)
        # one host transfer for the whole step output
        out = unpack_output(pack_output(out, self.dtype).cpu())
        if out.failure:
            self.reset()
        return out

    def add_frame_async(self, t, pt_ids, pt_rays, ln_ids=None, ln_obs=None, ln_vps=None,
                        ln_vp_valid=None, packed=False):
        """Steady-state frame step without the host readback: returns the
        device StepOutput (or, packed, its [28] f32 vector), so a pipelined
        caller overlaps this frame's device work with the previous frame's
        bookkeeping; the caller owns failure handling (``reset()``).  Until
        initialized, this is ``add_frame``."""
        if not self.initialized:
            return self.add_frame(t, pt_ids, pt_rays, ln_ids=ln_ids, ln_obs=ln_obs,
                                  ln_vps=ln_vps, ln_vp_valid=ln_vp_valid)
        imu_batch, pt_ids, pt_rays, ln_args = self._frame_inputs(
            t, pt_ids, pt_rays, ln_ids, ln_obs, ln_vps, ln_vp_valid)
        self.last_frame_time = float(t)
        self.state, self.data, out = track_step(
            self.state, self.data, pt_ids, pt_rays, imu_batch, self.cfg, self.params,
            t=float(t), ln_args=ln_args, use_lines=self.use_lines)
        return pack_output(out) if packed else out

    def calibrating(self):
        """Whether online calibration still holds the fill phase."""
        return ((self.estimate_extrinsic >= 2 and not self.extrinsic_ok)
                or (self.estimate_td and not self._td_solved))

    def _online_calibration(self, t, idx):
        """Hand-eye extrinsic rotation (mode 2) and time-offset accumulation
        on the fill frame at window slot idx, against slot idx - 1.

        The extrinsic converges at the reference's excitation gate (σ₃ >
        0.25 with >= 12 pairs) or when successive solves agree within 0.5°
        over 8 frames with >= 20 pairs.  A camera sample joins the td curve
        as valid only if its pair rotation's angle is within 0.005 rad of
        the gyro's; from 60 samples each frame solves for td until the
        solve is finite.  One host transfer a frame for each."""
        need_ex = self.estimate_extrinsic >= 2 and not self.extrinsic_ok
        need_td = self.estimate_td and not self._td_solved
        if idx <= 0 or not (need_ex or need_td):
            return
        d = self.data
        q_cam, okp = oc_mod.pair_rotation(d.pt_obs[:, idx - 1], d.pt_obs[:, idx],
                                          d.pt_mask[:, idx - 1], d.pt_mask[:, idx], d.pt_id,
                                          self.sfm_draws())
        dq_imu = d.imu_pre.delta_q[idx - 1]
        if need_ex:
            self._ex_acc = oc_mod.push_rotation_pair(self._ex_acc, q_cam, dq_imu, okp)
            q_ic, conv, _ = oc_mod.solve_extrinsic(self._ex_acc)
            h = torch.cat([q_ic.to(torch.float64), conv.to(torch.float64).reshape(1),
                           self._ex_acc.count.to(torch.float64).reshape(1)]).cpu().numpy()
            q_np, conv_h, count = h[:4], bool(h[4]), int(h[5])
            if self._ex_prev is not None and count >= 20:
                dot = min(1.0, abs(float(np.dot(q_np, self._ex_prev))))
                self._ex_stable = self._ex_stable + 1 if np.degrees(
                    2.0 * np.arccos(dot)) < 0.5 else 0
            self._ex_prev = q_np
            if conv_h or self._ex_stable >= 8:
                self.state = self.state._replace(q_ic=q_ic.to(self.dtype))
                self.extrinsic_ok = True
        if need_td:
            # gate visual pairs against the gyro increment: small-baseline
            # decompositions have heavy-tailed rotation errors that would
            # skew the cumulative curve for good
            angle = lambda q: 2.0 * torch.arccos(torch.clamp(torch.abs(q[0]), 0.0, 1.0))
            ok_td = okp & (torch.abs(angle(q_cam) - angle(dq_imu)) < 0.005)
            self._td_acc = oc_mod.push_cam_angle(self._td_acc, float(t), q_cam,
                                                 self.state.q_ic, ok_td, dq_imu)
            self._td_n_cam = min(self._td_n_cam + 1, self._td_acc.t_cam.shape[0])
            if self._td_n_cam >= 60:
                td, _, okt = oc_mod.solve_time_offset(self._td_acc)
                td_h, ok_h = torch.stack([td.to(torch.float64),
                                          okt.to(torch.float64)]).cpu().tolist()
                if ok_h:
                    self.td = td_h
                    self._td_solved = True

    def set_relo(self, match_ids, match_obs, old_p, old_q, kf_stamp=None):
        """Arm fast relocalization for the next solve.

        match_ids: [M] feature ids verified against an old keyframe;
        match_obs: [M, 2|3] their normalized observations in the old
        keyframe's camera; old_p/old_q: the old keyframe's (VIO-frame) pose,
        the seed of the relo pose the next BA optimizes with the window.
        kf_stamp: the loop keyframe's stamp (kept f64): the refined relative
        pose comes back in StepOutput.relo_rel_* against the window frame of
        that stamp; without it the refinement never reports valid.  Returns
        whether any id is in the window."""
        ids = np.asarray(match_ids, np.int64)
        obs = np.asarray(match_obs, float)
        if obs.shape[-1] == 2:
            obs = np.concatenate([obs, np.ones_like(obs[..., :1])], axis=-1)
        table = self.data.pt_id.cpu().numpy()
        relo_obs = self.data.relo_obs.cpu().numpy().copy()
        relo_mask = np.zeros(table.shape[0], bool)
        slot_of = {int(t): s for s, t in enumerate(table) if t >= 0}
        for m, fid in enumerate(ids):
            s = slot_of.get(int(fid))
            if s is not None:
                relo_obs[s] = obs[m]
                relo_mask[s] = True
        if not relo_mask.any():
            return False
        dev, dt = self.device, self.dtype
        t = lambda x, dtype=dt: (x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x, float))).to(device=dev, dtype=dtype)
        self.data = self.data._replace(
            relo_obs=t(relo_obs), relo_mask=torch.from_numpy(relo_mask).to(dev),
            relo_valid=torch.ones((), dtype=torch.bool, device=dev),
            relo_stamp=t(-2.0 if kf_stamp is None else float(kf_stamp), torch.float64))
        self.state = self.state._replace(p_relo=t(old_p), q_relo=t(old_q))
        return True

    def reset(self):
        """Full reboot on failure (the reference's clearState)."""
        q_ic, p_ic = self.state.q_ic, self.state.p_ic
        self.state = empty_state(self.cfg, self.dtype, self.device)._replace(q_ic=q_ic,
                                                                             p_ic=p_ic)
        self.data = empty_tracks(self.cfg, self.dtype, self.device)
        self.frame_count = 0
        self.initialized = False
        self._imu_times, self._imu_acc, self._imu_gyr = [], [], []
