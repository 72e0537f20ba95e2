"""The SLAM system's entry point: images and IMU in, VIO and drift-corrected
poses out.

Port of ``vplines_slam_tpu/pipeline/system.py`` (``SystemOutput`` and
``SlamSystem``: ``add_imu``, ``add_image``, ``_drain_pending``, ``flush``,
``new_sequence``, ``load_map``, ``_finish_frame`` and the staged loop
closure: ``_kf_throttle``, ``_lc_due_dev``, ``_advance_loop_stage``,
``_lc_stage_extract``, ``_lc_stage_cand``, ``_lc_dispatch_verify``,
``_lc_stage_commit``, ``_run_pgo``, ``_window_points_impl``, and the
attention feature selector's dispatch and ``_select_impl``) without GNSS
fusion, introspection and the K-frame batched fetch (``fetch_every > 1``):
the constructor raises when asked for any of them, or given their
configuration (``fusion_cfg``, ``introspect_dir``).  Loop closure is on by
default, as in the reference; the selector is off by default.

  sys = SlamSystem(cam, window_cfg, tracker_cfg, line_cfg, pg_cfg=profile.pose_graph,
                   imu_params=..., q_ic=..., p_ic=...)
  sys.add_imu(t, acc, gyr)          # every IMU sample, in time order
  out = sys.add_image(t, img)       # [H, W] in [0, 1]; the previous frame's output
  last = sys.flush()                # the tail at stream end, loop stages drained

Pipelining (``fetch_every=1``): once the VIO is initialized, ``add_image``
fetches the queued frame's output and the loop stage's one due device value
in one transfer before this frame's work is enqueued, then finishes the
frame on the host and advances the loop-closure pipeline one step
(extract + retrieve -> candidate gate -> verify -> commit -> drift), as the
reference runs its pose-graph process beside the estimator.  Each keyframe's
extract job keeps that frame's window state; the estimator builds new
tensors every step and writes none in place, so the snapshot stays that
frame's.  The verification's RANSAC draws come from the system's
``torch.Generator`` through ``pnp_draws``.

The selector (``use_feature_selector=True``): once initialized, the new
feature ids of a frame (those the window does not track) compete greedily
for the budget ``max_features`` minus the tracked count, by the information
they would add over an IMU-propagated horizon (``models/selector``, K20);
the losers are masked to -1 before the VIO step.  It runs in f64 on the
device, its budget a device scalar, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..estimator.vio import VioEngine, unpack_output
from ..estimator.window import WindowConfig
from ..models import camera as cam_mod
from ..models import imu as imu_mod
from ..models import pose_graph as pg_mod
from ..models import selector as sel_mod
from ..models.feature_tracker import FeatureTrackerFrontend, TrackerConfig
from ..models.line_tracker import LineTrackerConfig, LineTrackerFrontend
from ..utils.geometry import quat_conj, quat_mul, quat_rotate, rot_to_quat
from ..utils.stats import SPANS, Statistics


class SystemOutput(NamedTuple):
    t: float
    p_vio: np.ndarray
    q_vio: np.ndarray
    p_corrected: np.ndarray  # after the sequence base shift and drift correction
    q_corrected: np.ndarray
    is_keyframe: bool
    loop_closed: bool
    # host wall-clock ms per stage of the producing add_image call
    # (frontend / line_frontend / vio_dispatch / fetch_finish / loop_stage)
    timings: Optional[dict] = None
    ba_cost: float = float("nan")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for v in tree for x in _leaves(v)]


def _rebuild(tree, flat, pos):
    """tree's structure with numpy leaves cut from flat (f64) in order, each
    back in its tensor's dtype and shape."""
    if isinstance(tree, torch.Tensor):
        n = tree.numel()
        a = flat[pos:pos + n].reshape(tuple(tree.shape))
        if tree.dtype == torch.bool:
            a = a > 0.5
        elif not tree.dtype.is_floating_point:
            a = a.astype(np.int64)
        else:
            a = a.astype(str(tree.dtype).removeprefix("torch."))
        return a, pos + n
    kids = []
    for v in tree:
        a, pos = _rebuild(v, flat, pos)
        kids.append(a)
    return (type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)), pos


def _fetch(*trees):
    """Every tensor of the trees (tuples / NamedTuples of tensors, or None)
    to the host in ONE transfer, as f64 (exact for the f32, int32 and bool
    values fetched here).  Returns the trees with numpy leaves."""
    leaves = [x for t in trees if t is not None for x in _leaves(t)]
    if not leaves:
        return trees
    flat = torch.cat([x.reshape(-1).to(torch.float64) for x in leaves]).cpu().numpy()
    out, pos = [], 0
    for t in trees:
        if t is None:
            out.append(None)
            continue
        a, pos = _rebuild(t, flat, pos)
        out.append(a)
    return tuple(out)


class SlamSystem:
    """Monocular visual-inertial SLAM with optional lines and VPs, and loop
    closure."""

    def __init__(self, cam: cam_mod.CameraModel, window_cfg: WindowConfig = WindowConfig(),
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 line_cfg: Optional[LineTrackerConfig] = None,
                 pg_cfg: pg_mod.PoseGraphConfig = pg_mod.PoseGraphConfig(), fusion_cfg=None,
                 imu_params: Optional[imu_mod.ImuParams] = None, q_ic=None, p_ic=None,
                 use_loop_closure: bool = True, stream_gap_restart: float = 1.0,
                 use_feature_selector: bool = False, selector_cfg=None,
                 estimate_extrinsic=None, estimate_td: bool = False,
                 print_stats_every: int = 0, introspect_every: int = 0,
                 introspect_dir: Optional[str] = None, fetch_every: int = 1, mesh=None,
                 dtype=torch.float32, device=torch.device("cuda")):
        unported = {
            "GNSS fusion (fusion_cfg)": fusion_cfg is not None,
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
        # attention feature selector: tracked features always pass, new ones
        # compete for the remaining information budget
        self.use_selector = use_feature_selector
        self.selector_cfg = selector_cfg or sel_mod.SelectorConfig()
        self.use_loop = use_loop_closure
        self.pg_cfg = pg_cfg
        self.db = pg_mod.empty_db(pg_cfg, dtype, self.device)
        # host mirrors of db.count / db.seq and the keyframe stamps, so no
        # keyframe reads them back from the device
        self._db_count = 0
        self._db_seqs: list = []
        self._kf_times: list = []
        self.R_drift = np.eye(3)
        self.t_drift = np.zeros(3)
        # fast relocalization in flight: (current kf, old kf) whose refined
        # relative pose the next VIO step delivers
        self._pending_relo = None
        self._pending: list = []  # dispatched frames whose output is still on the device
        self._lc_jobs: list = []  # staged loop-closure jobs, oldest first
        self._drift_dev = None  # a dispatched drift correction not fetched yet
        self._loop_closed_flag = False
        # sequences (seq 0 is a loaded prior map); (R_base, t_base) maps the
        # current sequence's VIO frame onto the map once it is re-based
        self.seq = 1
        self._rebased_seqs = set()
        self._gap_restart = stream_gap_restart
        self._last_img_t = None
        self.R_base = np.eye(3)
        self.t_base = np.zeros(3)
        self._gen = torch.Generator(device=self.device).manual_seed(1)
        self._kf_skip_count = 0
        self._last_kf_p = None
        self.stats = Statistics(print_every=print_stats_every)

    # ------------------------------------------------------------- draws
    def pnp_draws(self):
        """[256, 6] PnP-RANSAC sample draws in [0, n_window_pts) of one loop
        verification."""
        return torch.randint(0, self.pg_cfg.n_window_pts, (256, 6), generator=self._gen,
                             device=self.device)

    # ------------------------------------------------------------------ API
    def add_imu(self, t, acc, gyr):
        self.vio.add_imu(t, acc, gyr)

    def new_sequence(self):
        """Start a new sequence after a stream discontinuity: the estimator
        restarts in a fresh VIO frame, the drift resets, and the sequence
        re-attaches to the map at its first loop onto an older sequence."""
        self.seq += 1
        self.vio.reset()
        self.R_drift = np.eye(3)
        self.t_drift = np.zeros(3)
        self.R_base = np.eye(3)
        self.t_base = np.zeros(3)
        self._pending_relo = None
        self._pending = []
        self._lc_jobs.clear()
        self._drift_dev = None

    def load_map(self, path):
        """Load a prior keyframe map (saved by either package) for
        multi-session relocalization: its keyframes get sequence 0 and are
        held fixed in the 4-DoF PGO."""
        db = pg_mod.load_db(path, self.device)
        self.db = db._replace(seq=torch.zeros_like(db.seq))
        self._db_count = int(db.count)
        self._db_seqs = [0] * self._db_count
        self._kf_times = [float("nan")] * self._db_count

    def add_image(self, t, img):
        """Process one grayscale frame [H, W] in [0, 1].  Returns the previous
        frame's SystemOutput (or None); ``flush()`` returns the last one."""
        if self._last_img_t is not None and t - self._last_img_t > self._gap_restart:
            self.new_sequence()
        self._last_img_t = t
        img = torch.as_tensor(img).to(device=self.device, dtype=self.dtype)
        tm = self.stats.timers
        SPANS.next_frame()
        # fetch the queued frame's output (and the due loop-stage value)
        # before this frame's work is enqueued
        results = self._drain_pending() if self._pending else []

        with tm.time("frontend"), SPANS.span("frontend"):
            feats = self.frontend.process(t, img)
        ln_kwargs = {}
        if self.line_frontend is not None:
            with tm.time("line_frontend"), SPANS.span("line_frontend"):
                lines = self.line_frontend.process(t, img)
            ln_kwargs = dict(ln_ids=lines.ids, ln_obs=lines.endpoints, ln_vps=lines.vp_dirs,
                             ln_vp_valid=lines.vp_valid)
        ids = feats.ids
        if self.use_selector and self.vio.initialized and len(self.vio._imu_acc) >= 2:
            acc_mean = np.mean(np.stack(self.vio._imu_acc), axis=0)
            gyr_mean = np.mean(np.stack(self.vio._imu_gyr), axis=0)
            dt = t - (self.vio.last_frame_time or t - 0.1)
            with SPANS.span("selector"):
                ids = self._select_impl(ids, feats.rays, self.vio.state, self.vio.data,
                                        acc_mean, gyr_mean, dt)

        if not self.vio.initialized:
            out = self.vio.add_frame(t, ids, feats.rays, **ln_kwargs)
            if out is not None and self.vio.initialized:
                results.append(self._finish_frame(t, img, out))
            return results[0] if results else None

        with tm.time("vio_dispatch"), SPANS.span("vio"):
            out_dev = self.vio.add_frame_async(t, ids, feats.rays, packed=True, **ln_kwargs)
        self._pending.append(dict(t=t, img=img, out=out_dev, state=self.vio.state,
                                  data=self.vio.data))
        return results[0] if results else None

    def _drain_pending(self):
        """Fetch every queued frame output and the due loop-stage value in
        one transfer, finish each frame in order (a failure reboots the
        estimator and drops the later ones and the staged jobs), then advance
        the loop-closure pipeline by one step."""
        tm = self.stats.timers
        pending, self._pending = self._pending, []
        due_dev = self._lc_due_dev()
        results = []
        with tm.time("fetch_finish"):
            out_mat, due_h = _fetch(torch.stack([p["out"] for p in pending]), due_dev)
        for p, row in zip(pending, out_mat):
            out_h = unpack_output(row)
            if out_h.failure:
                self.vio.reset()
                self._lc_jobs.clear()
                due_h = None
                break
            results.append(self._finish_frame(p["t"], p["img"], out_h, state=p["state"],
                                              data=p["data"]))
        with tm.time("loop_stage"), SPANS.span("loop_stage"):
            self._advance_loop_stage(due_h, due_dev)
        return results

    def flush(self):
        """Finish the in-flight frame and drain the staged loop-closure work
        (stream end).  Returns the last output or None."""
        results = self._drain_pending() if self._pending else []
        guard = 0
        while (self._lc_jobs or self._drift_dev is not None) and guard < 64:
            self._advance_loop_stage()
            guard += 1
        return results[-1] if results else None

    def _finish_frame(self, t, img, out, state=None, data=None):
        """Host bookkeeping of a frame whose StepOutput is on the host."""
        loop_closed = False
        # a relocalization in flight delivers the loop's refined relative pose
        if self._pending_relo is not None and bool(out.relo_valid):
            k_cur, k_old = self._pending_relo
            self.db = pg_mod.record_loop(self.db, k_cur, k_old, self._up(out.relo_rel_t),
                                         self._up(out.relo_rel_yaw))
            self._run_pgo()
            loop_closed = True
        self._pending_relo = None
        if self.use_loop and bool(out.is_keyframe) and self._kf_throttle(out):
            self._lc_jobs.append(dict(
                stage="extract", t=t, img=img, out=out,
                state=state if state is not None else self.vio.state,
                data=data if data is not None else self.vio.data))
        p_vio = np.asarray(out.p)
        q_vio = np.asarray(out.q)
        # sequence base shift (w_r_vio / w_t_vio), then the drift correction
        R_bd = self.R_drift @ self.R_base
        p_corr = R_bd @ p_vio + self.R_drift @ self.t_base + self.t_drift
        q_corr = quat_mul(rot_to_quat(torch.as_tensor(R_bd).to(self.dtype)),
                          torch.as_tensor(q_vio).to(self.dtype)).numpy()
        loop_closed = loop_closed or self._loop_closed_flag
        self._loop_closed_flag = False
        cost = float(out.ba_cost)
        self.stats.update(p_corr, bool(out.is_keyframe), loop_closed, ba_cost=cost)
        st = self.stats
        if st.print_every and st.frames % st.print_every == 0:
            st.maybe_print(p_ic=self.vio.state.p_ic.cpu(), q_ic=self.vio.state.q_ic.cpu(),
                           td=self.vio.td)
        return SystemOutput(t=t, p_vio=p_vio, q_vio=q_vio, p_corrected=p_corr,
                            q_corrected=q_corr, is_keyframe=bool(out.is_keyframe),
                            loop_closed=loop_closed, timings=dict(st.timers.last),
                            ba_cost=cost)

    def _up(self, a, dtype=None):
        """A host array as a device tensor of the system's dtype."""
        return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype or self.dtype)

    # ------------------------------------------------------- loop closure
    def _kf_throttle(self, out) -> bool:
        """Pass every (skip_cnt + 1)-th VIO keyframe that moved skip_dis."""
        cfg = self.pg_cfg
        if cfg.skip_cnt > 0:
            self._kf_skip_count += 1
            if self._kf_skip_count <= cfg.skip_cnt:
                return False
        if cfg.skip_dis > 0.0 and self._last_kf_p is not None:
            if np.linalg.norm(np.asarray(out.p) - self._last_kf_p) < cfg.skip_dis:
                return False
        self._kf_skip_count = 0
        self._last_kf_p = np.asarray(out.p)
        return True

    def _lc_due_dev(self):
        """The device value the next _advance_loop_stage reads, if any, so
        add_image fetches it with the frame's output."""
        if self._drift_dev is not None:
            return self._drift_dev
        if self._lc_jobs:
            job = self._lc_jobs[0]
            if job["stage"] == "cand":
                return job["cand_dev"]
            if job["stage"] == "commit":
                return job["lr_dev"]
        return None

    def _advance_loop_stage(self, due_h=None, due_dev=None):
        """Advance the staged loop closure by one step (at most one small
        readback): the deferred drift fetch, else extract (dispatch only, up
        to 3 jobs) and one readback stage of the oldest job.  due_h is the
        host value of _lc_due_dev() fetched with the frame, consumed only if
        the handle it came from is still the one due."""
        if self._drift_dev is not None:
            if due_h is not None and due_dev is self._drift_dev:
                R_d, t_d = due_h
            else:
                R_d, t_d = _fetch(self._drift_dev)[0]
            self.R_drift = np.asarray(R_d, float)
            self.t_drift = np.asarray(t_d, float)
            self._drift_dev = None
            return
        if not self._lc_jobs:
            return
        pre_stage = self._lc_jobs[0]["stage"]
        promoted = 0
        for job in self._lc_jobs:
            if job["stage"] == "extract" and promoted < 3:
                self._lc_stage_extract(job)
                promoted += 1
        # backlog: past max_backlog, drop the oldest jobs still waiting at
        # the candidate gate (their keyframes are in the database already);
        # job 0 stays, its value may be this drain's prefetch
        cfg = self.pg_cfg
        if len(self._lc_jobs) > cfg.max_backlog:
            overflow = len(self._lc_jobs) - cfg.max_backlog
            keep = [self._lc_jobs[0]]
            for job in self._lc_jobs[1:]:
                if overflow > 0 and job["stage"] == "cand" and "cand_queue" not in job:
                    overflow -= 1
                    continue
                keep.append(job)
            self._lc_jobs = keep
        job = self._lc_jobs[0]
        # a readback stage only if the job was there when the drain began (a
        # just-promoted job's retrieval is still computing)
        if pre_stage == "cand" and job["stage"] == "cand":
            self._lc_stage_cand(job, due_h if due_dev is job.get("cand_dev") else None)
        elif pre_stage == "commit" and job["stage"] == "commit":
            self._lc_stage_commit(job, due_h if due_dev is job.get("lr_dev") else None)
        if job.get("done"):
            self._lc_jobs.pop(0)

    def _lc_stage_extract(self, job):
        cfg = self.pg_cfg
        # grow before the write: an out-of-bounds row would raise
        if self._db_count >= self.db.p_vio.shape[0]:
            self.db = pg_mod.grow_db(self.db)
        out = job["out"]
        with SPANS.span("lc_extract"):
            w3d, wxy, w_valid, w_ids = self._window_points(job["state"], job["data"])
            fb = pg_mod.extract_keyframe_features(
                job["img"], lambda xy: cam_mod.lift(self.cam, xy), cfg,
                window_xy=(wxy, w_valid))
            # the keyframe pose and its world points in the sequence's map
            # frame: one upload of [R_base, t_base, p, q]
            host = np.concatenate([self.R_base.reshape(-1), self.t_base, np.asarray(out.p),
                                   np.asarray(out.q)])
            dev = self._up(host)
            Rb, tb = dev[0:9].reshape(3, 3), dev[9:12]
            q_b = rot_to_quat(Rb)
            p_kf = Rb @ dev[12:15] + tb
            q_kf = quat_mul(q_b, dev[15:19])
            w3d = w3d @ Rb.T + tb
            self.db = pg_mod.add_keyframe(self.db, cfg, p_kf, q_kf, fb["sig"], fb["desc"],
                                          fb["kp_norm"], fb["kp_valid"], fb["wdesc"], w3d,
                                          w_valid, seq=self.seq)
        with SPANS.span("lc_retrieve"):
            cand_dev = pg_mod.retrieve_candidates(self.db, cfg, fb["sig"], query_seq=self.seq)
        job.update(stage="cand", k=self._db_count, cand_dev=cand_dev, fb=fb, w3d=w3d,
                   w_valid=w_valid, w_ids=w_ids, p_kf=p_kf, q_kf=q_kf,
                   Rb=self.R_base.copy(), tb=self.t_base.copy(),
                   q_b=rot_to_quat(torch.as_tensor(self.R_base).to(self.dtype)))
        self._db_count += 1
        self._db_seqs.append(self.seq)
        self._kf_times.append(float(job["t"]))

    def _lc_stage_cand(self, job, due_h=None):
        """Gate the retrieval candidates and queue them for verification
        oldest-first: the best must clear both min_score and the query's
        recent-neighbour floor; every candidate within rel_margin of the best
        is eligible.  A failed verification falls back to the next-oldest
        eligible candidate."""
        cfg = self.pg_cfg
        cand_i, cand_s, floor = due_h if due_h is not None else _fetch(job["cand_dev"])[0]
        k = job["k"]
        best = float(cand_s[0])
        if best <= max(cfg.min_score, float(floor)):
            job["done"] = True
            return
        queue = []
        for i in range(len(cand_i)):
            cand, s = int(cand_i[i]), float(cand_s[i])
            if s < best - cfg.rel_margin:
                continue
            # candidates of other sequences / maps skip the recency check
            cross_seq = k > 0 and cand < len(self._db_seqs) and self._db_seqs[cand] != self.seq
            if k > cfg.skip_recent or cross_seq:
                queue.append((cand, cross_seq))
        if not queue:
            job["done"] = True
            return
        queue.sort()  # the oldest keyframe first
        job["cand_queue"] = queue
        self._lc_dispatch_verify(job)

    def _lc_dispatch_verify(self, job):
        cand, cross_seq = job["cand_queue"].pop(0)
        with SPANS.span("lc_verify"):
            lr_dev = pg_mod.verify_loop(
                self.db, self.pg_cfg, cand, job["fb"]["wdesc"], job["w3d"], job["w_valid"],
                job["p_kf"], job["q_kf"], self.pnp_draws(), self.vio.state.q_ic,
                self.vio.state.p_ic)
        job.update(stage="commit", cand=cand, cross_seq=cross_seq, lr_dev=lr_dev)

    def _lc_stage_commit(self, job, due_h=None):
        lr = due_h if due_h is not None else _fetch(job["lr_dev"])[0]
        if not bool(lr.ok):
            if job.get("cand_queue"):
                self._lc_dispatch_verify(job)  # the next-oldest candidate
            else:
                job["done"] = True
            return
        job["done"] = True
        k, cand = job["k"], job["cand"]
        self.db = pg_mod.record_loop(self.db, k, cand, self._up(lr.rel_t), self._up(lr.rel_yaw))
        if job["cross_seq"] and self.seq not in self._rebased_seqs:
            # the first loop onto an older sequence / map re-bases the whole
            # current sequence and folds the shift into the base transform
            self.db, (R_s, t_s) = pg_mod.rebase_sequence(self.db, self.pg_cfg, k, cand)
            R_s, t_s = _fetch((R_s, t_s))[0]
            self.R_base = R_s @ self.R_base
            self.t_base = R_s @ self.t_base + t_s
            self._rebased_seqs.add(self.seq)
        self._run_pgo()
        self._loop_closed_flag = True
        # arm fast relocalization: the matched old-keyframe observations
        # refine the loop's relative pose in the next window BA, from the PnP
        # pose mapped back into the estimator's own VIO frame
        mm = np.asarray(lr.match_mask)
        if mm.any():
            p_seed = np.asarray(job["Rb"]).T @ (np.asarray(lr.p_old, float) - job["tb"])
            q_seed = quat_mul(quat_conj(torch.as_tensor(job["q_b"]).to(self.dtype)),
                              torch.as_tensor(np.asarray(lr.q_old)).to(self.dtype))
            armed = self.vio.set_relo(np.asarray(job["w_ids"].cpu())[mm],
                                      np.asarray(lr.obs_old)[mm], p_seed, q_seed,
                                      kf_stamp=job["t"])
            if armed:
                self._pending_relo = (k, cand)

    def _run_pgo(self):
        """Dispatch the 4-DoF pose-graph solve; its drift correction is
        fetched on a later frame."""
        with SPANS.span("lc_pgo"):
            self.db, _ = pg_mod.optimize_4dof(self.db, self.pg_cfg)
            self._drift_dev = pg_mod.drift_correction(self.db, self.pg_cfg)

    def _select_impl(self, ids, rays, state, data, acc_mean, gyr_mean, dt):
        """The attention feature selector over a frame's candidates, in f64
        whatever the engine dtype: tracked ids pass, new ids compete
        greedily for max(max_features - tracked, 0) picks by the information
        they add over the propagated horizon (NN depth guesses from the
        window's solved landmarks); at most init_threshold candidates all
        pass.  Returns the ids [M] with the unselected new ones -1, on the
        device.  acc_mean, gyr_mean: host [3]; dt: the frame interval (s)."""
        cfg, scfg = self.vio.cfg, self.selector_cfg
        f64, dev = torch.float64, self.device
        k = cfg.nf - 2  # the newest solved frame after the slide
        ids = torch.as_tensor(ids).to(device=dev, dtype=torch.int64)
        rays = torch.as_tensor(rays).to(device=dev, dtype=f64)
        # membership by a [M, max_points] comparison: torch.isin would sort
        # through unique(), a host sync on the card
        tracked = torch.any(ids[:, None] == torch.where(data.pt_id >= 0, data.pt_id,
                                                        torch.full_like(data.pt_id, -2)), dim=1)
        valid = ids >= 0
        is_new = valid & ~tracked

        # the future horizon from the constant-IMU model, and its prior
        p, q, v = state.p.to(f64), state.q.to(f64), state.v.to(f64)
        q_ic, p_ic = state.q_ic.to(f64), state.p_ic.to(f64)
        imu = torch.from_numpy(np.concatenate([acc_mean, gyr_mean]).astype(np.float64))
        if dev.type == "cuda":  # a pinned, asynchronous upload: no host sync
            imu = imu.pin_memory()
        imu = imu.to(device=dev, non_blocking=True)
        ps, qs, _ = sel_mod.propagate_horizon(p[k], q[k], v[k], state.ba[k].to(f64),
                                              state.bg[k].to(f64), imu[0:3], imu[3:6], dt,
                                              self.vio.params.g.to(f64))
        omega_prior = sel_mod.imu_prior_information(qs, dt, scfg.acc_var, scfg.acc_bias_var,
                                                    scfg.n_imu_per_frame)

        # the window's solved landmarks in camera k: depth guesses
        slots = torch.arange(cfg.max_points, device=dev)
        i = data.pt_start
        z = 1.0 / torch.clamp(data.pt_inv_depth.to(f64), 1e-4, 1e4)
        Xc_anchor = data.pt_obs[slots, i].to(f64) * z[:, None]
        q_wc = quat_mul(q, q_ic.expand_as(q))
        p_wc = p + quat_rotate(q, p_ic.expand_as(p))
        Xw = quat_rotate(q_wc[i], Xc_anchor) + p_wc[i]
        Xc = quat_rotate(quat_conj(q_wc[k]), Xw - p_wc[k])
        k_ok = data.pt_solved & (data.pt_id >= 0) & (Xc[:, 2] > 0.1)
        k_rays = Xc / torch.clamp(torch.linalg.norm(Xc, dim=-1, keepdim=True), min=1e-9)
        unit = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True), min=1e-9)
        depths = sel_mod.nn_depth_guess(unit, k_rays, Xc[:, 2], k_ok)

        obs = 1  # the new image is horizon state 1: the information's support follows
        omega_f = sel_mod.feature_information(unit, depths, is_new, ps, qs, q_ic, p_ic,
                                              scfg.pix_sigma, obs_frame=obs)
        n_tracked = torch.sum(tracked.to(torch.int64))
        budget = torch.clamp(scfg.max_features - n_tracked, min=0)
        selected, _ = sel_mod.select_features(omega_prior, omega_f, is_new, budget, scfg,
                                              obs_frame=obs)
        # pass-through when few candidates (init_threshold)
        n_cand = torch.sum(valid.to(torch.int64))
        keep = torch.where(n_cand <= scfg.init_threshold, valid, tracked | selected)
        return torch.where(keep, ids, torch.full_like(ids, -1))

    def _window_points(self, state, data):
        """World 3D points, pixel coords, validity and ids of the first
        n_window_pts solved tracks seen in the newest solved frame (the
        keyframe's PnP anchors).  The pixel is the measured observation
        projected, not the estimate reprojected (that would shift the
        descriptor patch by the VIO drift)."""
        cfg = self.vio.cfg
        Wp = self.pg_cfg.n_window_pts
        q_ic = state.q_ic.expand_as(state.q)
        q_wc = quat_mul(state.q, q_ic)
        p_wc = state.p + quat_rotate(state.q, state.p_ic.expand_as(state.p))
        slots = torch.arange(cfg.max_points, device=state.p.device)
        i = data.pt_start
        ray = data.pt_obs[slots, i]
        z = 1.0 / torch.clamp(data.pt_inv_depth, 1e-4, 1e4)
        Xw = quat_rotate(q_wc[i], ray * z[:, None]) + p_wc[i]
        j = cfg.nf - 2
        seen = data.pt_mask[:, j] & data.pt_solved & (data.pt_id >= 0)
        uvn = data.pt_obs[:, j, 0:2]
        uv_px, vis = cam_mod.project(self.cam, torch.cat([uvn, torch.ones_like(uvn[:, :1])], -1))
        seen = seen & vis
        idx = torch.argsort((~seen).to(torch.int8), stable=True)[:Wp]
        return Xw[idx], uv_px[idx], seen[idx], data.pt_id[idx]
