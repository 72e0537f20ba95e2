"""``SlamSystem`` with loop closure against the JAX reference (torch f64 on
the CPU, the kernels' plain twins, against JAX x64):

(b) ``SlamSystem`` with loop closure on, on the cold-start stream, its
    database compared after every staged step;
(c) a committed loop in both systems: ``set_relo``, the next frames' refined
    relative pose, the recorded edge, the PGO and the corrected poses;
(d) a second sequence: ``new_sequence`` + ``load_map`` + a cross-sequence
    commit re-bases the sequence.

Frames come from the port's renderer; random draws from JAX keys.  The
loop-closure chain (a) on its own, over a rendered 2-lap circuit, is
test_torch_pose_graph.py's test_loop_closure_chain_matches_jax (the JAX
system here alone takes over a minute of one CPU process).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.estimator.window import WindowConfig as JWindowConfig
from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import feature_tracker as jft
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu.models import pose_graph as jpg
from vplines_slam_tpu.pipeline.system import SlamSystem as JSlamSystem
from vplines_slam_tpu.utils import geometry as jgeo
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import feature_tracker as tft
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.models import pose_graph as tpg
from vplines_slam_tpu_torch.pipeline.system import SlamSystem
from test_torch_coldstart import CPU, WKW, jax_draws
from test_torch_coldstart_system import rendered
from test_torch_pose_graph import close

torch.set_num_threads(1)
F64 = torch.float64


# ---------------------------------------------------------------------------
# (b)-(d): the systems
# ---------------------------------------------------------------------------

PG_KW = dict(max_keyframes=4, n_features=96, n_window_pts=32, skip_recent=12)
N_STREAM = WKW["window"] + 1 + 7


def _db_checked(jsys, tsys, atol=1e-6):
    """count, seq, poses, sig, desc, kp, wdesc, w3d, w_valid of the two
    systems' databases, and their host mirrors."""
    jdb, tdb = jsys.db, convert.from_torch(tsys.db)
    assert tsys._db_count == jsys._db_count and tsys._db_seqs == jsys._db_seqs
    np.testing.assert_array_equal(tsys._kf_times, jsys._kf_times)
    assert np.asarray(jdb.p_vio).shape == tdb.p_vio.shape
    for f in ("count", "seq", "desc", "kp_valid", "wdesc", "w_valid", "loop_to"):
        np.testing.assert_array_equal(getattr(tdb, f), np.asarray(getattr(jdb, f)), err_msg=f)
    # relative 1e-6 as well: (c)'s relocalization (8 matches) walks the
    # refined loop edge tens of metres out, in both packages alike
    for f in ("p_vio", "q_vio", "p_pgo", "yaw_pgo", "sig", "kp_norm", "loop_t", "loop_yaw"):
        close(getattr(jdb, f), getattr(tdb, f), atol=atol, rtol=1e-6)
    # world points 2-7 m out carry the estimators' ~1e-6 relative agreement
    close(jdb.w3d, tdb.w3d, atol=atol, rtol=1e-5)


class Systems:
    """The JAX and the port SlamSystem (points, CLAHE off, loop closure on)
    fed the same stream in lockstep."""

    def __init__(self):
        n = N_STREAM
        (self.frame_t, self.imu_t, self.accs, self.gyrs, self.imgs, q_ic,
         p_ic) = rendered(n)
        kw = dict(max_features=40, min_dist=12, quality=0.005, f_threshold=1e4, ransac_hyps=4)
        wkw = dict(WKW, init_min_parallax=15.0 / 460.0)
        self.j = JSlamSystem(jcam.pinhole(110.0, 110.0, 80.0, 60.0, width=160, height=120),
                             JWindowConfig(**wkw), jft.TrackerConfig(equalize=False, **kw),
                             pg_cfg=jpg.PoseGraphConfig(**PG_KW), imu_params=jimu.default_params(),
                             q_ic=jnp.asarray(q_ic), p_ic=jnp.asarray(p_ic), dtype=jnp.float64)
        self.t = SlamSystem(tcam.pinhole(110.0, 110.0, 80.0, 60.0, width=160, height=120,
                                         dtype=F64, device=CPU),
                            WindowConfig(**wkw), tft.TrackerConfig(equalize=False, **kw),
                            pg_cfg=tpg.PoseGraphConfig(**PG_KW),
                            imu_params=timu.default_params(device=CPU), q_ic=q_ic, p_ic=p_ic,
                            dtype=F64, device=CPU)
        assert self.j.use_loop and self.t.use_loop
        self.t.frontend.ransac_draws = jax_draws(0, (4, 8), 40)
        self.t.vio.sfm_draws = jax_draws(0, (64, 8), WKW["max_points"])
        self.t.pnp_draws = jax_draws(1, (256, 6), PG_KW["n_window_pts"])
        self.i = 0
        self.k = 0
        self.outs = []
        self.jobs = {"j": [], "t": []}
        for name, s in (("j", self.j), ("t", self.t)):
            orig = s._lc_stage_extract

            def spy(job, orig=orig, name=name):
                orig(job)
                self.jobs[name].append(job)

            s._lc_stage_extract = spy

    def step(self):
        k = self.k
        while self.i < len(self.imu_t) and self.imu_t[self.i] <= self.frame_t[k]:
            for s in (self.j, self.t):
                s.add_imu(self.imu_t[self.i], self.accs[self.i], self.gyrs[self.i])
            self.i += 1
        jo = self.j.add_image(self.frame_t[k], self.imgs[k])
        to = self.t.add_image(self.frame_t[k], self.imgs[k])
        assert (jo is None) == (to is None), k
        if jo is not None:
            self.outs.append((jo, to))
            _outputs_close(jo, to)
        self.k += 1


def _outputs_close(jo, to):
    assert jo.t == to.t and jo.is_keyframe == to.is_keyframe
    assert jo.loop_closed == to.loop_closed
    for f in ("p_vio", "q_vio", "p_corrected", "q_corrected"):
        close(getattr(jo, f), getattr(to, f), atol=1e-6)


@pytest.fixture(scope="module")
def systems():
    return Systems()


def test_slam_system_loop_closure_matches_jax(systems):
    """(b) the cold start with loop closure on: outputs (1e-6) after every
    frame and the database after every staged step."""
    S = systems
    while S.k < N_STREAM - 2:
        S.step()
        _db_checked(S.j, S.t)
    assert S.t.vio.initialized and len(S.outs) >= 2
    assert S.j._db_count >= 2
    assert len(S.jobs["j"]) == len(S.jobs["t"]) == S.j._db_count


def _commit_lr(S, job):
    """A verified loop of job's keyframe onto keyframe 0, consistent with the
    database: its window points seen from keyframe 0's camera, keyframe 0's
    pose as the PnP pose, the relative pose of the two database poses."""
    jj = job["j"]
    db, st = S.j.db, S.j.vio.state
    p_old, q_old = np.asarray(db.p_vio[0]), np.asarray(db.q_vio[0])
    p_kf, q_kf = np.asarray(jj["p_kf"]), np.asarray(jj["q_kf"])
    q_wc, p_wc = jgeo.pose_compose(jnp.asarray(q_old), jnp.asarray(p_old), st.q_ic, st.p_ic)
    q_cw, p_cw = jgeo.pose_inverse(q_wc, p_wc)
    Xc = np.asarray(jax.vmap(lambda x: jgeo.transform_point(q_cw, p_cw, x))(jj["w3d"]))
    mm = np.asarray(jj["w_valid"]) & (Xc[:, 2] > 0.1)
    yaw = lambda q: float(jgeo.rot_to_ypr(jgeo.quat_to_rot(jnp.asarray(q)))[0])
    n = np.asarray(int(mm.sum()), np.int32)
    return jpg.LoopResult(
        ok=np.asarray(True),
        rel_t=np.asarray(jgeo.quat_rotate(jgeo.quat_conj(jnp.asarray(q_old)),
                                          jnp.asarray(p_kf - p_old))),
        rel_yaw=np.asarray(yaw(q_kf) - yaw(q_old)), n_inliers=n, n_matches=n,
        obs_old=Xc[:, :2] / np.where(mm, Xc[:, 2], 1.0)[:, None], match_mask=mm,
        p_old=p_old, q_old=q_old)


def test_committed_loop_matches_jax(systems):
    """(c) the same LoopResult committed in both systems (the newest keyframe
    still in the window onto keyframe 0) inside the next frame's drain, as a verification lands: the
    set_relo slots, then the next frame's refined relative pose recorded as
    the loop edge, the PGO and the corrected poses once the drift lands."""
    S = systems
    # the newest keyframe still in the window (relo finds its frame by stamp)
    ft = S.t.vio.data.frame_t.numpy()
    i = max(i for i, jb in enumerate(S.jobs["t"]) if np.abs(ft[:-1] - jb["t"]).min() < 2e-3)
    job = {"j": S.jobs["j"][i], "t": S.jobs["t"][i]}
    assert job["j"]["t"] == job["t"]["t"]
    jlr = _commit_lr(S, job)
    tlr = convert.from_torch(convert.to_torch(jlr, CPU))
    k = job["j"]["k"]
    armed = {}
    for name, s, lr in (("j", S.j, jlr), ("t", S.t, tlr)):
        c = dict(job[name], stage="commit", cand=0, cross_seq=False)

        def once(due_h=None, due_dev=None, s=s, c=c, lr=lr, name=name,
                 orig=s._advance_loop_stage):
            orig(due_h, due_dev)
            s._advance_loop_stage = orig
            s._lc_stage_commit(c, due_h=lr)
            assert c["done"] and s._pending_relo == (k, 0)
            d, st = s.vio.data, s.vio.state
            armed[name] = [np.array(x) for x in (d.relo_obs, d.relo_mask, d.relo_valid,
                                                 d.relo_stamp, st.p_relo, st.q_relo)]
            assert int(np.asarray(s.db.loop_to)[k]) == 0

        s._advance_loop_stage = once
    S.step()  # drains the previous frame, commits, then dispatches this one armed
    (j_obs, j_mask, j_valid, j_stamp, j_p, j_q), (t_obs, t_mask, t_valid, t_stamp, t_p, t_q) = (
        armed["j"], armed["t"])
    np.testing.assert_array_equal(t_mask, j_mask)
    assert bool(t_valid) and bool(j_valid) and t_mask.sum() > 5
    close(j_obs, t_obs, atol=1e-12)
    assert t_stamp.dtype == np.float64 and float(t_stamp) == float(j_stamp) == job["j"]["t"]
    close(j_p, t_p, atol=1e-12)
    close(j_q, t_q, atol=1e-12)
    _db_checked(S.j, S.t)
    while S.k < N_STREAM:
        S.step()
        _db_checked(S.j, S.t)
    S.outs.append((S.j.flush(), S.t.flush()))
    _outputs_close(*S.outs[-1])
    _db_checked(S.j, S.t)
    # the relo refinement replaced the committed edge, and the PGO ran
    assert S.j._pending_relo is None and S.t._pending_relo is None
    assert abs(float(S.t.db.loop_yaw[k]) - float(jlr.rel_yaw)) > 1e-9
    assert any(to.loop_closed for _, to in S.outs)
    close(S.j.R_drift, S.t.R_drift, atol=1e-6)
    close(S.j.t_drift, S.t.t_drift, atol=1e-6)


def test_second_sequence_rebases_as_jax(systems, tmp_path):
    """(d) new_sequence + load_map (the JAX system's saved map, in both) + a
    cross-sequence commit of a new keyframe onto the map: the re-base, the
    recorded edge, the PGO (the map held fixed) and the drift."""
    S = systems
    jpg.save_db(S.j.db, tmp_path / "map.npz")
    for s in (S.j, S.t):
        s.new_sequence()
        s.load_map(tmp_path / "map.npz")
    assert S.t.seq == S.j.seq == 2
    _db_checked(S.j, S.t)
    n = S.j._db_count
    ypr = np.array([25.0, 1.0, -2.0])
    q = np.asarray(jgeo.rot_to_quat(jgeo.ypr_to_rot(jnp.asarray(ypr))))
    p = np.asarray(S.j.db.p_vio[1]) + np.array([0.3, -0.2, 0.05])
    kf = dict(sig=np.asarray(S.j.db.sig[1]), desc=np.asarray(S.j.db.desc[1]),
              kp_norm=np.asarray(S.j.db.kp_norm[1]), kp_valid=np.asarray(S.j.db.kp_valid[1]),
              wdesc=np.asarray(S.j.db.wdesc[1]), w3d=np.asarray(S.j.db.w3d[1]),
              w_valid=np.asarray(S.j.db.w_valid[1]))
    order = ["sig", "desc", "kp_norm", "kp_valid", "wdesc", "w3d", "w_valid"]
    if n >= S.j.db.p_vio.shape[0]:  # the systems' capacity guard
        S.j.db, S.t.db = jpg.grow_db(S.j.db), tpg.grow_db(S.t.db)
    S.j.db = jpg.add_keyframe(S.j.db, S.j.pg_cfg, jnp.asarray(p), jnp.asarray(q),
                              *[jnp.asarray(kf[f]) for f in order], seq=2)
    S.t.db = tpg.add_keyframe(
        S.t.db, S.t.pg_cfg, torch.from_numpy(p), torch.from_numpy(q),
        *[torch.from_numpy(kf[f].view(np.int32).copy() if f in ("desc", "wdesc") else kf[f])
          for f in order], seq=2)
    Wp = PG_KW["n_window_pts"]
    jlr = jpg.LoopResult(
        ok=np.asarray(True), rel_t=np.array([0.25, -0.1, 0.02]), rel_yaw=np.asarray(-6.0),
        n_inliers=np.asarray(25, np.int32), n_matches=np.asarray(30, np.int32),
        obs_old=np.zeros((Wp, 2)), match_mask=np.zeros(Wp, bool), p_old=np.zeros(3),
        q_old=np.array([1.0, 0.0, 0.0, 0.0]))
    tlr = convert.from_torch(convert.to_torch(jlr, CPU))
    for s, lr in ((S.j, jlr), (S.t, tlr)):
        s._db_count += 1
        s._db_seqs.append(2)
        s._kf_times.append(float("nan"))
        job = dict(stage="commit", k=n, cand=1, cross_seq=True, t=0.0, Rb=np.eye(3),
                   tb=np.zeros(3), q_b=None, w_ids=np.zeros(Wp, np.int64))
        s._lc_stage_commit(job, due_h=lr)
        assert 2 in s._rebased_seqs
        s.flush()
    close(S.j.R_base, S.t.R_base, atol=1e-9)
    close(S.j.t_base, S.t.t_base, atol=1e-9)
    assert not np.allclose(S.t.t_base, 0.0)
    _db_checked(S.j, S.t)
    close(S.j.R_drift, S.t.R_drift, atol=1e-6)
    close(S.j.t_drift, S.t.t_drift, atol=1e-6)
    # the loaded map (seq 0) stayed where it was
    close(np.asarray(S.j.db.p_pgo[:n]), S.t.db.p_pgo[:n], atol=1e-6)
