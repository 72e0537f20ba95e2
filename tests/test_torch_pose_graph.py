"""Loop closure's database, verification and 4-DoF pose graph against the
JAX reference (torch f64 on the CPU, the kernels' plain twins, against JAX
x64): ``ransac_pnp``, ``verify_loop``, ``retrieve_candidates``,
``add_keyframe``/``record_loop``/``grow_db``, ``save_db``/``load_db`` across
the two packages, ``rebase_sequence``, ``optimize_4dof``,
``drift_correction``, the converter, and the whole loop-closure chain over
a rendered 2-lap circuit with synthetic VIO drift (extract -> add ->
retrieve -> candidate gate -> oldest-first verification -> record, then the
PGO and the drift correction).

Random draws come from JAX keys and are handed to the port as inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import pose_graph as jpg
from vplines_slam_tpu.ops import mvg as jmvg
from vplines_slam_tpu.utils import geometry as jgeo
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import pose_graph as tpg
from vplines_slam_tpu_torch.ops import mvg as tmvg
from vplines_slam_tpu_torch.utils import demo
from vplines_slam_tpu_torch.utils import geometry as tgeo
from vplines_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
LH, LW = 120, 160
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out), atol=atol, rtol=rtol)


def jax_draws(key, n_hyp, N, S=6):
    return np.asarray(jax.random.randint(key, (n_hyp, S), 0, N))


def assert_db_equal(jdb, tdb, atol=1e-12):
    """Every field of a JAX database against the port's (descriptors bit for
    bit, ints and bools exact, floats to atol)."""
    back = convert.from_torch(tdb)
    for f in jdb._fields:
        a, b = np.asarray(getattr(jdb, f)), np.asarray(getattr(back, f))
        assert a.shape == b.shape, f
        if a.dtype.kind in "iub":
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=f)


# ---------------------------------------------------------------------------
# the rendered loop circuit
# ---------------------------------------------------------------------------


class LoopWorld:
    """A 120x160 camera looking inward from the loop_trajectory circuit
    (radius 3 m) in the blob world; frames, window points and truth from the
    port's renderer, fed to both packages."""

    def __init__(self, n_pts=420):
        self.tcam = tcam.pinhole(110.0, 110.0, LW / 2, LH / 2, width=LW, height=LH, dtype=F64,
                                 device=CPU)
        self.jcam = jcam.pinhole(110.0, 110.0, LW / 2, LH / 2, width=LW, height=LH)
        self.q_ic = tgeo.rot_to_quat(torch.tensor(R_BC))
        self.p_ic = torch.zeros(3, dtype=F64)
        self.rend = demo.BlobWorldRenderer(self.tcam, self.q_ic, self.p_ic, n_pts=n_pts, seed=4,
                                           dtype=F64, device=CPU)
        self.traj = tsyn.loop_trajectory(radius=3.0)

    def pose(self, t):
        t = torch.tensor(float(t), dtype=F64)
        return self.traj.quat(t), self.traj.pos(t)

    def window_points(self, q_wb, p_wb, n):
        """The n nearest landmarks the camera sees inside the 16 px border:
        (world 3D, pixel, valid)."""
        q_wc, p_wc = tgeo.pose_compose(q_wb, p_wb, self.q_ic, self.p_ic)
        q_cw, p_cw = tgeo.pose_inverse(q_wc, p_wc)
        X = self.rend.X
        Xc = tgeo.transform_point(q_cw, p_cw, X)
        uv, vis = tcam.project(self.tcam, Xc)
        ok = (vis & (Xc[:, 2] > 0.5) & (uv[:, 0] >= 16) & (uv[:, 0] < LW - 16)
              & (uv[:, 1] >= 16) & (uv[:, 1] < LH - 16))
        idx = torch.argsort(torch.where(ok, Xc[:, 2], torch.full_like(Xc[:, 2], 1e9)),
                            stable=True)[:n]
        return X[idx].numpy(), uv[idx].numpy(), ok[idx].numpy()

    def keyframe(self, t, n_window, img=None):
        """(q, p, image, window points) at time t; img: the image of this
        pose if already rendered."""
        q, p = self.pose(t)
        if img is None:
            img = self.rend.render(q, p).numpy()
        w3d, wxy, wv = self.window_points(q, p, n_window)
        return q.numpy(), p.numpy(), img, w3d, wxy, wv


_WORLD = {}


def loop_world():
    if "w" not in _WORLD:
        _WORLD["w"] = LoopWorld()
    return _WORLD["w"]


def drifted(rng_state, q_gt, p_gt, w3d):
    """Apply one more step of the synthetic VIO drift (yaw walk 0.15 deg,
    translation walk 0.01 m per keyframe) to a keyframe's pose and points."""
    rng_state["yaw"] += rng_state["rng"].normal(0.0, 0.15)
    rng_state["t"] = rng_state["t"] + rng_state["rng"].normal(0.0, 0.01, 3)
    Rz = np.asarray(jgeo.ypr_to_rot(jnp.asarray([rng_state["yaw"], 0.0, 0.0])))
    p_vio = Rz @ p_gt + rng_state["t"]
    q_vio = np.asarray(jgeo.rot_to_quat(jnp.asarray(Rz @ np.asarray(
        jgeo.quat_to_rot(jnp.asarray(q_gt))))))
    return p_vio, q_vio, w3d @ Rz.T + rng_state["t"]


# ---------------------------------------------------------------------------
# PnP-RANSAC
# ---------------------------------------------------------------------------


def _pnp_problem(seed=0, N=64, outlier=0.4):
    rng = np.random.default_rng(seed)
    R = np.asarray(jgeo.ypr_to_rot(jnp.asarray([20.0, -5.0, 3.0])))
    t = np.array([0.2, -0.1, 0.3])
    Xc = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(2, 6, N)], 1)
    X_w = (Xc - t) @ R  # R X_w + t = Xc
    x = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 1e-3, (N, 2))
    bad = rng.random(N) < outlier
    x[bad] = rng.uniform(-0.6, 0.6, (bad.sum(), 2))
    mask = rng.random(N) < 0.9
    return X_w, x, mask


def test_ransac_pnp_matches_jax():
    X_w, x, mask = _pnp_problem()
    key = jax.random.PRNGKey(3)
    thr = 8.0 / 460.0
    jR, jt, jinl, jn = map(np.asarray, jax.jit(
        lambda *a: jmvg.ransac_pnp(*a, n_hyp=256, threshold=thr))(
            jnp.asarray(X_w), jnp.asarray(x), jnp.asarray(mask), key))
    draws = torch.as_tensor(jax_draws(key, 256, 64))
    tR, tt, tinl, tn = tmvg.ransac_pnp(torch.from_numpy(X_w), torch.from_numpy(x),
                                       torch.from_numpy(mask), draws, threshold=thr)
    close(jR, tR, atol=1e-9)
    close(jt, tt, atol=1e-9)
    np.testing.assert_array_equal(tinl.numpy(), jinl)
    assert int(tn) == int(jn) and int(jn) > 25
    # the hypotheses one by one: counts of the full-rank ones exactly
    order = np.argsort(~mask, kind="stable")
    idx = order[draws.numpy() % max(mask.sum(), 6)]
    full = np.array([len(set(r.tolist())) == 6 and mask[r].all() for r in idx])

    def hyp(sample):
        sm = jnp.zeros(64, bool).at[sample].set(True) & jnp.asarray(mask)
        R, t, _ = jmvg.pnp_dlt(jnp.asarray(X_w), jnp.asarray(x), sm)
        Xc = jnp.asarray(X_w) @ R.T + t
        good = Xc[:, 2] > 0.05
        proj = Xc[:, :2] / jnp.where(good, Xc[:, 2], 1.0)[:, None]
        err = jnp.linalg.norm(proj - jnp.asarray(x), axis=-1)
        return jnp.sum(((err < thr) & jnp.asarray(mask) & good).astype(jnp.int32))

    jc = np.asarray(jax.jit(jax.vmap(hyp))(jnp.asarray(idx)))
    _, _, tc, _ = tmvg.pnp_hypotheses(torch.from_numpy(X_w), torch.from_numpy(x),
                                      torch.from_numpy(mask), torch.from_numpy(idx), thr)
    assert full.sum() > 150
    np.testing.assert_array_equal(tc.numpy()[full], jc[full])


# ---------------------------------------------------------------------------
# database ops
# ---------------------------------------------------------------------------


def _random_kf(rng, cfg):
    F, Wp = cfg.n_features, cfg.n_window_pts
    ypr = rng.uniform([-180, -10, -10], [180, 10, 10])
    q = np.asarray(jgeo.rot_to_quat(jgeo.ypr_to_rot(jnp.asarray(ypr))))
    sig = rng.normal(0, 1, 1024).astype(np.float32)
    return dict(
        p_vio=rng.normal(0, 2, 3), q_vio=q, sig=sig / np.linalg.norm(sig),
        desc=rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint64).astype(np.uint32),
        kp_norm=rng.normal(0, 0.3, (F, 2)), kp_valid=rng.random(F) < 0.8,
        wdesc=rng.integers(0, 2 ** 32, (Wp, 8), dtype=np.uint64).astype(np.uint32),
        w3d=rng.normal(0, 3, (Wp, 3)), w_valid=rng.random(Wp) < 0.7)


def _add_both(jdb, tdb, jcfg, tcfg, kf, seq=1):
    order = ["p_vio", "q_vio", "sig", "desc", "kp_norm", "kp_valid", "wdesc", "w3d", "w_valid"]
    jdb = jpg.add_keyframe(jdb, jcfg, *[jnp.asarray(kf[k]) for k in order], seq=seq)
    targs = [torch.from_numpy(np.asarray(kf[k]).view(np.int32).copy()) if k in ("desc", "wdesc")
             else torch.from_numpy(np.asarray(kf[k])) for k in order]
    tdb = tpg.add_keyframe(tdb, tcfg, *targs, seq=seq)
    return jdb, tdb


def _dbs(n, cap=8, seqs=None, seed=0, **kw):
    """A JAX and a port database holding the same n random keyframes (the
    capacity doubling when full)."""
    rng = np.random.default_rng(seed)
    ckw = dict(max_keyframes=cap, n_features=12, n_window_pts=6, **kw)
    jcfg, tcfg = jpg.PoseGraphConfig(**ckw), tpg.PoseGraphConfig(**ckw)
    jdb, tdb = jpg.empty_db(jcfg, jnp.float64), tpg.empty_db(tcfg, F64, CPU)
    for k in range(n):
        if k >= jdb.p_vio.shape[0]:
            jdb, tdb = jpg.grow_db(jdb), tpg.grow_db(tdb)
        jdb, tdb = _add_both(jdb, tdb, jcfg, tcfg, _random_kf(rng, jcfg),
                             seq=1 if seqs is None else seqs[k])
    return jdb, tdb, jcfg, tcfg


def test_add_record_grow_match_jax():
    jdb, tdb, _, _ = _dbs(11, cap=4)  # grows 4 -> 8 -> 16
    assert jdb.p_vio.shape[0] == 16
    assert_db_equal(jdb, tdb)
    jdb = jpg.record_loop(jdb, jnp.asarray(9), jnp.asarray(2), jnp.asarray([0.1, -0.2, 0.3]),
                          jnp.asarray(4.5))
    tdb = tpg.record_loop(tdb, 9, 2, torch.tensor([0.1, -0.2, 0.3], dtype=F64),
                          torch.tensor(4.5, dtype=F64))
    assert_db_equal(jdb, tdb)
    assert_db_equal(jpg.grow_db(jdb, 3), tpg.grow_db(tdb, 3))


@pytest.mark.parametrize("case", ["recency", "cross_seq", "few_eligible"])
def test_retrieve_candidates_matches_jax(case):
    """recency: only keyframes older than skip_recent compete; cross_seq:
    keyframes of another sequence are exempt with query_seq; few_eligible:
    fewer eligible than top_k, so the -1 scores tie and keep index order.
    The neighbour floor each time."""
    n = {"recency": 30, "cross_seq": 30, "few_eligible": 12}[case]
    seqs = [1] * 20 + [0] * 10 if case == "cross_seq" else None
    jdb, tdb, jcfg, tcfg = _dbs(n, cap=32, seqs=seqs, skip_recent=9, recent_ref=5)
    rng = np.random.default_rng(7)
    near = 1 if case == "few_eligible" else 25  # 25 lies in the recency zone
    q = np.asarray(jdb.sig[near]) + 0.3 * rng.normal(0, 1 / 32, 1024).astype(np.float32)
    qs = 1 if case == "cross_seq" else None
    ji, js, jf = map(np.asarray, jpg.retrieve_candidates(jdb, jcfg, jnp.asarray(q),
                                                         query_seq=qs))
    ti, ts, tf = tpg.retrieve_candidates(tdb, tcfg, torch.from_numpy(q), query_seq=qs)
    np.testing.assert_array_equal(ti.numpy(), ji)
    close(js, ts, atol=1e-6)  # f32 sums in another order
    close(jf, tf, atol=1e-6)
    if case == "few_eligible":
        assert ji[0] == 1 and (js == -1.0).sum() >= 1
    else:
        assert (ji[0] == 25) == (case == "cross_seq")


def test_save_load_across_packages(tmp_path):
    jdb, tdb, _, _ = _dbs(6, cap=8)
    jdb = jpg.record_loop(jdb, jnp.asarray(5), jnp.asarray(1), jnp.asarray([0.1, 0.0, 0.2]),
                          jnp.asarray(-3.0))
    tdb = tpg.record_loop(tdb, 5, 1, torch.tensor([0.1, 0.0, 0.2], dtype=F64),
                          torch.tensor(-3.0, dtype=F64))
    jpg.save_db(jdb, tmp_path / "jax.npz")
    assert_db_equal(jdb, tpg.load_db(tmp_path / "jax.npz", CPU))
    tpg.save_db(tdb, tmp_path / "port.npz")
    back = jpg.load_db(tmp_path / "port.npz")
    assert_db_equal(back, tdb)
    assert np.asarray(back.desc).dtype == np.uint32 and np.asarray(back.seq).dtype == np.int32


def test_rebase_sequence_matches_jax():
    jdb, tdb, jcfg, tcfg = _dbs(9, cap=16, seqs=[0] * 5 + [2] * 4)
    jdb = jpg.record_loop(jdb, jnp.asarray(7), jnp.asarray(2), jnp.asarray([0.3, -0.1, 0.05]),
                          jnp.asarray(12.0))
    tdb = tpg.record_loop(tdb, 7, 2, torch.tensor([0.3, -0.1, 0.05], dtype=F64),
                          torch.tensor(12.0, dtype=F64))
    jdb2, (jR, jt) = jpg.rebase_sequence(jdb, jcfg, jnp.asarray(7), jnp.asarray(2))
    tdb2, (tR, tt) = tpg.rebase_sequence(tdb, tcfg, 7, 2)
    close(jR, tR, atol=1e-12)
    close(jt, tt, atol=1e-12)
    assert_db_equal(jdb2, tdb2)
    assert not np.allclose(np.asarray(jdb2.p_vio[5:9]), np.asarray(jdb.p_vio[5:9]))


def _pgo_dbs():
    """K = 64 capacity, 40 keyframes along a drifted circle with loop edges
    (one inactive row beyond count carries one too) and a seq 0 keyframe."""
    rng = np.random.default_rng(2)
    ckw = dict(max_keyframes=64, n_features=4, n_window_pts=4)
    jcfg, tcfg = jpg.PoseGraphConfig(**ckw), tpg.PoseGraphConfig(**ckw)
    jdb, tdb = jpg.empty_db(jcfg, jnp.float64), tpg.empty_db(tcfg, F64, CPU)
    yaw_d, t_d = 0.0, np.zeros(3)
    for k in range(40):
        a = 2 * np.pi * k / 20
        yaw_d += rng.normal(0, 0.5)
        t_d = t_d + rng.normal(0, 0.03, 3)
        Rz = np.asarray(jgeo.ypr_to_rot(jnp.asarray([yaw_d, 0.0, 0.0])))
        p = Rz @ np.array([3 * np.cos(a), 3 * np.sin(a), 0.2 * np.sin(2 * a)]) + t_d
        ypr = np.array([np.degrees(a) + 180.0 + yaw_d, 4 * np.sin(a), 3 * np.cos(a)])
        q = np.asarray(jgeo.rot_to_quat(jgeo.ypr_to_rot(jnp.asarray(ypr))))
        kf = _random_kf(rng, jcfg)
        kf.update(p_vio=p, q_vio=q)
        jdb, tdb = _add_both(jdb, tdb, jcfg, tcfg, kf, seq=0 if k == 3 else 1)
    for k, c, rt, ry in [(22, 2, [0.2, 0.1, 0.0], 3.0), (30, 10, [-0.1, 0.3, 0.05], -8.0),
                         (39, 19, [0.0, 0.0, 0.1], 200.0), (45, 5, [1.0, 1.0, 1.0], 9.0)]:
        jdb = jpg.record_loop(jdb, jnp.asarray(k), jnp.asarray(c), jnp.asarray(rt),
                              jnp.asarray(ry))
        tdb = tpg.record_loop(tdb, k, c, torch.tensor(rt, dtype=F64),
                              torch.tensor(ry, dtype=F64))
    return jdb, tdb, jcfg, tcfg


def test_optimize_4dof_matches_jax():
    jdb, tdb, jcfg, tcfg = _pgo_dbs()
    jdb2, jout = jax.jit(lambda db: jpg.optimize_4dof(db, jcfg))(jdb)
    tdb2, tout = tpg.optimize_4dof(tdb, tcfg)
    close(jdb2.p_pgo, tdb2.p_pgo, atol=1e-8)
    close(jdb2.yaw_pgo, tdb2.yaw_pgo, atol=1e-8)
    for f in ("cost0", "cost", "lam", "grad_norm"):
        close(getattr(jout, f), getattr(tout, f), atol=0, rtol=1e-9)
    assert float(jout.cost) < 0.6 * float(jout.cost0)
    x = torch.cat([tdb.yaw_pgo[:, None], tdb.p_pgo], 1)
    r, H, g = tpg.pgo_normal(x, tdb, tpg._ypr_vio(tdb), tcfg)
    assert r.shape == (64 * 24,) and H.shape == (256, 256) and torch.equal(H, H.T)
    Rd_j, td_j = jpg.drift_correction(jdb2, jcfg)
    Rd_t, td_t = tpg.drift_correction(tdb2, tcfg)
    close(Rd_j, Rd_t, atol=1e-8)
    close(td_j, td_t, atol=1e-8)


def test_drift_correction_matches_jax():
    jdb, tdb, jcfg, tcfg = _dbs(7, cap=8)
    jdb = jdb._replace(yaw_pgo=jdb.yaw_pgo + 7.0, p_pgo=jdb.p_pgo + 0.4)
    tdb = tdb._replace(yaw_pgo=tdb.yaw_pgo + 7.0, p_pgo=tdb.p_pgo + 0.4)
    for a, b in zip(jpg.drift_correction(jdb, jcfg), tpg.drift_correction(tdb, tcfg)):
        close(a, b, atol=1e-12)


def test_converter_round_trip():
    jdb, _, jcfg, _ = _dbs(5, cap=8, seqs=[0, 0, 1, 1, 1])
    jdb = jpg.grow_db(jdb)
    tdb = convert.to_torch(jdb, CPU)
    assert tdb.desc.dtype == torch.int32 and tdb.seq.dtype == torch.int64
    assert tdb.sig.dtype == torch.float32 and tdb.count.dim() == 0
    assert_db_equal(jdb, tdb, atol=0)
    tcfg = convert.to_torch(jcfg, CPU)
    assert isinstance(tcfg, tpg.PoseGraphConfig) and tuple(tcfg) == tuple(jcfg)
    assert convert.from_torch(tcfg) == tcfg
    lr = jpg.LoopResult(ok=jnp.asarray(True), rel_t=jnp.ones(3), rel_yaw=jnp.asarray(2.0),
                        n_inliers=jnp.asarray(30, jnp.int32), n_matches=jnp.asarray(40, jnp.int32),
                        obs_old=jnp.zeros((6, 2)), match_mask=jnp.arange(6) < 3,
                        p_old=jnp.zeros(3), q_old=jnp.asarray([1.0, 0, 0, 0]))
    tlr = convert.to_torch(lr, CPU)
    assert isinstance(tlr, tpg.LoopResult) and bool(tlr.ok) and int(tlr.n_inliers) == 30
    back = convert.from_torch(tlr)
    for f in lr._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(lr, f)))
    assert np.asarray(back.n_inliers).dtype == np.int32


def test_verify_loop_matches_jax():
    """A revisit of a rendered keyframe (the same place 2 cm and 1 deg away,
    drifted world points): every LoopResult field, draws from one JAX key."""
    w = loop_world()
    ckw = dict(max_keyframes=8, n_features=96, n_window_pts=48, min_matches=12,
               pnp_thresh=8.0 / 110.0)
    jcfg, tcfg = jpg.PoseGraphConfig(**ckw), tpg.PoseGraphConfig(**ckw)
    jlift = lambda xy: jcam.lift(w.jcam, xy)
    tlift = lambda xy: tcam.lift(w.tcam, xy)
    jextract = jax.jit(lambda img, wxy, wv: jpg.extract_keyframe_features(
        img, jlift, jcfg, window_xy=(wxy, wv)))
    jdb, tdb = jpg.empty_db(jcfg, jnp.float64), tpg.empty_db(tcfg, F64, CPU)
    fbs = []
    state = dict(rng=np.random.default_rng(0), yaw=0.0, t=np.zeros(3))
    for t in (4.0, 4.03):
        q, p, img, w3d, wxy, wv = w.keyframe(t, ckw["n_window_pts"])
        p_vio, q_vio, w3d_v = drifted(state, q, p, w3d)
        jfb = jextract(jnp.asarray(img), jnp.asarray(wxy), jnp.asarray(wv))
        tfb = tpg.extract_keyframe_features(torch.from_numpy(img), tlift, tcfg,
                                            window_xy=(torch.from_numpy(wxy),
                                                       torch.from_numpy(wv)))
        jdb = jpg.add_keyframe(jdb, jcfg, jnp.asarray(p_vio), jnp.asarray(q_vio), jfb["sig"],
                               jfb["desc"], jfb["kp_norm"], jfb["kp_valid"], jfb["wdesc"],
                               jnp.asarray(w3d_v), jnp.asarray(wv))
        tdb = tpg.add_keyframe(tdb, tcfg, torch.from_numpy(p_vio), torch.from_numpy(q_vio),
                               tfb["sig"], tfb["desc"], tfb["kp_norm"], tfb["kp_valid"],
                               tfb["wdesc"], torch.from_numpy(w3d_v), torch.from_numpy(wv))
        fbs.append((jfb, tfb, p_vio, q_vio, w3d_v, wv))
    assert_db_equal(jdb, tdb)
    jfb, tfb, p_vio, q_vio, w3d_v, wv = fbs[1]
    key = jax.random.PRNGKey(11)
    q_ic = np.asarray(w.q_ic)
    jlr = jax.jit(lambda *a: jpg.verify_loop(jdb, jcfg, *a, q_ic=jnp.asarray(q_ic),
                                             p_ic=jnp.zeros(3)))(
        jnp.asarray(0), jfb["wdesc"], jnp.asarray(w3d_v), jnp.asarray(wv), jnp.asarray(p_vio),
        jnp.asarray(q_vio), key)
    tlr = tpg.verify_loop(tdb, tcfg, 0, tfb["wdesc"], torch.from_numpy(w3d_v),
                          torch.from_numpy(wv), torch.from_numpy(p_vio), torch.from_numpy(q_vio),
                          torch.as_tensor(jax_draws(key, 256, ckw["n_window_pts"])),
                          q_ic=torch.from_numpy(q_ic), p_ic=torch.zeros(3, dtype=F64))
    assert bool(jlr.ok) and int(jlr.n_inliers) >= 12
    for f in ("ok", "n_inliers", "n_matches", "match_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(tlr, f)), np.asarray(getattr(jlr, f)))
    for f in ("rel_t", "rel_yaw", "obs_old", "p_old", "q_old"):
        close(getattr(jlr, f), getattr(tlr, f), atol=1e-9)


def _lr_fields_equal(jlr, tlr, atol=1e-9):
    for f in ("ok", "n_inliers", "n_matches", "match_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(tlr, f)), np.asarray(getattr(jlr, f)),
                                      err_msg=f)
    for f in ("rel_t", "rel_yaw", "obs_old", "p_old", "q_old"):
        close(getattr(jlr, f), getattr(tlr, f), atol=atol)


def test_loop_closure_chain_matches_jax():
    """2 laps x 20 keyframes of the circuit (lap 2 revisits lap 1's poses),
    skip_recent 12, capacity 32 (grown to 64).  Per keyframe the candidates,
    scores and floor; per verification every LoopResult field; then the
    loops, the PGO'd poses and the drift correction.  Loops close in both."""
    w = loop_world()
    ckw = dict(max_keyframes=32, n_features=96, n_window_pts=48, skip_recent=12,
               min_matches=12, pnp_thresh=8.0 / 110.0)
    jcfg, tcfg = jpg.PoseGraphConfig(**ckw), tpg.PoseGraphConfig(**ckw)
    jlift = lambda xy: jcam.lift(w.jcam, xy)
    tlift = lambda xy: tcam.lift(w.tcam, xy)
    q_ic = np.asarray(w.q_ic)
    jextract = jax.jit(lambda img, wxy, wv: jpg.extract_keyframe_features(
        img, jlift, jcfg, window_xy=(wxy, wv)))
    jretrieve = jax.jit(lambda db, sig: jpg.retrieve_candidates(db, jcfg, sig))
    jverify = jax.jit(lambda db, cand, wdesc, w3d, wv, p, q, key: jpg.verify_loop(
        db, jcfg, cand, wdesc, w3d, wv, p, q, key, q_ic=jnp.asarray(q_ic), p_ic=jnp.zeros(3)))
    jdb, tdb = jpg.empty_db(jcfg, jnp.float64), tpg.empty_db(tcfg, F64, CPU)
    drift = dict(rng=np.random.default_rng(0), yaw=0.0, t=np.zeros(3))
    key = jax.random.PRNGKey(0)
    times = np.linspace(0.0, 60.0, 40, endpoint=False)
    frames = {}  # lap 2 repeats lap 1's poses (period 30 s): render each once
    loops, gt, n_verify = [], [], 0
    for k, t in enumerate(times):
        if t % 30.0 not in frames:
            frames[t % 30.0] = w.keyframe(t, ckw["n_window_pts"])[2]
        q, p, img, w3d, wxy, wv = w.keyframe(t, ckw["n_window_pts"], img=frames[t % 30.0])
        gt.append(p)
        p_vio, q_vio, w3d_v = drifted(drift, q, p, w3d)
        jfb = jextract(jnp.asarray(img), jnp.asarray(wxy), jnp.asarray(wv))
        tfb = tpg.extract_keyframe_features(torch.from_numpy(img), tlift, tcfg,
                                            window_xy=(torch.from_numpy(wxy),
                                                       torch.from_numpy(wv)))
        if k >= jdb.p_vio.shape[0]:
            jdb, tdb = jpg.grow_db(jdb), tpg.grow_db(tdb)
        jdb = jpg.add_keyframe(jdb, jcfg, jnp.asarray(p_vio), jnp.asarray(q_vio), jfb["sig"],
                               jfb["desc"], jfb["kp_norm"], jfb["kp_valid"], jfb["wdesc"],
                               jnp.asarray(w3d_v), jnp.asarray(wv))
        tdb = tpg.add_keyframe(tdb, tcfg, torch.from_numpy(p_vio), torch.from_numpy(q_vio),
                               tfb["sig"], tfb["desc"], tfb["kp_norm"], tfb["kp_valid"],
                               tfb["wdesc"], torch.from_numpy(w3d_v), torch.from_numpy(wv))
        ji, js, jf = map(np.asarray, jretrieve(jdb, jfb["sig"]))
        ti, ts, tf = tpg.retrieve_candidates(tdb, tcfg, tfb["sig"])
        np.testing.assert_array_equal(ti.numpy(), ji, err_msg=f"keyframe {k}")
        close(js, ts, atol=1e-6)  # f32 signature sums in another order
        close(jf, tf, atol=1e-6)
        best = float(js[0])
        if k <= jcfg.skip_recent or best <= max(jcfg.min_score, float(jf)):
            continue
        queue = sorted(int(c) for c, s in zip(ji, js) if s >= best - jcfg.rel_margin)
        for cand in queue:  # oldest first, the next one when a verification fails
            key, kk = jax.random.split(key)
            jlr = jverify(jdb, jnp.asarray(cand), jfb["wdesc"], jnp.asarray(w3d_v),
                          jnp.asarray(wv), jnp.asarray(p_vio), jnp.asarray(q_vio), kk)
            tlr = tpg.verify_loop(tdb, tcfg, cand, tfb["wdesc"], torch.from_numpy(w3d_v),
                                  torch.from_numpy(wv), torch.from_numpy(p_vio),
                                  torch.from_numpy(q_vio),
                                  torch.as_tensor(np.asarray(jax.random.randint(
                                      kk, (256, 6), 0, ckw["n_window_pts"]))),
                                  q_ic=torch.from_numpy(q_ic), p_ic=torch.zeros(3, dtype=F64))
            _lr_fields_equal(jlr, tlr)
            n_verify += 1
            if bool(jlr.ok):
                jdb = jpg.record_loop(jdb, jnp.asarray(k), jnp.asarray(cand), jlr.rel_t,
                                      jlr.rel_yaw)
                tdb = tpg.record_loop(tdb, k, cand, tlr.rel_t, tlr.rel_yaw)
                loops.append((k, cand))
                break
    assert jdb.p_vio.shape[0] == 64
    assert loops, f"no loop closed in {n_verify} verifications"
    for k, c in loops:  # every accepted loop is a true revisit
        assert np.linalg.norm(gt[k] - gt[c]) < 1.0, (k, c)
    assert_db_equal(jdb, tdb, atol=1e-9)
    jdb2, jout = jax.jit(lambda db: jpg.optimize_4dof(db, jcfg))(jdb)
    tdb2, tout = tpg.optimize_4dof(tdb, tcfg)
    close(jdb2.p_pgo, tdb2.p_pgo, atol=1e-8)
    close(jdb2.yaw_pgo, tdb2.yaw_pgo, atol=1e-8)
    close(jout.cost, tout.cost, atol=0, rtol=1e-9)
    for a, b in zip(jpg.drift_correction(jdb2, jcfg), tpg.drift_correction(tdb2, tcfg)):
        close(a, b, atol=1e-8)
    n = len(times)
    err_before = np.linalg.norm(np.asarray(tdb.p_pgo[:n]) - np.stack(gt), axis=1)
    err_after = np.linalg.norm(tdb2.p_pgo[:n].numpy() - np.stack(gt), axis=1)
    assert err_after[-1] < err_before[-1], (err_before[-1], err_after[-1])
