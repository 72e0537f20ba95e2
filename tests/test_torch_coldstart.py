"""The cold-start entry path against the JAX reference: ``VioEngine`` from
an empty window through the initializer into tracking (torch f64 on the CPU
against JAX x64; ``SlamSystem`` is in test_torch_coldstart_system.py).

Both sides get the same inputs and the port gets JAX's random draws: the
engine's ``sfm_draws`` (the initializer's essential-matrix RANSAC) is
overridden to return what ``jax.random`` draws from the reference's key
sequence.  Observations are noise-free, so a RANSAC hypothesis that repeats
a sample (not reproducible across LAPACK builds) cannot change the kept
inlier set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vplines_slam_tpu.estimator.vio import VioEngine as JVioEngine
from vplines_slam_tpu.estimator.window import WindowConfig as JWindowConfig
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu.utils import geometry as jgeo
from vplines_slam_tpu.utils import synthetic as jsyn
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator.vio import VioEngine
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.models import imu as timu

torch.set_num_threads(1)

CPU = torch.device("cpu")
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
P_IC = np.array([0.05, 0.02, 0.03])
Q_IC = np.asarray(jgeo.rot_to_quat(jnp.asarray(R_BC)))
T0 = 1403636579.763555  # EuRoC-epoch stamps
WKW = dict(window=5, max_points=40, max_lines=2, max_imu=24)


def close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out), atol=atol, rtol=rtol)


def jax_draws(seed, shape, high):
    """The draws of successive ``key, k = split(key)`` calls from
    PRNGKey(seed): ``randint(k, shape, 0, high)``."""
    state = dict(key=jax.random.PRNGKey(seed))

    def draw():
        state["key"], k = jax.random.split(state["key"])
        return torch.as_tensor(np.array(jax.random.randint(k, shape, 0, high))).long()

    return draw


def stream(n_frames, n_landmarks=300):
    """Noise-free synthetic ids/rays (the landmarks each frame sees, first
    M - 8 of them) and 200 Hz IMU along the figure-8 from t = 0."""
    traj = jsyn.figure8_trajectory()
    X = jsyn.scatter_landmarks(n_landmarks, seed=0)
    frame_rel = np.arange(n_frames) * 0.1
    imu_rel = np.arange((n_frames - 1) * 20 + 1) * 0.005
    accs, gyrs = (np.asarray(a) for a in jsyn.imu_samples(traj, jnp.asarray(imu_rel)))
    M = WKW["max_points"]
    frames = []
    for t in frame_rel:
        q_cw, p_cw = jgeo.pose_inverse(*jgeo.pose_compose(traj.quat(t), traj.pos(t),
                                                          jnp.asarray(Q_IC), jnp.asarray(P_IC)))
        Xc = np.asarray(jax.vmap(lambda x: jgeo.transform_point(q_cw, p_cw, x))(X))
        uv = Xc[:, :2] / Xc[:, 2:3]
        vis = (Xc[:, 2] > 0.3) & (np.abs(uv[:, 0]) < 0.82) & (np.abs(uv[:, 1]) < 0.55)
        sel = np.flatnonzero(vis)[: M - 8]
        ids = np.full(M, -1, np.int64)
        rays = np.zeros((M, 3))
        rays[:, 2] = 1.0
        ids[: len(sel)] = sel
        rays[: len(sel), :2] = uv[sel]
        frames.append((ids, rays))
    imu_t = T0 + imu_rel
    return imu_t[::20], imu_t, accs, gyrs, frames


def test_vio_engine_cold_start_matches_jax():
    """Fill, initialization and four tracked frames; every output and the
    post-init window compared (the solves run at f64: 1e-6)."""
    n = WKW["window"] + 1 + 4
    frame_t, imu_t, accs, gyrs, frames = stream(n)
    jeng = JVioEngine(JWindowConfig(**WKW), jimu.default_params(), q_ic=jnp.asarray(Q_IC),
                      p_ic=jnp.asarray(P_IC))
    teng = VioEngine(WindowConfig(**WKW), timu.default_params(device=CPU), q_ic=Q_IC,
                     p_ic=P_IC, device=CPU)
    teng.sfm_draws = jax_draws(0, (64, 8), WKW["max_points"])
    assert (jeng._sync is None) == (teng._sync is None)
    i = 0
    n_out = 0
    for k in range(n):
        while i < len(imu_t) and imu_t[i] <= frame_t[k]:
            jeng.add_imu(imu_t[i], accs[i], gyrs[i])
            teng.add_imu(imu_t[i], accs[i], gyrs[i])
            i += 1
        jo = jeng.add_frame(frame_t[k], *frames[k])
        to = teng.add_frame(frame_t[k], *frames[k])
        assert (jo is None) == (to is None), k
        assert jeng.initialized == teng.initialized and jeng.frame_count == teng.frame_count
        if jo is None:
            continue
        n_out += 1
        for f in ("p", "q", "v", "ba", "bg"):
            close(getattr(jo, f), getattr(to, f), atol=1e-6)
        assert bool(jo.is_keyframe) == to.is_keyframe and bool(jo.failure) == to.failure
        close(jo.ba_cost, to.ba_cost, atol=1e-8, rtol=1e-5)
        if n_out == 1:  # the post-init window
            js, ts = jeng.state, convert.from_torch(teng.state)
            for f in ("p", "q", "v", "ba", "bg"):
                close(getattr(js, f), getattr(ts, f), atol=1e-6)
            jd, td = jeng.data, convert.from_torch(teng.data)
            assert np.array_equal(np.asarray(jd.pt_id), td.pt_id)
            assert np.array_equal(np.asarray(jd.pt_solved), td.pt_solved)
            solved = np.asarray(jd.pt_solved)
            close(np.asarray(jd.pt_inv_depth)[solved], td.pt_inv_depth[solved], atol=1e-6)
            close(jd.frame_t, td.frame_t, atol=0)
            close(jd.imu_pre.delta_q, td.imu_pre.delta_q, atol=1e-9)
    assert teng.initialized and n_out == 5
