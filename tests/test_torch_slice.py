"""The slice: the port's points-only device loop against the JAX reference's
``make_device_loop(...).run``, frame by frame, from one JAX carry converted
with ``convert.py`` (torch f64 on the CPU against JAX x64).

The carry is initialized the way the port's truth-seeded warm-up does it,
but with the reference's own functions: states at truth, the JAX tracker on
rendered frames, ingest + IMU intervals, triangulation.  The reference runs
with max_lines=2 and empty line tables (its default weights stack zero line
and VP rows); the port runs its points-only layout, so matching frames also
prove that layout equivalent.

RANSAC runs at the real 1 px gate.  Each frame's draws are JAX's own
(``randint(key, (hyps, 8), 0, M)`` with the frame's key, as ``frame_step``
passes it through), with the key chosen on the tracker state the frame meets
so that no hypothesis repeats a sample (tests/test_torch_models.tracker_key):
a sample with repeats has no unique 8-point fit, and which null vector
``eigh`` returns is not portable between LAPACK builds.  The points-only
loop's tracker never reads the estimator, so stepping the JAX tracker alone
gives the states the loop will meet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vplines_slam_tpu.estimator import slide as jslide
from vplines_slam_tpu.estimator import window as jwin
from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import feature_tracker as jft
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu.ops import klt as jklt
from vplines_slam_tpu.pipeline.device_loop import make_device_loop as jmake_device_loop
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import feature_tracker as tft
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.ops import klt as tklt
from vplines_slam_tpu_torch.pipeline.device_loop import make_device_loop
from vplines_slam_tpu_torch.utils import demo, synthetic
from test_torch_models import tracker_key

torch.set_num_threads(1)

H, W = 120, 160
K = (100.0, 100.0, W / 2, H / 2, -0.1, 0.02, 0.0, 0.0)
WKW = dict(window=4, max_points=40, max_lines=2, max_imu=8)
TKW = dict(max_features=40, min_dist=15, quality=0.003, ransac_hyps=4)
FRAME_DT, IMU_DT = 0.05, 0.01
N_STEPS = 6


def test_device_loop_matches_jax_frame_by_frame():
    f64 = torch.float64
    cam, jc = tcam.pinhole(*K, width=W, height=H, device="cpu"), jcam.pinhole(*K, width=W, height=H)
    cfg, jcfg = WindowConfig(**WKW), jwin.WindowConfig(**WKW)
    tcfg = tft.TrackerConfig(klt=tklt.KLTConfig(levels=2), **TKW)
    jtcfg = jft.TrackerConfig(equalize=False, klt=jklt.KLTConfig(levels=2), **TKW)
    params, jparams = timu.default_params(f64, device="cpu"), jimu.default_params()
    nf = cfg.nf
    T = nf - 1 + N_STEPS
    r = round(FRAME_DT / IMU_DT)

    # ---- the world, rendered by the port; IMU from the analytic trajectory
    q_ic, p_ic = demo.forward_camera_extrinsic(f64, device="cpu")
    traj = synthetic.figure8_trajectory(radius=1.2, ypr_amp=(12.0, 5.0, 4.0))
    frame_t = np.arange(T) * FRAME_DT
    accs, gyrs = synthetic.imu_samples(traj, torch.arange(T * r + 1, dtype=f64) * IMU_DT)
    p_gt, q_gt, v_gt = synthetic.ground_truth_states(traj, torch.tensor(frame_t))
    rend = demo.BlobWorldRenderer(cam, q_ic, p_ic, n_pts=300, dtype=torch.float32,
                                  device="cpu")
    imgs = torch.stack([rend.render(q_gt[k], p_gt[k]) for k in range(T)]).to(f64)
    batches = demo.imu_batches(accs, gyrs, IMU_DT, r, T - 1, cfg.max_imu)

    # ---- JAX carry: states at truth, the JAX tracker's tracks ingested
    jimgs = jnp.asarray(imgs.numpy())
    jb = [jnp.asarray(b.numpy()) for b in batches]
    js = jwin.empty_state(jcfg)._replace(
        p=jnp.asarray(p_gt[:nf].numpy()), q=jnp.asarray(q_gt[:nf].numpy()),
        v=jnp.asarray(v_gt[:nf].numpy()), q_ic=jnp.asarray(q_ic.numpy()),
        p_ic=jnp.asarray(p_ic.numpy()))
    jd = jwin.empty_tracks(jcfg)
    fe = jft.init_state(jtcfg, H, W, jnp.float64)
    step = jax.jit(lambda s, img, key: jft.step(s, img, jc, jtcfg, FRAME_DT, key))
    ingest = jax.jit(lambda d, k, ids, rays, t: jslide.ingest_frame(d, jcfg, k, ids, rays)
                     ._replace(frame_t=d.frame_t.at[k].set(t)))
    imu_in = jax.jit(lambda d, k, dts, a, g, m: jslide.set_imu_interval(
        d, k, dts, a, g, m, params=jparams))
    keys, ridx = [], []
    for k in range(T):
        key, draws, _ = tracker_key(fe, jimgs[k], jtcfg, seed=k)
        keys.append(key)
        ridx.append(draws)
        if k == nf - 1:
            fe_start = fe
        fe, feats = step(fe, jimgs[k], key)
        if k < nf - 1:
            jd = ingest(jd, k, feats.ids, feats.rays, frame_t[k])
            if k > 0:
                jd = imu_in(jd, k - 1, *[b[k - 1] for b in jb[:4]])
    keys, ridx = jnp.stack(keys), np.stack(ridx)
    jd = jax.jit(lambda s, d: jwin.triangulate_points(s, d, jcfg))(js, jd)
    assert int(jd.pt_solved.sum()) >= 15
    jcarry = (fe_start, js, jd)

    # ---- both loops over the same frames from the same carry
    s = nf - 1
    jloop = jmake_device_loop(jc, jtcfg, jcfg, jparams)
    _, jouts = jloop.run(jcarry, jimgs[s:], tuple(b[s - 1:] for b in jb),
                         jnp.full((N_STEPS,), FRAME_DT), keys[s:])
    loop = make_device_loop(cam, tcfg, cfg, params)
    carry = loop.init_carry(*(convert.to_torch(x, device="cpu") for x in jcarry))
    _, outs = loop.run(carry, imgs[s:], tuple(b[s - 1:] for b in batches),
                       torch.full((N_STEPS,), FRAME_DT, dtype=f64), torch.as_tensor(ridx[s:]))

    jp, jq, jv, jkf, jfail, jcost = (np.asarray(o) for o in jouts)
    p, q, v, kf, fail, cost = (o.numpy() for o in outs)
    assert p.shape == (N_STEPS, 3) and q.shape == (N_STEPS, 4)
    assert np.array_equal(jkf, kf) and np.array_equal(jfail, fail)
    assert kf.any() and not kf.all()  # both slides are exercised
    assert not fail.any()
    # √-prior eigen-clipping carries f64 rounding at ~1e-6 of the prior's
    # scale (see test_torch_solver.py); it reaches the poses at ~1e-8
    np.testing.assert_allclose(p, jp, atol=1e-6)
    np.testing.assert_allclose(q, jq, atol=1e-7)
    np.testing.assert_allclose(v, jv, atol=1e-6)
    np.testing.assert_allclose(cost, jcost, rtol=1e-4)
    # and the estimate is a real one: within centimetres of the truth
    assert np.abs(p - p_gt[s:].numpy()).max() < 0.05
