"""The lines slice: the port's lines-on device loop against the JAX
reference's ``make_device_loop(..., line_cfg=, map_xy=).run``, frame by
frame, from one JAX carry converted with ``convert.py`` (torch f64 on the
CPU against JAX x64).

The world is the port's rendered blob room, whose floor and ceiling grids
and the wall's verticals are straight 3D lines, here with wide grid bands
and a faint texture so that the 240x320 frames hold lines; a radtan camera
sees it, so every frame is undistorted by a real remap before the line
tracker.  The room is small (4 m) and the run starts where the figure-8
moves sideways to the camera, so that lines triangulate within the window.  The carry is built
with the reference's own functions: states at truth, the JAX point and line
trackers over the first frames, their tracks ingested, IMU intervals,
point triangulation.  ``line_min_obs`` is relaxed to 3 so that lines solve
in a 5-frame window.

Randomness: ``frame_step`` splits each frame's key into the RANSAC key and
the line tracker's key, and ``detect_vps`` splits the latter again; the port
gets JAX's own RANSAC draws and VP uniforms.  Each key is chosen, on the
tracker state the frame meets, so that no RANSAC hypothesis repeats a sample
(see tests/test_torch_models.tracker_key).  The reference's line tracker
needs the x64 shim of tests/test_torch_lines.py to trace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.estimator import slide as jslide
from vplines_slam_tpu.estimator import window as jwin
from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import feature_tracker as jft
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu.models import line_tracker as jlt
from vplines_slam_tpu.ops import image as jimage
from vplines_slam_tpu.ops import klt as jklt
from vplines_slam_tpu.ops import lines as jlines
from vplines_slam_tpu.pipeline.device_loop import make_device_loop as jmake_device_loop
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import feature_tracker as tft
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.models import line_tracker as tlt
from vplines_slam_tpu_torch.ops import klt as tklt
from vplines_slam_tpu_torch.ops import lines as tlines
from vplines_slam_tpu_torch.pipeline.device_loop import make_device_loop
from vplines_slam_tpu_torch.utils import demo, synthetic
from test_torch_lines import patch_line_tracker_cond

torch.set_num_threads(1)

H, W = 240, 320
K = (230.0, 230.0, W / 2, H / 2, -0.12, 0.03, 0.0, 0.0)
WKW = dict(window=4, max_points=40, max_lines=16, max_imu=12, line_min_obs=3)
TKW = dict(max_features=40, min_dist=15, quality=0.003, ransac_hyps=4)
LKW = dict(max_lines=16, max_h=8, max_v=8)
DET = dict(min_len=25.0)
LINE_WORLD = dict(tex_gain=0.1, grid_band=0.2, grid_dark=0.0, wall_radius=4.0)
FRAME_DT, IMU_DT = 0.1, 0.01
T0 = 2.5  # the figure-8 runs sideways to the camera here: lines get parallax
N_STEPS = 6


@pytest.fixture
def jax_line_tracker_x64(monkeypatch):
    yield from patch_line_tracker_cond(monkeypatch)


_jklt_track = jax.jit(jklt.track, static_argnums=3)


def frame_key(js, img, jcfg, seed):
    """(key, RANSAC draws, VP uniforms) of one frame: ``split(key)[0]`` is
    the tracker's RANSAC key, whose hypotheses each draw 8 distinct tracks
    among those entering RANSAC (below 12 any key will do)."""
    _, ok, _ = _jklt_track(js.prev_img, img, js.xy, jcfg.klt)
    n_ok = int(jnp.sum(ok & (js.ids >= 0) & js.has_prev))
    hyps, M = jcfg.ransac_hyps, jcfg.max_features
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 ** 12)
    k1s = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
    idx = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (hyps, 8), 0, M))(k1s))
    s = np.sort(idx % max(n_ok, 8), axis=-1)
    good = np.all(np.diff(s, axis=-1) != 0, axis=(-1, -2)) | (n_ok < 12)
    i = int(np.argmax(good))
    assert good[i]
    k2 = jax.random.split(keys[i])[1]
    u = jax.random.uniform(jax.random.split(k2)[0], (jlt.LineTrackerConfig().vp.n_pairs, 2),
                           dtype=jnp.float64)
    return keys[i], idx[i], np.asarray(u)


def test_lines_device_loop_matches_jax_frame_by_frame(jax_line_tracker_x64):
    f64 = torch.float64
    cam = tcam.pinhole(*K, width=W, height=H, device="cpu")
    jc = jcam.pinhole(*K, width=W, height=H)
    cfg, jcfg = WindowConfig(**WKW), jwin.WindowConfig(**WKW)
    tcfg = tft.TrackerConfig(equalize=False, klt=tklt.KLTConfig(levels=2), **TKW)
    jtcfg = jft.TrackerConfig(equalize=False, klt=jklt.KLTConfig(levels=2), **TKW)
    lcfg = tlt.LineTrackerConfig(detect=tlines.LineDetectConfig(**DET), equalize=False, **LKW)
    jlcfg = jlt.LineTrackerConfig(detect=jlines.LineDetectConfig(**DET), equalize=False, **LKW)
    params, jparams = timu.default_params(f64, device="cpu"), jimu.default_params()
    nf = cfg.nf
    T = nf - 1 + N_STEPS
    r = round(FRAME_DT / IMU_DT)

    # ---- the world, rendered by the port; IMU from the analytic trajectory
    q_ic, p_ic = demo.forward_camera_extrinsic(f64, device="cpu")
    traj = synthetic.figure8_trajectory(radius=1.2, ypr_amp=(12.0, 5.0, 4.0))
    frame_t = T0 + np.arange(T) * FRAME_DT
    accs, gyrs = synthetic.imu_samples(traj, T0 + torch.arange(T * r + 1, dtype=f64) * IMU_DT)
    p_gt, q_gt, v_gt = synthetic.ground_truth_states(traj, torch.tensor(frame_t))
    rend = demo.BlobWorldRenderer(cam, q_ic, p_ic, n_pts=300, dtype=torch.float32,
                                  device="cpu", **LINE_WORLD)
    imgs = torch.stack([rend.render(q_gt[k], p_gt[k]) for k in range(T)]).to(f64)
    batches = demo.imu_batches(accs, gyrs, IMU_DT, r, T - 1, cfg.max_imu)

    # ---- JAX carry: states at truth, both JAX trackers' tracks ingested
    jimgs = jnp.asarray(imgs.numpy())
    jb = [jnp.asarray(b.numpy()) for b in batches]
    jmap = jcam.undistort_rectify_map(jc)
    jplan = jimage.build_remap_plan(jmap)
    jideal = jcam.pinhole(jc.fx, jc.fy, jc.cx, jc.cy, width=W, height=H)
    js = jwin.empty_state(jcfg)._replace(
        p=jnp.asarray(p_gt[:nf].numpy()), q=jnp.asarray(q_gt[:nf].numpy()),
        v=jnp.asarray(v_gt[:nf].numpy()), q_ic=jnp.asarray(q_ic.numpy()),
        p_ic=jnp.asarray(p_ic.numpy()))
    jd = jwin.empty_tracks(jcfg)
    fe = jft.init_state(jtcfg, H, W, jnp.float64)
    ln = jlt.init_state(jlcfg, H, W, jnp.float64)
    fstep = jax.jit(lambda s, img, key: jft.step(s, img, jc, jtcfg, FRAME_DT, key))
    lstep = jax.jit(lambda s, img, key: jlt.step(
        s, jimage.remap_static(img, jplan), jideal, jlcfg, key))
    ingest = jax.jit(lambda d, k, f, l, t: jslide.ingest_frame(
        d, jcfg, k, f.ids, f.rays, l.ids, l.endpoints, l.vp_dirs, l.vp_valid)
        ._replace(frame_t=d.frame_t.at[k].set(t)))
    imu_in = jax.jit(lambda d, k, dts, a, g, m: jslide.set_imu_interval(
        d, k, dts, a, g, m, params=jparams))
    keys, ridx, vp_u = [], [], []
    for k in range(T):
        key, draws, u = frame_key(fe, jimgs[k], jtcfg, seed=k)
        keys.append(key)
        ridx.append(draws)
        vp_u.append(u)
        if k == nf - 1:
            start = (fe, ln)
        k1, k2 = jax.random.split(key)
        fe, feats = fstep(fe, jimgs[k], k1)
        if k < nf - 1:
            ln, lout = lstep(ln, jimgs[k], k2)
            jd = ingest(jd, k, feats, lout, frame_t[k])
            if k > 0:
                jd = imu_in(jd, k - 1, *[b[k - 1] for b in jb[:4]])
    keys, ridx, vp_u = jnp.stack(keys), np.stack(ridx), np.stack(vp_u)
    jd = jax.jit(lambda s, d: jwin.triangulate_points(s, d, jcfg))(js, jd)
    assert int(jd.pt_solved.sum()) >= 15 and int((jd.ln_id >= 0).sum()) >= 6
    jcarry = (start[0], start[1], js, jd)

    # ---- both loops over the same frames from the same carry
    s = nf - 1
    jloop = jmake_device_loop(jc, jtcfg, jcfg, jparams, line_cfg=jlcfg, map_xy=jmap)
    jcarry_out, jouts = jloop.run(jcarry, jimgs[s:], tuple(b[s - 1:] for b in jb),
                                  jnp.full((N_STEPS,), FRAME_DT), keys[s:])
    loop = make_device_loop(cam, tcfg, cfg, params, line_cfg=lcfg,
                            map_xy=tcam.undistort_rectify_map(cam))
    carry = tuple(convert.to_torch(x, device="cpu") for x in jcarry)
    carry, outs = loop.run(carry, imgs[s:], tuple(b[s - 1:] for b in batches),
                           torch.full((N_STEPS,), FRAME_DT, dtype=f64),
                           torch.as_tensor(ridx[s:]), torch.as_tensor(vp_u[s:]))

    jp, jq, jv, jkf, jfail, jcost = (np.asarray(o) for o in jouts)
    p, q, v, kf, fail, cost = (o.numpy() for o in outs)
    assert p.shape == (N_STEPS, 3) and q.shape == (N_STEPS, 4)
    assert np.array_equal(jkf, kf) and np.array_equal(jfail, fail)
    assert kf.any() and not kf.all()  # both slides are exercised
    assert not fail.any()
    # the same tolerances as the points-only slice test (tests/test_torch_slice.py)
    np.testing.assert_allclose(p, jp, atol=1e-6)
    np.testing.assert_allclose(q, jq, atol=1e-7)
    np.testing.assert_allclose(v, jv, atol=1e-6)
    np.testing.assert_allclose(cost, jcost, rtol=1e-4)
    assert np.abs(p - p_gt[s:].numpy()).max() < 0.05
    # the line channel was live: lines solved, VP rows active, same tables
    jln, ln_t = jcarry_out[1], carry[1]
    jd_out, td_out = jcarry_out[3], carry[3]
    assert np.array_equal(np.asarray(jln.ids), ln_t.ids.numpy())
    assert np.array_equal(np.asarray(jd_out.ln_id), td_out.ln_id.numpy())
    assert np.array_equal(np.asarray(jd_out.ln_solved), td_out.ln_solved.numpy())
    assert int(td_out.ln_solved.sum()) >= 2
    assert bool((td_out.ln_vp_mask & td_out.ln_solved[:, None]).any())
    # line coordinates are angles of lines seen a few times: less well
    # conditioned than the poses, they agree at 1e-4 rad
    np.testing.assert_allclose(td_out.ln_orth.numpy(), np.asarray(jd_out.ln_orth), atol=1e-4)
