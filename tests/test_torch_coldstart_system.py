"""``SlamSystem`` from a cold start against the JAX reference: images and
IMU in, through the initializer into tracking (torch f64 on the CPU against
JAX x64).

The port's frontend and engine get JAX's random draws (``ransac_draws``,
``sfm_draws`` overridden to the reference's key sequences); the frontend's
RANSAC gate is open, so a hypothesis that repeats a sample (not
reproducible across LAPACK builds) cannot change the kept tracks.
"""

import jax.numpy as jnp
import torch

from vplines_slam_tpu.estimator.window import WindowConfig as JWindowConfig
from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import feature_tracker as jft
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu.pipeline.system import SlamSystem as JSlamSystem
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import feature_tracker as tft
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.pipeline.system import SlamSystem
from vplines_slam_tpu_torch.utils import demo
from test_torch_coldstart import CPU, T0, WKW, close, jax_draws

torch.set_num_threads(1)


def rendered(n_frames, H=120, W=160):
    """A small undistorted camera in the blob world along the figure-8, with
    200 Hz IMU (frames and IMU made by the port, fed to both systems)."""
    from vplines_slam_tpu_torch.utils import synthetic as tsyn

    f64 = torch.float64
    cam = tcam.pinhole(110.0, 110.0, W / 2, H / 2, width=W, height=H, dtype=f64, device=CPU)
    q_ic, p_ic = demo.forward_camera_extrinsic(f64, CPU)
    traj = tsyn.figure8_trajectory(radius=1.2, ypr_amp=(12.0, 5.0, 4.0))
    imu_rel = torch.arange((n_frames - 1) * 20 + 1, dtype=f64) / 200.0
    accs, gyrs = tsyn.imu_samples(traj, imu_rel)
    p, q, _ = tsyn.ground_truth_states(traj, imu_rel[::20])
    rend = demo.BlobWorldRenderer(cam, q_ic, p_ic, n_pts=300, seed=4, dtype=f64, device=CPU)
    imgs = [rend.render(q[k], p[k]).numpy() for k in range(n_frames)]
    imu_t = T0 + imu_rel.numpy()
    return (imu_t[::20], imu_t, accs.numpy(), gyrs.numpy(), imgs, q_ic.numpy(), p_ic.numpy())


def test_slam_system_cold_start_matches_jax():
    """SlamSystem (points, CLAHE off, loop closure off) from images and IMU
    through initialization (two failed attempts, then success at frame 8)
    and three tracked frames: the returned outputs compared (1e-6), the
    first being the initializing frame's."""
    n = WKW["window"] + 1 + 6
    frame_t, imu_t, accs, gyrs, imgs, q_ic, p_ic = rendered(n)
    kw = dict(max_features=40, min_dist=12, quality=0.005, f_threshold=1e4, ransac_hyps=4)
    jcfg = jft.TrackerConfig(equalize=False, **kw)
    tcfg = tft.TrackerConfig(equalize=False, **kw)
    wkw = dict(WKW, init_min_parallax=15.0 / 460.0)
    jsys = JSlamSystem(jcam.pinhole(110.0, 110.0, 80.0, 60.0, width=160, height=120),
                       JWindowConfig(**wkw), jcfg, imu_params=jimu.default_params(),
                       q_ic=jnp.asarray(q_ic), p_ic=jnp.asarray(p_ic), use_loop_closure=False,
                       dtype=jnp.float64)
    tsys = SlamSystem(tcam.pinhole(110.0, 110.0, 80.0, 60.0, width=160, height=120,
                                   dtype=torch.float64, device=CPU),
                      WindowConfig(**wkw), tcfg, imu_params=timu.default_params(device=CPU),
                      q_ic=q_ic, p_ic=p_ic, use_loop_closure=False, dtype=torch.float64,
                      device=CPU)
    tsys.frontend.ransac_draws = jax_draws(0, (4, 8), 40)
    tsys.vio.sfm_draws = jax_draws(0, (64, 8), WKW["max_points"])
    i = 0
    outs = []
    for k in range(n):
        while i < len(imu_t) and imu_t[i] <= frame_t[k]:
            jsys.add_imu(imu_t[i], accs[i], gyrs[i])
            tsys.add_imu(imu_t[i], accs[i], gyrs[i])
            i += 1
        jo = jsys.add_image(frame_t[k], imgs[k])
        to = tsys.add_image(frame_t[k], imgs[k])
        assert (jo is None) == (to is None), k
        assert jsys.vio.initialized == tsys.vio.initialized
        if jo is not None:
            outs.append((jo, to))
    outs.append((jsys.flush(), tsys.flush()))
    assert tsys.vio.initialized and len(outs) == 4
    for jo, to in outs:
        assert jo.t == to.t and jo.is_keyframe == to.is_keyframe
        close(jo.p_vio, to.p_vio, atol=1e-6)
        close(jo.q_vio, to.q_vio, atol=1e-6)
        close(jo.p_corrected, to.p_corrected, atol=1e-6)
        close(jo.q_corrected, to.q_corrected, atol=1e-6)
        close(jo.ba_cost, to.ba_cost, atol=1e-8, rtol=1e-5)
        assert set(to.timings) <= set(jo.timings)
