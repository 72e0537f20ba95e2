"""``VioEngine``'s time-offset path against the JAX reference (torch f64 on
the CPU against JAX x64) with the IMU stamped 4 ms late, through the solve,
and the system's stats line carrying the calibrated time offset."""

import io

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_online_calib import (CPU, P_IC, Q_IC, WKW, acc_close, calib_stream, close,
                                     feed, jax_draws)
from vplines_slam_tpu.estimator.vio import VioEngine as JVioEngine
from vplines_slam_tpu.estimator.window import WindowConfig as JWindowConfig
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator.vio import VioEngine, unpack_output
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import feature_tracker as tft
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(1)


def test_vio_engine_time_offset_path_matches_jax():
    """estimate_td with the IMU stamped 4 ms late: both engines hold the
    window while their curves fill, and the accumulator after every fill
    frame, the frame td is solved at and td agree (1e-9).  The
    initialization that follows is held back on both sides (its parity is
    test_torch_coldstart's), so the JAX side compiles no initializer."""
    frame_t, imu_t, accs, gyrs, frames = calib_stream(6.2, shift=0.004)
    jeng = JVioEngine(JWindowConfig(**WKW), jimu.default_params(), q_ic=jnp.asarray(Q_IC),
                      p_ic=jnp.asarray(P_IC), estimate_td=True)
    teng = VioEngine(WindowConfig(**WKW), timu.default_params(device=CPU), q_ic=Q_IC, p_ic=P_IC,
                     estimate_td=True, device=CPU)
    teng.sfm_draws = jax_draws(0, (64, 8), WKW["max_points"])
    held = []
    jeng._try_init = lambda s, d, k: held.append("jax") or (s, d, jnp.asarray(False))
    teng.try_init = lambda s, d, idx: held.append("port") or (s, d, torch.tensor(False))
    assert (jeng._sync is None) == (teng._sync is None)
    state, solved_at = dict(i=0), None
    for k in range(len(frame_t)):
        feed([jeng, teng], frame_t, imu_t, accs, gyrs, frames, k, state, lead=0.004)
        assert jeng._td_solved == teng._td_solved, k
        assert jeng.frame_count == teng.frame_count
        if not teng._td_solved:
            acc_close(jeng._td_acc, convert.from_torch(teng._td_acc), atol=1e-9)
        elif solved_at is None:
            solved_at = k
            close(jeng.td, teng.td, atol=1e-9)
            break
    assert solved_at == 60 and abs(teng.td - 0.004) < 0.002
    assert held == ["jax", "port"]


def test_stats_line_carries_td():
    """The periodic stats line prints the calibrated time offset, as the
    reference's does."""
    cam = tcam.pinhole(100.0, 100.0, 8.0, 6.0, width=16, height=12, device=CPU)
    sysm = SlamSystem(cam, WindowConfig(window=2, max_points=4, max_lines=2, max_imu=4),
                      tft.TrackerConfig(max_features=4), q_ic=np.array([1.0, 0, 0, 0]),
                      p_ic=np.zeros(3), use_loop_closure=False, print_stats_every=1,
                      device=CPU)
    sysm.stats.stream = io.StringIO()
    sysm.vio.td = 0.0042
    vec = np.zeros(28)
    vec[3] = 1.0  # q = identity
    sysm._finish_frame(1.0, np.zeros((12, 16)), unpack_output(vec))
    line = sysm.stats.stream.getvalue()
    assert "td=4.20ms" in line, line
