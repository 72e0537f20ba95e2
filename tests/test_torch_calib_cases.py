"""``VioEngine``'s extrinsic mode 2 against the JAX reference from an unknown
camera-IMU rotation through the hand-eye convergence and the
initialization (torch f64 on the CPU against JAX x64)."""

import numpy as np
import torch

from test_torch_online_calib import (CPU, Q_IC, WKW, acc_close, calib_stream, close, feed,
                                     jax_draws)
from vplines_slam_tpu.estimator.vio import VioEngine as JVioEngine
from vplines_slam_tpu.estimator.window import WindowConfig as JWindowConfig
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator.vio import VioEngine
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(1)


def test_vio_engine_extrinsic_mode2_matches_jax():
    """No q_ic: both engines accumulate hand-eye pairs over the fill phase
    (the accumulator after every frame within 1e-9), converge on the same
    frame to the same q_ic (1e-8, within 3 degrees of the truth), then
    initialize on that frame with the same poses (1e-6).  The tracked
    frames that follow are test_torch_coldstart's parity, so the JAX side
    compiles no track step."""
    frame_t, imu_t, accs, gyrs, frames = calib_stream(3.3)
    jeng = JVioEngine(JWindowConfig(**WKW), jimu.default_params(), q_ic=None, p_ic=None)
    teng = VioEngine(WindowConfig(**WKW), timu.default_params(device=CPU), q_ic=None,
                     p_ic=None, device=CPU)
    assert teng.estimate_extrinsic == 2 and not teng.extrinsic_ok
    teng.sfm_draws = jax_draws(0, (64, 8), WKW["max_points"])
    state, converged_at, n_out = dict(i=0), None, 0
    for k in range(len(frame_t)):
        jo, to = feed([jeng, teng], frame_t, imu_t, accs, gyrs, frames, k, state, lead=0.0)
        assert jeng.extrinsic_ok == teng.extrinsic_ok, k
        assert (jo is None) == (to is None) and jeng.initialized == teng.initialized, k
        assert jeng._ex_stable == teng._ex_stable, k
        acc_close(jeng._ex_acc, convert.from_torch(teng._ex_acc), atol=1e-9)
        if teng.extrinsic_ok and converged_at is None:
            converged_at = k
            close(jeng.state.q_ic, teng.state.q_ic, atol=1e-8)
            err = tgeo.quat_mul(tgeo.quat_conj(teng.state.q_ic), torch.tensor(Q_IC))
            assert np.degrees(2.0 * np.arccos(min(1.0, abs(float(err[0]))))) < 3.0
        if jo is not None:
            n_out += 1
            for f in ("p", "q", "v", "ba", "bg"):
                close(getattr(jo, f), getattr(to, f), atol=1e-6)
            break
    assert converged_at is not None and teng.initialized and n_out == 1
