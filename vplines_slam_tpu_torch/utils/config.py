"""YAML device profiles -> the port's module configs.

Port of ``vplines_slam_tpu/utils/config.py`` for pinhole cameras (the
equidistant and MEI models are not ported and raise).  One yaml file
describes the camera, IMU noise, extrinsics, front-end knobs and factor
weights; ``load_profile`` returns the typed configs the modules take.  The
pose-graph block gives ``pose_graph`` (a ``PoseGraphConfig``) and the
loop-closure switch; of the selector and GNSS blocks, whose modules are not
ported, only the switches are read (``SlamSystem`` raises when one is on).
PyYAML is imported when a profile is loaded, not with this module.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..estimator.window import WindowConfig
from ..factors import residuals as res
from ..models import camera as cam_mod
from ..models import imu as imu_mod
from ..models.feature_tracker import TrackerConfig
from ..models.line_tracker import LineTrackerConfig
from ..models.pose_graph import PoseGraphConfig
from ..ops.lines import LineDetectConfig
from ..ops.vp import VPConfig
from ..utils.geometry import rot_to_quat


class SystemProfile(NamedTuple):
    camera: cam_mod.CameraModel
    imu_params: imu_mod.ImuParams
    q_ic: torch.Tensor
    p_ic: torch.Tensor
    window: WindowConfig
    tracker: TrackerConfig
    lines: Optional[LineTrackerConfig]
    td: float
    name: str
    estimate_extrinsic: int = 1
    estimate_td: bool = False
    pose_graph: PoseGraphConfig = PoseGraphConfig()
    use_loop_closure: bool = True
    use_feature_selector: bool = False
    use_global_fusion: bool = False
    landmark_mesh_devices: int = 0


def load_profile(path, dtype=torch.float64, device=torch.device("cuda")) -> SystemProfile:
    import yaml

    with open(path) as f:
        y = yaml.safe_load(f)

    c = y["camera"]
    kind = c.get("model", "pinhole")
    if kind != "pinhole":
        raise NotImplementedError(f"camera model {kind!r} is not ported (pinhole only)")
    cam = cam_mod.pinhole(c["fx"], c["fy"], c["cx"], c["cy"],
                          *(c.get("distortion", [0, 0, 0, 0])[:4]),
                          width=c.get("width", 752), height=c.get("height", 480),
                          dtype=dtype, device=device)

    n = y.get("imu", {})
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    imu_params = imu_mod.ImuParams(
        acc_n=t(n.get("acc_n", 0.08)), gyr_n=t(n.get("gyr_n", 0.004)),
        acc_w=t(n.get("acc_w", 4e-5)), gyr_w=t(n.get("gyr_w", 2e-6)),
        g=t([0.0, 0.0, n.get("g_norm", 9.81007)]),
    )

    e = y.get("extrinsic", {})
    q_ic = rot_to_quat(t(e.get("R_bc", np.eye(3).tolist())))
    p_ic = t(e.get("p_bc", [0.0, 0.0, 0.0]))

    w = y.get("estimator", {})
    window = WindowConfig(
        max_points=w.get("max_points", 128),
        max_lines=w.get("max_lines", 32),
        max_imu=w.get("max_imu", 64),
        g_norm=n.get("g_norm", 9.81007),
        min_parallax=w.get("keyframe_parallax", 10.0) / 460.0,
        ba_iters=w.get("max_num_iterations", 8),
        line_sqrt_info=w.get("line_factor", res.LINE_SQRT_INFO),
        vp_sqrt_info=w.get("vp_factor", 10.0),
        line_min_obs=w.get("line_min_obs", 5),
    )

    fr = y.get("frontend", {})
    tracker = TrackerConfig(
        max_features=fr.get("max_cnt", 150),
        min_dist=fr.get("min_dist", 30),
        f_threshold=fr.get("F_threshold", 1.0),
        equalize=bool(fr.get("equalize", True)),
        fisheye=bool(fr.get("fisheye", False)),
    )

    lines = None
    lf = y.get("line_frontend")
    if lf is not None:
        # the reference-resolution VP preset: 112 pairs x 360 sweep positions
        vp_cfg = (VPConfig(n_pairs=112, n_sweep=360)
                  if lf.get("vp_resolution", "fast") == "reference" else VPConfig())
        lines = LineTrackerConfig(
            max_lines=lf.get("max_lines", 64),
            max_h=lf.get("max_h_lines", 40),
            max_v=lf.get("max_v_lines", 40),
            detect=LineDetectConfig(min_len=float(lf.get("min_line_length", 30)),
                                    fit_err=float(lf.get("line_fit_err", 1.5))),
            use_vp=bool(lf.get("use_vp", True)),
            vp=vp_cfg,
        )

    pg = y.get("pose_graph", {})
    pg_cfg = PoseGraphConfig(
        n_features=pg.get("n_features", 500),
        skip_cnt=pg.get("skip_cnt", 0),
        skip_dis=pg.get("skip_dis", 0.0),
        loop_edge_weight=pg.get("loop_edge_weight", 1.0),
    )

    return SystemProfile(
        camera=cam, imu_params=imu_params, q_ic=q_ic, p_ic=p_ic, window=window,
        tracker=tracker, lines=lines, td=float(y.get("td", 0.0)),
        name=y.get("name", os.path.basename(path)),
        estimate_extrinsic=int(y.get("estimate_extrinsic", 1)),
        estimate_td=bool(y.get("estimate_td", False)),
        pose_graph=pg_cfg,
        use_loop_closure=bool(pg.get("loop_closure", True)),
        use_feature_selector=bool(y.get("selector", {}).get("use_feature_selector", False)),
        use_global_fusion=bool(y.get("global_fusion", {}).get("enabled", False)),
        landmark_mesh_devices=int(y.get("parallel", {}).get("landmark_mesh_devices", 0)),
    )
