"""One steady-state VIO frame.

Port of ``track_step`` (points only, or with the line channel), ``StepOutput``,
``pack_output``, ``_propagate_interval`` and ``_failure_detection`` from
``vplines_slam_tpu/estimator/vio.py``.  The host engine ``VioEngine`` (and
with it the initializer) is not ported yet.

The reference's ``lax.cond`` between the keyframe and non-keyframe slides is
a Python branch on one ``bool()``: one host sync per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import imu as imu_mod
from ..utils.geometry import quat_conj, quat_mul, quat_rotate, quat_to_rot, rot_to_ypr
from .slide import (
    _set_row,
    ingest_frame,
    keyframe_parallax,
    marginalize_old,
    set_imu_interval,
    slide_window_new,
    slide_window_old,
)
from .window import (
    WindowConfig,
    WindowState,
    reject_outliers,
    settle_lines,
    solve_window,
    triangulate_lines,
    triangulate_points,
)


class StepOutput(NamedTuple):
    p: torch.Tensor  # latest body position
    q: torch.Tensor  # latest body orientation
    v: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor
    is_keyframe: torch.Tensor
    failure: torch.Tensor
    ba_cost: torch.Tensor
    # fast-relocalization feedback (valid when relo_valid)
    relo_valid: torch.Tensor
    relo_rel_t: torch.Tensor
    relo_rel_q: torch.Tensor
    relo_rel_yaw: torch.Tensor


def pack_output(out: StepOutput):
    """Flatten a StepOutput into one [28] f32 vector on its device."""
    sc = lambda x: torch.as_tensor(x).to(torch.float32).reshape(-1)
    return torch.cat([
        sc(out.p), sc(out.q), sc(out.v), sc(out.ba), sc(out.bg),
        sc(out.is_keyframe), sc(out.failure), sc(out.ba_cost),
        sc(out.relo_valid), sc(out.relo_rel_t), sc(out.relo_rel_q),
        sc(out.relo_rel_yaw),
    ])


def _propagate_interval(state, cfg, dts, accs, gyrs, mask, params, k_from, k_to):
    """Seed frame k_to by world-frame IMU propagation from k_from."""
    g = params.g.to(state.p.dtype)
    dts_m = dts * mask.to(state.p.dtype)
    p, q, v = state.p[k_from], state.q[k_from], state.v[k_from]
    ba, bg = state.ba[k_from], state.bg[k_from]
    for i in range(dts.shape[0]):
        p, q, v = imu_mod.midpoint_propagate(
            p, q, v, ba, bg, accs[i], gyrs[i], accs[i + 1], gyrs[i + 1], dts_m[i], g)
    return state._replace(
        p=_set_row(state.p, k_to, p), q=_set_row(state.q, k_to, q),
        v=_set_row(state.v, k_to, v), ba=_set_row(state.ba, k_to, ba),
        bg=_set_row(state.bg, k_to, bg),
    )


def _failure_detection(state_old: WindowState, state_new: WindowState):
    """estimator.cpp failureDetection:902-948 thresholds."""
    big_ba = torch.linalg.norm(state_new.ba[-1]) > 2.5
    big_bg = torch.linalg.norm(state_new.bg[-1]) > 1.0
    jump = torch.linalg.norm(state_new.p[-1] - state_old.p[-1]) > 5.0
    z_jump = torch.abs(state_new.p[-1, 2] - state_old.p[-1, 2]) > 1.0
    return big_ba | big_bg | jump | z_jump


def track_step(state, data, pt_ids, pt_rays, imu_batch, cfg: WindowConfig, params, t=None,
               ln_args=(), use_lines=False):
    """One steady-state frame: IMU interval ingest + propagation, feature
    ingest, keyframe test, triangulation, window BA, outlier cull, and the
    keyframe / non-keyframe slide.  imu_batch = (dts, accs, gyrs, mask,
    has_imu); ln_args = (ids, endpoints, vp_dirs, vp_valid) of the line
    tracker when use_lines.  Returns (state, data, StepOutput)."""
    nf = cfg.nf
    dts, accs, gyrs, mask, _ = imu_batch
    state0 = state
    data = set_imu_interval(data, nf - 2, dts, accs, gyrs, mask,
                            ba=state.ba[nf - 2], bg=state.bg[nf - 2], params=params)
    state = _propagate_interval(state, cfg, dts, accs, gyrs, mask, params, nf - 2, nf - 1)
    data = ingest_frame(data, cfg, nf - 1, pt_ids, pt_rays, *ln_args)
    t_new = (data.frame_t[nf - 2] + 1.0 if t is None
             else torch.as_tensor(t, dtype=data.frame_t.dtype, device=data.frame_t.device))
    data = data._replace(frame_t=_set_row(data.frame_t, nf - 1, t_new))

    is_kf, _, _ = keyframe_parallax(data, cfg, nf - 1)
    data = triangulate_points(state, data, cfg)
    if use_lines:
        # line-only Cauchy settle with poses fixed + the line culls, so fresh
        # triangulations never drag the joint solve (onlyLineOpt)
        data = triangulate_lines(state, data, cfg)
        data = settle_lines(state, data, cfg)
        data = reject_outliers(state, data, cfg, cull_points=False, use_lines=True)
    state, data, lm_out = solve_window(state, data, cfg, params, use_lines=use_lines)
    data = reject_outliers(state, data, cfg, use_lines=use_lines)
    failure = _failure_detection(state0, state)

    # fast-relocalization feedback against the window frame matching the
    # loop keyframe's stamp
    stamp_diff = torch.abs(data.frame_t - data.relo_stamp)
    kf_idx = torch.argmin(stamp_diff)
    relo_found = data.relo_valid & (stamp_diff[kf_idx] < 2e-3)
    q_relo_inv = quat_conj(state.q_relo)
    out = StepOutput(
        p=state.p[nf - 1], q=state.q[nf - 1], v=state.v[nf - 1],
        ba=state.ba[nf - 1], bg=state.bg[nf - 1],
        is_keyframe=is_kf, failure=failure, ba_cost=lm_out.cost,
        relo_valid=relo_found,
        relo_rel_t=quat_rotate(q_relo_inv, state.p[kf_idx] - state.p_relo),
        relo_rel_q=quat_mul(q_relo_inv, state.q[kf_idx]),
        relo_rel_yaw=(rot_to_ypr(quat_to_rot(state.q[kf_idx]))[0]
                      - rot_to_ypr(quat_to_rot(state.q_relo))[0]),
    )
    if bool(is_kf):  # host sync: the reference's lax.cond
        prior = marginalize_old(state, data, cfg, params, use_lines=use_lines)
        state, data = slide_window_old(state, data, cfg, params, prior)
    else:
        state, data = slide_window_new(state, data, cfg, params)
    return state, data, out
