"""Sliding-window state, points-only residual stack, BA solve and culling.

Port of the points parts of ``vplines_slam_tpu/estimator/window.py``.
``WindowConfig``, ``WindowState`` and ``TrackData`` keep every field of the
reference (line tables included) so state converts one to one; the solve
uses the points-only layout (``solver.lm.WindowLayout``): line and VP rows
and line-landmark columns are left out.  With empty line tables (every
``ln_id`` = -1) those rows are identically zero in the reference, so the
solve is the same.  The line tables are carried through untouched.

Dense parameter layout (delta space): frame k at 15k [δp δθ δv δba δbg],
extrinsic [δp_ic δθ_ic] at 15·NF, relocalization pose at 15·NF + 6,
ND = 15·NF + 12; then the MAXP inverse depths.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors import residuals as res
from ..models import imu as imu_mod
from ..solver import lm as lm_mod
from ..solver import marginalization as marg_mod
from ..utils.geometry import (
    quat_conj,
    quat_log,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_rot,
    rot_to_quat,
    rot_to_ypr,
    so3_exp_quat,
    ypr_to_rot,
)


class WindowConfig(NamedTuple):
    """The reference's fields that the points-only path reads (the line,
    VP and initializer settings wait for their modules)."""

    window: int = 10  # keyframes (parameters.h WINDOW_SIZE)
    max_points: int = 128
    max_lines: int = 32  # line-table capacity (tables carried, not solved)
    max_imu: int = 64  # IMU samples capacity per interval
    point_sqrt_info: float = res.POINT_SQRT_INFO
    huber_delta: float = 1.0
    min_parallax: float = 10.0 / 460.0  # keyframe threshold
    ba_iters: int = 8
    prior_chi2_cap: float = 0.6  # χ²-consistency cap on the prior
    retire_points: bool = True  # retire tracks absorbed into the prior

    @property
    def nf(self):
        return self.window + 1

    @property
    def nd(self):
        return 15 * self.nf + 12  # frames + extrinsic + relo pose

    @property
    def n_total(self):
        """Columns of the points-only layout: dense block + inverse depths."""
        return self.nd + self.max_points


class WindowState(NamedTuple):
    p: torch.Tensor  # [NF, 3]
    q: torch.Tensor  # [NF, 4]
    v: torch.Tensor  # [NF, 3]
    ba: torch.Tensor  # [NF, 3]
    bg: torch.Tensor  # [NF, 3]
    p_ic: torch.Tensor  # [3]
    q_ic: torch.Tensor  # [4]
    p_relo: torch.Tensor  # [3]
    q_relo: torch.Tensor  # [4]


class TrackData(NamedTuple):
    """Fixed-capacity SoA feature/line tables + IMU intervals + prior
    (field for field the reference's; ids and slots are int64 here)."""

    pt_id: torch.Tensor  # [MAXP] -1 = empty slot
    pt_obs: torch.Tensor  # [MAXP, NF, 3] normalized rays (z=1)
    pt_mask: torch.Tensor  # [MAXP, NF] bool
    pt_start: torch.Tensor  # [MAXP] anchor frame
    pt_inv_depth: torch.Tensor  # [MAXP]
    pt_solved: torch.Tensor  # [MAXP] bool
    ln_id: torch.Tensor  # [MAXL]
    ln_obs: torch.Tensor  # [MAXL, NF, 4]
    ln_mask: torch.Tensor  # [MAXL, NF]
    ln_vp: torch.Tensor  # [MAXL, NF, 3]
    ln_vp_mask: torch.Tensor  # [MAXL, NF]
    ln_orth: torch.Tensor  # [MAXL, 4]
    ln_solved: torch.Tensor  # [MAXL]
    imu_dt: torch.Tensor  # [NF-1, MAXI]
    imu_acc: torch.Tensor  # [NF-1, MAXI+1, 3]
    imu_gyr: torch.Tensor  # [NF-1, MAXI+1, 3]
    imu_mask: torch.Tensor  # [NF-1, MAXI]
    imu_valid: torch.Tensor  # [NF-1] bool
    imu_pre: imu_mod.Preintegration  # batched [NF-1, ...]
    imu_sqrt: torch.Tensor  # [NF-1, 15, 15]
    relo_obs: torch.Tensor  # [MAXP, 3]
    relo_mask: torch.Tensor  # [MAXP] bool
    relo_valid: torch.Tensor  # [] bool
    frame_t: torch.Tensor  # [NF]
    relo_stamp: torch.Tensor  # []
    prior: marg_mod.Prior
    prior_state: WindowState


def empty_state(cfg: WindowConfig, dtype=torch.float64, device=None) -> WindowState:
    nf = cfg.nf
    z = lambda *s: torch.zeros(*s, dtype=dtype, device=device)
    q0 = torch.zeros(nf, 4, dtype=dtype, device=device)
    q0[:, 0] = 1.0
    qi = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    return WindowState(p=z(nf, 3), q=q0, v=z(nf, 3), ba=z(nf, 3), bg=z(nf, 3),
                       p_ic=z(3), q_ic=qi, p_relo=z(3), q_relo=qi.clone())


def _identity_pre(n, dtype, device):
    eye = torch.eye(15, dtype=dtype, device=device).expand(n, 15, 15).clone()
    dq = torch.zeros(n, 4, dtype=dtype, device=device)
    dq[:, 0] = 1.0
    z = lambda *s: torch.zeros(*s, dtype=dtype, device=device)
    return imu_mod.Preintegration(
        delta_p=z(n, 3), delta_q=dq, delta_v=z(n, 3), jacobian=eye,
        covariance=eye.clone(), sum_dt=z(n), linearized_ba=z(n, 3),
        linearized_bg=z(n, 3))


def empty_tracks(cfg: WindowConfig, dtype=torch.float64, device=None) -> TrackData:
    nf, P, L, I = cfg.nf, cfg.max_points, cfg.max_lines, cfg.max_imu
    z = lambda *s: torch.zeros(*s, dtype=dtype, device=device)
    zb = lambda *s: torch.zeros(*s, dtype=torch.bool, device=device)
    neg = lambda n: torch.full((n,), -1, dtype=torch.long, device=device)
    pt_obs = z(P, nf, 3)
    pt_obs[..., 2] = 1.0
    ln_vp = z(L, nf, 3)
    ln_vp[..., 2] = 1.0
    relo_obs = z(P, 3)
    relo_obs[:, 2] = 1.0
    return TrackData(
        pt_id=neg(P), pt_obs=pt_obs, pt_mask=zb(P, nf),
        pt_start=torch.zeros(P, dtype=torch.long, device=device),
        pt_inv_depth=torch.full((P,), 0.2, dtype=dtype, device=device),
        pt_solved=zb(P),
        ln_id=neg(L), ln_obs=z(L, nf, 4), ln_mask=zb(L, nf), ln_vp=ln_vp,
        ln_vp_mask=zb(L, nf), ln_orth=z(L, 4), ln_solved=zb(L),
        imu_dt=z(nf - 1, I), imu_acc=z(nf - 1, I + 1, 3), imu_gyr=z(nf - 1, I + 1, 3),
        imu_mask=zb(nf - 1, I), imu_valid=zb(nf - 1),
        imu_pre=_identity_pre(nf - 1, dtype, device),
        imu_sqrt=torch.eye(15, dtype=dtype, device=device).expand(nf - 1, 15, 15).clone(),
        relo_obs=relo_obs, relo_mask=zb(P),
        relo_valid=torch.zeros((), dtype=torch.bool, device=device),
        frame_t=torch.full((nf,), -1.0, dtype=dtype, device=device),
        relo_stamp=torch.tensor(-2.0, dtype=dtype, device=device),
        prior=marg_mod.empty_prior(cfg.nd, dtype, device),
        prior_state=empty_state(cfg, dtype, device),
    )


# ---------------------------------------------------------------------------
# retraction / manifold difference on the dense block
# ---------------------------------------------------------------------------


def _boxplus_q(q, dth):
    return quat_normalize(quat_mul(q, so3_exp_quat(dth)))


def retract_state(state: WindowState, d, cfg: WindowConfig) -> WindowState:
    nf = cfg.nf
    df = d[: 15 * nf].reshape(nf, 15)
    de = d[15 * nf: 15 * nf + 6]
    dr = d[15 * nf + 6: 15 * nf + 12]
    return WindowState(
        p=state.p + df[:, 0:3],
        q=_boxplus_q(state.q, df[:, 3:6]),
        v=state.v + df[:, 6:9],
        ba=state.ba + df[:, 9:12],
        bg=state.bg + df[:, 12:15],
        p_ic=state.p_ic + de[0:3],
        q_ic=_boxplus_q(state.q_ic, de[3:6]),
        p_relo=state.p_relo + dr[0:3],
        q_relo=_boxplus_q(state.q_relo, dr[3:6]),
    )


def boxminus_state(x: WindowState, x0: WindowState, cfg: WindowConfig):
    """x ⊟ x0 in delta layout (replays the prior)."""
    dq = lambda a, b: quat_log(quat_mul(quat_conj(a), b))
    df = torch.cat([x.p - x0.p, dq(x0.q, x.q), x.v - x0.v, x.ba - x0.ba,
                    x.bg - x0.bg], dim=-1).reshape(-1)
    de = torch.cat([x.p_ic - x0.p_ic, dq(x0.q_ic, x.q_ic)])
    dr = torch.cat([x.p_relo - x0.p_relo, dq(x0.q_relo, x.q_relo)])
    return torch.cat([df, de, dr])


# ---------------------------------------------------------------------------
# residual stack (points-only layout)
# ---------------------------------------------------------------------------


def _imu_residuals(state, data, cfg, params):
    """[NF-1, 15] whitened IMU residuals from the stored preintegrations."""
    r = imu_mod.evaluate(
        data.imu_pre, params,
        state.p[:-1], state.q[:-1], state.v[:-1], state.ba[:-1], state.bg[:-1],
        state.p[1:], state.q[1:], state.v[1:], state.ba[1:], state.bg[1:],
    )
    return (data.imu_sqrt @ r[..., None])[..., 0] * data.imu_valid[:, None].to(r.dtype)


def _robust(r, valid, cfg, sqrt_info):
    """Whiten, kill non-finite/invalid rows, apply the Huber weight (held
    constant under differentiation, as the reference's stop_gradient)."""
    r = r * sqrt_info
    r = torch.where(torch.isfinite(r) & valid[..., None], r, torch.zeros_like(r))
    w = res.huber_weight(torch.sum(r * r, dim=-1).detach(), cfg.huber_delta)
    return r * w[..., None]


def _anchor_pose(state, data):
    i = data.pt_start
    return state.p[i], state.q[i]


def _point_residuals(state, data, inv_depth, cfg):
    """[MAXP, NF, 2] whitened + robust point residuals."""
    nf = cfg.nf
    p_i, q_i = _anchor_pose(state, data)
    P = data.pt_id.shape[0]
    obs_i = data.pt_obs[torch.arange(P, device=data.pt_obs.device), data.pt_start]
    r = res.point_reprojection(
        p_i[:, None], q_i[:, None], state.p[None], state.q[None],
        state.p_ic, state.q_ic, inv_depth[:, None], obs_i[:, None], data.pt_obs,
    )
    frames = torch.arange(nf, device=data.pt_mask.device)
    valid = (
        (data.pt_id >= 0)[:, None] & data.pt_mask & data.pt_solved[:, None]
        & (frames[None, :] != data.pt_start[:, None])
    )
    return _robust(r, valid, cfg, cfg.point_sqrt_info)


def _relo_residuals(state, data, inv_depth, cfg):
    """[MAXP, 2] relocalization factors against the relo (old keyframe) pose."""
    p_i, q_i = _anchor_pose(state, data)
    P = data.pt_id.shape[0]
    obs_i = data.pt_obs[torch.arange(P, device=data.pt_obs.device), data.pt_start]
    r = res.point_reprojection(
        p_i, q_i, state.p_relo, state.q_relo, state.p_ic, state.q_ic,
        inv_depth, obs_i, data.relo_obs,
    )
    valid = data.relo_valid & data.relo_mask & (data.pt_id >= 0) & data.pt_solved
    return _robust(r, valid, cfg, cfg.point_sqrt_info)


def window_residuals(x, data: TrackData, cfg: WindowConfig, params: imu_mod.ImuParams,
                     use_relo: bool = True):
    """Whitened residual stack [prior | imu | points | relo]; x = (state,
    inv_depth).  The marginalization stack leaves the relo rows out."""
    state, inv_depth = x
    parts = [
        marg_mod.prior_residual(data.prior, boxminus_state(state, data.prior_state, cfg)),
        _imu_residuals(state, data, cfg, params).reshape(-1),
        _point_residuals(state, data, inv_depth, cfg).reshape(-1),
    ]
    if use_relo:
        parts.append(_relo_residuals(state, data, inv_depth, cfg).reshape(-1))
    return torch.cat(parts)


def retract_all(x, delta, cfg: WindowConfig):
    state, inv_depth = x
    nd, P = cfg.nd, cfg.max_points
    return retract_state(state, delta[:nd], cfg), inv_depth + delta[nd: nd + P]


def layout_for(cfg: WindowConfig):
    return lm_mod.WindowLayout(nd=cfg.nd, nf=cfg.nf, P=cfg.max_points)


# ---------------------------------------------------------------------------
# BA solve + gauge fix
# ---------------------------------------------------------------------------


def solve_window(state: WindowState, data: TrackData, cfg: WindowConfig,
                 params: imu_mod.ImuParams, num_iters: int | None = None):
    """Sliding-window BA + yaw/position gauge re-anchoring."""
    out = lm_mod.lm_solve_window(
        lambda x: window_residuals(x, data, cfg, params),
        lambda x, d: retract_all(x, d, cfg),
        (state, data.pt_inv_depth),
        layout_for(cfg),
        lm_mod.LMConfig(num_iters=num_iters or cfg.ba_iters),
    )
    state_new, invd_new = out.x
    return gauge_fix(state, state_new), data._replace(pt_inv_depth=invd_new), out


def gauge_fix(state, state_new):
    """Restore frame-0 position and yaw after a solve (double2vector2), with
    the same rigid correction on the relo pose (points half: no lines)."""
    ypr0_old = rot_to_ypr(quat_to_rot(state.q[0]))
    ypr0_new = rot_to_ypr(quat_to_rot(state_new.q[0]))
    dyaw = ypr0_old[0] - ypr0_new[0]
    z = torch.zeros_like(dyaw)
    R_fix = ypr_to_rot(torch.stack([dyaw, z, z]))
    q_fix = rot_to_quat(R_fix)
    rot = lambda v: (R_fix @ v[..., None])[..., 0]
    return state_new._replace(
        p=rot(state_new.p - state_new.p[0]) + state.p[0],
        q=quat_mul(q_fix, state_new.q),
        v=rot(state_new.v),
        p_relo=rot(state_new.p_relo - state_new.p[0]) + state.p[0],
        q_relo=quat_mul(q_fix, state_new.q_relo),
    )


# ---------------------------------------------------------------------------
# triangulation + outlier rejection (points)
# ---------------------------------------------------------------------------


def camera_poses(state: WindowState):
    """World-from-camera (q_wc [NF,4], p_wc [NF,3])."""
    q_wc = quat_mul(state.q, state.q_ic)
    p_wc = state.p + quat_rotate(state.q, state.p_ic)
    return q_wc, p_wc


def triangulate_points(state: WindowState, data: TrackData, cfg: WindowConfig):
    """Initialize depths of unsolved tracks (feature_manager.cpp:565-621)."""
    from ..ops.mvg import triangulate_tracks

    q_wc, p_wc = camera_poses(state)
    R_cw = quat_to_rot(quat_conj(q_wc))
    t_cw = -(R_cw @ p_wc[..., None])[..., 0]
    X_w, ok2 = triangulate_tracks(R_cw, t_cw, data.pt_obs[:, :, 0:2], data.pt_mask)
    i = data.pt_start
    z_anchor = quat_rotate(quat_conj(q_wc[i]), X_w - p_wc[i])[:, 2]
    n_obs = torch.sum(data.pt_mask.long(), dim=1)
    new_ok = (data.pt_id >= 0) & ~data.pt_solved & (n_obs >= 2) & (z_anchor > 0.1) & ok2
    invd = torch.where(new_ok, 1.0 / torch.clamp(z_anchor, 0.1, 1e3), data.pt_inv_depth)
    return data._replace(pt_inv_depth=invd, pt_solved=data.pt_solved | new_ok)


def reject_outliers(state, data, cfg, reproj_thresh=5.0 / 460.0):
    """Drop solved tracks with negative depth or a large mean reprojection
    error (estimator removeFailures; points half)."""
    r_pt = _point_residuals(state, data, data.pt_inv_depth, cfg) / cfg.point_sqrt_info
    err = torch.linalg.norm(r_pt, dim=-1)
    n = torch.clamp(torch.sum(data.pt_mask.long(), dim=1) - 1, min=1)
    mean_err = torch.sum(err, dim=1) / n
    bad = data.pt_solved & ((data.pt_inv_depth < 0) | (mean_err > reproj_thresh))
    return data._replace(
        pt_id=torch.where(bad, torch.full_like(data.pt_id, -1), data.pt_id),
        pt_solved=data.pt_solved & ~bad,
        pt_mask=data.pt_mask & ~bad[:, None],
    )
