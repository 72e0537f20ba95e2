"""Sliding-window state, residual stack, BA solve, triangulation and culls.

Port of ``vplines_slam_tpu/estimator/window.py``.  ``WindowConfig``,
``WindowState`` and ``TrackData`` keep the reference's fields so state
converts one to one.  Two layouts (``solver.lm.WindowLayout``):

- points only (``x = (state, inv_depth)``): no line/VP rows, no line
  columns.  The reference with empty line tables stacks rows that are
  identically zero there, so the solve is the same;
- lines (``x = (state, inv_depth, orth)``): the reference's stack with line
  and VP rows and 4-dof line columns.

Dense parameter layout (delta space): frame k at 15k [δp δθ δv δba δbg],
extrinsic [δp_ic δθ_ic] at 15·NF, relocalization pose at 15·NF + 6,
ND = 15·NF + 12; then the MAXP inverse depths, then 4·MAXL line coords.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from ..factors import residuals as res
from ..models import imu as imu_mod
from ..solver import lm as lm_mod
from ..solver import marginalization as marg_mod
from ..utils.geometry import (
    cross,
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
from ..utils.plucker import (
    orth_boxplus,
    orth_to_plk,
    pi_from_ppp,
    pipi_plk,
    plk_to_orth,
    plk_transform,
    plk_transform_inv,
)


class WindowConfig(NamedTuple):
    """The reference's fields, in its order (the device loop's and the
    initializer's)."""

    window: int = 10  # keyframes (parameters.h WINDOW_SIZE)
    max_points: int = 128
    max_lines: int = 32
    max_imu: int = 64  # IMU samples capacity per interval
    g_norm: float = 9.81007
    point_sqrt_info: float = res.POINT_SQRT_INFO
    line_sqrt_info: float = res.LINE_SQRT_INFO
    vp_sqrt_info: float = res.VP_SQRT_INFO
    huber_delta: float = 1.0
    min_parallax: float = 10.0 / 460.0  # keyframe threshold
    ba_iters: int = 8
    line_min_obs: int = 5  # LINE_MIN_OBS
    prior_chi2_cap: float = 0.6  # χ²-consistency cap on the prior
    init_min_corres: int = 20  # initializer: correspondence gate
    init_min_parallax: float = 30.0 / 460.0  # initializer: parallax gate
    retire_points: bool = True  # retire tracks absorbed into the prior
    # lines stay live-only by default: their factors never enter the prior
    # (marg_lines=False); True folds them in and re-anchors (reference parity)
    retire_lines: bool = False
    marg_lines: bool = False

    @property
    def nf(self):
        return self.window + 1

    @property
    def nd(self):
        return 15 * self.nf + 12  # frames + extrinsic + relo pose

    @property
    def n_landmark(self):
        return self.max_points + 4 * self.max_lines

    @property
    def n_total(self):
        """Columns of the lines layout: dense block + every landmark."""
        return self.nd + self.n_landmark

    def n_columns(self, use_lines):
        """Columns of the layout in use (points only: nd + max_points)."""
        return self.n_total if use_lines else self.nd + self.max_points


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
    frame_t: torch.Tensor  # [NF] f64
    relo_stamp: torch.Tensor  # [] f64
    prior: marg_mod.Prior
    prior_state: WindowState


def empty_state(cfg: WindowConfig, dtype=torch.float64, device=torch.device("cuda")) -> WindowState:
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


def empty_tracks(cfg: WindowConfig, dtype=torch.float64, device=torch.device("cuda")) -> TrackData:
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
        # stamps are f64 whatever the engine dtype: f32 rounds EuRoC-epoch
        # stamps (~1.4e9 s) to multiples of 128 s
        frame_t=torch.full((nf,), -1.0, dtype=torch.float64, device=device),
        relo_stamp=torch.tensor(-2.0, dtype=torch.float64, device=device),
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


def _line_active(data, cfg):
    """[MAXL] lines that enter the solve (live, triangulated, enough obs)."""
    n_obs = torch.sum(data.ln_mask.long(), dim=1)
    return (data.ln_id >= 0) & data.ln_solved & (n_obs >= cfg.line_min_obs)


def _line_residuals(state, data, orth, cfg):
    """[MAXL, NF, 2] whitened + robust line residuals."""
    r = res.line_reprojection(state.p[None], state.q[None], state.p_ic, state.q_ic,
                              orth[:, None], data.ln_obs)
    valid = _line_active(data, cfg)[:, None] & data.ln_mask
    return _robust(r, valid, cfg, cfg.line_sqrt_info)


def _vp_residuals(state, data, orth, cfg):
    """[MAXL, NF, 2] whitened + robust VP residuals (Huber, as the
    reference's vpProjectionFactor)."""
    r = res.vp_alignment(state.p[None], state.q[None], state.p_ic, state.q_ic,
                         orth[:, None], data.ln_vp)
    valid = _line_active(data, cfg)[:, None] & data.ln_mask & data.ln_vp_mask
    return _robust(r, valid, cfg, cfg.vp_sqrt_info)


def window_residuals(x, data: TrackData, cfg: WindowConfig, params: imu_mod.ImuParams,
                     use_relo: bool = True, use_vps: bool = True):
    """Whitened residual stack [prior | imu | points | (lines | vps |) relo].
    x = (state, inv_depth) for the points-only layout, (state, inv_depth,
    orth) for the lines layout.  The marginalization stack leaves the relo
    and VP rows out."""
    state, inv_depth = x[0], x[1]
    parts = [
        marg_mod.prior_residual(data.prior, boxminus_state(state, data.prior_state, cfg)),
        _imu_residuals(state, data, cfg, params).reshape(-1),
        _point_residuals(state, data, inv_depth, cfg).reshape(-1),
    ]
    if len(x) == 3:
        parts.append(_line_residuals(state, data, x[2], cfg).reshape(-1))
        if use_vps:
            parts.append(_vp_residuals(state, data, x[2], cfg).reshape(-1))
    if use_relo:
        parts.append(_relo_residuals(state, data, inv_depth, cfg).reshape(-1))
    return torch.cat(parts)


def retract_all(x, delta, cfg: WindowConfig):
    nd, P = cfg.nd, cfg.max_points
    out = (retract_state(x[0], delta[:nd], cfg), x[1] + delta[nd: nd + P])
    if len(x) == 3:
        out = out + (orth_boxplus(x[2], delta[nd + P:].reshape(-1, 4)),)
    return out


def layout_for(cfg: WindowConfig, use_lines: bool = False, use_relo: bool = True,
               use_vps: bool = True):
    """The rows and columns of ``window_residuals(x, ..., use_relo, use_vps)``."""
    if not use_lines:
        return lm_mod.WindowLayout(nd=cfg.nd, nf=cfg.nf, P=cfg.max_points, has_relo=use_relo)
    return lm_mod.WindowLayout(nd=cfg.nd, nf=cfg.nf, P=cfg.max_points, L=cfg.max_lines,
                               has_lines=True, has_vps=use_vps, has_relo=use_relo)


# ---------------------------------------------------------------------------
# BA solve + gauge fix
# ---------------------------------------------------------------------------


def solve_window(state: WindowState, data: TrackData, cfg: WindowConfig,
                 params: imu_mod.ImuParams, num_iters: int | None = None,
                 use_lines: bool = False):
    """Sliding-window BA + yaw/position gauge re-anchoring (the solved world
    lines ride the same correction).  The LM's linearization and cost pass
    are K11 (``estimator/linearize.py``) on CUDA tensors."""
    from .linearize import window_blocks, window_cost_residuals

    x0 = (state, data.pt_inv_depth) + ((data.ln_orth,) if use_lines else ())
    out = lm_mod.lm_solve_window(
        lambda x: window_cost_residuals(x, data, cfg, params),
        lambda x: window_blocks(x, data, cfg, params),
        lambda x, d: retract_all(x, d, cfg),
        x0,
        layout_for(cfg, use_lines),
        lm_mod.LMConfig(num_iters=num_iters or cfg.ba_iters),
    )
    orth_new = out.x[2] if use_lines else data.ln_orth
    state_fixed, orth_fixed = gauge_fix(state, out.x[0], orth_new,
                                        data.ln_solved if use_lines else None)
    return state_fixed, data._replace(pt_inv_depth=out.x[1], ln_orth=orth_fixed), out


def gauge_fix(state, state_new, orth_new, ln_solved=None):
    """Restore frame-0 position and yaw after a solve (double2vector2), with
    the same rigid correction on the relo pose and on the solved world lines
    (ln_solved None: the lines are left as they are)."""
    ypr0_old = rot_to_ypr(quat_to_rot(state.q[0]))
    ypr0_new = rot_to_ypr(quat_to_rot(state_new.q[0]))
    dyaw = ypr0_old[0] - ypr0_new[0]
    z = torch.zeros_like(dyaw)
    R_fix = ypr_to_rot(torch.stack([dyaw, z, z]))
    q_fix = rot_to_quat(R_fix)
    rot = lambda v: (R_fix @ v[..., None])[..., 0]
    state_fixed = state_new._replace(
        p=rot(state_new.p - state_new.p[0]) + state.p[0],
        q=quat_mul(q_fix, state_new.q),
        v=rot(state_new.v),
        p_relo=rot(state_new.p_relo - state_new.p[0]) + state.p[0],
        q_relo=quat_mul(q_fix, state_new.q_relo),
    )
    if ln_solved is None:
        return state_fixed, orth_new
    # world' = R_fix · world + t_fix
    t_fix = state.p[0] - rot(state_new.p[0])
    fixed = plk_to_orth(plk_transform(orth_to_plk(orth_new), R_fix, t_fix))
    return state_fixed, torch.where(ln_solved[:, None], fixed, orth_new)


# ---------------------------------------------------------------------------
# triangulation, the line-only settle and outlier rejection
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


def _first_obs(mask):
    """[L] index of each row's first True (0 for an empty row), jnp.argmax."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def _homog(xy):
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def triangulate_lines(state: WindowState, data: TrackData, cfg: WindowConfig):
    """Initialize world Plücker lines from the observation pair with the
    widest plane angle (feature_manager.cpp triangulateLine:413-563)."""
    q_wc, p_wc = camera_poses(state)
    L = data.ln_id.shape[0]
    ar = torch.arange(L, device=data.ln_id.device)
    first = _first_obs(data.ln_mask)
    obs_i = data.ln_obs[ar, first]  # [L, 4]
    zero3 = torch.zeros_like(obs_i[:, 0:3])
    pii = pi_from_ppp(zero3, _homog(obs_i[:, 0:2]), _homog(obs_i[:, 2:4]))  # [L, 4]
    # every frame j's endpoints expressed in the anchor frame i
    qf_inv = quat_conj(q_wc[first])[:, None]  # [L, 1, 4]
    q_ij = quat_mul(qf_inv, q_wc[None])  # [L, NF, 4]
    t_ij = quat_rotate(qf_inv, p_wc[None] - p_wc[first][:, None])  # [L, NF, 3]
    a = quat_rotate(q_ij, _homog(data.ln_obs[..., 0:2])) + t_ij
    b = quat_rotate(q_ij, _homog(data.ln_obs[..., 2:4])) + t_ij
    pjs = pi_from_ppp(t_ij, a, b)  # [L, NF, 4]
    ni = pii[:, 0:3] / torch.linalg.norm(pii[:, 0:3], dim=-1, keepdim=True)
    njs = pjs[..., 0:3] / torch.linalg.norm(pjs[..., 0:3], dim=-1, keepdim=True)
    cosang = torch.abs(torch.sum(njs * ni[:, None], dim=-1))
    frames = torch.arange(cfg.nf, device=ar.device)
    use = data.ln_mask & (frames[None, :] != first[:, None])
    cosang = torch.where(use, cosang, torch.full_like(cosang, 2.0))
    best = torch.argmin(cosang, dim=1)
    plk_i = pipi_plk(pii, pjs[ar, best])
    R_wc_i = quat_to_rot(q_wc[first])
    R_cw_i = R_wc_i.mT
    plk_w = plk_transform_inv(plk_i, R_cw_i, -(R_cw_i @ p_wc[first][..., None])[..., 0])
    good = cosang[ar, best] < 0.998  # reference cos θ gate (:538)
    n_obs = torch.sum(data.ln_mask.long(), dim=1)
    new_ok = (data.ln_id >= 0) & ~data.ln_solved & (n_obs >= cfg.line_min_obs) & good
    orth = torch.where(new_ok[:, None], plk_to_orth(plk_w), data.ln_orth)
    return data._replace(ln_orth=orth, ln_solved=data.ln_solved | new_ok)


def settle_lines(state: WindowState, data: TrackData, cfg: WindowConfig, num_iters: int = 8):
    """Line-only damped Gauss-Newton with poses fixed and a Cauchy(1) loss
    (the reference's onlyLineOpt, estimator.cpp:950-1042).  With poses fixed
    the problem is block-diagonal per line: every line takes its own 4x4
    step; the 4 Jacobian columns of all lines come from 4 jvps (each
    residual row depends on one line only)."""
    active = _line_active(data, cfg)

    def line_resid(orth):  # [L, 4] -> [L, NF*2]
        r = res.line_reprojection(state.p[None], state.q[None], state.p_ic, state.q_ic,
                                  orth[:, None], data.ln_obs) * cfg.line_sqrt_info
        r = torch.where(torch.isfinite(r) & data.ln_mask[..., None], r, torch.zeros_like(r))
        w = res.cauchy_weight(torch.sum(r * r, dim=-1).detach(), 1.0)
        return (r * w[..., None]).reshape(r.shape[0], -1)

    orth = data.ln_orth
    L = orth.shape[0]
    eye4 = torch.eye(4, dtype=orth.dtype, device=orth.device)
    tangents = eye4[:, None, :].expand(4, L, 4)
    for _ in range(num_iters):
        f = lambda d: line_resid(orth_boxplus(orth, d))
        zero = torch.zeros_like(orth)
        r = f(zero)
        J = vmap(lambda t: jvp(f, (zero,), (t,))[1])(tangents).permute(1, 2, 0)  # [L, R, 4]
        H = J.mT @ J
        H = H + 1e-3 * torch.diag_embed(torch.diagonal(H, dim1=1, dim2=2)) + 1e-8 * eye4
        g = (J.mT @ r[..., None])[..., 0]
        d = -torch.linalg.solve_ex(H, g)[0]
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        new = orth_boxplus(orth, d)
        c0 = torch.sum(r * r, dim=1)
        c1 = torch.sum(line_resid(new) ** 2, dim=1)
        orth = torch.where((c1 < c0)[:, None], new, orth)
    return data._replace(ln_orth=torch.where(active[:, None], orth, data.ln_orth))


def _line_endpoint_gates(state, data, cfg):
    """The reference's geometric line culls (removeLineOutlier:702-798):
    trim the infinite line by the anchor-frame observation and flag lines
    whose 3D endpoints land behind the camera or spread over > 10 m."""
    q_wc, p_wc = camera_poses(state)
    L = data.ln_id.shape[0]
    ar = torch.arange(L, device=data.ln_id.device)
    i = _first_obs(data.ln_mask)
    R_cw = quat_to_rot(quat_conj(q_wc[i]))  # [L, 3, 3]
    t_cw = -(R_cw @ p_wc[i][..., None])[..., 0]
    plk_c = plk_transform(orth_to_plk(data.ln_orth), R_cw, t_cw)
    nc, vc = plk_c[:, 0:3], plk_c[:, 3:6]
    obs = data.ln_obs[ar, i]
    p11, p21 = _homog(obs[:, 0:2]), _homog(obs[:, 2:4])
    ln = cross(p11, p21)[:, 0:2]
    ln = ln / torch.clamp(torch.linalg.norm(ln, dim=-1, keepdim=True), min=1e-12)
    ln3 = torch.cat([ln, torch.zeros_like(ln[:, :1])], dim=-1)
    zero = torch.zeros_like(p11)
    pi1 = pi_from_ppp(zero, p11, p11 + ln3)
    pi2 = pi_from_ppp(zero, p21, p21 + ln3)

    def meet(pi):  # dual Plücker matrix [[nc]x, vc; -vcᵀ, 0] @ pi
        xyz = cross(nc, pi[:, 0:3]) + vc * pi[:, 3:4]
        return torch.cat([xyz, -torch.sum(vc * pi[:, 0:3], dim=-1, keepdim=True)], dim=-1)

    def unhom(e):
        w = e[:, 3:4]
        return e / torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))

    e1, e2 = unhom(meet(pi1)), unhom(meet(pi2))
    bad = (e1[:, 2] < 0) | (e2[:, 2] < 0) | (torch.linalg.norm(e1[:, 0:3] - e2[:, 0:3], dim=-1) > 10.0)
    return bad | ~torch.all(torch.isfinite(e1), dim=-1) | ~torch.all(torch.isfinite(e2), dim=-1)


def reject_outliers(state, data, cfg, reproj_thresh=5.0 / 460.0, line_thresh=3.0 / 500.0,
                    cull_points=True, use_lines=False):
    """Drop solved tracks with negative depth or a large mean reprojection
    error (estimator removeFailures) and, with lines, solved lines with a
    large max per-observation error or failing the endpoint gates
    (removeLineOutlier).  cull_points=False restricts the pass to lines."""
    if cull_points:
        r_pt = _point_residuals(state, data, data.pt_inv_depth, cfg) / cfg.point_sqrt_info
        err = torch.linalg.norm(r_pt, dim=-1)
        n = torch.clamp(torch.sum(data.pt_mask.long(), dim=1) - 1, min=1)
        mean_err = torch.sum(err, dim=1) / n
        bad = data.pt_solved & ((data.pt_inv_depth < 0) | (mean_err > reproj_thresh))
        data = data._replace(
            pt_id=torch.where(bad, torch.full_like(data.pt_id, -1), data.pt_id),
            pt_solved=data.pt_solved & ~bad,
            pt_mask=data.pt_mask & ~bad[:, None],
        )
    if not use_lines:
        return data
    r_ln = _line_residuals(state, data, data.ln_orth, cfg) / cfg.line_sqrt_info
    err_l = torch.amax(torch.linalg.norm(r_ln, dim=-1), dim=1)
    bad_ln = data.ln_solved & ((err_l > line_thresh) | _line_endpoint_gates(state, data, cfg))
    return data._replace(
        ln_id=torch.where(bad_ln, torch.full_like(data.ln_id, -1), data.ln_id),
        ln_solved=data.ln_solved & ~bad_ln,
        ln_mask=data.ln_mask & ~bad_ln[:, None],
    )
