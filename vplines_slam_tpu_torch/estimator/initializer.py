"""Visual-inertial initialization: window SFM + gyro-bias / velocity /
gravity / scale alignment.

Port of ``vplines_slam_tpu/estimator/initializer.py``: the reference
frame choice (relativePose's parallax gate), the window SFM (essential
matrix, two-view triangulation, PnP of every frame, joint refinement with
the generic LM engine), the gyro-bias least squares, the linear alignment
with its gravity refinement, and the rotation of the result into a
gravity-aligned, zero-yaw world.  Every stage is masked fixed-shape linear
algebra; nothing branches on data on the host.

``window_sfm`` takes its RANSAC draws as an input (``sample_idx``
[n_hyp, 8] long in [0, N)), as ``ops.mvg.ransac_essential`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors import residuals as res
from ..models import imu as imu_mod
from ..ops import mvg
from ..solver import lm as lm_mod
from ..utils.geometry import (
    cross,
    gravity_to_rot,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_rot,
    rot_to_quat,
    rot_to_ypr,
    so3_exp_quat,
    ypr_to_rot,
)


def solve_gyro_bias(q_vis_rel, pre: imu_mod.Preintegration, valid):
    """Gyro bias from the SFM-vs-preintegration rotation least squares.
    q_vis_rel [K, 4] visual relative body rotations; pre batched over the K
    intervals; valid [K]."""
    dq_dbg = pre.jacobian[:, 3:6, 12:15]
    err = 2.0 * quat_mul(quat_conj(pre.delta_q), q_vis_rel)[:, 1:4]
    w = valid.to(err.dtype)[:, None]
    A = torch.einsum("kij,kil->jl", dq_dbg * w[:, :, None], dq_dbg)
    b = torch.einsum("kij,ki->j", dq_dbg, err * w)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A + 1e-12 * eye, b)


def _alignment_system(R_b, T_c, pre: imu_mod.Preintegration, valid, tic, g_dirs=None,
                      g0=None):
    """Solve the LinearAlignment (g_dirs None: 3-dof gravity) or the
    RefineGravity (g_dirs [3, 2] tangent basis around g0) system.  R_b
    [F, 3, 3] body rotations in c0, T_c [F, 3] camera positions in c0
    (unscaled); unknowns [v_0..v_{F-1} (3 each) | g (3 or 2) | s·100]."""
    dtype, dev = T_c.dtype, T_c.device
    F = T_c.shape[0]
    K = F - 1
    gdim = 3 if g_dirs is None else 2
    n_state = F * 3 + gdim + 1
    Ri_T = R_b[:-1].transpose(-1, -2)
    Rj = R_b[1:]
    dt = pre.sum_dt
    I3 = torch.eye(3, dtype=dtype, device=dev)

    A_vi_p = -dt[:, None, None] * I3
    A_g_p = Ri_T * (0.5 * dt * dt)[:, None, None]
    A_s_p = torch.einsum("kij,kj->ki", Ri_T, T_c[1:] - T_c[:-1]) / 100.0
    b_p = pre.delta_p + torch.einsum("kij,kjl,l->ki", Ri_T, Rj, tic) - tic[None, :]
    A_vi_v = -I3.expand(K, 3, 3)
    A_vj_v = Ri_T @ Rj
    A_g_v = Ri_T * dt[:, None, None]
    b_v = pre.delta_v
    if g_dirs is not None:
        A_g_p = A_g_p @ g_dirs
        A_g_v = A_g_v @ g_dirs
        b_p = b_p - torch.einsum("kij,j->ki", Ri_T * (0.5 * dt * dt)[:, None, None], g0)
        b_v = b_v - torch.einsum("kij,j->ki", Ri_T * dt[:, None, None], g0)

    # per pair: rows [p (3); v (3)], columns [v_i (3), v_j (3), g (gdim), s (1)]
    w = valid.to(dtype)[:, None, None]
    top = torch.cat([A_vi_p, torch.zeros(K, 3, 3, dtype=dtype, device=dev), A_g_p,
                     A_s_p[:, :, None]], dim=2)
    bot = torch.cat([A_vi_v, A_vj_v, A_g_v, torch.zeros(K, 3, 1, dtype=dtype, device=dev)],
                    dim=2)
    tA = torch.cat([top, bot], dim=1) * w
    tb = torch.cat([b_p, b_v], dim=1) * w[:, :, 0]
    rA = tA.transpose(-1, -2) @ tA
    rb = (tA.transpose(-1, -2) @ tb[:, :, None])[:, :, 0]
    # scatter each pair's 10x10 (9x9) block into the global system
    ks = torch.arange(K, device=dev)[:, None]
    idx = torch.cat([3 * ks + torch.arange(6, device=dev)[None],
                     (3 * F + torch.arange(gdim + 1, device=dev))[None].expand(K, -1)], dim=1)
    A = torch.zeros(n_state, n_state, dtype=dtype, device=dev)
    A = A.index_put((idx[:, :, None], idx[:, None, :]), rA, accumulate=True)
    b = torch.zeros(n_state, dtype=dtype, device=dev).index_put((idx,), rb, accumulate=True)
    A = A * 1000.0
    b = b * 1000.0
    return torch.linalg.solve(A + 1e-10 * torch.eye(n_state, dtype=dtype, device=dev), b)


def _tangent_basis(g):
    """[3, 2] orthonormal basis of the plane orthogonal to g."""
    a = g / torch.linalg.norm(g)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=g.dtype, device=g.device)
    tmp = torch.where(torch.abs(a[2]) > 0.999, ex, ez)
    b1 = tmp - a * torch.dot(a, tmp)
    b1 = b1 / torch.linalg.norm(b1)
    return torch.stack([b1, cross(a, b1)], dim=1)


def linear_alignment(R_b, T_c, pre, valid, tic, g_norm):
    """Body-frame velocities, gravity in c0 and the metric scale, with 4
    fixed gravity-refinement iterations.  Returns (v_body [F, 3], g_c0 [3],
    s, ok)."""
    F = T_c.shape[0]
    x = _alignment_system(R_b, T_c, pre, valid, tic)
    s = x[-1] / 100.0
    g = x[3 * F: 3 * F + 3]
    ok = (torch.abs(torch.linalg.norm(g) - g_norm) < 1.0) & (s > 0)
    for _ in range(4):
        g0 = g / torch.linalg.norm(g) * g_norm
        basis = _tangent_basis(g0)
        xr = _alignment_system(R_b, T_c, pre, valid, tic, g_dirs=basis, g0=g0)
        g = g0 + basis @ xr[3 * F: 3 * F + 2]
    # re-solve at the refined gravity for the velocities and scale
    xr = _alignment_system(R_b, T_c, pre, valid, tic, g_dirs=_tangent_basis(g), g0=g)
    s_ref = xr[-1] / 100.0
    return xr[: 3 * F].reshape(F, 3), g, s_ref, ok & (s_ref > 0)


class SfmResult(NamedTuple):
    R_c0_c: torch.Tensor  # [F, 3, 3] camera-k rotation in c0
    t_c0_c: torch.Tensor  # [F, 3] camera-k position in c0
    ok: torch.Tensor


def window_sfm(obs, mask, l, sample_idx, lm_iters=15):
    """Structure from motion over the init window.  obs [N, F, 2] normalized
    observations; mask [N, F]; l the reference frame (int or 0-dim tensor);
    frame F-1 is the current one; sample_idx [n_hyp, 8] the essential-matrix
    RANSAC draws.  Essential(l, F-1) -> triangulation -> DLT PnP of every
    frame -> joint refinement (poses with frame l fixed + inverse depths in
    frame l).  Returns (SfmResult, inverse depths [N], point ok [N])."""
    N, F, _ = obs.shape
    dtype, dev = obs.dtype, obs.device
    obs_l, obs_n = obs[:, l], obs[:, F - 1]
    co_mask = mask[:, l] & mask[:, F - 1]
    E, inl, n_inl = mvg.ransac_essential(obs_l, obs_n, co_mask, sample_idx)
    R_rel, t_rel, _ = mvg.decompose_essential(E, obs_l, obs_n, inl)
    X_l, z_l = mvg.triangulate_two_view(R_rel, t_rel, obs_l, obs_n)
    pt_ok = inl & (z_l > 0.1)

    # PnP of every frame against the frame-l structure (x_cf = R x_l + t)
    m_f = (pt_ok[:, None] & mask).T  # [F, N]
    obs_f = obs.transpose(0, 1)  # [F, N, 2]
    R0, t0, pnp_ok = mvg.pnp_dlt(X_l, obs_f, m_f)
    R_cl, t_cl = mvg.pnp_refine(R0, t0, X_l, obs_f, m_f)

    q_cl = rot_to_quat(R_cl)
    invd0 = 1.0 / torch.clamp(z_l, 0.05, 1e3)
    ones = lambda *s: torch.ones(*s, dtype=dtype, device=dev)
    obs_l3 = torch.cat([obs_l, ones(N, 1)], dim=-1)[:, None, :]  # [N, 1, 3]
    obs_h = torch.cat([obs, ones(N, F, 1)], dim=-1)  # [N, F, 3]
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    res_mask = (pt_ok[:, None] & mask).to(dtype)[:, :, None]
    gauge = (torch.arange(F, device=dev) != l).to(dtype)[:, None]

    def residual(x):
        q_all, t_all, invd = x  # camera-from-l poses, inverse depths in l
        q_wf = quat_conj(q_all)  # frame l is the world: body-in-world poses
        p_wf = -quat_rotate(q_wf, t_all)
        r = res.point_reprojection(zero3, ident, p_wf, q_wf, zero3, ident,
                                   invd[:, None].expand(N, F), obs_l3, obs_h)
        return (r * res_mask).reshape(-1)

    def retract(x, delta):
        q_all, t_all, invd = x
        d_pose = delta[: 6 * F].reshape(F, 6) * gauge  # frame l fixed
        return (quat_normalize(quat_mul(q_all, so3_exp_quat(d_pose[:, 0:3]))),
                t_all + d_pose[:, 3:6], invd + delta[6 * F:])

    spec = lm_mod.SchurSpec(dense_dim=6 * F, n_scalar=N)
    out = lm_mod.lm_solve(residual, retract, (q_cl, t_cl, invd0), spec,
                          lm_mod.LMConfig(num_iters=lm_iters))
    q_fin, t_fin, invd_fin = out.x
    # camera-from-l -> camera-in-c0 (c0 := frame l)
    q_lc = quat_conj(q_fin)
    ok = torch.all(pnp_ok) & (n_inl >= 12)
    return (SfmResult(R_c0_c=quat_to_rot(q_lc), t_c0_c=-quat_rotate(q_lc, t_fin), ok=ok),
            invd_fin, pt_ok)


class InitResult(NamedTuple):
    p: torch.Tensor  # [F, 3] body positions, world (gravity-aligned, metric)
    q: torch.Tensor  # [F, 4]
    v: torch.Tensor  # [F, 3]
    bg: torch.Tensor  # [3]
    g_world: torch.Tensor  # [3]
    scale: torch.Tensor
    ok: torch.Tensor


def visual_inertial_align(sfm: SfmResult, pre, valid, q_ic, p_ic, g_norm):
    """Gyro bias -> first-order correction of the preintegrations -> linear
    alignment -> rotation into a gravity-aligned, zero-yaw world.  pre:
    batched preintegrations of the F-1 intervals at zero bias."""
    R_ic = quat_to_rot(q_ic)
    R_b = sfm.R_c0_c @ R_ic.T[None]
    q_b = rot_to_quat(R_b)
    dbg = solve_gyro_bias(quat_mul(quat_conj(q_b[:-1]), q_b[1:]), pre, valid)

    # first-order repropagation to the new gyro bias
    J = pre.jacobian
    mv = lambda M: (M @ dbg[:, None])[..., 0]
    half = 0.5 * mv(J[:, 3:6, 12:15])
    delta_q = quat_normalize(quat_mul(
        pre.delta_q, torch.cat([torch.ones_like(half[:, :1]), half], dim=-1)))
    pre_corr = pre._replace(
        delta_q=delta_q,
        delta_p=pre.delta_p + mv(J[:, 0:3, 12:15]),
        delta_v=pre.delta_v + mv(J[:, 6:9, 12:15]),
        linearized_bg=dbg.expand_as(pre.linearized_bg),
    )
    v_body, g_c0, s, ok = linear_alignment(R_b, sfm.t_c0_c, pre_corr, valid, p_ic, g_norm)

    # metric body positions in c0, re-based to frame 0
    P = s * sfm.t_c0_c - torch.einsum("fij,j->fi", R_b, p_ic)
    P = P - P[0]
    V = torch.einsum("fij,fj->fi", R_b, v_body)
    # rotate so gravity is +z and frame-0 yaw is zero
    R0 = gravity_to_rot(g_c0)
    yaw = rot_to_ypr(R0 @ R_b[0])[0]
    z = torch.zeros_like(yaw)
    R0 = ypr_to_rot(torch.stack([-yaw, z, z])) @ R0
    return InitResult(p=P @ R0.T, q=rot_to_quat(R0[None] @ R_b), v=V @ R0.T, bg=dbg,
                      g_world=R0 @ g_c0, scale=s, ok=ok & sfm.ok)


def choose_reference_frame(obs, mask, min_parallax=30.0 / 460.0, min_corres=20):
    """The earliest frame with enough correspondences and mean parallax
    against the newest.  Returns (l, found) as 0-dim tensors."""
    N, F, _ = obs.shape
    co = mask & mask[:, F - 1:F]  # [N, F]
    d = torch.linalg.norm(obs - obs[:, F - 1:F], dim=-1)
    n = torch.sum(co.to(torch.int64), dim=0)
    avg = torch.sum(d * co, dim=0) / torch.clamp(n, min=1)
    good = (n >= min_corres) & (avg > min_parallax)
    good = torch.cat([good[:-1], torch.zeros_like(good[-1:])])  # never the newest
    return torch.argmax(good.to(torch.uint8)), torch.any(good)
