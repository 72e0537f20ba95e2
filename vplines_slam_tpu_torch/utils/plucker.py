"""Plücker / orthonormal 3D line algebra.

Port of ``vplines_slam_tpu/utils/plucker.py`` (line_geometry.cpp semantics).
A Plücker line is ``[n (3), v (3)]`` (``v`` the direction, ``n = p × v`` the
moment); the orthonormal 4-dof form is ``[θ1, θ2, θ3, φ]``: ZYX-Euler angles
of U = [n̂, v̂, n̂×v̂] and the SO(2) angle φ with (cos φ, sin φ) ∝ (‖n‖, ‖v‖).
Every function broadcasts over leading dimensions (the reference's are
single-instance and vmapped at call sites) and is safe under ``torch.func``.
"""

from __future__ import annotations

import torch

from .geometry import cross, quat_to_rot, so3_exp_quat


def _mv(R, v):
    """R [..., 3, 3] @ v [..., 3], broadcasting the leading dims."""
    return torch.matmul(R, v.unsqueeze(-1)).squeeze(-1)


def _euler_zyx_to_rot(theta):
    """R = Rz(θ3) @ Ry(θ2) @ Rx(θ1) (line_geometry.cpp:99)."""
    s1, c1 = torch.sin(theta[..., 0]), torch.cos(theta[..., 0])
    s2, c2 = torch.sin(theta[..., 1]), torch.cos(theta[..., 1])
    s3, c3 = torch.sin(theta[..., 2]), torch.cos(theta[..., 2])
    return torch.stack([
        torch.stack([c2 * c3, s1 * s2 * c3 - c1 * s3, c1 * s2 * c3 + s1 * s3], -1),
        torch.stack([c2 * s3, s1 * s2 * s3 + c1 * c3, c1 * s2 * s3 - s1 * c3], -1),
        torch.stack([-s2, s1 * c2, c1 * c2], -1),
    ], dim=-2)


def orth_to_plk(orth):
    """[θ1,θ2,θ3,φ] -> Plücker [n, v] with ‖n‖ = cos φ, ‖v‖ = sin φ."""
    R = _euler_zyx_to_rot(orth[..., 0:3])
    phi = orth[..., 3:4]
    return torch.cat([torch.cos(phi) * R[..., :, 0], torch.sin(phi) * R[..., :, 1]], dim=-1)


def plk_to_orth(plk):
    """Plücker [n, v] -> orthonormal [θ1,θ2,θ3,φ]."""
    n, v = plk[..., 0:3], plk[..., 3:6]
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    u1, u2 = n / nn, v / vn
    u3 = cross(u1, u2)
    th1 = torch.atan2(u2[..., 2], u3[..., 2])
    th2 = torch.asin(torch.clamp(-u1[..., 2], -1.0, 1.0))
    th3 = torch.atan2(u1[..., 1], u1[..., 0])
    wn = torch.sqrt(nn * nn + vn * vn)
    phi = torch.asin(torch.clamp(vn / wn, -1.0, 1.0))[..., 0]
    return torch.stack([th1, th2, th3, phi], dim=-1)


def pi_from_ppp(x1, x2, x3):
    """Plane [a,b,c,d] through three points (line_geometry.cpp:134)."""
    normal = cross(x1 - x3, x2 - x3)
    d = -torch.sum(x3 * cross(x1, x2), dim=-1, keepdim=True)
    return torch.cat([normal, d], dim=-1)


def pipi_plk(pi1, pi2):
    """Plücker line of two intersecting planes (line_geometry.cpp:142), from
    the dual Plücker matrix dp = pi1 pi2ᵀ - pi2 pi1ᵀ."""
    dp = pi1[..., :, None] * pi2[..., None, :] - pi2[..., :, None] * pi1[..., None, :]
    return torch.stack([dp[..., 0, 3], dp[..., 1, 3], dp[..., 2, 3],
                        -dp[..., 1, 2], dp[..., 0, 2], -dp[..., 0, 1]], dim=-1)


def plk_transform(plk_w, R_cw, t_cw):
    """World line -> frame c with x_c = R_cw x_w + t_cw:
    nc = R n + [t]× R v, vc = R v (plk_to_pose:198)."""
    Rv = _mv(R_cw, plk_w[..., 3:6])
    nc = _mv(R_cw, plk_w[..., 0:3]) + cross(t_cw, Rv)
    return torch.cat([nc, Rv], dim=-1)


def plk_transform_inv(plk_c, R_cw, t_cw):
    """Inverse transform: camera-frame line -> world (plk_from_pose:211)."""
    R_wc = R_cw.transpose(-1, -2)
    return plk_transform(plk_c, R_wc, -_mv(R_wc, t_cw))


def orth_boxplus(orth, delta):
    """Retraction of the 4-dof coords: U <- U·exp([δθ]×), φ <- φ + δφ, then
    re-extract the Euler angles (LineOrthParameterization::Plus to first
    order)."""
    R = _euler_zyx_to_rot(orth[..., 0:3])
    Rn = R @ quat_to_rot(so3_exp_quat(delta[..., 0:3]))
    th1 = torch.atan2(Rn[..., 2, 1], Rn[..., 2, 2])
    th2 = torch.asin(torch.clamp(-Rn[..., 2, 0], -1.0, 1.0))
    th3 = torch.atan2(Rn[..., 1, 0], Rn[..., 0, 0])
    return torch.stack([th1, th2, th3, orth[..., 3] + delta[..., 3]], dim=-1)
