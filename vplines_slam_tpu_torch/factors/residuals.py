"""Residual primitives of the sliding-window BA.

Port of ``vplines_slam_tpu/factors/residuals.py``: unit-sphere tangent-plane
point reprojection (projection_factor.cpp with UNIT_SPHERE_ERROR), the line
endpoint-to-projected-line distances and the vanishing-point alignment
(line_projection_factor.cpp), and the Huber / Cauchy IRLS weights.  Batched
over leading dims and written for ``torch.func`` transforms (no in-place
writes).  The line weight is the reference's fit-statistics value 1500, not
the C++ code's 306.67 (see the reference module's docstring).
"""

from __future__ import annotations

import torch

from ..utils.geometry import cross, quat_conj, quat_rotate, quat_to_rot
from ..utils.plucker import orth_to_plk, plk_transform

FOCAL_LENGTH = 460.0
POINT_SQRT_INFO = FOCAL_LENGTH / 1.5
LINE_SQRT_INFO = 1500.0  # fit-statistics weight; reference parity = 306.67
VP_SQRT_INFO = 10.0


def tangent_basis(ray):
    """Orthonormal basis (b1, b2) of the plane ⊥ ray."""
    a = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    tmp = torch.where(torch.abs(a[..., 2:3]) < 0.9, ez, ex)
    b1 = tmp - a * torch.sum(a * tmp, dim=-1, keepdim=True)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    return b1, cross(a, b1)


def point_reprojection(p_i, q_i, p_j, q_j, p_ic, q_ic, inv_depth, obs_i, obs_j):
    """Unit-sphere reprojection residual of a track between frames i and j
    (2-vector, unwhitened); inv_depth has the batch shape, obs_* [..., 3]."""
    pts_i = obs_i / obs_i[..., 2:3]
    pts_cam_i = pts_i / inv_depth[..., None]
    pts_imu_i = quat_rotate(q_ic, pts_cam_i) + p_ic
    pts_w = quat_rotate(q_i, pts_imu_i) + p_i
    pts_imu_j = quat_rotate(quat_conj(q_j), pts_w - p_j)
    pts_cam_j = quat_rotate(quat_conj(q_ic), pts_imu_j - p_ic)
    b1, b2 = tangent_basis(obs_j)
    d = pts_cam_j / torch.linalg.norm(pts_cam_j, dim=-1, keepdim=True)
    e = d - obs_j / torch.linalg.norm(obs_j, dim=-1, keepdim=True)
    return torch.stack([torch.sum(b1 * e, -1), torch.sum(b2 * e, -1)], dim=-1)


def huber_weight(r_sq, delta):
    """sqrt of the ceres-style Huber IRLS weight."""
    w = torch.where(r_sq <= delta * delta, torch.ones_like(r_sq),
                    delta / torch.sqrt(torch.clamp(r_sq, min=1e-30)))
    return torch.sqrt(w)


def _world_line_in_camera(p_i, q_i, p_ic, q_ic, orth_w):
    """World orthonormal line -> Plücker line in camera i (world -> body ->
    camera, as the reference chains it)."""
    plk_b = plk_transform(orth_to_plk(orth_w), quat_to_rot(q_i).mT,
                          -quat_rotate(quat_conj(q_i), p_i))
    return plk_transform(plk_b, quat_to_rot(q_ic).mT, -quat_rotate(quat_conj(q_ic), p_ic))


def _point_to_line_residual(plk_c, obs):
    """Distances of the endpoints obs [..., 4] (normalized plane) to the
    projected infinite line; the guard keeps degenerate slots finite."""
    nc = plk_c[..., 0:3]
    denom = torch.sqrt(torch.clamp(nc[..., 0] ** 2 + nc[..., 1] ** 2, min=1e-18))
    e1 = obs[..., 0] * nc[..., 0] + obs[..., 1] * nc[..., 1] + nc[..., 2]
    e2 = obs[..., 2] * nc[..., 0] + obs[..., 3] * nc[..., 1] + nc[..., 2]
    return torch.stack([e1 / denom, e2 / denom], dim=-1)


def line_reprojection(p_i, q_i, p_ic, q_ic, orth_w, obs):
    """Endpoint-to-projected-line distances (line_projection_factor.cpp:270)."""
    return _point_to_line_residual(_world_line_in_camera(p_i, q_i, p_ic, q_ic, orth_w), obs)


def _nonzero(x):
    return torch.where(torch.abs(x) < 1e-9, torch.full_like(x, 1e-9), x)


def vp_alignment(p_i, q_i, p_ic, q_ic, orth_w, vp_obs):
    """Projected 3D line direction in camera i against the observed VP
    (homogeneous, normalized plane; line_projection_factor.cpp:30-46)."""
    d_c = _world_line_in_camera(p_i, q_i, p_ic, q_ic, orth_w)[..., 3:6]
    dz, vz = _nonzero(d_c[..., 2]), _nonzero(vp_obs[..., 2])
    return torch.stack([d_c[..., 0] / dz - vp_obs[..., 0] / vz,
                        d_c[..., 1] / dz - vp_obs[..., 1] / vz], dim=-1)


def cauchy_weight(r_sq, scale):
    """sqrt ρ'(s) of the Cauchy loss ρ(s) = c²·log(1 + s/c²)."""
    return torch.sqrt(1.0 / (1.0 + r_sq / (scale * scale)))
