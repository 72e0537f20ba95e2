"""Residual primitives of the sliding-window BA (points).

Port of the point parts of ``vplines_slam_tpu/factors/residuals.py``:
unit-sphere tangent-plane reprojection (projection_factor.cpp with
UNIT_SPHERE_ERROR) and the Huber IRLS weight.  Batched over leading dims and
written for ``torch.func`` transforms (no in-place writes).  The line and VP
residuals are not ported yet.
"""

from __future__ import annotations

import torch

from ..utils.geometry import cross, quat_conj, quat_rotate

FOCAL_LENGTH = 460.0
POINT_SQRT_INFO = FOCAL_LENGTH / 1.5


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
