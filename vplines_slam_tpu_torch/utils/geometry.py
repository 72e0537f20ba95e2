"""Rotation / quaternion / SE(3) algebra on batched tensors.

Port of ``vplines_slam_tpu/utils/geometry.py`` (the functions the device
loop, the initializer and online calibration use).  Quaternions are Hamilton, stored ``[w, x, y, z]``; every
function broadcasts over leading dimensions and is safe under
``torch.func.jvp``/``vmap`` (no in-place writes).
"""

from __future__ import annotations

import math

import torch


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def quat_mul(q, p):
    """Hamilton product q ⊗ p, both [w,x,y,z]."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate vector v by unit quaternion q (R(q) @ v)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_rot(q):
    """Unit quaternion -> rotation matrix.  The components keep a trailing
    axis: forward-mode AD of a 0-dim f32 tensor times a Python float gives a
    f64 tangent, which a single quaternion [4] would otherwise hit."""
    w, x, y, z = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    r00 = 1 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.cat([r00, r01, r02], dim=-1),
            torch.cat([r10, r11, r12], dim=-1),
            torch.cat([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R):
    """Rotation matrix -> unit quaternion [w,x,y,z] (largest-pivot candidate,
    canonical sign w >= 0)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    qw = torch.stack([tw, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, tx, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, ty, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, tz], dim=-1)
    t = torch.stack([tw, tx, ty, tz], dim=-1)
    best = torch.argmax(t, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4cand, 4comp]
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0).to(q.dtype)


def delta_quat(theta):
    """Small-angle quaternion [1, theta/2] (unnormalised)."""
    one = torch.ones_like(theta[..., :1])
    return torch.cat([one, theta * 0.5], dim=-1)


def so3_exp_quat(theta):
    """Exact exponential map: rotation vector -> unit quaternion."""
    angle_sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    angle = torch.sqrt(angle_sq)
    small = angle_sq < 1e-12
    half = angle * 0.5
    k = torch.where(
        small,
        0.5 - angle_sq / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle),
    )
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * theta], dim=-1)


def quat_log(q):
    """Unit quaternion -> rotation vector (inverse of so3_exp_quat)."""
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0).to(q.dtype)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    vn = torch.linalg.norm(q[..., 1:4], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-12
    scale = torch.where(
        small, 2.0 / torch.clamp(w, min=1e-6),
        angle / torch.where(small, torch.ones_like(vn), vn),
    )
    return scale * q[..., 1:4]


def so3_exp_matrix(theta):
    return quat_to_rot(so3_exp_quat(theta))


def quat_left(q):
    """Left-multiplication matrix: quat_mul(q, p) == quat_left(q) @ p."""
    w, v = q[..., 0, None, None], q[..., 1:4]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w, -v[..., None, :]], dim=-1)
    bottom = torch.cat([v[..., :, None], w * eye + skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_right(p):
    """Right-multiplication matrix: quat_mul(q, p) == quat_right(p) @ q."""
    w, v = p[..., 0, None, None], p[..., 1:4]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    top = torch.cat([w, -v[..., None, :]], dim=-1)
    bottom = torch.cat([v[..., :, None], w * eye - skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_from_two_vectors(a, b):
    """Shortest-arc quaternion rotating direction a onto b."""
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    c = cross(a, b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    w = 1.0 + d
    # antipodal: any axis orthogonal to a
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    ortho = torch.where(torch.abs(a[..., 0:1]) < 0.9, cross(a, ex), cross(a, ey))
    anti = w[..., 0] < 1e-8
    q = torch.cat([w, c], dim=-1)
    q_anti = torch.cat([torch.zeros_like(w), ortho], dim=-1)
    return quat_normalize(torch.where(anti[..., None], q_anti, q))


def rot_to_ypr(R):
    """Rotation matrix -> [yaw, pitch, roll] in DEGREES."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1) * (180.0 / math.pi)


def ypr_to_rot(ypr):
    """[yaw, pitch, roll] in DEGREES -> rotation matrix Rz@Ry@Rx."""
    d2r = math.pi / 180.0
    y, p, r = ypr[..., 0] * d2r, ypr[..., 1] * d2r, ypr[..., 2] * d2r
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
            torch.stack([-sp, cp * sr, cp * cr], -1),
        ],
        dim=-2,
    )


def gravity_to_rot(g):
    """R0 with R0 @ ĝ = ẑ and zero yaw (the reference's g2R)."""
    ng1 = g / torch.linalg.norm(g, dim=-1, keepdim=True)
    ng2 = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    R0 = quat_to_rot(quat_from_two_vectors(ng1, ng2))
    yaw = rot_to_ypr(R0)[..., 0]
    z = torch.zeros_like(yaw)
    return ypr_to_rot(torch.stack([-yaw, z, z], dim=-1)) @ R0


# SE(3) helpers: a pose is the tuple (q [..,4], p [..,3]) mapping body->world.


def pose_inverse(q, p):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, p)


def pose_compose(q1, p1, q2, p2):
    """(q1,p1) ∘ (q2,p2): apply 2 then 1."""
    return quat_mul(q1, q2), quat_rotate(q1, p2) + p1


def transform_point(q, p, x):
    return quat_rotate(q, x) + p
