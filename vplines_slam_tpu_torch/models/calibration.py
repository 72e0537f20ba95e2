"""Online self-calibration: camera-IMU extrinsic rotation and time offset.

Port of ``vplines_slam_tpu/models/calibration.py``:
``calibrate_extrinsic_rotation`` (hand-eye q_cam ⊗ q_ic = q_ic ⊗ q_imu as a
robust-weighted stacked quaternion least squares, with the σ₃ > 0.25 gate),
``integrate_gyro_yaw`` (the gyro-integrated yaw curve) and
``calibrate_time_offset`` (point-to-line ICP of the camera's (time, yaw)
curve onto the IMU's: 10 Gauss-Newton iterations over the shift td and a
yaw offset c).

On CUDA tensors each is a hand-written kernel of ``csrc/calib.cu``:
K24 ``hand_eye`` (the 4×4 eigenproblem of AᵀA in f64 in place of the SVD
of A), K22 ``gyro_yaw`` (the quaternion chain and its yaws; also the curve
write of ``estimator/online_calib.push_imu_angles``) and K23
``time_offset`` (every iteration and the RMS in one launch; with the
accumulator's counts, ``solve_time_offset``'s padding and gate too).  On
CPU tensors, the plain twins here, each counted in ``kernels.TWIN_CALLS``
("hand_eye", "gyro_yaw", "time_offset").  K22 and K23 work in f64.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels
from ..utils.geometry import (delta_quat, quat_left, quat_mul, quat_normalize, quat_right,
                              quat_to_rot, rot_to_ypr)

_SRC = "vplines_slam_tpu_torch/csrc/calib.cu"
GYRO_YAW = kernels.Kernel("vp_gyro_yaw", _SRC,
                          "vplines_slam_tpu/estimator/online_calib.py:163", [kernels.P])
TIME_OFFSET = kernels.Kernel("vp_time_offset", _SRC,
                             "vplines_slam_tpu/models/calibration.py:81", [kernels.P])
HAND_EYE = kernels.Kernel("vp_hand_eye", _SRC, "vplines_slam_tpu/models/calibration.py:24",
                          [kernels.P])
TD_MAX_IMU = 12_000  # K23 holds both IMU curves in shared memory (16 bytes a sample)

_GYRO_ARGS = kernels.args_struct(
    "GyroYawArgs", ["ts", "gyrs", "mask", "q_in", "q_out", "yaws", "t_ring", "a_ring", "n_in",
                    "t_out", "a_out", "n_out"], ["I", "M"])
_TD_ARGS = kernels.args_struct(
    "TimeOffsetArgs", ["t_cam", "a_cam", "cam_valid", "n_cam", "t_imu", "a_imu", "n_imu", "out",
                       "ok"], ["C", "M", "iters", "min_cam"], ["td_init"])
_EYE_ARGS = kernels.args_struct(
    "HandEyeArgs", ["q_cam", "q_imu", "valid", "count", "q_out", "converged", "sigma"],
    ["K", "min_pairs", "is_double"])

F64 = torch.float64


def yaw_of(q):
    """Yaw (rad) of unit quaternions [..., 4]: deg2rad(rot_to_ypr(R)[0])."""
    return torch.deg2rad(rot_to_ypr(quat_to_rot(q))[..., 0])


def wrap_angle(a):
    """(a + π) mod 2π − π, the floor-mod."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


# ---------------------------------------------------------------------------
# K24: hand-eye extrinsic rotation
# ---------------------------------------------------------------------------


def calibrate_extrinsic_rotation_plain(q_cam_rel, q_imu_rel, valid, count=None, min_pairs=0):
    """K24's twin, the reference's solve: A [4K, 4] of the weighted blocks
    (L(q_imu) - R(q_cam)) w, its SVD in the input type, the smallest right
    singular vector with q0 >= 0, converged = σ₃ > 0.25 (and count >=
    min_pairs where count is given)."""
    kernels.TWIN_CALLS["hand_eye"] += 1
    dtype = q_cam_rel.dtype
    thr = torch.deg2rad(torch.tensor(5.0, dtype=F64)).to(dtype)

    def angle(q):
        return 2.0 * torch.arccos(torch.clamp(torch.abs(q[:, 0]), 0.0, 1.0))

    d = torch.abs(angle(q_cam_rel) - angle(q_imu_rel))
    w = torch.where(d < thr, torch.ones_like(d), thr / torch.clamp(d, min=1e-9))
    w = w * valid.to(dtype)
    A = ((quat_left(q_imu_rel) - quat_right(q_cam_rel)) * w[:, None, None]).reshape(-1, 4)
    _, s, Vt = torch.linalg.svd(A, full_matrices=False)
    q = Vt[-1]
    q = q * torch.where(q[0] < 0, -1.0, 1.0).to(dtype)
    converged = s[2] > 0.25
    if count is not None:
        converged = converged & (count >= min_pairs)
    return q / torch.linalg.norm(q), converged, s[2]


def calibrate_extrinsic_rotation(q_cam_rel, q_imu_rel, valid, count=None, min_pairs=0):
    """Hand-eye rotation from K frame-pair rotations: q_cam_rel, q_imu_rel
    [K, 4] (camera and body relative rotations), valid [K].  Returns (q_ic
    [4], converged, σ₃).  count / min_pairs add the accumulator's gate.

    CPU tensors: ``calibrate_extrinsic_rotation_plain``.  CUDA tensors: K24,
    one launch and no host sync, f64 inside whatever the input type (f32 or
    f64), q and σ₃ in the input type."""
    if not q_cam_rel.is_cuda:
        return calibrate_extrinsic_rotation_plain(q_cam_rel, q_imu_rel, valid, count,
                                                  min_pairs)
    K, dt, dev = q_cam_rel.shape[0], q_cam_rel.dtype, q_cam_rel.device
    if dt not in (torch.float32, F64):
        raise ValueError(f"K24 takes float32 or float64 quaternions, got {dt}")
    # the inputs stay referenced here until the launch is enqueued
    q_cam_rel, q_imu_rel = q_cam_rel.contiguous(), q_imu_rel.contiguous()
    v8 = kernels.as_u8(valid)
    q = torch.empty(4, dtype=dt, device=dev)
    conv = torch.empty((), dtype=torch.bool, device=dev)
    sigma = torch.empty((), dtype=dt, device=dev)
    args = _EYE_ARGS(
        kernels.check(q_cam_rel, "q_cam_rel", dt, shape=(K, 4)),
        kernels.check(q_imu_rel, "q_imu_rel", dt, shape=(K, 4)),
        kernels.check(v8, "valid", torch.uint8, shape=(K,)),
        None if count is None else kernels.check(count.reshape(1), "count", torch.int64),
        q.data_ptr(), conv.data_ptr(), sigma.data_ptr(), K, int(min_pairs), int(dt == F64))
    HAND_EYE(ctypes.byref(args))
    return q, conv, sigma


# ---------------------------------------------------------------------------
# K22: the gyro yaw curve
# ---------------------------------------------------------------------------


def gyro_chain_plain(q, dts, gyrs):
    """q after each of the I steps q <- normalize(q ⊗ δq(½(w₀+w₁)dt)), every
    step applied (dts [I], already masked; gyrs [I + 1, 3]).  [I, 4]."""
    qs = []
    for i in range(dts.shape[0]):
        q = quat_normalize(quat_mul(q, delta_quat(0.5 * (gyrs[i] + gyrs[i + 1]) * dts[i])))
        qs.append(q)
    return torch.stack(qs) if qs else q.new_zeros(0, 4)


def gyro_yaw_cuda(ts, gyrs, q, mask=None, ring=None):
    """K22 on CUDA tensors, f64: ts [I + 1], gyrs [I + 1, 3], q [4], mask
    [I] (None: every step live); ring = (t_imu [M], ang_imu [M], n_imu [])
    of a curve to extend, or None.  Returns (q after the last step, yaws
    [I + 1] (q's, then each step's), the new (t_imu, ang_imu, n_imu) or
    None)."""
    I, dev = ts.shape[0] - 1, ts.device
    # the inputs stay referenced here until the launch is enqueued
    ts, gyrs, q = ts.contiguous(), gyrs.contiguous(), q.contiguous()
    m8 = None if mask is None else kernels.as_u8(mask)
    q_out = torch.empty(4, dtype=F64, device=dev)
    yaws = torch.empty(I + 1, dtype=F64, device=dev)
    ptrs = [kernels.check(ts, "ts", F64, shape=(I + 1,)),
            kernels.check(gyrs, "gyrs", F64, shape=(I + 1, 3)),
            None if m8 is None else kernels.check(m8, "mask", torch.uint8, shape=(I,)),
            kernels.check(q, "q", F64, shape=(4,)), q_out.data_ptr(), yaws.data_ptr()]
    M, out = 0, None
    if ring is not None:
        t_imu, ang_imu, n_imu = ring
        M = t_imu.shape[0]
        out = (torch.empty_like(t_imu), torch.empty_like(ang_imu),
               torch.empty((), dtype=torch.int64, device=dev))
        ptrs += [kernels.check(t_imu, "t_imu", F64, shape=(M,)),
                 kernels.check(ang_imu, "ang_imu", F64, shape=(M,)),
                 kernels.check(n_imu.reshape(1), "n_imu", torch.int64),
                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr()]
    else:
        ptrs += [None] * 6
    GYRO_YAW(ctypes.byref(_GYRO_ARGS(*ptrs, I, M)))
    return q_out, yaws, out


def integrate_gyro_yaw_plain(ts, gyrs, q0=None):
    """K22's twin for ``integrate_gyro_yaw``, in the input type."""
    kernels.TWIN_CALLS["gyro_yaw"] += 1
    q_init = (torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=gyrs.dtype, device=gyrs.device)
              if q0 is None else q0)
    qs = gyro_chain_plain(q_init, torch.diff(ts), gyrs)
    return yaw_of(torch.cat([q_init[None], qs]))


def integrate_gyro_yaw(ts, gyrs, q0=None):
    """Integrated body yaw curve (rad) [N] from raw gyro: ts [N], gyrs
    [N, 3], from q0 (identity by default).

    CPU tensors: ``integrate_gyro_yaw_plain``.  CUDA tensors: K22 in f64,
    the yaws returned in gyrs' type."""
    if not gyrs.is_cuda:
        return integrate_gyro_yaw_plain(ts, gyrs, q0)
    q_init = (torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64, device=gyrs.device)
              if q0 is None else q0.to(F64))
    _, yaws, _ = gyro_yaw_cuda(ts.to(F64), gyrs.to(F64), q_init)
    return yaws.to(gyrs.dtype)


# ---------------------------------------------------------------------------
# K23: the time-offset ICP
# ---------------------------------------------------------------------------


def _residuals_and_jacobian(td, c, t_cam, yaw_cam, v, t_imu, yaw_imu):
    """Per camera sample: the perpendicular distance of (t + td, y + c) to
    the forward segment of its first-nearest IMU sample, times v, and its
    derivatives in (td, c) as jacfwd gives them (NaN at a zero distance)."""
    M = t_imu.shape[0]
    tq = t_cam + td
    k = torch.clamp(torch.argmin(torch.abs(t_imu[None, :] - tq[:, None]), dim=1), 0, M - 2)
    p0t, p0a = t_imu[k], yaw_imu[k]
    u0, u1 = t_imu[k + 1] - p0t, yaw_imu[k + 1] - p0a
    nu = torch.clamp(torch.sqrt(u0 * u0 + u1 * u1), min=1e-9)
    u0, u1 = u0 / nu, u1 / nu
    dp0, dp1 = tq - p0t, (yaw_cam + c) - p0a
    dot = dp0 * u0 + dp1 * u1
    e0, e1 = dp0 - dot * u0, dp1 - dot * u1
    nr = torch.sqrt(e0 * e0 + e1 * e1)
    j0 = (e0 * (1.0 - u0 * u0) + e1 * (0.0 - u0 * u1)) / nr * v
    j1 = (e0 * (0.0 - u1 * u0) + e1 * (1.0 - u1 * u1)) / nr * v
    return nr * v, j0, j1


def calibrate_time_offset_plain(t_cam, yaw_cam, cam_valid, t_imu, yaw_imu, iters=10,
                                td_init=0.0):
    """K23's twin: ``iters`` Gauss-Newton steps on (td, c) with H = JᵀJ +
    1e-9 I solved by Cramer's rule, then the RMS over all C samples.
    Returns (td, c, rms)."""
    kernels.TWIN_CALLS["time_offset"] += 1
    v = cam_valid.to(t_cam.dtype)
    td = torch.tensor(td_init, dtype=t_cam.dtype, device=t_cam.device)
    c = torch.zeros_like(td)
    for _ in range(iters):
        r, j0, j1 = _residuals_and_jacobian(td, c, t_cam, yaw_cam, v, t_imu, yaw_imu)
        h00 = torch.sum(j0 * j0) + 1e-9
        h01 = torch.sum(j0 * j1)
        h11 = torch.sum(j1 * j1) + 1e-9
        g0, g1 = torch.sum(j0 * r), torch.sum(j1 * r)
        det = h00 * h11 - h01 * h01
        td, c = td - (h11 * g0 - h01 * g1) / det, c - (h00 * g1 - h01 * g0) / det
    r = _residuals_and_jacobian(td, c, t_cam, yaw_cam, v, t_imu, yaw_imu)[0]
    return td, c, torch.sqrt(torch.mean(r * r))


def time_offset_cuda(t_cam, yaw_cam, cam_valid, t_imu, yaw_imu, iters=10, td_init=0.0,
                     n_cam=None, n_imu=None, min_cam=0):
    """K23 on CUDA f64 tensors.  With n_cam / n_imu (device counts) the
    camera mask stops at n_cam and the IMU curve past n_imu is padded as
    ``solve_time_offset`` does.  Returns ([td, c, rms], ok)."""
    C, M, dev = t_cam.shape[0], t_imu.shape[0], t_cam.device
    if M > TD_MAX_IMU:
        raise ValueError(f"K23 takes at most {TD_MAX_IMU} IMU samples, got {M}")
    # the inputs stay referenced here until the launch is enqueued
    t_cam, yaw_cam, t_imu, yaw_imu = (x.contiguous() for x in (t_cam, yaw_cam, t_imu, yaw_imu))
    v8 = kernels.as_u8(cam_valid)
    out = torch.empty(3, dtype=F64, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    cnt = lambda n, name: None if n is None else kernels.check(n.reshape(1), name, torch.int64)
    args = _TD_ARGS(
        kernels.check(t_cam, "t_cam", F64, shape=(C,)),
        kernels.check(yaw_cam, "yaw_cam", F64, shape=(C,)),
        kernels.check(v8, "cam_valid", torch.uint8, shape=(C,)), cnt(n_cam, "n_cam"),
        kernels.check(t_imu, "t_imu", F64, shape=(M,)),
        kernels.check(yaw_imu, "yaw_imu", F64, shape=(M,)), cnt(n_imu, "n_imu"),
        out.data_ptr(), ok.data_ptr(), C, M, int(iters), int(min_cam), float(td_init))
    TIME_OFFSET(ctypes.byref(args))
    return out, ok


def calibrate_time_offset(t_cam, yaw_cam, cam_valid, t_imu, yaw_imu, iters=10, td_init=0.0):
    """The camera-IMU time shift by point-to-line ICP between the two (time,
    yaw) curves: t_cam / yaw_cam / cam_valid [C], t_imu / yaw_imu [M].  The
    camera curve at t_cam + td must lie on the IMU curve; a constant yaw
    offset c is estimated with it.  Returns (td, rms).

    CPU tensors: ``calibrate_time_offset_plain``.  CUDA tensors: K23, f64
    only, one launch."""
    if not t_cam.is_cuda:
        td, _, rms = calibrate_time_offset_plain(t_cam, yaw_cam, cam_valid, t_imu, yaw_imu,
                                                 iters, td_init)
        return td, rms
    out, _ = time_offset_cuda(t_cam, yaw_cam, cam_valid, t_imu, yaw_imu, iters, td_init)
    return out[0], out[2]
