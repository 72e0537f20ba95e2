"""Online self-calibration wiring: extrinsic-rotation mode 2 and the time
offset.

Port of ``vplines_slam_tpu/estimator/online_calib.py``: the frame-pair
camera rotation (``pair_rotation``: K4's essential-matrix RANSAC on the
newest window pair, then the decomposition's cheirality vote), the
fixed-capacity accumulators (``ExtrinsicCalib`` of hand-eye rotation pairs,
``TimeOffsetCalib`` of the camera's and the IMU's unwrapped yaw curves) and
their padded solves.  Every function is out of place, works on the tensors'
device and reads nothing back to the host.

``pair_rotation`` takes RANSAC draws (``[64, 8]`` long in ``[0, P)``) in
place of a key, as the initializer does.  The time-offset curves are f64
whatever the engine's type: the reference keeps them in the engine's type,
where EuRoC-epoch stamps (1.4e9 s) round to 128 s steps at f32.  On CUDA
tensors ``push_imu_angles`` is kernel K22 and ``solve_time_offset`` kernel
K23, and the hand-eye solve of ``solve_extrinsic`` kernel K24
(``models/calibration``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..models import calibration as cal
from ..ops import mvg
from ..utils.geometry import quat_conj, quat_mul, quat_normalize, rot_to_quat

F64 = torch.float64


def pair_rotation(obs_i, obs_j, mask_i, mask_j, ids, sample_idx, min_corres=12):
    """Relative camera rotation between two window frames from their tracked
    correspondences (8-point essential + RANSAC + cheirality): obs [P, 3],
    masks [P], ids [P], sample_idx [n_hyp, 8].  Returns (q_rel, ok): the
    rotation of frame j expressed in frame i (R_{ci<-cj}, the IMU
    preintegration's delta_q convention)."""
    corr = mask_i & mask_j & (ids >= 0)
    x1, x2 = obs_i[:, 0:2], obs_j[:, 0:2]
    E, inliers, n_inl = mvg.ransac_essential(x1, x2, corr, sample_idx)
    R, _, votes = mvg.decompose_essential(E, x1, x2, inliers)
    q = rot_to_quat(R.T)
    ok = (n_inl >= min_corres) & (votes >= torch.div(n_inl, 2, rounding_mode="floor"))
    return q, ok


def _at(a, k):
    """a[k] for a device index k (a 0-dim long tensor), without a host sync."""
    return torch.index_select(a, 0, k.reshape(1))[0]


class ExtrinsicCalib(NamedTuple):
    """Fixed-capacity accumulator of hand-eye rotation pairs."""

    q_cam: torch.Tensor  # [K, 4]
    q_imu: torch.Tensor  # [K, 4]
    valid: torch.Tensor  # [K] bool
    count: torch.Tensor  # [] int64


def empty_extrinsic_calib(capacity=64, dtype=F64, device=torch.device("cuda")):
    q0 = torch.zeros(capacity, 4, dtype=dtype, device=device)
    q0[:, 0] = 1.0
    return ExtrinsicCalib(q_cam=q0, q_imu=q0.clone(),
                          valid=torch.zeros(capacity, dtype=torch.bool, device=device),
                          count=torch.zeros((), dtype=torch.int64, device=device))


def push_rotation_pair(acc: ExtrinsicCalib, q_cam, q_imu, ok) -> ExtrinsicCalib:
    """Append one (camera, IMU) relative-rotation pair where ok (a ring of
    K once full)."""
    K = acc.valid.shape[0]
    slot = (torch.arange(K, device=acc.count.device) == acc.count % K) & ok
    dt = acc.q_cam.dtype
    return ExtrinsicCalib(
        q_cam=torch.where(slot[:, None], q_cam.to(dt), acc.q_cam),
        q_imu=torch.where(slot[:, None], q_imu.to(dt), acc.q_imu),
        valid=acc.valid | slot, count=acc.count + ok.to(torch.int64))


def solve_extrinsic(acc: ExtrinsicCalib, min_pairs=12):
    """Hand-eye solve over the accumulated pairs: (q_ic, converged, σ₃),
    converged only with count >= min_pairs."""
    return cal.calibrate_extrinsic_rotation(acc.q_cam, acc.q_imu, acc.valid, count=acc.count,
                                            min_pairs=min_pairs)


class TimeOffsetCalib(NamedTuple):
    """Fixed-capacity (time, unwrapped signed yaw) curves of the camera
    (frame rate) and the IMU (sample rate), f64."""

    t_cam: torch.Tensor  # [C]
    ang_cam: torch.Tensor  # [C] unwrapped visual body yaw (rad)
    cam_valid: torch.Tensor  # [C] bool
    n_cam: torch.Tensor  # [] int64
    q_cam_cum: torch.Tensor  # [4] accumulated visual body rotation
    t_imu: torch.Tensor  # [M]
    ang_imu: torch.Tensor  # [M] unwrapped gyro-integrated yaw (rad)
    n_imu: torch.Tensor  # [] int64
    q_imu_cum: torch.Tensor  # [4] accumulated gyro rotation


def empty_td_calib(cam_capacity=128, imu_capacity=4096, device=torch.device("cuda")):
    z = lambda n: torch.zeros(n, dtype=F64, device=device)
    qid = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64, device=device)
    n0 = torch.zeros((), dtype=torch.int64, device=device)
    return TimeOffsetCalib(
        t_cam=z(cam_capacity), ang_cam=z(cam_capacity),
        cam_valid=torch.zeros(cam_capacity, dtype=torch.bool, device=device), n_cam=n0,
        q_cam_cum=qid, t_imu=z(imu_capacity), ang_imu=z(imu_capacity), n_imu=n0.clone(),
        q_imu_cum=qid.clone())


def push_cam_angle(acc: TimeOffsetCalib, t, dq_cam, q_ic, ok, dq_imu_fallback):
    """Append the camera curve sample at frame time t: the frame-pair camera
    rotation conjugated into the body frame (q_ic ⊗ dq ⊗ q_ic⁻¹), composed
    and unwrapped to a yaw curve.  Where the visual pair failed (not ok) the
    interval's preintegrated rotation dq_imu_fallback is composed instead
    and the sample is marked invalid.  Once full, the last slot is
    rewritten, as in the reference."""
    C = acc.t_cam.shape[0]
    k = torch.clamp(acc.n_cam, max=C - 1)
    q_ic, dq_cam, dq_fb = q_ic.to(F64), dq_cam.to(F64), dq_imu_fallback.to(F64)
    dq_b = quat_mul(quat_mul(q_ic, dq_cam), quat_conj(q_ic))
    dq_b = torch.where(ok, dq_b, dq_fb)
    q_new = quat_normalize(quat_mul(acc.q_cam_cum, dq_b))
    prev = torch.where(acc.n_cam > 0, _at(acc.ang_cam, torch.clamp(k - 1, min=0)),
                       torch.zeros((), dtype=F64, device=k.device))
    new_ang = prev + cal.wrap_angle(cal.yaw_of(q_new) - cal.yaw_of(acc.q_cam_cum))
    slot = torch.arange(C, device=k.device) == k
    t = torch.as_tensor(t, dtype=F64, device=k.device)
    return acc._replace(
        t_cam=torch.where(slot, t, acc.t_cam), ang_cam=torch.where(slot, new_ang, acc.ang_cam),
        cam_valid=torch.where(slot, ok, acc.cam_valid),
        n_cam=torch.clamp(acc.n_cam + 1, max=C), q_cam_cum=q_new)


def push_imu_angles_plain(acc: TimeOffsetCalib, ts, gyrs, mask):
    """K22's twin for ``push_imu_angles``."""
    kernels.TWIN_CALLS["gyro_yaw"] += 1
    M, I = acc.t_imu.shape[0], mask.shape[0]
    ts, gyrs = ts.to(F64), gyrs.to(F64)
    qs = cal.gyro_chain_plain(acc.q_imu_cum, torch.diff(ts) * mask.to(F64), gyrs)
    q_final = qs[-1] if I else acc.q_imu_cum
    n = acc.n_imu
    prev_ang = torch.where(n > 0, _at(acc.ang_imu, torch.clamp(n - 1, min=0)),
                           torch.zeros((), dtype=F64, device=n.device))
    all_yaws = torch.cat([cal.yaw_of(acc.q_imu_cum)[None], cal.yaw_of(qs)])
    cum = prev_ang + torch.cumsum(cal.wrap_angle(torch.diff(all_yaws)) * mask.to(F64), 0)
    pos = n + torch.arange(I, device=n.device)
    idx = torch.clamp(pos, max=M - 1)
    write = mask & (pos < M)
    t_val = torch.where(write, ts[1:], acc.t_imu[idx])
    a_val = torch.where(write, cum, acc.ang_imu[idx])
    # steps clamped onto slot M - 1 all write the last one's value: the last
    # write wins, as the reference's scatter resolves them on the CPU
    last = idx == M - 1
    t_val = torch.where(last, t_val[-1:], t_val) if I else t_val
    a_val = torch.where(last, a_val[-1:], a_val) if I else a_val
    return acc._replace(
        t_imu=acc.t_imu.index_put((idx,), t_val), ang_imu=acc.ang_imu.index_put((idx,), a_val),
        n_imu=torch.clamp(n + torch.sum(mask.to(torch.int64)), max=M), q_imu_cum=q_final)


def push_imu_angles(acc: TimeOffsetCalib, ts, gyrs, mask) -> TimeOffsetCalib:
    """Append a batch of IMU curve samples: gyro quaternion integration from
    the accumulated rotation (every step applied, masked ones at dt = 0),
    the yaw of each sample unwrapped against the running curve, written at
    n_imu on (clamped to the capacity).  ts [I + 1], gyrs [I + 1, 3], mask
    [I].

    CPU tensors: ``push_imu_angles_plain``.  CUDA tensors: K22, one launch."""
    if not acc.t_imu.is_cuda:
        return push_imu_angles_plain(acc, ts, gyrs, mask)
    q, _, (t_imu, ang_imu, n_imu) = cal.gyro_yaw_cuda(
        ts.to(F64), gyrs.to(F64), acc.q_imu_cum, mask=mask,
        ring=(acc.t_imu, acc.ang_imu, acc.n_imu))
    return acc._replace(t_imu=t_imu, ang_imu=ang_imu, n_imu=n_imu, q_imu_cum=q)


def _padded_imu_curve(acc: TimeOffsetCalib):
    """The IMU curve past n_imu pushed out of reach (1e9 + m) and continued
    flat at its last angle."""
    m = torch.arange(acc.t_imu.shape[0], device=acc.t_imu.device)
    filled = m < acc.n_imu
    t_imu = torch.where(filled, acc.t_imu, 1e9 + m.to(F64))
    ang_last = _at(acc.ang_imu, torch.clamp(acc.n_imu - 1, min=0))
    return t_imu, torch.where(filled, acc.ang_imu, ang_last)


def solve_time_offset_plain(acc: TimeOffsetCalib, td_init=0.0, min_cam=30):
    """K23's twin for ``solve_time_offset``."""
    cam_ok = acc.cam_valid & (torch.arange(acc.t_cam.shape[0], device=acc.n_cam.device)
                              < acc.n_cam)
    t_imu, ang_imu = _padded_imu_curve(acc)
    td, _, rms = cal.calibrate_time_offset_plain(acc.t_cam, acc.ang_cam, cam_ok, t_imu,
                                                 ang_imu, td_init=td_init)
    return td, rms, (acc.n_cam >= min_cam) & torch.isfinite(td)


def solve_time_offset(acc: TimeOffsetCalib, td_init=0.0, min_cam=30):
    """ICP the camera curve onto the IMU curve for the time shift, over the
    filled camera samples, the IMU curve past n_imu padded out of reach.
    Returns (td, rms, ok): ok = n_cam >= min_cam and td finite.

    CPU tensors: ``solve_time_offset_plain``.  CUDA tensors: K23, one launch
    with the padding and the gate."""
    if not acc.t_cam.is_cuda:
        return solve_time_offset_plain(acc, td_init, min_cam)
    out, ok = cal.time_offset_cuda(acc.t_cam, acc.ang_cam, acc.cam_valid, acc.t_imu,
                                   acc.ang_imu, td_init=td_init, n_cam=acc.n_cam,
                                   n_imu=acc.n_imu, min_cam=min_cam)
    return out[0], out[2], ok
