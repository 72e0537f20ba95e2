"""Synthetic visual-inertial world: analytic trajectory, exact IMU samples,
random landmarks.

Port of the parts of ``vplines_slam_tpu/utils/synthetic.py`` the smoke run
and the tests use.  IMU measurements come from ``torch.func`` derivatives of
the analytic trajectory (exact accelerations and body rates).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .geometry import quat_conj, quat_rotate, quat_to_rot, rot_to_quat, ypr_to_rot

GRAVITY = 9.81007  # euroc_config.yaml g_norm


class Trajectory(NamedTuple):
    """Analytic body->world trajectory: position and orientation vs a 0-dim
    time tensor [s]."""

    pos: Callable  # t -> [3]
    quat: Callable  # t -> [4] wxyz


def figure8_trajectory(radius=2.0, height_amp=0.4, omega=0.6283,
                       ypr_amp=(25.0, 8.0, 6.0)):
    """A smooth excited trajectory (figure-8 + oscillating attitude); the
    time tensor's dtype and device carry through."""

    def pos(t):
        s = torch.sin(omega * t)
        return torch.stack([radius * s, radius * s * torch.cos(omega * t),
                            height_amp * torch.sin(1.7 * omega * t)])

    def quat(t):
        ypr = torch.stack([
            ypr_amp[0] * torch.sin(0.9 * omega * t),
            ypr_amp[1] * torch.sin(1.3 * omega * t + 0.4),
            ypr_amp[2] * torch.sin(1.1 * omega * t + 1.1),
        ])
        return rot_to_quat(ypr_to_rot(ypr))

    return Trajectory(pos=pos, quat=quat)


def body_rates(traj: Trajectory, t):
    """Body angular velocity ω_b with [ω]× = Rᵀ R'."""
    R = quat_to_rot(traj.quat(t))
    dR = jacfwd(lambda s: quat_to_rot(traj.quat(s)))(t)
    W = R.T @ dR
    return torch.stack([W[2, 1], W[0, 2], W[1, 0]])


def world_velocity(traj: Trajectory, t):
    return jacfwd(traj.pos)(t)


def world_accel(traj: Trajectory, t):
    return jacfwd(jacfwd(traj.pos))(t)


def imu_samples(traj: Trajectory, times, g_norm=GRAVITY):
    """Noise-free IMU output at times [T]: specific force a_m = R_wbᵀ(a_w + G)
    and body rates.  Returns (accs [T,3], gyrs [T,3])."""
    G = torch.tensor([0.0, 0.0, g_norm], dtype=times.dtype, device=times.device)

    def one(t):
        q = traj.quat(t)
        return quat_rotate(quat_conj(q), world_accel(traj, t) + G), body_rates(traj, t)

    return vmap(one)(times)


def ground_truth_states(traj: Trajectory, times):
    """(p, q, v) at each time [T]."""
    return (vmap(traj.pos)(times), vmap(traj.quat)(times),
            vmap(lambda t: world_velocity(traj, t))(times))


def scatter_landmarks(n, seed=0, box=((-6.0, 6.0), (-6.0, 6.0), (-1.5, 3.5)),
                      dtype=torch.float64, device=torch.device("cuda")):
    """Random 3D points in a box (numpy generator: the same points as the
    reference for the same seed)."""
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in box])
    hi = np.array([b[1] for b in box])
    return torch.as_tensor(rng.uniform(lo, hi, size=(n, 3)), dtype=dtype, device=device)


def loop_trajectory(radius=3.0, omega=2.0 * np.pi / 30.0, height_amp=0.25,
                    wobble_deg=(6.0, 4.0), speed_mod=0.12, radius_mod=0.05):
    """A closed circular survey lap with tangent-following yaw, exactly
    periodic with period 2π/ω (every attitude and height frequency is an
    integer multiple of the lap's), so lap k revisits lap 0's poses exactly:
    the revisit geometry loop closure needs.  The camera (body x) looks
    inward; the 3ω speed and 2ω radius harmonics keep monocular scale
    observable (at constant angular rate the centripetal acceleration is a
    near-constant body vector that the accelerometer bias absorbs)."""

    def pos(t):
        ph = omega * t + speed_mod * torch.sin(3.0 * omega * t)
        r = radius * (1.0 + radius_mod * torch.sin(2.0 * omega * t + 0.7))
        return torch.stack([r * torch.cos(ph), r * torch.sin(ph),
                            height_amp * torch.sin(2.0 * omega * t)])

    def quat(t):
        yaw = (torch.rad2deg(omega * t + speed_mod * torch.sin(3.0 * omega * t))
               + 180.0 + 5.0 * torch.sin(3.0 * omega * t + 1.3))
        pitch = wobble_deg[0] * torch.sin(2.0 * omega * t + 0.4)
        roll = wobble_deg[1] * torch.sin(4.0 * omega * t + 1.1)
        return rot_to_quat(ypr_to_rot(torch.stack([yaw, pitch, roll])))

    return Trajectory(pos=pos, quat=quat)
