"""IMU mid-point preintegration with 15x15 jacobian and covariance propagation.

Port of ``vplines_slam_tpu/models/imu.py``: the ``lax.scan`` over the
fixed-capacity, mask-padded sample buffer becomes a Python loop over the
same buffer (padded steps integrate over zero time and are exact no-ops).

State order (O_P,O_R,O_V,O_BA,O_BG) = (0,3,6,9,12); noise order
[na0, ng0, na1, ng1, nba, nbg] (18).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.geometry import (
    delta_quat,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_rot,
    skew,
)


class ImuParams(NamedTuple):
    acc_n: torch.Tensor  # accelerometer noise density
    gyr_n: torch.Tensor  # gyro noise density
    acc_w: torch.Tensor  # accelerometer random walk
    gyr_w: torch.Tensor  # gyro random walk
    g: torch.Tensor  # gravity in world, e.g. [0, 0, 9.81]


def default_params(dtype=torch.float64, device=torch.device("cuda")):
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return ImuParams(
        acc_n=t(0.08), gyr_n=t(0.004), acc_w=t(0.00004), gyr_w=t(2.0e-6),
        g=t([0.0, 0.0, 9.81007]),
    )


class Preintegration(NamedTuple):
    """Result of preintegrating one IMU interval (leading batch dims allowed)."""

    delta_p: torch.Tensor  # [3]
    delta_q: torch.Tensor  # [4] wxyz
    delta_v: torch.Tensor  # [3]
    jacobian: torch.Tensor  # [15,15]
    covariance: torch.Tensor  # [15,15]
    sum_dt: torch.Tensor  # []
    linearized_ba: torch.Tensor  # [3]
    linearized_bg: torch.Tensor  # [3]


def _blocks(rows, dtype, device):
    """Assemble a block matrix from a grid of 3x3 blocks (None = zero)."""
    z = torch.zeros(3, 3, dtype=dtype, device=device)
    return torch.cat(
        [torch.cat([z if b is None else b for b in row], dim=1) for row in rows],
        dim=0,
    )


def _noise_cov(params: ImuParams, dtype, device):
    eye = torch.eye(3, dtype=dtype, device=device)
    an2 = (params.acc_n * params.acc_n).to(dtype)
    gn2 = (params.gyr_n * params.gyr_n).to(dtype)
    aw2 = (params.acc_w * params.acc_w).to(dtype)
    gw2 = (params.gyr_w * params.gyr_w).to(dtype)
    return torch.block_diag(
        an2 * eye, gn2 * eye, an2 * eye, gn2 * eye, aw2 * eye, gw2 * eye
    )


def preintegrate(dts, accs, gyrs, mask, ba, bg, params: ImuParams) -> Preintegration:
    """Preintegrate a (padded) run of IMU samples.

    dts [N] per-step dt; accs/gyrs [N+1, 3] raw samples; mask [N] (padded
    steps are no-ops); ba, bg [3] bias linearization points.
    """
    dtype, device = accs.dtype, accs.device
    noise = _noise_cov(params, dtype, device)
    I3 = torch.eye(3, dtype=dtype, device=device)
    dts_m = dts * mask.to(dtype)

    dp = torch.zeros(3, dtype=dtype, device=device)
    dq = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    dv = torch.zeros(3, dtype=dtype, device=device)
    J = torch.eye(15, dtype=dtype, device=device)
    P = torch.zeros(15, 15, dtype=dtype, device=device)
    for i in range(dts.shape[0]):
        dt = dts_m[i]
        acc0, gyr0, acc1, gyr1 = accs[i], gyrs[i], accs[i + 1], gyrs[i + 1]
        un_acc_0 = quat_rotate(dq, acc0 - ba)
        un_gyr = 0.5 * (gyr0 + gyr1) - bg
        dq_new = quat_normalize(quat_mul(dq, delta_quat(un_gyr * dt)))
        un_acc_1 = quat_rotate(dq_new, acc1 - ba)
        un_acc = 0.5 * (un_acc_0 + un_acc_1)
        dp_new = dp + dv * dt + 0.5 * un_acc * dt * dt
        dv_new = dv + un_acc * dt

        # jacobian & covariance propagation (integration_base.h:76-166)
        R0 = quat_to_rot(dq)
        R1 = quat_to_rot(dq_new)
        Rw = skew(un_gyr)
        Ra0 = skew(acc0 - ba)
        Ra1 = skew(acc1 - ba)
        dt2 = dt * dt
        R1Ra1 = R1 @ Ra1
        IRw = I3 - Rw * dt
        F = _blocks([
            [I3, -0.25 * R0 @ Ra0 * dt2 - 0.25 * R1Ra1 @ IRw * dt2, I3 * dt,
             -0.25 * (R0 + R1) * dt2, 0.25 * R1Ra1 * dt2 * dt],
            [None, IRw, None, None, -I3 * dt],
            [None, -0.5 * R0 @ Ra0 * dt - 0.5 * R1Ra1 @ IRw * dt, I3,
             -0.5 * (R0 + R1) * dt, 0.5 * R1Ra1 * dt2],
            [None, None, None, I3, None],
            [None, None, None, None, I3],
        ], dtype, device)
        v03 = -0.125 * R1Ra1 * dt2 * dt
        v63 = -0.25 * R1Ra1 * dt2
        V = _blocks([
            [0.25 * R0 * dt2, v03, 0.25 * R1 * dt2, v03, None, None],
            [None, 0.5 * I3 * dt, None, 0.5 * I3 * dt, None, None],
            [0.5 * R0 * dt, v63, 0.5 * R1 * dt, v63, None, None],
            [None, None, None, None, I3 * dt, None],
            [None, None, None, None, None, I3 * dt],
        ], dtype, device)
        J = F @ J
        P = F @ P @ F.T + V @ noise @ V.T
        dp, dq, dv = dp_new, dq_new, dv_new
    return Preintegration(
        delta_p=dp, delta_q=dq, delta_v=dv, jacobian=J, covariance=P,
        sum_dt=torch.sum(dts_m), linearized_ba=ba, linearized_bg=bg,
    )


def evaluate(pre: Preintegration, params: ImuParams,
             Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj):
    """15-residual IMU factor (integration_base.h evaluate:200), batched over
    leading dims; bias deviations enter to first order through the stored
    jacobian blocks."""
    J = pre.jacobian
    dba = Bai - pre.linearized_ba
    dbg = Bgi - pre.linearized_bg
    mv = lambda M, x: (M @ x[..., None])[..., 0]

    corrected_q = quat_mul(pre.delta_q, delta_quat(mv(J[..., 3:6, 12:15], dbg)))
    corrected_v = pre.delta_v + mv(J[..., 6:9, 9:12], dba) + mv(J[..., 6:9, 12:15], dbg)
    corrected_p = pre.delta_p + mv(J[..., 0:3, 9:12], dba) + mv(J[..., 0:3, 12:15], dbg)

    g = params.g.to(Pi.dtype)
    dt = pre.sum_dt[..., None]
    qi_inv = quat_conj(Qi)
    r_p = quat_rotate(qi_inv, 0.5 * g * dt * dt + Pj - Pi - Vi * dt) - corrected_p
    r_q = 2.0 * quat_mul(quat_conj(corrected_q), quat_mul(qi_inv, Qj))[..., 1:4]
    r_v = quat_rotate(qi_inv, g * dt + Vj - Vi) - corrected_v
    return torch.cat([r_p, r_q, r_v, Baj - Bai, Bgj - Bgi], dim=-1)


def sqrt_information(pre: Preintegration):
    """S = chol(cov)⁻¹ (imu_factor.h:37-39 LLT whitening), computed in f64.

    The JAX reference whitens in f64 whenever the backend allows it (CPU with
    x64); CUDA has f64 Cholesky, so the port always whitens in f64 and never
    needs the reference's f32 whitening-range cap."""
    out_dtype = pre.covariance.dtype
    cov0 = pre.covariance.to(torch.float64)
    scale = torch.clamp(torch.diagonal(cov0, dim1=-2, dim2=-1), min=1e-30)
    cov = cov0 + torch.diag_embed(scale) * 1e-9
    L = torch.linalg.cholesky(cov)
    eye = torch.eye(15, dtype=torch.float64, device=cov.device).expand_as(L)
    S = torch.linalg.solve_triangular(L, eye, upper=False)
    return S.to(out_dtype)


def midpoint_propagate(p, q, v, ba, bg, acc0, gyr0, acc1, gyr1, dt, g):
    """World-frame IMU-rate forward propagation (estimator_node.cpp
    predict:68)."""
    un_acc_0 = quat_rotate(q, acc0 - ba) - g
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    q_new = quat_normalize(quat_mul(q, delta_quat(un_gyr * dt)))
    un_acc_1 = quat_rotate(q_new, acc1 - ba) - g
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    p_new = p + v * dt + 0.5 * un_acc * dt * dt
    v_new = v + un_acc * dt
    return p_new, q_new, v_new
