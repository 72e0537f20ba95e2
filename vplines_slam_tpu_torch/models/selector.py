"""Attention feature selector: anticipated-information greedy selection.

Port of ``vplines_slam_tpu/models/selector.py`` (``HORIZON``, ``STATE_SIZE``,
``DIM``, ``SelectorConfig``, ``propagate_horizon``, ``_slerp``,
``_linear_imu_block``, ``imu_prior_information``, ``feature_information``,
``nn_depth_guess``, ``select_features``): the future states k..k+H are
propagated from the mean IMU sample, the linear IMU model over them gives a
[45, 45] prior information, each candidate feature adds the information its
bearings over the horizon would give (the landmark marginalized in closed
form), and a greedy pass picks the subset of the largest log-determinant.

The whole selector runs in f64 whatever the engine dtype: the gain of a
round is the difference of two 45x45 log-determinants of about 1e2 whose
prior spans eigenvalues 0.15 to 1.1e7, below f32's resolution (at f32 the
gains come out as noise and the pass picks one feature where f64 picks 30).
``select_features(..., obs_frame=k)``, given the ``obs_frame`` that
``feature_information`` was called with, takes them in the Schur form of the
support the candidates' information lives on (``position_support``): the
same gains in exact arithmetic from 12x12 determinants.

``feature_information`` and ``select_features`` are kernel K20
(``csrc/selector.cu``: ``selector_info`` and ``selector_greedy``) on CUDA
tensors and their plain twins on CPU tensors.  The horizon, the prior and
the depth guess run once per frame and stay plain.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from ..utils.geometry import quat_conj, quat_mul, quat_to_rot, skew
from .imu import midpoint_propagate

HORIZON = 4  # future frames
STATE_SIZE = 9  # [p(3), v(3), b_a(3)]
DIM = (HORIZON + 1) * STATE_SIZE  # 45: states k..k+H

SELECTOR_INFO = kernels.Kernel(
    "vp_selector_info", "vplines_slam_tpu_torch/csrc/selector.cu",
    "vplines_slam_tpu/models/selector.py:135",
    [kernels.P] * 7 + [kernels.I, kernels.I, kernels.I, ctypes.c_double, kernels.P],
)
SELECTOR_GREEDY = kernels.Kernel(
    "vp_selector_greedy", "vplines_slam_tpu_torch/csrc/selector.cu",
    "vplines_slam_tpu/models/selector.py:210", [kernels.P],
)
MAX_DIM = 64  # selector_greedy's largest information (csrc/selector.cu)


class SelectorConfig(NamedTuple):
    max_features: int = 60  # kappa: budget of tracked features passed on
    init_threshold: int = 30  # pass-through when fewer candidates than this
    acc_var: float = 0.01  # accel noise variance (discrete)
    acc_bias_var: float = 1e-4
    n_imu_per_frame: int = 20  # IMU samples per horizon step
    pix_sigma: float = 1.0 / 460.0


def propagate_horizon(p0, q0, v0, ba, bg, acc_mean, gyr_mean, dt, g, horizon=HORIZON):
    """Constant-IMU forward propagation of the mean state over the horizon:
    returns (p [h+1, 3], q [h+1, 4], v [h+1, 3])."""
    ps, qs, vs = [p0], [q0], [v0]
    p, q, v = p0, q0, v0
    for _ in range(horizon):
        p, q, v = midpoint_propagate(p, q, v, ba, bg, acc_mean, gyr_mean, acc_mean, gyr_mean,
                                     dt, g)
        ps.append(p)
        qs.append(q)
        vs.append(v)
    return torch.stack(ps), torch.stack(qs), torch.stack(vs)


def _slerp(q0, q1, t, one_minus_t):
    """Quaternion slerp (shortest arc), branchless for small angles, over
    broadcast leading dims; t and 1 - t [..., 1] come in rounded as the
    reference rounds them (f32)."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(torch.clamp(d, -1.0, 1.0))
    th = torch.arccos(d)
    sth = torch.sin(th)
    use_lerp = sth < 1e-6
    den = torch.where(use_lerp, torch.ones_like(sth), sth)
    w0 = torch.where(use_lerp, one_minus_t, torch.sin(one_minus_t * th) / den)
    w1 = torch.where(use_lerp, t, torch.sin(t * th) / den)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _linear_imu_block(q_i, q_j, n_imu, dt_imu, acc_var, acc_bias_var):
    """(Omega [H, 9, 9], A [H, 9, 9]) of the horizon steps q_i -> q_j [H, 4]
    from the linear IMU model: the n_imu slerped attitudes of every step in
    one batch, summed into the Nij / Mij coupling of position and velocity
    to the accel bias, and the IMU noise covariance."""
    dt, dev = q_i.dtype, q_i.device
    # the reference's step index is f32, and so are t = i / n and 1 - t
    i32 = torch.arange(n_imu, dtype=torch.float32, device=dev)
    t32 = i32 / n_imu
    t, omt = t32.to(dt)[:, None], (1.0 - t32).to(dt)[:, None]
    R = quat_to_rot(_slerp(q_i[:, None], q_j[:, None], t, omt))  # [H, n, 3, 3]
    jkh = (n_imu - i32 - 0.5).to(dt)
    Nij = torch.sum(jkh[:, None, None] * R, dim=1)
    Mij = torch.sum(R, dim=1)
    c11 = sum((n_imu - i - 0.5) ** 2 for i in range(n_imu))  # host sums, exact
    c12 = sum(n_imu - i - 0.5 for i in range(n_imu))
    d2, d3, d4 = dt_imu ** 2, dt_imu ** 3, dt_imu ** 4
    I3 = torch.eye(3, dtype=dt, device=dev)
    H = q_i.shape[0]
    cov = torch.zeros(9, 9, dtype=dt, device=dev)
    cov[0:3, 0:3] = I3 * n_imu * c11 * d4 * acc_var
    cov[0:3, 3:6] = I3 * c12 * d3 * acc_var
    cov[3:6, 0:3] = I3 * c12 * d3 * acc_var
    cov[3:6, 3:6] = I3 * n_imu * d2 * acc_var
    cov[6:9, 6:9] = I3 * n_imu * acc_bias_var
    # inv_ex: no error check, so no host sync on the card
    Omega = torch.linalg.inv_ex(cov + 1e-12 * torch.eye(9, dtype=dt, device=dev))[0]
    A = -torch.eye(9, dtype=dt, device=dev).repeat(H, 1, 1)
    A[:, 0:3, 3:6] = -I3 * n_imu * dt_imu
    A[:, 0:3, 6:9] = Nij * d2
    A[:, 3:6, 6:9] = Mij * dt_imu
    return Omega.expand(H, 9, 9), A


def imu_prior_information(qs, dt, acc_var, acc_bias_var=1e-4, n_imu=20, horizon=HORIZON):
    """[45, 45] information of the linear IMU model over states k..k+H:
    consecutive-state blocks [A^T Om A, A^T Om; Om A, Om] accumulated along
    the horizon, rotations slerped between the propagated attitudes qs, and
    an identity prior on state k."""
    dt_imu = dt / n_imu
    n = (horizon + 1) * STATE_SIZE
    Om, A = _linear_imu_block(qs[:horizon], qs[1:horizon + 1], n_imu, dt_imu, acc_var,
                              acc_bias_var)
    AtO = A.transpose(-1, -2) @ Om
    AtOA = AtO @ A
    O = torch.zeros(n, n, dtype=qs.dtype, device=qs.device)
    for h in range(1, horizon + 1):
        i, j = (h - 1) * STATE_SIZE, h * STATE_SIZE
        O[i:i + 9, i:i + 9] += AtOA[h - 1]
        O[i:i + 9, j:j + 9] += AtO[h - 1]
        O[j:j + 9, i:i + 9] += AtO[h - 1].T
        O[j:j + 9, j:j + 9] += Om[h - 1]
    O[0:9, 0:9] += torch.eye(9, dtype=qs.dtype, device=qs.device)
    return O


def _cross(a, b):
    """a x b, each product and difference a tensor op of its own (K20
    rounds them the same way; torch.linalg.cross may fuse them)."""
    a0, a1, a2 = a[..., 0:1], a[..., 1:2], a[..., 2:3]
    b0, b1, b2 = b[..., 0:1], b[..., 1:2], b[..., 2:3]
    return torch.cat([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _qrot(q, v):
    """utils/geometry.quat_rotate with ``_cross``."""
    uv = _cross(q[..., 1:4], v)
    return v + 2.0 * (q[..., 0:1] * uv + _cross(q[..., 1:4], uv))


def _mm3(A, B):
    """A @ B of [..., 3, 3] matrices, each entry summed ((0 + 1) + 2) in
    order (K20 rounds the same sums the same way)."""
    return (A[..., :, 0:1] * B[..., 0:1, :] + A[..., :, 1:2] * B[..., 1:2, :]
            + A[..., :, 2:3] * B[..., 2:3, :])


def _inv3(M):
    """Inverse of [..., 3, 3] matrices by the adjugate over the determinant
    expanded along the first row."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00, c01, c02 = e * i - f * h, c * h - b * i, b * f - c * e
    c10, c11, c12 = f * g - d * i, a * i - c * g, c * d - a * f
    c20, c21, c22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * c00 + b * c10 + c * c20
    adj = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj / det[..., None, None]


def feature_information_plain(rays, depths, track_valid, ps, qs, q_ic, p_ic, img_fov=0.75,
                              obs_frame=1):
    """K20 ``selector_info``'s twin: the Delta-information [N, 45, 45] of
    each candidate over the horizon.  Per visible horizon state i the
    bearing factor C_i = B_i^T B_i with B_i = [u]x R_cw, then the landmark's
    3 dof marginalized in closed form, W = (sum C + 1e-9 I)^-1:
    Delta(i, i) = C_i - C_i W C_i^T and Delta(i, j) = -C_i W C_j^T on the
    position blocks of the states; zero when fewer than 2 states see it.
    rays [N, 3] bearings in the new image, whose pose is horizon state
    ``obs_frame``; depths [N] depth guesses; track_valid [N]."""
    kernels.TWIN_CALLS["selector_info"] += 1
    N, nh, o = rays.shape[0], ps.shape[0], obs_frame
    dt, dev = rays.dtype, rays.device
    X_w = _qrot(qs[o], _qrot(q_ic, rays * depths[:, None]) + p_ic) + ps[o]
    # camera poses of the states: (q_cw, p_cw) = inverse(q (x) q_ic, p + R p_ic)
    q_wc = quat_mul(qs, q_ic.expand_as(qs))
    p_wc = _qrot(qs, p_ic.expand_as(ps)) + ps
    q_cw = quat_conj(q_wc)
    p_cw = -_qrot(q_cw, p_wc)
    Xc = _qrot(q_cw[None], X_w[:, None, :]) + p_cw[None]  # [N, nh, 3]
    z = Xc[..., 2]
    k = torch.arange(nh, device=dev)
    visible = ((k >= o) & (z > 0.2) & (torch.abs(Xc[..., 0] / z) < img_fov)
               & (torch.abs(Xc[..., 1] / z) < img_fov))
    nrm = torch.sqrt(Xc[..., 0:1] * Xc[..., 0:1] + Xc[..., 1:2] * Xc[..., 1:2]
                     + Xc[..., 2:3] * Xc[..., 2:3])
    u = Xc / torch.clamp(nrm, min=1e-9)
    B = _mm3(skew(u), quat_to_rot(q_cw)[None])
    w = (visible & track_valid[:, None]).to(dt)
    C = _mm3(B.transpose(-1, -2), B) * w[..., None, None]  # [N, nh, 3, 3]
    n_vis = torch.sum(visible.to(torch.int64), dim=1)
    EtE = C[:, 0]
    for i in range(1, nh):
        EtE = EtE + C[:, i]
    W = _inv3(EtE + 1e-9 * torch.eye(3, dtype=dt, device=dev))
    CW = _mm3(C, W[:, None])  # [N, nh, 3, 3]
    D = _mm3(CW[:, :, None], C[:, None].transpose(-1, -2))  # [N, nh, nh, 3, 3]: C_i W C_j^T
    blk = torch.diag_embed(C.permute(0, 2, 3, 1)).permute(0, 3, 4, 1, 2) - D
    O = torch.zeros(N, nh, STATE_SIZE, nh, STATE_SIZE, dtype=dt, device=dev)
    O[:, :, 0:3, :, 0:3] = blk.permute(0, 1, 3, 2, 4)
    O = O.reshape(N, nh * STATE_SIZE, nh * STATE_SIZE)
    return torch.where((n_vis >= 2)[:, None, None], O, torch.zeros_like(O))


def feature_information(rays, depths, track_valid, ps, qs, q_ic, p_ic, pix_sigma=None,
                        img_fov=0.75, obs_frame=1):
    """K20 ``selector_info``.  CPU tensors: ``feature_information_plain``.
    CUDA tensors: one block per candidate, f64 (every input must be f64).
    pix_sigma is accepted as the reference accepts it, and unused: the
    bearing factors are unwhitened."""
    if not rays.is_cuda:
        return feature_information_plain(rays, depths, track_valid, ps, qs, q_ic, p_ic,
                                         img_fov, obs_frame)
    N, nh = rays.shape[0], ps.shape[0]
    f64 = torch.float64
    rays, depths, ps, qs = (x.contiguous() for x in (rays, depths, ps, qs))
    q_ic, p_ic = q_ic.contiguous(), p_ic.contiguous()
    valid = track_valid.to(torch.uint8).contiguous()
    n = nh * STATE_SIZE
    out = torch.empty(N, n, n, dtype=f64, device=rays.device)
    if N == 0:
        return out
    SELECTOR_INFO(kernels.check(rays, "rays", f64, shape=(N, 3)),
                  kernels.check(depths, "depths", f64, shape=(N,)),
                  kernels.check(valid, "track_valid", torch.uint8, shape=(N,)),
                  kernels.check(ps, "ps", f64, shape=(nh, 3)),
                  kernels.check(qs, "qs", f64, shape=(nh, 4)),
                  kernels.check(q_ic, "q_ic", f64, shape=(4,)),
                  kernels.check(p_ic, "p_ic", f64, shape=(3,)), N, nh, int(obs_frame),
                  float(img_fov), kernels.check(out, "omega_f", f64))
    return out


def nn_depth_guess(rays, known_rays, known_depths, known_valid, default=5.0):
    """Depth guess per candidate from the angularly nearest known landmark
    (the batched argmax of cosines; > 0.9 or the default)."""
    cos = rays @ known_rays.T  # [N, M]
    cos = torch.where(known_valid[None, :], cos, torch.full_like(cos, -2.0))
    best = torch.argmax(cos, dim=1)
    has = torch.any(known_valid)
    d = torch.where(torch.amax(cos, dim=1) > 0.9, known_depths[best],
                    torch.full_like(known_depths[best], default))
    return torch.where(has, d, torch.full_like(d, default))


def position_support(obs_frame=1, horizon=HORIZON):
    """The rows and columns of the position blocks of the states a candidate
    can be seen from, 9 k + {0, 1, 2} for k = obs_frame..horizon: the only
    entries ``feature_information(..., obs_frame=obs_frame)`` writes (its
    visibility needs k >= obs_frame), so the greedy pass's support (12 of
    the 45 at the defaults, 15 at obs_frame 0)."""
    return tuple(STATE_SIZE * k + a for k in range(obs_frame, horizon + 1) for a in range(3))


def _lu_steps(A, steps, pivot_rows):
    """The first ``steps`` pivot steps of the kernel's LU on a batch [B, n, n]
    (a copy): unblocked, right-looking, partial pivoting over rows
    k..pivot_rows-1 (the first largest |pivot|, as LAPACK's idamax), the
    multipliers scaled by the pivot's reciprocal, each product and
    difference rounded on its own, the logs of |pivot| summed in pivot
    order.  Returns (A after the steps, the sum of the logs [B])."""
    A = A.clone()
    B, n = A.shape[0], A.shape[-1]
    rows = torch.arange(B, device=A.device)
    out = torch.zeros(B, dtype=A.dtype, device=A.device)
    for k in range(steps):
        p = k + torch.argmax(torch.abs(A[:, k:pivot_rows, k]), dim=1)
        row_k, row_p = A[rows, k].clone(), A[rows, p].clone()
        A[rows, p] = row_k
        A[rows, k] = row_p
        piv = row_p[:, k]
        out = out + torch.log(torch.abs(piv))
        if k + 1 < n:
            col = A[:, k + 1:, k]
            lmul = torch.where((piv != 0)[:, None], col * (1.0 / piv)[:, None], col)
            A[:, k + 1:, k + 1:] = A[:, k + 1:, k + 1:] - lmul[:, :, None] * row_p[:, None, k + 1:]
    return A, out


def logdet_plain(M):
    """log|det| of a batch [B, n, n] by the kernel's LU (``_lu_steps`` over
    all n columns)."""
    n = M.shape[-1]
    return _lu_steps(M, n, n)[1]


def greedy_support(dim, obs_frame=None):
    """The indices the greedy pass factors for an information of size dim:
    ``position_support(obs_frame)`` over the dim / STATE_SIZE states when
    obs_frame is the one ``feature_information`` was called with, all dim
    of them (the dense case) when it is None."""
    if obs_frame is None:
        return tuple(range(dim))
    n_states = dim // STATE_SIZE
    if dim % STATE_SIZE or not 0 <= obs_frame < n_states:
        raise ValueError(f"obs_frame must name one of the {n_states} states of a "
                         f"[{dim}, {dim}] information, got {obs_frame}")
    return position_support(obs_frame, n_states - 1)


def _support_perm(dim, support):
    """(the indices off the support in order, then the support's): the
    order the greedy pass eliminates Omega in."""
    sup = tuple(range(dim)) if support is None else tuple(int(i) for i in support)
    return tuple(i for i in range(dim) if i not in sup) + sup, len(sup)


def schur_base_plain(omega_prior, support=None):
    """Sigma = Omega'_SS - Omega'_SN Omega'_NN^-1 Omega'_NS for Omega' =
    Omega + 1e-9 I, S the support and N the rest: the trailing block after
    the kernel's LU eliminates the N columns of [N, S]-ordered Omega' with
    pivots from the N rows.  det(Omega' + F) = det(Omega'_NN) det(Sigma +
    F_SS) for any F that is zero off S x S."""
    dim = omega_prior.shape[0]
    perm, ns = _support_perm(dim, support)
    nn = dim - ns
    idx = torch.tensor(perm, device=omega_prior.device)
    Om = omega_prior + 1e-9 * torch.eye(dim, dtype=omega_prior.dtype, device=omega_prior.device)
    A = Om[idx[:, None], idx[None, :]]
    return _lu_steps(A[None], nn, nn)[0][0, nn:, nn:]


def select_features_plain(omega_prior, omega_feats, candidate_mask, budget,
                          cfg: SelectorConfig, obs_frame=None):
    """K20 ``selector_greedy``'s twin: ``cfg.max_features`` greedy rounds
    (budget, a device int, masks off the rounds past it) on the support's
    Schur form: each round the log|det| of Sigma and of Sigma + F_SS[i] for
    every candidate by ``logdet_plain`` (``schur_base_plain``: the gain
    log|det(Omega + F_i + 1e-9 I)| - log|det(Omega + 1e-9 I)| in exact
    arithmetic), the first best of the positive gains taken and its F_SS
    added to Sigma.  obs_frame: the one omega_feats came from
    ``feature_information`` with, so the support is ``greedy_support(dim,
    obs_frame)`` (default None: all the indices, the dense case).  Returns
    (selected [N] bool, the first round's gains [N], 0 off candidate_mask)."""
    kernels.TWIN_CALLS["selector_greedy"] += 1
    N, dim = omega_feats.shape[0], omega_prior.shape[0]
    support = greedy_support(dim, obs_frame)
    perm, ns = _support_perm(dim, support)
    sup = torch.tensor(perm[dim - ns:], device=omega_prior.device)
    sigma = schur_base_plain(omega_prior, support)
    F = omega_feats[:, sup[:, None], sup[None, :]]
    selected = torch.zeros(N, dtype=torch.bool, device=omega_prior.device)
    neg_inf = torch.full((N,), -torch.inf, dtype=omega_prior.dtype, device=omega_prior.device)
    g0 = None
    for r in range(max(cfg.max_features, 1)):
        ld = logdet_plain(torch.cat([sigma[None], sigma + F]))
        if r == 0:
            g0 = ld[1:] - ld[0]
        if r == cfg.max_features:
            break
        gain = torch.where(candidate_mask & ~selected, ld[1:] - ld[0], neg_inf)
        best = torch.argmax(gain)
        improved = (gain[best] > 0.0) & (r < budget)
        sigma = torch.where(improved, sigma + F[best], sigma)
        selected = selected.clone()
        selected[best] = selected[best] | improved
    return selected, torch.where(candidate_mask, g0, torch.zeros_like(g0))


class _GreedyArgs(ctypes.Structure):
    """VpGreedyArgs (csrc/selector.cu)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("prior", "feats", "mask", "budget", "selected",
                                                 "gains")]
                + [(n, ctypes.c_int) for n in ("N", "dim", "ns", "rounds")]
                + [("perm", ctypes.c_int * MAX_DIM)])


def select_features(omega_prior, omega_feats, candidate_mask, budget, cfg: SelectorConfig,
                    obs_frame=None):
    """K20 ``selector_greedy``.  CPU tensors: ``select_features_plain``.
    CUDA tensors: the whole pass in one launch of a cluster of 16 CTAs, no
    host sync (budget is a device int): Sigma once, then per round every
    candidate's LU on the support (16 lanes each, the rows in registers,
    f64) and the argmax and update, the CTAs' bests exchanged through
    distributed shared memory.  obs_frame: the one omega_feats came from
    ``feature_information`` with; the kernel reads only F_SS of the support
    it gives (``greedy_support``).  Default None: every index, the dense
    case, for an information from elsewhere."""
    if not omega_feats.is_cuda:
        return select_features_plain(omega_prior, omega_feats, candidate_mask, budget, cfg,
                                     obs_frame)
    N, dim = omega_feats.shape[0], omega_prior.shape[0]
    f64, dev = torch.float64, omega_feats.device
    perm, ns = _support_perm(dim, greedy_support(dim, obs_frame))
    if dim > MAX_DIM:
        raise ValueError(f"selector_greedy takes dim <= {MAX_DIM}, got {dim}")
    prior, feats = omega_prior.contiguous(), omega_feats.contiguous()
    mask = candidate_mask.to(torch.uint8).contiguous()
    budget = torch.as_tensor(budget, device=dev).to(torch.int64).reshape(1)
    selected = torch.empty(N, dtype=torch.uint8, device=dev)
    gains = torch.empty(N, dtype=f64, device=dev)
    if N == 0:
        return selected.bool(), gains
    args = _GreedyArgs(
        kernels.check(prior, "omega_prior", f64, shape=(dim, dim)),
        kernels.check(feats, "omega_feats", f64, shape=(N, dim, dim)),
        kernels.check(mask, "candidate_mask", torch.uint8, shape=(N,)),
        kernels.check(budget, "budget", torch.int64, shape=(1,)),
        kernels.check(selected, "selected", torch.uint8),
        kernels.check(gains, "gains", f64), N, dim, ns, int(cfg.max_features),
        (ctypes.c_int * MAX_DIM)(*perm))
    SELECTOR_GREEDY(ctypes.byref(args))
    return selected.bool(), gains
