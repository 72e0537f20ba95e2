"""Multi-view geometry: essential matrix, two-view and multi-view
triangulation, PnP.

Port of ``vplines_slam_tpu/ops/mvg.py`` (``_solve3x3``, ``_smallest_eigvec``,
``eight_point_essential``, ``ransac_essential``, ``decompose_essential``,
``_two_view_depths``, ``triangulate_two_view``, ``triangulate_tracks``,
``pnp_dlt``, ``pnp_refine``, ``ransac_pnp``).
Everything works on normalized image coordinates; masked entries contribute
zero rows, so padding never changes results.

RANSAC takes its sample indices as an argument (``[n_hyp, 8]`` long, drawn
in ``[0, N)``): torch generators cannot reproduce ``jax.random`` draws, so
the tests feed the JAX draws and callers on the card draw with a seeded
``torch.Generator``.  ``ransac_essential`` on CUDA tensors is kernel K4
(``csrc/ransac.cu``): the sample masks, the 8-point fits (f64 inside
whatever the input type), the Sampson scores, the pick, the refit and the
tracker's gate in one launch; on CPU tensors ``ransac_essential_plain``
(``torch.linalg`` eigh 9x9 and svd 3x3, as the reference left them to XLA).
``ransac_pnp`` takes
its draws the same way (``[n_hyp, 6]``); its hypotheses -- a six-point DLT
pose each and its reprojection inliers -- are kernel K18
(``csrc/pnp.cu``, f64 inside whatever the input type), the choice of the
best and the final score plain torch.  ``pnp_refine``'s Gauss-Newton steps
are kernel K21 (``csrc/pnp_refine.cu``, f64 inside, a batch of problems in
one launch: the initializer's window frames, a verification's one pose).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.func import jacfwd

from .. import kernels
from ..utils.geometry import so3_exp_matrix

RANSAC_ESSENTIAL = kernels.Kernel(
    "vp_ransac_essential", "vplines_slam_tpu_torch/csrc/ransac.cu",
    "vplines_slam_tpu/ops/mvg.py:278",
    [kernels.P, kernels.I, kernels.P, kernels.I, kernels.P, kernels.P, kernels.I, kernels.I,
     ctypes.c_double, kernels.I, kernels.I, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
     kernels.P, kernels.P],
)
RANSAC_MAX_HYP, RANSAC_MAX_N = 64, 1024  # K4's limits: one CTA, eight lanes a hypothesis

PNP_HYPOTHESES = kernels.Kernel(
    "vp_pnp_hypotheses", "vplines_slam_tpu_torch/csrc/pnp.cu",
    "vplines_slam_tpu/ops/mvg.py:241",
    [kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.I, kernels.I,
     ctypes.c_double, kernels.I, kernels.P, kernels.P, kernels.P, kernels.P],
)

PNP_REFINE = kernels.Kernel(
    "vp_pnp_refine", "vplines_slam_tpu_torch/csrc/pnp_refine.cu",
    "vplines_slam_tpu/ops/mvg.py:213",
    [kernels.P, kernels.P, kernels.P, kernels.I, kernels.P, kernels.P, kernels.I, kernels.I,
     kernels.I, kernels.I, kernels.P, kernels.P],
)


def _solve3x3(H, g):
    """Closed-form (adjugate/Cramer) batched 3x3 solve."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g0, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g0 - d * i
    A11 = a * i - c * g0
    A12 = c * d - a * f
    A20 = d * h - e * g0
    A21 = b * g0 - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    x0 = (A00 * g[..., 0] + A01 * g[..., 1] + A02 * g[..., 2]) * inv_det
    x1 = (A10 * g[..., 0] + A11 * g[..., 1] + A12 * g[..., 2]) * inv_det
    x2 = (A20 * g[..., 0] + A21 * g[..., 1] + A22 * g[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def _smallest_eigvec(A):
    """Unit eigenvector of symmetric A for the smallest eigenvalue."""
    _, V = torch.linalg.eigh(A)
    return V[..., :, 0]


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def eight_point_essential(x1, x2, mask):
    """Essential matrix from >= 8 correspondences, batched over leading dims
    of ``mask`` ([..., N] weights): x2ᵀ E x1 = 0 with σ = (1, 1, 0)."""
    m = mask.to(x1.dtype)[..., :, None]
    h1, h2 = _homog(x1), _homog(x2)
    rows = (h2[:, :, None] * h1[:, None, :]).reshape(-1, 9)  # [N, 9]
    A = rows * m  # [..., N, 9]
    e = _smallest_eigvec(A.transpose(-1, -2) @ A)
    E = e.reshape(*e.shape[:-1], 3, 3)
    U, _, Vt = torch.linalg.svd(E)
    s_fixed = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * s_fixed) @ Vt


def sampson_score_plain(Es, x1, x2, mask, threshold):
    """Sampson inlier count and mask per hypothesis: Es [Hn,3,3] ->
    (counts [Hn] int32, inl [Hn, N] bool)."""
    h1, h2 = _homog(x1), _homog(x2)
    Ex1 = torch.einsum("nj,hij->hni", h1, Es)  # rows of E @ h1
    Etx2 = torch.einsum("nj,hji->hni", h2, Es)  # rows of Eᵀ @ h2
    num = torch.sum(h2 * Ex1, dim=-1)
    sampson = num * num / (
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
        + 1e-18
    )
    inl = (sampson < threshold * threshold) & mask
    return torch.sum(inl.to(torch.int32), dim=-1, dtype=torch.int32), inl


def ransac_essential_plain(x1, x2, mask, sample_idx, threshold=3.0 / 460.0, min_valid=0,
                           return_hypotheses=False):
    """K4's twin, the reference's ``ransac_essential``: draw i -> the (draw
    % max(n_valid, 8))-th entry of the stable valid-first order, the sample
    masks (sets: repeats collapse, invalid entries drop), their 8-point E
    and Sampson scores, the first best, its least-squares refit on all its
    inliers, kept only if it does not lose inliers.  Below min_valid valid
    entries (the tracker's gate, decided on the host here) it returns
    (zeros, mask, n_valid) and computes nothing.  With return_hypotheses
    also (Es, counts, inls) of every hypothesis and the refit's E_ref
    (zeros under the gate)."""
    kernels.TWIN_CALLS["ransac"] += 1
    n_hyp, N = sample_idx.shape[0], x1.shape[0]
    if min_valid > 0 and int(torch.sum(mask.to(torch.int64))) < min_valid:
        z = torch.zeros(n_hyp, 3, 3, dtype=x1.dtype, device=x1.device)
        out = (z[0], mask.clone(), torch.sum(mask.to(torch.int32), dtype=torch.int32))
        hyps = (z, torch.zeros(n_hyp, dtype=torch.int32, device=x1.device),
                torch.zeros(n_hyp, N, dtype=torch.bool, device=x1.device), z[0])
        return out + hyps if return_hypotheses else out
    order = torch.argsort((~mask).to(torch.int8), stable=True)  # valid first
    n_valid = torch.clamp(torch.sum(mask.to(torch.int64)), min=8)
    idx = order[sample_idx % n_valid]
    sm = torch.zeros(n_hyp, N, dtype=torch.bool, device=x1.device)
    sm = sm.scatter(1, idx, True) & mask
    Es = eight_point_essential(x1, x2, sm)
    counts, inls = sampson_score_plain(Es, x1, x2, mask, threshold)
    best = torch.argmax(counts)
    # least-squares refit on all inliers of the best minimal hypothesis, kept
    # only if it does not lose inliers
    E_ref = eight_point_essential(x1, x2, inls[best])
    n_ref, inl_ref = sampson_score_plain(E_ref[None], x1, x2, mask, threshold)
    n_ref, inl_ref = n_ref[0], inl_ref[0]
    better = n_ref >= counts[best]
    E_out = torch.where(better, E_ref, Es[best])
    inl_out = torch.where(better, inl_ref, inls[best])
    out = (E_out, inl_out, torch.maximum(n_ref, counts[best]))
    return out + (Es, counts, inls, E_ref) if return_hypotheses else out


def ransac_essential(x1, x2, mask, sample_idx, threshold=3.0 / 460.0, min_valid=0,
                     return_hypotheses=False):
    """Fixed-trial batched RANSAC for the essential matrix.

    x1, x2 [N, 2] normalized points (f32 or f64; rows may be strided, e.g.
    a column slice of ``lift``'s output); mask [N]; sample_idx [n_hyp, 8]
    long draws in [0, N) (the reference draws ``jax.random.randint(key,
    (n_hyp, 8), 0, N)``), remapped onto the valid entries as the reference
    does.  Below min_valid valid entries (the tracker passes 12, the
    reference's ``lax.cond``) the inliers are the mask itself, E is zero and
    n is the count of valid entries.  Returns (E_best, inlier_mask,
    n_inliers), with return_hypotheses also (Es, counts, inls) of every
    hypothesis and the refit's E_ref.

    CPU tensors: ``ransac_essential_plain``.  CUDA tensors: K4, one launch
    and no host sync, the fits in f64 whatever the input type, the scores in
    the input type; n_hyp <= 64 and N <= 1024, else it raises."""
    if not x1.is_cuda:
        return ransac_essential_plain(x1, x2, mask, sample_idx, threshold, min_valid,
                                      return_hypotheses)
    n_hyp, N = sample_idx.shape[0], x1.shape[0]
    dt, dev = x1.dtype, x1.device
    if dt not in (torch.float32, torch.float64) or x2.dtype != dt:
        raise ValueError(f"K4 takes float32 or float64 points, got {dt} and {x2.dtype}")
    if not (1 <= n_hyp <= RANSAC_MAX_HYP and 1 <= N <= RANSAC_MAX_N):
        raise ValueError(f"K4 takes 1-{RANSAC_MAX_HYP} hypotheses and 1-{RANSAC_MAX_N} "
                         f"points, got {n_hyp} and {N}")
    rows = []
    for name, x in (("x1", x1), ("x2", x2)):
        if x.device != dev or tuple(x.shape) != (N, 2) or x.stride(1) != 1:
            raise ValueError(f"{name}: expected [{N}, 2] on {dev} with adjacent columns, got "
                             f"shape {tuple(x.shape)} on {x.device}, strides {x.stride()}")
        rows.append(x.stride(0))
    m8 = kernels.as_u8(mask)
    E = torch.empty(3, 3, dtype=dt, device=dev)
    inl = torch.empty(N, dtype=torch.bool, device=dev)
    n = torch.empty((), dtype=torch.int32, device=dev)
    hyps = ((torch.empty(n_hyp, 3, 3, dtype=dt, device=dev),
             torch.empty(n_hyp, dtype=torch.int32, device=dev),
             torch.empty(n_hyp, N, dtype=torch.bool, device=dev),
             torch.empty(3, 3, dtype=dt, device=dev)) if return_hypotheses else None)
    RANSAC_ESSENTIAL(
        x1.data_ptr(), rows[0], x2.data_ptr(), rows[1],
        kernels.check(m8, "mask", torch.uint8, shape=(N,)),
        kernels.check(sample_idx, "sample_idx", torch.int64, shape=(n_hyp, 8)), n_hyp, N,
        float(threshold), int(min_valid), int(dt == torch.float64), kernels.check(E, "E", dt),
        kernels.check(inl, "inl", torch.bool), kernels.check(n, "n", torch.int32),
        *((None,) * 4 if hyps is None else (
            kernels.check(hyps[0], "Es", dt), kernels.check(hyps[1], "counts", torch.int32),
            kernels.check(hyps[2], "inls", torch.bool), kernels.check(hyps[3], "E_ref", dt))))
    return (E, inl, n) + (() if hyps is None else hyps)


def decompose_essential(E, x1, x2, mask):
    """Four-way decomposition + cheirality vote.  Returns (R, t, votes) with
    ‖t‖ = 1 and x2 ~ R x1 + t.  The SVD's sign conventions may differ from
    the reference's LAPACK, which reorders the four candidates but not the
    set; the vote picks the same one unless two candidates tie."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype,
                     device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t1 = U[:, 2]
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t1, -t1, t1, -t1])
    z1, z2 = _two_view_depths(cands_R, cands_t, x1, x2)  # [4, N]
    votes = torch.sum(((z1 > 0) & (z2 > 0) & mask).to(torch.int64), dim=-1)
    best = torch.argmax(votes)
    return cands_R[best], cands_t[best], votes[best]


def _two_view_depths(R, t, x1, x2):
    """Depths (z1, z2) of the least-squares midpoint triangulation given
    x2 ~ R x1 + t; R [..., 3, 3] and t [..., 3] may carry leading dims."""
    h1, h2 = _homog(x1), _homog(x2)
    r1 = h1 @ R.transpose(-1, -2)  # ray 1 in frame 2: [..., N, 3]
    M = torch.stack([r1, -h2.expand_as(r1)], dim=-1)  # [..., N, 3, 2]
    z = (torch.linalg.pinv(M) @ -t[..., None, :, None])[..., 0]
    return z[..., 0], z[..., 1]


def triangulate_two_view(R, t, x1, x2):
    """DLT triangulation in frame 1 given x2 ~ R x1 + t.  Returns (X1 [N, 3],
    depth in frame 1)."""
    P1 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device),
                    torch.zeros(3, 1, dtype=R.dtype, device=R.device)], 1)
    P2 = torch.cat([R, t[:, None]], 1)
    A = torch.stack([
        x1[:, 0:1] * P1[2] - P1[0], x1[:, 1:2] * P1[2] - P1[1],
        x2[:, 0:1] * P2[2] - P2[0], x2[:, 1:2] * P2[2] - P2[1],
    ], dim=1)  # [N, 4, 4]
    X = _smallest_eigvec(A.transpose(-1, -2) @ A)
    X1 = X[:, :3] / X[:, 3:4]
    return X1, X1[:, 2]


def pnp_dlt(X_w, x, mask):
    """Linear PnP (DLT) with rotation re-orthonormalization.  X_w [N, 3]
    world points; x [..., N, 2] normalized observations; mask [..., N]
    (leading dims batch several frames against the same points).  Returns
    (R, t, ok) with x ~ R X_w + t; ok needs >= 6 points."""
    m = mask.to(x.dtype)[..., None]
    X_h = _homog(X_w)  # [N, 4]
    z = torch.zeros_like(X_h)
    r0 = torch.cat([X_h.expand(*x.shape[:-1], 4), z.expand(*x.shape[:-1], 4),
                    -x[..., 0:1] * X_h], dim=-1) * m
    r1 = torch.cat([z.expand(*x.shape[:-1], 4), X_h.expand(*x.shape[:-1], 4),
                    -x[..., 1:2] * X_h], dim=-1) * m
    A = torch.stack([r0, r1], dim=-2).reshape(*x.shape[:-2], -1, 12)
    p = _smallest_eigvec(A.transpose(-1, -2) @ A)
    Pm = p.reshape(*p.shape[:-1], 3, 4)
    # fix the sign: mean depth positive
    depths = X_h @ Pm[..., 2, :, None]  # [..., N, 1]
    sign = torch.sign(torch.sum(depths * m, dim=(-2, -1)) + 1e-30)
    Pm = Pm * sign[..., None, None]
    U, sv, Vt = torch.linalg.svd(Pm[..., :3])
    R = U @ Vt
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    t = Pm[..., 3] / torch.mean(sv, dim=-1, keepdim=True)
    return R, t, torch.sum(mask.to(torch.int64), dim=-1) >= 6


def _pnp_refine_one(R0, t0, X_w, x, mask, iters):
    """Gauss-Newton refinement of one PnP pose on SE(3): the left rotation
    increment and the translation, ``iters`` fixed steps."""
    w = mask.to(x.dtype)[:, None]

    def residual(params):
        R = so3_exp_matrix(params[:3]) @ R0
        Xc = X_w @ R.T + params[3:]
        return ((Xc[:, :2] / Xc[:, 2:3] - x) * w).reshape(-1)

    params = torch.cat([torch.zeros_like(t0), t0])
    eye = torch.eye(6, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        r = residual(params)
        J = jacfwd(residual)(params)
        # solve_ex: a singular system gives non-finite values, as JAX's
        # solve does, and neither raises nor syncs with the host
        params = params - torch.linalg.solve_ex(J.T @ J + 1e-8 * eye, J.T @ r)[0]
    return so3_exp_matrix(params[:3]) @ R0, params[3:]


def pnp_refine_plain(R0, t0, X_w, x, mask, iters=5):
    """K21's twin: ``_pnp_refine_one`` (``jacfwd`` Gauss-Newton) vmapped
    over the batch.  R0 [B, 3, 3], t0 [B, 3], X_w [N, 3] (shared) or
    [B, N, 3], x [B, N, 2], mask [B, N]."""
    kernels.TWIN_CALLS["pnp_refine"] += 1
    X_b = X_w.expand(R0.shape[0], *X_w.shape[-2:]) if X_w.dim() == 2 else X_w
    return torch.func.vmap(functools.partial(_pnp_refine_one, iters=iters))(R0, t0, X_b, x,
                                                                             mask)


def pnp_refine(R0, t0, X_w, x, mask, iters=5):
    """K21: Gauss-Newton refinement of PnP poses, x ~ project(R X_w + t),
    ``iters`` steps on the left rotation increment w (R = exp(w) R0) and t.
    Batched: R0 [B, 3, 3], t0 [B, 3], X_w [N, 3] or [B, N, 3], x [B, N, 2],
    mask [B, N]; a single problem ([3, 3], [3], [N, 3], [N, 2], [N]) is a
    batch of one.  CPU tensors: ``pnp_refine_plain``.  CUDA tensors: one
    launch, a warp per problem, f64 inside (closed-form Jacobians, a
    reduce-scatter of the normal equations, every lane solving the 6x6
    system in registers by LU with partial pivoting), the pose returned in
    x's dtype."""
    single = R0.dim() == 2
    if single:
        R0, t0, x, mask = R0[None], t0[None], x[None], mask[None]
    if not x.is_cuda:
        R, t = pnp_refine_plain(R0, t0, X_w, x, mask, iters)
    else:
        B, N = x.shape[0], x.shape[1]
        dt = x.dtype
        if dt not in (torch.float32, torch.float64):
            raise ValueError(f"K21 takes float32 or float64, got {dt}")
        R0, t0, X_w, x = (a.to(dt).contiguous() for a in (R0, t0, X_w, x))
        m8 = kernels.as_u8(mask)
        R = torch.empty(B, 3, 3, dtype=dt, device=x.device)
        t = torch.empty(B, 3, dtype=dt, device=x.device)
        x_batched = X_w.dim() == 3
        PNP_REFINE(kernels.check(R0, "R0", dt, shape=(B, 3, 3)),
                   kernels.check(t0, "t0", dt, shape=(B, 3)),
                   kernels.check(X_w, "X_w", dt, shape=(B, N, 3) if x_batched else (N, 3)),
                   int(x_batched), kernels.check(x, "x", dt, shape=(B, N, 2)),
                   kernels.check(m8, "mask", torch.uint8, shape=(B, N)), B, N, int(iters),
                   int(dt == torch.float64), kernels.check(R, "R", dt),
                   kernels.check(t, "t", dt))
    return (R[0], t[0]) if single else (R, t)


def triangulate_tracks(poses_R, poses_t, obs, mask):
    """Multi-view triangulation of many tracks (affine-normalized DLT with a
    relative conditioning gate).

    poses_R/poses_t: [F, 3, 3]/[F, 3] camera-from-world; obs [N, F, 2]
    normalized observations; mask [N, F].  Returns (X_w [N, 3], ok [N])."""
    dtype = obs.dtype
    P = torch.cat([poses_R, poses_t[..., :, None]], dim=-1)  # [F,3,4]
    m = mask.to(dtype)
    r0 = obs[..., 0:1] * P[:, 2, :] - P[:, 0, :]  # [N,F,4]
    r1 = obs[..., 1:2] * P[:, 2, :] - P[:, 1, :]
    A = torch.cat([r0, r1], dim=1) * torch.cat([m, m], dim=1)[..., None]  # [N,2F,4]
    B, b = A[..., 0:3], A[..., 3]
    H = B.transpose(-1, -2) @ B
    tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / 3.0
    Hd = H + 1e-10 * tr[:, None, None] * torch.eye(3, dtype=dtype, device=obs.device)
    X = -_solve3x3(Hd, (B.transpose(-1, -2) @ b[..., None])[..., 0])
    eps_tri = 1e-9 if dtype.itemsize > 4 else 3e-5
    det = torch.linalg.det(Hd)
    cond_ok = det > eps_tri * torch.clamp(tr, min=1e-30) ** 3
    X = torch.where(torch.isfinite(X), X, torch.zeros_like(X))
    ok = (torch.sum(mask.to(torch.int64), dim=1) >= 2) & cond_ok
    return X, ok


def _pnp_score(R, t, X_w, x, mask, threshold):
    """Reprojection inliers of pose(s) R [..., 3, 3], t [..., 3]: depth >
    0.05, error < threshold, mask.  Returns (count int32 [...], inl [..., N])."""
    Xc = X_w @ R.transpose(-1, -2) + t[..., None, :]
    good_z = Xc[..., 2] > 0.05
    proj = Xc[..., :2] / torch.where(good_z, Xc[..., 2], torch.ones_like(Xc[..., 2]))[..., None]
    err = torch.linalg.norm(proj - x, dim=-1)
    inl = (err < threshold) & mask & good_z
    return torch.sum(inl.to(torch.int32), dim=-1, dtype=torch.int32), inl


def pnp_hypotheses_plain(X_w, x, mask, idx, threshold):
    """K18's twin: for each sample row of idx [n_hyp, S] (indices into the N
    points), the DLT pose of the sample SET intersected with mask and its
    inliers over all points.  Returns (Rs [n_hyp, 3, 3], ts [n_hyp, 3],
    counts [n_hyp] int32, inls [n_hyp, N])."""
    kernels.TWIN_CALLS["pnp"] += 1
    n_hyp, N = idx.shape[0], X_w.shape[0]
    sm = torch.zeros(n_hyp, N, dtype=torch.bool, device=x.device).scatter(1, idx, True) & mask
    Rs, ts, _ = pnp_dlt(X_w, x.expand(n_hyp, N, 2), sm)
    counts, inls = _pnp_score(Rs, ts, X_w, x, mask, threshold)
    return Rs, ts, counts, inls


def pnp_hypotheses(X_w, x, mask, idx, threshold):
    """K18.  CPU tensors: ``pnp_hypotheses_plain``.  CUDA tensors: a warp
    per hypothesis (a parallel-ordered Jacobi eigensolve in registers), in
    f64 inside, at most 32 draws a sample; Rs and ts come back as f64 (the
    caller casts), the inliers scored from them."""
    if not x.is_cuda:
        return pnp_hypotheses_plain(X_w, x, mask, idx, threshold)
    n_hyp, S = idx.shape
    N = X_w.shape[0]
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"K18 takes float32 or float64, got {dt}")
    if S > 32:
        raise ValueError(f"K18 takes at most 32 draws a sample, got {S}")
    X_w, x = X_w.contiguous(), x.contiguous()
    m8 = mask.to(torch.uint8).contiguous()
    idx = idx.to(torch.int64).contiguous()
    Rs = torch.empty(n_hyp, 3, 3, dtype=torch.float64, device=dev)
    ts = torch.empty(n_hyp, 3, dtype=torch.float64, device=dev)
    counts = torch.empty(n_hyp, dtype=torch.int32, device=dev)
    inl = torch.empty(n_hyp, N, dtype=torch.uint8, device=dev)
    PNP_HYPOTHESES(kernels.check(X_w, "X_w", dt, shape=(N, 3)),
                   kernels.check(x, "x", dt, shape=(N, 2)),
                   kernels.check(m8, "mask", torch.uint8, shape=(N,)),
                   kernels.check(idx, "idx", torch.int64, shape=(n_hyp, S)), n_hyp, N, S,
                   float(threshold), int(dt == torch.float64),
                   kernels.check(Rs, "Rs", torch.float64), kernels.check(ts, "ts", torch.float64),
                   kernels.check(counts, "counts", torch.int32),
                   kernels.check(inl, "inl", torch.uint8))
    return Rs, ts, counts, inl.bool()


def ransac_pnp(X_w, x, mask, sample_idx, threshold=8.0 / 460.0, min_pts=6):
    """Fixed-trial batched PnP-RANSAC: n_hyp six-point DLT hypotheses scored
    by reprojection inliers, the first best refined by Gauss-Newton on its
    inliers and scored again.

    sample_idx: [n_hyp, min_pts] long draws in [0, N) (the reference draws
    ``jax.random.randint(key, (n_hyp, min_pts), 0, N)``), remapped onto the
    valid entries as the reference does.  Returns (R, t, inlier_mask,
    n_inliers) with x ~ project(R X_w + t)."""
    order = torch.argsort((~mask).to(torch.int8), stable=True)  # valid first
    n_valid = torch.clamp(torch.sum(mask.to(torch.int64)), min=min_pts)
    idx = order[sample_idx % n_valid]
    Rs, ts, counts, inls = pnp_hypotheses(X_w, x, mask, idx, threshold)
    best = torch.argmax(counts)  # the first maximum
    R_b, t_b, inl_b = Rs[best].to(x.dtype), ts[best].to(x.dtype), inls[best]
    R_f, t_f = pnp_refine(R_b, t_b, X_w, x, inl_b)
    n_f, inl_f = _pnp_score(R_f, t_f, X_w, x, mask, threshold)
    return R_f, t_f, inl_f, n_f
