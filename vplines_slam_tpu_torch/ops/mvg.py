"""Multi-view geometry: essential-matrix RANSAC and multi-view triangulation.

Port of ``vplines_slam_tpu/ops/mvg.py`` (``_solve3x3``, ``_smallest_eigvec``,
``eight_point_essential``, ``ransac_essential``, ``triangulate_tracks``).
Everything works on normalized image coordinates; masked entries contribute
zero rows, so padding never changes results.

RANSAC takes its sample indices as an argument (``[n_hyp, 8]`` long, drawn
in ``[0, N)``): torch generators cannot reproduce ``jax.random`` draws, so
the tests feed the JAX draws and callers on the card draw with a seeded
``torch.Generator``.  The hypothesis scoring is kernel K4
(``csrc/sampson.cu``); the 8-point fits stay ``torch.linalg`` (batched eigh
9x9 and svd 3x3), as the reference left them to XLA.
"""

from __future__ import annotations

import torch

from .. import kernels

SAMPSON_SCORE = kernels.Kernel(
    "vp_sampson_score", "vplines_slam_tpu_torch/csrc/sampson.cu",
    "vplines_slam_tpu/ops/mvg.py:307",
    [kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.I,
     kernels.F, kernels.P, kernels.P],
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


def sampson_score(Es, x1, x2, mask, threshold):
    """K4.  CPU tensors: ``sampson_score_plain``.  CUDA tensors: one block per
    hypothesis, one thread per track."""
    if not Es.is_cuda:
        return sampson_score_plain(Es, x1, x2, mask, threshold)
    Hn, N = Es.shape[0], x1.shape[0]
    Es, x1, x2 = Es.contiguous(), x1.contiguous(), x2.contiguous()
    m8 = mask.to(torch.uint8).contiguous()
    counts = torch.empty(Hn, dtype=torch.int32, device=Es.device)
    inl = torch.empty(Hn, N, dtype=torch.uint8, device=Es.device)
    SAMPSON_SCORE(
        kernels.check(Es, "Es", shape=(Hn, 3, 3)), kernels.check(x1, "x1", shape=(N, 2)),
        kernels.check(x2, "x2", shape=(N, 2)), kernels.check(m8, "mask", torch.uint8, shape=(N,)),
        Hn, N, float(threshold) ** 2,
        kernels.check(counts, "counts", torch.int32),
        kernels.check(inl, "inl", torch.uint8),
    )
    return counts, inl.bool()


def ransac_essential(x1, x2, mask, sample_idx, threshold=3.0 / 460.0):
    """Fixed-trial batched RANSAC for the essential matrix.

    sample_idx: [n_hyp, 8] long draws in [0, N) (the reference draws
    ``jax.random.randint(key, (n_hyp, 8), 0, N)``); they are remapped onto
    the valid entries exactly as the reference does.
    Returns (E_best, inlier_mask, n_inliers)."""
    N = x1.shape[0]
    order = torch.argsort((~mask).to(torch.int8), stable=True)  # valid first
    n_valid = torch.clamp(torch.sum(mask.to(torch.int64)), min=8)
    idx = order[sample_idx % n_valid]
    n_hyp = idx.shape[0]
    sm = torch.zeros(n_hyp, N, dtype=torch.bool, device=x1.device)
    sm = sm.scatter(1, idx, True) & mask
    Es = eight_point_essential(x1, x2, sm)
    counts, inls = sampson_score(Es, x1, x2, mask, threshold)
    best = torch.argmax(counts)
    # least-squares refit on all inliers of the best minimal hypothesis, kept
    # only if it does not lose inliers
    E_ref = eight_point_essential(x1, x2, inls[best])
    n_ref, inl_ref = sampson_score(E_ref[None], x1, x2, mask, threshold)
    n_ref, inl_ref = n_ref[0], inl_ref[0]
    better = n_ref >= counts[best]
    E_out = torch.where(better, E_ref, Es[best])
    inl_out = torch.where(better, inl_ref, inls[best])
    return E_out, inl_out, torch.maximum(n_ref, counts[best])


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
