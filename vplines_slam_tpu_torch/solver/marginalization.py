"""Sliding-window marginalization as a square-root prior.

Port of ``vplines_slam_tpu/solver/marginalization.py`` (``Prior``,
``marginalize_window`` for the window's arrow structure,
``project_out_nullspace``, ``prior_residual``, ``shift_prior``).  The
Schur/eigen-clipping math runs in f64 (see ``lm._solve_dtype``).

The √-prior rows come from eigenvectors, whose signs and (for repeated
eigenvalues) rotations are free: compare priors through JᵀJ and Jᵀr, never
row by row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Prior(NamedTuple):
    """residual(x) = r0 + J · (x ⊟ x_lin), zero until ``valid``."""

    J: torch.Tensor  # [N, N]
    r0: torch.Tensor  # [N]
    valid: torch.Tensor  # [] bool


def empty_prior(n, dtype=torch.float64, device=torch.device("cuda")):
    return Prior(
        J=torch.zeros(n, n, dtype=dtype, device=device),
        r0=torch.zeros(n, dtype=dtype, device=device),
        valid=torch.zeros((), dtype=torch.bool, device=device),
    )


def _eps_rel(dtype):
    """Relative eigen-clip threshold per dtype (f32 eigh noise ~ ‖H‖·ulp)."""
    return 1e-6 if dtype.itemsize <= 4 else 1e-12


def _clip_gate(w, eps, floor=1e-30):
    """Keep-gate for eigenvalues: w > max(eps·max|w|, floor) per trailing block."""
    wmax = torch.amax(torch.abs(w), dim=-1, keepdim=True)
    return w > torch.clamp(eps * wmax, min=floor)


def _col_scale(J, floor=1e-30):
    """Jacobi preconditioner: column norms of J (1 for empty columns)."""
    d = torch.sum(J * J, dim=0)
    return torch.where(d > floor, torch.sqrt(torch.clamp(d, min=floor)), torch.ones_like(d))


def marginalize_window(J, r, nd, dense_start, dense_size, n_points=0, n_lines=0,
                       eps=None):
    """Exact marginalization for the window's arrow structure: [0:nd] dense
    states (the block [dense_start, +dense_size) is dropped),
    [nd : nd+n_points] point inverse depths and [+4·n_lines] line orth
    coords (all dropped).  Stage 1 removes the scalar point blocks with a
    clipped diagonal inverse and the 4x4 line blocks with per-block clipped
    eigh inverses, stage 2 the dropped dense block with eigh(dense_size),
    stage 3 takes the √ of the kept block with eigh(keep).  Returns
    (J_prior [N, N], r_prior [N])."""
    from .lm import _solve_dtype

    out_dtype = J.dtype
    dtype = _solve_dtype(J.dtype)
    if eps is None:
        eps = _eps_rel(dtype)
    J = J.to(dtype)
    r = r.to(dtype)
    N = J.shape[1]
    dev = J.device
    c = _col_scale(J)
    J = J / c[None, :]
    H = J.T @ J
    b = J.T @ r

    H1 = H[:nd, :nd]
    b1 = b[:nd]
    if n_points:
        p0 = nd
        Cp = H[:nd, p0:p0 + n_points]
        dp = torch.diagonal(H)[p0:p0 + n_points]
        keep_p = _clip_gate(dp[None, :], eps)[0]
        dpi = torch.where(keep_p, 1.0 / torch.clamp(dp, min=1e-30), torch.zeros_like(dp))
        H1 = H1 - (Cp * dpi[None, :]) @ Cp.T
        b1 = b1 - Cp @ (dpi * b[p0:p0 + n_points])
    if n_lines:
        q0, L = nd + n_points, n_lines
        Cl = H[:nd, q0:q0 + 4 * L].reshape(nd, L, 4)
        blk = H[q0:q0 + 4 * L, q0:q0 + 4 * L].reshape(L, 4, L, 4)
        ar = torch.arange(L, device=dev)
        wl, Vl = torch.linalg.eigh(blk[ar, :, ar, :])  # [L, 4, 4] diagonal blocks
        keep_l = _clip_gate(wl, eps)
        wli = torch.where(keep_l, 1.0 / torch.clamp(wl, min=1e-30), torch.zeros_like(wl))
        Dli = torch.einsum("lab,lb,lcb->lac", Vl, wli, Vl)
        H1 = H1 - torch.einsum("nla,lab,mlb->nm", Cl, Dli, Cl)
        b1 = b1 - torch.einsum("nla,lab,lb->n", Cl, Dli, b[q0:q0 + 4 * L].reshape(L, 4))

    midx = torch.arange(dense_start, dense_start + dense_size, device=dev)
    kidx = torch.cat([torch.arange(0, dense_start, device=dev),
                      torch.arange(dense_start + dense_size, nd, device=dev)])
    P00 = H1[midx[:, None], midx[None, :]]
    Q = H1[kidx[:, None], midx[None, :]]
    w0, V0 = torch.linalg.eigh(P00)
    keep0 = _clip_gate(w0, eps)
    w0i = torch.where(keep0, 1.0 / torch.clamp(w0, min=1e-30), torch.zeros_like(w0))
    P00i = (V0 * w0i[None, :]) @ V0.T
    A_new = H1[kidx[:, None], kidx[None, :]] - Q @ P00i @ Q.T
    b_new = b1[kidx] - Q @ (P00i @ b1[midx])
    A_new = 0.5 * (A_new + A_new.T)

    w2, V2 = torch.linalg.eigh(A_new)
    keep2 = _clip_gate(w2, eps)
    s = torch.sqrt(torch.where(keep2, w2, torch.zeros_like(w2)))
    s_inv = torch.where(keep2, 1.0 / torch.clamp(s, min=1e-30), torch.zeros_like(s))
    Jk = (s[:, None] * V2.T) * c[kidx][None, :]
    rk = (s_inv[:, None] * V2.T) @ b_new

    J_prior = torch.zeros(N, N, dtype=dtype, device=dev)
    J_prior[kidx[:, None], kidx[None, :]] = Jk
    r_prior = torch.zeros(N, dtype=dtype, device=dev)
    r_prior[kidx] = rk
    return J_prior.to(out_dtype), r_prior.to(out_dtype)


def project_out_nullspace(J, Nbasis, keep=None):
    """J ← J(I − UUᵀ), U an orthonormal basis of span(Nbasis) restricted to
    the dims the prior touches (the window's unobservable gauge)."""
    dtype = J.dtype
    if keep is None:
        d = torch.sum(J * J, dim=0)
        keep = d > 1e-12 * torch.max(d)
    Nb = Nbasis.to(dtype) * keep[:, None].to(dtype)
    U, s, _ = torch.linalg.svd(Nb, full_matrices=False)
    ok = s > 1e-6 * torch.clamp(torch.max(s), min=1e-30)
    U = U * ok[None, :].to(dtype)
    return J - (J @ U) @ U.T


def prior_residual(prior: Prior, dx):
    """Prior residual at the manifold difference dx = x ⊟ x_lin."""
    r = prior.r0 + prior.J @ dx
    return torch.where(prior.valid, r, torch.zeros_like(r))


def shift_prior(prior: Prior, perm):
    """Re-index prior columns after a slide: new column j <- old perm[j]
    (perm -1 = dropped)."""
    cols = torch.where(perm >= 0, perm, torch.zeros_like(perm))
    J_new = prior.J[:, cols] * (perm >= 0)[None, :].to(prior.J.dtype)
    return prior._replace(J=J_new)
