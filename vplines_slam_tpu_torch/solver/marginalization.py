"""Sliding-window marginalization as a square-root prior.

Port of ``vplines_slam_tpu/solver/marginalization.py`` (``Prior``,
``marginalize_window`` for the window's arrow structure,
``project_out_nullspace``, ``prior_residual``, ``shift_prior``).  The
Schur/eigen-clipping math runs in f64 (see ``lm._solve_dtype``).

``marginalize_window_blocks`` is the same marginalization from the block
normal equations (``lm.assemble_blocks``' output) in place of the dense
Jacobian: its stage 1 (column scaling, the landmarks eliminated with clipped
inverses) is kernel K14 (``csrc/marg.cu``) on CUDA tensors and
``marg_stage1_plain`` on CPU tensors; stages 2-3 (eigh of the dropped block
and of the kept block) are ``torch.linalg.eigh`` on both, as the reference
calls ``jnp.linalg.eigh`` there.

The √-prior rows come from eigenvectors, whose signs and (for repeated
eigenvalues) rotations are free: compare priors through JᵀJ and Jᵀr, never
row by row.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from . import lm as lm_mod

_MARG_ARGS = kernels.args_struct(
    "VpMargArgs", ["H_dd", "g_d", "H_dp", "h_p", "g_p", "H_dl", "Hll", "g_l", "H1", "b1", "c_d",
                   "aux"], ["nd", "P", "L"], ["eps"])
MARG_WINDOW = kernels.Kernel(
    "vp_marg_window", "vplines_slam_tpu_torch/csrc/marg.cu",
    "vplines_slam_tpu/solver/marginalization.py:152", [ctypes.POINTER(_MARG_ARGS)])


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
    out_dtype = J.dtype
    dtype = lm_mod._solve_dtype(J.dtype)
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

    J_prior, r_prior = _marg_dense(H1, b1, c[:nd], nd, dense_start, dense_size, eps, N)
    return J_prior.to(out_dtype), r_prior.to(out_dtype)


def _marg_dense(H1, b1, c_d, nd, dense_start, dense_size, eps, n):
    """Stages 2-3 on the landmark-free system (H1, b1) of the scaled dense
    block: the dropped block [dense_start, +dense_size) by eigh, then the √
    of the kept block by eigh, unscaled by c_d.  Returns (J_prior [n, n],
    r_prior [n]), zero outside the kept dense columns."""
    dev = H1.device
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
    J_prior = torch.zeros(n, n, dtype=H1.dtype, device=dev)
    J_prior[kidx[:, None], kidx[None, :]] = (s[:, None] * V2.T) * c_d[kidx][None, :]
    r_prior = torch.zeros(n, dtype=H1.dtype, device=dev)
    r_prior[kidx] = (s_inv[:, None] * V2.T) @ b_new
    return J_prior, r_prior


def marginalize_window_blocks(H_dd, g_d, nd, dense_start, dense_size, H_dp=None, h_p=None,
                              g_p=None, H_dl=None, Hll_b=None, g_l=None, eps=None,
                              out_dtype=None):
    """``marginalize_window`` from the block normal equations of J (f64:
    H_dd = J_dᵀJ_d, g_d = -J_dᵀr; the points' H_dp [nd, P], h_p, g_p and the
    lines' H_dl [nd, L, 4], Hll_b [L, 4, 4], g_l [L, 4], each optional).
    Returns (J_prior [nd, nd], r_prior [nd]) in out_dtype (default f64): the
    landmark columns of the dense version's prior are zero.  Stage 1 is K14
    on CUDA tensors, ``marg_stage1_plain`` on CPU tensors."""
    if eps is None:
        eps = _eps_rel(torch.float64)
    stage1 = _marg_stage1_cuda if H_dd.is_cuda else marg_stage1_plain
    H1, b1, c_d = stage1(H_dd, g_d, H_dp, h_p, g_p, H_dl, Hll_b, g_l, eps)
    J_prior, r_prior = _marg_dense(H1, b1, c_d, nd, dense_start, dense_size, eps, nd)
    out_dtype = out_dtype or H1.dtype
    return J_prior.to(out_dtype), r_prior.to(out_dtype)


def marg_stage1_plain(H_dd, g_d, H_dp, h_p, g_p, H_dl, Hll_b, g_l, eps):
    """K14's twin: the column scales c = sqrt(diag H) (1 where <= 1e-30),
    then the point and line landmarks eliminated from the scaled system with
    clipped inverses.  Returns (H1 [nd, nd], b1 [nd], c_d [nd]), f64."""
    lm_mod.TWIN_CALLS["marg_stage1"] += 1
    f64 = torch.float64
    H_dd, g_d = H_dd.to(f64), g_d.to(f64)
    c_d = lm_mod._jacobi(torch.diagonal(H_dd))
    H1 = H_dd / (c_d[:, None] * c_d[None, :])
    b1 = -g_d / c_d
    if h_p is not None and h_p.shape[0]:
        H_dp, h_p, g_p = H_dp.to(f64), h_p.to(f64), g_p.to(f64)
        c_p = lm_mod._jacobi(h_p)
        Cp = H_dp / (c_d[:, None] * c_p[None, :])
        dp = h_p / (c_p * c_p)
        keep_p = _clip_gate(dp[None, :], eps)[0]
        dpi = torch.where(keep_p, 1.0 / torch.clamp(dp, min=1e-30), torch.zeros_like(dp))
        H1 = H1 - (Cp * dpi[None, :]) @ Cp.T
        b1 = b1 - Cp @ (dpi * (-g_p / c_p))
    if Hll_b is not None and Hll_b.shape[0]:
        H_dl, Hll_b, g_l = H_dl.to(f64), Hll_b.to(f64), g_l.to(f64)
        c_l = lm_mod._jacobi(torch.diagonal(Hll_b, dim1=1, dim2=2))  # [L, 4]
        Cl = H_dl / (c_d[:, None, None] * c_l[None, :, :])
        blk = Hll_b / (c_l[:, :, None] * c_l[:, None, :])
        wl, Vl = torch.linalg.eigh(blk)
        keep_l = _clip_gate(wl, eps)
        wli = torch.where(keep_l, 1.0 / torch.clamp(wl, min=1e-30), torch.zeros_like(wl))
        Dli = torch.einsum("lab,lb,lcb->lac", Vl, wli, Vl)
        H1 = H1 - torch.einsum("nla,lab,mlb->nm", Cl, Dli, Cl)
        b1 = b1 - torch.einsum("nla,lab,lb->n", Cl, Dli, -g_l / c_l)
    return H1, b1, c_d


def marg_scratch(nd, P, L):
    """Doubles of K14's scratch (csrc/marg.cu's Plan and Aux): bv [Kp] |
    Cᵀ [Kp, ndp] | Yᵀ [Kp, ndp], ndp = nd rounded up to 16, Kp = P + 4 L
    rounded up to 4."""
    ndp, Kp = -(-nd // 16) * 16, -(-(P + 4 * L) // 4) * 4
    return Kp + 2 * Kp * ndp


def _marg_stage1_cuda(H_dd, g_d, H_dp, h_p, g_p, H_dl, Hll_b, g_l, eps):
    """K14: a prep grid writes the scaled landmark columns C and their
    weighted partners Y once, then a CTA per 16x16 tile of H1's lower
    triangle forms H_dd / (c cᵀ) - Y Cᵀ (and b1) on the f64 tensor cores."""
    f64, dev = torch.float64, H_dd.device
    nd = H_dd.shape[0]
    P = 0 if h_p is None else h_p.shape[0]
    L = 0 if Hll_b is None else Hll_b.shape[0]
    c64 = lambda t: t.to(f64).contiguous()
    ins = [c64(H_dd), c64(g_d)]
    ins += [c64(t) for t in (H_dp, h_p, g_p)] if P else [None] * 3
    ins += [c64(t) for t in (H_dl, Hll_b, g_l)] if L else [None] * 3
    shapes = [(nd, nd), (nd,), (nd, P), (P,), (P,), (nd, L, 4), (L, 4, 4), (L, 4)]
    names = ["H_dd", "g_d", "H_dp", "h_p", "g_p", "H_dl", "Hll_b", "g_l"]
    ptrs = [None if t is None else kernels.check(t, n, f64, shape=sh)
            for t, n, sh in zip(ins, names, shapes)]
    e = lambda *shape: torch.empty(*shape, dtype=f64, device=dev)
    H1, b1, c_d, aux = e(nd, nd), e(nd), e(nd), e(max(marg_scratch(nd, P, L), 1))
    args = _MARG_ARGS(*ptrs, H1.data_ptr(), b1.data_ptr(), c_d.data_ptr(), aux.data_ptr(),
                      nd, P, L, float(eps))
    MARG_WINDOW(ctypes.byref(args))
    return H1, b1, c_d


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
