"""Levenberg-Marquardt on the window residual layout, with Schur elimination
of the point inverse depths.

Port of the window path of ``vplines_slam_tpu/solver/lm.py``
(``lm_solve_window``, ``_structured_linearize``, ``_assemble_blocks``,
``schur_solve_blocks``, ``_solve_dtype``) for the points-only layout: the
residual stack has no line/VP rows and the parameter vector no line columns.
With empty line tables the reference's line blocks are exactly zero (H_dl = 0,
g_l = 0), so leaving them out changes no solve.

The linearization is ``torch.func.jvp`` under ``torch.func.vmap`` over
nd + 1 tangents (nd dense unit tangents plus one tangent of ones over every
inverse depth: each residual row depends on at most one point, so a single
jvp recovers all point columns).  The accept/reject is branchless
(``torch.where``), as in the reference: no host sync inside the solve.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jvp, vmap

from ..utils.tree import tree_map, tree_leaves


class LMConfig(NamedTuple):
    num_iters: int = 8
    lambda_init: float = 1e-4
    lambda_down: float = 1.0 / 3.0
    lambda_up: float = 4.0
    lambda_min: float = 1e-10
    lambda_max: float = 1e6
    diag_floor: float = 1e-8


class LMResult(NamedTuple):
    x: object
    cost0: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    grad_norm: torch.Tensor


def _solve_dtype(dtype):
    """f32 normal equations are solved in f64: JᵀJ squares the condition
    number and f32 loses the weak (bias/velocity) directions.  The reference
    promotes only on its CPU backend (the TPU has no f64 LU/eigh); CUDA has
    f64 Cholesky and eigh, so the port promotes on CPU and CUDA alike."""
    return torch.float64 if dtype == torch.float32 else dtype


class WindowLayout(NamedTuple):
    """Row/column layout of the points-only window residual stack:
    [prior nd | imu (nf-1)·15 | points P·nf·2 | relo P·2]; columns
    [dense nd | inverse depths P]."""

    nd: int
    nf: int
    P: int

    def segments(self):
        return [("prior", self.nd), ("imu", (self.nf - 1) * 15),
                ("points", self.P * self.nf * 2), ("relo", self.P * 2)]

    def slices(self):
        out = {}
        o = 0
        for name, n in self.segments():
            out[name] = slice(o, o + n)
            o += n
        out["_total"] = o
        return out


def _structured_linearize(residual_fn, retract_fn, x, layout: WindowLayout):
    """(r0 [R], J_d [R, nd], col_p [R]) via nd + 1 jvps."""
    nd, P = layout.nd, layout.P
    N = nd + P
    leaf = tree_leaves(x)[0]
    zero = torch.zeros(N, dtype=leaf.dtype, device=leaf.device)
    r0 = residual_fn(retract_fn(x, zero))

    def f(d):
        return residual_fn(retract_fn(x, d))

    T = torch.zeros(nd + 1, N, dtype=leaf.dtype, device=leaf.device)
    T[:nd, :nd] = torch.eye(nd, dtype=leaf.dtype, device=leaf.device)
    T[nd, nd:] = 1.0
    outs = vmap(lambda t: jvp(f, (zero,), (t,))[1])(T)  # [nd+1, R]
    return r0, outs[:nd].T, outs[nd]


def _assemble_blocks(r0, J_d, col_p, layout: WindowLayout):
    """Block normal equations (H_dd, g_d, H_dp, h_p, g_p)."""
    nd, P = layout.nd, layout.P
    sl = layout.slices()
    H_dd = J_d.T @ J_d
    g_d = -(J_d.T @ r0)
    # point and relo rows share their slot's inverse depth
    segs_p = ("points", "relo")
    cp = torch.cat([col_p[sl[s]].reshape(P, -1) for s in segs_p], dim=1)
    Jp_d = torch.cat([J_d[sl[s]].reshape(P, -1, nd) for s in segs_p], dim=1)
    rp = torch.cat([r0[sl[s]].reshape(P, -1) for s in segs_p], dim=1)
    h_p = torch.sum(cp * cp, dim=1)
    H_dp = torch.einsum("prd,pr->dp", Jp_d, cp)
    g_p = -torch.sum(cp * rp, dim=1)
    return H_dd, g_d, H_dp, h_p, g_p


def _jacobi(d):
    return torch.where(d > 1e-30, torch.sqrt(torch.clamp(d, min=1e-30)), torch.ones_like(d))


def schur_solve_blocks(H_dd, g_d, H_dp, h_p, g_p, lam, diag_floor=1e-8):
    """Damped, Jacobi-preconditioned Schur solve on the block normal
    equations; returns the delta [nd + P] in the input dtype.  A Cholesky
    that fails gives NaN (as JAX's does), so the LM step is then rejected."""
    out_dtype = H_dd.dtype
    sd = _solve_dtype(out_dtype)
    H_dd, g_d, H_dp, h_p, g_p = (t.to(sd) for t in (H_dd, g_d, H_dp, h_p, g_p))
    lam = torch.as_tensor(lam, dtype=sd, device=H_dd.device)
    P = h_p.shape[0]

    d_dd = torch.diagonal(H_dd)
    c_d = _jacobi(d_dd)
    c_p = _jacobi(h_p)
    H_dd = H_dd / (c_d[:, None] * c_d[None, :])
    g_d = g_d / c_d
    s_dd = d_dd / (c_d * c_d)
    S = H_dd + torch.diag(lam * s_dd + diag_floor)
    rhs = g_d
    if P:
        Hdp = H_dp / (c_d[:, None] * c_p[None, :])
        s_p = h_p / (c_p * c_p)
        wp = 1.0 / (s_p + lam * s_p + diag_floor)
        gp_s = g_p / c_p
        S = S - (Hdp * wp[None, :]) @ Hdp.T
        rhs = rhs - Hdp @ (wp * gp_s)
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    dd = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    parts = [dd / c_d]
    if P:
        parts.append(wp * (gp_s - Hdp.T @ dd) / c_p)
    return torch.cat(parts).to(out_dtype)


def lm_solve_window(residual_fn: Callable, retract_fn: Callable, x0,
                    layout: WindowLayout, config: LMConfig = LMConfig()) -> LMResult:
    """Fixed-iteration LM with branchless accept/reject."""

    def cost_of(x):
        r = residual_fn(x)
        return 0.5 * torch.dot(r, r)

    cost0 = cost_of(x0)
    x, cost = x0, cost0
    lam = torch.as_tensor(config.lambda_init, dtype=cost0.dtype, device=cost0.device)
    gnorm = torch.zeros_like(cost0)
    for _ in range(config.num_iters):
        r0, J_d, col_p = _structured_linearize(residual_fn, retract_fn, x, layout)
        blocks = _assemble_blocks(r0, J_d, col_p, layout)
        delta = schur_solve_blocks(*blocks, lam, config.diag_floor)
        x_new = retract_fn(x, delta)
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        x = tree_map(lambda a, b: torch.where(accept, b, a), x, x_new)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.clamp(
            torch.where(accept, lam * config.lambda_down, lam * config.lambda_up),
            config.lambda_min, config.lambda_max)
        gnorm = torch.linalg.norm(blocks[1])
    return LMResult(x=x, cost0=cost0, cost=cost, lam=lam, grad_norm=gnorm)
