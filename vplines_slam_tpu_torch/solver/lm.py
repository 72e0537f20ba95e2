"""Levenberg-Marquardt on the window residual layout, with Schur elimination
of the landmarks (point inverse depths and 4-dof lines).

Port of ``vplines_slam_tpu/solver/lm.py``: the generic engine (``SchurSpec``,
``normal_equations``, ``schur_solve``, ``lm_solve``: a dense jacobian by
``torch.func.jacfwd``, used by the initializer's window SFM) and the window
path (``lm_solve_window``, ``WindowLayout``, ``_structured_linearize``,
``_assemble_blocks``, ``schur_solve_blocks``, ``_solve_dtype``).  Two window
layouts:
the points-only one (``L = 0``: no line/VP rows, no line columns, nd + 1
tangents) and the reference's lines layout (``L > 0``: line and VP rows,
4L line columns, nd + 5 tangents).

The linearization is ``torch.func.jvp`` under ``torch.func.vmap``: nd dense
unit tangents, one tangent of ones over every inverse depth and, with lines,
one tangent of ones over orth component k of every line (each residual row
depends on at most one landmark, so one jvp recovers all such columns).  The
accept/reject is branchless (``torch.where``), as in the reference: no host
sync inside the solve.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, jvp, vmap

from ..utils.tree import tree_map, tree_leaves


class SchurSpec(NamedTuple):
    """Parameter layout: [dense | n_scalar scalar blocks | n_block4 4-dof blocks]."""

    dense_dim: int
    n_scalar: int = 0
    n_block4: int = 0

    @property
    def total_dim(self):
        return self.dense_dim + self.n_scalar + 4 * self.n_block4


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


def normal_equations(J, r):
    """H = JᵀJ, g = -Jᵀr."""
    return J.T @ J, -(J.T @ r)


def _cholesky_solve_or_nan(S, rhs):
    """Cholesky solve of S x = rhs; NaN where the factorization fails (as
    JAX's does), so an LM step through it is rejected."""
    Lc, info = torch.linalg.cholesky_ex(S)
    Lc = torch.where(info == 0, Lc, torch.full_like(Lc, float("nan")))
    return torch.cholesky_solve(rhs[:, None], Lc)[:, 0]


def schur_solve(H, g, spec: SchurSpec, lam, diag_floor=1e-8):
    """Solve (H + λ·diag(H) + floor) δ = g with Jacobi scaling, eliminating
    the scalar and 4x4 landmark blocks onto the dense block first."""
    D, P, L = spec.dense_dim, spec.n_scalar, spec.n_block4
    out_dtype = H.dtype
    sd = _solve_dtype(H.dtype)
    H, g = H.to(sd), g.to(sd)
    lam = torch.as_tensor(lam, dtype=sd, device=H.device)
    dH = torch.diagonal(H)
    c = _jacobi(dH)
    H = H / (c[:, None] * c[None, :])
    g = g / c
    Hd = H + torch.diag(lam * torch.diagonal(H) + diag_floor)
    S, rhs = Hd[:D, :D], g[:D]
    if P > 0:
        Hdp = Hd[:D, D:D + P]
        wp = 1.0 / torch.diagonal(Hd)[D:D + P]
        g_p = g[D:D + P]
        S = S - (Hdp * wp[None, :]) @ Hdp.T
        rhs = rhs - Hdp @ (wp * g_p)
    if L > 0:
        Hdl = Hd[:D, D + P:].reshape(D, L, 4)
        idx = torch.arange(L, device=H.device)
        Hll_b = Hd[D + P:, D + P:].reshape(L, 4, L, 4)[idx, :, idx, :]
        g_l = g[D + P:].reshape(L, 4)
        Wl = torch.linalg.inv(Hll_b)
        S = S - torch.einsum("dlk,lkm,elm->de", Hdl, Wl, Hdl)
        rhs = rhs - torch.einsum("dlk,lkm,lm->d", Hdl, Wl, g_l)
    dd = _cholesky_solve_or_nan(S, rhs)
    parts = [dd]
    if P > 0:
        parts.append(wp * (g_p - Hdp.T @ dd))
    if L > 0:
        dl = torch.einsum("lkm,lm->lk", Wl, g_l - torch.einsum("dlk,d->lk", Hdl, dd))
        parts.append(dl.reshape(L * 4))
    return (torch.cat(parts) / c).to(out_dtype)


def lm_solve(residual_fn: Callable, retract_fn: Callable, x0, spec: SchurSpec,
             config: LMConfig = LMConfig()) -> LMResult:
    """Fixed-iteration LM with branchless accept/reject.  residual_fn(x) ->
    flat whitened residual [R]; retract_fn(x, delta [N]) -> x'."""
    r_first = residual_fn(x0)
    dtype, dev = r_first.dtype, r_first.device
    zero = torch.zeros(spec.total_dim, dtype=dtype, device=dev)

    def cost_of(x):
        r = residual_fn(x)
        return 0.5 * torch.dot(r, r)

    cost0 = 0.5 * torch.dot(r_first, r_first)
    x, cost = x0, cost0
    lam = torch.as_tensor(config.lambda_init, dtype=dtype, device=dev)
    gnorm = torch.zeros_like(cost0)
    for _ in range(config.num_iters):
        f = lambda d: residual_fn(retract_fn(x, d))
        H, g = normal_equations(jacfwd(f)(zero), f(zero))
        delta = schur_solve(H, g, spec, lam, config.diag_floor)
        x_new = retract_fn(x, delta)
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        x = tree_map(lambda a, b: torch.where(accept, b, a), x, x_new)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.clamp(
            torch.where(accept, lam * config.lambda_down, lam * config.lambda_up),
            config.lambda_min, config.lambda_max)
        gnorm = torch.linalg.norm(g)
    return LMResult(x=x, cost0=cost0, cost=cost, lam=lam, grad_norm=gnorm)


class WindowLayout(NamedTuple):
    """Row/column layout of the window residual stack: [prior nd | imu
    (nf-1)·15 | points P·nf·2 | lines L·nf·2 | vps L·nf·2 | relo P·2];
    columns [dense nd | inverse depths P | line orth 4L].  The points-only
    layout has L = 0 and no line/VP rows."""

    nd: int
    nf: int
    P: int
    L: int = 0
    has_lines: bool = False
    has_vps: bool = False

    def segments(self):
        segs = [("prior", self.nd), ("imu", (self.nf - 1) * 15),
                ("points", self.P * self.nf * 2)]
        if self.has_lines:
            segs.append(("lines", self.L * self.nf * 2))
        if self.has_vps:
            segs.append(("vps", self.L * self.nf * 2))
        return segs + [("relo", self.P * 2)]

    def slices(self):
        out = {}
        o = 0
        for name, n in self.segments():
            out[name] = slice(o, o + n)
            o += n
        out["_total"] = o
        return out


def _structured_linearize(residual_fn, retract_fn, x, layout: WindowLayout):
    """(r0 [R], J_d [R, nd], col_p [R]) via nd + 1 jvps; with line columns
    (layout.L > 0) also cols_l [R, 4], via nd + 5 jvps."""
    nd, P, L = layout.nd, layout.P, layout.L
    N = nd + P + 4 * L
    leaf = tree_leaves(x)[0]
    zero = torch.zeros(N, dtype=leaf.dtype, device=leaf.device)
    r0 = residual_fn(retract_fn(x, zero))

    def f(d):
        return residual_fn(retract_fn(x, d))

    n_line_tan = 4 if L else 0
    T = torch.zeros(nd + 1 + n_line_tan, N, dtype=leaf.dtype, device=leaf.device)
    T[:nd, :nd] = torch.eye(nd, dtype=leaf.dtype, device=leaf.device)
    T[nd, nd:nd + P] = 1.0
    for k in range(n_line_tan):
        T[nd + 1 + k, nd + P + k::4] = 1.0
    outs = vmap(lambda t: jvp(f, (zero,), (t,))[1])(T)  # [nd+1(+4), R]
    if not L:
        return r0, outs[:nd].T, outs[nd]
    return r0, outs[:nd].T, outs[nd], outs[nd + 1:].T


def _assemble_blocks(r0, J_d, col_p, layout: WindowLayout, cols_l=None):
    """Block normal equations (H_dd, g_d, H_dp, h_p, g_p), and with line
    columns also (H_dl [nd, L, 4], Hll_b [L, 4, 4], g_l [L, 4])."""
    nd, P, L = layout.nd, layout.P, layout.L
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
    if not L:
        return H_dd, g_d, H_dp, h_p, g_p
    # line and VP rows share their slot's 4-dof line
    segs_l = [s for s, on in (("lines", layout.has_lines), ("vps", layout.has_vps)) if on]
    cl = torch.cat([cols_l[sl[s]].reshape(L, -1, 4) for s in segs_l], dim=1)
    Jl_d = torch.cat([J_d[sl[s]].reshape(L, -1, nd) for s in segs_l], dim=1)
    rl = torch.cat([r0[sl[s]].reshape(L, -1) for s in segs_l], dim=1)
    Hll_b = torch.einsum("lrk,lrm->lkm", cl, cl)
    H_dl = torch.einsum("lrd,lrk->dlk", Jl_d, cl)
    g_l = -torch.einsum("lrk,lr->lk", cl, rl)
    return H_dd, g_d, H_dp, h_p, g_p, H_dl, Hll_b, g_l


def _jacobi(d):
    return torch.where(d > 1e-30, torch.sqrt(torch.clamp(d, min=1e-30)), torch.ones_like(d))


def schur_solve_blocks(H_dd, g_d, H_dp, h_p, g_p, lam, diag_floor=1e-8,
                       H_dl=None, Hll_b=None, g_l=None):
    """Damped, Jacobi-preconditioned Schur solve on the block normal
    equations: scalar point blocks and (when given) 4x4 line blocks are
    eliminated onto the dense block.  Returns the delta [nd + P (+ 4L)] in
    the input dtype.  A Cholesky that fails gives NaN (as JAX's does), so
    the LM step is then rejected."""
    out_dtype = H_dd.dtype
    sd = _solve_dtype(out_dtype)
    H_dd, g_d, H_dp, h_p, g_p = (t.to(sd) for t in (H_dd, g_d, H_dp, h_p, g_p))
    lam = torch.as_tensor(lam, dtype=sd, device=H_dd.device)
    P = h_p.shape[0]
    L = 0 if Hll_b is None else Hll_b.shape[0]

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
    if L:
        H_dl, Hll_b, g_l = (t.to(sd) for t in (H_dl, Hll_b, g_l))
        d_ll = torch.diagonal(Hll_b, dim1=1, dim2=2)  # [L, 4]
        c_l = _jacobi(d_ll)
        Hdl = H_dl / (c_d[:, None, None] * c_l[None, :, :])
        Hll_s = Hll_b / (c_l[:, :, None] * c_l[:, None, :])
        s_l = d_ll / (c_l * c_l)
        gl_s = g_l / c_l
        Wl = torch.linalg.inv_ex(Hll_s + torch.diag_embed(lam * s_l + diag_floor))[0]
        S = S - torch.einsum("dlk,lkm,elm->de", Hdl, Wl, Hdl)
        rhs = rhs - torch.einsum("dlk,lkm,lm->d", Hdl, Wl, gl_s)
    dd = _cholesky_solve_or_nan(S, rhs)
    parts = [dd / c_d]
    if P:
        parts.append(wp * (gp_s - Hdp.T @ dd) / c_p)
    if L:
        dl = torch.einsum("lkm,lm->lk", Wl, gl_s - torch.einsum("dlk,d->lk", Hdl, dd))
        parts.append((dl / c_l).reshape(4 * L))
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
        lin = _structured_linearize(residual_fn, retract_fn, x, layout)
        blocks = _assemble_blocks(*lin[:3], layout, *lin[3:])
        delta = schur_solve_blocks(*blocks[:5], lam, config.diag_floor, *blocks[5:])
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
