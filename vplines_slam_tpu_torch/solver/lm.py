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

The window LM works on ``WindowBlocks``: the residual stack and, per
observation, the compact block of its Jacobian (the columns the row depends
on).  Its three device ops dispatch by device: on CUDA tensors the
hand-written kernels K11 (the blocks, ``estimator/linearize.py``), K12
(``assemble_blocks``: the block normal equations, accumulated in f64,
``csrc/window_blocks.cu``) and K13 (``schur_solve_blocks``: the f64 Schur
solve, ``csrc/schur.cu``); on CPU tensors their plain twins: the blocks
gathered from ``_structured_linearize`` (``torch.func.jvp`` under
``torch.func.vmap``: nd dense unit tangents, one tangent of ones over every
inverse depth and, with lines, one over orth component k of every line;
each residual row depends on at most one landmark, so one jvp recovers all
such columns), ``_assemble_blocks`` on the blocks scattered back to dense
(in f64) and ``schur_solve_blocks_plain``.  ``TWIN_CALLS`` counts the twins'
calls.  The accept/reject is branchless (``torch.where``), as in the
reference: no host sync inside the solve.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, jvp, vmap

from .. import kernels
from ..utils.tree import tree_map, tree_leaves

# calls of the plain twins of K11-K14 on any device: "linearize" (vmap of
# jvp), "assemble", "schur", "marg_stage1" and "marg_stack" (the
# marginalization stack's jacfwd); a run on the card reads 0 for each
TWIN_CALLS = collections.Counter()


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
    layout has L = 0 and no line/VP rows; the marginalization stack has no
    VP and no relo rows."""

    nd: int
    nf: int
    P: int
    L: int = 0
    has_lines: bool = False
    has_vps: bool = False
    has_relo: bool = True

    def segments(self):
        segs = [("prior", self.nd), ("imu", (self.nf - 1) * 15),
                ("points", self.P * self.nf * 2)]
        if self.has_lines:
            segs.append(("lines", self.L * self.nf * 2))
        if self.has_vps:
            segs.append(("vps", self.L * self.nf * 2))
        if self.has_relo:
            segs.append(("relo", self.P * 2))
        return segs

    def slices(self):
        out = {}
        o = 0
        for name, n in self.segments():
            out[name] = slice(o, o + n)
            o += n
        out["_total"] = o
        return out


class WindowBlocks(NamedTuple):
    """The whitened residual stack and its Jacobian by observation: each row
    keeps the columns it depends on (K11's output, K12's input).

    Compact columns: an IMU interval k: frame k's 15 dims, then frame k+1's;
    a point observation (p, j): pose i = pt_start[p] (δp, δθ), pose j
    (δp, δθ), the extrinsic, the inverse depth; a relo row: pose i, the relo
    pose, the extrinsic, the inverse depth; a line or VP observation (l, j):
    pose j, the extrinsic, the line's 4 orth coordinates."""

    r: torch.Tensor  # [R] the layout's rows
    J_prior: torch.Tensor  # [nd, nd] the prior rows
    J_imu: torch.Tensor  # [nf-1, 15, 30]
    J_pt: torch.Tensor  # [P, nf, 2, 19]
    J_relo: Optional[torch.Tensor]  # [P, 2, 19] (None without relo rows)
    J_ln: Optional[torch.Tensor]  # [L, nf, 2, 16] (None without lines)
    J_vp: Optional[torch.Tensor]  # [L, nf, 2, 16] (None without VP rows)
    pt_start: torch.Tensor  # [P] anchor frame of each point slot


def _block_columns(layout: WindowLayout, pt_start):
    """Dense column of each compact column but the landmark ones: IMU
    [nf-1, 30], points [P, nf, 18], relo [P, 18], lines [nf, 12]."""
    nf, dev = layout.nf, pt_start.device
    a6 = torch.arange(6, device=dev)
    frames = torch.arange(nf, device=dev)
    ext = 15 * nf + a6
    imu = (15 * frames[:-1, None] + torch.arange(30, device=dev)[None])
    pose_i = (15 * pt_start[:, None] + a6)[:, None].expand(-1, nf, -1)
    pose_j = (15 * frames[:, None] + a6)[None].expand(pt_start.shape[0], -1, -1)
    pts = torch.cat([pose_i, pose_j, ext.expand_as(pose_j)], dim=2)
    relo = torch.cat([pose_i[:, 0], (15 * nf + 6 + a6).expand(pt_start.shape[0], -1),
                      ext.expand(pt_start.shape[0], -1)], dim=1)
    lines = torch.cat([15 * frames[:, None] + a6, ext.expand(nf, -1)], dim=1)
    return imu, pts, relo, lines


def _block_rows(layout: WindowLayout, device):
    """Row index of each family's rows: IMU [nf-1, 15], points [P, nf, 2],
    lines / VPs [L, nf, 2], relo [P, 2] (None where the layout has none)."""
    sl = layout.slices()
    nf, P, L = layout.nf, layout.P, layout.L
    ar = lambda name, *shape: (torch.arange(sl[name].start, sl[name].stop, device=device)
                               .reshape(*shape))
    return (ar("imu", nf - 1, 15), ar("points", P, nf, 2),
            ar("lines", L, nf, 2) if layout.has_lines else None,
            ar("vps", L, nf, 2) if layout.has_vps else None,
            ar("relo", P, 2) if layout.has_relo else None)


def gather_blocks(r0, J_d, col_p, layout: WindowLayout, pt_start, cols_l=None) -> WindowBlocks:
    """The compact blocks of a dense linearization (K11's plain twin, after
    ``_structured_linearize``)."""
    nd = layout.nd
    c_imu, c_pt, c_relo, c_ln = _block_columns(layout, pt_start)
    r_imu, r_pt, r_ln, r_vp, r_relo = _block_rows(layout, r0.device)
    J_imu = J_d[r_imu[:, :, None], c_imu[:, None, :]]
    J_pt = torch.cat([J_d[r_pt[..., None], c_pt[:, :, None, :]], col_p[r_pt][..., None]], -1)
    J_relo = None if r_relo is None else torch.cat(
        [J_d[r_relo[..., None], c_relo[:, None, :]], col_p[r_relo][..., None]], -1)

    def line_rows(rows):
        if rows is None:
            return None
        return torch.cat([J_d[rows[..., None], c_ln[None, :, None, :]], cols_l[rows]], -1)

    return WindowBlocks(r=r0, J_prior=J_d[:nd], J_imu=J_imu, J_pt=J_pt, J_relo=J_relo,
                        J_ln=line_rows(r_ln), J_vp=line_rows(r_vp), pt_start=pt_start)


def blocks_to_dense(b: WindowBlocks, layout: WindowLayout):
    """(r0 [R], J_d [R, nd], col_p [R]) and with lines cols_l [R, 4]: the
    compact blocks scattered back to the dense linearization."""
    nd, R = layout.nd, layout.slices()["_total"]
    dt, dev = b.r.dtype, b.r.device
    c_imu, c_pt, c_relo, c_ln = _block_columns(layout, b.pt_start)
    r_imu, r_pt, r_ln, r_vp, r_relo = _block_rows(layout, dev)
    J_d = torch.zeros(R, nd, dtype=dt, device=dev)
    col_p = torch.zeros(R, dtype=dt, device=dev)
    J_d[:nd] = b.J_prior
    put = lambda rows, cols, vals: J_d.index_put_(
        torch.broadcast_tensors(rows, cols), vals, accumulate=True)
    put(r_imu[:, :, None], c_imu[:, None, :], b.J_imu)
    put(r_pt[..., None], c_pt[:, :, None, :], b.J_pt[..., :18])
    col_p[r_pt] = b.J_pt[..., 18]
    if r_relo is not None:
        put(r_relo[..., None], c_relo[:, None, :], b.J_relo[..., :18])
        col_p[r_relo] = b.J_relo[..., 18]
    if not layout.L:
        return b.r, J_d, col_p
    cols_l = torch.zeros(R, 4, dtype=dt, device=dev)
    for rows, J in ((r_ln, b.J_ln), (r_vp, b.J_vp)):
        if rows is not None:
            put(rows[..., None], c_ln[None, :, None, :], J[..., :12])
            cols_l[rows] = J[..., 12:]
    return b.r, J_d, col_p, cols_l


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
    segs_p = [seg for seg in ("points", "relo") if seg in sl]
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


_BLK_ARGS = kernels.args_struct(
    "VpBlkArgs",
    ["r", "J_prior", "J_imu", "J_pt", "J_relo", "J_ln", "J_vp", "pt_start",
     "H_dd", "g_d", "H_dp", "h_p", "g_p", "H_dl", "Hll", "g_l", "scratch"],
    ["nf", "P", "L", "has_relo", "has_lines", "has_vps", "off_imu", "off_pt", "off_ln",
     "off_vp", "off_relo", "is_double"])
WINDOW_BLOCKS = kernels.Kernel(
    "vp_window_blocks", "vplines_slam_tpu_torch/csrc/window_blocks.cu",
    "vplines_slam_tpu/solver/lm.py:243", [ctypes.POINTER(_BLK_ARGS)])
_SCHUR_ARGS = kernels.args_struct(
    "VpSchurArgs",
    ["H_dd", "g_d", "H_dp", "h_p", "g_p", "H_dl", "Hll", "g_l", "lam", "S", "rhs", "aux", "out"],
    ["nd", "P", "L", "out_double"], ["diag_floor"])
SCHUR_SOLVE = kernels.Kernel(
    "vp_schur_solve", "vplines_slam_tpu_torch/csrc/schur.cu",
    "vplines_slam_tpu/solver/lm.py:302", [ctypes.POINTER(_SCHUR_ARGS)])


def assemble_blocks(b: WindowBlocks, layout: WindowLayout):
    """Block normal equations of the window in f64: (H_dd, g_d, H_dp, h_p,
    g_p) and with lines (H_dl [nd, L, 4], Hll_b [L, 4, 4], g_l [L, 4]).  K12
    on CUDA tensors, ``assemble_blocks_plain`` on CPU tensors."""
    if b.r.is_cuda:
        return _assemble_blocks_cuda(b, layout)
    return assemble_blocks_plain(b, layout)


def assemble_blocks_plain(b: WindowBlocks, layout: WindowLayout):
    """K12's twin: ``_assemble_blocks`` on the dense scatter of the blocks,
    in f64 as the kernel."""
    TWIN_CALLS["assemble"] += 1
    dense = blocks_to_dense(b, layout)
    sd = _solve_dtype(b.r.dtype)
    dense = [t.to(sd) for t in dense]
    return _assemble_blocks(*dense[:3], layout, *dense[3:])


# frames of the largest window K12 takes: a slot chunk's nf + 3 column blocks
# in a 32-bit mask (csrc/window_blocks.cu)
WINDOW_BLOCKS_MAX_NF = 29


@functools.lru_cache(maxsize=None)
def window_blocks_scratch(nf, P, L, lines):
    """Doubles of scratch K12 passes from its first launch to its second
    (the prior and IMU terms of the observations' entries, the chunks'
    partials), from the kernel library's own plan."""
    fn = kernels.build().cdll.vp_window_blocks_scratch
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(nf, P, L, int(lines)))


def _assemble_blocks_cuda(b: WindowBlocks, layout: WindowLayout):
    """K12: two launches (the prior's band blocks with the IMU terms and the
    slot chunks' Grams; then the observations' entries of H_dd and g_d from
    the chunks' partials)."""
    dt, dev = b.r.dtype, b.r.device
    nd, nf, P, L = layout.nd, layout.nf, layout.P, layout.L
    if nf > WINDOW_BLOCKS_MAX_NF:
        raise ValueError(f"K12 takes windows of up to {WINDOW_BLOCKS_MAX_NF} frames (a slot "
                         f"chunk's column blocks in a 32-bit mask), got {nf}")
    sl = layout.slices()
    lines = layout.has_lines and L > 0
    e = lambda *shape: torch.empty(*shape, dtype=torch.float64, device=dev)
    outs = [e(nd, nd), e(nd), e(nd, P), e(P), e(P)]
    if lines:
        outs += [e(nd, L, 4), e(L, 4, 4), e(L, 4)]
    scratch = e(window_blocks_scratch(nf, P, L, lines))
    keep = []  # contiguous inputs stay referenced until the launch

    def ck(t, n, *shape, dtype=dt):
        if t is None:
            return None
        keep.append(t.contiguous())
        return kernels.check(keep[-1], n, dtype, shape=shape)

    start = lambda seg: sl[seg].start if seg in sl else -1
    args = _BLK_ARGS(
        ck(b.r, "r", sl["_total"]), ck(b.J_prior, "J_prior", nd, nd),
        ck(b.J_imu, "J_imu", nf - 1, 15, 30), ck(b.J_pt, "J_pt", P, nf, 2, 19),
        ck(b.J_relo if layout.has_relo else None, "J_relo", P, 2, 19),
        ck(b.J_ln if lines else None, "J_ln", L, nf, 2, 16),
        ck(b.J_vp if lines and layout.has_vps else None, "J_vp", L, nf, 2, 16),
        ck(b.pt_start, "pt_start", P, dtype=torch.int64),
        *[t.data_ptr() for t in outs], *([None] * (8 - len(outs))), scratch.data_ptr(),
        nf, P, L, int(layout.has_relo), int(lines), int(lines and layout.has_vps),
        start("imu"), start("points"), start("lines"), start("vps"), start("relo"),
        int(dt == torch.float64))
    WINDOW_BLOCKS(ctypes.byref(args))
    return tuple(outs)


def _jacobi(d):
    return torch.where(d > 1e-30, torch.sqrt(torch.clamp(d, min=1e-30)), torch.ones_like(d))


def schur_solve_blocks(H_dd, g_d, H_dp, h_p, g_p, lam, diag_floor=1e-8,
                       H_dl=None, Hll_b=None, g_l=None, out_dtype=None):
    """Damped, Jacobi-preconditioned Schur solve on the block normal
    equations (see ``schur_solve_blocks_plain``); the delta comes back in
    out_dtype (default: H_dd's).  K13 on CUDA tensors, the plain twin on
    CPU tensors."""
    if H_dd.is_cuda:
        return _schur_cuda(H_dd, g_d, H_dp, h_p, g_p, lam, diag_floor, H_dl, Hll_b, g_l,
                           out_dtype or H_dd.dtype)
    return schur_solve_blocks_plain(H_dd, g_d, H_dp, h_p, g_p, lam, diag_floor, H_dl, Hll_b,
                                    g_l, out_dtype)


def schur_solve_blocks_plain(H_dd, g_d, H_dp, h_p, g_p, lam, diag_floor=1e-8,
                             H_dl=None, Hll_b=None, g_l=None, out_dtype=None):
    """Damped, Jacobi-preconditioned Schur solve on the block normal
    equations: scalar point blocks and (when given) 4x4 line blocks are
    eliminated onto the dense block.  Returns the delta [nd + P (+ 4L)] in
    out_dtype (default: the input dtype).  A Cholesky that fails gives NaN
    (as JAX's does), so the LM step is then rejected."""
    TWIN_CALLS["schur"] += 1
    out_dtype = out_dtype or H_dd.dtype
    S, rhs, back = schur_system(H_dd, g_d, H_dp, h_p, g_p, lam, diag_floor, H_dl, Hll_b, g_l)
    dd = _cholesky_solve_or_nan(S, rhs)
    c_d, points, lines = back
    parts = [dd / c_d]
    if points is not None:
        Hdp, wp, gp_s, c_p = points
        parts.append(wp * (gp_s - Hdp.T @ dd) / c_p)
    if lines is not None:
        Hdl, Wl, gl_s, c_l = lines
        dl = torch.einsum("lkm,lm->lk", Wl, gl_s - torch.einsum("dlk,d->lk", Hdl, dd))
        parts.append((dl / c_l).reshape(-1))
    return torch.cat(parts).to(out_dtype)


def schur_system(H_dd, g_d, H_dp, h_p, g_p, lam, diag_floor=1e-8, H_dl=None, Hll_b=None,
                 g_l=None):
    """The reduced system of ``schur_solve_blocks_plain`` in the solve dtype:
    (S [nd, nd], rhs [nd], (c_d, point terms, line terms)) with the scaled
    couplings, inverses, rhs and scales the back-substitution needs."""
    sd = _solve_dtype(H_dd.dtype)
    H_dd, g_d, H_dp, h_p, g_p = (t.to(sd) for t in (H_dd, g_d, H_dp, h_p, g_p))
    lam = torch.as_tensor(lam, dtype=sd, device=H_dd.device)
    P = h_p.shape[0]
    L = 0 if Hll_b is None else Hll_b.shape[0]

    d_dd = torch.diagonal(H_dd)
    c_d = _jacobi(d_dd)
    H_dd = H_dd / (c_d[:, None] * c_d[None, :])
    g_d = g_d / c_d
    s_dd = d_dd / (c_d * c_d)
    S = H_dd + torch.diag(lam * s_dd + diag_floor)
    rhs = g_d
    points = lines = None
    if P:
        c_p = _jacobi(h_p)
        Hdp = H_dp / (c_d[:, None] * c_p[None, :])
        s_p = h_p / (c_p * c_p)
        wp = 1.0 / (s_p + lam * s_p + diag_floor)
        gp_s = g_p / c_p
        S = S - (Hdp * wp[None, :]) @ Hdp.T
        rhs = rhs - Hdp @ (wp * gp_s)
        points = (Hdp, wp, gp_s, c_p)
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
        lines = (Hdl, Wl, gl_s, c_l)
    return S, rhs, (c_d, points, lines)


SCHUR_SMEM_LIMIT = 232_448  # bytes of shared memory one CTA may use on the H100 (227 KB)
SchurPlan = collections.namedtuple("SchurPlan", "ndp tiles Kp smem aux")


def schur_plan(nd, P, L):
    """K13's sizes (``csrc/schur.cu``'s ``plan``): nd padded to 16, the
    16x16 lower tiles of S, K = P + 4L padded to 4, the factorization CTA's
    shared memory (the tiles, rhs, pivots' reciprocals, landmark t, a flag)
    and the doubles of the aux scratch.  Raises ValueError when the tiles do
    not fit in one CTA's shared memory."""
    ndp = -(-nd // 16) * 16
    tiles = (ndp // 16) * (ndp // 16 + 1) // 2
    Kp = -(-(P + 4 * L) // 4) * 4
    smem = 8 * (tiles * 256 + 2 * ndp + Kp + 1)
    if smem > SCHUR_SMEM_LIMIT:
        raise ValueError(
            f"schur_solve_blocks: nd {nd} (K {P + 4 * L}) needs {smem} bytes of shared memory "
            f"for K13's one-CTA factorization; the limit is {SCHUR_SMEM_LIMIT} bytes")
    return SchurPlan(ndp, tiles, Kp, smem, ndp + Kp + 2 * P + 20 * L + 2 * Kp * ndp)


def _schur_cuda(H_dd, g_d, H_dp, h_p, g_p, lam, diag_floor, H_dl, Hll_b, g_l, out_dtype,
                keep=None):
    """K13: the landmark terms and U, V once (launch 1), S's lower tiles and
    the rhs on the f64 MMA (launch 2), then one CTA's blocked Cholesky,
    substitutions and landmark back-substitution (launch 3); f64 inside,
    the delta in out_dtype (f32 or f64).  keep (a dict, for checks)
    receives launch 2's S tiles [tiles, 16, 16] and rhs [ndp]."""
    f64, dev = torch.float64, H_dd.device
    nd, P = H_dd.shape[0], h_p.shape[0]
    L = 0 if Hll_b is None else Hll_b.shape[0]
    plan = schur_plan(nd, P, L)
    if out_dtype not in (torch.float32, f64):
        raise ValueError(f"schur_solve_blocks: out_dtype {out_dtype} is not f32 or f64")
    ins = [t.to(f64).contiguous() for t in (H_dd, g_d, H_dp, h_p, g_p)]
    lins = [t.to(f64).contiguous() for t in (H_dl, Hll_b, g_l)] if L else [None] * 3
    lam_t = torch.as_tensor(lam, dtype=f64, device=dev).reshape(1)
    e = lambda n: torch.empty(n, dtype=f64, device=dev)
    S, rhs, aux = e(plan.tiles * 256), e(plan.ndp), e(plan.aux)
    out = torch.empty(nd + P + 4 * L, dtype=out_dtype, device=dev)
    ck = lambda t, n, *shape: kernels.check(t, n, f64, shape=shape)
    args = _SCHUR_ARGS(
        ck(ins[0], "H_dd", nd, nd), ck(ins[1], "g_d", nd), ck(ins[2], "H_dp", nd, P),
        ck(ins[3], "h_p", P), ck(ins[4], "g_p", P),
        *((ck(lins[0], "H_dl", nd, L, 4), ck(lins[1], "Hll_b", L, 4, 4), ck(lins[2], "g_l", L, 4))
          if L else (None, None, None)),
        ck(lam_t, "lam", 1), S.data_ptr(), rhs.data_ptr(), aux.data_ptr(), out.data_ptr(),
        nd, P, L, int(out_dtype == f64), float(diag_floor))
    SCHUR_SOLVE(ctypes.byref(args))
    if keep is not None:
        keep.update(S=S.view(plan.tiles, 16, 16), rhs=rhs)
    return out


def lm_solve_window(residual_fn: Callable, linearize_fn: Callable, retract_fn: Callable, x0,
                    layout: WindowLayout, config: LMConfig = LMConfig()) -> LMResult:
    """Fixed-iteration LM with branchless accept/reject.  linearize_fn(x) ->
    WindowBlocks; residual_fn(x) -> the residual stack [R] (the cost pass);
    retract_fn(x, delta) -> x'.  Each iteration: the blocks (K11), the block
    normal equations (K12), the Schur solve (K13), the retraction and the
    cost pass (K11, residuals only)."""

    def cost_of(x):
        r = residual_fn(x)
        return 0.5 * torch.dot(r, r)

    cost0 = cost_of(x0)
    x, cost = x0, cost0
    lam = torch.as_tensor(config.lambda_init, dtype=cost0.dtype, device=cost0.device)
    gnorm = torch.zeros_like(cost0)
    for _ in range(config.num_iters):
        ne = assemble_blocks(linearize_fn(x), layout)
        delta = schur_solve_blocks(*ne[:5], lam, config.diag_floor, *ne[5:],
                                   out_dtype=cost0.dtype)
        x_new = retract_fn(x, delta)
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        x = tree_map(lambda a, b: torch.where(accept, b, a), x, x_new)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.clamp(
            torch.where(accept, lam * config.lambda_down, lam * config.lambda_up),
            config.lambda_min, config.lambda_max)
        gnorm = torch.linalg.norm(ne[1]).to(cost0.dtype)
    return LMResult(x=x, cost0=cost0, cost=cost, lam=lam, grad_norm=gnorm)
