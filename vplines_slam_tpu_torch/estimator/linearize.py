"""The window's residual stack and its per-observation Jacobian blocks
(``solver.lm.WindowBlocks``): kernel K11 (``csrc/window_lin.cu``) and its
plain twin.

K11 replaces the reference's ``window_residuals`` differentiated by
``_structured_linearize`` (``vplines_slam_tpu/estimator/window.py:438``,
``vplines_slam_tpu/solver/lm.py:209``): one launch whose lanes each evaluate
an observation's residual on forward-mode jets seeded through the
retraction, with their own slice of its tangents, and write the whitened row
and their part of its compact block.  ``window_blocks`` gives the blocks
(the LM's linearization, the marginalization stack), ``window_cost_residuals``
the rows alone (the LM's cost pass).  On CUDA tensors both launch K11; on CPU
tensors the twin gathers the blocks from ``_structured_linearize`` (vmap of
jvp) and the cost pass is ``window_residuals``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..solver import lm as lm_mod
from . import window as win

_POINTERS = [
    "p", "q", "v", "ba", "bg", "p_ic", "q_ic", "p_relo", "q_relo", "inv_depth", "orth",
    "prior_J", "prior_r0", "prior_valid",
    "ps_p", "ps_q", "ps_v", "ps_ba", "ps_bg", "ps_p_ic", "ps_q_ic", "ps_p_relo", "ps_q_relo",
    "pre_dp", "pre_dq", "pre_dv", "pre_J", "pre_sum_dt", "pre_lba", "pre_lbg", "imu_sqrt",
    "imu_valid", "g",
    "pt_id", "pt_obs", "pt_mask", "pt_start", "pt_solved", "relo_obs", "relo_mask", "relo_valid",
    "ln_id", "ln_obs", "ln_vp", "ln_mask", "ln_vp_mask", "ln_solved",
    "r", "J_prior", "J_imu", "J_pt", "J_relo", "J_ln", "J_vp",
]
_INTS = ["nf", "P", "L", "use_relo", "use_lines", "use_vps", "with_j", "line_min_obs",
         "off_imu", "off_pt", "off_ln", "off_vp", "off_relo", "is_double"]
_DOUBLES = ["point_sqrt_info", "line_sqrt_info", "vp_sqrt_info", "huber_delta"]
_LIN_ARGS = kernels.args_struct("VpLinArgs", _POINTERS, _INTS, _DOUBLES)

WINDOW_LIN = kernels.Kernel(
    "vp_window_lin", "vplines_slam_tpu_torch/csrc/window_lin.cu",
    "vplines_slam_tpu/estimator/window.py:438", [ctypes.POINTER(_LIN_ARGS)])


def window_blocks(x, data: win.TrackData, cfg: win.WindowConfig, params,
                  use_relo: bool = True, use_vps: bool = True) -> lm_mod.WindowBlocks:
    """The residual stack at x and its Jacobian blocks in the retraction's
    tangent space (K11 on CUDA tensors, ``window_blocks_plain`` on CPU)."""
    if x[0].p.is_cuda:
        return _window_lin_cuda(x, data, cfg, params, use_relo, use_vps, True)
    return window_blocks_plain(x, data, cfg, params, use_relo, use_vps)


def window_cost_residuals(x, data: win.TrackData, cfg: win.WindowConfig, params,
                          use_relo: bool = True, use_vps: bool = True):
    """``window_residuals`` at x itself (K11's residual-only mode on CUDA)."""
    if x[0].p.is_cuda:
        return _window_lin_cuda(x, data, cfg, params, use_relo, use_vps, False)
    return win.window_residuals(x, data, cfg, params, use_relo, use_vps)


def window_blocks_plain(x, data, cfg, params, use_relo=True, use_vps=True):
    """K11's twin: ``_structured_linearize`` of ``window_residuals``, its
    dense rows gathered into the compact blocks."""
    lm_mod.TWIN_CALLS["linearize"] += 1
    layout = win.layout_for(cfg, len(x) == 3, use_relo, use_vps)
    lin = lm_mod._structured_linearize(
        lambda xx: win.window_residuals(xx, data, cfg, params, use_relo, use_vps),
        lambda xx, d: win.retract_all(xx, d, cfg), x, layout)
    return lm_mod.gather_blocks(*lin[:3], layout, data.pt_start, *lin[3:])


def _window_lin_cuda(x, data, cfg, params, use_relo, use_vps, with_j):
    """K11: one launch (block ranges for the prior rows, the IMU intervals,
    points + relo, lines + VPs) on the current stream.  Returns the blocks,
    or with_j=False the residual stack alone."""
    state, inv_depth = x[0], x[1]
    orth = x[2] if len(x) == 3 else None
    use_lines = orth is not None
    dt, dev = state.p.dtype, state.p.device
    nf, nd, P, L = cfg.nf, cfg.nd, cfg.max_points, cfg.max_lines
    layout = win.layout_for(cfg, use_lines, use_relo, use_vps)
    sl = layout.slices()
    keep = []  # converted inputs stay referenced until the launch

    def f(t, name, shape, dtype=dt):
        if t is None:
            return None
        t = t.to(dtype).contiguous()
        keep.append(t)
        return kernels.check(t, name, dtype, shape=shape)

    b8, i64 = torch.bool, torch.int64
    e = lambda *shape: torch.empty(*shape, dtype=dt, device=dev)
    r = e(sl["_total"])
    outs = dict(r=r)
    if with_j:
        outs.update(J_prior=e(nd, nd), J_imu=e(nf - 1, 15, 30), J_pt=e(P, nf, 2, 19),
                    J_relo=e(P, 2, 19) if use_relo else None,
                    J_ln=e(L, nf, 2, 16) if use_lines else None,
                    J_vp=e(L, nf, 2, 16) if use_lines and use_vps else None)
    ps, pre, prior = data.prior_state, data.imu_pre, data.prior
    ptr = lambda name: None if outs.get(name) is None else outs[name].data_ptr()
    args = _LIN_ARGS(
        f(state.p, "p", (nf, 3)), f(state.q, "q", (nf, 4)), f(state.v, "v", (nf, 3)),
        f(state.ba, "ba", (nf, 3)), f(state.bg, "bg", (nf, 3)), f(state.p_ic, "p_ic", (3,)),
        f(state.q_ic, "q_ic", (4,)), f(state.p_relo, "p_relo", (3,)),
        f(state.q_relo, "q_relo", (4,)), f(inv_depth, "inv_depth", (P,)),
        f(orth, "orth", (L, 4)),
        f(prior.J, "prior_J", (nd, nd)), f(prior.r0, "prior_r0", (nd,)),
        f(prior.valid.reshape(1), "prior_valid", (1,), b8),
        f(ps.p, "ps_p", (nf, 3)), f(ps.q, "ps_q", (nf, 4)), f(ps.v, "ps_v", (nf, 3)),
        f(ps.ba, "ps_ba", (nf, 3)), f(ps.bg, "ps_bg", (nf, 3)), f(ps.p_ic, "ps_p_ic", (3,)),
        f(ps.q_ic, "ps_q_ic", (4,)), f(ps.p_relo, "ps_p_relo", (3,)),
        f(ps.q_relo, "ps_q_relo", (4,)),
        f(pre.delta_p, "pre_dp", (nf - 1, 3)), f(pre.delta_q, "pre_dq", (nf - 1, 4)),
        f(pre.delta_v, "pre_dv", (nf - 1, 3)), f(pre.jacobian, "pre_J", (nf - 1, 15, 15)),
        f(pre.sum_dt, "pre_sum_dt", (nf - 1,)), f(pre.linearized_ba, "pre_lba", (nf - 1, 3)),
        f(pre.linearized_bg, "pre_lbg", (nf - 1, 3)),
        f(data.imu_sqrt, "imu_sqrt", (nf - 1, 15, 15)),
        f(data.imu_valid, "imu_valid", (nf - 1,), b8), f(params.g, "g", (3,)),
        f(data.pt_id, "pt_id", (P,), i64), f(data.pt_obs, "pt_obs", (P, nf, 3)),
        f(data.pt_mask, "pt_mask", (P, nf), b8), f(data.pt_start, "pt_start", (P,), i64),
        f(data.pt_solved, "pt_solved", (P,), b8), f(data.relo_obs, "relo_obs", (P, 3)),
        f(data.relo_mask, "relo_mask", (P,), b8),
        f(data.relo_valid.reshape(1), "relo_valid", (1,), b8),
        f(data.ln_id, "ln_id", (L,), i64), f(data.ln_obs, "ln_obs", (L, nf, 4)),
        f(data.ln_vp, "ln_vp", (L, nf, 3)), f(data.ln_mask, "ln_mask", (L, nf), b8),
        f(data.ln_vp_mask, "ln_vp_mask", (L, nf), b8), f(data.ln_solved, "ln_solved", (L,), b8),
        ptr("r"), ptr("J_prior"), ptr("J_imu"), ptr("J_pt"), ptr("J_relo"),
        ptr("J_ln"), ptr("J_vp"),
        nf, P, L, int(use_relo), int(use_lines), int(use_lines and use_vps), int(with_j),
        cfg.line_min_obs, sl["imu"].start, sl["points"].start,
        sl["lines"].start if "lines" in sl else -1, sl["vps"].start if "vps" in sl else -1,
        sl["relo"].start if "relo" in sl else -1, int(dt == torch.float64),
        float(cfg.point_sqrt_info), float(cfg.line_sqrt_info), float(cfg.vp_sqrt_info),
        float(cfg.huber_delta))
    WINDOW_LIN(ctypes.byref(args))
    if not with_j:
        return r
    return lm_mod.WindowBlocks(r=r, J_prior=outs["J_prior"], J_imu=outs["J_imu"],
                               J_pt=outs["J_pt"], J_relo=outs["J_relo"], J_ln=outs["J_ln"],
                               J_vp=outs["J_vp"], pt_start=data.pt_start)
