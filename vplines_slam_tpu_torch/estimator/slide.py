"""Track ingest, keyframe decision, marginalization and window slide.

Port of ``vplines_slam_tpu/estimator/slide.py``: masked gathers over
fixed-capacity point and line tables, no reallocation.  The line tables
shift with the window in both layouts (empty tables shift to themselves);
only the lines layout ingests line observations or marginalizes line
columns.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..models import imu as imu_mod
from ..solver import lm as lm_mod
from ..solver import marginalization as marg_mod
from ..utils.geometry import cross, quat_conj, quat_rotate
from ..utils.tree import tree_map
from .linearize import window_blocks
from .window import (
    TrackData,
    WindowConfig,
    WindowState,
    _first_obs,
    camera_poses,
    layout_for,
    retract_all,
    window_residuals,
)


def _set_row(a, k, v):
    """a with a[k] replaced by v (out of place; k a Python int, so no index
    is copied from the host: such a copy synchronizes)."""
    return torch.cat([a[:k], v.unsqueeze(0).to(a.dtype), a[k + 1:]])


def _set_col(a, k, v):
    """a with a[:, k] replaced by v (out of place; k a Python int)."""
    return torch.cat([a[:, :k], v.unsqueeze(1).to(a.dtype), a[:, k + 1:]], dim=1)


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------


def _assign_slots(table_ids, in_ids):
    """Match incoming ids to table slots; allocate free slots for new ids in
    order.  Returns (slots per incoming item, new table ids, has [P], src [P])."""
    P = table_ids.shape[0]
    valid_in = in_ids >= 0
    eq = (in_ids[:, None] == table_ids[None, :]) & valid_in[:, None]
    matched = torch.any(eq, dim=1)
    match_slot = torch.argmax(eq.to(torch.uint8), dim=1)
    free = table_ids < 0
    free_rank = torch.cumsum(free.long(), 0) - 1
    need = valid_in & ~matched
    need_rank = torch.cumsum(need.long(), 0) - 1
    n_free = torch.sum(free.long())
    free_slot_of_rank = torch.argmax(
        ((free_rank[None, :] == need_rank[:, None]) & free[None, :]).to(torch.uint8), dim=1)
    can_alloc = need & (need_rank < n_free)
    minus1 = torch.full_like(match_slot, -1)
    slots = torch.where(matched, match_slot, torch.where(can_alloc, free_slot_of_rank, minus1))
    assigned = (slots[:, None] == torch.arange(P, device=slots.device)[None, :]) & (
        slots >= 0)[:, None]
    has = torch.any(assigned, dim=0)
    src = torch.argmax(assigned.to(torch.uint8), dim=0)
    new_ids = torch.where(has, in_ids[src], table_ids)
    return slots, new_ids, has, src


def ingest_frame(data: TrackData, cfg: WindowConfig, frame_idx, pt_ids, pt_rays,
                 ln_ids=None, ln_obs=None, ln_vps=None, ln_vp_valid=None):
    """Insert one frame's observations at window slot ``frame_idx``.
    pt_ids [M] (-1 pad); pt_rays [M, 3] normalized rays; the optional line
    channel: ln_ids [Ml], ln_obs [Ml, 4] endpoints, ln_vps [Ml, 3] VPs,
    ln_vp_valid [Ml]."""
    _, new_pt_ids, has, src = _assign_slots(data.pt_id, pt_ids)
    obs_col = torch.where(has[:, None], pt_rays[src].to(data.pt_obs.dtype),
                          data.pt_obs[:, frame_idx])
    newly = has & (data.pt_id != new_pt_ids)
    data = data._replace(
        pt_id=new_pt_ids,
        pt_obs=_set_col(data.pt_obs, frame_idx, obs_col),
        pt_mask=_set_col(data.pt_mask, frame_idx, data.pt_mask[:, frame_idx] | has),
        pt_start=torch.where(newly, torch.full_like(data.pt_start, frame_idx), data.pt_start),
        pt_solved=data.pt_solved & ~newly,
    )
    if ln_ids is None:
        return data
    _, new_ln_ids, lhas, lsrc = _assign_slots(data.ln_id, ln_ids)
    f = frame_idx
    col = lambda new, old: torch.where(lhas.view(-1, *[1] * (old.dim() - 1)),
                                       new.to(old.dtype), old)
    ln_vp, ln_vp_mask = data.ln_vp, data.ln_vp_mask
    if ln_vps is not None:
        ln_vp = _set_col(ln_vp, f, col(ln_vps[lsrc], ln_vp[:, f]))
        ln_vp_mask = _set_col(ln_vp_mask, f, col(ln_vp_valid[lsrc], ln_vp_mask[:, f]))
    return data._replace(
        ln_id=new_ln_ids,
        ln_obs=_set_col(data.ln_obs, f, col(ln_obs[lsrc], data.ln_obs[:, f])),
        ln_mask=_set_col(data.ln_mask, f, data.ln_mask[:, f] | lhas),
        ln_vp=ln_vp, ln_vp_mask=ln_vp_mask,
        ln_solved=data.ln_solved & ~(lhas & (data.ln_id != new_ln_ids)),
    )


def set_imu_interval(data: TrackData, k, dts, accs, gyrs, mask, ba=None, bg=None,
                     params=None):
    """Store the padded IMU batch of interval k -> k+1 and preintegrate it
    once at the given bias."""
    data = data._replace(
        imu_dt=_set_row(data.imu_dt, k, dts),
        imu_acc=_set_row(data.imu_acc, k, accs),
        imu_gyr=_set_row(data.imu_gyr, k, gyrs),
        imu_mask=_set_row(data.imu_mask, k, mask.bool()),
        imu_valid=_set_row(data.imu_valid, k, torch.ones((), dtype=torch.bool,
                                                         device=dts.device)),
    )
    if params is not None:
        z3 = torch.zeros(3, dtype=dts.dtype, device=dts.device)
        ba, bg = (z3 if b is None else b for b in (ba, bg))
        pre = imu_mod.preintegrate(dts[None], accs[None], gyrs[None], mask[None], ba[None],
                                   bg[None], params)
        data = data._replace(
            imu_pre=tree_map(lambda buf, v: _set_row(buf, k, v[0]), data.imu_pre, pre),
            imu_sqrt=_set_row(data.imu_sqrt, k, imu_mod.sqrt_information(pre)[0]),
        )
    return data


def repropagate_all(data: TrackData, state: WindowState, params):
    """Re-preintegrate every stored interval at the current per-frame biases
    (one batched call; used after initialization sets the gyro bias)."""
    n = data.imu_dt.shape[0]
    pre = imu_mod.preintegrate(data.imu_dt, data.imu_acc, data.imu_gyr, data.imu_mask,
                               state.ba[:n], state.bg[:n], params)
    return data._replace(imu_pre=pre, imu_sqrt=imu_mod.sqrt_information(pre))


def keyframe_parallax(data: TrackData, cfg: WindowConfig, frame_idx):
    """Mean parallax between frames frame_idx-2 and frame_idx-1 over tracks
    seen in both.  Returns (is_keyframe, parallax, n_tracked_in_new)."""
    f2, f1 = frame_idx - 2, frame_idx - 1
    co = data.pt_mask[:, f2] & data.pt_mask[:, f1] & (data.pt_id >= 0)
    d = torch.linalg.norm(data.pt_obs[:, f2, 0:2] - data.pt_obs[:, f1, 0:2], dim=-1)
    n = torch.sum(co.long())
    parallax = torch.sum(d * co) / torch.clamp(n, min=1)
    n_new = torch.sum((data.pt_mask[:, frame_idx] & (data.pt_id >= 0)).long())
    is_kf = (n < 20) | (parallax >= cfg.min_parallax)
    return is_kf, parallax, n_new


# ---------------------------------------------------------------------------
# marginalization of the oldest frame
# ---------------------------------------------------------------------------


def gauge_nullspace(state: WindowState, cfg: WindowConfig):
    """[nd, 4] basis of the unobservable directions: global translation and
    yaw (δp_k = α ẑ×p_k, δθ_k = α R_kᵀẑ, δv_k = α ẑ×v_k)."""
    nf, nd = cfg.nf, cfg.nd
    dtype, dev = state.p.dtype, state.p.device
    z = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    yaw = torch.cat([cross(z, state.p), quat_rotate(quat_conj(state.q), z),
                     cross(z, state.v), torch.zeros(nf, 6, dtype=dtype, device=dev)], 1)
    trans = torch.zeros(15, 3, dtype=dtype, device=dev)
    trans[0:3] = torch.eye(3, dtype=dtype, device=dev)
    frames = torch.cat([trans.expand(nf, 15, 3), yaw[..., None]], dim=2).reshape(15 * nf, 4)
    return torch.cat([frames, torch.zeros(nd - 15 * nf, 4, dtype=dtype, device=dev)])


def _absorbed_points(data: TrackData):
    """Point tracks whose information marginalize_old folds into the prior
    (the same predicate drives the post-slide retirement)."""
    return (data.pt_start == 0) & (data.pt_id >= 0) & data.pt_solved


def _absorbed_lines(data: TrackData, cfg: WindowConfig):
    """Lines whose factors marginalize_old folds into the prior (with
    cfg.marg_lines), gated by line_min_obs as the line residuals are."""
    n_obs = torch.sum(data.ln_mask.long(), dim=1)
    return ((_first_obs(data.ln_mask) == 0) & (data.ln_id >= 0) & data.ln_solved
            & (n_obs >= cfg.line_min_obs))


def marginalize_old(state: WindowState, data: TrackData, cfg: WindowConfig,
                    params: imu_mod.ImuParams, use_lines: bool = False) -> marg_mod.Prior:
    """Square-root prior from all factors touching frame 0: previous prior +
    IMU(0,1) + point factors anchored at frame 0 and, in the lines layout
    with cfg.marg_lines, line factors of lines first seen at frame 0 (relo
    and VP factors never enter)."""
    data_r = marginalization_stack(data, cfg)
    x0 = (state, data.pt_inv_depth) + ((data.ln_orth,) if use_lines else ())
    stack_prior = _stack_prior_blocks if state.p.is_cuda else stack_prior_plain
    Jp, rp, r0 = stack_prior(x0, data_r, cfg, params, use_lines)
    Jp = marg_mod.project_out_nullspace(Jp, gauge_nullspace(state, cfg))
    nd = cfg.nd
    # χ²-capped prior: scale by α = min(1, cap / ms), ms the energy-weighted
    # mean whitened square Σr⁴/Σr² of the marginalized (non-prior) rows
    r2 = r0[nd:] * r0[nd:]
    ms = torch.sum(r2 * r2) / torch.clamp(torch.sum(r2), min=1e-12)
    alpha = torch.clamp(cfg.prior_chi2_cap / torch.clamp(ms, min=1e-9), max=1.0)
    return marg_mod.Prior(J=Jp * alpha, r0=rp * alpha,
                          valid=torch.ones((), dtype=torch.bool, device=Jp.device))


def _stack_prior_blocks(x0, data_r, cfg, params, use_lines):
    """The marginalization stack's √-prior on the dense block from its
    Jacobian blocks (K11), their block normal equations (K12) and stage 1
    (K14): (J_prior [nd, nd], r_prior [nd], the stack's residuals)."""
    blocks = window_blocks(x0, data_r, cfg, params, use_relo=False, use_vps=False)
    ne = lm_mod.assemble_blocks(blocks, layout_for(cfg, use_lines, use_relo=False, use_vps=False))
    Jp, rp = marg_mod.marginalize_window_blocks(*ne[:2], cfg.nd, 0, 15, *ne[2:5], *ne[5:],
                                                out_dtype=x0[0].p.dtype)
    return Jp, rp, blocks.r


def stack_prior_plain(x0, data_r, cfg, params, use_lines):
    """The twin of ``_stack_prior_blocks``: the stack's dense Jacobian by
    ``jacfwd`` and ``marginalize_window``.  CPU tensors take it: the clip
    gates and the nullspace projection carry last-bit differences of the
    prior into later costs at the 1e-5 level, and the parity tests hold the
    port to the reference through this route's rounding."""
    lm_mod.TWIN_CALLS["marg_stack"] += 1
    zero = torch.zeros(cfg.n_columns(use_lines), dtype=x0[0].p.dtype, device=x0[0].p.device)

    def r_of(d):
        return window_residuals(retract_all(x0, d, cfg), data_r, cfg, params, use_relo=False,
                                use_vps=False)

    r0 = r_of(zero)
    J = jacfwd(r_of)(zero)
    Jp, rp = marg_mod.marginalize_window(
        J, r0, cfg.nd, dense_start=0, dense_size=15, n_points=cfg.max_points,
        n_lines=cfg.max_lines if use_lines else 0)
    return Jp[:cfg.nd, :cfg.nd], rp[:cfg.nd], r0


def marginalization_stack(data: TrackData, cfg: WindowConfig) -> TrackData:
    """The tables whose residual stack (without relo and VP rows) is the
    marginalization's: IMU(0, 1), the point tracks marginalize_old absorbs
    and, with cfg.marg_lines, the lines first seen at frame 0 (without their
    frame-0 factor); everything else masked out."""
    anchored = _absorbed_points(data)
    imu_valid_r = torch.zeros_like(data.imu_valid)
    imu_valid_r[0] = data.imu_valid[0]
    if cfg.marg_lines:
        # the reference skips the j == 0 line factor (drop_set, :1327)
        ln_mask_r = data.ln_mask & _absorbed_lines(data, cfg)[:, None]
        ln_mask_r[:, 0] = False
    else:  # live-only lines: their factors never enter the prior
        ln_mask_r = torch.zeros_like(data.ln_mask)
    return data._replace(pt_mask=data.pt_mask & anchored[:, None], imu_valid=imu_valid_r,
                         ln_mask=ln_mask_r)


def _shift_frames(arr):
    """[NF, ...] shifted left by one; the last entry duplicated."""
    return torch.cat([arr[1:], arr[-1:]], dim=0)


def slide_window_old(state: WindowState, data: TrackData, cfg: WindowConfig,
                     params: imu_mod.ImuParams, new_prior: marg_mod.Prior):
    """Drop frame 0 after marginalization: retire absorbed tracks, re-anchor
    frame-0 depths to old frame 1, shift states/buffers, permute the prior."""
    nf = cfg.nf
    absorbed = _absorbed_points(data) if cfg.retire_points else torch.zeros_like(
        data.pt_solved)
    # retirement only makes sense for lines whose information was absorbed
    absorbed_ln = (_absorbed_lines(data, cfg) if cfg.retire_lines and cfg.marg_lines
                   else torch.zeros_like(data.ln_solved))
    data = data._replace(
        pt_id=torch.where(absorbed, torch.full_like(data.pt_id, -1), data.pt_id),
        pt_mask=data.pt_mask & ~absorbed[:, None],
        pt_solved=data.pt_solved & ~absorbed,
        ln_id=torch.where(absorbed_ln, torch.full_like(data.ln_id, -1), data.ln_id),
        ln_mask=data.ln_mask & ~absorbed_ln[:, None],
        ln_solved=data.ln_solved & ~absorbed_ln,
    )

    q_wc, p_wc = camera_poses(state)
    z0 = 1.0 / torch.clamp(data.pt_inv_depth, 1e-4, 1e4)
    X_w = quat_rotate(q_wc[0], data.pt_obs[:, 0] * z0[:, None]) + p_wc[0]
    z1 = quat_rotate(quat_conj(q_wc[1]), X_w - p_wc[1])[:, 2]
    was_anchor0 = (data.pt_start == 0) & (data.pt_id >= 0)
    keep_pt = (data.pt_id >= 0) & (torch.sum(data.pt_mask[:, 1:].long(), dim=1) >= 1)
    good_depth = z1 > 0.1
    inv_depth_new = torch.where(was_anchor0 & data.pt_solved & good_depth,
                                1.0 / torch.clamp(z1, 0.1, 1e4), data.pt_inv_depth)
    solved_new = torch.where(was_anchor0, data.pt_solved & good_depth, data.pt_solved)
    pt_start_new = torch.where(was_anchor0, torch.zeros_like(data.pt_start),
                               torch.clamp(data.pt_start - 1, min=0))
    # an anchor-0 track not seen at old frame 1 re-anchors at its first
    # remaining observation, unsolved
    first_rest = torch.argmax(data.pt_mask[:, 1:].to(torch.uint8), dim=1)
    lost1 = was_anchor0 & ~data.pt_mask[:, 1]
    pt_start_new = torch.where(lost1, first_rest, pt_start_new)
    solved_new = solved_new & ~lost1

    def shift_mask(m):
        return torch.cat([m[:, 1:], torch.zeros_like(m[:, -1:])], dim=1)

    def shift_obs(o):
        return torch.cat([o[:, 1:], o[:, -1:]], dim=1)

    keep_ln = (data.ln_id >= 0) & (torch.sum(data.ln_mask[:, 1:].long(), dim=1) >= 1)

    imu_dt = _shift_frames(data.imu_dt)
    imu_dt = _set_row(imu_dt, nf - 2, torch.zeros_like(imu_dt[-1]))
    imu_mask = _shift_frames(data.imu_mask)
    imu_mask = _set_row(imu_mask, nf - 2, torch.zeros_like(imu_mask[-1]))
    imu_valid = _shift_frames(data.imu_valid)
    imu_valid = _set_row(imu_valid, nf - 2, torch.zeros_like(imu_valid[-1]))
    data_new = data._replace(
        pt_id=torch.where(keep_pt, data.pt_id, torch.full_like(data.pt_id, -1)),
        pt_obs=shift_obs(data.pt_obs),
        pt_mask=shift_mask(data.pt_mask) & keep_pt[:, None],
        pt_start=pt_start_new,
        pt_inv_depth=inv_depth_new,
        pt_solved=solved_new & keep_pt,
        ln_id=torch.where(keep_ln, data.ln_id, torch.full_like(data.ln_id, -1)),
        ln_obs=shift_obs(data.ln_obs),
        ln_mask=shift_mask(data.ln_mask) & keep_ln[:, None],
        ln_vp=shift_obs(data.ln_vp),
        ln_vp_mask=shift_mask(data.ln_vp_mask) & keep_ln[:, None],
        ln_solved=data.ln_solved & keep_ln,
        imu_dt=imu_dt,
        imu_acc=_shift_frames(data.imu_acc),
        imu_gyr=_shift_frames(data.imu_gyr),
        imu_mask=imu_mask,
        imu_valid=imu_valid,
        imu_pre=tree_map(_shift_frames, data.imu_pre),
        imu_sqrt=_shift_frames(data.imu_sqrt),
        relo_mask=torch.zeros_like(data.relo_mask),
        relo_valid=torch.zeros_like(data.relo_valid),
        frame_t=_shift_frames(data.frame_t),
    )
    state_new = state._replace(
        p=_shift_frames(state.p), q=_shift_frames(state.q), v=_shift_frames(state.v),
        ba=_shift_frames(state.ba), bg=_shift_frames(state.bg),
    )
    # prior columns: new frame k <- old frame k+1; extrinsic/relo unchanged
    nd = cfg.nd
    dev = state.p.device
    perm = torch.cat([
        torch.arange(15, 15 * nf, device=dev), torch.full((15,), -1, device=dev),
        torch.arange(15 * nf, nd, device=dev)])
    prior_shifted = marg_mod.shift_prior(new_prior, perm)
    return state_new, data_new._replace(prior=prior_shifted, prior_state=state_new)


def slide_window_new(state: WindowState, data: TrackData, cfg: WindowConfig,
                     params: imu_mod.ImuParams = None):
    """Drop the second-newest frame (non-keyframe): merge its IMU samples into
    the previous interval, drop its observations and its prior dims, move
    the newest frame into its slot."""
    nf = cfg.nf
    s, n = nf - 2, nf - 1
    nd = cfg.nd
    dev = state.p.device

    # the prior alone: H = JᵀJ, g = -Jᵀr, no landmarks (stage 1 is K14)
    J64, r64 = data.prior.J.to(torch.float64), data.prior.r0.to(torch.float64)
    Jp, rp = marg_mod.marginalize_window_blocks(J64.T @ J64, -(J64.T @ r64), nd, 15 * s, 15,
                                                out_dtype=data.prior.J.dtype)
    Jp = marg_mod.project_out_nullspace(Jp, gauge_nullspace(data.prior_state, cfg))
    perm = torch.arange(nd, device=dev)
    perm[15 * s: 15 * (s + 1)] = -1
    prior_new = marg_mod.shift_prior(marg_mod.Prior(J=Jp, r0=rp, valid=data.prior.valid), perm)

    # merged interval (s-1 -> n) at slot s-1: built at 2x capacity, decimated
    # 2:1 (adjacent dt summed) when the union exceeds the capacity
    I = cfg.max_imu
    cnt_a = torch.sum(data.imu_mask[s - 1].long())
    cnt_b = torch.sum(data.imu_mask[s].long())
    idx2 = torch.arange(2 * I, device=dev)
    from_a = idx2 < cnt_a
    src_c = torch.clamp(idx2 - cnt_a, 0, I - 1)
    take = (idx2 >= cnt_a) & (idx2 - cnt_a < cnt_b)
    dt_a = data.imu_dt[s - 1][torch.clamp(idx2, 0, I - 1)]
    dt2 = torch.where(from_a, dt_a, torch.where(take, data.imu_dt[s][src_c],
                                                torch.zeros_like(dt_a)))
    mask2 = torch.where(from_a, data.imu_mask[s - 1][torch.clamp(idx2, 0, I - 1)], take)
    idx21 = torch.arange(2 * I + 1, device=dev)
    from_a1 = (idx21 < cnt_a)[:, None]
    srcA = torch.clamp(idx21, 0, I)
    src1_c = torch.clamp(idx21 - cnt_a, 0, I)
    acc2 = torch.where(from_a1, data.imu_acc[s - 1][srcA], data.imu_acc[s][src1_c])
    gyr2 = torch.where(from_a1, data.imu_gyr[s - 1][srcA], data.imu_gyr[s][src1_c])
    total = cnt_a + cnt_b
    overflow = total > I
    tclamp = torch.clamp(total, 0, 2 * I)
    past = (idx21 > total)[:, None]
    acc2 = torch.where(past, acc2[tclamp][None, :], acc2)
    gyr2 = torch.where(past, gyr2[tclamp][None, :], gyr2)

    dt_m = torch.where(overflow, dt2[0::2] + dt2[1::2], dt2[:I])
    mask_new = torch.where(overflow, mask2[0::2], mask2[:I])
    acc_m = torch.where(overflow, acc2[0::2][: I + 1], acc2[: I + 1])
    gyr_m = torch.where(overflow, gyr2[0::2][: I + 1], gyr2[: I + 1])

    imu_dt = _set_row(_set_row(data.imu_dt, s - 1, dt_m), s, torch.zeros_like(dt_m))
    imu_acc = _set_row(data.imu_acc, s - 1, acc_m)
    imu_gyr = _set_row(data.imu_gyr, s - 1, gyr_m)
    imu_mask = _set_row(_set_row(data.imu_mask, s - 1, mask_new), s,
                        torch.zeros_like(mask_new))
    imu_valid = _set_row(_set_row(data.imu_valid, s - 1,
                                  data.imu_valid[s - 1] & data.imu_valid[s]),
                         s, torch.zeros_like(data.imu_valid[s]))
    imu_pre, imu_sqrt = data.imu_pre, data.imu_sqrt
    if params is not None:
        pre_m = imu_mod.preintegrate(dt_m[None], acc_m[None], gyr_m[None], mask_new[None],
                                     state.ba[s - 1:s], state.bg[s - 1:s], params)
        imu_pre = tree_map(lambda buf, v: _set_row(buf, s - 1, v[0]), imu_pre, pre_m)
        imu_sqrt = _set_row(imu_sqrt, s - 1, imu_mod.sqrt_information(pre_m)[0])

    # observations: frame s loses its obs, frame n's move into slot s
    def drop_shift(obs, mask):
        return (_set_col(obs, s, obs[:, n]),
                _set_col(_set_col(mask, s, mask[:, n]), n, torch.zeros_like(mask[:, n])))

    pt_obs, pt_mask = drop_shift(data.pt_obs, data.pt_mask)
    ln_obs, ln_mask = drop_shift(data.ln_obs, data.ln_mask)
    ln_vp, ln_vp_mask = drop_shift(data.ln_vp, data.ln_vp_mask)
    pt_start = torch.where(data.pt_start == n, torch.full_like(data.pt_start, s),
                           data.pt_start)
    keep_pt = (data.pt_id >= 0) & (torch.sum(pt_mask.long(), dim=1) >= 1)
    keep_ln = (data.ln_id >= 0) & (torch.sum(ln_mask.long(), dim=1) >= 1)
    data_new = data._replace(
        pt_obs=pt_obs, pt_mask=pt_mask & keep_pt[:, None], pt_start=pt_start,
        pt_id=torch.where(keep_pt, data.pt_id, torch.full_like(data.pt_id, -1)),
        pt_solved=data.pt_solved & keep_pt,
        ln_obs=ln_obs, ln_mask=ln_mask & keep_ln[:, None],
        ln_vp=ln_vp, ln_vp_mask=ln_vp_mask & keep_ln[:, None],
        ln_id=torch.where(keep_ln, data.ln_id, torch.full_like(data.ln_id, -1)),
        ln_solved=data.ln_solved & keep_ln,
        imu_dt=imu_dt, imu_acc=imu_acc, imu_gyr=imu_gyr, imu_mask=imu_mask,
        imu_valid=imu_valid, imu_pre=imu_pre, imu_sqrt=imu_sqrt,
        relo_mask=torch.zeros_like(data.relo_mask),
        relo_valid=torch.zeros_like(data.relo_valid),
        frame_t=_set_row(data.frame_t, s, data.frame_t[n]),
        prior=prior_new,
    )
    state_new = state._replace(
        p=_set_row(state.p, s, state.p[n]), q=_set_row(state.q, s, state.q[n]),
        v=_set_row(state.v, s, state.v[n]), ba=_set_row(state.ba, s, state.ba[n]),
        bg=_set_row(state.bg, s, state.bg[n]),
    )
    return state_new, data_new
