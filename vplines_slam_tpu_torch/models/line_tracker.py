"""Line-feature front-end: detect -> h/v caps -> match -> ids -> VPs.

Port of ``vplines_slam_tpu/models/line_tracker.py`` (``step`` on an already
undistorted frame; ``LineTrackerFrontend``, the host wrapper, is not
ported).  CLAHE (``equalize=True``) is not ported yet.

The reference's ``lax.cond`` on ``has_prev`` is a masked ``torch.where``
here: the matcher runs on every frame and its result is dropped on the
first one, so the step needs no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import camera as cam_mod
from ..ops import line_match as lmatch_mod
from ..ops import lines as lines_mod
from ..ops import vp as vp_mod


class LineTrackerConfig(NamedTuple):
    max_lines: int = 64  # track capacity
    max_h: int = 40  # max_h_lines cap
    max_v: int = 40  # max_v_lines cap
    detect: lines_mod.LineDetectConfig = lines_mod.LineDetectConfig()
    match: lmatch_mod.LineMatchConfig = lmatch_mod.LineMatchConfig()
    vp: vp_mod.VPConfig = vp_mod.VPConfig()
    equalize: bool = False  # CLAHE is not ported: must stay False
    use_vp: bool = True


class LineTrackerState(NamedTuple):
    segs: torch.Tensor  # [L, 4] pixel endpoints (undistorted image)
    ids: torch.Tensor  # [L] int64 (-1 empty)
    next_id: torch.Tensor  # [] int64
    prev_img: torch.Tensor  # [H, W]
    has_prev: torch.Tensor  # [] bool
    vps_prev: torch.Tensor  # [3, 3]
    had_vps: torch.Tensor  # [] bool


class LineTrackerOutput(NamedTuple):
    ids: torch.Tensor  # [L]
    endpoints: torch.Tensor  # [L, 4] normalized-plane (u1, v1, u2, v2)
    vp_dirs: torch.Tensor  # [L, 3] homogeneous VP on the normalized plane
    vp_valid: torch.Tensor  # [L]
    segs_px: torch.Tensor  # [L, 4] pixel endpoints
    valid: torch.Tensor  # [L]


def init_state(cfg: LineTrackerConfig, H, W, dtype=torch.float32,
               device=torch.device("cuda")) -> LineTrackerState:
    L = cfg.max_lines
    return LineTrackerState(
        segs=torch.zeros(L, 4, dtype=dtype, device=device),
        ids=torch.full((L,), -1, dtype=torch.long, device=device),
        next_id=torch.zeros((), dtype=torch.long, device=device),
        prev_img=torch.zeros(H, W, dtype=dtype, device=device),
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
        vps_prev=torch.eye(3, dtype=dtype, device=device),
        had_vps=torch.zeros((), dtype=torch.bool, device=device),
    )


def _rank_desc(r):
    """Rank of every entry in a stable descending order (jnp.argsort(-r))."""
    order = torch.argsort(-r, stable=True)
    return torch.empty_like(order).scatter_(0, order, torch.arange(r.shape[0], device=r.device))


def step(state: LineTrackerState, img, ideal_cam: cam_mod.CameraModel,
         cfg: LineTrackerConfig, vp_u):
    """Process one (already undistorted) frame.  ideal_cam: the pinhole model
    of the undistorted image; vp_u: [n_pairs, 2] uniforms of the VP pair
    draw.  Returns (new_state, LineTrackerOutput)."""
    if cfg.equalize:
        raise NotImplementedError("CLAHE (equalize=True) is not ported yet; "
                                  "run with equalize=False")
    dtype, dev = img.dtype, img.device
    L = cfg.max_lines
    segs_new, lens_new, valid_new = lines_mod.detect_lines(img, cfg.detect._replace(max_lines=L))

    # h/v classification caps (top-up priority by length)
    horiz, vert = lines_mod.classify_hv(segs_new, valid_new)

    def cap(mask, kmax):
        return mask & (_rank_desc(torch.where(mask, lens_new, torch.full_like(lens_new, -1.0)))
                       < kmax)

    valid_new = valid_new & (cap(horiz, cfg.max_h) | cap(vert, cfg.max_v)
                             | (valid_new & ~horiz & ~vert))

    # ---- match against the previous frame (dropped on the first frame) ----
    m, _ = lmatch_mod.match_lines(state.prev_img, img, state.segs, state.ids >= 0,
                                  segs_new, valid_new, cfg.match)
    match = torch.where(state.has_prev, m, torch.full_like(m, -1))

    # new-frame slot table: tracked lines inherit ids, the rest get fresh ids
    matched = match >= 0
    safe_m = torch.where(matched, match, torch.zeros_like(match))
    ar = torch.arange(L, device=dev)
    # the reference scatters every source's flag into its target, with the
    # unmatched ones writing False into target 0; duplicates resolve
    # last-write-wins (XLA's in-order scatter), emulated with the largest
    # source index per target
    last = torch.full((L,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, safe_m, ar, reduce="amax")
    tgt_taken = (last >= 0) & matched[torch.clamp(last, min=0)]
    inherit_src = torch.where(tgt_taken, last, torch.full_like(last, -1))
    is_new = valid_new & ~tgt_taken
    new_rank = torch.cumsum(is_new.long(), 0) - 1
    ids_out = torch.where(tgt_taken & valid_new, state.ids[torch.clamp(inherit_src, min=0)],
                          torch.where(is_new, state.next_id + new_rank, torch.full_like(ar, -1)))
    n_new = torch.sum(is_new.long())

    # ---- vanishing points -------------------------------------------------
    if cfg.use_vp:
        vps, vp_id, vp_ok = vp_mod.detect_vps(segs_new, valid_new, ideal_cam.fx, ideal_cam.cx,
                                              ideal_cam.cy, vp_u, cfg.vp)
        vps = vp_mod.vps_temporal_consistency(vps, state.vps_prev, state.had_vps)
        vp_valid = (vp_id < 3) & valid_new & vp_ok
        vp_dirs = vps[torch.clamp(vp_id, 0, 2)]
        vp_dirs = vp_dirs * torch.where(vp_dirs[:, 2:3] < 0, -1.0, 1.0).to(dtype)
    else:
        vps = state.vps_prev
        vp_ok = torch.zeros((), dtype=torch.bool, device=dev)
        vp_valid = torch.zeros(L, dtype=torch.bool, device=dev)
        vp_dirs = torch.zeros(L, 3, dtype=dtype, device=dev)
        vp_dirs[:, 2] = 1.0

    # ---- normalized endpoints --------------------------------------------
    e1 = cam_mod.lift(ideal_cam, segs_new[:, 0:2])[:, 0:2]
    e2 = cam_mod.lift(ideal_cam, segs_new[:, 2:4])[:, 0:2]
    out = LineTrackerOutput(ids=ids_out, endpoints=torch.cat([e1, e2], dim=1), vp_dirs=vp_dirs,
                            vp_valid=vp_valid, segs_px=segs_new, valid=ids_out >= 0)
    state_new = LineTrackerState(
        segs=segs_new, ids=ids_out, next_id=state.next_id + n_new, prev_img=img,
        has_prev=torch.ones_like(state.has_prev),
        vps_prev=torch.where(vp_ok, vps, state.vps_prev),
        had_vps=state.had_vps | vp_ok,
    )
    return state_new, out
