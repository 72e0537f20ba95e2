"""Point-feature front-end: KLT -> essential-matrix RANSAC -> spaced top-up.

Port of ``vplines_slam_tpu/models/feature_tracker.py`` (``step`` without
CLAHE and without the fisheye mask).  Fixed-capacity slot arrays; new ids
come from a cumsum over the slots that take a fresh detection.

The reference's ``lax.cond`` on the RANSAC gate is a Python branch here: one
host sync per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import camera as cam_mod
from ..ops import corners as corners_mod
from ..ops import klt as klt_mod
from ..ops import mvg


class TrackerConfig(NamedTuple):
    max_features: int = 150  # max_cnt (euroc_config.yaml)
    min_dist: int = 30  # min_dist
    f_threshold: float = 1.0  # px at 460 virtual focal (F_threshold)
    equalize: bool = False  # CLAHE is not ported: must stay False
    ransac_hyps: int = 32
    quality: float = 0.01  # GFTT quality level (relative to max response)
    klt: klt_mod.KLTConfig = klt_mod.KLTConfig()


class TrackerState(NamedTuple):
    xy: torch.Tensor  # [M, 2] pixel positions
    ids: torch.Tensor  # [M] int64 (-1 empty)
    track_cnt: torch.Tensor  # [M] int64
    norm_prev: torch.Tensor  # [M, 2] previous normalized coords (velocity)
    next_id: torch.Tensor  # [] int64
    prev_img: torch.Tensor  # [H, W]
    has_prev: torch.Tensor  # [] bool


class TrackerOutput(NamedTuple):
    ids: torch.Tensor  # [M]
    rays: torch.Tensor  # [M, 3] normalized (z=1)
    velocity: torch.Tensor  # [M, 2] d(norm)/dt
    xy: torch.Tensor  # [M, 2] pixel
    valid: torch.Tensor  # [M]
    track_cnt: torch.Tensor  # [M]


def init_state(cfg: TrackerConfig, H, W, dtype=torch.float32, device=torch.device("cuda")) -> TrackerState:
    M = cfg.max_features
    return TrackerState(
        xy=torch.zeros(M, 2, dtype=dtype, device=device),
        ids=torch.full((M,), -1, dtype=torch.long, device=device),
        track_cnt=torch.zeros(M, dtype=torch.long, device=device),
        norm_prev=torch.zeros(M, 2, dtype=dtype, device=device),
        next_id=torch.zeros((), dtype=torch.long, device=device),
        prev_img=torch.zeros(H, W, dtype=dtype, device=device),
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
    )


def step(state: TrackerState, img, cam: cam_mod.CameraModel, cfg: TrackerConfig,
         dt, ransac_idx):
    """Process one frame.  ransac_idx: [ransac_hyps, 8] long sample draws in
    [0, max_features).  Returns (new_state, TrackerOutput)."""
    if cfg.equalize:
        raise NotImplementedError("CLAHE (equalize=True) is not ported yet")
    dtype = img.dtype
    M = cfg.max_features

    # ---- track ------------------------------------------------------------
    valid0 = state.ids >= 0
    pts1, ok, _ = klt_mod.track(state.prev_img, img, state.xy, cfg.klt)
    ok = ok & valid0 & state.has_prev

    # ---- essential-matrix outlier rejection (virtual focal plane) ----------
    norm0 = cam_mod.lift(cam, state.xy)[:, 0:2]
    norm1 = cam_mod.lift(cam, pts1)[:, 0:2]
    if int(torch.sum(ok)) >= 12:  # host sync: the reference's lax.cond
        _, inl, _ = mvg.ransac_essential(
            norm0, norm1, ok, ransac_idx, threshold=cfg.f_threshold / 460.0)
        ok = ok & inl

    # ---- survivor compaction + top-up detection ---------------------------
    xy_cur = torch.where(ok[:, None], pts1, state.xy)
    new_xy, _, new_valid = corners_mod.detect(
        img, max_corners=M, min_dist=cfg.min_dist, quality=cfg.quality,
        existing_xy=xy_cur, existing_mask=ok,
    )

    # fill free slots with new detections (rank matching)
    free = ~ok
    free_rank = torch.cumsum(free.long(), 0) - 1
    new_rank = torch.cumsum(new_valid.long(), 0) - 1
    n_free = torch.sum(free.long())
    take = new_valid & (new_rank < n_free)
    assigned = (free_rank[None, :] == new_rank[:, None]) & free[None, :] & take[:, None]
    slot_has_new = torch.any(assigned, dim=0)
    src = torch.argmax(assigned.to(torch.uint8), dim=0)

    xy_new = torch.where(slot_has_new[:, None], new_xy[src], xy_cur)
    new_id_rank = torch.cumsum(slot_has_new.long(), 0) - 1
    ids_new = torch.where(
        slot_has_new, state.next_id + new_id_rank,
        torch.where(ok, state.ids, torch.full_like(state.ids, -1)))
    track_cnt_new = torch.where(
        slot_has_new, torch.ones_like(state.track_cnt),
        torch.where(ok, state.track_cnt + 1, torch.zeros_like(state.track_cnt)))
    n_new = torch.sum(slot_has_new.long())

    # ---- normalized coords + velocities -----------------------------------
    norm_cur = cam_mod.lift(cam, xy_new)[:, 0:2]
    vel = torch.where(
        (ok & ~slot_has_new)[:, None],
        (norm_cur - state.norm_prev)
        / torch.clamp(torch.as_tensor(dt, dtype=dtype, device=img.device), min=1e-6),
        torch.zeros_like(norm_cur),
    )
    valid_out = ids_new >= 0
    out = TrackerOutput(
        ids=torch.where(valid_out, ids_new, torch.full_like(ids_new, -1)),
        rays=torch.cat([norm_cur, torch.ones(M, 1, dtype=dtype, device=img.device)], 1),
        velocity=vel,
        xy=xy_new,
        valid=valid_out,
        track_cnt=track_cnt_new,
    )
    state_new = TrackerState(
        xy=xy_new, ids=ids_new, track_cnt=track_cnt_new, norm_prev=norm_cur,
        next_id=state.next_id + n_new, prev_img=img,
        has_prev=torch.ones((), dtype=torch.bool, device=img.device),
    )
    return state_new, out
