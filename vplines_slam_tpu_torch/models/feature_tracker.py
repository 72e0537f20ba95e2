"""Point-feature front-end: CLAHE -> KLT -> essential-matrix RANSAC -> spaced
top-up.

Port of ``vplines_slam_tpu/models/feature_tracker.py`` (``step`` and the host
wrapper ``FeatureTrackerFrontend``; the fisheye mask is not ported and
``fisheye=True`` raises).  Fixed-capacity slot arrays; new ids come from a
cumsum over the slots that take a fresh detection.

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
from ..ops.image import clahe


class TrackerConfig(NamedTuple):
    max_features: int = 150  # max_cnt (euroc_config.yaml)
    min_dist: int = 30  # min_dist
    f_threshold: float = 1.0  # px at 460 virtual focal (F_threshold)
    equalize: bool = True  # CLAHE before tracking (feature_tracker.cpp:115)
    ransac_hyps: int = 32
    quality: float = 0.01  # GFTT quality level (relative to max response)
    fisheye: bool = False  # the fisheye mask is not ported: True raises
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
    if cfg.fisheye:
        raise NotImplementedError("the fisheye mask is not ported")
    dtype = img.dtype
    M = cfg.max_features
    if cfg.equalize:
        img = clahe(img)

    # ---- track ------------------------------------------------------------
    valid0 = state.ids >= 0
    pts1, ok, _ = klt_mod.track(state.prev_img, img, state.xy, cfg.klt)
    ok = ok & valid0 & state.has_prev

    # ---- essential-matrix outlier rejection (virtual focal plane) ----------
    norm0 = cam_mod.lift(cam, state.xy)[:, 0:2]
    norm1 = cam_mod.lift(cam, pts1)[:, 0:2]
    # below 12 tracks the inliers are ok itself (the reference's lax.cond),
    # decided inside K4's launch on the card
    _, inl, _ = mvg.ransac_essential(norm0, norm1, ok, ransac_idx,
                                     threshold=cfg.f_threshold / 460.0, min_valid=12)
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


class FeatureTrackerFrontend:
    """Host wrapper: owns the tracker state and the generator of the RANSAC
    draws (``ransac_draws``, one [ransac_hyps, 8] draw per frame)."""

    def __init__(self, cam: cam_mod.CameraModel, cfg: TrackerConfig = TrackerConfig(),
                 dtype=torch.float32, seed=0, device=torch.device("cuda")):
        if cfg.fisheye:
            raise NotImplementedError("the fisheye mask is not ported")
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = init_state(cfg, cam.height, cam.width, dtype, self.device)
        self.last_t = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def ransac_draws(self):
        """[ransac_hyps, 8] sample draws in [0, max_features)."""
        return torch.randint(0, self.cfg.max_features, (self.cfg.ransac_hyps, 8),
                             generator=self._gen, device=self.device)

    def process(self, t, img):
        dt = 0.05 if self.last_t is None else max(t - self.last_t, 1e-3)
        self.last_t = t
        self.state, out = step(self.state, img, self.cam, self.cfg, dt, self.ransac_draws())
        return out
