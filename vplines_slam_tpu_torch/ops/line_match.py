"""Frame-to-frame line matching: anchor tracking + voting + topological filter.

Port of ``vplines_slam_tpu/ops/line_match.py`` (``warp=None`` only; the
affine patch warp is not ported): anchors every ~10 px along each previous
segment are tracked by the KLT in gain/bias mode (K2), each tracked anchor
votes for the nearest current segment within 4 px (ClosestLine), a line
match needs the most votes, at least ``min_votes`` and a ``vote_ratio`` share
of its tracked anchors (Point2Line), duplicate targets keep the source with
the most votes, and pairs whose mutual sideness flips between frames are
dropped (TopologicalFilter).

Kernel K7 (``csrc/line_match.cu``, one block per frame) runs everything after
the KLT: distances, votes, gates, duplicate resolution and the sideness
filter.  ``line_vote_plain`` is its twin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from . import klt as klt_mod

LINE_VOTE = kernels.Kernel(
    "vp_line_vote", "vplines_slam_tpu_torch/csrc/line_match.cu",
    "vplines_slam_tpu/ops/line_match.py:101",
    [kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.I,
     kernels.I, kernels.I, kernels.F, kernels.F, kernels.I, kernels.P, kernels.P],
)


class LineMatchConfig(NamedTuple):
    anchors_per_line: int = 8  # fixed anchor capacity (step≈10px on ≤80px lines)
    anchor_step: float = 10.0
    max_point_line_dist: float = 4.0  # px, ClosestLine gate
    vote_ratio: float = 0.4  # Point2Line majority ratio
    min_votes: int = 2
    # min_eig relaxed: line-edge patches are 1D (aperture); only the
    # perpendicular flow component matters for line assignment
    klt: klt_mod.KLTConfig = klt_mod.KLTConfig(
        win=15, levels=3, iters=8, illum_adapt=True, min_eig=1e-6)


def sample_anchors(segs, valid, cfg: LineMatchConfig):
    """[L, A, 2] anchors uniformly spaced along each segment, with the mask
    of the first ceil(length/step) (at least 2) of them (Anchors:532)."""
    A = cfg.anchors_per_line
    p1, p2 = segs[:, 0:2], segs[:, 2:4]
    length = torch.linalg.norm(p2 - p1, dim=-1)
    t = (torch.arange(A, dtype=segs.dtype, device=segs.device) + 0.5) / A
    pts = p1[:, None, :] + (p2 - p1)[:, None, :] * t[None, :, None]
    n_anchor = torch.clamp(torch.ceil(length / cfg.anchor_step).long(), 2, A)
    amask = (torch.arange(A, device=segs.device)[None, :] < n_anchor[:, None]) & valid[:, None]
    return pts, amask


def point_to_segment_dist(p, a, b):
    """Distance from p to segment ab (broadcasting)."""
    ab = b - a
    t = torch.sum((p - a) * ab, dim=-1) / torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12)
    proj = a + torch.clamp(t, 0.0, 1.0)[..., None] * ab
    return torch.linalg.norm(p - proj, dim=-1)


def _side(seg, p):
    """Sign of p relative to the directed segment (0 stays 0, as jnp.sign)."""
    d = seg[..., 2:4] - seg[..., 0:2]
    v = p - seg[..., 0:2]
    return torch.sign(d[..., 0] * v[..., 1] - d[..., 1] * v[..., 0])


def topological_filter(segs0, segs1, match):
    """Drop matches whose pairwise sideness flips between frames: a match is
    kept when >= 60% of its pairs with the other matches are consistent."""
    mid0 = 0.5 * (segs0[:, 0:2] + segs0[:, 2:4])
    m1 = segs1[torch.clamp(match, min=0)]
    mid1 = 0.5 * (m1[:, 0:2] + m1[:, 2:4])
    valid = match >= 0
    s0 = _side(segs0[:, None], mid0[None, :])
    s1 = _side(m1[:, None], mid1[None, :])
    L0 = match.shape[0]
    eye = torch.eye(L0, dtype=torch.bool, device=match.device)
    pair_ok = (s0 == s1) | ~valid[None, :] | ~valid[:, None] | eye
    n_other = torch.clamp(torch.sum(valid.long()) - 1, min=1)
    consist = (torch.sum((pair_ok & valid[None, :]).long(), dim=1) - 1) / n_other
    keep = valid & (consist >= 0.6)
    return torch.where(keep, match, torch.full_like(match, -1))


def line_vote_plain(tracked, ok, segs0, valid0, segs1, valid1, cfg: LineMatchConfig):
    """Votes -> match [L0] (index into segs1 or -1) and n_votes [L0].
    tracked [L0, A, 2]; ok [L0, A] (KLT ok & anchor mask)."""
    L1 = segs1.shape[0]
    d = point_to_segment_dist(tracked[:, :, None, :], segs1[None, None, :, 0:2],
                              segs1[None, None, :, 2:4])  # [L0, A, L1]
    d = torch.where(valid1[None, None, :], d, torch.full_like(d, float("inf")))
    dmin, nearest = torch.min(d, dim=-1)  # first index on ties
    near_ok = (dmin < cfg.max_point_line_dist) & ok
    votes = torch.zeros(*ok.shape[:1], L1, dtype=segs0.dtype, device=segs0.device)
    votes = votes.scatter_add(1, nearest, near_ok.to(segs0.dtype))
    n_votes, best = torch.max(votes, dim=-1)
    n_tracked = torch.clamp(torch.sum(ok.long(), dim=1), min=1)
    accept = valid0 & (n_votes >= cfg.min_votes) & (n_votes / n_tracked >= cfg.vote_ratio)
    match = torch.where(accept, best, torch.full_like(best, -1))
    # duplicate targets: the source with the most votes keeps it (first on ties)
    tgt = torch.where(match >= 0, match, torch.full_like(match, L1))
    per_tgt = torch.where(tgt[:, None] == torch.arange(L1 + 1, device=tgt.device)[None, :],
                          n_votes[:, None], torch.zeros_like(n_votes)[:, None])
    best_src = torch.argmax(per_tgt, dim=0)
    keep = best_src[tgt] == torch.arange(tgt.shape[0], device=tgt.device)
    match = torch.where(keep, match, torch.full_like(match, -1))
    return topological_filter(segs0, segs1, match), n_votes


def _line_vote_cuda(tracked, ok, segs0, valid0, segs1, valid1, cfg: LineMatchConfig):
    L0, A = ok.shape
    L1 = segs1.shape[0]
    # the converted inputs stay referenced until the launch is enqueued
    tracked, segs0, segs1 = tracked.contiguous(), segs0.contiguous(), segs1.contiguous()
    ok8, v08, v18 = (x.to(torch.uint8).contiguous() for x in (ok, valid0, valid1))
    match = torch.empty(L0, dtype=torch.int32, device=segs0.device)
    n_votes = torch.empty(L0, dtype=segs0.dtype, device=segs0.device)
    LINE_VOTE(kernels.check(tracked, "tracked", shape=(L0, A, 2)),
              kernels.check(ok8, "ok", torch.uint8, shape=(L0, A)),
              kernels.check(segs0, "segs0", shape=(L0, 4)),
              kernels.check(v08, "valid0", torch.uint8, shape=(L0,)),
              kernels.check(segs1, "segs1", shape=(L1, 4)),
              kernels.check(v18, "valid1", torch.uint8, shape=(L1,)),
              L0, A, L1, float(cfg.max_point_line_dist), float(cfg.vote_ratio),
              int(cfg.min_votes), kernels.check(match, "match", torch.int32),
              kernels.check(n_votes, "n_votes"))
    return match.long(), n_votes


def line_vote(tracked, ok, segs0, valid0, segs1, valid1, cfg: LineMatchConfig):
    """K7.  CPU tensors: ``line_vote_plain``.  CUDA tensors: one block."""
    fn = _line_vote_cuda if segs0.is_cuda else line_vote_plain
    return fn(tracked, ok, segs0, valid0, segs1, valid1, cfg)


def match_lines(img0, img1, segs0, valid0, segs1, valid1,
                cfg: LineMatchConfig = LineMatchConfig()):
    """Match previous-frame segments to current-frame segments.
    Returns (match [L0], index into segs1 or -1; n_votes [L0])."""
    L0, A = segs0.shape[0], cfg.anchors_per_line
    anchors, amask = sample_anchors(segs0, valid0, cfg)
    tracked, ok, _ = klt_mod.track(img0, img1, anchors.reshape(L0 * A, 2), cfg.klt)
    return line_vote(tracked.reshape(L0, A, 2), ok.reshape(L0, A) & amask,
                     segs0, valid0, segs1, valid1, cfg)
