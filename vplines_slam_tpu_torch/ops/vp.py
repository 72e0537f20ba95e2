"""Vanishing point detection: 3-orthogonal-VP hypotheses + sphere grid.

Port of ``vplines_slam_tpu/ops/vp.py``: a 1°-resolution Gaussian-sphere
accumulator voted by all line-pair intersections weighted
sqrt(len_i·len_j)·(sin 2Δθ + 0.2) (getSphereGrids) and smoothed with its 4
neighbours (wrapping on both axes, as the reference's ``jnp.roll``); vp1
from a random line pair, vp2 swept around the great circle ⊥ vp1, vp3 =
vp1 × vp2 (getVPHypVia2Lines); the hypothesis with the most grid mass
(getBestVpsHyp, first index on ties); each line assigned to the VP it passes
within 1° of, else label 3 (lines2Vps).

The pair draw is an input: ``u [n_pairs, 2]`` uniforms in [0, 1), turned
into indices the way ``jax.random.choice(..., p=...)`` does (cumsum of p,
``r = c[-1]·(1 - u)``, left ``searchsorted``), so a caller that feeds JAX's
own uniforms gets JAX's draw.

Kernel K8 (``csrc/vp.cu``) is two launches: ``VP_GRID`` (a CTA per
latitude row: the pair votes landing on that row and its two neighbours,
added in pair order in shared memory, then the row's smoothing) and
``VP_SCORE`` (a cluster of 16 CTAs, the vp1 hypotheses split among them:
every hypothesis' three lookups, vp1's once per vp1, the flat argmax as a
(value, index) reduction across the cluster, the classification of the
lines).  The detector's constants (the basis references and the sweep's
cos / sin table) are made once per (config, dtype, device).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import kernels
from ..utils.geometry import cross

VP_GRID = kernels.Kernel(
    "vp_vp_grid", "vplines_slam_tpu_torch/csrc/vp.cu", "vplines_slam_tpu/ops/vp.py:87",
    [kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.I, kernels.I,
     kernels.F, kernels.P],
)
VP_SCORE = kernels.Kernel(
    "vp_vp_score", "vplines_slam_tpu_torch/csrc/vp.cu", "vplines_slam_tpu/ops/vp.py:138",
    [kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.I,
     kernels.P, kernels.P, kernels.I, kernels.I, kernels.I, kernels.F,
     kernels.P, kernels.P, kernels.P],
)


class VPConfig(NamedTuple):
    n_pairs: int = 64  # vp1 hypotheses (line pairs)
    n_sweep: int = 90  # vp2 sweep positions
    grid_la: int = 90  # latitude bins (π/2 span, 1°)
    grid_lo: int = 360  # longitude bins (2π span, 1°)
    angle_tol: float = math.pi / 180.0  # classification gate (thAngle)
    pair_angle_gate: float = math.pi / 3.0  # grid vote gate (angelTolerance)


def _line_params(segs, f, cx, cy):
    """Homogeneous lines on the unit-focal plane, lengths and angles in
    [0, π) of pixel segments [L, 4]."""
    x1, y1 = (segs[..., 0] - cx) / f, (segs[..., 1] - cy) / f
    x2, y2 = (segs[..., 2] - cx) / f, (segs[..., 3] - cy) / f
    one = torch.ones_like(x1)
    line = cross(torch.stack([x1, y1, one], -1), torch.stack([x2, y2, one], -1))
    length = torch.hypot(x2 - x1, y2 - y1)
    angle = torch.remainder(torch.atan2(y2 - y1, x2 - x1), math.pi)
    return line, length, angle


def _sphere_coords(v, cfg: VPConfig):
    """Unit direction -> (lat, lon) grid indices, folded to the upper
    hemisphere (getSphereGrids binning)."""
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    v = v * torch.where(v[..., 2:3] < 0, -1.0, 1.0).to(v.dtype)
    lat = torch.acos(torch.clamp(v[..., 2], -1.0, 1.0))
    lon = torch.remainder(torch.atan2(v[..., 1], v[..., 0]), 2 * math.pi)
    la = torch.clamp((lat / (math.pi / 2) * cfg.grid_la).long(), 0, cfg.grid_la - 1)
    lo = torch.clamp((lon / (2 * math.pi) * cfg.grid_lo).long(), 0, cfg.grid_lo - 1)
    return la, lo


# ---------------------------------------------------------------------------
# K8 vp_grid: pair votes + smoothing
# ---------------------------------------------------------------------------


def vp_grid_plain(line, length, angle, valid, cfg: VPConfig):
    """[grid_la, grid_lo] smoothed sphere accumulator."""
    L = line.shape[0]
    dtype = line.dtype
    w_valid = valid.to(dtype)
    inter = cross(line[:, None, :], line[None, :, :])
    norm = torch.linalg.norm(inter, dim=-1)
    dang = torch.abs(angle[:, None] - angle[None, :])
    dang = torch.minimum(math.pi - dang, dang)
    wpair = (torch.sqrt(length[:, None] * length[None, :]) * (torch.sin(2.0 * dang) + 0.2)
             * w_valid[:, None] * w_valid[None, :] * (norm > 1e-9).to(dtype)
             * (dang <= cfg.pair_angle_gate).to(dtype))
    iu = torch.triu_indices(L, L, offset=1, device=line.device)
    la, lo = _sphere_coords(inter[iu[0], iu[1]], cfg)
    grid = torch.zeros(cfg.grid_la * cfg.grid_lo, dtype=dtype, device=line.device)
    grid = grid.index_add(0, la * cfg.grid_lo + lo, wpair[iu[0], iu[1]])
    grid = grid.view(cfg.grid_la, cfg.grid_lo)
    return (grid + torch.roll(grid, 1, 0) + torch.roll(grid, -1, 0)
            + torch.roll(grid, 1, 1) + torch.roll(grid, -1, 1))


VP_GRID_MAX_LO = 1024  # longitude bins the kernel's shared-memory rows hold


def _vp_grid_cuda(line, length, angle, valid, cfg: VPConfig):
    if cfg.grid_la < 3 or not 1 <= cfg.grid_lo <= VP_GRID_MAX_LO:
        raise ValueError(f"vp_grid on the card takes grid_la >= 3 and 1 <= grid_lo <= "
                         f"{VP_GRID_MAX_LO}, got {cfg.grid_la} x {cfg.grid_lo}")
    L = line.shape[0]
    # the converted inputs stay referenced until the launch is enqueued
    line, length, angle = line.contiguous(), length.contiguous(), angle.contiguous()
    valid8 = kernels.as_u8(valid)
    grid = torch.empty(cfg.grid_la, cfg.grid_lo, dtype=line.dtype, device=line.device)
    VP_GRID(kernels.check(line, "line", shape=(L, 3)),
            kernels.check(length, "length", shape=(L,)),
            kernels.check(angle, "angle", shape=(L,)),
            kernels.check(valid8, "valid", torch.uint8, shape=(L,)),
            L, cfg.grid_la, cfg.grid_lo, float(cfg.pair_angle_gate),
            kernels.check(grid, "grid"))
    return grid


def vp_grid(line, length, angle, valid, cfg: VPConfig):
    """K8 stage 1.  CPU tensors: plain.  CUDA tensors: a CTA per latitude
    row."""
    return (_vp_grid_cuda if line.is_cuda else vp_grid_plain)(line, length, angle, valid, cfg)


# ---------------------------------------------------------------------------
# K8 vp_score: hypotheses' grid mass, argmax, line classification
# ---------------------------------------------------------------------------


def _classify(line, valid, vps, cfg: VPConfig):
    """[L] VP label per line: the VP its homogeneous line is most nearly ⊥
    to, within angle_tol, else 3."""
    ln = line / torch.clamp(torch.linalg.norm(line, dim=-1, keepdim=True), min=1e-12)
    cosv = torch.abs(ln @ vps.T)
    ang = torch.abs(math.pi / 2 - torch.acos(torch.clamp(cosv, -1.0, 1.0)))
    best_ang, best = torch.min(ang, dim=1)
    return torch.where(valid & (best_ang < cfg.angle_tol), best, torch.full_like(best, 3))


def vp_score_plain(grid, vp1, b1, b2, cos_s, sin_s, line, valid, cfg: VPConfig):
    """(vps [3, 3], line_vp_id [L], best score) for hypotheses vp1 [P, 3]
    with vp2 = b1·cos + b2·sin over the sweep [S]."""
    vp2 = b1[:, None, :] * cos_s[None, :, None] + b2[:, None, :] * sin_s[None, :, None]
    vp3 = cross(vp1[:, None, :], vp2)
    scores = torch.zeros(vp2.shape[:2], dtype=grid.dtype, device=grid.device)
    for v in (vp1[:, None, :].expand_as(vp2), vp2, vp3):
        la, lo = _sphere_coords(v, cfg)
        scores = scores + grid[la, lo]
    best, flat = torch.max(scores.reshape(-1), dim=0)  # first index on ties
    pi_, si_ = flat // cfg.n_sweep, flat % cfg.n_sweep
    vps = torch.stack([vp1[pi_], vp2[pi_, si_], vp3[pi_, si_]])
    return vps, _classify(line, valid, vps, cfg), best


VP_SCORE_MAX_PAIRS = 1024  # vp1 hypotheses the kernel takes (64 a CTA of 16)


def _sweep_table(cos_s, sin_s):
    """[2, S] table of the sweep's cos and sin: a view when sin_s follows
    cos_s in one storage (``detect_vps``'s table), else a stack."""
    S = cos_s.shape[0]
    if (cos_s.dtype == sin_s.dtype and cos_s.is_contiguous() and sin_s.is_contiguous()
            and cos_s.untyped_storage().data_ptr() == sin_s.untyped_storage().data_ptr()
            and sin_s.data_ptr() == cos_s.data_ptr() + S * cos_s.element_size()):
        return cos_s.as_strided((2, S), (S, 1))
    return torch.stack([cos_s, sin_s])


def _vp_score_cuda(grid, vp1, b1, b2, sweep, line, valid, cfg: VPConfig):
    """K8 stage 2 on the sweep table ``sweep`` [2, S] (cos, sin)."""
    P, S, L = vp1.shape[0], sweep.shape[1], line.shape[0]
    if P > VP_SCORE_MAX_PAIRS:
        raise ValueError(f"vp_score on the card takes at most {VP_SCORE_MAX_PAIRS} vp1 "
                         f"hypotheses, got {P}")
    # the converted inputs stay referenced until the launch is enqueued
    vp1, b1, b2, line = vp1.contiguous(), b1.contiguous(), b2.contiguous(), line.contiguous()
    valid8 = kernels.as_u8(valid)
    vps = torch.empty(3, 3, dtype=grid.dtype, device=grid.device)
    vp_id = torch.empty(L, dtype=torch.int32, device=grid.device)
    best = torch.empty((), dtype=grid.dtype, device=grid.device)
    VP_SCORE(kernels.check(grid, "grid", shape=(cfg.grid_la, cfg.grid_lo)),
             kernels.check(vp1, "vp1", shape=(P, 3)), kernels.check(b1, "b1", shape=(P, 3)),
             kernels.check(b2, "b2", shape=(P, 3)), kernels.check(sweep, "sweep", shape=(2, S)),
             P, S, kernels.check(line, "line", shape=(L, 3)),
             kernels.check(valid8, "valid", torch.uint8, shape=(L,)), L,
             cfg.grid_la, cfg.grid_lo, float(cfg.angle_tol),
             kernels.check(vps, "vps"), kernels.check(vp_id, "vp_id", torch.int32),
             kernels.check(best, "best"))
    return vps, vp_id.long(), best


def vp_score(grid, vp1, b1, b2, cos_s, sin_s, line, valid, cfg: VPConfig):
    """K8 stage 2.  CPU tensors: plain.  CUDA tensors: a cluster of 16 CTAs."""
    if not grid.is_cuda:
        return vp_score_plain(grid, vp1, b1, b2, cos_s, sin_s, line, valid, cfg)
    return _vp_score_cuda(grid, vp1, b1, b2, _sweep_table(cos_s, sin_s), line, valid, cfg)


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------


def choice_from_uniform(p, u):
    """Indices drawn with probabilities p [L] from uniforms u, as
    ``jax.random.choice(key, L, shape, p=p)`` computes them."""
    c = torch.cumsum(p, dim=0)
    return torch.searchsorted(c, c[-1] * (1.0 - u.to(c.dtype)))


@functools.cache
def detector_constants(cfg: VPConfig, dtype, device):
    """``detect_vps``'s constants, made once per (cfg, dtype, device) and
    never written: the basis references ez and ex, and the sweep's table
    [2, S] of cos and sin of ``arange(S) * π / S`` (in f64, then cast)."""
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=device)
    sweep = (torch.arange(cfg.n_sweep, dtype=torch.float64, device=device)
             * (math.pi / cfg.n_sweep)).to(dtype)
    return ez, ex, torch.stack([torch.cos(sweep), torch.sin(sweep)])


def detect_vps(segs, valid, f, cx, cy, u, cfg: VPConfig = VPConfig()):
    """Detect 3 orthogonal vanishing points.  segs [L, 4] pixel segments,
    valid [L], u [n_pairs, 2] uniforms of the pair draw.  Returns (vps [3, 3]
    unit directions in the camera frame, line_vp_id [L] in {0,1,2,3} with 3 =
    unassigned, ok)."""
    dtype = segs.dtype
    ez, ex, sweep = detector_constants(cfg, dtype, segs.device)
    line, length, angle = _line_params(segs, f, cx, cy)
    grid = vp_grid(line, length, angle, valid, cfg)

    probs = valid.to(dtype) + 1e-6
    idx = choice_from_uniform(probs / probs.sum(), u)  # [n_pairs, 2]
    vp1 = cross(line[idx[:, 0]], line[idx[:, 1]])
    vp1 = vp1 / torch.clamp(torch.linalg.norm(vp1, dim=-1, keepdim=True), min=1e-12)
    # orthonormal basis of the plane ⊥ vp1
    ref = torch.where(torch.abs(vp1[:, 2:3]) < 0.95, ez, ex)
    b1 = cross(vp1, ref)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = cross(vp1, b1)
    vps, vp_id, best = vp_score(grid, vp1, b1, b2, sweep[0], sweep[1], line, valid, cfg)
    return vps, vp_id, best > 0


def vps_temporal_consistency(vps, vps_prev, had_prev):
    """Keep the vp1/vp2 order of the previous frame (swap when that fits
    it better)."""
    d_keep = torch.abs(torch.sum(vps[0] * vps_prev[0])) + torch.abs(torch.sum(vps[1] * vps_prev[1]))
    d_swap = torch.abs(torch.sum(vps[0] * vps_prev[1])) + torch.abs(torch.sum(vps[1] * vps_prev[0]))
    swapped = torch.stack([vps[1], vps[0], vps[2]])
    return torch.where(had_prev & (d_swap > d_keep), swapped, vps)
