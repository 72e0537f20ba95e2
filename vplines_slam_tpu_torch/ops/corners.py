"""Scored Shi-Tomasi corner detection with grid-cell spacing.

Port of ``vplines_slam_tpu/ops/corners.py``: min-eigenvalue response
(Sobel, 3x3 box SUM, min eig), 3x3 non-max suppression, quality threshold,
border kill, then one argmax per ``min_dist`` cell, cells owned by tracked
features suppressed, and the top ``max_corners`` cells.

Kernel K3 (``csrc/corners.cu``) is two launches: ``CORNER_RESPONSE`` fuses
Sobel -> box sums -> min eig -> NMS over 16x16 tiles and keeps the global
maximum; ``CORNER_SELECT`` runs one block per cell with the threshold, the
border kill, the occupied mask and a first-index-wins argmax.  The top-k over
the few hundred cells stays a stable sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .image import _conv2d_same, sobel_gradients

CORNER_RESPONSE = kernels.Kernel(
    "vp_corner_response", "vplines_slam_tpu_torch/csrc/corners.cu",
    "vplines_slam_tpu/ops/corners.py:25",
    [kernels.P, kernels.I, kernels.I, kernels.P, kernels.P],
)
CORNER_SELECT = kernels.Kernel(
    "vp_corner_select", "vplines_slam_tpu_torch/csrc/corners.cu",
    "vplines_slam_tpu/ops/corners.py:43",
    [kernels.P, kernels.P, kernels.P, kernels.I, kernels.I, kernels.I,
     kernels.I, kernels.F, kernels.I, kernels.I, kernels.P, kernels.P],
)

def min_eig_response(img, block_size=3):
    """Per-pixel min eigenvalue of the structure tensor (cv::cornerMinEigenVal)."""
    gx, gy = sobel_gradients(img)
    k = ((1.0,) * block_size,) * block_size
    a = _conv2d_same(gx * gx, k)
    b = _conv2d_same(gx * gy, k)
    c = _conv2d_same(gy * gy, k)
    return ((a + c) - torch.sqrt((a - c) ** 2 + 4.0 * b * b)) * 0.5


def _nms(resp, radius=1):
    k = 2 * radius + 1
    mx = F.max_pool2d(resp[None, None], k, stride=1, padding=radius)[0, 0]
    return torch.where(resp >= mx, resp, torch.zeros_like(resp))


def _occupied(existing_xy, existing_mask, min_dist, ch, cw, device):
    """[ch, cw] cells owned by tracked features.  Like the reference, every
    feature WRITES its mask value into its cell; where several features share
    a cell the last one in slot order wins (XLA's in-order scatter), which is
    emulated deterministically with a max over slot indices."""
    if existing_xy is None:
        return torch.zeros(ch, cw, dtype=torch.bool, device=device)
    n = existing_xy.shape[0]
    ex = (existing_xy[:, 0] / min_dist).long().clamp(0, cw - 1)
    ey = (existing_xy[:, 1] / min_dist).long().clamp(0, ch - 1)
    m = (existing_mask if existing_mask is not None
         else torch.ones(n, dtype=torch.bool, device=device))
    last = torch.full((ch * cw,), -1, dtype=torch.long, device=device)
    last = last.scatter_reduce(0, ey * cw + ex, torch.arange(n, device=device),
                               reduce="amax")
    occ = (last >= 0) & m[last.clamp(min=0)]
    return occ.view(ch, cw)


def _cell_best_plain(img, min_dist, quality, occupied, border):
    H, W = img.shape
    resp = _nms(min_eig_response(img))
    thresh = quality * torch.max(resp)
    resp = torch.where(resp > thresh, resp, torch.zeros_like(resp))
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    resp = torch.where(inb, resp, torch.zeros_like(resp))
    ch, cw = occupied.shape
    rp = F.pad(resp, (0, cw * min_dist - W, 0, ch * min_dist - H))
    cells = rp.reshape(ch, min_dist, cw, min_dist).permute(0, 2, 1, 3).reshape(
        ch, cw, min_dist * min_dist)
    best_in_cell = torch.argmax(cells, dim=-1)
    best_val = torch.gather(cells, -1, best_in_cell[..., None])[..., 0]
    best_val = torch.where(occupied, torch.zeros_like(best_val), best_val)
    return best_val, best_in_cell


def _cell_best_cuda(img, min_dist, quality, occupied, border):
    H, W = img.shape
    ch, cw = occupied.shape
    nms = torch.empty_like(img)
    # order-preserving int image of the NMS maximum, reduced with atomicMax
    gmax = torch.full((1,), -2**31, dtype=torch.int32, device=img.device)
    CORNER_RESPONSE(kernels.check(img, "img", ndim=2), H, W,
                    kernels.check(nms, "nms"), kernels.check(gmax, "gmax", torch.int32))
    occ = occupied.to(torch.uint8).contiguous()
    best_val = torch.empty(ch, cw, dtype=img.dtype, device=img.device)
    best_idx = torch.empty(ch, cw, dtype=torch.int32, device=img.device)
    CORNER_SELECT(kernels.check(nms, "nms"), kernels.check(gmax, "gmax", torch.int32),
                  kernels.check(occ, "occupied", torch.uint8, shape=(ch, cw)), H, W, ch, cw,
                  float(quality), int(min_dist), int(border),
                  kernels.check(best_val, "best_val"),
                  kernels.check(best_idx, "best_idx", torch.int32))
    return best_val, best_idx.long()


def detect(img, max_corners, min_dist=30, quality=0.01, existing_xy=None,
           existing_mask=None, border=5):
    """Top-``max_corners`` corners with >= min_dist spacing, avoiding cells of
    existing ones.  Returns (xy [max_corners, 2], score, valid); unused slots
    have valid=False.  K3 runs on CUDA tensors, its plain twin on CPU."""
    H, W = img.shape
    ch = -(-H // min_dist)
    cw = -(-W // min_dist)
    occupied = _occupied(existing_xy, existing_mask, min_dist, ch, cw, img.device)
    cell_best = _cell_best_cuda if img.is_cuda else _cell_best_plain
    best_val, best_in_cell = cell_best(img, min_dist, quality, occupied, border)
    by = best_in_cell // min_dist
    bx = best_in_cell % min_dist
    cy = torch.arange(ch, device=img.device)[:, None] * min_dist + by
    cx = torch.arange(cw, device=img.device)[None, :] * min_dist + bx

    flat_val = best_val.reshape(-1)
    k = min(max_corners, flat_val.shape[0])
    # stable descending sort == lax.top_k's lower-index-first tie order
    top_val, top_idx = torch.sort(flat_val, descending=True, stable=True)
    top_val, top_idx = top_val[:k], top_idx[:k]
    xy = torch.stack([cx.reshape(-1)[top_idx], cy.reshape(-1)[top_idx]], -1).to(img.dtype)
    valid = top_val > 0.0
    if k < max_corners:
        pad = max_corners - k
        xy = torch.cat([xy, xy.new_zeros(pad, 2)])
        top_val = torch.cat([top_val, top_val.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return xy, top_val, valid
