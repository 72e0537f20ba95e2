"""Scored Shi-Tomasi corner detection with grid-cell spacing.

Port of ``vplines_slam_tpu/ops/corners.py``: min-eigenvalue response
(Sobel, 3x3 box SUM, min eig), 3x3 non-max suppression, quality threshold,
border kill, then one argmax per ``min_dist`` cell, cells owned by tracked
features suppressed, and the top ``max_corners`` cells.

Kernel K3 (``csrc/corners.cu``) is the whole of ``detect`` on a CUDA tensor,
in two launches and nothing else: ``CORNER_CELLS`` fuses Sobel -> box sums
-> min eig -> NMS over 32x32 tiles, keeps the image maximum and folds each
positive in-border value into its cell's best (first index wins);
``CORNER_TOPK`` (a CTA per 16 cells) thresholds the cells, suppresses the
occupied ones (the last tracked feature of a cell wins, as the reference's
scatter), ranks its cells in ``lax.top_k``'s order and writes their slots of
``xy``, ``score`` and ``valid``.  The two keep their cell bests and the
maximum in a scratch of the device and stream that the second launch leaves
cleared for the next call.  On a
CPU tensor ``detect`` runs the plain twin: ``_occupied``,
``_cell_best_plain``, a stable sort and gathers.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels
from .image import _conv2d_same, sobel_gradients

# csrc/corners.cu CornerArgs
_CORNER_ARGS = kernels.args_struct(
    "CornerArgs",
    ["img", "map", "state", "keys", "exist_xy", "exist_mask", "xy", "score", "valid"],
    ["H", "W", "md", "ch", "cw", "border", "n_exist", "max_corners", "keep_map"],
    ["quality"],
)
CORNER_CELLS = kernels.Kernel(
    "vp_corner_cells", "vplines_slam_tpu_torch/csrc/corners.cu",
    "vplines_slam_tpu/ops/corners.py:25", [kernels.P],
)
CORNER_TOPK = kernels.Kernel(
    "vp_corner_topk", "vplines_slam_tpu_torch/csrc/corners.cu",
    "vplines_slam_tpu/ops/corners.py:43", [kernels.P],
)
MAX_CELLS = 16384  # csrc/corners.cu kMaxCells: the top-k keeps 12 bytes a cell in shared memory

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


_SCRATCH = {}


def _scratch(dev, n_cells, n_px):
    """The device and stream's scratch of K3: the ordered image maximum and
    the ticket counter ({INT_MIN, 0} between calls), the cells' keys (0
    between calls) and the map of the exact path.  Made (one fill launch)
    the first time, or larger, and left cleared by every call's top-k."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    s = _SCRATCH.get(key)
    if s is None or s[1].numel() < n_cells or s[2].numel() < n_px:
        if s is not None:
            n_cells, n_px = max(n_cells, s[1].numel()), max(n_px, s[2].numel())
        s = (torch.tensor([-2**31, 0], dtype=torch.int32, device=dev),
             torch.zeros(n_cells, dtype=torch.int64, device=dev),
             torch.empty(n_px, dtype=torch.float32, device=dev))
        _SCRATCH[key] = s
    return s


def _detect_cuda(img, max_corners, min_dist, quality, existing_xy, existing_mask, border):
    """K3's two launches; raises before any launch on what they do not take."""
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError(f"img: K3 takes a float32 [H, W] image, got {img.dtype} "
                         f"{tuple(img.shape)}")
    H, W = img.shape
    ch, cw = -(-H // min_dist), -(-W // min_dist)
    if H < 1 or W < 1 or ch * cw > MAX_CELLS:
        raise ValueError(f"K3 takes 1 to {MAX_CELLS} cells, got {ch} x {cw}")
    dev = img.device
    img = img.contiguous()
    state, keys, mp = _scratch(dev, ch * cw, H * W)
    xy = torch.empty(max_corners, 2, dtype=img.dtype, device=dev)
    score = torch.empty(max_corners, dtype=img.dtype, device=dev)
    valid = torch.empty(max_corners, dtype=torch.bool, device=dev)
    n_exist, exy, emask = 0, None, None
    if existing_xy is not None:
        exy = existing_xy.contiguous()
        n_exist = exy.shape[0]
        kernels.check(exy, "existing_xy", shape=(n_exist, 2))
        if existing_mask is not None:
            emask = kernels.as_u8(existing_mask)
            kernels.check(emask, "existing_mask", torch.uint8, shape=(n_exist,))
    args = _CORNER_ARGS(
        kernels.check(img, "img"), mp.data_ptr(), state.data_ptr(), keys.data_ptr(),
        None if exy is None else exy.data_ptr(), None if emask is None else emask.data_ptr(),
        xy.data_ptr(), score.data_ptr(), valid.data_ptr(), H, W, int(min_dist), ch, cw,
        int(border), n_exist, int(max_corners), int(quality < 0), float(quality))
    CORNER_CELLS(ctypes.byref(args))
    CORNER_TOPK(ctypes.byref(args))
    return xy, score, valid


def detect_plain(img, max_corners, min_dist=30, quality=0.01, existing_xy=None,
                 existing_mask=None, border=5):
    """K3's twin: ``_occupied``, ``_cell_best_plain``, the stable top-k and
    the gathers, on any device."""
    H, W = img.shape
    ch = -(-H // min_dist)
    cw = -(-W // min_dist)
    occupied = _occupied(existing_xy, existing_mask, min_dist, ch, cw, img.device)
    best_val, best_in_cell = _cell_best_plain(img, min_dist, quality, occupied, border)
    return _top_cells(best_val, best_in_cell, min_dist, max_corners, img.dtype)


def _top_cells(best_val, best_in_cell, min_dist, max_corners, dtype):
    """The top ``max_corners`` cells of [ch, cw] bests (a stable descending
    sort: lax.top_k's order), padded with zeros."""
    ch, cw = best_val.shape
    dev = best_val.device
    by = best_in_cell // min_dist
    bx = best_in_cell % min_dist
    cy = torch.arange(ch, device=dev)[:, None] * min_dist + by
    cx = torch.arange(cw, device=dev)[None, :] * min_dist + bx

    flat_val = best_val.reshape(-1)
    k = min(max_corners, flat_val.shape[0])
    # stable descending sort == lax.top_k's lower-index-first tie order
    top_val, top_idx = torch.sort(flat_val, descending=True, stable=True)
    top_val, top_idx = top_val[:k], top_idx[:k]
    xy = torch.stack([cx.reshape(-1)[top_idx], cy.reshape(-1)[top_idx]], -1).to(dtype)
    valid = top_val > 0.0
    if k < max_corners:
        pad = max_corners - k
        xy = torch.cat([xy, xy.new_zeros(pad, 2)])
        top_val = torch.cat([top_val, top_val.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return xy, top_val, valid


def detect(img, max_corners, min_dist=30, quality=0.01, existing_xy=None,
           existing_mask=None, border=5):
    """Top-``max_corners`` corners with >= min_dist spacing, avoiding cells of
    existing ones.  Returns (xy [max_corners, 2], score, valid); unused slots
    have valid=False.  K3's two launches on a CUDA tensor (float32, at most
    MAX_CELLS cells), ``detect_plain`` on a CPU tensor."""
    if img.is_cuda:
        return _detect_cuda(img, max_corners, min_dist, quality, existing_xy, existing_mask,
                            border)
    return detect_plain(img, max_corners, min_dist, quality, existing_xy, existing_mask,
                        border)
