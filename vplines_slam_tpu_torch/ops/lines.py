"""Line segment detection: the anchor-growth formulation of EDLines.

Port of ``vplines_slam_tpu/ops/lines.py`` (``detect_lines`` without its
debug stash, ``seg_angle``, ``classify_hv``).  Steps: 5x5 Gaussian blur and
Scharr gradients; anchors = directional local maxima of |∇|; the best anchor
of every 16x16 cell; the top ``max_anchors`` cells; from each anchor a
straight ray walk of up to ``max_steps`` pixels both ways along the
level-line direction, stopping at the first sample that fails the
gradient/alignment gate; a 3-tap parabolic offset across the ray; a PCA line
fit of the support with a fit-error gate; (θ, ρ) dedupe; and the merge of
each winner with the good segments of its bin.

Kernel K6 (``csrc/lines.cu``) is two launches: ``LINE_ANCHORS`` (blur,
Scharr, anchor test and the per-cell argmax, a CTA a 32x32 tile, first index
wins) and ``LINE_SELECT_GROW`` (the top ``max_anchors`` cells by rank in the
stable descending order, which is ``lax.top_k``'s, then a warp a selected
cell: the walk, the tube offset, the moments and the fit; slots of a cell
scoring 0 are not walked and read zeros).  Its plain twins are
``_anchors_plain`` and ``select_and_grow_plain``, which keeps the top-k as a
stable sort and two gathers (``torch.topk`` does not order ties as
``lax.top_k``).  The (θ, ρ) dedupe and the merge stay plain PyTorch on both
routes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from .image import gaussian_blur, scharr_gradients

LINE_ANCHORS = kernels.Kernel(
    "vp_line_anchors", "vplines_slam_tpu_torch/csrc/lines.cu",
    "vplines_slam_tpu/ops/lines.py:63",
    [kernels.P, kernels.I, kernels.I, kernels.F, kernels.F,
     kernels.P, kernels.P, kernels.P, kernels.P, kernels.P],
)
LINE_SELECT_GROW = kernels.Kernel(
    "vp_line_select_grow", "vplines_slam_tpu_torch/csrc/lines.cu",
    "vplines_slam_tpu/ops/lines.py:96",
    [kernels.P, kernels.P, kernels.I, kernels.I, kernels.P, kernels.P, kernels.P, kernels.I,
     kernels.I, kernels.I, kernels.I, kernels.F, kernels.F, kernels.P, kernels.P, kernels.P,
     kernels.P],
)

CELL = 16  # anchor stratification cell (px)


class LineDetectConfig(NamedTuple):
    grad_thresh: float = 0.03  # gradient magnitude gate ([0,1] images)
    anchor_thresh: float = 0.004  # directional-peak margin (anchorThreshold)
    max_anchors: int = 512  # anchors grown in parallel
    max_steps: int = 96  # growth steps each way (pixels)
    angle_tol: float = 0.2  # rad, alignment gate during growth
    min_len: float = 30.0  # minLineLen
    fit_err: float = 1.5  # max RMS point-line distance (lineFitErrThreshold)
    max_lines: int = 64  # output capacity
    theta_bins: int = 36
    rho_bin: float = 12.0  # pixels


def _level_line_dir(gx, gy):
    """Unit direction along the edge (perpendicular to the gradient)."""
    mag = torch.sqrt(gx * gx + gy * gy)
    m = torch.clamp(mag, min=1e-12)
    return -gy / m, gx / m, mag


# ---------------------------------------------------------------------------
# stage 1: fields, anchors, per-cell best (K6 line_anchors)
# ---------------------------------------------------------------------------


def _anchors_plain(img, cfg: LineDetectConfig):
    """(mag, dx, dy [H, W], best value [ch, cw], best index in cell (int32))."""
    H, W = img.shape
    gx, gy = scharr_gradients(gaussian_blur(img, 5, 1.0))
    dx, dy, mag = _level_line_dir(gx, gy)
    magp = torch.nn.functional.pad(mag, (1, 1, 1, 1))
    mag_l, mag_r = magp[1:H + 1, 0:W], magp[1:H + 1, 2:W + 2]
    mag_u, mag_d = magp[0:H, 1:W + 1], magp[2:H + 2, 1:W + 1]
    t = cfg.anchor_thresh
    is_anchor = (mag > cfg.grad_thresh) & torch.where(
        torch.abs(gx) >= torch.abs(gy),
        (mag >= mag_l + t) & (mag >= mag_r + t),
        (mag >= mag_u + t) & (mag >= mag_d + t))
    score = torch.where(is_anchor, mag, torch.zeros_like(mag))
    ch, cw = -(-H // CELL), -(-W // CELL)
    pad = torch.nn.functional.pad(score, (0, cw * CELL - W, 0, ch * CELL - H))
    cells = pad.reshape(ch, CELL, cw, CELL).permute(0, 2, 1, 3).reshape(ch, cw, CELL * CELL)
    best_in = torch.argmax(cells, dim=-1)  # first index on ties, as jnp.argmax
    best_val = torch.gather(cells, -1, best_in[..., None])[..., 0]
    return mag, dx, dy, best_val, best_in.to(torch.int32)


def _anchors_cuda(img, cfg: LineDetectConfig):
    H, W = img.shape
    ch, cw = -(-H // CELL), -(-W // CELL)
    mag, dx, dy = (torch.empty_like(img) for _ in range(3))
    best_val = torch.empty(ch, cw, dtype=img.dtype, device=img.device)
    best_idx = torch.empty(ch, cw, dtype=torch.int32, device=img.device)
    LINE_ANCHORS(kernels.check(img, "img", ndim=2), H, W, float(cfg.grad_thresh),
                 float(cfg.anchor_thresh), kernels.check(mag, "mag"), kernels.check(dx, "dx"),
                 kernels.check(dy, "dy"), kernels.check(best_val, "best_val"),
                 kernels.check(best_idx, "best_idx", torch.int32))
    return mag, dx, dy, best_val, best_idx


def line_anchors(img, cfg: LineDetectConfig):
    """K6 stage 1.  CPU tensor: plain.  CUDA tensor: a CTA a 32x32 tile."""
    return (_anchors_cuda if img.is_cuda else _anchors_plain)(img, cfg)


# ---------------------------------------------------------------------------
# stage 2: top cells + ray walk + tube offset + PCA fit (K6 line_select_grow)
# ---------------------------------------------------------------------------


def _grow_plain(ax, ay, mag, dx, dy, cfg: LineDetectConfig):
    """Per anchor (ax, ay [A], integer-valued): (segs [A, 4], lens, fits,
    supports).  The walk's prefix-AND stops at the first failed gate."""
    H, W = mag.shape
    dtype = mag.dtype
    axi, ayi = ax.long(), ay.long()
    d0x, d0y = dx[ayi, axi], dy[ayi, axi]
    n0x, n0y = -d0y, d0x
    S = cfg.max_steps
    t = torch.arange(1, S + 1, dtype=dtype, device=mag.device)
    sgn = torch.tensor([1.0, -1.0], dtype=dtype, device=mag.device)
    st = sgn[None, :, None] * t[None, None, :]
    px = ax[:, None, None] + st * d0x[:, None, None]
    py = ay[:, None, None] + st * d0y[:, None, None]
    # nearest pixel: round half to even, as jnp.round
    xi, yi = torch.round(px).long(), torch.round(py).long()
    inb = (xi >= 1) & (xi < W - 2) & (yi >= 1) & (yi < H - 2)
    flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    m_s = mag.reshape(-1)[flat]
    align = torch.abs(dx.reshape(-1)[flat] * d0x[:, None, None]
                      + dy.reshape(-1)[flat] * d0y[:, None, None])
    ok = inb & (m_s > cfg.grad_thresh) & (align > math.cos(cfg.angle_tol))
    alive = torch.cumsum((~ok).long(), dim=-1) == 0
    av = alive.to(dtype)

    def tube(sx, sy):
        xi_, yi_ = torch.round(px + sx).long(), torch.round(py + sy).long()
        return mag.reshape(-1)[yi_.clamp(0, H - 1) * W + xi_.clamp(0, W - 1)]

    m_p = tube(n0x[:, None, None], n0y[:, None, None])
    m_m = tube(-n0x[:, None, None], -n0y[:, None, None])
    denom = m_p - 2.0 * m_s + m_m
    denom = torch.where(torch.abs(denom) > 1e-9, denom, torch.full_like(denom, 1e-9))
    delta = torch.clamp(0.5 * (m_m - m_p) / denom, -1.0, 1.0)
    qx = px + delta * n0x[:, None, None]
    qy = py + delta * n0y[:, None, None]

    n = 1.0 + torch.sum(av, dim=(1, 2))
    sx = ax + torch.sum(qx * av, dim=(1, 2))
    sy = ay + torch.sum(qy * av, dim=(1, 2))
    sxx = ax * ax + torch.sum(qx * qx * av, dim=(1, 2))
    sxy = ax * ay + torch.sum(qx * qy * av, dim=(1, 2))
    syy = ay * ay + torch.sum(qy * qy * av, dim=(1, 2))
    mx, my = sx / n, sy / n
    cxx = sxx / n - mx * mx
    cxy = sxy / n - mx * my
    cyy = syy / n - my * my
    theta_f = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)
    ux, uy = torch.cos(theta_f), torch.sin(theta_f)
    tr = cxx + cyy
    det = cxx * cyy - cxy * cxy
    lam_min = tr / 2.0 - torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    fits = torch.sqrt(torch.clamp(lam_min, min=0.0))
    tq = (qx - mx[:, None, None]) * ux[:, None, None] + (qy - my[:, None, None]) * uy[:, None, None]
    zero = torch.zeros_like(tq)
    t_hi = torch.amax(torch.where(alive, tq, zero), dim=(1, 2))
    t_lo = torch.amin(torch.where(alive, tq, zero), dim=(1, 2))
    segs = torch.stack([mx + t_lo * ux, my + t_lo * uy, mx + t_hi * ux, my + t_hi * uy], -1)
    return segs, t_hi - t_lo, fits, n


def select_cells_plain(best_val, best_idx, cfg: LineDetectConfig, dtype=None):
    """The anchors of the top ``max_anchors`` cells of best_val [ch, cw], in
    the stable descending order (lax.top_k's: the lower cell index first on
    ties), best_idx giving each cell's pixel: (ax, ay, a_ok [max_anchors]).
    a_ok is a score > 0; slots past the cell count are zeros, not ok."""
    ch, cw = best_val.shape
    dev = best_val.device
    dtype = dtype or best_val.dtype
    best_idx = best_idx.long()
    by = torch.arange(ch, device=dev)[:, None] * CELL + best_idx // CELL
    bx = torch.arange(cw, device=dev)[None, :] * CELL + best_idx % CELL
    flat_val = best_val.reshape(-1)
    k_cells = min(cfg.max_anchors, flat_val.shape[0])
    top_score, top_cell = torch.sort(flat_val, descending=True, stable=True)
    top_score, top_cell = top_score[:k_cells], top_cell[:k_cells]
    ax = bx.reshape(-1)[top_cell].to(dtype)
    ay = by.reshape(-1)[top_cell].to(dtype)
    a_ok = top_score > 0.0
    if k_cells < cfg.max_anchors:
        padn = cfg.max_anchors - k_cells
        ax = torch.cat([ax, ax.new_zeros(padn)])
        ay = torch.cat([ay, ay.new_zeros(padn)])
        a_ok = torch.cat([a_ok, a_ok.new_zeros(padn)])
    return ax, ay, a_ok


def select_and_grow_plain(best_val, best_idx, mag, dx, dy, cfg: LineDetectConfig):
    """K6 stage 2's twin: the top cells (``select_cells_plain``) walked:
    (segs [A, 4], lens, fits, supports, a_ok [A]).  A slot without a_ok
    reads zeros, as the kernel writes it."""
    dev, dtype = mag.device, mag.dtype
    ax, ay, a_ok = select_cells_plain(best_val, best_idx, cfg, dtype)
    segs, lens, fits, n = _grow_plain(ax, ay, mag, dx, dy, cfg)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return (torch.where(a_ok[:, None], segs, zero), torch.where(a_ok, lens, zero),
            torch.where(a_ok, fits, zero), torch.where(a_ok, n, zero), a_ok)


def _select_grow_cuda(best_val, best_idx, mag, dx, dy, cfg: LineDetectConfig):
    H, W = mag.shape
    ch, cw = best_val.shape
    A = cfg.max_anchors
    segs = torch.empty(A, 4, dtype=mag.dtype, device=mag.device)
    lens = torch.empty(A, dtype=mag.dtype, device=mag.device)
    fits_n = torch.empty(2, A, dtype=mag.dtype, device=mag.device)
    a_ok = torch.empty(A, dtype=torch.bool, device=mag.device)
    LINE_SELECT_GROW(kernels.check(best_val, "best_val", shape=(ch, cw)),
                     kernels.check(best_idx, "best_idx", torch.int32, shape=(ch, cw)), ch * cw, cw,
                     kernels.check(mag, "mag", ndim=2), kernels.check(dx, "dx", shape=(H, W)),
                     kernels.check(dy, "dy", shape=(H, W)), H, W, A, int(cfg.max_steps),
                     float(cfg.grad_thresh), float(math.cos(cfg.angle_tol)),
                     kernels.check(segs, "segs"), kernels.check(lens, "lens"),
                     kernels.check(fits_n, "fits_n"), kernels.check(a_ok, "a_ok", torch.bool))
    return segs, lens, fits_n[0], fits_n[1], a_ok


def line_select_grow(best_val, best_idx, mag, dx, dy, cfg: LineDetectConfig):
    """K6 stage 2.  CPU tensors: ``select_and_grow_plain``.  CUDA tensors: one
    launch, the ranks and a warp a selected cell."""
    fn = _select_grow_cuda if mag.is_cuda else select_and_grow_plain
    return fn(best_val, best_idx, mag, dx, dy, cfg)


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------


def detect_lines(img, cfg: LineDetectConfig = LineDetectConfig()):
    """Detect line segments.  img: [H, W] float in [0, 1].
    Returns (segments [max_lines, 4] = (x1, y1, x2, y2), lengths, valid)."""
    H, W = img.shape
    dev = img.device
    mag, dx, dy, best_val, best_idx = line_anchors(img, cfg)
    segs, lens, fits, supports, a_ok = line_select_grow(best_val, best_idx, mag, dx, dy, cfg)
    good = (a_ok & (lens >= cfg.min_len) & (fits <= cfg.fit_err)
            & (supports >= cfg.min_len * 0.6))

    # ---- dedupe by (θ, ρ) bin: the longest good segment per bin wins ------
    theta = seg_angle(segs)
    rho = -torch.sin(theta) * segs[:, 0] + torch.cos(theta) * segs[:, 1]
    tb = torch.clamp((theta / math.pi * cfg.theta_bins).long(), 0, cfg.theta_bins - 1)
    max_rho = math.sqrt(H * H + W * W)
    n_rho = int(2 * max_rho / cfg.rho_bin) + 2
    rb = torch.clamp(((rho + max_rho) / cfg.rho_bin).long(), 0, n_rho - 1)
    bin_id = tb * n_rho + rb
    order = torch.argsort(-torch.where(good, lens, torch.full_like(lens, -1.0)), stable=True)
    sorted_bins = bin_id[order]
    A = order.shape[0]
    earlier = torch.tril(torch.ones(A, A, dtype=torch.bool, device=dev), diagonal=-1)
    seen_before = torch.any((sorted_bins[:, None] == sorted_bins[None, :]) & earlier, dim=1)
    win_sorted = good[order] & ~seen_before
    win_len = torch.where(win_sorted, lens[order], torch.full_like(lens, -1.0))
    k = min(cfg.max_lines, cfg.max_anchors)
    top_vals, top_pos = torch.sort(win_len, descending=True, stable=True)
    top_vals, top_pos = top_vals[:k], top_pos[:k]
    sel = order[top_pos]
    win = top_vals > 0.0

    # merge collinear support: extend each winner to the union extent of the
    # good segments in its bin (walks can die mid-line)
    same = good[None, :] & (bin_id[None, :] == bin_id[sel][:, None])  # [k, A]
    th = theta[sel]
    ux, uy = torch.cos(th)[:, None], torch.sin(th)[:, None]
    mx = (0.5 * (segs[sel, 0] + segs[sel, 2]))[:, None]
    my = (0.5 * (segs[sel, 1] + segs[sel, 3]))[:, None]
    t1 = (segs[None, :, 0] - mx) * ux + (segs[None, :, 1] - my) * uy
    t2 = (segs[None, :, 2] - mx) * ux + (segs[None, :, 3] - my) * uy
    inf = torch.full_like(t1, math.inf)
    t_lo = torch.amin(torch.where(same, torch.minimum(t1, t2), inf), dim=1, keepdim=True)
    t_hi = torch.amax(torch.where(same, torch.maximum(t1, t2), -inf), dim=1, keepdim=True)
    merged = torch.cat([mx + t_lo * ux, my + t_lo * uy, mx + t_hi * ux, my + t_hi * uy], 1)
    out_segs = torch.where(win[:, None], merged, torch.zeros_like(merged))
    out_lens = torch.where(win, (t_hi - t_lo)[:, 0], torch.zeros_like(top_vals))
    if k < cfg.max_lines:
        pad = cfg.max_lines - k
        out_segs = torch.cat([out_segs, out_segs.new_zeros(pad, 4)])
        out_lens = torch.cat([out_lens, out_lens.new_zeros(pad)])
        win = torch.cat([win, win.new_zeros(pad)])
    return out_segs, out_lens, win


def seg_angle(segs):
    """Undirected segment angle in [0, π) (floor-mod, as ``% jnp.pi``)."""
    return torch.remainder(torch.atan2(segs[..., 3] - segs[..., 1], segs[..., 2] - segs[..., 0]),
                           math.pi)


def classify_hv(segs, valid, band=math.pi / 4):
    """Split into horizontal-ish / vertical-ish (π/4 bands)."""
    a = seg_angle(segs)
    horiz = ((a < band) | (a > math.pi - band)) & valid
    vert = (torch.abs(a - math.pi / 2) <= band) & valid
    return horiz, vert
