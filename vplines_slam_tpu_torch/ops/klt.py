"""Batched pyramidal Lucas-Kanade point tracking.

Port of ``vplines_slam_tpu/ops/klt.py`` (``track`` with the translational,
inverse-compositional ``_track_level`` and its per-patch gain/bias mode
``_gain_bias``, which the line matcher uses; no affine warp, no ``track_1d``).

The JAX version gathers windows with row strips and one-hot matmuls (a TPU
workaround).  The plain version here gathers directly; kernel K2
(``csrc/klt.cu``, one CTA per feature) runs a whole pyramid level.  Both keep
the semantics that change the output: the zero pad ``E = r + D + 2``, the
window-anchor clips, Scharr gradients taken on the integer template superset
(with the superset's wrap-around borders) and then interpolated, ``min_eig``
divided by ``P*P`` with the ``det > 1e-12`` guard, and the two rounds of
``iters // 2`` with one re-anchor, where drift inside a round is clamped to
the moving window.  In gain/bias mode every moving patch (and the final
residual's) is renormalized to the template's mean and population std.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels
from .image import build_pyramid

KLT_TRACK_LEVEL = kernels.Kernel(
    "vp_klt_track_level", "vplines_slam_tpu_torch/csrc/klt.cu",
    "vplines_slam_tpu/ops/klt.py:162",
    [kernels.P, kernels.P, kernels.I, kernels.I, kernels.P, kernels.P,
     kernels.I, kernels.I, kernels.I, kernels.F, kernels.I, kernels.P, kernels.P, kernels.P],
)

DRIFT = 5  # in-window drift margin per round (px), D in the reference


class KLTConfig(NamedTuple):
    win: int = 21  # patch side (reference 21x21)
    levels: int = 3  # pyramid levels
    iters: int = 10  # fixed iterations per level
    min_eig: float = 1e-6  # spatial-gradient conditioning gate ([0,1] images)
    max_residual: float = 0.08  # mean abs photometric residual gate
    illum_adapt: bool = False  # per-patch gain/bias (line-matcher KLT mode)


def _gain_bias(I, T):
    """Per-patch gain/bias fit I' = α·I + β matched to the template's mean
    and population std (getImageNormParams)."""
    mI = torch.mean(I, dim=(-2, -1), keepdim=True)
    mT = torch.mean(T, dim=(-2, -1), keepdim=True)
    sI = torch.std(I, dim=(-2, -1), keepdim=True, correction=0) + 1e-6
    sT = torch.std(T, dim=(-2, -1), keepdim=True, correction=0) + 1e-6
    return (I - mI) * (sT / sI) + mT


def extract_windows(img, y0, x0, S):
    """[N, S, S] integer windows at top-left (y0, x0) [N] (long).  Rows are
    clamped into the image, columns past the right edge read 0 (the
    reference's row-take + one-hot column select)."""
    H, W = img.shape
    ar = torch.arange(S, device=img.device)
    rows = (y0[:, None] + ar).clamp(0, H - 1)
    cols = x0[:, None] + ar
    v = img[rows[:, :, None], cols.clamp(max=W - 1)[:, None, :]]
    return torch.where((cols < W)[:, None, :], v, torch.zeros_like(v))


def _grad_inwin(w):
    """Scharr gradients inside [N, S, S] windows with wrap-around borders
    (torch.roll, as the reference); callers only read the interior."""
    sm = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    df = (-1.0, 0.0, 1.0)

    def corr(a, taps, dim):
        out = None
        for i, t in enumerate(taps):
            if t == 0.0:
                continue
            term = t * torch.roll(a, 1 - i, dims=dim)
            out = term if out is None else out + term
        return out

    return corr(corr(w, sm, -2), df, -1), corr(corr(w, df, -2), sm, -1)


def _inwin_extract(wins, tlx, tly, P):
    """Bilinear [N, C, P, P] patches from [N, C, S, S] windows at fractional
    local top-left (tlx, tly) [N]: rows first, then columns."""
    S = wins.shape[-1]
    N, C = wins.shape[:2]
    ar = torch.arange(P, device=wins.device)

    def taps(t):
        f = torch.floor(t)
        w = (t - f)[:, None]
        i0 = f.long()[:, None] + ar
        i1 = i0 + 1
        return i0.clamp(max=S - 1), i1.clamp(max=S - 1), 1.0 - w, torch.where(
            i1 < S, w, torch.zeros_like(w))

    r0, r1, wr0, wr1 = taps(tly)
    c0, c1, wc0, wc1 = taps(tlx)
    gr = lambda idx: torch.gather(
        wins, 2, idx[:, None, :, None].expand(N, C, P, S))
    rows = wr0[:, None, :, None] * gr(r0) + wr1[:, None, :, None] * gr(r1)
    gc = lambda idx: torch.gather(
        rows, 3, idx[:, None, None, :].expand(N, C, P, P))
    return wc0[:, None, None, :] * gc(c0) + wc1[:, None, None, :] * gc(c1)


def _track_level_plain(img0, img1, pts0, guess, cfg: KLTConfig):
    """One pyramid level of inverse-compositional LK for all N features.
    Returns (flow [N,2], ok [N], mean |residual| [N])."""
    dtype = img0.dtype
    P = cfg.win
    r = (P - 1) / 2.0
    E = int(r) + DRIFT + 2  # zero pad: window anchors never clamp in-image
    TS = P + 3  # template superset: +1 bilinear, +2 gradient margin
    D = DRIFT
    MS = P + 1 + 2 * D
    img0 = F.pad(img0, (E, E, E, E))
    img1 = F.pad(img1, (E, E, E, E))
    pts0 = pts0 + E
    H, W = img0.shape

    tl0 = pts0 - r
    a0x = (torch.floor(tl0[:, 0]).long() - 1).clamp(0, max(W - TS, 0))
    a0y = (torch.floor(tl0[:, 1]).long() - 1).clamp(0, max(H - TS, 0))
    T_ss = extract_windows(img0, a0y, a0x, TS)
    gx_ss, gy_ss = _grad_inwin(T_ss)
    chans = torch.stack([T_ss, gx_ss, gy_ss], dim=1)
    ltlx = (tl0[:, 0] - a0x.to(dtype)).clamp(0.0, TS - P - 1)
    ltly = (tl0[:, 1] - a0y.to(dtype)).clamp(0.0, TS - P - 1)
    TIxIy = _inwin_extract(chans, ltlx, ltly, P)
    T, Ix, Iy = TIxIy[:, 0], TIxIy[:, 1], TIxIy[:, 2]

    a = torch.sum(Ix * Ix, dim=(1, 2))
    b = torch.sum(Ix * Iy, dim=(1, 2))
    c = torch.sum(Iy * Iy, dim=(1, 2))
    det = a * c - b * b
    min_eig = (c + a - torch.sqrt((a - c) ** 2 + 4.0 * b * b)) / (2.0 * P * P)
    ok = min_eig > cfg.min_eig
    dsafe = torch.where(det > 1e-12, det, torch.ones_like(det))
    i00, i01, i11 = c / dsafe, -b / dsafe, a / dsafe

    def make_window(dcur):
        ctr = pts0 + dcur
        m0x = (torch.round(ctr[:, 0] - r).long() - D).clamp(0, max(W - MS, 0))
        m0y = (torch.round(ctr[:, 1] - r).long() - D).clamp(0, max(H - MS, 0))
        return extract_windows(img1, m0y, m0x, MS)[:, None], m0x, m0y

    def extract_moving(M_ss, m0x, m0y, dcur):
        tlx = (pts0[:, 0] + dcur[:, 0] - r - m0x.to(dtype)).clamp(0.0, MS - P - 1)
        tly = (pts0[:, 1] + dcur[:, 1] - r - m0y.to(dtype)).clamp(0.0, MS - P - 1)
        return _inwin_extract(M_ss, tlx, tly, P)[:, 0]

    d = guess
    rounds = (cfg.iters // 2, cfg.iters - cfg.iters // 2) if cfg.iters >= 4 else (
        cfg.iters,)
    for n_it in rounds:
        M_ss, m0x, m0y = make_window(d)
        for _ in range(n_it):
            I = extract_moving(M_ss, m0x, m0y, d)
            rr = (_gain_bias(I, T) if cfg.illum_adapt else I) - T
            g0 = torch.sum(rr * Ix, dim=(1, 2))
            g1 = torch.sum(rr * Iy, dim=(1, 2))
            step = torch.stack([i00 * g0 + i01 * g1, i01 * g0 + i11 * g1], -1)
            d = d - torch.where(ok[:, None], step, torch.zeros_like(step))

    M_ss, m0x, m0y = make_window(d)
    I = extract_moving(M_ss, m0x, m0y, d)
    if cfg.illum_adapt:
        I = _gain_bias(I, T)
    resid = torch.mean(torch.abs(I - T), dim=(1, 2))
    return d, ok, resid


def _track_level(img0, img1, pts0, guess, cfg: KLTConfig):
    """K2.  CPU tensors: ``_track_level_plain``.  CUDA tensors: one launch of
    the per-feature kernel for the whole level."""
    if not img0.is_cuda:
        return _track_level_plain(img0, img1, pts0, guess, cfg)
    H, W = img0.shape
    N = pts0.shape[0]
    P = cfg.win
    if P < 3 or P % 2 == 0:
        raise ValueError(f"klt: window must be odd and >= 3, got {P}")
    flow = torch.empty(N, 2, dtype=img0.dtype, device=img0.device)
    ok = torch.empty(N, dtype=torch.uint8, device=img0.device)
    resid = torch.empty(N, dtype=img0.dtype, device=img0.device)
    if N == 0:
        return flow, ok.bool(), resid
    pts0 = pts0.contiguous()
    guess = guess.contiguous()
    KLT_TRACK_LEVEL(
        kernels.check(img0, "img0", ndim=2), kernels.check(img1, "img1", shape=(H, W)),
        H, W, kernels.check(pts0, "pts0", shape=(N, 2)),
        kernels.check(guess, "guess", shape=(N, 2)),
        N, P, cfg.iters, float(cfg.min_eig), int(cfg.illum_adapt),
        kernels.check(flow, "flow"), kernels.check(ok, "ok", torch.uint8),
        kernels.check(resid, "resid"),
    )
    return flow, ok.bool(), resid


def track(img0, img1, pts0, cfg: KLTConfig = KLTConfig(), init_flow=None):
    """Track pts0 [N,2] from img0 to img1 through a pyramid.
    Returns (pts1 [N,2], ok [N], residual [N])."""
    dtype = img0.dtype
    N = pts0.shape[0]
    pyr0 = build_pyramid(img0, cfg.levels)
    pyr1 = build_pyramid(img1, cfg.levels)
    scale = 2.0 ** (cfg.levels - 1)
    flow = (torch.zeros_like(pts0) if init_flow is None else init_flow.to(dtype)) / scale
    ok_all = torch.ones(N, dtype=torch.bool, device=img0.device)
    resid = torch.zeros(N, dtype=dtype, device=img0.device)
    for lvl in range(cfg.levels - 1, -1, -1):
        s = 2.0 ** lvl
        flow, ok, resid = _track_level(pyr0[lvl], pyr1[lvl], pts0 / s, flow, cfg)
        # only the finest level's conditioning gates the track
        if lvl == 0:
            ok_all = ok_all & ok
        if lvl > 0:
            flow = flow * 2.0
    pts1 = pts0 + flow
    H, W = img0.shape
    r = (cfg.win - 1) / 2.0
    inb = (
        (pts1[:, 0] >= r) & (pts1[:, 0] < W - r)
        & (pts1[:, 1] >= r) & (pts1[:, 1] < H - r)
    )
    ok_all = ok_all & inb & (resid < cfg.max_residual)
    return pts1, ok_all, resid
