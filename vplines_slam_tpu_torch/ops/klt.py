"""Batched pyramidal Lucas-Kanade point tracking.

Port of ``vplines_slam_tpu/ops/klt.py`` (``track`` with the translational,
inverse-compositional ``_track_level`` and its per-patch gain/bias mode
``_gain_bias``, which the line matcher uses; no affine warp, no ``track_1d``).

The JAX version gathers windows with row strips and one-hot matmuls (a TPU
workaround).  The plain version here gathers directly; kernel K2
(``csrc/klt.cu``, four warps per feature) runs every pyramid level of a
``track`` call, and its gates, in one launch.  Both keep the semantics that
change the output: the zero pad ``E = r + D + 2``, the window-anchor clips,
Scharr gradients taken on the integer template superset (with the
superset's wrap-around borders) and then interpolated, ``min_eig`` divided
by ``P*P`` with the ``det > 1e-12`` guard, and the two rounds of
``iters // 2`` with one re-anchor, where drift inside a round is clamped to
the moving window.  In gain/bias mode every moving patch (and the final
residual's) is renormalized to the template's mean and population std.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels
from .image import build_pyramids

MAX_LEVELS = 4  # pyramid levels one K2 launch takes (csrc/klt.cu kMaxLevels)

_KLT_ARGS = kernels.args_struct(
    "KltArgs",
    [f"img0_{l}" for l in range(MAX_LEVELS)] + [f"img1_{l}" for l in range(MAX_LEVELS)]
    + ["pts0", "flow0", "pts1", "ok", "resid"],
    [f"{k}_{l}" for k in ("H", "W", "vec") for l in range(MAX_LEVELS)]
    + ["levels", "N", "P", "iters", "illum", "gate"],
    ["min_eig", "max_residual"])
KLT_TRACK = kernels.Kernel(
    "vp_klt_track", "vplines_slam_tpu_torch/csrc/klt.cu",
    "vplines_slam_tpu/ops/klt.py:162", [ctypes.POINTER(_KLT_ARGS)],
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


def _track_cuda(pyr0, pyr1, pts0, flow0, cfg: KLTConfig, gate):
    """K2: one launch over the levels of pyr0 / pyr1 (level 0 first),
    coarse to fine.  gate: (pts1, gated ok, level 0's residual) as ``track``
    returns them; else (flow, level 0's ok, residual) as ``_track_level``."""
    L, N, P = len(pyr0), pts0.shape[0], cfg.win
    if L > MAX_LEVELS:
        raise ValueError(f"klt: K2 takes at most MAX_LEVELS = {MAX_LEVELS} pyramid levels, "
                         f"got {L}")
    if P < 3 or P > 31 or P % 2 == 0:
        raise ValueError(f"klt: window must be odd and in [3, 31], got {P}")
    dev = pts0.device
    out = torch.empty(N, 2, dtype=torch.float32, device=dev)
    ok = torch.empty(N, dtype=torch.bool, device=dev)
    resid = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return out, ok, resid
    pts0 = pts0.contiguous()
    pad = [0] * (MAX_LEVELS - L)
    imgs0 = [kernels.check(im, f"img0[{l}]", ndim=2) for l, im in enumerate(pyr0)]
    imgs1 = [kernels.check(im1, f"img1[{l}]", shape=im0.shape)
             for l, (im0, im1) in enumerate(zip(pyr0, pyr1))]
    Hs = [im.shape[0] for im in pyr0]
    Ws = [im.shape[1] for im in pyr0]
    # 16-byte copies need rows of a multiple of 4 floats on a 16-byte base
    vec = [int(w % 4 == 0 and p0 % 16 == 0 and p1 % 16 == 0)
           for w, p0, p1 in zip(Ws, imgs0, imgs1)]
    flow_ptr = None
    if flow0 is not None:
        flow0 = flow0.to(torch.float32).contiguous()
        flow_ptr = kernels.check(flow0, "init_flow", shape=(N, 2))
    args = _KLT_ARGS(*imgs0, *pad, *imgs1, *pad, kernels.check(pts0, "pts0", shape=(N, 2)),
                     flow_ptr, out.data_ptr(), ok.data_ptr(), resid.data_ptr(),
                     *Hs, *pad, *Ws, *pad, *vec, *pad, L, N, P, cfg.iters,
                     int(cfg.illum_adapt), int(gate),
                     float(cfg.min_eig), float(cfg.max_residual))
    KLT_TRACK(ctypes.byref(args))
    return out, ok, resid


def _track_level(img0, img1, pts0, guess, cfg: KLTConfig):
    """K2 on one level.  CPU tensors: ``_track_level_plain``.  CUDA tensors:
    one launch of the kernel with that level alone and no gates."""
    if not img0.is_cuda:
        return _track_level_plain(img0, img1, pts0, guess, cfg)
    return _track_cuda([img0], [img1], pts0, guess, cfg, gate=False)


def track_plain(img0, img1, pts0, cfg: KLTConfig = KLTConfig(), init_flow=None):
    """The level loop over ``_track_level_plain`` plus the gates: K2's twin."""
    return track_levels(img0, img1, pts0, cfg, init_flow, _track_level_plain)


def track_levels(img0, img1, pts0, cfg, init_flow, level_fn):
    """``track``'s level loop and gates around ``level_fn`` (the signature
    of ``_track_level``), one call a level."""
    dtype = img0.dtype
    N = pts0.shape[0]
    pyr0, pyr1 = build_pyramids(img0, img1, cfg.levels)
    scale = 2.0 ** (cfg.levels - 1)
    flow = (torch.zeros_like(pts0) if init_flow is None else init_flow.to(dtype)) / scale
    ok_all = torch.ones(N, dtype=torch.bool, device=img0.device)
    resid = torch.zeros(N, dtype=dtype, device=img0.device)
    for lvl in range(cfg.levels - 1, -1, -1):
        s = 2.0 ** lvl
        flow, ok, resid = level_fn(pyr0[lvl], pyr1[lvl], pts0 / s, flow, cfg)
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


def track(img0, img1, pts0, cfg: KLTConfig = KLTConfig(), init_flow=None):
    """Track pts0 [N,2] from img0 to img1 through a pyramid.
    Returns (pts1 [N,2], ok [N], residual [N]).  CPU tensors:
    ``track_plain``.  CUDA tensors: both pyramids in one launch of K1, then
    one launch of K2 over every level, gates included."""
    if not img0.is_cuda:
        return track_plain(img0, img1, pts0, cfg, init_flow)
    if pts0.shape[0] == 0:  # nothing to track: no pyramid, no launch
        return _track_cuda([img0] * cfg.levels, [img1] * cfg.levels, pts0, init_flow, cfg,
                           gate=True)
    pyr0, pyr1 = build_pyramids(img0, img1, cfg.levels)
    return _track_cuda(pyr0, pyr1, pts0, init_flow, cfg, gate=True)
