"""Image primitives: separable correlations, gradients, pyramid, sampling and
the static undistortion remap.

Port of ``vplines_slam_tpu/ops/image.py`` (all but ``clahe``).  Images are float [H, W] in [0, 1].  The JAX package expressed every
correlation as zero-padded roll shifts (a TPU workaround); the plain versions
here pad once and add shifted slices, which is the same arithmetic in the
same tap order.

``pyr_down`` is kernel K1 (``csrc/pyr_down.cu``) and ``remap_static`` kernel
K5 (``csrc/remap.cu``): on a CUDA tensor each launches its kernel, on a CPU
tensor it runs its plain twin.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

PYR_DOWN = kernels.Kernel(
    "vp_pyr_down", "vplines_slam_tpu_torch/csrc/pyr_down.cu",
    "vplines_slam_tpu/ops/image.py:115",
    [kernels.P, kernels.P, kernels.I, kernels.I, kernels.I, kernels.I],
)

REMAP_STATIC = kernels.Kernel(
    "vp_remap_static", "vplines_slam_tpu_torch/csrc/remap.cu",
    "vplines_slam_tpu/ops/image.py:228",
    [kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.I, kernels.P],
)

PYR_TAPS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _axis_corr(img, taps, axis):
    """1D correlation along ``axis`` (0 or 1 of the last two dims), SAME zero
    padding: out[y] = Σ_i k[i]·img[y + i - r], summed in tap order."""
    r = len(taps) // 2
    dim = img.dim() - 2 + axis
    n = img.shape[dim]
    pad = [0, 0, 0, 0]
    pad[(1 - axis) * 2:(1 - axis) * 2 + 2] = [r, r]
    p = F.pad(img, pad)
    out = None
    for i, w in enumerate(taps):
        w = float(w)
        if w == 0.0:
            continue
        term = w * p.narrow(dim, i, n)
        out = term if out is None else out + term
    return out


def _sep_conv(img, kv, kh):
    """Separable correlation: vertical taps kv (axis 0) then horizontal kh."""
    return _axis_corr(_axis_corr(img, kv, 0), kh, 1)


def _conv2d_same(img, kernel):
    """2D correlation with a small constant kernel (nested tuples), SAME zero
    padding, taps summed row-major."""
    kh, kw = len(kernel), len(kernel[0])
    rh, rw = kh // 2, kw // 2
    H, W = img.shape[-2:]
    p = F.pad(img, (rw, rw, rh, rh))
    out = None
    for i in range(kh):
        for j in range(kw):
            w = float(kernel[i][j])
            if w == 0.0:
                continue
            term = w * p[..., i:i + H, j:j + W]
            out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(img)


def scharr_gradients(img):
    """Scharr x/y gradients (cv::Scharr parity, /32 normalization)."""
    sm = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    df = (-1.0, 0.0, 1.0)
    return _sep_conv(img, sm, df), _sep_conv(img, df, sm)


def sobel_gradients(img):
    sm = (1.0 / 8.0, 2.0 / 8.0, 1.0 / 8.0)
    df = (-1.0, 0.0, 1.0)
    return _sep_conv(img, sm, df), _sep_conv(img, df, sm)


def gaussian_kernel1d(ksize, sigma):
    r = ksize // 2
    g = [math.exp(-(x * x) / (2.0 * sigma * sigma)) for x in range(-r, r + 1)]
    s = sum(g)
    return tuple(v / s for v in g)


def gaussian_blur(img, ksize=5, sigma=1.0):
    g = gaussian_kernel1d(ksize, sigma)
    return _sep_conv(img, g, g)


def box_filter(img, ksize):
    t = (1.0,) * ksize
    return _sep_conv(img, t, t)


def pyr_down_plain(img):
    """Half resolution with 5-tap binomial smoothing (cv::pyrDown parity)."""
    return _sep_conv(img, PYR_TAPS, PYR_TAPS)[..., ::2, ::2].contiguous()


def pyr_down(img):
    """K1.  CPU tensor: ``pyr_down_plain``.  CUDA tensor: the kernel."""
    if not img.is_cuda:
        return pyr_down_plain(img)
    H, W = img.shape
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    out = torch.empty(Ho, Wo, dtype=img.dtype, device=img.device)
    PYR_DOWN(kernels.check(img, "img", ndim=2), kernels.check(out, "out"),
             H, W, Ho, Wo)
    return out


def build_pyramid(img, levels):
    """List of images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def bilinear_sample(img, xy, pad_value=0.0):
    """Sample img at float coords xy [..., 2] = (x, y); out-of-bounds taps
    read ``pad_value``."""
    H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()

    def at(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(inb, v, torch.full_like(v, pad_value))

    return (
        at(y0i, x0i) * (1 - fx) * (1 - fy)
        + at(y0i, x0i + 1) * fx * (1 - fy)
        + at(y0i + 1, x0i) * (1 - fx) * fy
        + at(y0i + 1, x0i + 1) * fx * fy
    )


class RemapPlan(NamedTuple):
    """Two-pass plan of a static remap (undistortion): a vertical resample
    tmp(i,u) = img(i + dy(i,u), u), then a horizontal one
    out(i,j) = tmp(i, j + dx(i,j)), times ``valid``; each pass a 1D linear
    interpolation that reads zeros outside the image."""

    dy: torch.Tensor  # [H, W] vertical displacement sy1(i,u) - i
    dx: torch.Tensor  # [H, W] horizontal displacement sx(i,j) - j
    band_v: tuple  # (lo, hi) ints covering dy
    band_h: tuple  # (lo, hi) ints covering dx
    valid: torch.Tensor  # [H, W] 1.0 where the source pixel is in-image


def build_remap_plan(map_xy, dtype=torch.float32, device=torch.device("cuda")):
    """RemapPlan of a static map [H, W, 2] = (sx, sy) per output pixel (host
    numpy, once at set-up); None for the identity map of a distortion-free
    camera.  Requires sx monotone in j per row (true for undistort maps)."""
    m = np.asarray(map_xy.cpu() if isinstance(map_xy, torch.Tensor) else map_xy, np.float64)
    sx, sy = m[..., 0], m[..., 1]
    H, W = sx.shape
    if (np.abs(sx - np.arange(W)[None, :]).max() < 1e-6
            and np.abs(sy - np.arange(H)[:, None]).max() < 1e-6):
        return None
    if not np.all(np.diff(sx, axis=1) > 0):
        raise ValueError("remap plan requires sx monotone per row")
    cols = np.arange(W, dtype=np.float64)
    rows = np.arange(H, dtype=np.float64)
    sy1 = np.empty_like(sy)
    for i in range(H):
        sy1[i] = np.interp(np.interp(cols, sx[i], cols), cols, sy[i])  # via sx⁻¹ per row
    dy = sy1 - rows[:, None]
    dx = sx - cols[None, :]
    valid = ((sx >= 0.0) & (sx <= W - 1.0) & (sy >= 0.0) & (sy <= H - 1.0)).astype(np.float32)
    t = lambda a: torch.as_tensor(a.astype(np.float32)).to(dtype=dtype, device=device)
    return RemapPlan(dy=t(dy), dx=t(dx),
                     band_v=(int(np.floor(dy.min())), int(np.ceil(dy.max()))),
                     band_h=(int(np.floor(dx.min())), int(np.ceil(dx.max()))),
                     valid=t(valid))


def _banded_pass(img, disp, band, dim):
    """Σ_r tent(disp - r)·shift_r(img) over the static band, zero padding."""
    lo, hi = band
    n = img.shape[dim]
    pv = max(abs(lo), abs(hi)) + 1
    padded = F.pad(img, (0, 0, pv, pv) if dim == 0 else (pv, pv, 0, 0))
    out = torch.zeros_like(img)
    for r in range(lo, hi + 1):
        w = torch.clamp(1.0 - torch.abs(disp - r), 0.0, 1.0)
        out = out + w * padded.narrow(dim, pv + r, n)
    return out


def remap_static_plain(img, plan: RemapPlan):
    """The reference's banded two-pass evaluation of the plan."""
    tmp = _banded_pass(img, plan.dy.to(img.dtype), plan.band_v, 0)
    return _banded_pass(tmp, plan.dx.to(img.dtype), plan.band_h, 1) * plan.valid.to(img.dtype)


def remap_static(img, plan: RemapPlan):
    """K5.  plan None (identity map) is a no-op.  CPU tensor:
    ``remap_static_plain``.  CUDA tensor: one thread per output pixel reads
    two columns, each interpolated vertically at its own dy."""
    if plan is None:
        return img
    if not img.is_cuda:
        return remap_static_plain(img, plan)
    H, W = img.shape
    out = torch.empty_like(img)
    REMAP_STATIC(kernels.check(img, "img", ndim=2), kernels.check(plan.dy, "dy", shape=(H, W)),
                 kernels.check(plan.dx, "dx", shape=(H, W)),
                 kernels.check(plan.valid, "valid", shape=(H, W)), H, W,
                 kernels.check(out, "out"))
    return out
