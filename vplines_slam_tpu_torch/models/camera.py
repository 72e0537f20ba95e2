"""Pinhole + radial-tangential camera model.

Port of the PINHOLE branch of ``vplines_slam_tpu/models/camera.py``
(``project``/``lift`` with fixed-iteration Newton undistortion,
``undistort_rectify_map``).  The
equidistant, MEI and Scaramuzza models are not ported yet.

Intrinsics are 0-dim tensors and ``dist`` a [5] tensor on the camera's
device; 0-dim tensors do not promote the dtype of the pixel arrays they meet
(as JAX's weakly-typed scalars do not).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PINHOLE = 0


class CameraModel(NamedTuple):
    """dist layout (PINHOLE): [k1, k2, p1, p2, 0]."""

    kind: int
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # [5]
    width: int = 752
    height: int = 480


def pinhole(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, width=752, height=480,
            dtype=torch.float64, device=torch.device("cuda")):
    t = lambda v: torch.tensor(float(v), dtype=dtype, device=device)
    return CameraModel(
        PINHOLE, t(fx), t(fy), t(cx), t(cy),
        torch.tensor([k1, k2, p1, p2, 0.0], dtype=dtype, device=device),
        width, height,
    )


def _radtan_distort(xy, k1, k2, p1, p2):
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2
    dx = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x + dx, y + dy], dim=-1)


def _radtan_undistort(xy_d, k1, k2, p1, p2):
    """Newton inverse of the rad-tan model (5 fixed iterations, analytic 2x2
    jacobian)."""
    xy = xy_d
    for _ in range(5):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        rad = k1 * r2 + k2 * r2 * r2
        fx_ = x * (1.0 + rad) + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xy_d[..., 0]
        fy_ = y * (1.0 + rad) + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y - xy_d[..., 1]
        drad_dr2 = k1 + 2.0 * k2 * r2
        j00 = 1.0 + rad + 2.0 * x * x * drad_dr2 + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = 2.0 * x * y * drad_dr2 + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = 2.0 * x * y * drad_dr2 + 2.0 * p1 * x + 2.0 * p2 * y
        j11 = 1.0 + rad + 2.0 * y * y * drad_dr2 + 6.0 * p1 * y + 2.0 * p2 * x
        det = j00 * j11 - j01 * j10
        x = x - (j11 * fx_ - j01 * fy_) / det
        y = y - (-j10 * fx_ + j00 * fy_) / det
        xy = torch.stack([x, y], dim=-1)
    return xy


def _check(cam: CameraModel):
    if cam.kind != PINHOLE:
        raise ValueError(f"camera kind {cam.kind} is not ported (pinhole only)")


def project(cam: CameraModel, X):
    """3D point(s) in camera frame -> (pixel uv [..,2], valid = z > 0)."""
    _check(cam)
    z = X[..., 2]
    xy = X[..., 0:2] / z[..., None]
    d = cam.dist
    xyd = _radtan_distort(xy, d[0], d[1], d[2], d[3])
    u = cam.fx * xyd[..., 0] + cam.cx
    v = cam.fy * xyd[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1), z > 0


def lift(cam: CameraModel, uv):
    """Pixel coords -> normalized image coords [x, y, 1]."""
    _check(cam)
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    d = cam.dist
    xy = _radtan_undistort(torch.stack([mx, my], dim=-1), d[0], d[1], d[2], d[3])
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def undistort_rectify_map(cam: CameraModel, fx_new=None, fy_new=None, cx_new=None,
                          cy_new=None):
    """Remap grid [H, W, 2] from an ideal-pinhole output image into the
    distorted input (initUndistortRectifyMap parity): for each undistorted
    output pixel, its source pixel in the raw image.  As in the reference,
    the normalized grid is f32 (its intrinsics are weakly typed there) and
    the distortion runs in the dtype of ``dist``."""
    fx_new = cam.fx if fx_new is None else fx_new
    fy_new = cam.fy if fy_new is None else fy_new
    cx_new = cam.cx if cx_new is None else cx_new
    cy_new = cam.cy if cy_new is None else cy_new
    dev = cam.fx.device
    v, u = torch.meshgrid(torch.arange(cam.height, dtype=torch.float32, device=dev),
                          torch.arange(cam.width, dtype=torch.float32, device=dev),
                          indexing="ij")
    X = torch.stack([(u - cx_new) / fx_new, (v - cy_new) / fy_new, torch.ones_like(u)], -1)
    return project(cam, X.to(cam.dist.dtype))[0]
