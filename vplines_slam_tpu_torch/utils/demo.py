"""Staging a synthetic run: extrinsic, blob-world renderer, IMU batches and
the truth-seeded warm-up.

Port of the parts of ``vplines_slam_tpu/utils/demo.py`` a smoke run needs
(``forward_camera_extrinsic``, ``BlobWorldRenderer``), plus
``truth_seeded_start``: the steady-state loop needs an initialized window,
and the initializer (``estimator/initializer.py``) is not ported yet.  In
its place the warm-up puts the first frames' states at truth and fills the
window with the port's OWN trackers (points, and lines when asked) on
rendered frames (the reference's
``synthetic_window`` used projections instead).
"""

from __future__ import annotations

import numpy as np
import torch

from ..estimator import window as win_mod
from ..estimator.slide import _set_row, ingest_frame, set_imu_interval
from ..models import camera as cam_mod
from ..models import feature_tracker as ft_mod
from ..models import line_tracker as lt_mod
from ..ops.image import build_remap_plan, remap_static
from . import geometry as geo
from . import synthetic as syn


def forward_camera_extrinsic(dtype=torch.float64, device=torch.device("cuda")):
    """Body <- camera extrinsic of a forward-looking camera (q_ic, p_ic)."""
    R_BC = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]],
                        dtype=dtype, device=device)
    return geo.rot_to_quat(R_BC), torch.tensor([0.05, 0.02, 0.03], dtype=dtype, device=device)


class BlobWorldRenderer:
    """Renderer of a static landmark world: gaussian blobs in a world-anchored
    textured room (cylinder wall + floor + ceiling, ray-cast per pixel).  The
    landmark layout and texture bank come from a numpy generator seeded as the
    reference's, so the same seed gives the same world."""

    def __init__(self, cam, q_ic, p_ic, n_pts=700, seed=4,
                 box=((-4, 4), (-4, 4), (-1, 2.5)), dtype=torch.float32,
                 device=torch.device("cuda"), wall_radius=8.0, floor_z=-1.4, ceil_z=3.2,
                 tex_octaves=14, blob_chunk=64, tex_gain=3.0, grid_band=0.04,
                 grid_dark=0.3):
        self.cam = cam
        self.H, self.W = int(cam.height), int(cam.width)
        self.dtype, self.device = dtype, device
        rng = np.random.default_rng(seed)
        n_wall = int(0.40 * n_pts)
        n_floor = int(0.25 * n_pts)
        n_ceil = int(0.10 * n_pts)
        n_int = n_pts - n_wall - n_floor - n_ceil
        th = rng.uniform(-np.pi, np.pi, n_wall)
        zw = rng.uniform(floor_z + 0.2, ceil_z - 0.2, n_wall)
        rw = wall_radius - 0.05
        Xw = np.stack([rw * np.cos(th), rw * np.sin(th), zw], 1)
        phf = rng.uniform(-np.pi, np.pi, n_floor)
        rf = np.sqrt(rng.uniform(0.05, 1.0, n_floor)) * (wall_radius - 0.3)
        Xf = np.stack([rf * np.cos(phf), rf * np.sin(phf),
                       np.full(n_floor, floor_z + 0.05)], 1)
        phc = rng.uniform(-np.pi, np.pi, n_ceil)
        rc = np.sqrt(rng.uniform(0.05, 1.0, n_ceil)) * (wall_radius - 0.3)
        Xc_ = np.stack([rc * np.cos(phc), rc * np.sin(phc),
                        np.full(n_ceil, ceil_z - 0.05)], 1)
        Xi = syn.scatter_landmarks(n_int, seed=seed, box=box, device="cpu").numpy()
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self.X = t(np.concatenate([Xw, Xf, Xc_, Xi], 0))
        self.brightness = t(rng.uniform(0.35, 0.9, n_pts))
        self.q_ic, self.p_ic = t(q_ic.cpu()), t(p_ic.cpu())
        self.wall_radius, self.floor_z, self.ceil_z = wall_radius, floor_z, ceil_z
        f = rng.uniform(0.3, 5.0, (tex_octaves, 2)) * rng.choice([-1.0, 1.0], (tex_octaves, 2))
        self.tex_f = t(2.0 * np.pi * f)
        self.tex_ph = t(rng.uniform(0, 2 * np.pi, tex_octaves))
        self.tex_a = t(rng.uniform(0.5, 1.0, tex_octaves) / np.sqrt(np.arange(1, tex_octaves + 1)))
        self.blob_chunk = blob_chunk
        # texture contrast, and the room's grid (straight 3D lines on floor,
        # ceiling and the wall's verticals): band half-width (m) and darkening
        self.tex_gain, self.grid_band, self.grid_dark = tex_gain, grid_band, grid_dark
        self.cam_r = cam_mod.CameraModel(*[
            v.to(dtype=dtype, device=device) if isinstance(v, torch.Tensor) else v
            for v in cam])

    def _surface_texture(self, u, v, sel):
        s = torch.einsum("k,hwk->hw", self.tex_a, torch.cos(
            u[..., None] * self.tex_f[:, 0] + v[..., None] * self.tex_f[:, 1]
            + self.tex_ph + sel * 2.1))
        t = 0.5 + 0.5 * torch.tanh(s * self.tex_gain)
        gu = torch.abs(torch.remainder(u, 1.5) - 0.75) > 0.75 - self.grid_band
        gv = torch.abs(torch.remainder(v, 1.5) - 0.75) > 0.75 - self.grid_band
        return t * torch.where(gu | gv, self.grid_dark, 1.0)

    @torch.no_grad()
    def render(self, q_wb, p_wb):
        """One [H, W] frame at body pose (q_wb, p_wb)."""
        H, W, dtype, dev = self.H, self.W, self.dtype, self.device
        q_wb = torch.as_tensor(q_wb).to(dtype=dtype, device=dev)
        p_wb = torch.as_tensor(p_wb).to(dtype=dtype, device=dev)
        q_cw, p_cw = geo.pose_inverse(*geo.pose_compose(q_wb, p_wb, self.q_ic, self.p_ic))
        Xc = geo.transform_point(q_cw, p_cw, self.X)
        cam = self.cam_r
        uv, _ = cam_mod.project(cam, Xc)
        vis = ((Xc[:, 2] > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < W - 5)
               & (uv[:, 1] > 5) & (uv[:, 1] < H - 5))
        yy, xx = torch.meshgrid(torch.arange(H, dtype=dtype, device=dev),
                                torch.arange(W, dtype=dtype, device=dev), indexing="ij")
        # world-anchored background: per-pixel ray cast into the room.  The
        # rays are lifted through the camera's distortion (the reference casts
        # undistorted pinhole rays, which puts the texture off the camera
        # model whenever the camera has distortion)
        R_wc = geo.quat_to_rot(geo.quat_conj(q_cw))
        p_c = -(R_wc @ p_cw)
        d = cam_mod.lift(cam, torch.stack([xx, yy], dim=-1))
        dw = torch.einsum("ij,hwj->hwi", R_wc, d)
        eps = 1e-9
        a = dw[..., 0] ** 2 + dw[..., 1] ** 2
        b = 2.0 * (p_c[0] * dw[..., 0] + p_c[1] * dw[..., 1])
        c = p_c[0] ** 2 + p_c[1] ** 2 - self.wall_radius ** 2
        disc = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
        t_wall = (-b + disc) / (2.0 * torch.clamp(a, min=eps))
        dz = dw[..., 2]
        t_floor = (self.floor_z - p_c[2]) / torch.where(torch.abs(dz) < eps, -eps, dz)
        t_ceil = (self.ceil_z - p_c[2]) / torch.where(torch.abs(dz) < eps, eps, dz)
        big = torch.full_like(t_wall, 1e6)
        t_floor = torch.where(t_floor > 0, t_floor, big)
        t_ceil = torch.where(t_ceil > 0, t_ceil, big)
        t_wall = torch.where(t_wall > 0, t_wall, big)
        t_hit = torch.minimum(t_wall, torch.minimum(t_floor, t_ceil))
        w = p_c + t_hit[..., None] * dw
        u_wall = torch.atan2(w[..., 1], w[..., 0]) * self.wall_radius
        tex = torch.where(
            t_hit == t_wall, self._surface_texture(u_wall, w[..., 2], 0),
            torch.where(t_hit == t_floor, self._surface_texture(w[..., 0], w[..., 1], 1),
                        self._surface_texture(w[..., 0], w[..., 1], 2)))
        img = (0.10 + 0.38 * tex) / (1.0 + 0.06 * t_hit)
        for k0 in range(0, self.X.shape[0], self.blob_chunk):
            sl = slice(k0, k0 + self.blob_chunk)
            d2 = (xx - uv[sl, 0, None, None]) ** 2 + (yy - uv[sl, 1, None, None]) ** 2
            amp = (vis[sl].to(dtype) * self.brightness[sl])[:, None, None]
            img = img + torch.sum(amp * torch.exp(-d2 / 4.5), dim=0)
        return torch.clamp(img, 0.0, 1.0)


def imu_batches(accs, gyrs, imu_dt, steps_per_frame, n_frames, max_imu):
    """Padded IMU batches (dts [T,I], accs [T,I+1,3], gyrs, mask [T,I],
    has_imu [T]) for the intervals ending at frames 1..n_frames, with frame
    k at sample k·steps_per_frame of the evenly spaced streams accs/gyrs."""
    r, I = steps_per_frame, max_imu
    if r > I:
        raise ValueError(f"{r} IMU steps per frame exceed the capacity {I}")
    dtype, dev = accs.dtype, accs.device
    T = n_frames
    dts = torch.zeros(T, I, dtype=dtype, device=dev)
    dts[:, :r] = imu_dt
    mask = torch.zeros(T, I, dtype=torch.bool, device=dev)
    mask[:, :r] = True
    idx = torch.arange(1, T + 1, device=dev)[:, None] * r - r + torch.arange(r + 1, device=dev)
    A = torch.zeros(T, I + 1, 3, dtype=dtype, device=dev)
    G = torch.zeros(T, I + 1, 3, dtype=dtype, device=dev)
    A[:, : r + 1] = accs[idx]
    G[:, : r + 1] = gyrs[idx]
    return dts, A, G, mask, torch.ones(T, dtype=torch.bool, device=dev)


def truth_seeded_start(cam, tracker_cfg: ft_mod.TrackerConfig, cfg: win_mod.WindowConfig,
                       params, q_ic, p_ic, truth, imgs, batches, frame_times,
                       frame_dt, ransac_idx, line_cfg=None, map_xy=None, vp_u=None):
    """Initialized (fe_state, state, data) after the first NF-1 frames, or
    (fe_state, state, data, ln_state) with the line front-end (line_cfg,
    map_xy and the VP draws vp_u [NF-1, n_pairs, 2] given).

    truth = (p, q, v) [NF, ...] states at the first NF frame times; imgs
    [NF-1, H, W]; batches = IMU batches of the intervals ending at frames
    1..NF-2 (as from ``imu_batches``); ransac_idx [NF-1, hyps, 8].  States
    sit at truth; the tracker runs on every frame and its tracks are
    ingested; the IMU intervals are preintegrated at zero bias; the tracks
    are then triangulated.  Slot NF-1 stays free for the first steady-state
    frame, as after the reference's initialization slide."""
    nf = cfg.nf
    dtype, dev = truth[0].dtype, truth[0].device
    state = win_mod.empty_state(cfg, dtype, dev)._replace(
        p=truth[0], q=truth[1], v=truth[2], q_ic=q_ic, p_ic=p_ic)
    data = win_mod.empty_tracks(cfg, dtype, dev)
    fe = ft_mod.init_state(tracker_cfg, cam.height, cam.width, imgs.dtype, dev)
    if line_cfg is not None:
        ln = lt_mod.init_state(line_cfg, cam.height, cam.width, imgs.dtype, dev)
        plan = build_remap_plan(map_xy, dtype=imgs.dtype, device=dev)
        ideal = cam_mod.pinhole(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                                width=cam.width, height=cam.height, dtype=cam.fx.dtype,
                                device=dev)
    for k in range(nf - 1):
        fe, feats = ft_mod.step(fe, imgs[k], cam, tracker_cfg, frame_dt, ransac_idx[k])
        ln_args = ()
        if line_cfg is not None:
            ln, lout = lt_mod.step(ln, remap_static(imgs[k], plan), ideal, line_cfg, vp_u[k])
            ln_args = (lout.ids, lout.endpoints, lout.vp_dirs, lout.vp_valid)
        data = ingest_frame(data, cfg, k, feats.ids, feats.rays.to(dtype), *ln_args)
        data = data._replace(frame_t=_set_row(
            data.frame_t, k, torch.tensor(float(frame_times[k]), dtype=dtype, device=dev)))
        if k > 0:
            b = [x[k - 1] for x in batches]
            data = set_imu_interval(data, k - 1, b[0], b[1], b[2], b[3], params=params)
    data = win_mod.triangulate_points(state, data, cfg)
    if line_cfg is None:
        return fe, state, data
    return fe, state, data, ln
