"""Synthetic visual-inertial world: analytic trajectory, exact IMU samples,
random landmarks.

Port of the parts of ``vplines_slam_tpu/utils/synthetic.py`` the smoke run
and the tests use.  IMU measurements come from ``torch.func`` derivatives of
the analytic trajectory (exact accelerations and body rates).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .geometry import quat_conj, quat_rotate, quat_to_rot, rot_to_quat, ypr_to_rot

GRAVITY = 9.81007  # euroc_config.yaml g_norm


class Trajectory(NamedTuple):
    """Analytic body->world trajectory: position and orientation vs a 0-dim
    time tensor [s]."""

    pos: Callable  # t -> [3]
    quat: Callable  # t -> [4] wxyz


def figure8_trajectory(radius=2.0, height_amp=0.4, omega=0.6283,
                       ypr_amp=(25.0, 8.0, 6.0)):
    """A smooth excited trajectory (figure-8 + oscillating attitude); the
    time tensor's dtype and device carry through."""

    def pos(t):
        s = torch.sin(omega * t)
        return torch.stack([radius * s, radius * s * torch.cos(omega * t),
                            height_amp * torch.sin(1.7 * omega * t)])

    def quat(t):
        ypr = torch.stack([
            ypr_amp[0] * torch.sin(0.9 * omega * t),
            ypr_amp[1] * torch.sin(1.3 * omega * t + 0.4),
            ypr_amp[2] * torch.sin(1.1 * omega * t + 1.1),
        ])
        return rot_to_quat(ypr_to_rot(ypr))

    return Trajectory(pos=pos, quat=quat)


def body_rates(traj: Trajectory, t):
    """Body angular velocity ω_b with [ω]× = Rᵀ R'."""
    R = quat_to_rot(traj.quat(t))
    dR = jacfwd(lambda s: quat_to_rot(traj.quat(s)))(t)
    W = R.T @ dR
    return torch.stack([W[2, 1], W[0, 2], W[1, 0]])


def world_velocity(traj: Trajectory, t):
    return jacfwd(traj.pos)(t)


def world_accel(traj: Trajectory, t):
    return jacfwd(jacfwd(traj.pos))(t)


def imu_samples(traj: Trajectory, times, g_norm=GRAVITY):
    """Noise-free IMU output at times [T]: specific force a_m = R_wbᵀ(a_w + G)
    and body rates.  Returns (accs [T,3], gyrs [T,3])."""
    G = torch.tensor([0.0, 0.0, g_norm], dtype=times.dtype, device=times.device)

    def one(t):
        q = traj.quat(t)
        return quat_rotate(quat_conj(q), world_accel(traj, t) + G), body_rates(traj, t)

    return vmap(one)(times)


def ground_truth_states(traj: Trajectory, times):
    """(p, q, v) at each time [T]."""
    return (vmap(traj.pos)(times), vmap(traj.quat)(times),
            vmap(lambda t: world_velocity(traj, t))(times))


def scatter_landmarks(n, seed=0, box=((-6.0, 6.0), (-6.0, 6.0), (-1.5, 3.5)),
                      dtype=torch.float64, device=torch.device("cuda")):
    """Random 3D points in a box (numpy generator: the same points as the
    reference for the same seed)."""
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in box])
    hi = np.array([b[1] for b in box])
    return torch.as_tensor(rng.uniform(lo, hi, size=(n, 3)), dtype=dtype, device=device)


def loop_trajectory(radius=3.0, omega=2.0 * np.pi / 30.0, height_amp=0.25,
                    wobble_deg=(6.0, 4.0), speed_mod=0.12, radius_mod=0.05):
    """A closed circular survey lap with tangent-following yaw, exactly
    periodic with period 2π/ω (every attitude and height frequency is an
    integer multiple of the lap's), so lap k revisits lap 0's poses exactly:
    the revisit geometry loop closure needs.  The camera (body x) looks
    inward; the 3ω speed and 2ω radius harmonics keep monocular scale
    observable (at constant angular rate the centripetal acceleration is a
    near-constant body vector that the accelerometer bias absorbs)."""

    def pos(t):
        ph = omega * t + speed_mod * torch.sin(3.0 * omega * t)
        r = radius * (1.0 + radius_mod * torch.sin(2.0 * omega * t + 0.7))
        return torch.stack([r * torch.cos(ph), r * torch.sin(ph),
                            height_amp * torch.sin(2.0 * omega * t)])

    def quat(t):
        yaw = (torch.rad2deg(omega * t + speed_mod * torch.sin(3.0 * omega * t))
               + 180.0 + 5.0 * torch.sin(3.0 * omega * t + 1.3))
        pitch = wobble_deg[0] * torch.sin(2.0 * omega * t + 0.4)
        roll = wobble_deg[1] * torch.sin(4.0 * omega * t + 1.1)
        return rot_to_quat(ypr_to_rot(torch.stack([yaw, pitch, roll])))

    return Trajectory(pos=pos, quat=quat)


# ---------------------------------------------------------------------------
# kernel check cases: padded IMU intervals (K10) and VP line sets (K8)
# ---------------------------------------------------------------------------


def imu_interval_cases(seed=0, cap=64, rate_hz=200.0):
    """Padded IMU intervals in the layouts the callers of
    ``models.imu.preintegrate`` build, by name: (dts [B, cap], accs and
    gyrs [B, cap + 1, 3], mask [B, cap], ba, bg [B, 3]) as numpy f64.

    - "frame 20/64": a frame's interval at 200 Hz IMU and 10 Hz frames, 20
      live steps, the rest zero-filled (``VioEngine._pack_imu``);
    - "merged 40/64": two such intervals merged by ``slide_window_new``, the
      padding repeating the last real sample;
    - "merged over capacity": 36 + 40 steps merged past the capacity, so
      decimated 2:1 (adjacent dt summed, every other sample kept);
    - "no live step": an interval with no sample (J = I, P = 0);
    - "masked between live": masked steps with real samples between live
      ones;
    - "B=9 biased": the initializer's nine intervals of 18-26 live steps,
      with non-zero bias linearization points."""
    rng = np.random.default_rng(seed)
    dt0 = 1.0 / rate_hz

    def samples(k):
        acc = np.array([0.3, -0.2, GRAVITY]) + rng.standard_normal((k, 3))
        return acc, 0.5 * rng.standard_normal((k, 3))

    def one(n_live, fill="zero", live=None):
        live = np.arange(n_live) if live is None else np.asarray(live)
        dts, mask = np.zeros(cap), np.zeros(cap, bool)
        dts[live] = dt0 + rng.uniform(-2e-5, 2e-5, len(live))
        mask[live] = True
        accs, gyrs = np.zeros((cap + 1, 3)), np.zeros((cap + 1, 3))
        k = int(live.max()) + 2 if len(live) else 0
        accs[:k], gyrs[:k] = samples(k)
        if fill == "repeat" and k:
            accs[k:], gyrs[k:] = accs[k - 1], gyrs[k - 1]
        elif fill == "all":
            accs, gyrs = samples(cap + 1)
        return dts, accs, gyrs, mask

    def merged(cnt_a, cnt_b):
        # slide_window_new's merge at 2x capacity, decimated 2:1 past it
        dts_a, acc_a, gyr_a, _ = one(cnt_a)
        dts_b, acc_b, gyr_b, _ = one(cnt_b)
        total = cnt_a + cnt_b
        dt2 = np.zeros(2 * cap)
        dt2[:cnt_a], dt2[cnt_a:total] = dts_a[:cnt_a], dts_b[:cnt_b]
        acc2 = np.concatenate([acc_a[:cnt_a], acc_b[:cnt_b + 1]])
        gyr2 = np.concatenate([gyr_a[:cnt_a], gyr_b[:cnt_b + 1]])
        acc2 = np.concatenate([acc2, np.repeat(acc2[-1:], 2 * cap + 1 - len(acc2), 0)])
        gyr2 = np.concatenate([gyr2, np.repeat(gyr2[-1:], 2 * cap + 1 - len(gyr2), 0)])
        mask2 = np.arange(2 * cap) < total
        if total > cap:
            return (dt2[0::2] + dt2[1::2], acc2[0::2][:cap + 1], gyr2[0::2][:cap + 1],
                    mask2[0::2])
        return dt2[:cap], acc2[:cap + 1], gyr2[:cap + 1], mask2[:cap]

    def batch(intervals, bias=0.0):
        B = len(intervals)
        ba = bias * rng.standard_normal((B, 3))
        bg = 0.2 * bias * rng.standard_normal((B, 3))
        return (*(np.stack(x) for x in zip(*intervals)), ba, bg)

    return {
        "frame 20/64": batch([one(20)]),
        "merged 40/64": batch([merged(20, 20)]),
        "merged over capacity": batch([merged(36, 40)]),
        "no live step": batch([one(0)]),
        "masked between live": batch([one(0, "all", [0, 1, 2, 5, 9, 10, 17, 30, 31, 32, 33,
                                                    50, cap - 1])]),
        "B=9 biased": batch([one(18 + b) for b in range(9)], bias=0.05),
    }


VP_CAMERA = (458.654, 367.215, 248.375, 752, 480)  # fx, cx, cy, width, height: EuRoC cam0


def vp_line_cases(seed=0, gate=np.pi / 3.0, dtype=np.float64):
    """Line sets for the VP sphere accumulator, by name: (segs [L, 4] pixel
    segments in ``VP_CAMERA``'s image, valid [L], angles [L] or None):

    - "hot": 64 valid lines through three orthogonal VPs (about 650 pairs
      vote at the VPs, hundreds into one cell);
    - "wrap": lines crossing at the principal point (latitude row 0) and
      two near-parallel pairs crossing far out along +x, just above and
      just below it (latitude row 89 at longitude 0 and 359);
    - "none valid", "one valid": the hot set with no or one valid line;
    - "gate": four lines whose angles are given in ``dtype`` (0, the pair
      gate rounded to it, the next value above, 0.3), so one pair sits on
      the gate and one just past."""
    rng = np.random.default_rng(seed)
    f, cx, cy, W, H = VP_CAMERA
    q = rng.standard_normal(4)
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])

    def through_vps(n):
        out = []
        for k in range(n):
            d = R[:, k % 3]
            x0 = np.array([rng.uniform(50, W - 50), rng.uniform(50, H - 50)])
            u = (np.array([f * d[0] / d[2] + cx, f * d[1] / d[2] + cy]) - x0
                 if abs(d[2]) > 1e-6 else d[:2])
            u = u / np.linalg.norm(u)
            t = rng.uniform(30.0, 150.0)
            out.append(np.concatenate([x0 - 0.5 * t * u, x0 + 0.5 * t * u]))
        return np.array(out)

    wrap = []
    for k in range(8):  # through the principal point, spread in angle
        a = np.pi * k / 8 + 0.01
        u = np.array([np.cos(a), np.sin(a)])
        c = np.array([cx, cy]) + rng.uniform(-0.2, 0.2, 2)
        wrap.append(np.concatenate([c - 60 * u, c + 60 * u]))
    for side in (-1.0, 1.0):  # two near-parallel pairs crossing ~27,800 px out on +x,
        for y0, slope in ((50.0, 1.2e-3), (40.0, 0.84e-3)):  # 17 px above / below cy
            ya = cy + side * y0
            wrap.append([100.0, ya, 700.0, ya - side * 600.0 * slope])
    hot = through_vps(64)
    all64 = np.ones(64, bool)
    g = dtype(gate)
    return {
        "hot": (hot, all64, None),
        "wrap": (np.array(wrap), np.ones(12, bool), None),
        "none valid": (hot, np.zeros(64, bool), None),
        "one valid": (hot, np.arange(64) == 5, None),
        "gate": (through_vps(4), np.ones(4, bool),
                 np.array([0.0, g, np.nextafter(g, dtype(4.0)), 0.3], dtype)),
    }


# ---------------------------------------------------------------------------
# kernel check cases: KLT tracks (K2) and CLAHE images (K9)
# ---------------------------------------------------------------------------


def _textured(rng, H, W, n_blobs=40):
    """Smooth random texture plus gaussian blobs in [0, 1]."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = 0.15 + 0.1 * np.sin(xx / 7.0 + rng.uniform(0, 6)) * np.cos(yy / 9.0)
    for _ in range(n_blobs):
        cx, cy = rng.uniform(8, W - 8), rng.uniform(8, H - 8)
        img += rng.uniform(0.3, 0.7) * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 6.0)
    return np.clip(img, 0.0, 1.0)


def _shifted(img, dx, dy):
    """img resampled bilinearly at (x - dx, y - dy), edge-clamped: the
    content moves by (+dx, +dy)."""
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    x, y = np.clip(xx - dx, 0, W - 1), np.clip(yy - dy, 0, H - 1)
    x0, y0 = np.minimum(np.floor(x).astype(int), W - 2), np.minimum(np.floor(y).astype(int), H - 2)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


def klt_cases(seed=0, H=96, W=128):
    """Tracks for the pyramidal KLT, by name: (img0, img1 [H, W], pts0
    [N, 2], init_flow [N, 2] or None, config overrides of
    ``ops/klt.KLTConfig``) as numpy f64:

    - "border": features on and next to the image border, where the
      template's and the moving window's anchor clips bind;
    - "flat": six features inside a constant square (det <= 1e-12, ok
      false), then textured ones outside it;
    - "past drift": one level, a 7.6 px shift from a zero guess, past the
      in-window drift margin of 5 px, so the re-anchor decides;
    - "gain/bias": the second image 1.25 x the first + 0.05 and shifted, in
      the line matcher's gain/bias mode (win 15, 8 iterations);
    - "empty": no feature;
    - "levels 1" .. "levels 4": 1-4 pyramid levels from an initial flow."""
    rng = np.random.default_rng(seed)
    img0 = _textured(rng, H, W)
    inner = rng.uniform([12, 12], [W - 12, H - 12], (24, 2))
    border = np.array([[0.0, 0.0], [0.5, 40.0], [W - 1.0, 3.0], [W - 0.3, H - 0.3],
                       [2.0, H - 2.0], [W / 2, 0.2], [W / 2, H - 1.0], [6.0, 6.0],
                       [W - 6.5, H / 2]])
    flat = img0.copy()
    flat[20:80, 30:100] = 0.4  # a feature's whole superset (P + 3 = 24 px) inside
    outside = np.array([[12.0, 12.0], [115.0, 12.0], [12.0, 86.0], [116.0, 85.0],
                        [64.0, 8.0], [64.0, 90.0]])
    flat_pts = np.concatenate([rng.uniform([46, 36], [84, 64], (6, 2)), outside])
    init = rng.uniform(-1.5, 1.5, (24, 2)) + np.array([2.6, -1.9])
    cases = {
        "border": (img0, _shifted(img0, 1.7, -0.8), np.concatenate([border, inner[:8]]),
                   None, {}),
        "flat": (flat, _shifted(flat, 1.2, 0.9), flat_pts, None, {}),
        "past drift": (img0, _shifted(img0, 7.6, 6.2), inner, None, {"levels": 1}),
        "gain/bias": (img0, 1.25 * _shifted(img0, 2.3, -1.4) + 0.05, inner, None,
                      {"win": 15, "iters": 8, "illum_adapt": True}),
        "empty": (img0, img0, np.zeros((0, 2)), None, {}),
    }
    for levels in (1, 2, 3, 4):
        cases[f"levels {levels}"] = (img0, _shifted(img0, 3.1, -2.4), inner, init,
                                     {"levels": levels})
    return cases


def line_vote_cases(seed=0, A=8):
    """Inputs of the line matcher's vote (K7), by name: (tracked [L0, A, 2],
    ok [L0, A] bool, segs0 [L0, 4], valid0 [L0], segs1 [L1, 4], valid1 [L1])
    as numpy f64.  The designed cases use dyadic coordinates, so their
    distances, projections and ratios are exact in f32 and f64 alike:

    - "frame": 40 of 64 lines, the current frame's the same lines moved by
      (3, -2) px in another order, anchors tracked with 0.3 px noise and a
      tenth of them lost;
    - "distance ties": anchors midway between two parallel targets, and
      next to a target that appears twice (the lower index must win);
    - "vote ties": a source whose anchors split 4 / 4 between two targets,
      two sources with equal votes for one target, and one with fewer votes
      at a lower index than its rival;
    - "all targets invalid": the frame with no valid current segment;
    - "L1 = 32": the frame matched into 32 current segments;
    - "single valid": one valid source (its consistency is 0 / 1);
    - "collinear midpoints": segments along one line, so sideness reads 0,
      and one of them lifted 2 px off it in the current frame;
    - "zero-length targets": current segments with both ends on an anchor;
    - "gate": anchors exactly max_point_line_dist (4 px) from their target
      (rejected: the gate is strict) and 3.75 px (accepted);
    - "vote ratio": 2 votes of 5 tracked anchors (0.4: accepted) and of 6
      (rejected)."""
    rng = np.random.default_rng(seed)
    t_a = (np.arange(A) + 0.5) / A

    def anchors(segs):  # ops/line_match.sample_anchors' points
        return segs[:, None, :2] + (segs[:, None, 2:] - segs[:, None, :2]) * t_a[None, :, None]

    def padded(segs, n):
        out = np.zeros((n, 4))
        out[:len(segs)] = segs
        return out, np.arange(n) < len(segs)

    def all_ok(L):
        return np.ones((L, A), bool)

    L, nv = 64, 40
    p0 = rng.uniform([20.0, 20.0], [732.0, 460.0], (nv, 2))
    ang, ln = rng.uniform(0.0, np.pi, nv), rng.uniform(40.0, 200.0, nv)
    lines = np.concatenate([p0, p0 + ln[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)], 1)
    s0, v0 = padded(lines, L)
    shift = np.array([3.0, -2.0, 3.0, -2.0])

    def frame(L1):
        slots = rng.permutation(L1)[:min(nv, L1)]
        s1, v1 = np.zeros((L1, 4)), np.zeros(L1, bool)
        s1[slots], v1[slots] = lines[:len(slots)] + shift, True
        tracked = anchors(s0) + shift[:2] + rng.normal(0.0, 0.3, (L, A, 2))
        n_anchor = np.clip(np.ceil(np.hypot(*(s0[:, 2:] - s0[:, :2]).T) / 10.0), 2, A)
        ok = (np.arange(A)[None, :] < n_anchor[:, None]) & v0[:, None] & (rng.random((L, A)) > 0.1)
        return tracked, ok, s0, v0, s1, v1

    # horizontal segments 128 px long from x = 64: anchors at 72, 88, ..., 184
    def hline(y, x0=64.0):
        return [x0, y, x0 + 128.0, y]

    cases = {"frame": frame(L)}
    # distance ties: source 0 at y = 102 between targets at 100 and 104;
    # source 1 at y = 106 next to target 1 and its copy, target 2
    d0 = np.array([hline(102.0), hline(106.0), hline(300.0)])
    d1 = np.array([hline(100.0), hline(104.0), hline(104.0), hline(301.0)])
    s, v = padded(d0, L)
    t, w = padded(d1, L)
    cases["distance ties"] = (anchors(s), all_ok(L) & v[:, None], s, v, t, w)
    # vote ties: source 0's anchors split between targets 0 (y 100) and 1
    # (y 110); sources 1 and 2 give target 2 eight votes each; source 3 gives
    # target 3 six votes, source 4 eight
    g0 = np.array([hline(105.0), hline(200.0), hline(200.0, 65.0), hline(260.0, 300.0),
                   hline(262.0, 300.0), hline(400.0)])
    g1 = np.array([hline(100.0), hline(110.0), hline(200.0), hline(261.0, 300.0),
                   hline(401.0)])
    s, v = padded(g0, L)
    t, w = padded(g1, L)
    tr = anchors(s)
    tr[0, :4, 1], tr[0, 4:, 1] = 100.5, 109.5
    ok = all_ok(L) & v[:, None]
    ok[3, 6:] = False  # six tracked anchors, all on target 3
    cases["vote ties"] = (tr, ok, s, v, t, w)
    tracked, ok, s, v, s1, v1 = frame(L)
    cases["all targets invalid"] = (tracked, ok, s, v, s1, np.zeros(L, bool))
    cases["L1 = 32"] = frame(32)
    tracked, ok, s, v, s1, v1 = frame(L)
    one = np.arange(L) == int(np.flatnonzero(v)[3])
    cases["single valid"] = (tracked, ok & one[:, None], s, one, s1, v1)
    # collinear midpoints: three segments on y = 100 and two vertical ones;
    # in the current frame the third is lifted to y = 102
    c0 = np.array([[8.0, 100.0, 56.0, 100.0], [72.0, 100.0, 120.0, 100.0],
                   [136.0, 100.0, 184.0, 100.0], [300.0, 20.0, 300.0, 180.0],
                   [340.0, 20.0, 340.0, 180.0]])
    c1 = c0.copy()
    c1[2, [1, 3]] = 102.0
    s, v = padded(c0, L)
    t, w = padded(c1, L)
    cases["collinear midpoints"] = (anchors(s), all_ok(L) & v[:, None], s, v, t, w)
    # zero-length targets on source 0's anchors 0 and 1, beside a segment
    # through all of them
    z0 = np.array([hline(150.0), hline(250.0)])
    a0 = anchors(z0[:1])[0]
    z1 = np.array([[*a0[0], *a0[0]], hline(150.0), [*a0[1], *a0[1]], hline(250.0)])
    s, v = padded(z0, L)
    t, w = padded(z1, L)
    cases["zero-length targets"] = (anchors(s), all_ok(L) & v[:, None], s, v, t, w)
    # the gate: source 0's anchors 4 px below its target, source 1's 3.75
    # (two more matches keep source 1 through the sideness filter)
    q0 = np.array([hline(104.0), hline(196.25), hline(300.0), hline(400.0)])
    q1 = np.array([hline(100.0), hline(200.0), hline(300.0), hline(400.0)])
    s, v = padded(q0, L)
    t, w = padded(q1, L)
    cases["gate"] = (anchors(s), all_ok(L) & v[:, None], s, v, t, w)
    # the vote ratio: two of five / six tracked anchors on the target, the
    # others tracked off every segment
    r0 = np.array([hline(100.0), hline(200.0), hline(300.0), hline(302.0)])
    r1 = np.array([hline(100.0), hline(200.0), hline(300.0)])
    s, v = padded(r0, L)
    t, w = padded(r1, L)
    tr = anchors(s)
    ok = all_ok(L) & v[:, None]
    ok[0, 5:], ok[1, 6:] = False, False
    tr[0, 2:5, 1], tr[1, 2:6, 1] = 150.0, 250.0
    cases["vote ratio"] = (tr, ok, s, v, t, w)
    return cases


def line_detect_cases(seed=0):
    """Images for the line detector (K6), by name, numpy f64:

    - "constant": 0.5 everywhere at 480 x 752 (only the zero padding makes
      gradients: anchors on the border);
    - "zero": 480 x 752 of zeros (every cell scores 0: the top-k falls back
      to cell order, and no anchor is ok);
    - "61x97": a textured crop, 28 cells (fewer than max_anchors);
    - "stripes": 480 x 752 of bright 2 px stripes 16 px apart, so every
      cell of a row holds the same values (ties across cells)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:752]
    stripes = np.where((xx % 16 < 2) | (yy % 64 < 2), 0.8, 0.2)
    return {
        "constant": np.full((480, 752), 0.5),
        "zero": np.zeros((480, 752)),
        "61x97": _textured(rng, 61, 97, n_blobs=12),
        "stripes": stripes,
    }


def clahe_cases(seed=0):
    """Images for CLAHE, by name, numpy f64:

    - "constant": every pixel in one bin, so the clip and the spread bind;
    - "outside [0, 1]": values from -0.3 to 1.4 (clipped before binning);
    - "crop": 77 x 101, not multiples of the 8 x 8 tiles, so the histograms
      crop the image and the mapping covers the rest;
    - "random": seeded uniform noise."""
    rng = np.random.default_rng(seed)
    return {
        "constant": np.full((96, 128), 0.37),
        "outside [0, 1]": rng.uniform(-0.3, 1.4, (96, 128)),
        "crop": _textured(rng, 77, 101, n_blobs=20),
        "random": rng.uniform(0.0, 1.0, (96, 128)),
    }


def corner_cases(seed=0):
    """Inputs of Shi-Tomasi ``detect`` (K3), by name: dict(img [H, W] numpy
    f64, max_corners, min_dist, quality, existing_xy [N, 2] or None,
    existing_mask [N] bool or None):

    - "constant", "zero": a 0.5 and an all-zero frame (only the zero padding
      makes gradients; every cell is thresholded or border-killed to 0, so
      the top-k falls back to cell order);
    - "ramp": a linear ramp, a rank-1 structure tensor whose min eigenvalue
      rounds to tiny values of either sign inside the image;
    - "quality < 0": a textured frame at quality -0.01, so the threshold is
      negative (K3's exact path);
    - "ties": the same three dots in every 16 px cell at two brightnesses:
      equal values within a cell (the first index wins) and across cells
      (the lower cell first), max_corners cutting through a tie group;
    - "tracked": tracked features several to a cell with mixed masks (the
      last slot of a cell decides), on cell edges, outside the image;
    - "min_dist 7" ... "min_dist 45": a 61 x 97 crop and a 120 x 160 frame,
      H and W no multiples of min_dist, max_corners above and below the
      cell count."""
    rng = np.random.default_rng(seed)
    case = lambda img, mc, md, q=0.01, exy=None, em=None: dict(
        img=img, max_corners=mc, min_dist=md, quality=q, existing_xy=exy, existing_mask=em)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float64)
    dots = np.full((96, 128), 0.2)
    for cy in range(6):
        for cx in range(8):
            amp = 0.5 if (cx + cy) % 3 == 0 else 0.8
            for oy, ox in ((6, 6), (6, 11), (11, 6)):
                dots[16 * cy + oy, 16 * cx + ox] = amp
    tex = _textured(rng, 96, 128, n_blobs=30)
    exy = np.array([[20.5, 20.5], [21.0, 22.0],            # one cell: set, then clear
                    [50.0, 40.0], [52.0, 41.0],            # clear, then set
                    [70.0, 70.0], [71.0, 72.0], [75.0, 73.0],  # set, clear, set
                    [32.0, 16.0], [47.999996, 31.999998],  # on and just below cell edges
                    [-3.0, 5.0], [200.0, 100.0], [100.0, -0.5]])  # outside the image
    em = np.array([True, False, False, True, True, False, True, True, True, True, False, True])
    cases = {
        "constant": case(np.full((96, 128), 0.5), 40, 16),
        "zero": case(np.zeros((61, 97)), 40, 16),
        "ramp": case(0.002 * xx[:80, :120] + 0.003 * yy[:80, :120], 20, 16),
        "quality < 0": case(tex, 30, 16, q=-0.01),
        "ties": case(dots, 24, 16),
        "tracked": case(tex, 30, 16, exy=exy, em=em),
    }
    crop = _textured(rng, 61, 97, n_blobs=14)
    frame = _textured(rng, 120, 160, n_blobs=40)
    for md, img, mc in ((7, crop, 64), (16, crop, 40), (30, frame, 40), (45, frame, 8)):
        cases[f"min_dist {md}"] = case(img, mc, md)
    return cases


def brief_cases(seed=0, H=96, W=128):
    """Keypoints of BRIEF (K16) on one textured [H, W] frame, by name: (img
    numpy f64, xy [K, 2], valid [K] bool):

    - "edge": on the image's edges and corners (taps in the zero pad);
    - "beyond": outside the image, some far (every tap padded);
    - "straddling": within the pattern's 17 px of an edge;
    - "fractional": inside, at non-integer positions;
    - "K 0", "K 1": no keypoint, one;
    - "keyframe": 564 keypoints (a keyframe's 500 corners and 64 window
      points) over the frame and 20 px past it, a tenth invalid."""
    rng = np.random.default_rng(seed)
    img = _textured(rng, H, W, n_blobs=30)
    edge = np.array([[0.0, 0.0], [W - 1.0, H - 1.0], [0.0, H / 2], [W / 2, 0.0],
                     [W - 0.5, 10.25], [37.75, H - 0.25], [W - 1.0, 0.0], [0.0, H - 1.0]])
    beyond = np.array([[-20.0, 30.0], [W + 20.0, 10.0], [-100.0, -100.0],
                       [W + 3.5, H + 2.25], [40.0, -16.5], [55.5, H + 16.75]])
    straddle = np.concatenate([rng.uniform([1, 1], [16, H - 1], (6, 2)),
                               rng.uniform([W - 16, 1], [W - 1, H - 1], (6, 2)),
                               rng.uniform([1, 1], [W - 1, 16], (6, 2))])
    frac = rng.uniform([18, 18], [W - 18, H - 18], (24, 2))
    kf = rng.uniform([-20, -20], [W + 20, H + 20], (564, 2))
    kf[:100] = np.round(kf[:100])  # corners sit on pixels
    ones = lambda n: np.ones(n, bool)
    return {
        "edge": (img, edge, ones(len(edge))),
        "beyond": (img, beyond, ones(len(beyond))),
        "straddling": (img, straddle, ones(len(straddle))),
        "fractional": (img, frac, ones(len(frac))),
        "K 0": (img, np.zeros((0, 2)), ones(0)),
        "K 1": (img, frac[:1], ones(1)),
        "keyframe": (img, kf, rng.uniform(size=564) >= 0.1),
    }


def _pgo_rows(rng, K, n, yaw0=0.0):
    """n keyframes of a database of capacity K along a 3 m circle (64 a lap)
    with a drifting yaw and translation, the rows beyond n as empty_db leaves
    them: (p [K, 3], ypr [K, 3] deg)."""
    a = 2 * np.pi * np.arange(n) / 64
    yaw_d = np.cumsum(rng.normal(0, 0.3, n))
    t_d = np.cumsum(rng.normal(0, 0.02, (n, 3)), axis=0)
    p = np.zeros((K, 3))
    ypr = np.zeros((K, 3))
    p[:n] = np.stack([3 * np.cos(a), 3 * np.sin(a), 0.2 * np.sin(2 * a)], 1) + t_d
    ypr[:n] = np.stack([np.degrees(a) + yaw0 + yaw_d, 4 * np.sin(a), 3 * np.cos(a)], 1)
    ypr[:n, 0] = np.mod(ypr[:n, 0] + 180.0, 360.0) - 180.0
    return p, ypr


def pgo_cases(seed=0, K=64):
    """Databases for the 4-DoF pose graph (K19), by name: dict(count, seq
    [K], p_vio [K, 3], q_vio [K, 4], p_pgo, yaw_pgo, loop_to [K], loop_t
    [K, 3], loop_yaw [K], numpy f64 / int64, and grow: whether the caller
    doubles it with ``grow_db`` first); p_pgo and yaw_pgo start off the VIO
    poses, as after an earlier PGO:

    - "empty": count 0; "count 1": one keyframe;
    - "full": count K, a loop edge every 9 keyframes from keyframe 34, onto
      the keyframe half a lap back;
    - "sequence change": a loaded map (seq 0, held fixed) of 8 keyframes,
      then seq 1 and, from keyframe 30, seq 2: the sequential edges across
      each change are cut; loops from seq 2 into seq 1 and seq 0;
    - "loop into 0": three loop edges onto keyframe 0, one of them from
      keyframe 2, inside the band of sequential edges;
    - "two loops into one": keyframes 40 and 52 both onto keyframe 7, and a
      pair of keyframes looping onto each other;
    - "yaw wrap": yaws around +-180 deg and loop yaws of exactly +180 and
      -180 between keyframes half a lap apart;
    - "grown": a full database of capacity K / 2 with loops, grown to K."""
    rng = np.random.default_rng(seed)

    def case(n, loops=(), seq=None, cap=K, yaw0=180.0, grow=False):
        p, ypr = _pgo_rows(rng, cap, n, yaw0)
        q = rot_to_quat(ypr_to_rot(torch.from_numpy(ypr))).numpy()
        q[n:] = 0.0
        loop_to = np.full(cap, -1, np.int64)
        loop_t, loop_yaw = np.zeros((cap, 3)), np.zeros(cap)
        for j, c, yaw in loops:
            loop_to[j] = c
            loop_t[j] = rng.normal(0, 0.1, 3)
            loop_yaw[j] = rng.normal(0, 2.0) if yaw is None else yaw
        seq = np.ones(cap, np.int64) if seq is None else np.asarray(seq, np.int64)
        drift = np.zeros((cap, 4))
        drift[:n] = rng.normal(0, [1.0, 0.05, 0.05, 0.05], (n, 4))
        return dict(count=n, seq=seq, p_vio=p, q_vio=q, p_pgo=p + drift[:, 1:],
                    yaw_pgo=np.where(np.arange(cap) < n, ypr[:, 0] + drift[:, 0], 0.0),
                    loop_to=loop_to, loop_t=loop_t, loop_yaw=loop_yaw, grow=grow)

    free = [(j, j - 32, None) for j in range(34, K, 9)]
    seq = np.ones(K, np.int64)
    seq[:8] = 0
    seq[30:] = 2
    return {
        "empty": case(0),
        "count 1": case(1),
        "full": case(K, free),
        "sequence change": case(K - 4, [(34, 20, None), (40, 3, None), (50, 31, None)], seq),
        "loop into 0": case(K - 6, [(2, 0, None), (33, 0, None), (45, 0, None)]),
        "two loops into one": case(K, [(40, 7, None), (52, 7, None), (20, 47, None),
                                       (47, 20, None)]),
        "yaw wrap": case(K - 2, [(35, 3, 180.0), (45, 13, -180.0), (50, 18, 180.0)],
                         yaw0=90.0),
        "grown": case(K // 2, [(20, 2, None), (31, 12, None)], cap=K // 2, grow=True),
    }


def pnp_cases(seed=0, N=24, n_hyp=24):
    """Inputs of the PnP hypotheses (K18), by name: (X_w [N, 3], x [N, 2]
    normalized observations, mask [N] bool, idx [n_hyp, 6] int64 draws,
    threshold), numpy f64.  A pose R = ypr(20, -5, 3), t = (0.2, -0.1, 0.3)
    sees points 2-6 m ahead with 1e-3 noise, a quarter of them outliers:

    - "repeated draws": rows that draw a point two or three times (a repeat
      counts once);
    - "masked samples": a fifth of the points masked, drawn anyway;
    - "fewer than six": rows of 1-5 distinct points, and rows whose masked
      draws leave fewer than six;
    - "coplanar": every point on one plane (the DLT's null space is 4-dim:
      no unique pose);
    - "near coplanar": a plane with 1 cm of relief (a textured wall);
    - "behind the camera": points at depth -2 m and 0.04 m whose
      observations are their projections, some drawn;
    - "on the threshold": no noise, and points whose reprojection error is
      the threshold times 1 -+ 1e-7, either side of the strict test."""
    rng = np.random.default_rng(seed)
    R = ypr_to_rot(torch.tensor([20.0, -5.0, 3.0], dtype=torch.float64)).numpy()
    t = np.array([0.2, -0.1, 0.3])
    thr = 8.0 / 460.0

    def scene(Xc, noise=1e-3, outliers=0.25):
        x = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, noise, (len(Xc), 2))
        bad = rng.random(len(Xc)) < outliers
        x[bad] = rng.uniform(-0.6, 0.6, (bad.sum(), 2))
        return (Xc - t) @ R, x

    def ahead(n):
        return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                         rng.uniform(2, 6, n)], 1)

    def draws(n_rows=n_hyp, k=6, pool=N):
        return np.stack([rng.choice(pool, k, replace=False) for _ in range(n_rows)])

    out = {}
    X, x = scene(ahead(N))
    idx = draws()
    idx[::2, 1] = idx[::2, 0]
    idx[1::4, 2:4] = idx[1::4, 0:2]
    out["repeated draws"] = (X, x, np.ones(N, bool), idx, thr)
    X, x = scene(ahead(N))
    mask = rng.random(N) >= 0.2
    out["masked samples"] = (X, x, mask, draws(), thr)
    X, x = scene(ahead(N))
    idx = draws()
    for r in range(0, n_hyp, 2):
        base = idx[r, :1 + (r // 2) % 5].copy()
        idx[r] = rng.permutation(np.concatenate([base, rng.choice(base, 6 - len(base))]))
    mask = np.ones(N, bool)
    mask[idx[1::2, :2].reshape(-1)[:6]] = False
    out["fewer than six"] = (X, x, mask, idx, thr)
    Xc = ahead(N)
    Xw = (Xc - t) @ R
    Xw[:, 2] = 1.5 + 0.3 * Xw[:, 0] - 0.2 * Xw[:, 1]
    out["coplanar"] = (Xw,) + scene(Xw @ R.T + t)[1:] + (np.ones(N, bool), draws(), thr)
    Xw = Xw.copy()
    Xw[:, 2] += rng.uniform(-0.01, 0.01, N)
    out["near coplanar"] = (Xw,) + scene(Xw @ R.T + t)[1:] + (np.ones(N, bool), draws(), thr)
    Xc = ahead(N)
    Xc[:3, 2] = -2.0
    Xc[3:5, 2] = 0.04
    Xw, x = scene(Xc, outliers=0.0)
    out["behind the camera"] = (Xw, x, np.ones(N, bool), draws(), thr)
    Xc = ahead(N)
    Xw, x = scene(Xc, noise=0.0, outliers=0.0)
    ang = rng.uniform(0, 2 * np.pi, 8)
    side = np.where(np.arange(8) % 2 == 0, 1 - 1e-7, 1 + 1e-7)
    x[-8:] += thr * side[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)
    out["on the threshold"] = (Xw, x, np.ones(N, bool), draws(pool=N - 8), thr)
    return out


def _flip_bits(rng, desc, n_bits, avoid=None):
    """desc [8] int32 with n_bits distinct bits flipped (none of those in
    avoid, a set of bit positions), and the flipped positions."""
    pool = np.setdiff1d(np.arange(256), np.fromiter(avoid or (), int, len(avoid or ())))
    bits = rng.choice(pool, n_bits, replace=False)
    out = desc.view(np.uint32).copy()
    for b in bits:
        out[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out.view(np.int32), set(bits.tolist())


def _hamming_np(da, db):
    x = da.view(np.uint32)[:, None, :] ^ db.view(np.uint32)[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def match_cases(seed=0):
    """Inputs of the Hamming match (K17's ``match_descriptors``), by name:
    (da [N, 8] int32, va [N] bool, db [M, 8] int32, vb [M] bool), numpy.
    Queries are copies of database columns with 0-40 bits flipped (a tenth
    of them random), columns random, a tenth of each invalid, unless a
    case says otherwise:

    - "M 1", "M 17" (under a warp), "M 1100" (over 1,024; several column
      slices a CTA), "N 1", "N 64 x M 500" (a verification's shape), "N 1100"
      (over 32 x 32 rows);
    - "columns invalid", "rows invalid": every column / every row invalid;
    - "ties": rows with their best at two equal columns (the lower index
      wins), columns whose best row is two equal rows (the lower wins, so the
      other fails the mutual check), and a second column at the best's value
      (second - dist = 0);
    - "margin 16 / 15": rows whose second is exactly 16 and 15 above the
      best;
    - "dist 80 / 79": rows whose best is exactly 80 and 79, the second far
      above."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(np.int32)

    def case(N, M, p_valid=0.9):
        db = rand(M)
        src = rng.integers(0, M, N)
        da = np.stack([_flip_bits(rng, db[j], int(rng.integers(0, 41)))[0] for j in src])
        bad = rng.random(N) < 0.1
        da[bad] = rand(int(bad.sum()))
        return da, rng.random(N) < p_valid, db, rng.random(M) < p_valid

    out = {"M 1": case(64, 1), "M 17": case(64, 17), "M 1100": case(64, 1100),
           "N 1": case(1, 500), "N 64 x M 500": case(64, 500), "N 1100": case(1100, 500)}
    da, va, db, vb = case(64, 500)
    out["columns invalid"] = (da, va, db, np.zeros(500, bool))
    out["rows invalid"] = (da, np.zeros(64, bool), db, vb)
    # ties: rows 0-7 see two identical columns; rows 8-9 and 10-11 are equal
    # pairs of rows; row 12's second column sits at its best's value
    da, va, db, vb = case(64, 500, p_valid=1.0)
    for r in range(8):
        j1, j2 = 20 * r + 3, 20 * r + 11
        db[j2] = db[j1]
        da[r] = _flip_bits(rng, db[j1], 5 + r)[0]
    da[8], da[10] = _flip_bits(rng, db[400], 1)[0], _flip_bits(rng, db[450], 2)[0]
    da[9], da[11] = da[8], da[10]
    da[12], used = _flip_bits(rng, db[300], 12)
    db[301] = _flip_bits(rng, da[12], 12, avoid=used)[0]
    out["ties"] = (da, va, db, vb)
    # the second exactly 16 / 15 above a best of 10 (rows 0-3), and a best of
    # exactly 80 / 79 (rows 4-7)
    da, va, db, vb = case(64, 500, p_valid=1.0)
    for r, (best, gap) in enumerate(((10, 16), (10, 15), (20, 16), (20, 15))):
        j = 40 * r + 7
        da[r] = _flip_bits(rng, db[j], best)[0]
        db[j + 1] = _flip_bits(rng, da[r], best + gap)[0]
    out["margin 16 / 15"] = (da, va, db, vb)
    da, va, db, vb = case(64, 500, p_valid=1.0)
    for r, best in enumerate((80, 79, 80, 79)):
        da[r] = _flip_bits(rng, db[50 * r + 9], best)[0]
    out["dist 80 / 79"] = (da, va, db, vb)
    return out


def pnp_refine_cases(seed=0):
    """Inputs of the PnP refinement (K21's ``pnp_refine``), by name: (R0
    [B, 3, 3], t0 [B, 3], X_w [N, 3] shared or [B, N, 3], x [B, N, 2]
    normalized observations, mask [B, N] bool), numpy f64.  Poses about 0.2
    rad from the identity see points 2-6 m ahead with 1e-3 noise, ~20% of
    them masked, from a start rotated about a random axis and moved 5 cm:

    - "at the truth": noise-free observations from the true pose, so every
      step's w stays in so3_exp's small-angle branch (|w|^2 < 1e-12);
    - "2 deg", "10 deg", "30 deg": starts that far off (B 2);
    - "3 unmasked": only three points unmasked (six residuals for six
      parameters: J^T J is square but ill-conditioned);
    - "all masked": padded points at the origin with t0 = 0, all masked
      (0/0 residuals: non-finite, as in the reference);
    - "N 1", "N 6", "N 64", "N 100", "N 128": point counts (one point leaves
      J^T J of rank 2 apart from the 1e-8);
    - "shared X 11 x 128": the initializer's batch, one point set;
      "per-problem X 4 x 100": a point set a problem."""
    rng = np.random.default_rng(seed)
    f64 = torch.float64

    def exp(w):
        from .geometry import so3_exp_matrix

        return so3_exp_matrix(torch.as_tensor(w, dtype=f64)).numpy()

    def case(B, N, deg, shared=True, noise=1e-3, p_mask=0.2, exact_start=False):
        X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                      rng.uniform(2, 6, N)], 1)
        R0s, t0s, Xs, xs, ms = [], [], [], [], []
        for _ in range(B):
            Xb = X if shared else X + rng.normal(0, 0.1, X.shape)
            R, t = exp(rng.normal(0, 0.2, 3)), rng.normal(0, 0.3, 3)
            Xc = Xb @ R.T + t
            xs.append(Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, noise, (N, 2)))
            axis = rng.normal(size=3)
            R0s.append(R if exact_start else exp(np.radians(deg) * axis / np.linalg.norm(axis)) @ R)
            t0s.append(t if exact_start else t + rng.normal(0, 0.05, 3))
            ms.append(rng.random(N) >= p_mask)
            Xs.append(Xb)
        return (np.stack(R0s), np.stack(t0s), X if shared else np.stack(Xs), np.stack(xs),
                np.stack(ms))

    out = {"at the truth": case(1, 64, 0.0, noise=0.0, p_mask=0.0, exact_start=True)}
    for deg in (2, 10, 30):
        out[f"{deg} deg"] = case(2, 64, float(deg))
    R0, t0, X, x, m = case(1, 64, 10.0)
    m[:] = False
    m[0, [3, 17, 40]] = True
    out["3 unmasked"] = (R0, t0, X, x, m)
    out["all masked"] = (np.eye(3)[None], np.zeros((1, 3)), np.zeros((8, 3)),
                         np.zeros((1, 8, 2)), np.zeros((1, 8), bool))
    for n in (1, 6, 64, 100, 128):
        out[f"N {n}"] = case(1, n, 10.0, p_mask=0.0 if n <= 6 else 0.2)
    out["shared X 11 x 128"] = case(11, 128, 10.0)
    out["per-problem X 4 x 100"] = case(4, 100, 10.0, shared=False)
    return out


# ---------------------------------------------------------------------------
# kernel check cases: FAST (K15) and the selector's information (K20)
# ---------------------------------------------------------------------------


def _dots(H, W, ys, xs, levels):
    """A black [H, W] float32 image with single bright pixels at (ys, xs)."""
    img = np.zeros((H, W), np.float32)
    img[np.asarray(ys), np.asarray(xs)] = np.asarray(levels, np.float32)
    return img


def fast_cases(seed=0):
    """Images of ``detect_fast`` (K15), by name, float32 [H, W] numpy.  A
    lone bright pixel on black is a FAST corner whose score depends only on
    its level (16 equal margins), so equal levels give equal scores:

    - "ties over k": 768 dots 4 px apart (no dot in another's ring or 7x7
      window) at four levels, so the 1st, 60th and 500th places fall inside
      runs of equal scores;
    - "fewer than k": 40 dots, so slots 40.. are the zero-score fill;
    - "flat": a constant image, no corner: every slot is fill;
    - "plateau": 2x2 bright blocks (four equal scores in one 7x7 window, all
      kept) and 3x3 blocks (the centre's 16 margins beat the rest);
    - "edge": dots on the first and last rows and columns outside the 16 px
      border (16 and H - 17, 16 and W - 17) and just inside it (15, H - 16:
      score 0);
    - "33x40" (its scored pixels are one row of 8: three dots there, random
      0/1 rows beyond their rings), "97x131" (a noisy texture): sizes no
      multiple of K15's 32 px tile; "24x32": all border (no pixel scored);
    - "two-level": a random 0/1 image, many equal scores;
    - "frame 752x480": a noisy textured frame at the profile's size;
    - "binary 752x480": a random 0/1 frame (~3,900 kept corners, as many as
      a rendered keyframe's);
    - "dots 752x480": 20,160 dots 4 px apart at four levels, more kept
      corners than K15 stages in shared memory (16,384)."""
    rng = np.random.default_rng(seed)
    H, W = 128, 160
    gy, gx = np.mgrid[16:H - 16:4, 16:W - 16:4]
    levels = rng.choice(np.array([0.35, 0.55, 0.75, 0.95]), size=gy.size,
                        p=[0.3, 0.3, 0.25, 0.15])
    cases = {"ties over k": _dots(H, W, gy.ravel(), gx.ravel(), levels)}
    pick = rng.choice(gy.size, 40, replace=False)
    cases["fewer than k"] = _dots(H, W, gy.ravel()[pick], gx.ravel()[pick],
                                  rng.uniform(0.2, 1.0, 40))
    cases["flat"] = np.full((H, W), 0.5, np.float32)
    plateau = np.zeros((H, W), np.float32)
    for i, (y, x) in enumerate(((20, 20), (20, 60), (60, 100), (90, 30), (100, 130))):
        s = 2 if i % 2 == 0 else 3
        plateau[y:y + s, x:x + s] = 0.6
    cases["plateau"] = plateau
    ys = [16, 16, H - 17, H - 17, 16, H - 17, 70, 50, 15, H - 16, 60, 80]
    xs = [16, W - 17, 16, W - 17, 80, 90, 16, W - 17, 40, 50, 15, W - 16]
    cases["edge"] = _dots(H, W, ys, xs, np.linspace(0.4, 0.9, len(ys)))
    noise = lambda h, w: np.clip(_textured(rng, h, w, n_blobs=max(4, h * w // 600))
                                 + rng.uniform(-0.04, 0.04, (h, w)), 0, 1).astype(np.float32)
    binary = lambda h, w: (rng.random((h, w)) < 0.5).astype(np.float32)
    small = binary(33, 40)
    small[13:20] = 0.0
    small[16, [16, 20, 23]] = (0.5, 0.8, 0.8)
    cases["33x40"] = small
    cases["97x131"] = noise(97, 131)
    cases["24x32"] = noise(24, 32)
    cases["two-level"] = binary(96, 128)
    cases["frame 752x480"] = noise(480, 752)
    cases["binary 752x480"] = binary(480, 752)
    gy, gx = np.mgrid[16:480 - 16:4, 16:752 - 16:4]
    cases["dots 752x480"] = _dots(480, 752, gy.ravel(), gx.ravel(),
                                  rng.choice(np.array([0.35, 0.55, 0.75, 0.95]), size=gy.size))
    return cases


def _quat_np(w):
    """The unit quaternion [w, x, y, z] of the rotation vector w (numpy)."""
    th = float(np.linalg.norm(w))
    if th == 0.0:
        return np.array([1.0, 0.0, 0.0, 0.0])
    return np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * np.asarray(w) / th])


def selector_info_cases(seed=0):
    """Inputs of the selector's information (K20's ``selector_info``,
    ``feature_information``), by name: dict(rays [N, 3], depths [N],
    track_valid [N] bool, ps [nh, 3], qs [nh, 4], q_ic [4], p_ic [3],
    obs_frame), numpy f64.  A horizon of nh states ~0.1 m apart with small
    rotations, a EuRoC-like extrinsic, candidates as a frame gives them (a
    tenth far outside the field of view, a tenth within the 0.2 m depth
    gate, a fifth with track_valid false):

    - "N {1, 150} nh {2, 5, 8} obs {0, 1}", "N 1000 nh 5 obs 1": sizes (K20
      takes nh <= 8; the one candidate of N 1 in view of every state);
    - "seen by 1 / 2 states": identity extrinsic and rotations, states 0.5 m
      apart along x: one landmark only state 1 sees, one states 1 and 2 see
      (and one states 1-4);
    - "track_valid false": every candidate's mask off;
    - "behind, depth 0": landmarks behind every camera, and one at depth 0
      (at the observing camera's centre: 0 / 0 in its visibility test);
    - "visibility edges": identity extrinsic and rotations (every rotation
      exact), the observing state at the origin and the others 0.25 m apart
      along x, landmarks at z = 0.2 and at |x / z| = 0.75 exactly from the
      observing state (both invisible there: the tests are strict) beside
      ones just inside;
    - "nearly parallel": landmarks 50 m to 100 km ahead over a 0.1 m
      baseline, so sum C is near singular (only the 1e-9 I keeps it
      invertible)."""
    rng = np.random.default_rng(seed)
    q_euroc = np.array([0.5, -0.5, 0.5, -0.5])
    p_euroc = np.array([0.05, 0.02, 0.03])
    ident = np.array([1.0, 0.0, 0.0, 0.0])

    def horizon(nh):
        ps = np.cumsum(rng.normal(0.0, 0.03, (nh, 3)) + [0.1, 0.0, 0.02], axis=0)
        qs = np.stack([_quat_np(rng.normal(0.0, 0.05, 3)) for _ in range(nh)])
        return ps, qs

    def candidates(N):
        if N == 1:  # one candidate, in view of every state at 4 m
            return np.array([[0.1, -0.05, 1.0]]) / np.sqrt(1.0125), np.array([4.0]), [True]
        xy = rng.uniform(-0.8, 0.8, (N, 2))
        xy[: N // 10] = rng.uniform(2.0, 5.0, (N // 10, 2))
        rays = np.concatenate([xy, np.ones((N, 1))], 1)
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        depths = rng.uniform(1.5, 8.0, N)
        depths[N // 10: N // 5] = rng.uniform(0.05, 0.2, N // 10)
        return rays, depths, rng.uniform(size=N) >= 0.2

    def case(rays, depths, valid, ps, qs, q_ic=q_euroc, p_ic=p_euroc, obs=1):
        return dict(rays=np.asarray(rays, np.float64), depths=np.asarray(depths, np.float64),
                    track_valid=np.asarray(valid, bool), ps=np.asarray(ps, np.float64),
                    qs=np.asarray(qs, np.float64), q_ic=np.asarray(q_ic, np.float64),
                    p_ic=np.asarray(p_ic, np.float64), obs_frame=obs)

    out = {}
    for N in (1, 150):
        for nh in (2, 5, 8):
            for obs in (0, 1):
                out[f"N {N} nh {nh} obs {obs}"] = case(*candidates(N), *horizon(nh), obs=obs)
    out["N 1000 nh 5 obs 1"] = case(*candidates(1000), *horizon(5))
    # states 0.5 m apart along x looking along z: the landmark at x = 0
    # (from state 1: -0.5) only state 1 sees, at x = 0.5 states 1 and 2
    ps_x = np.array([[0.5 * k, 0.0, 0.0] for k in range(5)])
    qs_1 = np.tile(ident, (5, 1))
    X1 = np.array([[-0.5, 0.1, 1.0], [0.0, -0.1, 1.0], [0.5, 0.0, 2.0]])
    d1 = np.linalg.norm(X1, axis=1)
    out["seen by 1 / 2 states"] = case(X1 / d1[:, None], d1, [True] * 3, ps_x, qs_1, ident,
                                       np.zeros(3))
    r, d, _ = candidates(150)
    out["track_valid false"] = case(r, d, np.zeros(150, bool), *horizon(5))
    ps5, qs5 = horizon(5)
    back = np.concatenate([rng.uniform(-0.5, 0.5, (6, 2)), -np.ones((6, 1))], 1)
    back /= np.linalg.norm(back, axis=1, keepdims=True)
    out["behind, depth 0"] = case(np.concatenate([back, [[0.0, 0.0, 1.0], [0.6, 0.0, 0.8]]]),
                                  np.concatenate([rng.uniform(1.0, 5.0, 6), [0.0, 0.0]]),
                                  [True] * 8, ps5, qs5)
    # exact edges: z = 0.2 (ray * 1.0 = the point), |x / z| = 0.75, |y / z| =
    # 0.75, and points just inside them
    edge = np.array([[0.1, 0.0, 0.2], [0.75, 0.0, 1.0], [-0.75, 0.25, 1.0], [0.0, 0.75, 1.0],
                     [0.0, -1.5, 2.0], [0.1, 0.0, 0.20000000000000004],
                     [0.7499999999999999, 0.0, 1.0], [0.0, -0.7499999, 1.0], [0.25, 0.5, 2.0]])
    ps_e = np.array([[0.25 * (k - 1), 0.0, 0.0] for k in range(5)])
    out["visibility edges"] = case(edge, np.ones(len(edge)), [True] * len(edge), ps_e,
                                   np.tile(ident, (5, 1)), ident, np.zeros(3))
    far = np.concatenate([rng.uniform(-0.05, 0.05, (5, 2)), np.ones((5, 1))], 1)
    far /= np.linalg.norm(far, axis=1, keepdims=True)
    ps_b = np.array([[0.025 * k, 0.0, 0.0] for k in range(5)])
    out["nearly parallel"] = case(far, [50.0, 1e3, 1e4, 1e5, 3e3], [True] * 5, ps_b,
                                  np.tile(ident, (5, 1)), ident, np.zeros(3))
    return out


# ---------------------------------------------------------------------------
# kernel check cases: the essential-matrix RANSAC (K4)
# ---------------------------------------------------------------------------


def _two_view(rng, N, noise, outliers, R=None, t=None):
    """N points 3-8 m ahead of camera 1 seen by camera 2 (x2 ~ R x1 + t) with
    Gaussian noise on x2 and a fraction of outliers moved up to 0.2 away:
    (x1 [N, 2], x2 [N, 2]) normalized, numpy f64."""
    if R is None:
        R = ypr_to_rot(torch.tensor([4.0, -2.0, 1.5], dtype=torch.float64)).numpy()
        t = np.array([0.3, 0.05, 0.02])
    X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(3, 8, N)], 1)
    X2 = X @ R.T + t
    x1, x2 = X[:, :2] / X[:, 2:3], X2[:, :2] / X2[:, 2:3] + rng.normal(0, noise, (N, 2))
    bad = rng.random(N) < outliers
    x2[bad] += rng.uniform(-0.2, 0.2, (bad.sum(), 2))
    return x1, x2


def ransac_cases(seed=0):
    """Inputs of the essential-matrix RANSAC (K4's ``ransac_essential``), by
    name: dict(x1 [N, 2], x2 [N, 2] normalized points, mask [N] bool, idx
    [n_hyp, 8] int64 draws in [0, N), threshold, min_valid), numpy f64.
    Draw i takes the (draw % max(n_valid, 8))-th valid entry, so with every
    entry valid a draw is the index itself.

    - "tracker 32 x 150": a tracked frame's shape, 15 tracks masked, 10%
      outliers, 0.25 px of noise, the tracker's 1 px gate, random draws;
    - "initializer 64 x 128": the initializer's shape and its 3 px gate;
    - "repeated draws": rows that draw an entry two or three times (a sample
      is a set: fewer than 8 distinct rows, no unique fit);
    - "fewer than 8 valid": 6 valid entries (draws past them drop);
    - "exactly 8 valid": noise-free, every row a permutation of the 8 (one
      fit, every count tied) or with repeats;
    - "draws on invalid entries": 5 valid entries and every draw mapped past
      them, so every sample is empty;
    - "tie": noise-free points of two motions, 20 each, a 1e-4 gate; row 3
      samples motion B, row 5 motion A, the others both: rows 3 and 5 tie
      and the first (B) wins;
    - "refit loses": a scene whose least-squares refit on the winner's
      inliers scores fewer than the winner (better is false);
    - "all outliers": x2 unrelated to x1;
    - "11 valid, gated" and "12 valid": the tracker's gate (min_valid 12) on
      either side."""
    rng = np.random.default_rng(seed)

    def draws(n_hyp, pool, k=8):
        return np.stack([rng.choice(pool, k, replace=False) for _ in range(n_hyp)])

    def case(x1, x2, mask, idx, thr, min_valid=0):
        return dict(x1=x1, x2=x2, mask=mask, idx=idx.astype(np.int64), threshold=thr,
                    min_valid=min_valid)

    out = {}
    x1, x2 = _two_view(rng, 150, 5e-4, 0.1)
    mask = np.ones(150, bool)
    mask[rng.choice(150, 15, replace=False)] = False
    out["tracker 32 x 150"] = case(x1, x2, mask, rng.integers(0, 150, (32, 8)), 1.0 / 460.0)
    x1, x2 = _two_view(rng, 128, 5e-4, 0.05)
    mask = rng.random(128) >= 0.2
    out["initializer 64 x 128"] = case(x1, x2, mask, rng.integers(0, 128, (64, 8)), 3.0 / 460.0)
    x1, x2 = _two_view(rng, 40, 1e-3, 0.1)
    idx = draws(16, 40)
    idx[::2, 1] = idx[::2, 0]
    idx[1::4, 2:5] = idx[1::4, 0:1]
    out["repeated draws"] = case(x1, x2, np.ones(40, bool), idx, 1.0 / 460.0)
    x1, x2 = _two_view(rng, 40, 0.0, 0.0)
    mask = np.zeros(40, bool)
    mask[rng.choice(40, 6, replace=False)] = True
    out["fewer than 8 valid"] = case(x1, x2, mask, rng.integers(0, 40, (16, 8)), 1.0 / 460.0)
    x1, x2 = _two_view(rng, 40, 0.0, 0.0)
    mask = np.zeros(40, bool)
    mask[rng.choice(40, 8, replace=False)] = True
    idx = np.stack([rng.permutation(8) + 8 * rng.integers(0, 5, 8) for _ in range(16)])
    idx[8:, 0] = idx[8:, 1]
    out["exactly 8 valid"] = case(x1, x2, mask, idx, 1.0 / 460.0)
    x1, x2 = _two_view(rng, 40, 1e-3, 0.0)
    mask = np.zeros(40, bool)
    mask[rng.choice(40, 5, replace=False)] = True
    out["draws on invalid entries"] = case(x1, x2, mask,
                                           5 + rng.integers(0, 3, (16, 8)) + 8 * rng.integers(
                                               0, 4, (16, 8)), 1.0 / 460.0)
    xa1, xa2 = _two_view(rng, 20, 0.0, 0.0)
    R_b = ypr_to_rot(torch.tensor([-6.0, 3.0, -2.0], dtype=torch.float64)).numpy()
    xb1, xb2 = _two_view(rng, 20, 0.0, 0.0, R_b, np.array([-0.1, 0.25, 0.05]))
    idx = np.concatenate([draws(16, 20, 4), 20 + draws(16, 20, 4)], 1)
    idx[3], idx[5] = 20 + draws(1, 20)[0], draws(1, 20)[0]
    out["tie"] = case(np.concatenate([xa1, xb1]), np.concatenate([xa2, xb2]), np.ones(40, bool),
                      idx, 1e-4)
    out["refit loses"] = _refit_loses(rng)
    x1, x2 = rng.uniform(-0.6, 0.6, (40, 2)), rng.uniform(-0.6, 0.6, (40, 2))
    out["all outliers"] = case(x1, x2, np.ones(40, bool), rng.integers(0, 40, (16, 8)),
                               1.0 / 460.0)
    x1, x2 = _two_view(rng, 40, 1e-3, 0.2)
    for n in (11, 12):
        mask = np.zeros(40, bool)
        mask[:n] = True
        out[f"{n} valid" + (", gated" if n < 12 else "")] = case(
            x1, x2, mask, rng.integers(0, 40, (16, 8)), 1.0 / 460.0, min_valid=12)
    return out


def essential_rows(x1, x2, sm):
    """The 8-point rows kron(h2, h1) at f64, masked by each row of sm [n, N]:
    [n, N, 9]."""
    h1 = torch.cat([x1.double(), torch.ones_like(x1[:, :1], dtype=torch.float64)], 1)
    h2 = torch.cat([x2.double(), torch.ones_like(x2[:, :1], dtype=torch.float64)], 1)
    return (h2[:, :, None] * h1[:, None, :]).reshape(-1, 9) * sm.double()[..., None]


def essential_fit_determined(x1, x2, sm):
    """Per sample mask row of sm [n, N], whether its 8-point E is determined
    by the data rather than by an eigensolver's rounding: A^T A (f64) has a
    relative gap above 1e-10 between its two smallest eigenvalues and the E
    of its smallest eigenvector has sigma_2 above 1e-4 sigma_1 (the rank-2
    projection is unique).  Returns (determined, the relative gap); an
    eigenvector of A^T A is good to ~eps / gap."""
    A = essential_rows(x1, x2, sm)
    lam, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    gap = (lam[:, 1] - lam[:, 0]) / lam[:, -1]
    sv = torch.linalg.svdvals(V[:, :, 0].reshape(-1, 3, 3))
    return (gap > 1e-10) & (sv[:, 1] > 1e-4 * sv[:, 0]), gap


def essential_samples(mask, draws):
    """The reference's remap of RANSAC draws [n_hyp, 8]: draw i -> the (draw
    % max(n_valid, 8))-th entry of the stable valid-first order (an index
    past the valid ones lands on an invalid entry).  Returns (idx [n_hyp,
    8], sample masks [n_hyp, N])."""
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    idx = order[draws % torch.clamp(mask.sum(), min=8)]
    sm = torch.zeros(draws.shape[0], mask.shape[0], dtype=torch.bool, device=mask.device)
    return idx, sm.scatter(1, idx, True) & mask


def essential_determined(x1, x2, mask, idx):
    """Per sample row of idx [n_hyp, 8] (indices into the N points, after
    ``essential_samples``' remap), whether its hypothesis is determined:
    eight distinct valid rows (``full``) whose fit ``essential_fit_determined``
    accepts.  Returns (full, determined)."""
    srt = torch.sort(idx, dim=1).values
    full = (srt[:, 1:] != srt[:, :-1]).all(1) & mask[idx].all(1)
    sm = torch.zeros(idx.shape[0], mask.shape[0], dtype=torch.bool, device=mask.device)
    sm = sm.scatter(1, idx, True) & mask
    return full, full & essential_fit_determined(x1, x2, sm)[0]



def _refit_loses(rng, tries=200):
    """The first of ``tries`` noisy scenes (2 px of noise, 40 points, a 3 px
    gate, 16 hypotheses of distinct draws) whose refit on the winner's
    inliers scores fewer inliers than the winner, as ``ransac_cases``
    entry."""
    from ..ops import mvg

    T = lambda a: torch.from_numpy(np.asarray(a))
    for _ in range(tries):
        x1, x2 = _two_view(rng, 40, 4e-3, 0.15)
        idx = np.stack([rng.choice(40, 8, replace=False) for _ in range(16)])
        mask = np.ones(40, bool)
        thr = 3.0 / 460.0
        _, _, n, Es, counts, inls, E_ref = mvg.ransac_essential_plain(
            T(x1), T(x2), T(mask), T(idx), thr, return_hypotheses=True)
        best = int(torch.argmax(counts))
        n_ref = int(mvg.sampson_score_plain(E_ref[None], T(x1), T(x2), T(mask), thr)[0][0])
        if n_ref < int(counts[best]):
            return dict(x1=x1, x2=x2, mask=mask, idx=idx.astype(np.int64), threshold=thr,
                        min_valid=0)
    raise RuntimeError("no scene whose refit loses inliers")
