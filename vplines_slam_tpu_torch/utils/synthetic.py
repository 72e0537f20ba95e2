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
