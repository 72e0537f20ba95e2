"""Parity of the port's line front-end with the JAX reference (torch f64 on
the CPU against JAX x64): Plücker algebra, line/VP residuals, the static
undistortion remap, line detection, the gain/bias KLT, line matching, VP
detection and one line-tracker step.

The frames are long bright segments on a smooth texture, 240x320, and a copy
rendered with the scene shifted by a few pixels, so that lines are found,
tracked and matched.  VP pair draws are JAX's own uniforms, handed to the
port (see ``ops/vp.py``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.factors import residuals as jres
from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import line_tracker as jlt
from vplines_slam_tpu.ops import image as jimage
from vplines_slam_tpu.ops import klt as jklt
from vplines_slam_tpu.ops import line_match as jlm
from vplines_slam_tpu.ops import lines as jlines
from vplines_slam_tpu.ops import vp as jvp
from vplines_slam_tpu.utils import plucker as jplk
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.factors import residuals as tres
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import line_tracker as tlt
from vplines_slam_tpu_torch.ops import image as timage
from vplines_slam_tpu_torch.ops import klt as tklt
from vplines_slam_tpu_torch.ops import line_match as tlm
from vplines_slam_tpu_torch.ops import lines as tlines
from vplines_slam_tpu_torch.ops import vp as tvp
from vplines_slam_tpu_torch.utils import plucker as tplk

torch.set_num_threads(1)

H, W = 240, 320
SEGS = [(30, 40, 290, 52), (40, 200, 280, 160), (150, 20, 162, 220), (60, 30, 72, 210),
        (230, 60, 250, 215), (20, 120, 300, 128), (90, 70, 210, 230), (200, 25, 300, 100)]
SHIFT = (3.0, -2.0)  # scene motion between the two frames (px)
F_IDEAL = (250.0, 250.0, 160.0, 120.0)


def T(a):
    return torch.as_tensor(np.array(a))


def close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out), atol=atol, rtol=rtol)


def segment_frame(shift=(0.0, 0.0)):
    """Bright 1.5 px-wide segments on a smooth texture, the scene shifted by
    ``shift`` px."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    x, y = xx + shift[0], yy + shift[1]
    img = 0.3 + 0.1 * np.sin(x / 7.3) * np.cos(y / 5.1) + 0.05 * np.sin((x + 2 * y) / 3.1)
    for x1, y1, x2, y2 in SEGS:
        ab = np.array([x2 - x1, y2 - y1], float)
        t = np.clip(((x - x1) * ab[0] + (y - y1) * ab[1]) / (ab @ ab), 0, 1)
        d = np.hypot(x - x1 - t * ab[0], y - y1 - t * ab[1])
        img = np.maximum(img, 0.9 * np.exp(-d ** 2 / 4.5))
    return np.clip(img, 0.0, 1.0)


@pytest.fixture(scope="module")
def frames():
    return segment_frame(), segment_frame(SHIFT)


_jdetect = jax.jit(jlines.detect_lines, static_argnums=1)


@pytest.fixture
def jax_line_tracker_x64(monkeypatch):
    """The reference's ``line_tracker.step`` does not trace under x64: its
    ``lax.cond`` on ``has_prev`` returns ``match_lines``' int64 argmax in one
    branch and an int32 fill in the other.  Under the f32 configuration it
    runs in (TPU), both are int32.  This fixture gives the reference module a
    ``jax`` whose ``lax.cond`` casts int64 branch outputs to int32, so it
    traces in x64 with the same values; nothing else changes."""
    yield from patch_line_tracker_cond(monkeypatch)


def patch_line_tracker_cond(monkeypatch):
    import types

    def cond(pred, true_fun, false_fun, *operands):
        to32 = lambda f: lambda *a: jax.tree_util.tree_map(
            lambda x: x.astype(jnp.int32) if x.dtype == jnp.int64 else x, f(*a))
        return jax.lax.cond(pred, to32(true_fun), to32(false_fun), *operands)

    shim = types.SimpleNamespace(lax=types.SimpleNamespace(cond=cond))
    monkeypatch.setattr(jlt, "jax", shim)
    yield


def vp_uniforms(key, cfg):
    """The uniforms ``detect_vps(..., key)`` draws its line pairs from."""
    k1, _ = jax.random.split(key)
    return np.asarray(jax.random.uniform(k1, (cfg.n_pairs, 2), dtype=jnp.float64))


# ---------------------------------------------------------------------------
# Plücker algebra and the line / VP residuals
# ---------------------------------------------------------------------------


def test_plucker_matches_jax():
    rng = np.random.default_rng(0)
    orth = rng.uniform(-1.2, 1.2, (6, 4))
    delta = rng.standard_normal((6, 4)) * 0.1
    R = np.asarray(jax.vmap(lambda w: jax.scipy.linalg.expm(jnp.cross(
        jnp.eye(3), w)))(jnp.asarray(rng.standard_normal((6, 3)))))
    t = rng.standard_normal((6, 3))
    for i in range(6):
        jp = jplk.orth_to_plk(jnp.asarray(orth[i]))
        close(jp, tplk.orth_to_plk(T(orth[i])), atol=1e-14)
        close(jplk.plk_to_orth(jp), tplk.plk_to_orth(T(np.asarray(jp))), atol=1e-12)
        close(jplk.orth_boxplus(jnp.asarray(orth[i]), jnp.asarray(delta[i])),
              tplk.orth_boxplus(T(orth[i]), T(delta[i])), atol=1e-13)
        close(jplk.plk_transform(jp, jnp.asarray(R[i]), jnp.asarray(t[i])),
              tplk.plk_transform(T(np.asarray(jp)), T(R[i]), T(t[i])), atol=1e-13)
        close(jplk.plk_transform_inv(jp, jnp.asarray(R[i]), jnp.asarray(t[i])),
              tplk.plk_transform_inv(T(np.asarray(jp)), T(R[i]), T(t[i])), atol=1e-13)
    x = rng.standard_normal((3, 3))
    jpi = jplk.pi_from_ppp(*map(jnp.asarray, x))
    close(jpi, tplk.pi_from_ppp(*map(T, x)), atol=1e-14)
    pi2 = rng.standard_normal(4)
    close(jplk.pipi_plk(jpi, jnp.asarray(pi2)), tplk.pipi_plk(T(np.asarray(jpi)), T(pi2)),
          atol=1e-14)
    # batched: the port's functions broadcast where the reference vmaps
    close(jax.vmap(jplk.orth_to_plk)(jnp.asarray(orth)), tplk.orth_to_plk(T(orth)), atol=1e-14)


def test_line_and_vp_residuals_match_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p, p_ic = rng.standard_normal(3), rng.standard_normal(3) * 0.1
    for k in range(5):
        orth = rng.uniform(-1.2, 1.2, 4)
        obs = rng.standard_normal(4) * 0.3
        vp = np.append(rng.standard_normal(2), 1.0)
        args = [p, q[0], p_ic, q[1], orth]
        close(jres.line_reprojection(*map(jnp.asarray, args), jnp.asarray(obs)),
              tres.line_reprojection(*map(T, args), T(obs)), atol=1e-12)
        close(jres.vp_alignment(*map(jnp.asarray, args), jnp.asarray(vp)),
              tres.vp_alignment(*map(T, args), T(vp)), atol=1e-10, rtol=1e-12)
        plk = np.asarray(jplk.orth_to_plk(jnp.asarray(orth)))
        close(jres._point_to_line_residual(jnp.asarray(plk), jnp.asarray(obs)),
              tres._point_to_line_residual(T(plk), T(obs)), atol=1e-12)
    r_sq = rng.uniform(0, 10, 7)
    close(jres.cauchy_weight(jnp.asarray(r_sq), 1.0), tres.cauchy_weight(T(r_sq), 1.0), atol=1e-15)


# ---------------------------------------------------------------------------
# undistortion remap (K5)
# ---------------------------------------------------------------------------


def test_remap_static_matches_jax(frames):
    K = (230.0, 229.0, 161.0, 118.0, -0.29, 0.08, 5e-5, -1.6e-4)
    jc = jcam.pinhole(*K, width=W, height=H)
    tc = tcam.pinhole(*K, width=W, height=H, device="cpu")
    jmap = jcam.undistort_rectify_map(jc)
    # the reference squares the f32 pixel grid in f32 before its f64
    # distortion terms (weakly typed intrinsics, strongly typed dist); the
    # port distorts all in f64: 1e-5 px apart
    close(jmap, tcam.undistort_rectify_map(tc), atol=1e-5)
    jplan = jimage.build_remap_plan(jmap)
    tplan = timage.build_remap_plan(T(np.asarray(jmap)), dtype=torch.float64, device="cpu")
    assert tplan.band_v == jplan.band_v and tplan.band_h == jplan.band_h
    assert jplan.band_v[1] - jplan.band_v[0] >= 4  # a real (non-identity) remap
    close(jplan.dy, tplan.dy, atol=0.0)
    close(jplan.valid, tplan.valid, atol=0.0)
    img = frames[0]
    out = timage.remap_static(T(img), tplan)
    close(jimage.remap_static(jnp.asarray(img), jplan), out, atol=1e-12)
    assert float(out.max()) > 0.8
    # an identity map gives no plan, and no plan is a no-op
    ident = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1)
    assert timage.build_remap_plan(ident, device="cpu") is None
    x = T(img)
    assert timage.remap_static(x, None) is x


# ---------------------------------------------------------------------------
# line detection (K6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frame", [0, 1])
def test_detect_lines_matches_jax(frames, frame):
    img = frames[frame]
    cfg = jlines.LineDetectConfig(max_lines=32)
    js, jl, jv = _jdetect(jnp.asarray(img), cfg)
    ts, tl, tv = tlines.detect_lines(T(img), tlines.LineDetectConfig(max_lines=32))
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert int(tv.sum()) >= len(SEGS)  # every drawn segment, at least
    close(js, ts, atol=1e-9)
    close(jl, tl, atol=1e-9)
    h, v = tlines.classify_hv(ts, tv)
    jh, jvv = jlines.classify_hv(js, jv)
    assert np.array_equal(np.asarray(jh), h.numpy()) and np.array_equal(np.asarray(jvv), v.numpy())
    assert bool(h.any()) and bool(v.any())
    # seg_angle folds with a floor-mod: angles of reversed segments agree
    rev = ts[:, [2, 3, 0, 1]]
    close(tlines.seg_angle(ts), tlines.seg_angle(rev), atol=1e-12)


# ---------------------------------------------------------------------------
# gain/bias KLT (K2 mode) and line matching (K7)
# ---------------------------------------------------------------------------


def test_gain_bias_klt_matches_jax(frames):
    img0, img1 = frames
    img1 = 0.7 * img1 + 0.1  # an illumination change the gain/bias fit absorbs
    rng = np.random.default_rng(5)
    pts = np.array([[0.5 * (x1 + x2), 0.5 * (y1 + y2)] for x1, y1, x2, y2 in SEGS])
    pts = np.concatenate([pts, rng.uniform([20, 20], [W - 20, H - 20], (8, 2))])
    jcfg = jklt.KLTConfig(win=15, levels=3, iters=8, illum_adapt=True, min_eig=1e-6)
    tcfg = tklt.KLTConfig(win=15, levels=3, iters=8, illum_adapt=True, min_eig=1e-6)
    jp, jok, jr = jax.jit(jklt.track, static_argnums=3)(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), jcfg)
    tp, tok, tr = tklt.track(T(img0), T(img1), T(pts), tcfg)
    assert np.array_equal(np.asarray(jok), tok.numpy())
    close(jp, tp, atol=1e-8)
    close(jr, tr, atol=1e-10)
    # the patches follow the scene (up to the aperture along each line)
    assert int(tok.sum()) >= 12
    a = jklt._gain_bias(jnp.asarray(img0[:15, :15]), jnp.asarray(img1[:15, :15]))
    close(a, tklt._gain_bias(T(img0[:15, :15]), T(img1[:15, :15])), atol=1e-14)


def test_match_lines_matches_jax(frames):
    img0, img1 = frames
    cfg = jlines.LineDetectConfig(max_lines=32)
    js0, _, jv0 = _jdetect(jnp.asarray(img0), cfg)
    js1, _, jv1 = _jdetect(jnp.asarray(img1), cfg)
    jm, jvotes = jax.jit(jlm.match_lines, static_argnums=6)(
        jnp.asarray(img0), jnp.asarray(img1), js0, jv0, js1, jv1, jlm.LineMatchConfig())
    tm, tvotes = tlm.match_lines(T(img0), T(img1), *map(T, (js0, jv0, js1, jv1)),
                                 tlm.LineMatchConfig())
    assert np.array_equal(np.asarray(jm), tm.numpy())
    close(jvotes, tvotes, atol=0.0)
    assert int((tm >= 0).sum()) >= len(SEGS)
    # the topological filter drops a match whose sideness flips
    segs0 = T(np.asarray(js0))
    forged = tm.clone()
    ok = torch.nonzero(tm >= 0)[:, 0]
    forged[ok[0]], forged[ok[1]] = tm[ok[1]], tm[ok[0]]
    jf = jlm.topological_filter(jnp.asarray(js0), jnp.asarray(js1), jnp.asarray(forged.numpy()),
                                jlm.LineMatchConfig())
    tf = tlm.topological_filter(segs0, T(np.asarray(js1)), forged)
    assert np.array_equal(np.asarray(jf), tf.numpy())


# ---------------------------------------------------------------------------
# vanishing points (K8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 11])
def test_detect_vps_matches_jax(frames, seed):
    js, _, jv = _jdetect(jnp.asarray(frames[0]), jlines.LineDetectConfig(max_lines=32))
    cfg = jvp.VPConfig()
    key = jax.random.PRNGKey(seed)
    f, _, cx, cy = F_IDEAL
    jvps, jid, jok = jax.jit(jvp.detect_vps, static_argnums=6)(js, jv, f, cx, cy, key, cfg)
    c = lambda x: torch.tensor(x, dtype=torch.float64)
    tvps, tid, tok = tvp.detect_vps(T(np.asarray(js)), T(np.asarray(jv)), c(f), c(cx), c(cy),
                                    T(vp_uniforms(key, cfg)), tvp.VPConfig())
    assert bool(jok) and bool(tok)
    close(jvps, tvps, atol=1e-12)
    assert np.array_equal(np.asarray(jid), tid.numpy())
    assert int((tid < 3).sum()) >= 3
    # the smoothed grid on its own
    line, length, angle = tvp._line_params(T(np.asarray(js)), c(f), c(cx), c(cy))
    jline, jlen, jang = jvp._line_params(js, f, cx, cy)
    close(jline, line, atol=1e-15)
    grid = tvp.vp_grid(line, length, angle, T(np.asarray(jv)), tvp.VPConfig())
    assert float(grid.max()) > 0
    prev = T(np.eye(3)[[1, 0, 2]])
    close(jvp.vps_temporal_consistency(jvps, jnp.asarray(prev.numpy()), jnp.asarray(True)),
          tvp.vps_temporal_consistency(tvps, prev, torch.tensor(True)), atol=1e-12)


def test_choice_from_uniform_matches_jax():
    p = np.array([0.0, 1.0, 1.0, 0.0, 3.0, 1e-6]) + 1e-6
    p = p / p.sum()
    key = jax.random.PRNGKey(7)
    j = np.asarray(jax.random.choice(key, 6, (50, 2), p=jnp.asarray(p)))
    u = np.asarray(jax.random.uniform(key, (50, 2), dtype=jnp.float64))
    assert np.array_equal(j, tvp.choice_from_uniform(T(p), T(u)).numpy())


# ---------------------------------------------------------------------------
# the line tracker
# ---------------------------------------------------------------------------


def test_line_tracker_step_matches_jax(frames, jax_line_tracker_x64):
    """Three frames (the scene moving on), every output compared; frame 1
    matches against frame 0, frame 2 against frame 1."""
    imgs = [frames[0], frames[1], segment_frame((2 * SHIFT[0], 2 * SHIFT[1]))]
    jcfg = jlt.LineTrackerConfig(max_lines=32, max_h=10, max_v=10, equalize=False)
    tcfg = tlt.LineTrackerConfig(max_lines=32, max_h=10, max_v=10, equalize=False)
    jideal = jcam.pinhole(*F_IDEAL, width=W, height=H)
    tideal = tcam.pinhole(*F_IDEAL, width=W, height=H, device="cpu")
    js = jlt.init_state(jcfg, H, W, jnp.float64)
    ts = convert.to_torch(js, device="cpu")
    step = jax.jit(lambda s, img, key: jlt.step(s, img, jideal, jcfg, key))
    for k, img in enumerate(imgs):
        key = jax.random.PRNGKey(20 + k)
        js, jo = step(js, jnp.asarray(img), key)
        ts, to = tlt.step(ts, T(img), tideal, tcfg, T(vp_uniforms(key, jcfg.vp)))
        assert np.array_equal(np.asarray(jo.ids), to.ids.numpy()), k
        assert np.array_equal(np.asarray(jo.vp_valid), to.vp_valid.numpy())
        close(jo.endpoints, to.endpoints, atol=1e-11)
        close(jo.segs_px, to.segs_px, atol=1e-9)
        close(jo.vp_dirs, to.vp_dirs, atol=1e-10)
        close(js.vps_prev, ts.vps_prev, atol=1e-12)
        assert int(js.next_id) == int(ts.next_id)
    # lines were tracked across frames (ids carried over) and VPs attached
    assert int(ts.next_id) < 3 * int((to.ids >= 0).sum())
    assert bool(to.vp_valid.any())


def _seg_dist(a, b):
    """[A, B] max endpoint distance between segments, either orientation."""
    d1 = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    d2 = np.abs(a[:, None, :] - b[None][..., [2, 3, 0, 1]]).max(-1)
    return np.minimum(d1, d2)


def test_line_tracker_clahe_matches_jax(frames, jax_line_tracker_x64):
    """equalize=True.  The reference blends its CLAHE in bf16, the port in the
    input dtype (<= 1e-2 apart, test_clahe_matches_jax), and EDLine on two
    equalized frames that far apart can split or merge a segment otherwise.
    So the test holds two things over three frames:
    1. exactly, everything after the equalization: the port with
       equalize=True against the reference with equalize=False fed the
       port's equalized frame (the tolerances of
       test_line_tracker_step_matches_jax);
    2. end to end against the reference with equalize=True, from the same
       state each frame: at least half of the port's segments lie within
       1 px of a reference segment (measured 11 of 12, 7 of 11, 11 of 11),
       and of the ids carried in from the previous frame at least 3/4 of
       the union are carried by both (measured 6 of 7, 4 of 4)."""
    imgs = [frames[0], frames[1], segment_frame((2 * SHIFT[0], 2 * SHIFT[1]))]
    kw = dict(max_lines=32, max_h=10, max_v=10)
    jraw = jlt.LineTrackerConfig(equalize=False, **kw)
    jeq = jlt.LineTrackerConfig(equalize=True, **kw)
    tcfg = tlt.LineTrackerConfig(equalize=True, **kw)
    jideal = jcam.pinhole(*F_IDEAL, width=W, height=H)
    tideal = tcam.pinhole(*F_IDEAL, width=W, height=H, device="cpu")
    step_raw = jax.jit(lambda s, img, key: jlt.step(s, img, jideal, jraw, key))
    step_eq = jax.jit(lambda s, img, key: jlt.step(s, img, jideal, jeq, key))
    js = jlt.init_state(jraw, H, W, jnp.float64)
    ts = convert.to_torch(js, device="cpu")
    je = js
    for k, img in enumerate(imgs):
        key = jax.random.PRNGKey(20 + k)
        u = T(vp_uniforms(key, jraw.vp))
        # 1. exact: the reference on the port's equalized frame
        js, jo = step_raw(js, jnp.asarray(timage.clahe(T(img)).numpy()), key)
        ts, to = tlt.step(ts, T(img), tideal, tcfg, u)
        assert np.array_equal(np.asarray(jo.ids), to.ids.numpy()), k
        assert np.array_equal(np.asarray(jo.vp_valid), to.vp_valid.numpy())
        close(jo.endpoints, to.endpoints, atol=1e-11)
        close(jo.segs_px, to.segs_px, atol=1e-9)
        close(jo.vp_dirs, to.vp_dirs, atol=1e-10)
        close(js.vps_prev, ts.vps_prev, atol=1e-12)
        close(js.prev_img, ts.prev_img, atol=0)
        # 2. end to end, from the reference's own equalized state
        te = convert.to_torch(je, device="cpu")
        je2, jeo = step_eq(je, jnp.asarray(img), key)
        _, teo = tlt.step(te, T(img), tideal, tcfg, u)
        jv, tv = np.asarray(jeo.valid), teo.valid.numpy()
        near = _seg_dist(teo.segs_px.numpy()[tv], np.asarray(jeo.segs_px)[jv]).min(1) < 1.0
        assert near.mean() >= 0.5, (k, near)
        old_t = {int(i) for i in teo.ids.numpy()[tv] if i < int(je.next_id)}
        old_j = {int(i) for i in np.asarray(jeo.ids)[jv] if i < int(je.next_id)}
        assert len(old_t & old_j) >= 0.75 * len(old_t | old_j), (k, old_t, old_j)
        je = je2
    assert int(ts.next_id) < 3 * int((to.ids >= 0).sum())


# ---------------------------------------------------------------------------
# entry points run on the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------


def _constructors():
    from vplines_slam_tpu_torch.estimator import window as twin
    from vplines_slam_tpu_torch.models import feature_tracker as tft
    from vplines_slam_tpu_torch.models import imu as timu
    from vplines_slam_tpu_torch.solver import marginalization as tmarg
    from vplines_slam_tpu_torch.estimator.vio import VioEngine
    from vplines_slam_tpu_torch.pipeline.system import SlamSystem
    from vplines_slam_tpu_torch.utils import demo, synthetic
    from vplines_slam_tpu_torch.utils.config import load_profile

    wcfg = twin.WindowConfig(window=2, max_points=4, max_lines=2, max_imu=4)
    q0 = np.array([1.0, 0.0, 0.0, 0.0])
    cam = lambda: tcam.pinhole(100.0, 100.0, 8.0, 6.0, -0.1, width=16, height=12, device="cpu")
    return {
        "camera.pinhole": lambda: tcam.pinhole(100.0, 100.0, 8.0, 6.0, width=16, height=12),
        "imu.default_params": lambda: timu.default_params(),
        "feature_tracker.init_state": lambda: tft.init_state(tft.TrackerConfig(max_features=4),
                                                             12, 16),
        "line_tracker.init_state": lambda: tlt.init_state(tlt.LineTrackerConfig(max_lines=4),
                                                          12, 16),
        "window.empty_state": lambda: twin.empty_state(wcfg),
        "window.empty_tracks": lambda: twin.empty_tracks(wcfg),
        "marginalization.empty_prior": lambda: tmarg.empty_prior(5),
        "demo.forward_camera_extrinsic": lambda: demo.forward_camera_extrinsic(),
        "demo.BlobWorldRenderer": lambda: demo.BlobWorldRenderer(
            tcam.pinhole(100.0, 100.0, 8.0, 6.0, width=16, height=12, device="cpu"),
            *demo.forward_camera_extrinsic(device="cpu"), n_pts=8).X,
        "synthetic.scatter_landmarks": lambda: synthetic.scatter_landmarks(3),
        "convert.to_torch": lambda: convert.to_torch((np.zeros(3), np.ones(2, bool))),
        "image.build_remap_plan": lambda: timage.build_remap_plan(
            np.stack(np.meshgrid(np.arange(16) * 1.01, np.arange(12), indexing="xy"), -1)),
        "vio.VioEngine": lambda: VioEngine(wcfg, q_ic=q0, p_ic=np.zeros(3)).state,
        "system.SlamSystem": lambda: SlamSystem(cam(), wcfg, tft.TrackerConfig(max_features=4),
                                                q_ic=q0, p_ic=np.zeros(3),
                                                use_loop_closure=False).vio.state,
        "feature_tracker.FeatureTrackerFrontend": lambda: tft.FeatureTrackerFrontend(
            cam(), tft.TrackerConfig(max_features=4)).state,
        "line_tracker.LineTrackerFrontend": lambda: tlt.LineTrackerFrontend(
            cam(), tlt.LineTrackerConfig(max_lines=4)).state,
        "config.load_profile": lambda: load_profile(
            str(Path(__file__).resolve().parents[1] / "configs" / "euroc.yaml")).camera,
    }


@pytest.mark.parametrize("name", sorted(_constructors()))
def test_constructors_default_to_the_card(name):
    """Called without a device, a constructor puts its tensors on CUDA; on a
    machine without CUDA it raises rather than fall back to the CPU."""
    ctor = _constructors()[name]
    if torch.cuda.is_available():
        out = ctor()
        leaves = out if isinstance(out, tuple) else (out,)
        flat = [x for leaf in leaves for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
        assert all(x.is_cuda for x in flat if isinstance(x, torch.Tensor))
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            ctor()
