"""Parity of the port's IMU model, point tracker and state conversion with
the JAX reference (torch f64 on the CPU against JAX x64)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.estimator import window as jwin
from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import feature_tracker as jft
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu.ops import klt as jklt
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import feature_tracker as tft
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.ops import klt as tklt
from vplines_slam_tpu_torch.ops import image as timage
from test_torch_ops import key_with_distinct_samples

torch.set_num_threads(1)

PKG = Path(__file__).resolve().parents[1] / "vplines_slam_tpu_torch"


def T(a):
    return torch.as_tensor(np.array(a))


def close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out),
                               atol=atol, rtol=rtol)


def imu_interval(rng, n_cap=16, n_real=11):
    dts = np.zeros(n_cap)
    dts[:n_real] = 0.005 + rng.uniform(0, 1e-4, n_real)
    mask = np.arange(n_cap) < n_real
    accs = np.zeros((n_cap + 1, 3))
    gyrs = np.zeros((n_cap + 1, 3))
    accs[: n_real + 1] = np.array([0.3, -0.2, 9.81]) + rng.standard_normal((n_real + 1, 3))
    gyrs[: n_real + 1] = rng.standard_normal((n_real + 1, 3)) * 0.5
    return dts, accs, gyrs, mask


def test_preintegrate_matches_jax():
    rng = np.random.default_rng(0)
    dts, accs, gyrs, mask = imu_interval(rng)
    ba, bg = rng.standard_normal(3) * 0.05, rng.standard_normal(3) * 0.01
    jp = jimu.preintegrate(*map(jnp.asarray, (dts, accs, gyrs, mask, ba, bg)),
                           jimu.default_params())
    tp = timu.preintegrate(*map(T, (dts, accs, gyrs, mask, ba, bg)), timu.default_params(device="cpu"))
    for f in jp._fields:
        close(getattr(jp, f), getattr(tp, f), atol=1e-13)
    # whitening: f64 Cholesky of the same covariance
    close(jimu.sqrt_information(jp), timu.sqrt_information(tp), atol=1e-6, rtol=1e-9)


def test_evaluate_matches_jax():
    rng = np.random.default_rng(1)
    dts, accs, gyrs, mask = imu_interval(rng)
    jp = jimu.preintegrate(*map(jnp.asarray, (dts, accs, gyrs, mask)),
                           jnp.zeros(3), jnp.zeros(3), jimu.default_params())
    tp = convert.to_torch(jp, device="cpu")
    q = rng.standard_normal((2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    args = [rng.standard_normal(3), q[0], rng.standard_normal(3), rng.standard_normal(3) * 0.1,
            rng.standard_normal(3) * 0.01, rng.standard_normal(3), q[1], rng.standard_normal(3),
            rng.standard_normal(3) * 0.1, rng.standard_normal(3) * 0.01]
    close(jimu.evaluate(jp, jimu.default_params(), *map(jnp.asarray, args)),
          timu.evaluate(tp, timu.default_params(device="cpu"), *map(T, args)), atol=1e-12)


def test_midpoint_propagate_matches_jax():
    rng = np.random.default_rng(2)
    args = [rng.standard_normal(3), np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm(
        [0.9, 0.1, -0.3, 0.2])] + [rng.standard_normal(3) for _ in range(7)] + [0.005]
    args.append(np.array([0.0, 0.0, 9.81007]))
    jout = jimu.midpoint_propagate(*map(jnp.asarray, args))
    tout = timu.midpoint_propagate(*map(T, args))
    for a, b in zip(jout, tout):
        close(a, b, atol=1e-14)


# ---------------------------------------------------------------------------
# point tracker
# ---------------------------------------------------------------------------


def blob_frames(rng, n, H=120, W=160, step=(3.0, -1.5), movers=0):
    """n frames of 50 Gaussian blobs drifting by `step` px per frame; the
    first `movers` blobs move on their own (outliers to the epipolar model)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    c = rng.uniform([10, 10], [W - 10, H - 10], (50, 2))
    amp = rng.uniform(0.3, 0.8, 50)
    steps = np.tile(np.asarray(step), (50, 1))
    steps[:movers] = (-2.0, 2.5)
    frames = []
    for k in range(n):
        ck = c + k * steps * (1.0 + 0.2 * (c[:, :1] / W))  # mild parallax
        img = 0.1 + 0.05 * np.sin(xx / 11.0) * np.cos(yy / 13.0)
        for (x, y), a in zip(ck, amp):
            img = img + a * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 5.0)
        frames.append(np.clip(img, 0.0, 1.0))
    return frames


_jklt_track = jax.jit(jklt.track, static_argnums=3)


def tracker_key(js, img, jcfg, seed):
    """(key, draws, n_ok) for one frame of the JAX tracker: n_ok tracks enter
    RANSAC (KLT ok, valid id, after a first frame), and the key's hypotheses
    each draw 8 distinct ones, so the port gets JAX's own draws and no
    hypothesis is degenerate (see key_with_distinct_samples).  Below 12 tracks
    the tracker skips RANSAC and any key will do."""
    _, ok, _ = _jklt_track(js.prev_img, img, js.xy, jcfg.klt)
    n_ok = int(jnp.sum(ok & (js.ids >= 0) & js.has_prev))
    if n_ok < 12:
        key = jax.random.PRNGKey(seed)
        return key, np.asarray(jax.random.randint(key, (jcfg.ransac_hyps, 8), 0,
                                                  jcfg.max_features)), n_ok
    return (*key_with_distinct_samples(jcfg.ransac_hyps, jcfg.max_features, n_ok, seed),
            n_ok)


@pytest.mark.parametrize("f_threshold", [1.0, 1e4])
def test_tracker_step_matches_jax(f_threshold):
    """Three frames from the same initial state, every output compared.  Each
    frame's RANSAC draws are JAX's own (``randint(key, (hyps, 8), 0, M)``),
    with the key chosen so that no hypothesis repeats a sample.  At the real
    threshold (1 px) RANSAC rejects outliers from the second frame on; with
    the gate wide open (1e4 px) it keeps every track."""
    rng = np.random.default_rng(3)
    frames = blob_frames(rng, 3, movers=8)
    K = (100.0, 100.0, 80.0, 60.0, -0.1, 0.02, 0.0, 0.0)
    jc, tc = jcam.pinhole(*K, width=160, height=120), tcam.pinhole(*K, width=160, height=120, device="cpu")
    kw = dict(max_features=32, min_dist=15, quality=0.01, f_threshold=f_threshold,
              ransac_hyps=4)
    jcfg = jft.TrackerConfig(equalize=False, klt=jklt.KLTConfig(levels=2), **kw)
    tcfg = tft.TrackerConfig(klt=tklt.KLTConfig(levels=2), **kw)
    js = jft.init_state(jcfg, 120, 160, jnp.float64)
    ts = convert.to_torch(js, device="cpu")
    n_rejected = 0
    for k, img in enumerate(frames):
        key, ridx, n_ok = tracker_key(js, jnp.asarray(img), jcfg, seed=k)
        js, jo = jft.step(js, jnp.asarray(img), jc, jcfg, 0.1, key)
        ts, to = tft.step(ts, T(img), tc, tcfg, 0.1, T(ridx).long())
        assert to.ids.shape == (32,) and to.rays.shape == (32, 3)
        n_rejected += n_ok - int(np.sum(np.asarray(jo.track_cnt) >= 2))
        assert np.array_equal(np.asarray(jo.ids), to.ids.numpy()), k
        assert np.array_equal(np.asarray(jo.track_cnt), to.track_cnt.numpy())
        close(jo.xy, to.xy, atol=1e-8)
        close(jo.rays, to.rays, atol=1e-10)
        close(jo.velocity, to.velocity, atol=1e-8)
        assert int(js.next_id) == int(ts.next_id)
    assert int(ts.next_id) > 20 and bool((ts.track_cnt >= 2).any())
    # the 8 blobs that move on their own are rejected only at the real gate
    assert (n_rejected > 0) == (f_threshold < 1e3)


# ---------------------------------------------------------------------------
# conversion and package hygiene
# ---------------------------------------------------------------------------


def test_convert_round_trip():
    cfg = jwin.WindowConfig(window=3, max_points=8, max_lines=2, max_imu=4)
    state = jwin.empty_state(cfg)
    data = jwin.empty_tracks(cfg)
    fe = jft.init_state(jft.TrackerConfig(max_features=6), 12, 16, jnp.float64)
    cam = jcam.pinhole(100.0, 101.0, 8.0, 6.0, 0.1, width=16, height=12)
    batch = (jnp.zeros(4), jnp.ones((5, 3)), jnp.ones((5, 3)), jnp.ones(4, bool),
             jnp.asarray(True))
    for obj in (state, data, fe, jimu.default_params(), cam, batch):
        t = convert.to_torch(obj, device="cpu")
        back = convert.from_torch(t)
        ja = jax.tree_util.tree_leaves(obj)
        tb = jax.tree_util.tree_leaves(back)
        assert len(ja) == len(tb)
        for a, b in zip(ja, tb):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    t = convert.to_torch(data, device="cpu")
    assert t.pt_id.dtype == torch.int64 and t.pt_mask.dtype == torch.bool
    assert type(t.prior).__module__.startswith("vplines_slam_tpu_torch")
    assert convert.to_torch(cam, device="cpu").width == 16


def test_port_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|vplines_slam_tpu)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_wrappers_take_plain_path_on_cpu():
    """On a CPU tensor a kernel wrapper runs its plain twin and launches
    nothing."""
    from vplines_slam_tpu_torch.kernels import all_kernels

    before = [k.launches for k in all_kernels()]
    img = T(blob_frames(np.random.default_rng(4), 1)[0])
    assert torch.equal(timage.pyr_down(img), timage.pyr_down_plain(img))
    assert [k.launches for k in all_kernels()] == before
    assert all(k.source.endswith(".cu") and (PKG.parent / k.source).exists()
               for k in all_kernels())
