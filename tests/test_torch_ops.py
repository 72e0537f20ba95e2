"""Parity of the PyTorch port's math and front-end ops with the JAX reference.

Inputs come from numpy seeds and go through the JAX function and its port
(torch f64 on the CPU against JAX x64, as tests/conftest.py sets it).  On the
CPU every kernel wrapper runs its plain PyTorch twin, so K1-K4's plain
versions are what is held against JAX here; the CUDA kernels are held
against these plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.ops import corners as jcorners
from vplines_slam_tpu.ops import image as jimage
from vplines_slam_tpu.ops import klt as jklt
from vplines_slam_tpu.ops import mvg as jmvg
from vplines_slam_tpu.utils import geometry as jgeo
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.ops import corners as tcorners
from vplines_slam_tpu_torch.ops import image as timage
from vplines_slam_tpu_torch.ops import klt as tklt
from vplines_slam_tpu_torch.ops import mvg as tmvg
from vplines_slam_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(
        np.asarray(torch_out), np.asarray(jax_out), atol=atol, rtol=rtol)


def rand_quats(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def textured_image(rng, H, W, n_blobs=40):
    """Smooth random texture plus gaussian blobs in [0, 1]."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = 0.15 + 0.1 * np.sin(xx / 7.0 + rng.uniform(0, 6)) * np.cos(yy / 9.0)
    for _ in range(n_blobs):
        cx, cy = rng.uniform(8, W - 8), rng.uniform(8, H - 8)
        img += rng.uniform(0.3, 0.7) * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 6.0)
    return np.clip(img, 0.0, 1.0)


def shifted(img, dx, dy):
    """img resampled at (x - dx, y - dy): content moves by (+dx, +dy)."""
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xy = np.stack([xx - dx, yy - dy], -1)
    return np.asarray(jimage.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))


# ---------------------------------------------------------------------------
# geometry + camera (tolerance 1e-12: same f64 formulas)
# ---------------------------------------------------------------------------

GEO_CASES = {
    "quat_mul": lambda m, q, p, v: m.quat_mul(q, p),
    "quat_rotate": lambda m, q, p, v: m.quat_rotate(q, v),
    "quat_to_rot": lambda m, q, p, v: m.quat_to_rot(q),
    "rot_to_quat": lambda m, q, p, v: m.rot_to_quat(m.quat_to_rot(q)),
    "so3_exp_quat": lambda m, q, p, v: m.so3_exp_quat(v),
    "so3_exp_quat_small": lambda m, q, p, v: m.so3_exp_quat(v * 1e-8),
    "quat_log": lambda m, q, p, v: m.quat_log(q),
    "delta_quat": lambda m, q, p, v: m.delta_quat(v),
    "skew": lambda m, q, p, v: m.skew(v),
    "rot_to_ypr": lambda m, q, p, v: m.rot_to_ypr(m.quat_to_rot(q)),
    "ypr_to_rot": lambda m, q, p, v: m.ypr_to_rot(v * 40.0),
    "pose_inverse": lambda m, q, p, v: m.pose_inverse(q, v)[1],
    "pose_compose": lambda m, q, p, v: m.pose_compose(q, v, p, v)[1],
}


@pytest.mark.parametrize("name", sorted(GEO_CASES))
def test_geometry_matches_jax(name):
    rng = np.random.default_rng(1)
    q, p = rand_quats(rng, 16), rand_quats(rng, 16)
    v = rng.standard_normal((16, 3))
    fn = GEO_CASES[name]
    close(fn(jgeo, jnp.asarray(q), jnp.asarray(p), jnp.asarray(v)),
          fn(tgeo, T(q), T(p), T(v)), atol=1e-12)


def test_camera_project_lift_match_jax():
    rng = np.random.default_rng(2)
    K = (461.6, 460.3, 363.0, 248.1, -2.917e-01, 8.228e-02, 5.333e-05, -1.578e-04)
    jc = jcam.pinhole(*K)
    tc = tcam.pinhole(*K, device="cpu")
    X = np.concatenate([rng.uniform(-1, 1, (64, 2)), rng.uniform(1, 4, (64, 1))], 1)
    juv, jv = jcam.project(jc, jnp.asarray(X))
    tuv, tv = tcam.project(tc, T(X))
    close(juv, tuv, atol=1e-9)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    uv = rng.uniform([0, 0], [752, 480], (64, 2))
    # 5 Newton steps of the same f64 arithmetic: equal to rounding
    close(jcam.lift(jc, jnp.asarray(uv)), tcam.lift(tc, T(uv)), atol=1e-12)


# ---------------------------------------------------------------------------
# K1: image pyramid and separable correlations
# ---------------------------------------------------------------------------

IMAGE_CASES = {
    "pyr_down": lambda m, im: m.pyr_down(im),
    "sobel_x": lambda m, im: m.sobel_gradients(im)[0],
    "sobel_y": lambda m, im: m.sobel_gradients(im)[1],
    "scharr_x": lambda m, im: m.scharr_gradients(im)[0],
    "scharr_y": lambda m, im: m.scharr_gradients(im)[1],
    "gaussian_blur": lambda m, im: m.gaussian_blur(im, 5, 1.0),
    "box_filter": lambda m, im: m.box_filter(im, 3),
}


@pytest.mark.parametrize("name", sorted(IMAGE_CASES))
@pytest.mark.parametrize("shape", [(120, 160), (241, 319)])
def test_image_ops_match_jax(name, shape):
    img = textured_image(np.random.default_rng(3), *shape)
    fn = IMAGE_CASES[name]
    close(fn(jimage, jnp.asarray(img)), fn(timage, T(img)), atol=1e-14)


def test_build_pyramid_and_bilinear_match_jax():
    rng = np.random.default_rng(4)
    img = textured_image(rng, 240, 320)
    jp = jimage.build_pyramid(jnp.asarray(img), 3)
    tp = timage.build_pyramid(T(img), 3)
    for a, b in zip(jp, tp):
        close(a, b, atol=1e-14)
    xy = rng.uniform(-3, 323, (50, 7, 2))
    close(jimage.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)),
          timage.bilinear_sample(T(img), T(xy)), atol=1e-14)


# ---------------------------------------------------------------------------
# K2: KLT, including drift beyond the in-window margin D = 5 px
# ---------------------------------------------------------------------------


def klt_case(seed, shift):
    rng = np.random.default_rng(seed)
    img0 = textured_image(rng, 120, 160, n_blobs=60)
    img1 = shifted(img0, *shift)
    pts = np.concatenate([rng.uniform([12, 12], [148, 108], (40, 2)),
                          [[2.0, 3.0], [158.5, 60.0], [80.0, 119.0]]])  # near borders
    return img0, img1, pts


@pytest.mark.parametrize("shift", [(2.3, -1.4), (7.6, 6.2), (-9.1, 3.3)])
def test_klt_level_matches_jax(shift):
    """One level from a zero guess: shifts above 5 px drift beyond the
    moving window inside a round, so the in-round clamp and the re-anchor
    decide the result."""
    img0, img1, pts = klt_case(5, shift)
    cfg_j, cfg_t = jklt.KLTConfig(), tklt.KLTConfig()
    zero = np.zeros_like(pts)
    jf, jo, jr = jklt._track_level(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                                   jnp.asarray(zero), cfg_j, jnp.float64)
    tf, to, tr = tklt._track_level_plain(T(img0), T(img1), T(pts), T(zero), cfg_t)
    assert np.array_equal(np.asarray(jo), to.numpy())
    # same f64 arithmetic, reductions in another order: 1e-8 px
    close(jf, tf, atol=1e-8)
    close(jr, tr, atol=1e-10)


@pytest.mark.parametrize("levels", [2, 3])
def test_klt_track_matches_jax(levels):
    img0, img1, pts = klt_case(6, (6.4, -3.7))
    jp, jo, jr = jklt.track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                            jklt.KLTConfig(levels=levels))
    tp, to, tr = tklt.track(T(img0), T(img1), T(pts), tklt.KLTConfig(levels=levels))
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert to.sum() > 20  # the case really tracks
    close(jp, tp, atol=1e-8)
    close(jr, tr, atol=1e-10)


# ---------------------------------------------------------------------------
# K3: corner response, NMS and spaced detection
# ---------------------------------------------------------------------------


def test_min_eig_and_nms_match_jax():
    img = textured_image(np.random.default_rng(7), 120, 160)
    jr = jcorners.min_eig_response(jnp.asarray(img))
    tr = tcorners.min_eig_response(T(img))
    close(jr, tr, atol=1e-15)
    close(jcorners._nms(jr), tcorners._nms(tr), atol=1e-15)


@pytest.mark.parametrize("with_existing", [False, True])
@pytest.mark.parametrize("shape,min_dist", [((120, 160), 20), ((240, 320), 30)])
def test_detect_matches_jax(with_existing, shape, min_dist):
    rng = np.random.default_rng(8)
    img = textured_image(rng, *shape, n_blobs=80)
    kw = {}
    if with_existing:
        # features sharing cells with mixed masks pin the last-write-wins rule
        xy = rng.uniform([0, 0], [shape[1], shape[0]], (48, 2))
        xy[1::2] = xy[0::2] + 1.0
        mask = rng.uniform(size=48) < 0.5
        kw = dict(existing_xy=xy, existing_mask=mask)
    jout = jcorners.detect(jnp.asarray(img), 64, min_dist, 0.01,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    tout = tcorners.detect(T(img), 64, min_dist, 0.01, **{k: T(v) for k, v in kw.items()})
    valid = np.asarray(jout[2])
    assert np.array_equal(valid, tout[2].numpy())
    close(np.asarray(jout[0])[valid], tout[0].numpy()[valid], atol=0.0)
    close(jout[1], tout[1], atol=1e-15)


# ---------------------------------------------------------------------------
# K4: essential-matrix RANSAC (identical sample indices) + triangulation
# ---------------------------------------------------------------------------


def two_view(rng, n=64, outliers=8, noise=1e-3):
    ang = rng.standard_normal(3) * 0.05
    R = np.asarray(jgeo.so3_exp_matrix(jnp.asarray(ang)))
    t = np.array([0.3, 0.05, 0.02])
    X = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 8, (n, 1))], 1)
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:] + rng.standard_normal((n, 2)) * noise
    x2[:outliers] += rng.uniform(-0.2, 0.2, (outliers, 2))
    mask = np.ones(n, bool)
    mask[-5:] = False
    return x1, x2, mask


def key_with_distinct_samples(n_hyp, N, n_valid, seed=0):
    """First key of ``split(PRNGKey(seed), 2**15)`` whose RANSAC hypotheses
    each draw 8 DISTINCT valid entries (``ransac_essential`` maps draw i to
    the ``i % max(n_valid, 8)``-th valid entry).  Returns (key, its draws).
    A sample with repeats spans fewer than 8 points: its 9x9 normal matrix
    has a multi-dimensional null space, and which null vector eigh returns
    differs between LAPACK builds, so such hypotheses are not comparable."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 ** 15)
    idx = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (n_hyp, 8), 0, N))(keys))
    s = np.sort(idx % max(n_valid, 8), axis=-1)
    good = np.all(np.diff(s, axis=-1) != 0, axis=(-1, -2))
    assert good.any(), "no key found"
    key = keys[int(np.argmax(good))]
    draws = np.asarray(jax.random.randint(key, (n_hyp, 8), 0, N))
    assert np.array_equal(draws, idx[int(np.argmax(good))])
    return key, draws


@pytest.mark.parametrize("n_hyp", [3, 5])
def test_ransac_essential_matches_jax(n_hyp):
    rng = np.random.default_rng(9)
    x1, x2, mask = two_view(rng)
    key, idx = key_with_distinct_samples(n_hyp, len(mask), int(mask.sum()))
    thr = 3.0 / 460.0
    jE, jinl, jn = jmvg.ransac_essential(jnp.asarray(x1), jnp.asarray(x2),
                                         jnp.asarray(mask), key, n_hyp=n_hyp, threshold=thr)
    tE, tinl, tn = tmvg.ransac_essential(T(x1), T(x2), T(mask), T(idx).long(), threshold=thr)
    assert int(jn) == int(tn)
    assert np.array_equal(np.asarray(jinl), tinl.numpy())
    jE = np.asarray(jE)
    sign = np.sign(np.sum(jE * tE.numpy()))  # E is defined up to sign
    close(jE, sign * tE.numpy(), atol=1e-9)


def test_sampson_and_eight_point_match_jax():
    rng = np.random.default_rng(10)
    x1, x2, mask = two_view(rng, outliers=0)
    sm = np.zeros(len(mask), bool)
    sm[rng.choice(50, 12, replace=False)] = True
    jE = np.asarray(jmvg.eight_point_essential(jnp.asarray(x1), jnp.asarray(x2),
                                               jnp.asarray(sm)))
    tE = tmvg.eight_point_essential(T(x1), T(x2), T(sm)).numpy()
    close(jE, np.sign(np.sum(jE * tE)) * tE, atol=1e-10)
    counts, inl = tmvg.sampson_score_plain(T(np.stack([jE, -jE])), T(x1), T(x2), T(mask), 1e-3)
    h1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    h2 = np.concatenate([x2, np.ones((len(x2), 1))], 1)
    Ex1, Etx2 = h1 @ jE.T, h2 @ jE
    samp = np.sum(h2 * Ex1, 1) ** 2 / (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2
                                       + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2 + 1e-18)
    ref = (samp < 1e-6) & mask
    assert np.array_equal(inl.numpy(), np.stack([ref, ref]))
    assert counts.tolist() == [ref.sum()] * 2


def test_triangulate_tracks_matches_jax():
    rng = np.random.default_rng(11)
    F, N = 5, 40
    Rs = np.stack([np.asarray(jgeo.so3_exp_matrix(jnp.asarray(rng.standard_normal(3) * 0.1)))
                   for _ in range(F)])
    ts = rng.standard_normal((F, 3)) * 0.3
    X = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(3, 8, (N, 1))], 1)
    Xc = np.einsum("fij,nj->nfi", Rs, X) + ts[None]
    obs = Xc[..., :2] / Xc[..., 2:] + rng.standard_normal((N, F, 2)) * 1e-3
    mask = rng.uniform(size=(N, F)) < 0.7
    mask[:3] = False
    mask[3:6, 1:] = False  # single observation
    jX, jok = jmvg.triangulate_tracks(jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(obs),
                                      jnp.asarray(mask))
    tX, tok = tmvg.triangulate_tracks(T(Rs), T(ts), T(obs), T(mask))
    assert np.array_equal(np.asarray(jok), tok.numpy())
    close(jX, tX, atol=1e-9)
