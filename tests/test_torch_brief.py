"""Loop closure's keyframe features against the JAX reference: FAST, BRIEF,
Hamming matching and the SimHash signature (torch f64 on the CPU, the
kernels' plain twins, against JAX x64), and ``extract_keyframe_features``.

Frames come from the port's renderer (a 120x160 camera in the blob world)
and are fed to both packages as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import pose_graph as jpg
from vplines_slam_tpu.ops import brief as jbrief
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import pose_graph as tpg
from vplines_slam_tpu_torch.ops import brief as tbrief
from vplines_slam_tpu_torch.utils import demo

torch.set_num_threads(1)

CPU = torch.device("cpu")
H, W = 120, 160
F64 = torch.float64


def _frame(t=0.0):
    from vplines_slam_tpu_torch.utils import synthetic as tsyn

    cam = tcam.pinhole(110.0, 110.0, W / 2, H / 2, width=W, height=H, dtype=F64, device=CPU)
    q_ic, p_ic = demo.forward_camera_extrinsic(F64, CPU)
    traj = tsyn.figure8_trajectory(radius=1.2, ypr_amp=(12.0, 5.0, 4.0))
    p, q, _ = tsyn.ground_truth_states(traj, torch.tensor([t], dtype=F64))
    rend = demo.BlobWorldRenderer(cam, q_ic, p_ic, n_pts=300, seed=4, dtype=F64, device=CPU)
    return rend.render(q[0], p[0]).numpy()


_FRAMES = {}


def frame(t=0.0):
    if t not in _FRAMES:
        _FRAMES[t] = _frame(t)
    return _FRAMES[t]


def u32(desc_t):
    """The port's int32 words as the reference's uint32."""
    return desc_t.numpy().astype(np.int32).view(np.uint32)


def rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def t_desc(d):
    return torch.from_numpy(d.view(np.int32).copy())


def test_fast_score_matches_jax():
    img = frame()
    js = np.asarray(jbrief.fast_score(jnp.asarray(img)))
    ts = tbrief.fast_score(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-12, atol=0)
    assert (js > 0).sum() > 50


@pytest.mark.parametrize("max_corners", [60, 500])
def test_detect_fast_matches_jax(max_corners):
    """60 corners: all valid; 500: more slots than corners, so the zero
    scores tie and the stable sort must keep lax.top_k's index order."""
    img = frame()
    jxy, jv = map(np.asarray, jbrief.detect_fast(jnp.asarray(img), max_corners))
    txy, tv = tbrief.detect_fast(torch.from_numpy(img), max_corners)
    np.testing.assert_array_equal(txy.numpy(), jxy)
    np.testing.assert_array_equal(tv.numpy(), jv)
    if max_corners == 500:
        assert 0 < jv.sum() < 500


def test_pattern_and_vocabulary_match_jax():
    ja, jb = map(np.asarray, jbrief.brief_pattern())
    ta, tb = tbrief.brief_pattern()
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tbrief._random_vocab(256, 256),
                                  np.asarray(jbrief._random_vocab(256, 256, jnp.float64)))
    np.testing.assert_array_equal(tbrief._CIRCLE, jbrief._CIRCLE)
    assert (tbrief.SIG_CELLS, tbrief.SIG_DIM) == (jbrief.SIG_CELLS, jbrief.SIG_DIM)


def test_describe_brief_matches_jax():
    img = frame()
    jxy, jv = jbrief.detect_fast(jnp.asarray(img), 120)
    xy = np.asarray(jxy)
    # off-grid points too, some near the border (zero pad) and one invalid
    rng = np.random.default_rng(3)
    extra = np.concatenate([rng.uniform([2, 2], [W - 2, H - 2], (20, 2)),
                            [[1.5, 3.25], [W - 1.2, H - 0.7]]])
    xy = np.concatenate([xy, extra])
    valid = np.concatenate([np.asarray(jv), np.ones(len(extra), bool)])
    valid[5] = False
    jd = np.asarray(jbrief.describe_brief(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid)))
    td = tbrief.describe_brief(torch.from_numpy(img), torch.from_numpy(xy),
                               torch.from_numpy(valid))
    assert td.dtype == torch.int32
    np.testing.assert_array_equal(u32(td), jd)
    assert (jd[5] == 0).all() and (jd != 0).any()


def test_hamming_matrix_matches_jax():
    rng = np.random.default_rng(0)
    da, db = rand_desc(rng, 17), rand_desc(rng, 23)
    jh = np.asarray(jbrief.hamming_matrix(jnp.asarray(da), jnp.asarray(db)))
    th = tbrief.hamming_matrix(t_desc(da), t_desc(db)).numpy()
    np.testing.assert_array_equal(th, jh)


@pytest.mark.parametrize("margin,mutual", [(0, False), (16, True), (16, False), (0, True)])
def test_match_descriptors_matches_jax(margin, mutual):
    """Noisy copies of db rows (so most rows match), duplicates (ties at the
    best, which fail a margin), invalid rows and columns."""
    rng = np.random.default_rng(1)
    db = rand_desc(rng, 90)
    src = rng.integers(0, 90, 40)
    da = db[src].copy()
    flips = rng.integers(0, 2 ** 32, size=da.shape, dtype=np.uint64).astype(np.uint32)
    keep = rng.random(da.shape) < 0.85
    da = np.where(keep, da, da ^ (flips & np.uint32(0x01010101)))
    da[::7] = rand_desc(rng, len(da[::7]))
    db[10] = db[11]  # a tie at the best for rows copied from 10 or 11
    va = rng.random(40) < 0.9
    vb = rng.random(90) < 0.9
    j_idx, j_dist = map(np.asarray, jbrief.match_descriptors(
        jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb), 80, margin, mutual))
    t_idx, t_dist = tbrief.match_descriptors(t_desc(da), torch.from_numpy(va), t_desc(db),
                                             torch.from_numpy(vb), 80, margin, mutual)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_dist.numpy(), j_dist)
    assert (j_idx >= 0).sum() > 10


def test_signature_bit_order():
    """A descriptor with one bit set: bit i is word i // 32, bit i % 32."""
    for i in (0, 31, 32, 77, 255):
        d = np.zeros((1, 8), np.uint32)
        d[0, i // 32] = np.uint32(1) << np.uint32(i % 32)
        bits = np.asarray(jnp.unpackbits(jnp.asarray(d).view(jnp.uint8), axis=-1, count=256,
                                         bitorder="little"))
        tb = tbrief._unpack_bits(t_desc(d)).numpy()
        np.testing.assert_array_equal(tb, bits)
        assert tb[0, i] == 1 and tb.sum() == 1


def test_signature_code_is_128_minus_popcount():
    """The identity K17's signature kernel relies on: with w_j, column j of
    the reference's vocabulary (``_random_vocab``) packed as the port's
    ``_vocab_words``, (bits - 0.5) @ W = 128 - popcount(desc ^ w_j) exactly,
    so the code is that integer's sign.  Descriptors at distance exactly 128
    from a word (code 0, as jnp.sign gives), 127 and 129 are crafted in.  The
    bit order of the packing is test_signature_bit_order's and not repeated."""
    rng = np.random.default_rng(6)
    words = u32(tbrief._vocab_words(256, CPU))  # [256, 8]
    crafted = []
    for j, flips in ((0, 128), (5, 128), (255, 128), (7, 127), (7, 129)):
        mask = np.zeros(256, np.uint8)
        mask[rng.permutation(256)[:flips]] = 1
        crafted.append(words[j] ^ np.packbits(mask, bitorder="little").view(np.uint32))
    d = np.concatenate([rand_desc(rng, 40), np.stack(crafted)])
    bits = np.asarray(jnp.unpackbits(jnp.asarray(d).view(jnp.uint8), axis=-1, count=256,
                                     bitorder="little"), np.float64)
    proj = (bits - 0.5) @ np.asarray(jbrief._random_vocab(256, 256, jnp.float64))
    dist = np.unpackbits((d[:, None, :] ^ words[None]).view(np.uint8), axis=-1).sum(
        -1, dtype=np.int64)
    np.testing.assert_array_equal(proj, 128 - dist)
    codes = tbrief.simhash_codes_plain(t_desc(d), torch.ones(len(d), dtype=torch.bool))
    np.testing.assert_array_equal(codes.numpy(), np.sign(128 - dist))
    assert codes[40, 0] == codes[41, 5] == codes[42, 255] == 0
    assert (codes[43, 7], codes[44, 7]) == (1, -1)


@pytest.mark.parametrize("with_xy", [False, True])
def test_signature_of_no_descriptors_is_zero(with_xy):
    """N = 0: the port's signature is the zero vector (no codes to sum, the
    norm floored at 1e-9), as the reference's is when every descriptor is
    invalid.  The reference itself cannot take N = 0: its jnp.unpackbits
    divides by zero on the empty array (ROADMAP C)."""
    xy = lambda n: np.full((n, 2), 10.0, np.float32)
    tkw = dict(xy=torch.from_numpy(xy(0)), img_hw=(H, W)) if with_xy else {}
    jkw = lambda n: dict(xy=jnp.asarray(xy(n)), img_hw=(H, W)) if with_xy else {}
    tsig = tbrief.global_signature(torch.zeros(0, 8, dtype=torch.int32),
                                   torch.zeros(0, dtype=torch.bool), **tkw)
    assert tsig.shape == (tbrief.SIG_DIM,) and not tsig.any()
    jsig = np.asarray(jbrief.global_signature(jnp.asarray(rand_desc(np.random.default_rng(7), 1)),
                                              jnp.zeros(1, bool), **jkw(1)))
    np.testing.assert_array_equal(jsig, tsig.numpy())
    with pytest.raises(ZeroDivisionError):
        jbrief.global_signature(jnp.zeros((0, 8), jnp.uint32), jnp.zeros(0, bool), **jkw(0))


@pytest.mark.parametrize("with_xy", [False, True])
def test_global_signature_matches_jax(with_xy):
    img = frame()
    jxy, jv = jbrief.detect_fast(jnp.asarray(img), 200)
    jd = jbrief.describe_brief(jnp.asarray(img), jxy, jv)
    kw = dict(xy=jxy, img_hw=img.shape) if with_xy else {}
    jsig = np.asarray(jbrief.global_signature(jd, jv, **kw))
    d_t, v_t = t_desc(np.asarray(jd)), torch.from_numpy(np.asarray(jv))
    tkw = dict(xy=torch.from_numpy(np.asarray(jxy)), img_hw=img.shape) if with_xy else {}
    tsig = tbrief.global_signature(d_t, v_t, **tkw).numpy()
    # the codes, exactly
    bits = jnp.unpackbits(jd.view(jnp.uint8), axis=-1, count=256, bitorder="little")
    Wv = jbrief._random_vocab(256, 256, jnp.float32)
    jcodes = np.asarray(jnp.sign((bits.astype(jnp.float32) - 0.5) @ Wv)
                        * jv.astype(jnp.float32)[:, None])
    np.testing.assert_array_equal(tbrief.simhash_codes_plain(d_t, v_t).numpy(), jcodes)
    assert tsig.dtype == np.float32 and tsig.shape == (tbrief.SIG_DIM,)
    np.testing.assert_allclose(tsig, jsig, atol=1e-12, rtol=0)
    if with_xy:
        assert (np.abs(jsig.reshape(4, 256)).sum(1) > 0).sum() >= 3


def test_extract_keyframe_features_matches_jax():
    """FAST + BRIEF + signature of a rendered frame, and BRIEF at window
    points (some within 3 px of a corner, snapped; some not; one invalid)."""
    img = frame(0.7)
    cfg_kw = dict(n_features=96, n_window_pts=12)
    jcfg, tcfg = jpg.PoseGraphConfig(**cfg_kw), tpg.PoseGraphConfig(**cfg_kw)
    jc = jcam.pinhole(110.0, 110.0, W / 2, H / 2, width=W, height=H)
    tc = tcam.pinhole(110.0, 110.0, W / 2, H / 2, width=W, height=H, dtype=F64, device=CPU)
    jxy, _ = jbrief.detect_fast(jnp.asarray(img), 96)
    rng = np.random.default_rng(5)
    wxy = np.concatenate([np.asarray(jxy)[:6] + rng.uniform(-2, 2, (6, 2)),
                          rng.uniform([20, 20], [W - 20, H - 20], (6, 2))])
    wv = np.ones(12, bool)
    wv[3] = False
    jo = jpg.extract_keyframe_features(jnp.asarray(img), lambda xy: jcam.lift(jc, xy), jcfg,
                                       window_xy=(jnp.asarray(wxy), jnp.asarray(wv)))
    to = tpg.extract_keyframe_features(torch.from_numpy(img), lambda xy: tcam.lift(tc, xy),
                                       tcfg, window_xy=(torch.from_numpy(wxy),
                                                        torch.from_numpy(wv)))
    np.testing.assert_array_equal(u32(to["desc"]), np.asarray(jo["desc"]))
    np.testing.assert_array_equal(u32(to["wdesc"]), np.asarray(jo["wdesc"]))
    np.testing.assert_array_equal(to["kp_valid"].numpy(), np.asarray(jo["kp_valid"]))
    np.testing.assert_allclose(to["kp_norm"].numpy(), np.asarray(jo["kp_norm"]), atol=1e-12)
    np.testing.assert_allclose(to["sig"].numpy(), np.asarray(jo["sig"]), atol=1e-12)
