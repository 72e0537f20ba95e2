"""FAST (K15's plain twins ``fast_score_plain`` and ``detect_fast_plain``,
which the wrappers run on CPU tensors) against the JAX reference's
``fast_score`` and ``detect_fast`` on the images of
``utils/synthetic.fast_cases``, at max_corners 1, 60 and 500, in float32 as
the card runs them.  The score is a sum of margins in ring order and the
outputs are pixel positions and flags, so everything is held exactly; the
cases' premises (ties at the k-th place, the zero-score fill, plateaus, the
border, the candidate counts) are pinned."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import brief as jbrief
from vplines_slam_tpu_torch.ops import brief as tbrief
from vplines_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CASES = tsyn.fast_cases()
KS = [1, 60, 500]
# one compile per shape (and k) instead of eager dispatch op by op
J_SCORE = jax.jit(jbrief.fast_score)
J_DETECT = jax.jit(jbrief.detect_fast, static_argnums=1)


def kept(name):
    """The plain twin's kept map (score where it is its 7x7 window's
    maximum, else 0), flattened."""
    img = torch.from_numpy(CASES[name])
    return tbrief._nms_plain(tbrief.fast_score_plain(img), 3).reshape(-1).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_fast_score_case_equals_jax(name):
    img = CASES[name]
    js = np.asarray(J_SCORE(jnp.asarray(img)))
    ts = tbrief.fast_score(torch.from_numpy(img))
    assert ts.dtype == torch.float32 and js.dtype == np.float32
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(CASES))
def test_detect_fast_case_equals_jax(name, k):
    img = CASES[name]
    jxy, jv = map(np.asarray, J_DETECT(jnp.asarray(img), k))
    txy, tv = tbrief.detect_fast(torch.from_numpy(img), k)
    assert txy.shape == (k, 2) and tv.shape == (k,) and tv.dtype == torch.bool
    np.testing.assert_array_equal(txy.numpy(), jxy)
    np.testing.assert_array_equal(tv.numpy(), jv)


def test_ties_fall_inside_runs_at_every_k():
    """The 1st, 60th and 500th places each sit inside a run of equal kept
    scores, so the lower index must win there."""
    v = np.sort(kept("ties over k"))[::-1]
    for k in KS:
        assert v[k - 1] == v[k] > 0


def test_fill_is_the_lowest_zero_score_indices():
    """40 corners: slots 40.. hold pixels 0, 1, 2, ... (no corner lies in the
    first rows), invalid; with no corner at all every slot is fill."""
    name = "fewer than k"
    W = CASES[name].shape[1]
    assert (kept(name) > 0).sum() == 40
    xy, v = tbrief.detect_fast(torch.from_numpy(CASES[name]), 500)
    assert v[:40].all() and not v[40:].any()
    i = np.arange(460)
    np.testing.assert_array_equal(xy[40:].numpy(), np.stack([i % W, i // W], 1))
    xy, v = tbrief.detect_fast(torch.from_numpy(CASES["flat"]), 60)
    assert not v.any()
    np.testing.assert_array_equal(xy[:, 1].numpy(), 0.0)
    np.testing.assert_array_equal(xy[:, 0].numpy(), np.arange(60))


def test_fill_skips_corners_below_k():
    """A corner whose index is below k takes its place among the corners,
    and the fill skips its pixel: the three corners of "33x40" (row 16) have
    indices 656, 660 and 663, below k = 700."""
    img = CASES["33x40"]
    xy, v = tbrief.detect_fast(torch.from_numpy(img), 700)
    assert int(v.sum()) == 3
    idx = (xy[:, 1] * img.shape[1] + xy[:, 0]).long().numpy()
    assert sorted(idx[:3]) == [656, 660, 663]
    fill = idx[3:]
    assert len(fill) == 697 and np.all(np.diff(fill) > 0)
    assert not set(fill) & {656, 660, 663} and fill[-1] == 699


def test_plateau_keeps_every_equal_score():
    """A 2x2 block's four equal scores share one 7x7 window: all are kept;
    a 3x3 block keeps its centre, whose 16 margins beat its neighbours'."""
    k = kept("plateau").reshape(CASES["plateau"].shape)
    blk = k[20:22, 20:22]
    assert (blk > 0).all() and (blk == blk[0, 0]).all()
    c = k[19:24, 59:64]
    assert c[2, 2] > 0 and c[2, 2] == c.max() and (c > 0).sum() < 9


def test_edge_corners_and_the_border():
    """The dots on rows 16 and H - 17 and columns 16 and W - 17 are corners,
    the ones on rows 15 and H - 16 and columns 15 and W - 16 score 0; an
    image of 24 rows is all border."""
    img = CASES["edge"]
    H, W = img.shape
    k = kept("edge").reshape(H, W)
    for y, x in ((16, 16), (16, W - 17), (H - 17, 16), (H - 17, W - 17), (70, 16),
                 (50, W - 17)):
        assert k[y, x] > 0
    for y, x in ((15, 40), (H - 16, 50), (60, 15), (80, W - 16)):
        assert k[y, x] == 0
    assert (kept("24x32") == 0).all()


def test_candidate_counts():
    """"dots 752x480" keeps more corners than K15's selection stages in
    shared memory (16,384: the kernel then reads them from device memory);
    "binary 752x480" about as many as a rendered keyframe (~4,300)."""
    assert (kept("dots 752x480") > 0).sum() == 20160
    assert 2000 < (kept("binary 752x480") > 0).sum() < 16384
