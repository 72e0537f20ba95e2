"""CLAHE's plain twin (K9's) against the JAX reference on the cases the
kernel must reproduce.

Cases (``utils/synthetic.clahe_cases``): a constant image (every pixel in one
bin, so the clip and the even spread of the excess bind), values outside
[0, 1], an image whose sides are no multiples of the 8 x 8 tiles (the
histograms crop it, the mapping covers all of it) and seeded noise.

The LUTs (``clahe_luts_plain``, torch f64 on the CPU) must equal, to the bit,
the reference's expression (``vplines_slam_tpu/ops/image.py:269-283``:
one-hot tile histograms, clip at clip_limit * th * tw / bins, the excess
spread evenly, cumulative sum, normalised by the last entry) evaluated here
in numpy f64: counts are integers and the limit is a multiple of 1/32, so
every sum is exact in any order and the one division rounds the same.  The
whole ``clahe`` is held against JAX's within 1e-2, the bound of
``tests/test_torch_coldstart_ops.py``: the reference blends its per-pixel LUT
stack in bf16, the port in the input dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import image as jimage
from vplines_slam_tpu_torch.ops import image as timage
from vplines_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CASES = synthetic.clahe_cases(seed=0)


def reference_luts(img, clip_limit=3.0, tiles=8, bins=32):
    """The reference's LUT expression, in numpy f64."""
    H, W = img.shape
    th, tw = H // tiles, W // tiles
    x = np.clip(img[: th * tiles, : tw * tiles], 0.0, 1.0)
    q = np.minimum((x * bins).astype(np.int64), bins - 1)
    tiles_q = q.reshape(tiles, th, tiles, tw).transpose(0, 2, 1, 3).reshape(tiles * tiles, th * tw)
    hist = (tiles_q[:, :, None] == np.arange(bins)[None, None, :]).astype(np.float64).sum(axis=1)
    limit = clip_limit * (th * tw) / bins
    excess = np.maximum(hist - limit, 0.0).sum(axis=1, keepdims=True)
    cdf = np.cumsum(np.minimum(hist, limit) + excess / bins, axis=1)
    return (cdf / cdf[:, -1:]).reshape(tiles, tiles, bins)


@pytest.mark.parametrize("name", list(CASES))
def test_luts_equal_the_reference_expression(name):
    img = CASES[name]
    t = timage.clahe_luts_plain(torch.as_tensor(img)).numpy()
    np.testing.assert_array_equal(t, reference_luts(img))


@pytest.mark.parametrize("name", list(CASES))
def test_clahe_matches_jax(name):
    img = CASES[name]
    j = np.asarray(jimage.clahe(jnp.asarray(img)))
    t = timage.clahe(torch.as_tensor(img)).numpy()
    assert t.shape == img.shape and np.isfinite(t).all()
    assert np.abs(j - t).max() < 1e-2


def test_constant_image_clips_and_spreads():
    """One bin holds every pixel: it is clipped to the limit and the excess
    spread evenly, so the LUT steps by the spread below the bin and by the
    limit plus the spread at it."""
    img = CASES["constant"]
    luts = reference_luts(img)
    th, tw = img.shape[0] // 8, img.shape[1] // 8
    limit = 3.0 * th * tw / 32
    spread = (th * tw - limit) / 32
    steps = np.diff(np.concatenate([np.zeros((8, 8, 1)), luts], axis=-1), axis=-1) * th * tw
    k = int(0.37 * 32)
    np.testing.assert_allclose(steps[..., k], limit + spread, rtol=1e-12)
    np.testing.assert_allclose(np.delete(steps, k, axis=-1), spread, rtol=1e-12)
    np.testing.assert_array_equal(timage.clahe_luts_plain(torch.as_tensor(img)).numpy(), luts)
