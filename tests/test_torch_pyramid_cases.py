"""K1's semantics on its plain route: ``build_pyramids`` and ``build_pyramid``
of the port against the JAX package's ``ops/image.build_pyramid``.

On the CPU both entries run ``pyr_down_plain`` level after level; on the
card K1 builds every level of both pyramids of a ``track`` call in one
launch, and ``chip_smoke.py`` holds it against this plain route (and the
previous one-level kernel) there.  The cases are the shapes the kernel's
tiling has to get right: odd heights and widths at 1-4 levels, a constant
image (every level's zero-padded border shows), an image whose coarsest
level is one pixel wide, and two images of different content in one call.

Tolerance: 1e-14 at f64, as ``tests/test_torch_ops.py`` holds ``pyr_down``
(the same taps in the same order; XLA may round a product-sum apart by an
ulp); 1e-6 at f32 (images in [0, 1], float32 rounding of 25 taps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import image as jimage
from vplines_slam_tpu_torch.ops import image as timage

torch.set_num_threads(1)


def textured(rng, H, W):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = 0.4 + 0.2 * np.sin(xx / 3.3 + rng.uniform(0, 6)) * np.cos(yy / 4.1)
    return np.clip(img + 0.3 * rng.uniform(0, 1, (H, W)), 0.0, 1.0)


def jax_pyramid(img, levels):
    return [np.asarray(x) for x in jimage.build_pyramid(jnp.asarray(img), levels)]


def assert_pyramid(got, ref, atol):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=atol, rtol=0.0)


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(61, 97), (33, 17)])
def test_odd_shapes_match_jax(shape, levels):
    rng = np.random.default_rng(levels)
    a, b = textured(rng, *shape), textured(rng, *shape)
    p0, p1 = timage.build_pyramids(torch.tensor(a), torch.tensor(b), levels)
    assert_pyramid(p0, jax_pyramid(a, levels), 1e-14)
    assert_pyramid(p1, jax_pyramid(b, levels), 1e-14)
    assert_pyramid(timage.build_pyramid(torch.tensor(a), levels), jax_pyramid(a, levels), 1e-14)
    # level k is (H + 1) // 2 of level k - 1
    h, w = shape
    for lv in p0:
        assert tuple(lv.shape) == (h, w)
        h, w = (h + 1) // 2, (w + 1) // 2


def test_f32_matches_jax():
    rng = np.random.default_rng(7)
    a = textured(rng, 61, 97).astype(np.float32)
    got = timage.build_pyramid(torch.tensor(a), 4)
    assert all(g.dtype == torch.float32 for g in got)
    assert_pyramid(got, jax_pyramid(a, 4), 1e-6)


def test_constant_image_shows_each_border():
    c = 0.7
    a = np.full((40, 56), c)
    got = timage.build_pyramid(torch.tensor(a), 4)
    assert_pyramid(got, jax_pyramid(a, 4), 1e-14)
    # level 1: interior c; an edge row sums taps 6 + 4 + 1 of 16 one way,
    # the corner both ways
    l1 = got[1].numpy()
    edge = 11.0 / 16.0
    np.testing.assert_allclose(l1[5:-5, 5:-5], c, atol=1e-14)
    np.testing.assert_allclose(l1[0, 5:-5], edge * c, atol=1e-14)
    np.testing.assert_allclose(l1[0, 0], edge * edge * c, atol=1e-14)
    # every coarser level pads its own border with zeros: its corner is
    # darker than its finer level's
    for fine, coarse in zip(got[1:], got[2:]):
        assert float(coarse[0, 0]) < float(fine[0, 0])


def test_coarsest_level_one_pixel_wide():
    rng = np.random.default_rng(3)
    a = textured(rng, 40, 3)
    got = timage.build_pyramid(torch.tensor(a), 4)
    assert [tuple(g.shape) for g in got] == [(40, 3), (20, 2), (10, 1), (5, 1)]
    assert_pyramid(got, jax_pyramid(a, 4), 1e-14)
    p0, p1 = timage.build_pyramids(torch.tensor(a), torch.tensor(a[::-1].copy()), 4)
    assert_pyramid(p1, jax_pyramid(a[::-1].copy(), 4), 1e-14)


def test_two_images_equal_two_single_calls():
    rng = np.random.default_rng(11)
    a, b = torch.tensor(textured(rng, 61, 97)), torch.tensor(textured(rng, 61, 97))
    p0, p1 = timage.build_pyramids(a, b, 3)
    for got, ref in ((p0, timage.build_pyramid(a, 3)), (p1, timage.build_pyramid(b, 3))):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert p0[0] is a and p1[0] is b  # level 0 is the image itself
    # pyr_down is the one-level entry
    assert torch.equal(timage.pyr_down(a), p0[1])


def test_level_limit_refused_before_a_launch():
    img = torch.zeros(16, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match=f"MAX_LEVELS = {timage.MAX_LEVELS}"):
        timage._pyramids_cuda([img], timage.MAX_LEVELS + 1)
    # one level launches nothing: the image itself
    assert timage._pyramids_cuda([img, img], 1) == [[img], [img]]
