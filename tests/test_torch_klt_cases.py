"""The pyramidal KLT's plain twins (K2's) against the JAX reference on the
cases the fused kernel must reproduce.

Cases (``utils/synthetic.klt_cases``): features on the image border (the
anchor clips), inside a flat square (the det guard, ok false), a shift past
the in-window drift margin from a zero guess (the re-anchor), a gain and
bias change in the line matcher's gain/bias mode, no feature, and 1-4
pyramid levels from an initial flow.  ``track_plain`` (the level loop and
the gates, what ``track`` runs on CPU tensors) is held against JAX's
``ops/klt.track``, ``_track_level_plain`` against JAX's ``_track_level`` on
each case's finest level, both at f64 on the CPU with the tolerances of
``tests/test_torch_ops.py``'s KLT tests: ok flags identical, flows and
points within 1e-8 px (the same f64 arithmetic, reductions in another
order), mean residuals within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import klt as jklt
from vplines_slam_tpu_torch.ops import klt as tklt
from vplines_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CASES = synthetic.klt_cases(seed=0)
LEVEL_CASES = ["border", "flat", "past drift", "gain/bias"]


def T(a):
    return torch.as_tensor(np.array(a))


def configs(over):
    return jklt.KLTConfig(**over), tklt.KLTConfig(**over)


def close(jax_out, torch_out, atol):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out), atol=atol, rtol=0.0)


@pytest.mark.parametrize("name", list(CASES))
def test_track_plain_matches_jax(name):
    img0, img1, pts, init, over = CASES[name]
    cj, ct = configs(over)
    jp, jo, jr = jklt.track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), cj,
                            init_flow=None if init is None else jnp.asarray(init))
    args = (T(img0), T(img1), T(pts), ct)
    tp, to, tr = tklt.track_plain(*args, init_flow=None if init is None else T(init))
    assert np.array_equal(np.asarray(jo), to.numpy())
    close(jp, tp, 1e-8)
    close(jr, tr, 1e-10)
    # on CPU tensors track is its plain twin
    for a, b in zip(tklt.track(*args, init_flow=None if init is None else T(init)),
                    (tp, to, tr)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", LEVEL_CASES)
def test_track_level_plain_matches_jax(name):
    img0, img1, pts, _, over = CASES[name]
    cj, ct = configs(over)
    zero = np.zeros_like(pts)
    jf, jo, jr = jklt._track_level(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                                   jnp.asarray(zero), cj, jnp.float64)
    tf, to, tr = tklt._track_level_plain(T(img0), T(img1), T(pts), T(zero), ct)
    assert np.array_equal(np.asarray(jo), to.numpy())
    close(jf, tf, 1e-8)
    close(jr, tr, 1e-10)


def test_the_cases_reach_their_branches():
    """Each case exercises what it is named for: the flat square's features
    fail the conditioning gate (det below 1e-12) and the textured ones pass;
    flows from the shift past the drift margin leave it; the gain/bias
    mode tracks through the intensity change; the border features are cut by
    the in-bounds gate."""
    img0, img1, pts, _, over = CASES["flat"]
    _, ok, _ = tklt._track_level_plain(T(img0), T(img1), T(pts), T(np.zeros_like(pts)),
                                       tklt.KLTConfig(**over))
    assert not ok.numpy()[:6].any() and ok.numpy()[6:].sum() >= 3
    img0, img1, pts, _, over = CASES["past drift"]
    p1, ok, _ = tklt.track_plain(T(img0), T(img1), T(pts), tklt.KLTConfig(**over))
    assert np.abs((p1 - T(pts)).numpy()).max() > tklt.DRIFT and ok.sum() >= 8
    img0, img1, pts, _, over = CASES["gain/bias"]
    p1, ok, _ = tklt.track_plain(T(img0), T(img1), T(pts), tklt.KLTConfig(**over))
    err = (p1 - T(pts)).numpy()[ok.numpy()] - np.array([2.3, -1.4])
    assert ok.sum() >= 12 and np.median(np.abs(err)) < 0.1
    img0, img1, pts, _, over = CASES["border"]
    _, ok, _ = tklt.track_plain(T(img0), T(img1), T(pts), tklt.KLTConfig(**over))
    assert not ok.numpy()[:9].any()


def test_kernel_limits_raise_before_launching():
    """K2 takes at most MAX_LEVELS levels and odd windows up to 31: the
    wrapper names the limit before it checks or launches anything."""
    img = torch.zeros(64, 64)
    pts = torch.zeros(3, 2)
    levels = tklt.MAX_LEVELS + 1
    with pytest.raises(ValueError, match="MAX_LEVELS"):
        tklt._track_cuda([img] * levels, [img] * levels, pts, None,
                         tklt.KLTConfig(levels=levels), True)
    with pytest.raises(ValueError, match="window"):
        tklt._track_cuda([img], [img], pts, None, tklt.KLTConfig(win=33), True)
