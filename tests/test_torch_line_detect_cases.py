"""K6's function on its plain route: the port's ``detect_lines`` against the
JAX package's on the images of ``utils/synthetic.line_detect_cases`` (a
constant frame, an all-zero one, a 61x97 crop with fewer cells than
``max_anchors``, stripes whose cells tie) and on one rendered 752x480
frame; the walks before the dedupe against the reference's own (its
``_debug_stash``, switched on for the test's duration; not on the constant
frame, whose border cells tie up to the last bits); the selection
against ``jax.lax.top_k``'s order on tied values; and the rank rule the
kernel selects by.

On the card the selection and the walks are one launch (``csrc/lines.cu``
``vp_line_select_grow``): a cell's slot is its rank, the number of cells
with a greater value plus those with an equal value and a lower index.
That is the stable descending sort of ``select_cells_plain`` and the order
of ``lax.top_k``, which these tests pin.  ``chip_smoke.py`` holds the
kernel to the twin and, to the bit, to the previous kernels.

Tolerances (x64): segments and lengths 1e-9 px (the same f64 expressions;
the libraries' trig may differ by an ulp), the walks' segments 1e-9 and
fits 1e-6 (a fit is the root of the minor eigenvalue tr/2 - sqrt(tr^2/4 -
det), which cancels on a straight support: 1e-14 of rounding there is 1e-7
in the root on the stripes), valid flags, a_ok, supports and the selection
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import lines as jlines
from vplines_slam_tpu_torch.ops import lines as tlines
from vplines_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

JCFG = jlines.LineDetectConfig(min_len=35.0, fit_err=1.8)
TCFG = tlines.LineDetectConfig(min_len=35.0, fit_err=1.8)


def rendered_frame():
    """One 752x480 frame of the rendered line world (the lines slice's)."""
    from vplines_slam_tpu_torch.models import camera as cam_mod
    from vplines_slam_tpu_torch.utils import demo

    f32, cpu = torch.float32, torch.device("cpu")
    cam = cam_mod.pinhole(461.6, 460.3, 363.0, 248.1, width=752, height=480, dtype=f32,
                          device=cpu)
    q_ic, p_ic = demo.forward_camera_extrinsic(f32, cpu)
    rend = demo.BlobWorldRenderer(cam, q_ic, p_ic, n_pts=700, seed=4, dtype=f32, device=cpu,
                                  tex_gain=0.1, grid_band=0.2, grid_dark=0.0)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f32)
    return rend.render(q, torch.tensor([0.3, -0.2, 0.4], dtype=f32)).double().numpy()


@pytest.fixture(scope="module")
def images():
    out = dict(synthetic.line_detect_cases(seed=0))
    out["rendered"] = rendered_frame()
    return out


@pytest.fixture(scope="module")
def jax_runs(images):
    """Each image through the reference's detect_lines, eagerly, with its
    pre-dedupe stash: (outputs, stash)."""
    runs = {}
    jlines._debug_stash["enabled"] = True
    try:
        for name, img in images.items():
            out = jlines.detect_lines(jnp.asarray(img), JCFG)
            runs[name] = (out, dict(jlines._debug_stash["pre"]))
    finally:
        jlines._debug_stash.clear()
    return runs


NAMES = ["constant", "zero", "61x97", "stripes", "rendered"]


@pytest.mark.parametrize("name", NAMES)
def test_detect_lines_case_matches_jax(images, jax_runs, name):
    (js, jl, jv), _ = jax_runs[name]
    ts, tl, tv = tlines.detect_lines(torch.as_tensor(images[name]), TCFG)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-9, rtol=0.0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-9, rtol=0.0)
    if name == "rendered":
        assert int(tv.sum()) >= 10


@pytest.mark.parametrize("name", ["zero", "61x97", "stripes", "rendered"])
def test_select_and_grow_twin_matches_the_reference_walks(images, jax_runs, name):
    _, pre = jax_runs[name]
    mag, dx, dy, best_val, best_idx = tlines.line_anchors(torch.as_tensor(images[name]), TCFG)
    ax, ay, a_ok = tlines.select_cells_plain(best_val, best_idx, TCFG)
    assert np.array_equal(a_ok.numpy(), np.asarray(pre["a_ok"]))
    assert np.array_equal(ax.numpy(), np.asarray(pre["ax"]))
    assert np.array_equal(ay.numpy(), np.asarray(pre["ay"]))
    segs, lens, fits, n, ok = tlines.select_and_grow_plain(best_val, best_idx, mag, dx, dy, TCFG)
    k = a_ok.numpy()
    assert np.array_equal(ok.numpy(), k)
    np.testing.assert_allclose(segs.numpy()[k], np.asarray(pre["segs"])[k], atol=1e-9, rtol=0)
    np.testing.assert_allclose(lens.numpy()[k], np.asarray(pre["lens"])[k], atol=1e-9, rtol=0)
    np.testing.assert_allclose(fits.numpy()[k], np.asarray(pre["fits"])[k], atol=1e-6, rtol=0)
    assert np.array_equal(n.numpy()[k], np.asarray(pre["supports"])[k])
    # the slots the kernel does not walk read zeros
    for x in (segs, lens, fits, n):
        assert bool((x[~a_ok] == 0).all())


def test_constant_frame_anchors_only_on_the_border(images, jax_runs):
    # the zero padding alone makes gradients; the four borders' magnitudes
    # tie up to the last bits, which the two packages round apart, so the
    # order of the border cells (and the pixel within a corner cell) may
    # differ: the count of ok anchors and where they lie do not
    _, pre = jax_runs["constant"]
    mag, dx, dy, bv, bi = tlines.line_anchors(torch.as_tensor(images["constant"]), TCFG)
    ax, ay, a_ok = tlines.select_cells_plain(bv, bi, TCFG)
    assert int(a_ok.sum()) == int(np.asarray(pre["a_ok"]).sum()) > 0
    x, y = ax[a_ok], ay[a_ok]
    assert bool(((x <= 1) | (x >= 750) | (y <= 1) | (y >= 478)).all())


def test_selection_falls_back_to_cell_order_and_pads(images):
    # every cell of the zero frame scores 0: the selection is the cells in
    # order, none ok; the 61x97 crop has 28 cells, so slots 28.. are zeros
    _, _, _, bv, bi = tlines.line_anchors(torch.as_tensor(images["zero"]), TCFG)
    ax, ay, a_ok = tlines.select_cells_plain(bv, bi, TCFG)
    cw = bv.shape[1]
    cells = torch.arange(TCFG.max_anchors)
    assert not bool(a_ok.any())
    assert torch.equal(ax, (cells % cw * 16).double()) and torch.equal(ay, (cells // cw * 16).double())
    _, _, _, bv, bi = tlines.line_anchors(torch.as_tensor(images["61x97"]), TCFG)
    assert bv.shape == (4, 7)
    ax, ay, a_ok = tlines.select_cells_plain(bv, bi, TCFG)
    assert not bool(a_ok[28:].any()) and bool((ax[28:] == 0).all()) and bool((ay[28:] == 0).all())


def tied_values(seed=0, n=1410):
    """Cell values drawn from five levels (zero among them): most cells tie."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0.0, 0.05, 0.125, 0.5, 1.0]), n)


@pytest.mark.parametrize("k", [512, 1410])
def test_selection_order_is_lax_top_k_order(k):
    vals = tied_values()
    _, j_cell = jax.lax.top_k(jnp.asarray(vals), k)
    cfg = TCFG._replace(max_anchors=k)
    best_val = torch.as_tensor(vals).reshape(30, 47)
    best_idx = torch.zeros(30, 47, dtype=torch.int32)  # each cell's top-left pixel
    ax, ay, a_ok = tlines.select_cells_plain(best_val, best_idx, cfg)
    cell = (ay.long() // 16) * 47 + ax.long() // 16
    assert np.array_equal(cell.numpy(), np.asarray(j_cell))
    assert np.array_equal(a_ok.numpy(), vals[np.asarray(j_cell)] > 0)


def test_rank_rule_is_the_stable_descending_sort():
    # the kernel's slot of cell c: cells with a greater value plus cells with
    # an equal value and a lower index
    vals = tied_values(seed=1)
    idx = np.arange(vals.size)
    rank = ((vals[None, :] > vals[:, None]) | ((vals[None, :] == vals[:, None])
                                               & (idx[None, :] < idx[:, None]))).sum(1)
    order = torch.sort(torch.as_tensor(vals), descending=True, stable=True).indices.numpy()
    assert np.array_equal(np.sort(rank), idx)  # a permutation: one cell a slot
    assert np.array_equal(order[rank], idx)
