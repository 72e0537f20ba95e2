"""K3's function on its plain route: the port's ``detect`` against the JAX
package's on the inputs of ``utils/synthetic.corner_cases`` (a constant and
an all-zero frame, a ramp, a negative quality, ties within and across
cells, tracked features several to a cell, min_dist 7 to 45 on sizes that
are no multiples of it, max_corners above and below the cell count), and
the selection rule K3's kernels compute, modelled here in numpy, against
the plain route.

On the card ``detect`` is two launches (``csrc/corners.cu``): pass 1 keeps,
per cell, the greatest positive in-border NMS value v* at its first index
i*; pass 2 takes (v*, i*) if v* > thresh else (0, 0), which is the
thresholded argmax whenever thresh >= 0, and scans the kept NMS map of the
exact path when thresh < 0; then it ranks the cells (greater values, then
equal values at lower indices).  ``kernel_model`` follows those steps and
must give the plain route's outputs to the bit.  ``chip_smoke.py`` holds
the kernels to the plain route and, to the bit, to the previous kernels.

Tolerances (x64), as ``tests/test_torch_ops.py``'s detect test: valid flags
and the positions of valid slots exact, scores 1e-15.  Every slot's
position is compared exactly too (an invalid slot holds its cell's best
pixel, the cell's corner when the cell scored 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import corners as jcorners
from vplines_slam_tpu_torch.ops import corners as tcorners
from vplines_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CASES = synthetic.corner_cases(seed=0)


def run_jax(c):
    kw = {k: jnp.asarray(c[k]) for k in ("existing_xy", "existing_mask")
          if c[k] is not None}
    return [np.asarray(o) for o in jcorners.detect(
        jnp.asarray(c["img"]), c["max_corners"], c["min_dist"], c["quality"], **kw)]


def run_torch(c, fn=tcorners.detect):
    kw = {k: torch.from_numpy(np.asarray(c[k])) for k in ("existing_xy", "existing_mask")
          if c[k] is not None}
    return [o.numpy() for o in fn(torch.from_numpy(c["img"]), c["max_corners"],
                                  c["min_dist"], c["quality"], **kw)]


@pytest.mark.parametrize("name", list(CASES))
def test_detect_matches_jax(name):
    c = CASES[name]
    (jxy, js, jv), (txy, ts, tv) = run_jax(c), run_torch(c)
    assert txy.shape == (c["max_corners"], 2)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(txy, jxy)  # every slot, invalid ones too
    np.testing.assert_allclose(ts, js, atol=1e-15, rtol=0)


def kernel_model(c):
    """K3's two passes in numpy on the plain route's NMS map."""
    img = torch.from_numpy(c["img"])
    md, q, border, k_max = c["min_dist"], c["quality"], 5, c["max_corners"]
    H, W = img.shape
    nms = tcorners._nms(tcorners.min_eig_response(img)).numpy()
    thresh = q * nms.max()
    yy, xx = np.mgrid[0:H, 0:W]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    m = np.where(inb, nms, 0.0)
    ch, cw = -(-H // md), -(-W // md)
    vals, idxs = np.zeros(ch * cw), np.zeros(ch * cw, np.int64)
    for c_ in range(ch * cw):
        blk = np.zeros((md, md))
        y0, x0 = (c_ // cw) * md, (c_ % cw) * md
        part = m[y0:y0 + md, x0:x0 + md]
        blk[:part.shape[0], :part.shape[1]] = part
        flat = blk.reshape(-1)
        if thresh >= 0:  # pass 1's positive key, pass 2's shortcut
            v = flat.max()
            if v > thresh:
                vals[c_], idxs[c_] = v, int(np.argmax(flat))
        else:  # the exact path: the thresholded argmax of the kept map
            t = np.where(flat > thresh, flat, 0.0)
            vals[c_], idxs[c_] = t.max(), int(np.argmax(t))
    exy = None if c["existing_xy"] is None else torch.from_numpy(c["existing_xy"])
    emask = None if c["existing_mask"] is None else torch.from_numpy(c["existing_mask"])
    occ = tcorners._occupied(exy, emask, md, ch, cw, img.device).numpy().reshape(-1)
    vals = np.where(occ, 0.0, vals)
    # the rank: nonzero cells among themselves, zero cells after the positive
    # ones in cell order, negative ones after every zero
    n_pos, n_zero = int((vals > 0).sum()), int((vals == 0).sum())
    rank = np.empty(ch * cw, np.int64)
    for c_ in range(ch * cw):
        v = vals[c_]
        if v == 0:
            rank[c_] = n_pos + int((vals[:c_] == 0).sum())
        else:
            rank[c_] = (int((vals[:c_][vals[:c_] != 0] >= v).sum())
                        + int((vals[c_ + 1:][vals[c_ + 1:] != 0] > v).sum())
                        + (n_zero if v < 0 else 0))
    xy, score, valid = np.zeros((k_max, 2)), np.zeros(k_max), np.zeros(k_max, bool)
    for c_ in range(ch * cw):
        r = rank[c_]
        if r < k_max:
            i = idxs[c_]
            xy[r] = ((c_ % cw) * md + i % md, (c_ // cw) * md + i // md)
            score[r], valid[r] = vals[c_], vals[c_] > 0
    return xy, score, valid


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_matches_plain_route(name):
    c = CASES[name]
    got, ref = kernel_model(c), run_torch(c, tcorners.detect_plain)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_cases_reach_their_branches():
    """The ties tie, the ramp's responses round negative, the negative
    quality makes the threshold negative, the tracked features clear and
    set cells, the crops' cells overhang the image."""
    t = CASES["ties"]
    xy, score, valid = run_torch(t)
    # 32 bright cells tie for 24 slots: the lower cells win, each at its first dot
    assert valid.all() and len(np.unique(score)) == 1
    _, all_scores, all_valid = run_torch(dict(t, max_corners=48))
    assert all_valid.sum() == 48 and len(np.unique(all_scores)) == 2
    cells = (xy[:, 1] // 16) * 8 + xy[:, 0] // 16
    assert (np.diff(cells) > 0).all() and (xy % 16 == 6).all()
    ramp = torch.from_numpy(CASES["ramp"]["img"])
    resp = tcorners.min_eig_response(ramp).numpy()[3:-3, 3:-3]
    assert (resp < 0).any() and np.abs(resp).max() < 1e-15
    nq = CASES["quality < 0"]
    nms = tcorners._nms(tcorners.min_eig_response(torch.from_numpy(nq["img"]))).numpy()
    assert nq["quality"] * nms.max() < 0
    tr = CASES["tracked"]
    occ = tcorners._occupied(torch.from_numpy(tr["existing_xy"]),
                             torch.from_numpy(tr["existing_mask"]), 16, 6, 8,
                             torch.device("cpu"))
    assert not occ[1, 1] and occ[2, 3] and occ[4, 4]  # the last slot of each cell decides
    for name in ("min_dist 7", "min_dist 45"):
        c = CASES[name]
        H, W = c["img"].shape
        cells = -(-H // c["min_dist"]) * -(-W // c["min_dist"])
        assert H % c["min_dist"] and W % c["min_dist"]
        assert (c["max_corners"] < cells) == (name == "min_dist 7" or name == "min_dist 45")
    assert CASES["zero"]["max_corners"] > 4 * 7  # more slots than cells: zero padding


def test_cuda_limits_refused_before_a_launch():
    """K3 takes float32 and at most MAX_CELLS cells: the CUDA route raises
    before it touches the card."""
    img = torch.zeros(480, 752, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        tcorners._detect_cuda(img, 10, 30, 0.01, None, None, 5)
    img = torch.zeros(480, 752, dtype=torch.float32)
    with pytest.raises(ValueError, match=str(tcorners.MAX_CELLS)):
        tcorners._detect_cuda(img, 10, 4, 0.01, None, None, 5)
