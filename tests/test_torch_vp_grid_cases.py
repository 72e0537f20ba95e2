"""K8's ``vp_grid`` twin against a grid built here from the JAX package's own
``_line_params`` and ``_sphere_coords`` with the expression of
``vplines_slam_tpu/ops/vp.py:88-109`` (the line-pair votes, their
scatter-add and the 4-neighbour smoothing that wraps on both axes),
reproduced in ``reference_grid``; torch f64 on the CPU against JAX x64.

Cases (``utils/synthetic.vp_line_cases``): 64 lines through three orthogonal
VPs (hundreds of votes in one cell), votes on latitude rows 0 and 89 and on
longitude 0 and 359 (both wraps), no valid line, one valid line, and pairs
on and just past the pair-angle gate.

Tolerance: 1e-12 of the grid's largest cell.  Both sides compute the same
f64 expressions and both scatters add in pair order, but the two libraries'
trig functions may round a direction apart by an ulp, which moves a vote on
a bin edge to the next cell; no case here has such a vote (the test would
show it as a cell off by a whole vote).

On the CPU ``index_add`` sums in index order (pair order here), so the twin
is also held bit-equal to a pair-order Python loop on the hot case, f64 and
f32: the order the kernel reproduces on the card (its sums are formed from 0
in ascending pair order, without atomics).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import vp as jvp
from vplines_slam_tpu_torch.ops import vp as tvp
from vplines_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CASES = synthetic.vp_line_cases(seed=0)
JCFG, TCFG = jvp.VPConfig(), tvp.VPConfig()


def reference_grid(line, length, angle, valid, cfg):
    """vplines_slam_tpu/ops/vp.py:88-109: the smoothed grid, and the raw
    votes' (la, lo, weight) per pair."""
    L = line.shape[0]
    w_valid = valid.astype(line.dtype)
    inter = jnp.cross(line[:, None, :], line[None, :, :])
    norm = jnp.linalg.norm(inter, axis=-1)
    dang = jnp.abs(angle[:, None] - angle[None, :])
    dang = jnp.minimum(jnp.pi - dang, dang)
    wpair = (jnp.sqrt(length[:, None] * length[None, :]) * (jnp.sin(2.0 * dang) + 0.2)
             * w_valid[:, None] * w_valid[None, :] * (norm > 1e-9)
             * (dang <= cfg.pair_angle_gate))
    iu = jnp.triu_indices(L, k=1)
    wts = wpair[iu]
    la, lo = jvp._sphere_coords(inter[iu], cfg)
    grid = jnp.zeros((cfg.grid_la, cfg.grid_lo), line.dtype).at[la, lo].add(wts)
    smooth = (grid + jnp.roll(grid, 1, 0) + jnp.roll(grid, -1, 0)
              + jnp.roll(grid, 1, 1) + jnp.roll(grid, -1, 1))
    return np.asarray(smooth), np.asarray(la), np.asarray(lo), np.asarray(wts)


def inputs(name):
    segs, valid, angles = CASES[name]
    f, cx, cy = synthetic.VP_CAMERA[:3]
    line, length, angle = jvp._line_params(jnp.asarray(segs), f, cx, cy)
    if angles is not None:
        angle = jnp.asarray(angles)
    return line, length, angle, jnp.asarray(valid)


def twin(line, length, angle, valid, dtype=torch.float64):
    t = lambda a: torch.as_tensor(np.array(a)).to(dtype)
    return tvp.vp_grid_plain(t(line), t(length), t(angle), torch.as_tensor(np.array(valid)),
                             TCFG)


@pytest.mark.parametrize("name", list(CASES))
def test_vp_grid_case_matches_jax(name):
    args = inputs(name)
    ref, la, lo, wts = reference_grid(*args, JCFG)
    got = twin(*args).numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    print(f"{name}: {int((wts > 0).sum())} votes, largest cell {scale:.4f}, "
          f"max |twin - reference| / largest = {err:.3e} (tol 1e-12)")
    assert err <= 1e-12
    voted = wts > 0
    if name == "hot":
        cells = la[voted] * JCFG.grid_lo + lo[voted]
        assert np.bincount(cells).max() >= 100  # hundreds of votes in one cell
    elif name == "wrap":
        rows, cols = set(la[voted].tolist()), set(lo[voted].tolist())
        assert {0, JCFG.grid_la - 1} <= rows and {0, JCFG.grid_lo - 1} <= cols
        # the smoothing carries row 0's votes into row 89 and column 0's
        # into column 359, and back
        raw = np.zeros((JCFG.grid_la, JCFG.grid_lo))
        np.add.at(raw, (la[voted], lo[voted]), wts[voted])
        for r, c in zip(*np.nonzero(raw[[0, -1]])):
            r = 0 if r == 0 else JCFG.grid_la - 1
            assert got[(r + 1) % JCFG.grid_la, c] > 0 and got[r - 1, c] > 0
            assert got[r, (c + 1) % JCFG.grid_lo] > 0 and got[r, c - 1] > 0
    elif name in ("none valid", "one valid"):
        assert not voted.any() and not got.any()
    elif name == "gate":
        iu = np.triu_indices(4, k=1)
        votes = dict(zip(zip(*iu), voted))
        assert votes[(0, 1)] and not votes[(0, 2)]  # on the gate, just past it


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vp_grid_twin_sums_in_pair_order(dtype):
    """The twin's grid equals, bit for bit, a Python loop adding each pair's
    vote in pair order (i < j, row-major), then the same smoothing."""
    line, length, angle, valid = (torch.as_tensor(np.array(a)) for a in inputs("hot"))
    line, length, angle = line.to(dtype), length.to(dtype), angle.to(dtype)
    got = tvp.vp_grid_plain(line, length, angle, valid, TCFG)
    L = line.shape[0]
    inter = torch.linalg.cross(line[:, None, :].expand(L, L, 3), line[None].expand(L, L, 3))
    dang = torch.abs(angle[:, None] - angle[None, :])
    dang = torch.minimum(np.pi - dang, dang)
    w = (torch.sqrt(length[:, None] * length[None, :]) * (torch.sin(2.0 * dang) + 0.2)
         * (torch.linalg.norm(inter, dim=-1) > 1e-9).to(dtype)
         * (dang <= TCFG.pair_angle_gate).to(dtype))
    iu = torch.triu_indices(L, L, offset=1)
    la, lo = tvp._sphere_coords(inter[iu[0], iu[1]], TCFG)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    grid = np.zeros(TCFG.grid_la * TCFG.grid_lo, np_dtype)
    for k, (i, j) in enumerate(zip(iu[0].tolist(), iu[1].tolist())):
        c = int(la[k]) * TCFG.grid_lo + int(lo[k])
        grid[c] = grid[c] + np_dtype(w[i, j])
    g = torch.as_tensor(grid.reshape(TCFG.grid_la, TCFG.grid_lo))
    ref = (g + torch.roll(g, 1, 0) + torch.roll(g, -1, 0) + torch.roll(g, 1, 1)
           + torch.roll(g, -1, 1))
    assert torch.equal(got, ref)
