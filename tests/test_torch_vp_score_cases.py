"""K8's hypothesis search on its plain route: the port's ``detect_vps``
against the JAX package's on the line sets of ``utils/synthetic.
vp_line_cases``, the argmax's tie rule on ``vp_score_plain``, and the
detector's constants made once per (config, dtype, device).

On the card ``vp_score`` is one launch of a 16-CTA cluster; ``chip_smoke.py``
holds it to the bit against the previous one-CTA kernel there.  What the
kernel must keep is what these tests pin on the plain route: the greatest
score wins, and on ties the LOWEST flat index ``p * S + s`` (an all-zero
grid ties everywhere and gives index 0).

The pair draw is JAX's own (its uniforms handed to the port, as
``tests/test_torch_lines.py`` does).  Tolerance: ``vps`` 1e-12 at x64 (the
same f64 expressions; the libraries' trig may differ by an ulp), labels and
``ok`` exact.
"""

import jax
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
F, CX, CY = synthetic.VP_CAMERA[:3]


def vp_uniforms(key, cfg):
    """The uniforms ``detect_vps(..., key)`` draws its line pairs from."""
    k1, _ = jax.random.split(key)
    return np.asarray(jax.random.uniform(k1, (cfg.n_pairs, 2), dtype=jnp.float64))


def port_detect(segs, valid, u):
    t = lambda a: torch.as_tensor(np.array(a))
    return tvp.detect_vps(t(segs), t(valid), F, CX, CY, t(u), TCFG)


@pytest.mark.parametrize("name", list(CASES))
def test_detect_vps_case_matches_jax(name):
    segs, valid, _ = CASES[name]
    key = jax.random.PRNGKey(5)
    jvps, jid, jok = jax.jit(jvp.detect_vps, static_argnums=6)(
        jnp.asarray(segs), jnp.asarray(valid), F, CX, CY, key, JCFG)
    tvps, tid, tok = port_detect(segs, valid, vp_uniforms(key, JCFG))
    np.testing.assert_allclose(tvps.numpy(), np.asarray(jvps), atol=1e-12, rtol=0.0)
    assert np.array_equal(tid.numpy(), np.asarray(jid))
    assert bool(tok) == bool(jok)
    if name == "none valid":  # an all-zero grid: nothing detected
        assert not bool(tok) and bool((tid == 3).all())


def hypotheses(seed, P=16):
    """vp1 [P, 3], b1, b2 and the sweep's cos / sin, as detect_vps makes them."""
    rng = np.random.default_rng(seed)
    vp1 = rng.standard_normal((P, 3))
    vp1 /= np.linalg.norm(vp1, axis=1, keepdims=True)
    ref = np.where(np.abs(vp1[:, 2:3]) < 0.95, [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    b1 = np.cross(vp1, ref)
    b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    b2 = np.cross(vp1, b1)
    _, _, sweep = tvp.detector_constants(TCFG, torch.float64, torch.device("cpu"))
    return tuple(torch.tensor(x) for x in (vp1, b1, b2)) + (sweep[0], sweep[1])


def cells(vp1, b1, b2, cs, sn):
    """[P, S, 3] flat grid cells of every hypothesis' (vp1, vp2, vp3), by JAX's
    binning."""
    vp1, b1, b2, cs, sn = (np.asarray(x) for x in (vp1, b1, b2, cs, sn))
    v2 = b1[:, None, :] * cs[None, :, None] + b2[:, None, :] * sn[None, :, None]
    v3 = np.cross(vp1[:, None, :], v2)
    out = []
    for v in (np.broadcast_to(vp1[:, None, :], v2.shape), v2, v3):
        la, lo = jvp._sphere_coords(jnp.asarray(v), JCFG)
        out.append(np.asarray(la) * JCFG.grid_lo + np.asarray(lo))
    return np.stack(out, -1)


def lines_and_valid():
    segs, valid, _ = CASES["hot"]
    line, _, _ = tvp._line_params(torch.tensor(segs), F, CX, CY)
    return line, torch.tensor(valid)


def test_all_zero_grid_picks_index_0():
    vp1, b1, b2, cs, sn = hypotheses(1)
    line, valid = lines_and_valid()
    grid = torch.zeros(TCFG.grid_la, TCFG.grid_lo, dtype=torch.float64)
    vps, _, best = tvp.vp_score_plain(grid, vp1, b1, b2, cs, sn, line, valid, TCFG)
    assert float(best) == 0.0
    assert torch.equal(vps[0], vp1[0])
    assert torch.equal(vps[1], b1[0] * cs[0] + b2[0] * sn[0])


@pytest.mark.parametrize("seed", [2, 3])
def test_exact_tie_picks_the_lower_flat_index(seed):
    vp1, b1, b2, cs, sn = hypotheses(seed)
    line, valid = lines_and_valid()
    c = cells(vp1, b1, b2, cs, sn).reshape(-1, 3)
    # two hypotheses far apart in flat order, one cell of each worth 1.0: the
    # highest score (1.0, or 2.0 where a hypothesis holds both cells) is tied
    rng = np.random.default_rng(seed)
    ha, hb = sorted(rng.choice(c.shape[0], 2, replace=False))
    grid = np.zeros(JCFG.grid_la * JCFG.grid_lo)
    grid[c[ha, 1]] = 1.0
    grid[c[hb, 2]] = 1.0
    scores = grid[c].sum(-1)  # 0 + g1 + g2 + g3: small integers, exact
    expect = int(np.flatnonzero(scores == scores.max())[0])
    assert int((scores == scores.max()).sum()) >= 2  # a real tie
    vps, _, best = tvp.vp_score_plain(torch.tensor(grid).view(JCFG.grid_la, JCFG.grid_lo),
                                      vp1, b1, b2, cs, sn, line, valid, TCFG)
    p, s = divmod(expect, TCFG.n_sweep)
    assert float(best) == scores.max()
    assert torch.equal(vps[0], vp1[p])
    assert torch.equal(vps[1], b1[p] * cs[s] + b2[p] * sn[s])


def test_two_calls_equal():
    segs, valid, _ = CASES["hot"]
    u = np.random.default_rng(4).uniform(0, 1, (TCFG.n_pairs, 2))
    a, b = port_detect(segs, valid, u), port_detect(segs, valid, u)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_constants_equal_a_fresh_computation(dtype):
    dev = torch.device("cpu")
    ez, ex, sweep = tvp.detector_constants(TCFG, dtype, dev)
    assert tvp.detector_constants(TCFG, dtype, dev)[2] is sweep  # made once
    s = (torch.arange(TCFG.n_sweep, dtype=torch.float64) * (np.pi / TCFG.n_sweep)).to(dtype)
    assert sweep.dtype == dtype and tuple(sweep.shape) == (2, TCFG.n_sweep)
    assert torch.equal(sweep[0], torch.cos(s)) and torch.equal(sweep[1], torch.sin(s))
    assert ez.tolist() == [0.0, 0.0, 1.0] and ex.tolist() == [1.0, 0.0, 0.0]
    # the kernel takes the cached rows as the table they are (a view), and
    # stacks any other pair
    view = tvp._sweep_table(sweep[0], sweep[1])
    assert view.data_ptr() == sweep.data_ptr() and torch.equal(view, sweep)
    other = tvp._sweep_table(sweep[1], sweep[0])
    assert torch.equal(other[0], sweep[1]) and torch.equal(other[1], sweep[0])
