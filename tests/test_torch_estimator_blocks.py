"""Parity of the estimator's block path with the JAX reference (torch f64 on
the CPU against JAX x64): the per-observation Jacobian blocks (K11's plain
twin), the block normal equations from them (K12's twin), the
marginalization from the blocks (K14's twin, ``marginalize_window_blocks``),
``marginalize_old`` through the blocks, and one LM iteration through blocks +
Schur (K13's twin) with the accept forced.

One window, the lines window of ``test_torch_lines_solver.py`` with every
residual family live (a prior, relo rows), in both of the port's layouts:
the points layout (no line columns, no line/VP rows: compared against the
reference's other rows) and the lines layout.  The CUDA kernels themselves
are held against these twins on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.estimator import slide as jslide
from vplines_slam_tpu.estimator import window as jwin
from vplines_slam_tpu.solver import lm as jlm
from vplines_slam_tpu.solver import marginalization as jmarg
from vplines_slam_tpu.utils import demo as jdemo
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator import linearize as tlin
from vplines_slam_tpu_torch.estimator import slide as tslide
from vplines_slam_tpu_torch.estimator import window as twin
from vplines_slam_tpu_torch.solver import lm as tlm
from vplines_slam_tpu_torch.solver import marginalization as tmarg
from test_torch_solver import close, close_prior

torch.set_num_threads(1)

KW = dict(window=4, max_points=24, max_lines=8, max_imu=8, line_min_obs=3)
JCFG = jwin.WindowConfig(**KW)
TCFG = twin.WindowConfig(**KW)
LAYOUTS = ["points", "lines"]


def to_t(x):
    return convert.to_torch(x, device="cpu")


@pytest.fixture(scope="module")
def window():
    """The lines window of test_torch_lines_solver.py with every family live:
    the prior of its own frame-0 marginalization (set, not slid), relo rows
    against a relo pose near frame 1 (each solved track's frame-1 ray), its
    last frame moved; and the reference's linearization of it (its lines
    layout, jitted as the other parity tests run it)."""
    state, data, params = jdemo.synthetic_window(
        JCFG, n_landmarks=60, frame_dt=0.1, imu_per_interval=8, seed=0, perturb=0.01,
        n_lines=40)
    rng = np.random.default_rng(4)
    L = KW["max_lines"]
    data = data._replace(ln_orth=data.ln_orth + jnp.asarray(rng.standard_normal((L, 4)) * 2e-3)
                         * data.ln_solved[:, None])
    prior = jax.jit(lambda s, d: jslide.marginalize_old(s, d, JCFG, params))(state, data)
    data = data._replace(prior=prior, prior_state=state, relo_valid=jnp.asarray(True),
                         relo_mask=data.pt_solved, relo_obs=data.pt_obs[:, 1])
    state = state._replace(p=state.p.at[-1].set(state.p[-2] + 0.05),
                           q=state.q.at[-1].set(state.q[-2]),
                           p_relo=state.p[1] + 0.02, q_relo=state.q[1])
    lay = jlm.WindowLayout(nd=JCFG.nd, nf=JCFG.nf, P=JCFG.max_points, L=L)
    lin = jax.jit(lambda s, d: jlm._structured_linearize(
        lambda x: jwin.window_residuals(x, d, JCFG, params),
        lambda x, dd: jwin.retract_all(x, dd, JCFG), (s, d.pt_inv_depth, d.ln_orth), lay))(
        state, data)
    return dict(js=state, jd=data, jp=params, lay=lay, lin=lin, ts=to_t(state), td=to_t(data),
                tp=to_t(params))


def _port_rows(W, lines):
    """The port layout's rows in the reference's stack (the points layout
    leaves out the line and VP rows)."""
    sl = W["lay"].slices()
    segs = ("prior", "imu", "points") + (("lines", "vps") if lines else ()) + ("relo",)
    return np.concatenate([np.arange(sl[k].start, sl[k].stop) for k in segs])


def _reference_blocks(W, lines):
    """The reference's _assemble_blocks over the port layout's rows (its
    other rows zeroed)."""
    r0, J_d, col_p, cols_l = W["lin"]
    keep = np.zeros(r0.shape[0], bool)
    keep[_port_rows(W, lines)] = True
    m = jnp.asarray(keep)
    return jlm._assemble_blocks(r0 * m, J_d * m[:, None], col_p * m, cols_l * m[:, None],
                                W["lay"])


def _port_x(W, lines):
    return (W["ts"], W["td"].pt_inv_depth) + ((W["td"].ln_orth,) if lines else ())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_window_blocks_scatter_to_the_reference_linearization(window, layout):
    """(a) Every family's blocks (prior, IMU, point, relo and, in the lines
    layout, line and VP rows), scattered back to [R, nd] + col_p (+ cols_l),
    equal the reference's _structured_linearize."""
    W, lines = window, layout == "lines"
    blocks = tlin.window_blocks(_port_x(W, lines), W["td"], TCFG, W["tp"])
    lay = twin.layout_for(TCFG, lines)
    dense = tlm.blocks_to_dense(blocks, lay)
    rows = _port_rows(W, lines)
    r0, J_d, col_p, cols_l = (np.asarray(a)[rows] for a in W["lin"])
    close(r0, dense[0], atol=1e-10)
    close(J_d, dense[1], atol=1e-8, rtol=1e-10)
    close(col_p, dense[2], atol=1e-8, rtol=1e-10)
    if lines:
        close(cols_l, dense[3], atol=1e-8, rtol=1e-10)
    sl = lay.slices()
    for seg, _ in lay.segments():  # every family is live
        assert np.abs(dense[1][sl[seg]].numpy()).max() > 0, seg


@pytest.mark.parametrize("layout", LAYOUTS)
def test_blocks_normal_equations_match_the_reference(window, layout):
    """(b) The block normal equations from the blocks (f64) equal the
    reference's _assemble_blocks to 1e-9 of each block's largest entry."""
    W, lines = window, layout == "lines"
    blocks = tlin.window_blocks(_port_x(W, lines), W["td"], TCFG, W["tp"])
    ne = tlm.assemble_blocks(blocks, twin.layout_for(TCFG, lines))
    assert all(t.dtype == torch.float64 for t in ne)
    ref = _reference_blocks(W, lines)
    ref = ref if lines else ref[:5]
    assert len(ne) == len(ref)
    for a, b in zip(ref, ne):
        a = np.asarray(a)
        close(a, b, atol=1e-9 * np.abs(a).max(), rtol=1e-9)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lm_iteration_through_blocks_matches_the_reference(window, layout):
    """(e) One LM iteration at lambda_init through the blocks, their normal
    equations and the Schur solve, the accept forced (ROADMAP C: the
    accept/reject flips on cost reassociation): the retracted state and its
    cost equal the reference's."""
    W, lines = window, layout == "lines"
    lam = jlm.LMConfig().lambda_init
    x = _port_x(W, lines)
    ne = tlm.assemble_blocks(tlin.window_blocks(x, W["td"], TCFG, W["tp"]),
                             twin.layout_for(TCFG, lines))
    delta = tlm.schur_solve_blocks(*ne[:5], lam, 1e-8, *ne[5:])
    x1 = twin.retract_all(x, delta, TCFG)
    r1 = tlin.window_cost_residuals(x1, W["td"], TCFG, W["tp"])

    jp = W["jp"]

    def step(s, d, blocks):
        xj = jwin.retract_all((s, d.pt_inv_depth, d.ln_orth),
                              jlm.schur_solve_blocks(*blocks, lam), JCFG)
        return xj, jwin.window_residuals(xj, d, JCFG, jp)

    jx1, jr1 = jax.jit(step)(W["js"], W["jd"], _reference_blocks(W, lines))
    for f in jx1[0]._fields:
        close(getattr(jx1[0], f), getattr(x1[0], f), atol=1e-9)
    close(jx1[1], x1[1], atol=1e-9)
    if lines:
        close(jx1[2], x1[2], atol=1e-9)
    jr1 = np.asarray(jr1)[_port_rows(W, lines)]
    close(0.5 * jr1 @ jr1, 0.5 * torch.dot(r1, r1), atol=0.0, rtol=1e-9)
    assert float((x1[0].p - x[0].p).abs().max()) > 1e-6  # the step moved the state


@pytest.mark.parametrize("layout", LAYOUTS)
def test_marginalize_old_through_blocks_matches_the_reference(window, layout, monkeypatch):
    """(d) marginalize_old through the blocks (the route the card takes: the
    stack's blocks, their normal equations, marginalize_window_blocks) in
    place of the CPU's jacfwd route; in the lines layout with marg_lines
    (the frame-0 lines' factors enter the prior)."""
    W, lines = window, layout == "lines"
    jcfg, tcfg = JCFG, TCFG
    if lines:
        jcfg = jcfg._replace(marg_lines=True, retire_lines=True)
        tcfg = tcfg._replace(marg_lines=True, retire_lines=True)
    monkeypatch.setattr(tslide, "stack_prior_plain", tslide._stack_prior_blocks)
    jac_calls = tlm.TWIN_CALLS["marg_stack"]
    jpr = jax.jit(lambda s, d: jslide.marginalize_old(s, d, jcfg, W["jp"]))(W["js"], W["jd"])
    tpr = tslide.marginalize_old(W["ts"], W["td"], tcfg, W["tp"], use_lines=lines)
    assert tlm.TWIN_CALLS["marg_stack"] == jac_calls  # no jacfwd
    close_prior(jpr, tpr, rtol=5e-6)


@pytest.mark.parametrize("n_points,n_lines", [(7, 0), (5, 3), (0, 0)],
                         ids=["points", "points_lines", "prior_only"])
def test_marginalize_window_blocks_matches_the_reference(n_points, n_lines):
    """(c) marginalize_window_blocks on the block normal equations of a
    random J equals the reference's marginalize_window(J, r)."""
    rng = np.random.default_rng(20 + n_points + n_lines)
    nd, R = 27, 120
    N = nd + n_points + 4 * n_lines
    J = rng.standard_normal((R, N)) * rng.uniform(0.1, 10, N)
    J[:, nd - 3] = 0.0  # an inactive column
    if n_lines:
        J[:, nd + n_points + 4:nd + n_points + 8] = 0.0  # an unobserved line
        # each row depends on at most one landmark, as in the window
        owner = rng.integers(0, n_points + n_lines, R)
        for k in range(n_points):
            J[owner != k, nd + k] = 0.0
        for l in range(n_lines):
            c = nd + n_points + 4 * l
            J[owner != n_points + l, c:c + 4] = 0.0
    elif n_points:
        owner = rng.integers(0, n_points, R)
        for k in range(n_points):
            J[owner != k, nd + k] = 0.0
    r = rng.standard_normal(R)
    jJ, jr = jax.jit(lambda a, b: jmarg.marginalize_window(
        a, b, nd, 6, 9, n_points=n_points, n_lines=n_lines))(jnp.asarray(J), jnp.asarray(r))
    Jd, Jp = J[:, :nd], J[:, nd:nd + n_points]
    Jl = J[:, nd + n_points:].reshape(R, n_lines, 4)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    blocks = dict(H_dp=t(Jd.T @ Jp), h_p=t((Jp * Jp).sum(0)), g_p=t(-(Jp.T @ r)))
    if n_lines:
        blocks.update(H_dl=t(np.einsum("rd,rlk->dlk", Jd, Jl)),
                      Hll_b=t(np.einsum("rlk,rlm->lkm", Jl, Jl)),
                      g_l=t(-np.einsum("rlk,r->lk", Jl, r)))
    tJ, tr = tmarg.marginalize_window_blocks(t(Jd.T @ Jd), t(-(Jd.T @ r)), nd, 6, 9, **blocks)
    assert tJ.shape == (nd, nd)
    assert not np.asarray(jJ)[:, nd:].any()  # the landmark columns of the prior are zero
    close_prior(jmarg.Prior(jJ[:nd, :nd], jr[:nd], jnp.asarray(True)),
                tmarg.Prior(tJ, tr, torch.tensor(True)), rtol=1e-9)
