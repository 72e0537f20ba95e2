"""Parity of the port's lines layout of the estimator with the JAX reference
(torch f64 on the CPU against JAX x64): the residual stack with line and VP
rows, the linearization with 4 line tangents, the block normal equations and
the Schur solve with 4x4 line blocks, the window solve, line triangulation,
the line-only settle, the line culls, marginalization with line columns,
both slides with line tables.

The window is the reference's ``synthetic_window`` with projected 3D lines
(every line observed in several frames, with VPs), its positions and line
coordinates perturbed.  Its prior is empty: the prior's paths do not depend
on lines and are held by test_torch_solver.py, and the VIO step with lines
by the slice test.  √-priors are compared through JᵀJ and Jᵀr (their rows
are eigenvectors, free in sign and rotation).
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
from vplines_slam_tpu_torch.estimator import slide as tslide
from vplines_slam_tpu_torch.estimator import window as twin
from vplines_slam_tpu_torch.solver import lm as tlm
from vplines_slam_tpu_torch.solver import marginalization as tmarg
from test_torch_solver import close, close_prior, close_tree

torch.set_num_threads(1)

KW = dict(window=4, max_points=24, max_lines=8, max_imu=8, line_min_obs=3)
JCFG = jwin.WindowConfig(**KW)
TCFG = twin.WindowConfig(**KW)
L = KW["max_lines"]


def to_t(x):
    return convert.to_torch(x, device="cpu")


@pytest.fixture(scope="module")
def window():
    state, data, params = jdemo.synthetic_window(
        JCFG, n_landmarks=60, frame_dt=0.1, imu_per_interval=8, seed=0, perturb=0.01,
        n_lines=40)
    rng = np.random.default_rng(4)
    data = data._replace(ln_orth=data.ln_orth + jnp.asarray(rng.standard_normal((L, 4)) * 2e-3)
                         * data.ln_solved[:, None])
    state = state._replace(p=state.p.at[-1].set(state.p[-2] + 0.05),
                           q=state.q.at[-1].set(state.q[-2]))
    return (state, data, params), tuple(to_t(x) for x in (state, data, params))


def test_window_has_live_lines(window):
    (_, jd, _), _ = window
    n_obs = np.asarray(jd.ln_mask).sum(1)
    active = np.asarray(jd.ln_solved) & (n_obs >= KW["line_min_obs"])
    assert active.sum() >= 4 and np.asarray(jd.ln_vp_mask).any()


def test_window_residuals_with_lines_match_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    jw = jwin.ResidualWeights(use_vps=False, use_relo=False)
    jr, jr_marg = jax.jit(lambda s, d: [jwin.window_residuals(
        (s, d.pt_inv_depth, d.ln_orth), d, JCFG, jp, w) for w in (jwin.ResidualWeights(), jw)])(
        js, jd)
    tr = twin.window_residuals((ts, td.pt_inv_depth, td.ln_orth), td, TCFG, tp)
    close(jr, tr, atol=1e-9)
    sl = jlm.WindowLayout(nd=JCFG.nd, nf=JCFG.nf, P=JCFG.max_points, L=L).slices()
    assert np.abs(np.asarray(jr)[sl["lines"]]).max() > 1e-2
    assert np.abs(np.asarray(jr)[sl["vps"]]).max() > 1e-4
    # the marginalization stack: no VP, no relo rows
    close(jr_marg, twin.window_residuals((ts, td.pt_inv_depth, td.ln_orth), td, TCFG, tp,
                                use_relo=False, use_vps=False), atol=1e-9)


def test_linearize_assemble_and_schur_with_lines_match_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    lay_j = jlm.WindowLayout(nd=JCFG.nd, nf=JCFG.nf, P=JCFG.max_points, L=L)
    jlin = jax.jit(lambda s, d: jlm._structured_linearize(
        lambda x: jwin.window_residuals(x, d, JCFG, jp),
        lambda x, dd: jwin.retract_all(x, dd, JCFG), (s, d.pt_inv_depth, d.ln_orth), lay_j))(
        js, jd)
    lay_t = twin.layout_for(TCFG, use_lines=True)
    tlin = tlm._structured_linearize(
        lambda x: twin.window_residuals(x, td, TCFG, tp),
        lambda x, d: twin.retract_all(x, d, TCFG), (ts, td.pt_inv_depth, td.ln_orth), lay_t)
    assert len(tlin) == 4
    for a, b in zip(jlin, tlin):
        close(a, b, atol=1e-7, rtol=1e-9)
    jb = jlm._assemble_blocks(*jlin, lay_j)
    tb = tlm._assemble_blocks(*tlin[:3], lay_t, tlin[3])
    assert len(tb) == 8
    for a, b in zip(jb, tb):
        close(a, b, atol=1e-5, rtol=1e-9)
    assert np.abs(tb[5].numpy()).max() > 0  # H_dl: lines couple to the poses
    assert np.abs(tb[6].numpy()).max() > 0  # the 4x4 line blocks
    for lam in (1e-4, 10.0):
        jdelta = jlm.schur_solve_blocks(*jb, lam)
        tdelta = tlm.schur_solve_blocks(*tb[:5], lam, 1e-8, *tb[5:])
        close(jdelta, tdelta, atol=1e-9, rtol=1e-7)


def test_solve_window_with_lines_matches_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    js2, jd2, jout = jax.jit(lambda s, d: jwin.solve_window(s, d, JCFG, jp, num_iters=4))(js, jd)
    ts2, td2, tout = twin.solve_window(ts, td, TCFG, tp, num_iters=4, use_lines=True)
    close_tree(js2, ts2, atol=1e-9)
    close(jd2.pt_inv_depth, td2.pt_inv_depth, atol=1e-9)
    close(jd2.ln_orth, td2.ln_orth, atol=1e-8)
    # the line rows whiten by 1500: their squares sum at 1e-8 relative
    close(jout.cost, tout.cost, atol=0.0, rtol=1e-8)
    assert float(tout.cost) < float(tout.cost0)


def test_triangulate_settle_and_cull_lines_match_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    # unsolve the lines so triangulation runs on every live one
    jd0 = jd._replace(ln_solved=jnp.zeros_like(jd.ln_solved))
    td0 = to_t(jd0)
    jd1 = jax.jit(lambda s, d: jwin.triangulate_lines(s, d, JCFG))(js, jd0)
    td1 = twin.triangulate_lines(ts, td0, TCFG)
    assert np.array_equal(np.asarray(jd1.ln_solved), td1.ln_solved.numpy())
    assert int(td1.ln_solved.sum()) >= 4
    close(jd1.ln_orth, td1.ln_orth, atol=1e-9)
    jd2 = jax.jit(lambda s, d: jwin.settle_lines(s, d, JCFG))(js, jd)
    td2 = twin.settle_lines(ts, td, TCFG)
    close(jd2.ln_orth, td2.ln_orth, atol=1e-8)
    assert float((td2.ln_orth - td.ln_orth).abs().max()) > 1e-5
    close(jax.jit(lambda s, d: jwin._line_endpoint_gates(s, d, JCFG))(js, jd),
          twin._line_endpoint_gates(ts, td, TCFG), atol=0)
    # a corrupted line fails the residual gate in both
    bad = jd._replace(ln_orth=jd.ln_orth.at[int(np.argmax(np.asarray(jd.ln_solved)))].add(0.3))
    for cull_points in (False, True):
        jd3 = jax.jit(lambda s, d: jwin.reject_outliers(s, d, JCFG, cull_points=cull_points))(
            js, bad)
        td3 = twin.reject_outliers(ts, to_t(bad), TCFG, cull_points=cull_points, use_lines=True)
        for f in ("ln_id", "ln_solved", "ln_mask", "pt_id", "pt_solved"):
            assert np.array_equal(np.asarray(getattr(jd3, f)), getattr(td3, f).numpy()), f
        assert int(td3.ln_solved.sum()) < int(td.ln_solved.sum())


@pytest.mark.parametrize("n_points", [0, 5])
def test_marginalize_window_with_lines_matches_jax(n_points):
    rng = np.random.default_rng(10 + n_points)
    nd, R, nl = 27, 120, 3
    J = rng.standard_normal((R, nd + n_points + 4 * nl)) * rng.uniform(
        0.1, 10, nd + n_points + 4 * nl)
    J[:, nd - 3] = 0.0  # an inactive column
    J[:, nd + n_points + 4:nd + n_points + 8] = 0.0  # an unobserved line
    r = rng.standard_normal(R)
    jJ, jr = jmarg.marginalize_window(jnp.asarray(J), jnp.asarray(r), nd, 6, 9,
                                      n_points=n_points, n_lines=nl)
    tJ, tr = tmarg.marginalize_window(torch.as_tensor(J), torch.as_tensor(r), nd, 6, 9,
                                      n_points=n_points, n_lines=nl)
    close_prior(jmarg.Prior(jJ, jr, jnp.asarray(True)), tmarg.Prior(tJ, tr, torch.tensor(True)),
                rtol=1e-9)


def test_marginalize_old_and_slide_with_lines_match_jax(window):
    """With marg_lines (reference parity) the frame-0 lines' factors enter
    the prior and the absorbed lines retire; the live-only default is held
    by the slice test."""
    (js, jd, jp), (ts, td, tp) = window
    jcfg = JCFG._replace(marg_lines=True, retire_lines=True)
    tcfg = TCFG._replace(marg_lines=True, retire_lines=True)
    jpr = jax.jit(lambda s, d: jslide.marginalize_old(s, d, jcfg, jp))(js, jd)
    tpr = tslide.marginalize_old(ts, td, tcfg, tp, use_lines=True)
    close_prior(jpr, tpr, rtol=5e-6)
    js2, jd2 = jax.jit(lambda s, d, p: jslide.slide_window_old(s, d, jcfg, jp, p))(js, jd, jpr)
    ts2, td2 = tslide.slide_window_old(ts, td, tcfg, tp, to_t(jpr))
    close_tree(js2, ts2, atol=0.0)
    close_tree(jd2, convert.from_torch(td2), atol=1e-12)
    assert int((td2.ln_id >= 0).sum()) < int((td.ln_id >= 0).sum())  # absorbed lines retire


def test_slide_window_new_with_lines_matches_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    js2, jd2 = jax.jit(lambda s, d: jslide.slide_window_new(s, d, JCFG, jp))(js, jd)
    ts2, td2 = tslide.slide_window_new(ts, td, TCFG, tp)
    close_tree(js2, ts2, atol=0.0)
    close_tree(jd2, convert.from_torch(td2), atol=1e-12, rtol=1e-12, skip=("prior",))
    close_prior(jd2.prior, td2.prior, rtol=1e-8)
