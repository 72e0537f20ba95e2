"""The cases K13 (the window's Schur solve, ``csrc/schur.cu``) must reproduce,
pinned on the CPU: the port's ``schur_solve_blocks_plain`` (the twin the
kernel is held against on the card) against the JAX reference's
``schur_solve_blocks`` at x64, and K13's shared-memory planner.

The block normal equations are J^T J of seeded random Jacobians at the
window's size (nd 177 = 15 x 11 frames + 12, 128 point slots, 32 line
slots), with column scales over five decades that the Jacobi scaling takes
out: a points window whose last 40 slots are empty (h_p = 0, so c_p = 1 and
wp = 1 / floor = 1e8 on a zero column of H_dp: 0, not NaN), a lines window
whose first 4x4 line block has two directions 1e-7 apart (near-singular),
both at lambda 0, 1e-4, 10 and 1e4, and an indefinite S (a negative
diagonal entry of H_dd), where both packages give an all-NaN delta.

Tolerance: 1e-12 of the delta's largest entry (measured up to 2.2e-15).
Both sides run the same f64 arithmetic with sums in another order (torch's
and XLA's matmul, Cholesky and 4x4 inverses).  At lambda 0 the
near-singular block is damped by the 1e-8 floor alone, so its scaled
inverse has condition ~4e8 and a reordering may move the delta by up to
~1e-7 of it: 1e-8 there (measured 5.0e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.solver import lm as jlm
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.solver import lm as tlm

torch.set_num_threads(1)

CFG = WindowConfig()
ND, P, L = CFG.nd, CFG.max_points, CFG.max_lines
LAMS = [0.0, 1e-4, 10.0, 1e4]


def window(seed, n_lines, empty=0, near_singular=False):
    """Block normal equations (H_dd, g_d, H_dp, h_p, g_p, H_dl, Hll, g_l)
    as numpy f64: a diagonal prior on the dense block, 4 rows per live
    point and 6 per line over ~10% of the dense columns."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-2, 3, ND)
    J0 = np.diag(rng.uniform(0.5, 2.0, ND)) * scale
    H_dd, g_d = J0.T @ J0, -J0.T @ rng.normal(size=ND)
    H_dp, h_p, g_p = np.zeros((ND, P)), np.zeros(P), np.zeros(P)
    for p in range(P - empty):
        Jd = rng.normal(size=(4, ND)) * (rng.random(ND) < 0.1) * scale
        jp = rng.normal(size=4) * 10.0 ** rng.uniform(-1, 2)
        r = rng.normal(size=4)
        H_dd += Jd.T @ Jd
        g_d -= Jd.T @ r
        H_dp[:, p], h_p[p], g_p[p] = Jd.T @ jp, jp @ jp, -jp @ r
    H_dl, Hll, g_l = np.zeros((ND, n_lines, 4)), np.zeros((n_lines, 4, 4)), np.zeros((n_lines, 4))
    for l in range(n_lines):
        Jd = rng.normal(size=(6, ND)) * (rng.random(ND) < 0.1) * scale
        Jl = rng.normal(size=(6, 4))
        if near_singular and l == 0:
            Jl[:, 3] = Jl[:, 2] + 1e-7 * rng.normal(size=6)
        r = rng.normal(size=6)
        H_dd += Jd.T @ Jd
        g_d -= Jd.T @ r
        H_dl[:, l], Hll[l], g_l[l] = Jd.T @ Jl, Jl.T @ Jl, -Jl.T @ r
    return [H_dd, g_d, H_dp, h_p, g_p, H_dl, Hll, g_l]


_JAX_SOLVE = jax.jit(jlm.schur_solve_blocks)


def solve_both(ne, lam):
    """(JAX delta, port twin delta) as numpy f64."""
    jd = np.asarray(_JAX_SOLVE(*map(jnp.asarray, ne), lam))
    t = [torch.from_numpy(a) for a in ne]
    lines = t[6].shape[0] > 0
    td = tlm.schur_solve_blocks_plain(*t[:5], lam, 1e-8, *(t[5:] if lines else ()))
    return jd, td.numpy()


def assert_close(jd, td, tol=1e-12):
    assert jd.shape == td.shape and np.isfinite(jd).all() and np.isfinite(td).all()
    err = np.abs(td - jd).max() / np.abs(jd).max()
    assert err <= tol, f"max |port - JAX| / max |JAX| = {err:.3e} (tol {tol})"


@pytest.mark.parametrize("lam", LAMS)
def test_points_window_with_empty_slots_matches_jax(lam):
    ne = window(1, 0, empty=40)
    jd, td = solve_both(ne, lam)
    assert_close(jd, td)
    # the empty slots: zero column, wp = 1e8, zero gradient -> a zero step
    assert td.shape == (ND + P,) and (td[ND + P - 40:] == 0.0).all()


@pytest.mark.parametrize("lam", LAMS)
def test_lines_window_with_a_near_singular_line_block_matches_jax(lam):
    ne = window(2, L, near_singular=True)
    assert np.linalg.cond(ne[6][0]) > 1e10
    jd, td = solve_both(ne, lam)
    assert td.shape == (ND + P + 4 * L,)
    assert_close(jd, td, 1e-8 if lam == 0.0 else 1e-12)


@pytest.mark.parametrize("n_lines", [0, L])
def test_indefinite_s_gives_nan_in_both(n_lines):
    ne = window(3, n_lines)
    ne[0][3, 3] = -1.0  # c_d = 1 there, so S's pivot 3 is below -1
    jd, td = solve_both(ne, 1e-4)
    assert np.isnan(jd).all() and np.isnan(td).all()


def test_planner_fits_the_profile_window():
    """nd 177 pads to 192: 78 lower 16x16 tiles, 156 KB of them, within one
    CTA's 227 KB with the rhs, reciprocals and landmark t; the aux scratch
    holds the scales and U^T, V^T [256, 192]."""
    plan = tlm.schur_plan(ND, P, L)
    assert (plan.ndp, plan.tiles, plan.Kp) == (192, 78, 256)
    assert plan.smem == 8 * (78 * 256 + 2 * 192 + 256 + 1) <= tlm.SCHUR_SMEM_LIMIT
    assert plan.aux == 192 + 256 + 2 * P + 20 * L + 2 * 256 * 192
    assert tlm.schur_plan(ND, P, 0).Kp == P
    assert tlm.schur_plan(224, P, L).smem <= tlm.SCHUR_SMEM_LIMIT  # 14 tile rows fit


@pytest.mark.parametrize("nd", [225, 300])
def test_planner_refuses_an_oversized_window_before_any_launch(nd):
    with pytest.raises(ValueError, match=f"limit is {tlm.SCHUR_SMEM_LIMIT} bytes"):
        tlm.schur_plan(nd, P, L)
    # the wrapper plans first: it raises the planner's error before it
    # converts or checks a tensor (these lie on the CPU) and launches nothing
    rng = np.random.default_rng(4)
    t = lambda *s: torch.from_numpy(rng.normal(size=s))
    before = tlm.SCHUR_SOLVE.launches
    with pytest.raises(ValueError, match="shared memory"):
        tlm._schur_cuda(t(nd, nd), t(nd), t(nd, P), t(P), t(P), 1e-4, 1e-8, t(nd, L, 4),
                        t(L, 4, 4), t(L, 4), torch.float64)
    assert tlm.SCHUR_SOLVE.launches == before
