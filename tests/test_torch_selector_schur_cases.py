"""The cases the redesigned K20 greedy pass and K14 stage 1 must reproduce,
pinned on the CPU against the JAX reference at x64.

K20 (``csrc/selector.cu`` ``selector_greedy``) selects in the Schur form of
the position support: every candidate's information is zero off the
position rows and columns S of the states that can see it (k >= obs_frame =
1: 12 of the 45), so with Omega' = Omega + 1e-9 I, det(Omega' + F_i) =
det(Omega'_NN) det(Sigma + F_i,SS), Sigma the Schur complement of the other
33, and each round factors 12x12 matrices.  Its twin
``select_features_plain(..., obs_frame=1)`` (the support
``position_support(1)``) is held against
``jsel.select_features`` (LAPACK's 45x45 ``slogdet``): the selected sets
exactly, the gains at GAIN_ATOL = 5e-8, the bar of
``test_torch_selector.py``.  Each log-determinant of ~4e2 is rounded by up
to ~eps * cond(Omega') ~ 1.7e-8 at the frame problem's condition number
(~7.6e7), by each formulation in its own way, so the port's supports (12,
all 5 states' 15, the dense 45) also differ at that level (measured up to
1.1e-8 on the frame, 7e-10 to 1.9e-9 on the small problems) and are held
to the same bar; an extended-precision (``np.longdouble``) evaluation of
the first round's gains shows which is nearer the exact value.

K14 (``csrc/marg.cu``) is stage 1 of ``marginalize_window_blocks``; its twin
``marg_stage1_plain`` feeds stages 2-3 there.  Seeded Jacobians at the
window's size (nd 177, P 128, L 32: a diagonal prior on the dense block, 4
rows a point, 6 a line) go through the reference's ``marginalize_window``
(the dense J) and the port's blocks route; the priors agree through J^T J
and J^T r at 1e-10 of each one's largest entry (the kept block is well
conditioned here, so the eigenvectors of stages 2-3 are stable).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.models import selector as jsel
from vplines_slam_tpu.solver import marginalization as jmarg
from vplines_slam_tpu_torch.models import selector as tsel
from vplines_slam_tpu_torch.solver import marginalization as tmarg
from test_torch_selector import (GAIN_ATOL, PROBLEMS, T, candidates, horizon,
                                 problem_frame)

torch.set_num_threads(1)

SUPPORT = tsel.position_support()  # the main path's: obs_frame 1


@functools.lru_cache(maxsize=None)
def _frame():
    return problem_frame(30)


def frame(budget=30, max_features=30, seed=11, mask=None, **cand):
    """problem_frame's horizon and prior with other candidates or budgets."""
    P = dict(_frame(), budget=budget)
    if seed != 11 or cand:
        P["rays"], P["depths"], P["valid"] = candidates(150, seed=seed)
        for k, v in cand.items():
            P[k] = v(P[k])
    if mask is not None:
        P["valid"] = P["valid"] & mask
    P["cfg"] = dict(max_features=max_features)
    return P


def behind(depths):
    """Every depth under the 0.2 m gate but the first 8: most candidates are
    seen by no state, so their information is zero."""
    d = depths.copy()
    d[8:] = 0.1
    return d


def nothing_seen(depths):
    return np.full_like(depths, 0.1)


CASES = {
    **{f"frame_b{b}_m{m}": (lambda b=b, m=m: frame(b, m))
       for b, m in itertools.product((0, 7, 30), (30, 60))},
    "informative": PROBLEMS["informative"],
    "structure": PROBLEMS["structure"],
    "bruteforce": PROBLEMS["bruteforce"],
    "off_the_mask": lambda: frame(
        mask=np.random.default_rng(4).uniform(size=150) < 0.5),
    "seen_by_fewer_than_2": lambda: frame(seed=12, depths=behind),
    "every_gain_le_0": lambda: frame(seed=13, depths=nothing_seen),
}


_INFO = jax.jit(jsel.feature_information)
_PRIOR = jax.jit(jsel.imu_prior_information, static_argnums=(1, 2))
_SELECT = jax.jit(jsel.select_features, static_argnums=4)


def jax_inputs(P):
    q_ic, p_ic = np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3)
    jF = _INFO(jnp.asarray(P["rays"]), jnp.asarray(P["depths"]), jnp.asarray(P["valid"]),
               jnp.asarray(P["ps"]), jnp.asarray(P["qs"]), jnp.asarray(q_ic), jnp.asarray(p_ic))
    return _PRIOR(jnp.asarray(P["qs"]), P["dt"], P["acc_var"]), jF


@pytest.fixture(scope="module")
def solved():
    """Every case through JAX once: (P, jO, jF, JAX's selected, JAX's gains)."""
    out = {}
    for name, make in CASES.items():
        P = make()
        jO, jF = jax_inputs(P)
        js, jg = _SELECT(jO, jF, jnp.asarray(P["valid"]), P["budget"],
                         jsel.SelectorConfig(**P["cfg"]))
        out[name] = (P, np.asarray(jO), np.asarray(jF), np.asarray(js), np.asarray(jg))
    return out


def twin(P, jO, jF, obs_frame):
    s, g = tsel.select_features_plain(T(jO), T(jF), T(P["valid"]), torch.tensor(P["budget"]),
                                      tsel.SelectorConfig(**P["cfg"]), obs_frame=obs_frame)
    return s.numpy(), g.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_schur_greedy_matches_jax(solved, name):
    """The main path's support: the selected set exactly, gains at 5e-8."""
    P, jO, jF, js, jg = solved[name]
    ts, tg = twin(P, jO, jF, 1)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tg, jg, atol=GAIN_ATOL, rtol=0)
    assert not ts[~P["valid"]].any()
    if name == "every_gain_le_0":
        assert not js.any() and np.all(jg <= 0)  # the pass ends in round 0
    if name == "seen_by_fewer_than_2":
        zero = np.abs(jF).max(axis=(1, 2)) == 0
        assert zero.sum() >= 140 and not ts[zero].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_position_support_against_the_full_support(solved, name):
    """The 12- and 15-index Schur forms against the dense 45x45 form of the
    same twin (obs_frame None: Sigma = Omega'): the same sets, the gains
    within the LUs' rounding (GAIN_ATOL)."""
    P, jO, jF, _, _ = solved[name]
    s45, g45 = twin(P, jO, jF, None)
    for obs_frame in (1, 0):
        s, g = twin(P, jO, jF, obs_frame)
        np.testing.assert_array_equal(s, s45)
        np.testing.assert_allclose(g, g45, atol=GAIN_ATOL, rtol=0)


def _logdet_longdouble(M):
    """log|det| of a batch [B, n, n] by an LU with partial pivoting in
    np.longdouble (x87 extended precision on x86-64: eps ~1.1e-19)."""
    A = M.astype(np.longdouble).copy()
    B, n = A.shape[:2]
    rows = np.arange(B)
    out = np.zeros(B, np.longdouble)
    for k in range(n):
        p = k + np.argmax(np.abs(A[:, k:, k]), axis=1)
        rk, rp = A[rows, k].copy(), A[rows, p].copy()
        A[rows, p], A[rows, k] = rk, rp
        piv = rp[:, k]
        out += np.log(np.abs(piv))
        l = A[:, k + 1:, k] / piv[:, None]
        A[:, k + 1:, k + 1:] -= l[:, :, None] * rp[:, None, k + 1:]
    return out


def test_schur_gains_against_extended_precision(solved):
    """The frame's first-round gains of both supports against the same
    determinants in extended precision: each within the f64 LU's rounding,
    and the Schur form no farther from the exact value than the dense one
    by more than that rounding."""
    P, jO, jF, _, jg = solved["frame_b30_m30"]
    M = jO + 1e-9 * np.eye(45)
    ld = _logdet_longdouble(np.concatenate([M[None], M + jF]))
    exact = np.where(P["valid"], (ld[1:] - ld[0]).astype(np.float64), 0.0)
    e12 = np.abs(twin(P, jO, jF, 1)[1] - exact).max()
    e15 = np.abs(twin(P, jO, jF, 0)[1] - exact).max()
    e45 = np.abs(twin(P, jO, jF, None)[1] - exact).max()
    ej = np.abs(jg - exact).max()
    print(f"first-round gains against extended precision: Schur form 12 {e12:.2e}, 15 "
          f"{e15:.2e}, dense form {e45:.2e}, JAX {ej:.2e}")
    assert max(e12, e15, e45, ej) <= GAIN_ATOL
    assert max(e12, e15) <= e45 + 2e-8


def test_support_is_the_position_blocks():
    """feature_information writes only the rows and columns the support
    names (the position blocks of states obs_frame..4): the kernel reads
    F_SS alone."""
    assert SUPPORT == tuple(9 * k + a for k in range(1, 5) for a in range(3))
    assert tsel.position_support(obs_frame=0) == tuple(9 * k + a for k in range(5)
                                                       for a in range(3))
    assert tsel.greedy_support(45, 1) == SUPPORT and tsel.greedy_support(45) == tuple(range(45))
    (jps, jqs, _), _ = horizon(1.0)
    rays, depths, valid = candidates(150, seed=3)
    F = np.asarray(jsel.feature_information(
        jnp.asarray(rays), jnp.asarray(depths), jnp.asarray(valid), jps, jqs,
        jnp.asarray([1.0, 0.0, 0.0, 0.0]), jnp.zeros(3)))
    off = np.ones(45, bool)
    off[list(SUPPORT)] = False
    assert np.abs(F).max() > 0
    assert not F[:, off, :].any() and not F[:, :, off].any()


def test_support_is_checked():
    """obs_frame must name a state of the information's horizon."""
    O, F = torch.eye(45, dtype=torch.float64), torch.zeros(3, 45, 45, dtype=torch.float64)
    mask, cfg = torch.ones(3, dtype=torch.bool), tsel.SelectorConfig(max_features=2)
    for bad in (-1, 5, 9):
        with pytest.raises(ValueError):
            tsel.select_features_plain(O, F, mask, torch.tensor(2), cfg, obs_frame=bad)
    with pytest.raises(ValueError):
        tsel.greedy_support(44, 1)


# ---- K14 stage 1 -----------------------------------------------------------

ND, NP, NL = 177, 128, 32


def marg_window(seed, n_points=NP, n_lines=NL, gated_point=False, rank_deficient=False,
                zero_column=False):
    """A dense J [R, nd + P + 4 L] with the window's arrow structure (each
    row on at most one landmark) and r [R], numpy f64."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-2, 3, ND)
    rows = [np.concatenate([np.diag(rng.uniform(0.5, 2.0, ND)) * scale,
                            np.zeros((ND, n_points + 4 * n_lines))], 1)]
    for p in range(n_points):
        Jr = np.zeros((4, ND + n_points + 4 * n_lines))
        Jr[:, :ND] = rng.normal(size=(4, ND)) * (rng.random(ND) < 0.1) * scale
        Jr[:, ND + p] = rng.normal(size=4) * 10.0 ** rng.uniform(-1, 2)
        if gated_point and p == 5:
            Jr[:, ND + p] *= 1e-20  # h_p <~1e-35: c_p = 1 and dp under the gate
        rows.append(Jr)
    for l in range(n_lines):
        Jr = np.zeros((6, ND + n_points + 4 * n_lines))
        Jr[:, :ND] = rng.normal(size=(6, ND)) * (rng.random(ND) < 0.1) * scale
        Jl = rng.normal(size=(6, 4))
        if rank_deficient and l == 3:
            Jl[:, 3] = Jl[:, 0] - 2.0 * Jl[:, 1]  # a rank-3 block
        c = ND + n_points + 4 * l
        Jr[:, c:c + 4] = Jl
        rows.append(Jr)
    J = np.concatenate(rows)
    if zero_column:
        J[:, 40] = 0.0  # an inactive dense column: c = 1
    return J, rng.normal(size=J.shape[0])


MARG_CASES = {
    "gated_point": dict(gated_point=True),
    "rank_deficient_line": dict(rank_deficient=True),
    "zero_column": dict(zero_column=True),
    "no_points": dict(n_points=0),
    "no_lines": dict(n_lines=0),
    "prior_only": dict(n_points=0, n_lines=0),
}


@pytest.mark.parametrize("case", sorted(MARG_CASES))
def test_marg_stage1_cases_match_the_reference(case):
    kw = MARG_CASES[case]
    P, L = kw.get("n_points", NP), kw.get("n_lines", NL)
    J, r = marg_window(30 + len(case), **kw)
    jJ, jr = jax.jit(lambda a, b: jmarg.marginalize_window(
        a, b, ND, 6, 15, n_points=P, n_lines=L))(jnp.asarray(J), jnp.asarray(r))
    Jd, Jp, Jl = J[:, :ND], J[:, ND:ND + P], J[:, ND + P:].reshape(len(r), L, 4)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    blocks = dict(H_dp=t(Jd.T @ Jp), h_p=t((Jp * Jp).sum(0)), g_p=t(-(Jp.T @ r))) if P else {}
    if L:
        blocks.update(H_dl=t(np.einsum("rd,rlk->dlk", Jd, Jl)),
                      Hll_b=t(np.einsum("rlk,rlm->lkm", Jl, Jl)),
                      g_l=t(-np.einsum("rlk,r->lk", Jl, r)))
    calls = tmarg.lm_mod.TWIN_CALLS["marg_stage1"]
    tJ, tr = tmarg.marginalize_window_blocks(t(Jd.T @ Jd), t(-(Jd.T @ r)), ND, 6, 15, **blocks)
    assert tmarg.lm_mod.TWIN_CALLS["marg_stage1"] == calls + 1
    jJ, jr = np.asarray(jJ), np.asarray(jr)
    assert not jJ[:, ND:].any()
    H_j, H_t = jJ[:ND, :ND].T @ jJ[:ND, :ND], tJ.numpy().T @ tJ.numpy()
    b_j, b_t = jJ[:ND, :ND].T @ jr[:ND], tJ.numpy().T @ tr.numpy()
    assert np.abs(H_j - H_t).max() <= 1e-10 * np.abs(H_j).max()
    assert np.abs(b_j - b_t).max() <= 1e-10 * np.abs(b_j).max()
    # stage 1 itself: symmetric, and the special columns as the reference has them
    H1, b1, c_d = tmarg.marg_stage1_plain(t(Jd.T @ Jd), t(-(Jd.T @ r)), *(
        blocks.get(k) for k in ("H_dp", "h_p", "g_p", "H_dl", "Hll_b", "g_l")), 1e-12)
    assert torch.allclose(H1, H1.T, rtol=0, atol=1e-12 * float(H1.abs().max()))
    if case == "zero_column":
        assert float(c_d[40]) == 1.0 and not H1[40].any() and float(b1[40]) == 0.0
