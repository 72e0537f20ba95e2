"""The attention feature selector against the JAX reference (torch f64 on the
CPU, K20's plain twins, against JAX x64): the horizon propagation, the IMU
prior information, each candidate's information, the nearest-neighbour
depth guess and the greedy log-det selection, then the port's own versions
of the reference's property checks (informative features preferred, the
greedy pick against brute force).

Inputs come from numpy seeds and the figure-8 truth.  Log-determinant gains
are held at GAIN_ATOL: two LU factorizations of the same 45x45 matrices
(LAPACK's blocked one in JAX, the twin's unblocked one) each round a
log|det| of about 4e2 by up to ~eps * cond, and the prior's condition
number is ~7.6e7 on the frame problem (1.9e7 on the small ones), so
eps * cond ~ 1.7e-8.  The gains here differ by up to 1.1e-8 on the frame
problem and 1.6e-9 on the small ones; the selected sets are identical.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.models import selector as jsel
from vplines_slam_tpu.utils import synthetic as jsyn
from vplines_slam_tpu_torch.models import selector as tsel

torch.set_num_threads(1)

GAIN_ATOL = 5e-8
IDENT = np.array([1.0, 0.0, 0.0, 0.0])


def T(a):
    return torch.as_tensor(np.array(a))


def rel(jax_out, torch_out):
    j, t = np.asarray(jax_out), np.asarray(torch_out)
    return np.abs(j - t).max() / max(np.abs(j).max(), 1e-300)


def horizon(t0, dt=0.1):
    """The figure-8 truth at t0 propagated by its IMU sample at t0, both
    packages on the same numbers.  Returns (jax (ps, qs, vs), torch ...)."""
    traj = jsyn.figure8_trajectory()
    p0, q0 = traj.pos(t0), traj.quat(t0)
    v0 = jsyn.world_velocity(traj, t0)
    accs, gyrs = jsyn.imu_samples(traj, jnp.asarray([t0]))
    rng = np.random.default_rng(int(10 * t0))
    ba, bg = rng.normal(0, 0.02, 3), rng.normal(0, 0.002, 3)
    g = np.array([0.0, 0.0, jsyn.GRAVITY])
    args = [np.asarray(a) for a in (p0, q0, v0, ba, bg, accs[0], gyrs[0])]
    j = jsel.propagate_horizon(*(jnp.asarray(a) for a in args), dt, jnp.asarray(g))
    t = tsel.propagate_horizon(*(T(a) for a in args), dt, T(g))
    return j, t


@pytest.mark.parametrize("t0,dt", [(1.0, 0.1), (2.7, 0.1), (4.3, 0.05)])
def test_propagate_horizon_and_prior_match_jax(t0, dt):
    (jps, jqs, jvs), (tps, tqs, tvs) = horizon(t0, dt)
    for j, t in ((jps, tps), (jqs, tqs), (jvs, tvs)):
        assert rel(j, t) < 1e-12
    jO = jsel.imu_prior_information(jqs, dt, 0.01)
    tO = tsel.imu_prior_information(T(jqs), dt, 0.01)
    assert tO.shape == (45, 45)
    assert rel(jO, tO) < 1e-12
    # another noise level and fewer IMU samples a step
    jO = jsel.imu_prior_information(jqs, dt, 0.04, acc_bias_var=1e-3, n_imu=10)
    tO = tsel.imu_prior_information(T(jqs), dt, 0.04, acc_bias_var=1e-3, n_imu=10)
    assert rel(jO, tO) < 1e-12


def candidates(N, seed):
    """N unit bearings (some far outside the field of view), depths and a
    track_valid mask."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.8, 0.8, (N, 2))
    xy[: N // 10] = rng.uniform(2.0, 5.0, (N // 10, 2))  # leave the FOV at once
    rays = np.concatenate([xy, np.ones((N, 1))], 1)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    depths = rng.uniform(1.5, 8.0, N)
    depths[N // 10: N // 5] = rng.uniform(0.05, 0.2, N // 10)  # behind the 0.2 m gate
    valid = rng.uniform(size=N) < 0.8
    return rays, depths, valid


EXTRINSICS = {
    "euroc_like": (np.array([0.5, -0.5, 0.5, -0.5]), np.array([0.05, 0.02, 0.03])),
    "identity": (IDENT, np.zeros(3)),
}


@pytest.mark.parametrize("extr", sorted(EXTRINSICS))
def test_feature_information_matches_jax(extr):
    """[150, 45, 45] at 1e-10 of each candidate's largest entry, with
    out-of-FOV candidates, candidates seen by fewer than 2 states and
    track_valid false among them (their blocks are zero in both)."""
    q_ic, p_ic = EXTRINSICS[extr]
    (jps, jqs, _), _ = horizon(1.0)
    rays, depths, valid = candidates(150, seed=3)
    jF = np.asarray(jsel.feature_information(
        jnp.asarray(rays), jnp.asarray(depths), jnp.asarray(valid), jps, jqs,
        jnp.asarray(q_ic), jnp.asarray(p_ic)))
    tF = tsel.feature_information(T(rays), T(depths), T(valid), T(jps), T(jqs), T(q_ic),
                                  T(p_ic)).numpy()
    assert tF.shape == (150, 45, 45)
    scale = np.maximum(np.abs(jF).max(axis=(1, 2)), 1e-300)
    assert np.all(np.abs(jF - tF).max(axis=(1, 2)) <= 1e-10 * scale)
    zero = np.abs(jF).max(axis=(1, 2)) == 0
    assert np.array_equal(zero, np.abs(tF).max(axis=(1, 2)) == 0)
    assert zero[~valid].all() and zero[:15].all() and not zero.all()


def test_nn_depth_guess_matches_jax():
    rng = np.random.default_rng(5)
    rays, _, _ = candidates(150, seed=5)
    k = rng.normal(size=(128, 3)) + np.array([0.0, 0.0, 3.0])
    k_rays = k / np.linalg.norm(k, axis=1, keepdims=True)
    k_depths = rng.uniform(1.0, 9.0, 128)
    for k_ok in (rng.uniform(size=128) < 0.4, np.zeros(128, bool)):
        j = jsel.nn_depth_guess(jnp.asarray(rays), jnp.asarray(k_rays), jnp.asarray(k_depths),
                                jnp.asarray(k_ok))
        t = tsel.nn_depth_guess(T(rays), T(k_rays), T(k_depths), T(k_ok))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert np.all(t.numpy() == 5.0)  # no known landmark: the default


def forward_horizon(step=(0.0, 0.0, 0.1)):
    h = jsel.HORIZON
    ps = np.stack([np.asarray(step) * k for k in range(h + 1)])
    return ps, np.stack([IDENT] * (h + 1))


def problem_informative():
    """tests/test_calibration_selector.py:64's problem: 5 bearings dead
    ahead, 5 far outside the field of view, budget 4."""
    ps, qs = forward_horizon()
    rays = [[0.05 * k - 0.1, 0.02 * k - 0.04, 1.0] for k in range(5)]
    rays += [[3.5 + k, 2.0, 1.0] for k in range(5)]
    rays = np.asarray(rays)
    rays = rays / rays[:, 2:3]
    return dict(ps=ps, qs=qs, rays=rays, depths=np.full(10, 4.0), valid=np.ones(10, bool),
                dt=0.1, acc_var=0.04, budget=4, cfg=dict())


def problem_structure():
    """tests/test_calibration_selector.py:115's horizon and two bearings."""
    ps, qs = forward_horizon((0.2, 0.05, 0.0))
    return dict(ps=ps, qs=qs, rays=np.array([[0.1, -0.05, 1.0], [5.0, 5.0, 1.0]]),
                depths=np.array([4.0, 4.0]), valid=np.ones(2, bool), dt=0.1, acc_var=0.04,
                budget=2, cfg=dict(max_features=2))


def problem_bruteforce():
    """tests/test_calibration_selector.py:148's problem: 8 candidates,
    budget 3."""
    rng = np.random.default_rng(7)
    ps, qs = forward_horizon((0.15, 0.0, 0.02))
    N = 8
    rays = np.concatenate([rng.uniform(-0.5, 0.5, (N, 2)), np.ones((N, 1))], axis=1)
    return dict(ps=ps, qs=qs, rays=rays, depths=rng.uniform(2.0, 8.0, N),
                valid=np.ones(N, bool), dt=0.1, acc_var=0.04, budget=3,
                cfg=dict(max_features=3))


def problem_frame(budget):
    """A frame's worth: 150 candidates over the figure-8 horizon at t = 1 s,
    the prior at SelectorConfig's defaults, max_features 30."""
    (jps, jqs, _), _ = horizon(1.0)
    rays, depths, valid = candidates(150, seed=11)
    return dict(ps=np.asarray(jps), qs=np.asarray(jqs), rays=rays, depths=depths, valid=valid,
                dt=0.1, acc_var=0.01, budget=budget, cfg=dict(max_features=30))


PROBLEMS = {
    "informative": problem_informative,
    "structure": problem_structure,
    "bruteforce": problem_bruteforce,
    "frame_budget0": lambda: problem_frame(0),
    "frame_budget7": lambda: problem_frame(7),
    "frame_budget30": lambda: problem_frame(30),
}


def run_both(P, ident_extr=True):
    q_ic, p_ic = (IDENT, np.zeros(3)) if ident_extr else EXTRINSICS["euroc_like"]
    jF = jsel.feature_information(jnp.asarray(P["rays"]), jnp.asarray(P["depths"]),
                                  jnp.asarray(P["valid"]), jnp.asarray(P["ps"]),
                                  jnp.asarray(P["qs"]), jnp.asarray(q_ic), jnp.asarray(p_ic))
    jO = jsel.imu_prior_information(jnp.asarray(P["qs"]), P["dt"], P["acc_var"])
    jcfg, tcfg = jsel.SelectorConfig(**P["cfg"]), tsel.SelectorConfig(**P["cfg"])
    js, jg = jsel.select_features(jO, jF, jnp.asarray(P["valid"]), P["budget"], jcfg)
    # the port selects on the reference's matrices: the same inputs
    ts, tg = tsel.select_features(T(jO), T(jF), T(P["valid"]), torch.tensor(P["budget"]), tcfg)
    return (np.asarray(js), np.asarray(jg)), (ts.numpy(), tg.numpy()), (jO, jF)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_select_features_matches_jax(name):
    (js, jg), (ts, tg), _ = run_both(PROBLEMS[name]())
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tg, jg, atol=GAIN_ATOL, rtol=0)


def test_selector_prefers_informative_features():
    """The port's version of the reference's check: 4 of the 5 visible
    features picked, none of the out-of-FOV ones, positive gains."""
    P = problem_informative()
    _, (chosen, gains), _ = run_both(P)
    assert int(chosen.sum()) == 4
    assert not chosen[5:].any(), "out-of-FOV features selected"
    assert gains[:5].min() > 0
    assert np.all(gains[5:] == 0.0)


def test_selector_greedy_overlaps_bruteforce():
    """The port's greedy pick against brute-force enumeration of every
    3-subset: >= 2 of 3 in common, >= 95% of the optimal log-det gain."""
    P = problem_bruteforce()
    _, (chosen, _), (jO, jF) = run_both(P)
    O0, Of = T(jO), T(jF)
    logdet = lambda M: float(tsel.logdet_plain((M + 1e-9 * torch.eye(45))[None])[0])
    greedy = frozenset(np.flatnonzero(chosen).tolist())
    best_set, best_ld = None, -np.inf
    for combo in itertools.combinations(range(8), 3):
        ld = logdet(O0 + sum(Of[i] for i in combo))
        if ld > best_ld:
            best_ld, best_set = ld, frozenset(combo)
    base = logdet(O0)
    assert len(greedy & best_set) >= 2, (greedy, best_set)
    assert logdet(O0 + sum(Of[i] for i in greedy)) - base >= 0.95 * (best_ld - base)


def test_logdet_plain_matches_slogdet():
    """The twin's LU against torch.linalg.slogdet on random SPD matrices
    and on a singular one (-inf)."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(6, 45, 45))
    M = T(A @ np.transpose(A, (0, 2, 1)) + 0.1 * np.eye(45))
    np.testing.assert_allclose(tsel.logdet_plain(M).numpy(),
                               torch.linalg.slogdet(M)[1].numpy(), rtol=1e-12)
    S = torch.zeros(1, 45, 45, dtype=torch.float64)
    S[0, :44, :44] = M[0, :44, :44]
    assert float(tsel.logdet_plain(S)[0]) == -np.inf


def test_selector_in_f32_is_noise():
    """Why the port runs the selector in f64 whatever the engine dtype: at
    f32 the frame problem's gains lose the sign they have at f64, in the
    reference's formulation (the difference of two 45x45 log-dets: the
    dense support) and in the main path's Schur form on the position
    support alike (its 12x12 log-dets still differ by gains ~100x below
    their size)."""
    P = problem_frame(30)
    (_, jg), _, (jO, jF) = run_both(P)
    valid = T(P["valid"])
    live = P["valid"] & (np.asarray(jg) > 0)
    for obs_frame in (None, 1):
        g32 = tsel.select_features(T(jO).float(), T(jF).float(), valid, torch.tensor(30),
                                   tsel.SelectorConfig(max_features=30),
                                   obs_frame=obs_frame)[1].numpy()
        assert (np.abs(g32[live] - np.asarray(jg)[live]).max()
                > 0.1 * np.asarray(jg)[live].max())


def test_selector_config_matches_jax():
    assert tuple(tsel.SelectorConfig()) == tuple(jsel.SelectorConfig())
    assert (tsel.HORIZON, tsel.STATE_SIZE, tsel.DIM) == (jsel.HORIZON, jsel.STATE_SIZE, jsel.DIM)
