"""``ops/mvg.pnp_refine`` (K21's plain twin on the CPU) against the JAX
reference at x64: the batched entry against JAX one problem at a time and
against a loop of the port's single calls, a start 10 degrees off (so the
rotation increment is not zero from the second Gauss-Newton step on), a
shared and a per-problem point set, and an all-masked problem, whose
non-finite output is the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import mvg as jmvg
from vplines_slam_tpu.utils import geometry as jgeo
from vplines_slam_tpu_torch.ops import mvg as tmvg

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def problems(B, N, deg, seed, shared=True):
    """B poses observing N points at 2-6 m with 1e-3 noise and ~20% of the
    points masked; the start R0 rotated by ~deg degrees about a random axis
    and t0 moved by 5 cm."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(2, 6, N)], 1)
    Xs, R0s, t0s, xs, ms = [], [], [], [], []
    for _ in range(B):
        Xb = X if shared else X + rng.normal(0, 0.1, X.shape)
        R = np.asarray(jgeo.so3_exp_matrix(jnp.asarray(rng.normal(0, 0.2, 3))))
        t = rng.normal(0, 0.3, 3)
        Xc = Xb @ R.T + t
        xs.append(Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 1e-3, (N, 2)))
        axis = rng.normal(size=3)
        dR = np.asarray(jgeo.so3_exp_matrix(jnp.asarray(np.radians(deg) * axis
                                                        / np.linalg.norm(axis))))
        R0s.append(dR @ R)
        t0s.append(t + rng.normal(0, 0.05, 3))
        ms.append(rng.uniform(size=N) < 0.8)
        Xs.append(Xb)
    X_all = X if shared else np.stack(Xs)
    return np.stack(R0s), np.stack(t0s), X_all, np.stack(xs), np.stack(ms)


def jax_refine(R0, t0, X, x, m):
    shared = X.ndim == 2
    out = [jmvg.pnp_refine(jnp.asarray(R0[b]), jnp.asarray(t0[b]),
                           jnp.asarray(X if shared else X[b]), jnp.asarray(x[b]),
                           jnp.asarray(m[b]))
           for b in range(R0.shape[0])]
    return np.stack([np.asarray(r) for r, _ in out]), np.stack([np.asarray(t) for _, t in out])


@pytest.mark.parametrize("shape,shared", [((11, 128), True), ((1, 64), True), ((4, 32), False)])
def test_pnp_refine_batched_matches_jax(shape, shared):
    """The initializer's batch (11 frames x 128 points against one point
    set), a verification's (1 x 64) and per-problem points, 10 degrees off."""
    B, N = shape
    R0, t0, X, x, m = problems(B, N, 10.0, seed=B * N, shared=shared)
    jR, jt = jax_refine(R0, t0, X, x, m)
    tR, tt = tmvg.pnp_refine(T(R0), T(t0), T(X), T(x), T(m))
    assert tR.shape == (B, 3, 3) and tt.shape == (B, 3)
    np.testing.assert_allclose(tR.numpy(), jR, atol=1e-10, rtol=0)
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-10, rtol=0)
    # the refinement moved the 10-degree start onto the observations
    assert np.abs(tR.numpy() - R0).max() > 0.05


def test_pnp_refine_batch_equals_single_calls():
    R0, t0, X, x, m = problems(6, 48, 10.0, seed=3)
    tR, tt = tmvg.pnp_refine(T(R0), T(t0), T(X), T(x), T(m))
    for b in range(6):
        sR, st = tmvg.pnp_refine(T(R0[b]), T(t0[b]), T(X), T(x[b]), T(m[b]))
        assert sR.shape == (3, 3) and st.shape == (3,)
        np.testing.assert_allclose(tR[b].numpy(), sR.numpy(), atol=1e-14, rtol=0)
        np.testing.assert_allclose(tt[b].numpy(), st.numpy(), atol=1e-14, rtol=0)


def test_pnp_refine_all_masked_is_non_finite_as_in_jax():
    """An all-masked problem on padded points (zeros, t0 = 0): the masked
    residuals are 0/0 times 0, NaN in both packages; a masked problem on
    real points keeps its start."""
    R0, t0 = np.eye(3), np.zeros(3)
    X, x, m = np.zeros((8, 3)), np.zeros((8, 2)), np.zeros(8, bool)
    jR, jt = jmvg.pnp_refine(*(jnp.asarray(a) for a in (R0, t0, X, x, m)))
    tR, tt = tmvg.pnp_refine(*(T(a) for a in (R0, t0, X, x, m)))
    np.testing.assert_array_equal(np.isfinite(tR.numpy()), np.isfinite(np.asarray(jR)))
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), np.isfinite(np.asarray(jt)))
    assert not np.isfinite(tR.numpy()).any() and not np.isfinite(tt.numpy()).any()
    R0, t0, X, x, _ = problems(1, 16, 10.0, seed=9)
    jR, jt = jax_refine(R0, t0, X, x, np.zeros((1, 16), bool))
    tR, tt = tmvg.pnp_refine(T(R0), T(t0), T(X), T(x), T(np.zeros((1, 16), bool)))
    np.testing.assert_allclose(tR.numpy(), jR, atol=1e-12)
    np.testing.assert_allclose(tR.numpy(), R0, atol=1e-12)
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-12)
