"""The PnP refinement (K21's plain twin ``pnp_refine_plain``, which the
wrapper runs on CPU tensors) against the JAX reference's ``pnp_refine`` at
x64, one problem at a time, on the cases of
``utils/synthetic.pnp_refine_cases``: a start at the truth (w stays in
so3_exp's small-angle branch), starts 2, 10 and 30 degrees off, three
unmasked points, an all-masked padded problem (non-finite in both), 1 to
128 points, a shared and a per-problem point set.

R and t are held within 1e-12 (torch's and JAX's LAPACK solves of the 6x6
systems, ~1e-15 apart), except at one point: there J^T J has rank 2, and
the null-space components of each step are rounding divided by the 1e-8
damping, ~4e-10 apart between the two packages, so that case is held to
1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import mvg as jmvg
from vplines_slam_tpu_torch.ops import mvg as tmvg
from vplines_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CASES = tsyn.pnp_refine_cases()
TOL = {"N 1": 1e-9}
_jax_refine = jax.jit(jmvg.pnp_refine)


def jax_refine(R0, t0, X, x, m):
    out = [_jax_refine(*(jnp.asarray(a) for a in (R0[b], t0[b], X if X.ndim == 2 else X[b],
                                                  x[b], m[b])))
           for b in range(R0.shape[0])]
    return np.stack([np.asarray(r) for r, _ in out]), np.stack([np.asarray(t) for _, t in out])


def port_refine(R0, t0, X, x, m):
    R, t = tmvg.pnp_refine(*(torch.from_numpy(np.asarray(a)) for a in (R0, t0, X, x, m)))
    return R.numpy(), t.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_pnp_refine_case_matches_jax(name):
    R0, t0, X, x, m = CASES[name]
    jR, jt = jax_refine(R0, t0, X, x, m)
    tR, tt = port_refine(R0, t0, X, x, m)
    B = R0.shape[0]
    assert tR.shape == (B, 3, 3) and tt.shape == (B, 3)
    np.testing.assert_array_equal(np.isfinite(tR), np.isfinite(jR))
    np.testing.assert_array_equal(np.isfinite(tt), np.isfinite(jt))
    tol = TOL.get(name, 1e-12)
    np.testing.assert_allclose(tR, jR, atol=tol, rtol=0)
    np.testing.assert_allclose(tt, jt, atol=tol, rtol=0)


def test_pnp_refine_cases_premises():
    """The all-masked padded problem is non-finite; every other case is
    finite, the start at the truth stays there (so |w| stays far below
    so3_exp's 1e-6 branch point), and the other starts move."""
    for name, (R0, t0, X, x, m) in CASES.items():
        tR, tt = port_refine(R0, t0, X, x, m)
        if name == "all masked":
            assert not np.isfinite(tR).any() and not np.isfinite(tt).any()
            continue
        assert np.isfinite(tR).all() and np.isfinite(tt).all(), name
        moved = np.abs(tR - R0).max()
        if name == "at the truth":
            assert moved < 1e-12 and np.abs(tt - t0).max() < 1e-12
        else:
            assert moved > 1e-3, name
    assert CASES["3 unmasked"][4].sum() == 3
    assert CASES["shared X 11 x 128"][2].shape == (128, 3)
    assert CASES["per-problem X 4 x 100"][2].shape == (4, 100, 3)
