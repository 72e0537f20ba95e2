"""The Hamming match (K17's plain twin ``match_descriptors_plain``, which
the wrapper runs on CPU tensors) against the JAX reference's
``match_descriptors`` on the cases of ``utils/synthetic.match_cases``, in
the verification's gate setting (margin 16, mutual) and the default one
(neither).  Every output is an integer, so index and distance are held
exactly; the designed cases' tie, margin and distance rules are pinned."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import brief as jbrief
from vplines_slam_tpu_torch.ops import brief as tbrief
from vplines_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CASES = tsyn.match_cases()
GATES = [(16, True), (0, False)]


def both(name, margin, mutual):
    da, va, db, vb = CASES[name]
    ji, jd = jbrief.match_descriptors(jnp.asarray(da.view(np.uint32)), jnp.asarray(va),
                                      jnp.asarray(db.view(np.uint32)), jnp.asarray(vb), 80,
                                      margin, mutual)
    ti, td = tbrief.match_descriptors(*(torch.from_numpy(a) for a in (da, va, db, vb)), 80,
                                      margin, mutual)
    return (np.asarray(ji), np.asarray(jd)), (ti, td)


@pytest.mark.parametrize("margin,mutual", GATES)
@pytest.mark.parametrize("name", list(CASES))
def test_match_case_equals_jax(name, margin, mutual):
    (ji, jd), (ti, td) = both(name, margin, mutual)
    N = CASES[name][0].shape[0]
    assert ti.dtype == torch.int64 and td.dtype == torch.int32 and ti.shape == td.shape == (N,)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)


def test_match_ties_take_the_lower_index():
    """Rows 0-7 see their best at two equal columns: the lower wins, and its
    second equals its best, so the margin drops it.  Rows 8-9 and 10-11 are
    equal rows: the column's best row is the lower one, so the mutual check
    keeps only it.  Row 12's second column sits at its best's value."""
    (_, _), (ti, td) = both("ties", 0, False)
    for r in range(8):
        assert int(ti[r]) == 20 * r + 3 and int(td[r]) == 5 + r
    (_, _), (ti, td) = both("ties", 0, True)
    assert int(ti[8]) >= 0 and int(ti[9]) == -1 and int(ti[10]) >= 0 and int(ti[11]) == -1
    (_, _), (ti, td) = both("ties", 16, True)
    assert (ti[:8] == -1).all() and int(ti[12]) == -1 and int(td[12]) == 12


def test_match_margin_and_distance_gates_at_their_edges():
    """A second exactly 16 above the best passes the margin, 15 fails; a best
    of exactly 80 fails the distance gate, 79 passes."""
    (_, _), (ti, td) = both("margin 16 / 15", 16, True)
    assert [int(ti[r]) >= 0 for r in range(4)] == [True, False, True, False]
    assert [int(td[r]) for r in range(4)] == [10, 10, 20, 20]
    (_, _), (ti, td) = both("dist 80 / 79", 16, True)
    assert [int(td[r]) for r in range(4)] == [80, 79, 80, 79]
    assert [int(ti[r]) >= 0 for r in range(4)] == [False, True, False, True]


def test_match_invalid_columns_and_rows():
    """Every column invalid: each row's best is column 0 at 10,000, no match.
    Every row invalid: the distances stand, no match."""
    (_, _), (ti, td) = both("columns invalid", 0, False)
    assert (td == 10_000).all() and (ti == -1).all()
    (ji, jd), (ti, td) = both("rows invalid", 16, True)
    assert (ti == -1).all() and (td < 10_000).all()
