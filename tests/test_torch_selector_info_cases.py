"""The selector's information (K20 ``selector_info``'s plain twin
``feature_information_plain``, which the wrapper runs on CPU tensors)
against the JAX reference's ``feature_information`` at x64 on the cases of
``utils/synthetic.selector_info_cases``.

Each candidate's [n, n] block is held at 1e-10 of its largest entry, and
its zero pattern exactly: every entry off the position blocks is 0 in both,
and each 3x3 position block is all zero in one exactly where it is in the
other (a state that does not see the candidate, a candidate seen by fewer
than 2 states or with track_valid false).  Single entries of a live block
may round to +-1e-17 in one package and to 0 in the other (identity
rotations), so the pattern is held block by block.

Near-singular candidates.  The two packages invert E = sum C + 1e-9 I
differently (LU in JAX, the adjugate in the twin), and the information
C_i - C_i W C_j^T cancels down to the parallax the landmark sees, so
their difference grows with E's condition number kappa: up to ~eps * kappa
of the candidate's largest entry (measured: 0.2-1.0 eps * kappa on these
cases).  Where kappa > 1e5 (a far landmark over a short baseline: the
"nearly parallel" case, and a few far candidates of the nh 2 horizons) a
candidate is held at 4 eps kappa instead (1e-10 or more); every other
candidate at 1e-10."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.models import selector as jsel
from vplines_slam_tpu_torch.models import selector as tsel
from vplines_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CASES = tsyn.selector_info_cases()
ARGS = ("rays", "depths", "track_valid", "ps", "qs", "q_ic", "p_ic")
EPS = np.finfo(np.float64).eps
KAPPA_NEAR_SINGULAR = 1e5
# one compile per shape instead of eager dispatch op by op
J_INFO = jax.jit(jsel.feature_information, static_argnames=("obs_frame",))


@functools.lru_cache(maxsize=None)
def both(name):
    c = CASES[name]
    a = [c[k] for k in ARGS]
    jF = np.asarray(J_INFO(*map(jnp.asarray, a), obs_frame=c["obs_frame"]))
    tF = tsel.feature_information(*map(torch.from_numpy, a), obs_frame=c["obs_frame"])
    return jF, tF


def condition(name):
    """kappa of each candidate's E = sum_k C_k + 1e-9 I, from the twin's
    bearing factors (the diagonal position blocks' C_k are not recoverable
    from the output, so they are rebuilt as the twin builds them)."""
    c = CASES[name]
    rays, depths, valid, ps, qs, q_ic, p_ic = (torch.from_numpy(c[k]) for k in ARGS)
    o = c["obs_frame"]
    X_w = tsel._qrot(qs[o], tsel._qrot(q_ic, rays * depths[:, None]) + p_ic) + ps[o]
    q_cw = tsel.quat_conj(tsel.quat_mul(qs, q_ic.expand_as(qs)))
    p_cw = -tsel._qrot(q_cw, tsel._qrot(qs, p_ic.expand_as(ps)) + ps)
    Xc = tsel._qrot(q_cw[None], X_w[:, None, :]) + p_cw[None]
    z = Xc[..., 2]
    k = torch.arange(ps.shape[0])
    vis = ((k >= o) & (z > 0.2) & (torch.abs(Xc[..., 0] / z) < 0.75)
           & (torch.abs(Xc[..., 1] / z) < 0.75))
    u = Xc / torch.clamp(torch.linalg.norm(Xc, dim=-1, keepdim=True), min=1e-9)
    B = tsel._mm3(tsel.skew(u), tsel.quat_to_rot(q_cw)[None])
    C = tsel._mm3(B.transpose(-1, -2), B) * (vis & valid[:, None]).double()[..., None, None]
    return np.linalg.cond((C.sum(1) + 1e-9 * torch.eye(3, dtype=torch.float64)).numpy())


def blocks(F, nh):
    """(position blocks all zero [N, nh, nh], every entry off them zero)."""
    B = F.reshape(F.shape[0], nh, 9, nh, 9)
    off = B.copy()
    off[:, :, :3, :, :3] = 0.0
    return np.abs(B[:, :, :3, :, :3]).max(axis=(2, 4)) == 0, not off.any()


@pytest.mark.parametrize("name", list(CASES))
def test_selector_info_case_matches_jax(name):
    jF, tF = both(name)
    N, nh = CASES[name]["rays"].shape[0], CASES[name]["ps"].shape[0]
    assert tF.dtype == torch.float64 and tF.shape == (N, 9 * nh, 9 * nh)
    tF = tF.numpy()
    scale = np.abs(jF).max(axis=(1, 2))
    kappa = condition(name)
    tol = np.where(kappa > KAPPA_NEAR_SINGULAR, np.maximum(1e-10, 4 * EPS * kappa), 1e-10)
    assert np.all(np.abs(jF - tF).max(axis=(1, 2)) <= tol * scale)
    (jz, joff), (tz, toff) = blocks(jF, nh), blocks(tF, nh)
    assert joff and toff
    np.testing.assert_array_equal(tz, jz)


def test_case_premises():
    """What each designed case is for: who sees what, which blocks vanish."""
    def live(name):
        jF, _ = both(name)
        return np.abs(jF).max(axis=(1, 2)) > 0

    # state 1 alone sees the first landmark (no information), states 1 and 2
    # the second, states 1-4 the third
    assert live("seen by 1 / 2 states").tolist() == [False, True, True]
    assert not live("track_valid false").any()
    assert not live("behind, depth 0").any()
    # z = 0.2 and |x / z| = 0.75 are invisible from the observing state, so
    # those landmarks' state-1 blocks vanish; the ones just inside keep them
    jF, _ = both("visibility edges")
    z1, _ = blocks(jF, 5)
    seen1 = ~z1[:, 1, 1]
    assert seen1.tolist() == [False, False, False, False, False, True, True, True, True]
    # nearly parallel: E is near singular, and every candidate still informs
    assert (condition("nearly parallel") > 1e8).sum() >= 3
    assert live("nearly parallel").all()
    # a fifth of the frame's candidates off the mask, so some vanish
    assert 0 < live("N 150 nh 5 obs 1").sum() < 150
