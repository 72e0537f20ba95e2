"""K7's function on its plain route: the port's ``match_lines`` (through
``line_vote_plain``) against the JAX package's ``match_lines`` on the
handed-in tracks of ``utils/synthetic.line_vote_cases``.

Both packages' ``match_lines`` sample their anchors, call the KLT and vote.
Here each package's KLT is replaced for the test's duration (pytest's
``monkeypatch``) by a function that returns the case's tracked points and ok
flags, so the two votes see the same inputs and everything after the KLT is
compared: ClosestLine, Point2Line, the duplicate targets and the sideness
filter.  The kernel on the card is held to this twin (and to the previous
kernel, to the bit) by ``chip_smoke.py``; what it must keep is what these
tests pin: the lower index wins equal distances and equal votes, the gate
``dist < 4 px`` is strict, the ratio gate ``>= 0.4`` is not, and a lone
match has consistency 0.

Tolerance: none.  Labels and votes are compared exactly at x64, and the
designed cases' coordinates are dyadic, so their outcomes are the same at
f32 (the kernel's type).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import line_match as jlm
from vplines_slam_tpu_torch.ops import line_match as tlm
from vplines_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CASES = synthetic.line_vote_cases(seed=0)
DESIGNED = [n for n in CASES if n not in ("frame", "all targets invalid", "L1 = 32",
                                          "single valid")]


def T(a):
    return torch.as_tensor(np.array(a))


def jax_vote(monkeypatch, case, cfg=jlm.LineMatchConfig()):
    tracked, ok, segs0, valid0, segs1, valid1 = case
    L0, A = ok.shape

    def track(img0, img1, pts, kcfg, affine_inv=None):
        assert pts.shape == (L0 * A, 2)
        return (jnp.asarray(tracked.reshape(L0 * A, 2)), jnp.asarray(ok.reshape(-1)),
                jnp.zeros(L0 * A))

    monkeypatch.setattr(jlm.klt_mod, "track", track)
    img = jnp.zeros((8, 8))
    m, nv = jlm.match_lines(img, img, jnp.asarray(segs0), jnp.asarray(valid0),
                            jnp.asarray(segs1), jnp.asarray(valid1), cfg)
    return np.asarray(m), np.asarray(nv)


def port_vote(monkeypatch, case, dtype=torch.float64, cfg=tlm.LineMatchConfig()):
    tracked, ok, segs0, valid0, segs1, valid1 = case
    L0, A = ok.shape

    def track(img0, img1, pts, kcfg):
        assert tuple(pts.shape) == (L0 * A, 2)
        return (T(tracked).to(dtype).reshape(L0 * A, 2), T(ok).reshape(-1),
                torch.zeros(L0 * A, dtype=dtype))

    monkeypatch.setattr(tlm.klt_mod, "track", track)
    img = torch.zeros(8, 8, dtype=dtype)
    return tlm.match_lines(img, img, T(segs0).to(dtype), T(valid0), T(segs1).to(dtype),
                           T(valid1), cfg)


@pytest.mark.parametrize("name", list(CASES))
def test_vote_case_matches_jax(monkeypatch, name):
    jm, jv = jax_vote(monkeypatch, CASES[name])
    tm, tv = port_vote(monkeypatch, CASES[name])
    assert tm.dtype == torch.int64
    assert np.array_equal(tm.numpy(), jm)
    assert np.array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("name", DESIGNED)
def test_designed_case_is_exact_in_f32(monkeypatch, name):
    m64, v64 = port_vote(monkeypatch, CASES[name])
    m32, v32 = port_vote(monkeypatch, CASES[name], torch.float32)
    assert torch.equal(m32, m64) and torch.equal(v32.double(), v64)


def test_distance_ties_take_the_lower_target(monkeypatch):
    m, nv = port_vote(monkeypatch, CASES["distance ties"])
    # source 0 lies midway between targets 0 and 1; source 1 next to target
    # 1 and its copy, target 2
    assert m[:3].tolist() == [0, 1, 3] and nv[:3].tolist() == [8.0, 8.0, 8.0]


def test_vote_ties_take_the_lower_target_and_source(monkeypatch):
    m, nv = port_vote(monkeypatch, CASES["vote ties"])
    assert nv[:6].tolist() == [4.0, 8.0, 8.0, 6.0, 8.0, 8.0]
    # 4 / 4 split: the lower target; 8 = 8 votes for target 2: the lower
    # source; 6 < 8 for target 3: the source with more votes
    assert m[:6].tolist() == [0, 2, -1, -1, 3, 4]


def test_gate_is_strict_at_max_point_line_dist(monkeypatch):
    m, nv = port_vote(monkeypatch, CASES["gate"])
    assert nv[0] == 0 and m[0] == -1  # every anchor exactly 4 px away
    assert nv[1] == 8 and m[1] == 1  # 3.75 px


def test_vote_ratio_is_inclusive(monkeypatch):
    m, nv = port_vote(monkeypatch, CASES["vote ratio"])
    assert nv[:2].tolist() == [2.0, 2.0]
    assert m[0] == 0 and m[1] == -1  # 2 / 5 = 0.4 accepted, 2 / 6 not


def test_lone_match_and_invalid_targets_give_no_match(monkeypatch):
    m, nv = port_vote(monkeypatch, CASES["single valid"])
    assert int(nv.max()) == 8 and bool((m == -1).all())  # consistency 0 / 1
    m, nv = port_vote(monkeypatch, CASES["all targets invalid"])
    assert bool((m == -1).all()) and bool((nv == 0).all())


def test_collinear_midpoints_keep_sign_zero(monkeypatch):
    m, _ = port_vote(monkeypatch, CASES["collinear midpoints"])
    # sideness 0 against 0 is consistent; the segment lifted off the common
    # line flips its pairs with the two others and is dropped
    assert m[:5].tolist() == [0, 1, -1, 3, 4]


def test_line_vote_takes_the_plain_route_on_the_cpu():
    tracked, ok, segs0, valid0, segs1, valid1 = (T(x) for x in CASES["frame"])
    cfg = tlm.LineMatchConfig()
    got = tlm.line_vote(tracked, ok, segs0, valid0, segs1, valid1, cfg)
    want = tlm.line_vote_plain(tracked, ok, segs0, valid0, segs1, valid1, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
