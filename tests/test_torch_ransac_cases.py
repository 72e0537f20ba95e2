"""The essential-matrix RANSAC (K4's plain twin ``ransac_essential_plain``,
which ``ransac_essential`` runs on CPU tensors) against the JAX reference's
``ransac_essential`` at x64, on the cases of ``utils/synthetic.ransac_cases``,
with the reference's draws replaced by each case's (``jax.random.randint``
swapped while the call traces; the JAX package is not edited); and the
tracker's gate at 11 and 12 valid tracks through both packages'
``feature_tracker.step``.

Hypotheses are compared only where ``utils/synthetic.essential_determined``
accepts them (eight distinct valid rows, an eigengap, a rank-2 projection
that rounding cannot flip): elsewhere the null space has more than one
dimension and each LAPACK build returns a vector of its own.  Both packages
take the smallest eigenvector of A^T A, whose rounding error is ~eps / gap
(gap: the relative gap between its two smallest eigenvalues, down to 5e-10
on these cases), so each E is held to 1e-9 + 10 eps / gap of its largest
entry; counts and inlier flags of determined hypotheses, and the final
inliers and count wherever both winners are determined, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import feature_tracker as jft
from vplines_slam_tpu.ops import klt as jklt
from vplines_slam_tpu.ops import mvg as jmvg
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import feature_tracker as tft
from vplines_slam_tpu_torch.ops import klt as tklt
from vplines_slam_tpu_torch.ops import mvg as tmvg
from vplines_slam_tpu_torch.utils import synthetic as tsyn
from test_torch_models import blob_frames, tracker_key

torch.set_num_threads(1)

CASES = tsyn.ransac_cases()
EPS = np.finfo(np.float64).eps


def T(a):
    return torch.from_numpy(np.array(a))


def rel_gap(x1, x2, sm):
    """The relative gap between the two smallest eigenvalues of each sample
    mask row's A^T A [n]."""
    h1, h2 = np.c_[x1, np.ones(len(x1))], np.c_[x2, np.ones(len(x2))]
    A = (h2[:, :, None] * h1[:, None, :]).reshape(-1, 9) * sm[..., None]
    lam = np.linalg.eigvalsh(np.swapaxes(A, -1, -2) @ A)
    with np.errstate(invalid="ignore"):  # an empty sample: 0 / 0
        return (lam[..., 1] - lam[..., 0]) / lam[..., -1]


def sign_err(a, b):
    """max |a - s b| / max |b| per matrix of [..., 3, 3], s = +-1 the better."""
    s = np.sign(np.sum(a * b, axis=(-1, -2)))[..., None, None]
    return np.abs(a - s * b).max(axis=(-1, -2)) / np.abs(b).max(axis=(-1, -2))


def sampson_np(Es, x1, x2, mask, thr):
    h1, h2 = np.c_[x1, np.ones(len(x1))], np.c_[x2, np.ones(len(x2))]
    Ex1, Etx2 = np.einsum("nj,hij->hni", h1, Es), np.einsum("nj,hji->hni", h2, Es)
    num = np.sum(h2 * Ex1, -1)
    s = num * num / (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
                     + Etx2[..., 1] ** 2 + 1e-18)
    inl = (s < thr * thr) & mask
    return inl.sum(-1), inl


@jax.jit
def _jax_ransac(x1, x2, mask, draws, sm, thr):
    """jmvg.ransac_essential with its ``jax.random.randint`` returning draws
    while it traces, and the E of each sample mask row of sm."""
    randint = jax.random.randint
    jax.random.randint = lambda key, shape, lo, hi: draws
    try:
        E, inl, n = jmvg.ransac_essential(x1, x2, mask, jax.random.PRNGKey(0),
                                          n_hyp=draws.shape[0], threshold=thr)
    finally:
        jax.random.randint = randint
    return E, inl, n, jax.vmap(lambda m: jmvg.eight_point_essential(x1, x2, m))(sm)


def jax_ransac(c):
    """The reference's (E, inl, n) on the case's draws, and its hypotheses
    (Es from ``eight_point_essential`` on each sample mask, their counts and
    inliers)."""
    _, sm = tsyn.essential_samples(T(c["mask"]), T(c["idx"]))
    E, inl, n, Es = _jax_ransac(*(jnp.asarray(a) for a in (
        c["x1"], c["x2"], c["mask"], c["idx"], sm.numpy(), c["threshold"])))
    Es = np.asarray(Es)
    counts, inls = sampson_np(Es, c["x1"], c["x2"], c["mask"], c["threshold"])
    return (np.asarray(E), np.asarray(inl), int(n)), (Es, counts, inls), sm.numpy()


def port_ransac(c, min_valid=None):
    out = tmvg.ransac_essential(T(c["x1"]), T(c["x2"]), T(c["mask"]), T(c["idx"]),
                                threshold=c["threshold"],
                                min_valid=c["min_valid"] if min_valid is None else min_valid,
                                return_hypotheses=True)
    return tuple(o.numpy() for o in out)


@pytest.mark.parametrize("name", [n for n in CASES if not n.endswith("gated")])
def test_ransac_case_matches_jax(name):
    c = CASES[name]
    (jE, jinl, jn), (jEs, jcounts, jinls), sm = jax_ransac(c)
    tE, tinl, tn, tEs, tcounts, tinls, _ = port_ransac(c)
    idx, _ = tsyn.essential_samples(T(c["mask"]), T(c["idx"]))
    _, det = tsyn.essential_determined(T(c["x1"]), T(c["x2"]), T(c["mask"]), idx)
    det = det.numpy()
    gap = rel_gap(c["x1"], c["x2"], sm)
    tol = 1e-9 + 10 * EPS / np.maximum(gap, 1e-300)
    assert np.all(sign_err(tEs[det], jEs[det]) <= tol[det])
    np.testing.assert_array_equal(tcounts[det], jcounts[det])
    np.testing.assert_array_equal(tinls[det], jinls[det])
    # the port's flags are its own E's Sampson test
    counts_np, inls_np = sampson_np(tEs, c["x1"], c["x2"], c["mask"], c["threshold"])
    np.testing.assert_array_equal(tcounts, counts_np)
    np.testing.assert_array_equal(tinls, inls_np)
    for inl, n in ((jinl, jn), (tinl, tn)):
        assert not np.any(inl & ~c["mask"]) and n == inl.sum()
    tb, jb = int(np.argmax(tcounts)), int(np.argmax(jcounts))
    if det[tb] and det[jb]:
        assert tb == jb
        np.testing.assert_array_equal(tinl, jinl)
        assert tn == jn
        refit_gap = rel_gap(c["x1"], c["x2"], tinls[tb][None])[0]
        assert sign_err(tE, jE) <= 1e-9 + 10 * EPS / max(refit_gap, 1e-300)


def test_ransac_cases_premises():
    """What each case is built to show, in the port and in the reference."""
    tsm = {n: tsyn.essential_samples(T(c["mask"]), T(c["idx"])) for n, c in CASES.items()}
    det = {n: tsyn.essential_determined(T(c["x1"]), T(c["x2"]), T(c["mask"]), tsm[n][0])
           for n, c in CASES.items()}
    # repeated draws: the rows with a repeat are never full-rank
    idx = CASES["repeated draws"]["idx"]
    has_repeat = np.array([len(set(r)) < 8 for r in idx])
    assert has_repeat.sum() >= 12 and not np.any(det["repeated draws"][0].numpy() & has_repeat)
    assert not det["fewer than 8 valid"][0].any()
    # exactly 8 valid: every permutation row fits the same E and ties at 8
    _, _, n8, _, counts8, _, _ = port_ransac(CASES["exactly 8 valid"])
    assert n8 == 8 and np.all(counts8[:8] == 8) and det["exactly 8 valid"][1][:8].all()
    # draws on invalid entries: every sample empty
    assert not tsm["draws on invalid entries"][1].any()
    # tie: rows 3 (motion B) and 5 (motion A) tie; the first wins in both
    c = CASES["tie"]
    (_, jinl, _), (_, jcounts, _), _ = jax_ransac(c)
    _, tinl, _, _, tcounts, _, _ = port_ransac(c)
    for counts, inl in ((jcounts, jinl), (tcounts, tinl)):
        assert counts[3] == counts[5] == 20 and counts.max() == 20
        assert np.array_equal(inl, np.arange(40) >= 20)
    # refit loses: better is false, so E is the winner's own
    c = CASES["refit loses"]
    tE, _, tn, tEs, tcounts, tinls, tE_ref = port_ransac(c)
    b = int(np.argmax(tcounts))
    E_ref = tmvg.eight_point_essential(T(c["x1"]), T(c["x2"]), T(tinls[b]))
    n_ref = int(tmvg.sampson_score_plain(E_ref[None], T(c["x1"]), T(c["x2"]), T(c["mask"]),
                                         c["threshold"])[0][0])
    assert n_ref < tcounts[b] == tn and np.array_equal(tE, tEs[b])
    assert np.array_equal(tE_ref, E_ref.numpy())
    # the gate: below min_valid the mask comes back and nothing is fitted
    tE, tinl, tn, tEs, tcounts, tinls, tE_ref = port_ransac(CASES["11 valid, gated"])
    assert np.array_equal(tinl, CASES["11 valid, gated"]["mask"]) and tn == 11
    assert not tE.any() and not tEs.any() and not tcounts.any() and not tinls.any()
    assert not tE_ref.any()
    assert port_ransac(CASES["11 valid, gated"], min_valid=11)[2] < 11
    assert port_ransac(CASES["12 valid"])[2] < 12


@pytest.mark.parametrize("n_valid", [11, 12])
def test_tracker_gate_matches_jax(n_valid):
    """A tracker state with n_valid live tracks, two of them on blobs that
    move on their own: at 11 the gate keeps every track (no RANSAC, the
    reference's lax.cond), at 12 RANSAC runs and rejects; both packages'
    ``step`` give the same outputs.  The draws are JAX's own, distinct
    (``tracker_key``), so no hypothesis is degenerate."""
    rng = np.random.default_rng(5)
    frames = blob_frames(rng, 2, movers=8)
    K = (100.0, 100.0, 80.0, 60.0, -0.1, 0.02, 0.0, 0.0)
    jc, tc = jcam.pinhole(*K, width=160, height=120), tcam.pinhole(*K, width=160, height=120,
                                                                   device="cpu")
    kw = dict(max_features=32, min_dist=15, quality=0.01, ransac_hyps=2)
    jcfg = jft.TrackerConfig(equalize=False, klt=jklt.KLTConfig(levels=2), **kw)
    tcfg = tft.TrackerConfig(equalize=False, klt=tklt.KLTConfig(levels=2), **kw)
    step = jax.jit(lambda s, img, key: jft.step(s, img, jc, jcfg, 0.1, key))
    js, _ = step(jft.init_state(jcfg, 120, 160, jnp.float64), jnp.asarray(frames[0]),
                 jax.random.PRNGKey(0))
    # keep n_valid live tracks that KLT follows into frame 1, the blobs that
    # move on their own among them
    _, ok, _ = jklt.track(js.prev_img, jnp.asarray(frames[1]), js.xy, jcfg.klt)
    live = np.asarray(ok & (js.ids >= 0))
    d = np.linalg.norm(np.asarray(js.xy)[:, None] - blob_centers(rng_seed=5)[None, :8], axis=-1)
    mover = d.min(1) < 3.0
    keep = np.concatenate([np.nonzero(live & mover)[0][:2], np.nonzero(live & ~mover)[0]])[:n_valid]
    assert len(keep) == n_valid and mover[keep].sum() == 2
    ids = np.full(32, -1)
    ids[keep] = np.asarray(js.ids)[keep]
    js = js._replace(ids=jnp.asarray(ids, dtype=js.ids.dtype))
    ts = convert.to_torch(js, device="cpu")
    key, ridx, n_ok = tracker_key(js, jnp.asarray(frames[1]), jcfg, seed=1)
    assert n_ok == n_valid
    js1, jo = step(js, jnp.asarray(frames[1]), key)
    ts1, to = tft.step(ts, T(frames[1]), tc, tcfg, 0.1, T(ridx).long())
    np.testing.assert_array_equal(np.asarray(jo.ids), to.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jo.track_cnt), to.track_cnt.numpy())
    np.testing.assert_allclose(to.xy.numpy(), np.asarray(jo.xy), atol=1e-8, rtol=0)
    kept = int(np.sum(np.asarray(jo.track_cnt) >= 2))
    assert kept == n_valid if n_valid < 12 else kept < n_valid


def blob_centers(rng_seed):
    """The first frame's blob centres of ``blob_frames(default_rng(rng_seed),
    ...)`` (its first draw)."""
    return np.random.default_rng(rng_seed).uniform([10, 10], [150, 110], (50, 2))
