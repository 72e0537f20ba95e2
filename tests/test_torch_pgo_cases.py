"""The 4-DoF pose graph (K19's plain twin inside ``optimize_4dof``) against
the JAX reference on the databases of ``utils/synthetic.pgo_cases``: an
empty one, one keyframe, a full one, a sequence change that cuts the
sequential edges (after a loaded seq 0 map), loop edges into keyframe 0,
two loop edges into one keyframe, loop yaws of exactly +-180 deg, and a
database grown by ``grow_db``.  Tolerances as ``test_torch_pose_graph.py``'s
``test_optimize_4dof_matches_jax``: poses 1e-8, the LM's costs, damping and
gradient norm 1e-9 relative (torch f64 on the CPU against JAX x64).  On each
case the premises of K19's design hold exactly on the twin: the dead edges'
zeros and the sparsity of H."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from vplines_slam_tpu.models import pose_graph as jpg
from vplines_slam_tpu_torch.models import pose_graph as tpg
from vplines_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
CASES = tsyn.pgo_cases()


def _dbs(case):
    """The case as a JAX and a port database (grown when it says so)."""
    K = case["p_vio"].shape[0]
    ckw = dict(max_keyframes=K, n_features=4, n_window_pts=4)
    jcfg, tcfg = jpg.PoseGraphConfig(**ckw), tpg.PoseGraphConfig(**ckw)
    fields = ("p_vio", "q_vio", "p_pgo", "yaw_pgo", "loop_t", "loop_yaw")
    jdb = jpg.empty_db(jcfg, jnp.float64)._replace(
        count=jnp.asarray(case["count"], jnp.int32), seq=jnp.asarray(case["seq"], jnp.int32),
        loop_to=jnp.asarray(case["loop_to"], jnp.int32),
        **{f: jnp.asarray(case[f]) for f in fields})
    tdb = tpg.empty_db(tcfg, F64, CPU)._replace(
        count=torch.tensor(case["count"]), seq=torch.from_numpy(case["seq"]),
        loop_to=torch.from_numpy(case["loop_to"]),
        **{f: torch.from_numpy(case[f]) for f in fields})
    if case["grow"]:
        jdb, tdb = jpg.grow_db(jdb), tpg.grow_db(tdb)
    return jdb, tdb, jcfg, tcfg


def close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", list(CASES))
def test_optimize_4dof_case_matches_jax(name):
    jdb, tdb, jcfg, tcfg = _dbs(CASES[name])
    jdb2, jout = jax.jit(lambda db: jpg.optimize_4dof(db, jcfg))(jdb)
    tdb2, tout = tpg.optimize_4dof(tdb, tcfg)
    close(jdb2.p_pgo, tdb2.p_pgo, atol=1e-8)
    close(jdb2.yaw_pgo, tdb2.yaw_pgo, atol=1e-8)
    for f in ("cost0", "cost", "lam", "grad_norm"):
        close(getattr(jout, f), getattr(tout, f), atol=0, rtol=1e-9)
    assert float(tout.cost) <= float(tout.cost0)


def _live_edges(case, K, E):
    """Whether each edge of the stacked residual has a nonzero weight: [K,
    E] sequential edges, [K] loop edges, [K] gauge rows."""
    n, seq, lt = case["count"], case["seq"], case["loop_to"]
    seq = np.concatenate([seq, np.ones(K - len(seq), np.int64)])
    lt = np.concatenate([lt, -np.ones(K - len(lt), np.int64)])
    j = np.arange(K)
    i = j[:, None] - np.arange(1, E + 1)[None, :]
    live_seq = (i >= 0) & (j[:, None] < n) & (j[:, None] >= 1) & (
        seq[np.maximum(i, 0)] == seq[:, None])
    live_loop = (lt >= 0) & (j < n)
    live_gauge = (j == 0) | ((seq == 0) & (j < n))
    return np.concatenate([live_seq.reshape(-1), live_loop, live_gauge]), lt


@pytest.mark.parametrize("name", list(CASES))
def test_pgo_normal_case_premises(name):
    """What K19's block rows rely on, on the twin at a perturbed x: an edge
    of weight 0 has exact zeros in r and J (the kernel skips it); g is
    -J^T r, and the nonzero 4x4 blocks of H = J^T J lie on the band
    |a - b| <= seq_edges and the loop partners (the only blocks the kernel
    computes; the rest of each row it writes as zeros)."""
    _, tdb, _, tcfg = _dbs(CASES[name])
    K, E = tdb.p_vio.shape[0], tcfg.seq_edges
    rng = np.random.default_rng(5)
    x = torch.cat([tdb.yaw_pgo[:, None], tdb.p_pgo], 1) + torch.from_numpy(
        rng.uniform(-0.5, 0.5, (K, 4)))
    ypr = tpg._ypr_vio(tdb)
    r, H, g = tpg.pgo_normal(x, tdb, ypr, tcfg)
    J = jacfwd(lambda xf: tpg.pgo_residual(xf.reshape(K, 4), tdb, ypr, tcfg))(x.reshape(-1))
    live, lt = _live_edges(CASES[name], K, E)
    dead = torch.from_numpy(np.repeat(~live, 4))
    assert torch.equal(r[dead], torch.zeros_like(r[dead]))
    assert torch.equal(J[dead], torch.zeros_like(J[dead]))
    torch.testing.assert_close(g, -(J.T @ r), rtol=0, atol=0)
    nz = (H.reshape(K, 4, K, 4).abs().sum((1, 3)) != 0).numpy()
    allowed = np.abs(np.arange(K)[:, None] - np.arange(K)[None, :]) <= E
    for j in np.nonzero((lt >= 0) & live[K * E:K * E + K])[0]:
        allowed[j, lt[j]] = allowed[lt[j], j] = True
    assert not (nz & ~allowed).any()
    assert nz[0, 0]
