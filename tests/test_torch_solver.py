"""Parity of the port's window residuals, linearization, Schur solve,
marginalization, slide and one VIO step with the JAX reference (torch f64 on
the CPU against JAX x64).

The reference stacks line and VP rows and line-landmark columns even when
its line tables are empty; those rows are identically zero and the columns
decouple, so the port's points-only layout is compared against the
reference's point/IMU/prior/relo rows and dense + point columns.
√-priors are compared through JᵀJ and Jᵀr: their rows are eigenvectors,
free in sign and, for repeated eigenvalues, in rotation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.estimator import slide as jslide
from vplines_slam_tpu.estimator import vio as jvio
from vplines_slam_tpu.estimator import window as jwin
from vplines_slam_tpu.solver import lm as jlm
from vplines_slam_tpu.solver import marginalization as jmarg
from vplines_slam_tpu.utils import demo as jdemo
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator import slide as tslide
from vplines_slam_tpu_torch.estimator import vio as tvio
from vplines_slam_tpu_torch.estimator import window as twin
from vplines_slam_tpu_torch.solver import lm as tlm
from vplines_slam_tpu_torch.solver import marginalization as tmarg

torch.set_num_threads(1)

KW = dict(window=4, max_points=24, max_lines=2, max_imu=8)
JCFG = jwin.WindowConfig(**KW)
TCFG = twin.WindowConfig(**KW)
P = KW["max_points"]


def close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out),
                               atol=atol, rtol=rtol)


def close_tree(ja, tb, atol, rtol=0.0, skip=()):
    for f in ja._fields:
        if f in skip:
            continue
        a, b = getattr(ja, f), getattr(tb, f)
        if isinstance(a, tuple):
            close_tree(a, b, atol, rtol)
        else:
            close(a, b, atol, rtol)


def close_prior(jp, tp, rtol=1e-7, b_rtol=1e-4):
    """Priors agree through JᵀJ and Jᵀr, relative to their largest entry.
    Jᵀr gets the looser b_rtol: it is b projected onto the kept eigenspace,
    and the eigenvectors of the near-clip (gauge-like) eigenvalues are
    ill-conditioned, so f64 rounding moves it at the 1e-5 level."""
    jJ, jr = np.asarray(jp.J), np.asarray(jp.r0)
    tJ, tr = tp.J.numpy(), tp.r0.numpy()
    H_j, H_t = jJ.T @ jJ, tJ.T @ tJ
    assert np.abs(H_j - H_t).max() <= rtol * np.abs(H_j).max()
    b_j, b_t = jJ.T @ jr, tJ.T @ tr
    assert np.abs(b_j - b_t).max() <= b_rtol * np.abs(b_j).max()
    assert bool(jp.valid) == bool(tp.valid)


@pytest.fixture(scope="module")
def window():
    """A perturbed synthetic window (JAX), then one keyframe marginalization
    + slide so the prior is live; returned in both packages' types."""
    state, data, params = jdemo.synthetic_window(
        JCFG, n_landmarks=60, frame_dt=0.1, imu_per_interval=8, seed=0, perturb=0.01)
    prior = jax.jit(lambda s, d: jslide.marginalize_old(s, d, JCFG, params))(state, data)
    state, data = jax.jit(lambda s, d, p: jslide.slide_window_old(s, d, JCFG, params, p))(
        state, data, prior)
    state = state._replace(p=state.p.at[-1].set(state.p[-2] + 0.05),
                           q=state.q.at[-1].set(state.q[-2]))
    return (state, data, params), tuple(convert.to_torch(x, device="cpu") for x in (state, data, params))


def jax_rows(r, layout):
    sl = layout.slices()
    return np.concatenate([np.asarray(r)[sl[k]] for k in ("prior", "imu", "points", "relo")])


def jlayout():
    return jlm.WindowLayout(nd=JCFG.nd, nf=JCFG.nf, P=P, L=KW["max_lines"])


def test_window_residuals_match_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    assert bool(jd.prior.valid)
    jr = jwin.window_residuals((js, jd.pt_inv_depth, jd.ln_orth), jd, JCFG, jp)
    tr = twin.window_residuals((ts, td.pt_inv_depth), td, TCFG, tp)
    sl = jlayout().slices()
    assert np.abs(np.asarray(jr)[sl["lines"]]).max() == 0.0
    assert np.abs(np.asarray(jr)[sl["vps"]]).max() == 0.0
    close(jax_rows(jr, jlayout()), tr, atol=1e-10)
    assert np.abs(tr.numpy()).max() > 1e-3  # the window is really perturbed


def test_linearize_assemble_and_schur_match_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    lay_j = jlayout()
    r0, J_d, col_p, cols_l = jax.jit(lambda s, d: jlm._structured_linearize(
        lambda x: jwin.window_residuals(x, d, JCFG, jp),
        lambda x, dd: jwin.retract_all(x, dd, JCFG), (s, d.pt_inv_depth, d.ln_orth), lay_j))(
        js, jd)
    lay_t = twin.layout_for(TCFG)
    tr0, tJ_d, tcol_p = tlm._structured_linearize(
        lambda x: twin.window_residuals(x, td, TCFG, tp),
        lambda x, d: twin.retract_all(x, d, TCFG), (ts, td.pt_inv_depth), lay_t)
    close(jax_rows(r0, lay_j), tr0, atol=1e-10)
    sl = lay_j.slices()
    rows = np.concatenate([np.arange(sl[k].start, sl[k].stop)
                           for k in ("prior", "imu", "points", "relo")])
    close(np.asarray(J_d)[rows], tJ_d, atol=1e-8, rtol=1e-10)
    close(np.asarray(col_p)[rows], tcol_p, atol=1e-8, rtol=1e-10)

    jb = jlm._assemble_blocks(r0, J_d, col_p, cols_l, lay_j)
    tb = tlm._assemble_blocks(tr0, tJ_d, tcol_p, lay_t)
    for a, b in zip(jb[:5], tb):
        close(a, b, atol=1e-6, rtol=1e-9)
    assert np.abs(np.asarray(jb[5])).max() == 0.0  # H_dl: no line coupling
    for lam in (1e-4, 10.0):
        jdelta = jlm.schur_solve_blocks(*jb, lam)
        tdelta = tlm.schur_solve_blocks(*tb, lam)
        close(np.asarray(jdelta)[: JCFG.nd + P], tdelta, atol=1e-9, rtol=1e-7)


def test_solve_window_matches_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    js2, jd2, jout = jax.jit(lambda s, d: jwin.solve_window(s, d, JCFG, jp, num_iters=4))(
        js, jd)
    ts2, td2, tout = twin.solve_window(ts, td, TCFG, tp, num_iters=4)
    close_tree(js2, ts2, atol=1e-9)
    close(jd2.pt_inv_depth, td2.pt_inv_depth, atol=1e-9)
    close(jout.cost, tout.cost, atol=0.0, rtol=1e-9)
    close(jout.cost0, tout.cost0, atol=0.0, rtol=1e-12)
    assert float(tout.cost) < float(tout.cost0)


@pytest.mark.parametrize("n_points", [0, 7])
def test_marginalize_window_matches_jax(n_points):
    rng = np.random.default_rng(n_points)
    nd, R = 27, 90
    J = rng.standard_normal((R, nd + n_points)) * rng.uniform(0.1, 10, nd + n_points)
    J[:, nd - 3] = 0.0  # an inactive column
    r = rng.standard_normal(R)
    jJ, jr = jmarg.marginalize_window(jnp.asarray(J), jnp.asarray(r), nd, 6, 9,
                                      n_points=n_points)
    tJ, tr = tmarg.marginalize_window(torch.as_tensor(J), torch.as_tensor(r), nd, 6, 9,
                                      n_points=n_points)
    close_prior(jmarg.Prior(jJ, jr, jnp.asarray(True)),
                tmarg.Prior(tJ, tr, torch.tensor(True)), rtol=1e-9)


def test_marginalize_old_matches_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    jpr = jax.jit(lambda s, d: jslide.marginalize_old(s, d, JCFG, jp))(js, jd)
    tpr = tslide.marginalize_old(ts, td, TCFG, tp)
    # the bias rows whiten by up to ~1e7 (J matches to 1e-20 relative), so
    # the Schur complement of the dropped frame inherits f64 eigh rounding
    # at the 1e-6 level of its largest entry
    close_prior(jpr, tpr, rtol=5e-6)
    close(jslide.gauge_nullspace(js, JCFG), tslide.gauge_nullspace(ts, TCFG), atol=1e-14)


def test_slide_window_old_matches_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    jpr = jax.jit(lambda s, d: jslide.marginalize_old(s, d, JCFG, jp))(js, jd)
    tpr = convert.to_torch(jpr, device="cpu")  # same prior in: compare the slide alone
    js2, jd2 = jax.jit(lambda s, d, p: jslide.slide_window_old(s, d, JCFG, jp, p))(js, jd, jpr)
    ts2, td2 = tslide.slide_window_old(ts, td, TCFG, tp, tpr)
    close_tree(js2, ts2, atol=0.0)
    close_tree(jd2, convert.from_torch(td2), atol=1e-12, skip=("ln_orth",))


def test_slide_window_new_matches_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    # fill the newest interval so the merge overflows the capacity (2:1 path)
    jd = jslide.set_imu_interval(jd, JCFG.nf - 2, jd.imu_dt[0], jd.imu_acc[0],
                                 jd.imu_gyr[0], jd.imu_mask[0], params=jp)
    td = convert.to_torch(jd, device="cpu")
    js2, jd2 = jax.jit(lambda s, d: jslide.slide_window_new(s, d, JCFG, jp))(js, jd)
    ts2, td2 = tslide.slide_window_new(ts, td, TCFG, tp)
    close_tree(js2, ts2, atol=0.0)
    tn = convert.from_torch(td2)
    close_tree(jd2, tn, atol=1e-12, rtol=1e-12, skip=("prior", "ln_orth"))
    close_prior(jd2.prior, td2.prior, rtol=1e-8)


def test_track_step_matches_jax(window):
    (js, jd, jp), (ts, td, tp) = window
    nf, I = JCFG.nf, JCFG.max_imu
    # the newest frame observes the tracks of the frame before it
    ids = np.asarray(jd.pt_id)
    rays = np.asarray(jd.pt_obs)[:, nf - 2]
    rays = rays + np.concatenate([np.full((P, 2), 2e-3), np.zeros((P, 1))], 1)
    seen = np.asarray(jd.pt_mask)[:, nf - 2] & (ids >= 0)
    ids = np.where(seen, ids, -1).astype(np.int32)
    batch = (np.asarray(jd.imu_dt[0]), np.asarray(jd.imu_acc[0]), np.asarray(jd.imu_gyr[0]),
             np.asarray(jd.imu_mask[0]), np.asarray(True))
    js2, jd2, jo = jax.jit(lambda s, d, i, r, b: jvio.track_step(
        s, d, i, r, (), b, JCFG, jp, False))(
        js, jd, jnp.asarray(ids), jnp.asarray(rays), tuple(map(jnp.asarray, batch)))
    ts2, td2, to = tvio.track_step(ts, td, torch.as_tensor(ids).long(),
                                   torch.as_tensor(rays), convert.to_torch(batch, device="cpu"), TCFG, tp)
    for f in ("p", "q", "v", "ba", "bg", "ba_cost"):
        close(getattr(jo, f), getattr(to, f), atol=1e-8, rtol=1e-8)
    assert bool(jo.is_keyframe) == bool(to.is_keyframe)
    assert bool(jo.failure) == bool(to.failure)
    close(jvio.pack_output(jo), tvio.pack_output(to), atol=1e-5)
    close_tree(js2, ts2, atol=1e-8)
    close(jd2.pt_inv_depth, td2.pt_inv_depth, atol=1e-8)
    assert np.array_equal(np.asarray(jd2.pt_id), td2.pt_id.numpy())
    close_prior(jd2.prior, td2.prior, rtol=1e-6)
