"""Parity of the cold-start path's modules with the JAX reference: CLAHE, the
batched IMU preintegration and ``repropagate_all``, the two-view and PnP
geometry, the generic LM engine, the initializer's functions, the config
loader, the frame stamps and the modes that stay unported (torch f64 on the
CPU against JAX x64, unless a test says otherwise)."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.estimator import initializer as jinit
from vplines_slam_tpu.estimator import slide as jslide
from vplines_slam_tpu.estimator import window as jwin
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu.ops import image as jimage
from vplines_slam_tpu.ops import mvg as jmvg
from vplines_slam_tpu.solver import lm as jlm
from vplines_slam_tpu.utils import config as jconfig
from vplines_slam_tpu.utils import geometry as jgeo
from vplines_slam_tpu.utils import synthetic as jsyn
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator import initializer as tinit
from vplines_slam_tpu_torch.estimator import slide as tslide
from vplines_slam_tpu_torch.estimator import vio as tvio
from vplines_slam_tpu_torch.estimator import window as twin
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import feature_tracker as tft
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.ops import image as timage
from vplines_slam_tpu_torch.ops import mvg as tmvg
from vplines_slam_tpu_torch.pipeline import system as tsys
from vplines_slam_tpu_torch.solver import lm as tlm
from vplines_slam_tpu_torch.utils import config as tconfig
from vplines_slam_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def T(a):
    return torch.as_tensor(np.array(a))


def close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# CLAHE (K9's plain twin)
# ---------------------------------------------------------------------------


def textured(H=96, W=128, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = 0.3 + 0.1 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.05 * rng.standard_normal((H, W))
    img[10:30, 20:60] += 0.35
    img[60:90, 90:120] -= 0.2
    return np.clip(img, 0.0, 1.0)


def test_clahe_matches_jax():
    """The reference blends its per-pixel LUT stack in bf16 (8 mantissa bits:
    ~4e-3 relative per rounding on [0, 1]); the port blends in the input
    dtype.  Bound: 1e-2 absolute, the error two bf16 roundings of the blend
    allow.  The port's own f32 and f64 results agree to f32 rounding."""
    img = textured()
    j = np.asarray(jimage.clahe(jnp.asarray(img)))
    t = timage.clahe(T(img)).numpy()
    err = float(np.abs(j - t).max())
    print(f"clahe: max |port - reference| = {err:.3e} (bound 1e-2)")
    assert err < 1e-2
    # the histograms and LUTs carry no bf16 step: compare them exactly-ish
    tl = timage.clahe_luts_plain(T(img)).numpy()
    assert tl.shape == (8, 8, 32) and np.all(np.diff(tl, axis=-1) >= 0)
    np.testing.assert_allclose(tl[..., -1], 1.0)
    t32 = timage.clahe(T(img).float()).numpy()
    assert np.abs(t32 - t).max() < 1e-5


# ---------------------------------------------------------------------------
# batched preintegration and repropagation (K10's plain twin)
# ---------------------------------------------------------------------------


def imu_batch(rng, B=4, N=16, real=(11, 16, 5, 0)):
    dts = 0.005 + rng.uniform(0, 1e-4, (B, N))
    mask = np.arange(N)[None] < np.asarray(real)[:, None]
    accs = np.array([0.3, -0.2, 9.81]) + rng.standard_normal((B, N + 1, 3))
    gyrs = rng.standard_normal((B, N + 1, 3)) * 0.5
    ba = rng.standard_normal((B, 3)) * 0.05
    bg = rng.standard_normal((B, 3)) * 0.01
    return dts, accs, gyrs, mask, ba, bg


def test_preintegrate_batched_matches_jax():
    """Four intervals at once (11, 16, 5 and 0 real steps; the masked steps
    still run, as in the reference) against the reference vmapped; and the
    single-interval call without the batch axis.  rtol 1e-10."""
    args = imu_batch(np.random.default_rng(0))
    jp = jax.vmap(lambda *a: jimu.preintegrate(*a, jimu.default_params()))(
        *map(jnp.asarray, args))
    tp = timu.preintegrate(*map(T, args), timu.default_params(device=CPU))
    for f in jp._fields:
        close(getattr(jp, f), getattr(tp, f), atol=1e-15, rtol=1e-10)
    one = timu.preintegrate(*(T(a[1]) for a in args), timu.default_params(device=CPU))
    assert one.jacobian.shape == (15, 15) and one.sum_dt.shape == ()
    for f in jp._fields:
        close(getattr(jp, f)[1], getattr(one, f), atol=1e-15, rtol=1e-10)


def test_repropagate_all_matches_jax():
    """Every stored interval re-preintegrated at the per-frame biases in one
    batched call, then whitened (rtol 1e-10; the whitening 1e-9)."""
    rng = np.random.default_rng(1)
    cfg = jwin.WindowConfig(window=4, max_points=8, max_lines=2, max_imu=16)
    dts, accs, gyrs, mask, _, _ = imu_batch(rng, B=4, N=16, real=(11, 16, 5, 9))
    data = jwin.empty_tracks(cfg)._replace(
        imu_dt=jnp.asarray(dts), imu_acc=jnp.asarray(accs), imu_gyr=jnp.asarray(gyrs),
        imu_mask=jnp.asarray(mask))
    state = jwin.empty_state(cfg)._replace(ba=jnp.asarray(rng.standard_normal((5, 3)) * 0.05),
                                           bg=jnp.asarray(rng.standard_normal((5, 3)) * 0.01))
    jd = jslide.repropagate_all(data, state, jimu.default_params())
    td = tslide.repropagate_all(convert.to_torch(data, device=CPU),
                                convert.to_torch(state, device=CPU),
                                timu.default_params(device=CPU))
    for f in jd.imu_pre._fields:
        close(getattr(jd.imu_pre, f), getattr(td.imu_pre, f), atol=1e-15, rtol=1e-10)
    close(jd.imu_sqrt, td.imu_sqrt, atol=1e-6, rtol=1e-9)


# ---------------------------------------------------------------------------
# a synthetic init window (shared by the geometry and initializer tests)
# ---------------------------------------------------------------------------

R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
P_IC = np.array([0.05, 0.02, 0.03])
NF, NPTS = 6, 48


def _window():
    """NF frames at 10 Hz of the figure-8 from t = 0, NPTS landmarks seen by
    all or most frames (noise-free normalized observations, see _sfm_key),
    and the zero-bias preintegrations of the 20-step IMU intervals between
    frames."""
    traj = jsyn.figure8_trajectory()
    q_ic = jgeo.rot_to_quat(jnp.asarray(R_BC))
    rng = np.random.default_rng(5)
    ts = np.arange(NF) * 0.1
    q_wb = np.stack([np.asarray(traj.quat(t)) for t in ts])
    p_wb = np.stack([np.asarray(traj.pos(t)) for t in ts])
    R_wc = np.stack([np.asarray(jgeo.quat_to_rot(jnp.asarray(q))) @ R_BC for q in q_wb])
    p_wc = p_wb + np.einsum("fij,j->fi", np.stack(
        [np.asarray(jgeo.quat_to_rot(jnp.asarray(q))) for q in q_wb]), P_IC)
    # landmarks 2-6 m in front of the first camera, spread over the view
    d = rng.uniform(2.0, 6.0, NPTS)
    uv = rng.uniform([-0.6, -0.4], [0.6, 0.4], (NPTS, 2))
    X = p_wc[0] + (np.concatenate([uv, np.ones((NPTS, 1))], 1) * d[:, None]) @ R_wc[0].T
    Xc = np.einsum("fji,nfj->nfi", R_wc, X[:, None] - p_wc[None])
    obs = Xc[..., :2] / Xc[..., 2:]
    mask = (Xc[..., 2] > 0.3) & (np.abs(obs) < 0.9).all(-1)
    mask[:6, 1:3] = False  # a few gaps
    imu_t = np.arange((NF - 1) * 20 + 1) * 0.005
    accs, gyrs = (np.asarray(a) for a in jsyn.imu_samples(traj, jnp.asarray(imu_t)))
    idx = np.arange(NF - 1)[:, None] * 20 + np.arange(21)
    dts = np.full((NF - 1, 20), 0.005)
    z = jnp.zeros((NF - 1, 3))
    pre = jax.vmap(lambda *a: jimu.preintegrate(*a, jimu.default_params()))(
        jnp.asarray(dts), jnp.asarray(accs[idx]), jnp.asarray(gyrs[idx]),
        jnp.ones((NF - 1, 20), bool), z, z)
    return dict(obs=obs, mask=mask, pre=pre, q_ic=np.asarray(q_ic), p_ic=P_IC,
                valid=np.ones(NF - 1, bool), X=X, R_wc=R_wc, p_wc=p_wc)


WIN = _window()


def _sfm_key(l, n_hyp=64):
    """JAX key and its draws for window_sfm.  No key gives 64 hypotheses of 8
    distinct valid entries (see key_with_distinct_samples), and a hypothesis
    with a repeated sample is not reproducible across LAPACK builds.  With
    noise-free observations that does not matter: every hypothesis that
    wins finds all valid tracks inliers, and the kept essential matrix is
    the refit on that inlier set."""
    key = jax.random.PRNGKey(l)
    return key, np.asarray(jax.random.randint(key, (n_hyp, 8), 0, NPTS))


def test_choose_reference_frame_matches_jax():
    for min_par in (0.01, 0.03, 1.0):
        jl, jf = jinit.choose_reference_frame(jnp.asarray(WIN["obs"]), jnp.asarray(WIN["mask"]),
                                              min_parallax=min_par, min_corres=20)
        tl, tf = tinit.choose_reference_frame(T(WIN["obs"]), T(WIN["mask"]),
                                              min_parallax=min_par, min_corres=20)
        assert int(jl) == int(tl) and bool(jf) == bool(tf)


def test_decompose_essential_and_triangulate_two_view_match_jax():
    """Frames 0 and NF-1: the essential fit, the cheirality vote (the four
    candidates' order depends on the SVD's signs; the winner does not) and
    the DLT triangulation."""
    x1, x2 = WIN["obs"][:, 0], WIN["obs"][:, NF - 1]
    m = WIN["mask"][:, 0] & WIN["mask"][:, NF - 1]
    E = np.asarray(jmvg.eight_point_essential(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(m)))
    jR, jt, jv = jmvg.decompose_essential(*map(jnp.asarray, (E, x1, x2, m)))
    tR, tt, tv = tmvg.decompose_essential(*map(T, (E, x1, x2, m)))
    assert int(jv) == int(tv) == int(m.sum())
    close(jR, tR, atol=1e-10)
    close(jt, tt, atol=1e-10)
    jz1, jz2 = jmvg._two_view_depths(jR, jt, jnp.asarray(x1), jnp.asarray(x2))
    tz1, tz2 = tmvg._two_view_depths(tR, tt, T(x1), T(x2))
    close(jz1, tz1, atol=1e-9)
    close(jz2, tz2, atol=1e-9)
    jX, jd = jmvg.triangulate_two_view(jR, jt, jnp.asarray(x1), jnp.asarray(x2))
    tX, td = tmvg.triangulate_two_view(tR, tt, T(x1), T(x2))
    close(jX, tX, atol=1e-8, rtol=1e-8)
    close(jd, td, atol=1e-8, rtol=1e-8)


def test_pnp_dlt_and_refine_match_jax():
    """Every frame against the true landmarks (frame 0's camera as the
    world), batched over frames in the port, one frame at a time in JAX."""
    X_l = (WIN["X"] - WIN["p_wc"][0]) @ WIN["R_wc"][0]
    obs_f = np.transpose(WIN["obs"], (1, 0, 2))
    m_f = WIN["mask"].T
    tR, tt, tok = tmvg.pnp_dlt(T(X_l), T(obs_f), T(m_f))
    for f in range(NF):
        jR, jt, jok = jmvg.pnp_dlt(jnp.asarray(X_l), jnp.asarray(obs_f[f]), jnp.asarray(m_f[f]))
        close(jR, tR[f], atol=1e-9)
        close(jt, tt[f], atol=1e-9)
        assert bool(jok) == bool(tok[f])
        jR2, jt2 = jmvg.pnp_refine(jR, jt, jnp.asarray(X_l), jnp.asarray(obs_f[f]),
                                   jnp.asarray(m_f[f]))
        tR2, tt2 = tmvg.pnp_refine(T(np.asarray(jR)), T(np.asarray(jt)), T(X_l), T(obs_f[f]),
                                   T(m_f[f]))
        close(jR2, tR2, atol=1e-10)
        close(jt2, tt2, atol=1e-10)


# ---------------------------------------------------------------------------
# the generic LM engine
# ---------------------------------------------------------------------------


def _ls_problem(rng):
    """A small nonlinear least-squares problem with a dense block (3), 6
    scalar blocks and 2 4-dof blocks: r = tanh(A x) - b."""
    n = 3 + 6 + 8
    A = rng.standard_normal((40, n)) * 0.4
    mask = rng.uniform(size=(40, n)) < 0.5
    mask[:, :3] = True
    A = A * mask
    b = np.tanh(A @ rng.standard_normal(n)) + rng.standard_normal(40) * 0.01
    return A, b


@pytest.mark.parametrize("lam", [1e-4, 10.0])
def test_schur_solve_matches_jax(lam):
    rng = np.random.default_rng(2)
    J = rng.standard_normal((60, 17))
    J[:, 3:9] *= rng.uniform(size=(60, 6)) < 0.3  # sparse scalar columns
    r = rng.standard_normal(60)
    jH, jg = jlm.normal_equations(jnp.asarray(J), jnp.asarray(r))
    tH, tg = tlm.normal_equations(T(J), T(r))
    close(jH, tH, atol=1e-12)
    spec = dict(dense_dim=3, n_scalar=6, n_block4=2)
    jd = jlm.schur_solve(jH, jg, jlm.SchurSpec(**spec), lam)
    td = tlm.schur_solve(tH, tg, tlm.SchurSpec(**spec), lam)
    close(jd, td, atol=1e-10, rtol=1e-9)


def test_lm_solve_matches_jax():
    A, b = _ls_problem(np.random.default_rng(3))
    spec = dict(dense_dim=3, n_scalar=6, n_block4=2)
    jout = jlm.lm_solve(lambda x: jnp.tanh(jnp.asarray(A) @ x) - jnp.asarray(b),
                        lambda x, d: x + d, jnp.zeros(17), jlm.SchurSpec(**spec),
                        jlm.LMConfig(num_iters=6))
    tout = tlm.lm_solve(lambda x: torch.tanh(T(A) @ x) - T(b), lambda x, d: x + d,
                        torch.zeros(17, dtype=torch.float64), tlm.SchurSpec(**spec),
                        tlm.LMConfig(num_iters=6))
    assert float(tout.cost) < 0.5 * float(tout.cost0)
    for f in ("x", "cost0", "cost", "lam", "grad_norm"):
        close(getattr(jout, f), getattr(tout, f), atol=1e-10, rtol=1e-8)


# ---------------------------------------------------------------------------
# geometry helpers and the initializer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["so3_exp_matrix", "quat_from_two_vectors", "gravity_to_rot"])
def test_geometry_helpers_match_jax(name):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 3))
    b = np.concatenate([rng.standard_normal((4, 3)), -a[4:5]])  # the last pair antipodal
    args = {"so3_exp_matrix": (a,), "quat_from_two_vectors": (a, b),
            "gravity_to_rot": (a + np.array([0.0, 0.0, 9.8]),)}[name]
    close(getattr(jgeo, name)(*map(jnp.asarray, args)), getattr(tgeo, name)(*map(T, args)),
          atol=1e-12)


def test_window_sfm_matches_jax():
    """The window SFM from frame 0, with the port given JAX's own RANSAC
    draws (a key whose 64 hypotheses draw distinct valid entries)."""
    l = 0
    key, draws = _sfm_key(l)
    jsfm, jinvd, jok = jinit.window_sfm(jnp.asarray(WIN["obs"]), jnp.asarray(WIN["mask"]), l,
                                        key)
    tsfm, tinvd, tok = tinit.window_sfm(T(WIN["obs"]), T(WIN["mask"]), torch.tensor(l),
                                        T(draws).long())
    assert bool(jsfm.ok) and bool(tsfm.ok)
    assert np.array_equal(np.asarray(jok), tok.numpy())
    close(jsfm.R_c0_c, tsfm.R_c0_c, atol=1e-8)
    close(jsfm.t_c0_c, tsfm.t_c0_c, atol=1e-8)
    close(jinvd, tinvd, atol=1e-7)


@functools.lru_cache(maxsize=None)
def _sfm_inputs():
    """The JAX window SFM's result, the input of the alignment functions."""
    key, _ = _sfm_key(0)
    sfm, _, _ = jinit.window_sfm(jnp.asarray(WIN["obs"]), jnp.asarray(WIN["mask"]), 0, key)
    R_b = sfm.R_c0_c @ jgeo.quat_to_rot(jnp.asarray(WIN["q_ic"])).T[None]
    return sfm, R_b


def test_solve_gyro_bias_and_alignment_system_match_jax():
    sfm, R_b = _sfm_inputs()
    pre, valid = WIN["pre"], jnp.asarray(WIN["valid"])
    tpre = convert.to_torch(pre, device=CPU)
    q_b = jax.vmap(jgeo.rot_to_quat)(R_b)
    q_rel = jax.vmap(lambda a, b: jgeo.quat_mul(jgeo.quat_conj(a), b))(q_b[:-1], q_b[1:])
    jbg = jinit.solve_gyro_bias(q_rel, pre, valid)
    tbg = tinit.solve_gyro_bias(T(q_rel), tpre, T(valid))
    close(jbg, tbg, atol=1e-12)
    tic = jnp.asarray(WIN["p_ic"])
    jx = jinit._alignment_system(R_b, sfm.t_c0_c, pre, valid, tic)
    tx = tinit._alignment_system(T(R_b), T(sfm.t_c0_c), tpre, T(valid), T(tic))
    close(jx, tx, atol=1e-9, rtol=1e-8)
    g0 = jx[3 * NF: 3 * NF + 3]
    basis = jnp.asarray(np.linalg.qr(np.asarray(g0)[:, None], mode="complete")[0][:, 1:])
    jx2 = jinit._alignment_system(R_b, sfm.t_c0_c, pre, valid, tic, g_dirs=basis, g0=g0)
    tx2 = tinit._alignment_system(T(R_b), T(sfm.t_c0_c), tpre, T(valid), T(tic),
                                  g_dirs=T(basis), g0=T(g0))
    close(jx2, tx2, atol=1e-9, rtol=1e-8)


def test_linear_and_visual_inertial_alignment_match_jax():
    sfm, R_b = _sfm_inputs()
    pre, valid = WIN["pre"], jnp.asarray(WIN["valid"])
    tpre = convert.to_torch(pre, device=CPU)
    tic = jnp.asarray(WIN["p_ic"])
    jout = jinit.linear_alignment(R_b, sfm.t_c0_c, pre, valid, tic, 9.81007)
    tout = tinit.linear_alignment(T(R_b), T(sfm.t_c0_c), tpre, T(valid), T(tic), 9.81007)
    for a, b in zip(jout, tout):
        close(a, b, atol=1e-8, rtol=1e-8)
    tsfm = tinit.SfmResult(*(T(np.asarray(x)) for x in sfm))
    ja = jinit.visual_inertial_align(sfm, pre, valid, jnp.asarray(WIN["q_ic"]), tic, 9.81007)
    ta = tinit.visual_inertial_align(tsfm, tpre, T(valid), T(WIN["q_ic"]), T(tic), 9.81007)
    assert bool(ja.ok) and bool(ta.ok)
    for f in ja._fields:
        close(getattr(ja, f), getattr(ta, f), atol=1e-8, rtol=1e-8)


# ---------------------------------------------------------------------------
# frame stamps, the config loader, unported modes
# ---------------------------------------------------------------------------


def test_frame_stamps_stay_f64_at_euroc_epoch():
    """With an f32 engine, two frames 0.05 s apart at t ~ 1.4e9 s keep
    distinct stamps (f32 would round both to the same multiple of 128 s),
    and the relo stamp match picks the right frame."""
    cfg = twin.WindowConfig(window=3, max_points=8, max_lines=2, max_imu=8)
    eng = tvio.VioEngine(cfg, q_ic=np.array([1.0, 0, 0, 0]), p_ic=np.zeros(3),
                         dtype=torch.float32, device=CPU)
    assert eng.data.frame_t.dtype == torch.float64 and eng.state.p.dtype == torch.float32
    t0 = 1403636579.763555
    batch = eng._pack_imu(None)
    ids = torch.full((8,), -1, dtype=torch.long)
    rays = torch.zeros(8, 3)
    for k, t in enumerate((t0, t0 + 0.05)):
        eng.fill_step(k, ids, rays, (), batch, t)
    ft = eng.data.frame_t.numpy()
    assert ft[0] == t0 and ft[1] == t0 + 0.05 and np.float32(t0) == np.float32(t0 + 0.05)
    data = eng.data._replace(relo_valid=torch.tensor(True),
                             relo_stamp=torch.tensor(t0 + 0.05, dtype=torch.float64))
    kf_idx, found = tvio._relo_frame(data)
    assert int(kf_idx) == 1 and bool(found)
    f32 = data._replace(frame_t=data.frame_t.float(), relo_stamp=data.relo_stamp.float())
    assert int(tvio._relo_frame(f32)[0]) == 0  # f32 stamps tie: the wrong frame
    back = convert.to_torch(convert.from_torch(eng.data), device=CPU, dtype=torch.float32)
    assert back.frame_t.dtype == torch.float64 and back.frame_t[1].item() == t0 + 0.05


def test_load_profile_matches_jax():
    path = str(ROOT / "configs" / "euroc.yaml")
    jp = jconfig.load_profile(path)
    tp = tconfig.load_profile(path, device=CPU)
    for f in ("fx", "fy", "cx", "cy", "dist"):
        close(getattr(jp.camera, f), getattr(tp.camera, f), atol=0)
    assert (jp.camera.width, jp.camera.height) == (tp.camera.width, tp.camera.height)
    for a, b in zip(jp.imu_params, tp.imu_params):
        close(a, b, atol=0)
    close(jp.q_ic, tp.q_ic, atol=1e-15)
    close(jp.p_ic, tp.p_ic, atol=0)
    assert jp.window._asdict() == tp.window._asdict()
    for f in tp.tracker._fields:
        if f != "klt":
            assert getattr(jp.tracker, f) == getattr(tp.tracker, f), f
    assert tp.tracker.equalize and tp.lines.equalize
    jl, tl = jp.lines, tp.lines
    assert (jl.max_lines, jl.max_h, jl.max_v, jl.use_vp) == (tl.max_lines, tl.max_h, tl.max_v,
                                                             tl.use_vp)
    assert (jl.detect.min_len, jl.detect.fit_err) == (tl.detect.min_len, tl.detect.fit_err)
    assert tuple(jl.vp) == tuple(tl.vp)
    for f in ("td", "name", "estimate_extrinsic", "estimate_td", "use_loop_closure",
              "use_feature_selector", "use_global_fusion", "landmark_mesh_devices"):
        assert getattr(jp, f) == getattr(tp, f), f
    assert tuple(jp.pose_graph) == tuple(tp.pose_graph) and tp.pose_graph.n_features == 500


def _unported():
    cam = lambda: tcam.pinhole(100.0, 100.0, 8.0, 6.0, width=16, height=12, device=CPU)
    cfg = twin.WindowConfig(window=2, max_points=4, max_lines=2, max_imu=4)
    tc = tft.TrackerConfig(max_features=4)
    q = np.array([1.0, 0, 0, 0])

    def engine(**kw):
        return lambda: tvio.VioEngine(cfg, q_ic=q, p_ic=np.zeros(3), device=CPU, **kw)

    def system(**kw):
        kw = dict(dict(use_loop_closure=False), **kw)
        return lambda: tsys.SlamSystem(cam(), cfg, tc, q_ic=q, p_ic=np.zeros(3), device=CPU,
                                       **kw)

    def profile(tmp):
        text = (ROOT / "configs" / "euroc.yaml").read_text().replace("model: pinhole",
                                                                     "model: mei")
        (tmp / "mei.yaml").write_text(text)
        return tconfig.load_profile(str(tmp / "mei.yaml"), device=CPU)

    return {
        "vio.mesh": engine(mesh=object()),
        "system.fusion": system(fusion_cfg=object()),
        "system.fetch_every": system(fetch_every=2),
        "system.introspection": system(introspect_every=5),
        "system.introspection_dir": system(introspect_dir="introspect"),
        "tracker.fisheye": lambda: tft.FeatureTrackerFrontend(
            cam(), tft.TrackerConfig(max_features=4, fisheye=True), device=CPU),
        "config.non_pinhole": profile,
    }


@pytest.mark.parametrize("name", sorted(_unported()))
def test_unported_modes_raise(name, tmp_path):
    fn = _unported()[name]
    with pytest.raises(NotImplementedError):
        fn(tmp_path) if name == "config.non_pinhole" else fn()


@pytest.mark.parametrize("where", ["engine", "system"])
@pytest.mark.parametrize("mode", ["estimate_extrinsic=2", "estimate_td"])
def test_online_calibration_modes_construct_and_fill(mode, where):
    """Online calibration is ported: the VioEngine, or a SlamSystem passing
    the flag through, constructs on the CPU in each mode and takes two fill
    frames (the second runs the calibration's frame pair)."""
    cfg = twin.WindowConfig(window=2, max_points=8, max_lines=2, max_imu=4)
    kw = (dict(q_ic=None, p_ic=None) if mode == "estimate_extrinsic=2"
          else dict(q_ic=np.array([1.0, 0, 0, 0]), p_ic=np.zeros(3), estimate_td=True))
    if where == "engine":
        eng = tvio.VioEngine(cfg, device=CPU, **kw)
    else:
        cam = tcam.pinhole(100.0, 100.0, 8.0, 6.0, width=16, height=12, device=CPU)
        eng = tsys.SlamSystem(cam, cfg, tft.TrackerConfig(max_features=4),
                              use_loop_closure=False, device=CPU, **kw).vio
    assert (eng.estimate_extrinsic, eng.estimate_td) == (
        (2, False) if mode == "estimate_extrinsic=2" else (1, True))
    rng = np.random.default_rng(0)
    ids = np.r_[np.arange(6), -1, -1]
    for k in range(2):
        for i in range(5):
            eng.add_imu(0.1 * k + 0.02 * i, np.array([0.0, 0.0, 9.81]), np.array([0.0, 0.0, 0.1]))
        rays = np.c_[rng.uniform(-0.3, 0.3, (8, 2)), np.ones(8)]
        assert eng.add_frame(0.1 * k, ids, rays) is None
    assert eng.frame_count == 2 and eng.calibrating()
    if mode == "estimate_td":
        assert int(eng._td_acc.n_cam) == 1 and int(eng._td_acc.n_imu) > 0
