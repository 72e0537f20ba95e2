"""Parity of online self-calibration with the JAX reference: the hand-eye
extrinsic rotation, the gyro yaw curve, the time-offset ICP
(``models/calibration``), the accumulators, their solves and the frame-pair
rotation (``estimator/online_calib``) (torch f64 on the CPU against JAX x64;
the plain twins of K22-K24).  The stream and helpers of the engine tests
(``test_torch_calib_cases``, ``test_torch_calib_td_engine``) live here too.

Also pinned: the time-offset curves stay f64 at an f32 engine (at
EuRoC-epoch stamps the reference's f32 curves lose td; the port's recover
it), and a zero residual makes the time-offset step NaN in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.estimator import online_calib as joc
from vplines_slam_tpu.models import calibration as jcal
from vplines_slam_tpu.utils import geometry as jgeo
from vplines_slam_tpu.utils import synthetic as jsyn
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator import online_calib as toc
from vplines_slam_tpu_torch.estimator.vio import VioEngine
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.models import calibration as tcal
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(1)

CPU = torch.device("cpu")
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
Q_IC = np.asarray(jgeo.rot_to_quat(jnp.asarray(R_BC)))
P_IC = np.array([0.05, 0.02, 0.03])
T0 = 1403636579.763555  # a EuRoC-epoch stamp


def T(a):
    return torch.as_tensor(np.array(a))


def close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out), atol=atol, rtol=rtol)


def imu_samples(traj, t):
    """jsyn.imu_samples under jit (its eager ops take seconds)."""
    return [np.asarray(a) for a in jax.jit(lambda t: jsyn.imu_samples(traj, t))(jnp.asarray(t))]


def acc_close(jacc, tacc, atol=1e-12):
    """Every field of a reference accumulator against the port's: integers
    and flags exactly, floats within atol."""
    for f in jacc._fields:
        a, b = np.asarray(getattr(jacc, f)), np.asarray(getattr(tacc, f))
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b), f
        else:
            close(a, b, atol=atol)


# ---------------------------------------------------------------------------
# models/calibration
# ---------------------------------------------------------------------------


def test_quat_left_right_match_jax():
    q = np.random.default_rng(0).standard_normal((5, 4))
    close(jgeo.quat_left(jnp.asarray(q)), tgeo.quat_left(T(q)), atol=0)
    close(jgeo.quat_right(jnp.asarray(q)), tgeo.quat_right(T(q)), atol=0)
    p = np.random.default_rng(1).standard_normal(4)
    qp = jgeo.quat_mul(jnp.asarray(q), jnp.asarray(p))
    close(qp, tgeo.quat_left(T(q)) @ T(p), atol=1e-15)
    close(qp, (tgeo.quat_right(T(p)) @ T(q)[..., None])[..., 0], atol=1e-15)


def hand_eye_pairs(K=30, noise=0.0, seed=1, scale=0.2):
    """test_calibration_selector.py's hand-eye set: body rotations of `scale`
    rad and their camera rotations q_ic⁻¹ q_i q_ic, optionally perturbed (so
    the 5° robust weights engage)."""
    rng = np.random.default_rng(seed)
    q_ic = jgeo.so3_exp_quat(jnp.asarray([0.1, -0.2, 1.5]))
    q_i = jgeo.so3_exp_quat(jnp.asarray(rng.standard_normal((K, 3)) * scale))
    q_c = jgeo.quat_mul(jgeo.quat_conj(q_ic), jgeo.quat_mul(q_i, q_ic))
    if noise:
        q_c = jgeo.quat_mul(q_c, jgeo.so3_exp_quat(jnp.asarray(rng.standard_normal((K, 3))
                                                               * noise)))
    return np.asarray(q_c), np.asarray(q_i), np.asarray(q_ic)


def _hand_eye_case(name):
    if name == "exact 30":
        qc, qi, _ = hand_eye_pairs()
        return qc, qi, np.ones(30, bool)
    if name == "noisy 30, robust weights":
        qc, qi, _ = hand_eye_pairs(noise=0.15, seed=2)
        return qc, qi, np.ones(30, bool)
    if name == "padded 64 slots":
        qc, qi, _ = hand_eye_pairs(K=20, seed=3)
        pad = np.zeros((44, 4))
        pad[:, 0] = 1.0
        v = np.r_[np.ones(20, bool), np.zeros(44, bool)]
        v[4] = False
        return np.r_[qc, pad], np.r_[qi, pad], v
    if name == "few small rotations":  # σ₃ below the gate
        qc, qi, _ = hand_eye_pairs(K=3, seed=4, scale=0.01)
        return qc, qi, np.ones(3, bool)
    raise KeyError(name)


HAND_EYE_CASES = ["exact 30", "noisy 30, robust weights", "padded 64 slots",
                  "few small rotations"]


@pytest.mark.parametrize("name", HAND_EYE_CASES)
def test_calibrate_extrinsic_rotation_matches_jax(name):
    """q within 1e-10 (up to the sign the q0 >= 0 rule fixes), σ₃ within
    1e-12, the gate exactly."""
    qc, qi, v = _hand_eye_case(name)
    jq, jconv, js = jax.jit(jcal.calibrate_extrinsic_rotation)(jnp.asarray(qc), jnp.asarray(qi),
                                                               jnp.asarray(v))
    tq, tconv, ts = tcal.calibrate_extrinsic_rotation(T(qc), T(qi), T(v))
    close(jq, tq, atol=1e-10)
    close(js, ts, atol=1e-12)
    assert bool(jconv) == bool(tconv)
    if name == "exact 30":
        _, _, q_ic = hand_eye_pairs()
        assert abs(float(tgeo.quat_mul(tgeo.quat_conj(tq), T(q_ic))[0])) > 1 - 1e-8
    if name == "few small rotations":
        assert not bool(tconv)


def test_integrate_gyro_yaw_matches_jax():
    """The figure-8's gyro over 2 s (400 samples), from identity and from a
    tilted q0: the yaws within 1e-12."""
    ts = np.linspace(0.0, 2.0, 400)
    _, gyrs = imu_samples(jsyn.figure8_trajectory(), ts)
    integrate = jax.jit(jcal.integrate_gyro_yaw)
    close(integrate(ts, gyrs), tcal.integrate_gyro_yaw(T(ts), T(gyrs)), atol=1e-12)
    q0 = np.asarray(jgeo.so3_exp_quat(jnp.asarray([0.3, -0.2, 2.9])))
    close(integrate(ts, gyrs, q0), tcal.integrate_gyro_yaw(T(ts), T(gyrs), T(q0)), atol=1e-12)


def time_offset_curves(td_true=0.035):
    """test_calibration_selector.py's curves: the camera sees the IMU yaw at
    t_cam + td_true."""
    t_imu = np.linspace(0.0, 7.0, 700)
    yaw = 0.5 * np.sin(1.3 * t_imu) + 0.2 * t_imu
    t_cam = np.linspace(0.3, 6.5, 40)
    yaw_cam = 0.5 * np.sin(1.3 * (t_cam + td_true)) + 0.2 * (t_cam + td_true)
    return t_cam, yaw_cam, t_imu, yaw


@pytest.mark.parametrize("td_init", [0.0, 0.02])
def test_calibrate_time_offset_matches_jax(td_init):
    """td and the RMS within 1e-12, with one masked sample."""
    t_cam, yaw_cam, t_imu, yaw = time_offset_curves()
    valid = np.ones(40, bool)
    valid[7] = False
    jtd, jrms = jcal.calibrate_time_offset(*map(jnp.asarray, (t_cam, yaw_cam, valid, t_imu, yaw)),
                                           td_init=td_init)
    ttd, trms = tcal.calibrate_time_offset(*map(T, (t_cam, yaw_cam, valid, t_imu, yaw)),
                                           td_init=td_init)
    close(jtd, ttd, atol=1e-12)
    close(jrms, trms, atol=1e-12)
    assert abs(float(ttd) - 0.035) < 0.004 and float(trms) < 1e-3


# ---------------------------------------------------------------------------
# estimator/online_calib: accumulators and solves
# ---------------------------------------------------------------------------


def test_push_rotation_pair_through_the_ring():
    """A 4-slot ring over 7 pushes, two of them not ok: slots, flags and the
    count exactly."""
    qc, qi, _ = hand_eye_pairs(K=7, seed=5)
    oks = [True, True, False, True, True, False, True]
    jacc = joc.empty_extrinsic_calib(capacity=4)
    tacc = toc.empty_extrinsic_calib(capacity=4, device=CPU)
    push = jax.jit(joc.push_rotation_pair)
    for k, ok in enumerate(oks):
        jacc = push(jacc, jnp.asarray(qc[k]), jnp.asarray(qi[k]),
                                      jnp.asarray(ok))
        tacc = toc.push_rotation_pair(tacc, T(qc[k]), T(qi[k]), torch.tensor(ok))
        acc_close(jacc, tacc, atol=0)
    jq, jconv, js = jax.jit(joc.solve_extrinsic, static_argnums=1)(jacc, 6)
    tq, tconv, ts = toc.solve_extrinsic(tacc, min_pairs=6)
    close(jq, tq, atol=1e-10)
    close(js, ts, atol=1e-12)
    assert bool(jconv) == bool(tconv)


def imu_batches(n_batches, I, seed, yaw_rate=0.0, t0=0.0):
    """IMU batches as VioEngine._pack_imu passes them: stamps [I + 1]
    (zero-padded past the live steps), gyros [I + 1, 3], a mask [I] with a
    prefix of live steps, and one batch with masked steps between live ones;
    yaw_rate adds a fast turn about z (the yaw crosses ±π)."""
    rng = np.random.default_rng(seed)
    out, t = [], t0
    for b in range(n_batches):
        live = I if b % 3 == 0 else int(rng.integers(1, I))
        ts = np.zeros(I + 1)
        ts[: live + 1] = t + np.cumsum(np.r_[0.0, rng.uniform(0.004, 0.006, live)])
        t = ts[live]
        gyrs = rng.standard_normal((I + 1, 3)) * 0.5
        gyrs[:, 2] += yaw_rate
        gyrs[live + 1:] = 0.0
        mask = np.arange(I) < live
        if b == 1:
            mask[::2] = False
        out.append((ts, gyrs, mask))
    return out


@pytest.mark.parametrize("case", ["fill", "yaw crossing pi", "capacity overflow"])
def test_push_imu_angles_matches_jax(case):
    """Several batches through push_imu_angles (the reference's jitted
    scatter resolves the clamped slot M - 1 last-write-wins): every field
    within 1e-12 after each batch."""
    I, M, rate, n = {"fill": (8, 64, 0.0, 5), "yaw crossing pi": (8, 64, 30.0, 5),
                     "capacity overflow": (6, 16, 2.0, 5)}[case]
    jacc = joc.empty_td_calib(cam_capacity=8, imu_capacity=M)
    tacc = toc.empty_td_calib(cam_capacity=8, imu_capacity=M, device=CPU)
    push = jax.jit(joc.push_imu_angles)
    for ts, gyrs, mask in imu_batches(n, I, seed=6, yaw_rate=rate, t0=T0):
        jacc = push(jacc, jnp.asarray(ts), jnp.asarray(gyrs), jnp.asarray(mask))
        tacc = toc.push_imu_angles(tacc, T(ts), T(gyrs), T(mask))
        acc_close(jacc, tacc, atol=1e-12)
    if case == "yaw crossing pi":
        assert float(tacc.ang_imu.abs().max()) > np.pi
    if case == "capacity overflow":
        assert int(tacc.n_imu) == M


def cam_pushes(n, seed, yaw_rate=0.0):
    """(t, dq_cam, ok, dq_imu) of n camera samples 0.1 s apart: body yaw
    steps of yaw_rate · 0.1 plus small tilts; every third pair fails."""
    rng = np.random.default_rng(seed)
    q_ic = np.asarray(jgeo.so3_exp_quat(jnp.asarray([0.05, -0.1, 1.2])))
    out = []
    for k in range(n):
        w = rng.standard_normal(3) * 0.05
        w[2] += yaw_rate * 0.1
        dq_b = jgeo.so3_exp_quat(jnp.asarray(w))
        dq_c = jgeo.quat_mul(jgeo.quat_conj(jnp.asarray(q_ic)), jgeo.quat_mul(dq_b, jnp.asarray(q_ic)))
        dq_imu = jgeo.so3_exp_quat(jnp.asarray(w + rng.standard_normal(3) * 1e-3))
        out.append((T0 + 0.1 * k, np.asarray(dq_c), k % 3 != 2, np.asarray(dq_imu)))
    return q_ic, out


@pytest.mark.parametrize("case", ["fill", "yaw crossing pi", "capacity overflow"])
def test_push_cam_angle_matches_jax(case):
    """Camera samples through push_cam_angle: every field within 1e-12 after
    each push (once full the last slot is rewritten)."""
    C, n, rate = {"fill": (16, 10, 0.0), "yaw crossing pi": (16, 10, 12.0),
                  "capacity overflow": (8, 11, 3.0)}[case]
    q_ic, pushes = cam_pushes(n, seed=7, yaw_rate=rate)
    jacc = joc.empty_td_calib(cam_capacity=C, imu_capacity=8)
    tacc = toc.empty_td_calib(cam_capacity=C, imu_capacity=8, device=CPU)
    push = jax.jit(joc.push_cam_angle)
    for t, dq_c, ok, dq_i in pushes:
        jacc = push(jacc, jnp.asarray(t), jnp.asarray(dq_c), jnp.asarray(q_ic),
                                  jnp.asarray(ok), jnp.asarray(dq_i))
        tacc = toc.push_cam_angle(tacc, t, T(dq_c), T(q_ic), torch.tensor(ok), T(dq_i))
        acc_close(jacc, tacc, atol=1e-12)
    if case == "yaw crossing pi":
        assert float(tacc.ang_cam.abs().max()) > np.pi


def td_accumulator(td_true=0.012, n_cam=40, n_imu=900, C=64, M=1024, t0=0.0):
    """A half-filled TimeOffsetCalib (numpy leaves, the reference's field
    order): camera samples at 10 Hz from t = 0.2 s seeing the yaw at t +
    td_true, IMU samples at 200 Hz from t = 0.05 s, every fifth camera
    sample invalid."""
    yaw = lambda t: 0.6 * np.sin(1.1 * t) + 0.15 * t
    t_imu = np.zeros(M)
    t_imu[:n_imu] = 0.05 + np.arange(n_imu) * 0.005
    a_imu = np.zeros(M)
    a_imu[:n_imu] = yaw(t_imu[:n_imu])
    t_cam = np.zeros(C)
    t_cam[:n_cam] = 0.2 + np.arange(n_cam) * 0.1
    a_cam = np.zeros(C)
    a_cam[:n_cam] = yaw(t_cam[:n_cam] + td_true) + 0.3  # another origin
    valid = np.zeros(C, bool)
    valid[:n_cam] = np.arange(n_cam) % 5 != 4
    t_cam[:n_cam] += t0
    t_imu[:n_imu] += t0
    return joc.TimeOffsetCalib(
        t_cam=t_cam, ang_cam=a_cam, cam_valid=valid, n_cam=np.int32(n_cam),
        q_cam_cum=np.array([1.0, 0, 0, 0]), t_imu=t_imu, ang_imu=a_imu, n_imu=np.int32(n_imu),
        q_imu_cum=np.array([1.0, 0, 0, 0]))


def test_solve_time_offset_half_filled_matches_jax():
    """Both curves filled part way (the IMU curve padded as 1e9 + m, flat at
    its last angle): td, the RMS and ok within 1e-12 / exactly, td
    recovered."""
    acc = td_accumulator()
    jtd, jrms, jok = jax.jit(joc.solve_time_offset)(acc)
    ttd, trms, tok = toc.solve_time_offset(convert.to_torch(acc, CPU))
    close(jtd, ttd, atol=1e-12)
    close(jrms, trms, atol=1e-12)
    assert bool(jok) == bool(tok) and bool(tok)
    assert abs(float(ttd) - 0.012) < 1e-3
    # below min_cam: not ok
    assert not bool(toc.solve_time_offset(convert.to_torch(acc, CPU), min_cam=41)[2])


def test_time_offset_step_is_nan_at_a_zero_residual():
    """A masked camera sample lying exactly on the IMU curve's segment: the
    distance's derivative is 0/0, so J, the step and td are NaN and ok is
    false, in the reference (jax.jacfwd of the norm) and the port alike."""
    acc = td_accumulator()
    # slot n_cam (unfilled, masked) sits on the IMU curve's first sample
    t_cam = acc.t_cam.copy()
    a_cam = acc.ang_cam.copy()
    t_cam[int(acc.n_cam)] = acc.t_imu[0]
    a_cam[int(acc.n_cam)] = acc.ang_imu[0]
    acc = acc._replace(t_cam=t_cam, ang_cam=a_cam)
    jtd, _, jok = jax.jit(joc.solve_time_offset)(acc)
    ttd, _, tok = toc.solve_time_offset(convert.to_torch(acc, CPU))
    assert np.isnan(float(jtd)) and np.isnan(float(ttd))
    assert not bool(jok) and not bool(tok)


def test_td_curves_stay_f64_at_an_f32_engine():
    """A deliberate divergence: the reference keeps the time-offset curves in
    the engine's dtype, and at f32 EuRoC-epoch stamps round to 128 s steps,
    so its solve loses td; the port keeps them f64 and recovers it."""
    acc = td_accumulator(t0=T0)
    j32 = joc.TimeOffsetCalib(*(jnp.asarray(x, jnp.float32)
                                if np.asarray(x).dtype == np.float64 else jnp.asarray(x)
                                for x in acc))
    jtd, _, jok = jax.jit(joc.solve_time_offset)(j32)
    assert not (bool(jok) and abs(float(jtd) - 0.012) < 2e-3)
    eng = VioEngine(WindowConfig(window=2, max_points=8, max_lines=2, max_imu=4),
                    timu.default_params(torch.float32, CPU), q_ic=Q_IC, p_ic=P_IC,
                    dtype=torch.float32, estimate_td=True, device=CPU)
    assert all(x.dtype == torch.float64 for x in eng._td_acc if x.is_floating_point())
    ttd, _, tok = toc.solve_time_offset(convert.to_torch(acc, CPU))
    assert bool(tok) and abs(float(ttd) - 0.012) < 1e-3


# ---------------------------------------------------------------------------
# pair_rotation
# ---------------------------------------------------------------------------


def test_pair_rotation_matches_jax():
    """Two views of 60 points (8 of them untracked) with the JAX key's RANSAC
    draws given to the port: q_rel within 1e-9, ok exactly."""
    rng = np.random.default_rng(8)
    P = 64
    X = np.c_[rng.uniform(-1.5, 1.5, (P, 2)), rng.uniform(3.0, 7.0, P)]
    R = np.asarray(jgeo.so3_exp_matrix(jnp.asarray([0.02, -0.05, 0.03])))
    t = np.array([0.3, 0.05, 0.02])
    Xj = X @ R.T + t
    obs_i = np.c_[X[:, :2] / X[:, 2:], np.ones(P)]
    obs_j = np.c_[Xj[:, :2] / Xj[:, 2:], np.ones(P)]
    m_i = np.ones(P, bool)
    m_j = np.arange(P) < 60
    ids = np.where(np.arange(P) % 9 == 8, -1, np.arange(P))
    key = jax.random.PRNGKey(3)
    draws = np.asarray(jax.random.randint(key, (64, 8), 0, P))
    jq, jok = jax.jit(joc.pair_rotation)(*map(jnp.asarray, (obs_i, obs_j, m_i, m_j, ids)), key)
    tq, tok = toc.pair_rotation(*map(T, (obs_i, obs_j, m_i, m_j, ids)), T(draws).long())
    close(jq, tq, atol=1e-9)
    assert bool(jok) == bool(tok) and bool(tok)
    # the rotation of frame j in frame i is R^T
    close(jgeo.rot_to_quat(jnp.asarray(R.T)), tq, atol=1e-9)


# ---------------------------------------------------------------------------
# the engine tests' stream (test_torch_calib_cases, test_torch_calib_td_engine)
# ---------------------------------------------------------------------------

WKW = dict(window=5, max_points=40, max_lines=2, max_imu=24)


def jax_draws(seed, shape, high):
    """The draws of successive ``key, k = split(key)`` calls from
    PRNGKey(seed): ``randint(k, shape, 0, high)``."""
    state = dict(key=jax.random.PRNGKey(seed))

    def draw():
        state["key"], k = jax.random.split(state["key"])
        return torch.as_tensor(np.array(jax.random.randint(k, shape, 0, high))).long()

    return draw


def calib_stream(duration, shift=0.0, n_landmarks=300, M=40):
    """test_online_calib_wiring.drive's noise-free stream at 10 Hz: ids and
    rays of the first M - 8 landmarks each frame sees, 200 Hz IMU whose
    samples carrying the motion of true time tau are stamped tau + shift."""
    traj = jsyn.figure8_trajectory()
    X = np.asarray(jsyn.scatter_landmarks(n_landmarks, seed=0))
    frame_t = np.arange(0.0, duration, 0.1)
    imu_true = np.arange(-shift if shift < 0 else 0.0, duration + 1e-9, 0.005)
    accs, gyrs = imu_samples(traj, imu_true)
    q_wb = np.asarray(jax.vmap(traj.quat)(jnp.asarray(frame_t)))
    p_wb = np.asarray(jax.vmap(traj.pos)(jnp.asarray(frame_t)))
    R_wc = np.asarray(jax.vmap(jgeo.quat_to_rot)(jnp.asarray(q_wb))) @ R_BC
    p_wc = p_wb + np.einsum("fij,j->fi", np.asarray(jax.vmap(jgeo.quat_to_rot)(
        jnp.asarray(q_wb))), P_IC)
    frames = []
    for k in range(len(frame_t)):
        Xc = (X - p_wc[k]) @ R_wc[k]
        uv = Xc[:, :2] / Xc[:, 2:3]
        vis = (Xc[:, 2] > 0.3) & (np.abs(uv[:, 0]) < 0.82) & (np.abs(uv[:, 1]) < 0.55)
        sel = np.flatnonzero(vis)[: M - 8]
        ids = np.full(M, -1, np.int64)
        rays = np.zeros((M, 3))
        rays[:, 2] = 1.0
        ids[: len(sel)] = sel
        rays[: len(sel), :2] = uv[sel]
        frames.append((ids, rays))
    return frame_t, imu_true + shift, accs, gyrs, frames


def feed(engines, frame_t, imu_t, accs, gyrs, frames, k, state, lead):
    """IMU up to frame k's stamp + lead (the IMU runs ahead once td != 0),
    then frame k, into every engine."""
    while state["i"] < len(imu_t) and imu_t[state["i"]] <= frame_t[k] + lead + 1e-9:
        for e in engines:
            e.add_imu(imu_t[state["i"]], accs[state["i"]], gyrs[state["i"]])
        state["i"] += 1
    return [e.add_frame(frame_t[k], *frames[k]) for e in engines]
