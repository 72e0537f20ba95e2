"""The cases K11 (the window linearization, ``csrc/window_lin.cu``) and K12
(the block normal equations, ``csrc/window_blocks.cu``) must reproduce,
pinned on the CPU at the EuRoC window's size (nd 177 = 15 x 11 frames + 12,
128 point slots, 32 line slots): the port's plain twins, which the kernels
are held against on the card, against the JAX reference at x64.

K12: ``assemble_blocks_plain`` on seeded random compact blocks against the
reference's ``_assemble_blocks`` on the same blocks scattered to the dense
[R, nd] linearization by numpy, in every layout the kernel's split over
slot chunks and node pairs must reproduce: the lines layout with random
anchors, every point anchored at frame 0 (the imbalanced case: one frame's
tiles carry every observation), 40 empty point and 10 empty line slots (zero
rows), relo rows off, lines without VP rows, the marginalization stack's
layout (``layout_for(cfg, True, use_relo=False, use_vps=False)``) and the
points layout.  Tolerance 1e-12 of each block's largest entry (measured up
to 4e-16): both sides are f64 sums of the same products in another order
(torch's and XLA's matmul and einsum).

K11: ``window_blocks_plain`` (vmap of jvp of the port's
``window_residuals``) and ``window_cost_residuals`` on a seeded numpy window
with every family live (a dense prior, relo rows, 28 of 32 lines with VP
rows), with one non-finite observation (its rows zero, as the reference's
``where``) and outliers whose rows the Huber weight scales, against the
reference's ``_structured_linearize`` of its ``window_residuals``: the
blocks scattered back to dense equal the reference's rows of the port's
layout, and the cost pass's rows equal the reference's ``window_residuals``.
Tolerance 1e-12 of each family's largest entry (measured up to 1.2e-14):
the same f64 arithmetic in another order.  The line and VP rows' values
(not their Jacobians) are held at 1e-10 (measured 5.2e-11): they are
differences of terms whitened by 1500 (line) and 10 (VP) that cancel to
~0.5, since the observations lie on the projected lines, and XLA's and
torch's sin, cos and atan2 differ in the last bit, so the values move by
~1e-13 x 1500 of the row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.estimator import window as jwin
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu.solver import lm as jlm
from vplines_slam_tpu.solver import marginalization as jmarg
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator import linearize as tlin
from vplines_slam_tpu_torch.estimator import window as twin
from vplines_slam_tpu_torch.solver import lm as tlm

torch.set_num_threads(2)

CFG = twin.WindowConfig()
JCFG = jwin.WindowConfig()
NF, ND, P, L = CFG.nf, CFG.nd, CFG.max_points, CFG.max_lines
TOL = 1e-12
TOL_LINE_VALUES = 1e-10


# ---------------------------------------------------------------------------
# numpy geometry (Hamilton [w, x, y, z], as both packages)
# ---------------------------------------------------------------------------


def qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def q2rot(q):
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def small_quat(rng, scale):
    q = np.concatenate([[1.0], rng.normal(scale=scale, size=3)])
    return q / np.linalg.norm(q)


def euler_zyx(t):
    s1, c1, s2, c2, s3, c3 = (np.sin(t[0]), np.cos(t[0]), np.sin(t[1]), np.cos(t[1]),
                              np.sin(t[2]), np.cos(t[2]))
    return np.array([[c2 * c3, s1 * s2 * c3 - c1 * s3, c1 * s2 * c3 + s1 * s3],
                     [c2 * s3, s1 * s2 * s3 + c1 * c3, c1 * s2 * s3 - s1 * c3],
                     [-s2, s1 * c2, c1 * c2]])


def to_frame(n, v, p, q):
    """A line (n, v) into the frame of pose (p, q)."""
    R = q2rot(q)
    vc = R.T @ v
    return R.T @ n + np.cross(-R.T @ p, vc), vc


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


def numpy_window(seed):
    """(state, data, params) as the reference's NamedTuples with numpy f64
    leaves: 11 frames along a gentle arc, every point and line slot filled
    from a seeded world and observed with noise, a dense whitened prior,
    random IMU preintegrations, relo rows against a pose near frame 1; one
    point observation non-finite and a few far off (Huber-active)."""
    rng = np.random.default_rng(seed)
    p = np.stack([[0.1 * k, 0.05 * np.sin(0.5 * k), 0.02 * k] for k in range(NF)])
    q = np.stack([small_quat(rng, 0.02) for _ in range(NF)])
    v = rng.normal(scale=0.3, size=(NF, 3))
    ba, bg = rng.normal(scale=0.02, size=(NF, 3)), rng.normal(scale=0.002, size=(NF, 3))
    p_ic, q_ic = np.array([0.02, -0.01, 0.03]), small_quat(rng, 0.01)
    p_relo, q_relo = p[1] + 0.02, qmul(q[1], small_quat(rng, 0.005))
    state = jwin.WindowState(p, q, v, ba, bg, p_ic, q_ic, p_relo, q_relo)
    R_ic = q2rot(q_ic)

    def cam_of(pw, pk, qk):
        return R_ic.T @ (q2rot(qk).T @ (pw - pk) - p_ic)

    # points: anchor ray and depth -> world point -> rays in every frame
    start = rng.integers(0, NF - 2, P)
    inv_depth = 1.0 / rng.uniform(2.0, 8.0, P)
    obs = np.zeros((P, NF, 3))
    mask = rng.random((P, NF)) < 0.85
    for s in range(P):
        i = start[s]
        ray = np.array([*rng.uniform(-0.5, 0.5, 2), 1.0])
        pw = q2rot(q[i]) @ (R_ic @ (ray / inv_depth[s]) + p_ic) + p[i]
        for j in range(NF):
            pc = cam_of(pw, p[j], q[j])
            obs[s, j] = pc / pc[2] + np.array([*rng.normal(scale=1.5e-3, size=2), 0.0])
        obs[s, i] = ray
        mask[s, i] = True
        mask[s] &= np.array([cam_of(pw, p[j], q[j])[2] > 0.3 for j in range(NF)])
    relo_obs = obs[:, 1] + np.array([0.004, -0.003, 0.0])
    relo_mask = rng.random(P) < 0.7
    # a non-finite observation and outliers (whitened error of ~5-15: Huber on)
    obs[7, 5] = [np.nan, 0.1, 1.0]
    mask[7, 5] = True
    for s in (3, 11, 40):
        j = (start[s] + 2) % NF
        obs[s, j, :2] += 0.03
        mask[s, j] = True
    # lines: orth -> Plücker in each camera -> endpoints on the projected line
    orth = np.column_stack([rng.uniform(-1.2, 1.2, (L, 3)), rng.uniform(0.3, 1.2, L)])
    ln_obs, ln_vp = np.zeros((L, NF, 4)), np.zeros((L, NF, 3))
    for l in range(L):
        U = euler_zyx(orth[l, :3])
        n_w, v_w = np.cos(orth[l, 3]) * U[:, 0], np.sin(orth[l, 3]) * U[:, 1]
        for j in range(NF):
            nb, vb = to_frame(n_w, v_w, p[j], q[j])
            nc, vc = to_frame(nb, vb, p_ic, q_ic)
            xs = np.array([-0.3, 0.3])
            ys = -(nc[0] * xs + nc[2]) / nc[1]
            ln_obs[l, j] = [xs[0], ys[0], xs[1], ys[1]] + rng.normal(scale=1e-4, size=4)
            ln_vp[l, j] = vc / vc[2] + np.array([*rng.normal(scale=1e-2, size=2), 0.0])
    ln_mask = rng.random((L, NF)) < 0.8
    ln_vp_mask = (rng.random((L, NF)) < 0.7) & (np.arange(L) < L - 4)[:, None]
    # IMU intervals, the dense prior
    pre = jimu.Preintegration(
        delta_p=rng.normal(scale=0.05, size=(NF - 1, 3)),
        delta_q=np.stack([small_quat(rng, 0.02) for _ in range(NF - 1)]),
        delta_v=rng.normal(scale=0.1, size=(NF - 1, 3)),
        jacobian=np.eye(15) + rng.normal(scale=0.05, size=(NF - 1, 15, 15)),
        covariance=np.broadcast_to(np.eye(15), (NF - 1, 15, 15)).copy(),
        sum_dt=np.full(NF - 1, 0.1), linearized_ba=ba[:-1] + 0.01, linearized_bg=bg[:-1] - 0.001)
    imu_sqrt = np.triu(rng.normal(scale=3.0, size=(NF - 1, 15, 15))) + 20.0 * np.eye(15)
    prior = jmarg.Prior(J=rng.normal(size=(ND, ND)) * 10.0 ** rng.uniform(-1, 2.5, ND),
                        r0=rng.normal(size=ND), valid=np.asarray(True))
    ps = state._replace(p=p + rng.normal(scale=1e-3, size=p.shape),
                        q=np.stack([qmul(qq, small_quat(rng, 1e-3)) for qq in q]))
    data = jwin.TrackData(
        pt_id=np.arange(P, dtype=np.int32), pt_obs=obs, pt_mask=mask,
        pt_start=start.astype(np.int32), pt_inv_depth=inv_depth, pt_solved=np.ones(P, bool),
        ln_id=np.arange(L, dtype=np.int32), ln_obs=ln_obs, ln_mask=ln_mask, ln_vp=ln_vp,
        ln_vp_mask=ln_vp_mask, ln_orth=orth, ln_solved=np.ones(L, bool),
        imu_dt=np.zeros((NF - 1, 4)), imu_acc=np.zeros((NF - 1, 5, 3)),
        imu_gyr=np.zeros((NF - 1, 5, 3)), imu_mask=np.zeros((NF - 1, 4), bool),
        imu_valid=np.ones(NF - 1, bool), imu_pre=pre, imu_sqrt=imu_sqrt, relo_obs=relo_obs,
        relo_mask=relo_mask, relo_valid=np.asarray(True), frame_t=np.arange(NF) * 0.1,
        relo_stamp=np.asarray(0.1), prior=prior, prior_state=ps)
    return state, data, jimu.default_params(jnp.float64)


# the port's layouts: (use_lines, use_relo, use_vps)
K11_LAYOUTS = {"lines": (True, True, True), "no_relo": (True, False, True),
               "no_vps": (True, True, False), "marg": (True, False, False),
               "points": (False, True, True)}


@pytest.fixture(scope="module")
def window():
    """The numpy window in both packages and the reference's linearization
    of its whole stack (every family; each port layout's rows are a subset)."""
    state, data, params = numpy_window(0)
    js, jd, jp = (jax.tree_util.tree_map(jnp.asarray, t) for t in (state, data, params))
    lay = jlm.WindowLayout(nd=ND, nf=NF, P=P, L=L)
    x = (js, jd.pt_inv_depth, jd.ln_orth)
    lin = jax.jit(lambda x, d: jlm._structured_linearize(
        lambda xx: jwin.window_residuals(xx, d, JCFG, jp),
        lambda xx, dd: jwin.retract_all(xx, dd, JCFG), x, lay))(x, jd)
    cost = jax.jit(lambda x, d: jwin.window_residuals(x, d, JCFG, jp))(x, jd)
    to_t = lambda t: convert.to_torch(t, device="cpu")
    return dict(lay=lay, lin=[np.asarray(a) for a in lin], cost=np.asarray(cost),
                ts=to_t(state), td=to_t(data), tp=to_t(params))


def port_rows(lay_j, lines, relo, vps):
    """The port layout's rows in the reference's whole stack."""
    sl = lay_j.slices()
    segs = (("prior", "imu", "points") + (("lines",) if lines else ())
            + (("vps",) if lines and vps else ()) + (("relo",) if relo else ()))
    return np.concatenate([np.arange(sl[k].start, sl[k].stop) for k in segs])


def close_per_block(ref, got, what, tol=TOL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, what
    den = np.abs(ref).max()
    err = np.abs(got - ref).max() / den if den > 0 else np.abs(got).max()
    assert err <= tol, f"{what}: max |port - JAX| / max |JAX| = {err:.3e} (tol {tol})"


@pytest.mark.parametrize("name", list(K11_LAYOUTS))
def test_k11_twin_matches_the_reference(window, name):
    lines, relo, vps = K11_LAYOUTS[name]
    W = window
    x = (W["ts"], W["td"].pt_inv_depth) + ((W["td"].ln_orth,) if lines else ())
    b = tlin.window_blocks_plain(x, W["td"], CFG, W["tp"], use_relo=relo, use_vps=vps)
    lay = twin.layout_for(CFG, lines, relo, vps)
    dense = tlm.blocks_to_dense(b, lay)
    rows = port_rows(W["lay"], lines, relo, vps)
    r0, J_d, col_p, cols_l = (a[rows] for a in W["lin"])
    sl = lay.slices()
    tol_r = lambda seg: TOL_LINE_VALUES if seg in ("lines", "vps") else TOL
    for seg, _ in lay.segments():  # each family against its own scale
        s = sl[seg]
        close_per_block(r0[s], dense[0][s], f"r ({seg})", tol_r(seg))
        close_per_block(J_d[s], dense[1][s], f"J_d ({seg})")
        if seg in ("points", "relo"):
            close_per_block(col_p[s], dense[2][s], f"col_p ({seg})")
        if lines and seg in ("lines", "vps"):
            close_per_block(cols_l[s], dense[3][s], f"cols_l ({seg})")
    cost = tlin.window_cost_residuals(x, W["td"], CFG, W["tp"], use_relo=relo, use_vps=vps)
    for seg, _ in lay.segments():
        close_per_block(W["cost"][rows][sl[seg]], cost[sl[seg]], f"cost rows ({seg})",
                        tol_r(seg))


def test_k11_window_has_the_cases(window):
    """The non-finite observation's rows are zero (the port's twin matches
    them above), the outliers' rows are Huber-weighted (their whitened
    norm beyond delta = 1, scaled to sqrt(delta |r|)) and every family of the
    whole stack is live."""
    r0 = window["lin"][0]
    sl = window["lay"].slices()
    pts = r0[sl["points"]].reshape(P, NF, 2)
    assert (pts[7, 5] == 0).all()
    start = np.asarray(window["td"].pt_start)
    for s in (3, 11, 40):
        assert 1.0 < np.linalg.norm(pts[s, (start[s] + 2) % NF]) < 10.0
    for seg in ("prior", "imu", "points", "lines", "vps", "relo"):
        assert np.abs(window["lin"][1][sl[seg]]).max() > 0, seg
    assert np.isfinite(window["lin"][1]).all()


# ---------------------------------------------------------------------------
# K12: random compact blocks in each layout
# ---------------------------------------------------------------------------

# (use_lines, use_relo, use_vps, anchors, empty point slots, empty line slots)
K12_CASES = {
    "lines": (True, True, True, "random", 0, 0),
    "one_anchor": (True, True, True, "zero", 0, 0),
    "empty_slots": (True, True, True, "random", 40, 10),
    "no_relo": (True, False, True, "random", 0, 0),
    "no_vps": (True, True, False, "random", 0, 0),
    "marg": (True, False, False, "random", 0, 0),
    "points": (False, True, True, "random", 0, 0),
}


def random_blocks(seed, lines, relo, vps, anchors, empty_p, empty_l):
    """Compact blocks as K11 writes them (numpy f64): column scales over
    five decades, the anchor frame's own observation zero (K11 zeroes
    j == i), empty slots' rows zero."""
    rng = np.random.default_rng(seed)
    lay = twin.layout_for(CFG, lines, relo, vps)
    sl = lay.slices()
    start = np.zeros(P, np.int64) if anchors == "zero" else rng.integers(0, NF - 2, P)
    g = lambda *s: rng.normal(size=s) * 10.0 ** rng.uniform(-2, 3, s[-1])
    J_pt = g(P, NF, 2, 19)
    J_pt[np.arange(P), start] = 0.0
    J_pt[P - empty_p:] = 0.0
    J_relo = g(P, 2, 19) if relo else None
    if relo:
        J_relo[P - empty_p:] = 0.0
    J_ln = J_vp = None
    if lines:
        J_ln = g(L, NF, 2, 16)
        J_ln[L - empty_l:] = 0.0
        if vps:
            J_vp = g(L, NF, 2, 16) * (rng.random((L, NF, 1, 1)) < 0.7)
            J_vp[L - empty_l:] = 0.0
    return lay, sl, dict(r=rng.normal(size=sl["_total"]), J_prior=g(ND, ND),
                         J_imu=g(NF - 1, 15, 30), J_pt=J_pt, J_relo=J_relo, J_ln=J_ln,
                         J_vp=J_vp, pt_start=start)


def numpy_dense(lay, sl, B):
    """The blocks scattered to (r0, J_d [R, nd], col_p [R], cols_l [R, 4])
    by the compact columns' meaning (WindowBlocks)."""
    R = sl["_total"]
    J_d, col_p, cols_l = np.zeros((R, ND)), np.zeros(R), np.zeros((R, 4))
    J_d[:ND] = B["J_prior"]
    a6, ext, rel = np.arange(6), 15 * NF + np.arange(6), 15 * NF + 6 + np.arange(6)
    for k in range(NF - 1):
        J_d[sl["imu"].start + 15 * k:sl["imu"].start + 15 * k + 15, 15 * k:15 * k + 30] += \
            B["J_imu"][k]
    for s in range(P):
        i = B["pt_start"][s]
        for j in range(NF):
            for c in range(2):
                row, blk = sl["points"].start + 2 * (s * NF + j) + c, B["J_pt"][s, j, c]
                np.add.at(J_d[row], np.concatenate([15 * i + a6, 15 * j + a6, ext]), blk[:18])
                col_p[row] = blk[18]
        if lay.has_relo:
            for c in range(2):
                row, blk = sl["relo"].start + 2 * s + c, B["J_relo"][s, c]
                J_d[row, np.concatenate([15 * i + a6, rel, ext])] += blk[:18]
                col_p[row] = blk[18]
    for fam, key in (("lines", "J_ln"), ("vps", "J_vp")):
        if fam not in sl:
            continue
        for l in range(L):
            for j in range(NF):
                for c in range(2):
                    row, blk = sl[fam].start + 2 * (l * NF + j) + c, B[key][l, j, c]
                    J_d[row, np.concatenate([15 * j + a6, ext])] += blk[:12]
                    cols_l[row] = blk[12:]
    return B["r"], J_d, col_p, cols_l


@pytest.mark.parametrize("name", list(K12_CASES))
def test_k12_twin_matches_the_reference(name):
    lines, relo, vps, anchors, empty_p, empty_l = K12_CASES[name]
    lay, sl, B = random_blocks(len(name), lines, relo, vps, anchors, empty_p, empty_l)
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    blocks = tlm.WindowBlocks(r=t(B["r"]), J_prior=t(B["J_prior"]), J_imu=t(B["J_imu"]),
                              J_pt=t(B["J_pt"]), J_relo=t(B["J_relo"]), J_ln=t(B["J_ln"]),
                              J_vp=t(B["J_vp"]), pt_start=t(B["pt_start"]))
    ne = tlm.assemble_blocks_plain(blocks, lay)
    lay_j = jlm.WindowLayout(nd=ND, nf=NF, P=P, L=L if lines else 0, has_lines=lines,
                             has_vps=lines and vps, has_relo=relo)
    ref = jax.jit(jlm._assemble_blocks, static_argnums=4)(
        *map(jnp.asarray, numpy_dense(lay, sl, B)), lay_j)
    ref = ref if lines else ref[:5]
    assert len(ne) == len(ref)
    names = ["H_dd", "g_d", "H_dp", "h_p", "g_p", "H_dl", "Hll_b", "g_l"]
    for nm, a, b in zip(names, ref, ne):
        assert b.dtype == torch.float64
        close_per_block(a, b, f"{name}: {nm}")
    if empty_p:
        assert (ne[3][P - empty_p:] == 0).all() and (ne[2][:, P - empty_p:] == 0).all()
