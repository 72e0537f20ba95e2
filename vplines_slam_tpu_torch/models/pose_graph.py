"""Loop closure and the 4-DoF pose graph.

Port of ``vplines_slam_tpu/models/pose_graph.py``: ``PoseGraphConfig``,
``KeyframeDB``, ``empty_db``, ``extract_keyframe_features``,
``add_keyframe``, ``retrieve_candidates``, ``LoopResult``, ``verify_loop``,
``record_loop``, ``optimize_4dof``, ``rebase_sequence``, ``grow_db``,
``save_db``/``load_db`` and ``drift_correction``.

- keyframe features: FAST + BRIEF (``ops/brief``, kernels K15-K16) at 500
  corners and at the tracked window points, snapped to a FAST corner within
  3 px;
- place retrieval: the cosine of mean-centred SimHash signatures (K17's
  signature mode) against the database, top-``top_k`` outside the recency
  zone, with the query's recent-neighbour floor;
- verification: Hamming matching with the margin and mutual gates (K17's
  match mode), PnP-RANSAC (K18), the inlier, yaw and translation gates;
- the 4-DoF pose graph: {yaw, t} per keyframe, sequential edges to
  ``seq_edges`` predecessors, loop edges and gauge rows, by LM.  K19
  (``csrc/pgo4.cu``) evaluates the residuals and reduces J^T J and -J^T r
  in f64 (its plain twin: ``torch.func.jacfwd`` of the residual); the dense
  4K x 4K solve is ``solver/lm.schur_solve`` (f64 Cholesky).

The database has fixed capacity (it doubles when full, from the caller's
host count), ``count`` is a device scalar and every reduction is masked, as
in the reference.  Descriptors are int32 bit patterns of the reference's
uint32 words; ``save_db`` writes them back as uint32, so a map saved by
either package loads in the other.  Random draws come in as arguments
(``verify_loop``'s ``sample_idx``).  The functions return new databases and
leave their arguments as they were.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from .. import kernels
from ..ops import brief as brief_mod
from ..ops import mvg
from ..solver import lm as lm_mod
from ..utils.geometry import (
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_rot,
    rot_to_quat,
    rot_to_ypr,
    ypr_to_rot,
)

_PGO_ARGS = kernels.args_struct(
    "VpPgoArgs",
    ["x", "p_vio", "ypr_vio", "p_pgo", "yaw_pgo", "loop_t", "loop_yaw", "seq", "loop_to",
     "count", "r", "J", "ei", "ej", "H", "g"],
    ["K", "E", "with_h"], ["lw"])
PGO4 = kernels.Kernel(
    "vp_pgo4", "vplines_slam_tpu_torch/csrc/pgo4.cu",
    "vplines_slam_tpu/models/pose_graph.py:322", [ctypes.POINTER(_PGO_ARGS)])


class PoseGraphConfig(NamedTuple):
    max_keyframes: int = 256  # initial capacity; the database doubles when full
    n_features: int = 256  # FAST + BRIEF per keyframe (the profile: 500)
    n_window_pts: int = 64  # tracked window points carried for PnP
    skip_recent: int = 50  # the recency exclusion zone
    min_score: float = 0.08  # absolute floor of the best candidate
    min_score_2: float = 0.024
    recent_ref: int = 10  # recent neighbours that set the query's floor
    rel_margin: float = 0.02  # eligible: within this of the best candidate
    max_backlog: int = 8  # staged jobs beyond this are dropped oldest-first
    top_k: int = 4
    min_matches: int = 20
    pnp_thresh: float = 8.0 / 460.0
    max_yaw: float = 30.0  # deg
    max_t: float = 20.0  # m
    seq_edges: int = 4
    pgo_iters: int = 6
    skip_cnt: int = 0  # insert every (skip_cnt + 1)-th VIO keyframe
    skip_dis: float = 0.0  # ... that moved at least this far (m)
    loop_edge_weight: float = 1.0


class KeyframeDB(NamedTuple):
    count: torch.Tensor  # [] int64
    seq: torch.Tensor  # [K] int64 sequence id (0 = loaded prior map, held fixed)
    p_vio: torch.Tensor  # [K, 3] VIO pose at insertion
    q_vio: torch.Tensor  # [K, 4]
    p_pgo: torch.Tensor  # [K, 3] optimized
    yaw_pgo: torch.Tensor  # [K] optimized yaw (deg)
    sig: torch.Tensor  # [K, SIG_DIM] float32 signatures
    desc: torch.Tensor  # [K, F, 8] int32 FAST + BRIEF
    kp_norm: torch.Tensor  # [K, F, 2] normalized coords of the FAST corners
    kp_valid: torch.Tensor  # [K, F]
    wdesc: torch.Tensor  # [K, Wp, 8] int32 descriptors at tracked window points
    w3d: torch.Tensor  # [K, Wp, 3] their world 3D (VIO frame)
    w_valid: torch.Tensor  # [K, Wp]
    loop_to: torch.Tensor  # [K] int64 loop target (-1)
    loop_t: torch.Tensor  # [K, 3] relative translation (in the old frame)
    loop_yaw: torch.Tensor  # [K] relative yaw (deg)


def empty_db(cfg: PoseGraphConfig, dtype=torch.float64, device=torch.device("cuda")):
    K, F, Wp = cfg.max_keyframes, cfg.n_features, cfg.n_window_pts
    z = lambda *s, dt=dtype: torch.zeros(*s, dtype=dt, device=device)
    q = z(K, 4)
    q[:, 0] = 1.0
    return KeyframeDB(
        count=torch.zeros((), dtype=torch.int64, device=device),
        # the live sequence is 1; seq 0 marks keyframes of a loaded prior map
        seq=torch.ones(K, dtype=torch.int64, device=device),
        p_vio=z(K, 3), q_vio=q, p_pgo=z(K, 3), yaw_pgo=z(K),
        sig=z(K, brief_mod.SIG_DIM, dt=torch.float32),
        desc=z(K, F, 8, dt=torch.int32), kp_norm=z(K, F, 2),
        kp_valid=z(K, F, dt=torch.bool), wdesc=z(K, Wp, 8, dt=torch.int32),
        w3d=z(K, Wp, 3), w_valid=z(K, Wp, dt=torch.bool),
        loop_to=torch.full((K,), -1, dtype=torch.int64, device=device),
        loop_t=z(K, 3), loop_yaw=z(K),
    )


def extract_keyframe_features(img, cam_lift, cfg: PoseGraphConfig, window_xy=None):
    """FAST + BRIEF on the keyframe image, and BRIEF at the tracked window
    points (each snapped to a FAST corner within 3 px, else kept: a KLT
    position drifts a few px, and a descriptor off the corner does not match
    the old keyframe's corner-centred one).  cam_lift: pixel -> normalized.
    Returns the feature block add_keyframe takes."""
    xy, valid = brief_mod.detect_fast(img, cfg.n_features)
    wdesc = None
    if window_xy is None:
        desc = brief_mod.describe_brief(img, xy, valid)
    else:
        wxy, wvalid = window_xy
        d2 = torch.sum((wxy[:, None, :] - xy[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(valid[None, :], d2, torch.full_like(d2, float("inf")))
        dmin, nn = torch.min(d2, dim=1)
        near = dmin < 9.0
        snapped = torch.where(near[:, None], xy[nn], wxy)
        # both sets in one K16 launch
        desc, wdesc = brief_mod.describe_brief_pair(img, xy, valid, snapped, wvalid)
    norm = cam_lift(xy)[..., 0:2]
    sig = brief_mod.global_signature(desc, valid, xy=xy, img_hw=tuple(img.shape))
    out = {"desc": desc, "kp_norm": norm, "kp_valid": valid, "sig": sig}
    if wdesc is not None:
        out["wdesc"] = wdesc
    return out


def _put(a, k, v):
    """a with row k replaced by v, out of place; k a Python int or a 0-dim
    device tensor (no host copy either way)."""
    a = a.clone()
    if isinstance(k, torch.Tensor):
        idx = k.reshape(1).to(torch.int64)
        if isinstance(v, torch.Tensor):
            a.index_put_((idx,), v.to(dtype=a.dtype, device=a.device).unsqueeze(0))
        else:
            a.index_fill_(0, idx, v)  # a Python scalar: no upload
    else:
        a[k] = v.to(a.dtype) if isinstance(v, torch.Tensor) else v
    return a


def _row(a, k):
    """a[k] for a Python int or a 0-dim device tensor k (no host copy)."""
    if isinstance(k, torch.Tensor):
        return a.index_select(0, k.reshape(1).to(torch.int64))[0]
    return a[k]


def add_keyframe(db: KeyframeDB, cfg: PoseGraphConfig, p_vio, q_vio, sig, desc, kp_norm,
                 kp_valid, wdesc, w3d, w_valid, seq=1):
    """Store a keyframe at row db.count (the caller grows a full database
    first).  Its PGO state starts at the VIO pose."""
    k = db.count
    yaw_vio = rot_to_ypr(quat_to_rot(q_vio))[0]
    return db._replace(
        count=k + 1, seq=_put(db.seq, k, seq), p_vio=_put(db.p_vio, k, p_vio),
        q_vio=_put(db.q_vio, k, q_vio), p_pgo=_put(db.p_pgo, k, p_vio),
        yaw_pgo=_put(db.yaw_pgo, k, yaw_vio), sig=_put(db.sig, k, sig),
        desc=_put(db.desc, k, desc), kp_norm=_put(db.kp_norm, k, kp_norm),
        kp_valid=_put(db.kp_valid, k, kp_valid), wdesc=_put(db.wdesc, k, wdesc),
        w3d=_put(db.w3d, k, w3d), w_valid=_put(db.w_valid, k, w_valid),
    )


def retrieve_candidates(db: KeyframeDB, cfg: PoseGraphConfig, sig, query_seq=None):
    """Cosine of mean-centred signatures against every stored keyframe,
    outside the most recent skip_recent (keyframes of another sequence are
    exempt when query_seq is given).  Returns (idx [top_k], score [top_k],
    floor): floor is the query's smallest score against its recent_ref
    previous keyframes (the query itself is stored at count - 1), 0 if none.
    Ineligible keyframes score -1; the top-k is a stable descending sort, so
    ties keep the lower index first (lax.top_k's order)."""
    k = db.count
    K = db.sig.shape[0]
    idx = torch.arange(K, device=db.sig.device)
    active = (idx < k)[:, None].to(torch.float32)
    mu = torch.sum(db.sig * active, dim=0) / torch.clamp(torch.sum(active), min=1.0)
    S = db.sig - mu[None, :]
    q = sig.to(torch.float32) - mu
    qn = q / torch.clamp(torch.linalg.norm(q), min=1e-9)
    Sn = S / torch.clamp(torch.linalg.norm(S, dim=1, keepdim=True), min=1e-9)
    scores = Sn @ qn
    eligible = (idx < k - cfg.skip_recent) & (idx >= 0)
    if query_seq is not None:
        eligible = eligible | ((db.seq != query_seq) & (idx < k))
    recent = (idx >= k - 1 - cfg.recent_ref) & (idx < k - 1)
    floor = torch.min(torch.where(recent, scores, torch.full_like(scores, float("inf"))))
    floor = torch.where(torch.isfinite(floor), floor, torch.zeros_like(floor))
    scores = torch.where(eligible, scores, torch.full_like(scores, -1.0))
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    return top_i[:cfg.top_k], top_s[:cfg.top_k], floor


class LoopResult(NamedTuple):
    ok: torch.Tensor  # [] bool: passed the inlier / yaw / translation gates
    rel_t: torch.Tensor  # [3] current position in the old keyframe's frame
    rel_yaw: torch.Tensor  # [] deg
    n_inliers: torch.Tensor  # [] int32
    n_matches: torch.Tensor  # [] int32 descriptor matches fed to PnP
    obs_old: torch.Tensor  # [Wp, 2] matched normalized coords in the old keyframe
    match_mask: torch.Tensor  # [Wp] bool: descriptor match AND PnP inlier
    p_old: torch.Tensor  # [3] PnP old-keyframe pose in the current VIO frame
    q_old: torch.Tensor  # [4]


def verify_loop(db: KeyframeDB, cfg: PoseGraphConfig, cand, wdesc, w3d, w_valid, p_cur,
                q_cur, sample_idx, q_ic=None, p_ic=None) -> LoopResult:
    """Descriptor match (margin 16, mutual) of the window points against one
    candidate keyframe's FAST corners, PnP-RANSAC on the matches
    (sample_idx: [n_hyp, 6] draws in [0, Wp)), then the gates.  p_old/q_old
    is the old keyframe's body pose from PnP (through the camera-IMU
    extrinsic when given) in the current VIO world, where w3d lives."""
    old_desc, old_valid, old_norm = (_row(db.desc, cand), _row(db.kp_valid, cand),
                                     _row(db.kp_norm, cand))
    midx, _ = brief_mod.match_descriptors(wdesc, w_valid, old_desc, old_valid, margin=16,
                                          mutual=True)
    m_ok = midx >= 0
    obs_old = old_norm[torch.where(m_ok, midx, torch.zeros_like(midx))]
    R0, t0, inl, n_inl = mvg.ransac_pnp(w3d, obs_old, m_ok, sample_idx,
                                        threshold=cfg.pnp_thresh)
    R_w_oldc = R0.T
    p_w_oldc = -R0.T @ t0
    if q_ic is not None:
        R_ic = quat_to_rot(torch.as_tensor(q_ic).to(R0))
        R_w_old = R_w_oldc @ R_ic.T
        p_old_pnp = p_w_oldc - R_w_old @ torch.as_tensor(p_ic).to(R0)
    else:
        R_w_old = R_w_oldc
        p_old_pnp = p_w_oldc
    q_w_old = rot_to_quat(R_w_old)
    rel_t = quat_rotate(quat_conj(q_w_old), p_cur - p_old_pnp)
    yaw_cur = rot_to_ypr(quat_to_rot(q_cur))[0]
    yaw_old = rot_to_ypr(quat_to_rot(q_w_old))[0]
    rel_yaw = yaw_cur - yaw_old
    ok = ((n_inl >= cfg.min_matches)
          & (torch.abs(torch.remainder(rel_yaw + 180.0, 360.0) - 180.0) < cfg.max_yaw)
          & (torch.linalg.norm(rel_t) < cfg.max_t))
    return LoopResult(ok=ok, rel_t=rel_t, rel_yaw=rel_yaw, n_inliers=n_inl,
                      n_matches=torch.sum(m_ok.to(torch.int32), dtype=torch.int32),
                      obs_old=obs_old, match_mask=m_ok & inl, p_old=p_old_pnp, q_old=q_w_old)


def record_loop(db: KeyframeDB, k, cand, rel_t, rel_yaw):
    return db._replace(loop_to=_put(db.loop_to, k, cand), loop_t=_put(db.loop_t, k, rel_t),
                       loop_yaw=_put(db.loop_yaw, k, rel_yaw))


# ---------------------------------------------------------------------------
# 4-DoF pose graph optimisation
# ---------------------------------------------------------------------------


def _ypr_vio(db):
    return rot_to_ypr(quat_to_rot(db.q_vio))


def pgo_residual(x, db: KeyframeDB, ypr_vio, cfg: PoseGraphConfig):
    """The pose graph's stacked residual at x [K, 4] = (yaw deg, t): [K, E, 4]
    sequential edges (each keyframe to its E predecessors of the same
    sequence), [K, 4] loop edges (times loop_edge_weight), [K, 4] gauge rows
    (x 100 on keyframe 0 and every active seq 0 keyframe), flattened in that
    order.  Rows are (t_x, t_y, t_z, wrapped yaw / 10)."""
    K = x.shape[0]
    dev = x.device
    yaw, t = x[:, 0], x[:, 1:4]
    ar = torch.arange(K, device=dev)
    active = ar < db.count

    def edge_res(i, j, t_meas, yaw_meas, w):
        ypr_i = torch.stack([yaw[i], ypr_vio[i, 1], ypr_vio[i, 2]], dim=-1)
        Ri = ypr_to_rot(ypr_i)
        r_t = torch.einsum("...ki,...k->...i", Ri, t[j] - t[i]) - t_meas
        r_y = torch.remainder(yaw[j] - yaw[i] - yaw_meas + 180.0, 360.0) - 180.0
        return torch.cat([r_t, (r_y / 10.0)[..., None]], dim=-1) * w[..., None]

    E = cfg.seq_edges
    j = ar[:, None].expand(K, E)
    i = j - torch.arange(1, E + 1, device=dev)[None, :]
    isafe = torch.clamp(i, min=0)
    okd = (i >= 0) & active[j] & (j >= 1) & (db.seq[isafe] == db.seq[j])
    Rv = ypr_to_rot(ypr_vio[isafe])
    tm = torch.einsum("...ki,...k->...i", Rv, db.p_vio[j] - db.p_vio[isafe])
    ym = ypr_vio[j, 0] - ypr_vio[isafe, 0]
    r_seq = edge_res(isafe, j, tm, ym, okd.to(x.dtype))
    il = db.loop_to
    okl = (il >= 0) & active
    r_loop = edge_res(torch.clamp(il, min=0), ar, db.loop_t, db.loop_yaw,
                      okl.to(x.dtype)) * cfg.loop_edge_weight
    fixed = (ar == 0) | ((db.seq == 0) & active)
    r_gauge = (torch.cat([t - db.p_pgo, (yaw - db.yaw_pgo)[:, None]], dim=1)
               * fixed[:, None].to(x.dtype) * 100.0)
    return torch.cat([r_seq.reshape(-1), r_loop.reshape(-1), r_gauge.reshape(-1)])


def _f64_db(db):
    return db._replace(**{f: getattr(db, f).double() for f in (
        "p_vio", "q_vio", "p_pgo", "yaw_pgo", "loop_t", "loop_yaw")})


def pgo_normal_plain(x, db: KeyframeDB, ypr_vio, cfg: PoseGraphConfig, with_h=True):
    """K19's twin, in f64: (r, H = J^T J, g = -J^T r) with J from
    ``torch.func.jacfwd`` of ``pgo_residual``; (r, None, None) without H."""
    kernels.TWIN_CALLS["pgo4"] += 1
    K = x.shape[0]
    db64, y64, x64 = _f64_db(db), ypr_vio.double(), x.double()
    f = lambda xf: pgo_residual(xf.reshape(K, 4), db64, y64, cfg)
    r = f(x64.reshape(-1))
    if not with_h:
        return r, None, None
    J = jacfwd(f)(x64.reshape(-1))
    return r, J.T @ J, -(J.T @ r)


def _pgo_normal_cuda(x, db: KeyframeDB, ypr_vio, cfg: PoseGraphConfig, with_h):
    K, E = x.shape[0], cfg.seq_edges
    dev = x.device
    n_e = K * E + 2 * K
    d = lambda t: t.to(torch.float64).contiguous()
    i32 = lambda t: t.to(torch.int32).contiguous()
    ins = [d(x), d(db.p_vio), d(ypr_vio), d(db.p_pgo), d(db.yaw_pgo), d(db.loop_t),
           d(db.loop_yaw), i32(db.seq), i32(db.loop_to), i32(db.count.reshape(1))]
    shapes = [(K, 4), (K, 3), (K, 3), (K, 3), (K,), (K, 3), (K,), (K,), (K,), (1,)]
    names = ["x", "p_vio", "ypr_vio", "p_pgo", "yaw_pgo", "loop_t", "loop_yaw", "seq",
             "loop_to", "count"]
    ptrs = [kernels.check(t, n, t.dtype, shape=s) for t, n, s in zip(ins, names, shapes)]
    e = lambda *s, dt=torch.float64: torch.empty(*s, dtype=dt, device=dev)
    r = e(n_e * 4)
    if with_h:
        J, ei, ej = e(n_e, 32), e(n_e, dt=torch.int32), e(n_e, dt=torch.int32)
        H, g = e(4 * K, 4 * K), e(4 * K)
        outs = [r, J, ei, ej, H, g]
    else:
        outs = [r, None, None, None, None, None]
    args = _PGO_ARGS(*ptrs, *[None if t is None else t.data_ptr() for t in outs], K, E,
                     int(with_h), float(cfg.loop_edge_weight))
    PGO4(ctypes.byref(args))
    return (r, H, g) if with_h else (r, None, None)


def pgo_normal(x, db: KeyframeDB, ypr_vio, cfg: PoseGraphConfig, with_h=True):
    """K19.  CPU tensors: ``pgo_normal_plain``.  CUDA tensors: a thread per
    edge for the residual and Jacobian blocks, a thread per 4x4 block of H in
    a fixed order; with_h=False is the residual-only cost pass.  All f64."""
    if not x.is_cuda:
        return pgo_normal_plain(x, db, ypr_vio, cfg, with_h)
    return _pgo_normal_cuda(x, db, ypr_vio, cfg, with_h)


def optimize_4dof(db: KeyframeDB, cfg: PoseGraphConfig):
    """Masked fixed-shape 4-DoF PGO over the whole database: LM on [yaw
    (deg), x, y, z] per keyframe with pitch and roll held at the VIO's, the
    same iteration, branchless accept and damping as ``lm.lm_solve``.  The
    cost is taken in the database's dtype from K19's f64 residual; H and g
    stay f64 into the solve.  Returns (db with yaw_pgo/p_pgo, LMResult)."""
    K = db.p_vio.shape[0]
    dtype, dev = db.p_vio.dtype, db.p_vio.device
    ypr_vio = _ypr_vio(db)
    config = lm_mod.LMConfig(num_iters=cfg.pgo_iters)
    spec = lm_mod.SchurSpec(dense_dim=4 * K)

    def cost_of(x):
        r = pgo_normal(x, db, ypr_vio, cfg, with_h=False)[0].to(dtype)
        return 0.5 * torch.dot(r, r)

    x = torch.cat([db.yaw_pgo[:, None], db.p_pgo], dim=1)
    cost0 = cost_of(x)
    cost = cost0
    lam = torch.as_tensor(config.lambda_init, dtype=dtype, device=dev)
    gnorm = torch.zeros_like(cost0)
    for _ in range(config.num_iters):
        _, H, g = pgo_normal(x, db, ypr_vio, cfg)
        delta = lm_mod.schur_solve(H, g, spec, lam, config.diag_floor)
        x_new = x + delta.to(dtype).reshape(K, 4)
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        x = torch.where(accept, x_new, x)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.clamp(
            torch.where(accept, lam * config.lambda_down, lam * config.lambda_up),
            config.lambda_min, config.lambda_max)
        gnorm = torch.linalg.norm(g).to(dtype)
    out = lm_mod.LMResult(x=x.reshape(-1), cost0=cost0, cost=cost, lam=lam, grad_norm=gnorm)
    return db._replace(yaw_pgo=x[:, 0].contiguous(), p_pgo=x[:, 1:4].contiguous()), out


def rebase_sequence(db: KeyframeDB, cfg: PoseGraphConfig, k_cur, cand):
    """Re-base the current sequence onto the old map at its first
    inter-sequence loop: the yaw + t shift that moves keyframe k_cur onto
    (old pose o loop relative), applied to every keyframe of its sequence
    (VIO and PGO poses).  Returns (db, (R_s, t_s))."""
    ypr_old = rot_to_ypr(quat_to_rot(_row(db.q_vio, cand)))
    R_old = ypr_to_rot(ypr_old)
    w_p_cur = R_old @ _row(db.loop_t, k_cur) + _row(db.p_vio, cand)
    w_yaw_cur = ypr_old[0] + _row(db.loop_yaw, k_cur)
    yaw_vio_cur = rot_to_ypr(quat_to_rot(_row(db.q_vio, k_cur)))[0]
    shift_yaw = w_yaw_cur - yaw_vio_cur
    z = torch.zeros_like(shift_yaw)
    R_s = ypr_to_rot(torch.stack([shift_yaw, z, z]))
    t_s = w_p_cur - R_s @ _row(db.p_vio, k_cur)
    q_s = rot_to_quat(R_s)
    member = ((db.seq == _row(db.seq, k_cur))
              & (torch.arange(db.seq.shape[0], device=db.seq.device) < db.count))
    m = member[:, None]
    p_vio2 = torch.where(m, db.p_vio @ R_s.T + t_s, db.p_vio)
    q_vio2 = torch.where(m, quat_mul(q_s.expand_as(db.q_vio), db.q_vio), db.q_vio)
    p_pgo2 = torch.where(m, db.p_pgo @ R_s.T + t_s, db.p_pgo)
    yaw_pgo2 = torch.where(member, db.yaw_pgo + shift_yaw, db.yaw_pgo)
    return db._replace(p_vio=p_vio2, q_vio=q_vio2, p_pgo=p_pgo2, yaw_pgo=yaw_pgo2), (R_s, t_s)


def grow_db(db: KeyframeDB, factor: int = 2) -> KeyframeDB:
    """Capacity times factor; the new rows take empty_db's defaults, so the
    masked programs treat them as inactive."""
    K = db.p_vio.shape[0]
    extra = K * (factor - 1)

    def pad(a, fill=0):
        return torch.cat([a, torch.full((extra,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                        device=a.device)])

    q_pad = torch.zeros(extra, 4, dtype=db.q_vio.dtype, device=db.q_vio.device)
    q_pad[:, 0] = 1.0
    return db._replace(
        seq=pad(db.seq, 1), p_vio=pad(db.p_vio), q_vio=torch.cat([db.q_vio, q_pad]),
        p_pgo=pad(db.p_pgo), yaw_pgo=pad(db.yaw_pgo), sig=pad(db.sig), desc=pad(db.desc),
        kp_norm=pad(db.kp_norm), kp_valid=pad(db.kp_valid), wdesc=pad(db.wdesc),
        w3d=pad(db.w3d), w_valid=pad(db.w_valid), loop_to=pad(db.loop_to, -1),
        loop_t=pad(db.loop_t), loop_yaw=pad(db.loop_yaw),
    )


def save_db(db: KeyframeDB, path):
    """Persist the keyframe database in one npz with the reference's keys
    and dtypes (uint32 descriptors, int32 count/seq/loop_to)."""
    from ..convert import from_torch

    np.savez_compressed(path, **from_torch(db)._asdict())


def load_db(path, device=torch.device("cuda")) -> KeyframeDB:
    """Reload a database saved by either package."""
    from ..convert import to_torch

    with np.load(path) as z:
        return to_torch(KeyframeDB(**{f: z[f] for f in z.files}), device)


def drift_correction(db: KeyframeDB, cfg: PoseGraphConfig):
    """(R_drift yaw-only, t_drift) mapping VIO poses into the corrected frame,
    at the newest keyframe."""
    k = torch.clamp(db.count - 1, min=0)
    yaw_vio = rot_to_ypr(quat_to_rot(_row(db.q_vio, k)))[0]
    dyaw = _row(db.yaw_pgo, k) - yaw_vio
    z = torch.zeros_like(dyaw)
    R_drift = ypr_to_rot(torch.stack([dyaw, z, z]))
    t_drift = _row(db.p_pgo, k) - R_drift @ _row(db.p_vio, k)
    return R_drift, t_drift
