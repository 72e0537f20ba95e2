"""``SlamSystem`` with the attention feature selector on, against the JAX
reference (torch f64 on the CPU, K20's plain twins, against JAX x64): a
small cold start into tracking with the selector masking new features,
``_select_impl`` on one state and window carried across by ``convert``, the
selector's invariants, and the profile's selector block.

The stream and draws are test_torch_coldstart_system.py's; the selector's
block is cut to the small tracker (40 features): max_features 34 and
init_threshold 20, so tracked frames have new candidates, a budget above 0
and more candidates than the pass-through threshold.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.estimator.window import WindowConfig as JWindowConfig
from vplines_slam_tpu.models import camera as jcam
from vplines_slam_tpu.models import feature_tracker as jft
from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu.models import selector as jsel
from vplines_slam_tpu.pipeline.system import SlamSystem as JSlamSystem
from vplines_slam_tpu.utils import config as jconfig
from vplines_slam_tpu_torch import convert
from vplines_slam_tpu_torch.estimator.window import WindowConfig
from vplines_slam_tpu_torch.models import camera as tcam
from vplines_slam_tpu_torch.models import feature_tracker as tft
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.models import selector as tsel
from vplines_slam_tpu_torch.pipeline.system import SlamSystem
from vplines_slam_tpu_torch.utils import config as tconfig
from test_torch_coldstart import CPU, WKW, close, jax_draws
from test_torch_coldstart_system import rendered

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEL = dict(max_features=34, init_threshold=20)
N_TRACKED = 3


@pytest.fixture(scope="module")
def run():
    """Both systems through init and N_TRACKED tracked frames with the
    selector on; every selector call's inputs and ids are recorded."""
    n = WKW["window"] + 4 + N_TRACKED  # init succeeds at frame 8
    frame_t, imu_t, accs, gyrs, imgs, q_ic, p_ic = rendered(n)
    kw = dict(max_features=40, min_dist=12, quality=0.005, f_threshold=1e4, ransac_hyps=4)
    wkw = dict(WKW, init_min_parallax=15.0 / 460.0)
    jsys = JSlamSystem(jcam.pinhole(110.0, 110.0, 80.0, 60.0, width=160, height=120),
                       JWindowConfig(**wkw), jft.TrackerConfig(equalize=False, **kw),
                       imu_params=jimu.default_params(), q_ic=jnp.asarray(q_ic),
                       p_ic=jnp.asarray(p_ic), use_loop_closure=False,
                       use_feature_selector=True, selector_cfg=jsel.SelectorConfig(**SEL),
                       dtype=jnp.float64)
    tsys = SlamSystem(tcam.pinhole(110.0, 110.0, 80.0, 60.0, width=160, height=120,
                                   dtype=torch.float64, device=CPU),
                      WindowConfig(**wkw), tft.TrackerConfig(equalize=False, **kw),
                      imu_params=timu.default_params(device=CPU), q_ic=q_ic, p_ic=p_ic,
                      use_loop_closure=False, use_feature_selector=True,
                      selector_cfg=tsel.SelectorConfig(**SEL), dtype=torch.float64, device=CPU)
    tsys.frontend.ransac_draws = jax_draws(0, (4, 8), 40)
    tsys.vio.sfm_draws = jax_draws(0, (64, 8), WKW["max_points"])
    calls = dict(jax=[], torch=[])
    jsel_fn, tsel_fn = jsys._jit_select, tsys._select_impl

    def jax_select(*a):
        out = jsel_fn(*a)
        calls["jax"].append((a, np.asarray(out)))
        return out

    def torch_select(*a):
        out = tsel_fn(*a)
        calls["torch"].append((a, out.numpy().copy()))
        return out

    jsys._jit_select, tsys._select_impl = jax_select, torch_select
    i, outs = 0, []
    for k in range(n):
        while i < len(imu_t) and imu_t[i] <= frame_t[k]:
            jsys.add_imu(imu_t[i], accs[i], gyrs[i])
            tsys.add_imu(imu_t[i], accs[i], gyrs[i])
            i += 1
        jo = jsys.add_image(frame_t[k], imgs[k])
        to = tsys.add_image(frame_t[k], imgs[k])
        assert (jo is None) == (to is None), k
        if jo is not None:
            outs.append((jo, to))
    outs.append((jsys.flush(), tsys.flush()))
    return dict(jsys=jsys, tsys=tsys, outs=outs, calls=calls, select=(jsel_fn, tsel_fn))


def test_selector_system_matches_jax(run):
    """The same ids kept on every tracked frame and the same outputs (1e-6,
    the cold-start system test's bound)."""
    calls, outs = run["calls"], run["outs"]
    assert run["tsys"].vio.initialized and len(outs) == N_TRACKED + 1
    assert len(calls["torch"]) == len(calls["jax"]) == N_TRACKED
    for (_, j_ids), (_, t_ids) in zip(calls["jax"], calls["torch"]):
        np.testing.assert_array_equal(t_ids, j_ids)
    for jo, to in outs:
        assert jo.t == to.t and jo.is_keyframe == to.is_keyframe
        close(jo.p_vio, to.p_vio, atol=1e-6)
        close(jo.q_vio, to.q_vio, atol=1e-6)
        close(jo.ba_cost, to.ba_cost, atol=1e-8, rtol=1e-5)


def _carried(run, cfg=None):
    """The last selector call's inputs on the JAX engine's final state and
    window, carried to the port by convert; ids from both packages (the
    JAX side jitted afresh when cfg changes the selector block)."""
    jsys, tsys = run["jsys"], run["tsys"]
    (ids, rays, _, _, acc, gyr, dt), _ = run["calls"]["jax"][-1]
    state, data = jsys.vio.state, jsys.vio.data
    j_select, t_select = run["select"]
    if cfg is not None:
        jsys.selector_cfg = jsel.SelectorConfig(**cfg)
        tsys.selector_cfg = tsel.SelectorConfig(**cfg)
        j_select = jax.jit(jsys._select_impl)
    try:
        j_ids = np.asarray(j_select(ids, rays, state, data, acc, gyr, dt))
        t_ids = t_select(torch.as_tensor(np.array(ids)), torch.as_tensor(np.array(rays)),
                         convert.to_torch(state, CPU), convert.to_torch(data, CPU),
                         np.asarray(acc), np.asarray(gyr), float(dt)).numpy()
    finally:
        jsys.selector_cfg = jsel.SelectorConfig(**SEL)
        tsys.selector_cfg = tsel.SelectorConfig(**SEL)
    return np.asarray(ids), j_ids, t_ids, data


@pytest.mark.parametrize("cfg", [None, dict(max_features=40, init_threshold=20)],
                         ids=["profile_block", "larger_budget"])
def test_select_impl_matches_jax_on_a_carried_state(run, cfg):
    _, j_ids, t_ids, _ = _carried(run, cfg)
    np.testing.assert_array_equal(t_ids, j_ids)


def test_selector_invariants(run):
    """Tracked ids pass, new ids are kept within the budget, the kept count
    stays within max(max_features, tracked), and at most init_threshold
    candidates all pass."""
    picked_any = False
    for (ids, _, state, data, *_), out in run["calls"]["torch"]:
        ids = ids.numpy()
        window = set(data.pt_id.numpy()[data.pt_id.numpy() >= 0].tolist())
        valid = ids >= 0
        tracked = valid & np.isin(ids, list(window))
        new_kept = (out >= 0) & ~tracked
        budget = max(SEL["max_features"] - int(tracked.sum()), 0)
        assert np.array_equal(out[tracked], ids[tracked])
        assert np.all((out == ids) | (out == -1))
        assert new_kept.sum() <= budget
        assert (out >= 0).sum() <= max(SEL["max_features"], int(tracked.sum()))
        picked_any |= bool(new_kept.any())
    assert picked_any, "no frame picked a new feature"
    ids, _, t_ids, _ = _carried(run, dict(max_features=34, init_threshold=1000))
    np.testing.assert_array_equal(t_ids, ids)


def test_load_profile_selector_matches_jax():
    """The pinhole profiles' selector blocks (euroc.yaml's 30 / 30) as the
    reference's loader builds them."""
    for name in ("euroc.yaml", "d455.yaml", "gnss_527.yaml", "mapping_multichip.yaml"):
        path = str(ROOT / "configs" / name)
        jp, tp = jconfig.load_profile(path), tconfig.load_profile(path, device=CPU)
        assert tuple(tp.selector) == tuple(jp.selector), name
        assert tp.use_feature_selector == jp.use_feature_selector, name
    assert tp.selector.max_features == 30 or name != "euroc.yaml"
