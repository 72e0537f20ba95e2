"""The batched IMU preintegration (K10's plain twin) against the JAX reference
on the interval layouts the kernel must reproduce, and the premise its skip
of masked steps rests on.

Cases (``utils/synthetic.imu_interval_cases``): a frame interval with 20 live
steps of 64, a merged interval with 40, one merged past the capacity
(decimated 2:1), an interval with no live step, masked steps between live
ones, and the initializer's nine intervals with non-zero biases.  Torch f64
on the CPU against JAX x64 (``jax.vmap`` of ``models/imu.preintegrate``) at
rtol 1e-10, as ``test_torch_coldstart_ops.py``'s batched test: both run the
same step in the same order, so they differ by the matmuls' rounding only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.models import imu as jimu
from vplines_slam_tpu_torch.models import imu as timu
from vplines_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CPU = torch.device("cpu")
CASES = synthetic.imu_interval_cases(seed=0)


def T(a):
    return torch.as_tensor(np.array(a))


def port(args):
    return timu.preintegrate(*map(T, args), timu.default_params(device=CPU))


@pytest.mark.parametrize("name", list(CASES))
def test_preintegrate_case_matches_jax(name):
    args = CASES[name]
    jp = jax.vmap(lambda *a: jimu.preintegrate(*a, jimu.default_params()))(
        *map(jnp.asarray, args))
    tp = port(args)
    for f in jp._fields:
        np.testing.assert_allclose(np.asarray(getattr(tp, f)), np.asarray(getattr(jp, f)),
                                   atol=1e-15, rtol=1e-10, err_msg=f"{name}: {f}")


def test_no_live_step_is_the_identity():
    """J = I and P = 0 exactly, dq the renormalised identity, sum_dt 0, as in
    the reference."""
    args = CASES["no live step"]
    tp = port(args)
    jp = jax.vmap(lambda *a: jimu.preintegrate(*a, jimu.default_params()))(
        *map(jnp.asarray, args))
    assert torch.equal(tp.jacobian[0], torch.eye(15, dtype=torch.float64))
    assert torch.equal(tp.covariance[0], torch.zeros(15, 15, dtype=torch.float64))
    assert float(tp.sum_dt[0]) == 0.0
    assert np.array_equal(tp.delta_q.numpy(), np.asarray(jp.delta_q))
    assert np.array_equal(tp.delta_p.numpy(), np.zeros((1, 3)))


@pytest.mark.parametrize("fill", ["zero", "repeat"])
def test_masked_step_leaves_jacobian_and_covariance_bit_equal(fill):
    """The premise of K10's skip: in the twin, a step with dt * mask = 0 on
    finite samples multiplies J and P by an exact identity and adds an exact
    zero.  An interval of k live steps padded to 64 (zero-filled as
    ``VioEngine._pack_imu`` does, or repeating the last sample as the
    slide's merge does) gives the same J and P, bit for bit, as the k steps
    alone; dq differs only by the padding's renormalisations."""
    dts, accs, gyrs, mask, ba, bg = (np.array(x) for x in CASES["frame 20/64"])
    k = int(mask.sum())
    if fill == "repeat":
        accs[:, k + 1:], gyrs[:, k + 1:] = accs[:, k:k + 1], gyrs[:, k:k + 1]
    padded = port((dts, accs, gyrs, mask, ba, bg))
    alone = port((dts[:, :k], accs[:, :k + 1], gyrs[:, :k + 1], mask[:, :k], ba, bg))
    assert torch.equal(padded.jacobian, alone.jacobian)
    assert torch.equal(padded.covariance, alone.covariance)
    assert torch.equal(padded.delta_p, alone.delta_p)
    assert torch.equal(padded.delta_v, alone.delta_v)
    np.testing.assert_allclose(padded.delta_q.numpy(), alone.delta_q.numpy(), rtol=0,
                               atol=1e-15)
