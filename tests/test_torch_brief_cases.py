"""K16's function on its plain route: the port's ``describe_brief`` against
the JAX package's on the keypoints of ``utils/synthetic.brief_cases`` (on,
beyond and straddling the image's edges, at non-integer positions, K = 0, 1
and a keyframe's 564 with invalid rows), and ``describe_brief_pair``, the
one call ``extract_keyframe_features`` makes for its two point sets, equal
to two calls to the bit.

On the card the pair is one launch (``csrc/brief.cu``): a CTA a keypoint
blurs the 34 x 34 patch its tests read, with the full-frame blur's
arithmetic, so each row depends on its own keypoint alone, as on the plain
route.  ``chip_smoke.py`` holds the kernel to the plain route and, to the
bit, to the previous kernel (a full-frame blur, then the tests).

Tolerance: exact (the descriptors are bits; the port's int32 words are the
reference's uint32 patterns).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import brief as jbrief
from vplines_slam_tpu_torch.ops import brief as tbrief
from vplines_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CASES = synthetic.brief_cases(seed=0)


def u32(desc_t):
    """The port's int32 words as the reference's uint32."""
    return desc_t.numpy().astype(np.int32).view(np.uint32)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", list(CASES))
def test_describe_brief_matches_jax(name):
    img, xy, valid = CASES[name]
    jd = np.asarray(jbrief.describe_brief(jnp.asarray(img), jnp.asarray(xy),
                                          jnp.asarray(valid)))
    td = tbrief.describe_brief(t(img), t(xy), t(valid))
    assert td.dtype == torch.int32 and td.shape == (len(xy), 8)
    np.testing.assert_array_equal(u32(td), jd.reshape(len(xy), 8))
    assert not td[~t(valid)].any()


@pytest.mark.parametrize("split", [0, 1, 500, 564])
def test_pair_equals_two_calls(split):
    """A keyframe's corners and window points in one call: each half equals
    its own call to the bit, at every split (an empty set included)."""
    img, xy, valid = CASES["keyframe"]
    a, b = tbrief.describe_brief_pair(t(img), t(xy[:split]), t(valid[:split]),
                                      t(xy[split:]), t(valid[split:]))
    assert torch.equal(a, tbrief.describe_brief(t(img), t(xy[:split]), t(valid[:split])))
    assert torch.equal(b, tbrief.describe_brief(t(img), t(xy[split:]), t(valid[split:])))


def test_cases_reach_their_branches():
    """The edge and straddling keypoints read the zero pad, the far ones
    only the pad (all bits 0 where every tap is 0), the fractional ones
    fall between pixels, the keyframe case holds invalid rows."""
    img, xy, valid = CASES["beyond"]
    d = tbrief.describe_brief(t(img), t(xy), t(valid))
    assert not d[2].any()  # (-100, -100): every tap in the pad, va < vb never holds
    _, frac, _ = CASES["fractional"]
    assert (frac % 1 != 0).all()
    _, kf, kv = CASES["keyframe"]
    assert len(kf) == 564 and 0 < (~kv).sum() < 100
    assert ((kf < 0) | (kf > [127, 95])).any(axis=1).sum() > 10
