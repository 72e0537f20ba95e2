"""The PnP hypotheses (K18's plain twin ``pnp_hypotheses_plain``) against
the JAX reference's ``pnp_dlt`` on each sample's mask and its score, as
``ransac_pnp``'s vmapped hypothesis runs them, on the cases of
``utils/synthetic.pnp_cases``: repeated draws, draws of masked points, fewer
than six distinct points, coplanar and nearly coplanar points, points behind
the camera and points either side of the inlier threshold.

On a sample whose pose is determined (``_determined``: six distinct unmasked
points, a gap between the two smallest eigenvalues of A^T A, a depth sign
and a polar factor that rounding cannot flip) the inlier counts and masks
are exact and R, t within 1e-6, the bar ``chip_smoke.py`` holds K18 to
against this twin (torch f64 on the CPU against JAX x64: two LAPACK
eigensolves, ~3e-8 apart on the nearly coplanar points, eps over that
case's eigengap; ~1e-12 elsewhere).  Elsewhere the pose hangs on the
eigensolver's rounding and only the outputs' shapes and finiteness are
held; the coplanar case has no determined sample at all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vplines_slam_tpu.ops import mvg as jmvg
from vplines_slam_tpu_torch.ops import mvg as tmvg
from vplines_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CASES = tsyn.pnp_cases()


def _jax_hyps(X_w, x, mask, idx, thr):
    """The reference's hypothesis of each sample row: (R, t, count, inl)."""
    X_w, x, mask = jnp.asarray(X_w), jnp.asarray(x), jnp.asarray(mask)

    def hyp(sample):
        sm = jnp.zeros(X_w.shape[0], bool).at[sample].set(True) & mask
        R, t, _ = jmvg.pnp_dlt(X_w, x, sm)
        Xc = X_w @ R.T + t
        good = Xc[:, 2] > 0.05
        proj = Xc[:, :2] / jnp.where(good, Xc[:, 2], 1.0)[:, None]
        inl = (jnp.linalg.norm(proj - x, axis=-1) < thr) & mask & good
        return R, t, jnp.sum(inl.astype(jnp.int32)), inl

    return map(np.asarray, jax.jit(jax.vmap(hyp))(jnp.asarray(idx)))


def _determined(X_w, x, mask, idx):
    """Whether each sample's pose is determined by the data rather than by
    an eigensolver's rounding (``chip_smoke.py``'s ``pnp_determined``): six
    distinct unmasked points, a relative gap above 1e-10 between the two
    smallest eigenvalues of A^T A, sample depths under the eigenvector that
    sum to more than 1e-4 of their magnitudes, and an M = P[:, :3] whose
    smallest singular value is above 1e-4 of its largest."""
    out = []
    for row in idx:
        pts = np.unique(row)
        if len(pts) < 6 or not mask[pts].all():
            out.append(False)
            continue
        Xh = np.concatenate([X_w[pts], np.ones((len(pts), 1))], 1)
        z = np.zeros_like(Xh)
        A = np.concatenate([np.concatenate([Xh, z, -x[pts, :1] * Xh], 1),
                            np.concatenate([z, Xh, -x[pts, 1:] * Xh], 1)])
        lam, V = np.linalg.eigh(A.T @ A)
        P = V[:, 0].reshape(3, 4)
        depths = Xh @ P[2]
        sv = np.linalg.svd(P[:, :3], compute_uv=False)
        out.append((lam[1] - lam[0]) / lam[-1] > 1e-10
                   and abs(depths.sum()) > 1e-4 * np.abs(depths).sum() and sv[2] > 1e-4 * sv[0])
    return np.array(out)


@pytest.mark.parametrize("name", list(CASES))
def test_pnp_hypotheses_case_matches_jax(name):
    X_w, x, mask, idx, thr = CASES[name]
    jR, jt, jc, jinl = _jax_hyps(X_w, x, mask, idx, thr)
    tR, tt, tc, tinl = tmvg.pnp_hypotheses_plain(
        torch.from_numpy(X_w), torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(idx), thr)
    n_hyp, N = idx.shape[0], X_w.shape[0]
    assert tR.shape == (n_hyp, 3, 3) and tt.shape == (n_hyp, 3) and tinl.shape == (n_hyp, N)
    assert tc.dtype == torch.int32 and torch.isfinite(tR).all() and torch.isfinite(tt).all()
    full = _determined(X_w, x, mask, idx)
    assert full.any() != (name == "coplanar")  # its null space is 4-dim
    np.testing.assert_array_equal(tc.numpy()[full], jc[full])
    np.testing.assert_array_equal(tinl.numpy()[full], jinl[full])
    np.testing.assert_allclose(tR.numpy()[full], jR[full], atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt.numpy()[full], jt[full], atol=1e-6, rtol=0)
