"""Port parity: closed-form linear algebra, LRF, SO(2) candidates,
cross-scale consensus and RANSAC (fed JAX's own rank draws).

Everything here is float32 on both sides: poses and rotations agree to
1e-5 (f32 rounding through a few dozen dependent products); masks and
counts agree exactly on inputs without near-threshold pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.core import linalg as jla
from bufferx_tpu.core import se3 as jse3
from bufferx_tpu.geometry.lrf import align_patches as j_align
from bufferx_tpu.solver.consensus import cross_scale_consensus as j_consensus
from bufferx_tpu.solver.ransac import ransac_pose as j_ransac
from bufferx_tpu.solver.so2 import so2_pose_candidates as j_so2
from bufferx_tpu_torch.core import linalg as tla
from bufferx_tpu_torch.core import se3 as tse3
from bufferx_tpu_torch.geometry.lrf import align_patches
from bufferx_tpu_torch.solver.consensus import cross_scale_consensus
from bufferx_tpu_torch.solver.ransac import RANK_RANGE, ransac_pose
from bufferx_tpu_torch.solver.so2 import so2_pose_candidates

T = torch.from_numpy


def _rot(rs, n):
    q = rs.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.array(jla.quaternion_to_rotation(jnp.asarray(q, jnp.float32)))


def test_eigh_and_rodrigues_match():
    rs = np.random.RandomState(0)
    a = rs.randn(64, 3, 5).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1)
    cov[:4] = np.diag([1.0, 2.0, 3.0]).astype(np.float32)   # diagonal case
    jw, jv = jla.eigh3x3(jnp.asarray(cov))
    tw, tv = tla.eigh3x3(T(cov))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4)
    u = rs.randn(64, 3).astype(np.float32)
    u[0] = [0, 0, -1]                                         # antiparallel
    z = np.broadcast_to(np.asarray([0, 0, 1], np.float32), u.shape)
    np.testing.assert_allclose(
        tla.rodrigues_a_to_b(T(u), T(z.copy())).numpy(),
        np.asarray(jla.rodrigues_a_to_b(jnp.asarray(u), jnp.asarray(z))),
        rtol=0, atol=1e-5)


def test_kabsch_matches():
    rs = np.random.RandomState(1)
    R = _rot(rs, 1)[0]
    A = rs.randn(40, 3).astype(np.float32)
    B = (A @ R.T + [0.3, -0.2, 0.1] + 0.01 * rs.randn(40, 3)).astype(np.float32)
    w = (rs.uniform(size=40) < 0.7).astype(np.float32)
    jR, jt = jla.kabsch(jnp.asarray(A), jnp.asarray(B), jnp.asarray(w))
    tR, tt = tla.kabsch(T(A), T(B), T(w))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    # batched minimal sets, as RANSAC solves them
    a3 = rs.randn(256, 3, 3).astype(np.float32)
    b3 = rs.randn(256, 3, 3).astype(np.float32)
    jR, jt = jla.kabsch(jnp.asarray(a3), jnp.asarray(b3))
    tR, tt = tla.kabsch(T(a3), T(b3))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    assert torch.allclose(torch.linalg.det(tR), torch.ones(256), atol=1e-4)


def test_lrf_alignment_matches():
    rs = np.random.RandomState(2)
    delta = (rs.randn(32, 64, 3) * [1.0, 0.7, 0.1]).astype(np.float32)
    delta[:, 50:] = 0.0                            # invalid slots
    kpts = rs.randn(32, 3).astype(np.float32)
    for aligned in (False, True):
        jd, jr, jR = j_align(jnp.asarray(delta), jnp.asarray(kpts),
                             jnp.asarray(aligned))
        td, tr, tR = align_patches(T(delta), T(kpts), aligned)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def _correspondences(seed, c=300, inlier_frac=0.6):
    rs = np.random.RandomState(seed)
    R = _rot(rs, 1)[0]
    t = np.asarray([0.2, -0.4, 0.3], np.float32)
    ss = rs.uniform(-1, 1, (c, 3)).astype(np.float32)
    tt = (ss @ R.T + t + 0.003 * rs.randn(c, 3)).astype(np.float32)
    out = rs.uniform(size=c) > inlier_frac
    tt[out] = rs.uniform(-1.5, 1.5, (out.sum(), 3))
    valid = rs.uniform(size=c) < 0.95
    return rs, ss, tt, valid, R, t


def test_so2_and_consensus_match():
    rs, ss, tt, valid, _R, _t = _correspondences(3)
    c = len(ss)
    sR, tR = _rot(rs, c), _rot(rs, c)
    ind = rs.uniform(0, 20, c).astype(np.float32)
    jRc, jtc = j_so2(jnp.asarray(ss), jnp.asarray(tt), jnp.asarray(sR),
                     jnp.asarray(tR), jnp.asarray(ind), 20)
    tRc, ttc = so2_pose_candidates(T(ss), T(tt), T(sR), T(tR), T(ind), 20)
    np.testing.assert_allclose(tRc.numpy(), np.asarray(jRc), atol=1e-5)
    np.testing.assert_allclose(ttc.numpy(), np.asarray(jtc), atol=1e-5)
    # consensus on the JAX candidates, so only the vote itself is compared
    jm, jb, jn = j_consensus(jRc, jtc, jnp.asarray(ss), jnp.asarray(tt),
                             jnp.asarray(valid), azi_n=20, inlier_th=1.25)
    tm, tb, tn = cross_scale_consensus(
        T(np.array(jRc)), T(np.array(jtc)), T(ss), T(tt), T(valid),
        azi_n=20, inlier_th=1.25)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tb) == int(jb) and int(tn) == int(jn)


@pytest.mark.parametrize("seed", [4, 5])
def test_ransac_matches_with_jax_ranks(seed):
    _rs, ss, tt, valid, R, t = _correspondences(seed)
    pool = valid & (np.random.RandomState(seed).uniform(size=len(ss)) < 0.8)
    key = jax.random.PRNGKey(seed)
    H = 512
    ranks = np.array(jax.random.randint(key, (H, 3), 0, jnp.int32(RANK_RANGE),
                                        dtype=jnp.int32))
    jr = j_ransac(jnp.asarray(ss), jnp.asarray(tt), jnp.asarray(pool),
                  jnp.asarray(valid), key, dist_th=0.05, num_hypotheses=H,
                  chunk=128)
    tr = ransac_pose(T(ss), T(tt), T(pool), T(valid), T(ranks),
                     dist_th=0.05, chunk=128)
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-5)
    assert int(tr.num_inliers) == int(jr.num_inliers)
    np.testing.assert_array_equal(tr.inlier_mask.numpy(),
                                  np.asarray(jr.inlier_mask))
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3], gt[:3, 3] = R, t
    assert float(tse3.compute_rte(tr.pose, T(gt))) < 0.01
    assert float(tse3.compute_rre(tr.pose, T(gt))) < 1.0
    np.testing.assert_allclose(
        float(tse3.compute_rre(tr.pose, T(gt))),
        float(jse3.compute_rre(jr.pose, jnp.asarray(gt))), atol=1e-2)
