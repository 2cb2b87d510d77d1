"""Port parity: closed-form linear algebra, LRF, SO(2) candidates,
cross-scale consensus, RANSAC (fed JAX's own rank draws), IRLS refinement
and GNC-TLS. The port's solvers take a leading pair dimension where the JAX
package uses ``vmap``: the tests stack two or three problems into one call
and hold each against the JAX function on its own.

Everything here is float32 on both sides: poses and rotations agree to
1e-5 (f32 rounding through a few dozen dependent products; 1e-4 after the
20 and 50 dependent Kabsch rounds of IRLS and GNC); masks and counts agree
exactly on inputs without near-threshold pairs.
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
from bufferx_tpu.solver.gnc import gnc_tls_solve as j_gnc
from bufferx_tpu.solver.irls import post_refinement as j_irls
from bufferx_tpu.solver.ransac import ransac_pose as j_ransac
from bufferx_tpu.solver.so2 import so2_pose_candidates as j_so2
from bufferx_tpu_torch.core import linalg as tla
from bufferx_tpu_torch.core import se3 as tse3
from bufferx_tpu_torch.geometry.lrf import align_patches
from bufferx_tpu_torch.solver.consensus import cross_scale_consensus
from bufferx_tpu_torch.solver.gnc import gnc_tls_solve
from bufferx_tpu_torch.solver.irls import post_refinement
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
        T(np.array(jRc))[None], T(np.array(jtc))[None], T(ss)[None],
        T(tt)[None], T(valid)[None], azi_n=20, inlier_th=1.25)
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
    assert int(tb[0]) == int(jb) and int(tn[0]) == int(jn)


def test_consensus_batch_matches_pair_by_pair():
    """Three pairs' votes in one call (one of them with no valid match)
    against the JAX function on each."""
    sets = []
    for seed in (6, 7, 8):
        rs, ss, tt, valid, _R, _t = _correspondences(seed)
        c = len(ss)
        ind = rs.uniform(0, 20, c).astype(np.float32)
        Rc, tc = j_so2(jnp.asarray(ss), jnp.asarray(tt),
                       jnp.asarray(_rot(rs, c)), jnp.asarray(_rot(rs, c)),
                       jnp.asarray(ind), 20)
        sets.append((np.array(Rc), np.array(tc), ss, tt, valid))
    sets[2] = sets[2][:4] + (np.zeros_like(sets[2][4]),)
    tm, tb, tn = cross_scale_consensus(
        *(T(np.stack(x)) for x in zip(*sets)), azi_n=20, inlier_th=1.25)
    for i, (Rc, tc, ss, tt, valid) in enumerate(sets):
        jm, jb, jn = j_consensus(
            jnp.asarray(Rc), jnp.asarray(tc), jnp.asarray(ss),
            jnp.asarray(tt), jnp.asarray(valid), azi_n=20, inlier_th=1.25)
        np.testing.assert_array_equal(tm[i].numpy(), np.asarray(jm))
        assert int(tb[i]) == int(jb) and int(tn[i]) == int(jn)


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
    tr = ransac_pose(T(ss)[None], T(tt)[None], T(pool)[None], T(valid)[None],
                     T(ranks)[None], dist_th=0.05, chunk=128)
    tr = type(tr)(*(x[0] for x in tr))
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


def test_ransac_batch_with_pool_fallbacks():
    """Three pairs in one call: a healthy pool, an empty pool (falls back
    to the scored set) and no valid match at all (falls back to everything);
    each equals the JAX solver on its own, same rank draws."""
    H = 256
    sets, keys = [], []
    for i, seed in enumerate((9, 10, 11)):
        _rs, ss, tt, valid, _R, _t = _correspondences(seed)
        pool = valid & (np.random.RandomState(seed).uniform(size=len(ss)) < 0.8)
        if i == 1:
            pool = np.zeros_like(pool)
        if i == 2:
            pool, valid = np.zeros_like(pool), np.zeros_like(valid)
        key = jax.random.PRNGKey(seed)
        ranks = np.array(jax.random.randint(
            key, (H, 3), 0, jnp.int32(RANK_RANGE), dtype=jnp.int32))
        sets.append((ss, tt, pool, valid, ranks))
        keys.append(key)
    tr = ransac_pose(*(T(np.stack(x)) for x in zip(*sets)), dist_th=0.05,
                     chunk=100)
    for i, (ss, tt, pool, valid, _ranks) in enumerate(sets):
        jr = j_ransac(jnp.asarray(ss), jnp.asarray(tt), jnp.asarray(pool),
                      jnp.asarray(valid), keys[i], dist_th=0.05,
                      num_hypotheses=H, chunk=128)
        np.testing.assert_allclose(tr.pose[i].numpy(), np.asarray(jr.pose),
                                   atol=1e-5)
        assert int(tr.num_inliers[i]) == int(jr.num_inliers)
        np.testing.assert_array_equal(tr.inlier_mask[i].numpy(),
                                      np.asarray(jr.inlier_mask))


def _gt(R, t):
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3], gt[:3, 3] = R, t
    return gt


def _perturbed(rs, gt, deg=1.5, shift=0.01):
    """``gt`` off by a small rotation about a random axis and a shift."""
    axis = rs.randn(3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    dR = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    out = gt.copy()
    out[:3, :3] = (dR @ gt[:3, :3]).astype(np.float32)
    out[:3, 3] += (shift * rs.randn(3)).astype(np.float32)
    return out


@pytest.mark.parametrize("seeds", [(12, 13), (14,)])
def test_post_refinement_matches_jax(seeds):
    """IRLS from a perturbed pose on correspondences with 40% outliers: the
    batch in one call against the JAX function pair by pair, poses within
    1e-4; the refined pose is closer to the truth than the start. The last
    problem of a batch starts so far off that no round finds 3 inliers: it
    keeps its pose."""
    sets = []
    for i, seed in enumerate(seeds):
        rs, ss, tt, valid, R, t = _correspondences(seed)
        gt = _gt(R, t)
        start = _perturbed(rs, gt)
        if len(seeds) > 1 and i == len(seeds) - 1:
            start[:3, 3] += 50.0
        sets.append((start, ss, tt, valid, gt))
    got = post_refinement(*(T(np.stack(x)) for x in list(zip(*sets))[:4]),
                          dist_th=0.1, num_iters=20)
    for i, (start, ss, tt, valid, gt) in enumerate(sets):
        want = j_irls(jnp.asarray(start), jnp.asarray(ss), jnp.asarray(tt),
                      jnp.asarray(valid), 0.1, num_iters=20)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-4)
        if start[0, 3] > 25.0:
            np.testing.assert_array_equal(got[i].numpy(), start)
        else:
            assert (float(tse3.compute_rre(got[i], T(gt)))
                    < 0.25 * float(tse3.compute_rre(T(start), T(gt))))


@pytest.mark.parametrize("seeds", [(15, 16, 17), (18,)])
def test_gnc_matches_jax(seeds):
    """GNC-TLS on correspondences with outliers: a batch in one call against
    the JAX function pair by pair: poses within 1e-4, inlier counts and
    final weights equal. The last problem of the longer batch has fewer
    than 3 valid correspondences (the degenerate guard)."""
    sets = []
    for i, seed in enumerate(seeds):
        _rs, ss, tt, valid, R, t = _correspondences(seed, inlier_frac=0.7)
        if len(seeds) > 1 and i == len(seeds) - 1:
            valid = np.zeros_like(valid)
            valid[:2] = True
        sets.append((ss, tt, valid, _gt(R, t)))
    got = gnc_tls_solve(*(T(np.stack(x)) for x in list(zip(*sets))[:3]),
                        noise_bound=0.02)
    for i, (ss, tt, valid, gt) in enumerate(sets):
        want = j_gnc(jnp.asarray(ss), jnp.asarray(tt), jnp.asarray(valid),
                     noise_bound=0.02)
        # two points do not fix a rotation: the degenerate problem's pose is
        # ill-conditioned, and only its counts and weights are compared
        if valid.sum() > 3:
            np.testing.assert_allclose(got.pose[i].numpy(),
                                       np.asarray(want.pose), atol=1e-4)
        assert bool(torch.isfinite(got.pose[i]).all())
        assert int(got.num_inliers[i]) == int(want.num_inliers)
        np.testing.assert_array_equal(got.weights[i].numpy(),
                                      np.asarray(want.weights))
        if valid.sum() > 3:
            assert float(tse3.compute_rte(got.pose[i], T(gt))) < 0.01
            assert float(tse3.compute_rre(got.pose[i], T(gt))) < 1.0
            assert int(got.num_inliers[i]) > 100
