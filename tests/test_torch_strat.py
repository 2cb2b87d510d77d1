"""Port parity: the fused stratified ball query (plain version of kernel K2).

The packed int32 result must be bit-exact against the JAX package's pure
twin (``_multi_reference``) and its Pallas kernel in interpret mode, given
the same d2, quantized coordinates and JAX's own strip offsets. The port's
functions take a leading cloud dimension (one kernel launch for a batch of
clouds); the JAX side is run cloud by cloud.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.kernels import strat_pallas as jstrat
from bufferx_tpu_torch.kernels import strat_pallas as tstrat
from bufferx_tpu_torch.kernels.neighbors import masked_sqdist

N, S, K = 2048, 64, 96
L = N // S


def _inputs(seed):
    rs = np.random.RandomState(seed)
    pts = (rs.randn(N, 3) * 0.4 + [3.0, -1.0, 0.5]).astype(np.float32)
    mask = np.ones(N, bool)
    mask[rs.choice(N, 200, replace=False)] = False
    centers = pts[rs.choice(np.flatnonzero(mask), K, replace=False)]
    d2 = masked_sqdist(torch.from_numpy(centers), torch.from_numpy(pts),
                       torch.ones(K, dtype=torch.bool),
                       torch.from_numpy(mask)).numpy()
    radii = np.asarray([0.45, 0.2, 0.08], np.float32)
    key = jax.random.PRNGKey(seed)
    off = np.array(jax.random.randint(key, (K, S), 0, L, dtype=jnp.int32))
    return pts, mask, centers, d2, radii, key, off


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_and_packed_match_reference(seed):
    pts, mask, _c, d2, radii, _k, off = _inputs(seed)
    jq, jlo, jres = jstrat._quantize(jnp.asarray(pts), jnp.asarray(mask))
    tq, tlo, tres = tstrat.quantize(torch.from_numpy(pts)[None],
                                    torch.from_numpy(mask)[None])
    np.testing.assert_array_equal(tq[0].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tlo[0].numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tres[0].numpy(), np.asarray(jres))
    radii2 = radii * radii
    want = jstrat._multi_reference(jnp.asarray(d2), jq, jnp.asarray(off),
                                   jnp.asarray(radii2), S)
    q_t = tq.reshape(1, L, S, 3).permute(0, 3, 1, 2).contiguous()
    got = tstrat.strat_packed_plain(torch.from_numpy(d2)[None], q_t,
                                    torch.from_numpy(off)[None],
                                    torch.from_numpy(radii2)[None])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def _cloud_case(rs, kq, l, s, num_r):
    """One cloud's seeded kernel inputs at a ragged shape: d2 with a share
    of exact-radius and masked (1e30) entries, quantized coordinates,
    offsets, squared radii."""
    d2 = rs.uniform(0.0, 1.0, (kq, l * s)).astype(np.float32)
    d2[rs.uniform(size=d2.shape) < 0.1] = 1e30
    # hit rates that leave some slots of every shape with and without a hit
    radii2 = np.sort(np.minimum(rs.uniform(0.2, 3.0, num_r) / l, 0.6)
                     .astype(np.float32))[::-1]
    d2[rs.uniform(size=d2.shape) < 0.02] = radii2[0]      # d2 == r^2 is inside
    q = rs.randint(0, 1 << 24, (l * s, 3)).astype(np.int32)
    off = rs.randint(0, l, (kq, s)).astype(np.int32)
    return d2, q, off, radii2.copy()


# (clouds, centres, strips L, slots S, radii R): C = 1, 2, 5; R = 1..4; S not
# a multiple of the kernel's tiles (64, 128) nor of 4; fewer centres than a
# block's share; L = 1 and the largest L the packing takes
_SHAPES = [(1, 96, 32, 64, 3), (2, 40, 9, 128, 1), (5, 7, 5, 36, 2),
           (2, 3, 1, 200, 4), (1, 5, 127, 6, 3), (2, 1, 59, 130, 3)]


@pytest.mark.parametrize("c_n,kq,l,s,num_r", _SHAPES)
def test_packed_with_cloud_dimension_matches_reference(c_n, kq, l, s, num_r):
    """The plain version with the cloud dimension, cloud by cloud against
    the JAX package's pure twin: bit-exact."""
    rs = np.random.RandomState(c_n * 1000 + kq)
    cases = [_cloud_case(rs, kq, l, s, num_r) for _ in range(c_n)]
    d2, q, off, radii2 = (np.stack(x) for x in zip(*cases))
    q_t = torch.from_numpy(q).reshape(c_n, l, s, 3).permute(0, 3, 1, 2)
    got = tstrat.strat_packed_plain(
        torch.from_numpy(d2), q_t.contiguous(), torch.from_numpy(off),
        torch.from_numpy(radii2))
    assert got.shape == (c_n, num_r, 3, kq, s) and got.dtype == torch.int32
    for c in range(c_n):
        want = jstrat._multi_reference(
            jnp.asarray(d2[c]), jnp.asarray(q[c]), jnp.asarray(off[c]),
            jnp.asarray(radii2[c]), s)
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want))
    # a slot with no hit carries score L and the least coordinate of its
    # strips, which the kernel keeps apart from the loop over strips
    no_hit = (got[:, :, 0] >> tstrat.QBITS) == l
    assert bool(no_hit.any()) and not bool(no_hit.all())


def test_d2_view_with_a_larger_cloud_stride():
    """The batched path hands the query the first K rows of each cloud's
    [K', N] matrix as a view: same result as the contiguous copy."""
    rs = np.random.RandomState(9)
    cases = [_cloud_case(rs, 12, 8, 32, 2) for _ in range(3)]
    d2, q, off, radii2 = (torch.from_numpy(np.stack(x)) for x in zip(*cases))
    q_t = q.reshape(3, 8, 32, 3).permute(0, 3, 1, 2).contiguous()
    view = d2[:, :7]
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        tstrat.strat_packed_plain(view, q_t, off[:, :7], radii2).numpy(),
        tstrat.strat_packed_plain(view.contiguous(), q_t,
                                  off[:, :7].contiguous(), radii2).numpy())


def test_decoded_patches_match_pallas_interpret():
    """Two clouds in one call against the Pallas kernel in interpret mode,
    cloud by cloud."""
    clouds = [_inputs(2), _inputs(5)]
    stacked = [torch.from_numpy(np.stack([c[i] for c in clouds]))
               for i in (0, 1, 2, 3, 4, 6)]
    pts, mask, centers, d2, radii, off = stacked
    tp, tv = tstrat.ball_query_stratified_multi(pts, mask, centers, radii,
                                                off, S, d2)
    for c, (cp, cm, cc, cd, cr, key, _off) in enumerate(clouds):
        jp, jv = jstrat.ball_query_stratified_multi(
            jnp.asarray(cp), jnp.asarray(cm), jnp.asarray(cc),
            jnp.asarray(cr), key, S, jnp.asarray(cd), interpret=True,
        )
        np.testing.assert_array_equal(tv[c].numpy(), np.asarray(jv))
        # lo + q * res may round once differently (fused multiply-add)
        np.testing.assert_allclose(tp[c].numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-6)
    assert tv.float().mean() > 0.2           # the query selects something


def test_guards():
    pts, mask, centers, d2, radii, _k, off = (
        torch.from_numpy(x)[None] if isinstance(x, np.ndarray) else x
        for x in _inputs(3))
    with pytest.raises(ValueError):   # N not a multiple of nsample
        tstrat.ball_query_stratified_multi(pts, mask, centers, radii, off, 60,
                                           d2)
    big = torch.zeros(1, 2, 256 * 4)      # L = 256 overflows the packing
    with pytest.raises(ValueError):
        tstrat.ball_query_stratified_multi(
            torch.zeros(1, 1024, 3), torch.ones(1, 1024, dtype=torch.bool),
            torch.zeros(1, 2, 3), torch.ones(1, 1),
            torch.zeros(1, 2, 4, dtype=torch.int32), 4, big)
    with pytest.raises(ValueError):   # off without the cloud dimension
        tstrat.ball_query_stratified_multi(pts, mask, centers, radii, off[0],
                                           S, d2)
    with pytest.raises(ValueError):   # kernel wrapper: CUDA tensors only
        tstrat.strat_packed_cuda(
            torch.zeros(1, 2, 8), torch.zeros(1, 3, 2, 4, dtype=torch.int32),
            torch.zeros(1, 2, 4, dtype=torch.int32), torch.ones(1, 1))
    with pytest.raises(ValueError):   # kernel wrapper: 1..4 radii
        tstrat.strat_packed_cuda(
            torch.zeros(1, 2, 8), torch.zeros(1, 3, 2, 4, dtype=torch.int32),
            torch.zeros(1, 2, 4, dtype=torch.int32), torch.ones(1, 5))
