"""Port parity: the fused stratified ball query (plain version of kernel K2).

The packed int32 result must be bit-exact against the JAX package's pure
twin (``_multi_reference``) and its Pallas kernel in interpret mode, given
the same d2, quantized coordinates and JAX's own strip offsets.
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
    tq, tlo, tres = tstrat.quantize(torch.from_numpy(pts), torch.from_numpy(mask))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    radii2 = radii * radii
    want = jstrat._multi_reference(jnp.asarray(d2), jq, jnp.asarray(off),
                                   jnp.asarray(radii2), S)
    q_t = tq.reshape(L, S, 3).permute(2, 0, 1).contiguous()
    got = tstrat.strat_packed_plain(torch.from_numpy(d2), q_t,
                                    torch.from_numpy(off),
                                    torch.from_numpy(radii2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decoded_patches_match_pallas_interpret():
    pts, mask, centers, d2, radii, key, off = _inputs(2)
    jp, jv = jstrat.ball_query_stratified_multi(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers),
        jnp.asarray(radii), key, S, jnp.asarray(d2), interpret=True,
    )
    tp, tv = tstrat.ball_query_stratified_multi(
        torch.from_numpy(pts), torch.from_numpy(mask),
        torch.from_numpy(centers), torch.from_numpy(radii),
        torch.from_numpy(off), S, torch.from_numpy(d2),
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # lo + q * res may round once differently (fused multiply-add)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    assert tv.float().mean() > 0.2           # the query selects something


def test_guards():
    pts, mask, centers, d2, radii, _k, off = _inputs(3)
    with pytest.raises(ValueError):   # N not a multiple of nsample
        tstrat.ball_query_stratified_multi(
            torch.from_numpy(pts), torch.from_numpy(mask),
            torch.from_numpy(centers), torch.from_numpy(radii),
            torch.from_numpy(off), 60, torch.from_numpy(d2))
    big = torch.zeros(2, 256 * 4)      # L = 256 overflows the packing
    with pytest.raises(ValueError):
        tstrat.ball_query_stratified_multi(
            torch.zeros(1024, 3), torch.ones(1024, dtype=torch.bool),
            torch.zeros(2, 3), torch.ones(1), torch.zeros(2, 4, dtype=torch.int32),
            4, big)
    with pytest.raises(ValueError):   # kernel wrapper: CUDA tensors only
        tstrat.strat_packed_cuda(torch.zeros(2, 8), torch.zeros(
            3, 2, 4, dtype=torch.int32), torch.zeros(2, 4, dtype=torch.int32),
            torch.ones(1))
