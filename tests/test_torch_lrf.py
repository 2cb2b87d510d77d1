"""Port parity of the per-patch gravity flag in
``bufferx_tpu_torch/geometry/lrf.py:align_patches``.

A [K] bool tensor selects, patch by patch, between the global frame and the
patch's LRF, as the JAX function does when ``register_pair_jit`` is mapped
over pairs with one flag each (``jax.vmap`` over patches with a scalar flag
here). Half the patches flagged True, half False: the port's tensor form
equals the JAX function within 1e-5 (the 3x3 eigensolver rounds
differently in XLA and in PyTorch) and equals the port's own bool branch
on each half to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bufferx_tpu.geometry.lrf import align_patches as jax_align
from bufferx_tpu_torch.geometry.lrf import align_patches


def _patches(k=64, p=48, seed=0):
    rs = np.random.RandomState(seed)
    kpts = (rs.randn(k, 3) * 2.0).astype(np.float32)
    # flattened blobs of random orientation: a well-defined normal each
    delta = rs.randn(k, p, 3) * np.array([0.3, 0.2, 0.03])
    q, _ = np.linalg.qr(rs.randn(k, 3, 3))
    delta = np.einsum("kpi,kji->kpj", delta, q).astype(np.float32)
    delta[:, -5:] = 0.0                       # invalid slots carry zeros
    return delta, kpts


def test_per_patch_flag_matches_jax_and_the_bool_branch():
    delta, kpts = _patches()
    k, h = delta.shape[0], delta.shape[0] // 2
    flags = np.arange(k) % 2 == 0
    order = np.argsort(~flags, kind="stable")     # the True half first
    delta, kpts, flags = delta[order], kpts[order], flags[order]
    got = align_patches(torch.from_numpy(delta), torch.from_numpy(kpts),
                        torch.from_numpy(flags))
    want = jax.vmap(lambda d, c, a: jax_align(d[None], c[None], a))(
        jnp.asarray(delta), jnp.asarray(kpts), jnp.asarray(flags))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, 0], rtol=0,
                                   atol=1e-5)
    halves = {True: slice(0, h), False: slice(h, k)}
    for flag, sl in halves.items():
        assert bool(flags[sl].all()) == flag and bool(flags[sl].any()) == flag
        ref = align_patches(torch.from_numpy(delta[sl]),
                            torch.from_numpy(kpts[sl]), flag)
        for g, r in zip(got, ref):
            assert torch.equal(g[sl], r)
    # the True half is the global frame itself
    assert torch.equal(got[0][:h], torch.from_numpy(delta[:h]))
    assert torch.equal(got[2][:h], torch.eye(3).expand(h, 3, 3))
