"""Port parity of the seven training losses (``train/losses.py``) and their
gradients against the JAX functions, on seeded inputs with padded slots,
spatially near keypoints, ties and saturated hinges.

Tolerance: float32 on both sides, the same operations in the same order
except for reductions: values and gradients within 1e-5 of the largest
magnitude (at least 1); accuracies equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.train import losses as jl
from bufferx_tpu_torch.train import losses as tl

TOL = 1e-5


def _close(ref, got, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def _descs(seed, n=24, c=32):
    rs = np.random.RandomState(seed)
    a = rs.randn(n, c).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    p = a + rs.randn(n, c).astype(np.float32) * 0.3
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    k = rs.uniform(0, 1, (n, 3)).astype(np.float32)
    d = np.sqrt(((k[:, None] - k[None]) ** 2).sum(-1)).astype(np.float32)
    ks = k + rs.randn(n, 3).astype(np.float32) * 0.05
    ds = np.sqrt(((ks[:, None] - ks[None]) ** 2).sum(-1)).astype(np.float32)
    valid = rs.rand(n) < 0.8
    return a, p, d, ds, valid


def _grad_pair(jfn, tfn, arrays, argnums):
    """(JAX value and grads, port value and grads) of a scalar loss."""
    jv, jg = jax.value_and_grad(
        lambda *xs: jfn(*xs), argnums=argnums)(*map(jnp.asarray, arrays))
    ts = [torch.tensor(x, requires_grad=i in argnums)
          for i, x in enumerate(arrays)]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, [ts[i] for i in argnums])
    return (jv, jg), (tv, tg)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("safe_radius", [0.1, 0.3])
def test_contrastive_loss(seed, symmetric, safe_radius):
    a, p, d, ds, valid = _descs(seed)
    kw = dict(safe_radius=safe_radius)

    def jfn(a, p):
        return jl.contrastive_loss(a, p, jnp.asarray(d), jnp.asarray(valid),
                                   dist_keypts_src=jnp.asarray(ds)
                                   if symmetric else None, **kw)[0]

    def tfn(a, p):
        return tl.contrastive_loss(a, p, torch.from_numpy(d),
                                   torch.from_numpy(valid),
                                   dist_keypts_src=torch.from_numpy(ds)
                                   if symmetric else None, **kw)[0]

    (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, [a, p], (0, 1))
    _close(jv, tv, "loss")
    for i in range(2):
        _close(jg[i], tg[i], f"grad {i}")
    _, jacc = jl.contrastive_loss(jnp.asarray(a), jnp.asarray(p),
                                  jnp.asarray(d), jnp.asarray(valid), **kw)
    _, tacc = tl.contrastive_loss(torch.from_numpy(a), torch.from_numpy(p),
                                  torch.from_numpy(d), torch.from_numpy(valid),
                                  **kw)
    assert float(jacc) == float(tacc)


def test_contrastive_loss_all_invalid_is_zero():
    a, p, d, _, _ = _descs(3)
    none = np.zeros(len(a), bool)
    jv = jl.contrastive_loss(jnp.asarray(a), jnp.asarray(p), jnp.asarray(d),
                             jnp.asarray(none))
    tv = tl.contrastive_loss(torch.from_numpy(a), torch.from_numpy(p),
                             torch.from_numpy(d), torch.from_numpy(none))
    assert float(jv[0]) == float(tv[0]) == 0.0
    assert float(jv[1]) == float(tv[1]) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_so2_cross_entropy(seed):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(40, 20) * 3).astype(np.float32)
    logits[5, 3] = logits[5, 7] = logits[5].max() + 1.0   # a tie in argmax
    labels = rs.randint(0, 20, 40)
    labels[5] = 3
    valid = rs.rand(40) < 0.7

    def jfn(x):
        return jl.so2_cross_entropy(x, jnp.asarray(labels),
                                    jnp.asarray(valid))[0]

    def tfn(x):
        return tl.so2_cross_entropy(x, torch.from_numpy(labels),
                                    torch.from_numpy(valid))[0]

    (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, [logits], (0,))
    _close(jv, tv, "loss")
    _close(jg[0], tg[0], "grad")
    jacc = jl.so2_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(valid))[1]
    tacc = tl.so2_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.from_numpy(valid))[1]
    assert float(jacc) == float(tacc)


def test_so2_cross_entropy_label_outside_the_bins_is_nan():
    logits = torch.zeros(2, 4)
    loss, _ = tl.so2_cross_entropy(logits, torch.tensor([1, -5]),
                                   torch.ones(2, dtype=torch.bool))
    assert torch.isnan(loss)


@pytest.mark.parametrize("delta", [1.0, 0.5])
def test_huber_loss(delta):
    rs = np.random.RandomState(4)
    pred = rs.uniform(0, 20, 50).astype(np.float32)
    target = (pred + rs.randn(50) * 1.5).astype(np.float32)
    valid = rs.rand(50) < 0.8

    def jfn(x):
        return jl.huber_loss(x, jnp.asarray(target), jnp.asarray(valid),
                             delta=delta)

    def tfn(x):
        return tl.huber_loss(x, torch.from_numpy(target),
                             torch.from_numpy(valid), delta=delta)

    (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, [pred], (0,))
    _close(jv, tv, "loss")
    _close(jg[0], tg[0], "grad")


def test_contrastive_loss_with_sos():
    a, p, d, _, valid = _descs(5)

    def jfn(a, p):
        return jl.contrastive_loss_with_sos(a, p, jnp.asarray(d),
                                            jnp.asarray(valid))[0]

    def tfn(a, p):
        return tl.contrastive_loss_with_sos(a, p, torch.from_numpy(d),
                                            torch.from_numpy(valid))[0]

    (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, [a, p], (0, 1))
    _close(jv, tv, "loss")
    _close(jg[0], tg[0], "grad a")
    _close(jg[1], tg[1], "grad p")


def test_hardest_contrastive_loss():
    a, p, _, _, valid = _descs(6)

    def jfn(a, p):
        return jl.hardest_contrastive_loss(a, p, jnp.asarray(valid))

    def tfn(a, p):
        return tl.hardest_contrastive_loss(a, p, torch.from_numpy(valid))

    (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, [a, p], (0, 1))
    _close(jv, tv, "loss")
    _close(jg[0], tg[0], "grad a")
    _close(jg[1], tg[1], "grad p")


def test_inlier_classification_loss():
    rs = np.random.RandomState(7)
    logits = (rs.randn(60) * 4).astype(np.float32)
    labels = (rs.rand(60) < 0.3).astype(np.int32)
    valid = rs.rand(60) < 0.9

    def jfn(x):
        return jl.inlier_classification_loss(x, jnp.asarray(labels),
                                             jnp.asarray(valid))

    def tfn(x):
        return tl.inlier_classification_loss(x, torch.from_numpy(labels),
                                             torch.from_numpy(valid))

    (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, [logits], (0,))
    _close(jv, tv, "loss")
    _close(jg[0], tg[0], "grad")


@pytest.mark.parametrize("loss_type", ["frobenius", "geodesic"])
def test_transformation_loss(loss_type):
    rs = np.random.RandomState(8)
    poses = []
    for _ in range(2):
        q = np.linalg.qr(rs.randn(3, 3))[0]
        q *= np.sign(np.linalg.det(q))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = q, rs.randn(3)
        poses.append(T)

    def jfn(x):
        return jl.transformation_loss(x, jnp.asarray(poses[1]), loss_type)

    def tfn(x):
        return tl.transformation_loss(x, torch.from_numpy(poses[1]),
                                      loss_type)

    (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, [poses[0]], (0,))
    _close(jv, tv, "loss")
    _close(jg[0], tg[0], "grad")
    with pytest.raises(ValueError):
        tl.transformation_loss(torch.eye(4), torch.eye(4), "chordal")
