"""Port parity: the fused conv stack's weight fold and the plain version of
kernel K5, against :mod:`bufferx_tpu.kernels.conv_pallas`.

Tolerances: the fold's BN scale is ``rsqrt(var + eps)``, which XLA's CPU
backend approximates (13% of random f32 inputs land one ulp off the
correctly rounded value, which ``torch.rsqrt`` returns), so the folded f32
bias agrees to 2 ulps, not exactly (measured: 159 of 1024 entries differ,
by at most 2 ulps), and a folded bf16 weight may round to the other bf16
neighbour (measured 1 of 681,984 entries; pinned at 1 in 10^4).

The plain stack and the JAX reference share every rounding point and differ
only in f32 summation order. Where a sum lands within that difference of a
bf16 rounding boundary, the activation rounds to the other bf16 neighbour,
and the later layers carry the step. With small random weights (outputs
below 1) that stays under 1e-2 absolute, the JAX package's own kernel
bound, which this test keeps. With the shipped weights the outputs pass 8,
where one bf16 step is 2^-4: there the bound is two bf16 steps at the
output's largest magnitude, ``2^-6 * 2^floor(log2 max|ref|)``, and a mean
error under 2^-8 of the mean magnitude (a small fraction of a step;
measured: 0.0625, one step at max |ref| 10, and a mean of 7.2e-4 against
a mean magnitude of 1.42; with random weights 0.0078).

The fused module against the unfused bf16 stack: BN applied to bf16
activations or folded into the weights moves values by bf16 steps, so at
most 8% of the output's standard deviation, as the JAX package bounds the
same comparison.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.kernels.conv_pallas import (
    cyl_conv_stack_fused,
    cyl_conv_stack_reference,
)
from bufferx_tpu.kernels.conv_pallas import fold_cyl_stack as jax_fold
from bufferx_tpu_torch.kernels.conv_pallas import (
    CYL_LAYER_CHANNELS,
    cyl_conv_stack,
    cyl_conv_stack_cuda,
    cyl_conv_stack_plain,
    fold_cyl_stack,
    pack_cyl_weights,
)
from bufferx_tpu_torch.models.layers import (
    CylindricalConvNet,
    FusedCylindricalConvNet,
)
from bufferx_tpu_torch.tools.weights import load_snapshot

SNAP = os.path.join(os.path.dirname(__file__), "..", "snapshot", "hard")
FOLD_FLIP_BOUND = 1e-4
BIAS_ULPS = 2


def _assert_stack_close(got, want, weights):
    err = np.abs(got - want)
    if weights == "random":
        assert float(err.max()) <= 1e-2
        return
    step = 2.0 ** np.floor(np.log2(np.abs(want).max()))
    assert float(err.max()) <= 2.0 ** -6 * step, (err.max(), step)
    assert float(err.mean()) <= 2.0 ** -8 * float(np.abs(want).mean())


@pytest.fixture(scope="module")
def folds():
    with open(os.path.join(SNAP, "Desc", "best.msgpack"), "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    layers = []
    n = len(CYL_LAYER_CHANNELS)
    for i in range(n):
        conv = tree["params"]["CylindricalConvNet_0"][f"ConvBNRelu_{i}"]["Conv_0"]
        if i < n - 1:
            st = tree["batch_stats"]["CylindricalConvNet_0"][f"ConvBNRelu_{i}"][
                "BatchNorm_0"]
            layers.append((jnp.asarray(conv["kernel"]), jnp.asarray(conv["bias"]),
                           jnp.asarray(st["mean"]), jnp.asarray(st["var"])))
        else:
            layers.append((jnp.asarray(conv["kernel"]), jnp.asarray(conv["bias"]),
                           None, None))
    jw, jb = jax_fold(layers)
    sd = load_snapshot(SNAP)["desc"]
    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    tw, tb = fold_cyl_stack(backbone)
    return (np.array(jw.astype(jnp.float32)), np.array(jb),
            tw, tb, backbone)


def _inputs(seed, k=10):
    rs = np.random.RandomState(seed)
    return np.maximum(rs.randn(k, 3, 7, 20, 16), 0.0).astype(np.float32)


def test_fold_matches_jax(folds):
    jw, jb, tw, tb, _ = folds
    assert tw.dtype == torch.bfloat16 and tuple(tw.shape) == (5328, 128)
    assert tb.dtype == torch.float32 and tuple(tb.shape) == (8, 128)
    ulps = np.abs(tb.numpy().view(np.int32).astype(np.int64)
                  - jb.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= BIAS_ULPS
    flips = int((tw.float().numpy() != jw).sum())
    assert flips <= FOLD_FLIP_BOUND * jw.size, flips


@pytest.mark.parametrize("weights", ["snapshot", "random"])
def test_plain_matches_jax_reference(folds, weights):
    jw, jb, *_ = folds
    if weights == "random":
        rs = np.random.RandomState(3)
        jw = (jw != 0) * rs.randn(*jw.shape).astype(np.float32) * 0.05
        jw = np.array(jnp.asarray(jw).astype(jnp.bfloat16).astype(jnp.float32))
        jb = (rs.randn(*jb.shape) * 0.1).astype(np.float32)
    x = _inputs(0)
    want = np.asarray(cyl_conv_stack_reference(
        jnp.asarray(x), jnp.asarray(jw, jnp.bfloat16), jnp.asarray(jb)))
    got = cyl_conv_stack_plain(torch.from_numpy(x),
                               torch.from_numpy(jw).to(torch.bfloat16),
                               torch.from_numpy(jb))
    assert got.dtype == torch.float32 and tuple(got.shape) == (10, 7, 20, 32)
    _assert_stack_close(got.numpy(), want, weights)


def test_plain_matches_pallas_interpret(folds):
    jw, jb, *_ = folds
    x = _inputs(1, k=4)
    want = np.asarray(cyl_conv_stack_fused(
        jnp.asarray(x), jnp.asarray(jw, jnp.bfloat16), jnp.asarray(jb),
        interpret=True))
    got = cyl_conv_stack(torch.from_numpy(x),
                         torch.from_numpy(jw).to(torch.bfloat16),
                         torch.from_numpy(jb)).numpy()
    _assert_stack_close(got, want, "snapshot")


def test_fused_module_loads_and_folds(folds):
    _jw, _jb, tw, tb, backbone = folds
    fused = FusedCylindricalConvNet()
    missing, unexpected = fused.load_state_dict(backbone, strict=True)
    assert not missing and not unexpected
    assert "folded_w" not in fused.state_dict()
    assert torch.equal(fused.folded_w, tw) and torch.equal(fused.folded_b, tb)
    ref = CylindricalConvNet(32, 1.0, torch.bfloat16)
    ref.load_state_dict(backbone, strict=True)
    ref.eval()                # running statistics, as the fused stack folds
    x = torch.from_numpy(_inputs(2)).permute(0, 4, 1, 2, 3)   # [K, 16, 3, 7, 20]
    with torch.no_grad():
        want = ref(x)
        with pytest.raises(RuntimeError):    # serving-only, as in JAX
            fused.train()(x)
        got = fused.eval()(x)
    assert got.shape == want.shape == (10, 32, 7, 20)
    assert float((got - want).abs().max()) <= 0.08 * float(want.std())
    with pytest.raises(ValueError):
        FusedCylindricalConvNet(dim=16)


def test_dispatch_and_guards(folds):
    _jw, _jb, tw, tb, _ = folds
    x = torch.from_numpy(_inputs(4, k=2))
    with pytest.raises(ValueError):          # kernel wrapper: CUDA tensors only
        cyl_conv_stack_cuda(x, tw, tb)
    with pytest.raises(ValueError):          # fixed geometry
        cyl_conv_stack_plain(x[:, :2], tw, tb)


def _unpack(packed):
    """Inverse of ``pack_cyl_weights``, written out on its own: walk the
    packed tiles ``(layer, tap, ci/8, co, 8)`` back into ``[5328, 128]``;
    the padding lanes the pack drops are zero."""
    packed = packed.view(torch.int16).numpy()
    out = np.zeros((5328, 128), np.int16)
    pos = row = 0
    for ci, co in CYL_LAYER_CHANNELS:
        for tap in range(9):
            tile = packed[pos:pos + ci * co].reshape(ci // 8, co, 8)
            out[row:row + ci, :co] = tile.transpose(0, 2, 1).reshape(ci, co)
            pos += ci * co
            row += ci
    assert pos == packed.size and row == 5328
    return out


@pytest.mark.parametrize("weights", ["snapshot", "random"])
def test_pack_is_a_permutation_of_the_fold(folds, weights):
    _jw, _jb, tw, _tb, _ = folds
    if weights == "random":
        rs = np.random.RandomState(5)
        # where, not a product: the padding lanes must stay +0, not -0
        tw = torch.from_numpy(np.where(
            tw.float().numpy() != 0, rs.randn(*tw.shape), 0.0
        ).astype(np.float32)).to(torch.bfloat16)
    packed = pack_cyl_weights(tw)
    assert packed.dtype == torch.bfloat16
    assert tuple(packed.shape) == (9 * sum(ci * co for ci, co in
                                           CYL_LAYER_CHANNELS),)
    # bit for bit: compare the 16-bit patterns, not the values
    np.testing.assert_array_equal(_unpack(packed),
                                  tw.view(torch.int16).numpy())
    with pytest.raises(ValueError):
        pack_cyl_weights(tw[:, :64])


def test_fused_module_packs_on_build_and_load(folds):
    _jw, _jb, tw, _tb, backbone = folds
    fused = FusedCylindricalConvNet()
    assert torch.equal(fused.packed_w, pack_cyl_weights(fused.folded_w))
    before = fused.packed_w.clone()
    fused.load_state_dict(backbone, strict=True)
    assert "packed_w" not in fused.state_dict()
    assert torch.equal(fused.folded_w, tw)
    assert torch.equal(fused.packed_w, pack_cyl_weights(tw))
    assert not torch.equal(fused.packed_w, before)
    # the packed tensor rides along: the CPU dispatch ignores it
    x = torch.from_numpy(_inputs(6, k=2))
    assert torch.equal(cyl_conv_stack(x, tw, fused.folded_b, fused.packed_w),
                       cyl_conv_stack_plain(x, tw, fused.folded_b))
