"""Port parity: MiniSpinNet (moments, gated) and CostVolume, layer by layer,
with the shipped ``hard_moments_r4ft2`` checkpoint, in float32 and bf16; the
softmax pool (``hard_moments_r4``) and width 2.0 (``r5_w2_scratch``) the
same way; and
the sampled MiniSpinNet with ``snapshot/hard`` in bf16, with the cuDNN
backbone and with the fused conv stack (kernel K5's plain version on the
JAX side's ``cyl_conv_stack_reference``).

Tolerances, against the layer's largest magnitude (at least 1): float32
layers to 1e-5 (convolutions sum in another order in XLA and in PyTorch;
measured <= 1.1e-6); bf16 layers to 3e-2 (a bf16 rounding flip, 2^-8
relative, moves an activation by one bf16 step that later layers carry;
measured <= 1.1e-2). Outputs: desc/equi to 1e-5 in f32 and 5e-3/2e-2 in
bf16 (measured 5.6e-4/3.4e-3); the rotation index to 1e-4 bins in f32 and
0.05 bins (0.9 degrees) in bf16 (measured 8.8e-3). The sampled net keeps
the same bf16 tolerances; the fused backbone's output carries bf16 steps
that a rounding flip propagates (one step is 2^-7 of the value, under the
3e-2 layer bound).
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.models.heads import CostVolume as JaxCostVolume
from bufferx_tpu.models.spinnet import MiniSpinNet as JaxMiniSpinNet
from bufferx_tpu_torch.models.heads import CostVolume
from bufferx_tpu_torch.models.spinnet import MiniSpinNet
from bufferx_tpu_torch.tools.weights import load_snapshot, load_snapshot_config

SNAP = os.path.join(os.path.dirname(__file__), "..", "snapshot",
                    "hard_moments_r4ft2")
SNAP_SAMPLED = os.path.join(os.path.dirname(__file__), "..", "snapshot",
                            "hard")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LAYER_TOL = {"f32": 1e-5, "bf16": 3e-2}


def _restore(snap, stage):
    with open(os.path.join(snap, stage, "best.msgpack"), "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    return {"desc": _restore(SNAP, "Desc"), "pose": _restore(SNAP, "Pose"),
            "torch": load_snapshot(SNAP)}


def _hook_outputs(modules: dict) -> dict:
    got = {}
    for name, mod in modules.items():
        mod.register_forward_hook(
            lambda _m, _i, out, name=name: got.__setitem__(name, out)
        )
    return got


def _stem_out(t):
    """The moments stem's output, handed on as the backbone's padded input
    [K, 16, rad, ele + 2, azi + 2] ("pad3d"), back to channels-last [K, G,
    16]."""
    t = t[..., 1:-1, 1:-1]
    return t.permute(0, 2, 3, 4, 1).reshape(t.shape[0], -1, t.shape[1])


def _backbone_out(t, i):
    """Backbone layer ``i``'s output: layers 0-6 hand on the next layer's
    padded input ("pad2d"), layer 0 without its rad = 1 axis."""
    if i == 7:
        return t
    t = t[..., 1:-1, 1:-1]
    return t[:, :, None] if i == 0 else t


def _close(jax_out, torch_out, tol, what):
    ref = np.asarray(jax_out, dtype=np.float32)
    got = torch_out.detach().float().numpy()
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_minispinnet_layerwise(weights, dt):
    jdt, tdt = DTYPES[dt]
    rs = np.random.RandomState(0)
    x = (rs.randn(6, 10, 420) * 0.5).astype(np.float32)
    jm = JaxMiniSpinNet(mode="moments", pool="gated", compute_dtype=jdt)
    out, inter = jm.apply(weights["desc"], jnp.asarray(x), train=False,
                          capture_intermediates=True)
    inter = inter["intermediates"]
    tm = MiniSpinNet(compute_dtype=tdt)
    tm.load_state_dict(weights["torch"]["desc"], strict=True)
    tm.eval()                 # serving: BatchNorm from running statistics
    hooked = {"stem": tm.stem, "att_hidden": tm.att_hidden,
              "att_gate": tm.att_gate}
    hooked.update({f"backbone.{i}": layer
                   for i, layer in enumerate(tm.backbone.layers)})
    got = _hook_outputs(hooked)
    with torch.no_grad():
        o = tm(torch.from_numpy(x))

    tol = LAYER_TOL[dt]
    _close(inter["ConvBNRelu_0"]["__call__"][0], _stem_out(got["stem"]), tol,
           "stem")
    for i in range(8):
        ref = inter["CylindricalConvNet_0"][f"ConvBNRelu_{i}"]["__call__"][0]
        _close(ref, torch.movedim(_backbone_out(got[f"backbone.{i}"], i), 1,
                                  -1), tol, f"backbone layer {i}")
    for jname, tname in (("ConvBNRelu_1", "att_hidden"),
                         ("ConvBNRelu_2", "att_gate")):
        _close(inter[jname]["__call__"][0], torch.movedim(got[tname], 1, -1),
               tol, tname)
    desc_tol, equi_tol = (1e-5, 1e-5) if dt == "f32" else (5e-3, 2e-2)
    _close(out["desc"], o["desc"], desc_tol, "desc")
    _close(out["equi"], o["equi"], equi_tol, "equi")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cost_volume_layerwise(weights, dt):
    jdt, tdt = DTYPES[dt]
    rs = np.random.RandomState(1)

    def unit_maps():
        d = rs.randn(5, 32, 5, 20).astype(np.float32)
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    d1, d2 = unit_maps(), unit_maps()
    jc = JaxCostVolume(azi_n=20, compute_dtype=jdt)
    ind, inter = jc.apply(weights["pose"], jnp.asarray(d1), jnp.asarray(d2),
                          train=False, capture_intermediates=True)
    inter = inter["intermediates"]
    tc = CostVolume(compute_dtype=tdt)
    tc.load_state_dict(weights["torch"]["pose"], strict=True)
    tc.eval()
    hooked = {"stem": tc.stem}
    hooked.update({f"layer.{i}": layer for i, layer in enumerate(tc.layers)})
    got = _hook_outputs(hooked)
    with torch.no_grad():
        t_ind = tc(torch.from_numpy(d1), torch.from_numpy(d2))

    tol = LAYER_TOL[dt]
    _close(inter["ConvBNRelu_0"]["__call__"][0],
           torch.movedim(got["stem"], 1, -1), tol, "stem")
    for i in range(9):
        _close(inter[f"ConvBNRelu_{i + 1}"]["__call__"][0],
               torch.movedim(got[f"layer.{i}"], 1, -1), tol, f"layer {i}")
    ind_tol = 1e-4 if dt == "f32" else 0.05
    err = float(np.abs(np.asarray(ind) - t_ind.numpy()).max())
    assert err <= ind_tol, f"rotation index off by {err} bins"


@pytest.mark.parametrize("fused", [False, True])
def test_minispinnet_sampled_layerwise(fused):
    """Sampled mode with ``snapshot/hard`` in bf16: stem, backbone output,
    attention layers and outputs against the JAX net."""
    rs = np.random.RandomState(2)
    x = (rs.randn(6, 420, 10, 3) * 0.3).astype(np.float32)
    jm = JaxMiniSpinNet(mode="sampled", pool="gated",
                        compute_dtype=jnp.bfloat16, fused_conv=fused)
    out, inter = jm.apply(_restore(SNAP_SAMPLED, "Desc"), jnp.asarray(x),
                          train=False, capture_intermediates=True)
    inter = inter["intermediates"]
    tm = MiniSpinNet(mode="sampled", compute_dtype=torch.bfloat16,
                     fused_conv=fused)
    tm.load_state_dict(load_snapshot(SNAP_SAMPLED)["desc"], strict=True)
    tm.eval()
    assert tm.fused == fused
    got = _hook_outputs({"stem": tm.stem, "backbone": tm.backbone,
                         "att_hidden": tm.att_hidden, "att_gate": tm.att_gate})
    with torch.no_grad():
        o = tm(torch.from_numpy(x))
    tol = LAYER_TOL["bf16"]
    stem_ref = inter["ConvBNRelu_0"]["__call__"][0]
    # the net's stem hands on the max over the samples
    _close(jnp.max(stem_ref, axis=2), got["stem"], tol, "stem max")
    with torch.no_grad():               # every sample's, as a bare call
        stem = tm.stem(torch.from_numpy(x))
    _close(stem_ref, stem, tol, "stem")
    _close(inter["CylindricalConvNet_0"]["__call__"][0][0],
           torch.movedim(got["backbone"], 1, -1), tol, "backbone")
    for jname, tname in (("ConvBNRelu_1", "att_hidden"),
                         ("ConvBNRelu_2", "att_gate")):
        _close(inter[jname]["__call__"][0], torch.movedim(got[tname], 1, -1),
               tol, tname)
    _close(out["desc"], o["desc"], 5e-3, "desc")
    _close(out["equi"], o["equi"], 2e-2, "equi")


@pytest.mark.parametrize("snap,dt", [("hard_moments_r4", "f32"),
                                     ("hard_moments_r4", "bf16"),
                                     ("r5_w2_scratch", "f32"),
                                     ("r5_w2_scratch", "bf16")])
def test_minispinnet_softmax_and_width_layerwise(snap, dt):
    """The other two architectures shipped with the repo, read from their
    config.json: the softmax pool (``hard_moments_r4``) and the backbone at
    width 2.0 (``r5_w2_scratch``), every layer and both outputs against the
    JAX net, with the tolerances above."""
    jdt, tdt = DTYPES[dt]
    root = os.path.join(os.path.dirname(__file__), "..", "snapshot", snap)
    knobs = load_snapshot_config(root)
    pool, width = knobs["desc_pool"], knobs.get("desc_width", 1.0)
    assert (pool, width) == {"hard_moments_r4": ("softmax", 1.0),
                             "r5_w2_scratch": ("gated", 2.0)}[snap]
    rs = np.random.RandomState(3)
    x = (rs.randn(6, 10, 420) * 0.5).astype(np.float32)
    jm = JaxMiniSpinNet(mode="moments", pool=pool, width=width,
                        compute_dtype=jdt)
    out, inter = jm.apply(_restore(root, "Desc"), jnp.asarray(x),
                          train=False, capture_intermediates=True)
    inter = inter["intermediates"]
    tm = MiniSpinNet(pool=pool, width=width, compute_dtype=tdt)
    tm.load_state_dict(load_snapshot(root)["desc"], strict=True)
    tm.eval()
    hooked = {"stem": tm.stem, "att_hidden": tm.att_hidden,
              "att_gate": tm.att_gate}
    hooked.update({f"backbone.{i}": layer
                   for i, layer in enumerate(tm.backbone.layers)})
    got = _hook_outputs(hooked)
    with torch.no_grad():
        o = tm(torch.from_numpy(x))
    tol = LAYER_TOL[dt]
    _close(inter["ConvBNRelu_0"]["__call__"][0], _stem_out(got["stem"]), tol,
           "stem")
    for i in range(8):
        ref = inter["CylindricalConvNet_0"][f"ConvBNRelu_{i}"]["__call__"][0]
        _close(ref, torch.movedim(_backbone_out(got[f"backbone.{i}"], i), 1,
                                  -1), tol, f"backbone layer {i}")
    for jname, tname in (("ConvBNRelu_1", "att_hidden"),
                         ("ConvBNRelu_2", "att_gate")):
        _close(inter[jname]["__call__"][0], torch.movedim(got[tname], 1, -1),
               tol, tname)
    desc_tol, equi_tol = (1e-5, 1e-5) if dt == "f32" else (5e-3, 2e-2)
    _close(out["desc"], o["desc"], desc_tol, "desc")
    _close(out["equi"], o["equi"], equi_tol, "equi")


def test_minispinnet_rejects_unported_modes():
    assert MiniSpinNet(pool="softmax").att_gate.use_bn is False
    with pytest.raises(ValueError):
        MiniSpinNet(pool="max")
    with pytest.raises(ValueError):
        MiniSpinNet(mode="voxel")
    sampled = MiniSpinNet(mode="sampled")
    assert type(sampled.backbone).__name__ == "CylindricalConvNet"
    with pytest.raises(ValueError):          # sampled input is [K, G, ns, 3]
        sampled(torch.zeros(2, 10, 420))
    # the fused stack only under the JAX package's condition
    assert not MiniSpinNet(mode="sampled", fused_conv=True).fused   # f32
    assert not MiniSpinNet(mode="sampled", compute_dtype=torch.bfloat16,
                           fused_conv=True, width=2.0).fused
    assert MiniSpinNet(mode="sampled", compute_dtype=torch.bfloat16,
                       fused_conv=True).fused


# ---- CylindricalUNet ---------------------------------------------------------
UNET_CHANNELS = [(16, 32), (32, 32), (32, 64), (64, 128), (128, 128),
                 (256, 64), (128, 32), (64, 32), (32, 32)]


def _unet_tree(seed: int = 5) -> dict:
    """flax ``{params, batch_stats}`` of the JAX ``CylindricalUNet`` (16
    input channels, dim 32) from a RandomState: kernels scaled by their fan
    in, BatchNorm scale, bias and running statistics away from their
    initial values."""
    rs = np.random.RandomState(seed)
    params, stats = {}, {}
    for i, (cin, cout) in enumerate(UNET_CHANNELS):
        kshape = (3, 3, 3, cin, cout) if i == 0 else (3, 3, cin, cout)
        fan_in = int(np.prod(kshape[:-1]))
        f32 = np.float32
        params[f"ConvBNRelu_{i}"] = {
            "Conv_0": {"kernel": (rs.randn(*kshape) / np.sqrt(fan_in))
                       .astype(f32),
                       "bias": (rs.randn(cout) * 0.1).astype(f32)},
            "BatchNorm_0": {"scale": rs.uniform(0.5, 1.5, cout).astype(f32),
                            "bias": (rs.randn(cout) * 0.1).astype(f32)}}
        stats[f"ConvBNRelu_{i}"] = {"BatchNorm_0": {
            "mean": (rs.randn(cout) * 0.1).astype(f32),
            "var": rs.uniform(0.5, 1.5, cout).astype(f32)}}
    return {"params": params, "batch_stats": stats}


def _unet_pair(dt, tree):
    from bufferx_tpu.models.layers import CylindricalUNet as JaxUNet
    from bufferx_tpu_torch.models.layers import CylindricalUNet
    from bufferx_tpu_torch.tools.weights import UNET_MODULES, params_from_numpy

    jdt, tdt = DTYPES[dt]
    tm = CylindricalUNet(compute_dtype=tdt)
    tm.load_state_dict(params_from_numpy(tree, UNET_MODULES), strict=True)
    return JaxUNet(compute_dtype=jdt), tm


UNET_LAYERS = ["stem", "enc1", "enc2", "enc3", "bott", "dec3", "dec2", "dec1",
               "final"]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cylindrical_unet_layerwise(dt, train):
    """Every layer and the output against the flax module with the same
    weights, eval mode (running statistics) and train mode (the batch's,
    and the running statistics they give)."""
    from bufferx_tpu_torch.models.layers import running_stats
    from bufferx_tpu_torch.tools.weights import UNET_MODULES, params_from_numpy

    tree = _unet_tree()
    jm, tm = _unet_pair(dt, tree)
    x = np.random.RandomState(6).randn(6, 3, 7, 20, 16).astype(np.float32)
    variables = jax.tree.map(jnp.asarray, tree)

    @jax.jit
    def run(v, x):
        return jm.apply(v, x, train=train, capture_intermediates=True,
                        mutable=["intermediates", "batch_stats"])

    (out, none), state = run(variables, jnp.asarray(x))
    assert none is None
    inter = state["intermediates"]
    tm.train(train)
    got = _hook_outputs({n: getattr(tm, n) for n in UNET_LAYERS})
    bn_stats = {}
    with torch.no_grad():
        t_out, t_none = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                           bn_stats)
    assert t_none is None
    tol = LAYER_TOL[dt]
    for i, name in enumerate(UNET_LAYERS):
        ref = inter[f"ConvBNRelu_{i}"]["__call__"][0]
        g = got[name][:, :, 0] if i == 0 else got[name]
        _close(ref[:, 0] if i == 0 else ref, torch.movedim(g, 1, -1), tol,
               name)
    _close(out, torch.movedim(t_out, 1, -1), tol, "output")
    assert t_out.dtype == torch.float32 and t_out.shape == (6, 32, 7, 20)
    if train:
        want = params_from_numpy(
            {"batch_stats": jax.tree.map(np.asarray, state["batch_stats"])},
            UNET_MODULES)
        new = running_stats(tm, bn_stats)
        assert sorted(new) == sorted(want)
        for k in want:
            _close(want[k].numpy(), new[k], tol, k)
    else:
        assert not bn_stats


def test_cylindrical_unet_gradient_matches_jax():
    """Train-mode float32 gradients of a scalar loss, every parameter,
    against ``jax.grad``: relative L2 over all of them within 1e-2
    (``GRAD_TOL`` of ``tests/test_torch_train_forward.py``)."""
    from bufferx_tpu_torch.tools.weights import UNET_MODULES, params_from_numpy

    tree = _unet_tree(7)
    jm, tm = _unet_pair("f32", tree)
    rs = np.random.RandomState(8)
    x = rs.randn(6, 3, 7, 20, 16).astype(np.float32)
    w = rs.randn(6, 7, 20, 32).astype(np.float32)

    @jax.jit
    def grads(p):
        def loss(p):
            (out, _), _ = jm.apply({"params": p,
                                    "batch_stats": tree["batch_stats"]},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
            return jnp.sum(out * w)
        return jax.grad(loss)(p)

    want = params_from_numpy(
        {"params": jax.tree.map(np.asarray,
                                grads(jax.tree.map(jnp.asarray,
                                                   tree["params"])))},
        UNET_MODULES)
    tm.train()
    out, _ = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    torch.sum(torch.movedim(out, 1, -1) * torch.from_numpy(w)).backward()
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(want)
    num = sum(float(((want[k] - got[k].grad) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= 1e-2, (num / den) ** 0.5


def test_cylindrical_unet_weights_round_trip():
    """flax tree -> state dict -> flax tree, equal to the bit, in both
    directions, and the state dict's keys are the module's own."""
    from bufferx_tpu_torch.models.layers import CylindricalUNet
    from bufferx_tpu_torch.tools.weights import (
        UNET_MODULES,
        numpy_from_params,
        params_from_numpy,
    )

    tree = _unet_tree(9)
    sd = params_from_numpy(tree, UNET_MODULES)
    assert sorted(sd) == sorted(CylindricalUNet().state_dict())
    back = numpy_from_params(sd, UNET_MODULES)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(tree)))
    again = params_from_numpy(back, UNET_MODULES)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert sd["stem.weight"].shape == (32, 16, 3, 3, 3)
    assert sd["dec3.weight"].shape == (64, 256, 3, 3)
