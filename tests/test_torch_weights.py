"""Port: the dependency-free flax-msgpack reader and the state-dict map."""

import os

import flax.serialization
import numpy as np
import pytest
import torch

from bufferx_tpu_torch.models.heads import CostVolume
from bufferx_tpu_torch.models.spinnet import MiniSpinNet
from bufferx_tpu_torch.tools.weights import (
    DESC_MODULES,
    POSE_MODULES,
    load_snapshot,
    load_snapshot_config,
    msgpack_restore,
    params_from_numpy,
)

SNAP = os.path.join(os.path.dirname(__file__), "..", "snapshot",
                    "hard_moments_r4ft2")
SNAP_SAMPLED = os.path.join(os.path.dirname(__file__), "..", "snapshot",
                            "hard")


def _assert_same_tree(a, b, path=""):
    assert type(a) is type(b) or (
        isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
    ), (path, type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("stage", ["Desc", "Pose"])
def test_reader_matches_flax_on_checkpoint(stage):
    with open(os.path.join(SNAP, stage, "best.msgpack"), "rb") as f:
        data = f.read()
    _assert_same_tree(msgpack_restore(data),
                      flax.serialization.msgpack_restore(data))


def test_reader_matches_flax_on_mixed_tree():
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65536, 2**40, -1, -32, -33, -200,
                 -40000, -(2**40)],
        "floats": [0.5, -1.25e300],
        "flags": [True, False, None],
        "text": ["", "x" * 40, "y" * 300],
        "arrays": {"f": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "i": np.arange(4, dtype=np.int64),
                   "big": np.linspace(0, 1, 70000).astype(np.float32)},
        "scalar": np.float32(3.5),
        "nested": {str(i): {"v": np.full((1,), i, np.int32)} for i in range(20)},
    }
    data = flax.serialization.msgpack_serialize(tree)
    _assert_same_tree(msgpack_restore(data),
                      flax.serialization.msgpack_restore(data))


def test_state_dicts_load_strict():
    sd = load_snapshot(SNAP)
    desc = MiniSpinNet()
    pose = CostVolume()
    missing, unexpected = desc.load_state_dict(sd["desc"], strict=True)
    assert not missing and not unexpected
    missing, unexpected = pose.load_state_dict(sd["pose"], strict=True)
    assert not missing and not unexpected
    # one kernel of each kind, against the flax layout
    with open(os.path.join(SNAP, "Desc", "best.msgpack"), "rb") as f:
        flax_desc = flax.serialization.msgpack_restore(f.read())
    k3 = flax_desc["params"]["CylindricalConvNet_0"]["ConvBNRelu_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        desc.backbone.layers[0].weight.detach().numpy(),
        np.transpose(k3, (4, 3, 0, 1, 2)),
    )
    k2 = flax_desc["params"]["CylindricalConvNet_0"]["ConvBNRelu_3"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        desc.backbone.layers[3].weight.detach().numpy(),
        np.transpose(k2, (3, 2, 0, 1)),
    )
    var = flax_desc["batch_stats"]["ConvBNRelu_1"]["BatchNorm_0"]["var"]
    np.testing.assert_array_equal(desc.att_hidden.bn_var.numpy(), var)


def test_params_from_numpy_rejects_unknown_modules():
    tree = {"params": {"Mystery_0": {"Conv_0": {"kernel": np.zeros((1, 1, 2, 2))}}}}
    with pytest.raises(KeyError):
        params_from_numpy(tree, DESC_MODULES)
    assert "stem" in POSE_MODULES.values()


def test_snapshot_config():
    assert load_snapshot_config(SNAP) == {"desc_mode": "moments",
                                          "desc_pool": "gated"}
    assert isinstance(load_snapshot(SNAP)["pose"]["stem.weight"], torch.Tensor)


@pytest.mark.parametrize("fused", [False, True])
def test_sampled_snapshot_loads_strict(fused):
    """``snapshot/hard`` (sampled mode, no config.json) maps through
    DESC_MODULES onto the sampled MiniSpinNet, with the cuDNN or the fused
    backbone; its point-MLP stem is the flax [1, 1, 3, 16] kernel."""
    assert load_snapshot_config(SNAP_SAMPLED) == {}
    sd = load_snapshot(SNAP_SAMPLED)
    desc = MiniSpinNet(mode="sampled", compute_dtype=torch.bfloat16,
                       fused_conv=fused)
    assert desc.fused == fused
    missing, unexpected = desc.load_state_dict(sd["desc"], strict=True)
    assert not missing and not unexpected
    CostVolume().load_state_dict(sd["pose"], strict=True)
    with open(os.path.join(SNAP_SAMPLED, "Desc", "best.msgpack"), "rb") as f:
        flax_desc = flax.serialization.msgpack_restore(f.read())
    stem = flax_desc["params"]["ConvBNRelu_0"]["Conv_0"]["kernel"]
    assert stem.shape == (1, 1, 3, 16)
    np.testing.assert_array_equal(desc.stem.weight.detach().numpy(),
                                  np.transpose(stem, (3, 2, 0, 1)))
    if fused:   # folded once, on load, from the loaded weights
        from bufferx_tpu_torch.kernels.conv_pallas import fold_cyl_stack

        w, b = fold_cyl_stack(desc.backbone.state_dict())
        assert torch.equal(desc.backbone.folded_w, w)
        assert torch.equal(desc.backbone.folded_b, b)
        assert bool(desc.backbone.folded_w.abs().sum() > 0)
