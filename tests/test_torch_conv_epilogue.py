"""The conv layers' serving epilogue (``kernels/conv_epilogue.py``): its
plain version against the eager layers, where the layers take the kernel and
where they keep the eager chain, the CUDA wrapper's guards and the cached
constants.

Every comparison is exact: the plain version is the eager chain op for op,
and the layers' forms are the consumers' own pad and cast ops.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from bufferx_tpu_torch.kernels import conv_epilogue as ce
from bufferx_tpu_torch.models import heads, layers, spinnet
from bufferx_tpu_torch.models.heads import CostVolume, FactoredCostStem
from bufferx_tpu_torch.models.layers import ConvBNRelu, pad_cyl_2d, pad_cyl_3d
from bufferx_tpu_torch.models.spinnet import (
    MiniSpinNet,
    MomentsMajorStem,
    PointwiseStem,
)
from bufferx_tpu_torch.tools.weights import load_snapshot

ROOT = os.path.join(os.path.dirname(__file__), "..", "snapshot")
BF16 = torch.bfloat16
# "_cl": the layer's input channels-last, as in the descriptor backbone
FORMS = ["pad2d", "pad2d_rad", "pad2d_cl", "pad2d_rad_cl", "bf16", "f32",
         "f32_cl", "pad3d", "amax", "cost"]
GRID = (3, 7, 20)


@pytest.fixture(scope="module")
def snapshots():
    return {"moments": load_snapshot(os.path.join(ROOT, "hard_moments_r4ft2")),
            "sampled": load_snapshot(os.path.join(ROOT, "hard"))}


def _randomize(layer: torch.nn.Module, seed: int) -> None:
    """Random weights and BatchNorm state, the variances positive."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in [*layer.named_parameters(), *layer.named_buffers()]:
            r = torch.randn(t.shape, generator=g)
            t.copy_(r.abs() + 0.1 if name == "bn_var" else r * 0.3)


def _sub(state: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def _case(form: str, weights: str, snapshots: dict):
    """(layer in eval bf16, its inputs, the eager reference: the layer's
    own output and its consumer's pad and cast)."""
    g = torch.Generator().manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, generator=g)

    desc, pose = snapshots["moments"]["desc"], snapshots["moments"]["pose"]
    cl = form.endswith("_cl")
    form = form.removesuffix("_cl")
    if form in ("pad2d", "pad2d_rad", "f32"):
        idx = {"pad2d": 3, "pad2d_rad": 0, "f32": 7}[form]
        cin, cout, kernel = [(16, 64, (3, 3, 3)), None, None,
                             (128, 128, (3, 3)), None, None, None,
                             (32, 32, (3, 3))][idx]
        layer = ConvBNRelu(cin, cout, kernel, use_bn=idx != 7,
                           use_relu=idx != 7, compute_dtype=BF16)
        state = _sub(desc, f"backbone.layers.{idx}.")
        x = (pad_cyl_3d(rand(6, cin, 3, 7, 20), 3) if idx == 0
             else pad_cyl_2d(rand(6, cin, 7, 20), 3)).to(BF16)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last_3d if idx == 0
                             else torch.channels_last)

        def ref(y):
            if form == "f32":
                return y
            return pad_cyl_2d(y[:, :, 0] if idx == 0 else y, 3).to(BF16)
    elif form == "bf16":
        layer = ConvBNRelu(64, 128, (3, 1, 3), compute_dtype=BF16)
        state = _sub(pose, "layers.2.")
        x = rand(5, 64, 14, 1, 14).to(BF16)

        def ref(y):
            return y.to(BF16)
    elif form == "pad3d":
        layer = MomentsMajorStem(compute_dtype=BF16)
        state = _sub(desc, "stem.")
        x = (rand(6, 10, 420) * 0.5).to(BF16)

        def ref(y):
            cl = y.reshape(6, *GRID, 16).permute(0, 4, 1, 2, 3)
            return pad_cyl_3d(cl, 3).to(BF16)
    elif form == "amax":
        layer = PointwiseStem(compute_dtype=BF16)
        state = _sub(snapshots["sampled"]["desc"], "stem.")
        x = (rand(4, 420, 10, 3) * 0.3).to(BF16)

        def ref(y):
            return torch.amax(y, dim=2)
    else:                                       # the factored cost stem
        layer = FactoredCostStem(20, compute_dtype=BF16)
        state = _sub(pose, "stem.")
        x = (rand(5, 32, 5, 20), rand(5, 32, 5, 20))

        def ref(y):
            return y.to(BF16)
    layer.load_state_dict(state, strict=True)
    if weights == "random":
        _randomize(layer, 11)
    layer.eval()
    return layer, x if isinstance(x, tuple) else (x,), ref


def _conv_out(layer, xs):
    """The layer's conv (or matmul) output in bf16, as its forward makes
    it; for the cost stem (A, C2d)."""
    (ws), _const = layer.serving_state()
    if isinstance(layer, FactoredCostStem):
        d1 = xs[0].to(BF16)
        a_in = torch.cat([d1[..., -2:], d1, d1[..., :2]], dim=-1)
        return F.conv2d(a_in, ws[0]), F.conv2d(xs[1].to(BF16), ws[1])
    if isinstance(layer, PointwiseStem):
        x = xs[0].transpose(1, 2) if isinstance(layer, MomentsMajorStem) \
            else xs[0]
        return torch.matmul(x, ws[0]), None
    conv = F.conv2d if len(layer.kernel) == 2 else F.conv3d
    return conv(xs[0], ws[0]), None


def _plain_args(form):
    form = form.removesuffix("_cl")
    out = {"pad2d_rad": "pad2d", "cost": "bf16"}.get(form, form)
    kw = {}
    if form in ("pad3d", "amax"):
        kw["channel_dim"] = -1
    if form == "pad3d":
        kw["grid"] = GRID
    return out, kw


@pytest.mark.parametrize("weights", ["snapshot", "random"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_equals_the_eager_layer_and_its_consumer(snapshots, form,
                                                       weights):
    """``conv_epilogue_plain`` on the layer's conv output and cached
    constants = the eager layer (its default float32 output) followed by
    the consumer's own pad and cast, bit for bit."""
    layer, xs, ref = _case(form, weights, snapshots)
    with torch.no_grad():
        want = ref(layer(*xs))
        y, c2d = _conv_out(layer, xs)
        out, kw = _plain_args(form)
        got = ce.conv_epilogue_plain(y, layer.serving_state()[1], out,
                                     c2d=c2d, **kw)
        # the layer asked for the form gives it too (the eager chain here)
        direct = layer(*xs, out=out, **({"grid": GRID} if form == "pad3d"
                                        else {}))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.stride() == want.stride()
    assert torch.equal(got, want)
    assert torch.equal(direct, want)


@pytest.mark.parametrize("form", FORMS)
def test_kernel_output_has_the_plain_layout(snapshots, form):
    """The kernel's wrapper allocates each form's output with the plain
    version's shape, dtype and strides (the descriptor backbone runs
    channels-last, and cuDNN and the later reductions must see the eager
    chain's strides); it pads only a channels-last conv output, the layout
    the cylindrical nets run in on the card."""
    layer, xs, _ref = _case(form, "snapshot", snapshots)
    with torch.no_grad():
        y, c2d = _conv_out(layer, xs)
        out, kw = _plain_args(form)
        const = layer.serving_state()[1]
        want = ce.conv_epilogue_plain(y, const, out, c2d=c2d, **kw)
        if c2d is not None:
            y, c2d = y.contiguous(), c2d.contiguous()

        def plan():
            return ce._plan(y, const, out, kw.get("channel_dim", 1),
                            kw.get("grid"), c2d)[0]

        if form in ("pad2d", "pad2d_rad"):          # a contiguous conv output
            with pytest.raises(ValueError, match="channels-last"):
                plan()
            return
        got = plan()
    assert (got.shape, got.dtype, got.stride()) == (want.shape, want.dtype,
                                                    want.stride())


def _patch_card(monkeypatch, calls):
    """Pretend every tensor is on the card and record the epilogue calls,
    which run the plain version."""
    monkeypatch.setattr(layers, "_on_card", lambda t: True)

    def recorder(*a, **k):
        calls.append(a[2] if len(a) > 2 else k.get("out", "f32"))
        return ce.conv_epilogue_plain(*a, **k)

    for mod in (layers, spinnet, heads):
        monkeypatch.setattr(mod, "conv_epilogue", recorder)


@pytest.mark.parametrize("setting", ["serving", "cpu", "train", "f32",
                                     "grad"])
@pytest.mark.parametrize("form", FORMS)
def test_each_form_takes_the_kernel_only_in_serving(snapshots, monkeypatch,
                                                    form, setting):
    """A layer asked for a form takes the epilogue only on the card, in
    eval mode, in bf16, with no gradient needed; on the CPU, in training,
    in float32 and under a gradient it keeps the eager chain, and the
    eval-mode forwards on the card among them (float32, a gradient) are
    counted as eager-served. Both routes give the same result."""
    layer, xs, ref = _case(form, "snapshot", snapshots)
    out, _kw = _plain_args(form)
    kw = {"grid": GRID} if form == "pad3d" else {}
    if setting == "f32":
        layer.compute_dtype = torch.float32
    with torch.no_grad():
        want = layer(*xs, out=out, **kw)      # the eager chain on the CPU
    if setting == "train":
        layer.train()
    calls = []
    if setting != "cpu":
        _patch_card(monkeypatch, calls)
    before = ce.eager_serving_forwards
    with torch.set_grad_enabled(setting in ("grad", "train")):
        got = layer(*xs, out=out, **kw)
    assert calls == ([out] if setting == "serving" else [])
    assert ce.eager_serving_forwards - before == (setting in ("f32", "grad"))
    if setting != "train":              # training normalizes by the batch
        assert torch.equal(got.detach(), want)


@pytest.mark.parametrize("net", ["moments", "sampled", "cost"])
def test_nets_serve_through_the_epilogue_bit_equal(snapshots, monkeypatch,
                                                   net):
    """``MiniSpinNet`` (moments: the stem writes the backbone's padded
    input; sampled: the stem's max over samples) and ``CostVolume`` served
    through the epilogue's forms give the eager nets' bits, one epilogue
    call a layer."""
    g = torch.Generator().manual_seed(3)
    if net == "cost":
        model = CostVolume(compute_dtype=BF16)
        model.load_state_dict(snapshots["moments"]["pose"], strict=True)
        xs = (torch.randn(6, 32, 5, 20, generator=g),
              torch.randn(6, 32, 5, 20, generator=g))
        n_layers = 10
    else:
        model = MiniSpinNet(mode=net, compute_dtype=BF16)
        model.load_state_dict(snapshots[net]["desc"], strict=True)
        shape = (6, 10, 420) if net == "moments" else (6, 420, 10, 3)
        xs = (torch.randn(shape, generator=g).to(BF16),)
        n_layers = 11
    model.eval()
    with torch.no_grad():
        want = model(*xs)
        calls = []
        _patch_card(monkeypatch, calls)
        got = model(*xs)
    assert len(calls) == n_layers
    if net == "cost":
        assert torch.equal(got, want)
    else:
        for key in ("desc", "equi"):
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_backbone_on_the_card_pads_channels_last(snapshots, monkeypatch,
                                                 layout):
    """``CylindricalConvNet`` on the card hands every layer a channels-last
    input, whatever the layout of the tensor it is given, so that each
    layer's epilogue is one the kernel takes (its plan accepts every call);
    the output is the eager net's."""
    import inspect

    net = layers.CylindricalConvNet(32, 1.0, BF16)
    net.load_state_dict(_sub(snapshots["moments"]["desc"], "backbone."),
                        strict=True)
    net.eval()
    x = torch.randn(4, 16, 3, 7, 20, generator=torch.Generator().manual_seed(9))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        want = net(x)
    sig = inspect.signature(ce.conv_epilogue_plain)
    forms = []

    def planned(*a, **k):
        args = sig.bind(*a, **k)
        args.apply_defaults()
        ce._plan(**args.arguments)               # raises where it would
        forms.append(args.arguments["out"])
        return ce.conv_epilogue_plain(*a, **k)

    monkeypatch.setattr(layers, "_on_card", lambda t: True)
    monkeypatch.setattr(layers, "conv_epilogue", planned)
    with torch.no_grad():
        got = net(x)
    assert forms == ["pad2d"] * 7 + ["f32"]
    assert torch.equal(got, want)


def _cuda_args(bad: str):
    const = ce.EpilogueConstants(torch.zeros(8, dtype=BF16),
                                 torch.zeros(8), torch.ones(8))
    y = torch.zeros(2, 8, 7, 20, dtype=BF16)
    if bad == "dtype":
        y = y.float()
    elif bad == "contiguity":
        y = y.transpose(2, 3)
    elif bad == "constant dtype":
        const = ce.EpilogueConstants(torch.zeros(8, dtype=BF16),
                                     torch.zeros(8, dtype=torch.float64),
                                     torch.ones(8))
    elif bad == "form":
        return y, const, "pad9d"
    return y, const, "bf16"


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "device",
                                 "constant dtype", "form"])
def test_cuda_wrapper_raises(bad):
    """The kernel's wrapper refuses another dtype, a non-contiguous tensor,
    a tensor off the card and an unknown form, before any launch."""
    y, const, out = _cuda_args(bad)
    want = {"dtype": "expected torch.bfloat16",
            "contiguity": "contiguous", "device": "CUDA tensor",
            "constant dtype": "expected torch.float32",
            "form": "unknown output form"}[bad]
    launches = ce.CONV_EPILOGUE_KERNEL.launches
    with pytest.raises(ValueError, match=want):
        ce.conv_epilogue_cuda(y, const, out)
    assert ce.CONV_EPILOGUE_KERNEL.launches == launches


@pytest.mark.parametrize("edit", ["load_state_dict", "in_place",
                                  "new_buffer", "weight"])
def test_cached_constants_follow_the_state(snapshots, monkeypatch, edit):
    """The serving constants and weights are made once and reused while
    the layer's state stands; ``load_state_dict``, an in-place edit, a
    replaced buffer and an edited weight each make them anew, so the served
    output stays the eager one's."""
    layer, xs, _ref = _case("pad2d", "snapshot", snapshots)
    calls = []
    _patch_card(monkeypatch, calls)
    with torch.no_grad():
        layer(*xs, out="pad2d")
        first = layer.serving_state()
        assert layer.serving_state()[1] is first[1]      # reused
        if edit == "load_state_dict":
            state = {k: v.clone() for k, v in layer.state_dict().items()}
            state["bn_var"] = state["bn_var"] * 4.0
            layer.load_state_dict(state)
        elif edit == "in_place":
            layer.bn_mean.add_(0.5)
        elif edit == "new_buffer":
            layer.bn_var = layer.bn_var * 0.25
        else:
            layer.weight.mul_(-1.0)
        served = layer(*xs, out="pad2d")
        assert layer.serving_state()[1] is not first[1]
        monkeypatch.setattr(layers, "_on_card", lambda t: False)
        eager = layer(*xs, out="pad2d")
    assert calls == ["pad2d", "pad2d"]
    assert torch.equal(served, eager)
