"""Port parity of the reference-checkpoint importer
(``bufferx_tpu_torch/tools/torch_import.py`` and its CLI
``tools/import_reference_checkpoint.py``) against
``bufferx_tpu/tools/torch_import.py``.

The torch mirrors of the reference architecture (``tests/test_import.py``)
with seeded random weights and BatchNorm statistics are saved as a
reference ``best.pth``. Held here:

- the port's msgpack bytes equal the JAX importer's for the same ``.pth``
  (the same trees, keys in the importer's order);
- the port's Desc and Pose modules, loaded from the import, match the
  mirrors' eval-mode forward within 1e-5 (float32 on both sides);
- the imported weights through the port's ``register_pair`` at the small
  capacities of ``tests/test_import.py`` give the JAX package's pose with
  JAX's draws (within 0.02 m / 2 degrees, as ``tests/test_torch_pipeline.py``
  holds every path; success and validity equal);
- ``torch.load`` (the port) and JAX's torch-free parser read the quirk
  dictionaries equal (bfloat16: the parser's raw bits, the port's exact
  float32);
- moments configurations are refused, and a shape mismatch raises.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.pipeline import registration as jreg
from bufferx_tpu.tools import torch_import as jti
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.core import se3
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.models.heads import CostVolume
from bufferx_tpu_torch.models.spinnet import MiniSpinNet
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.tools import import_reference_checkpoint as cli
from bufferx_tpu_torch.tools import torch_import as tti
from bufferx_tpu_torch.tools.weights import (
    DESC_MODULES,
    POSE_MODULES,
    load_snapshot,
    params_from_numpy,
)
from test_import import AZI, ELE, NS, RAD, RefBufferX, _randomize_bn_stats
from test_torch_pipeline import _jax_draws, few_threads  # noqa: F401
from test_torch_queries import jax_scale_draws

# tests/test_import.py's small capacities
SMALL = dict(
    capacity=dict(max_points=1536, num_ransac_hypotheses=512,
                  ransac_chunk=128, sphere_query_chunk=64),
    patch=dict(num_fps=192, num_points_radius_estimate=192,
               num_points_per_patch=96, num_scales=2,
               search_radius_thresholds=(5.0, 2.0), voxel_sample=NS),
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The mirrors with seeded weights, saved as a reference snapshot
    ``<src>/{Desc,Pose}/best.pth`` (each the whole state dict), and both
    packages' imports of it."""
    gen = torch.Generator().manual_seed(0)
    model = RefBufferX()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        _randomize_bn_stats(model, gen)
    model.eval()
    base = tmp_path_factory.mktemp("reference_import")
    src = base / "ref"
    for stage in ("Desc", "Pose"):
        os.makedirs(src / stage)
        torch.save(model.state_dict(), str(src / stage / "best.pth"))
    # the JAX importer reads only the template's shapes: the port's
    # numpy trees (equal shapes, tests/test_torch_weights.py) spare a JAX
    # init
    jti.import_reference_snapshot(str(src), str(base / "jax"),
                                  cli.template_for(make_cfg("3DMatch")))
    assert cli.main(["--src", str(src), "--out", str(base / "port")]) == 0
    return model, base


@pytest.mark.parametrize("over", [{}, dict(desc_mode="moments"),
                                  dict(desc_width=2.0)])
def test_template_shapes_are_the_jax_models(over):
    """The shape template of the port's CLI is the JAX package's
    ``init_params`` tree, leaf by leaf."""
    got = cli.template_for(make_cfg("3DMatch").override(patch=over))
    want = jax.eval_shape(lambda: jreg.init_params(
        jax_make_cfg("3DMatch").override(patch=over), jax.random.PRNGKey(0)))
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_got] == \
        [jax.tree_util.keystr(k) for k, _ in flat_want]
    for (k, a), (_, b) in zip(flat_got, flat_want):
        assert tuple(a.shape) == tuple(b.shape), jax.tree_util.keystr(k)


def test_msgpack_bytes_equal_the_jax_importers(ref):
    _, base = ref
    for stage in ("Desc", "Pose"):
        with open(base / "jax" / stage / "best.msgpack", "rb") as f:
            want = f.read()
        with open(base / "port" / stage / "best.msgpack", "rb") as f:
            got = f.read()
        assert got == want, stage
        # and flax reads the port's bytes back to the same tree
        tree = flax.serialization.msgpack_restore(got)
        ref_tree = flax.serialization.msgpack_restore(want)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref_tree)):
            np.testing.assert_array_equal(a, b)


def test_modules_match_the_mirrors_forward(ref):
    model, base = ref
    sd = load_snapshot(str(base / "port"))
    desc = MiniSpinNet(RAD, ELE, AZI, mode="sampled")
    desc.load_state_dict(sd["desc"])
    desc.eval()
    pose = CostVolume(AZI)
    pose.load_state_dict(sd["pose"])
    pose.eval()
    rs = np.random.RandomState(1)
    inv = torch.from_numpy(rs.randn(4, RAD * ELE * AZI, NS, 3)
                           .astype(np.float32))
    d1 = torch.from_numpy(rs.randn(3, 32, ELE - 2, AZI).astype(np.float32))
    d2 = torch.from_numpy(rs.randn(3, 32, ELE - 2, AZI).astype(np.float32))
    with torch.no_grad():
        f_ref, equi_ref = model.Desc(inv)
        ind_ref = model.Pose.conv(d1, d2)
        out = desc(inv)
        ind = pose(d1, d2)
    torch.testing.assert_close(out["desc"], f_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(out["equi"], equi_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(ind, ind_ref, rtol=0, atol=1e-5)


def test_imported_weights_through_the_pipeline(ref):
    """Both imports through both pipelines at small capacities: the port's
    pose with JAX's draws against ``register_pair_jit``'s."""
    _, base = ref
    jcfg = jax_make_cfg("3DMatch").override(**SMALL)
    tcfg = make_cfg("3DMatch").override(**SMALL)
    assert tcfg.patch.desc_mode == "sampled"
    jparams = {stage.lower(): jax.tree.map(
        jnp.asarray, flax.serialization.msgpack_restore(
            open(base / "jax" / stage / "best.msgpack", "rb").read()))
        for stage in ("Desc", "Pose")}
    jst = jreg.PipelineStatics.from_config(jcfg)
    tst = treg.PipelineStatics.from_config(tcfg)
    models = treg.build_models(tst, load_snapshot(str(base / "port")), "cpu")
    s, t, T = synthetic_pair_full_overlap(np.random.RandomState(42), 1400)
    key = jax.random.PRNGKey(3)
    if treg.fused_query(tst):
        _keys, draws = _jax_draws(key, jst, num_scales=tst.num_scales)
    else:
        draws = jax_scale_draws(key, jst, "strat")
    jres = jreg.register_pair_jit(
        jparams, jst, jreg.prepare_cloud(s, jcfg, seed=0),
        jreg.prepare_cloud(t, jcfg, seed=0), jnp.asarray(False), key)
    tres = treg.register_pair(
        tcfg, treg.prepare_cloud(s, tcfg, seed=0, device="cpu"),
        treg.prepare_cloud(t, tcfg, seed=0, device="cpu"), models,
        draws=draws, device="cpu")
    jpose = torch.from_numpy(np.array(jres.pose))
    assert bool(torch.isfinite(tres.pose).all())
    assert float(se3.compute_rte(tres.pose, jpose)) <= 0.02
    assert float(se3.compute_rre(tres.pose, jpose)) <= 2.0
    Tg = torch.from_numpy(T)

    def success(pose):
        return (float(se3.compute_rte(pose, Tg)) < tcfg.test.rte_thresh
                and float(se3.compute_rre(pose, Tg)) < tcfg.test.rre_thresh)

    assert success(tres.pose) == success(jpose)
    assert bool(tres.valid) == bool(jres.valid)


def _quirks():
    base = torch.randn(40)
    m = torch.randn(6, 8)
    return {
        "shared": {"a": base[:10], "b": base[10:30], "c": base[25:],
                   "whole": base},
        "strides": {"transposed": m.t(), "strided_rows": m[::2],
                    "strided_cols": m[:, ::2],
                    "expanded": torch.randn(1, 5).expand(4, 5),
                    "scalar": torch.tensor(3.25)},
        "dtypes": {"f16": torch.randn(5, 3).half(),
                   "f64": torch.randn(5, 3).double(),
                   "f32": torch.randn(5, 3), "i64": torch.arange(7),
                   "i32": torch.arange(7, dtype=torch.int32),
                   "u8": torch.arange(7, dtype=torch.uint8),
                   "bool": torch.tensor([True, False, True])},
        "bfloat16": {"w": torch.randn(4, 4).to(torch.bfloat16)},
    }


@pytest.mark.parametrize("case", list(_quirks()))
def test_quirk_dictionaries_read_equal(tmp_path, case):
    torch.manual_seed(0)
    sd = _quirks()[case]
    path = str(tmp_path / "q.pth")
    torch.save(sd, path)
    got = tti.load_state_dict(path)
    want = jti._load_without_torch(path)
    assert set(got) == set(want) == set(sd)
    for k in sd:
        w = np.asarray(want[k])
        if sd[k].dtype == torch.bfloat16:      # the parser keeps raw bits
            w = (w.astype(np.uint32) << 16).view(np.float32)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_moments_config_refused(ref, tmp_path, monkeypatch, capsys):
    _, base = ref
    moments = make_cfg("3DMatch").override(patch=dict(desc_mode="moments"))
    monkeypatch.setattr(cli, "make_cfg", lambda _name: moments)
    assert cli.main(["--src", str(base / "ref"), "--out",
                     str(tmp_path / "out")]) == 1
    assert "desc_mode='sampled'" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "out")


def test_shape_mismatch_raises(ref, tmp_path):
    """A template of other shapes (the moments descriptor's 10-channel
    stem; a width-2 net) refuses the import."""
    _, base = ref
    for over in (dict(desc_mode="moments"), dict(desc_width=2.0)):
        cfg = make_cfg("3DMatch").override(patch=over)
        with pytest.raises(ValueError, match="shape mismatch"):
            tti.import_reference_snapshot(str(base / "ref"),
                                          str(tmp_path / "out"),
                                          cli.template_for(cfg))


def test_served_without_config_json(ref):
    """The imported snapshot has no config.json and serves as the default
    sampled descriptor, as snapshot/hard does."""
    _, base = ref
    assert not os.path.exists(base / "port" / "config.json")
    sd = load_snapshot(str(base / "port"))
    tmpl = cli.template_for(make_cfg("3DMatch"))
    for stage, modules in (("desc", DESC_MODULES), ("pose", POSE_MODULES)):
        want = params_from_numpy(tmpl[stage], modules)
        assert sorted(sd[stage]) == sorted(want)
        for k in want:
            assert sd[stage][k].shape == want[k].shape, k


def test_snapshot_hard_round_trips_through_the_reference_layout(tmp_path):
    """``chip_smoke.py``'s inverse map writes ``snapshot/hard`` as reference
    ``.pth`` files; both importers read them back to the same bytes, which
    hold every array of ``snapshot/hard`` and, in the pytree key order that
    the snapshot was written in, its exact bytes."""
    import chip_smoke
    from bufferx_tpu_torch.tools.weights import msgpack_dumps, msgpack_restore

    snap = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "snapshot", "hard")
    src = chip_smoke.write_reference_snapshot(torch, snap,
                                              str(tmp_path / "ref"))
    sd = torch.load(os.path.join(src, "Desc", "best.pth"), weights_only=True)
    assert any(k.startswith("Pose.") for k in sd)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    assert cli.main(["--src", src, "--out", str(tmp_path / "port")]) == 0
    jti.import_reference_snapshot(src, str(tmp_path / "jax"),
                                  cli.template_for(make_cfg("3DMatch")))

    def sort(tree):
        return {k: sort(tree[k]) for k in sorted(tree)} \
            if isinstance(tree, dict) else tree

    for stage in ("Desc", "Pose"):
        got = open(tmp_path / "port" / stage / "best.msgpack", "rb").read()
        assert got == open(tmp_path / "jax" / stage / "best.msgpack",
                           "rb").read()
        want = open(os.path.join(snap, stage, "best.msgpack"), "rb").read()
        assert msgpack_dumps(sort(msgpack_restore(got))) == want
