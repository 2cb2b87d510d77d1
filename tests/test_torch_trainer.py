"""Port parity of the trainer: full Desc and Pose steps against
``make_train_step``, the optimizer chain and its learning-rate schedule
against optax, the guarded update's roll-back, checkpoints both packages
read, the ``Trainer``'s resume and best loss, and ``CollapseGuard``.

Tolerances. The optimizer with the same gradients: float32 rounding
(1e-6 relative to each tensor's largest magnitude). Three full steps of
each stage from the shipped weights with JAX's draws (tests/test_train.py's
sizes): losses within 1e-4 relative (measured <= 3.1e-5); counts equal;
running statistics within 1e-3 relative L2 (measured <= 9.5e-5); Adam's
moments and the parameters' change within 1e-1 relative L2 over all
tensors (measured <= 3.8e-2 and 4.2e-2). The last two are loose because
Adam divides each gradient element by its own RMS: an element whose
gradient lies below the float32 noise of train-mode BatchNorm's backward
(JAX's gradient is 3.6e-3 from a float64 evaluation, the port's 4e-5:
test_torch_train_forward.py) takes a full step of either sign in either
package. Conv biases before train-mode BatchNorm (gradient 0 up to
rounding) are left out of the parameters' change.
"""

import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.pipeline.registration import init_params as jax_init_params
from bufferx_tpu.train import guard as jguard
from bufferx_tpu.train import trainer as jtr
from bufferx_tpu_torch.models.layers import ConvBNRelu
from bufferx_tpu_torch.pipeline.registration import init_params
from bufferx_tpu_torch.tools.weights import (
    DESC_MODULES,
    POSE_MODULES,
    load_snapshot,
    load_snapshot_config,
    msgpack_dumps,
    msgpack_restore,
    numpy_from_params,
    params_from_numpy,
    save_snapshot,
)
from bufferx_tpu_torch.train import guard as tguard
from bufferx_tpu_torch.train import trainer as ttr
from test_torch_pipeline import few_threads  # noqa: F401
from test_torch_train_forward import (
    SNAP,
    cfgs,
    jax_draws,
    setup,  # noqa: F401
    torch_batch,
)


def _np(tree_or_sd):
    return {k: v.detach().numpy().copy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in tree_or_sd.items()}


def _rel_l2(ref: dict, got: dict, keys, base: dict | None = None) -> float:
    num = sum(float(np.sum((ref[k] - got[k]) ** 2)) for k in keys)
    den = sum(float(np.sum((ref[k] - (0 if base is None else base[k])) ** 2))
              for k in keys)
    return (num / max(den, 1e-30)) ** 0.5


# ---- full train steps ----------------------------------------------------------
@pytest.mark.parametrize("stage", ["Desc", "Pose"])
def test_train_steps_match_jax(setup, stage):  # noqa: F811
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jb = jax.tree.map(jnp.asarray, setup["batch"])
    tb = torch_batch(setup["batch"])
    jopt = jtr.make_optimizer(jcfg, stage, 2)
    jstep = jax.jit(jtr.make_train_step(jcfg, stage, jopt))
    topt = ttr.make_optimizer(tcfg, stage, 2)
    tstep = ttr.make_train_step(tcfg, stage, topt)
    mods = DESC_MODULES if stage == "Desc" else POSE_MODULES
    jv = setup["variables"][stage.lower()]
    jos = jopt.init(jv["params"])
    desc, pose = ttr.train_models(tcfg, load_snapshot(SNAP), "cpu")
    model = desc if stage == "Desc" else pose
    p0 = _np(model.state_dict())
    tos = topt.init(dict(model.named_parameters()))
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        draws = jax_draws(key, jcfg.train.pos_num, jcfg.capacity.max_points)
        if stage == "Desc":
            jv, jos, jm = jstep(jv, jos, jb, key)
            tos, tm = tstep(model, tos, tb, draws)
        else:
            jv, jos, jm = jstep(jv, jos, setup["variables"]["desc"], jb, key)
            tos, tm = tstep(model, tos, desc, tb, draws)
        assert set(jm) == set(tm)
        assert bool(jm["grads_finite"]) and bool(tm["grads_finite"])
        for k in jm:
            assert abs(float(jm[k]) - float(tm[k])) <= 1e-4 * max(
                1.0, abs(float(jm[k]))), (i, k, float(jm[k]), float(tm[k]))
    adam, sched = jos[2]
    assert int(adam.count) == int(sched.count) == int(tos.count) == 3
    want = _np(params_from_numpy(jax.tree.map(np.asarray, jv), mods))
    got = _np(model.state_dict())
    stats = [k for k in want if k.endswith(("bn_mean", "bn_var"))]
    dead = {f"{n}.bias" for n, m in model.named_modules()
            if isinstance(m, ConvBNRelu) and m.use_bn}
    live = [k for k in want if k not in stats and k not in dead]
    assert _rel_l2(want, got, stats) <= 1e-3
    assert _rel_l2(want, got, live, base=p0) <= 1e-1
    for name, moment in (("mu", adam.mu), ("nu", adam.nu)):
        ref = _np(params_from_numpy(
            {"params": jax.tree.map(np.asarray, moment)}, mods))
        assert _rel_l2(ref, _np(getattr(tos, name)), list(ref)) <= 1e-1, name


def test_train_step_keeps_state_on_non_finite_loss(setup):  # noqa: F811
    """One NaN weight makes the loss, the gradients and the batch statistics
    NaN: the step keeps the parameters, the running statistics and the
    optimizer state."""
    tcfg = setup["tcfg"]
    desc, _ = ttr.train_models(tcfg, load_snapshot(SNAP), "cpu")
    with torch.no_grad():
        desc.backbone.layers[3].weight[0, 0, 0, 0] = float("nan")
    opt = ttr.make_optimizer(tcfg, "Desc", 2)
    step = ttr.make_train_step(tcfg, "Desc", opt)
    state = opt.init(dict(desc.named_parameters()))
    before = {k: v.clone() for k, v in desc.state_dict().items()}
    new, m = step(desc, state, torch_batch(setup["batch"]), setup["draws"])
    assert not bool(m["grads_finite"]) and not np.isfinite(float(m["loss"]))
    for k, v in desc.state_dict().items():
        assert torch.equal(torch.nan_to_num(v, 7.0),
                           torch.nan_to_num(before[k], 7.0)), k
    assert int(new.count) == 0
    assert all(torch.equal(new.mu[k], state.mu[k]) for k in state.mu)


# ---- the optimizer ---------------------------------------------------------------
def _grad_sets(rs):
    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "b.weight": (7,)}
    scales = [0.01, 3.0, 0.2, 10.0, 0.05, 1.0]     # 3.0, 10.0: clipped
    return shapes, [{k: (rs.randn(*s) * sc).astype(np.float32)
                     for k, s in shapes.items()} for sc in scales]


def _to_optax_tree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_optimizer_matches_optax():
    rs = np.random.RandomState(0)
    shapes, grads = _grad_sets(rs)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    lr, steps, decay, wd = 1e-3, 2, 0.5, 1e-2
    chain = optax.chain(
        optax.clip_by_global_norm(5.0), optax.add_decayed_weights(wd),
        optax.adam(optax.exponential_decay(lr, steps, decay, staircase=True)))
    opt = ttr.Optimizer(lr, steps, decay, wd)
    jp, js = _to_optax_tree(params), chain.init(_to_optax_tree(params))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = chain.update(_to_optax_tree(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts, ok = ttr.guarded_update(
            opt, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert bool(ok)
    for k in params:
        ref = np.asarray(jp[k])
        assert np.abs(ref - tp[k].numpy()).max() <= 1e-6 * np.abs(ref).max()
    adam = js[2][0]
    for name in ("mu", "nu"):
        for k in params:
            ref = np.asarray(getattr(adam, name)[k])
            got = getattr(ts, name)[k].numpy()
            assert np.abs(ref - got).max() <= 1e-6 * np.abs(ref).max()
    assert int(ts.count) == int(adam.count) == len(grads)


def test_lr_schedule_matches_optax():
    for lr, steps, decay in ((1e-3, 3, 0.5), (2.5e-4, 1, 0.9), (1e-2, 7, 0.3)):
        sched = optax.exponential_decay(lr, steps, decay, staircase=True)
        opt = ttr.Optimizer(lr, steps, decay, 0.0)
        for count in range(0, 40):
            ref = float(sched(jnp.int32(count)))
            got = float(opt.learning_rate(torch.tensor(count,
                                                       dtype=torch.int32)))
            assert abs(ref - got) <= 1e-7 * ref, (lr, steps, count)


def test_make_optimizer_reads_the_config(setup):  # noqa: F811
    tcfg = setup["tcfg"].override(optim=dict(lr_pose=2e-3,
                                             scheduler_interval_pose=3))
    opt = ttr.make_optimizer(tcfg, "Pose", 5)
    assert (opt.lr, opt.transition_steps, opt.decay_rate,
            opt.weight_decay) == (2e-3, 15, 0.5, 1e-6)
    assert ttr.make_optimizer(tcfg, "Desc", 0).transition_steps == 1


@pytest.mark.parametrize("poison", ["grads", "updates"])
def test_guarded_update_rolls_back(poison):
    """A NaN gradient, or finite gradients whose update is not finite (a
    poisoned second moment): params, moments and count stay as they were,
    as in the JAX package's ``_guarded_update``."""
    rs = np.random.RandomState(1)
    shapes, grads = _grad_sets(rs)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    chain = jtr.make_optimizer(
        jax_init_cfg(), "Desc", 1)                        # the JAX chain
    opt = ttr.make_optimizer(port_init_cfg(), "Desc", 1)
    jp, js = _to_optax_tree(params), chain.init(_to_optax_tree(params))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    # one good step first, so that the moments and the count are not zero
    jp, js, _ = jtr._guarded_update(chain, _to_optax_tree(grads[0]), js, jp)
    tp, ts, _ = ttr.guarded_update(
        opt, {k: torch.from_numpy(v) for k, v in grads[0].items()}, ts, tp)
    bad = {k: v.copy() for k, v in grads[2].items()}
    if poison == "grads":
        bad["a.weight"][1, 2, 0, 1] = np.nan
    else:
        ts = ts._replace(nu={**ts.nu, "b.weight": ts.nu["b.weight"] * 0 - 1})
        js = (js[0], js[1], (js[2][0]._replace(nu={**js[2][0].nu,
              "b.weight": js[2][0].nu["b.weight"] * 0 - 1}), js[2][1]))
    kept_p = {k: v.clone() for k, v in tp.items()}
    jp2, js2, jok = jtr._guarded_update(chain, _to_optax_tree(bad), js, jp)
    tp2, ts2, tok = ttr.guarded_update(
        opt, {k: torch.from_numpy(v) for k, v in bad.items()}, ts, tp)
    assert not bool(jok) and not bool(tok)
    for k in params:
        assert torch.equal(tp2[k], kept_p[k])
        assert np.array_equal(np.asarray(jp2[k]), np.asarray(jp[k]))
        assert torch.equal(ts2.mu[k], ts.mu[k])
        assert torch.equal(ts2.nu[k], ts.nu[k])
    assert int(ts2.count) == int(js2[2][0].count) == int(js2[2][1].count) == 1
    # and the next good step goes through
    _, ts3, ok = ttr.guarded_update(
        opt, {k: torch.from_numpy(v) for k, v in grads[3].items()}, ts2, tp2)
    assert bool(ok) == (poison == "grads") and int(ts3.count) == (
        2 if poison == "grads" else 1)


def jax_init_cfg():
    return cfgs()[0]


def port_init_cfg():
    return cfgs()[1]


def _jax_init_shapes(jcfg):
    """The JAX package's initial variable tree, as shapes (traced, not
    run): the structure flax's ``from_bytes`` restores into."""
    return jax.eval_shape(lambda: jax_init_params(jcfg,
                                                  jax.random.PRNGKey(0)))


# ---- checkpoints ------------------------------------------------------------------
@pytest.mark.parametrize("snap", ["hard_moments_r4ft2", "hard",
                                  "hard_moments_r4", "r5_w2_scratch"])
def test_writer_reproduces_shipped_checkpoints(snap):
    """Read a shipped checkpoint into the port's state dict and write it
    back: the bytes the JAX package wrote, exactly."""
    root = os.path.join(os.path.dirname(__file__), "..", "snapshot", snap)
    for stage, modules in (("Desc", DESC_MODULES), ("Pose", POSE_MODULES)):
        with open(os.path.join(root, stage, "best.msgpack"), "rb") as f:
            raw = f.read()
        sd = params_from_numpy(msgpack_restore(raw), modules)
        assert msgpack_dumps(numpy_from_params(sd, modules)) == raw


def test_writer_matches_flax_to_bytes(monkeypatch):
    import bufferx_tpu_torch.tools.weights as tw

    rs = np.random.RandomState(2)
    tree = {"variables": {"w": rs.randn(3, 4).astype(np.float32),
                          "i": np.arange(5, dtype=np.int32)},
            "epoch": 3, "best_loss": 0.25, "neg": -200, "big": 70000,
            "count": np.int32(7), "flag": True, "none": None,
            "empty": np.zeros((0, 3), np.float32),
            "many": {str(i): i for i in range(20)}}
    assert tw.msgpack_dumps(tree) == flax.serialization.to_bytes(tree)
    # arrays above the chunk size are split the way flax splits them
    monkeypatch.setattr(tw, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 16)
    data = tw.msgpack_dumps(tree)
    assert data == flax.serialization.to_bytes(tree)
    assert np.array_equal(msgpack_restore(data)["variables"]["w"],
                          tree["variables"]["w"])


@pytest.mark.parametrize("cfg_patch", [
    dict(desc_mode="moments", desc_pool="gated"),
    dict(desc_mode="sampled", desc_pool="softmax", desc_width=2.0),
])
def test_port_snapshot_reads_in_both_packages(tmp_path, cfg_patch):
    """init_params -> save_snapshot: flax reads it into the JAX package's
    init tree (same structure and shapes), the port loads it back equal,
    and config.json says the architecture."""
    jcfg, tcfg = cfgs()
    jcfg = jcfg.override(patch=cfg_patch)
    tcfg = tcfg.override(patch=cfg_patch)
    sd = init_params(tcfg, torch.Generator().manual_seed(0))
    save_snapshot(str(tmp_path), sd, tcfg)
    template = _jax_init_shapes(jcfg)
    for stage, modules in (("Desc", DESC_MODULES), ("Pose", POSE_MODULES)):
        with open(tmp_path / stage / "best.msgpack", "rb") as f:
            got = flax.serialization.from_bytes(template[stage.lower()],
                                                f.read())
        ref = numpy_from_params(sd[stage.lower()], modules)
        leaves_t = jax.tree_util.tree_leaves_with_path(got)
        leaves_r = dict(jax.tree_util.tree_leaves_with_path(ref))
        assert len(leaves_t) == len(leaves_r)
        for path, leaf in leaves_t:
            assert np.array_equal(np.asarray(leaf), leaves_r[path]), path
    back = load_snapshot(str(tmp_path))
    for name in ("desc", "pose"):
        assert all(torch.equal(back[name][k], sd[name][k]) for k in sd[name])
    assert load_snapshot_config(str(tmp_path)) == {
        "desc_mode": cfg_patch["desc_mode"],
        "desc_pool": cfg_patch["desc_pool"],
        "desc_width": tcfg.patch.desc_width}


def test_init_params_follows_flax_initializers():
    """Shapes equal to the JAX package's init tree; conv kernels a normal
    truncated at two standard deviations with variance 1 / fan_in; biases
    0, BatchNorm scales 1, running statistics 0 and 1."""
    jcfg, tcfg = cfgs()
    sd = init_params(tcfg, torch.Generator().manual_seed(0))
    again = init_params(tcfg, torch.Generator().manual_seed(0))
    template = _jax_init_shapes(jcfg)
    for name, modules in (("desc", DESC_MODULES), ("pose", POSE_MODULES)):
        ref = params_from_numpy(jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype), template[name]), modules)
        assert sorted(ref) == sorted(sd[name])
        for k, v in sd[name].items():
            assert v.shape == ref[k].shape, k
            assert torch.equal(v, again[name][k])
            leaf = k.rsplit(".", 1)[1]
            if leaf == "weight":
                std = (1.0 / v[0].numel()) ** 0.5 / 0.87962566103423978
                z = v / std
                assert float(z.abs().max()) <= 2.0 + 1e-6
                if v.numel() >= 4096:
                    # a normal truncated at 2 sigma, rescaled: unit variance
                    assert abs(float(z.pow(2).mean()) - 0.7737) < 0.05
                    assert abs(float(z.mean())) < 0.05
            else:
                fill = 1.0 if leaf in ("bn_scale", "bn_var") else 0.0
                assert bool((v == fill).all()), k


# ---- the Trainer --------------------------------------------------------------------
def _tiny_stream(setup, n):  # noqa: F811
    def batches():
        for _ in range(n):
            yield torch_batch(setup["batch"])
    return batches


def test_trainer_resume_and_best_loss(setup, tmp_path):  # noqa: F811
    tcfg = setup["tcfg"]
    logs = []
    desc, _ = ttr.train_models(tcfg, load_snapshot(SNAP), "cpu")
    tr = ttr.Trainer(tcfg, "Desc", desc, None, _tiny_stream(setup, 2),
                     steps_per_epoch=2, snapshot_dir=str(tmp_path),
                     log=logs.append)
    tr.train(epochs=1)
    out = tmp_path / "Desc"
    for name in ("0.msgpack", "best.msgpack", "best_meta.json",
                 "state_latest.msgpack", "scalars.jsonl"):
        assert (out / name).exists(), name
    rec = json.loads((out / "scalars.jsonl").read_text().splitlines()[-1])
    assert rec["epoch"] == 0 and rec["stage"] == "Desc"
    best = json.loads((out / "best_meta.json").read_text())["best_loss"]
    assert best == pytest.approx(rec["val_desc_loss"], abs=1e-6)
    assert int(tr.opt_state.count) == 2

    # a new Trainer on the same directory: the best loss persists, and
    # resume continues after the saved epoch with the saved state
    desc2, _ = ttr.train_models(tcfg, load_snapshot(SNAP), "cpu")
    tr2 = ttr.Trainer(tcfg, "Desc", desc2, None, _tiny_stream(setup, 2),
                      steps_per_epoch=2, snapshot_dir=str(tmp_path),
                      log=logs.append)
    assert tr2.best_loss == pytest.approx(best)
    assert tr2.resume()
    assert tr2.start_epoch == 1 and int(tr2.opt_state.count) == 2
    for k, v in desc.state_dict().items():
        assert torch.equal(v, desc2.state_dict()[k]), k
    for k in tr.opt_state.mu:
        assert torch.equal(tr.opt_state.mu[k], tr2.opt_state.mu[k])
    tr2.train(epochs=2)
    assert int(tr2.opt_state.count) == 4
    assert (out / "1.msgpack").exists()
    # a run that does not beat the best loss leaves best.msgpack alone
    with open(out / "best_meta.json", "w") as f:
        json.dump({"best_loss": -1.0, "stage": "Desc"}, f)
    before = (out / "best.msgpack").read_bytes()
    desc3, _ = ttr.train_models(tcfg, load_snapshot(SNAP), "cpu")
    tr3 = ttr.Trainer(tcfg, "Desc", desc3, None, _tiny_stream(setup, 1),
                      steps_per_epoch=1, snapshot_dir=str(tmp_path),
                      log=logs.append)
    assert tr3.best_loss == -1.0
    tr3.train(epochs=1)
    assert (out / "best.msgpack").read_bytes() == before


def test_trainer_pose_stage_and_validation(setup, tmp_path):  # noqa: F811
    tcfg = setup["tcfg"]
    desc, pose = ttr.train_models(tcfg, load_snapshot(SNAP), "cpu")
    tr = ttr.Trainer(tcfg, "Pose", pose, desc, _tiny_stream(setup, 1),
                     val_batches=_tiny_stream(setup, 2), steps_per_epoch=1,
                     snapshot_dir=str(tmp_path), log=lambda *_: None)
    tr.train(epochs=1)
    rec = json.loads((tmp_path / "Pose" / "scalars.jsonl").read_text())
    assert np.isfinite(rec["val_match_loss"]) and rec["grads_finite"] == 1.0
    # the file written is a JAX-readable Pose checkpoint
    jcfg = cfgs()[0]
    template = _jax_init_shapes(jcfg)["pose"]
    with open(tmp_path / "Pose" / "best.msgpack", "rb") as f:
        flax.serialization.from_bytes(template, f.read())
    params = ttr.compose_staged_params(
        os.path.join(SNAP, "Desc", "best.msgpack"),
        str(tmp_path / "Pose" / "best.msgpack"))
    assert all(torch.equal(params["pose"][k], pose.state_dict()[k])
               for k in params["pose"])


# ---- the collapse guard -----------------------------------------------------------
SCRIPT = [
    {"desc_loss": 1.8, "desc_acc": 0.02, "grads_finite": 1.0},   # slow start
    {"desc_loss": 1.5, "desc_acc": 0.2, "grads_finite": 1.0},    # healthy
    {"desc_loss": 1.31, "desc_acc": 0.01, "grads_finite": 1.0},  # saddle
    {"desc_loss": 1.2, "desc_acc": 0.3, "grads_finite": 0.0},    # rejected
    {"desc_loss": 1.0, "desc_acc": 0.4, "grads_finite": 1.0},    # healthy
    {"desc_loss": 1.6, "desc_acc": 0.03, "grads_finite": 1.0},   # crash
    {"desc_loss": 1.29, "desc_acc": 0.04, "grads_finite": 1.0},  # saddle
    {"desc_loss": 1.1, "desc_acc": 0.3, "grads_finite": 0.0},    # rejected
    {"desc_loss": 1.0, "desc_acc": 0.5, "grads_finite": 1.0},
]


@pytest.mark.parametrize("patience,detect_crash", [(2, True), (3, True),
                                                   (2, False), (6, False)])
def test_collapse_guard_decisions(patience, detect_crash):
    jg = jguard.CollapseGuard(patience=patience, detect_crash=detect_crash)
    tg = tguard.CollapseGuard(patience=patience, detect_crash=detect_crash)
    for step, m in enumerate(SCRIPT):
        state = {"w": torch.full((2,), float(step))}
        assert tg.update(step, m, state) == jg.update(
            step, m, {"w": jnp.full((2,), float(step))}), step
        assert (tg.bad_streak, tg.last_good_step, tg.collapsed) == (
            jg.bad_streak, jg.last_good_step, jg.collapsed), step
    if tg.last_good_variables is not None:
        good = tg.restore({"w": torch.zeros(2)})
        assert float(good["w"][0]) == tg.last_good_step
        assert good["w"].device.type == "cpu"
    fresh = tguard.CollapseGuard()
    fallback = {"w": torch.ones(1)}
    assert fresh.restore(fallback) is fallback


# ---- the training tool ---------------------------------------------------------
def test_train_synthetic_tool_on_the_cpu(tmp_path):
    """``tools/train_synthetic.py`` at full width for one step a stage from
    the shipped checkpoint: a snapshot both packages read, with its
    config.json and one scalars line a stage."""
    from bufferx_tpu_torch.tools import train_synthetic

    out = tmp_path / "run"
    assert train_synthetic.main([
        "--cpu", "--hard", "--desc-mode", "moments", "--init-from", SNAP,
        "--steps", "1", "--pose-steps", "1", "--pool", "1",
        "--num-points", "1500", "--out", str(out)]) == 0
    assert load_snapshot_config(str(out)) == {
        "desc_mode": "moments", "desc_pool": "gated", "desc_width": 1.0}
    recs = [json.loads(x) for x in (out / "scalars.jsonl").read_text()
            .splitlines()]
    assert [r["stage"] for r in recs] == ["Desc", "Pose"]
    assert all(r["grads_finite"] == 1.0 for r in recs)
    template = _jax_init_shapes(train_synthetic_jax_cfg())
    for stage in ("Desc", "Pose"):
        with open(out / stage / "best.msgpack", "rb") as f:
            flax.serialization.from_bytes(template[stage.lower()], f.read())
    load_snapshot(str(out))


def train_synthetic_jax_cfg():
    return jax_make_cfg("ModelNet40").override(
        capacity=dict(max_points=4096, sphere_query_chunk=128),
        patch=dict(num_points_per_patch=256, desc_mode="moments"),
        train=dict(pos_num=256))


def test_train_synthetic_phases():
    from bufferx_tpu_torch.tools import train_synthetic as ts

    args = ts._parse(["--curriculum", "--steps", "100", "--pose-steps", "7"])
    desc, pose = ts._stage_phases(args)
    assert args.hard and [n for n, _ in desc] == [12, 18, 25, 25, 20]
    assert desc[3][1]["overlap_range"] == (0.1, 0.6)
    assert pose == [(7, {k: v for k, v in ts.CURRICULUM[2].items()
                         if k != "frac"})]
    args = ts._parse(["--phases", '[{"steps": 3, "overlap_range": [0.2, '
                      '0.4]}, {"steps": 5}]'])
    desc, _ = ts._stage_phases(args)
    assert args.hard and args.steps == 8
    assert desc == [(3, {"overlap_range": (0.2, 0.4)}), (5, {})]
    desc, pose = ts._stage_phases(ts._parse(["--steps", "9"]))
    assert desc == [(9, None)] and pose == [(600, None)]
    cfg = ts.training_config("moments", "softmax", 2.0, lr_scale=0.5)
    assert (cfg.capacity.max_points, cfg.patch.num_points_per_patch,
            cfg.train.pos_num, cfg.capacity.sphere_query_chunk) == (
                4096, 256, 256, 128)
    assert cfg.optim.lr_desc == 0.0005 and cfg.patch.desc_width == 2.0
