"""The reference and the check on the CPU: the frozen copies against the
program, the reference against the port at a tiny size, and the check
failing a run whose timed path is broken underneath.

The control (the reference with TF32 on, in the program's place) only
differs on the card: its test is marked ``chip``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.harness import ROOT, run_cell
from benchmark.tests.conftest import TINY_MIX, tiny_copy

SEED = 2 ** 31 + 29


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_generators_equal_the_programs():
    from benchmark.generators import hardsynth, modelnet

    from bufferx_tpu_torch.data import hardsynth as p_hard
    from bufferx_tpu_torch.data import modelnet as p_model

    kw = dict(family="eval", num_points=1200, overlap_ratio=0.4,
              noise=0.01, density_ratio=2.0, outlier_frac=0.1)
    for a, b in zip(hardsynth.hard_pair(np.random.RandomState(5), **kw),
                    p_hard.hard_pair(np.random.RandomState(5), **kw)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(
            modelnet.synthetic_pair_full_overlap(np.random.RandomState(5),
                                                 1200),
            p_model.synthetic_pair_full_overlap(np.random.RandomState(5),
                                                1200)):
        np.testing.assert_array_equal(a, b)


def test_success_arithmetic_equals_the_programs():
    from benchmark.harness import load_module

    from bufferx_tpu_torch.core import se3

    rs = np.random.RandomState(0)
    for _ in range(8):
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                       2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                       2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w),
                       1 - 2 * (x * x + y * y)]])
        est, gt = np.eye(4), np.eye(4)
        est[:3, :3], est[:3, 3] = R, rs.randn(3)
        rre = se3.compute_rre(torch.from_numpy(est), torch.from_numpy(gt))
        rte = se3.compute_rte(torch.from_numpy(est), torch.from_numpy(gt))
        recall = load_module("metrics", "recall")
        assert abs(recall._rre_deg(est, gt) - float(rre)) < 1e-6
        assert abs(np.linalg.norm(est[:3, 3] - gt[:3, 3]) - float(rte)) \
            < 1e-12
        assert abs(check.rotation_gap_deg(est, gt) - float(rre)) < 1e-6


def test_weights_reader_equals_the_programs():
    from benchmark.reference.weights import load_snapshot

    from bufferx_tpu_torch.tools.weights import load_snapshot as p_load

    for snap in ("hard_moments_r4ft2", "hard"):
        a = load_snapshot(os.path.join(ROOT, "snapshot", snap))
        b = p_load(os.path.join(ROOT, "snapshot", snap))
        for stage in ("desc", "pose"):
            assert a[stage].keys() == b[stage].keys()
            for k in a[stage]:
                assert torch.equal(a[stage][k], b[stage][k])


def test_plain_kernels_equal_the_programs():
    from benchmark.reference.geometry import spt
    from benchmark.reference.kernels import conv_pallas, fps, strat_pallas

    from bufferx_tpu_torch.geometry import spt_pallas as p_spt
    from bufferx_tpu_torch.kernels import conv_pallas as p_conv
    from bufferx_tpu_torch.kernels import fps as p_fps
    from bufferx_tpu_torch.kernels import strat_pallas as p_strat

    g = torch.Generator().manual_seed(0)
    xyz = torch.randn(2, 256, 3, generator=g)
    mask = torch.rand(2, 256, generator=g) > 0.1
    assert torch.equal(fps.farthest_point_sampling(xyz, mask, 40),
                       p_fps.farthest_point_sampling_plain(xyz, mask, 40))
    d2 = torch.rand(2, 16, 256, generator=g)
    q_t = torch.randint(0, 1 << 20, (2, 3, 8, 32), generator=g,
                        dtype=torch.int32)
    off = torch.randint(0, 8, (2, 16, 32), generator=g, dtype=torch.int32)
    radii2 = torch.rand(2, 3, generator=g)
    assert torch.equal(strat_pallas.strat_packed(d2, q_t, off, radii2),
                       p_strat.strat_packed_plain(d2, q_t, off, radii2))
    pts = torch.rand(6, 64, 3, generator=g) * 2 - 1
    pm = torch.rand(6, 64, generator=g) > 0.2
    cells = torch.rand(60, 3, generator=g) * 2 - 1
    assert torch.equal(spt.spt_moments(pts, pm, cells, 0.3),
                       p_spt.spt_moments_plain(pts, pm, cells, 0.3))
    assert torch.equal(spt.spt_cell_query(pts, pm, cells, 0.5, 4),
                       p_spt.spt_cell_query_plain(pts, pm, cells, 0.5, 4))
    x = torch.randn(3, 3, 7, 20, 16, generator=g)
    w = (torch.randn(5328, 128, generator=g) * 0.05).to(torch.bfloat16)
    b = torch.randn(8, 128, generator=g) * 0.1
    assert torch.equal(conv_pallas.cyl_conv_stack(x, w, b),
                       p_conv.cyl_conv_stack_plain(x, w, b))


@pytest.mark.parametrize("preset, snapshot", [
    ("ModelNet40", "hard_moments_r4ft2"), ("3DMatch", "hard")])
def test_reference_equals_the_port_at_a_tiny_size(preset, snapshot):
    """Two-phase serving of a batch of two tiny pairs on the CPU: the port
    (its plain kernels) and the reference give the same results."""
    from benchmark.generators.hard_mixed import pairs
    from benchmark.reference import registration as ref
    from benchmark.reference.weights import load_snapshot

    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.pipeline import registration as reg
    from bufferx_tpu_torch.tools.weights import load_snapshot as p_load
    from benchmark.tests.conftest import TINY_OVERRIDES

    over = {k: dict(v) for k, v in TINY_OVERRIDES.items()}
    if preset == "3DMatch":
        over["patch"]["fused_conv"] = True
    else:
        over["patch"].update(desc_mode="moments", desc_pool="gated")
    cfg = make_cfg(preset).override(**over)
    statics = dataclasses.asdict(reg.PipelineStatics.from_config(cfg))
    statics["is_aligned"] = False
    s = ref.Statics.from_dict(statics)
    pool = pairs(3, dict(TINY_MIX, count=2))
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(1)
    draws = [tuple(reg.make_draws(reg.PipelineStatics.from_config(cfg), gen,
                                  cpu, batch=2) for _ in range(2))]
    models = reg.build_models(reg.PipelineStatics.from_config(cfg),
                              p_load(os.path.join(ROOT, "snapshot",
                                                  snapshot)), cpu)
    got = reg.register_pairs_batched(
        cfg, [reg.prepare_cloud(p[0], cfg, seed=2 * i, device=cpu)
              for i, p in enumerate(pool)],
        [reg.prepare_cloud(p[1], cfg, seed=2 * i + 1, device=cpu)
         for i, p in enumerate(pool)], models, batch_size=2, draws=draws,
        device=cpu)
    rmodels = ref.build_models(s, load_snapshot(os.path.join(
        ROOT, "snapshot", snapshot)), cpu)
    want = ref.register_batches(
        rmodels, s,
        [ref.prepare_cloud(p[0], s.max_points, 2 * i, cpu)
         for i, p in enumerate(pool)],
        [ref.prepare_cloud(p[1], s.max_points, 2 * i + 1, cpu)
         for i, p in enumerate(pool)], [[0, 1]],
        [tuple(ref.Draws(*d) for d in draws[0])])
    for a, b in zip(got, want):
        assert torch.equal(a.pose, b.pose)
        assert int(a.num_inliers) == int(b.num_inliers)
        assert int(a.scales_used) == int(b.scales_used)
        assert int(a.num_mutual) == int(b.num_mutual)


def _identity_pose(reg):
    """A step that returns its state unchanged: the solve hands back the
    pose it starts from."""
    solve = reg._solve

    def broken(statics, cand, pool, rank_draws):
        pose, n = solve(statics, cand, pool, rank_draws)
        eye = torch.eye(4, dtype=pose.dtype, device=pose.device)
        return eye.expand_as(pose).clone(), n
    reg._solve = broken


def _half_batch(reg):
    """Half of the batch left out: a batch registers its first half, and
    the rest take those results."""
    register = reg._register_batch

    def broken(models, statics, src, tgt, draws, scales, is_aligned):
        b = src.xyz.shape[0]
        h = max(b // 2, 1)
        part = register(models, statics, reg.Cloud(src.xyz[:h], src.mask[:h]),
                        reg.Cloud(tgt.xyz[:h], tgt.mask[:h]),
                        type(draws)(*(x[:h] for x in draws)), scales,
                        is_aligned)
        take = torch.arange(b) % h
        return reg.RegistrationResult(*(x[take] for x in part))
    reg._register_batch = broken


def _altered_answer(reg):
    """An answer altered where it is produced: every solved pose moved by
    5 cm along x."""
    pool_and_solve = reg._pool_and_solve

    def broken(*a, **kw):
        res = pool_and_solve(*a, **kw)
        pose = res.pose.clone()
        pose[:, 0, 3] += 0.05
        return res._replace(pose=pose)
    reg._pool_and_solve = broken


def _one_pair_wrong(reg):
    """A fault on a minority of pairs: the last pair of every batched call
    is served with the identity pose."""
    register = reg.register_pairs_batched

    def broken(*a, **kw):
        res = list(register(*a, **kw))
        pose = res[-1].pose
        res[-1] = res[-1]._replace(pose=torch.eye(
            4, dtype=pose.dtype, device=pose.device))
        return res
    reg.register_pairs_batched = broken


def _no_redo(reg):
    """The early exit's read returns counts that never send a pair on."""
    reg._fetch_inliers = lambda res: [10 ** 9] * int(res.num_inliers.numel())


def _altered_matches(reg):
    """An answer altered where it is produced: every tenth mutual match of
    every scale dropped."""
    mutual_nearest = reg.mutual_nearest

    def broken(*a, **kw):
        nn, mutual, d2 = mutual_nearest(*a, **kw)
        mutual = mutual.clone()
        mutual[:, ::10] = False
        return nn, mutual, d2
    reg.mutual_nearest = broken


FAULTS = {"identity_pose": _identity_pose, "half_batch": _half_batch,
          "altered_answer": _altered_answer, "no_redo": _no_redo,
          "altered_matches": _altered_matches,
          "one_pair_wrong": _one_pair_wrong}
# the faults each cell can have, run on a tiny copy of its configuration and
# entry and judged by its own check's numbers, far thresholds and limits
CELL_FAULTS = [
    ("moments.mixed.b8", "tiny_moments", "batched",
     ("identity_pose", "half_batch", "altered_answer", "no_redo",
      "altered_matches", "one_pair_wrong")),
    ("moments.online.b1", "tiny_moments", "online",
     ("identity_pose", "altered_answer", "altered_matches")),
    ("sampled3dm.gate.b8", "tiny_sampled", "batched",
     ("identity_pose", "half_batch", "altered_answer", "no_redo",
      "altered_matches")),
    ("moments.easy.b8", "tiny_moments", "batched",
     ("identity_pose", "half_batch", "altered_answer", "no_redo",
      "altered_matches", "one_pair_wrong")),
]


def _cell_rules(workload: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "checks",
                           workload + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload, config, entry, fault", [
    (w, c, e, f) for w, c, e, faults in CELL_FAULTS for f in faults])
def test_a_broken_timed_path_is_not_correct(tmp_path, workload, config,
                                            entry, fault):
    """The whole run but the look for a card, with the program broken
    underneath: ``correct`` comes out false under the cell's check."""
    import bufferx_tpu_torch.pipeline.registration as reg

    saved = dict(vars(reg))
    bench, root = tiny_copy(tmp_path, entry=entry, config_name=config,
                            rules=_cell_rules(workload))
    try:
        result, _ = run_cell("tiny.cell", SEED, 0.01, False,
                             time.perf_counter(), bench=bench, root=root,
                             need_cuda=False, program_hook=FAULTS[fault])
    finally:
        for k, v in saved.items():
            setattr(reg, k, v)
    assert result["correct"] is False
    if fault == "one_pair_wrong":
        # one checked pair of four: the medians pass, the far share fails
        judged = result["check"]
        assert judged["far_share"]["value"] == 0.25
        assert all(j["value"] <= j["limit"] for name, j in judged.items()
                   if name != "far_share")


@pytest.mark.parametrize("workload, config, entry", [
    (w, c, e) for w, c, e, _faults in CELL_FAULTS])
def test_a_sound_run_is_correct(tmp_path, workload, config, entry):
    bench, root = tiny_copy(tmp_path, entry=entry, config_name=config,
                            rules=_cell_rules(workload))
    result, _ = run_cell("tiny.cell", SEED, 0.01, False, time.perf_counter(),
                         bench=bench, root=root, need_cuda=False)
    assert result["correct"] is True
    assert all(j["value"] == 0.0 for j in result["check"].values())


def test_control_readings_on_a_tiny_copy(tmp_path, capsys):
    """``benchmark/control.py`` rehearsed on the CPU: a line a seed and
    side; the program's plain path reads 0 against the reference (TF32 has
    no effect on the CPU, so the control does too)."""
    from benchmark import control

    bench, root = tiny_copy(tmp_path)
    control.main(["--workload", "tiny.cell", "--seeds", "3", "--calls", "1",
                  "--control", "--device", "cpu"], bench=bench, root=root)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["side"] for r in rows] == ["program", "control"]
    assert rows[0]["pairs"] == 4
    assert rows[0]["numbers"]["mutual_gap.median"] == 0.0


@pytest.mark.chip
def test_the_control_is_not_correct(card):
    """On the card at the cell's size: the reference with TF32 on, in the
    program's place, fails the cell's check where the program passes."""
    import io
    from contextlib import redirect_stdout

    from benchmark import control

    buf = io.StringIO()
    with redirect_stdout(buf):
        control.main(["--workload", "moments.mixed.b8", "--seeds", "5",
                      "--calls", "1", "--control"])
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    limits = _cell_rules("moments.mixed.b8")["limits"]
    sides = {r["side"]: check.judge(r["numbers"], limits)[0] for r in rows}
    assert sides == {"program": True, "control": False}
