"""Spans inside the port's pipeline (``utils/timers.py``: ``span``,
``spanned``, ``tracing``, ``spans``), on the CPU at the small size of
``test_torch_pipeline.py``, ``hard_moments_r4ft2`` weights.

Off (no ``tracing()`` block, no profiler) a span enters no
``record_function`` and stores nothing. On, under ``tracing()`` or under a
CPU ``torch.profiler``, two-phase serving of 3 pairs at batch size 2, with
an early-exit threshold at which only the first batch is redone, gives one
``bufferx.serve`` tree: phase 1 with a pass a batch, phase 2 with a fetch a
batch and the redo pass, each pass ``precompute``, ``candidates`` a scale
(each with its ``describe``) and ``solve`` (with its ``ransac``), with
the pass's pairs, and
every span under the one root. Results are bit-equal with tracing on and
off. Each single entry point is one ``bufferx.register`` root; the clutter
prefilter and IRLS nest under ``precompute`` and ``solve``. The store
keeps at most ``SPAN_CAPACITY`` records. The stage spans time the stream
(on the CPU their stream time is their host time); the others do not.
"""

import numpy as np
import pytest
import torch

from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.tools.weights import load_snapshot
from bufferx_tpu_torch.utils import timers
from bufferx_tpu_torch.utils.timers import (SPAN_CAPACITY, span, spanned,
                                            spans, tracing)
from test_torch_pipeline import SMALL, SNAP, few_threads  # noqa: F401

# pool seeds, in batch order: batch 0 holds the first two, batch 1 the last
SEEDS = (2, 0, 4)
BATCH = 2
SCALES = 3
STAGES = {"bufferx.precompute", "bufferx.candidates", "bufferx.describe",
          "bufferx.solve", "bufferx.ransac", "bufferx.prefilter",
          "bufferx.refine"}


def _serve(w, cfg):
    return treg.register_pairs_batched(
        cfg, w["srcs"], w["tgts"], w["models"], batch_size=BATCH,
        draws=w["draws"], device="cpu")


@pytest.fixture(scope="module")
def world():
    """The pairs, their draws (each pair's own, stacked a batch; phase 2
    reuses them), the threshold at which batch 0 alone redoes pairs (the
    scale-0 inliers of batch 1's pair: batch 0's weaker pairs fall below
    it), and the results with tracing off."""
    cfg = make_cfg("ModelNet40").override(**SMALL)
    statics = treg.PipelineStatics.from_config(cfg)
    models = treg.build_models(statics, load_snapshot(SNAP), "cpu")
    srcs, tgts, one = [], [], []
    for i in SEEDS:
        s, t, _T = synthetic_pair_full_overlap(np.random.RandomState(i), 2000)
        srcs.append(treg.prepare_cloud(s, cfg, seed=i, device="cpu"))
        tgts.append(treg.prepare_cloud(t, cfg, seed=i, device="cpu"))
        one.append(treg.make_draws(statics, torch.Generator().manual_seed(i),
                                   "cpu"))
    draws = [(treg.stack_draws(one[i:i + BATCH]),) * 2
             for i in range(0, len(SEEDS), BATCH)]
    w = dict(cfg=cfg, models=models, srcs=srcs, tgts=tgts, one=one,
             draws=draws)
    exits = _serve(w, cfg.override(match=dict(early_exit_min_inliers=1)))
    inliers = [int(r.num_inliers) for r in exits]
    threshold = inliers[-1]
    redone = sum(n < threshold for n in inliers[:BATCH])
    assert redone >= 1, inliers
    w["cfg"] = cfg.override(match=dict(early_exit_min_inliers=threshold))
    w["redone"] = redone
    w["off"] = _serve(w, w["cfg"])
    assert [int(r.scales_used) for r in w["off"]].count(SCALES) == redone
    assert spans() == []
    return w


def _pass(pairs, parent, scales):
    out = [("bufferx.precompute", pairs, parent)]
    for _ in range(scales):
        out += [("bufferx.candidates", pairs, parent),
                ("bufferx.describe", pairs, "bufferx.candidates")]
    return out + [("bufferx.solve", pairs, parent),
                  ("bufferx.ransac", pairs, "bufferx.solve")]


def _tree(records) -> list:
    """[(name, pairs, parent's name)] in the order the spans opened."""
    by_id = {r.id: r for r in records}
    return [(r.name, r.pairs, by_id[r.parent].name if r.parent else None)
            for r in sorted(records, key=lambda r: r.id)]


def test_tracing_off_enters_no_record_function(world, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    out = _serve(world, world["cfg"])
    treg.register_pair(world["cfg"], world["srcs"][0], world["tgts"][0],
                       world["models"], draws=world["one"][0], device="cpu")
    assert spans() == []
    for got, ref in zip(out, world["off"]):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["tracing", "profiler"])
def test_two_phase_serving_tree(world, mode):
    """One root, its phases, a fetch a batch, each pass's stages with the
    pass's pairs; results bit-equal to tracing off."""
    n, r = len(SEEDS), world["redone"]
    if mode == "tracing":
        with tracing():
            out = _serve(world, world["cfg"])
        names = None
    else:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = _serve(world, world["cfg"])
        names = [e.name for e in prof.events()
                 if e.name.startswith("bufferx.")]
    records = spans()
    want = ([("bufferx.serve", n, None),
             ("bufferx.phase1", n, "bufferx.serve")]
            + _pass(BATCH, "bufferx.phase1", 1)
            + _pass(n - BATCH, "bufferx.phase1", 1)
            + [("bufferx.phase2", n, "bufferx.serve"),
               ("bufferx.fetch", BATCH, "bufferx.phase2")]
            + _pass(r, "bufferx.phase2", SCALES)
            + [("bufferx.fetch", n - BATCH, "bufferx.phase2")])
    assert _tree(records) == want
    root = records[-1]
    assert root.name == "bufferx.serve" and root.parent is None
    assert {rec.root for rec in records} == {root.id}
    for rec in records:
        assert rec.host_ms >= 0.0
        assert rec.stream_ms == (rec.host_ms if rec.name in STAGES else None)
    by_name = {rec.name: rec for rec in records}
    assert root.host_ms >= (by_name["bufferx.phase1"].host_ms
                            + by_name["bufferx.phase2"].host_ms)
    if names is not None:       # the profiler's trace holds every span
        assert sorted(names) == sorted(rec.name for rec in records)
    assert spans() == []
    for got, ref in zip(out, world["off"]):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["register_pair", "register_batch",
                                   "register_pair_early_exit",
                                   "register_pair_timed"])
def test_single_entry_is_one_register_root(world, entry):
    w = world
    src, tgt, draws = w["srcs"][0], w["tgts"][0], w["one"][0]
    with tracing():
        if entry == "register_batch":
            treg.register_batch(w["cfg"], [src], [tgt], w["models"],
                                draws=treg.stack_draws([draws]), device="cpu")
        elif entry == "register_pair_early_exit":
            treg.register_pair_early_exit(w["cfg"], src, tgt, w["models"],
                                          draws=(draws, draws), device="cpu")
        else:
            getattr(treg, entry)(w["cfg"], src, tgt, w["models"], draws=draws,
                                 device="cpu")
    records = spans()
    roots = [rec for rec in records if rec.parent is None]
    assert [(rec.name, rec.pairs) for rec in roots] == [("bufferx.register",
                                                         1)]
    assert {rec.root for rec in records} == {roots[0].id}
    names = [rec.name for rec in records]
    assert names.count("bufferx.candidates") == names.count(
        "bufferx.describe") >= 1
    assert "bufferx.precompute" in names and "bufferx.solve" in names


def test_prefilter_and_refine_nest_in_their_stages(world):
    w = world
    cfg = w["cfg"].override(data=dict(clutter_filter=True),
                            test=dict(pose_refine=True))
    with tracing():
        treg.register_pair(cfg, w["srcs"][0], w["tgts"][0], w["models"],
                           draws=w["one"][0], device="cpu")
    tree = _tree(spans())
    assert ("bufferx.prefilter", 1, "bufferx.precompute") in tree
    assert ("bufferx.refine", 1, "bufferx.solve") in tree
    assert [t[0] for t in tree].count("bufferx.register") == 1


def test_prepare_is_its_own_root():
    cfg = make_cfg("ModelNet40").override(**SMALL)
    pts = np.random.RandomState(0).rand(100, 3).astype(np.float32)
    treg.prepare_cloud(pts, cfg, device="cpu")
    assert spans() == []
    with tracing():
        treg.prepare_cloud(pts, cfg, device="cpu")
    (rec,) = spans()
    assert (rec.name, rec.pairs, rec.parent, rec.root) == (
        "bufferx.prepare", None, None, rec.id)


def test_store_keeps_at_most_its_capacity():
    with tracing():
        for _ in range(SPAN_CAPACITY + 5):
            with span("bufferx.test"):
                pass
        assert len(timers._TRACER.store) == SPAN_CAPACITY
    records = spans()
    assert len(records) == SPAN_CAPACITY
    ids = [rec.id for rec in records]        # the oldest five were dropped
    assert ids == list(range(ids[0], ids[0] + SPAN_CAPACITY))
    assert spans() == []


def test_spanned_puts_every_call_in_a_span():
    @spanned("bufferx.test", pairs=lambda xs, *_a, **_k: len(xs))
    def scaled(xs, scale=1):
        """Each x times scale."""
        with span("bufferx.inner"):
            return [x * scale for x in xs]

    assert scaled([1, 2], scale=3) == [3, 6] and spans() == []
    assert scaled.__doc__ == "Each x times scale."
    with tracing():
        assert scaled([1, 2, 3]) == [1, 2, 3]
    inner, outer = spans()
    assert (outer.name, outer.pairs, outer.parent) == ("bufferx.test", 3, None)
    assert (inner.name, inner.pairs, inner.parent, inner.root) == (
        "bufferx.inner", None, outer.id, outer.id)


def test_only_stream_spans_time_the_stream():
    with tracing():
        with span("bufferx.test", pairs=2, stream=True):
            with span("bufferx.inner"):
                pass
    inner, outer = spans()
    assert inner.stream_ms is None
    assert outer.stream_ms == outer.host_ms >= 0.0


def test_span_off_is_a_flag_check():
    assert span("bufferx.test") is span("bufferx.test", pairs=3)
    with span("bufferx.test"):
        pass
    assert spans() == []
    with tracing(), tracing():
        pass
    assert timers._TRACER.forced == 0


def test_trace_pair_reads_the_spans_and_the_union():
    """``tools/trace_pair.py``: the first call's span tree, its table of the
    spans a pair (over the pairs of the calls' roots), its busy time as the
    union of the device operations inside the window, and its window from
    the profile's own span."""
    from bufferx_tpu_torch.tools import trace_pair

    ops = [("k", 0.0, 10.0, "kernel"), ("k", 5.0, 10.0, "kernel"),
           ("c", 20.0, 5.0, "gpu_memcpy"), ("k", 95.0, 10.0, "kernel")]
    assert trace_pair._busy_us(ops, (2.0, 100.0)) == 13.0 + 5.0 + 5.0
    SR = timers.SpanRecord
    records = [SR("bufferx.solve", 3, 2, 1, 2, 4.0, 8.0),
               SR("bufferx.phase1", 2, 1, 1, 2, 5.0, 10.0),
               SR("bufferx.precompute", 6, 5, 5, 2, 2.0, 6.0),
               SR("bufferx.serve", 1, None, 1, 2, 9.0, None),
               SR("bufferx.solve", 7, 5, 5, 2, 2.0, 4.0),
               SR("bufferx.serve", 5, None, 5, 2, 9.0, None)]
    tree = trace_pair._span_tree(records)
    assert [(d, r.name) for d, r in tree] == [
        (0, "bufferx.serve"), (1, "bufferx.phase1"), (2, "bufferx.solve")]
    assert trace_pair._span_tree([]) == []
    table = trace_pair._span_table(records)
    assert list(table) == ["bufferx.serve", "bufferx.phase1",
                           "bufferx.solve", "bufferx.precompute"]
    assert table["bufferx.solve"] == {"count": 2, "stream_ms": 3.0,
                                      "host_ms": 1.5}
    assert table["bufferx.serve"]["stream_ms"] is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace_pair.WINDOW):
            torch.ones(8).sum()
    window, device = trace_pair._device_ops(prof)
    assert window[1] > window[0] and device == []
