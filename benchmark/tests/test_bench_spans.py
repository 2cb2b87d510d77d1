"""The readers of the program's spans (``benchmark/spans.py`` and the
metrics ``stage_ms.*``, ``idle_share.*``, ``host_syncs_per_pair``), on the
CPU: the helper on a hand-made trace and span list, and tiny traced runs
whose result lines carry every metric that names their cell's kind.

On the CPU the profiler records no device operation, so the harness reads
no traced window; the tiny runs here let the trace's host operators stand
in for device operations (the gaps between them are then the host's time
outside any operator), which is enough to exercise the attribution.
"""

from __future__ import annotations

import json
import time

import pytest

import benchmark.trace
from benchmark import spans as bspans
from benchmark.harness import Run, load_module, metrics_for, run_cell
from benchmark.tests.conftest import tiny_copy
from benchmark.trace import Trace
from bufferx_tpu_torch.utils import timers
from bufferx_tpu_torch.utils.timers import SpanRecord

SEED = 2 ** 31 + 17
STAGES = ("precompute", "candidates", "describe", "solve")
ALL_CELLS = (["stage_ms." + s for s in STAGES]
             + ["idle_share.ingest", "idle_share.dispatch",
                "host_syncs_per_pair"])
GATE_ONLY = ["stage_ms.prefilter", "stage_ms.refine"]


def _trace() -> Trace:
    """Window 0-100 us. Device busy 12-15, 30-40, 52-62, 66-86: gaps 0-12
    (under bufferx.prepare), 15-30 and 40-52 (bufferx.phase1 inside
    bufferx.serve), 62-66 (bufferx.fetch), 86-100 (no program span: serve
    ends at 90, the midpoint is 93). Host operators over the gaps do not
    take them from the program's spans."""
    device = [("k", 12.0, 3.0, "kernel"), ("k", 30.0, 10.0, "kernel"),
              ("memcpy", 52.0, 10.0, "gpu_memcpy"), ("k", 66.0, 20.0,
                                                     "kernel")]
    host = [("bench.window", 0.0, 100.0), ("bench.prepare", 0.0, 20.0),
            ("bufferx.prepare", 0.0, 20.0), ("aten::to", 2.0, 10.0),
            ("bufferx.serve", 20.0, 70.0), ("bufferx.phase1", 20.0, 30.0),
            ("aten::add", 44.0, 6.0), ("bufferx.phase2", 55.0, 35.0),
            ("bufferx.fetch", 60.0, 5.0),
            # syncs: in prepare, in phase 1, in fetch; one outside
            ("cudaMemcpy", 10.0, 1.0),
            ("cudaDeviceSynchronize_v3020", 45.0, 1.0),
            ("cudaStreamSynchronize", 62.0, 1.0),
            ("cudaMemcpyAsync", 61.0, 1.0),
            ("cudaLaunchKernel", 63.0, 0.5),
            ("cudaStreamSynchronize", 95.0, 1.0)]
    return Trace((0.0, 100.0), device, host)


def _run(trace=None, pairs=4, records=None) -> Run:
    run = Run(workload="x", seed=0, statics={}, traffic={}, trace=trace,
              traced_records=[object()] * pairs)
    if records is not None:
        run._program_spans = records
    return run


def test_innermost_span_of_each_point():
    spans = [(0.0, 20.0, "a"), (20.0, 90.0, "b"), (20.0, 50.0, "c"),
             (60.0, 65.0, "d"), (61.0, 62.0, "e")]
    points = [93.0, 6.0, 22.5, 46.0, 64.0, 61.5, 50.0, 55.0, 20.0]
    assert bspans.innermost(spans, points) == [
        None, "a", "c", "c", "d", "e", "c", "b", "c"]
    assert bspans.innermost([], [1.0]) == [None]


def test_gaps_split_by_the_innermost_program_span():
    trace = _trace()
    split = bspans.idle_split(_run(trace))
    assert split == pytest.approx({"ingest": 12.0, "dispatch": 31.0})
    idle = 100.0 * (1 - trace.busy_s() / trace.window_s)
    assert idle == pytest.approx(57.0)
    # the gap under no program span is in neither share
    assert sum(split.values()) == pytest.approx(idle - 14.0)
    for name, key in (("idle_share.ingest", "ingest"),
                      ("idle_share.dispatch", "dispatch")):
        reader = load_module("metrics", name)
        assert reader.read(_run(trace)) == pytest.approx(split[key])


def test_syncs_counted_inside_program_spans_per_pair():
    # cudaMemcpy in prepare, the versioned device sync in phase 1, the
    # stream sync in fetch; not the async copy, the launch, or the sync
    # after serve
    assert bspans.host_syncs_per_pair(_run(_trace(), pairs=4)) == 0.75
    reader = load_module("metrics", "host_syncs_per_pair")
    assert reader.read(_run(_trace(), pairs=3)) == 1.0


def test_stage_ms_sums_stream_ms_over_the_traced_pairs():
    records = [SpanRecord("bufferx.precompute", 1, None, 1, 8, 9.0, 4.0),
               SpanRecord("bufferx.precompute", 2, None, 2, 3, 5.0, 2.0),
               SpanRecord("bufferx.solve", 3, None, 3, 8, 1.0, 6.0)]
    run = _run(pairs=4, records=records)
    assert bspans.stage_ms(run, "bufferx.precompute") == 1.5
    assert load_module("metrics", "stage_ms.solve").read(run) == 1.5
    assert load_module("metrics", "stage_ms.refine").read(run) is None


def test_nothing_to_read_gives_none(monkeypatch):
    """No trace, a trace without program spans (a program that has none),
    and a program without a store: every reader returns None."""
    no_program = _trace()._replace(host=[h for h in _trace().host
                                         if not h[0].startswith("bufferx.")])
    for run in (_run(None), _run(no_program)):
        assert bspans.idle_split(run) is None
        assert bspans.host_syncs_per_pair(run) is None
    monkeypatch.delattr(timers, "spans")
    run = _run(_trace())
    assert bspans.program_spans(run) is None
    for name in ALL_CELLS + GATE_ONLY:
        if name.startswith("stage_ms."):
            assert load_module("metrics", name).read(run) is None


def test_the_store_is_read_once_a_run():
    with timers.tracing():
        with timers.span("bufferx.solve", pairs=2):
            pass
    run = _run(pairs=2)
    first = bspans.program_spans(run)
    assert [r.name for r in first] == ["bufferx.solve"]
    assert bspans.program_spans(run) is first
    assert timers.spans() == []


def _host_ops_as_device(monkeypatch):
    """The harness's trace reader, with each host operator (``cpu_op``) of
    the exported trace copied as a device operation."""
    inner = benchmark.trace.read_chrome_trace

    def read(path):
        with open(path) as f:
            data = json.load(f)
        data["traceEvents"] += [dict(ev, cat="kernel")
                                for ev in data["traceEvents"]
                                if ev.get("cat") == "cpu_op"]
        with open(path, "w") as f:
            json.dump(data, f)
        return inner(path)

    monkeypatch.setattr(benchmark.trace, "read_chrome_trace", read)


@pytest.mark.parametrize("entry, config, names", [
    ("batched", "tiny_moments", ALL_CELLS),
    ("batched", "tiny_sampled", ALL_CELLS + GATE_ONLY),
    ("online", "tiny_moments", ALL_CELLS),
])
def test_traced_tiny_run_reports_the_span_metrics(tmp_path, monkeypatch,
                                                  entry, config, names):
    bench, root = tiny_copy(tmp_path, entry=entry, config_name=config)
    _host_ops_as_device(monkeypatch)
    timers.spans()
    result, _lines = run_cell("tiny.cell", SEED, 0.01, True,
                              time.perf_counter(), bench=bench, root=root,
                              need_cuda=False)
    assert result["correct"] is True
    spec = json.load(open(f"{root}/BENCHMARK.json"))
    assert set(names) <= {m["name"] for m in metrics_for(spec, "tiny.cell",
                                                         True)}
    got = result["metrics"]
    for name in names:
        assert got[name]["value"] is not None and got[name]["value"] >= 0.0
    assert got["stage_ms.describe"]["value"] <= \
        got["stage_ms.candidates"]["value"]
    idle = got["device_idle_share"]["value"]
    assert (got["idle_share.ingest"]["value"]
            + got["idle_share.dispatch"]["value"]) <= idle + 1e-9
    assert got["idle_share.ingest"]["value"] > 0.0
    assert got["idle_share.dispatch"]["value"] > 0.0
    # no prefilter or IRLS on the moments path
    for name in set(GATE_ONLY) - set(names):
        assert name not in got
    assert timers.spans() == []
