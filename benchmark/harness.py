"""One run of one cell of ``BENCHMARK.json`` on the card.

Everything that belongs to a configuration, a traffic mix, an entry, a
metric, a kernel's count or a cell's check lives in a file of its own that
the harness finds by name:

- ``configs/<config>.json``: the program's preset, the snapshot, the
  overrides, and the statics the program must derive from them;
- ``traffic/<traffic>.json``: a generator and its parameters, the entry and
  its parameters, the success thresholds;
- ``generators/<generator>.py``: ``pairs(seed, params)``;
- ``entries/<entry>.py``: ``Entry(env)`` with ``warm()``, ``call()``,
  ``passes(records)`` and ``check_groups(records)``;
- ``metrics/<metric>.py``: ``read(run)``, a number or None;
- ``counts/<kernel>.py``: ``KERNEL`` and ``launches(statics, passes)``;
- ``checks/<workload>.json``: the limits of the check's numbers.

A run: set-up (kernels built or loaded, snapshot, pool, warm-up),
then the window of ``--seconds``, closed-loop entry calls back to back,
with ``--trace 1`` the first ``trace_calls`` of them under the profiler,
then the check against the reference, then the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time

__all__ = ["BENCH", "ROOT", "Run", "load_module", "find_cell",
           "metrics_for", "run_cell", "FORBIDDEN"]

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "bufferx_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench: str = BENCH):
    """``<bench>/<kind>/<name>.py`` as a module (the name may hold dots)."""
    path = os.path.join(bench, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path}")
    key = f"benchmark.{kind}._{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def count_modules(bench: str = BENCH) -> dict:
    """{kernel: module} of every file in ``counts/``."""
    folder = os.path.join(bench, "counts")
    return {f[:-3]: load_module("counts", f[:-3], bench)
            for f in sorted(os.listdir(folder))
            if f.endswith(".py") and not f.startswith("_")}


def find_cell(spec: dict, workload: str, bench: str = BENCH) -> tuple:
    """(workload entry, configuration, traffic) of a cell by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[workload]
    config = load_json(os.path.join(bench, "configs", w["config"] + ".json"))
    traffic = load_json(os.path.join(bench, "traffic",
                                     w["traffic"] + ".json"))
    return w, config, traffic


def metrics_for(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: with ``trace`` the
    per-layer ones, else the end-to-end ones. An entry with a
    ``workloads`` list applies to those cells; a per-layer one without it
    to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


@dataclasses.dataclass
class Run:
    """What a metric reader sees of a run."""
    workload: str
    seed: int
    statics: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    records: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    trace: object = None           # benchmark.trace.Trace of the traced calls
    traced_records: list = dataclasses.field(default_factory=list)
    traced_passes: list = dataclasses.field(default_factory=list)
    stages: dict | None = None     # {"desc": ms, "pose": ms}
    model_units: dict | None = None
    gt: list = dataclasses.field(default_factory=list)  # T_gt a pool pair
    bench: str = BENCH


class Env:
    """What an entry sees: the program, its configuration and models, the
    pool of raw pairs, the seed, the device, and the span helper."""

    def __init__(self, reg, cfg, models, statics, traffic, pool, seed,
                 device, profiling):
        self.reg, self.cfg, self.models = reg, cfg, models
        self.statics, self.traffic, self.pool = statics, traffic, pool
        self.seed, self.device = seed, device
        self.profiling = profiling

    def span(self, name: str):
        if not self.profiling:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def program_config(config: dict):
    """The program's Config for a configuration file, checked: the statics
    the program derives from it must equal the file's."""
    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.pipeline.registration import PipelineStatics

    cfg = make_cfg(config["preset"]).override(**config["overrides"])
    got = dataclasses.asdict(PipelineStatics.from_config(cfg))
    got["is_aligned"] = cfg.patch.is_aligned_to_global_z
    want = config["statics"]
    diff = {k: (got.get(k), v) for k, v in want.items()
            if (list(got[k]) if isinstance(got.get(k), tuple) else got.get(k))
            != v}
    if diff:
        raise ValueError(f"the program no longer runs configuration "
                         f"{config['name']!r} as its file states: "
                         f"(program, file) {diff}")
    return cfg


def _device_check(chips: int, need_cuda: bool):
    import torch
    if not need_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, *, bench: str = BENCH, root: str = ROOT,
             need_cuda: bool = True, program_hook=None) -> tuple:
    """Run one cell once. Returns (result dict, check lines). ``bench``
    holds the benchmark's files and ``root`` the checkout (its
    ``BENCHMARK.json`` and snapshots). With ``need_cuda`` False the run
    takes the CPU (the tests' tiny runs); a ``program_hook(reg)`` may wrap
    the program's entry points (the tests' planted faults)."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    w, config, traffic = find_cell(spec, workload, bench)
    device = _device_check(int(w["chips"]), need_cuda)

    import torch

    from benchmark import check, modelflops
    from benchmark.trace import read_chrome_trace

    from bufferx_tpu_torch import cuda_build
    from bufferx_tpu_torch.pipeline import registration as reg
    from bufferx_tpu_torch.tools.weights import load_snapshot

    log(f"imports done at {time.perf_counter() - t_start:.2f} s")
    if program_hook is not None:
        program_hook(reg)
    cfg = program_config(config)
    statics = config["statics"]
    if device.type == "cuda":
        built = cuda_build.build_all()
        log(f"kernels built or loaded in {built:.2f} s")
    models = reg.build_models(reg.PipelineStatics.from_config(cfg),
                              load_snapshot(os.path.join(root,
                                                         config["snapshot"])),
                              device)
    log(f"models loaded at {time.perf_counter() - t_start:.2f} s")
    gen = load_module("generators", traffic["generator"], bench)
    t = time.perf_counter()
    pool = gen.pairs(seed, traffic["params"])
    log(f"pool of {len(pool)} pairs made in {time.perf_counter() - t:.2f} s")
    env = Env(reg, cfg, models, statics, traffic, pool, seed, device, trace)
    entry = load_module("entries", traffic["entry"], bench).Entry(env)
    log(f"entry ready at {time.perf_counter() - t_start:.2f} s")
    entry.warm()
    _sync(device)
    run = Run(workload=workload, seed=seed, statics=statics, traffic=traffic,
              gt=[p[2] for p in pool], bench=bench)
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s")

    # ---- the window --------------------------------------------------------
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    trace_path = os.path.join(tempfile.gettempdir(),
                              f"bench_trace_{os.getpid()}.json")
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    end = t0 + seconds
    calls = 0
    while time.perf_counter() < end:
        if prof is not None and calls < entry.trace_calls:
            with torch.profiler.record_function("bench.window"):
                run.traced_records += entry.call()
            if calls + 1 == entry.trace_calls:
                prof.stop()
        else:
            run.records += entry.call()
        calls += 1
    _sync(device)
    run.window_s = time.perf_counter() - t0
    if prof is not None and calls < entry.trace_calls:
        prof.stop()
    run.records = run.traced_records + run.records
    if device.type == "cuda":
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    log(f"window {run.window_s:.3f} s, {calls} calls, "
        f"{len(run.records)} pairs")

    if prof is not None:
        prof.export_chrome_trace(trace_path)
        del prof
        run.trace = read_chrome_trace(trace_path)
        os.remove(trace_path)
        run.traced_passes = entry.passes(run.traced_records)
        run.model_units = modelflops.unit_flops(statics)
        if hasattr(entry, "stages"):
            run.stages = entry.stages()

    # ---- the check ---------------------------------------------------------
    groups = entry.check_groups(run.records)
    del env.models, models, entry
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    refs = check.reference_records(root, config, pool, groups, device)
    served = [r for g in groups for r in g[3]]
    gaps = [check.pair_gaps(s, r) for s, r in zip(served, refs)]
    rules = load_json(os.path.join(bench, "checks", workload + ".json"))
    values = check.numbers(gaps, rules)
    correct, judged = check.judge(values, rules["limits"])
    log(f"reference: {len(refs)} pairs in {time.perf_counter() - t:.2f} s")
    log("check gaps: " + json.dumps([{k: (round(v, 6) if isinstance(v, float)
                                          else v) for k, v in g.items()}
                                     for g in gaps]))
    log("check numbers: " + json.dumps(values))

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run's process loaded {bad}: the benchmark "
                         "runs the port alone")

    # ---- the result line ---------------------------------------------------
    metrics = {}
    for m in metrics_for(spec, workload, trace):
        value = load_module("metrics", m["name"], bench).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(run.records),
              "failed": sum(not r.valid for r in run.records),
              "metrics": metrics,
              "device": _device(device, run)}
    if trace and run.trace is not None:
        result["breakdown"] = _breakdown(run.trace)
    result["check"] = judged
    lines = [f"check {name}: {j['value']} (limit {j['limit']})"
             for name, j in judged.items()]
    return result, lines


def _device(device, run: Run) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": run.peak_bytes}
    if run.trace is not None:
        out["busy_s"] = run.trace.busy_s()
        out["window_s"] = run.trace.window_s
    return out


def _breakdown(trace) -> dict:
    ops = sorted(trace.device_by_name().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in trace.idle_gaps(10)]}


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start)
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0

