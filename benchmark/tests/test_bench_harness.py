"""The harness on the CPU: the result line, discovery by file name (the
check's reference too), the contract of BENCHMARK.json, the kernel counts
and the import guard.

Run with ``python -m pytest benchmark/tests -q`` from the repository root;
the tests marked ``chip`` need the card and skip without one.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest

from benchmark import check
from benchmark.harness import (
    BENCH,
    FORBIDDEN,
    ROOT,
    Env,
    count_modules,
    find_cell,
    load_module,
    metrics_for,
    program_config,
    run_cell,
)
from benchmark.roofline import bound_s
from benchmark.tests.conftest import tiny_copy, tiny_statics, write_json

SEED = 2 ** 31 + 11
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_result_line_of_a_stub_run(tmp_path):
    bench, root = tiny_copy(tmp_path)
    result, lines = run_cell("tiny.cell", SEED, 0.01, False,
                             time.perf_counter(), bench=bench, root=root,
                             need_cuda=False)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert result["correct"] is True
    assert result["attempted"] == 4 and result["failed"] == 0
    e2e = metrics_for(json.load(open(os.path.join(root, "BENCHMARK.json"))),
                      "tiny.cell", False)
    assert set(result["metrics"]) <= {m["name"] for m in e2e}
    assert {"pairs_per_s", "recall", "setup_s"} <= set(result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert lines == [f"check {name}: {j['value']} (limit {j['limit']})"
                     for name, j in result["check"].items()]
    json.dumps(result)


def test_traced_stub_run_reports_per_layer_metrics(tmp_path):
    bench, root = tiny_copy(tmp_path, entry="online")
    result, _lines = run_cell("tiny.cell", SEED, 0.01, True,
                              time.perf_counter(), bench=bench, root=root,
                              need_cuda=False)
    per_layer = {m["name"] for m in metrics_for(
        json.load(open(os.path.join(root, "BENCHMARK.json"))), "tiny.cell",
        True)}
    assert set(result["metrics"]) <= per_layer
    # the program's own spans reach the line; device metrics need the card
    assert {"stage_ms.desc", "stage_ms.pose"} <= set(result["metrics"])
    assert "step_mfu" not in result["metrics"]


def test_new_config_traffic_metric_and_count_by_file_name(tmp_path):
    """A stub of each, added as new files and BENCHMARK.json entries on a
    copy, is found and run without an edit to any file there."""
    bench, root = tiny_copy(tmp_path)
    cfg = json.load(open(os.path.join(bench, "configs", "tiny_moments.json")))
    write_json(os.path.join(bench, "configs", "stub_config.json"),
               dict(cfg, name="stub_config"))
    traffic = json.load(open(os.path.join(bench, "traffic", "tiny.json")))
    traffic["params"] = dict(traffic["params"], count=2)
    traffic["entry_params"] = dict(traffic["entry_params"],
                                   pairs_per_call=2)
    write_json(os.path.join(bench, "traffic", "stub_mix.json"),
               dict(traffic, name="stub_mix"))
    with open(os.path.join(bench, "metrics", "stub_metric.py"), "w") as f:
        f.write("def read(run):\n    return 42.0 + len(run.records)\n")
    with open(os.path.join(bench, "counts", "stub_kernel.py"), "w") as f:
        f.write("KERNEL = r'stub_kernel'\n\n\ndef launches(statics, passes):"
                "\n    return [(1.0, 1.0, 1.0) for _ in passes]\n")
    write_json(os.path.join(bench, "checks", "stub.cell.json"),
               json.load(open(os.path.join(bench, "checks",
                                           "tiny.cell.json"))))
    path = os.path.join(root, "BENCHMARK.json")
    s = json.load(open(path))
    s["configs"].append({"name": "stub_config", "source": "stub",
                         "file": "benchmark/configs/stub_config.json",
                         "reduced": [], "why": "stub"})
    s["workloads"].append({"name": "stub.cell", "config": "stub_config",
                           "traffic": "stub_mix", "chips": 1, "why": "stub"})
    s["end_to_end"].append({"name": "stub_metric", "unit": "x",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["stub.cell"]})
    write_json(path, s)
    result, _ = run_cell("stub.cell", SEED, 0.01, False, time.perf_counter(),
                         bench=bench, root=root, need_cuda=False)
    assert result["metrics"]["stub_metric"]["value"] == 44.0
    assert result["attempted"] == 2
    assert "stub_kernel" in count_modules(bench)
    assert result["correct"] is True
    # the configuration names a reference of its own, which serves every
    # pair's mutual matches doubled: the check holds the run against it
    with open(os.path.join(bench, "reference", "stub_ref.py"), "w") as f:
        f.write(STUB_REFERENCE)
    write_json(os.path.join(bench, "configs", "stub_config.json"),
               dict(cfg, name="stub_config", reference="stub_ref"))
    result, _ = run_cell("stub.cell", SEED, 0.01, False, time.perf_counter(),
                         bench=bench, root=root, need_cuda=False)
    assert result["correct"] is False
    assert result["check"]["mutual_gap.median"]["value"] > 0.025


STUB_REFERENCE = """\
from benchmark.reference import registration as _base
from benchmark.reference.registration import (  # noqa: F401
    Cloud, Draws, Result, Statics, build_models, prepare_cloud)


def _doubled(res):
    return res._replace(num_mutual=res.num_mutual * 2)


def register_batch(*args, **kwargs):
    return _doubled(_base.register_batch(*args, **kwargs))


def register_batches(*args, **kwargs):
    return [_doubled(r) for r in _base.register_batches(*args, **kwargs)]
"""


def _boom_generator(bench: str) -> None:
    """The tiny traffic's generator replaced by one that raises: a run that
    reaches its pool fails with "pool made"."""
    with open(os.path.join(bench, "generators", "boom.py"), "w") as f:
        f.write("def pairs(seed, params):\n"
                "    raise RuntimeError('pool made')\n")
    path = os.path.join(bench, "traffic", "tiny.json")
    write_json(path, dict(json.load(open(path)), generator="boom"))


@pytest.mark.parametrize("case", ["missing", "refused"])
def test_a_reference_that_cannot_check_the_configuration_stops_set_up(
        tmp_path, case):
    """A configuration that names a missing reference, or whose reference
    refuses its statics, fails at set-up with the reference's message and
    its path, before the pool and the window."""
    bench, root = tiny_copy(tmp_path)
    _boom_generator(bench)
    path = os.path.join(bench, "configs", "tiny_moments.json")
    cfg = json.load(open(path))
    if case == "missing":
        cfg["reference"] = "no_such_ref"
        want = (FileNotFoundError, re.escape(os.path.join(
            bench, "reference", "no_such_ref.py")))
    else:
        # the program's GNC-TLS solver, which ``registration`` refuses
        cfg["overrides"] = dict(cfg["overrides"],
                                match={"pose_estimator": "gnc"})
        cfg["statics"] = tiny_statics(cfg["preset"], cfg["overrides"])
        want = (ValueError, re.escape(os.path.join(
            bench, "reference", "registration.py")) +
            ".*the reference runs the RANSAC solver")
    write_json(path, cfg)
    with pytest.raises(want[0], match=want[1]):
        run_cell("tiny.cell", SEED, 0.01, False, time.perf_counter(),
                 bench=bench, root=root, need_cuda=False)


def test_reference_by_name_equals_the_package_import(tmp_path, monkeypatch):
    """The tiny cell's reference records, loaded by the configuration's
    name from the copy, equal field for field those of
    ``benchmark.reference.registration`` imported as a package."""
    import numpy as np
    import torch

    from benchmark.reference import registration as package

    from bufferx_tpu_torch.pipeline import registration as reg
    from bufferx_tpu_torch.tools.weights import load_snapshot

    bench, root = tiny_copy(tmp_path)
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    _w, config, traffic = find_cell(spec, "tiny.cell", bench)
    assert "reference" not in config
    cfg = program_config(config)
    cpu = torch.device("cpu")
    models = reg.build_models(reg.PipelineStatics.from_config(cfg),
                              load_snapshot(os.path.join(
                                  root, config["snapshot"])), cpu)
    pool = load_module("generators", traffic["generator"], bench).pairs(
        SEED, traffic["params"])
    env = Env(reg, cfg, models, config["statics"], traffic, pool, SEED,
              cpu, False)
    entry = load_module("entries", traffic["entry"], bench).Entry(env)
    groups = entry.check_groups(entry.call())
    mod, _statics = check.load_reference(config, bench)
    assert mod.__file__ == os.path.join(bench, "reference",
                                        "registration.py")
    by_name = check.reference_records(root, bench, config, pool, groups, cpu)
    monkeypatch.setattr(check, "load_reference", lambda config, bench: (
        package, package.Statics.from_dict(config["statics"])))
    by_package = check.reference_records(root, bench, config, pool, groups,
                                         cpu)
    assert len(by_name) == len(by_package) == 4
    for a, b in zip(by_name, by_package):
        assert list(a) == list(b)
        np.testing.assert_array_equal(a.pop("pose"), b.pop("pose"))
        assert a == b


def test_benchmark_json_keeps_to_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"][:2] == ["python3", "benchmark/run.py"]
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    assert 2 + 14 * 24 * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        reference = cfg.get("reference", check.DEFAULT_REFERENCE)
        assert NAME.match(reference)
        assert os.path.isfile(os.path.join(BENCH, "reference",
                                           reference + ".py"))
        names.add(c["name"])
    cells = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(BENCH, "checks",
                                           w["name"] + ".json"))
        cells.add(w["name"])
    used = {w["config"] for w in s["workloads"]}
    assert used == names
    metric_names = set()
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.add(m["name"])
    assert "setup_s" in metric_names
    e2e = {m["name"]: m for m in s["end_to_end"]}
    layers = {}
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
            assert "workloads" not in e2e[m["moves"]] or \
                w in e2e[m["moves"]]["workloads"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        metric_names.add(m["name"])
    assert all(len(v) == 1 for v in layers.values())
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for n in names | cells:
        assert NAME.match(n)
    for cell in cells:
        assert "setup_s" in {m["name"] for m in metrics_for(s, cell, False)}
        assert len(metrics_for(s, cell, False)) >= 2
        assert metrics_for(s, cell, True)
    assert len(json.dumps(s)) <= 64 * 1024


@pytest.mark.parametrize("kernel, args, bound_ms", [
    # the kernel table's tabulated bounds (chip_smoke.py's arithmetic)
    ("fps", (2, 30208, 2000), 0.0162),
    ("strat", (2, 1500, 30208, 512, 3), 0.1268),
    ("strat", (16, 1500, 30208, 512, 3), 1.0141),
    ("moments", (3000, 512, 420, 20), 0.0210),
    ("cell_query", (3000, 512, 420, 20, 10), 0.0511),
    ("conv_stack", (3000,), 0.3601),
])
def test_counts_equal_the_tabulated_bounds(kernel, args, bound_ms):
    mod = count_modules()[kernel]
    assert round(bound_s(*mod.launch(*args)) * 1e3, 4) == bound_ms


def _loaded_tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    mods = ["benchmark.harness", "benchmark.check", "benchmark.control",
            "benchmark.modelflops", "benchmark.trace"]
    code = "\n".join(f"import {m}" for m in mods) + (
        "\nfrom benchmark.harness import load_module, BENCH\nimport os\n"
        "for kind in ('entries', 'metrics', 'counts', 'generators'):\n"
        "    for f in sorted(os.listdir(os.path.join(BENCH, kind))):\n"
        "        if f.endswith('.py') and not f.startswith('_'):\n"
        "            load_module(kind, f[:-3])\n"
        "import bufferx_tpu_torch.pipeline.registration\n"
        "import bufferx_tpu_torch.tools.weights\n"
        "import bufferx_tpu_torch.cuda_build\n")
    tops = _loaded_tops(code)
    assert not tops & set(FORBIDDEN)
    assert "bufferx_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    """Every module file under ``benchmark/reference/``, imported as a
    package module, every configuration's reference loaded by name, and
    the check, load neither JAX nor the program."""
    folder = os.path.join(BENCH, "reference")
    mods = sorted(
        "benchmark." + os.path.relpath(os.path.join(d, f[:-3]), BENCH)
        .replace(os.sep, ".").removesuffix(".__init__")
        for d, _dirs, files in os.walk(folder) for f in files
        if f.endswith(".py"))
    assert "benchmark.reference.registration" in mods
    configs = [c["file"] for c in spec()["configs"]]
    tops = _loaded_tops(
        "".join(f"import {m}\n" for m in mods)
        + "import json\nfrom benchmark import check\n"
        + "".join(f"check.load_reference(json.load(open({f!r})))\n"
                  for f in configs))
    assert not tops & (set(FORBIDDEN) | {"bufferx_tpu_torch"})
