"""The readings that a cell's check limits are set from, on the card.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        [--calls 2] [--control]

For each seed, in one process: the cell's pool and draws, ``--calls``
entry calls of the program as the window makes them (not timed), the
pairs the run's check would take, and the reference on them; prints the
check's numbers of the program against the reference (``"side":
"program"``). With ``--control`` also the reference computed with TF32 on,
put in the program's place, against the reference (``"side": "control"``).
One JSON line a seed and side on standard output.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import check  # noqa: E402
from benchmark.entries.common import Record  # noqa: E402
from benchmark.harness import (  # noqa: E402
    BENCH,
    Env,
    find_cell,
    load_json,
    load_module,
    log,
    program_config,
)


def as_records(groups, refs) -> list:
    """The reference's results as the records of the groups' pairs."""
    served = [r for g in groups for r in g[3]]
    return [Record(pair=s.pair, call=s.call, batch=s.batch, slot=s.slot,
                   **r) for s, r in zip(served, refs)]


def main(argv=None, bench: str = BENCH, root: str = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cpu: rehearse on the plain kernels")
    args = ap.parse_args(argv)

    import torch

    from bufferx_tpu_torch import cuda_build
    from bufferx_tpu_torch.pipeline import registration as reg
    from bufferx_tpu_torch.tools.weights import load_snapshot

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    _w, config, traffic = find_cell(spec, args.workload, bench)
    rules = load_json(os.path.join(bench, "checks", args.workload + ".json"))
    cfg = program_config(config)
    check.load_reference(config, bench)
    if dev.type == "cuda":
        cuda_build.build_all()
    models = reg.build_models(reg.PipelineStatics.from_config(cfg),
                              load_snapshot(os.path.join(root,
                                                         config["snapshot"])),
                              dev)
    gen = load_module("generators", traffic["generator"], bench)
    for seed in args.seeds:
        t = time.perf_counter()
        pool = gen.pairs(seed, traffic["params"])
        env = Env(reg, cfg, models, config["statics"], traffic, pool, seed,
                  dev, False)
        entry = load_module("entries", traffic["entry"], bench).Entry(env)
        records = []
        for _ in range(args.calls):
            records += entry.call()
        groups = entry.check_groups(records)
        refs = check.reference_records(root, bench, config, pool, groups,
                                       dev)
        served = [r for g in groups for r in g[3]]
        sides = [("program", served)]
        if args.control:
            low = check.reference_records(root, bench, config, pool, groups,
                                          dev, tf32=True)
            sides.append(("control", as_records(groups, low)))
        for side, got in sides:
            gaps = [check.pair_gaps(s, r) for s, r in zip(got, refs)]
            print(json.dumps({
                "workload": args.workload, "seed": seed, "side": side,
                "pairs": len(gaps),
                "numbers": check.numbers(gaps, rules),
                "gaps": gaps}), flush=True)
        log(f"seed {seed}: {time.perf_counter() - t:.1f} s")
        del env, entry
    return 0


if __name__ == "__main__":
    sys.exit(main())
