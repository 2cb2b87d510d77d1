"""Evaluation sweeps over every benchmark target.

The port's counterpart of ``scripts/eval_all.sh`` (the 11-target
generalization sweep, the reference's ``scripts/eval_all.sh:22-34``) and,
with ``--hetero``, of ``scripts/eval_all_hetero.sh`` (the 6 heterogeneous-
sensor directions, the reference's ``scripts/eval_all_hetero.sh:22-29``),
over the port's ``tools/evaluate.py``:

    python3 -m bufferx_tpu_torch.tools.eval_all [--hetero] [DATASETS_ROOT] \\
        [tools/evaluate.py flags ...]

``DATASETS_ROOT`` (default ``../datasets``) holds one directory a target
(``TARGETS``); every flag after it goes to each ``tools/evaluate.py`` run
(``--checkpoint-dir``, ``--cpu``, ``--max-pairs``, ...). As in the shell
scripts, a target whose run fails prints ``[skip] <target> failed`` (its
error goes to stderr) and the sweep goes on. A run that finds no pairs
fails too: some loaders warn and yield nothing for a missing root, and an
evaluation of no pairs is no result. The last line counts the targets that
ran and those skipped, and the exit code is 0.
"""

from __future__ import annotations

import os
import sys
import traceback

from bufferx_tpu_torch.tools import evaluate

__all__ = ["TARGETS", "HETERO", "sweep", "main"]

# target -> its directory under the datasets root (scripts/eval_all.sh)
TARGETS = {
    "3DMatch": "ThreeDMatch", "3DLoMatch": "ThreeDMatch",
    "Scannetpp_iphone": "scannetpp_iphone",
    "Scannetpp_faro": "scannetpp_faro", "TIERS": "tiers_indoor",
    "KITTI": "kitti", "WOD": "WOD", "MIT": "kimera-multi",
    "KAIST": "helipr_kaist05", "ETH": "ETH", "Oxford": "newer-college",
}
# (dataset, directory, source sensor, target sensor)
# (scripts/eval_all_hetero.sh)
HETERO = (
    ("KAIST_hetero", "helipr_kaist05", "Aeva", "Avia"),
    ("KAIST_hetero", "helipr_kaist05", "Avia", "Ouster"),
    ("KAIST_hetero", "helipr_kaist05", "Ouster", "Aeva"),
    ("TIERS_hetero", "tiers_indoor", "os0_128", "os1_64"),
    ("TIERS_hetero", "tiers_indoor", "os1_64", "vel16"),
    ("TIERS_hetero", "tiers_indoor", "vel16", "os0_128"),
)


def _runs(root: str, hetero: bool):
    """(label, header, tools/evaluate.py arguments) of every target."""
    if hetero:
        for ds, d, src, tgt in HETERO:
            yield (f"{ds}:{d}:{src}:{tgt}", f"{ds} {src}->{tgt}",
                   ["--dataset", ds, "--root", os.path.join(root, d),
                    "--hetero", f"{src}:{tgt}"])
    else:
        for ds, d in TARGETS.items():
            yield ds, ds, ["--dataset", ds, "--root", os.path.join(root, d)]


def sweep(root: str, extra=(), hetero: bool = False, log=print) -> dict:
    """Run every target's evaluation; returns {"ran": {label: summary},
    "skipped": [label, ...]}."""
    ran, skipped = {}, []
    for label, header, argv in _runs(root, hetero):
        print(f"=== {header} ===", flush=True)
        try:
            summary = evaluate.run(argv + list(extra), log=log)
            if not summary["num_pairs"]:
                raise RuntimeError(f"{label}: no pairs under the root")
            ran[label] = summary
        except (Exception, SystemExit):
            traceback.print_exc(file=sys.stderr)
            print(f"[skip] {label} failed", flush=True)
            skipped.append(label)
    print(f"eval_all: {len(ran)} ran, {len(skipped)} skipped", flush=True)
    return {"ran": ran, "skipped": skipped}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    hetero = bool(argv) and argv[0] == "--hetero"
    if hetero:
        argv = argv[1:]
    root = "../datasets"
    if argv and not argv[0].startswith("-"):
        root, argv = argv[0], argv[1:]
    sweep(root, argv, hetero)
    return 0


if __name__ == "__main__":
    sys.exit(main())
