"""Import a reference BUFFER-X checkpoint into the port's snapshot format.

    python3 -m bufferx_tpu_torch.tools.import_reference_checkpoint \
        --src snapshot_ref/threedmatch --out snapshot/threedmatch

``--src`` must hold the reference layout ``{Desc,Pose}/best.pth`` (what the
reference's ``scripts/download_pretrained_models.py`` fetches); the output is
the staged snapshot ``{Desc,Pose}/best.msgpack`` that
:func:`bufferx_tpu_torch.tools.weights.load_snapshot`, ``tools/evaluate.py``
and every other entry point of both packages read. The port's counterpart
of ``scripts/import_reference_checkpoint.py``, with the same flags.

Reference weights encode the SAMPLED descriptor mode (the reference's
point-MLP SPT semantics); the importer refuses the moments mode. Every
tensor is shape-checked against the port's own models for ``--dataset``'s
configuration. The import runs on the host; ``--cpu`` is accepted for the
JAX script's flags and changes nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.pipeline.registration import init_params
from bufferx_tpu_torch.tools.torch_import import import_reference_snapshot
from bufferx_tpu_torch.tools.weights import (
    DESC_MODULES,
    POSE_MODULES,
    numpy_from_params,
)

__all__ = ["template_for", "main"]


def template_for(cfg) -> dict:
    """{"desc": tree, "pose": tree}: the flax trees of ``cfg``'s models, the
    shapes an import must match."""
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    return {"desc": numpy_from_params(sd["desc"], DESC_MODULES),
            "pose": numpy_from_params(sd["pose"], POSE_MODULES)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True,
                    help="reference snapshot dir holding {Desc,Pose}/best.pth")
    ap.add_argument("--out", required=True,
                    help="output snapshot dir for {Desc,Pose}/best.msgpack")
    ap.add_argument("--dataset", default="3DMatch",
                    help="config preset used to shape-check the import")
    ap.add_argument("--cpu", action="store_true",
                    help="accepted for the JAX script's flags; the import "
                         "runs on the host either way")
    args = ap.parse_args(argv)

    cfg = make_cfg(args.dataset)
    if cfg.patch.desc_mode != "sampled":
        print("reference weights require desc_mode='sampled'", file=sys.stderr)
        return 1
    template = template_for(cfg)
    import_reference_snapshot(args.src, args.out, template)
    n = sum(leaf.size for tree in template.values()
            for leaf in _leaves(tree))
    print(f"imported {args.src} -> {args.out} "
          f"({n:,} params shape-checked against {args.dataset})")
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
