"""The port stands alone: no module of ``bufferx_tpu_torch/`` nor
``chip_smoke.py`` imports JAX, flax or the JAX package, and importing the
whole port loads none of them."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "bufferx_tpu"}


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(os.path.join(ROOT, "bufferx_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {name}")


def test_importing_the_port_loads_no_jax():
    mods = [
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        for p in _port_sources() if "bufferx_tpu_torch" in p
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m.removesuffix('.__init__')}\n" for m in mods)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        + repr(FORBIDDEN) + ")\n"
        + "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=300)


def test_every_kernel_is_registered():
    """``cuda_build.build_all`` imports every kernel module: five CUDA
    kernels, each with its source in ``csrc/`` and the Pallas kernel it
    replaces at a ``def`` line of the JAX package."""
    from bufferx_tpu_torch import cuda_build
    from bufferx_tpu_torch.geometry import spt_pallas  # noqa: F401
    from bufferx_tpu_torch.kernels import (  # noqa: F401
        conv_pallas,
        fps,
        strat_pallas,
    )

    assert sorted(cuda_build.KERNELS) == ["cell_query", "conv_stack", "fps",
                                          "moments", "strat"]
    with open(os.path.join(ROOT, "bufferx_tpu_torch", "cuda_build.py")) as f:
        build_src = f.read()
    for name in ("conv_pallas", "fps", "strat_pallas", "spt_pallas"):
        assert name in build_src
    for k in cuda_build.KERNELS.values():
        assert os.path.exists(k.source_path), k.source_path
        path, line = k.replaces.split(":")
        with open(os.path.join(ROOT, path)) as f:
            assert f.readlines()[int(line) - 1].lstrip().startswith("def _")


def test_dataset_entry_points_stand_alone():
    """The dataset entry points and the modules they read are the port's own
    copies: the loaders, file readers, splits, sphericity, the voxel grid,
    the patch queries and both CLIs, each among the checked sources."""
    want = ["data/io.py", "data/splits.py", "data/base.py",
            "data/datasets.py", "geometry/sphericity.py", "geometry/patches.py",
            "kernels/neighbors.py", "kernels/voxel.py", "tools/evaluate.py",
            "tools/train.py"]
    have = {os.path.relpath(p, os.path.join(ROOT, "bufferx_tpu_torch"))
            for p in _port_sources()}
    for rel in want:
        assert rel in have, rel


def test_multiframe_and_distributed_stand_alone():
    """The multi-frame front end, the distributed layer and their tools are
    among the checked sources (no JAX, flax or JAX package imports), and
    importing them loads none of those."""
    want = ["parallel/__init__.py", "parallel/mesh.py", "parallel/posegraph.py",
            "parallel/bundle.py", "parallel/sharded.py",
            "pipeline/multiframe.py", "tools/exp_multiframe.py",
            "tools/dryrun.py"]
    have = {os.path.relpath(p, os.path.join(ROOT, "bufferx_tpu_torch"))
            for p in _port_sources()}
    for rel in want:
        assert rel in have, rel
    code = ("import sys\n"
            "import bufferx_tpu_torch.parallel\n"
            "import bufferx_tpu_torch.pipeline.multiframe\n"
            "import bufferx_tpu_torch.tools.exp_multiframe\n"
            "import bufferx_tpu_torch.tools.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
