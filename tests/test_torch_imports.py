"""The port stands alone: no module of ``bufferx_tpu_torch/`` nor
``chip_smoke.py`` imports JAX, flax or the JAX package (nor, inside the
package, the benchmark), importing the whole port loads none of them, and
the commands the documents give exist."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "bufferx_tpu"}
# the benchmark reads the package, never the other way round; chip_smoke.py,
# outside the package, takes its bounds from the benchmark's counts
ABOVE_THE_PACKAGE = {"benchmark"}


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(os.path.join(ROOT, "bufferx_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    forbidden = FORBIDDEN
    if os.path.relpath(path, ROOT).startswith("bufferx_tpu_torch"):
        forbidden = FORBIDDEN | ABOVE_THE_PACKAGE
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
            assert name.split(".")[0] not in forbidden, (
                f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {name}")


@pytest.mark.parametrize("doc", ["README.md",
                                 ".claude/skills/verify/SKILL.md"])
def test_documented_commands_exist(doc):
    """Every ``python -m bufferx_tpu_torch.<module>`` and every
    ``python <path>.py`` that the document gives names a module or a file
    of the repo (the files only: nothing is imported)."""
    with open(os.path.join(ROOT, doc)) as f:
        text = f.read()
    modules = re.findall(r"\bpython3?\s+-m\s+(bufferx_tpu_torch[\w.]*\w)",
                         text)
    scripts = re.findall(r"\bpython3?\s+([\w./-]+\.py)\b", text)
    assert modules and scripts, doc
    missing = []
    for mod in modules:
        rel = os.path.join(ROOT, *mod.split("."))
        if not (os.path.exists(rel + ".py") or os.path.isdir(rel)):
            missing.append(f"-m {mod}")
    missing += [p for p in scripts
                if not os.path.exists(os.path.join(ROOT, p))]
    assert not missing, f"{doc} names commands that do not exist: {missing}"


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
    """``cuda_build.build_all`` imports every kernel module: seven CUDA
    kernels, each with its source in ``csrc/``; the five ports name the
    Pallas kernel they replace at a ``def`` line of the JAX package, the
    conv layers' serving epilogue and the hypothesis scoring replace
    none."""
    from bufferx_tpu_torch import cuda_build
    from bufferx_tpu_torch.geometry import spt_pallas  # noqa: F401
    from bufferx_tpu_torch.kernels import (  # noqa: F401
        conv_epilogue,
        conv_pallas,
        fps,
        hyp_score,
        strat_pallas,
    )

    assert sorted(cuda_build.KERNELS) == ["cell_query", "conv_epilogue",
                                          "conv_stack", "fps", "hyp_score",
                                          "moments", "strat"]
    with open(os.path.join(ROOT, "bufferx_tpu_torch", "cuda_build.py")) as f:
        build_src = f.read()
    for name in ("conv_epilogue", "conv_pallas", "fps", "hyp_score",
                 "strat_pallas", "spt_pallas"):
        assert name in build_src
    for k in cuda_build.KERNELS.values():
        assert os.path.exists(k.source_path), k.source_path
        if k.name in ("conv_epilogue", "hyp_score"):
            assert k.replaces is None
            continue
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


def test_every_jax_module_has_a_counterpart():
    """Each module of the JAX package has one of the same path in the port
    (the JAX ``config`` package is the port's ``config.py``)."""
    jax_root = os.path.join(ROOT, "bufferx_tpu")
    missing = []
    for d, _dirs, files in os.walk(jax_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), jax_root)
            if rel == os.path.join("config", "__init__.py"):
                rel = "config.py"
            if not os.path.exists(os.path.join(ROOT, "bufferx_tpu_torch",
                                               rel)):
                missing.append(rel)
    assert not missing, missing


@pytest.mark.parametrize("module", [
    "bufferx_tpu_torch.utils.vis", "bufferx_tpu_torch.tools.tsdf",
    "bufferx_tpu_torch.tools.scannetpp", "bufferx_tpu_torch.tools.pairgen",
    "bufferx_tpu_torch.tools.torch_import",
    "bufferx_tpu_torch.tools.import_reference_checkpoint",
    "bufferx_tpu_torch.native", "bufferx_tpu_torch.tools.bench_scaling",
    "bufferx_tpu_torch.tools.eval_all",
])
def test_offline_tools_import_alone(module):
    """Each offline tool imports in a fresh interpreter without loading JAX,
    flax or the JAX package."""
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)


# Public names of the JAX package that the port does not define under the
# same name in the counterpart module, each with the reason (ROADMAP.md,
# Queue 1): XLA dispatch forms, Pallas entry points whose kernels the port
# launches through its own wrappers, and names that live elsewhere.
NAME_EXCEPTIONS = {
    "register_pair_jit": "an XLA dispatch form: register_pair and "
                         "register_batch are the port's entries",
    "register_batch_split": "two XLA programs for one batch: there is no "
                            "program boundary in eager PyTorch",
    "farthest_point_sampling": "the Pallas entry of K1: the port's is fps "
                               "(farthest_point_sampling_plain on the CPU)",
    "farthest_point_sampling_pallas": "the Pallas entry of K1: "
                                      "farthest_point_sampling_cuda",
    "spt_moments_pallas": "the Pallas entry of K3: spt_moments_cuda",
    "spt_cell_query_pallas": "the Pallas entry of K4: spt_cell_query_cuda",
    "cyl_conv_stack_fused": "the Pallas entry of K5: cyl_conv_stack_cuda",
    "cyl_conv_stack_reference": "K5's pure-jax mirror: "
                                "cyl_conv_stack_plain",
    "moments_to_features": "the port keeps the product form, "
                           "moments_to_features_mm",
    "sqdist_compensated": "a bf16 hi/lo split for the TPU's matrix unit: "
                          "the port's sqdist is float32 with TF32 off",
    "NUM_MOMENTS": "defined in the port's geometry/spt_pallas.py",
    "point_moment_features": "defined in the port's geometry/spt_pallas.py",
    "load_snapshot_config": "defined in the port's tools/weights.py",
    "save_snapshot_config": "defined in the port's tools/weights.py",
}


def _top_level(path: str):
    """(names a module defines at top level: def, class, assignment;
    names it imports at top level)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    defined, imported = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            defined |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {(a.asname or a.name).split(".")[0]
                         for a in node.names}
    return defined, imported


def _module_pairs():
    """(relative path, JAX module, port counterpart) for every module of the
    JAX package."""
    jax_root = os.path.join(ROOT, "bufferx_tpu")
    for d, _dirs, files in sorted(os.walk(jax_root)):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), jax_root)
                port = "config.py" if rel == os.path.join(
                    "config", "__init__.py") else rel
                yield rel, os.path.join(d, f), os.path.join(
                    ROOT, "bufferx_tpu_torch", port)


def _public_jax_names(path: str) -> set:
    """A JAX module's public names: its top-level public defs, classes and
    assignments, and in an ``__init__.py`` every name it imports."""
    defined, imported = _top_level(path)
    names = {n for n in defined if not n.startswith("_")}
    if os.path.basename(path) == "__init__.py":
        names |= imported
    return names


def test_every_jax_public_name_has_a_counterpart():
    """Each public name of each JAX module is defined or imported in the
    port's counterpart module, but for ``NAME_EXCEPTIONS``; each exception
    is a public JAX name that its counterpart module still does not define
    (an ``__init__.py`` not export), so the list cannot go stale."""
    missing, stale, seen = [], [], set()
    for rel, jax_path, port_path in _module_pairs():
        want = _public_jax_names(jax_path)
        defined, imported = _top_level(port_path)
        missing += [f"{rel}: {n}" for n in sorted(
            want - defined - imported - set(NAME_EXCEPTIONS))]
        exists = defined | (imported if rel.endswith("__init__.py")
                            else set())
        for name in sorted(want & set(NAME_EXCEPTIONS)):
            seen.add(name)
            if name in exists:
                stale.append(f"{rel}: {name}")
    assert not missing, missing
    assert not stale, f"exceptions that the port now has: {stale}"
    assert seen == set(NAME_EXCEPTIONS), sorted(set(NAME_EXCEPTIONS) - seen)


SUBPACKAGES = ["kernels", "pipeline", "geometry", "solver", "train", "models",
               "data", "core"]


@pytest.mark.parametrize("package", SUBPACKAGES)
def test_subpackage_reexports(package):
    """A fresh interpreter imports the subpackage and every name its
    ``__init__.py`` re-exports: no JAX, flax or JAX package loaded, no
    kernel built or launched."""
    from bufferx_tpu_torch import cuda_build
    from bufferx_tpu_torch.geometry import spt_pallas  # noqa: F401
    from bufferx_tpu_torch.kernels import (  # noqa: F401
        conv_pallas,
        fps,
        strat_pallas,
    )

    init = os.path.join(ROOT, "bufferx_tpu_torch", package, "__init__.py")
    _defined, names = _top_level(init)
    assert names, f"{package}/__init__.py re-exports nothing"
    absent = [k.lib_path() for k in cuda_build.KERNELS.values()
              if not os.path.exists(k.lib_path())]
    # a name that is also a submodule's must stay the module: a function
    # of that name would hide the module from ``from package import name``
    code = (f"import os, sys, types\n"
            f"import bufferx_tpu_torch.{package} as pkg\n"
            f"from bufferx_tpu_torch import cuda_build\n"
            f"here = os.path.dirname(pkg.__file__)\n"
            f"for name in {sorted(names)!r}:\n"
            f"    assert getattr(pkg, name) is not None, name\n"
            f"    if os.path.exists(os.path.join(here, name + '.py')):\n"
            f"        assert isinstance(getattr(pkg, name), types.ModuleType), "
            f"name\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\n"
            "assert not bad, bad\n"
            "for k in cuda_build.KERNELS.values():\n"
            "    assert k.launches == 0 and k._lib is None, k.name\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert [p for p in absent if os.path.exists(p)] == []
