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
