"""Nothing the benchmark runs loads JAX or the JAX package: the run's own
check compares whole top-level module names, and no file under the
benchmark imports them; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.manifest import ROOT

HERE = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("names,found", [
    (["mpmcxx_tpu_torch", "mpmcxx_tpu_torch.ops.polar", "torch"], []),
    (["mpmcxx_tpu", "mpmcxx_tpu_torch"], ["mpmcxx_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxy", "mpmcxx_tpu_x"], [])])
def test_forbidden_modules_compares_whole_names(monkeypatch, names, found):
    fake = {n: object() for n in names}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == found


def test_no_file_imports_jax_or_the_jax_package():
    for path in _files():
        if os.sep + "tests" + os.sep in path:
            continue
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        mods = set(_imports(path))
        assert mods <= {"__future__", "numpy", "torch"}, (path, mods)


def test_a_run_loads_no_jax():
    """Importing the harness and the whole path a run takes into the
    program leaves no forbidden module loaded."""
    code = ("import sys; sys.path[0] = %r\n"
            "from benchmark import harness\n"
            "from mpmcxx_tpu_torch import cli\n"
            "from mpmcxx_tpu_torch.mc import chain, averages, pi\n"
            "from benchmark.ensembles import pi_nvt\n"
            "from mpmcxx_tpu_torch.config import parser\n"
            "print(harness.forbidden_modules())\n" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
