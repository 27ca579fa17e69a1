"""chip_smoke.py, the on-card check of the PyTorch/CUDA port, as far as a
machine without a GPU can exercise it: it imports cleanly, refuses to run
without CUDA or outside a checkout, builds the flagship with the port,
and neither it nor the port imports jax or the JAX package."""

import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tools")]))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_imports_and_defines_main():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main) and mod.CHUNK == 64


def test_exits_nonzero_without_cuda():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_builds_flagship_without_jax():
    """The port and chip_smoke run with jax and the JAX package made
    unimportable; the flagship they build has the reference's shape."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        "import chip_smoke\n"
        "from mpmcxx_tpu_torch.mc import chain\n"
        "from mpmcxx_tpu_torch.ops import energy, kernels, polar_cache\n"
        "state, meta, flags, params, opts = chip_smoke.build_flagship('cpu')\n"
        "chain.require_options(flags, params, opts)\n"
        "print(state.n_atom_slots, int(state.aalive.sum()),\n"
        "      state.n_mol_slots)\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["11264", "10112", "3585"]


def test_kernel_build_needs_nvcc(monkeypatch):
    from mpmcxx_tpu_torch.ops import kernels
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: the build would run")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
