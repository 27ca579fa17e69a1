"""chip_smoke.py, the on-card check of the PyTorch/CUDA port, and the
port's command line, as far as a machine without a GPU can exercise them:
chip_smoke imports cleanly, refuses to run without CUDA or outside a
checkout, and builds the flagship with the port; the CLI refuses to run
without CUDA unless given ``--device cpu``, and then runs an input to its
end, the Gibbs and PI examples included; neither imports jax or the JAX
package."""

import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import torch_co2_system as co2  # noqa: E402

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


@pytest.mark.parametrize("model,shape", [
    ("co2", ["11264", "10112", "3585", "3"]),
    ("h2", ["10752", "10512", "2049", "5"]),
    ("ar", ["10752", "10240", "10241", "1"])])
def test_builds_flagship_without_jax(model, shape):
    """The port and chip_smoke run with jax and the JAX package made
    unimportable; each flagship they build (CO2, H2, monatomic) has the
    shape of tools/flagship.py's JAX-side build function: atom slots, live
    atoms, molecule slots and the move window S."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        "import chip_smoke\n"
        "from mpmcxx_tpu_torch.mc import chain\n"
        "from mpmcxx_tpu_torch.ops import energy, kernels, polar_cache\n"
        f"state, meta, flags, params, opts = chip_smoke.build_flagship("
        f"{model!r}, 'cpu')\n"
        "chain.require_options(flags, params, opts)\n"
        "print(state.n_atom_slots, int(state.aalive.sum()),\n"
        "      state.n_mol_slots, opts.max_mol_atoms)\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == shape


CLI_RUN_IN = """job_name tiny
ensemble uvt
temperature 150.0
pressure 20.0
insert_probability 0.3
move_factor 0.1
numsteps 4
corrtime 2
seed 0
polarization on
polar_iterative on
polar_ewald on
polar_mixed on
polar_max_iter 4
polar_damp_type exponential
polar_damp 2.1304
cavity_bias on
cavity_grid 4
cavity_radius 2.6
pqr_input co2.pqr
basis1 28 0 0
basis2 0 28 0
basis3 0 0 28
"""


def _cli_input(tmp_path):
    """A run.in and a CO2 PQR of 8 framework atoms and 171 CO2 (1,034 atom
    slots after the runner's uVT headroom: the blocked path)."""
    co2.write_pqr(str(tmp_path / "co2.pqr"), co2.records(5, 28.0, 171, 6))
    (tmp_path / "run.in").write_text(CLI_RUN_IN)


def test_cli_without_device_exits_nonzero_without_cuda(tmp_path):
    _cli_input(tmp_path)
    r = _run(["-m", "mpmcxx_tpu_torch.cli", "run.in"], tmp_path)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "Simulation complete" not in r.stdout
    assert not (tmp_path / "tiny.energy.dat").exists()


def test_cli_runs_on_cpu_without_jax(tmp_path):
    """``--device cpu`` runs the cavity-biased uVT input to its end with
    jax and the JAX package made unimportable."""
    _cli_input(tmp_path)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        "from mpmcxx_tpu_torch import cli\n"
        "sys.exit(cli.main(['--device', 'cpu', 'run.in']))\n")
    r = _run(["-c", code], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "SIM_CONTROL: cavity-biased umbrella sampling activated" in \
        r.stdout
    assert r.stdout.splitlines()[-1] == "SIM_CONTROL: Simulation complete!"
    rows = [ln.split() for ln in
            (tmp_path / "tiny.energy.dat").read_text().splitlines()[1:]]
    assert [float(r[0]) for r in rows] == [0.0, 2.0, 4.0]
    for name in ("tiny.restart.pqr", "tiny.final.pqr", "tiny.dipole.dat"):
        assert (tmp_path / name).stat().st_size > 0, name


@pytest.mark.parametrize("name,args,outputs", [
    ("gibbs-argon", [], ["ar_gibbs.energy-0000.dat",
                         "ar_gibbs.energy-0001.dat",
                         "ar_gibbs.final-0000.pqr",
                         "ar_gibbs.final-0001.pqr"]),
    ("pi-argon-dimer", ["-P", "4", "-xyz", "frames.xyz"],
     ["ar2k.energy.dat", "frames.xyz"] +
     [f"ar2k.{kind}-000{s}.pqr" for kind in ("restart", "final")
      for s in range(4)])])
def test_dispatched_example_runs_on_cpu_without_jax(name, args, outputs,
                                                    tmp_path):
    """``--device cpu`` runs the Gibbs and PI examples (4 steps) through
    the CLI's dispatch with jax and the JAX package made unimportable,
    and writes the per-box or per-bead files."""
    d = tmp_path / name
    shutil.copytree(os.path.join(ROOT, "examples", name), d)
    run_in = (d / "run.in").read_text()
    for key, value in (("numsteps", 4), ("corrtime", 2)):
        run_in = "\n".join(f"{key} {value}" if ln.startswith(key + " ")
                           else ln for ln in run_in.splitlines())
    (d / "run.in").write_text(run_in + "\n")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        "from mpmcxx_tpu_torch import cli\n"
        f"sys.exit(cli.main(['--device', 'cpu'] + {args!r} + ['run.in']))\n")
    r = _run(["-c", code], d)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "SIM_CONTROL: Simulation complete!"
    for out in outputs:
        assert (d / out).stat().st_size > 0, out


def test_kernel_build_needs_nvcc(monkeypatch):
    from mpmcxx_tpu_torch.ops import kernels
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: the build would run")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
