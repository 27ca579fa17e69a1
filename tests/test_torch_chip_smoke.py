"""chip_smoke.py, the on-card check of the PyTorch/CUDA port, and the
port's command line, as far as a machine without a GPU can exercise them:
chip_smoke imports cleanly, refuses to run without CUDA or outside a
checkout, and builds the flagship with the port; the CLI refuses to run
without CUDA unless given ``--device cpu``, and then runs an input to its
end, the Gibbs and PI examples included; neither imports jax or the JAX
package, and chip_smoke reads nothing under tools/ (the children run
with only the repository root on their path)."""

import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import torch_co2_system as co2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=300):
    # one intra-op thread per child: the suite runs several workers at
    # once, and children that each take every core oversubscribe them
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT)
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
    """The port and chip_smoke run with jax, the JAX package and
    tools/flagship.py made unimportable; each flagship the port's
    flagship.build makes for chip_smoke (CO2, H2, monatomic) has the shape
    of tools/flagship.py's JAX-side build function: atom slots, live
    atoms, molecule slots and the move window S."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        "sys.modules['flagship'] = None\n"
        "import chip_smoke\n"
        "from mpmcxx_tpu_torch import flagship\n"
        "from mpmcxx_tpu_torch.mc import chain\n"
        "from mpmcxx_tpu_torch.ops import energy, kernels, polar_cache\n"
        f"state, meta, flags, params, opts = flagship.build("
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


ENERGY_TERM_STEPS = {
    # chip_smoke step -> the code that runs it on the CPU at a small size
    "pairwise": (
        "import torch_co2_system as co2\n"
        "from mpmcxx_tpu_torch import flagship\n"
        "flagship.write_pqr_co2 = lambda p: co2.write_pqr(\n"
        "    p, co2.records(5, 18.0, 12, 3))\n"
        "chip_smoke.PW_MOVES = 4\n"
        "total, rates = chip_smoke.run_pairwise_terms(w, device='cpu')\n"
        "assert set(rates) == set(chip_smoke.PW_SETTINGS)\n"),
    "many_body": (
        "chip_smoke.MB.update(n=27, moves=4)\n"
        "total, ms = chip_smoke.run_many_body(device='cpu')\n"
        "assert set(ms) == {'axilrod_teller', 'polarvdw_exp'}\n"),
}


@pytest.mark.parametrize("step", list(ENERGY_TERM_STEPS))
def test_energy_term_steps_run_on_cpu(step, tmp_path):
    """Steps 16 and 17 (the pairwise terms' Delta-E and chain gates, the
    dense many-body terms) at a small size on the CPU, with jax and the
    JAX package made unimportable and the card's calls stubbed: their
    gates pass and no kernel launches."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import torch\n"
        "for f in ('synchronize', 'reset_peak_memory_stats',\n"
        "          'max_memory_allocated'):\n"
        "    setattr(torch.cuda, f, lambda *a, **k: 0)\n"
        "import chip_smoke\n"
        f"w = {str(tmp_path)!r}\n"
        + ENERGY_TERM_STEPS[step] +
        "assert not any(total.values()), total\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr[-3000:]


POLAR_SOLVER_STUBS = (
    # K5 and K2 count their plain versions' calls, the switch picks K5 for
    # every square plane, and a stand-in profiler reports one
    # contract_sym_kernel per K5 call
    "from torch.autograd import DeviceType\n"
    "from mpmcxx_tpu_torch.ops import cuda_polar, polar\n"
    "def counting(orig):\n"
    "    def f(*a, **k):\n"
    "        f.launches += 1\n"
    "        return orig(*a, **k)\n"
    "    f.launches = 0\n"
    "    return f\n"
    "for name in ('contract_planes_sym', 'write_plane_strips'):\n"
    "    setattr(cuda_polar, name, counting(getattr(cuda_polar, name)))\n"
    "polar.use_sym = lambda shape: shape[0] == shape[1]\n"
    "class Event:\n"
    "    def __init__(self, name):\n"
    "        self.name, self.device_type = name, DeviceType.CUDA\n"
    "        self.time_range = type('T', (), {'elapsed_us':\n"
    "                                         lambda s: 1.0})()\n"
    "class Profile:\n"
    "    def __enter__(self):\n"
    "        self.n = cuda_polar.contract_planes_sym.launches\n"
    "        return self\n"
    "    def __exit__(self, *a):\n"
    "        self.n = cuda_polar.contract_planes_sym.launches - self.n\n"
    "    def events(self):\n"
    "        return [Event('contract_sym_kernel<3>')] * self.n\n"
    "import torch.profiler\n"
    "torch.profiler.profile = lambda **k: Profile()\n"
    "chip_smoke._time_ms = lambda fn, reps=1: (fn(), 0.0)[1]\n"
    "import dataclasses, torch_co2_system as co2\n"
    "state, _, flags, params, opts = co2.torch_system()\n"
    "opts = dataclasses.replace(opts, blocked_energy=False)\n"
    "chip_smoke.SCF_CHUNK = chip_smoke.GROUP_PROBE = 4\n"
    "chip_smoke.CG_MOVES = 4\n")
POLAR_SOLVER_STEPS = {
    "scf_cache": (
        "total, out = chip_smoke.run_scf_solvers(state, flags, params, opts,\n"
        "                                        ROOT, 'cpu')\n"
        "assert out['iterations'][2] == 0 and out['cg_steps'][1] < 400\n"),
    "cache_modes": (
        "total, out = chip_smoke.run_cache_modes(state, flags, params, opts,\n"
        "                                        ROOT, 'cpu')\n"
        "assert [m for _, m, _ in out.values()] == [4, 5, 3]\n"),
    "dense": (
        "chip_smoke.DENSE_MOVES = 2\n"
        "launches, ms, sweep = chip_smoke.run_dense_solvers(\n"
        "    ROOT, w, 'cpu', device='cpu')\n"
        "total = {'dense': launches}\n"),
}


@pytest.mark.parametrize("step", list(POLAR_SOLVER_STEPS))
def test_polar_solver_steps_run_on_cpu(step, tmp_path):
    """Steps 18-20 (precision-terminated SCF, Palmo and CG on the polar
    cache; plane modes 4 and 5 and the no-PBC and Wolf fields; the dense
    solvers and the tensor through the CLI) on the small CO2 system or
    the gcmc-mof-co2 example on the CPU, with jax and the JAX package
    made unimportable and the card's calls stubbed: their gates pass
    (the launch gates against the counted plain calls)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        f"ROOT = {ROOT!r}\n"
        "import torch\n"
        "for f in ('synchronize', 'reset_peak_memory_stats',\n"
        "          'max_memory_allocated', 'empty_cache',\n"
        "          'set_sync_debug_mode'):\n"
        "    setattr(torch.cuda, f, lambda *a, **k: 0)\n"
        "import chip_smoke\n"
        f"w = {str(tmp_path)!r}\n"
        + POLAR_SOLVER_STUBS + POLAR_SOLVER_STEPS[step] +
        "assert all(n[k] for n in total.values()\n"
        "           for k in ('contract_planes_sym', 'write_plane_strips'))"
        " if 'dense' not in total else not any(total['dense'].values())\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr[-3000:]


SPECIAL_MOVE_STEPS = {
    # chip_smoke step -> the code that runs it on the CPU
    "special_dense": (
        "chip_smoke.SPECIAL_MOVES = 16\n"
        "total, ms = chip_smoke.run_special_moves(ROOT, device='cpu')\n"
        "assert set(ms) == set(chip_smoke.SPECIAL_CHAINS)\n"
        "assert not any(total.values()), total\n"),
    "h2_spin": (
        # the small H2 system in the flagship's place, K5 and K2 counting
        # their plain versions' calls
        "import torch_co2_system as co2\n"
        "from mpmcxx_tpu_torch import flagship\n"
        "flagship.write_pqr_h2 = lambda p: co2.write_pqr(\n"
        "    p, co2.records(model='h2'))\n"
        "flagship.L = co2.L\n"
        "flagship.H2_EXTRA_SLOTS, flagship.N_H2 = 8, co2.N_MOL\n"
        "chip_smoke.H2_SPIN_SLOTS = 8 + 5 * (co2.N_MOL + 32)\n"
        "from mpmcxx_tpu_torch.ops import cuda_polar, polar\n"
        "def counting(orig):\n"
        "    def f(*a, **k):\n"
        "        f.launches += 1\n"
        "        return orig(*a, **k)\n"
        "    f.launches = 0\n"
        "    return f\n"
        "for name in ('contract_planes_sym', 'write_plane_strips'):\n"
        "    setattr(cuda_polar, name, counting(getattr(cuda_polar, name)))\n"
        "polar.use_sym = lambda shape: shape[0] == shape[1]\n"
        "chip_smoke.count_launches = lambda fn, tries=8: (\n"
        "    fn(), 0, 0.0, 'no profiler on the CPU')\n"
        "total, rate = chip_smoke.run_h2_spin(w, 'cpu', device='cpu')\n"
        "assert total['contract_planes_sym'] >= 4 * 64\n"),
    "spin_ensembles": (
        "g, p, rg, rp = chip_smoke.run_spin_ensembles(w, device='cpu')\n"
        "assert not any(g.values()) and not any(p.values())\n"),
}


@pytest.mark.parametrize("step", list(SPECIAL_MOVE_STEPS))
def test_special_move_steps_run_on_cpu(step, tmp_path):
    """Steps 21-23 (the special moves' goldens and dense chains, the H2
    flagship with spin flips and adiabatic molecules, spin flips in the
    Gibbs VLE and PI-NVT) on the CPU, step 22 on the small H2 system,
    with jax and the JAX package made unimportable and the card's calls
    stubbed: their gates pass."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        f"ROOT = {ROOT!r}\n"
        "import torch\n"
        "for f in ('synchronize', 'reset_peak_memory_stats',\n"
        "          'max_memory_allocated', 'empty_cache',\n"
        "          'set_sync_debug_mode'):\n"
        "    setattr(torch.cuda, f, lambda *a, **k: 0)\n"
        "import chip_smoke\n"
        f"w = {str(tmp_path)!r}\n"
        + SPECIAL_MOVE_STEPS[step])
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr[-3000:]


REPLICA_STUBS = (
    # K5, K2 and K3 count their plain versions' calls and the switch picks
    # K5 for every square plane; the small CO2 system in the flagship's
    # place (248 runner slots, an 18 A box, an 8^3 cavity grid)
    "from mpmcxx_tpu_torch.ops import cuda_cavity, cuda_polar, polar\n"
    "from mpmcxx_tpu_torch.mc import cavity\n"
    "def counting(orig):\n"
    "    def f(*a, **k):\n"
    "        f.launches += 1\n"
    "        return orig(*a, **k)\n"
    "    f.launches = 0\n"
    "    return f\n"
    "for name in ('contract_planes_sym', 'write_plane_strips'):\n"
    "    setattr(cuda_polar, name, counting(getattr(cuda_polar, name)))\n"
    "cuda_cavity.occupancy = cavity.occupancy = counting(\n"
    "    cuda_cavity.occupancy)\n"
    "polar.use_sym = lambda shape: shape[0] == shape[1]\n"
    "import os, numpy as np, torch_co2_system as co2\n"
    "pqr = os.path.join(w, 'flagship_co2.pqr')\n"
    "co2.write_pqr(pqr, co2.records())\n"
    "chip_smoke.RUN_IN = chip_smoke.RUN_IN.replace(' 80', ' 18').replace(\n"
    "    'numsteps 128', 'numsteps 8').replace('corrtime 64', 'corrtime 4'\n"
    "    ).replace('cavity_grid 24', 'cavity_grid 8')\n"
    "chip_smoke.CLI_SLOTS, chip_smoke.CLI_DARTS = 8 + 6 * co2.N_MOL, 583\n"
    "chip_smoke.CHUNK = 4\n"
    "chip_smoke.REP_STEPS, chip_smoke.REP_CORRTIME = 8, 4\n"
    "chip_smoke.REP_PTEMP = 2\n")
REPLICA_STEPS = {
    "replicas_vs_single": (
        "state, _, flags, params, opts = co2.torch_system()\n"
        "n, kept = chip_smoke.check_replicas_vs_single(state, flags, params,\n"
        "                                              opts)\n"
        "assert n['contract_planes_sym'] >= 4 * 32, n\n"
        "assert len(kept['reps']) == len(kept['outs']) == 2, kept\n"),
    "replicas_cli": (
        "with open(os.path.join(w, 'run.in'), 'w') as f:\n"
        "    f.write(chip_smoke.RUN_IN)\n"
        "_, _, cli, _, _ = chip_smoke._run_cli(w, ['--device', 'cpu',\n"
        "                                         'run.in'])\n"
        "n, out = chip_smoke.run_replica_flagship(w, cli, 'cpu',\n"
        "                                         device='cpu')\n"
        "assert n['occupancy'] >= 2 * 4 * 8 and out['swap'][1] == 6, out\n"
        "assert len(out['restart_s']) == 2 and len(out['rates']) == 4\n"),
    "codec": (
        "from mpmcxx_tpu_torch.io.pqr import read_pqr\n"
        "from mpmcxx_tpu_torch.state import build_state\n"
        "def small(p, device, with_meta=False):\n"
        "    st, meta = build_state(read_pqr(p), np.eye(3) * 18.0,\n"
        "                           extra_mol_capacity=co2.N_MOL,\n"
        "                           device=device)\n"
        "    return (st, meta) if with_meta else st\n"
        "chip_smoke.cli_flagship_state = small\n"
        "times = chip_smoke.check_codec(pqr, device='cpu')\n"
        "assert set(times) == {'codec', 'python'}\n"),
}


@pytest.mark.parametrize("step", list(REPLICA_STEPS))
def test_replica_steps_run_on_cpu(step, tmp_path):
    """Step 24 (2 replicas against single chains; 4 tempering replicas
    of the cavity-biased flagship through the CLI with --replicas; the
    native codec) on the small CO2 system on the CPU, with jax and the
    JAX package made unimportable and the card's calls stubbed: their
    gates pass, the launch gates against the counted plain calls."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import torch\n"
        "for f in ('synchronize', 'reset_peak_memory_stats',\n"
        "          'max_memory_allocated', 'empty_cache',\n"
        "          'set_sync_debug_mode'):\n"
        "    setattr(torch.cuda, f, lambda *a, **k: 0)\n"
        "import chip_smoke\n"
        f"w = {str(tmp_path)!r}\n"
        + REPLICA_STUBS + REPLICA_STEPS[step])
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr[-3000:]


MESH_STUBS = REPLICA_STUBS + (
    # K1 and K4 counted too, the timers and the profiler stubbed; a mesh
    # of 4 CPU entries in the card's place; step 14's fluid at 64 H2 x 8
    # beads in a box of its density
    "for name in ('contract_planes', 'contract_planes_tri'):\n"
    "    setattr(cuda_polar, name, counting(getattr(cuda_polar, name)))\n"
    "torch.cuda.memory_allocated = lambda *a, **k: 0\n"
    "chip_smoke._time_ms = lambda fn, reps=1: (fn(), 1.0)[1]\n"
    "chip_smoke.device_split = lambda fn, want='', count=1, **k: (\n"
    "    fn(), {want + '_kernel': (0.01, float(count))})[1]\n"
    "from mpmcxx_tpu_torch.parallel import meshing\n"
    "mesh = meshing.make_mesh(devices=['cpu'] * 4)\n"
    "from mpmcxx_tpu_torch.io.pqr import read_pqr\n"
    "from mpmcxx_tpu_torch.state import build_state\n"
    "def small(p, device, with_meta=False):\n"
    "    st, meta = build_state(read_pqr(p), np.eye(3) * 18.0,\n"
    "                           extra_mol_capacity=co2.N_MOL,\n"
    "                           device=device)\n"
    "    return (st, meta) if with_meta else st\n"
    "chip_smoke.cli_flagship_state = small\n"
    "chip_smoke.PI_H2 = dict(chip_smoke.PI_H2, n=64, L=14.0, beads=8)\n")
MESH_STEPS = {
    "replicas": (
        "state, _, flags, params, opts = co2.torch_system()\n"
        "_, rep_a = chip_smoke.check_replicas_vs_single(state, flags,\n"
        "                                               params, opts)\n"
        "n = chip_smoke.check_replicas_on_mesh(rep_a, flags, params, opts,\n"
        "                                      device='cpu')\n"
        "assert n['write_plane_strips'] == 32, n\n"),
    "energy": (
        "_, _, flags, params, _ = co2.torch_system()\n"
        "chip_smoke.MESH_BLOCK = 16\n"
        "n, k1 = chip_smoke.check_sharded_energy(pqr, flags, params, mesh,\n"
        "                                        device='cpu')\n"
        "assert n['contract_planes'] == 16 and k1['slices'] == [62] * 4, n\n"),
    "chain": (
        "stats = {'rate': 1.0, 'peak_gb': 0.0, 'base_gb': 0.0}\n"
        "chip_smoke.MESH_CORRTIME = 4\n"
        "n, sim, out = chip_smoke.run_mesh_chain(w, mesh, stats, 'cpu',\n"
        "                                        device='cpu')\n"
        "assert out['per_move']['write_plane_strips'] == 4, out\n"
        "assert out['per_move']['contract_planes'] >= 16, out\n"
        "k2 = chip_smoke.check_k2_row_slices(sim.carry.pcache, 'cpu')\n"
        "assert k2['ms'] == 0.01, k2\n"),
    "pi": (
        "n, out = chip_smoke.run_mesh_pi(w, mesh, 4, device='cpu')\n"
        "assert not any(n.values()) and out['rate'] > 0, n\n"),
}


@pytest.mark.parametrize("step", list(MESH_STEPS))
def test_mesh_steps_run_on_cpu(step, tmp_path):
    """Step 25 (2 replicas on a 2-shard mesh against step 24a's; the
    sharded energy of the runner's state and the sliced K1; the flagship
    through Simulation(mesh=...) and K2's row-slice mode; PI on the
    mesh) on the small CO2 system and a small PI fluid, on a mesh of 4
    CPU entries, with jax and the JAX package made unimportable and the
    card's calls stubbed: their gates pass, the launch gates against the
    counted plain calls."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import torch\n"
        "for f in ('synchronize', 'reset_peak_memory_stats',\n"
        "          'max_memory_allocated', 'empty_cache',\n"
        "          'set_sync_debug_mode'):\n"
        "    setattr(torch.cuda, f, lambda *a, **k: 0)\n"
        "import chip_smoke\n"
        f"w = {str(tmp_path)!r}\n"
        + MESH_STUBS + MESH_STEPS[step])
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr[-3000:]


def test_bench_step_runs_on_cpu(tmp_path):
    """Step 26 (the bench module's flagships, Thole solve and PIMC) on the
    CPU, with jax and the JAX package made unimportable and the card's
    calls stubbed: the small CO2, H2 and monatomic systems
    in the flagships' place (a 4-move warm-up and one 8-move segment), the
    Thole solve on the small monatomic one, the PIMC argon dimer for one
    chunk after its warm-up; its gates pass, the launch gates against the
    counted plain calls."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import torch\n"
        "for f in ('synchronize', 'empty_cache'):\n"
        "    setattr(torch.cuda, f, lambda *a, **k: 0)\n"
        "import chip_smoke\n"
        "from mpmcxx_tpu_torch import bench, flagship\n"
        "from mpmcxx_tpu_torch.ops import cuda_polar, polar\n"
        "def counting(orig):\n"
        "    def f(*a, **k):\n"
        "        f.launches += 1\n"
        "        return orig(*a, **k)\n"
        "    f.launches = 0\n"
        "    return f\n"
        "for name in ('contract_planes_sym', 'write_plane_strips'):\n"
        "    setattr(cuda_polar, name, counting(getattr(cuda_polar, name)))\n"
        "polar.use_sym = lambda shape: shape[0] == shape[1]\n"
        "import torch_co2_system as co2\n"
        "for name, model in (('build_state_co2', 'co2'),\n"
        "                    ('build_state_h2', 'h2'),\n"
        "                    ('build_state', 'ar')):\n"
        "    setattr(flagship, name, lambda device='cuda', model=model:\n"
        "            co2.torch_system(device, model=model))\n"
        "bench.CHUNK, bench.MEASURE_STEPS = 4, 8\n"
        "n, out = chip_smoke.run_bench_step('cpu', device='cpu')\n"
        "assert set(n) == {'bench-co2', 'bench-h2', 'bench-ar',\n"
        "                  'bench-thole', 'bench-pimc'}, n\n"
        "assert n['bench-co2']['contract_planes_sym'] == 4 * 12 + 4, n\n"
        "assert n['bench-thole']['contract_planes_sym'] == 31 * 4, n\n"
        "assert all(x > 0 for x in out.values()), out\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr[-3000:]


def test_vle_shape_without_tools(tmp_path):
    """Step 13's Gibbs VLE input from the port's validate package with
    tools/ off the path and its gibbs_vle module unimportable: the
    lever-rule split N = (497, 15) on 994 and 512 slots, the dense
    incremental path (vle_simulation's own gate)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        "sys.modules['gibbs_vle'] = None\n"
        "assert not any(p.endswith('tools') for p in sys.path), sys.path\n"
        "import chip_smoke\n"
        f"sim = chip_smoke.vle_simulation({str(tmp_path)!r}, device='cpu')\n"
        "print(sim.state_a.n_atom_slots, sim.state_b.n_atom_slots)\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-2:] == ["994", "512"]


def test_validate_step_runs_on_cpu(tmp_path):
    """Step 27 (the validation studies at wiring length) on the CPU, with
    jax, the JAX package and the tools' modules made unimportable and the
    card's calls stubbed: warmstart on the mini geometry (232 slots) in
    the flagship's place; K1, K5, K2 and K3 count their plain versions'
    calls, K5 for square planes of at least 200 slots; every gate of the
    step passes (JSON keys, refreshes, the launch counts, the truth
    against CG)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        "for m in ('uvt_crosscheck', 'npt_crosscheck', 'gibbs_vle',\n"
        "          'ptemp_validate', 'warmstart_study', 'flagship'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "for f in ('synchronize', 'empty_cache'):\n"
        "    setattr(torch.cuda, f, lambda *a, **k: 0)\n"
        "import chip_smoke\n"
        "from mpmcxx_tpu_torch.ops import cuda_cavity, cuda_polar, polar\n"
        "from mpmcxx_tpu_torch.mc import cavity\n"
        "from mpmcxx_tpu_torch.validate import common, warmstart\n"
        "def counting(orig):\n"
        "    def f(*a, **k):\n"
        "        f.launches += 1\n"
        "        return orig(*a, **k)\n"
        "    f.launches = 0\n"
        "    return f\n"
        "for name in ('contract_planes', 'contract_planes_sym',\n"
        "             'write_plane_strips'):\n"
        "    setattr(cuda_polar, name, counting(getattr(cuda_polar, name)))\n"
        "cuda_cavity.occupancy = cavity.occupancy = counting(\n"
        "    cuda_cavity.occupancy)\n"
        "polar.use_sym = lambda shape: shape[0] == shape[1] >= 200\n"
        "build = warmstart.build\n"
        "warmstart.build = lambda mini, device: build(True, device)\n"
        "chip_smoke.VAL_WARM_SLOTS = 232\n"
        "n, out = chip_smoke.run_validate_step('cpu', device='cpu')\n"
        "assert set(out) == {'uvt-argon', 'uvt-polar', 'uvt-cavity', 'npt',\n"
        "                    'gibbs-vle', 'ptemp', 'warmstart'}, out\n"
        "assert n['validate-uvt-polar']['contract_planes'] >= 4 * 150, n\n"
        "assert n['validate-uvt-cavity']['occupancy'] >= 2 * 150, n\n"
        "assert n['validate-warmstart']['contract_planes_sym'] == 13 * 17, n\n")
    r = _run(["-c", code], ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:] + r.stdout[-3000:]


def test_pair_kernel_step_runs_on_cpu(tmp_path):
    """Step 28 (K6 at the benchmark cells' shapes) on the CPU, with jax
    and the JAX package made unimportable: each cell's configuration,
    lattice and run.in from the benchmark's builders, its build stood in
    for by tests/torch_pair_system.py's mixture (LJ for the CO2 cell, FH4
    for the H2 one) and an initial blocked energy, K6 by its plain
    version counted as launches; the build's one K6 launch and every
    check of check_k6 pass, and its record holds the bound of the pair
    classes."""
    code = (
        "import os, sys, types\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpmcxx_tpu'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import torch\n"
        "for f in ('synchronize', 'empty_cache'):\n"
        "    setattr(torch.cuda, f, lambda *a, **k: 0)\n"
        "import chip_smoke\n"
        "import torch_pair_system as ps\n"
        "from benchmark import harness\n"
        "from mpmcxx_tpu_torch.ops import cuda_pairs, energy\n"
        "def counting(orig):\n"
        "    def f(*a, **k):\n"
        "        f.launches += 1\n"
        "        return orig(*a, **k)\n"
        "    f.launches = 0\n"
        "    return f\n"
        "cuda_pairs.pair_sums = counting(energy.pair_sums_plain)\n"
        "cuda_pairs.takes = lambda st, fl: True\n"
        "chip_smoke._time_ms = lambda fn, reps=10: (fn(), 1.0)[1]\n"
        "built = []\n"
        "def build(path, config, traffic, dev):\n"
        "    assert os.path.getsize(path) and config['slots'] > 19000\n"
        "    state, _ = ps.build(dev)\n"
        "    flags = ps.flags('fh4' if 'h2' in config['name'] else 'lj')\n"
        "    energy.energy_breakdown_blocked(state, flags, ps.params())\n"
        "    built.append(config['name'])\n"
        "    return types.SimpleNamespace(state=state, flags=flags,\n"
        "                                 params=ps.params())\n"
        "harness.build = build\n"
        "n = {}\n"
        "recs = chip_smoke.run_k6_cells(n, device='cpu')\n"
        "assert built == ['co2-trappe-298k', 'h2-bssp-77k'], built\n"
        "assert set(n) == {'k6-co2-bulk.plain', 'k6-h2-bulk-77k.fixed4'}\n"
        "assert all(v['pair_energy'] == 1 for v in n.values()), n\n"
        "for r in recs.values():\n"
        "    assert r['max_abs_err'] == 0.0 and r['ms'] == 1.0, r\n"
        "    assert r['bound'][1] == 'operations' and r['bound'][0] > 0\n"
        "lj, fh4 = (recs[c]['bound'][0] for c in chip_smoke.K6_CELLS)\n"
        "assert fh4 > lj, (lj, fh4)\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr[-3000:] + r.stdout[-3000:]
