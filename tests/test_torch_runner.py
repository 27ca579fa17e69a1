"""The run.in path as a whole: the same input through the JAX package's
``runner.Simulation`` and the port's, on the CPU.  A CO2 PQR of 8 frozen
framework atoms and 171 CO2 in a 28 A box (1,034 atom slots after the
runner's uVT headroom, so both packages take the blocked path), cavity
bias on (6^3 grid, radius 2.6 A), two corrtimes of 8 moves, then one
capacity regrowth and one more chunk.

Tolerances: energies agree to 1e-6 relative (the f32 SCF planes are
summed in another order); the dipole and field logs print 6 decimals of
values carrying that f32 difference, so they agree to 2e-6 absolute;
counts, cavity averages, PQR files and regrown states are equal."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu.config.parser import read_config as read_config_j  # noqa: E402
from mpmcxx_tpu.runner import Simulation as Simulation_j  # noqa: E402
from mpmcxx_tpu.state import grow_mol_capacity as grow_j  # noqa: E402
from mpmcxx_tpu_torch.config.parser import \
    read_config as read_config_t  # noqa: E402
from mpmcxx_tpu_torch.runner import Simulation as Simulation_t  # noqa: E402
from mpmcxx_tpu_torch.state import grow_mol_capacity as grow_t  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax  # noqa: E402

BOX, N_MOL = 28.0, 171
RUN_IN = f"""job_name cav
ensemble uvt
temperature 150.0
pressure 20.0
insert_probability 0.3
move_factor 0.1
numsteps 16
corrtime 8
seed 0
polarization on
polar_iterative on
polar_ewald on
polar_mixed on
polar_max_iter 4
polar_damp_type exponential
polar_damp 2.1304
cavity_bias on
cavity_grid 6
cavity_radius 2.6
pqr_input co2.pqr
basis1 {BOX} 0 0
basis2 0 {BOX} 0
basis3 0 0 {BOX}
"""
FILES = ("cav.energy.dat", "cav.restart.pqr", "cav.final.pqr",
         "cav.traj.pqr", "cav.dipole.dat", "cav.field.dat")


def _run(workdir, read_config, Simulation, **kw):
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        sim = Simulation(read_config("run.in"), quiet=True, **kw)
        n_slots = sim.state.n_atom_slots
        sim.run()
        outs = {}
        for name in FILES:
            with open(name) as f:
                outs[name] = f.read()
        # a proactive regrowth, then one more corrtime chunk
        sim._grow_capacity(sim.carry)
        sim.carry, stats = sim.run_chunk(sim.carry)
    finally:
        os.chdir(cwd)
    return sim, n_slots, outs, [int(m) for m in np.asarray(stats.movetype)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("runner")
    co2.write_pqr(str(base / "co2.pqr"), co2.records(5, BOX, N_MOL, 6))
    (base / "run.in").write_text(RUN_IN)
    dirs = []
    for name in ("jax", "torch"):
        d = base / name
        d.mkdir()
        for f in ("co2.pqr", "run.in"):
            shutil.copy(base / f, d / f)
        dirs.append(d)
    return (_run(dirs[0], read_config_j, Simulation_j),
            _run(dirs[1], read_config_t, Simulation_t, device="cpu"))


def _rows(text):
    return np.array([[float(x) for x in ln.split()]
                     for ln in text.splitlines() if not ln.startswith("#")])


def test_energy_log_matches_jax(runs):
    (sj, nj, oj, _), (st, nt, ot, _) = runs
    assert nt == nj > 1024
    ej, et = _rows(oj["cav.energy.dat"]), _rows(ot["cav.energy.dat"])
    assert ej.shape == et.shape == (3, 12)
    np.testing.assert_array_equal(et[:, 0], [0, 8, 16])
    np.testing.assert_allclose(et, ej, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(et[:, 8], ej[:, 8])      # N


def test_counts_and_cavity_match_jax(runs):
    (sj, *_), (st, *_) = runs
    np.testing.assert_array_equal(st.carry.stats.accept.numpy(),
                                  np.asarray(sj.carry.stats.accept))
    np.testing.assert_array_equal(st.carry.stats.reject.numpy(),
                                  np.asarray(sj.carry.stats.reject))
    assert int(st.carry.stats.accept.sum()) > 0
    np.testing.assert_allclose(st.carry.cavity.numpy(),
                               np.asarray(sj.carry.cavity), rtol=1e-12)
    assert 0.0 < float(st.carry.cavity[0]) < 1.0
    assert st.avg.mean["cavity_bias_probability"] == pytest.approx(
        sj.avg.mean["cavity_bias_probability"], rel=1e-12)


def test_output_files_match_jax(runs):
    (_, _, oj, _), (_, _, ot, _) = runs
    for name in ("cav.restart.pqr", "cav.final.pqr", "cav.traj.pqr"):
        assert ot[name] == oj[name], name
    for name in ("cav.dipole.dat", "cav.field.dat"):
        a, b = _rows(ot[name]), _rows(oj[name])
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6, err_msg=name)


def test_capacity_regrowth_matches_jax(runs):
    (sj, nj, _, mj), (st, nt, _, mt) = runs
    assert st.state.n_atom_slots == sj.state.n_atom_slots > nt
    assert st.state.n_atom_slots % 512 == 0
    assert st.meta == sj.meta
    assert mt == mj
    assert float(st.carry.obs.N) == float(sj.carry.obs.N)
    assert float(st.carry.obs.energy) == pytest.approx(
        float(sj.carry.obs.energy), rel=1e-6)


def test_grow_mol_capacity_matches_jax():
    sj, mj = co2.jax_system()[:2]
    st = state_from_jax(co2.jax_state_numpy(sj))
    # one sorbate dead, so the regrowth drops it and re-pads
    alive = np.asarray(sj.mol_alive).copy()
    alive[5] = False
    sj = sj.replace(mol_alive=sj.mol_alive.at[5].set(False))
    st = st.replace(mol_alive=torch.from_numpy(alive),
                    aalive=torch.from_numpy(alive[np.asarray(sj.mol_id)]))
    gj, gmj = grow_j(sj, mj, {"CO2": 10}, ensure_species=("CO2",),
                     pad_atoms_multiple=64)
    gt, gmt = grow_t(st, dict(mj), {"CO2": 10}, ensure_species=("CO2",),
                     pad_atoms_multiple=64)
    assert gmt == gmj
    assert gt.n_atom_slots % 64 == 0
    want = co2.jax_state_numpy(gj)
    for f in dataclasses.fields(gt):
        if f.name == "pbc":
            for k, v in want["pbc"].items():
                np.testing.assert_array_equal(getattr(gt.pbc, k).numpy(), v)
            continue
        np.testing.assert_array_equal(getattr(gt, f.name).numpy(),
                                      want[f.name], err_msg=f.name)
