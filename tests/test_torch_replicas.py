"""Replica chains and parallel tempering in the port (parallel/replicas.py,
parallel/driver.py, the CLI's dispatch) against the JAX package on the
same seeded inputs.

- Twins of tests/test_replica_driver.py: resume from per-replica
  restarts with the merged histogram, the restart search order and its
  ``parallel_restarts`` gate, capacity regrowth, and replicas against
  independent single chains (the small CO2 system with the polar cache:
  moves and accepts exactly, energies within 1e-6 relative of the JAX
  vmapped replicas, bitwise equal to the port's own single chains).
- Twins of tests/test_gibbs_replicas.py: replicated chains diverge, the
  ladder, and the swap, bitwise equal to the JAX one for both parities.
- ``ReplicaSimulation`` against the JAX one on argon uVT: R = 2 without
  tempering and R = 3 with tempering: the energy log, the restart and
  final PQRs (after both drains), the DX file, the swap counters and the
  final temperatures byte for byte.
- Replica carries share no storage; the R-replica cache budget
  (``polar_cache.max_slots(n_caches=R)``); the CLI's dispatch; what
  raises (a CUDA run without CUDA).

The JAX replica runs are kept small (<= 12 molecules, <= 24 moves per
chunk): JAX's compile is most of each test's time."""

import copy
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu.config.parser import read_config as read_j  # noqa: E402
from mpmcxx_tpu.io import pqr as pqr_j  # noqa: E402
from mpmcxx_tpu.mc import chain as chain_j  # noqa: E402
from mpmcxx_tpu.parallel import replicas as rep_j  # noqa: E402
from mpmcxx_tpu.parallel.driver import ReplicaSimulation as RepSim_j  # noqa: E402,E501
from mpmcxx_tpu_torch import constants as const  # noqa: E402
from mpmcxx_tpu_torch import random as rnd  # noqa: E402
from mpmcxx_tpu_torch.config.parser import read_config as read_t  # noqa: E402
from mpmcxx_tpu_torch.flags import FFlags, RunParams  # noqa: E402
from mpmcxx_tpu_torch.mc import chain as chain_t  # noqa: E402
from mpmcxx_tpu_torch.ops import polar_cache as pc_t  # noqa: E402
from mpmcxx_tpu_torch.parallel import replicas as rep_t  # noqa: E402
from mpmcxx_tpu_torch.parallel.driver import ReplicaSimulation as RepSim_t  # noqa: E402,E501
from mpmcxx_tpu_torch.state import AtomRecord, build_state, topology  # noqa: E402,E501
from test_replica_driver import write_inputs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sim(cfg, R, **kw):
    return RepSim_t(cfg, R, quiet=True, device="cpu", **kw)


def _tensors(x, out):
    """Every tensor reachable in a carry (dataclasses, tuples)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, out)
    return out


# --- twins of tests/test_replica_driver.py -------------------------------

def test_resume_and_merged_histogram(tmp_path, monkeypatch):
    """Per-replica restart files and the merged histogram are written;
    with parallel_restarts on, a fresh ReplicaSimulation resumes each
    replica from its own restart (not the input), with the run's N and
    energies; the JAX one resumes from the same files to the same N and
    energies (1e-9 relative)."""
    monkeypatch.chdir(tmp_path)
    write_inputs(tmp_path)
    sim = _sim(read_t("run.in"), 2)
    sim.run()
    for name in ("rdrv.restart-0000.pqr", "rdrv.restart-0001.pqr"):
        assert os.path.exists(name)
    txt = open("rdrv.hist.dx").read()
    assert "gridconnections" in txt
    n_end = [float(c.obs.N) for c in sim.carries]
    e_end = [float(c.obs.energy) for c in sim.carries]
    assert n_end[0] != n_end[1] or e_end[0] != e_end[1]

    cfg2 = read_t("run.in")
    cfg2.parallel_restarts = True
    sim2 = _sim(cfg2, 2)
    assert [sim2._restart_path(r) for r in range(2)] == \
        ["rdrv.restart-0000.pqr", "rdrv.restart-0001.pqr"]
    assert [float(c.obs.N) for c in sim2.carries] == n_end
    np.testing.assert_allclose([float(c.obs.energy) for c in sim2.carries],
                               e_end, rtol=1e-3)
    cfg_j = read_j("run.in")
    cfg_j.parallel_restarts = True
    sim_j = RepSim_j(cfg_j, 2, quiet=True)
    np.testing.assert_array_equal(np.asarray(sim_j.carry.obs.N), n_end)
    np.testing.assert_allclose(
        [float(c.obs.energy) for c in sim2.carries],
        np.asarray(sim_j.carry.obs.energy), rtol=1e-9)
    assert [c.state.n_atom_slots for c in sim2.carries] == \
        [sim_j.carry.state.pos.shape[1]] * 2


def test_restart_path_search_order(tmp_path, monkeypatch):
    """Nothing on disk -> the input; ``.last`` before the input, the
    plain restart before ``.last`` — the same paths as the JAX
    ReplicaSimulation's."""
    monkeypatch.chdir(tmp_path)
    write_inputs(tmp_path, hist=False)
    sims = []
    for read, make in ((read_t, _sim),
                       (read_j, lambda c, R: RepSim_j(c, R, quiet=True))):
        cfg = read("run.in")
        cfg.parallel_restarts = True
        sims.append(make(cfg, 2))

    def paths(r):
        got = {s._restart_path(r) for s in sims}
        assert len(got) == 1
        return got.pop()
    assert paths(0) == "box.pqr"
    open("rdrv.restart-0001.pqr.last", "w").write("")
    assert paths(1) == "rdrv.restart-0001.pqr.last"
    open("rdrv.restart-0001.pqr", "w").write("")
    assert paths(1) == "rdrv.restart-0001.pqr"
    assert paths(0) == "box.pqr"


def test_restart_search_gated_on_parallel_restarts(tmp_path, monkeypatch):
    """Without parallel_restarts (and with pqr_restart /dev/null) a
    replica job in a directory with restart files starts from the input
    (SimulationControl.cpp:2298-2355)."""
    monkeypatch.chdir(tmp_path)
    write_inputs(tmp_path, hist=False)
    cfg = read_t("run.in")
    assert not cfg.parallel_restarts
    sim = _sim(cfg, 2)
    open("rdrv.restart-0001.pqr", "w").write("")
    assert sim._restart_path(1) == "box.pqr"
    sim.cfg.parallel_restarts = True
    sim.cfg.pqr_restart = "/dev/null"
    assert sim._restart_path(1) == "box.pqr"


def test_replica_capacity_regrowth(tmp_path, monkeypatch):
    """A replica's insert at the molecule-capacity ceiling discards the
    chunk and regrows every replica to one common capacity (the replica
    twin of runner.Simulation._grow_capacity): the capacity grows, a
    replica samples past the old ceiling, the random streams stay
    distinct and each carried energy equals its refresh."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(9)
    with open("box.pqr", "w") as f:
        for m in range(2):
            x, y, z = rng.uniform(-6, 6, 3)
            f.write(f"ATOM  {m + 1:5d} Ar   Ar  M {m + 1:4d}   "
                    f"{x:8.3f}{y:8.3f}{z:8.3f} 39.94800  0.00000  "
                    f"0.00000 119.80000  3.40500  0.00000  0.00000\n")
        f.write("END\n")
    with open("run.in", "w") as f:
        f.write("job_name rgrw\nensemble uvt\ntemperature 110.0\n"
                "pressure 200.0\ninsert_probability 0.7\nnumsteps 600\n"
                "corrtime 100\nseed 6\nmove_factor 0.3\npqr_input box.pqr\n"
                "pqr_restart /dev/null\nenergy_output /dev/null\n"
                "basis1 16 0 0\nbasis2 0 16 0\nbasis3 0 0 16\n")
    sim = _sim(read_t("run.in"), 2)
    cap0 = sim.carries[0].state.n_mol_slots
    grown = []
    orig = sim._grow_replica_capacity
    sim._grow_replica_capacity = lambda prev: (grown.append(1), orig(prev))
    sim.run()
    caps = {c.state.n_mol_slots for c in sim.carries}
    assert grown and len(caps) == 1 and caps.pop() > cap0
    N = [int(c.state.mol_alive.sum()) for c in sim.carries]
    assert max(N) > cap0
    assert not torch.equal(sim.carries[0].key, sim.carries[1].key)
    for c in sim.carries:
        fresh = sim.refresh(c)
        assert float(c.obs.energy) == pytest.approx(float(fresh.obs.energy),
                                                    rel=1e-9)


def test_replicas_match_independent_single_chains():
    """The replica premise on the flagship's code path (uVT, incremental
    Delta-E and the polar cache, blocked energy) on the small CO2 system:
    R = 3 replicas of one 24-move chunk each equal the single chain run
    from the same carry with key fold_in(PRNGKey(0), r), bitwise (state,
    energy and the committed planes); against the JAX package's vmapped
    replicas the same moves and accepts, energies within 1e-6 relative
    (the f32 planes); distinct streams diverge."""
    R, chunk = 3, 24
    sj, _, fj, pj, oj = co2.jax_system()
    carry_j = chain_j.init_carry(sj, fj, pj, oj, seed=0)
    out_j, outs_j = rep_j.make_replica_runner(fj, pj, oj, chunk)(
        rep_j.replicate_carry(carry_j, R, base_seed=0))

    st, _, ft, pt, ot = co2.torch_system()
    carry_t = chain_t.init_carry(st, ft, pt, ot, seed=0)
    reps = rep_t.replicate_carry(carry_t, R, base_seed=0)
    out_t, outs_t = rep_t.make_replica_runner(ft, pt, ot, chunk)(reps)
    single = chain_t.make_chunk_runner(ft, pt, ot, chunk,
                                       topology=topology(st))
    for r in range(R):
        one, outs_1 = single(dataclasses.replace(
            copy.deepcopy(carry_t), key=rnd.fold_in(rnd.PRNGKey(0), r)))
        assert torch.equal(out_t[r].key, one.key)
        assert torch.equal(out_t[r].state.pos, one.state.pos)
        assert torch.equal(out_t[r].state.mol_alive, one.state.mol_alive)
        assert torch.equal(out_t[r].obs.energy, one.obs.energy)
        for a, b in zip(pc_t.planes_of(out_t[r].pcache),
                        pc_t.planes_of(one.pcache)):
            assert torch.equal(a, b)
        assert torch.equal(outs_t[r].accepted, outs_1.accepted)
        # against the JAX package's vmapped replica r
        np.testing.assert_array_equal(out_t[r].key.numpy(),
                                      np.asarray(out_j.key[r]))
        assert outs_t[r].movetype.tolist() == \
            np.asarray(outs_j.movetype[r]).tolist()
        assert outs_t[r].accepted.tolist() == \
            np.asarray(outs_j.accepted[r]).tolist()
        np.testing.assert_array_equal(out_t[r].state.mol_alive.numpy(),
                                      np.asarray(out_j.state.mol_alive[r]))
        for f in ("energy", "polarization_energy", "rd_energy",
                  "coulombic_energy", "N"):
            assert float(getattr(out_t[r].obs, f)) == pytest.approx(
                float(getattr(out_j.obs, f)[r]), rel=1e-6, abs=1e-9)
        np.testing.assert_allclose(out_t[r].state.pos.numpy(),
                                   np.asarray(out_j.state.pos[r]),
                                   rtol=0, atol=1e-9)
    assert not torch.equal(out_t[0].state.pos, out_t[1].state.pos)
    assert 0 < sum(int(o.accepted.sum()) for o in outs_t) < R * chunk


def test_replica_carries_share_no_storage():
    """replicate_carry gives each replica its own tensors: no data_ptr of
    one replica's carry (state, caches, planes) appears in another's or
    in the source carry, and an in-place plane write of one replica
    leaves the others as they were."""
    st, _, ft, pt, ot = co2.torch_system()
    carry = chain_t.init_carry(st, ft, pt, ot, seed=0)
    reps = rep_t.replicate_carry(carry, 3, base_seed=5)
    seen = {t.data_ptr() for t in _tensors(carry, []) if t.numel()}
    for c in reps:
        ptrs = {t.data_ptr() for t in _tensors(c, []) if t.numel()}
        assert not ptrs & seen
        seen |= ptrs
    assert reps[0].pcache.dx.data_ptr() != reps[1].pcache.dx.data_ptr()
    before = reps[1].pcache.dx.clone()
    reps[0].pcache.dx.add_(1.0)
    assert torch.equal(reps[1].pcache.dx, before)
    keys = [c.key.tolist() for c in reps]
    assert len({tuple(k) for k in keys}) == 3
    assert keys[2] == rnd.fold_in(rnd.PRNGKey(5), 2).tolist()


# --- twins of tests/test_gibbs_replicas.py -------------------------------

def _argon_box(n, L, extra=8):
    """tests/test_gibbs_replicas.py::argon_box in the port."""
    g = int(np.ceil(n ** (1 / 3)))
    s = L / g
    atoms = []
    for i in range(g):
        for j in range(g):
            for k in range(g):
                if len(atoms) < n:
                    atoms.append(AtomRecord(
                        "Ar", "Ar", len(atoms) + 1, x=(i + .5) * s - L / 2,
                        y=(j + .5) * s - L / 2, z=(k + .5) * s - L / 2,
                        mass=39.948, epsilon=119.8, sigma=3.405))
    return build_state(atoms, np.eye(3) * L, extra_mol_capacity=extra,
                       device="cpu")


def test_replicated_chains_diverge():
    """Four NVT replicas of 8 argon atoms (24 moves) end at different
    energies, each equal to the JAX vmapped replica's (1e-9)."""
    from test_gibbs_replicas import argon_box
    from mpmcxx_tpu import FFlags as FFlags_j, RunParams as RunParams_j
    state, _ = _argon_box(8, 20.0)
    opts = chain_t.MCOptions(ensemble=const.ENSEMBLE_NVT, move_factor=0.1,
                             numsteps=24)
    carry = chain_t.init_carry(state, FFlags(), RunParams(temperature=130.0),
                               opts, seed=0)
    reps, outs = rep_t.make_replica_runner(
        FFlags(), RunParams(temperature=130.0), opts, 24)(
        rep_t.replicate_carry(carry, 4, base_seed=7))
    energies = np.array([float(c.obs.energy) for c in reps])
    assert len(np.unique(energies.round(6))) > 1

    sj, _ = argon_box(8, 20.0)
    opts_j = chain_j.MCOptions(ensemble=const.ENSEMBLE_NVT, move_factor=0.1,
                               numsteps=24)
    params_j = RunParams_j(temperature=130.0)
    cj = chain_j.init_carry(sj, FFlags_j(), params_j, opts_j, seed=0)
    out_j, outs_j = rep_j.make_replica_runner(FFlags_j(), params_j, opts_j,
                                              24)(
        rep_j.replicate_carry(cj, 4, base_seed=7))
    np.testing.assert_allclose(energies, np.asarray(out_j.obs.energy),
                               rtol=1e-9)
    assert [o.accepted.tolist() for o in outs] == \
        np.asarray(outs_j.accepted).tolist()


def test_ladder():
    """Geometric, float64, ends at t_min and t_max, bitwise the JAX
    ladder; one replica -> [t_min]."""
    t = rep_t.temperature_ladder(100.0, 400.0, 5)
    assert t.dtype == np.float64
    assert t[0] == pytest.approx(100.0) and t[-1] == pytest.approx(400.0)
    assert np.all(np.diff(t) > 0)
    np.testing.assert_array_equal(
        t, np.asarray(rep_j.temperature_ladder(100.0, 400.0, 5)))
    np.testing.assert_array_equal(rep_t.temperature_ladder(150.0, 300.0, 1),
                                  [150.0])


def test_swap_prefers_low_energy_cold():
    """A cold bath holding a high-energy configuration swaps with a hot
    bath holding a low-energy one (factor > 1), as in the JAX package."""
    new_t, swapped = rep_t.tempering_swap([100.0, 200.0], [5000.0, -5000.0],
                                          rnd.PRNGKey(0), 0)
    assert bool(swapped[0])
    np.testing.assert_allclose(new_t, [200.0, 100.0])
    want_t, want_s = rep_j.tempering_swap(
        jnp.asarray([100.0, 200.0]), jnp.asarray([5000.0, -5000.0]),
        jax.random.PRNGKey(0), 0)
    np.testing.assert_array_equal(new_t, np.asarray(want_t))
    np.testing.assert_array_equal(swapped, np.asarray(want_s))


def test_swap_preserves_multiset():
    """Sweeps of both parities over an 8-rung ladder permute it, and each
    sweep's temperatures and swap mask are bitwise the JAX package's on
    the same key; some swaps are accepted and some refused."""
    temps = rep_t.temperature_ladder(50.0, 800.0, 8)
    energies = np.random.default_rng(0).normal(0, 1000, 8)
    n_swapped, n_left = 0, 0
    for sweep in range(6):
        parity = sweep % 2
        key = rnd.fold_in(rnd.PRNGKey(3), sweep)
        new_t, swapped = rep_t.tempering_swap(temps, energies, key, parity)
        want_t, want_s = rep_j.tempering_swap(
            jnp.asarray(temps), jnp.asarray(energies),
            jax.random.fold_in(jax.random.PRNGKey(3), sweep), parity)
        np.testing.assert_array_equal(new_t, np.asarray(want_t))
        np.testing.assert_array_equal(swapped, np.asarray(want_s))
        np.testing.assert_allclose(np.sort(new_t), np.sort(temps))
        n_swapped += int(swapped.sum())
        n_left += sum(1 for i in range(7) if i % 2 == parity)
        temps = new_t
    assert 0 < n_swapped < n_left


# --- ReplicaSimulation against the JAX one --------------------------------

@pytest.mark.parametrize("R,tempering", [(2, False), (3, True)],
                         ids=["r2", "r3_tempering"])
def test_replica_simulation_matches_jax(R, tempering, tmp_path, monkeypatch):
    """The argon uVT run of tests/test_replica_driver.py (6 atoms, 12
    steps, corrtime 6) through both packages' ReplicaSimulation: R = 2,
    and R = 3 under tempering (140 -> 700 K, ptemp_freq 3, so four
    sweeps): every file the runs write (energy log with one row per
    replica, restart PQRs and their .last, final PQRs, histogram DX) is
    byte-identical, and so are the swap counters and final
    temperatures."""
    extra = "energy_output rdrv.energy.dat\n"
    if tempering:
        extra += ("parallel_tempering on\nmax_temperature 700\n"
                  "ptemp_freq 3\n")
    sims = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        write_inputs(d)
        with open("run.in", "a") as f:
            f.write(extra)
        if pkg == "jax":
            sims[pkg] = RepSim_j(read_j("run.in"), R, quiet=True)
            sims[pkg].run()
            pqr_j.drain()
        else:
            sims[pkg] = _sim(read_t("run.in"), R)
            sims[pkg].run()
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "torch"))
    assert len([f for f in files if f.startswith("rdrv.restart-")]) == 2 * R
    assert len([f for f in files if f.startswith("rdrv.final-")]) == R
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    rows = (tmp_path / "torch" / "rdrv.energy.dat").read_text().splitlines()
    assert len(rows) == 1 + 3 * R
    sj, st = sims["jax"], sims["torch"]
    assert (st.swap_attempts, st.swap_accepts) == \
        (sj.swap_attempts, sj.swap_accepts)
    temps = [float(c.temperature) for c in st.carries]
    np.testing.assert_array_equal(temps, np.asarray(sj.carry.temperature))
    if tempering:
        assert st.swap_attempts == 4 and 0 < st.swap_accepts
        np.testing.assert_array_equal(
            sorted(temps), rep_t.temperature_ladder(140.0, 700.0, 3))


# --- the cache budget, the dispatch, what raises --------------------------

class _Card:
    total_memory = 80 * 2 ** 30


def test_max_slots_shares_the_card_among_replicas(monkeypatch):
    """max_slots(n_caches=R): today's bound at R = 1; on a stubbed 80 GiB
    card it shrinks as R grows, each bound holding (R + 2) copies of the
    planes within DEVICE_MEMORY_SHARE; the CO2 CLI's 19,712 slots fit
    four caches; the CPU's cap is the JAX package's 16,384 for every R."""
    for R in (1, 2, 4, 8):
        assert pc_t.max_slots("cpu", 3, R) == pc_t.CPU_MAX_SLOTS == 16384
        assert pc_t.max_slots(None, 5, R) == 16384
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Card)
    one = pc_t.max_slots("cuda", 3)
    assert one == pc_t.max_slots("cuda", 3, 1)
    assert 36 * one ** 2 <= pc_t.DEVICE_MEMORY_SHARE * _Card.total_memory \
        < 36 * (one + 1) ** 2
    caps = [pc_t.max_slots("cuda", 3, R) for R in (1, 2, 4, 8)]
    assert caps == sorted(caps, reverse=True) and len(set(caps)) == 4
    for R, cap in zip((1, 2, 4, 8), caps):
        per = 3 * 4 * (R + pc_t.PLANE_COPIES_AT_PEAK - 1)
        assert per * cap ** 2 <= pc_t.DEVICE_MEMORY_SHARE * \
            _Card.total_memory < per * (cap + 1) ** 2
    assert 19712 <= caps[2] < 27000
    flags = co2.torch_system()[2]
    assert pc_t.supports(flags, 19712, "cuda", 4)
    assert not pc_t.supports(flags, caps[2] + 1, "cuda", 4)


def test_replicas_over_budget_run_without_cache(tmp_path, monkeypatch,
                                                capsys):
    """A system whose R caches exceed the budget runs every replica on
    the no-cache path, said once; one cache would have fit."""
    from mpmcxx_tpu_torch import runner
    monkeypatch.chdir(tmp_path)
    co2.write_pqr("co2.pqr", co2.records())
    with open("run.in", "w") as f:
        f.write("job_name cap\nensemble uvt\ntemperature 300.0\n"
                "pressure 1.0\nnumsteps 4\ncorrtime 2\nseed 1\n"
                "polarization on\npolar_iterative on\npolar_ewald on\n"
                "polar_mixed on\npolar_max_iter 4\n"
                "polar_damp_type exponential\npolar_damp 2.1304\n"
                "pqr_input co2.pqr\nbasis1 18 0 0\nbasis2 0 18 0\n"
                "basis3 0 0 18\n")
    single = runner.Simulation(read_t("run.in"), quiet=True, device="cpu")
    slots = single.state.n_atom_slots
    assert single.opts.polar_incremental
    real = pc_t.max_slots
    monkeypatch.setattr(pc_t, "max_slots", lambda dev=None, n_planes=3,
                        n_caches=1: real(dev, n_planes) if n_caches == 1
                        else slots - 1)
    sim = RepSim_t(read_t("run.in"), 2, quiet=False, device="cpu")
    said = capsys.readouterr().out
    assert said.count("do not fit") == 1
    assert not sim.base.opts.polar_incremental
    assert all(c.pcache is None for c in sim.carries)
    sim.run()
    assert all(c.pcache is None for c in sim.carries)


def _example_cfg(name, tmp_path, extra=""):
    d = tmp_path / name
    shutil.copytree(os.path.join(REPO, "examples", name), d)
    with open(d / "run.in", "a") as f:
        f.write(extra)
    return d


def test_cli_dispatch(tmp_path, monkeypatch):
    """The JAX CLI's order: PI and Gibbs ignore --replicas; --replicas R
    runs R replica chains; tempering alone runs 2; neither runs one
    chain."""
    from mpmcxx_tpu_torch import cli
    from mpmcxx_tpu_torch.mc.gibbs import GibbsSimulation
    from mpmcxx_tpu_torch.mc.pi import PISimulation
    from mpmcxx_tpu_torch.runner import Simulation
    for name, cls in (("pi-argon-dimer", PISimulation),
                      ("gibbs-argon", GibbsSimulation)):
        monkeypatch.chdir(_example_cfg(name, tmp_path))
        cfg = read_t("run.in")
        cfg.total_trotter_number = 4
        assert type(cli.dispatch(cfg, 3, device="cpu")) is cls
    monkeypatch.chdir(_example_cfg("nvt-argon", tmp_path))
    assert type(cli.dispatch(read_t("run.in"), 1, device="cpu")) is \
        Simulation
    sim = cli.dispatch(read_t("run.in"), 3, device="cpu")
    assert type(sim) is RepSim_t and sim.R == 3 and not sim.tempering
    monkeypatch.chdir(_example_cfg(
        "npt-argon", tmp_path,
        "parallel_tempering on\nmax_temperature 300\n"))
    sim = cli.dispatch(read_t("run.in"), 1, device="cpu")
    assert type(sim) is RepSim_t and sim.R == 2 and sim.tempering
    assert sim.chunk == min(const.PTEMP_FREQ_DEFAULT, sim.cfg.corrtime)


def test_cli_replicas_run_to_the_end(tmp_path, monkeypatch, capsys):
    """``--replicas 2 --device cpu`` on the nvt-argon example runs to its
    end: one energy-log row per replica per corrtime, two restart and two
    final PQRs, each of the example's 64 atoms, on disk when the CLI
    returns; the startup echo counts one system."""
    from mpmcxx_tpu_torch import cli
    d = _example_cfg("nvt-argon", tmp_path)
    text = (d / "run.in").read_text()
    text = text.replace("numsteps 5000", "numsteps 8").replace(
        "corrtime 500", "corrtime 4")
    (d / "run.in").write_text(text)
    monkeypatch.chdir(d)
    rc, sim = cli.run(["--device", "cpu", "--replicas", "2", "run.in"])
    out = capsys.readouterr().out
    assert rc == 0 and type(sim) is RepSim_t
    assert out.splitlines()[-1] == "SIM_CONTROL: Simulation complete!"
    rows = (d / "ar_nvt.energy.dat").read_text().splitlines()[1:]
    assert [int(r.split()[0]) for r in rows] == [0, 0, 4, 4, 8, 8]
    for kind in ("restart", "final"):
        for r in range(2):
            path = str(d / f"ar_nvt.{kind}-000{r}.pqr")
            assert len(pqr_j.read_pqr(path)) == 64


def test_run_input_file_with_tempering_runs_one_chain(tmp_path,
                                                      monkeypatch):
    """run_input_file takes a parallel_tempering input as one chain at
    the base temperature, in both packages: the port's energy log equals
    the JAX package's byte for byte."""
    from mpmcxx_tpu import runner as runner_j
    from mpmcxx_tpu_torch import runner as runner_t
    logs = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        write_inputs(d, hist=False)
        with open("run.in", "a") as f:
            f.write("energy_output rdrv.energy.dat\nparallel_tempering on\n"
                    "max_temperature 300\nptemp_freq 3\n")
        if pkg == "jax":
            runner_j.run_input_file("run.in", quiet=True)
        else:
            sim = runner_t.make_simulation(read_t("run.in"), quiet=True,
                                           device="cpu")
            assert type(sim) is runner_t.Simulation
            runner_t.run_input_file("run.in", quiet=True, device="cpu")
        logs[pkg] = (d / "rdrv.energy.dat").read_bytes()
        assert os.path.exists(d / "rdrv.restart.pqr")
    assert logs["torch"] == logs["jax"]
    rows = logs["torch"].decode().splitlines()[1:]
    assert [float(r.split()[-1]) for r in rows] == [140.0] * 3


def test_mesh_and_missing_cuda_raise(tmp_path, monkeypatch):
    """A CUDA replica run without CUDA raises instead of falling back to
    the CPU, with or without a mesh (the mesh runs themselves are in
    tests/test_torch_mesh.py)."""
    monkeypatch.chdir(tmp_path)
    write_inputs(tmp_path, hist=False)
    cfg = read_t("run.in")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RepSim_t(cfg, 2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        RepSim_t(cfg, 2, device="cuda", mesh=rep_t.make_mesh(
            devices=["cuda:0"] * 2))
