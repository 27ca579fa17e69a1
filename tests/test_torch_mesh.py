"""The port's mesh of devices (parallel/meshing.py) and its ``mesh=`` entry
points against the JAX package on the same seeded inputs.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py), the
port on a ``Mesh`` of 8 (or 4) ``cpu`` entries; no process is spawned.

- The mesh itself: ``make_mesh`` (a CUDA mesh without CUDA raises), the
  leader-side ``psum`` and row gather, the balance helpers against the
  twin's, the twin's ValueErrors (A % n, P % n).
- Kernel K2's row-slice mode on the CPU: the plain version on [A/n, A]
  slices bitwise equal to the matching rows of the full-plane plain
  version, for n = 2, 4, 8, windows at 0, inside one shard, straddling a
  shard boundary and at A - S, S = 1, 3, 5, all-valid and partly valid;
  the window rows of a row-sharded plane and the sharded contraction
  bitwise their whole-plane counterparts.
- Twins of tests/test_multichip_drivers.py: ``PISimulation(mesh=...)``
  (4 Ar atoms x 8 beads on 8 shards, per-bead restarts and the resume),
  ``Simulation(mesh=...)`` (the polarizable uVT run on 8 shards, shard
  shapes and ``plane_row_balance``) and its ValueError without the polar
  cache; each port mesh run bitwise its one-device run in positions,
  mol_alive and accepts, its energy within the twin's rel=1e-8 (here
  exact), and the JAX mesh run's moves and accepts with energies within
  1e-9 relative (1e-6 where an f32 SCF lies on the path, as the
  chain-vs-JAX tests).
- A twin of test_gibbs_replicas.py::TestReplicas::test_replica_runner_on
  _mesh: 4 NVT argon replicas on a 4-shard mesh, equal to the same
  replicas with no mesh and to the JAX mesh run; ``ReplicaSimulation``
  on a mesh writes the energy log of the run with none.
- The sharded chain's other rebuilds (a corrtime refresh through the
  sharded energy, NPT volume moves) bitwise its one-device chain's."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu.config.parser import read_config as read_j  # noqa: E402
from mpmcxx_tpu.parallel import meshing as meshing_j  # noqa: E402
from mpmcxx_tpu_torch import constants as const  # noqa: E402
from mpmcxx_tpu_torch.config.parser import read_config as read_t  # noqa: E402
from mpmcxx_tpu_torch.flags import FFlags, RunParams  # noqa: E402
from mpmcxx_tpu_torch.mc import chain as chain_t  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_polar  # noqa: E402
from mpmcxx_tpu_torch.ops import polar as polar_t  # noqa: E402
from mpmcxx_tpu_torch.ops import polar_cache as pc_t  # noqa: E402
from mpmcxx_tpu_torch.ops.pairwise import slice_rows  # noqa: E402
from mpmcxx_tpu_torch.parallel import meshing  # noqa: E402
from mpmcxx_tpu_torch.parallel import replicas as rep_t  # noqa: E402
from mpmcxx_tpu_torch.state import topology  # noqa: E402
from test_multichip_drivers import (PI_INPUT, UVT_INPUT,  # noqa: E402
                                    _write_ar_pqr)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-virtual-device CPU mesh")


def cpu_mesh(n=8, axis="shard"):
    return meshing.make_mesh(devices=["cpu"] * n, axis=axis)


# --- the mesh ---------------------------------------------------------------

def test_make_mesh_and_collectives(monkeypatch):
    mesh = meshing.make_mesh(3, axis="atoms", devices=["cpu"] * 8)
    assert mesh.size == 3 and mesh.shape == {"atoms": 3}
    assert mesh.leader == torch.device("cpu")
    parts = [torch.tensor(x, dtype=torch.float64)
             for x in (1e16, 1.0, -1e16)]
    # shard order: (1e16 + 1) - 1e16 == 0 in float64
    assert float(meshing.psum(parts, mesh)) == 0.0
    rows = [torch.full((2, 3), float(d)) for d in range(3)]
    assert meshing.gather_rows(rows, mesh)[:, 0].tolist() == \
        [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        meshing.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        meshing.make_mesh(devices=["cuda:0"] * 4)
    with pytest.raises(ValueError):
        meshing.make_mesh(devices=["meta"])


def test_balance_matches_jax():
    state, *_ = co2.torch_system(model="h2")
    sj, *_ = co2.jax_system(model="h2")
    for n in (2, 4, 8):
        np.testing.assert_array_equal(
            meshing.plane_row_balance(state, n),
            meshing_j.plane_row_balance(sj, n))
    for P, n in ((8, 8), (16, 4), (6, 4)):
        np.testing.assert_array_equal(meshing.bead_balance(P, n),
                                      meshing_j.bead_balance(P, n))


def test_shard_carry_value_errors():
    """The twin's ValueErrors: n must divide A (planes) and P (beads)."""
    state, _, flags, params, opts = co2.torch_system(model="ar")
    carry = chain_t.init_carry(state, flags, params, opts, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        meshing.shard_chain_carry(carry, cpu_mesh(3))
    with pytest.raises(ValueError, match="not divisible"):
        pc_t.cache_init(state, flags, params, mesh=cpu_mesh(6))
    with pytest.raises(ValueError, match="Trotter number 6"):
        meshing.shard_pi_carry(carry, cpu_mesh(4), 6)
    sharded = meshing.shard_chain_carry(carry, cpu_mesh(8))
    assert meshing.shard_chain_carry(sharded, cpu_mesh(8)) is sharded
    # the carry passed in keeps planes of its own
    assert carry.pcache.dx.data_ptr() not in [
        p.data_ptr() for p in sharded.pcache.dx.parts]


# --- K2's row-slice mode and the sharded planes -----------------------------

A_SLICE = 96


def _window_starts(n, S):
    R = A_SLICE // n
    return sorted({0, R + 1, R - S // 2 - 1 if S > 1 else R - 1,
                   A_SLICE - S})


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("S", [1, 3, 5])
@pytest.mark.parametrize("valid", ["all", "partly"])
def test_write_plane_strips_row_slices_bitwise(n, S, valid):
    """K2's plain version on each shard's [A/n, A] slices (row0 = its
    first row) equals the full-plane plain version's rows bitwise, at
    window starts 0, inside one shard, straddling a shard boundary and
    A - S, with 3 planes and mixed signs."""
    rng = np.random.default_rng(n * 10 + S)
    A = A_SLICE
    R = A // n
    for start in _window_starts(n, S):
        full = tuple(torch.from_numpy(rng.normal(size=(A, A)).astype(
            np.float32)) for _ in range(3))
        rows = tuple(torch.from_numpy(rng.normal(size=(S, A)).astype(
            np.float32)) for _ in range(3))
        ok = np.ones(S, bool) if valid == "all" else np.arange(S) % 2 == 0
        st = torch.tensor(start)
        blend, cols = pc_t.commit_strips(full, rows, st, torch.from_numpy(ok),
                                         (1.0, -1.0, -1.0))
        parts = [tuple(p[d * R:(d + 1) * R].clone() for p in full)
                 for d in range(n)]
        want = tuple(p.clone() for p in full)
        cuda_polar.write_plane_strips(want, blend, cols, st)
        for d, part in enumerate(parts):
            cuda_polar.write_plane_strips(part, blend, cols, st, row0=d * R)
        for p, w in enumerate(want):
            got = torch.cat([part[p] for part in parts])
            assert torch.equal(got, w), (start, p)
        straddles = start // R != (start + S - 1) // R
        if start == R - S // 2 - 1 and S > 1:
            assert straddles


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_commit_window_rows_and_contraction(n):
    """The sharded contraction equals the whole planes' K1 plain version
    bitwise (and the JAX package's contract_mixed on its XLA branch within
    1e-6), the window rows of the sharded planes equal slice_rows at every
    start, and write_symmetric_rows on row-sharded planes equals it on the
    whole planes (one plain K2 per shard)."""
    import jax.numpy as jnp
    from mpmcxx_tpu.ops import polar as polar_j
    from test_torch_cuda_kernels import _planes
    A = A_SLICE
    mesh = cpu_mesh(n)
    rng = np.random.default_rng(n)
    full = _planes(A, 3, n, "cpu")      # distances of 1-12 A
    sharded = tuple(meshing.RowShards.split(p, mesh) for p in full)
    mu = torch.from_numpy(rng.normal(size=(A, 3)))
    got = polar_t.contract_mixed(sharded, mu, l=2.1304)
    assert torch.equal(got, cuda_polar.contract_planes_plain(full, mu,
                                                             2.1304))
    want = polar_j.contract_mixed(tuple(jnp.asarray(p.numpy())
                                        for p in full),
                                  jnp.asarray(mu.numpy()), l=2.1304)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    for start in range(0, A - 2):
        st = torch.tensor(start)
        for p, s in zip(full, sharded):
            assert torch.equal(slice_rows(p, st, 3), s.window_rows(st, 3))
    rows = tuple(torch.from_numpy(rng.normal(size=(3, A)).astype(
        np.float32)) for _ in range(3))
    st = torch.tensor(A // n - 1)
    valid = torch.tensor([True, False, True])
    pc_t.write_symmetric_rows(full, rows, st, valid, -1.0)
    pc_t.write_symmetric_rows(sharded, rows, st, valid, -1.0)
    for p, s in zip(full, sharded):
        assert torch.equal(p, s.full())


@pytest.mark.parametrize("model,n", [("co2", 2), ("h2", 8), ("ar", 4)])
def test_sharded_cache_init_bitwise(model, n):
    """Each shard's cache_init rows (built on its own, in unpadded tiles)
    equal the one-device build's bitwise, planes and static field, where
    a shard's live rows end within a tile of A (the CO2 shape's 134 slots
    on 2 shards: rows 67-133)."""
    state, _, flags, params, _ = co2.torch_system(model=model)
    full = pc_t.cache_init(state, flags, params)
    sharded = pc_t.cache_init(state, flags, params, mesh=cpu_mesh(n))
    A = state.n_atom_slots
    for a, b in zip(pc_t.planes_of(full), pc_t.planes_of(sharded)):
        assert [tuple(p.shape) for p in b.parts] == [(A // n, A)] * n
        assert torch.equal(a, b.full())
    for f in ("e_pair", "cosp", "sinp", "f1", "f2"):
        assert torch.equal(getattr(full, f), getattr(sharded, f)), f


# --- twins of tests/test_multichip_drivers.py --------------------------------

def _pi_run(read, cls, mesh, **kw):
    sim = cls(read("run.in"), P=8, quiet=True, mesh=mesh, **kw)
    sim.run()
    return sim


def test_pi_bead_mesh_matches_single_device_and_restarts(tmp_path,
                                                         monkeypatch):
    from mpmcxx_tpu.mc.pi import PISimulation as PI_j
    from mpmcxx_tpu_torch.mc.pi import PISimulation, whole
    monkeypatch.chdir(tmp_path)
    _write_ar_pqr("ar.pqr", n=4)
    with open("run.in", "w") as f:
        f.write(PI_INPUT)

    ref = _pi_run(read_t, PISimulation, None, device="cpu")
    mesh = cpu_mesh(8, axis="bead")
    got = _pi_run(read_t, PISimulation, mesh, device="cpu")
    jx = _pi_run(read_j, PI_j, meshing_j.make_mesh(8, axis="bead"))

    # the carried bead stack is on the mesh, one bead per shard
    assert [p.pos.shape[0] for p in got.carry.stack.parts] == [1] * 8
    assert (meshing.bead_balance(8, 8) == 1).all()

    final = whole(got.carry.stack)
    assert torch.equal(ref.carry.stack.pos, final.pos)
    assert torch.equal(ref.carry.accept, got.carry.accept)
    assert float(got.carry.potential_current) == pytest.approx(
        float(ref.carry.potential_current), rel=1e-10, abs=1e-8)
    # the JAX mesh run's moves and energies
    np.testing.assert_array_equal(got.carry.accept.numpy(),
                                  np.asarray(jx.carry.accept))
    np.testing.assert_allclose(final.pos.numpy(),
                               np.asarray(jx.carry.stack.pos), rtol=0,
                               atol=1e-9)
    assert float(got.carry.potential_current) == pytest.approx(
        float(jx.carry.potential_current), rel=1e-9)

    for s in range(8):
        assert os.path.exists(f"piar.restart-{s:04d}.pqr")
    cfg = read_t("run.in")
    cfg.parallel_restarts = True
    resumed = PISimulation(cfg, P=8, quiet=True, mesh=mesh, device="cpu")
    np.testing.assert_allclose(resumed.stack.pos.numpy(), final.pos.numpy(),
                               atol=5e-4)   # PQR %8.3f quantum
    with pytest.raises(ValueError, match="Trotter number 8"):
        PISimulation(read_t("run.in"), P=8, mesh=cpu_mesh(3), device="cpu")


def _uvt_run(read, cls, mesh, **kw):
    sim = cls(read("run.in"), quiet=True, mesh=mesh, **kw)
    assert sim.opts.polar_incremental
    sim.run()
    return sim


def test_chain_plane_mesh_matches_single_device(tmp_path, monkeypatch):
    from mpmcxx_tpu.runner import Simulation as Sim_j
    from mpmcxx_tpu_torch.runner import Simulation
    monkeypatch.chdir(tmp_path)
    _write_ar_pqr("ar.pqr", n=8, charged=True, alpha=1.64)
    with open("run.in", "w") as f:
        f.write(UVT_INPUT)
    ref = _uvt_run(read_t, Simulation, None, device="cpu")
    mesh = cpu_mesh(8, axis="atoms")
    got = _uvt_run(read_t, Simulation, mesh, device="cpu")
    jx = _uvt_run(read_j, Sim_j, meshing_j.make_mesh(8, axis="atoms"))

    A = got.state.n_atom_slots
    assert A % 8 == 0
    # the planes are row-sharded on the mesh after the full run
    assert [tuple(p.shape) for p in got.carry.pcache.dx.parts] == \
        [(A // 8, A)] * 8
    assert torch.equal(ref.carry.state.pos, got.carry.state.pos)
    assert torch.equal(ref.carry.state.mol_alive, got.carry.state.mol_alive)
    assert torch.equal(ref.carry.stats.accept, got.carry.stats.accept)
    assert float(got.carry.obs.energy) == pytest.approx(
        float(ref.carry.obs.energy), rel=1e-8, abs=1e-5)
    for a, b in zip(pc_t.planes_of(ref.carry.pcache),
                    pc_t.planes_of(got.carry.pcache)):
        assert torch.equal(a, b.full())

    np.testing.assert_array_equal(got.carry.stats.accept.numpy(),
                                  np.asarray(jx.carry.stats.accept))
    np.testing.assert_array_equal(got.carry.state.mol_alive.numpy(),
                                  np.asarray(jx.carry.state.mol_alive))
    np.testing.assert_allclose(got.carry.state.pos.numpy(),
                               np.asarray(jx.carry.state.pos), rtol=0,
                               atol=1e-9)
    assert float(got.carry.obs.energy) == pytest.approx(
        float(jx.carry.obs.energy), rel=1e-6)

    bal = meshing.plane_row_balance(got.carry.state, 8)
    assert bal.sum() == int(got.carry.state.atom_alive().sum())
    assert bal.max() <= -(-A // 8)
    np.testing.assert_array_equal(
        bal, meshing_j.plane_row_balance(jx.carry.state, 8))
    with pytest.raises(ValueError, match="not divisible"):
        Simulation(read_t("run.in"), quiet=True, device="cpu",
                   mesh=cpu_mesh(7))
    with pytest.raises(ValueError, match="mesh led by cpu"):
        Simulation(read_t("run.in"), quiet=True, mesh=mesh)


def test_mesh_requires_polar_incremental(tmp_path, monkeypatch):
    from mpmcxx_tpu_torch.runner import Simulation
    monkeypatch.chdir(tmp_path)
    _write_ar_pqr("ar.pqr", n=8)
    plain = UVT_INPUT
    for line in ("polarization on", "polar_iterative on", "polar_max_iter 4",
                 "polar_damp_type exponential", "polar_damp 2.1304",
                 "polar_mixed on", "polar_ewald on"):
        plain = plain.replace(line + "\n", "")
    with open("run.in", "w") as f:
        f.write(plain)
    with pytest.raises(ValueError, match="polar-incremental"):
        Simulation(read_t("run.in"), quiet=True, device="cpu",
                   mesh=cpu_mesh(8))


# --- replicas on a mesh ----------------------------------------------------

def test_replica_runner_on_mesh():
    """4 NVT argon replicas on a 4-shard mesh: equal to the same replicas
    with no mesh (bitwise) and to the JAX mesh run (energies 1e-9)."""
    from test_gibbs_replicas import argon_box
    from test_torch_replicas import _argon_box
    from mpmcxx_tpu import FFlags as FFlags_j, RunParams as RunParams_j
    from mpmcxx_tpu.mc import chain as chain_j
    from mpmcxx_tpu.parallel import replicas as rep_j

    state, _ = _argon_box(8, 20.0)
    flags, params = FFlags(), RunParams(temperature=130.0)
    opts = chain_t.MCOptions(ensemble=const.ENSEMBLE_NVT, move_factor=0.1,
                             numsteps=10)
    carry = chain_t.init_carry(state, flags, params, opts, seed=0)
    mesh = rep_t.make_mesh(devices=["cpu"] * 4)
    assert mesh.axis == "replica"
    got, outs = rep_t.make_replica_runner(flags, params, opts, 10,
                                          mesh=mesh)(
        rep_t.replicate_carry(carry, 4, base_seed=1))
    ref, _ = rep_t.make_replica_runner(flags, params, opts, 10)(
        rep_t.replicate_carry(carry, 4, base_seed=1))
    energies = np.array([float(c.obs.energy) for c in got])
    assert energies.shape == (4,) and np.all(np.isfinite(energies))
    for a, b in zip(got, ref):
        assert torch.equal(a.state.pos, b.state.pos)
        assert float(a.obs.energy) == float(b.obs.energy)

    sj, _ = argon_box(8, 20.0)
    opts_j = chain_j.MCOptions(ensemble=const.ENSEMBLE_NVT, move_factor=0.1,
                               numsteps=10)
    pj = RunParams_j(temperature=130.0)
    cj = chain_j.init_carry(sj, FFlags_j(), pj, opts_j, seed=0)
    out_j, outs_j = rep_j.make_replica_runner(
        FFlags_j(), pj, opts_j, 10, mesh=rep_j.make_mesh(4))(
        rep_j.replicate_carry(cj, 4, base_seed=1))
    np.testing.assert_allclose(energies, np.asarray(out_j.obs.energy),
                               rtol=1e-9)
    assert [o.accepted.tolist() for o in outs] == \
        np.asarray(outs_j.accepted).tolist()
    with pytest.raises(ValueError, match="axis"):
        rep_t.make_replica_runner(flags, params, opts, 10, mesh=mesh,
                                  axis="shard")


def test_replica_simulation_on_mesh(tmp_path, monkeypatch):
    """ReplicaSimulation on a 2-shard CPU mesh writes the energy log, the
    restarts and the final temperatures of the run with no mesh."""
    from mpmcxx_tpu_torch.parallel.driver import ReplicaSimulation
    from test_replica_driver import write_inputs
    logs = {}
    for name, mesh in (("ref", None), ("mesh", rep_t.make_mesh(
            devices=["cpu"] * 2))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        write_inputs(d, hist=False)
        with open("run.in", "a") as f:
            f.write("energy_output rdrv.energy.dat\n")
        sim = ReplicaSimulation(read_t("run.in"), 3, quiet=True,
                                device="cpu", mesh=mesh)
        assert sim.mesh is mesh
        sim.run()
        logs[name] = ((d / "rdrv.energy.dat").read_bytes(),
                      (d / "rdrv.restart-0002.pqr").read_bytes())
    assert logs["mesh"] == logs["ref"]


# --- the sharded chain's rebuilds ------------------------------------------

@pytest.mark.parametrize("ensemble", ["uvt", "npt"])
def test_sharded_rebuilds_bitwise(ensemble):
    """On the H2 shape (768 slots, blocked energy) row-sharded over 8
    shards: a chunk then a refresh (the sharded blocked energy and each
    shard's cache_init) in uVT, or NPT with volume moves (a sharded
    rebuild selected shard by shard), bitwise the one-device chain's."""
    state, _, flags, params, opts = co2.torch_system(model="h2")
    if ensemble == "npt":
        params = dataclasses.replace(params, pressure=50.0)
        opts = dataclasses.replace(
            opts, ensemble=const.ENSEMBLE_NPT, volume_probability=0.3,
            volume_change_factor=0.05)
    mesh = cpu_mesh(8)
    runner = chain_t.make_chunk_runner(flags, params, opts, 8,
                                       topology=topology(state))
    refresh = chain_t.make_refresher(flags, params, opts)
    out = {}
    for name, m in (("ref", None), ("mesh", mesh)):
        carry = chain_t.init_carry(state, flags, params, opts, seed=2,
                                   mesh=m)
        carry, outs = runner(carry)
        carry = refresh(carry)
        out[name] = (carry, outs)
    (c1, o1), (c2, o2) = out["ref"], out["mesh"]
    if ensemble == "npt":
        assert bool((o1.movetype == const.MOVETYPE_VOLUME).any())
    assert torch.equal(o1.accepted, o2.accepted)
    assert torch.equal(c1.state.pos, c2.state.pos)
    assert torch.equal(c1.state.pbc.basis, c2.state.pbc.basis)
    for f in ("energy", "rd_energy", "coulombic_energy",
              "polarization_energy"):
        assert float(getattr(c1.obs, f)) == float(getattr(c2.obs, f))
    assert meshing.mesh_of(c2.pcache) == mesh
    for a, b in zip(pc_t.planes_of(c1.pcache), pc_t.planes_of(c2.pcache)):
        assert [tuple(p.shape) for p in b.parts] == [(96, 768)] * 8
        assert torch.equal(a, b.full())
    assert torch.equal(c1.pcache.e_pair, c2.pcache.e_pair)
