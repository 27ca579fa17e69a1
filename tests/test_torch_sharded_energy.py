"""The port's mesh-sharded full energy (parallel/sharded_energy.py) and the
row-sharded flagship chain against the JAX package on the same seeded
inputs: twins of tests/test_sharded_energy.py.

Each energy case runs the JAX ``sharded_breakdown`` on its 8-device
virtual CPU mesh (tests/conftest.py) and the port's on a mesh of 8 ``cpu``
entries, and holds the port to both the JAX result and its own unsharded
``energy_breakdown_blocked`` (or dense ``energy_breakdown``): a twin that
only compares with JAX copies its faults.  Tolerances:
- rd and coulombic 1e-9 absolute, as the twin's, or 1e-14 relative where
  that is larger (the seeded system overlaps atoms: its rd is 3.4e10 K,
  where one ulp is 4e-6 K, so another summation order moves it by a few
  ulps);
- polarization 1e-6 relative against JAX (f32 planes summed in another
  order) and 1e-12 against the port's own blocked path (the plain
  contraction sums each row in the same order whatever the slice);
- the many-body terms 1e-9 relative.
The flagship chain (CO2 and H2 reduced as the twin reduces them) holds
the port's row-sharded run bitwise to its one-device run, and to the JAX
mesh run's moves and accepts with energies within 1e-6."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpmcxx_tpu import FFlags as FFlags_j  # noqa: E402
from mpmcxx_tpu import RunParams as RunParams_j  # noqa: E402
from mpmcxx_tpu.parallel import replicas as rep_j  # noqa: E402
from mpmcxx_tpu.parallel.sharded_energy import \
    sharded_breakdown as sharded_j  # noqa: E402
from mpmcxx_tpu_torch.flags import FFlags, RunParams  # noqa: E402
from mpmcxx_tpu_torch.mc import chain as chain_t  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_polar  # noqa: E402
from mpmcxx_tpu_torch.ops import polar_cache as pc_t  # noqa: E402
from mpmcxx_tpu_torch.ops.energy import (energy_breakdown,  # noqa: E402
                                         energy_breakdown_blocked)
from mpmcxx_tpu_torch.parallel import meshing  # noqa: E402
from mpmcxx_tpu_torch.parallel.sharded_energy import \
    sharded_breakdown  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax  # noqa: E402
from test_sharded_energy import system  # noqa: E402

import torch_co2_system as co2  # noqa: E402

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-virtual-device CPU mesh")

BLOCK = 16
MESH = meshing.make_mesh(devices=["cpu"] * 8, axis="replica")

POLAR = dict(polarization=True, polar_iterative=True, polar_ewald=True,
             polar_mixed=True, polar_max_iter=12)
POLAR_PARAMS = dict(temperature=140.0, ewald_alpha=3.5 / 12.0,
                    polar_ewald_alpha=3.5 / 12.0, polar_damp=2.1304,
                    polar_gamma=1.0)
POLAR_WOLF = dict(polarization=True, polar_iterative=True, polar_wolf=True,
                  polar_mixed=True, wolf=True, polar_max_iter=10)
POLAR_WOLF_PARAMS = dict(temperature=140.0, ewald_alpha=0.25,
                         polar_wolf_alpha=0.2, polar_damp=2.1304,
                         polar_gamma=1.0)


def _port_state(sj):
    return state_from_jax(co2.jax_state_numpy(sj), device="cpu")


def _both(sj, flags, params, dense=False):
    """(JAX sharded, port sharded, port unsharded) of one state."""
    mesh_j = rep_j.make_mesh(8)
    fj, pj = FFlags_j(**flags), RunParams_j(**params)
    a_j = jax.jit(lambda s: sharded_j(s, fj, pj, mesh_j, block=BLOCK))(sj)
    st = _port_state(sj)
    ft, pt = FFlags(**flags), RunParams(**params)
    got = sharded_breakdown(st, ft, pt, MESH, block=BLOCK)
    own = (energy_breakdown if dense else energy_breakdown_blocked)(
        st, ft, pt)
    return a_j, got, own


def _pair_terms(a_j, got, own):
    for comp in ("rd", "coulombic"):
        for want in (a_j, own):
            assert float(getattr(got, comp)) == pytest.approx(
                float(getattr(want, comp)), abs=1e-9, rel=1e-14)


def test_lj_ewald_matches_blocked():
    sj, _ = system()
    a_j, got, own = _both(sj, {}, dict(temperature=140.0,
                                       ewald_alpha=3.5 / 12.0))
    _pair_terms(a_j, got, own)
    assert float(got.polarization) == 0.0


@pytest.mark.parametrize("flags,params", [(POLAR, POLAR_PARAMS),
                                          (POLAR_WOLF, POLAR_WOLF_PARAMS)],
                         ids=["polarizable_mixed", "polar_wolf"])
def test_polarizable_matches_blocked_mixed(flags, params, monkeypatch):
    """The row-sharded mixed SCF (twins of test_polarizable_matches_blocked
    _mixed and test_polar_wolf_sharded): one K1 plain contraction per
    shard with rows per SCF iteration."""
    calls = []
    real = cuda_polar.contract_planes

    def counted(planes, mu, l=0.0):
        calls.append(tuple(planes[0].shape))
        return real(planes, mu, l)

    monkeypatch.setattr(cuda_polar, "contract_planes", counted)
    sj, _ = system(polar=True)
    a_j, got, own = _both(sj, flags, params)
    _pair_terms(a_j, got, own)
    assert float(got.polarization) == pytest.approx(
        float(a_j.polarization), rel=1e-6)
    assert float(got.polarization) == pytest.approx(
        float(own.polarization), rel=1e-12)
    assert float(got.total) == pytest.approx(float(a_j.total), rel=1e-9)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(a_j.mu),
                               rtol=1e-5, atol=1e-6)
    # 80 atoms over 8 shards of 16-row tiles: 5 shards hold rows
    A = sj.n_atom_slots
    shards = [c for c in calls if c[0] != A]
    assert shards and all(c[1] == A for c in shards)
    assert len(shards) % 5 == 0


def test_wolf_and_sg():
    sj, _ = system()
    params = dict(temperature=140.0, ewald_alpha=0.3)
    for fl in (dict(wolf=True), dict(use_sg=True)):
        a_j, got, own = _both(sj, fl, params)
        _pair_terms(a_j, got, own)


def test_polarvdw_matches_dense():
    sj, _ = system(n_mol=10, polar=True)
    sj = sj.replace(omega=jnp.where(sj.atom_alive(), 0.6, 0.0))
    flags = dict(POLAR, polarvdw=True, polar_max_iter=10)
    a_j, got, own = _both(sj, flags, POLAR_PARAMS, dense=True)
    assert float(got.vdw) == pytest.approx(float(a_j.vdw), rel=1e-9,
                                           abs=1e-9)
    assert float(got.vdw) == pytest.approx(float(own.vdw), rel=1e-9,
                                           abs=1e-9)
    _pair_terms(a_j, got, own)


def test_axilrod_teller_matches_dense():
    sj, _ = system(n_mol=8)
    sj = sj.replace(polarizability=jnp.where(sj.atom_alive(), 1.642, 0.0),
                    c9=jnp.where(sj.atom_alive(), 518.3, 0.0))
    a_j, got, own = _both(sj, dict(using_axilrod_teller=True),
                          dict(temperature=140.0, ewald_alpha=3.5 / 12.0),
                          dense=True)
    assert float(got.three_body) != 0.0
    assert float(got.three_body) == pytest.approx(float(a_j.three_body),
                                                  rel=1e-9)
    assert float(got.three_body) == pytest.approx(float(own.three_body),
                                                  rel=1e-9)


def test_unsupported_flags_still_raise():
    sj, _ = system(n_mol=4)
    st = _port_state(sj)
    params = RunParams(temperature=140.0)
    for fl in (FFlags(rd_crystal=True), FFlags(gwp=True),
               FFlags(spectre=True), FFlags(rd_anharmonic=True),
               FFlags(polarization=True, polar_mixed=False),
               FFlags(polarization=True, polar_mixed=True,
                      polar_ewald_full=True)):
        with pytest.raises(ValueError):
            sharded_breakdown(st, fl, params, MESH, block=BLOCK)
    with pytest.raises(ValueError, match="axis"):
        sharded_breakdown(st, FFlags(), params, MESH, axis="atoms")


def test_many_body_cap_raises():
    """polarvdw and Axilrod-Teller replicate dense tensors: above 4,096
    slots the twin's ValueError, before any work."""
    big = type("Big", (), {"n_atom_slots": 4097})()
    for fl in (FFlags(polarvdw=True), FFlags(using_axilrod_teller=True)):
        with pytest.raises(ValueError, match="4096"):
            sharded_breakdown(big, fl, RunParams(), MESH)


# --- the flagship chain, row-sharded ---------------------------------------

def _reduced_flagship(model):
    import flagship
    orig = (flagship.G_FRAME, flagship.N_CO2, flagship.N_H2)
    flagship.G_FRAME, flagship.N_CO2, flagship.N_H2 = 4, 40, 40
    try:
        builder = {"co2": flagship.build_state_co2,
                   "h2": flagship.build_state_h2}[model]
        return builder(extra_mol_capacity=8)
    finally:
        flagship.G_FRAME, flagship.N_CO2, flagship.N_H2 = orig


@pytest.mark.parametrize("model", ["co2", "h2"])
def test_trajectory_identical_to_single_device(model):
    """32 flagship moves with the planes row-sharded over 8 shards
    (shard_chain_carry of the one-device initial carry, as the twin
    places its carry): positions, mol_alive and accepts bitwise the
    one-device run's, the energy to the twin's rel=1e-8 (here exact), the
    committed planes bitwise; the moves and accepts of the JAX mesh run,
    its energy within 1e-6 (f32 SCF planes summed in another order)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mpmcxx_tpu.mc import chain as chain_j
    from mpmcxx_tpu.state import topology as topology_j
    from mpmcxx_tpu_torch.state import topology as topology_t

    sj, _, fj, pj, oj = _reduced_flagship(model)
    A = sj.n_atom_slots
    assert A % 8 == 0
    mesh_j = rep_j.make_mesh(8)
    carry_j = chain_j.init_carry(sj, fj, pj, oj, seed=0)
    row, repl = NamedSharding(mesh_j, P("replica", None)), \
        NamedSharding(mesh_j, P())
    carry_j = jax.tree_util.tree_map_with_path(
        lambda p, x: jax.device_put(
            x, row if "pcache" in "/".join(str(q) for q in p) and
            x.ndim == 2 and x.shape[0] == A else repl), carry_j)
    c_j, outs_j = chain_j.make_chunk_runner(fj, pj, oj, 32,
                                            topology=topology_j(sj))(carry_j)

    st = _port_state(sj)
    ft, pt = FFlags(**dataclasses.asdict(fj)), \
        RunParams(**dataclasses.asdict(pj))
    names = {f.name for f in dataclasses.fields(chain_t.MCOptions)}
    ot = chain_t.MCOptions(**{k: v for k, v in dataclasses.asdict(oj).items()
                              if k in names})
    carry = chain_t.init_carry(st, ft, pt, ot, seed=0)
    carry_s = meshing.shard_chain_carry(carry, MESH)
    assert [p.shape for p in carry_s.pcache.dx.parts] == [(A // 8, A)] * 8
    runner = chain_t.make_chunk_runner(ft, pt, ot, 32,
                                       topology=topology_t(st))
    c2, outs2 = runner(carry_s)
    c1, outs1 = runner(carry)

    assert torch.equal(c1.state.pos, c2.state.pos)
    assert torch.equal(c1.state.mol_alive, c2.state.mol_alive)
    assert torch.equal(c1.stats.accept, c2.stats.accept)
    assert float(c1.obs.N) == float(c2.obs.N)
    assert float(c2.obs.energy) == pytest.approx(float(c1.obs.energy),
                                                 rel=1e-8, abs=1e-5)
    for a, b in zip(pc_t.planes_of(c1.pcache), pc_t.planes_of(c2.pcache)):
        assert torch.equal(a, b.full())

    assert outs2.movetype.tolist() == np.asarray(outs_j.movetype).tolist()
    assert outs2.accepted.tolist() == np.asarray(outs_j.accepted).tolist()
    assert sum(outs2.accepted.tolist()) > 0
    np.testing.assert_array_equal(c2.stats.accept.numpy(),
                                  np.asarray(c_j.stats.accept))
    assert float(c2.obs.energy) == pytest.approx(float(c_j.obs.energy),
                                                 rel=1e-6)
