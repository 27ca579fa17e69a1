"""The port's state, full energy and polarization cache against the JAX
package on a small CO2-flagship-shaped system (tests/torch_co2_system.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu.mc import moves as moves_j  # noqa: E402
from mpmcxx_tpu.ops import polar_cache as pc_j  # noqa: E402
from mpmcxx_tpu.ops.energy import energy_breakdown_blocked as eb_j  # noqa
from mpmcxx_tpu_torch.ops import polar_cache as pc_t  # noqa: E402
from mpmcxx_tpu_torch.ops.energy import \
    energy_breakdown_blocked as eb_t  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax  # noqa: E402


@pytest.fixture(scope="module")
def systems():
    return co2.jax_system(), co2.torch_system()


def test_build_state_fields_equal(systems):
    (sj, mj, *_), (st, mt, *_) = systems
    assert mj == mt
    for f in dataclasses.fields(sj):
        if f.name == "pbc":
            for k in ("basis", "reciprocal", "volume", "cutoff"):
                np.testing.assert_allclose(
                    getattr(st.pbc, k).numpy(),
                    np.asarray(getattr(sj.pbc, k)), rtol=1e-15, err_msg=k)
            continue
        np.testing.assert_array_equal(getattr(st, f.name).numpy(),
                                      np.asarray(getattr(sj, f.name)),
                                      err_msg=f.name)


def test_energy_breakdown_blocked_matches(systems):
    (sj, _, fj, pj, _), (st, _, ft, pt, _) = systems
    a, b = eb_j(sj, fj, pj), eb_t(st, ft, pt)
    for name in ("rd", "coulombic"):
        assert float(getattr(b, name)) == pytest.approx(
            float(getattr(a, name)), rel=1e-9)
    # f32 coefficient planes, sums in another order
    assert float(b.polarization) == pytest.approx(float(a.polarization),
                                                  rel=2e-6)
    np.testing.assert_allclose(b.mu.numpy(), np.asarray(a.mu), rtol=1e-4,
                               atol=1e-5)


def _rows(state_j, mol):
    starts = np.asarray(jnp.nonzero(state_j.mol_id == mol)[0])
    return np.asarray(starts[:3] if len(starts) >= 3 else starts)


def _moves(sj):
    """(kind, new JAX state, rows) for a displace, a removal and an
    insertion of the small system's CO2 molecules."""
    key = jax.random.PRNGKey(4)
    r1 = jnp.asarray(_rows(sj, 1), jnp.int32)
    disp = moves_j.displace_rows(sj, key, r1, r1 >= 0, 0.1, 1.0)
    r6 = jnp.asarray(_rows(sj, 6), jnp.int32)
    rem = moves_j.remove(sj, jnp.asarray(6))
    slot = int(moves_j.find_dead_slot(sj, sj.mol_type[2]))
    rs = jnp.asarray(_rows(sj, slot), jnp.int32)
    r2 = jnp.asarray(_rows(sj, 2), jnp.int32)
    ins, valid = moves_j.insert_rows(sj, key, r2, rs, r2 >= 0,
                                     jnp.asarray(slot), jnp.asarray(True))
    assert bool(valid)
    return [("displace", disp, r1), ("remove", rem, r6), ("insert", ins, rs)]


def _cache_close(got: pc_t.PolarCache, want, msg=""):
    for name in ("dx", "dy", "dz", "cosp", "sinp"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, err_msg=msg + name)
    for name in ("e_pair", "f1", "f2"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=msg + name)


def test_cache_init_matches(systems):
    (sj, _, fj, pj, _), (st, _, ft, pt, _) = systems
    _cache_close(pc_t.cache_init(st, ft, pt), pc_j.cache_init(sj, fj, pj))


def test_proposal_matches_materialized_cache(systems):
    """Twin of test_polar_cache.py::test_proposal_matches_materialized_cache:
    the port's read-only proposal agrees with the JAX proposal and with a
    solve on the JAX cache_move'd cache, for displace/remove/insert."""
    (sj, _, fj, pj, _), (st, _, ft, pt, _) = systems
    cache_j = pc_j.cache_init(sj, fj, pj)
    cache_t = pc_t.cache_init(st, ft, pt)
    for kind, nj, rows in _moves(sj):
        nt = state_from_jax(co2.jax_state_numpy(nj))
        got = pc_t.polar_proposal(cache_t, st, nt, torch.from_numpy(
            np.asarray(rows, np.int64)), ft, pt)
        want = pc_j.polar_proposal(cache_j, sj, nj, rows, fj, pj)
        mat = pc_j.polar_from_cache(
            nj, pc_j.cache_move(cache_j, sj, nj, rows, fj, pj), fj, pj)
        for ref in (want, mat):
            assert float(got.energy) == pytest.approx(float(ref.energy),
                                                      rel=1e-6), kind


def test_cache_commit_matches_cache_move_and_rejects_noop(systems):
    """Twin of test_polar_cache.py::test_cache_commit_matches_cache_move_
    and_rejects_noop: the port's in-place commit of an accepted proposal
    equals the JAX cache_move/cache_commit caches; a rejected commit leaves
    every field bitwise as it was."""
    (sj, _, fj, pj, _), (st, _, ft, pt, _) = systems
    cache_j = pc_j.cache_init(sj, fj, pj)
    for kind, nj, rows in _moves(sj):
        nt = state_from_jax(co2.jax_state_numpy(nj))
        rows_t = torch.from_numpy(np.asarray(rows, np.int64))
        cache_t = pc_t.cache_init(st, ft, pt)
        _, cdata = pc_t.polar_proposal(cache_t, st, nt, rows_t, ft, pt,
                                       with_commit=True)
        before = {f.name: getattr(cache_t, f.name).clone()
                  for f in dataclasses.fields(cache_t)}
        pc_t.cache_commit(cache_t, torch.tensor(False), cdata, ft)
        for name, t in before.items():
            assert torch.equal(getattr(cache_t, name), t), (kind, name)

        pc_t.cache_commit(cache_t, torch.tensor(True), cdata, ft)
        moved = pc_j.cache_move(cache_j, sj, nj, rows, fj, pj)
        _, cd_j = pc_j.polar_proposal(cache_j, sj, nj, rows, fj, pj,
                                      with_commit=True)
        committed = pc_j.cache_commit(cache_j, jnp.asarray(True), cd_j, fj)
        _cache_close(cache_t, moved, kind + ":")
        _cache_close(cache_t, committed, kind + ":")
        # and the commit equals a rebuild of the moved state in the port
        _cache_close(cache_t, pc_t.cache_init(nt, ft, pt), kind + ":")


@pytest.mark.parametrize("relax", [{}, {"polar_sor": True},
                                   {"polar_esor": True}])
def test_thole_iterative_matches(systems, relax):
    """The fixed-iteration solve (Jacobi, SOR, ESOR relaxation) on the
    same static field and the same linear contraction."""
    from mpmcxx_tpu.ops import polar as polar_j
    from mpmcxx_tpu_torch.ops import polar as polar_t
    (sj, _, fj, pj, _), (st, _, ft, pt, _) = systems
    A = st.n_atom_slots
    rng = np.random.default_rng(5)
    E = rng.normal(size=(A, 3))
    M = rng.normal(size=(A, A)) * 0.01
    got = polar_t.thole_iterative(
        st, torch.from_numpy(E), ft.replace(**relax),
        pt.replace(polar_gamma=0.8), lambda m: -torch.from_numpy(M) @ m)
    want = polar_j.thole_iterative(
        sj, None, jnp.asarray(E), fj.replace(**relax),
        pj.replace(polar_gamma=0.8), contract_fn=lambda m: -jnp.asarray(M) @ m)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12, atol=1e-14)
    assert float(got[1]) == float(want[1])
    assert bool(got[2]) == bool(want[2])
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-10)
