"""The polar solvers, static fields and Thole dampings through the JAX
package and the port on the same inputs.

- A small system (8 frozen charged framework sites, 10 CO2, 2 dead
  molecule slots; 44 atom slots) under every SCF setting: precision
  termination (Jacobi, SOR, ESOR), a fixed count above 16, sequential
  and ranked Gauss-Seidel (fixed and precision-terminated), Palmo,
  ZODID, the warm start, the exact solve, the no-PBC and Wolf fields
  (alpha = 0 and 0.2), polar_wolf_full, linear and no damping, the
  full-Ewald SCF and the divergence fallback:
  - the dense ``polar`` within 1e-10 relative (energy, mu, dipole rrms),
    equal iteration counts and failure flags;
  - ``polar_blocked`` in 16-row tiles in float64 (1e-10) and on the f32
    planes of polar_mixed (1e-5; the divergent setting excluded);
- the polar cache in plane modes 3, 4 and 5 and under the no-PBC and
  Wolf fields (no k-space): ``cache_init`` and ``polar_proposal`` of a
  displacement, a removal and an insertion against the JAX package's
  (1e-5 on the f32 planes, equal iteration counts); a sequence of
  accepted and rejected commits leaves the planes bitwise those of a
  fresh ``cache_init``; ``max_slots`` counts the mode's planes;
- the sequential Gauss-Seidel iterates at K = 1-4 and ``gs_rank_order``
  (twins of tests/test_polar_gs_iterates.py's sequential cases);
- the grouped device loop at group size 1 and at LOOP_GROUP, bitwise;
  ``cg_solve`` against ``jax.scipy.sparse.linalg.cg`` on a seeded SPD
  matrix (the same step count, x within 1e-12);
- four chains step for step against the JAX chain (2 x 16 moves, a
  refresh after each chunk): uVT on the cache with precision + Palmo,
  with linear damping and with polar_wolf_full; NVT on the dense path
  with ranked Gauss-Seidel;
- the JAX package's polar_ewald_full fault: its blocked energy solves on
  the no-PBC field (the polar_nopbc golden's value), where the port
  routes the blocked call dense;
- the polarizability-tensor report and printer, and the CLI's analysis
  mode, against the polar_tensor golden;
- the many-body vdW term's A matrix under linear damping and
  polar_wolf_full.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu import constants as const  # noqa: E402
from mpmcxx_tpu.mc import chain as chain_j  # noqa: E402
from mpmcxx_tpu.mc import moves as moves_j  # noqa: E402
from mpmcxx_tpu.ops import energy as energy_j  # noqa: E402
from mpmcxx_tpu.ops import pairwise as pairwise_j  # noqa: E402
from mpmcxx_tpu.ops import polar as polar_j  # noqa: E402
from mpmcxx_tpu.ops import polar_cache as pc_j  # noqa: E402
from mpmcxx_tpu.state import AtomRecord as AtomRecord_j  # noqa: E402
from mpmcxx_tpu.state import build_state as build_state_j  # noqa: E402
from mpmcxx_tpu.state import topology as topology_j  # noqa: E402
from mpmcxx_tpu_torch import flags as flags_t  # noqa: E402
from mpmcxx_tpu_torch.mc import chain as chain_t  # noqa: E402
from mpmcxx_tpu_torch.ops import energy as energy_t  # noqa: E402
from mpmcxx_tpu_torch.ops import pairwise as pairwise_t  # noqa: E402
from mpmcxx_tpu_torch.ops import polar as polar_t  # noqa: E402
from mpmcxx_tpu_torch.ops import polar_cache as pc_t  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax  # noqa: E402
from mpmcxx_tpu_torch.state import topology as topology_t  # noqa: E402

REL = 1e-10
F32 = 1e-5
L = 18.0
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
P8 = dict(polar_precision=1e-8)
WOLF = dict(polar_ewald=False, polar_wolf=True)
# setting -> (FFlags kwargs, RunParams kwargs)
SETTINGS = {
    "precision": ({}, P8),
    "sor": (dict(polar_sor=True), dict(polar_precision=1e-8,
                                       polar_gamma=0.8)),
    "esor": (dict(polar_esor=True), dict(polar_precision=1e-8,
                                         polar_gamma=0.9)),
    "max_iter_24": (dict(polar_max_iter=24), {}),
    "gs": (dict(polar_gs=True), dict(polar_precision=1e-10)),
    "gs_ranked": (dict(polar_gs_ranked=True), dict(polar_precision=1e-10)),
    "gs_ranked_fixed": (dict(polar_gs_ranked=True, polar_max_iter=3), {}),
    "palmo": (dict(polar_palmo=True), P8),
    "zodid": (dict(polar_zodid=True), {}),
    "warm_start": (dict(polar_warm_start=True), P8),
    "exact": (dict(polar_iterative=False), {}),
    "exact_palmo": (dict(polar_iterative=False, polar_palmo=True), {}),
    "nopbc": (dict(polar_ewald=False), P8),
    "wolf": (WOLF, dict(polar_precision=1e-8, polar_wolf_alpha=0.2)),
    "wolf_a0": (WOLF, P8),
    "wolf_full": (dict(polar_wolf_full=True, **WOLF),
                  dict(polar_precision=1e-8, polar_wolf_alpha=0.2)),
    "linear": (dict(damp_type=const.DAMPING_LINEAR), P8),
    "damp_off": (dict(damp_type=const.DAMPING_OFF), P8),
    "plane_mode_4": (dict(polar_plane_mode=4), P8),
    "ewald_full": (dict(polar_ewald_full=True, polar_ewald=False), P8),
    "ewald_full_palmo": (dict(polar_ewald_full=True, polar_ewald=False,
                              polar_palmo=True), P8),
    # SOR past 2 diverges: no iteration meets the precision
    "diverge": (dict(polar_sor=True), dict(polar_precision=1e-8,
                                           polar_gamma=2.5)),
}
# the full-Ewald SCF is dense-only in the port (flags.dense_only)
BLOCKED = [s for s in SETTINGS if not s.startswith("ewald_full")]
MIXED = [s for s in BLOCKED if s != "diverge"]


def _records():
    return co2.records(seed=5, box=L, n_mol=10, g=3)


def _pair(fkw, pkw, recs=None, extra=2, mixed=False, mu_seed=None):
    """(JAX state, flags, params), (port state, flags, params) of the
    small system, polarization on with the settings ``fkw``/``pkw``;
    ``mu_seed`` puts seeded dipoles on both states (zero where dead)."""
    sj = build_state_j([AtomRecord_j(**r) for r in recs or _records()],
                       np.eye(3) * L, extra_mol_capacity=extra)[0]
    if mu_seed is not None:
        alive = np.asarray(sj.atom_alive())[:, None]
        mu = np.random.default_rng(mu_seed).normal(
            0.0, 0.05, (sj.n_atom_slots, 3)) * alive
        sj = sj.replace(mu=jnp.asarray(mu))
    st = state_from_jax(co2.jax_state_numpy(sj))
    out = []
    for sys_ in (co2.jax_system(), co2.torch_system()):
        flags, params = sys_[2], sys_[3]
        out.append((flags.replace(polar_mixed=mixed, **fkw),
                    dataclasses.replace(params, **pkw)))
    return (sj,) + tuple(out[0]), (st,) + tuple(out[1])


def _setting(name, **kw):
    fkw, pkw = SETTINGS[name]
    return _pair(fkw, pkw, mu_seed=7 if name == "warm_start" else None,
                 **kw)


def _same_result(rt, rj, rel, name=""):
    """energy and mu within ``rel``; the dipole rrms, a mean relative
    change of mu that cancels near convergence, within ``rel`` absolute;
    iterations and the failure flag equal."""
    e_j = float(rj.energy)
    assert float(rt.energy) == pytest.approx(e_j, rel=rel), name
    mu_j = np.asarray(rj.mu)
    scale = float(np.abs(mu_j).max())
    assert float(np.abs(rt.mu.numpy() - mu_j).max()) <= rel * scale, name
    assert float(rt.iterations) == float(rj.iterations), name
    assert bool(rt.iterator_failed) == bool(rj.iterator_failed), name
    assert float(rt.dipole_rrms) == pytest.approx(
        float(rj.dipole_rrms), rel=1e-8, abs=rel), name


# --- dense, blocked and mixed solves --------------------------------------

@pytest.mark.parametrize("name", list(SETTINGS))
def test_polar_dense_matches_jax(name):
    (sj, fj, pj), (st, ft, pt) = _setting(name)
    rj = polar_j.polar(sj, pairwise_j.build_pairs(sj, fj), fj, pj)
    rt = polar_t.polar(st, pairwise_t.build_pairs(st, ft), ft, pt)
    _same_result(rt, rj, REL, name)
    assert float(rt.energy) < 0.0 or name == "diverge"
    if pt.polar_precision > 0.0:
        want_fail = name == "diverge"
        assert bool(rt.iterator_failed) == want_fail
        assert (float(rt.iterations) == const.MAX_ITERATION_COUNT) == \
            want_fail
    if name == "diverge":
        # the fallback: mu = alpha * E_static at the live atoms
        E = polar_t.thole_field(st, pairwise_t.build_pairs(st, ft), ft, pt)
        np.testing.assert_array_equal(
            rt.mu.numpy(), (st.polarizability[:, None] * E).numpy())


@pytest.mark.parametrize("name", BLOCKED)
def test_polar_blocked_f64_matches_jax(name):
    """16-row tiles over 44 slots; GS runs Jacobi here in both packages
    (no A matrix), the exact solve is CG."""
    (sj, fj, pj), (st, ft, pt) = _setting(name)
    rj = polar_j.polar_blocked(sj, fj, pj, block=16)
    rt = polar_t.polar_blocked(st, ft, pt, block=16)
    _same_result(rt, rj, REL, name)


@pytest.mark.parametrize("name", MIXED)
def test_polar_blocked_mixed_matches_jax(name):
    """The f32 planes of polar_mixed at precision 1e-5 Debye (1e-8 is
    below what f32 contractions resolve)."""
    fkw, pkw = SETTINGS[name]
    if pkw.get("polar_precision"):
        pkw = dict(pkw, polar_precision=1e-5)
    (sj, fj, pj), (st, ft, pt) = _pair(
        fkw, pkw, mixed=True, mu_seed=7 if name == "warm_start" else None)
    rj = polar_j.polar_blocked(sj, fj, pj, block=16)
    rt = polar_t.polar_blocked(st, ft, pt, block=16)
    _same_result(rt, rj, F32, name)
    assert not bool(rt.iterator_failed)


def test_polarvdw_amatrix_takes_every_damping():
    """The many-body vdW term reads the Thole A matrix under linear
    damping and polar_wolf_full, with and without polarization."""
    recs = _records()
    for r in recs:
        r.update(omega=1.1)
    for fkw in (dict(damp_type=const.DAMPING_LINEAR),
                dict(polar_wolf_full=True, **WOLF),
                dict(damp_type=const.DAMPING_OFF, polarization=False)):
        (sj, fj, pj), (st, ft, pt) = _pair(dict(polarvdw=True, **fkw), P8,
                                           recs=recs)
        ej = energy_j.energy_breakdown(sj, fj, pj)
        et = energy_t.energy_breakdown(st, ft, pt)
        for comp in ("vdw", "polarization", "total"):
            assert float(getattr(et, comp)) == pytest.approx(
                float(getattr(ej, comp)), rel=REL, abs=1e-300), comp
        assert float(et.vdw) != 0.0


# --- Gauss-Seidel iterates ------------------------------------------------

def _gs_system():
    """The 12-atom system of tests/test_polar_gs_iterates.py."""
    rng = np.random.default_rng(11)
    recs, m = [], 0
    for i in range(3):
        for j in range(2):
            for k in range(2):
                m += 1
                x, y, z = (np.array([i, j, k]) * 3.4 - 2.5 +
                           rng.uniform(-0.3, 0.3, 3))
                q = 0.3 if m % 2 else -0.3
                recs.append(dict(
                    atomtype="X", moleculetype="MOL", molecule_id=m, x=x,
                    y=y, z=z, mass=20.0, charge=q * const.E2REDUCED,
                    epsilon=30.0, sigma=2.9, polarizability=1.2))
    sj = build_state_j([AtomRecord_j(**r) for r in recs],
                       np.eye(3) * 40.0)[0]
    return sj, state_from_jax(co2.jax_state_numpy(sj))


@pytest.mark.parametrize("ranked", [False, True], ids=["gs", "gs_ranked"])
def test_gs_iterates_match_jax(ranked):
    """The port's sequential sweeps at K = 1-4 against the JAX package's
    _gs_sweep (sweep 1 natural, later sweeps ranked), on the same A
    matrix and field; and gs_rank_order."""
    sj, st = _gs_system()
    fj = co2.jax_system()[2].replace(
        polar_ewald=True, polar_mixed=False, polar_gs=not ranked,
        polar_gs_ranked=ranked)
    ft = co2.torch_system()[2].replace(
        polar_ewald=True, polar_mixed=False, polar_gs=not ranked,
        polar_gs_ranked=ranked)
    pj = co2.jax_system()[3]
    pt = co2.torch_system()[3]
    pairs_j, pairs_t = pairwise_j.build_pairs(sj, fj), \
        pairwise_t.build_pairs(st, ft)
    Aj = polar_j.thole_amatrix(sj, pairs_j, fj, pj)
    Ej = polar_j.thole_field(sj, pairs_j, fj, pj)
    M = polar_t.contract_matrix(polar_t.thole_amatrix(st, pairs_t, ft, pt))
    Et = polar_t.thole_field(st, pairs_t, ft, pt)
    ro_j = polar_j.gs_rank_order(sj, pairs_j) if ranked else None
    ro_t = polar_t.gs_rank_order(st, pairs_t) if ranked else None
    if ranked:
        np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_j))
        assert not np.array_equal(ro_t.numpy(), np.arange(12))
    for k in (1, 2, 3, 4):
        want = polar_j.thole_iterative(
            sj, Aj, Ej, fj.replace(polar_max_iter=k), pj,
            rank_order=ro_j)[0]
        got = polar_t.thole_iterative(
            st, Et, ft.replace(polar_max_iter=k), pt, None, gs_matrix=M,
            rank_order=ro_t)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-15)


# --- the grouped loop and CG ----------------------------------------------

@pytest.mark.parametrize("name", ["precision", "gs_ranked", "diverge",
                                  "exact", "ewald_full"])
def test_grouped_loop_is_group_size_free(name, monkeypatch):
    """The solve at group size 1 (a host read after every iteration), at
    LOOP_GROUP and at 8 is bitwise the same: dense and, for the blocked
    CG, in row tiles."""
    _, (st, ft, pt) = _setting(name)

    def solve(group):
        monkeypatch.setattr(polar_t, "LOOP_GROUP", group)
        if name == "exact":
            return polar_t.polar_blocked(st, ft, pt, block=16)
        return polar_t.polar(st, pairwise_t.build_pairs(st, ft), ft, pt)

    want = solve(1)
    for group in {polar_t.LOOP_GROUP, 3, 8}:
        for x, y in zip(solve(group), want):
            assert torch.equal(x, y), group


def test_cg_matches_jax_cg():
    """cg_solve against jax.scipy.sparse.linalg.cg on a seeded SPD
    system: x within 1e-12, and the same step count k (the JAX solve
    capped at k gives its converged x bitwise, capped at k - 1 not)."""
    rng = np.random.default_rng(23)
    n = 48
    Q = rng.normal(size=(n, n))
    A = Q @ Q.T / n + np.diag(rng.uniform(0.5, 2.0, n))
    b = rng.normal(size=(n // 3, 3))
    At = torch.from_numpy(A)
    x, k = polar_t.cg_solve(lambda m: (At @ m.reshape(-1)).reshape(m.shape),
                            torch.from_numpy(b))
    k = int(k)
    Aj = jnp.asarray(A)

    def cg(maxiter):
        return np.asarray(jax.scipy.sparse.linalg.cg(
            lambda m: (Aj @ m.reshape(-1)).reshape(m.shape), jnp.asarray(b),
            tol=1e-12, maxiter=maxiter)[0])

    want = cg(400)
    assert 3 < k < 400
    np.testing.assert_allclose(x.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(cg(k), want)
    assert not np.array_equal(cg(k - 1), want)
    np.testing.assert_allclose(A @ x.numpy().reshape(-1), b.reshape(-1),
                               rtol=0, atol=1e-10)


# --- the polar cache ------------------------------------------------------

CACHE = {
    "mode3_nopbc": (dict(polar_ewald=False), {}),
    "mode4_linear": (dict(damp_type=const.DAMPING_LINEAR), {}),
    "mode4_off_nopbc": (dict(damp_type=const.DAMPING_OFF,
                             polar_ewald=False), {}),
    "mode4_forced": (dict(polar_plane_mode=4), {}),
    "mode5_wolf_full": (dict(polar_wolf_full=True, **WOLF),
                        dict(polar_wolf_alpha=0.2)),
    "mode3_wolf_palmo": (dict(polar_palmo=True, **WOLF),
                         dict(polar_wolf_alpha=0.2, polar_precision=1e-5)),
    "mode4_cg": (dict(damp_type=const.DAMPING_LINEAR,
                      polar_iterative=False), {}),
}


def _cache_pair(name):
    """The 134-slot CO2 system of tests/torch_co2_system.py under a
    cache setting, in both packages (f32 planes)."""
    fkw, pkw = CACHE[name]
    out = []
    for sys_ in (co2.jax_system(), co2.torch_system()):
        state, _, flags, params, _ = sys_
        out.append((state, flags.replace(**fkw),
                    dataclasses.replace(params, **pkw)))
    st = state_from_jax(co2.jax_state_numpy(out[0][0]))
    return out[0], (st,) + out[1][1:]


def _rows(state, mol, S=3):
    ms, mn = topology_j(state)
    s, n = int(ms[mol]), int(mn[mol])
    return np.array([s + i if i < n else -1 for i in range(S)], np.int64)


def _move(sj, kind):
    """(new JAX state, rows) of a displacement of molecule 1 or 3, the
    removal of molecule 6 or an insertion into a dead slot (molecule 2's
    geometry) of the small system's CO2."""
    key = jax.random.PRNGKey(4)
    if kind.startswith("displace"):
        r = jnp.asarray(_rows(sj, 3 if kind.endswith("2") else 1),
                        jnp.int32)
        return moves_j.displace_rows(sj, key, r, r >= 0, 0.1, 1.0), r
    if kind == "remove":
        return (moves_j.remove(sj, jnp.asarray(6)),
                jnp.asarray(_rows(sj, 6), jnp.int32))
    slot = int(moves_j.find_dead_slot(sj, sj.mol_type[2]))
    rs = jnp.asarray(_rows(sj, slot), jnp.int32)
    r2 = jnp.asarray(_rows(sj, 2), jnp.int32)
    ins, valid = moves_j.insert_rows(sj, key, r2, rs, r2 >= 0,
                                     jnp.asarray(slot), jnp.asarray(True))
    assert bool(valid)
    return ins, rs


SEQUENCE = [("displace", True), ("remove", False), ("insert", True),
            ("displace2", True)]


@pytest.mark.parametrize("name", list(CACHE))
def test_cache_matches_jax_and_commits_bitwise(name):
    """cache_init against the JAX package's; then a sequence of
    displacements, removals and insertions, accepted and rejected, each
    proposal (polar_proposal) against the JAX package's on its own
    carried cache, and the commits (cache_commit) leave every plane
    bitwise that of a fresh cache_init of the final state."""
    (sj, fj, pj), (st, ft, pt) = _cache_pair(name)
    mode = polar_t.plane_mode(ft)
    cache_t = pc_t.cache_init(st, ft, pt)
    cache_j = pc_j.cache_init(sj, fj, pj)
    planes_t, planes_j = pc_t.planes_of(cache_t), pc_j.planes_of(cache_j)
    assert len(planes_t) == len(planes_j) == mode
    for a, b in zip(planes_t, planes_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    assert cache_t.cosp.shape == tuple(cache_j.cosp.shape)
    assert (cache_t.cosp.shape[1] == 0) == (not ft.polar_ewald)
    np.testing.assert_allclose(cache_t.e_pair.numpy(),
                               np.asarray(cache_j.e_pair), rtol=1e-9,
                               atol=1e-9)
    for kind, accept in SEQUENCE:
        nj, rows = _move(sj, kind)
        cur_t = state_from_jax(co2.jax_state_numpy(sj))
        nt = state_from_jax(co2.jax_state_numpy(nj))
        rj, cd_j = pc_j.polar_proposal(cache_j, sj, nj, rows, fj, pj,
                                       with_commit=True)
        rt, cdata = pc_t.polar_proposal(
            cache_t, cur_t, nt, torch.from_numpy(np.asarray(rows, np.int64)),
            ft, pt, with_commit=True)
        _same_result(rt, rj, F32, kind)
        pc_t.cache_commit(cache_t, torch.tensor(accept), cdata, ft)
        cache_j = pc_j.cache_commit(cache_j, jnp.asarray(accept), cd_j, fj)
        if accept:
            sj = nj
    fresh = pc_t.cache_init(state_from_jax(co2.jax_state_numpy(sj)), ft, pt)
    for a, b in zip(pc_t.planes_of(cache_t), pc_t.planes_of(fresh)):
        assert torch.equal(a, b), name
    np.testing.assert_allclose(cache_t.e_pair.numpy(), fresh.e_pair.numpy(),
                               rtol=1e-9, atol=1e-9)
    for f in ("cosp", "sinp", "f1", "f2"):
        np.testing.assert_allclose(getattr(cache_t, f).numpy(),
                                   getattr(fresh, f).numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_max_slots_counts_planes(monkeypatch):
    """The cache's slot bound counts the mode's planes: a 5-plane cache
    at the bound stays within DEVICE_MEMORY_SHARE of the card."""
    class Props:
        total_memory = 80 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    caps = {n: pc_t.max_slots("cuda", n) for n in (3, 4, 5)}
    assert caps[3] > caps[4] > caps[5]
    for n, cap in caps.items():
        per = n * 4 * pc_t.PLANE_COPIES_AT_PEAK
        assert per * cap ** 2 <= pc_t.DEVICE_MEMORY_SHARE * \
            Props.total_memory < per * (cap + 1) ** 2
    base = co2.torch_system()[2]
    wolf_full = base.replace(polar_wolf_full=True, **WOLF)
    assert pc_t.supports(base, caps[5] + 1, "cuda")
    assert not pc_t.supports(wolf_full, caps[5] + 1, "cuda")
    assert pc_t.supports(wolf_full, caps[5], "cuda")
    assert not pc_t.supports(base.replace(polar_ewald_full=True), 100)


# --- chains ---------------------------------------------------------------

CHUNK, N_CHUNKS = 16, 2
CHAINS = {
    # FFlags kwargs, RunParams kwargs, MCOptions kwargs
    "uvt_precision_palmo": (dict(polar_palmo=True),
                            dict(polar_precision=1e-5), {}),
    "uvt_linear": (dict(damp_type=const.DAMPING_LINEAR), {}, {}),
    "uvt_wolf_full": (dict(polar_wolf_full=True, **WOLF),
                      dict(polar_wolf_alpha=0.2), {}),
    "nvt_gs_ranked": (dict(polar_gs_ranked=True, polar_mixed=False),
                      dict(polar_precision=1e-8),
                      dict(ensemble=const.ENSEMBLE_NVT, incremental=False,
                           polar_incremental=False)),
}


def _chain_case(system, name, state):
    _, _, flags, params, opts = system
    fkw, pkw, okw = CHAINS[name]
    return (state, flags.replace(**fkw), dataclasses.replace(params, **pkw),
            dataclasses.replace(opts, blocked_energy=False, **okw))


def _run(chain, topology, case):
    state, flags, params, opts = case
    carry = chain.init_carry(state, flags, params, opts, seed=2)
    runner = chain.make_chunk_runner(flags, params, opts, CHUNK,
                                     topology=topology(state))
    refresher = chain.make_refresher(flags, params, opts)
    rows, movetype, accepted, iters = [], [], [], []
    for _ in range(N_CHUNKS):
        carry, outs = runner(carry)
        inc = (float(carry.obs.energy), float(carry.obs.polarization_energy))
        carry = refresher(carry)
        rows.append(inc + (float(carry.obs.energy),
                           float(carry.obs.polarization_energy),
                           float(carry.obs.N)))
        movetype += [int(m) for m in np.asarray(outs.movetype)]
        accepted += [bool(a) for a in np.asarray(outs.accepted)]
        iters += [float(i) for i in np.asarray(outs.polarization_iterations)]
    return carry, rows, movetype, accepted, iters


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_matches_jax(name):
    sj = co2.jax_system()[0]
    st = state_from_jax(co2.jax_state_numpy(sj))
    cj, ej, mj, aj, ij = _run(chain_j, topology_j,
                              _chain_case(co2.jax_system(), name, sj))
    ct, et, mt, at, it = _run(chain_t, topology_t,
                              _chain_case(co2.torch_system(), name, st))
    assert mt == mj and at == aj
    assert it == ij
    assert 0 < sum(at) < len(at)
    if name.startswith("uvt"):
        assert {const.MOVETYPE_INSERT, const.MOVETYPE_REMOVE,
                const.MOVETYPE_DISPLACE} <= set(mt)
    rel = 1e-9 if name.startswith("nvt") else 1e-6
    for row_j, row_t in zip(ej, et):
        np.testing.assert_allclose(row_t, row_j, rtol=rel, atol=1e-9)
        # the carried polarization within 1e-5 of its refresh
        assert row_t[1] == pytest.approx(row_t[3], rel=1e-5)
    np.testing.assert_allclose(ct.state.pos.numpy(), np.asarray(cj.state.pos),
                               rtol=0, atol=1e-9)
    if ct.pcache is not None:
        fresh = pc_t.cache_init(ct.state, *_chain_case(
            co2.torch_system(), name, st)[1:3])
        for a, b in zip(pc_t.planes_of(ct.pcache), pc_t.planes_of(fresh)):
            assert torch.equal(a, b)


# --- the JAX package's polar_ewald_full fault ------------------------------

def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        return json.load(f)


def _golden_system(fix, pkg):
    """(state, flags, params) of a golden fixture in the JAX package
    (``pkg`` "jax") or the port, by the recipe of tests/test_golden.py."""
    if pkg == "jax":
        from mpmcxx_tpu.config.parser import parse_config
        from mpmcxx_tpu.state import AtomRecord, build_state
        dev = {}
    else:
        from mpmcxx_tpu_torch.config.parser import parse_config
        from mpmcxx_tpu_torch.state import AtomRecord, build_state
        dev = {"device": "cpu"}
    atoms = [AtomRecord(atomtype=at, moleculetype=mt, molecule_id=mid, x=x,
                        y=y, z=z, mass=mass, charge=q * const.E2REDUCED,
                        polarizability=al, epsilon=eps, sigma=sig, omega=om,
                        gwp_alpha=gw, c6=c6, c8=c8, c10=c10, c9=c9)
             for (at, mt, mid, x, y, z, mass, q, al, eps, sig, om, gw, c6,
                  c8, c10, c9) in fix["atoms"]]
    state = build_state(atoms, np.eye(3) * fix["basis"], **dev)[0]
    cfg = parse_config(fix["config_extra"])
    cfg.temperature = fix["temperature"]
    params = cfg.to_params()
    alpha = 3.5 / (fix["basis"] / 2.0)
    if not cfg.ewald_alpha_set:
        params = dataclasses.replace(params, ewald_alpha=alpha)
    if not cfg.polar_ewald_alpha_set:
        params = dataclasses.replace(params, polar_ewald_alpha=alpha)
    return state, cfg.to_flags(), params


def test_jax_blocked_ewald_full_fault():
    """The JAX package's energy_breakdown_blocked never reads
    polar_ewald_full and solves on the no-PBC field (the polar_nopbc
    golden's -72.08 K), where its dense energy gives the golden plus its
    known_delta (-68.77 K); the port routes the blocked call dense, so
    both of its calls give the golden."""
    fix = _golden("polar_ewald_full")
    want = fix["expected"]["polar"] + fix["known_delta"]["polar"]
    sj, fj, pj = _golden_system(fix, "jax")
    st, ft, pt = _golden_system(fix, "torch")
    dense_j = float(energy_j.energy_breakdown(sj, fj, pj).polarization)
    blocked_j = float(energy_j.energy_breakdown_blocked(sj, fj, pj)
                      .polarization)
    nopbc = _golden("polar_nopbc")["expected"]["polar"]
    assert dense_j == pytest.approx(want, abs=2e-6)
    assert dense_j == pytest.approx(-68.771, abs=1e-3)
    assert blocked_j == pytest.approx(nopbc, abs=2e-6)
    assert blocked_j == pytest.approx(-72.083, abs=1e-3)
    dense_t = energy_t.energy_breakdown(st, ft, pt)
    blocked_t = energy_t.energy_breakdown_blocked(st, ft, pt)
    assert float(blocked_t.polarization) == float(dense_t.polarization)
    assert float(dense_t.polarization) == pytest.approx(want, abs=2e-6)
    assert flags_t.dense_only(ft)


# --- the polarizability tensor --------------------------------------------

def test_polarizability_tensor_matches_golden():
    """Twin of tests/test_golden.py::test_polarizability_tensor: the
    port's report and printer against the reference's printout, and the
    JAX package's report."""
    fix = _golden("polar_tensor")
    st, ft, pt = _golden_system(fix, "torch")
    sj, fj, pj = _golden_system(fix, "jax")
    A_t, B_t, C, iso = polar_t.polarizability_tensor_report(st, ft, pt)
    A_j, B_j, C_j, iso_j = polar_j.polarizability_tensor_report(sj, fj, pj)
    np.testing.assert_allclose(A_t, A_j, rtol=1e-12)
    np.testing.assert_allclose(C, C_j, rtol=1e-10)
    want = np.asarray(fix["expected"]["tensor"])
    assert np.max(np.abs(C - want)) < 2e-4
    assert abs(iso - fix["expected"]["isotropic"]) < 2e-4
    buf, buf_j = io.StringIO(), io.StringIO()
    polar_t.print_polarizability_tensor(st, ft, pt, buf)
    polar_j.print_polarizability_tensor(sj, fj, pj, buf_j)
    assert buf.getvalue() == buf_j.getvalue()
    assert f"isotropic = {fix['expected']['isotropic']:.4f}" in buf.getvalue()


def test_cli_prints_the_tensor_and_ends(tmp_path):
    """``polarizability_tensor on`` with ``polar_iterative off`` through
    the port's CLI: the tensor block and no Monte Carlo step."""
    from mpmcxx_tpu_torch import cli
    fix = _golden("polar_tensor")
    recs = [dict(atomtype=at, moleculetype=mt, molecule_id=mid, x=x, y=y,
                 z=z, mass=mass, charge=q * const.E2REDUCED,
                 polarizability=al, epsilon=eps, sigma=sig)
            for (at, mt, mid, x, y, z, mass, q, al, eps, sig, *_)
            in fix["atoms"]]
    co2.write_pqr(str(tmp_path / "in.pqr"), recs)
    b = fix["basis"]
    (tmp_path / "run.in").write_text(
        f"job_name tensor\nensemble nvt\ntemperature {fix['temperature']}\n"
        f"numsteps 10\ncorrtime 5\nmove_factor 0.5\nrot_factor 1.0\n"
        f"insert_probability 0.0\nbasis1 {b} 0 0\nbasis2 0 {b} 0\n"
        f"basis3 0 0 {b}\npqr_input in.pqr\npqr_output /dev/null\n"
        f"pqr_restart /dev/null\nenergy_output /dev/null\n"
        + fix["config_extra"])
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--device", "cpu", "run.in"])
    finally:
        os.chdir(cwd)
    text = out.getvalue()
    assert rc in (0, None)
    assert "POLARIZATION: polarizability tensor (A^3):" in text
    assert f"isotropic = {fix['expected']['isotropic']:.4f}" in text
