"""The port's path-integral NVT against mpmcxx_tpu.mc.pi on the CPU, on
bead stacks built from seeded numpy inputs (no file outside the repo).

- Twins of TestPI's test_coker_staging_preserves_com,
  test_orientation_schedule_covers_all_beads and
  test_sampled_orientations_unit.
- coker_stage_coms, sample_orientations, pi_displace, pi_perturb_beads,
  pi_kinetic and the chain lengths against the JAX functions on the same
  keys: within 1e-12 (1e-9 after the bisection sampler's arccos).
- Step for step, the JAX ``make_pi_step`` under ``lax.scan`` and the
  port's chunk runner: equal move and accept sequences, counts, Coker
  anchors; positions and energies within 1e-9.  Chains: an argon stack
  at P = 4 (incremental LJ/Ewald branch), a two-site species with
  orientation data (the bisection staging), a tiny polarizable stack
  (per-bead full recompute with the dense float64 SCF), and simulated
  annealing, linear and geometric (the temperature after every step
  equal to JAX's within 1e-12).
- PIFrameWriter's file byte for byte as JAX's on the same stack.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu import FFlags, RunParams  # noqa: E402
from mpmcxx_tpu import constants as const  # noqa: E402
from mpmcxx_tpu.io.trajectory import PIFrameWriter as Frames_j  # noqa: E402
from mpmcxx_tpu.mc import pi as pi_j  # noqa: E402
from mpmcxx_tpu.state import AtomRecord, build_state  # noqa: E402
from mpmcxx_tpu_torch import flags as flags_t  # noqa: E402
from mpmcxx_tpu_torch import random as rnd  # noqa: E402
from mpmcxx_tpu_torch.io.trajectory import \
    PIFrameWriter as Frames_t  # noqa: E402
from mpmcxx_tpu_torch.mc import pi as pi_t  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax, topology  # noqa: E402

E2REDUCED = 408.7816
H2_BOND = 0.742
H2_REDUCED_MASS_KG = 8.368618e-28


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _records(kind, n_mol, L, seed):
    """AtomRecord kwargs of ``n_mol`` molecules on a jittered lattice:
    argon, a two-site H2 (sites at +-bond/2 along a random axis, LJ on
    both) or a polarizable charged two-site molecule."""
    rng = np.random.default_rng(seed)
    g = int(np.ceil(n_mol ** (1 / 3)))
    s = L / g
    out = []
    for m in range(n_mol):
        i, j, k = m // (g * g), (m // g) % g, m % g
        c = np.array([i + .5, j + .5, k + .5]) * s - L / 2 + \
            rng.uniform(-0.3, 0.3, 3)
        if kind == "ar":
            out.append(dict(atomtype="Ar", moleculetype="Ar",
                            molecule_id=m + 1, x=c[0], y=c[1], z=c[2],
                            mass=39.948, epsilon=119.8, sigma=3.405))
            continue
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        for a, sign in enumerate((1.0, -1.0)):
            p = c + sign * 0.5 * (H2_BOND if kind == "h2" else 1.1) * u
            if kind == "h2":
                out.append(dict(atomtype="H", moleculetype="H2",
                                molecule_id=m + 1, x=p[0], y=p[1], z=p[2],
                                mass=1.008, epsilon=17.0, sigma=2.7))
            else:
                out.append(dict(atomtype="X", moleculetype="MOL",
                                molecule_id=m + 1, x=p[0], y=p[1], z=p[2],
                                mass=16.0, polarizability=0.7,
                                charge=E2REDUCED * 0.2 * sign,
                                epsilon=80.0, sigma=3.1))
    return out


def stacks(kind="ar", P=4, n_mol=6, L=12.0, seed=0, jitter=0.08):
    """(JAX stack, port stack, meta): P copies of one seeded geometry, each
    bead's molecules shifted rigidly by its own seeded offsets."""
    recs = _records(kind, n_mol, L, seed)
    rng = np.random.default_rng(seed + 100)
    states = []
    for _ in range(P):
        shift = rng.normal(0.0, jitter, (n_mol, 3))
        atoms = []
        for r in recs:
            d = shift[r["molecule_id"] - 1]
            atoms.append(AtomRecord(**dict(r, x=r["x"] + d[0],
                                           y=r["y"] + d[1],
                                           z=r["z"] + d[2])))
        st, meta = build_state(atoms, np.eye(3) * L)
        states.append(st)
    sj = pi_j.stack_states(states)
    st = pi_t.stack_states([state_from_jax(co2.jax_state_numpy(s))
                            for s in states])
    return sj, st, meta


# --- the twins of TestPI -------------------------------------------------

def test_coker_staging_preserves_com():
    coms = rnd.normal(rnd.PRNGKey(7), (8, 3)) * 0.3
    normals = rnd.normal(rnd.split(rnd.PRNGKey(7), 4), (3,))
    new = pi_t.coker_stage_coms(coms, normals, 4, 2, 39.948, 2.0, 8)
    np.testing.assert_allclose(new.mean(0).numpy(), coms.mean(0).numpy(),
                               atol=1e-12)
    delta = (new - coms).numpy()
    moved = np.abs(delta - delta[2]).sum(axis=1) > 1e-10
    assert moved.sum() == 4


def test_orientation_schedule_covers_all_beads():
    for P in (4, 8, 16):
        sched = pi_t._orientation_schedule(P)
        assert sched == pi_j._orientation_schedule(P)
        assert {0} | {J for (_, J, _, _) in sched} == set(range(P))


def _orientation_draws(key, P):
    """sample_orientations' draws of the twin's key."""
    k0, ks = rnd.split(key, 2)
    kcb = rnd.split(rnd.split(ks, len(pi_t._orientation_schedule(P))), 2)
    return rnd.normal(k0, (3,)), rnd.uniform(kcb[:, 0]), \
        rnd.uniform(kcb[:, 1])


def test_sampled_orientations_unit():
    o = pi_t.sample_orientations(*_orientation_draws(rnd.PRNGKey(0), 8), 8,
                                 0.742e-10, 8.368618e-28, 10.0)
    np.testing.assert_allclose(torch.linalg.norm(o, dim=1).numpy(), 1.0,
                               rtol=1e-9)


# --- functions on the same keys -------------------------------------------

def test_coker_and_orientations_match_jax():
    key = jax.random.PRNGKey(11)
    coms = np.random.default_rng(1).normal(0.0, 0.3, (8, 3))
    want = pi_j.coker_stage_coms(jnp.asarray(coms), key, 5, 6, 2.016, 25.0,
                                 8)
    got = pi_t.coker_stage_coms(
        _t(coms), rnd.normal(rnd.split(rnd.PRNGKey(11), 5), (3,)), 5, 6,
        2.016, 25.0, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    mu = H2_REDUCED_MASS_KG / const.AMU2KG
    for P in (4, 16):
        want = pi_j.sample_orientations(key, P, H2_BOND, mu, 20.0)
        got = pi_t.sample_orientations(
            *_orientation_draws(rnd.PRNGKey(11), P), P, H2_BOND, mu, 20.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-9)


def test_estimators_and_displace_match_jax():
    sj, st, _ = stacks("h2", P=8, n_mol=5, L=10.0, seed=3)
    for T in (2.0, 25.0):
        assert float(pi_t.pi_kinetic(st, T)) == pytest.approx(
            float(pi_j.pi_kinetic(sj, T)), rel=1e-12)
    assert float(pi_t.chain_mass_length2_system(st)) == pytest.approx(
        float(pi_j.chain_mass_length2_system(sj)), rel=1e-12)
    for mol in range(5):
        m = torch.tensor(mol)
        assert float(pi_t.chain_mass_length2_mol(st, m)) == pytest.approx(
            float(pi_j.chain_mass_length2_mol(sj, mol)), rel=1e-12)
        assert float(pi_t.orient_mu_length2_mol(
            st, m, torch.tensor(2 * mol + 1), H2_BOND)) == pytest.approx(
            float(pi_j.orient_mu_length2_mol(sj, mol, 2 * mol + 1,
                                             H2_BOND)), rel=1e-12)
    k3 = rnd.split(rnd.PRNGKey(4), 3)
    want = pi_j.pi_displace(sj, jax.random.PRNGKey(4), jnp.asarray(2), 0.3,
                            40.0)
    got = pi_t.pi_displace(st, rnd.uniform(k3[0], (6,)),
                           rnd.normal(k3[1], (3,)), rnd.uniform(k3[2]),
                           torch.tensor(2), 0.3, 40.0)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=0, atol=1e-12)
    # the perturbation with orientation staging (the twin's standalone
    # form, spec fixed on the host) and without
    mu = H2_REDUCED_MASS_KG / const.AMU2KG
    key = jax.random.PRNGKey(9)
    k_orient, k_com = rnd.split(rnd.PRNGKey(9), 2)
    normals = rnd.normal(rnd.split(k_com, 3), (3,))
    for orient in (False, True):
        spec = pi_j.PerturbSpec(orient, 1, H2_BOND, mu)
        want = pi_j.pi_perturb_beads(sj, key, 3, 3, 5, 20.0, spec, 6)
        o = (torch.tensor(True), torch.tensor(7),
             torch.tensor(H2_BOND, dtype=torch.float64),
             torch.tensor(mu, dtype=torch.float64),
             *_orientation_draws(k_orient, 8)) if orient else None
        got = pi_t.pi_perturb_beads(st, torch.tensor(3), normals, 3, 5,
                                    20.0, o)
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                                   rtol=0, atol=1e-9 if orient else 1e-12)


# --- chains ---------------------------------------------------------------

POLAR = dict(polarization=True, polar_iterative=True, polar_ewald=True,
             polar_max_iter=4, damp_type=const.DAMPING_EXPONENTIAL)

CHAINS = {
    # kind, stack kwargs, FFlags kw, RunParams kw, options kw, chain length,
    # moves, seed
    "argon": ("ar", dict(P=4), {}, dict(temperature=60.0),
              dict(move_factor=0.05, bead_perturb_probability=0.5), 2, 64,
              1),
    "h2_orientation": ("h2", dict(P=8, n_mol=5, L=10.0, seed=3), {},
                       dict(temperature=20.0),
                       dict(move_factor=0.05, rot_factor=30.0,
                            bead_perturb_probability=0.6), 3, 48, 2),
    "polar": ("polar", dict(P=4, n_mol=3, L=10.0, seed=5, jitter=0.03),
              POLAR, dict(temperature=120.0, ewald_alpha=0.7,
                          polar_ewald_alpha=0.7, polar_damp=2.1304),
              dict(move_factor=0.05, bead_perturb_probability=0.5), 2, 12,
              3),
    "anneal_linear": ("ar", dict(P=4), {}, dict(temperature=80.0),
                      dict(move_factor=0.05, bead_perturb_probability=0.5,
                           simulated_annealing=True,
                           simulated_annealing_linear=True,
                           simulated_annealing_target=30.0, numsteps=40),
                      2, 40, 4),
    "anneal_geometric": ("ar", dict(P=4), {}, dict(temperature=80.0),
                         dict(move_factor=0.05, bead_perturb_probability=0.5,
                              simulated_annealing=True,
                              simulated_annealing_schedule=0.97,
                              simulated_annealing_target=30.0, numsteps=40),
                         2, 40, 5),
}


def _specs(meta, orient, pkg):
    """Per-molecule-slot PerturbSpec of either package: the H2 species
    carries its orientation site (atom 1), bond length and reduced mass."""
    types = meta["moleculetypes"]
    has = [orient and t == "H2" for t in types]
    site = [1 if h else 0 for h in has]
    blen = [H2_BOND if h else 0.0 for h in has]
    rmass = [H2_REDUCED_MASS_KG / const.AMU2KG if h else 0.0 for h in has]
    if pkg == "jax":
        return pi_j.PerturbSpec(jnp.asarray(has), jnp.asarray(site,
                                                              jnp.int32),
                                jnp.asarray(blen), jnp.asarray(rmass))
    return pi_t.PerturbSpec(torch.tensor(has), torch.tensor(site),
                            torch.tensor(blen, dtype=torch.float64),
                            torch.tensor(rmass, dtype=torch.float64))


def _jax_chain(sj, meta, fkw, pkw, okw, n_chain, n, seed, orient):
    flags, params = FFlags(**fkw), RunParams(**pkw)
    opts = pi_j._PIOpts(**okw)
    mol_id = np.asarray(sj.mol_id[0])
    M = sj.mol_alive.shape[1]
    counts = np.bincount(mol_id, minlength=M)
    starts = np.array([np.nonzero(mol_id == m)[0][0] for m in range(M)],
                      np.int32)
    incremental = pi_j.delta_mod.supports(flags)
    step = pi_j.make_pi_step(flags, params, opts, _specs(meta, orient, "jax"),
                             jnp.asarray(starts), n_chain,
                             incremental=incremental,
                             max_mol_atoms=int(counts.max()),
                             any_orientation=orient, mol_atom_counts=counts)
    comps_pb, _ = pi_j.pi_potential_per_bead(sj, flags, params)
    comps = jnp.mean(comps_pb, axis=0)
    P = sj.pos.shape[0]
    sf = pi_j.pi_sf_compute(sj, flags, params) if incremental else \
        pi_j.delta_mod.SFCache(jnp.zeros((P, 0)), jnp.zeros((P, 0)))
    carry = pi_j.PICarry(
        sj, jnp.sum(comps), comps, comps_pb, sf,
        jnp.asarray(pkw["temperature"], jnp.float64),
        jax.random.PRNGKey(seed), jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int64), jnp.zeros(7, jnp.int64),
        jnp.zeros(7, jnp.int64), jnp.zeros(()))

    def body(c, x):
        c, out = step(c, x)
        return c, (out, c.temperature, c.starter_bead)

    carry, (outs, temps, starters) = jax.lax.scan(body, carry, None,
                                                  length=n)
    return carry, outs, np.asarray(temps), np.asarray(starters)


def _torch_chain(st, meta, fkw, pkw, okw, n_chain, n, seed, orient):
    flags, params = flags_t.FFlags(**fkw), flags_t.RunParams(**pkw)
    opts = pi_t.PIOptions(**okw)
    topo = topology(pi_t.bead(st, 0))
    incremental = pi_t.delta_mod.supports(flags)
    step = pi_t.make_pi_step(flags, params, opts, _specs(meta, orient, "t"),
                             n_chain, topo, incremental=incremental,
                             max_mol_atoms=int(topo[1].max()),
                             any_orientation=orient)
    temps, starters = [], []

    def logged(carry, d, perturb):
        carry, out = step(carry, d, perturb)
        temps.append(float(carry.temperature))
        starters.append(carry.starter_bead)
        return carry, out

    carry = pi_t.init_pi_carry(st, flags, params, pkw["temperature"],
                               rnd.PRNGKey(seed), incremental)
    runner = pi_t.make_pi_chunk_runner(logged, n, opts, n_chain, orient)
    carry, outs = runner(carry)
    return carry, outs, np.array(temps), np.array(starters), flags, params


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_matches_jax(name):
    kind, skw, fkw, pkw, okw, n_chain, n, seed = CHAINS[name]
    sj, st, meta = stacks(kind, **skw)
    orient = kind == "h2"
    cj, oj, tj, sj_start = _jax_chain(sj, meta, fkw, pkw, okw, n_chain, n,
                                      seed, orient)
    ct, ot, tt, st_start, flags, params = _torch_chain(
        st, meta, fkw, pkw, okw, n_chain, n, seed, orient)
    assert ot.movetype.tolist() == np.asarray(oj.movetype).tolist()
    assert ot.accepted.tolist() == np.asarray(oj.accepted).tolist()
    assert {const.MOVETYPE_DISPLACE, const.MOVETYPE_PERTURB_BEADS} == \
        set(ot.movetype.tolist())
    assert 0 < int(ot.accepted.sum()) < n
    np.testing.assert_array_equal(ct.accept.numpy(), np.asarray(cj.accept))
    np.testing.assert_array_equal(ct.reject.numpy(), np.asarray(cj.reject))
    assert st_start.tolist() == sj_start.tolist()
    np.testing.assert_allclose(tt, tj, rtol=1e-12)
    if okw.get("simulated_annealing"):
        assert tt[-1] < pkw["temperature"] and len(set(tt.tolist())) > 2
    tol = 1e-8 if orient else 1e-9
    np.testing.assert_allclose(ct.stack.pos.numpy(), np.asarray(cj.stack.pos),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(ct.comps_per_bead.numpy(),
                               np.asarray(cj.comps_per_bead), rtol=tol,
                               atol=tol)
    assert float(ct.potential_current) == pytest.approx(
        float(cj.potential_current), rel=tol)
    np.testing.assert_allclose(ot.boltzmann_factor.numpy(),
                               np.asarray(oj.bf), rtol=1e-7)
    if pi_t.delta_mod.supports(flags):
        # the carried per-bead energies against a full recompute
        full, _ = pi_t.pi_potential_per_bead(ct.stack, flags, params)
        np.testing.assert_allclose(ct.comps_per_bead.numpy(), full.numpy(),
                                   rtol=1e-9, atol=1e-9)


def test_frame_writer_matches_jax(tmp_path):
    sj, st, meta = stacks("h2", P=4, n_mol=3, L=9.0, seed=6)
    fj, ft = Frames_j(str(tmp_path / "j.xyz")), Frames_t(
        str(tmp_path / "t.xyz"))
    for _ in range(2):
        fj.write(sj, meta)
        ft.write(st, meta)
    text = (tmp_path / "t.xyz").read_bytes()
    assert text == (tmp_path / "j.xyz").read_bytes()
    assert text.splitlines()[0] == b"24"
    Frames_t("").write(st, meta)       # no path, no file


def test_pi_options_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(pi_t.PIOptions)] \
        == [(f.name, f.default) for f in dataclasses.fields(pi_j._PIOpts)]
