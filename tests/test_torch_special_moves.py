"""The special moves (queue A item 4c) through the JAX package and the
port on the same inputs, the states carried across with
``state_from_jax``.

- Energies within 1e-10 relative, dense and through
  ``energy_breakdown_blocked`` (which routes them dense): the no-PBC
  Coulomb, the GWP Coulomb and kinetic terms, LJ's SPECTRE branch with
  and without its long-range and crystal sums, the anharmonic well with
  Feynman-Hibbs off, 2 and 4.  With feynman_kleinert on both packages
  give the classical well (a fault shared with the JAX package).
- The draws of the adiabatic, anharmonic, SPECTRE and GWP moves, and
  the [n, A] array of the last two, bit for bit the JAX package's keys'
  at A = 21 and 134 (GWP's normals within 1e-14 relative: erfinv).
- Each masked move from the same key within 1e-12; twins of
  tests/test_mc.py's TestSpecialMoves and TestSpectreChargeLaw.
- Chains step for step against the JAX chunk runners: NVT SPECTRE, GWP
  and anharmonic + FH4, uVT with adiabatic molecules on the polar cache,
  uVT and NVT with spin flips, NVT argon without a topology, Gibbs and
  PI with spin flips: the same move and accept sequences, the end
  states within 1e-9 (charges and widths 1e-12, spins equal).  Every
  spin flip is rejected in both packages: the rotational partition
  functions stay 0 (a fault shared with the JAX package).
- The spin-flip factors (NaN included), the capacity regrowth with
  adiabatic molecules and spins, the observables' frozen mass, and NVT
  GWP and SPECTRE runs through both runners (the SIM_CONTROL echo, the
  averages report and the energy log)."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu import FFlags, RunParams  # noqa: E402
from mpmcxx_tpu import constants as const  # noqa: E402
from mpmcxx_tpu.io.pqr import read_pqr as read_pqr_j  # noqa: E402
from mpmcxx_tpu.mc import chain as chain_j  # noqa: E402
from mpmcxx_tpu.mc import gibbs as gibbs_j  # noqa: E402
from mpmcxx_tpu.mc import moves as moves_j  # noqa: E402
from mpmcxx_tpu.mc import pi as pi_j  # noqa: E402
from mpmcxx_tpu.ops import energy as energy_j  # noqa: E402
from mpmcxx_tpu.ops import ewald as ewald_j  # noqa: E402
from mpmcxx_tpu.ops import pairwise as pairwise_j  # noqa: E402
from mpmcxx_tpu.state import AtomRecord, build_state  # noqa: E402
from mpmcxx_tpu.state import topology as topology_j  # noqa: E402
from mpmcxx_tpu_torch import flags as flags_t  # noqa: E402
from mpmcxx_tpu_torch import random as rnd  # noqa: E402
from mpmcxx_tpu_torch.mc import chain as chain_t  # noqa: E402
from mpmcxx_tpu_torch.mc import gibbs as gibbs_t  # noqa: E402
from mpmcxx_tpu_torch.mc import moves as moves_t  # noqa: E402
from mpmcxx_tpu_torch.mc import pi as pi_t  # noqa: E402
from mpmcxx_tpu_torch.ops import energy as energy_t  # noqa: E402
from mpmcxx_tpu_torch.ops import ewald as ewald_t  # noqa: E402
from mpmcxx_tpu_torch.ops import pairwise as pairwise_t  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax  # noqa: E402
from mpmcxx_tpu_torch.state import topology as topology_t  # noqa: E402
from test_torch_pi import _jax_chain, _torch_chain  # noqa: E402

E2REDUCED = 408.7816
HERE = os.path.dirname(__file__)
EXAMPLES = os.path.join(HERE, "..", "examples")
REL = 1e-10


def _port(sj):
    return state_from_jax(co2.jax_state_numpy(sj))


def _golden(name):
    with open(os.path.join(HERE, "golden", name + ".json")) as f:
        return json.load(f)


def _golden_atoms(fix):
    if "pqr_text" in fix:
        return read_pqr_j(fix["pqr_text"], is_text=True)
    return [AtomRecord(atomtype=at, moleculetype=mt, molecule_id=mid, x=x,
                       y=y, z=z, mass=mass, charge=q * E2REDUCED,
                       polarizability=al, epsilon=eps, sigma=sig, omega=om,
                       gwp_alpha=gw)
            for (at, mt, mid, x, y, z, mass, q, al, eps, sig, om, gw, *_)
            in fix["atoms"]]


def special_state(seed=0, n_mol=7, L=16.0, extra=0):
    """A seeded mixture in both packages: one target atom, SPECTRE sites,
    two-site molecules whose first site carries a GWP width, and
    frozen charges; (JAX state, port state)."""
    r = np.random.default_rng(seed)
    atoms = [AtomRecord("Tg", "TGT", 1, target=True, x=0.3, y=-0.2, z=0.1,
                        mass=50.0, charge=E2REDUCED * 0.25, epsilon=100.0,
                        sigma=3.0)]
    mid = 2
    for m in range(n_mol):
        c = r.uniform(-L / 2, L / 2, 3)
        if m % 3 == 0:
            atoms.append(AtomRecord(
                "Sp", "SPC", mid, spectre=True, x=c[0], y=c[1], z=c[2],
                mass=1.0, charge=E2REDUCED * r.uniform(-0.1, 0.1),
                epsilon=50.0, sigma=2.5))
        else:
            u = r.normal(size=3)
            u /= np.linalg.norm(u)
            for a, sgn in enumerate((1.0, -1.0)):
                p = c + sgn * 0.6 * u
                atoms.append(AtomRecord(
                    "X", "MOL", mid, x=p[0], y=p[1], z=p[2], mass=4.0,
                    charge=E2REDUCED * 0.3 * sgn, epsilon=40.0, sigma=2.8,
                    gwp_alpha=0.9 + 0.2 * m if a == 0 else 0.0))
        mid += 1
    for k in range(3):
        p = r.uniform(-L / 2, L / 2, 3)
        atoms.append(AtomRecord("F", "FRM", mid, frozen=True, x=p[0],
                                y=p[1], z=p[2], mass=12.0,
                                charge=E2REDUCED * 0.2 * (-1) ** k,
                                epsilon=30.0, sigma=3.2))
        mid += 1
    sj, _ = build_state(atoms, np.eye(3) * L, extra_mol_capacity=extra)
    return sj, _port(sj)


def _close(got, want, rel=REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(abs(want), 1e-300), (got, want)


# --- energies ------------------------------------------------------------

def test_special_coulomb_terms_match_jax():
    sj, st = special_state()
    fj, ft = FFlags(), flags_t.FFlags()
    pj, pt = pairwise_j.build_pairs(sj, fj), pairwise_t.build_pairs(st, ft)
    _close(ewald_t.coulombic_nopbc(st, pt), ewald_j.coulombic_nopbc(sj, pj))
    _close(ewald_t.coulombic_nopbc_gwp(st, pt),
           ewald_j.coulombic_nopbc_gwp(sj, pj))
    _close(ewald_t.coulombic_kinetic_gwp(st),
           ewald_j.coulombic_kinetic_gwp(sj))
    assert float(ewald_t.coulombic_kinetic_gwp(st)) > 0.0


ANHARMONIC = dict(rd_only=True, rd_anharmonic=True, rd_anharmonic_k=600.0,
                  rd_anharmonic_g=12.0, rd_lrc=False)
ENERGY_CASES = {
    "spectre": dict(spectre=True),
    "spectre_nolrc": dict(spectre=True, rd_lrc=False),
    "spectre_crystal": dict(spectre=True, rd_crystal=True,
                            rd_crystal_order=2),
    "gwp": dict(gwp=True),
    "gwp_nolrc": dict(gwp=True, rd_lrc=False),
    "anharmonic": ANHARMONIC,
    "anharmonic_fh2": dict(ANHARMONIC, feynman_hibbs=True,
                           feynman_hibbs_order=2),
    "anharmonic_fh4": dict(ANHARMONIC, feynman_hibbs=True,
                           feynman_hibbs_order=4),
}


@pytest.mark.parametrize("name", list(ENERGY_CASES))
def test_energy_breakdown_matches_jax(name):
    """Dense energy_breakdown against the JAX package's, and the port's
    energy_breakdown_blocked equal to its dense energy."""
    sj, st = special_state(seed=1)
    kw = ENERGY_CASES[name]
    pkw = dict(temperature=40.0, ewald_alpha=3.5 / 8.0)
    ej = energy_j.energy_breakdown(sj, FFlags(**kw), RunParams(**pkw))
    ft, pt = flags_t.FFlags(**kw), flags_t.RunParams(**pkw)
    et = energy_t.energy_breakdown(st, ft, pt)
    for f in ("rd", "coulombic", "kinetic", "total"):
        want = float(getattr(ej, f))
        assert float(getattr(et, f)) == pytest.approx(
            want, rel=REL, abs=0.0 if want else 1e-300), f
    assert float(et.rd) != 0.0 or name.startswith("gwp")
    if name.startswith("gwp"):
        assert float(et.kinetic) > 0.0 and float(et.rd) == 0.0
    blocked = energy_t.energy_breakdown_blocked(st, ft, pt)
    for f in ("rd", "coulombic", "kinetic", "total"):
        assert float(getattr(blocked, f)) == float(getattr(et, f)), f


def test_feynman_kleinert_gives_the_classical_well():
    """Shared fault: with feynman_kleinert on, both packages drop the
    Feynman-Hibbs terms of the anharmonic well (the reference iterates
    the Feynman-Kleinert effective potential instead)."""
    sj, st = special_state(seed=2)
    pkw = dict(temperature=20.0)
    fh4 = dict(ANHARMONIC, feynman_hibbs=True, feynman_hibbs_order=4)
    out = {}
    for name, kw in (("classical", ANHARMONIC), ("fh4", fh4),
                     ("fk", dict(fh4, feynman_kleinert=True))):
        ej = energy_j.energy_breakdown(sj, FFlags(**kw), RunParams(**pkw))
        et = energy_t.energy_breakdown(st, flags_t.FFlags(**kw),
                                       flags_t.RunParams(**pkw))
        _close(et.rd, ej.rd)
        out[name] = (float(et.rd), float(ej.rd))
    assert out["fk"] == out["classical"]
    assert out["fh4"][0] != out["classical"][0]


# --- draws -----------------------------------------------------------------

@pytest.mark.parametrize("A", [21, 134])
def test_special_draws_match_jax(A):
    n = 6
    key = rnd.PRNGKey(11)
    _, d, _ = chain_t.chunk_draws(key, n, special=True)
    wide = chain_t.wide_draws(key, n, A).numpy()
    d = d.numpy()
    assert d.shape == (n, 40) and wide.shape == (n, A)
    assert chain_t.chunk_draws(key, n)[1].shape == (n, 22)
    kj = jax.random.PRNGKey(11)
    for i in range(n):
        kj, _, k_target, k_apply, _, _ = jax.random.split(kj, 6)
        k1, = jax.random.split(k_apply, 1)
        ka, kb = jax.random.split(k1)
        u = lambda k, s=(): np.asarray(jax.random.uniform(k, s))
        assert d[i, chain_t._U_ADIA] == u(jax.random.fold_in(k_target, 1))
        np.testing.assert_array_equal(
            d[i, chain_t._SP_DICE:chain_t._SP_DICE + 6], u(ka, (6,)))
        assert d[i, chain_t._SP_DICE] == u(ka)           # displace_1d's
        assert d[i, chain_t._U_1D_SIGN] == u(kb)
        g = d[i, chain_t._GWP:chain_t._GWP + 10]
        k3 = jax.random.split(ka, 3)
        np.testing.assert_array_equal(g[:6], u(k3[0], (6,)))
        np.testing.assert_allclose(g[6:9], jax.random.normal(k3[1], (3,)),
                                   rtol=1e-14, atol=0)
        assert g[9] == u(k3[2])
        np.testing.assert_array_equal(wide[i], u(kb, (A,)))


# --- moves -----------------------------------------------------------------

def _disp_draws(k):
    k3 = rnd.split(k, 3)
    return (rnd.uniform(k3[0], (6,)), rnd.normal(k3[1], (3,)),
            rnd.uniform(k3[2]))


def _same(st_new, sj_new, fields=("pos", "charge", "gwp_alpha"), tol=1e-12):
    for f in fields:
        np.testing.assert_allclose(getattr(st_new, f).numpy(),
                                   np.asarray(getattr(sj_new, f)),
                                   rtol=tol, atol=tol, err_msg=f)


MOVES = ["displace", "insert", "displace_1d", "spinflip", "spectre_displace",
         "displace_gwp", "spectre_renormalize", "spectre_reject_restore",
         "spectre_wrapall"]


@pytest.mark.parametrize("name", MOVES)
def test_move_matches_jax(name):
    sj, st = special_state(seed=3, extra=2)
    kj, kt = jax.random.PRNGKey(5), rnd.PRNGKey(5)
    mol = 3                                   # a two-site GWP molecule
    mj, mt = jnp.asarray(mol), torch.tensor(mol)
    if name == "displace":
        _same(moves_t.displace(st, *_disp_draws(kt), mt, 0.4, 0.7),
              moves_j.displace(sj, kj, mj, 0.4, 0.7))
    elif name == "insert":
        slot = int(np.nonzero(~np.asarray(sj.mol_alive))[0][0])
        nj, vj = moves_j.insert(sj, kj, mj, jnp.asarray(slot))
        nt, vt = moves_t.insert(st, *_disp_draws(kt), mt, torch.tensor(slot))
        _same(nt, nj)
        for f in ("mol_alive", "aalive", "nuclear_spin"):
            np.testing.assert_array_equal(getattr(nt, f).numpy(),
                                          np.asarray(getattr(nj, f)))
        assert bool(vt) and bool(vj)
        full = moves_t.insert(nt, *_disp_draws(kt), mt, torch.tensor(-1))
        assert not bool(full[1]) and torch.equal(full[0].pos, nt.pos)
    elif name == "displace_1d":
        ka, kb = rnd.split(kt, 2)
        _same(moves_t.displace_1d(st, rnd.uniform(ka), rnd.uniform(kb), mt,
                                  0.3),
              moves_j.displace_1d(sj, kj, mj, 0.3))
    elif name == "spinflip":
        nt = moves_t.spinflip(st, mt)
        np.testing.assert_array_equal(
            nt.nuclear_spin.numpy(),
            np.asarray(moves_j.spinflip(sj, mj).nuclear_spin))
        assert int(nt.nuclear_spin[mol]) == const.NUCLEAR_SPIN_ORTHO
        assert torch.equal(moves_t.spinflip(nt, mt).nuclear_spin,
                           st.nuclear_spin)
    elif name in ("spectre_displace", "spectre_reject_restore"):
        sp_mol = 1                            # the first SPECTRE site
        ka, kb = rnd.split(kt, 2)
        nt = moves_t.spectre_displace(
            st, rnd.uniform(ka, (6,)), rnd.uniform(kb, (st.n_atom_slots,)),
            torch.tensor(sp_mol), 0.2, 0.15 * E2REDUCED, 5.0)
        nj = moves_j.spectre_displace(sj, kj, jnp.asarray(sp_mol), 0.2,
                                      0.15 * E2REDUCED, 5.0)
        _same(nt, nj)
        # the renormalization leaves the live SPECTRE sites neutral
        live = (st.spectre & st.aalive).numpy()
        assert abs(nt.charge.numpy()[live].sum()) < 1e-9
        if name == "spectre_reject_restore":
            np.testing.assert_allclose(
                moves_t.spectre_reject_restore(st, nt,
                                               torch.tensor(sp_mol)).numpy(),
                np.asarray(moves_j.spectre_reject_restore(
                    sj, nj, jnp.asarray(sp_mol))), rtol=1e-12, atol=1e-12)
    elif name == "displace_gwp":
        _same(moves_t.displace_gwp(st, rnd.uniform(kt, (st.n_atom_slots,)),
                                   mt, 0.3),
              moves_j.displace_gwp(sj, kj, mj, 0.3))
    elif name == "spectre_renormalize":
        q = np.random.default_rng(4).normal(0.0, 50.0, st.n_atom_slots)
        np.testing.assert_allclose(
            moves_t.spectre_renormalize(st, torch.tensor(q)).numpy(),
            np.asarray(moves_j.spectre_renormalize(sj, jnp.asarray(q))),
            rtol=1e-12, atol=1e-12)
    else:
        _same(moves_t.spectre_wrapall(st, 2.5),
              moves_j.spectre_wrapall(sj, 2.5))
        wrapped = moves_t.spectre_wrapall(st, 2.5).pos.numpy()
        d = wrapped[st.spectre.numpy()] - st.pos.numpy()[0]
        assert (np.abs(d) <= 2.5 + 1e-12).all()


# --- twins of tests/test_mc.py ---------------------------------------------

def _nvt_chain(atoms, L, fkw, pkw, okw, n, seed):
    st, _ = build_state(atoms, np.eye(3) * L)
    st = _port(st)
    flags, params = flags_t.FFlags(**fkw), flags_t.RunParams(**pkw)
    opts = chain_t.MCOptions(ensemble=const.ENSEMBLE_NVT, numsteps=n, **okw)
    carry = chain_t.init_carry(st, flags, params, opts, seed=seed)
    return chain_t.make_chunk_runner(flags, params, opts, n)(carry)


def test_gwp_displace_perturbs_widths():
    """Twin of TestSpecialMoves.test_gwp_displace_perturbs_widths."""
    atoms = [AtomRecord("H", "GW", 1, x=0.0, mass=1.0, gwp_alpha=0.5,
                        charge=408.78),
             AtomRecord("H", "GW", 2, x=3.0, mass=1.0, gwp_alpha=0.5,
                        charge=-408.78)]
    carry, _ = _nvt_chain(atoms, 20.0, dict(gwp=True, rd_lrc=False),
                          dict(temperature=50.0),
                          dict(move_factor=0.1, gwp=True,
                               gwp_probability=0.3), 40, 2)
    assert np.isfinite(float(carry.obs.energy))
    ga = carry.state.gwp_alpha.numpy()
    assert np.all(ga > 0) and np.any(ga != 0.5)


def test_spectre_chain_neutral():
    """Twin of TestSpecialMoves.test_spectre_chain_neutral."""
    qs = [0.1, -0.1, 0.0, -0.1]
    atoms = [AtomRecord("S", "SPC", m + 1, x=4.0 * m, mass=1.0,
                        spectre=(m < 3), target=(m == 3),
                        charge=408.78 * qs[m], epsilon=10.0, sigma=2.0)
             for m in range(4)]
    carry, _ = _nvt_chain(atoms, 20.0, dict(spectre=True, rd_lrc=False),
                          dict(temperature=300.0),
                          dict(move_factor=0.1, spectre=True,
                               spectre_max_charge=300.0,
                               spectre_max_target=5.0), 60, 8)
    q = carry.state.charge.numpy()
    sp = carry.state.spectre.numpy()
    assert int(carry.stats.accept.sum()) > 0
    assert abs(q[sp].sum()) < 1e-9
    assert np.any(np.abs(q[sp] - 408.78 * np.asarray(qs)[:3]) > 1e-6)


def test_spectre_reject_leak_algebra():
    """Twin of TestSpecialMoves.test_spectre_reject_leak_algebra: a
    rejected move leaves the moved site at q_old + d (n-1)/n^2 and every
    other at q_old - d/n^2."""
    n = 12
    atoms = [AtomRecord("T", "TGT", 1, mass=50.0, target=True,
                        charge=408.78, epsilon=10.0, sigma=3.0)]
    atoms += [AtomRecord("S", "SPC", m + 2, x=1.0 + m, y=0.5, mass=1.0,
                         spectre=True, charge=0.0, epsilon=10.0, sigma=2.0)
              for m in range(n)]
    st = _port(build_state(atoms, np.eye(3) * 30.0)[0])
    ka, kb = rnd.split(rnd.PRNGKey(3), 2)
    mol = torch.tensor(4)
    new = moves_t.spectre_displace(st, rnd.uniform(ka, (6,)),
                                   rnd.uniform(kb, (st.n_atom_slots,)), mol,
                                   0.1, 300.0, 5.0)
    q_old, q_new = st.charge.numpy(), new.charge.numpy()
    sp = st.spectre.numpy()
    moved = st.mol_id.numpy() == 4
    d = (q_new[moved & sp][0] - q_old[moved & sp][0]) * n / (n - 1)
    q_rej = moves_t.spectre_reject_restore(st, new, mol).numpy()
    assert abs(q_rej[moved & sp][0] -
               (q_old[moved & sp][0] + d * (n - 1) / n ** 2)) < 1e-9
    others = sp & ~moved
    np.testing.assert_allclose(q_rej[others], q_old[others] - d / n ** 2,
                               atol=1e-9)
    assert abs(q_rej[sp].sum()) < 1e-9 and q_rej[0] == q_old[0]


def test_spectre_charge_law_matches_reference_sampler():
    """Twin of TestSpectreChargeLaw: the charge delta's law against a
    numpy mirror of the reference's redraw loop (KS test)."""
    from scipy import stats as sps
    max_charge, max_target = 1.25, 5.0
    q0 = np.array([1.1, -0.9])
    atoms = [AtomRecord("S1", "SPC", 1, x=0.0, charge=q0[0], mass=1.0,
                        spectre=True),
             AtomRecord("S2", "SPC", 1, x=1.0, charge=q0[1], mass=1.0,
                        spectre=True)]
    st = _port(build_state(atoms, np.eye(3) * 20.0)[0])
    n = 4000
    keys = rnd.split(rnd.PRNGKey(0), n)
    k12 = rnd.split(keys, 2)
    dice = rnd.uniform(k12[:, 0], (6,))
    u = rnd.uniform(k12[:, 1], (2,))
    mol = torch.tensor(0)
    ours = np.stack([moves_t.spectre_displace(
        st, dice[i], u[i], mol, 0.2, max_charge, max_target).charge.numpy()
        for i in range(n)])
    rng = np.random.default_rng(1)
    ref = np.empty((n, 2))
    for i in range(n):
        q = q0.copy()
        for a in range(2):
            while True:
                dq = rng.random()
                if rng.random() < 0.5:
                    dq = -dq
                if abs(q[a] + dq) <= max_charge:
                    break
            q[a] += dq
        q -= q.sum() / 2.0
        ref[i] = q
    for a in range(2):
        assert sps.ks_2samp(ours[:, a], ref[:, a]).pvalue > 1e-3, a
    np.testing.assert_allclose(ours.sum(axis=1), 0.0, atol=1e-12)


# --- chains, step for step -------------------------------------------------

def _spectre_state():
    atoms = _golden_atoms(_golden("spectre_nvt"))
    return build_state(atoms, np.eye(3) * 20.0)[0]


def _gwp_state():
    return build_state(_golden_atoms(_golden("gwp_coulomb_kinetic")),
                       np.eye(3) * 17.0)[0]


def _anharmonic_state():
    return build_state(_golden_atoms(_golden("anharmonic")),
                       np.eye(3) * 17.0)[0]


def _argon_state(extra=0):
    atoms = read_pqr_j(os.path.join(EXAMPLES, "gibbs-argon", "boxA.pqr"))
    return build_state(atoms, np.eye(3) * 20.0, extra_mol_capacity=extra)[0]


def _adiabatic_co2():
    """The CO2 test system with its first three sorbates adiabatic."""
    recs = co2.records()
    first = sorted({r["molecule_id"] for r in recs
                    if not r.get("frozen")})[:3]
    atoms = [AtomRecord(**dict(r, adiabatic=r["molecule_id"] in first))
             for r in recs]
    return build_state(atoms, np.eye(3) * co2.L,
                       extra_mol_capacity=co2.EXTRA)[0]


CO2_POLAR = dict(polarization=True, polar_iterative=True, polar_ewald=True,
                 polar_mixed=True, polar_max_iter=4,
                 damp_type=const.DAMPING_EXPONENTIAL)
CO2_PARAMS = dict(temperature=150.0, ewald_alpha=3.5 / 9.0,
                  polar_ewald_alpha=3.5 / 9.0, polar_damp=2.1304,
                  polar_gamma=1.0)
NVT_PLAIN = dict(ensemble=const.ENSEMBLE_NVT)
CHAINS = {
    # state, FFlags kw, RunParams kw, MCOptions kw, topology, moves, seed
    "nvt_spectre": (_spectre_state, dict(spectre=True),
                    dict(temperature=500.0),
                    dict(NVT_PLAIN, move_factor=0.3, spectre=True,
                         spectre_max_charge=50.0,
                         spectre_max_target=5.0), True, 48, 1),
    "nvt_gwp": (_gwp_state, dict(gwp=True, rd_lrc=False),
                dict(temperature=77.0),
                dict(NVT_PLAIN, move_factor=0.2, gwp=True,
                     gwp_probability=0.3), True, 48, 2),
    "nvt_anharmonic_fh4": (
        _anharmonic_state,
        dict(ANHARMONIC, feynman_hibbs=True, feynman_hibbs_order=4),
        dict(temperature=77.0),
        dict(NVT_PLAIN, move_factor=0.4, rd_anharmonic=True), True, 64, 3),
    "uvt_adiabatic_cache": (
        _adiabatic_co2, CO2_POLAR, CO2_PARAMS,
        dict(ensemble=const.ENSEMBLE_UVT, move_factor=0.1,
             insert_probability=0.3, fugacity=20.0,
             adiabatic_probability=0.2, incremental=True,
             polar_incremental=True, blocked_energy=False), True, 32, 0),
    "uvt_spinflip": (
        lambda: _argon_state(extra=24), {}, dict(temperature=110.0),
        dict(ensemble=const.ENSEMBLE_UVT, move_factor=0.25,
             insert_probability=0.3, fugacity=5.0, quantum_rotation=True,
             spinflip_probability=0.3, incremental=True), True, 48, 4),
    "nvt_spinflip": (
        _argon_state, {}, dict(temperature=110.0),
        dict(NVT_PLAIN, move_factor=0.25, quantum_rotation=True,
             spinflip_probability=0.3, incremental=True), True, 48, 5),
    "nvt_no_topology": (
        lambda: co2.jax_system("ar")[0], CO2_POLAR, CO2_PARAMS,
        dict(NVT_PLAIN, move_factor=0.1, incremental=True,
             polar_incremental=True), False, 32, 6),
}


def _opts(pkg, sj, okw):
    counts = np.bincount(np.asarray(sj.mol_id), minlength=sj.n_mol_slots)
    return pkg.MCOptions(max_mol_atoms=int(counts.max()), **okw)


def _run_chain(pkg, topology, state, flags, params, opts, n, seed, topo):
    carry = pkg.init_carry(state, flags, params, opts, seed=seed)
    runner = pkg.make_chunk_runner(flags, params, opts, n,
                                   topology=topology(state) if topo else None)
    carry, outs = runner(carry)
    return carry, [int(m) for m in np.asarray(outs.movetype)], \
        [bool(a) for a in np.asarray(outs.accepted)]


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_matches_jax(name):
    make, fkw, pkw, okw, topo, n, seed = CHAINS[name]
    sj = make()
    cj, mj, aj = _run_chain(chain_j, topology_j, sj, FFlags(**fkw),
                            RunParams(**pkw), _opts(chain_j, sj, okw), n,
                            seed, topo)
    st = _port(sj)
    ct, mt, at = _run_chain(chain_t, topology_t, st, flags_t.FFlags(**fkw),
                            flags_t.RunParams(**pkw),
                            _opts(chain_t, sj, okw), n, seed, topo)
    assert mt == mj and at == aj
    assert 0 < sum(at) < len(at)
    rel = 1e-6 if "cache" in name or "topology" in name else 1e-9
    for f in ("energy", "rd_energy", "coulombic_energy", "kinetic_energy",
              "N"):
        want = float(getattr(cj.obs, f))
        assert float(getattr(ct.obs, f)) == pytest.approx(
            want, rel=rel, abs=1e-9), f
    np.testing.assert_allclose(ct.state.pos.numpy(), np.asarray(cj.state.pos),
                               rtol=0, atol=1e-9)
    for f in ("charge", "gwp_alpha"):
        np.testing.assert_allclose(getattr(ct.state, f).numpy(),
                                   np.asarray(getattr(cj.state, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    for f in ("nuclear_spin", "mol_alive"):
        np.testing.assert_array_equal(getattr(ct.state, f).numpy(),
                                      np.asarray(getattr(cj.state, f)))
    flips = [a for m, a in zip(mt, at) if m == const.MOVETYPE_SPINFLIP]
    if "spinflip" in name:
        # shared fault: every flip is proposed and rejected
        assert flips and not any(flips)
        np.testing.assert_array_equal(ct.state.nuclear_spin.numpy(),
                                      st.nuclear_spin.numpy())
    if name == "uvt_adiabatic_cache":
        assert const.MOVETYPE_ADIABATIC in mt
        adia = np.asarray(sj.mol_adiabatic)
        moved = np.any(np.abs(ct.state.pos.numpy() - st.pos.numpy()) > 0,
                       axis=1)
        mols = np.unique(st.mol_id.numpy()[moved])
        assert adia[mols].any()
    if name == "nvt_spectre":
        # the renormalization leaves the SPECTRE sites neutral
        assert abs(ct.state.charge.numpy()[st.spectre.numpy()].sum()) < 1e-9
    if name == "nvt_gwp":
        assert (ct.state.gwp_alpha.numpy()[st.gwp_spin.numpy()] > 0).all()


def test_adiabatic_molecule_fits_the_move_window():
    """movable_window counts adiabatic molecules (it leaves out frozen
    ones only), so a 5-site adiabatic molecule wider than the 3-site
    sorbates sets the polar cache's window."""
    recs = co2.records()
    atoms = [AtomRecord(**r) for r in recs]
    atoms += [AtomRecord("A", "ADI", 999, adiabatic=True, x=0.5 * k,
                         mass=2.0, epsilon=10.0, sigma=2.0)
              for k in range(5)]
    st = _port(build_state(atoms, np.eye(3) * co2.L,
                           extra_mol_capacity=co2.EXTRA)[0])
    assert moves_t.movable_window(st) == 5


def _gibbs_boxes():
    d = os.path.join(EXAMPLES, "gibbs-argon")
    a = read_pqr_j(os.path.join(d, "boxA.pqr"))
    b = read_pqr_j(os.path.join(d, "boxB.pqr"))
    extra = max(len(a), len(b), 16)
    return (build_state(a, np.eye(3) * 20.0, extra_mol_capacity=extra)[0],
            build_state(b, np.eye(3) * 20.0, extra_mol_capacity=extra)[0])


GIBBS_OPTS = dict(move_factor=0.25, transfer_probability=0.3,
                  volume_probability=0.1, volume_change_factor=0.1,
                  quantum_rotation=True, spinflip_probability=0.2,
                  incremental=True, max_mol_atoms=1)


def test_gibbs_spinflip_chain_matches_jax():
    sa, sb = _gibbs_boxes()
    n, seed, T = 60, 5, 110.0
    flags, params = FFlags(), RunParams(temperature=T)

    def eo(state):
        eb = energy_j.energy_breakdown(state, flags, params)
        return eb.total, chain_j.observables_from_breakdown(
            state, eb, flags, params, const.ENSEMBLE_NVT_GIBBS)

    dm = gibbs_j.delta_mod
    (ea, oa), (eb_, ob) = eo(sa), eo(sb)
    sfa, sfb = dm.sf_compute(sa, flags, params), dm.sf_compute(sb, flags,
                                                               params)
    carry = gibbs_j.GibbsCarry(
        sa, sb, ea, eb_, oa, ob, jnp.asarray(T), jax.random.PRNGKey(seed),
        jnp.zeros((), jnp.int64), jnp.zeros(7, jnp.int64),
        jnp.zeros(7, jnp.int64), sfa, sfb,
        dm.recip_energy(sfa, sa, flags, params),
        dm.recip_energy(sfb, sb, flags, params))
    step = gibbs_j.make_gibbs_step(
        flags, params, gibbs_j.GibbsOptions(numsteps=n, **GIBBS_OPTS))
    cj, (_, acc_j, mt_j) = jax.lax.scan(step, carry, None, length=n)

    ta, tb = _port(sa), _port(sb)
    ft, pt = flags_t.FFlags(), flags_t.RunParams(temperature=T)
    opts = gibbs_t.GibbsOptions(numsteps=n, **GIBBS_OPTS)
    ct = gibbs_t.init_gibbs_carry(ta, tb, ft, pt, opts, seed, T)
    ct, outs = gibbs_t.make_gibbs_chunk_runner(
        ft, pt, opts, n, (topology_t(ta), topology_t(tb)))(ct)
    mt, at = outs.movetype.tolist(), outs.accepted.tolist()
    assert mt == np.asarray(mt_j).tolist()
    assert at == np.asarray(acc_j).tolist()
    flips = [a for m, a in zip(mt, at) if m == const.MOVETYPE_SPINFLIP]
    assert flips and not any(flips)
    assert 0 < sum(at)
    for got, want in ((ct.energy_a, cj.energy_a), (ct.energy_b, cj.energy_b)):
        assert float(got) == pytest.approx(float(want), rel=1e-10, abs=1e-9)
    for got, want in ((ct.state_a, cj.state_a), (ct.state_b, cj.state_b)):
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(got.nuclear_spin.numpy(),
                                      np.asarray(want.nuclear_spin))


def test_pi_spinflip_chain_matches_jax():
    atoms = read_pqr_j(os.path.join(EXAMPLES, "pi-argon-dimer",
                                    "dimer.pqr"))
    P = 4
    rng = np.random.default_rng(9)
    states = []
    for _ in range(P):
        shift = rng.normal(0.0, 0.05, (2, 3))
        moved = [dataclasses.replace(a, x=a.x + shift[i, 0],
                                     y=a.y + shift[i, 1],
                                     z=a.z + shift[i, 2])
                 for i, a in enumerate(atoms)]
        st, meta = build_state(moved, np.eye(3) * 25.0)
        states.append(st)
    sj = pi_j.stack_states(states)
    st = pi_t.stack_states([_port(s) for s in states])
    fkw, pkw = {}, dict(temperature=2.0)
    okw = dict(move_factor=0.04, bead_perturb_probability=0.4,
               quantum_rotation=True, spinflip_probability=0.2)
    n = 48
    cj, oj, _, _ = _jax_chain(sj, meta, fkw, pkw, okw, 2, n, 1, False)
    ct, ot, _, _, _, _ = _torch_chain(st, meta, fkw, pkw, okw, 2, n, 1,
                                      False)
    mt = ot.movetype.tolist()
    assert mt == np.asarray(oj.movetype).tolist()
    assert ot.accepted.tolist() == np.asarray(oj.accepted).tolist()
    assert {const.MOVETYPE_SPINFLIP, const.MOVETYPE_PERTURB_BEADS,
            const.MOVETYPE_DISPLACE} <= set(mt)
    flips = [a for m, a in zip(mt, ot.accepted.tolist())
             if m == const.MOVETYPE_SPINFLIP]
    assert flips and not any(flips)
    np.testing.assert_allclose(ct.stack.pos.numpy(), np.asarray(cj.stack.pos),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ct.stack.nuclear_spin.numpy(),
                                  np.asarray(cj.stack.nuclear_spin))
    assert float(ct.potential_current) == pytest.approx(
        float(cj.potential_current), rel=1e-10, abs=1e-9)


# --- the factors, the regrowth and the runner ------------------------------

def test_spin_factors_match_jax():
    """The SPINFLIP branches of the uVT and NVT factors and the partition
    function ratio, NaN where the functions are 0 (the shared fault)."""
    from mpmcxx_tpu.mc import metropolis as metro_j
    from mpmcxx_tpu_torch.mc import metropolis as metro_t
    rng = np.random.default_rng(6)
    n = 32
    spin = rng.integers(0, 2, n).astype(np.int32)
    g = np.where(np.arange(n) < 8, 0.0, rng.uniform(0.1, 3.0, n))
    u = np.where(np.arange(n) < 8, 0.0, rng.uniform(0.1, 3.0, n))
    t = lambda x: torch.as_tensor(x)
    pr_j = np.asarray(metro_j.spin_partfunc_ratio(spin, g, u))
    pr_t = metro_t.spin_partfunc_ratio(t(spin), t(g), t(u)).numpy()
    np.testing.assert_allclose(pr_t, pr_j, rtol=1e-15)
    assert np.isnan(pr_t[:8]).all() and np.isfinite(pr_t[8:]).all()
    mt = np.full(n, const.MOVETYPE_SPINFLIP)
    dE, T = rng.normal(0.0, 50.0, n), rng.uniform(50.0, 300.0, n)
    np.testing.assert_allclose(
        metro_t.nvt_factor(t(mt), t(dE), t(T), t(pr_t)).numpy(),
        np.asarray(metro_j.nvt_factor(mt, dE, T, pr_j)), rtol=1e-15)
    args = (dE, T, 8000.0, 2.0, rng.uniform(1.0, 30.0, n), 1.0,
            np.zeros(n, bool), 0.0, 0.0)
    want = np.asarray(metro_j.uvt_factor(mt, *args, pr_j))
    got = metro_t.uvt_factor(t(mt), *(t(a) if isinstance(a, np.ndarray)
                                      else a for a in args), t(pr_t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
    assert np.isnan(got.numpy()[:8]).all()
    # a NaN factor never accepts
    assert not (0.5 < got[:8]).any()


def test_regrowth_and_observables_keep_adiabatic_molecules_and_spins():
    """The capacity regrowth carries adiabatic flags, nuclear spins and
    partition functions as the JAX package's does, and the observables
    count adiabatic molecules' mass as frozen."""
    from mpmcxx_tpu.state import grow_mol_capacity as grow_j
    from mpmcxx_tpu_torch.mc.chain import observables_from_breakdown as ob_t
    from mpmcxx_tpu_torch.state import grow_mol_capacity as grow_t
    recs = co2.records()
    first = sorted({r["molecule_id"] for r in recs
                    if not r.get("frozen")})[:3]
    sj, meta = build_state(
        [AtomRecord(**dict(r, adiabatic=r["molecule_id"] in first))
         for r in recs], np.eye(3) * co2.L, extra_mol_capacity=co2.EXTRA,
        rot_partfunc={"CO2": (1.5, 0.5)})
    spins = np.zeros(sj.n_mol_slots, np.int32)
    spins[[2, 5, 7]] = const.NUCLEAR_SPIN_ORTHO
    sj = sj.replace(nuclear_spin=jnp.asarray(spins))
    st = _port(sj)
    gj, _ = grow_j(sj, meta, {"CO2": 9})
    gt, _ = grow_t(st, meta, {"CO2": 9})
    for f in ("nuclear_spin", "mol_adiabatic", "adiabatic", "mol_alive",
              "rot_partfunc_g", "rot_partfunc_u", "charge", "gwp_alpha"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), f)
    _, _, fj, pj, _ = co2.jax_system()
    _, _, ft, pt, _ = co2.torch_system()
    fj, ft = fj.replace(polarization=False), ft.replace(polarization=False)
    oj = chain_j.observables_from_breakdown(
        sj, energy_j.energy_breakdown(sj, fj, pj), fj, pj,
        const.ENSEMBLE_UVT)
    ot = ob_t(st, energy_t.energy_breakdown(st, ft, pt), ft, pt,
              const.ENSEMBLE_UVT)
    for f in ("frozen_mass", "total_mass", "N", "spin_ratio", "energy"):
        assert float(getattr(ot, f)) == pytest.approx(
            float(getattr(oj, f)), rel=1e-12), f
    assert float(ot.frozen_mass) > float(
        np.asarray(sj.mol_mass)[np.asarray(sj.mol_frozen)].sum())


RUN_CASES = {
    "gwp": ("gwp_coulomb_kinetic", "gwp on\nrd_lrc off\ngwp_probability "
            "0.3\nmove_factor 0.2\n", 17.0),
    "spectre": ("spectre_nvt", "spectre on\nspectre_max_charge 50.0\n"
                "spectre_max_target 5.0\nmove_factor 0.3\n", 20.0),
}


@pytest.mark.parametrize("name", list(RUN_CASES))
def test_special_runs_match_jax(name, tmp_path, monkeypatch):
    """An NVT run of each through both packages' ``runner.Simulation``
    (the initial SPECTRE domain wrap included): the same SIM_CONTROL
    echo, averages report (GWP's total energy in eV and kinetic lines)
    and energy log."""
    import contextlib
    import io
    from mpmcxx_tpu import runner as runner_j
    from mpmcxx_tpu.config.parser import read_config as read_j
    from mpmcxx_tpu.io.output import display_sim_control as echo_j
    from mpmcxx_tpu.io.pqr import drain as drain_j
    from mpmcxx_tpu.io.pqr import write_state_pqr as write_j
    from mpmcxx_tpu_torch import runner as runner_t
    from mpmcxx_tpu_torch.config.parser import read_config as read_t
    from mpmcxx_tpu_torch.io.output import display_sim_control as echo_t
    golden, extra, L = RUN_CASES[name]
    fix = _golden(golden)
    state, meta = build_state(_golden_atoms(fix), np.eye(3) * L)
    out = {}
    for pkg, read, echo, sim_cls in (
            ("jax", read_j, echo_j, runner_j.Simulation),
            ("torch", read_t, echo_t, runner_t.Simulation)):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        write_j("in.pqr", state, meta, wrapall=False)
        drain_j()          # the write is queued on the codec's thread
        with open("run.in", "w") as f:
            f.write(f"job_name sp\nensemble nvt\ntemperature "
                    f"{fix['temperature']}\nnumsteps 40\ncorrtime 20\n"
                    f"seed 2\npqr_input in.pqr\nbasis1 {L} 0 0\nbasis2 0 "
                    f"{L} 0\nbasis3 0 0 {L}\n{extra}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            kw = {} if pkg == "jax" else {"device": "cpu"}
            sim = sim_cls(read("run.in"), **kw)
            echo(sim.cfg, out=buf)
            sim.run()
        if pkg == "jax":
            drain_j()
        # (the timer's lines differ by the host's speed)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith(("SIM_CONTROL", "OUTPUT")) and
                 "sec/step" not in ln]
        out[pkg] = (lines, np.loadtxt(d / "sp.energy.dat"))
    assert out["torch"][0] == out["jax"][0]
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=1e-9,
                               atol=1e-9)
    text = "\n".join(out["torch"][0])
    assert ("SPECTRE" in text) if name == "spectre" else (
        "gwp" in text and "kinetic energy" in text and " eV" in text)
