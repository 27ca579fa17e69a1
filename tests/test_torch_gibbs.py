"""The port's two-box Gibbs ensemble against mpmcxx_tpu.mc.gibbs on the
CPU, on the same states (built as tests/test_gibbs_replicas.py builds
them, carried across with ``state_from_jax``) and the same key.

- Step for step, the JAX ``make_gibbs_step`` under ``lax.scan`` and the
  port's chunk runner: equal move types (transfers are INSERT), accept
  flags and accept/reject counts; per-box energies within 1e-10
  relative; equal final volumes (1e-12).  Cases: argon 8 @ 20 A + 8 @
  24 A on the full-recompute branch; charged two-site boxes with Ewald on
  the incremental branch (SF caches; its energies also against a full
  recompute at 1e-9), also under Feynman-Hibbs order 4; a tiny
  polarizable pair on the full-recompute branch with the dense float64
  SCF.
- Twins of TestGibbs' conservation tests on the port: total N under
  transfers, total V under volume exchanges, finite per-box energies
  under displacements; and, marked slow, the ideal-gas uniform-V_a gate.
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
from mpmcxx_tpu.mc import chain as chain_j  # noqa: E402
from mpmcxx_tpu.mc import gibbs as gibbs_j  # noqa: E402
from mpmcxx_tpu.ops.energy import energy_breakdown as energy_j  # noqa: E402
from mpmcxx_tpu.state import AtomRecord, build_state  # noqa: E402
from mpmcxx_tpu_torch import flags as flags_t  # noqa: E402
from mpmcxx_tpu_torch.mc import gibbs as gibbs_t  # noqa: E402
from mpmcxx_tpu_torch.ops.energy import \
    energy_breakdown as energy_t  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax, topology  # noqa: E402
from test_gibbs_replicas import argon_box  # noqa: E402

E2REDUCED = 408.7816


def charged_box(n_mol, L, seed, polarizability=0.0, extra=6):
    """TestGibbsIncremental's two-site charged molecules."""
    r = np.random.default_rng(seed)
    atoms = []
    for m in range(n_mol):
        base = r.uniform(-L / 2, L / 2, 3)
        for a in range(2):
            off = r.normal(0, 0.9, 3)
            atoms.append(AtomRecord(
                "X", "MOL", m + 1, x=base[0] + off[0], y=base[1] + off[1],
                z=base[2] + off[2], mass=16.0,
                charge=E2REDUCED * (0.15 if a % 2 else -0.15),
                epsilon=80.0, sigma=3.1, polarizability=polarizability))
    return build_state(atoms, np.eye(3) * L, extra_mol_capacity=extra)


POLAR = dict(polarization=True, polar_iterative=True, polar_ewald=True,
             polar_max_iter=4, damp_type=const.DAMPING_EXPONENTIAL)

CASES = {
    # (box factories, FFlags kwargs, RunParams kwargs, GibbsOptions kwargs,
    #  steps, seed)
    "argon": ((lambda: argon_box(8, 20.0), lambda: argon_box(8, 24.0)),
              {}, dict(temperature=130.0),
              dict(move_factor=0.1, transfer_probability=0.3,
                   volume_probability=0.1, volume_change_factor=0.1), 60, 3),
    "charged_incremental": (
        (lambda: charged_box(8, 18.0, 1), lambda: charged_box(6, 20.0, 2)),
        {}, dict(temperature=140.0, ewald_alpha=3.5 / 9.0),
        dict(move_factor=0.2, transfer_probability=0.3,
             volume_probability=0.1, incremental=True, max_mol_atoms=2),
        60, 7),
    "fh4_incremental": (
        (lambda: charged_box(8, 18.0, 1), lambda: charged_box(6, 20.0, 2)),
        dict(feynman_hibbs=True, feynman_hibbs_order=4),
        dict(temperature=140.0, ewald_alpha=3.5 / 9.0),
        dict(move_factor=0.2, transfer_probability=0.3,
             volume_probability=0.1, incremental=True, max_mol_atoms=2),
        60, 7),
    "polar_full": (
        (lambda: charged_box(4, 14.0, 3, 0.7, extra=4),
         lambda: charged_box(3, 15.0, 4, 0.7, extra=4)),
        POLAR, dict(temperature=160.0, ewald_alpha=3.5 / 7.0,
                    polar_ewald_alpha=3.5 / 7.0, polar_damp=2.1304),
        dict(move_factor=0.2, transfer_probability=0.3,
             volume_probability=0.15, max_mol_atoms=2), 16, 5),
}


def _jax_run(case):
    boxes, fkw, pkw, okw, n, seed = CASES[case]
    (sa, _), (sb, _) = boxes[0](), boxes[1]()
    flags, params = FFlags(**fkw), RunParams(**pkw)
    opts = gibbs_j.GibbsOptions(numsteps=n, **okw)

    def eo(state):
        eb = energy_j(state, flags, params)
        return eb.total, chain_j.observables_from_breakdown(
            state, eb, flags, params, const.ENSEMBLE_NVT_GIBBS)

    ea, oa = eo(sa)
    eb_, ob = eo(sb)
    dm = gibbs_j.delta_mod
    if opts.incremental:
        sfa, sfb = dm.sf_compute(sa, flags, params), \
            dm.sf_compute(sb, flags, params)
        ra, rb = dm.recip_energy(sfa, sa, flags, params), \
            dm.recip_energy(sfb, sb, flags, params)
    else:
        sfa = sfb = dm.SFCache(jnp.zeros(0), jnp.zeros(0))
        ra = rb = jnp.zeros(())
    carry = gibbs_j.GibbsCarry(
        sa, sb, ea, eb_, oa, ob, jnp.asarray(params.temperature),
        jax.random.PRNGKey(seed), jnp.zeros((), jnp.int64),
        jnp.zeros(7, jnp.int64), jnp.zeros(7, jnp.int64), sfa, sfb, ra, rb)
    step = gibbs_j.make_gibbs_step(flags, params, opts)
    carry, (bf, acc, mt) = jax.lax.scan(step, carry, None, length=n)
    return carry, np.asarray(acc), np.asarray(mt)


def _torch_setup(case):
    boxes, fkw, pkw, okw, n, seed = CASES[case]
    sa = state_from_jax(co2.jax_state_numpy(boxes[0]()[0]))
    sb = state_from_jax(co2.jax_state_numpy(boxes[1]()[0]))
    flags = flags_t.FFlags(**fkw)
    params = flags_t.RunParams(**pkw)
    opts = gibbs_t.GibbsOptions(numsteps=n, **okw)
    return sa, sb, flags, params, opts, n, seed


def _torch_run(case):
    sa, sb, flags, params, opts, n, seed = _torch_setup(case)
    carry = gibbs_t.init_gibbs_carry(sa, sb, flags, params, opts, seed,
                                     params.temperature)
    runner = gibbs_t.make_gibbs_chunk_runner(
        flags, params, opts, n, (topology(sa), topology(sb)))
    carry, outs = runner(carry)
    return carry, outs, flags, params


@pytest.mark.parametrize("case", list(CASES))
def test_chain_matches_jax(case):
    cj, acc_j, mt_j = _jax_run(case)
    ct, outs, flags, params = _torch_run(case)
    assert outs.movetype.tolist() == mt_j.tolist()
    assert outs.accepted.tolist() == acc_j.tolist()
    assert 0 < int(acc_j.sum()) < len(acc_j)
    assert {const.MOVETYPE_INSERT, const.MOVETYPE_VOLUME,
            const.MOVETYPE_DISPLACE} <= set(mt_j.tolist())
    np.testing.assert_array_equal(ct.accept.numpy(), np.asarray(cj.accept))
    np.testing.assert_array_equal(ct.reject.numpy(), np.asarray(cj.reject))
    for got, want in ((ct.energy_a, cj.energy_a), (ct.energy_b, cj.energy_b),
                      (ct.obs_a.N, cj.obs_a.N), (ct.obs_b.N, cj.obs_b.N)):
        assert float(got) == pytest.approx(float(want), rel=1e-10, abs=1e-9)
    for got, want in ((ct.state_a, cj.state_a), (ct.state_b, cj.state_b)):
        assert float(got.pbc.volume) == pytest.approx(
            float(want.pbc.volume), rel=1e-12)
        np.testing.assert_array_equal(got.mol_alive.numpy(),
                                      np.asarray(want.mol_alive))
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                                   rtol=0, atol=1e-9)
    if gibbs_t.GibbsOptions(**CASES[case][3]).incremental:
        for st, E in ((ct.state_a, ct.energy_a), (ct.state_b, ct.energy_b)):
            ref = energy_t(st, flags, params)
            assert float(E) == pytest.approx(float(ref.total), rel=1e-9,
                                             abs=1e-7)


def _port_chain(okw, n, seed=3):
    """TestGibbs._carry's argon boxes (8 @ 20 A, 8 @ 24 A, T = 130 K) on
    the port; returns (initial carry, final carry, outputs)."""
    sa = state_from_jax(co2.jax_state_numpy(argon_box(8, 20.0)[0]))
    sb = state_from_jax(co2.jax_state_numpy(argon_box(8, 24.0)[0]))
    flags, params = flags_t.FFlags(), flags_t.RunParams(temperature=130.0)
    opts = gibbs_t.GibbsOptions(numsteps=n, **okw)
    carry0 = gibbs_t.init_gibbs_carry(sa, sb, flags, params, opts, seed,
                                      130.0)
    runner = gibbs_t.make_gibbs_chunk_runner(
        flags, params, opts, n, (topology(sa), topology(sb)))
    carry, outs = runner(carry0)
    return carry0, carry, outs


@pytest.mark.parametrize("name", ["transfer_conserves_total_n",
                                  "volume_exchange_conserves_total_v",
                                  "displace_independent_accept"])
def test_gibbs_twins(name):
    """Twins of TestGibbs.test_transfer_conserves_total_n,
    test_volume_exchange_conserves_total_v and
    test_displace_independent_accept."""
    if name == "transfer_conserves_total_n":
        c0, c, outs = _port_chain(dict(move_factor=0.1,
                                       transfer_probability=0.7), 80)
        assert float(c.obs_a.N + c.obs_b.N) == float(c0.obs_a.N + c0.obs_b.N)
        assert int(c.accept[const.MOVETYPE_INSERT]) > 0
        assert int(c.state_a.mol_alive.sum() + c.state_b.mol_alive.sum()) \
            == 16
    elif name == "volume_exchange_conserves_total_v":
        c0, c, _ = _port_chain(dict(move_factor=0.05,
                                    volume_probability=0.6,
                                    volume_change_factor=0.05), 60)
        v0 = float(c0.state_a.pbc.volume + c0.state_b.pbc.volume)
        v1 = float(c.state_a.pbc.volume + c.state_b.pbc.volume)
        assert v1 == pytest.approx(v0, rel=1e-12)
        assert int(c.accept[const.MOVETYPE_VOLUME]) > 0
    else:
        _, c, outs = _port_chain(dict(move_factor=0.05), 40)
        assert set(outs.movetype.tolist()) == {const.MOVETYPE_DISPLACE}
        assert np.isfinite(float(c.energy_a))
        assert np.isfinite(float(c.energy_b))
        assert int(c.accept.sum()) > 0


@pytest.mark.slow
def test_ideal_gas_volume_marginal_uniform():
    """TestGibbs.test_ideal_gas_volume_marginal_uniform on the port: the
    V_a marginal of an ideal gas is uniform on (0, V_total)."""
    def ideal_box(n, L, seed):
        rng = np.random.default_rng(seed)
        return build_state(
            [AtomRecord("Ar", "Ar", m + 1, x=float(x), y=float(y),
                        z=float(z), mass=39.948)
             for m, (x, y, z) in enumerate(
                 rng.uniform(-L / 2, L / 2, (n, 3)))],
            np.eye(3) * L, extra_mol_capacity=16)[0]

    sa = state_from_jax(co2.jax_state_numpy(ideal_box(8, 10.0, 1)))
    sb = state_from_jax(co2.jax_state_numpy(ideal_box(8, 10.0, 2)))
    flags, params = flags_t.FFlags(), flags_t.RunParams(temperature=100.0)
    opts = gibbs_t.GibbsOptions(move_factor=0.2, volume_probability=0.4,
                                transfer_probability=0.3,
                                volume_change_factor=0.5)
    carry = gibbs_t.init_gibbs_carry(sa, sb, flags, params, opts, 17, 100.0)
    runner = gibbs_t.make_gibbs_chunk_runner(
        flags, params, opts, 200, (topology(sa), topology(sb)))
    vas = []
    for _ in range(400):
        carry, _ = runner(carry)
        vas.append(float(carry.state_a.pbc.volume))
    va = np.asarray(vas[80:])
    assert 780.0 < va.mean() < 1220.0
    assert 650.0 < np.median(va) < 1350.0


def test_gibbs_options_match_jax():
    """The port's GibbsOptions carries the twin's fields and defaults."""
    assert [(f.name, f.default)
            for f in dataclasses.fields(gibbs_t.GibbsOptions)] == \
        [(f.name, f.default) for f in dataclasses.fields(gibbs_j.GibbsOptions)]
