"""NVT, NPT and NVE, and the mixture's species draw, through the JAX
package and the port on the same inputs.

- The Metropolis factors ``nvt_factor``, ``npt_factor`` and
  ``nve_factor`` over a seeded grid that includes the NVE sign cases
  (E above the total energy with 3N/2 integral, odd or even, and
  non-integral): within 1e-12 relative.
- ``volume_change`` from the same key: positions and box within 1e-12.
- Chains of 2 x 32 moves (seed 0, a refresh after each chunk) on the
  small CO2 system (134 atom slots, the dense path): NVT, NVE and NPT
  with LJ + Ewald only (incremental Delta-E), NPT with the polarization
  cache (volume moves rebuild it), and NVT on the float64 SCF (a full
  recompute of every proposal).  The same move and accept sequence; N,
  volume and energies within 1e-9 relative, 1e-6 where the f32 SCF
  planes carry the polarization.
- NVT with simulated annealing, linear and geometric: the temperature
  after each chunk equal to the JAX chain's (1e-12).
- The draws of the volume move and of the mixture's insertion species,
  key for key as the JAX chain's."""

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
from mpmcxx_tpu import constants as const  # noqa: E402
from mpmcxx_tpu.mc import chain as chain_j  # noqa: E402
from mpmcxx_tpu.mc import metropolis as metro_j  # noqa: E402
from mpmcxx_tpu.mc import moves as moves_j  # noqa: E402
from mpmcxx_tpu.state import topology as topology_j  # noqa: E402
from mpmcxx_tpu_torch import random as rnd  # noqa: E402
from mpmcxx_tpu_torch.mc import chain as chain_t  # noqa: E402
from mpmcxx_tpu_torch.mc import metropolis as metro_t  # noqa: E402
from mpmcxx_tpu_torch.mc import moves as moves_t  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax  # noqa: E402
from mpmcxx_tpu_torch.state import topology as topology_t  # noqa: E402

CHUNK, N_CHUNKS = 32, 2


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _grid():
    rng = np.random.default_rng(3)
    n = 64
    return dict(
        movetype=rng.choice([const.MOVETYPE_DISPLACE, const.MOVETYPE_VOLUME,
                             const.MOVETYPE_SPINFLIP], n),
        delta=rng.normal(0.0, 300.0, n), T=rng.uniform(50.0, 400.0, n),
        pr=rng.uniform(0.0, 1.0, n), P=rng.uniform(0.1, 100.0, n),
        v_old=rng.uniform(5e3, 2e4, n), v_new=rng.uniform(5e3, 2e4, n),
        N=rng.integers(1, 40, n).astype(np.float64))


def test_nvt_and_npt_factors_match_jax():
    g = _grid()
    want = metro_j.nvt_factor(g["movetype"], g["delta"], g["T"], g["pr"])
    got = metro_t.nvt_factor(_t(g["movetype"]), _t(g["delta"]), _t(g["T"]),
                             _t(g["pr"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    want = metro_j.npt_factor(g["movetype"], g["delta"], g["T"], g["P"],
                              g["v_old"], g["v_new"], g["N"])
    got = metro_t.npt_factor(_t(g["movetype"]), _t(g["delta"]), _t(g["T"]),
                             _t(g["P"]), _t(g["v_old"]), _t(g["v_new"]),
                             _t(g["N"]))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("N", [2.0, 3.0, 5.0, 27.0, 64.0])
def test_nve_factor_matches_jax(N):
    """1.5 N integral and odd (N = 2), non-integral (N = 3, 5, 27) and
    integral even (N = 64); E_old and E_new on both sides of E_total,
    and E_old == E_total exactly."""
    rng = np.random.default_rng(int(N))
    e_tot = 4000.0
    e_old = np.concatenate([rng.uniform(-2000.0, 6000.0, 40), [e_tot]])
    e_new = np.concatenate([rng.uniform(-2000.0, 6000.0, 40), [3000.0]])
    Ns = np.full(e_old.shape, N)
    want = np.asarray(metro_j.nve_factor(e_tot, e_old, e_new, Ns))
    got = metro_t.nve_factor(e_tot, _t(e_old), _t(e_new), _t(Ns)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    below = (e_old < e_tot) & (e_new < e_tot)
    assert (got[below] > 0).all() and got[-1] == 0.0
    above = (e_old > e_tot) & (e_new > e_tot)
    if 1.5 * N != np.floor(1.5 * N):
        assert (got[above] == 0.0).all()
    else:
        assert (got[above] > 0.0).all()


def test_volume_change_matches_jax():
    sj = co2.jax_system()[0]
    st = state_from_jax(co2.jax_state_numpy(sj))
    key = jax.random.PRNGKey(7)
    nj = moves_j.volume_change(sj, key, 0.25)
    nt = moves_t.volume_change(st, rnd.uniform(rnd.PRNGKey(7)), 0.25)
    np.testing.assert_allclose(nt.pos.numpy(), np.asarray(nj.pos),
                               rtol=1e-12, atol=1e-12)
    for k in ("basis", "reciprocal", "volume", "cutoff"):
        np.testing.assert_allclose(getattr(nt.pbc, k).numpy(),
                                   np.asarray(getattr(nj.pbc, k)),
                                   rtol=1e-12, err_msg=k)
    assert float(nt.pbc.volume) != float(st.pbc.volume)


def test_volume_and_species_draws_match_jax():
    """chunk_draws' volume column is uniform(split(k_apply, 1)[0]) and its
    species column uniform(fold_in(k_target, 2)) of the JAX step's key
    split (chain.py:270, 351-353, 420-422)."""
    n = 8
    _, draws, _ = chain_t.chunk_draws(rnd.PRNGKey(5), n)
    key = jax.random.PRNGKey(5)
    for i in range(n):
        key, _, k_target, k_apply, _, _ = jax.random.split(key, 6)
        k1, = jax.random.split(k_apply, 1)
        assert float(draws[i, chain_t._U_VOL]) == float(
            jax.random.uniform(k1))
        u = float(jax.random.uniform(jax.random.fold_in(k_target, 2)))
        assert float(draws[i, chain_t._U_SPEC]) == u
        si = int(jnp.floor(u * 2).astype(jnp.int32))
        assert int(np.floor(float(draws[i, chain_t._U_SPEC]) * 2)) == si


def _case(system, chain, case):
    """(state, flags, params, opts) of the small CO2 system for one chain
    case, on the dense path."""
    state, _, flags, params, opts = system
    lj = dict(polarization=False)
    kw = {"nvt": (lj, dict(ensemble=const.ENSEMBLE_NVT)),
          "nve": (lj, dict(ensemble=const.ENSEMBLE_NVE)),
          "npt": (lj, dict(ensemble=const.ENSEMBLE_NPT,
                           volume_probability=0.2,
                           volume_change_factor=0.25)),
          "npt_cache": ({}, dict(ensemble=const.ENSEMBLE_NPT,
                                 volume_probability=0.2,
                                 volume_change_factor=0.25)),
          "nvt_f64": (dict(polar_mixed=False),
                      dict(ensemble=const.ENSEMBLE_NVT)),
          "nvt_anneal_linear": (lj, dict(
              ensemble=const.ENSEMBLE_NVT, simulated_annealing=True,
              simulated_annealing_linear=True,
              simulated_annealing_target=100.0, numsteps=CHUNK * N_CHUNKS)),
          "nvt_anneal_geometric": (lj, dict(
              ensemble=const.ENSEMBLE_NVT, simulated_annealing=True,
              simulated_annealing_schedule=0.98,
              simulated_annealing_target=100.0,
              numsteps=CHUNK * N_CHUNKS))}[case]
    flags = flags.replace(**kw[0])
    polar_cache = flags.polarization and flags.polar_mixed
    opts = dataclasses.replace(
        opts, blocked_energy=False, polar_incremental=polar_cache,
        incremental=polar_cache or not flags.polarization, **kw[1])
    params = dataclasses.replace(params, pressure=20.0,
                                 total_energy=-2000.0)
    return state, flags, params, opts


def _run(chain, topology, system):
    state, flags, params, opts = system
    carry = chain.init_carry(state, flags, params, opts, seed=0)
    runner = chain.make_chunk_runner(flags, params, opts, CHUNK,
                                     topology=topology(state))
    refresher = chain.make_refresher(flags, params, opts)
    per_chunk, movetype, accepted = [], [], []
    for _ in range(N_CHUNKS):
        carry, outs = runner(carry)
        inc = float(carry.obs.energy)
        carry = refresher(carry)
        per_chunk.append((inc, float(carry.obs.energy), float(carry.obs.N),
                          float(carry.obs.volume),
                          float(carry.obs.kinetic_energy),
                          float(carry.temperature)))
        movetype += [int(m) for m in np.asarray(outs.movetype)]
        accepted += [bool(a) for a in np.asarray(outs.accepted)]
    return carry, per_chunk, movetype, accepted


@pytest.mark.parametrize("case", ["nvt", "nve", "npt", "npt_cache",
                                  "nvt_f64", "nvt_anneal_linear",
                                  "nvt_anneal_geometric"])
def test_chain_matches_jax(case):
    rj = _run(chain_j, topology_j, _case(co2.jax_system(), chain_j, case))
    rt = _run(chain_t, topology_t, _case(co2.torch_system(), chain_t, case))
    (cj, ej, mj, aj), (ct, et, mt, at) = rj, rt
    assert mt == mj and at == aj
    assert 0 < sum(at) < len(at)
    if case.startswith("npt"):
        n_vol = mt.count(const.MOVETYPE_VOLUME)
        assert n_vol > 0 and any(a for m, a in zip(mt, at)
                                 if m == const.MOVETYPE_VOLUME)
    else:
        assert set(mt) == {const.MOVETYPE_DISPLACE}
    rel = 1e-6 if case == "npt_cache" else 1e-9
    for row_j, row_t in zip(ej, et):
        np.testing.assert_allclose(row_t, row_j, rtol=rel, atol=1e-9)
    np.testing.assert_array_equal(ct.stats.accept.numpy(),
                                  np.asarray(cj.stats.accept))
    np.testing.assert_array_equal(ct.stats.reject.numpy(),
                                  np.asarray(cj.stats.reject))
    np.testing.assert_allclose(ct.state.pos.numpy(), np.asarray(cj.state.pos),
                               rtol=0, atol=1e-9)
    T0 = float(_case(co2.torch_system(), chain_t, case)[2].temperature)
    if case.startswith("nvt_anneal"):
        # simulated annealing: the temperature falls toward the target on
        # accepts; the linear schedule lands on it at the last step
        assert [r[5] for r in et] == pytest.approx([r[5] for r in ej],
                                                   rel=1e-12)
        assert 100.0 <= et[-1][5] < et[0][5] < T0
        if case.endswith("linear"):
            assert et[-1][5] == 100.0
    else:
        assert all(r[5] == T0 for r in et)
    if case == "nve":
        # the kinetic energy is the fixed total less the potential
        assert et[-1][4] == pytest.approx(-2000.0 - et[-1][1], rel=1e-12)
    if case == "npt_cache":
        from mpmcxx_tpu_torch.ops import polar_cache
        _, flags, params, _ = _case(co2.torch_system(), chain_t, case)
        fresh = polar_cache.cache_init(ct.state, flags, params)
        for name in ("dx", "dy", "dz"):
            assert torch.equal(getattr(ct.pcache, name),
                               getattr(fresh, name))


@pytest.mark.parametrize("flag", [
    {"polar_iterative": False}, {"polar_ewald": False},
    {"polar_ewald_full": True}, {"polar_palmo": True},
    {"polar_zodid": True}, {"polar_wolf": True}, {"polar_gs_ranked": True}])
def test_unported_scf_raises(flag):
    """The SCF branches outside the fixed-K Ewald Jacobi solve raise and
    name themselves, on the dense path and on the f64 blocked one."""
    state, flags, params, opts = _case(co2.torch_system(), chain_t,
                                       "nvt_f64")
    for blocked in (False, True):
        with pytest.raises(NotImplementedError, match=next(iter(flag))):
            chain_t.init_carry(state, flags.replace(**flag), params,
                               dataclasses.replace(opts,
                                                   blocked_energy=blocked),
                               seed=0)


def test_polar_flags_are_free_without_polarization():
    """With polarization off no code reads the SCF's flags (the LJ-only
    examples parse to damp_type off); precision termination still raises
    with polarization on."""
    state, flags, params, opts = _case(co2.torch_system(), chain_t, "nvt")
    carry = chain_t.init_carry(
        state, flags.replace(damp_type=const.DAMPING_OFF, polar_max_iter=0),
        dataclasses.replace(params, polar_precision=1e-6), opts, seed=0)
    assert float(carry.obs.polarization_energy) == 0.0
    state, flags, params, opts = _case(co2.torch_system(), chain_t,
                                       "nvt_f64")
    with pytest.raises(NotImplementedError, match="polar_precision"):
        chain_t.init_carry(state, flags,
                           dataclasses.replace(params, polar_precision=1e-6),
                           opts, seed=0)


def test_cavity_bias_outside_uvt_raises():
    state, flags, params, opts = _case(co2.torch_system(), chain_t, "npt")
    with pytest.raises(NotImplementedError, match="cavity_bias"):
        chain_t.make_chunk_runner(
            flags, params, dataclasses.replace(opts, cavity_bias=True), 4,
            topology=topology_t(state))


@pytest.mark.parametrize("name,extra,args,match", [
    ("gibbs-argon", "quantum_rotation on\n", [], "quantum_rotation"),
    ("pi-argon-dimer", "quantum_rotation on\n", ["-P", "8"],
     "quantum_rotation"),
    ("nvt-argon", "", ["--replicas", "2"], "replicas")])
def test_unported_examples_raise(name, extra, args, match, tmp_path):
    """What the port has no path for raises through the CLI and names
    itself: quantum rotation (spin flips) in Gibbs and PI runs, and
    replica chains."""
    from mpmcxx_tpu_torch import cli
    from test_examples import EXAMPLES
    d = tmp_path / name
    shutil.copytree(os.path.join(EXAMPLES, name), d)
    with open(d / "run.in", "a") as f:
        f.write(extra)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        with pytest.raises(NotImplementedError, match=match):
            cli.run(["--device", "cpu", "--quiet"] + args + ["run.in"])
    finally:
        os.chdir(cwd)
