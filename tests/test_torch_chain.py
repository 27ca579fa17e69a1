"""The slice as a whole: the same small flagship-shaped systems (CO2, and
the H2 and monatomic shapes) through the JAX chain (init_carry +
make_chunk_runner) and the port's, seed 0, 2 chunks x 16 uVT moves."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu.mc import chain as chain_j  # noqa: E402
from mpmcxx_tpu.state import topology as topology_j  # noqa: E402
from mpmcxx_tpu_torch import constants as const  # noqa: E402
from mpmcxx_tpu_torch.mc import chain as chain_t  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_polar  # noqa: E402
from mpmcxx_tpu_torch.ops.energy import \
    energy_breakdown_blocked as eb_t  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax  # noqa: E402
from mpmcxx_tpu_torch.state import topology as topology_t  # noqa: E402

CHUNK, N_CHUNKS = 16, 2


def _run(chain, topology, system, refresh=False):
    state, _, flags, params, opts = system
    carry = chain.init_carry(state, flags, params, opts, seed=0)
    runner = chain.make_chunk_runner(flags, params, opts, CHUNK,
                                     topology=topology(state))
    refresher = chain.make_refresher(flags, params, opts)
    per_chunk, movetype, accepted, bf = [], [], [], []
    for _ in range(N_CHUNKS):
        carry, outs = runner(carry)
        if refresh:
            carry = refresher(carry)
        per_chunk.append((float(carry.obs.energy), float(carry.obs.N),
                          np.array(carry.cavity)))
        movetype += [int(m) for m in np.asarray(outs.movetype)]
        accepted += [bool(a) for a in np.asarray(outs.accepted)]
        bf += [float(b) for b in np.asarray(outs.boltzmann_factor)]
    return carry, per_chunk, movetype, accepted, bf


@pytest.fixture(scope="module")
def chains():
    return (_run(chain_j, topology_j, co2.jax_system()),
            _run(chain_t, topology_t, co2.torch_system()))


def test_chain_trajectory_matches_jax(chains):
    (cj, ej, mj, aj, _), (ct, et, mt, at, _) = chains
    assert mt == mj
    assert at == aj
    assert sum(at) > 0 and {0, 1, 2} <= set(mt)
    for (e_j, n_j, _), (e_t, n_t, _) in zip(ej, et):
        assert n_t == n_j
        # f32 SCF planes summed in another order
        assert e_t == pytest.approx(e_j, rel=1e-6)
    np.testing.assert_array_equal(ct.stats.accept.numpy(),
                                  np.asarray(cj.stats.accept))
    np.testing.assert_array_equal(ct.stats.reject.numpy(),
                                  np.asarray(cj.stats.reject))


# the schedule switch each flagship shape runs under on the card
SHAPE_ENV = {"h2": {"MPMCXX_TRI_KERNEL": "1"},
             "ar": {"MPMCXX_SYM_KERNEL": "0"}}


@pytest.fixture(scope="module", params=sorted(SHAPE_ENV))
def shaped_chains(request):
    """The H2 shape (S = 5, 768 slots) with MPMCXX_TRI_KERNEL=1, so K4's
    plain version drives every contraction of the port's run, and the
    monatomic shape (S = 1, 256 slots) with MPMCXX_SYM_KERNEL=0 (K1's).
    The JAX package runs its CPU contraction either way.  Returns
    (model, JAX run, port run, plain-version calls of the port run)."""
    model = request.param
    jax_run = _run(chain_j, topology_j, co2.jax_system(model))
    calls = {"contract_planes_plain": 0, "contract_planes_tri_plain": 0}
    with pytest.MonkeyPatch.context() as mp:
        for k in ("MPMCXX_SYM_KERNEL", "MPMCXX_TRI_KERNEL"):
            mp.delenv(k, raising=False)
        for k, v in SHAPE_ENV[model].items():
            mp.setenv(k, v)
        for name in calls:
            def counted(*a, _n=name, _f=getattr(cuda_polar, name), **k):
                calls[_n] += 1
                return _f(*a, **k)
            mp.setattr(cuda_polar, name, counted)
        port_run = _run(chain_t, topology_t, co2.torch_system(model=model))
    return model, jax_run, port_run, calls


def test_flagship_shape_chain_matches_jax(shaped_chains):
    """Same moves, accept decisions and N as the JAX chain, energies
    within 1e-6, through the contraction the switch picks."""
    model, (cj, ej, mj, aj, _), (ct, et, mt, at, _), calls = shaped_chains
    S = len(co2.MODELS[model][1])
    assert int(ct.state.mol_id.bincount().max()) == max(S, 8)
    assert ct.state.n_atom_slots == {"h2": 768, "ar": 256}[model]
    assert mt == mj and at == aj
    assert sum(at) > 0 and {0, 1, 2} <= set(mt)
    for (e_j, n_j, _), (e_t, n_t, _) in zip(ej, et):
        assert n_t == n_j
        # f32 SCF planes summed in another order
        assert e_t == pytest.approx(e_j, rel=1e-6)
    np.testing.assert_array_equal(ct.stats.accept.numpy(),
                                  np.asarray(cj.stats.accept))
    np.testing.assert_array_equal(ct.stats.reject.numpy(),
                                  np.asarray(cj.stats.reject))
    used, unused = ("contract_planes_tri_plain", "contract_planes_plain") \
        if model == "h2" else ("contract_planes_plain",
                               "contract_planes_tri_plain")
    assert calls[used] >= 4 * CHUNK * N_CHUNKS and calls[unused] == 0


def test_flagship_shape_incremental_tracks_full(shaped_chains):
    model, _, (ct, *_), _ = shaped_chains
    _, _, flags, params, _ = co2.torch_system(model=model)
    eb = eb_t(ct.state, flags, params)
    assert float(ct.obs.rd_energy) == pytest.approx(float(eb.rd), rel=1e-9)
    assert float(ct.obs.coulombic_energy) == pytest.approx(
        float(eb.coulombic), rel=1e-9)
    assert float(ct.obs.polarization_energy) == pytest.approx(
        float(eb.polarization), rel=2e-6)


def _cavity(system, opts_mod):
    state, meta, flags, params, opts = system
    return state, meta, flags, params, dataclasses.replace(
        opts, cavity_bias=True, cavity_grid_size=5, cavity_radius=2.6,
        cavity_darts=int(co2.L ** 3 * 0.1))


@pytest.fixture(scope="module")
def cavity_chains():
    return (_run(chain_j, topology_j, _cavity(co2.jax_system(), chain_j),
                 refresh=True),
            _run(chain_t, topology_t, _cavity(co2.torch_system(), chain_t),
                 refresh=True))


def test_cavity_chain_matches_jax(cavity_chains):
    """Cavity-biased insertion: the same move and accept sequences and,
    through the Boltzmann factors (the biased factor carries the cavity
    volume and the prior open fraction), the same biased sequence; the
    cavity averages across two corrtime refreshes agree."""
    (cj, ej, mj, aj, bj), (ct, et, mt, at, bt) = cavity_chains
    assert mt == mj and at == aj
    # BF = exp(-dE/T) (x the cavity terms): dE carries the f32 SCF's
    # ~1e-6 relative polarization difference, a few mK here, so the factors
    # agree to ~|d dE| / T; a biased and an unbiased factor differ by
    # V / (V_cavity p), ~100 here
    np.testing.assert_allclose(bt, bj, rtol=1e-4)
    c = ct.cavity
    assert co2.L ** 3 / float(c[1] * c[0]) > 10.0
    for (e_j, n_j, c_j), (e_t, n_t, c_t) in zip(ej, et):
        assert n_t == n_j
        assert e_t == pytest.approx(e_j, rel=1e-6)
        np.testing.assert_allclose(c_t, c_j, rtol=1e-12)
    assert ct.cavity[3] == 2.0 and 0.0 < float(ct.cavity[0]) < 1.0
    assert {const.MOVETYPE_INSERT, const.MOVETYPE_REMOVE} <= set(mt)


def test_cavity_biased_flags(cavity_chains):
    """The port's StepOut.biased: every insert with an open cavity point
    and no other move type than insert and remove is biased."""
    system = _cavity(co2.torch_system(), chain_t)
    state, _, flags, params, opts = system
    carry = chain_t.init_carry(state, flags, params, opts, seed=0)
    runner = chain_t.make_chunk_runner(flags, params, opts, CHUNK,
                                       topology=topology_t(state))
    _, outs = runner(carry)
    mt = outs.movetype
    ins = mt == const.MOVETYPE_INSERT
    rem = mt == const.MOVETYPE_REMOVE
    assert bool(outs.biased[ins].all()) and bool(ins.any())
    assert not bool(outs.biased[~(ins | rem)].any())
    assert [int(m) for m in mt] == cavity_chains[0][2][:CHUNK]


def test_incremental_tracks_full_recompute(chains):
    _, (ct, *_) = chains
    _, _, flags, params, _ = co2.torch_system()
    eb = eb_t(ct.state, flags, params)
    assert float(ct.obs.rd_energy) == pytest.approx(float(eb.rd), rel=1e-9)
    assert float(ct.obs.coulombic_energy) == pytest.approx(
        float(eb.coulombic), rel=1e-9)
    assert float(ct.obs.polarization_energy) == pytest.approx(
        float(eb.polarization), rel=2e-6)


def test_state_from_jax_round_trips():
    sj = co2.jax_system()[0]
    fields = co2.jax_state_numpy(sj)
    st = state_from_jax(fields)
    for f in dataclasses.fields(st):
        if f.name == "pbc":
            for k, v in fields["pbc"].items():
                np.testing.assert_array_equal(getattr(st.pbc, k).numpy(), v)
            continue
        np.testing.assert_array_equal(getattr(st, f.name).numpy(),
                                      fields[f.name], err_msg=f.name)


def _special_chain(chain, topology, system, flag, opt, n=8):
    """``n`` uVT moves of the CO2 system, seed 0, with FFlags changed by
    ``flag`` and MCOptions by ``opt``, on the full-recompute branch the
    runner takes for them (dense, no polarization cache; polarization
    off, which keeps the JAX compile short).  Returns (carry, move
    types, accept flags)."""
    state, _, flags, params, opts = system
    flags = flags.replace(polarization=False, **flag)
    opts = dataclasses.replace(opts, incremental=False,
                               polar_incremental=False, blocked_energy=False,
                               **opt)
    carry = chain.init_carry(state, flags, params, opts, seed=0)
    carry, outs = chain.make_chunk_runner(flags, params, opts, n,
                                          topology=topology(state))(carry)
    return carry, [int(m) for m in np.asarray(outs.movetype)], \
        [bool(a) for a in np.asarray(outs.accepted)]


def _twin_chains(flag, opt):
    (cj, mj, aj) = _special_chain(chain_j, topology_j, co2.jax_system(),
                                  flag, opt)
    (ct, mt, at) = _special_chain(chain_t, topology_t, co2.torch_system(),
                                  flag, opt)
    assert mt == mj and at == aj
    assert float(ct.obs.energy) == pytest.approx(float(cj.obs.energy),
                                                 rel=1e-9)
    np.testing.assert_allclose(ct.state.pos.numpy(), np.asarray(cj.state.pos),
                               rtol=0, atol=1e-9)
    return mt, at


@pytest.mark.parametrize("flag", [{"rd_anharmonic": True}, {"gwp": True},
                                  {"spectre": True},
                                  {"feynman_kleinert": True}])
def test_special_flag_chain_matches_jax(flag):
    """The special moves' energy flags (they once raised here) run the
    chain as the JAX package's does."""
    _twin_chains(flag, {})


@pytest.mark.parametrize("opt", [{"ensemble": const.ENSEMBLE_SURF}])
def test_unported_option_raises(opt):
    """An ensemble the standard chain has no branch for raises and names
    itself."""
    state, _, flags, params, opts = co2.torch_system()
    with pytest.raises(NotImplementedError, match=next(iter(opt))):
        chain_t.init_carry(state, flags, params,
                           dataclasses.replace(opts, **opt), seed=0)


@pytest.mark.parametrize("opt", [
    {"spectre": True, "spectre_max_charge": 100.0, "spectre_max_target": 3.0},
    {"quantum_rotation": True, "spinflip_probability": 0.3}])
def test_special_option_chain_matches_jax(opt):
    """The special moves' options (they once raised here) run the chain as
    the JAX package's does; every spin flip is rejected in both."""
    mt, at = _twin_chains({}, opt)
    if opt.get("quantum_rotation"):
        flips = [a for m, a in zip(mt, at) if m == const.MOVETYPE_SPINFLIP]
        assert flips and not any(flips)


def test_refresher_rebuilds_caches(chains):
    """make_refresher recomputes the observables and rebuilds the
    structure-factor and polarization caches from the carried state."""
    from mpmcxx_tpu_torch.ops import delta, polar_cache
    _, (ct, *_) = chains
    _, _, flags, params, opts = co2.torch_system()
    ref = chain_t.make_refresher(flags, params, opts)(ct)
    eb = eb_t(ct.state, flags, params)
    assert float(ref.obs.energy) == float(eb.total)
    assert float(ref.obs.N) == float(ct.obs.N)
    fresh = polar_cache.cache_init(ct.state, flags, params)
    for f in dataclasses.fields(fresh):
        assert torch.equal(getattr(ref.pcache, f.name),
                           getattr(fresh, f.name)), f.name
    sf = delta.sf_compute(ct.state, flags, params)
    assert torch.equal(ref.sf.re, sf.re) and torch.equal(ref.sf.im, sf.im)
    # the carried incremental caches agree with the rebuild
    np.testing.assert_allclose(ct.pcache.e_pair.numpy(),
                               fresh.e_pair.numpy(), rtol=1e-9, atol=1e-9)
    for name in ("dx", "dy", "dz"):
        assert torch.equal(getattr(ct.pcache, name), getattr(fresh, name))
