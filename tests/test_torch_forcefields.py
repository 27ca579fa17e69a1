"""The energy terms beyond LJ (Lorentz-Berthelot) + Ewald, through the
JAX package and the port on the same inputs.

- ``mix_lj``: every mixing rule, elementwise on seeded arrays with zeros
  and negative (attractive-only) sigmas, within 1e-12 relative.
- The goldens of these terms through the port's ``energy_breakdown`` are
  in tests/test_torch_dense.py::test_energy_breakdown_matches_golden.
- A small flagship-shaped system (8 frozen framework sites, 10 CO2, 2
  dead slots; 44 atom slots) with per-type omega, C6/C8/C10/C9, and the
  PHAST2 or Buckingham parameters where a setting reads them:
  - ``energy_breakdown`` per component against the JAX package's,
    within 1e-10 relative, for every pairwise setting, Feynman-Hibbs,
    the crystal sums, the many-body vdW term (with and without
    vdw_fh_2be), disp_expansion_mbvdw and Axilrod-Teller;
  - ``energy_breakdown_blocked`` in 16-row tiles (3 tiles) against the
    JAX package's, for the pairwise settings;
  - ``delta_energy`` of a displacement, an insertion and a removal
    against the JAX package's and against the port's own difference of
    two full recomputes.  Two exceptions, where the port is held to its
    full recompute alone: Wolf on insertion and removal (the JAX package
    adds the Ewald self-term difference, which the Wolf sum does not
    have; the test asserts that its gap equals alpha * sum q^2 / sqrt(pi)
    of the molecule), and Silvera-Goldman with Feynman-Hibbs (the JAX
    package's move window reads the wrong molecule's mass).  Where the
    JAX package raises (exp_repulsion's pair LRC on [S,A] and [B,A]
    pairs) the twins compare with rd_lrc off.
- Routing: the many-body, crystal-sum and mbvdw terms stay on the dense
  path (the JAX package lets mbvdw through to the incremental one), and
  under use_sg or rd_only the polar cache is off; both cavity checks
  fire on a clash in both packages.
- Step for step against the JAX chain (2 x 16 moves, a refresh after
  each chunk): uVT with Feynman-Hibbs order 4 on the polarization
  cache, uVT with DREIDING on the incremental LJ/Ewald branch (134
  slots), and NVT with the many-body vdW term on the dense full
  recompute (44 slots).
- The flags of the special moves still raise and name themselves.
"""

import dataclasses

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
from mpmcxx_tpu.ops import delta as delta_j  # noqa: E402
from mpmcxx_tpu.ops import energy as energy_j  # noqa: E402
from mpmcxx_tpu.ops import pairwise as pairwise_j  # noqa: E402
from mpmcxx_tpu.state import AtomRecord as AtomRecord_j  # noqa: E402
from mpmcxx_tpu.state import build_state as build_state_j  # noqa: E402
from mpmcxx_tpu.state import topology as topology_j  # noqa: E402
from mpmcxx_tpu_torch import runner as runner_t  # noqa: E402
from mpmcxx_tpu_torch.mc import chain as chain_t  # noqa: E402
from mpmcxx_tpu_torch.ops import delta as delta_t  # noqa: E402
from mpmcxx_tpu_torch.ops import energy as energy_t  # noqa: E402
from mpmcxx_tpu_torch.ops import pairwise as pairwise_t  # noqa: E402
from mpmcxx_tpu_torch.state import state_from_jax  # noqa: E402
from mpmcxx_tpu_torch.state import topology as topology_t  # noqa: E402

REL = 1e-10
L = 18.0
# per-type omega (a.u.) and C6/C8/C10/C9 (a.u.) of the terms that read them
SITE = {"Fw": dict(omega=1.10, c6=25.0, c8=600.0, c10=1.5e4, c9=300.0),
        "CC": dict(omega=0.90, c6=15.0, c8=350.0, c10=9.0e3, c9=120.0),
        "OC": dict(omega=0.80, c6=11.0, c8=230.0, c10=6.0e3, c9=80.0)}
# PHAST2 form: sigma = Born-Mayer radius (A), epsilon = exponent (1/A)
PHAST2 = {"Fw": (3.40, 3.2), "CC": (3.10, 3.6), "OC": (2.95, 3.9)}
# Buckingham: sigma = C (K), epsilon = rho (A)
BUCK = {"Fw": (4.0e5, 0.28), "CC": (3.0e5, 0.25), "OC": (2.5e5, 0.24)}

# setting -> (FFlags kwargs, RunParams kwargs, per-type (sigma, epsilon))
PAIRWISE = {
    "waldmanhagler": (dict(waldmanhagler=True), {}, None),
    "halgren": (dict(halgren_mixing=True), {}, None),
    "c6_mixing": (dict(c6_mixing=True), {}, None),
    "lj_9th": (dict(cdvdw_9th_repulsion=True), {}, None),
    "sig_repulsion": (dict(cdvdw_sig_repulsion=True), {}, None),
    "buffered_14_7": (dict(using_lj_buffered_14_7=True), {}, None),
    "dreiding": (dict(use_dreiding=True), {}, None),
    "sg": (dict(use_sg=True), {}, None),
    "disp_expansion": (dict(using_disp_expansion=True, damp_dispersion=True,
                            extrapolate_disp_coeffs=True), {}, PHAST2),
    "disp_schmidt": (dict(using_disp_expansion=True, schmidt_ff=True), {},
                     PHAST2),
    "exp_repulsion": (dict(cdvdw_exp_repulsion=True), {}, BUCK),
    "wolf": (dict(wolf=True), {}, None),
    "rd_only": (dict(rd_only=True), {}, None),
    "cavity_absolute": (dict(cavity_autoreject_absolute=True,
                             cavity_autoreject=True),
                        dict(cavity_autoreject_scale=0.5), None),
    "fh2": (dict(feynman_hibbs=True, feynman_hibbs_order=2), {}, None),
    "fh4": (dict(feynman_hibbs=True, feynman_hibbs_order=4), {}, None),
    "fh4_sig": (dict(feynman_hibbs=True, feynman_hibbs_order=4,
                     cdvdw_sig_repulsion=True), {}, None),
    "fh4_exp": (dict(feynman_hibbs=True, feynman_hibbs_order=4,
                     cdvdw_exp_repulsion=True), {}, BUCK),
    "fh2_sg": (dict(feynman_hibbs=True, feynman_hibbs_order=2,
                    use_sg=True), {}, None),
}
POLAR = dict(polarization=True, polar_iterative=True, polar_ewald=True,
             polar_max_iter=4, damp_type=const.DAMPING_EXPONENTIAL)
DENSE_ONLY = {
    "rd_crystal": (dict(rd_crystal=True, rd_crystal_order=2), {}, None),
    "polarvdw": (dict(polarvdw=True, **POLAR), {}, None),
    "polarvdw_fh": (dict(polarvdw=True, feynman_hibbs=True,
                         feynman_hibbs_order=4, **POLAR), {}, None),
    "polarvdw_fh_2be": (dict(polarvdw=True, feynman_hibbs=True,
                             feynman_hibbs_order=4, vdw_fh_2be=True,
                             **POLAR), {}, None),
    "polarvdw_exp": (dict(polarvdw=True, cdvdw_exp_repulsion=True, **POLAR),
                     {}, BUCK),
    "disp_mbvdw": (dict(using_disp_expansion=True, disp_expansion_mbvdw=True,
                        damp_dispersion=True), {}, PHAST2),
    "axilrod_teller": (dict(using_axilrod_teller=True), {}, None),
    "axilrod_teller_mk": (dict(using_axilrod_teller=True,
                               midzuno_kihara_approx=True), {}, None),
}
COMPONENTS = ("rd", "coulombic", "polarization", "vdw", "three_body",
              "cavity_penalty", "total")


def _records(se):
    recs = co2.records(seed=5, box=L, n_mol=10, g=3)
    for r in recs:
        r.update(SITE[r["atomtype"]])
        if se is not None:
            r["sigma"], r["epsilon"] = se[r["atomtype"]]
    return recs


def _system(setting):
    """(JAX state, flags, params), (port state, flags, params)."""
    fkw, pkw, se = {**PAIRWISE, **DENSE_ONLY}[setting]
    sj = build_state_j([AtomRecord_j(**r) for r in _records(se)],
                       np.eye(3) * L, extra_mol_capacity=2)[0]
    st = state_from_jax(co2.jax_state_numpy(sj))
    base = dict(polarization=False, polar_mixed=False)
    out = []
    for sys_ in (co2.jax_system(), co2.torch_system()):
        flags, params = sys_[2], sys_[3]
        out.append((flags.replace(**{**base, **fkw}),
                    dataclasses.replace(params, temperature=77.0, **pkw)))
    return (sj,) + tuple(out[0]), (st,) + tuple(out[1])


def _close(got, want, rel=REL, scale=None):
    got, want = float(got), float(want)
    tol = rel * max(abs(want), abs(scale) if scale is not None else 0.0)
    assert abs(got - want) <= tol, (got, want)


# --- mixing rules ---------------------------------------------------------

MIX = {"lb": {}, "waldmanhagler": dict(waldmanhagler=True),
       "wh_sig": dict(waldmanhagler=True, cdvdw_sig_repulsion=True),
       "halgren": dict(halgren_mixing=True),
       "lj_9th": dict(cdvdw_9th_repulsion=True),
       "sig_repulsion": dict(cdvdw_sig_repulsion=True),
       "exp_repulsion": dict(cdvdw_exp_repulsion=True),
       "disp_expansion": dict(using_disp_expansion=True),
       "disp_schmidt": dict(using_disp_expansion=True, schmidt_ff=True),
       "disp_extrapolate": dict(using_disp_expansion=True,
                                extrapolate_disp_coeffs=True),
       "c6_mixing": dict(c6_mixing=True), "sg": dict(use_sg=True)}


@pytest.mark.parametrize("rule", list(MIX))
def test_mix_lj_matches_jax(rule):
    rng = np.random.default_rng(17)
    n = 24

    def col(lo, hi, zeros=True, negative=False):
        v = rng.uniform(lo, hi, n)
        if zeros:
            v[rng.choice(n, 4, replace=False)] = 0.0
        if negative:
            v[rng.choice(n, 4, replace=False)] *= -1.0
        return v

    eps, sig = col(0.0, 200.0), col(0.5, 4.0, negative=True)
    w, a = col(0.3, 1.5), col(0.0, 3.0)
    c6, c8, c10 = col(1.0, 40.0), col(10.0, 900.0), col(1e3, 2e4)
    args_np = []
    for v in (eps, sig, w, a, c6, c8, c10):
        args_np += [v[:, None], v[None, :]]
    (ei, ej, si, sj, wi, wj, ai, aj, c6i, c6j, c8i, c8j, c10i,
     c10j) = args_np
    order = (ei, ej, si, sj, wi, wj, ai, aj, c6i, c6j, c8i, c8j, c10i, c10j)
    fj = co2.jax_system()[2].replace(**MIX[rule])
    ft = co2.torch_system()[2].replace(**MIX[rule])
    want = pairwise_j.mix_lj(fj, *[jnp.asarray(x) for x in order])
    got = pairwise_t.mix_lj(ft, *[torch.as_tensor(x) for x in order])
    names = ("sigma", "epsilon", "attractive_only", "sigrep", "c6", "c8",
             "c10")
    for name, g, w_ in zip(names, got, want):
        w_ = np.broadcast_to(np.asarray(w_), (n, n))
        g = g.numpy()
        if name == "attractive_only":
            np.testing.assert_array_equal(g, w_)
            continue
        assert np.isnan(g).tolist() == np.isnan(w_).tolist(), name
        np.testing.assert_allclose(g, w_, rtol=1e-12, atol=0.0, err_msg=name)


# --- full energies --------------------------------------------------------

@pytest.mark.parametrize("setting", list(PAIRWISE) + list(DENSE_ONLY))
def test_energy_breakdown_matches_jax(setting):
    (sj, fj, pj), (st, ft, pt) = _system(setting)
    ej = energy_j.energy_breakdown(sj, fj, pj)
    et = energy_t.energy_breakdown(st, ft, pt)
    for name in COMPONENTS:
        _close(getattr(et, name), getattr(ej, name))
    assert np.isfinite(float(et.total))
    fkw = {**PAIRWISE, **DENSE_ONLY}[setting][0]
    if fkw.get("polarvdw") or fkw.get("disp_expansion_mbvdw"):
        assert float(et.vdw if fkw.get("polarvdw") else et.rd) != 0.0
    if fkw.get("using_axilrod_teller"):
        assert float(et.three_body) != 0.0
    if fkw.get("wolf"):
        # Wolf has no reciprocal or self term
        pair = energy_t.ewald.coulombic_wolf(
            st, pairwise_t.build_pairs(st, ft), ft, pt)
        assert float(et.coulombic) == float(pair)


@pytest.mark.parametrize("setting", list(PAIRWISE))
def test_energy_breakdown_blocked_matches_jax(setting):
    """16-row tiles over 44 slots: the pair sums per tile, the
    whole-system self and LRC sums once."""
    (sj, fj, pj), (st, ft, pt) = _system(setting)
    assert st.n_atom_slots == 44
    et = energy_t.energy_breakdown_blocked(st, ft, pt, block=16)
    dense = energy_t.energy_breakdown(st, ft, pt)
    for name in COMPONENTS:
        _close(getattr(et, name), getattr(dense, name), rel=1e-9)
    fj, ft = _jax_exp_lrc_fault(fj, ft, lambda f: energy_j.
                                energy_breakdown_blocked(sj, f, pj, block=16))
    ej = energy_j.energy_breakdown_blocked(sj, fj, pj, block=16)
    et = energy_t.energy_breakdown_blocked(st, ft, pt, block=16)
    for name in COMPONENTS:
        _close(getattr(et, name), getattr(ej, name))


def _jax_exp_lrc_fault(fj, ft, call):
    """The JAX package's exp_repulsion builds the pair LRC's SPECTRE mask
    on [A,A] (pair_potentials.py:429-430), so on [B,A] tiles and [S,A]
    move windows with rd_lrc on it raises; there the twins compare with
    rd_lrc off (the port's rd_lrc-on result is held to its own dense
    recompute)."""
    if not (fj.cdvdw_exp_repulsion and fj.rd_lrc):
        return fj, ft
    with pytest.raises(TypeError, match="incompatible shapes"):
        call(fj)
    return fj.replace(rd_lrc=False), ft.replace(rd_lrc=False)


@pytest.mark.parametrize("setting", list(DENSE_ONLY))
def test_dense_only_terms_stay_dense(setting):
    """The many-body and crystal-sum terms never reach the blocked or
    incremental paths; disp_expansion_mbvdw among them, which the JAX
    package's delta.supports lets through."""
    (_, fj, _), (st, ft, pt) = _system(setting)
    assert not delta_t.supports(ft)
    opts = runner_t.capacity_opts(co2.torch_system()[4], ft, st)
    assert not opts.incremental and not opts.polar_incremental
    with pytest.raises(ValueError, match="dense-only"):
        energy_t.energy_breakdown_blocked(st, ft, pt)
    if setting == "disp_mbvdw":
        assert delta_j.supports(fj)


def test_cavity_penalties_trigger():
    """Molecule slot 4 moved 0.4 A from an atom of slot 5: the absolute
    penalty on the dense, blocked and [S,A] pairs, and the per-pair
    cavity_autoreject MAXVALUE in rd, in both packages."""
    (sj, fj, pj), (_, ft, pt) = _system("cavity_absolute")
    starts, _ = topology_j(sj)
    a, b = int(starts[4]), int(starts[5])
    pos = np.array(sj.pos)
    pos[a:a + 3] += pos[b] + np.array([0.4, 0.0, 0.0]) - pos[a]
    sj = sj.replace(pos=jnp.asarray(pos))
    st = state_from_jax(co2.jax_state_numpy(sj))
    ej = energy_j.energy_breakdown(sj, fj, pj)
    for et in (energy_t.energy_breakdown(st, ft, pt),
               energy_t.energy_breakdown_blocked(st, ft, pt, block=16)):
        assert float(et.cavity_penalty) == float(ej.cavity_penalty) == \
            const.MAXVALUE
        assert float(et.rd) >= const.MAXVALUE
        _close(et.rd, ej.rd)
    rows = torch.arange(a, a + 3)
    pen = energy_t.cavity_absolute_check(
        st, pairwise_t.build_pairs_rect(st, ft, rows), pt)
    assert float(pen) == const.MAXVALUE


@pytest.mark.parametrize("flag", ["use_sg", "rd_only"])
def test_sg_and_rd_only_skip_the_polar_cache(flag):
    """Under use_sg or rd_only the full energy carries no electrostatics
    and no polarization; the JAX package's polar cache would still carry
    the polarization per move, so the port routes such a run to the full
    recompute."""
    from mpmcxx_tpu.ops import polar_cache as pcache_j
    from mpmcxx_tpu_torch.ops import polar_cache as pcache_t
    state, _, flags, params, opts = co2.torch_system()
    assert pcache_t.supports(flags, state.n_atom_slots)
    ft = flags.replace(**{flag: True})
    assert pcache_j.supports(co2.jax_system()[2].replace(**{flag: True}))
    assert not pcache_t.supports(ft, state.n_atom_slots)
    o = runner_t.capacity_opts(opts, ft, state)
    assert not (o.incremental or o.polar_incremental)
    eb = energy_t.energy_breakdown(state, ft, params)
    assert float(eb.polarization) == float(eb.coulombic) == 0.0


# --- incremental Delta-E --------------------------------------------------

MOVES = ("displace", "insert", "remove")


def _move_states(sj, move):
    """(old, new, rows) of one move of molecule slot 4 (a CO2)."""
    mol = 4
    starts, counts = topology_j(sj)
    rows = np.arange(starts[mol], starts[mol] + 3)
    assert counts[mol] == 3 and bool(sj.mol_alive[mol])
    if move == "displace":
        return sj, moves_j.displace(sj, jax.random.PRNGKey(2), mol, 0.2,
                                    1.0), rows
    dead = moves_j.remove(sj, mol)
    return (dead, sj, rows) if move == "insert" else (sj, dead, rows)


def _delta(d, old, new, rows, flags, params):
    if d.uses_recip(flags):
        sf = d.sf_compute(old, flags, params)
    elif d is delta_t:
        sf = delta_t.empty_sf(old.pos.device)
    else:
        sf = delta_j.SFCache(jnp.zeros(0), jnp.zeros(0))
    return d.delta_energy(old, new, rows, sf, flags, params)


@pytest.mark.parametrize("move", MOVES)
@pytest.mark.parametrize("setting", list(PAIRWISE))
def test_delta_energy_matches_jax(setting, move):
    (sj, fj, pj), (_, ft, pt) = _system(setting)
    old_j, new_j, rows = _move_states(sj, move)
    old_t = state_from_jax(co2.jax_state_numpy(old_j))
    new_t = state_from_jax(co2.jax_state_numpy(new_j))
    rows_j, rows_t = jnp.asarray(rows, jnp.int32), torch.as_tensor(rows)
    # the port against its own difference of two full recomputes
    dt = _delta(delta_t, old_t, new_t, rows_t, ft, pt)
    e_old = energy_t.energy_breakdown(old_t, ft, pt)
    e_new = energy_t.energy_breakdown(new_t, ft, pt)
    for got, name in ((dt.d_rd, "rd"), (dt.d_coul, "coulombic")):
        full = float(getattr(e_new, name)) - float(getattr(e_old, name))
        _close(got, full, scale=float(getattr(e_old, name)))
    fj, ft = _jax_exp_lrc_fault(
        fj, ft, lambda f: _delta(delta_j, old_j, new_j, rows_j, f, pj))
    dj = _delta(delta_j, old_j, new_j, rows_j, fj, pj)
    dt = _delta(delta_t, old_t, new_t, rows_t, ft, pt)
    e_old = energy_t.energy_breakdown(old_t, ft, pt)
    if fj.use_sg and fj.feynman_hibbs:
        # on the move window the JAX package reads the row molecule's mass
        # (pair_potentials.py:264), its full recompute the lower index's:
        # its Delta-E misses its own full recompute where they differ
        full_rd = float(e_new.rd) - float(e_old.rd)
        assert abs(float(dj.d_rd) - full_rd) > 1e3 * REL * abs(
            float(e_old.rd))
    else:
        _close(dt.d_rd, dj.d_rd, scale=float(e_old.rd))
    if ft.wolf and move != "displace":
        # the JAX package adds the Ewald self-term difference the Wolf
        # total does not have: alpha * sum q^2 / sqrt(pi) of the molecule
        q = np.asarray(sj.charge)[rows]
        gap = pj.ewald_alpha * np.sum(q * q) / np.sqrt(const.pi)
        sign = 1.0 if move == "remove" else -1.0
        assert gap > 1e3
        _close(float(dj.d_coul) - float(dt.d_coul), sign * gap)
    else:
        _close(dt.d_coul, dj.d_coul, scale=float(e_old.coulombic))
    if delta_t.uses_recip(ft):
        _close(dt.recip_new, dj.recip_new)
        np.testing.assert_allclose(dt.sf_new.re.numpy(),
                                   np.asarray(dj.sf_new.re), rtol=1e-10,
                                   atol=1e-9)


# --- chains ---------------------------------------------------------------

CHUNK, N_CHUNKS = 16, 2
CHAINS = {
    # FFlags kwargs, MCOptions kwargs, RunParams temperature
    "uvt_fh4_cache": (dict(feynman_hibbs=True, feynman_hibbs_order=4),
                      dict(blocked_energy=False), 77.0),
    "uvt_dreiding": (dict(use_dreiding=True, polarization=False),
                     dict(polar_incremental=False, blocked_energy=False),
                     150.0),
    "nvt_polarvdw": (dict(polarvdw=True, polar_mixed=False),
                     dict(ensemble=const.ENSEMBLE_NVT, incremental=False,
                          polar_incremental=False, blocked_energy=False),
                     150.0),
}


def _chain_case(system, name, state):
    _, _, flags, params, opts = system
    fkw, okw, T = CHAINS[name]
    return (state, flags.replace(**fkw),
            dataclasses.replace(params, temperature=T),
            dataclasses.replace(opts, **okw))


def _chain_states(name):
    """The small CO2 system (134 slots) in both packages; for the
    many-body term, whose every move solves two [3A, 3A] eigenproblems,
    the 44-slot one of the energy twins with its omega."""
    if name == "nvt_polarvdw":
        recs, extra = _records(None), 2
    else:
        recs, extra = co2.records(), co2.EXTRA
    sj = build_state_j([AtomRecord_j(**r) for r in recs], np.eye(3) * co2.L,
                       extra_mol_capacity=extra)[0]
    return sj, state_from_jax(co2.jax_state_numpy(sj))


def _run(chain, topology, case):
    state, flags, params, opts = case
    carry = chain.init_carry(state, flags, params, opts, seed=1)
    runner = chain.make_chunk_runner(flags, params, opts, CHUNK,
                                     topology=topology(state))
    refresher = chain.make_refresher(flags, params, opts)
    rows, movetype, accepted = [], [], []
    for _ in range(N_CHUNKS):
        carry, outs = runner(carry)
        inc = (float(carry.obs.energy), float(carry.obs.rd_energy),
               float(carry.obs.polarization_energy))
        carry = refresher(carry)
        rows.append(inc + (float(carry.obs.energy), float(carry.obs.rd_energy),
                           float(carry.obs.polarization_energy),
                           float(carry.obs.vdw_energy), float(carry.obs.N)))
        movetype += [int(m) for m in np.asarray(outs.movetype)]
        accepted += [bool(a) for a in np.asarray(outs.accepted)]
    return carry, rows, movetype, accepted


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_matches_jax(name):
    sj, st = _chain_states(name)
    cj, ej, mj, aj = _run(chain_j, topology_j,
                          _chain_case(co2.jax_system(), name, sj))
    ct, et, mt, at = _run(chain_t, topology_t,
                          _chain_case(co2.torch_system(), name, st))
    assert mt == mj and at == aj
    assert 0 < sum(at) < len(at)
    if name.startswith("uvt"):
        assert {const.MOVETYPE_INSERT, const.MOVETYPE_REMOVE,
                const.MOVETYPE_DISPLACE} <= set(mt)
    # the f32 planes carry the polarization on the cache path
    rel = 1e-6 if name == "uvt_fh4_cache" else 1e-9
    for row_j, row_t in zip(ej, et):
        np.testing.assert_allclose(row_t, row_j, rtol=rel, atol=1e-9)
        # incremental rd within 1e-8 of its refresh
        assert row_t[1] == pytest.approx(row_t[4], rel=1e-8, abs=1e-8)
    np.testing.assert_allclose(ct.state.pos.numpy(), np.asarray(cj.state.pos),
                               rtol=0, atol=1e-9)
    if name == "nvt_polarvdw":
        assert all(r[6] != 0.0 for r in et)


# --- the special moves' terms, and what still raises ---------------------

@pytest.mark.parametrize("flag", [
    {"rd_anharmonic": True}, {"gwp": True}, {"spectre": True},
    {"feynman_kleinert": True}, {"quantum_rotation": True},
    {"rd_anharmonic_k": 2.0}, {"rd_anharmonic_g": 0.5},
    {"spectre": True, "polar_palmo": True},
    {"gwp": True, "polar_wolf": True},
    {"feynman_kleinert": True, "polar_gs": True},
    {"quantum_rotation": True, "damp_type": const.DAMPING_LINEAR}])
def test_special_terms_match_jax(flag):
    """The special moves' terms (they once raised here) against the JAX
    package under the many-body vdW term, with polarization on and off,
    whatever SCF and Thole damping they come with."""
    (sj, fj, pj), (st, ft, pt) = _system("polarvdw")
    for pol in (True, False):
        ej = energy_j.energy_breakdown(
            sj, fj.replace(polarization=pol, **flag), pj)
        et = energy_t.energy_breakdown(
            st, ft.replace(polarization=pol, **flag), pt)
        for name in ("rd", "coulombic", "polarization", "vdw", "kinetic",
                     "total"):
            _close(getattr(et, name), getattr(ej, name),
                   scale=float(ej.total))


@pytest.mark.parametrize("flag", [{"damp_type": 7}])
def test_unported_terms_raise(flag):
    """A value outside a field's range raises and names the field, with
    polarization on and off."""
    _, (st, ft, pt) = _system("polarvdw")
    name = next(iter(flag))
    with pytest.raises(NotImplementedError, match=name):
        energy_t.energy_breakdown(st, ft.replace(**flag), pt)
    with pytest.raises(NotImplementedError, match=name):
        energy_t.energy_breakdown(
            st, ft.replace(polarization=False, **flag), pt)
