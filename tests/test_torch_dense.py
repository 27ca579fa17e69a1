"""The dense [A,A] full-energy path of small systems and the float64
SCF, through the JAX package and the port on the same inputs.

- ``build_pairs``, ``thole_amatrix``, ``thole_field`` and ``polar.polar``
  (fixed K = 4 and 6 Jacobi iterations, polar_precision 0) on the atoms of
  the 7-atom ``polar_ewald`` golden fixture: within 1e-10 relative (the
  same float64 formulas, summed in another order).
- ``energy_breakdown`` on 39 goldens of every mixing rule, repulsion-
  dispersion form, Feynman-Hibbs order, Wolf, the 3-body term, every
  polar solver, static field and damping, and the special moves' terms
  (the anharmonic well, the GWP Coulomb and kinetic terms, SPECTRE), the
  system built with the port's own parser: within the goldens' 2e-6
  absolute (tests/test_golden.py).
- ``energy_breakdown_blocked`` at 1,034 atom slots with polarization off
  and with polar_mixed off (the float64 matrix-free SCF): within 1e-10
  relative of the JAX package's."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_co2_system as co2  # noqa: E402
from mpmcxx_tpu import constants as const_j  # noqa: E402
from mpmcxx_tpu.ops import energy as energy_j  # noqa: E402
from mpmcxx_tpu.ops import pairwise as pairwise_j  # noqa: E402
from mpmcxx_tpu.ops import polar as polar_j  # noqa: E402
from mpmcxx_tpu.state import AtomRecord as AtomRecord_j  # noqa: E402
from mpmcxx_tpu.state import build_state as build_state_j  # noqa: E402
from mpmcxx_tpu_torch import constants as const_t  # noqa: E402
from mpmcxx_tpu_torch.config.parser import parse_config  # noqa: E402
from mpmcxx_tpu_torch.ops import energy as energy_t  # noqa: E402
from mpmcxx_tpu_torch.ops import pairwise as pairwise_t  # noqa: E402
from mpmcxx_tpu_torch.ops import polar as polar_t  # noqa: E402
from mpmcxx_tpu_torch.state import AtomRecord as AtomRecord_t  # noqa: E402
from mpmcxx_tpu_torch.state import build_state as build_state_t  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
REL = 1e-10


def _fixture(name):
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        return json.load(f)


def _build(fix, AtomRecord, build_state, const, config_extra=None):
    """(state, flags, params) of a golden fixture's atoms in one package
    (the recipe of tests/test_golden.py::build_from_fixture): its atom
    table, or its literal PQR (``pqr_text``) through the package's
    reader."""
    if "pqr_text" in fix:
        if const is const_j:
            from mpmcxx_tpu.io.pqr import read_pqr
        else:
            from mpmcxx_tpu_torch.io.pqr import read_pqr
        atoms = read_pqr(fix["pqr_text"], is_text=True)
    else:
        atoms = [AtomRecord(atomtype=at, moleculetype=mt, molecule_id=mid,
                            x=x, y=y, z=z, mass=mass,
                            charge=q * const.E2REDUCED, polarizability=al,
                            epsilon=eps, sigma=sig, omega=om, gwp_alpha=gw,
                            c6=c6, c8=c8, c10=c10, c9=c9)
                 for (at, mt, mid, x, y, z, mass, q, al, eps, sig, om, gw,
                      c6, c8, c10, c9) in fix["atoms"]]
    dev = {} if const is const_j else {"device": "cpu"}
    state = build_state(atoms, np.eye(3) * fix["basis"], **dev)[0]
    if const is const_j:
        from mpmcxx_tpu.config.parser import parse_config as parse
    else:
        parse = parse_config
    cfg = parse(fix["config_extra"] if config_extra is None
                else config_extra)
    cfg.temperature = fix["temperature"]
    params = cfg.to_params()
    cutoff = fix["basis"] / 2.0
    if not cfg.ewald_alpha_set:
        params = dataclasses.replace(params, ewald_alpha=3.5 / cutoff)
    if not cfg.polar_ewald_alpha_set:
        params = dataclasses.replace(params, polar_ewald_alpha=3.5 / cutoff)
    return state, cfg.to_flags(), params


POLAR_CONFIG = ("polarization on\npolar_iterative on\npolar_ewald on\n"
                "polar_damp_type exponential\npolar_damp 2.1304\n"
                "polar_gamma 1.0\npolar_max_iter {k}\n")


def _polar_pair(k):
    fix = _fixture("polar_ewald")
    cfg = POLAR_CONFIG.format(k=k)
    sj, fj, pj = _build(fix, AtomRecord_j, build_state_j, const_j, cfg)
    st, ft, pt = _build(fix, AtomRecord_t, build_state_t, const_t, cfg)
    return (sj, fj, pj), (st, ft, pt)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) <= rel * scale


def test_build_pairs_matches_jax():
    (sj, fj, _), (st, ft, _) = _polar_pair(4)
    pj = pairwise_j.build_pairs(sj, fj)
    pt = pairwise_t.build_pairs(st, ft)
    assert pt.rows is None and pt.rimg.shape == (7, 7)
    for name in ("dimg", "rimg", "r", "sigma", "epsilon"):
        _close(getattr(pt, name).numpy(), getattr(pj, name), rel=1e-14)
    for name in ("pair_once", "alive", "same_mol", "frozen", "rd_excluded",
                 "es_excluded", "attractive_only"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)), name)


def test_thole_amatrix_and_field_match_jax():
    (sj, fj, pj), (st, ft, pt) = _polar_pair(4)
    pairs_j = pairwise_j.build_pairs(sj, fj)
    pairs_t = pairwise_t.build_pairs(st, ft)
    A_j = np.array(polar_j.thole_amatrix(sj, pairs_j, fj, pj))
    A_t = polar_t.thole_amatrix(st, pairs_t, ft, pt).numpy()
    assert A_t.shape == (7, 7, 3, 3)
    # the 1/alpha diagonal, then the off-diagonal blocks
    idx = np.arange(7)
    _close(A_t[idx, idx], A_j[idx, idx])
    A_j[idx, idx] = A_t[idx, idx] = 0.0
    _close(A_t, A_j)
    _close(polar_t.thole_field(st, pairs_t, ft, pt).numpy(),
           polar_j.thole_field(sj, pairs_j, fj, pj))


@pytest.mark.parametrize("k", [4, 6])
def test_polar_matches_jax(k):
    (sj, fj, pj), (st, ft, pt) = _polar_pair(k)
    rj = polar_j.polar(sj, pairwise_j.build_pairs(sj, fj), fj, pj)
    rt = polar_t.polar(st, pairwise_t.build_pairs(st, ft), ft, pt)
    assert float(rt.energy) == pytest.approx(float(rj.energy), rel=REL)
    _close(rt.mu.numpy(), rj.mu)
    assert float(rt.iterations) == float(rj.iterations) == k
    assert float(rt.dipole_rrms) == pytest.approx(float(rj.dipole_rrms),
                                                  rel=1e-8)


GOLDENS = ["lj_lb", "lj_nolrc", "lb_attractive_only", "triatomic_ewald",
           "axilrod_teller", "axilrod_teller_mk", "disp_expansion",
           "disp_nodamp", "disp_tt_damped", "dreiding", "exp_repulsion",
           "lj_9th_repulsion", "lj_buffered_14_7", "lj_c6_mixing", "lj_fh2",
           "lj_fh4", "lj_halgren", "lj_rd_crystal", "lj_wh",
           "wh_attractive_only", "sg", "wolf",
           # the polar solvers (exp_repulsion above also runs its own
           # config: "polarvdw on" turns on a precision-terminated SCF on
           # the no-PBC field)
           "polar_damp_off", "polar_esor", "polar_ewald", "polar_ewald_full",
           "polar_exact", "polar_gs", "polar_gs_ranked", "polar_linear_damp",
           "polar_nopbc", "polar_palmo", "polar_sor", "polar_wolf",
           "polar_wolf_full", "polar_zodid",
           # the special moves' terms (the GWP golden compares kinetic)
           "anharmonic", "gwp_coulomb_kinetic", "spectre_nvt"]


@pytest.mark.parametrize("name", GOLDENS)
def test_energy_breakdown_matches_golden(name):
    """The reference binary's breakdown through the port's
    energy_breakdown, with each fixture's known_delta applied as
    tests/test_golden.py does (polar_ewald_full's records the
    reference's scalar k weight, which both packages correct)."""
    fix = _fixture(name)
    st, ft, pt = _build(fix, AtomRecord_t, build_state_t, const_t)
    eb = energy_t.energy_breakdown(st, ft, pt)
    exp = fix["expected"]
    deltas = fix.get("known_delta", {})
    field = {"rd": "rd", "coulombic": "coulombic", "polar": "polarization",
             "vdw": "vdw", "three_body": "three_body", "kinetic": "kinetic"}
    for comp in fix.get("compare", ["rd", "coulombic", "polar", "vdw"]):
        want = exp[comp] + deltas.get(comp, 0.0)
        assert float(getattr(eb, field[comp])) == pytest.approx(
            want, abs=2e-6), comp


def _blocked_pair(**flag_kw):
    """1,034 atom slots (8 framework atoms, 171 live and 171 dead CO2) in
    both packages, under the CO2 test system's force field changed by
    ``flag_kw``."""
    recs = co2.records(5, 28.0, 171, 6)
    sj = build_state_j([AtomRecord_j(**r) for r in recs], np.eye(3) * 28.0,
                       extra_mol_capacity=171)[0]
    st = build_state_t([AtomRecord_t(**r) for r in recs], np.eye(3) * 28.0,
                       extra_mol_capacity=171, device="cpu")[0]
    _, _, fj, pj, _ = co2.jax_system()
    _, _, ft, pt, _ = co2.torch_system()
    alpha = 3.5 / 14.0
    pj = dataclasses.replace(pj, ewald_alpha=alpha, polar_ewald_alpha=alpha)
    pt = dataclasses.replace(pt, ewald_alpha=alpha, polar_ewald_alpha=alpha)
    return (sj, fj.replace(**flag_kw), pj), (st, ft.replace(**flag_kw), pt)


@pytest.mark.parametrize("flag_kw", [{"polarization": False},
                                     {"polar_mixed": False}],
                         ids=["no_polarization", "f64_scf"])
def test_energy_breakdown_blocked_matches_jax(flag_kw):
    (sj, fj, pj), (st, ft, pt) = _blocked_pair(**flag_kw)
    assert st.n_atom_slots == 1034
    ej = energy_j.energy_breakdown_blocked(sj, fj, pj)
    et = energy_t.energy_breakdown_blocked(st, ft, pt)
    for name in ("rd", "coulombic", "polarization", "total"):
        want = float(getattr(ej, name))
        assert float(getattr(et, name)) == pytest.approx(
            want, rel=REL, abs=0.0 if want else 1e-300), name
    _close(et.mu.numpy(), ej.mu)
    if not flag_kw.get("polarization", True):
        assert float(et.polarization) == 0.0
        assert not bool(torch.any(et.mu != 0.0))
    else:
        assert float(et.polarization) < 0.0


def test_blocked_static_field_matches_jax_and_dense():
    """thole_field_blocked (the field log's E_static on the f64 blocked
    path) against the JAX package's and the port's dense thole_field."""
    (sj, fj, pj), (st, ft, pt) = _blocked_pair(polar_mixed=False)
    want = np.asarray(polar_j.thole_field_blocked(sj, fj, pj))
    got = polar_t.thole_field_blocked(st, ft, pt).numpy()
    _close(got, want)
    dense = polar_t.thole_field(st, pairwise_t.build_pairs(st, ft), ft, pt)
    _close(got, dense.numpy())
