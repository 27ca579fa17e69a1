"""The port's two-box Gibbs chain on TraPPE CO2 against the plain float64
reference of the benchmark (``benchmark/reference``), on the CPU.

A small cut of the benchmark's ``co2-trappe-vle-250k`` deployment: 24
and 8 rigid 3-site CO2 in two 24 A boxes at 250 K, LJ and Ewald, built
as the cell builds it (the benchmark's lattice generator, its ``run.in``,
``cli.dispatch`` through ``ensembles/nvt_gibbs.build``) and driven with
``mc/gibbs``'s public chunk runner, with transfers and volume exchanges
frequent enough that every kind of move is accepted, on the incremental
path's dense and blocked full recomputes.

- After a few hundred steps with no refresh, each box's carried rd,
  Coulomb and k-space energies match ``energy_terms`` at the box's own
  side (the cell's judge, at its limits).
- Each accepted transfer's and volume exchange's Boltzmann factor
  matches ``reference/gibbs.py`` evaluated on the reference's energies of
  the states before and after.
- N_a + N_b and V_a + V_b are conserved.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmark import harness  # noqa: E402
from benchmark.ensembles import nvt_gibbs  # noqa: E402
from benchmark.inputs import geometry  # noqa: E402
from benchmark.inputs.runin import run_in  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from benchmark.reference import gibbs as ref_gibbs  # noqa: E402
from benchmark.reference import physics as ref_physics  # noqa: E402
from benchmark.reference.energy import energy_terms  # noqa: E402
from mpmcxx_tpu_torch import constants as const  # noqa: E402
from mpmcxx_tpu_torch.mc import gibbs  # noqa: E402

CELL = "co2-vle-250k.gemc"
L = 24.0
N_A, N_B = 24, 8
STEPS, CHUNK = 240, 40


def _cut():
    """(config, traffic) of the cell cut to 24 + 8 molecules in 24 A
    boxes, with transfers and volume exchanges frequent."""
    man = Manifest()
    cell = man.workload(CELL)
    cfg = copy.deepcopy(man.config(cell["config"]))
    for geo, n in (("geometry", N_A), ("geometry_b", N_B)):
        cfg[geo].update(box=L, molecules=n)
    cfg["slots"] = cfg["slots_b"] = None
    tr = copy.deepcopy(man.traffic(cell["traffic"]))
    tr["runin"].update(transfer_probability=0.35, volume_probability=0.25,
                       move_factor=0.1)
    return cfg, tr


def _simulation(tmp_path, blocked, seed=2 ** 31 + 21):
    cfg, tr = _cut()
    pqr = tmp_path / "input.pqr"
    geometry.write_pqr(str(pqr), cfg["model"],
                       geometry.molecules(cfg["model"], cfg["geometry"]))
    path = tmp_path / "run.in"
    path.write_text(run_in(cfg, tr, seed, str(pqr)))
    sim = nvt_gibbs.build(str(path), cfg, tr, "cpu")
    if blocked:
        sim.opts = dataclasses.replace(sim.opts, blocked_energy=True)
    return sim, cfg, tr


def _box_reference(st, box, cfg, tr):
    """The reference's terms of one box of a host snapshot, at its own
    side and the program's Ewald alpha."""
    atoms, _ = harness.judge_inputs(
        {k: st[f"{k}_{box}"] for k in nvt_gibbs.LAYOUT}, cfg)
    phys = ref_physics.physics(cfg, tr)
    phys["ewald_alpha"] = nvt_gibbs._ewald_alpha(cfg, tr)
    return energy_terms(harness._to_torch(atoms, "cpu"), phys,
                        nvt_gibbs.side(st[f"basis_{box}"]))


def _live(st, box):
    return int(np.sum(st[f"mol_alive_{box}"] & ~st[f"mol_frozen_{box}"]))


@pytest.mark.parametrize("blocked", [False, True])
def test_carried_energies_match_the_reference_box_by_box(tmp_path,
                                                         blocked):
    sim, cfg, tr = _simulation(tmp_path, blocked)
    assert sim.opts.incremental
    assert sim.params.ewald_alpha == pytest.approx(3.5 / (L / 2))
    run = gibbs.make_gibbs_chunk_runner(sim.flags, sim.params, sim.opts,
                                        CHUNK, sim.topologies)
    carry = sim.carry
    for _ in range(STEPS // CHUNK):
        carry, _ = run(carry)
    # every kind of move was accepted: displacements, transfers (reported
    # as INSERT) and volume exchanges
    for mt in (const.MOVETYPE_DISPLACE, const.MOVETYPE_INSERT,
               const.MOVETYPE_VOLUME):
        assert int(carry.accept[mt]) > 0, mt
    st = harness.on_host(nvt_gibbs.snapshot(carry))
    assert st["volume_a"] != pytest.approx(L ** 3, rel=1e-6)
    limits = Manifest().limits(CELL)
    got, _, refs = nvt_gibbs.judge(st, cfg, tr, "cpu", False)
    for k in ("rd_gap", "coul_gap", "recip_gap", "polar_gap", "n_gap"):
        assert got[k] <= limits[k], (k, got[k])
    for box, ref in zip(nvt_gibbs.BOXES, refs):
        assert ref["recip"] > 0.0 and ref["coulombic"] != 0.0
        assert st[f"N_{box}"] == _live(st, box)
        assert st[f"rd_{box}"] == pytest.approx(ref["rd"], rel=1e-9)
        assert st[f"coulombic_{box}"] == pytest.approx(ref["coulombic"],
                                                       rel=1e-9)
        assert st[f"recip_{box}"] == pytest.approx(ref["recip"], rel=1e-9)
    # the totals: N and V conserved
    assert _live(st, "a") + _live(st, "b") == N_A + N_B
    assert st["volume_a"] + st["volume_b"] == pytest.approx(2 * L ** 3,
                                                            rel=1e-12)
    sides = [nvt_gibbs.side(st[f"basis_{b}"]) for b in nvt_gibbs.BOXES]
    assert sum(s ** 3 for s in sides) == pytest.approx(2 * L ** 3,
                                                       rel=1e-12)


def test_joint_factors_match_the_reference(tmp_path):
    """Step by step: each accepted transfer's and volume exchange's factor
    against reference/gibbs.py on the reference's energy changes."""
    sim, cfg, tr = _simulation(tmp_path, blocked=False, seed=2 ** 31 + 33)
    run = gibbs.make_gibbs_chunk_runner(sim.flags, sim.params, sim.opts, 1,
                                        sim.topologies)
    T = cfg["physics"]["temperature"]
    carry = sim.carry
    before = harness.on_host(nvt_gibbs.snapshot(carry))
    seen = {const.MOVETYPE_INSERT: 0, const.MOVETYPE_VOLUME: 0}
    for _ in range(160):
        carry, out = run(carry)
        after = harness.on_host(nvt_gibbs.snapshot(carry))
        mt = int(out.movetype[0])
        if bool(out.accepted[0]) and mt in seen:
            e0 = [_box_reference(before, b, cfg, tr) for b in "ab"]
            e1 = [_box_reference(after, b, cfg, tr) for b in "ab"]
            dE = [e1[i]["rd"] + e1[i]["coulombic"] - e0[i]["rd"] -
                  e0[i]["coulombic"] for i in range(2)]
            n = [_live(after, b) for b in "ab"]
            if mt == const.MOVETYPE_VOLUME:
                want = ref_gibbs.volume_factor(
                    n[0], n[1], before["volume_a"], after["volume_a"],
                    before["volume_b"], after["volume_b"], dE[0], dE[1], T)
            else:
                src = 0 if n[0] < _live(before, "a") else 1
                dst = 1 - src
                want = ref_gibbs.transfer_factor(
                    n[src], n[dst], before["volume_" + "ab"[src]],
                    before["volume_" + "ab"[dst]], dE[src], dE[dst], T)
                assert n[src] == _live(before, "ab"[src]) - 1
            assert float(out.boltzmann_factor[0]) == pytest.approx(
                want, rel=1e-7), mt
            seen[mt] += 1
        assert _live(after, "a") + _live(after, "b") == N_A + N_B
        assert after["volume_a"] + after["volume_b"] == pytest.approx(
            2 * L ** 3, rel=1e-12)
        before = after
    assert all(v > 0 for v in seen.values()), seen


def test_reference_factors_by_hand():
    """The reference's formulas on numbers worked out by hand."""
    assert ref_gibbs.transfer_factor(3, 5, 10.0, 20.0, 0.0, 0.0, 100.0) \
        == pytest.approx(3 / 10 * 20 / 6)
    assert ref_gibbs.transfer_factor(1, 1, 1.0, 1.0, 50.0, 50.0, 100.0) \
        == pytest.approx(0.5 * np.exp(-1.0))
    assert ref_gibbs.volume_factor(2, 3, 1.0, 2.0, 3.0, 2.0, 0.0, 0.0,
                                   1.0) == pytest.approx(8 * (2 / 3) ** 3)
    assert ref_gibbs.volume_factor(0, 0, 1.0, 1.0, 1.0, 1.0, -10.0, 0.0,
                                   5.0) == pytest.approx(np.exp(2.0))
