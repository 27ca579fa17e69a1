"""The float64 reference against the port's own full energy on the CPU,
for small cuts of each configuration, and the harness's judge on a state
the CLI built."""

import copy

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.inputs import geometry
from benchmark.inputs.runin import run_in
from benchmark.reference import physics as ref_physics
from benchmark.reference.energy import energy_terms
from benchmark.tests.small import BLOCKED, DENSE, small

pytest.importorskip("mpmcxx_tpu_torch")


def _sim(tmp_path, cfg, tr, seed):
    from mpmcxx_tpu_torch import cli
    from mpmcxx_tpu_torch.config.parser import read_config
    pqr = str(tmp_path / "input.pqr")
    geometry.write_pqr(pqr, cfg["model"],
                       geometry.molecules(cfg["model"], cfg["geometry"]))
    path = tmp_path / "run.in"
    path.write_text(run_in(cfg, tr, seed, pqr))
    return cli.dispatch(read_config(str(path)), 1, quiet=True,
                        device="cpu")


def _terms(sim, cfg, tr):
    snap = harness.on_host(harness.snapshot(sim.carry))
    atoms, n = harness.judge_inputs(snap, cfg)
    ta = {k: torch.as_tensor(v) for k, v in atoms.items()}
    return energy_terms(ta, ref_physics.physics(cfg, tr),
                        cfg["geometry"]["box"]), n


@pytest.mark.parametrize("cell,size,f64", [
    ("h2-bulk-77k.fixed4", DENSE, False), ("h2-bulk-77k.fixed4", DENSE, True),
    ("co2-bulk.plain", DENSE, False), ("co2-bulk.plain", BLOCKED, False),
    ("h2-bulk-77k.precise", DENSE, True),
    ("h2-bulk-77k.fixed4", BLOCKED, False)])
def test_reference_matches_the_ports_full_energy(tmp_path, cell, size, f64):
    """Every term of the initial state (the port's full recompute, dense
    or blocked): rd and Coulomb to 1e-12 of the sum of their parts'
    magnitudes (a bulk gas's Coulomb total is a near-cancellation of
    parts ~1e6 times larger, the scale the harness's gaps use), k-space
    (where the chain carries it) to 1e-10, polarization to 1e-10 with the
    port's float64 SCF (polar_mixed off) and to 1e-6 over its float32
    planes."""
    cfg, tr = small(cell, size)
    if f64:
        cfg = copy.deepcopy(cfg)
        cfg["physics"]["polar_mixed"] = "off"
    sim = _sim(tmp_path, cfg, tr, 2 ** 31 + 99)
    ref, n = _terms(sim, cfg, tr)
    obs = sim.carry.obs
    assert n == int(obs.N) == cfg["geometry"]["molecules"]
    for name, got, tol in (
            ("rd", obs.rd_energy, 1e-12 * ref["rd_scale"]),
            ("coulombic", obs.coulombic_energy,
             1e-12 * ref["coulombic_scale"]),
            ("recip", sim.carry.recip_e, 1e-10 * abs(ref["recip"]))):
        if name == "recip" and not sim.opts.incremental:
            continue
        assert abs(float(got) - ref[name]) <= tol, name
    pol = float(obs.polarization_energy)
    if ref_physics.physics(cfg, tr)["polarization"]:
        tol = 1e-10 if f64 else 1e-6
        assert abs(pol - ref["polarization"]) <= \
            tol * abs(ref["polarization"])
        assert ref["polarization"] < 0.0 and not ref["failed"]
    else:
        assert pol == ref["polarization"] == 0.0


def test_judge_refuses_a_molecule_short_of_a_site(tmp_path):
    cfg, tr = small("h2-bulk-77k.fixed4")
    sim = _sim(tmp_path, cfg, tr, 5)
    snap = harness.on_host(harness.snapshot(sim.carry))
    harness.judge_inputs(snap, cfg)
    snap["mol_id"] = snap["mol_id"].copy()
    snap["mol_id"][0] = snap["mol_id"][5]
    with pytest.raises(ValueError):
        harness.judge_inputs(snap, cfg)


def test_moved_share():
    mol_id = np.array([0, 0, 1, 1, 2, 2])
    frozen = np.array([True, False, False])
    alive = np.array([True, True, True])
    p0 = np.zeros((6, 3))
    p1 = p0.copy()
    p1[2] = 1.0
    # one accepted move of two movable molecules changes one of them
    assert harness.moved_share(p0, alive, p1, alive, mol_id, frozen, 1) == 0
    assert harness.moved_share(p0, alive, p0, alive, mol_id, frozen, 3) == 1
    gone = alive.copy()
    gone[2] = False
    # four accepted moves would change 2 (1 - 1/2^4) molecules; two did
    share = harness.moved_share(p0, alive, p1, gone, mol_id, frozen, 4)
    assert share == pytest.approx(1.0 - 2.0 / (2.0 * (1.0 - 0.5 ** 4)))


def test_pi_reference_matches_the_ports_per_bead_energy(tmp_path):
    """Each bead of the staged start of the PI cell's small cut: the
    reference of that bead alone (``energy_terms`` over the judge's atom
    table of the bead) against the port's ``pi_potential_per_bead``,
    rd to 1e-12 of the sum of its parts' magnitudes; the beads differ, so
    a reference of one bead for all would not pass."""
    from benchmark.ensembles import pi_nvt
    from mpmcxx_tpu_torch.mc import pi
    cfg, tr = small("pi-h2-nvt.b16")
    pqr = str(tmp_path / "input.pqr")
    geometry.write_pqr(pqr, cfg["model"],
                       geometry.molecules(cfg["model"], cfg["geometry"]))
    path = tmp_path / "run.in"
    path.write_text(run_in(cfg, tr, 2 ** 31 + 99, pqr))
    sim = pi_nvt.build(str(path), cfg, tr, torch.device("cpu"))
    comps, _ = pi.pi_potential_per_bead(pi.whole(sim.stack), sim.flags,
                                        sim.params)
    snap = harness.on_host(pi_nvt.snapshot(sim.carry))
    tables = [harness.judge_inputs(dict(snap, pos=p,
                                        mol_alive=snap["mol_alive"][0]),
                                   cfg) for p in snap["pos"]]
    assert all(n == cfg["geometry"]["molecules"] for _, n in tables)
    refs = [energy_terms({k: torch.as_tensor(v) for k, v in a.items()},
                         ref_physics.physics(cfg, tr),
                         cfg["geometry"]["box"]) for a, _ in tables]
    assert len(refs) == comps.shape[0] == tr["trotter"]
    rd = [r["rd"] for r in refs]
    assert max(rd) - min(rd) > 1e-6 * refs[0]["rd_scale"]
    for s, ref in enumerate(refs):
        assert abs(float(comps[s, 0]) - ref["rd"]) <= 1e-12 * ref["rd_scale"]
        assert float(comps[s, 1]) == ref["coulombic"] == 0.0
        assert float(comps[s, 2]) == ref["polarization"] == 0.0


def test_pi_judge_holds_the_bead_means(tmp_path):
    """The PI judge on the staged start of the small cut: sound, it reads
    rounding; the potential the acceptance reads taken as a bead sum, or
    the bead means the averages read off by a thousandth, fail
    ``rd_gap``."""
    import dataclasses

    from benchmark.ensembles import pi_nvt
    cfg, tr = small("pi-h2-nvt.b16")
    pqr = str(tmp_path / "input.pqr")
    geometry.write_pqr(pqr, cfg["model"],
                       geometry.molecules(cfg["model"], cfg["geometry"]))
    path = tmp_path / "run.in"
    path.write_text(run_in(cfg, tr, 2 ** 31 + 98, pqr))
    sim = pi_nvt.build(str(path), cfg, tr, torch.device("cpu"))
    dev = torch.device("cpu")

    def rd_gap(carry):
        st = harness.on_host(pi_nvt.snapshot(carry))
        return pi_nvt.judge(st, cfg, tr, dev, False)[0]["rd_gap"]

    c = sim.carry
    assert rd_gap(c) < 1e-12
    summed = torch.sum(c.comps_per_bead[:, :3])
    assert rd_gap(dataclasses.replace(c, potential_current=summed)) > 0.5
    off = c.obs_components * torch.tensor([1.001, 1.0, 1.0, 1.0],
                                          dtype=c.obs_components.dtype)
    assert rd_gap(dataclasses.replace(c, obs_components=off)) > 1e-4


def test_beads_left():
    from benchmark.ensembles.pi_nvt import beads_left
    mol_id = np.array([0, 0, 1, 1, 2, 2])
    p0 = np.zeros((4, 6, 3))
    assert beads_left(p0, p0, mol_id) == 0
    p1 = p0.copy()
    p1[:, 0] += 1.0          # one atom of molecule 0 on every bead
    p1[1:3, 2] += 1.0        # molecule 1 on two of the four beads
    assert beads_left(p0, p1, mol_id) == 1
    p1[:, 3] += 1.0          # and then on every bead
    assert beads_left(p0, p1, mol_id) == 0
