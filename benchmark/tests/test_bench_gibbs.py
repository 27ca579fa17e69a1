"""The Gibbs cell's inputs and judge: box B's lattice start has no
overlap; on a small cut of the cell on the CPU (both boxes at the cell's
densities in 30 A boxes, transfers and volume exchanges frequent) the
program passes and the float32 control fails; and three faults planted
underneath fail the judge, each by its own number."""

import copy
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.inputs import geometry
from benchmark.manifest import ROOT, Manifest
from benchmark.tests.test_bench_inputs import _least_distance

pytest.importorskip("mpmcxx_tpu_torch")

CELL = "co2-vle-250k.gemc"
SMALL_L = 30.0


def _fails(checks):
    return [k for k, v in checks.items()
            if v["value"] is not None and not v["value"] <= v["limit"]]


def test_box_b_start_has_no_overlap():
    man = Manifest()
    cfg = man.config(man.workload(CELL)["config"])
    geo = cfg["geometry_b"]
    mols = geometry.molecules(cfg["model"], geo)
    assert mols.shape == (geo["molecules"], len(cfg["model"]["sites"]), 3)
    sigma = max(s["sigma"] for s in cfg["model"]["sites"])
    assert _least_distance(mols, geo["box"]) > 1.2 * sigma
    assert geo["box"] == cfg["geometry"]["box"]


def small(corrtime=16, volume_probability=0.2):
    """(config, traffic) of the cell at the same densities in SMALL_L
    boxes."""
    man = Manifest()
    cell = man.workload(CELL)
    cfg = copy.deepcopy(man.config(cell["config"]))
    f = (SMALL_L / cfg["geometry"]["box"]) ** 3
    for geo in ("geometry", "geometry_b"):
        cfg[geo]["molecules"] = round(cfg[geo]["molecules"] * f)
        cfg[geo]["box"] = SMALL_L
    cfg["slots"] = cfg["slots_b"] = None
    tr = copy.deepcopy(man.traffic(cell["traffic"]))
    tr.update(corrtime=corrtime, chunk=4)
    tr["runin"].update(transfer_probability=0.3,
                       volume_probability=volume_probability)
    return cfg, tr


def run_small(seed=2 ** 31 + 9, seconds=2.0, control=False, corrtime=16,
              volume_probability=0.2):
    cfg, tr = small(corrtime, volume_probability)
    return harness.run_cell(CELL, seed, seconds, False, device="cpu",
                            config=cfg, traffic=tr,
                            limits=Manifest().limits(CELL), control=control)


def test_program_passes_and_control_fails():
    res = run_small(control=True)
    assert res["correct"], res["checks"]
    assert res["window"]["moves"] > 0 and res["window"]["accepted"] > 0
    assert res["window"]["judged"] == 2
    assert _fails(res["control"]), res["control"]
    assert res["failed"] == 0


def plant_stale_structure_factors(monkeypatch):
    """The receiving box keeps its structure factors and k-space energy
    when a molecule is inserted."""
    from mpmcxx_tpu_torch.ops import delta
    real = delta.delta_energy

    def stale(old, new, rows, sf, flags, params, recip_old=None):
        res = real(old, new, rows, sf, flags, params, recip_old=recip_old)
        if int(new.mol_alive.sum()) > int(old.mol_alive.sum()):
            return res._replace(sf_new=sf, recip_new=recip_old)
        return res

    monkeypatch.setattr(delta, "delta_energy", stale)


def plant_volume_loss(monkeypatch):
    """Box B keeps its side while box A takes its new one in a volume
    exchange.  Returns the list of ``scale_box`` calls."""
    from mpmcxx_tpu_torch.mc import moves
    real = moves.scale_box
    calls = []

    def lossy(state, factor):
        calls.append(1)
        return state if len(calls) % 2 == 0 else real(state, factor)

    monkeypatch.setattr(moves, "scale_box", lossy)
    return calls


def plant_source_keeps_molecule(monkeypatch):
    """The source box's removal leaves the molecule alive: the
    destination gains one, N_a + N_b grows."""
    from mpmcxx_tpu_torch.mc import moves
    monkeypatch.setattr(moves, "remove", lambda state, mol: state)


def plant_state_left_unchanged(monkeypatch):
    """Every displacement and transfer keeps the old state, energies,
    structure factors and counts, while the counters count it as the
    step decided; volume exchanges are made."""
    import dataclasses

    from mpmcxx_tpu_torch.mc import gibbs
    real = gibbs.make_gibbs_step

    def make(*a, **k):
        step = real(*a, **k)

        def kept(carry, d, move, a_to_b):
            new, out = step(carry, d, move, a_to_b)
            if move == gibbs.VOLUME:
                return new, out
            return dataclasses.replace(carry, step=new.step), out

        return kept

    monkeypatch.setattr(gibbs, "make_gibbs_step", make)


# each planted fault, and the number it has to fail
PLANTED = {"stale_structure_factors": (plant_stale_structure_factors,
                                       "recip_gap"),
           "volume_loss": (plant_volume_loss, "rd_gap"),
           "source_keeps_molecule": (plant_source_keeps_molecule, "n_gap"),
           "state_left_unchanged": (plant_state_left_unchanged, "unmoved")}


def test_stale_structure_factors_after_a_transfer(monkeypatch):
    """No volume exchange or refresh in the window rebuilds the stale
    structure factors."""
    plant_stale_structure_factors(monkeypatch)
    res = run_small(corrtime=256, volume_probability=0.0)
    assert not res["correct"]
    assert "recip_gap" in _fails(res["checks"]), res["checks"]


def test_volume_exchange_that_loses_volume(monkeypatch):
    calls = plant_volume_loss(monkeypatch)
    res = run_small()
    assert calls and not res["correct"]
    assert _fails(res["checks"]) == ["rd_gap"], res["checks"]


def test_transfer_that_keeps_the_source_molecule(monkeypatch):
    plant_source_keeps_molecule(monkeypatch)
    res = run_small()
    assert not res["correct"]
    assert "n_gap" in _fails(res["checks"]), res["checks"]
    assert res["checks"]["n_gap"]["value"] >= 1


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    """Its state stays consistent, so only ``unmoved`` can see it; the
    volume exchanges in the window rescale every molecule and must not
    hide it."""
    plant_state_left_unchanged(monkeypatch)
    res = run_small()
    assert res["window"]["accepted"] > 0
    assert not res["correct"]
    assert _fails(res["checks"]) == ["unmoved"], res["checks"]
    assert res["checks"]["unmoved"]["value"] == 1.0


def test_unmoved_sees_through_volume_exchanges():
    """A sound chain with many volume exchanges reads ``unmoved`` at or
    below 0."""
    res = run_small(volume_probability=0.5)
    assert res["correct"], res["checks"]
    assert res["checks"]["unmoved"]["value"] <= 0.0


def test_judge_refuses_a_box_that_is_not_cubic():
    from benchmark.ensembles import nvt_gibbs
    with pytest.raises(ValueError):
        nvt_gibbs.side(torch.diag(torch.tensor([30.0, 30.0, 31.0]))
                       .numpy())


def test_the_gibbs_path_loads_no_jax():
    """Importing the harness, the Gibbs ensemble file and the program's
    Gibbs chain leaves no forbidden module loaded."""
    import os
    import subprocess
    import sys
    from benchmark.manifest import ROOT
    code = ("import sys; sys.path[0] = %r\n"
            "from benchmark import harness\n"
            "from benchmark.ensembles import nvt_gibbs\n"
            "from benchmark.reference import gibbs\n"
            "from mpmcxx_tpu_torch import cli\n"
            "from mpmcxx_tpu_torch.mc import gibbs as g\n"
            "print(harness.forbidden_modules())\n" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
