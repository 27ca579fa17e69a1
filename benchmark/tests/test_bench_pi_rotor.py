"""The PI judge on charged beads, on a small PI cut of the BSSP H2 model
whose rotation is sampled as a quantum rotor (``small.pi_rotor``, with
its orientation staging): charged and incremental, each bead's k-space
is judged from its carried structure factors; polarizable, the chain
recomputes every bead in full and carries none, and ``recip_gap`` is the
Coulomb column's gap."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.inputs import geometry
from benchmark.inputs.runin import run_in
from benchmark.reference.energy import _kvecs
from benchmark.tests.small import pi_rotor, run_rotor, small

pytest.importorskip("mpmcxx_tpu_torch")


def _fails(checks):
    return [k for k, v in checks.items()
            if v["value"] is not None and not v["value"] <= v["limit"]]


def test_charged_rotor_passes_and_control_fails():
    res = run_rotor(polarization=False, control=True)
    assert res["correct"], res["checks"]
    assert res["window"]["moves"] > 0 and res["window"]["accepted"] > 0
    assert all(b["recip"] > 0 for st in res["reference"] for b in st)
    assert res["checks"]["recip_gap"]["value"] < 1e-9
    assert "recip_gap" in _fails(res["control"]), res["control"]


def test_polarizable_rotor_reads_the_coulomb_gap():
    res = run_rotor(polarization=True, control=True)
    assert res["correct"], res["checks"]
    assert res["window"]["moves"] > 0
    c = res["checks"]
    assert c["recip_gap"]["value"] == c["coul_gap"]["value"]
    assert _fails(res["control"]), res["control"]


def _built(tmp_path, cfg, tr, seed):
    from benchmark.ensembles import pi_nvt
    pqr = str(tmp_path / "input.pqr")
    geometry.write_pqr(pqr, cfg["model"],
                       geometry.molecules(cfg["model"], cfg["geometry"]))
    path = tmp_path / "run.in"
    path.write_text(run_in(cfg, tr, seed, pqr))
    return pi_nvt.build(str(path), cfg, tr, torch.device("cpu"))


def _judge(carry, cfg, tr):
    from benchmark.ensembles import pi_nvt
    st = harness.on_host(pi_nvt.snapshot(carry))
    return pi_nvt.judge(st, cfg, tr, torch.device("cpu"), False)[0]


def _with_sf(carry, re, im):
    return dataclasses.replace(carry, sf=type(carry.sf)(re, im))


def test_judge_holds_the_carried_structure_factors(tmp_path):
    """On the staged start of the charged cut: sound, ``recip_gap`` reads
    rounding; one bead's factors off by a millionth fail it, and so do
    two of its factors swapped, which leaves its k-space energy as it
    was; a lattice of another length contradicts the inputs."""
    cfg, tr, limits = pi_rotor(polarization=False)
    sim = _built(tmp_path, cfg, tr, 2 ** 31 + 97)
    c = sim.carry
    re, im = c.sf.re, c.sf.im
    assert re.shape == (tr["trotter"], len(_kvecs(7)))
    assert _judge(c, cfg, tr)["recip_gap"] < 1e-12

    off = re.clone()
    off[1] *= 1.0 + 1e-6
    assert _judge(_with_sf(c, off, im), cfg, tr)["recip_gap"] > \
        limits["recip_gap"]

    # two k-vectors of one |k|: the bead's energy is the same sum
    l2 = np.sum(_kvecs(7) ** 2, axis=1)
    i, j = np.nonzero(l2 == l2[0])[0][:2]
    swapped = [t.clone() for t in (re, im)]
    for t in swapped:
        t[2, [i, j]] = t[2, [j, i]]
    g = _judge(_with_sf(c, *swapped), cfg, tr)
    assert g["recip_gap"] > limits["recip_gap"]

    with pytest.raises(ValueError, match="k-vectors"):
        _judge(_with_sf(c, re[:, 1:], im[:, 1:]), cfg, tr)


def test_uncharged_judge_takes_any_lattice(tmp_path):
    """The uncharged PI cell's k-space energies are 0 on any lattice: a
    carried lattice of another length reads ``recip_gap`` 0."""
    cfg, tr = small("pi-h2-nvt.b16")
    c = _built(tmp_path, cfg, tr, 2 ** 31 + 96).carry
    g = _judge(_with_sf(c, c.sf.re[:, 1:], c.sf.im[:, 1:]), cfg, tr)
    assert g["recip_gap"] == 0.0


def test_judge_without_carried_factors_reads_the_coulomb_gap(tmp_path):
    """On the polarizable cut the carry holds no structure factors:
    ``recip_gap`` is ``coul_gap``, also where that is off."""
    cfg, tr, limits = pi_rotor(polarization=True)
    c = _built(tmp_path, cfg, tr, 2 ** 31 + 95).carry
    assert c.sf.re.shape == (tr["trotter"], 0)
    off = c.comps_per_bead.clone()
    off[2, 1] += 1.0                  # K, of a Coulomb scale of ~1e6 K
    g = _judge(dataclasses.replace(c, comps_per_bead=off), cfg, tr)
    assert g["recip_gap"] == g["coul_gap"] > limits["coul_gap"]
