"""Small cuts of the benchmark's cells for CPU tests: the cell's own
configuration and traffic files with fewer molecules in a box of the
same density (the generator, the CLI path, the harness's loop and judge
are the cell's)."""

from __future__ import annotations

import copy

from benchmark import harness
from benchmark.manifest import Manifest
from benchmark.reference import constants as C

# molecules: 60 take the dense path, 240 the blocked one (>1,024 atom
# slots after the uVT headroom)
DENSE = 60
BLOCKED = 240
# A small cut's float32-plane polarization reads up to ~6e-8 of the
# float64 one (one rounding of a sum of few terms), so its limit is 1e-6
# where the cell's is lower; the control fails the other numbers by
# decades.
SMALL_POLAR_GAP = 1e-6
# H2's rotation as a quantum rotor under PI: the orientation site (an H
# of BSSP's five, 0.371 A from the centre), the bond length and the
# reduced mass 1.008 / 2 amu, in kg as the keyword takes it
ROTOR = {"sorbate_orientation_site": "H2 1",
         "sorbate_bondlength": "H2 0.742",
         "sorbate_reducedMass": f"H2 {0.5 * 1.008 * C.AMU2KG!r}"}


def small(name: str, size=DENSE, man=None):
    """(config, traffic) of cell ``name`` cut to ``size`` molecules."""
    man = man or Manifest()
    cell = man.workload(name)
    cfg = copy.deepcopy(man.config(cell["config"]))
    geo = cfg["geometry"]
    geo["box"] = geo["box"] * (size / geo["molecules"]) ** (1.0 / 3.0)
    geo["molecules"] = size
    cfg["slots"] = None
    tr = copy.deepcopy(man.traffic(cell["traffic"]))
    tr.update(corrtime=8, chunk=4)
    if "cavity_grid" in tr["runin"]:
        tr["runin"]["cavity_grid"] = 8
    return cfg, tr


def run_small(name: str, seed: int = 2 ** 31 + 7, seconds: float = 1.5,
              size=DENSE, control: bool = False, trace_on: bool = False):
    man = Manifest()
    cfg, tr = small(name, size, man)
    limits = man.limits(name)
    limits["polar_gap"] = max(limits["polar_gap"], SMALL_POLAR_GAP)
    return harness.run_cell(name, seed, seconds, trace_on, device="cpu",
                            config=cfg, traffic=tr, limits=limits,
                            control=control)


def pi_rotor(polarization: bool, size=DENSE, corrtime=8, man=None):
    """(config, traffic, limits) of a PI cut of the ``h2-bssp-77k``
    model: ``size`` molecules at the cell's density under PI-NVT at 77 K
    on 4 beads, with ROTOR's orientation staging; charged, with
    ``polarization`` as the model states it or off (no Feynman-Hibbs: the
    beads carry the quantum correction).  The limits are the model's uVT
    cell's, with SMALL_POLAR_GAP."""
    man = man or Manifest()
    cfg = copy.deepcopy(man.config("h2-bssp-77k"))
    geo = cfg["geometry"]
    geo["box"] = geo["box"] * (size / geo["molecules"]) ** (1.0 / 3.0)
    geo["molecules"] = size
    cfg["slots"] = None
    polar = {k: v for k, v in cfg["physics"].items() if k.startswith("polar")}
    cfg["physics"] = {"ensemble": "pi_nvt", "temperature": 77.0, **ROTOR,
                      **(polar if polarization else {})}
    runin = {"bead_perturb_probability": 0.5, "pi_trial_chain_length": 2,
             "move_factor": 0.1}
    if polarization:
        runin["polar_max_iter"] = 4
    tr = {"name": "rotor", "trotter": 4, "runin": runin,
          "corrtime": corrtime, "chunk": 4, "profile_chunks": 1}
    limits = man.limits("h2-bulk-77k.fixed4")
    limits["polar_gap"] = max(limits["polar_gap"], SMALL_POLAR_GAP)
    return cfg, tr, limits


def run_rotor(polarization: bool, seed: int = 2 ** 31 + 10,
              seconds: float = 1.5, control: bool = False, corrtime=8):
    cfg, tr, limits = pi_rotor(polarization, corrtime=corrtime)
    # the PI cell's entry gives the rest: its chips and its metrics
    return harness.run_cell("pi-h2-nvt.b16", seed, seconds, False,
                            device="cpu", config=cfg, traffic=tr,
                            limits=limits, control=control)
