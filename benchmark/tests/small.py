"""Small cuts of the benchmark's cells for CPU tests: the cell's own
configuration and traffic files with fewer molecules in a box of the
same density (the generator, the CLI path, the harness's loop and judge
are the cell's)."""

from __future__ import annotations

import copy

from benchmark import harness
from benchmark.manifest import Manifest

# molecules: 60 take the dense path, 240 the blocked one (>1,024 atom
# slots after the uVT headroom)
DENSE = 60
BLOCKED = 240
# A small cut's float32-plane polarization reads up to ~6e-8 of the
# float64 one (one rounding of a sum of few terms), so its limit is 1e-6
# where the cell's is lower; the control fails the other numbers by
# decades.
SMALL_POLAR_GAP = 1e-6


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
