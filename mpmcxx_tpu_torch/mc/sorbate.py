"""Per-sorbate statistics (multi-species systems).

JAX twin: mpmcxx_tpu/mc/sorbate.py (a copy; numpy only).  The sorbate
tracking layer: per-species counts and
sorption metrics each corrtime (update_sorbate_info,
src/System.Averages.cpp:214-241; count_sorbates src/System.cpp:1555-1570),
running averages with error propagation and selectivity ratios
(update_root_sorb_averages, src/System.Averages.cpp:247-323), and the
stdout stats block (display_averages, src/System.Output.cpp:505-567).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import field
from typing import Dict, List

import numpy as np

from .. import constants as const

_TRACKED = ["avgN", "percent_wt", "percent_wt_me", "excess_ratio",
            "pore_density", "density"]


@dataclasses.dataclass
class SorbateStats:
    """One species: identity + running averages."""
    id: str
    mass: float
    mean: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in _TRACKED})
    sq: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in _TRACKED})
    err: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in _TRACKED})
    selectivity: float = 0.0
    selectivity_err: float = 0.0


class SorbateTracker:
    def __init__(self, species: Dict[str, int], mol_type: np.ndarray,
                 mol_mass: np.ndarray, movable: np.ndarray):
        """species: name -> index; arrays are per molecule slot."""
        self.mol_type = mol_type
        self.movable = movable
        self.stats: List[SorbateStats] = []
        self.species_idx: List[int] = []
        for name, idx in sorted(species.items(), key=lambda kv: kv[1]):
            sel = movable & (mol_type == idx)
            if not sel.any():
                continue
            mass = float(mol_mass[sel][0])
            self.stats.append(SorbateStats(id=name, mass=mass))
            self.species_idx.append(idx)
        self.counter = 0

    @property
    def count(self) -> int:
        return len(self.stats)

    def update(self, mol_alive: np.ndarray, *, volume: float,
               frozen_mass: float, total_mass: float, free_volume: float,
               pressure_or_fugacity: float, temperature: float) -> None:
        """Sample current counts and average them in."""
        self.counter += 1
        m = float(self.counter)
        sdom = 1.0 / math.sqrt(m - 1.0) if m > 1 else 0.0
        factor = (m - 1.0) / m

        for st, sp in zip(self.stats, self.species_idx):
            currN = int((mol_alive & self.movable &
                         (self.mol_type == sp)).sum())
            sorbed_mass = currN * st.mass
            cur = {
                "avgN": float(currN),
                "percent_wt": 100.0 * sorbed_mass / total_mass
                if total_mass else 0.0,
                "percent_wt_me": 100.0 * sorbed_mass / frozen_mass
                if frozen_mass else 0.0,
                "excess_ratio": 1000.0 * st.mass * (
                    currN - st.mass * free_volume * pressure_or_fugacity *
                    const.ATM2REDUCED / temperature) / frozen_mass
                if frozen_mass and temperature else 0.0,
                "density": sorbed_mass / (volume * const.NA * const.A32CM3),
                "pore_density": sorbed_mass /
                (free_volume * const.NA * const.A32CM3)
                if free_volume else 0.0,
            }
            for k in _TRACKED:
                st.mean[k] = factor * st.mean[k] + cur[k] / m
                st.sq[k] = factor * st.sq[k] + cur[k] ** 2 / m
                st.err[k] = sdom * math.sqrt(
                    max(st.sq[k] - st.mean[k] ** 2, 0.0))

        # selectivity: N_i / sum_{j != i} N_j with propagated error
        for i, st in enumerate(self.stats):
            num = st.mean["avgN"]
            rel = (st.err["avgN"] ** 2 / num ** 2) if num else 0.0
            den = 0.0
            for j, other in enumerate(self.stats):
                if j == i:
                    continue
                den += other.mean["avgN"]
                if other.mean["avgN"]:
                    rel += other.err["avgN"] ** 2 / other.mean["avgN"] ** 2
            st.selectivity = num / den if den else 0.0
            st.selectivity_err = st.selectivity * math.sqrt(rel)

    def display(self, out, sys_id: str = "",
                frozen_mass: float = 0.0) -> None:
        for st in self.stats:
            out.write(f"OUTPUT{sys_id}: Stats for {st.id}\n")
            out.write(f"             Average_N({st.id})= "
                      f"{st.mean['avgN']:.5f} +- {st.err['avgN']:.5f}\n")
            out.write(f"             Sorbed_Mass({st.id})= "
                      f"{st.mean['avgN'] * st.mass:.5f} +- "
                      f"{st.err['avgN'] * st.mass:.5f} g/mol\n")
            out.write(f"             density({st.id})= "
                      f"{st.mean['density']:.5e} +- "
                      f"{st.err['density']:.5e} g/cm^3\n")
            if frozen_mass > 0:
                out.write(f"             pore_density({st.id})= "
                          f"{st.mean['pore_density']:.5e} +- "
                          f"{st.err['pore_density']:.5e} g/cm^3\n")
                out.write(f"             excess_ratio({st.id})= "
                          f"{st.mean['excess_ratio']:.5e} +- "
                          f"{st.err['excess_ratio']:.5e} g/cm^3\n")
                out.write(f"             wt_%({st.id})= "
                          f"{st.mean['percent_wt']:.5f} +- "
                          f"{st.err['percent_wt']:.5e} %\n")
                out.write(f"             wt_%({st.id})(ME)= "
                          f"{st.mean['percent_wt_me']:.5f} +- "
                          f"{st.err['percent_wt_me']:.5e} %\n")
            out.write(f"             Selectivity({st.id})= "
                      f"{st.selectivity:.4f} +- {st.selectivity_err:.4f}\n")
