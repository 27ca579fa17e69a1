"""Running averages, errors, and derived thermodynamic quantities.

JAX twin: mpmcxx_tpu/mc/averages.py (a copy; numpy only).

Host-side numpy port of the statistics layer
(src/System.Averages.cpp:8-405, struct defs src/System.h:44-185): running
mean / mean-square / standard-error tracking per observable, heat capacity
and compressibility from fluctuations (with the Stirling gamma-ratio error
factor), isosteric heat, densities, and the nodestats acceptance-rate
machinery.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import field
from typing import Dict, Optional

import numpy as np

from .. import constants as const

TRACKED = ["energy", "coulombic_energy", "rd_energy", "polarization_energy",
           "vdw_energy", "three_body_energy", "dipole_rrms",
           "kinetic_energy", "temperature", "volume", "N", "spin_ratio"]

NS_TRACKED = ["boltzmann_factor", "acceptance_rate", "acceptance_rate_insert",
              "acceptance_rate_remove", "acceptance_rate_displace",
              "acceptance_rate_adiabatic", "acceptance_rate_spinflip",
              "acceptance_rate_volume", "acceptance_rate_ptemp",
              "acceptance_rate_beadPerturb", "cavity_bias_probability",
              "polarization_iterations"]


@dataclasses.dataclass
class AvgObservables:
    """avg_observables_t equivalent: mean/sq/error per tracked quantity plus
    derived quantities."""

    mean: Dict[str, float] = field(default_factory=lambda: {k: 0.0 for k in TRACKED + NS_TRACKED})
    sq: Dict[str, float] = field(default_factory=lambda: {k: 0.0 for k in TRACKED + NS_TRACKED})
    err: Dict[str, float] = field(default_factory=lambda: {k: 0.0 for k in TRACKED + NS_TRACKED})
    counter: int = 0
    ns_counter: int = 0
    energy_sq_sq: float = 0.0
    energy_sq_error: float = 0.0
    NU: float = 0.0
    density: float = 0.0
    density_sq: float = 0.0
    density_error: float = 0.0
    heat_capacity: float = 0.0
    heat_capacity_error: float = 0.0
    compressibility: float = 0.0
    compressibility_error: float = 0.0
    qst: float = 0.0
    percent_wt: float = 0.0
    percent_wt_error: float = 0.0
    percent_wt_me: float = 0.0
    percent_wt_me_error: float = 0.0
    excess_ratio: float = 0.0
    excess_ratio_error: float = 0.0
    pore_density: float = 0.0
    pore_density_error: float = 0.0

    def update(self, obs: dict, *, ensemble: int, temperature: float,
               volume: float, particle_mass: float, free_volume: float = 0.0,
               fugacity: Optional[float] = None, pressure: float = 0.0,
               gibbs: bool = False) -> None:
        """Average one observables sample in
        (update_root_averages, src/System.Averages.cpp:8-208)."""
        self.counter += 1
        m = float((self.counter - 1) // 2) if gibbs else float(self.counter)
        sdom = 1.0 / math.sqrt(m - 1.0) if m > 1 else 0.0
        factor = (m - 1.0) / m

        for k in TRACKED:
            v = float(obs.get(k, 0.0))
            self.mean[k] = factor * self.mean[k] + v / m
            self.sq[k] = factor * self.sq[k] + v * v / m
            var = self.sq[k] - self.mean[k] ** 2
            self.err[k] = sdom * math.sqrt(max(var, 0.0))

        e = float(obs.get("energy", 0.0))
        self.energy_sq_sq = factor * self.energy_sq_sq + e ** 4 / m
        self.energy_sq_error = sdom * math.sqrt(
            max(self.energy_sq_sq - self.mean["energy"] ** 4, 0.0))

        self.NU = factor * self.NU + float(obs.get("NU", 0.0)) / m

        curr_density = (float(obs.get("N", 0.0)) * particle_mass /
                        (volume * const.NA * const.A32CM3))
        self.density = factor * self.density + curr_density / m
        self.density_sq = factor * self.density_sq + curr_density ** 2 / m
        self.density_error = sdom * math.sqrt(
            max(self.density_sq - self.density ** 2, 0.0))

        # Stirling-approximated gamma ratio for sstdev
        if m > 2:
            gammaratio = ((m - 2.0) / (m - 1.0)) ** (0.5 * m - 1.0) * \
                math.sqrt(0.5 * (m - 2.0)) * math.exp(0.5)
            inner = (m - 1.0 - 2.0 * gammaratio ** 2) / self.counter
            gammaratio = math.sqrt(max(inner, 0.0))
        else:
            gammaratio = 0.0

        if temperature > 0:
            self.heat_capacity = (const.kB * const.NA / 1000.0) * \
                (self.sq["energy"] - self.mean["energy"] ** 2) / \
                (temperature * temperature)
            self.heat_capacity_error = sdom * 2.0 * gammaratio * \
                self.heat_capacity

            if ensemble != const.ENSEMBLE_NPT:
                denom = const.kB * temperature * self.mean["N"] ** 2
                if denom != 0.0:
                    self.compressibility = const.ATM2PASCALS * \
                        (volume / const.METER2ANGSTROM ** 3) * \
                        (self.sq["N"] - self.mean["N"] ** 2) / denom
            else:
                denom = const.kB * temperature * self.mean["volume"]
                if denom != 0.0:
                    self.compressibility = const.ATM2PASCALS * \
                        const.METER2ANGSTROM ** -3 * \
                        (self.sq["volume"] - self.mean["volume"] ** 2) / denom
            self.compressibility_error = sdom * 2.0 * gammaratio * \
                self.compressibility

        frozen_mass = float(obs.get("frozen_mass", 0.0))
        if frozen_mass > 0.0:
            N_avg = self.mean["N"]
            N_err = self.err["N"]
            self.percent_wt = 100.0 * N_avg * particle_mass / \
                (frozen_mass + N_avg * particle_mass)
            self.percent_wt_error = sdom * 100.0 * N_err * particle_mass / \
                (frozen_mass + N_err * particle_mass)
            self.percent_wt_me = 100.0 * N_avg * particle_mass / frozen_mass
            self.percent_wt_me_error = sdom * 100.0 * N_err * particle_mass \
                / frozen_mass

            if free_volume > 0.0:
                f = fugacity if fugacity is not None else pressure
                self.excess_ratio = 1000.0 * (
                    N_avg * particle_mass -
                    particle_mass * free_volume * f * const.ATM2REDUCED /
                    temperature) / frozen_mass
                self.excess_ratio_error = sdom * 1000.0 * N_err * \
                    particle_mass / frozen_mass
                self.pore_density = curr_density * volume / free_volume
                self.pore_density_error = sdom * N_err * particle_mass / \
                    (free_volume * const.NA * const.A32CM3)

            dN2 = self.sq["N"] - self.mean["N"] ** 2
            if dN2 != 0.0:
                qst = -(self.NU - self.mean["N"] * self.mean["energy"]) / dN2
                qst += temperature
                self.qst = qst * const.kB * const.NA / 1000.0

    def update_nodestats(self, ns: dict) -> None:
        """Average per-corrtime nodestats in (update_root_nodestats,
        src/System.Averages.cpp:357-395)."""
        self.ns_counter += 1
        m = float(self.ns_counter)
        new_f = 1.0 / m
        factor = (m - 1.0) / m
        for k in NS_TRACKED:
            v = float(ns.get(k, 0.0))
            self.mean[k] = factor * self.mean[k] + v * new_f
            self.sq[k] = factor * self.sq[k] + v * v * new_f
        if m > 1:
            sdom = 1.0 / math.sqrt(m - 1.0)
            for k in ("boltzmann_factor", "cavity_bias_probability",
                      "polarization_iterations"):
                var = self.sq[k] - self.mean[k] ** 2
                self.err[k] = sdom * math.sqrt(max(var, 0.0))


def nodestats_from_counters(accept: np.ndarray, reject: np.ndarray,
                            boltzmann_factor: float,
                            cavity_bias_probability: float = 0.0,
                            polarization_iterations: float = 0.0) -> dict:
    """Convert accept/reject counters into acceptance rates (track_ar,
    src/System.Output.cpp:572-621)."""
    tot = accept.sum() + reject.sum()

    def rate(i):
        d = accept[i] + reject[i]
        return float(accept[i] / d) if d > 0 else 0.0

    return {
        "boltzmann_factor": boltzmann_factor,
        "acceptance_rate": float(accept.sum() / tot) if tot else 0.0,
        "acceptance_rate_insert": rate(const.MOVETYPE_INSERT),
        "acceptance_rate_remove": rate(const.MOVETYPE_REMOVE),
        "acceptance_rate_displace": rate(const.MOVETYPE_DISPLACE),
        "acceptance_rate_adiabatic": rate(const.MOVETYPE_ADIABATIC),
        "acceptance_rate_spinflip": rate(const.MOVETYPE_SPINFLIP),
        "acceptance_rate_volume": rate(const.MOVETYPE_VOLUME),
        "acceptance_rate_beadPerturb": rate(const.MOVETYPE_PERTURB_BEADS),
        "acceptance_rate_ptemp": 0.0,
        "cavity_bias_probability": cavity_bias_probability,
        "polarization_iterations": polarization_iterations,
    }
