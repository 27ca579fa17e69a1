"""Run output: energy logs, stdout averages report, performance/ETA.

JAX twin: mpmcxx_tpu/io/output.py (a copy).

Reproduces the reference's output contract: the 12-column ``.energy.dat``
(+ csv) format (src/System.Output.cpp:29-62, 251-299), the per-corrtime
stdout averages report (display_averages, :304-567), and the sec/step + ETA
performance line (write_performance, :1234-1279).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import TextIO

from .. import constants as const
from ..mc.averages import AvgObservables

ENERGY_HEADER = ("#step #energy #coulombic #rd #polar #vdw #kinetic "
                 "#kin_temp #N #spin_ratio #volume #core_temp\n")
ENERGY_HEADER_CSV = ("#step,#energy,#coulombic,#rd,#polar,#vdw,#kinetic,"
                     "#kin_temp,#N,#spin_ratio,#volume,#core_temp\n")


def live(path: str) -> bool:
    """Whether an output ``path`` is set: neither empty nor /dev/null."""
    return bool(path) and path != "/dev/null"


def obs_to_dict(obs) -> dict:
    """The fields of an Observables as host floats."""
    return {f.name: float(getattr(obs, f.name))
            for f in dataclasses.fields(obs)}


def open_energy_file(path: str, csv: bool = False) -> TextIO:
    f = open(path, "w")
    f.write(ENERGY_HEADER_CSV if csv else ENERGY_HEADER)
    f.flush()
    return f


def write_observables(f: TextIO, step: int, obs: dict, core_temp: float,
                      csv: bool = False) -> None:
    vals = [obs.get("energy", 0.0), obs.get("coulombic_energy", 0.0),
            obs.get("rd_energy", 0.0), obs.get("polarization_energy", 0.0),
            obs.get("vdw_energy", 0.0), obs.get("kinetic_energy", 0.0),
            obs.get("temperature", 0.0), obs.get("N", 0.0),
            obs.get("spin_ratio", 0.0), obs.get("volume", 0.0), core_temp]
    sep = "," if csv else " "
    f.write(f"{step}" + "".join(f"{sep}{v:f}" for v in vals) + "\n")
    f.flush()


def display_averages(avg: AvgObservables, *, sys_id: str = "",
                     temperature: float = 0.0,
                     simulated_annealing: bool = False, gwp: bool = False,
                     ensemble: int = const.ENSEMBLE_NVT,
                     sorbate_count: int = 1, polar_rrms: bool = False,
                     out: TextIO = sys.stdout) -> None:
    """Per-corrtime stdout report (display_averages,
    src/System.Output.cpp:304-567)."""
    w = out.write
    m = avg.mean
    e = avg.err
    if m["boltzmann_factor"] > 0.0:
        w(f"OUTPUT{sys_id}: BF = {m['boltzmann_factor']:.5g} "
          f"+- {e['boltzmann_factor']:.5g}\n")
    if m["acceptance_rate"] > 0.0:
        line = (f"OUTPUT{sys_id}: AR = {m['acceptance_rate']:.5f} "
                f"({m['acceptance_rate_insert']:.5f} I/ "
                f"{m['acceptance_rate_remove']:.5f} R/ "
                f"{m['acceptance_rate_displace']:.5f} D")
        if m["acceptance_rate_adiabatic"] > 0.0:
            line += f"/ {m['acceptance_rate_adiabatic']:.5f} A"
        if m["acceptance_rate_spinflip"] > 0.0:
            line += f"/ {m['acceptance_rate_spinflip']:.5f} S"
        if m["acceptance_rate_volume"] > 0.0:
            line += f"/ {m['acceptance_rate_volume']:.5f} V"
        if m["acceptance_rate_ptemp"] > 0.0:
            line += f"/ {m['acceptance_rate_ptemp']:.5f} PT"
        if m["acceptance_rate_beadPerturb"] > 0.0:
            line += f"/ {m['acceptance_rate_beadPerturb']:.5f} BEAD"
        w(line + ")\n")
    if simulated_annealing:
        w(f"OUTPUT{sys_id}: Simulated Annealing Temperature = "
          f"{temperature:.5f} K\n")
    if m["cavity_bias_probability"] > 0.0:
        w(f"OUTPUT{sys_id}: Cavity bias probability = "
          f"{m['cavity_bias_probability']:.5f} "
          f"+- {e['cavity_bias_probability']:.5f}\n")

    if gwp:
        w(f"OUTPUT{sys_id}: total energy = {m['energy']/const.EV2K:.5f} "
          f"+- {e['energy']/const.EV2K:.5f} eV\n")
    elif ensemble == const.ENSEMBLE_PATH_INTEGRAL_NVT:
        w(f"OUTPUT{sys_id}: total energy          = {m['energy']:.5f} "
          f"+- {e['energy']:.5f} K\n")
    else:
        w(f"OUTPUT{sys_id}: potential energy = {m['energy']:.5f} "
          f"+- {e['energy']:.5f} K\n")

    if m["coulombic_energy"] != 0.0:
        w(f"OUTPUT{sys_id}: electrostatic energy = "
          f"{m['coulombic_energy']:.5f} +- {e['coulombic_energy']:.5f} K\n")
    if m["rd_energy"] != 0.0:
        w(f"OUTPUT{sys_id}: repulsion/dispersion energy = "
          f"{m['rd_energy']:.5f} +- {e['rd_energy']:.5f} K\n")
    if m["polarization_energy"] != 0.0:
        line = (f"OUTPUT{sys_id}: polarization energy = "
                f"{m['polarization_energy']:.5f} "
                f"+- {e['polarization_energy']:.5f} K")
        if polar_rrms and e["dipole_rrms"] != 0.0:
            line += (f" (iterations = {m['polarization_iterations']:.1f} "
                     f"+- {e['polarization_iterations']:.1f} rrms = "
                     f"{m['dipole_rrms']:e} +- {e['dipole_rrms']:e})")
        elif m["polarization_iterations"] != 0.0:
            line += (f" (iterations = {m['polarization_iterations']:.1f} "
                     f"+- {e['polarization_iterations']:.1f})")
        w(line + "\n")
    if m["vdw_energy"] != 0.0:
        w(f"OUTPUT{sys_id}: (coupled-dipole) vdw energy = "
          f"{m['vdw_energy']:.5f} +- {e['vdw_energy']:.5f} K\n")
    if m["kinetic_energy"] > 0.0:
        w(f"OUTPUT{sys_id}: kinetic energy = {m['kinetic_energy']:.5f} "
          f"+- {e['kinetic_energy']:.5f} K\n")
        w(f"OUTPUT{sys_id}: kinetic temperature = {m['temperature']:.5f} "
          f"+- {e['temperature']:.5f} K\n")
    w(f"OUTPUT{sys_id}: N = {m['N']:.5f} +- {e['N']:.5f} molecules\n")
    if sorbate_count == 1:
        w(f"OUTPUT{sys_id}: density = {avg.density:.5f} "
          f"+- {avg.density_error:.5f} g/cm^3\n")
        if avg.pore_density != 0.0:
            w(f"OUTPUT{sys_id}: pore density = {avg.pore_density:.5f} "
              f"+- {avg.pore_density_error:.5f} g/cm^3\n")
        if avg.percent_wt > 0.0:
            w(f"OUTPUT{sys_id}: wt %% = {avg.percent_wt:.5f} "
              f"+- {avg.percent_wt_error:.5f} %%\n")
            w(f"OUTPUT{sys_id}: wt %% (ME) = {avg.percent_wt_me:.5f} "
              f"+- {avg.percent_wt_me_error:.5f} %%\n")
        if avg.excess_ratio != 0.0:
            w(f"OUTPUT{sys_id}: excess adsorption ratio = "
              f"{avg.excess_ratio:.5f} +- {avg.excess_ratio_error:.5f} "
              f"mg/g\n")
    if avg.qst != 0.0:
        w(f"OUTPUT{sys_id}: qst = {avg.qst:.5f} kJ/mol\n")
    if avg.heat_capacity != 0.0:
        w(f"OUTPUT{sys_id}: heat capacity = {avg.heat_capacity:.5f} "
          f"+- {avg.heat_capacity_error:.6f} kJ/mol K\n")
    if avg.compressibility != 0.0:
        w(f"OUTPUT{sys_id}: compressibility = {avg.compressibility:.6g} "
          f"+- {avg.compressibility_error:.6g} atm^-1\n")
    out.flush()


class PerformanceTimer:
    """sec/step + ETA reporter (write_performance,
    src/System.Output.cpp:1234-1279)."""

    def __init__(self, numsteps: int):
        self.start = time.time()
        self.last_time = self.start
        self.last_step = 0
        self.numsteps = numsteps

    def report(self, step: int, out: TextIO = sys.stdout) -> float:
        now = time.time()
        dsteps = step - self.last_step
        sec_step = (now - self.last_time) / dsteps if dsteps else 0.0
        remaining = sec_step * (self.numsteps - step)
        out.write(f"OUTPUT: Grand Total Steps: {step}... "
                  f"[ {sec_step:.4f} sec/step, ETA = {remaining/3600.0:.2f} "
                  f"hrs ]\n")
        out.flush()
        self.last_time = now
        self.last_step = step
        return sec_step


def display_sim_control(cfg, out: TextIO = sys.stdout,
                        n_systems: int = 1) -> None:
    """Echo the resolved run configuration at startup with the reference's
    SIM_CONTROL lines in the reference's *runtime* order (check_config +
    initialization, src/SimulationControl.cpp:1617-2790, :48-186), so the
    startup stdout is diffable against the reference binary's for the
    examples/ inputs.  ``n_systems`` is the bead count for pi_nvt (per-
    SYSTEM file lines) and 2 for Gibbs (per-SYS box lines)."""
    from .. import constants as const

    o = out.write
    pi = cfg.ensemble == const.ENSEMBLE_PATH_INTEGRAL_NVT
    gibbs = cfg.ensemble == const.ENSEMBLE_NVT_GIBBS

    ens = {
        const.ENSEMBLE_UVT: "Grand canonical ensemble",
        const.ENSEMBLE_NVT: "Canonical ensemble",
        const.ENSEMBLE_PATH_INTEGRAL_NVT:
            "Canonical ensemble for Path Integrals",
        const.ENSEMBLE_NVT_GIBBS: "Gibbs ensemble",
        const.ENSEMBLE_SURF: "Potential energy surface",
        const.ENSEMBLE_SURF_FIT: "Potential energy surface fitting",
        const.ENSEMBLE_NVE: "Microcanonical ensemble",
        const.ENSEMBLE_TE: "Single-point energy calculation",
        const.ENSEMBLE_NPT: "Isobaric-Isothermal ensemble",
        const.ENSEMBLE_REPLAY: "Replaying trajectory",
    }.get(cfg.ensemble)
    if ens:
        o(f"SIM_CONTROL: {ens}\n")

    o(f"SIM_CONTROL: Each core performing {cfg.numsteps} simulation "
      f"steps.\n")
    o(f"SIM_CONTROL: System correlation time is {cfg.corrtime} steps.\n")
    if cfg.free_volume > 0.0:
        o(f"SIM_CONTROL: system free_volume is {cfg.free_volume:.3f} A^3\n")
    o(f"SIM_CONTROL: system temperature is {cfg.temperature:.3f} K\n")
    if cfg.parallel_tempering:
        o("SIM_CONTROL: Parallel tempering activated\n")
        if cfg.ptemp_freq:
            o(f"SIM_CONTROL: Parallel tempering frequency set to "
              f"{cfg.ptemp_freq} steps.\n")

    # ensemble-specific thermodynamics + move probabilities
    # (:1908-2103; PI at :1950-1954; Gibbs probabilities print later)
    if cfg.ensemble == const.ENSEMBLE_NVE:
        o(f"SIM_CONTROL: NVE energy is {cfg.total_energy:.3f} K\n")
    if cfg.ensemble == const.ENSEMBLE_NVT and cfg.quantum_rotation:
        o(f"SIM_CONTROL: spinflip probability is "
          f"{cfg.spinflip_probability:.6f}.\n")
        o(f"SIM_CONTROL: displace probability is "
          f"{1.0 - cfg.spinflip_probability:.6f}.\n")
    if pi:
        o(f"SIM_CONTROL: spinflip probability is "
          f"{cfg.spinflip_probability:.6f}.\n")
        o(f"SIM_CONTROL: bead perturbation probability is "
          f"{cfg.bead_perturb_probability:.6f}.\n")
        disp = 1.0 - cfg.spinflip_probability - cfg.bead_perturb_probability
        o(f"SIM_CONTROL: displace probability is {disp:.6f}.\n")
    if cfg.ensemble == const.ENSEMBLE_NPT:
        o(f"SIM_CONTROL: reservoir pressure is {cfg.pressure:.3f} atm\n")
        if cfg.volume_probability == 0.0:
            o("SIM_CONTROL: volume change probability is 1/N_molecules.\n")
            o("SIM_CONTROL: displace probability is 1-1/N_molecules.\n")
        else:
            o(f"SIM_CONTROL: volume change probability is "
              f"{cfg.volume_probability:.3f}\n")
            o(f"SIM_CONTROL: displace probability is "
              f"{1.0 - cfg.volume_probability:.3f}\n")
        o(f"SIM_CONTROL: volume change factor is "
          f"{cfg.volume_change_factor:.6f}.\n")
    if cfg.ensemble == const.ENSEMBLE_UVT:
        if cfg.user_fugacities:
            o("SIM_CONTROL: user defined fugacities are in use.\n")
            for i, f in enumerate(cfg.fugacities):
                o(f"SIM_CONTROL: fugacity[{i}] is set to {f:.3f} atm\n")
        elif cfg.pressure > 0.0:
            o(f"SIM_CONTROL: reservoir pressure is {cfg.pressure:.3f} "
              f"atm\n")
            for gas, on in (("H2", cfg.h2_fugacity),
                            ("CO2", cfg.co2_fugacity),
                            ("CH4", cfg.ch4_fugacity),
                            ("N2", cfg.n2_fugacity)):
                if on and cfg.fugacities:
                    o(f"SIM_CONTROL: {gas} fugacity = "
                      f"{cfg.fugacities[0]:.3f} atm\n")
        o(f"SIM_CONTROL: insert/delete probability is "
          f"{cfg.insert_probability:.6f}.\n")
        if cfg.quantum_rotation:
            o(f"SIM_CONTROL: spinflip probability is "
              f"{cfg.spinflip_probability * (1.0 - cfg.insert_probability):.6f}.\n")
            o(f"SIM_CONTROL: displace probability is "
              f"{(1.0 - cfg.spinflip_probability) * (1.0 - cfg.insert_probability):.6f}.\n")
        else:
            o(f"SIM_CONTROL: displace probability is "
              f"{1.0 - cfg.insert_probability:.6f}.\n")

    # change factors (:2126-2133)
    o(f"SIM_CONTROL: translation change factor is {cfg.move_factor:.5f}\n")
    o(f"SIM_CONTROL: rotation change factor is {cfg.rot_factor:.5f}\n")
    if cfg.gwp:
        o(f"SIM_CONTROL: gwp change factor is {cfg.gwp_probability:.3f}\n")
    if pi:
        o(f"SIM_CONTROL: bead perturbation trials will be performed on "
          f"sub-chains of length {cfg.PI_trial_chain_length}.\n")

    # cavity / SPECTRE (:2140-2187)
    if cfg.cavity_autoreject:
        o("SIM_CONTROL: cavity autorejection activated\n")
    if cfg.cavity_autoreject_absolute:
        o("SIM_CONTROL: cavity autoreject absolute activated\n")
    if cfg.cavity_bias:
        o("SIM_CONTROL: cavity-biased umbrella sampling activated\n")
        g = cfg.cavity_grid_size
        o(f"SIM_CONTROL: cavity grid size is {g}x{g}x{g} points with a "
          f"sphere radius of {cfg.cavity_radius:.3f} A\n")
    if cfg.spectre:
        o("SIM_CONTROL: SPECTRE algorithm activated\n")
        o(f"SIM_CONTROL: SPECTRE max charge = "
          f"{cfg.spectre_max_charge:.3f}\n")
        o(f"SIM_CONTROL: SPECTRE max target = "
          f"{cfg.spectre_max_target:.3f}\n")

    # potential selection (:1681-1727)
    if cfg.rd_only:
        o("SIM_CONTROL: calculating repulsion/dispersion only\n")
    if cfg.wolf:
        o("SIM_CONTROL: ES Wolf summation active\n")
    o("SIM_CONTROL: rd long-range corrections are %s\n"
      % ("ON" if cfg.rd_lrc else "OFF"))
    if cfg.rd_crystal:
        o(f"SIM_CONTROL: rd crystal order set to "
          f"{cfg.rd_crystal_order}.\n")
    if cfg.use_sg:
        o("SIM_CONTROL: Molecular potential is Silvera-Goldman\n")
    if cfg.waldmanhagler:
        o("SIM_CONTROL: Using Waldman-Hagler mixing rules for "
          "LJ-interactions.\n")
    if cfg.halgren_mixing:
        o("SIM_CONTROL: Using Halgren mixing rules for LJ-interactions.\n")
    if cfg.c6_mixing:
        o("SIM_CONTROL: Using C6 mixing rules for LJ-interactions.\n")
    if cfg.use_dreiding:
        o("SIM_CONTROL: Molecular potential is DREIDING\n")
    if cfg.using_lj_buffered_14_7:
        o("SIM_CONTROL: Molecular potential is lj_buffered_14_7\n")
    if cfg.using_disp_expansion:
        o("SIM_CONTROL: Using the dispersion coefficient expansion and "
          "exponential repulsion for LJ-interactions.\n")
        if cfg.extrapolate_disp_coeffs:
            o("SIM_CONTROL: Extrapolating the C10 coefficient from the C6 "
              "and C8 coefficients with disp_expansion.\n")
        if cfg.damp_dispersion:
            o("SIM_CONTROL: Using Tang-Toennies damping for dispersion "
              "interactions with disp_expansion.\n")
        if cfg.schmidt_ff:
            o("SIM_CONTROL: Using the Schmidt mixing rule for exponential "
              "repulsions with disp_expansion.\n")
    if cfg.rd_anharmonic:
        o(f"SIM_CONTROL: rd_anharmonic_k = {cfg.rd_anharmonic_k:.3f} "
          f"K/A^2\n")
        o(f"SIM_CONTROL: rd_anharmonic_g = {cfg.rd_anharmonic_g:.3f} "
          f"K/A^4\n")

    # Feynman-Hibbs / annealing / histogram (:2477-2596)
    if cfg.feynman_hibbs:
        o("SIM_CONTROL: Feynman-Hibbs effective potential activated\n")
        if cfg.feynman_kleinert:
            o("SIM_CONTROL: Feynman-Kleinert iteration method activated\n")
        elif cfg.feynman_hibbs_order == 2:
            o("SIM_CONTROL: Feynman-Hibbs second-order quantum correction "
              "activated\n")
        elif cfg.feynman_hibbs_order == 4:
            o("SIM_CONTROL: Feynman-Hibbs fourth-order quantum correction "
              "activated\n")
        else:
            o("SIM_CONTROL: Feynman-Hibbs order unspecified or specified "
              "with unsupported value--defaulting to h^2\n")
    if cfg.simulated_annealing:
        o("SIM_CONTROL: Simulated annealing active\n")
        o(f"SIM_CONTROL: Simulated annealing temperature schedule = "
          f"{cfg.simulated_annealing_schedule:.3f}\n")
        o(f"SIM_CONTROL: Simulated annealing target "
          f"{cfg.simulated_annealing_target:.6f}K.")
        if cfg.simulated_annealing_linear:
            o("SIM_CONTROL: Simulated annealing using a linear ramp.")
    if cfg.calc_hist:
        o("SIM_CONTROL: Histogram calculation will be performed.\n")
        o(f"SIM_CONTROL: histogram resolution set to "
          f"{cfg.hist_resolution:.3f} A\n")
        if cfg.frozen_output:
            o(f"SIM_CONTROL: will be writing frozen coordinates to "
              f"{cfg.frozen_output}\n")

    # polarization block (:2610-2780)
    if cfg.polarization:
        o("SIM_CONTROL: Thole polarization activated\n")
        if cfg.polar_wolf or cfg.polar_wolf_full:
            if cfg.polar_wolf:
                o("SIM_CONTROL: Polar wolf activated. Thole field "
                  "calculated using wolf method.\n")
            if cfg.polar_wolf_full:
                o("SIM_CONTROL: Full polar wolf treatment activated.\n")
            if cfg.polar_wolf_alpha_lookup:
                o(f"SIM_CONTROL: Polar wolf alpha will be performed via "
                  f"lookup table with cutoff "
                  f"{cfg.polar_wolf_alpha_lookup_cutoff:.6f} Ang.\n")
            o(f"SIM_CONTROL: Polar wolf damping set to "
              f"{cfg.polar_wolf_alpha:.6f}. (0 is default)\n")
        if cfg.polar_ewald:
            o("SIM_CONTROL: Polar ewald activated. Thole field calculated "
              "using ewald method.\n")
        if cfg.polar_ewald_full:
            o("SIM_CONTROL: Full ewald polarization activated.\n")
        if cfg.damp_type == const.DAMPING_LINEAR:
            o("SIM_CONTROL: Thole linear damping activated\n")
        else:
            o("SIM_CONTROL: Thole exponential damping activated\n")
        o(f"SIM_CONTROL: Thole damping parameter is {cfg.polar_damp:.4f}\n")
        if cfg.polar_iterative:
            o("SIM_CONTROL: Thole iterative solver activated\n")
            if cfg.polar_zodid:
                o("SIM_CONTROL: ZODID polarization enabled\n")
            if cfg.polar_precision > 0.0:
                o(f"SIM_CONTROL: Thole iterative precision is "
                  f"{cfg.polar_precision:e} A*sqrt(KA) "
                  f"({cfg.polar_precision / const.DEBYE2SKA:e} D)\n")
            else:
                o(f"SIM_CONTROL: using polar max SCF iterations = "
                  f"{cfg.polar_max_iter}\n")
            if cfg.polar_rrms:
                o("SIM_CONTROL: polar_rrms activated. Dipole rrms will be "
                  "reported.\n")
            if cfg.polar_sor:
                o("SIM_CONTROL: SOR SCF scheme active\n")
            if cfg.polar_esor:
                o("SIM_CONTROL: ESOR SCF scheme active\n")
            o(f"SIM_CONTROL: Pre-cond/SOR/ESOR gamma = "
              f"{cfg.polar_gamma:.3f}\n")
            if cfg.polar_gs:
                o("SIM_CONTROL: Gauss-Seidel iteration scheme active\n")
            if cfg.polar_gs_ranked:
                o("SIM_CONTROL: Gauss-Seidel Ranked iteration scheme "
                  "active\n")
            if cfg.polar_palmo:
                o("SIM_CONTROL: Polarization energy of Palmo and Krimm "
                  "enabled\n")
        else:
            o("SIM_CONTROL: Matrix polarization activated\n")
            if cfg.polarizability_tensor:
                o("SIM_CONTROL: Polarizability tensor calculation "
                  "activated\n")
    if cfg.polarvdw:
        o("SIM_CONTROL: polarvdw (coupled-dipole van der Waals) "
          "activated\n")
        if cfg.cdvdw_exp_repulsion:
            o("SIM_CONTROL: exponential repulsion activated\n")
        if cfg.cdvdw_sig_repulsion:
            o("SIM_CONTROL: C_6*sig^6 repulsion activated\n")
        if cfg.cdvdw_9th_repulsion:
            o("SIM_CONTROL: 9th power repulsion mixing activated\n")

    o(f"SIM_CONTROL: Job Name: {cfg.job_name}\n")
    if cfg.gwp:
        o("SIM_CONTROL: Gaussian wavepacket code active\n")
    if cfg.scale_charge != 1.0:
        o(f"SIM_CONTROL: frozen atom charges scaled by "
          f"{cfg.scale_charge:.2f}\n")

    # io destinations (:2203-2462); pi_nvt gets per-SYSTEM lines
    def dest(path, what, warn):
        if path == "/dev/null":
            o(f"SIM_CONTROL: {warn}\n")
        elif path:
            o(f"SIM_CONTROL: will be writing {what} to ./{path}\n")

    from .pqr import make_filename
    if pi and n_systems > 1:
        if cfg.pqr_restart != "/dev/null":
            for j in range(n_systems):
                o(f"SIM_CONTROL: SYSTEM {j} will be writing restart "
                  f"configuration to "
                  f"./{make_filename(cfg.pqr_restart, j)}\n")
        if cfg.pqr_output != "/dev/null":
            for j in range(n_systems):
                o(f"SIM_CONTROL: SYSTEM {j} will be writing final "
                  f"configuration to ./{make_filename(cfg.pqr_output, j)}\n")
    else:
        dest(cfg.pqr_restart, "restart configuration",
             "**Warning**: PQR restart file option disabled; writing "
             "restart configuration to /dev/null")
        dest(cfg.pqr_output, "final configuration",
             "**Warning: PQR final configuration file disabled; writing "
             "to /dev/null")
    o(f"SIM_CONTROL: reading initial molecular coordinates from: "
      f"{cfg.pqr_input}\n")
    dest(cfg.energy_output, "energy output",
         "energy file output disabled; writing to /dev/null")
    dest(cfg.traj_output, "trajectory",
         "trajectory file output disabled; writing to /dev/null")
    if cfg.polarization:
        if cfg.dipole_output == "/dev/null":
            o("SIM_CONTROL: dipole file output disabled; writing to "
              "/dev/null\n")
        elif cfg.dipole_output:
            o(f"SIM_CONTROL: dipole field will be written to "
              f"./{cfg.dipole_output}\n")
        if cfg.field_output == "/dev/null":
            o("SIM_CONTROL: field file output disabled; writing to "
              "/dev/null\n")
        elif cfg.field_output:
            o(f"SIM_CONTROL: field field will be written to "
              f"./{cfg.field_output}\n")

    o("SIM_CONTROL: input file validated.\n")
    seed = cfg.preset_seed if cfg.preset_seed_on else 0
    o(f"SIM_CONTROL: RNG initialized. Seed = {seed}\n")

    # system instantiation / box / Ewald echo (:117-186)
    if pi and n_systems > 1:
        for j in range(n_systems):
            o(f"SIM_CONTROL: SYSTEM[ {j} ] Instantiated.\n")
            o(f"SIM_CONTROL->SYSTEM[ {j} ]: Constructing simulation box.\n")
            o(f"SIM_CONTROL->SYSTEM[ {j} ]: simulation box configured.\n")
        o("SIM_CONTROL: finished allocating pair lists\n")
    elif gibbs:
        for j in range(2):
            o(f"SIM_CONTROL, SYS {j}: simulation box configured.\n")
            o(f"SIM_CONTROL, SYS {j}: finished allocating pair lists\n")
            o(f"SIM_CONTROL, SYS {j}: finished calculating pairwise "
              f"interactions\n")
            if not cfg.wolf:
                o(f"SIM_CONTROL, SYS {j}: Ewald gaussian width = "
                  f"{cfg.ewald_alpha:f} A\n")
                o(f"SIM_CONTROL, SYS {j}: Ewald kmax = {cfg.ewald_kmax}\n")
        o(f"SIM_CONTROL: volume change probability is "
          f"{cfg.volume_probability:.6f}.\n")
        o(f"SIM_CONTROL:      transfer probability is "
          f"{cfg.transfer_probability:.6f}.\n")
        disp = 1.0 - cfg.volume_probability - cfg.transfer_probability
        o(f"SIM_CONTROL:      displace probability is {disp:.6f}.\n")
    else:
        o("SIM_CONTROL: simulation box configured.\n")
        o("SIM_CONTROL: finished allocating pair lists\n")
        o("SIM_CONTROL: finished calculating pairwise interactions\n")
        if not cfg.wolf:
            o(f"SIM_CONTROL: Ewald gaussian width = {cfg.ewald_alpha:f} A\n")
            o(f"SIM_CONTROL: Ewald kmax = {cfg.ewald_kmax}\n")
    out.flush()
