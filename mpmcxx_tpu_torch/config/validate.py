"""Option validation and default resolution.

JAX twin: mpmcxx_tpu/config/validate.py (a copy).

Reproduces the reference's check_system / check_mc_options /
check_spectre_options / check_feynman_hibbs_options /
check_simulated_annealing_options / check_hist_options /
check_polarization_options / check_qrot_options / check_PI_options /
check_io_files_options passes (src/SimulationControl.cpp:1617-2850,
src/SimulationControl.PathIntegral.cpp:552-606) plus the Gibbs
probability setup checks (src/SimulationControl.Gibbs.cpp:14-130) in one
pass: every input the reference rejects is rejected here with the same
message (minus the "SIM_CONTROL: " log prefix); defaults (histogram
resolution, FH order, output filenames) resolve identically.  The
SIM_CONTROL *echo* lines live in io/output.py (test_sim_control_echo
pins them byte-identical to the binary).

Deliberate deviations (stricter than the reference, never looser):

* NVE with no ``total_energy`` is an error here; the reference
  silently runs with E_total = 0 (every move rejected by the power-law
  Boltzmann factor, src/System.MonteCarlo.cpp BF path).
* ``polar_iterative`` with neither ``polar_precision`` nor
  ``polar_max_iter`` is an error here; the reference iterates zero
  times and reports the cold-start dipoles.
"""

from __future__ import annotations

import warnings

from .. import constants as const
from ..mc import fugacity as fug
from .parser import ConfigError
from .schema import SimConfig


def _check_ensemble(cfg: SimConfig) -> None:
    ens = cfg.ensemble
    if ens in (const.ENSEMBLE_SURF, const.ENSEMBLE_SURF_FIT,
               const.ENSEMBLE_TE, const.ENSEMBLE_REPLAY):
        # vestigial in this edition (src/SimulationControl.h:117-121 stubs)
        raise ConfigError(
            f"ensemble {ens} is stubbed in this edition (as in the "
            "reference: runSimulation returns false for SURF/SURF_FIT/TE/"
            "REPLAY)")


def _check_mc_options(cfg: SimConfig) -> None:
    """src/SimulationControl.cpp:1797-2171."""
    ens = cfg.ensemble

    if cfg.numsteps < 1:
        raise ConfigError("Improper number of steps specified.")
    if cfg.corrtime < 1:
        raise ConfigError("Improper correlation time specified.")
    if ens != const.ENSEMBLE_NVE and cfg.temperature <= 0.0:
        raise ConfigError("Invalid temperature specified.")
    if ens == const.ENSEMBLE_NVE and cfg.total_energy <= 0.0:
        # stricter than the reference -- see module docstring
        raise ConfigError("NVE requires total_energy to be set.")

    # :1922-1934 -- NVE/NVT move mix
    if ens in (const.ENSEMBLE_NVE, const.ENSEMBLE_NVT):
        if cfg.spinflip_probability > 1.0:
            raise ConfigError(
                "The requested spinflip probabilities is greater than 1.0.")

    # PI move mix + Trotter checks (check_mc_options :1938-1956 +
    # check_PI_options, src/SimulationControl.PathIntegral.cpp:552-606)
    if ens == const.ENSEMBLE_PATH_INTEGRAL_NVT:
        if cfg.feynman_hibbs:
            raise ConfigError(
                "The Feynmann hibbs approximation cannot be used with a "
                "Path Integral technique.")
        if cfg.spinflip_probability + cfg.bead_perturb_probability > 1.0:
            raise ConfigError(
                "The requested probabilities for all MC moves sum to a "
                "value greater than 1.0.")

    if ens == const.ENSEMBLE_NPT:
        if cfg.pressure <= 0.0:
            raise ConfigError("invalid pressure set for NPT")

    if ens == const.ENSEMBLE_UVT:
        _check_uvt_fugacities(cfg)

    # :2139-2154 -- autoreject insertions closer than scale * sigma
    if cfg.cavity_autoreject or cfg.cavity_autoreject_absolute:
        if not (0.0 < cfg.cavity_autoreject_scale <= 1.0):
            raise ConfigError(
                "cavity_autoreject_scale either not set or out of range")

    # :2157-2168
    if cfg.cavity_bias:
        if cfg.cavity_grid_size <= 0 or cfg.cavity_radius <= 0.0:
            raise ConfigError("invalid cavity grid or radius specified")


def _check_uvt_fugacities(cfg: SimConfig) -> None:
    """src/SimulationControl.cpp:1995-2089."""
    if cfg.user_fugacities:
        if cfg.pressure != 0.0:
            raise ConfigError("User defined fugacities are not "
                              "compatible with pressure specification.")
        return
    if cfg.pressure <= 0.0:
        raise ConfigError("invalid pressure set for GCMC")

    # the reference applies each EoS keyword in sequence and errors if
    # fugacities[0] was already set by an earlier one (:2026-2087)
    eqs = [("h2", cfg.h2_fugacity, fug.h2_fugacity),
           ("co2", cfg.co2_fugacity, fug.co2_fugacity),
           ("ch4", cfg.ch4_fugacity, fug.ch4_fugacity),
           ("n2", cfg.n2_fugacity, fug.n2_fugacity)]
    for name, enabled, eos in eqs:
        if not enabled:
            continue
        if cfg.fugacities and cfg.fugacities[0] != 0.0:
            raise ConfigError(
                f"{name}_fugacity called, but fugacities are already set.")
        f = eos(cfg.temperature, cfg.pressure)
        if f <= 0.0:
            raise ConfigError(
                f"error in {name.upper()} fugacity assignment")
        cfg.fugacities = [f]


def _check_spectre_options(cfg: SimConfig) -> None:
    """src/SimulationControl.cpp:2176-2191."""
    if cfg.ensemble != const.ENSEMBLE_NVT:
        raise ConfigError("SPECTRE algorithm requires canonical ensemble")
    if cfg.spectre_max_charge <= 0 or cfg.spectre_max_target <= 0:
        raise ConfigError("SPECTRE requires spectre_max_charge and "
                          "spectre_max_target > 0")


def _check_feynman_hibbs_options(cfg: SimConfig) -> None:
    """src/SimulationControl.cpp:2473-2515."""
    if cfg.feynman_kleinert:
        if not cfg.rd_anharmonic:
            raise ConfigError("Feynman-Kleinert iteration only implemented "
                              "for anharmonic oscillator")
    elif cfg.feynman_hibbs_order not in (2, 4):
        # "unspecified or unsupported value--defaulting to h^2"
        cfg.feynman_hibbs_order = 2
    if cfg.polarvdw and not cfg.cavity_autoreject_absolute and \
            cfg.ensemble != const.ENSEMBLE_REPLAY:
        raise ConfigError("cavity_autoreject_absolute must be used with "
                          "polarvdw + Feynman Hibbs.")
    if cfg.temperature <= 0:
        raise ConfigError("feynman_hibbs requires positive temperature.")


def _check_simulated_annealing_options(cfg: SimConfig) -> None:
    """src/SimulationControl.cpp:2520-2547."""
    if not (0.0 <= cfg.simulated_annealing_schedule <= 1.0):
        raise ConfigError(
            "invalid simulated annealing temperature schedule specified")
    if cfg.simulated_annealing_target < 0.0:
        raise ConfigError("invalid simulated annealing target specified")


def _check_hist_options(cfg: SimConfig) -> None:
    """src/SimulationControl.cpp:2552-2601 -- all soft defaults."""
    if cfg.hist_resolution == 0.0 or not (0.01 <= cfg.hist_resolution <= 5.0):
        cfg.hist_resolution = 0.7
    elif not cfg.histogram_output:
        cfg.histogram_output = "histogram.dat"
    if cfg.max_bondlength < 0.5:
        cfg.max_bondlength = 1.8
    if not cfg.frozen_output:
        cfg.frozen_output = "frozen.dx"


def _check_polarization_options(cfg: SimConfig) -> None:
    """src/SimulationControl.cpp:2606-2785."""
    if cfg.polar_iterative and cfg.polarizability_tensor:
        raise ConfigError("iterative polarizability tensor method not "
                          "implemented")
    if not cfg.polar_iterative and cfg.polar_zodid:
        raise ConfigError("ZODID and matrix inversion cannot both be set!")

    if cfg.polar_wolf or cfg.polar_wolf_full:
        if cfg.polar_wolf_alpha_lookup and \
                cfg.polar_wolf_alpha_lookup_cutoff <= 0:
            raise ConfigError("invalid polar_wolf_alpha_lookup_cutoff")
        if not (0.0 <= cfg.polar_wolf_alpha <= 1.0):
            raise ConfigError("1 >= polar_wolf_alpha >= 0 is required.")

    if cfg.damp_type not in (const.DAMPING_OFF, const.DAMPING_LINEAR,
                             const.DAMPING_EXPONENTIAL):
        raise ConfigError("Thole damping method not specified")
    if cfg.polar_damp <= 0.0 and cfg.damp_type != const.DAMPING_OFF:
        raise ConfigError("damping factor must be specified")

    if cfg.polar_iterative:
        if cfg.polar_precision > 0.0 and cfg.polar_max_iter > 0:
            raise ConfigError("cannot specify both polar_precision and "
                              "polar_max_iter, must pick one")
        if cfg.polar_precision < 0.0:
            raise ConfigError(
                "invalid polarization iterative precision specified")
        if cfg.polar_precision == 0.0 and cfg.polar_max_iter == 0:
            # stricter than the reference -- see module docstring
            raise ConfigError("must specify either polar_precision or "
                              "polar_max_iter")
        if cfg.polar_sor and cfg.polar_esor:
            raise ConfigError("cannot specify both SOR and ESOR SCF methods")
        if cfg.polar_gamma < 0.0:
            raise ConfigError("invalid Pre-cond/SOR/ESOR gamma set")
        if cfg.polar_gs and cfg.polar_gs_ranked:
            raise ConfigError("both polar_gs and polar_gs_ranked cannot "
                              "be set")
        if (cfg.polar_gs or cfg.polar_gs_ranked) and cfg.polar_max_iter > 0:
            # MIGRATION.md "Gauss-Seidel iterates": the exact A-matrix
            # path (systems <= ~1k atoms) runs the reference's true
            # sequential sweep (ops/polar._gs_sweep) with bit-identical
            # finite-K iterates; the blocked/mixed large-system paths
            # iterate Jacobi (same converged fixed point, polar_gs
            # goldens; System.Energy.cpp:3564-3597)
            warnings.warn(
                "polar_gs/polar_gs_ranked with fixed polar_max_iter: "
                "finite-K iterates match the reference's sequential "
                "Gauss-Seidel sweep only on the exact A-matrix path "
                "(small systems); the blocked large-system path iterates "
                "Jacobi order (converged fixed points match; see "
                "MIGRATION.md)", stacklevel=2)

    if cfg.polarvdw:
        n_mix = sum([cfg.cdvdw_exp_repulsion, cfg.cdvdw_sig_repulsion,
                     cfg.cdvdw_9th_repulsion, cfg.waldmanhagler,
                     cfg.halgren_mixing])
        if n_mix > 1:
            raise ConfigError("more than one mixing rules specified")
    else:
        if cfg.cdvdw_exp_repulsion:
            raise ConfigError("exponential repulsion must be used in "
                              "conjunction with polarvdw")
        if cfg.cdvdw_sig_repulsion:
            raise ConfigError("sig repulsion is used in conjunction with "
                              "polarvdw")


def _check_qrot_options(cfg: SimConfig) -> None:
    """src/SimulationControl.cpp:2790-2850 (QM_ROTATION build)."""
    if cfg.quantum_rotation_B <= 0.0:
        raise ConfigError("invalid quantum rotational constant B specified")
    if cfg.quantum_rotation_level_max <= 0:
        raise ConfigError("invalid quantum rotation level max")
    if cfg.quantum_rotation_l_max <= 0:
        raise ConfigError("invalid quantum rotation l_max")
    lmax = cfg.quantum_rotation_l_max
    if cfg.quantum_rotation_level_max > (lmax + 1) * (lmax + 1):
        raise ConfigError("quantum rotational levels cannot exceed "
                          "l_max + 1 X l_max +1")
    if cfg.quantum_rotation_sum <= 0 or \
            cfg.quantum_rotation_sum > cfg.quantum_rotation_level_max:
        raise ConfigError(
            "quantum rotational sum for partition function invalid")


def _check_system_misc(cfg: SimConfig) -> None:
    """The inline checks of check_system itself
    (src/SimulationControl.cpp:1677-1791)."""
    if cfg.rd_crystal and cfg.rd_crystal_order <= 0:
        raise ConfigError("rd crystal order must be positive")
    n_mix = sum([cfg.waldmanhagler, cfg.halgren_mixing, cfg.c6_mixing])
    if n_mix > 1:
        raise ConfigError("more than one mixing rule specified")
    if not cfg.job_name:
        raise ConfigError("must specify a job name")
    if cfg.gwp and cfg.gwp_probability == 0.0:
        # "GWP move scaling not input - setting equal to move_factor"
        cfg.gwp_probability = cfg.move_factor
    if cfg.rd_anharmonic and not cfg.rd_only:
        raise ConfigError("rd_anharmonic being set requires rd_only")


def _check_gibbs_options(cfg: SimConfig) -> None:
    """check_Gibbs_options is empty (src/SimulationControl.Gibbs.cpp:14-26);
    the real guards live in initialize_Gibbs_systems (:93-129), run here
    instead of at system setup so a bad input fails before any state is
    built.  volume_probability's 1/N default stays at setup time (N is
    unknown until both boxes are read)."""
    if not cfg.pqr_input_B:
        cfg.pqr_input_B = cfg.pqr_input
    if not cfg.quantum_rotation:
        cfg.spinflip_probability = 0.0
    if cfg.transfer_probability == 0.0:
        raise ConfigError(
            "transfer move probability was either not set, or set to 0.0 "
            'in a Gibbs NVT simulation. Set with keyword '
            '"transfer_probability" in input file.')
    psum = (cfg.spinflip_probability + cfg.volume_probability +
            cfg.transfer_probability)
    if psum >= 1.0:
        # the reference prints this error but does NOT abort
        # (Gibbs.cpp:126-129, no return/throw) -- mirror as a warning
        warnings.warn(
            "Invalid probabilities set. The summed frequencies for "
            "spinflip, volume, transfer, and displacement moves may not "
            "exceed 1.0.", stacklevel=2)


def validate(cfg: SimConfig, n_systems: int = 1) -> SimConfig:
    ens = cfg.ensemble

    _check_ensemble(cfg)

    if not cfg.pqr_input:
        cfg.pqr_input = cfg.job_name + ".initial.pqr"

    if ens in (const.ENSEMBLE_UVT, const.ENSEMBLE_NVT, const.ENSEMBLE_NVE,
               const.ENSEMBLE_NPT, const.ENSEMBLE_NVT_GIBBS,
               const.ENSEMBLE_PATH_INTEGRAL_NVT):
        _check_mc_options(cfg)

    # PI Trotter-number checks (check_PI_options,
    # src/SimulationControl.PathIntegral.cpp:552-606): power of two >= 4;
    # trial chain in [1, P-1]
    if ens == const.ENSEMBLE_PATH_INTEGRAL_NVT:
        P = n_systems
        if P < 4 or (P & (P - 1)) != 0:
            raise ConfigError(
                "Path integrals require a Trotter number (-P) that is a "
                "power of 2 and >= 4.")
        if not cfg.PI_trial_chain_length:
            raise ConfigError("PI_trial_chain_length must be set when using "
                              "Path Integral ensembles.")
        if cfg.PI_trial_chain_length >= P:
            raise ConfigError("PI_trial_chain_length must be in [1..P-1]")

    if ens == const.ENSEMBLE_NVT_GIBBS:
        _check_gibbs_options(cfg)

    if cfg.spectre:
        _check_spectre_options(cfg)
    _check_system_misc(cfg)
    if cfg.feynman_hibbs:
        _check_feynman_hibbs_options(cfg)
    if cfg.simulated_annealing:
        _check_simulated_annealing_options(cfg)
    if cfg.calc_hist:
        _check_hist_options(cfg)
    if cfg.polarization:
        _check_polarization_options(cfg)
    if cfg.quantum_rotation:
        _check_qrot_options(cfg)

    # default output filenames (check_io_files_options,
    # src/SimulationControl.cpp:2196-2468)
    def default(name, suffix):
        v = getattr(cfg, name)
        if v.lower() == "off":
            setattr(cfg, name, "/dev/null")
        elif not v:
            setattr(cfg, name, cfg.job_name + suffix)

    default("pqr_restart", ".restart.pqr")
    default("pqr_output", ".final.pqr")
    default("energy_output", ".energy.dat")
    if cfg.surf_virial:
        default("virial_output", ".virial.dat")
    if cfg.calc_hist:
        default("histogram_output", ".histogram.dx")
    if cfg.polarization:
        default("dipole_output", ".dipole.dat")
        default("field_output", ".field.dat")
    if cfg.traj_output.lower() == "off":
        cfg.traj_output = "/dev/null"
    elif not cfg.traj_output:
        cfg.traj_output = cfg.job_name + ".traj.pqr"

    return cfg
