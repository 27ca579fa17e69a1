"""SimConfig: full simulation configuration.

JAX twin: mpmcxx_tpu/config/schema.py (a copy; ``to_flags`` and
``to_params`` return the port's FFlags and RunParams).

One host-side dataclass mirrors all user-settable options in the reference
(defaults from src/System.h:505-832, SimulationControl members from
src/SimulationControl.h:18-174).  ``to_flags()``/``to_params()`` derive the
static FFlags and numeric RunParams of the energy and MC code.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Dict, List, Optional

from .. import constants as const
from ..flags import FFlags, RunParams


@dataclasses.dataclass
class SimConfig:
    job_name: str = "untitled"
    ensemble: int = 0

    # MC controls
    numsteps: int = 0
    corrtime: int = 0
    ptemp_freq: int = 0
    move_factor: float = 1.0
    rot_factor: float = 1.0
    volume_change_factor: float = 0.25
    adiabatic_probability: float = 0.0
    gwp_probability: float = 0.0
    insert_probability: float = 0.0
    spinflip_probability: float = 0.0
    volume_probability: float = 0.0
    transfer_probability: float = 0.0
    bead_perturb_probability: float = 0.0
    PI_trial_chain_length: int = 0
    total_trotter_number: int = 0  # -P on the CLI

    # observables / thermodynamics
    temperature: float = 0.0
    pressure: float = 0.0
    free_volume: float = 0.0
    total_energy: float = 0.0
    h2_fugacity: bool = False
    co2_fugacity: bool = False
    ch4_fugacity: bool = False
    n2_fugacity: bool = False
    user_fugacities: bool = False
    fugacities: List[float] = field(default_factory=list)

    # io filenames
    pqr_input: str = ""
    pqr_input_B: str = ""
    pqr_output: str = ""
    pqr_restart: str = ""
    traj_input: str = ""
    traj_output: str = ""
    energy_output: str = ""
    energy_output_csv: str = ""
    dipole_output: str = ""
    field_output: str = ""
    frozen_output: str = ""
    histogram_output: str = ""
    insert_input: str = ""
    surf_output: str = ""
    surf_virial: bool = False   # no input keyword (System.h:829); SURF-only
    virial_output: str = ""
    long_output: bool = False
    parallel_restarts: bool = False
    read_pqr_box: bool = False
    max_bondlength: float = 0.0

    # rng
    preset_seed_on: bool = False
    preset_seed: int = 0

    # simulated annealing
    simulated_annealing: bool = False
    simulated_annealing_linear: bool = False
    simulated_annealing_schedule: float = 0.0
    simulated_annealing_target: float = 0.0

    # spectre
    spectre: bool = False
    spectre_max_charge: float = 0.0
    spectre_max_target: float = 0.0

    # cavity bias
    cavity_bias: bool = False
    cavity_grid_size: int = 0
    cavity_radius: float = 0.0
    cavity_autoreject: bool = False
    cavity_autoreject_absolute: bool = False
    cavity_autoreject_scale: float = 0.0
    cavity_autoreject_repulsion: float = 0.0

    # parallel tempering
    parallel_tempering: bool = False
    max_temperature: float = 0.0

    # pbc
    wrapall: bool = True
    basis1: Optional[List[float]] = None
    basis2: Optional[List[float]] = None
    basis3: Optional[List[float]] = None
    pbc_cutoff: float = 0.0

    # energy corrections
    feynman_hibbs: bool = False
    feynman_kleinert: bool = False
    feynman_hibbs_order: int = 0
    vdw_fh_2be: bool = False
    rd_lrc: bool = True
    rd_crystal: bool = False
    rd_crystal_order: int = 0

    # force field selection
    rd_only: bool = False
    rd_anharmonic: bool = False
    rd_anharmonic_k: float = 0.0
    rd_anharmonic_g: float = 0.0
    use_sg: bool = False
    use_dreiding: bool = False
    using_lj_buffered_14_7: bool = False
    using_disp_expansion: bool = False
    using_axilrod_teller: bool = False
    c6_mixing: bool = False
    damp_dispersion: bool = False
    disp_expansion_mbvdw: bool = False
    extrapolate_disp_coeffs: bool = False
    halgren_mixing: bool = False
    midzuno_kihara_approx: bool = False
    schmidt_ff: bool = False
    waldmanhagler: bool = False
    gwp: bool = False
    independent_particle: bool = False
    scale_charge: float = 1.0

    # electrostatics
    wolf: bool = False
    ewald_alpha: float = const.EWALD_ALPHA_DEFAULT
    ewald_alpha_set: bool = False
    ewald_kmax: int = const.EWALD_KMAX_DEFAULT
    polar_ewald_alpha: float = const.EWALD_ALPHA_DEFAULT
    polar_ewald_alpha_set: bool = False

    # polarization
    polarization: bool = False
    polarvdw: bool = False
    polarizability_tensor: bool = False
    cdvdw_exp_repulsion: bool = False
    cdvdw_sig_repulsion: bool = False
    cdvdw_9th_repulsion: bool = False
    polar_iterative: bool = False
    polar_ewald: bool = False
    polar_ewald_full: bool = False
    polar_zodid: bool = False
    polar_palmo: bool = False
    polar_rrms: bool = False
    polar_gs: bool = False
    polar_gs_ranked: bool = False
    polar_sor: bool = False
    polar_esor: bool = False
    polar_max_iter: int = 0
    polar_wolf: bool = False
    polar_wolf_full: bool = False
    polar_mixed: bool = False
    polar_warm_start: bool = False
    polar_wolf_alpha_lookup: bool = False
    polar_wolf_alpha: float = 0.0
    polar_wolf_alpha_lookup_cutoff: float = const.WOLF_ALPHA_LOOKUP_CUTOFF_DEFAULT
    polar_gamma: float = 1.0
    polar_damp: float = 0.0
    field_damp: float = 0.0
    polar_precision: float = 0.0
    damp_type: int = const.DAMPING_EXPONENTIAL

    # histogram
    calc_hist: bool = False
    hist_resolution: float = 0.0

    # quantum rotation (parsed; hindered-rotor solver not yet implemented)
    quantum_rotation: bool = False
    quantum_rotation_hindered: bool = False
    quantum_rotation_hindered_barrier: float = 0.0
    quantum_rotation_B: float = 0.0
    quantum_rotation_level_max: int = 0
    quantum_rotation_l_max: int = 0
    quantum_rotation_sum: int = 0
    quantum_vibration: bool = False

    # replay
    calc_pressure: bool = False
    calc_pressure_dv: float = 0.0

    # surface-fit options (parsed for compatibility; engine stubbed as in
    # this reference edition, src/SimulationControl.h:117-121)
    surf_fit_arbitrary_configs: bool = False
    surf_decomp: bool = False
    surf_min: float = 0.0
    surf_max: float = 0.0
    surf_inc: float = 0.0
    surf_ang: float = 0.0
    surf_print_level: int = 0
    surf_weight_constant: float = 0.0
    surf_weight_constant_on: bool = False
    surf_scale_q: float = 0.0
    surf_scale_q_on: bool = False
    surf_scale_r: float = 0.0
    surf_scale_r_on: bool = False
    surf_scale_epsilon: float = 0.0
    surf_scale_epsilon_on: bool = False
    surf_scale_sigma: float = 0.0
    surf_scale_sigma_on: bool = False
    surf_scale_omega: float = 0.0
    surf_scale_omega_on: bool = False
    surf_scale_alpha: float = 0.0
    surf_scale_alpha_on: bool = False
    surf_scale_pol: float = 0.0
    surf_scale_pol_on: bool = False
    surf_scale_c6: float = 0.0
    surf_scale_c6_on: bool = False
    surf_scale_c8: float = 0.0
    surf_scale_c8_on: bool = False
    surf_scale_c10: float = 0.0
    surf_scale_c10_on: bool = False
    surf_qshift_on: bool = False
    surf_preserve: bool = False
    surf_preserve_rotation_on: bool = False
    surf_preserve_rotation: Optional[List[float]] = None
    surf_global_axis_on: bool = False
    surf_descent: bool = False
    ee_local: bool = False
    range_eps: float = 0.0
    range_sig: float = 0.0
    step_eps: float = 0.0
    step_sig: float = 0.0
    fit_schedule: float = 0.0
    fit_max_energy: float = 0.0
    fit_start_temp: float = 0.0
    fit_boltzmann_weight: bool = False
    fit_input: List[str] = field(default_factory=list)

    # accelerator flags accepted for compatibility (no-ops here: TPU is
    # always the compute backend; src/System.h:510-514)
    cuda: bool = False
    opencl: bool = False

    # sorbate metadata registry (src/SimulationControl.cpp:2976-3072)
    sorbate_orientation_site: Dict[str, int] = field(default_factory=dict)
    sorbate_bond_length: Dict[str, float] = field(default_factory=dict)
    sorbate_reduced_mass: Dict[str, float] = field(default_factory=dict)

    def to_flags(self) -> FFlags:
        return FFlags(
            rd_only=self.rd_only,
            rd_anharmonic=self.rd_anharmonic,
            use_sg=self.use_sg,
            use_dreiding=self.use_dreiding,
            using_lj_buffered_14_7=self.using_lj_buffered_14_7,
            using_disp_expansion=self.using_disp_expansion,
            cdvdw_exp_repulsion=self.cdvdw_exp_repulsion,
            using_axilrod_teller=self.using_axilrod_teller,
            gwp=self.gwp,
            spectre=self.spectre,
            rd_lrc=self.rd_lrc,
            rd_crystal=self.rd_crystal,
            rd_crystal_order=self.rd_crystal_order,
            feynman_hibbs=self.feynman_hibbs,
            feynman_hibbs_order=self.feynman_hibbs_order,
            feynman_kleinert=self.feynman_kleinert,
            rd_anharmonic_k=self.rd_anharmonic_k,
            rd_anharmonic_g=self.rd_anharmonic_g,
            waldmanhagler=self.waldmanhagler,
            halgren_mixing=self.halgren_mixing,
            cdvdw_9th_repulsion=self.cdvdw_9th_repulsion,
            cdvdw_sig_repulsion=self.cdvdw_sig_repulsion,
            c6_mixing=self.c6_mixing,
            disp_expansion_mbvdw=self.disp_expansion_mbvdw,
            extrapolate_disp_coeffs=self.extrapolate_disp_coeffs,
            schmidt_ff=self.schmidt_ff,
            damp_dispersion=self.damp_dispersion,
            midzuno_kihara_approx=self.midzuno_kihara_approx,
            wolf=self.wolf,
            ewald_kmax=self.ewald_kmax,
            polarization=self.polarization,
            polarvdw=self.polarvdw,
            vdw_fh_2be=self.vdw_fh_2be,
            polar_iterative=self.polar_iterative,
            polar_ewald=self.polar_ewald,
            polar_ewald_full=self.polar_ewald_full,
            polar_zodid=self.polar_zodid,
            polar_palmo=self.polar_palmo,
            polar_rrms=self.polar_rrms,
            polar_gs=self.polar_gs,
            polar_gs_ranked=self.polar_gs_ranked,
            polar_sor=self.polar_sor,
            polar_esor=self.polar_esor,
            polar_max_iter=self.polar_max_iter,
            polar_wolf=self.polar_wolf,
            polar_wolf_full=self.polar_wolf_full,
            polar_mixed=self.polar_mixed,
            polar_warm_start=self.polar_warm_start,
            damp_type=self.damp_type,
            cavity_autoreject=self.cavity_autoreject,
            cavity_autoreject_absolute=self.cavity_autoreject_absolute,
            independent_particle=self.independent_particle,
            quantum_rotation=self.quantum_rotation,
        )

    def to_params(self) -> RunParams:
        return RunParams(
            temperature=self.temperature,
            pressure=self.pressure,
            ewald_alpha=self.ewald_alpha,
            polar_ewald_alpha=self.polar_ewald_alpha,
            polar_damp=self.polar_damp,
            polar_gamma=self.polar_gamma,
            polar_precision=self.polar_precision,
            polar_wolf_alpha=self.polar_wolf_alpha,
            cavity_autoreject_scale=self.cavity_autoreject_scale,
            cavity_autoreject_repulsion=self.cavity_autoreject_repulsion,
            scale_charge=self.scale_charge,
            total_energy=self.total_energy,
        )
