"""Input-file parser.

JAX twin: mpmcxx_tpu/config/parser.py (a copy).

Line-oriented ``keyword value...`` files, case-insensitive keywords, ``!``/
``#`` comments, at most 10 tokens per line — the contract of
src/SimulationControl.cpp:204-1613 reimplemented as a declarative keyword
table instead of a 1,350-line if-chain.

Errors raise ConfigError with messages naming the offending line, matching
the reference's fail-on-bad-input behavior.
"""

from __future__ import annotations

from typing import Dict

from .. import constants as const
from .schema import SimConfig


class ConfigError(ValueError):
    pass


def _to_bool(tok: str) -> bool:
    t = tok.lower()
    if t == "on":
        return True
    if t == "off":
        return False
    raise ConfigError(f"expected on/off, got {tok!r}")


def _to_int(tok: str) -> int:
    try:
        return int(tok)
    except ValueError as e:
        raise ConfigError(f"expected integer, got {tok!r}") from e


def _to_float(tok: str) -> float:
    try:
        return float(tok)
    except ValueError as e:
        raise ConfigError(f"expected number, got {tok!r}") from e


# --- keyword table -------------------------------------------------------
# maps lowercase keyword -> (config attribute, converter) for the uniform
# single-value commands; special multi-token commands get handlers below.

_BOOL = _to_bool
_INT = _to_int
_FLT = _to_float
_STR = str

SIMPLE_KEYWORDS: Dict[str, tuple] = {
    "job_name": ("job_name", _STR),
    "parallel_restarts": ("parallel_restarts", _BOOL),
    "fit_arbitrary_configs": ("surf_fit_arbitrary_configs", _BOOL),
    "surf_decomp": ("surf_decomp", _BOOL),
    "surf_min": ("surf_min", _FLT),
    "surf_max": ("surf_max", _FLT),
    "surf_inc": ("surf_inc", _FLT),
    "surf_ang": ("surf_ang", _FLT),
    "surf_print_level": ("surf_print_level", _INT),
    "surf_qshift": ("surf_qshift_on", _BOOL),
    "surf_preserve": ("surf_preserve", _BOOL),
    "surf_global_axis": ("surf_global_axis_on", _BOOL),
    "surf_descent": ("surf_descent", _BOOL),
    "ee_local": ("ee_local", _BOOL),
    "range_eps": ("range_eps", _FLT),
    "range_sig": ("range_sig", _FLT),
    "step_eps": ("step_eps", _FLT),
    "step_sig": ("step_sig", _FLT),
    "spectre": ("spectre", _BOOL),
    "spectre_max_charge": ("spectre_max_charge", _FLT),
    "spectre_max_target": ("spectre_max_target", _FLT),
    "cavity_bias": ("cavity_bias", _BOOL),
    "cavity_grid": ("cavity_grid_size", _INT),
    "cavity_radius": ("cavity_radius", _FLT),
    "cavity_autoreject": ("cavity_autoreject", _BOOL),
    "cavity_autoreject_absolute": ("cavity_autoreject_absolute", _BOOL),
    "cavity_autoreject_scale": ("cavity_autoreject_scale", _FLT),
    "cavity_autoreject_repulsion": ("cavity_autoreject_repulsion", _FLT),
    "polarization": ("polarization", _BOOL),
    "cdvdw_9th_repulsion": ("cdvdw_9th_repulsion", _BOOL),
    "cdvdw_exp_repulsion": ("cdvdw_exp_repulsion", _BOOL),
    "cdvdw_sig_repulsion": ("cdvdw_sig_repulsion", _BOOL),
    "polar_ewald_full": ("polar_ewald_full", _BOOL),
    "polar_ewald": ("polar_ewald", _BOOL),
    "polar_wolf_full": ("polar_wolf_full", _BOOL),
    # TPU extensions: float32 pair coefficients for the blocked SCF,
    # and SCF warm starts from carried dipoles
    "polar_mixed": ("polar_mixed", _BOOL),
    "polar_warm_start": ("polar_warm_start", _BOOL),
    "polar_wolf": ("polar_wolf", _BOOL),
    "polar_wolf_alpha_lookup": ("polar_wolf_alpha_lookup", _BOOL),
    "polar_wolf_damp": ("polar_wolf_alpha", _FLT),
    "polar_wolf_alpha": ("polar_wolf_alpha", _FLT),
    "polar_wolf_alpha_lookup_cutoff": ("polar_wolf_alpha_lookup_cutoff", _FLT),
    "calc_pressure": ("calc_pressure", _BOOL),
    "calc_pressure_dv": ("calc_pressure_dv", _FLT),
    "total_energy": ("total_energy", _FLT),
    "numsteps": ("numsteps", _INT),
    "corrtime": ("corrtime", _INT),
    "move_factor": ("move_factor", _FLT),
    "rot_factor": ("rot_factor", _FLT),
    "gwp_probability": ("gwp_probability", _FLT),
    "insert_probability": ("insert_probability", _FLT),
    "adiabatic_probability": ("adiabatic_probability", _FLT),
    "spinflip_probability": ("spinflip_probability", _FLT),
    "volume_probability": ("volume_probability", _FLT),
    "volume_change_factor": ("volume_change_factor", _FLT),
    "transfer_probability": ("transfer_probability", _FLT),
    "bead_perturb_probability": ("bead_perturb_probability", _FLT),
    "pi_trial_chain_length": ("PI_trial_chain_length", _INT),
    "ptemp_freq": ("ptemp_freq", _INT),
    "parallel_tempering": ("parallel_tempering", _BOOL),
    "max_temperature": ("max_temperature", _FLT),
    "temperature": ("temperature", _FLT),
    "simulated_annealing": ("simulated_annealing", _BOOL),
    "simulated_annealing_linear": ("simulated_annealing_linear", _BOOL),
    "simulated_annealing_schedule": ("simulated_annealing_schedule", _FLT),
    "simulated_annealing_target": ("simulated_annealing_target", _FLT),
    "pressure": ("pressure", _FLT),
    "h2_fugacity": ("h2_fugacity", _BOOL),
    "co2_fugacity": ("co2_fugacity", _BOOL),
    "ch4_fugacity": ("ch4_fugacity", _BOOL),
    "n2_fugacity": ("n2_fugacity", _BOOL),
    "free_volume": ("free_volume", _FLT),
    "rd_only": ("rd_only", _BOOL),
    "gwp": ("gwp", _BOOL),
    "wolf": ("wolf", _BOOL),
    "rd_lrc": ("rd_lrc", _BOOL),
    "rd_crystal": ("rd_crystal", _BOOL),
    "rd_crystal_order": ("rd_crystal_order", _INT),
    "rd_anharmonic": ("rd_anharmonic", _BOOL),
    "rd_anharmonic_k": ("rd_anharmonic_k", _FLT),
    "rd_anharmonic_g": ("rd_anharmonic_g", _FLT),
    "feynman_hibbs": ("feynman_hibbs", _BOOL),
    "vdw_fh_2be": ("vdw_fh_2be", _BOOL),
    "feynman_kleinert": ("feynman_kleinert", _BOOL),
    "feynman_hibbs_order": ("feynman_hibbs_order", _INT),
    "sg": ("use_sg", _BOOL),
    "waldmanhagler": ("waldmanhagler", _BOOL),
    "halgren_mixing": ("halgren_mixing", _BOOL),
    "dreiding": ("use_dreiding", _BOOL),
    "lj_buffered_14_7": ("using_lj_buffered_14_7", _BOOL),
    "disp_expansion": ("using_disp_expansion", _BOOL),
    "extrapolate_disp_coeffs": ("extrapolate_disp_coeffs", _BOOL),
    "damp_dispersion": ("damp_dispersion", _BOOL),
    "disp_expansion_mbvdw": ("disp_expansion_mbvdw", _BOOL),
    "axilrod_teller": ("using_axilrod_teller", _BOOL),
    "midzuno_kihara_approx": ("midzuno_kihara_approx", _BOOL),
    "schmidt_ff": ("schmidt_ff", _BOOL),
    "c6_mixing": ("c6_mixing", _BOOL),
    "wrapall": ("wrapall", _BOOL),
    "scale_charge": ("scale_charge", _FLT),
    "ewald_kmax": ("ewald_kmax", _INT),
    "pbc_cutoff": ("pbc_cutoff", _FLT),
    "polarizability_tensor": ("polarizability_tensor", _BOOL),
    "polar_zodid": ("polar_zodid", _BOOL),
    "polar_iterative": ("polar_iterative", _BOOL),
    "polar_palmo": ("polar_palmo", _BOOL),
    "polar_gs": ("polar_gs", _BOOL),
    "polar_gs_ranked": ("polar_gs_ranked", _BOOL),
    "polar_sor": ("polar_sor", _BOOL),
    "polar_esor": ("polar_esor", _BOOL),
    "polar_gamma": ("polar_gamma", _FLT),
    "polar_damp": ("polar_damp", _FLT),
    "polar_precision": ("polar_precision", _FLT),
    "polar_max_iter": ("polar_max_iter", _INT),
    "polar_rrms": ("polar_rrms", _BOOL),
    "cuda": ("cuda", _BOOL),
    "opencl": ("opencl", _BOOL),
    "independent_particle": ("independent_particle", _BOOL),
    "pqr_input": ("pqr_input", _STR),
    "pqr_input_b": ("pqr_input_B", _STR),
    "pqr_output": ("pqr_output", _STR),
    "pqr_restart": ("pqr_restart", _STR),
    "traj_output": ("traj_output", _STR),
    "traj_input": ("traj_input", _STR),
    "energy_output": ("energy_output", _STR),
    "energy_output_csv": ("energy_output_csv", _STR),
    "pop_histogram_output": ("histogram_output", _STR),
    "dipole_output": ("dipole_output", _STR),
    "field_output": ("field_output", _STR),
    "frozen_output": ("frozen_output", _STR),
    "insert_input": ("insert_input", _STR),
    "surf_output": ("surf_output", _STR),
    "long_output": ("long_output", _BOOL),
    "read_pqr_box": ("read_pqr_box", _BOOL),
    "fit_schedule": ("fit_schedule", _FLT),
    "fit_max_energy": ("fit_max_energy", _FLT),
    "fit_start_temp": ("fit_start_temp", _FLT),
    "fit_boltzmann_weight": ("fit_boltzmann_weight", _BOOL),
    "max_bondlength": ("max_bondlength", _FLT),
    "pop_histogram": ("calc_hist", _BOOL),
    "pop_hist_resolution": ("hist_resolution", _FLT),
    "quantum_rotation": ("quantum_rotation", _BOOL),
    "quantum_rotation_hindered": ("quantum_rotation_hindered", _BOOL),
    "quantum_rotation_hindered_barrier":
        ("quantum_rotation_hindered_barrier", _FLT),
    "quantum_rotation_b": ("quantum_rotation_B", _FLT),
    "quantum_rotation_level_max": ("quantum_rotation_level_max", _INT),
    "quantum_rotation_l_max": ("quantum_rotation_l_max", _INT),
    "quantum_rotation_sum": ("quantum_rotation_sum", _INT),
    "quantum_vibration": ("quantum_vibration", _BOOL),
}

# keywords that also set a companion "_on" flag when given a value
_SCALE_KEYWORDS = {
    "surf_weight_constant": ("surf_weight_constant", "surf_weight_constant_on"),
    "surf_scale_q": ("surf_scale_q", "surf_scale_q_on"),
    "surf_scale_r": ("surf_scale_r", "surf_scale_r_on"),
    "surf_scale_epsilon": ("surf_scale_epsilon", "surf_scale_epsilon_on"),
    "surf_scale_sigma": ("surf_scale_sigma", "surf_scale_sigma_on"),
    "surf_scale_omega": ("surf_scale_omega", "surf_scale_omega_on"),
    "surf_scale_alpha": ("surf_scale_alpha", "surf_scale_alpha_on"),
    "surf_scale_pol": ("surf_scale_pol", "surf_scale_pol_on"),
    "surf_scale_c6": ("surf_scale_c6", "surf_scale_c6_on"),
    "surf_scale_c8": ("surf_scale_c8", "surf_scale_c8_on"),
    "surf_scale_c10": ("surf_scale_c10", "surf_scale_c10_on"),
}

_DEPRECATED = {
    "move_probability":
        "move_probability is no longer supported as this is not a "
        "probability, but a maximum factor by which to scale the length of "
        "random moves. Use move_factor instead.",
    "rot_probability":
        "rot_probability is no longer supported as this is not a "
        "probability, but the maximum rotation that can occur as a Monte "
        "Carlo rotational move. Use rot_factor instead.",
}


def process_command(cfg: SimConfig, tokens: list[str]) -> None:
    """Apply one tokenised input line to the config."""
    if not tokens or tokens[0].startswith("!") or tokens[0].startswith("#"):
        return
    kw = tokens[0].lower()
    args = tokens[1:]

    def need(n):
        if len(args) < n:
            raise ConfigError(f"{kw}: expected {n} argument(s)")

    if kw in _DEPRECATED:
        raise ConfigError(_DEPRECATED[kw])

    if kw == "ensemble":
        need(1)
        name = args[0].lower()
        if name not in const.ENSEMBLE_NAMES:
            raise ConfigError(f"unknown ensemble {args[0]!r}")
        cfg.ensemble = const.ENSEMBLE_NAMES[name]
        return

    if kw in ("seed", "preset_seed"):
        need(1)
        cfg.preset_seed = _to_int(args[0])
        cfg.preset_seed_on = True
        return

    if kw == "sorbate_orientation_site":
        need(2)
        cfg.sorbate_orientation_site[args[0]] = _to_int(args[1])
        return
    if kw == "sorbate_bondlength":
        need(2)
        cfg.sorbate_bond_length[args[0]] = _to_float(args[1])
        return
    if kw == "sorbate_reducedmass":
        need(2)
        cfg.sorbate_reduced_mass[args[0]] = _to_float(args[1])
        return

    if kw == "user_fugacities":
        if not args:
            raise ConfigError("user_fugacities: no fugacities given")
        cfg.user_fugacities = True
        cfg.fugacities = [_to_float(a) for a in args[:const.MAX_TOKENS - 1]]
        return

    if kw in ("polarvdw", "cdvdw"):
        # reference side effects (src/SimulationControl.cpp:662-684):
        # any "on"-like mode also forces polarization + polar_iterative
        # (matrix inversion would destroy the A-matrix before vdw uses it)
        need(1)
        a = args[0].lower()
        if a in ("on", "evects", "comp"):
            cfg.polarvdw = True
            cfg.polarization = True
            cfg.polar_iterative = True
        elif a == "off":
            cfg.polarvdw = False
        else:
            raise ConfigError(f"polarvdw: bad argument {args[0]!r}")
        return

    if kw == "polar_damp_type":
        need(1)
        m = {"none": const.DAMPING_OFF, "off": const.DAMPING_OFF,
             "linear": const.DAMPING_LINEAR,
             "exponential": const.DAMPING_EXPONENTIAL}
        a = args[0].lower()
        if a not in m:
            raise ConfigError(f"polar_damp_type: unknown type {args[0]!r}")
        cfg.damp_type = m[a]
        return

    if kw == "ewald_alpha":
        need(1)
        cfg.ewald_alpha = _to_float(args[0])
        cfg.ewald_alpha_set = True
        return
    if kw == "polar_ewald_alpha":
        need(1)
        cfg.polar_ewald_alpha = _to_float(args[0])
        cfg.polar_ewald_alpha_set = True
        return

    if kw in ("basis1", "basis2", "basis3"):
        need(3)
        setattr(cfg, kw, [_to_float(a) for a in args[:3]])
        return

    if kw == "surf_preserve_rotation":
        need(6)
        cfg.surf_preserve_rotation_on = True
        cfg.surf_preserve_rotation = [_to_float(a) for a in args[:6]]
        return

    if kw == "fit_input":
        need(1)
        cfg.fit_input.append(args[0])
        return

    if kw in _SCALE_KEYWORDS:
        need(1)
        val_attr, on_attr = _SCALE_KEYWORDS[kw]
        setattr(cfg, val_attr, _to_float(args[0]))
        setattr(cfg, on_attr, True)
        return

    if kw in SIMPLE_KEYWORDS:
        need(1)
        attr, conv = SIMPLE_KEYWORDS[kw]
        setattr(cfg, attr, conv(args[0]))
        return

    raise ConfigError(f"unknown keyword {tokens[0]!r}")


def parse_config(text: str) -> SimConfig:
    """Parse a full input file's text into a SimConfig."""
    cfg = SimConfig()
    for lineno, line in enumerate(text.splitlines(), 1):
        tokens = line.split()[:const.MAX_TOKENS]
        if not tokens:
            continue
        try:
            process_command(cfg, tokens)
        except ConfigError as e:
            raise ConfigError(f"line {lineno}: {e}") from None
    return cfg


def read_config(path: str) -> SimConfig:
    with open(path) as f:
        return parse_config(f.read())
