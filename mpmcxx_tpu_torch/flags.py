"""Static force-field / solver configuration.

JAX twin: mpmcxx_tpu/flags.py (a copy; ``dense_only`` and
``require_supported`` at the end are new: the port keeps some terms on
the dense path and refuses a value outside a field's range).

A frozen, hashable dataclass passed as a static argument to jitted energy
functions.  Mirrors the option flags scattered through src/System.h:505-832;
anything that changes the *structure* of the computation lives here, anything
numeric-but-traced (temperature, pressure, ...) lives in RunParams.
"""

from __future__ import annotations

import dataclasses

from . import constants as const


@dataclasses.dataclass(frozen=True)
class FFlags:
    # repulsion/dispersion selection (src/System.Energy.cpp:112-126)
    rd_only: bool = False
    rd_anharmonic: bool = False
    use_sg: bool = False
    use_dreiding: bool = False
    using_lj_buffered_14_7: bool = False
    using_disp_expansion: bool = False
    cdvdw_exp_repulsion: bool = False
    using_axilrod_teller: bool = False
    gwp: bool = False
    spectre: bool = False

    # LJ options
    rd_lrc: bool = True
    rd_crystal: bool = False
    rd_crystal_order: int = 0
    feynman_hibbs: bool = False
    feynman_hibbs_order: int = 0
    feynman_kleinert: bool = False

    # anharmonic
    rd_anharmonic_k: float = 0.0
    rd_anharmonic_g: float = 0.0

    # mixing rules (src/System.cpp:1070-1177)
    waldmanhagler: bool = False
    halgren_mixing: bool = False
    cdvdw_9th_repulsion: bool = False
    cdvdw_sig_repulsion: bool = False
    c6_mixing: bool = False
    disp_expansion_mbvdw: bool = False
    extrapolate_disp_coeffs: bool = False
    schmidt_ff: bool = False
    damp_dispersion: bool = False
    midzuno_kihara_approx: bool = False

    # electrostatics
    wolf: bool = False
    ewald_kmax: int = const.EWALD_KMAX_DEFAULT

    # polarization
    polarization: bool = False
    polarvdw: bool = False
    vdw_fh_2be: bool = False
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
    # TPU mixed precision for the blocked SCF: pair coefficients are
    # precomputed once in float32 (native VPU/MXU) and every iteration is
    # pure einsums; dipoles/energies stay float64.  Off by default — the
    # float64 golden-energy contract is exact only with this off.
    polar_mixed: bool = False
    # warm-start the SCF from the dipoles carried on the state (only
    # honored with precision-based termination; reference cold-starts)
    polar_warm_start: bool = False
    # force the mixed-SCF plane representation (ops.polar.plane_mode):
    # 0 = auto; 4 = folded (cd, sx, sy, sz) even under exponential
    # damping, where auto picks the 3-plane in-kernel-recompute form.
    # The two trade HBM bytes (4 planes) against VPU flops (3 planes);
    # which wins is a per-chip measurement (docs/PERF.md), hence a knob.
    # Identical math either way: fold_outer_rows folds sqrt(-co) exactly
    # and the golden contract is gated on both.
    polar_plane_mode: int = 0
    damp_type: int = const.DAMPING_EXPONENTIAL

    # cavity
    cavity_autoreject: bool = False
    cavity_autoreject_absolute: bool = False

    # misc
    independent_particle: bool = False
    quantum_rotation: bool = False

    def replace(self, **kw) -> "FFlags":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunParams:
    """Traced numeric parameters for the energy/MC step (still hashable
    defaults; values are floats that become traced scalars under jit)."""

    temperature: float = 0.0
    pressure: float = 0.0
    ewald_alpha: float = const.EWALD_ALPHA_DEFAULT
    polar_ewald_alpha: float = const.EWALD_ALPHA_DEFAULT
    polar_damp: float = 0.0
    polar_gamma: float = 1.0
    polar_precision: float = 0.0
    polar_wolf_alpha: float = 0.0
    cavity_autoreject_scale: float = 0.0
    cavity_autoreject_repulsion: float = 0.0
    scale_charge: float = 1.0
    total_energy: float = 0.0  # for NVE

    def replace(self, **kw) -> "RunParams":
        return dataclasses.replace(self, **kw)


# FFlags fields the port may take at a value other than the default, and
# the values it takes there: every switch of the twin's ops/energy.py
# (each repulsion-dispersion form, mixing rule, many-body term,
# electrostatics variant and special move's term: the anharmonic
# oscillator with Feynman-Hibbs or Feynman-Kleinert, GWP, SPECTRE) and
# every Thole SCF, on float32 planes (polar_mixed) or in float64;
# damp_type takes the three damping forms.
_BOTH = (False, True)
_PORTED = {name: _BOTH for name in (
    "polarization", "polar_mixed", "polar_sor", "polar_esor",
    "polar_iterative", "polar_ewald", "polar_ewald_full", "polar_zodid",
    "polar_palmo", "polar_rrms", "polar_gs", "polar_gs_ranked",
    "polar_wolf", "polar_wolf_full", "polar_warm_start",
    "rd_only", "rd_anharmonic", "use_sg", "use_dreiding",
    "using_lj_buffered_14_7", "using_disp_expansion", "cdvdw_exp_repulsion",
    "using_axilrod_teller", "gwp", "spectre", "rd_crystal", "feynman_hibbs",
    "feynman_kleinert", "waldmanhagler", "halgren_mixing",
    "cdvdw_9th_repulsion", "cdvdw_sig_repulsion", "c6_mixing",
    "disp_expansion_mbvdw", "extrapolate_disp_coeffs", "schmidt_ff",
    "damp_dispersion", "midzuno_kihara_approx", "wolf", "polarvdw",
    "vdw_fh_2be", "cavity_autoreject", "cavity_autoreject_absolute",
    "independent_particle", "quantum_rotation")}
_PORTED["damp_type"] = (const.DAMPING_OFF, const.DAMPING_LINEAR,
                        const.DAMPING_EXPONENTIAL)
# numeric options read only under a ported switch, at any value
# (polar.plane_mode takes any polar_plane_mode but 4 as automatic)
_ANY = frozenset(["ewald_kmax", "rd_lrc", "rd_crystal_order",
                  "feynman_hibbs_order", "polar_max_iter",
                  "polar_plane_mode", "rd_anharmonic_k", "rd_anharmonic_g"])


def dense_only(flags: FFlags) -> bool:
    """Whether a term of the energy has no row-tiled or incremental form,
    so that only the dense full recompute computes it: the many-body vdW
    term (polarvdw, and disp_expansion_mbvdw's coupling of it into rd),
    Axilrod-Teller, the crystal sums, the GWP, SPECTRE and anharmonic
    branches, and the full-Ewald SCF (polar_ewald_full), whose induced
    field couples the dipoles through k-space.  This routes such a run
    dense in runner.capacity_opts, the Gibbs and PI set-ups and
    energy_breakdown_blocked, and keeps it off the polar cache.  The
    twin's lists (delta.py:39-44, runner.py:61-64) lack
    disp_expansion_mbvdw and polar_ewald_full: its row-tiled and
    incremental paths drop the mbvdw coupling silently, and its blocked
    SCF (polar.polar_blocked, above 1,024 slots) never reads
    polar_ewald_full and solves on the no-PBC field instead."""
    return (flags.polarvdw or flags.using_axilrod_teller or
            flags.rd_crystal or flags.gwp or flags.spectre or
            flags.rd_anharmonic or
            (flags.using_disp_expansion and flags.disp_expansion_mbvdw) or
            (flags.polarization and flags.polar_ewald_full))


def require_supported(flags: FFlags, params: RunParams) -> None:
    """Raise NotImplementedError naming the first flag at a value outside
    its range (an unknown damp_type); never run a different branch
    silently."""
    default = FFlags()
    for f in dataclasses.fields(FFlags):
        v = getattr(flags, f.name)
        if f.name in _PORTED:
            ok = v in _PORTED[f.name]
        elif f.name in _ANY:
            ok = True
        else:
            ok = v == getattr(default, f.name)
        if not ok:
            raise NotImplementedError(f"FFlags.{f.name}={v!r}")
