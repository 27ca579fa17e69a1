"""Physical constants and unit conversions.

JAX twin: mpmcxx_tpu/constants.py (a verbatim copy; the JAX package
cannot be imported here because its __init__ imports jax).

Energies are in Kelvin, distances in Angstroms, charge in sqrt(K*Angstrom)
(reduced units) throughout the framework, matching the reference contract
(reference: src/constants.h:12-56).
"""


# --- physical constants (src/constants.h:13-23) ---
pi = 3.141592653589793238462643383279502884
h = 6.626068e-34           # Planck's constant, J s
hBar = 1.054571e-34        # h / 2pi, J s
c_hBar = 7.63822291e-12    # hbar in K s
hBar2 = 1.11211999e-68     # hBar^2, (J s)^2
hBar4 = 1.23681087e-136    # hBar^4, (J s)^4
half_hBar = 3.81911146e-12 # hBar/2 in K s
kB = 1.3806503e-23         # Boltzmann constant, J/K
kB2 = 1.90619525e-46       # kB^2
NA = 6.0221415e23          # Avogadro's number
c_light = 2.99792458e8     # speed of light, m/s

# --- conversion factors (src/constants.h:28-50) ---
au2invseconds = 4.13412763705666648752113572754445220741745180640e16
AU2ANGSTROM = 0.529177249
METER2ANGSTROM = 1.0e10
ANGSTROM2METER = 1.0e-10
M2A2 = 1.0e20
M2A4 = 1.0e40
HARTREE2KELVIN = 3.15774655e5
E2REDUCED = 408.7816        # e -> sqrt(K*A)
ATM2REDUCED = 0.0073389366  # atm -> K/A^3
ATM2PASCALS = 101325.0
ATM2PSI = 14.6959488
A32CM3 = 1.0e-24
AMU2KG = 1.66053873e-27
DEBYE2SKA = 85.10597636
EV2K = 1.160444e4
K2WN = 0.695039
KoverANGcubed2ATM = 136.259
LITER2A3 = 1.0e27
GASCONSTANT = 0.8205746

OneOverSqrtPi = 0.5641895835477562869480794515607725858440506293289988
SqrtPi = 1.77245385091
twoPi = 2.0 * pi

MAX_ITERATION_COUNT = 128
# The reference uses 1e40 (src/constants.h:53).  TPU "float64" is
# double-word float32 emulation with float32's EXPONENT range (~1e38), so
# 1e40 overflows to inf there and poisons the dense Thole A-matrix diagonal
# (alpha=0 atoms) with NaNs.  1e30 serves the same effectively-infinite
# sentinel role on every backend.
MAXVALUE = 1.0e30
SMALL_dR = 1.0e-12
FEYNMAN_KLEINERT_TOLERANCE = 1.0e-12

# --- enums (src/constants.h:62-95) ---
DAMPING_OFF = 0
DAMPING_LINEAR = 1
DAMPING_EXPONENTIAL = 2

NUCLEAR_SPIN_PARA = 0
NUCLEAR_SPIN_ORTHO = 1

ENSEMBLE_UVT = 0
ENSEMBLE_NVT = 1
ENSEMBLE_SURF = 2
ENSEMBLE_SURF_FIT = 3
ENSEMBLE_NVE = 4
ENSEMBLE_TE = 5
ENSEMBLE_NPT = 6
ENSEMBLE_REPLAY = 7
ENSEMBLE_PATH_INTEGRAL_NVT = 8
ENSEMBLE_NVT_GIBBS = 9

ENSEMBLE_NAMES = {
    "uvt": ENSEMBLE_UVT,
    "nvt": ENSEMBLE_NVT,
    "surf": ENSEMBLE_SURF,
    "surf_fit": ENSEMBLE_SURF_FIT,
    "nve": ENSEMBLE_NVE,
    "total_energy": ENSEMBLE_TE,
    "te": ENSEMBLE_TE,
    "npt": ENSEMBLE_NPT,
    "replay": ENSEMBLE_REPLAY,
    "pi_nvt": ENSEMBLE_PATH_INTEGRAL_NVT,
    "nvt_gibbs": ENSEMBLE_NVT_GIBBS,
}

MOVETYPE_INSERT = 0
MOVETYPE_REMOVE = 1
MOVETYPE_DISPLACE = 2
MOVETYPE_ADIABATIC = 3
MOVETYPE_SPINFLIP = 4
MOVETYPE_VOLUME = 5
MOVETYPE_PERTURB_BEADS = 6

MOVETYPE_NAMES = {
    MOVETYPE_INSERT: "insert",
    MOVETYPE_REMOVE: "remove",
    MOVETYPE_DISPLACE: "displace",
    MOVETYPE_ADIABATIC: "adiabatic",
    MOVETYPE_SPINFLIP: "spinflip",
    MOVETYPE_VOLUME: "volume",
    MOVETYPE_PERTURB_BEADS: "bead_perturb",
}

# defaults (src/System.h:21-24)
EWALD_ALPHA_DEFAULT = 0.5
EWALD_KMAX_DEFAULT = 7
PTEMP_FREQ_DEFAULT = 20
WOLF_ALPHA_LOOKUP_CUTOFF_DEFAULT = 30.0

MAX_TOKENS = 10
