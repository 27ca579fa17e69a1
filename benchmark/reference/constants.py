"""Physical constants and unit conversions of MPMC++ (src/Constants.h),
the values the configurations' physics is stated in."""

pi = 3.141592653589793238462643383279502884
hBar2 = 1.11211999e-68     # (J s)^2, as MPMC++ states it
hBar4 = 1.23681087e-136    # (J s)^4
kB = 1.3806503e-23         # J/K
kB2 = 1.90619525e-46       # kB^2
M2A2 = 1.0e20              # m^2 -> A^2
M2A4 = 1.0e40
E2REDUCED = 408.7816       # e -> sqrt(K A)
AMU2KG = 1.66053873e-27
DEBYE2SKA = 85.10597636    # Debye -> sqrt(K A) A
OneOverSqrtPi = 0.5641895835477562869480794515607725858440506293289988
SMALL_dR = 1.0e-12         # the repulsion-dispersion cutoff test's slack
MAX_ITERATION_COUNT = 128  # sweeps before the SCF's divergence fallback
EWALD_KMAX_DEFAULT = 7
