"""Equations of state for uVT chemical potentials.

JAX twin: mpmcxx_tpu/mc/fugacity.py (a copy; numpy only).

Host-side scalar math (numpy), replacing src/Fugacity.cpp:9-670.  The
reference repeats the BACK and Peng-Robinson machinery per gas; here both are
single parameterised implementations with per-species constants, and the
BACK pressure integration is vectorised.

All pressures in atm, temperatures in K; returns fugacity in atm.
"""

from __future__ import annotations

import math

import numpy as np

from .. import constants as const

# BACK universal D constants (m-major, 9x4)
_BACK_D = np.array([
    [-8.8043, 2.9396, -2.8225, 0.34],
    [4.164627, -6.0865383, 4.7600148, -3.1875014],
    [-48.203555, 40.137956, 11.257177, 12.231796],
    [140.4362, -76.230797, -66.382743, -12.110681],
    [-195.23339, -133.70055, 69.248785, 0.0],
    [113.515, 860.25349, 0.0, 0.0],
    [0.0, -1535.3224, 0.0, 0.0],
    [0.0, 1221.4261, 0.0, 0.0],
    [0.0, -409.10539, 0.0, 0.0],
])

# per-species BACK constants: alpha, u0, v00, n  (BACK_C is universal 0.12)
_BACK_SPECIES = {
    "h2": (1.033, 38.488, 9.746, 0.00),
    "ch4": (1.000, 188.047, 21.532, 2.40),
    "n2": (1.048, 120.489, 18.955, 10.81),
}
_BACK_C = 0.12

# Peng-Robinson critical constants: Tc (K), Pc (atm), acentric factor
_PR_SPECIES = {
    "ch4": (190.564, 45.391, 0.01142),
    "n2": (126.192, 33.514, 0.037),
    "co2": (304.12, 73.74 / 1.01325, 0.225),
}
_PR_R = 0.08206  # atm L / (mol K)


def back_compressibility(species: str, temperature, pressure):
    """BACK EoS compressibility factor (vectorised over pressure)."""
    alpha, u0, v00, nconst = _BACK_SPECIES[species]
    P = np.asarray(pressure, dtype=float)
    v0 = v00 * (1.0 - _BACK_C * math.exp(-3.0 * u0 / temperature))
    V = const.NA * const.kB * temperature / (P * const.ATM2PASCALS * 1.0e-6)
    u = u0 * (1.0 + nconst / temperature)

    m = np.arange(1, 10)[:, None]          # [9,1]
    n = np.arange(1, 5)[None, :]           # [1,4]
    un = (u / temperature) ** n            # [1,4]
    vm = (v0 / V[..., None, None]) ** m    # [...,9,1]
    attractive = np.sum(m * _BACK_D * un * vm, axis=(-2, -1))

    y = (const.pi * math.sqrt(2.0) / 6.0) * \
        (P * const.ATM2PASCALS * 1.0e-6) / \
        (const.NA * const.kB * temperature) * v0
    repulsive = (1.0 + (3.0 * alpha - 2.0) * y +
                 (3.0 * alpha ** 2 - 3.0 * alpha + 1.0) * y ** 2 -
                 alpha ** 2 * y ** 3) / (1.0 - y) ** 3
    return repulsive + attractive


def back_fugacity(species: str, temperature, pressure):
    """phi = exp( int_0^P (z-1)/P dP ) via the reference's 0.001-atm grid."""
    dP = 0.001
    nsteps = int(math.floor(pressure / dP + 1e-9))
    P = dP * np.arange(1, nsteps + 1)
    z = back_compressibility(species, temperature, P)
    lnphi = np.sum(dP * (z - 1.0) / P)
    return pressure * math.exp(lnphi)


def pr_fugacity(species: str, temperature, pressure):
    """Peng-Robinson fugacity with the reference's cubic-root selection
    (largest real root; src/Fugacity.cpp:322-346)."""
    Tc, Pc, w = _PR_SPECIES[species]
    R = _PR_R
    aa = 0.45724 * R * R * Tc * Tc / Pc
    bb = 0.07780 * R * Tc / Pc
    Tr = temperature / Tc
    kappa = 0.37464 + 1.54226 * w - 0.26992 * w * w
    alpha = (1.0 + kappa * (1.0 - math.sqrt(Tr))) ** 2
    A = alpha * aa * pressure / (R * R * temperature * temperature)
    B = bb * pressure / (R * temperature)

    j = -(1.0 - B)
    k = A - 3.0 * B * B - 2.0 * B
    l = -(A * B - B * B - B ** 3)
    Q = (j * j - 3.0 * k) / 9.0
    X = (2.0 * j ** 3 - 9.0 * j * k + 27.0 * l) / 54.0
    if X * X < Q ** 3:
        theta = math.acos(X / math.sqrt(Q ** 3))
        roots = [-2.0 * math.sqrt(Q) * math.cos((theta + s) / 3.0) - j / 3.0
                 for s in (0.0, 2.0 * const.pi, -2.0 * const.pi)]
        # reference picks via (1-r) comparisons without abs -> largest root
        r1, r2, r3 = roots
        if (1 - r1) < (1 - r2) and (1 - r1) < (1 - r3):
            Z = r1
        elif (1 - r2) < (1 - r3) and (1 - r2) < (1 - r1):
            Z = r2
        else:
            Z = r3
    else:
        uu = abs(X - math.sqrt(X * X - Q ** 3))
        U = uu ** (1.0 / 3.0)
        Z = U + Q / U - j / 3.0

    s2 = math.sqrt(2.0)
    lnfoverp = ((Z - 1.0) - math.log(Z - B) -
                A / (2.0 * s2 * B) *
                math.log((Z + (1 + s2) * B) / (Z + (1 - s2) * B)))
    return math.exp(lnfoverp) * pressure


def _zhou(pressure):
    """Zhou low-T polynomial (shared by H2 and N2;
    src/Fugacity.cpp:151-170, :567-587)."""
    p = pressure * const.ATM2PSI
    lnphi = (-1.38130e-4 * p + 4.67096e-8 * p ** 2 / 2 +
             5.93690e-12 * p ** 3 / 3 - 3.24527e-15 * p ** 4 / 4 +
             3.54211e-19 * p ** 5 / 5)
    return pressure * math.exp(lnphi)


def h2_fugacity(temperature, pressure):
    """(src/Fugacity.cpp:9-26)"""
    if temperature == 77.0 and pressure <= 200.0:
        return _zhou(pressure)
    if temperature >= 273.15:
        # Shaw-Wones empirical relation (src/Fugacity.cpp:124-144)
        C1 = math.exp(-3.8402 * temperature ** 0.125 + 0.5410)
        C2 = math.exp(-0.1263 * math.sqrt(temperature) - 15.980)
        C3 = 300.0 * math.exp(-0.11901 * temperature - 5.941)
        lnphi = (C1 * pressure - C2 * pressure ** 2 +
                 C3 * math.exp(-pressure / 300.0 - 1.0))
        return math.exp(lnphi) * pressure
    return back_fugacity("h2", temperature, pressure)


def ch4_fugacity(temperature, pressure):
    """(src/Fugacity.cpp:175-195)"""
    if 298.0 <= temperature <= 300.0 and pressure <= 500.0:
        return back_fugacity("ch4", temperature, pressure)
    if temperature == 150.0 and pressure <= 200.0:
        return pr_fugacity("ch4", temperature, pressure)
    return back_fugacity("ch4", temperature, pressure)


def n2_fugacity(temperature, pressure):
    """(src/Fugacity.cpp:370-401)"""
    if temperature == 78.0 and pressure <= 1.0:
        return _zhou(pressure)
    if temperature == 78.0 and 10.0 <= pressure <= 300.0:
        return pr_fugacity("n2", temperature, pressure)
    if temperature == 150.0 and pressure < 175.0:
        return pr_fugacity("n2", temperature, pressure)
    if temperature == 150.0 and 175.0 <= pressure <= 325.0:
        return back_fugacity("n2", temperature, pressure)
    if 298.0 <= temperature <= 300.0 and pressure <= 350.0:
        return pr_fugacity("n2", temperature, pressure)
    return pr_fugacity("n2", temperature, pressure)


def co2_fugacity(temperature, pressure):
    """(src/Fugacity.cpp:599-669)"""
    return pr_fugacity("co2", temperature, pressure)
