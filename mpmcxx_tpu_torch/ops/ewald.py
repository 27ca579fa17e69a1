"""Ewald electrostatics.

JAX twin: mpmcxx_tpu/ops/ewald.py: the real-space erfc sum with the
intra-molecular screening correction (src/System.Energy.cpp:1466-1517)
and its Feynman-Hibbs correction (:1521-1557), hemisphere k-space
structure factors (:1561-1622), the self term (:1626-1643), the Wolf
damped-shifted sum (:1420-1462), and the special moves' terms: SPECTRE's
plain no-PBC Coulomb (:1304-1326) and the Gaussian-wave-packet Coulomb
and kinetic energies (:1330-1392).  Charges are in reduced units
sqrt(K*Angstrom); energies in Kelvin.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import constants as const
from ..flags import FFlags, RunParams
from ..state import SystemState
from .pair_potentials import _reduced_mass_kg
from .pairwise import PairTensors, phase_dot

_SQRT_PI = float(np.sqrt(const.pi))


@lru_cache(maxsize=8)
def hemisphere_kvecs(kmax: int) -> np.ndarray:
    """Static integer k-lattice over the reference's hemisphere
    (src/System.Energy.cpp:1577-1583)."""
    out = []
    for l0 in range(0, kmax + 1):
        for l1 in range(0 if l0 == 0 else -kmax, kmax + 1):
            for l2 in range(1 if (l0 == 0 and l1 == 0) else -kmax, kmax + 1):
                if l0 * l0 + l1 * l1 + l2 * l2 > kmax * kmax:
                    continue
                out.append((l0, l1, l2))
    return np.asarray(out, dtype=np.float64)


@lru_cache(maxsize=8)
def _kvecs_on(kmax: int, device: torch.device) -> torch.Tensor:
    # one host-to-device copy per device: the MC step never waits on one
    return torch.as_tensor(hemisphere_kvecs(kmax), dtype=torch.float64,
                           device=device)


def kvectors(state: SystemState, kmax: int):
    """[K,3] reciprocal vectors 2*pi * l @ recip.T and [K] k^2."""
    rec = state.pbc.reciprocal
    k = 2.0 * const.pi * phase_dot(_kvecs_on(kmax, rec.device), rec)
    return k, torch.sum(k * k, dim=-1)


def coulombic_real_fh(flags: FFlags, params: RunParams, state: SystemState,
                      rimg, gaussian_term, erfc_term, pt=None):
    """FH correction for the real-space sum
    (src/System.Energy.cpp:1521-1557)."""
    alpha = params.ewald_alpha
    r = torch.where(rimg == 0.0, 1.0, rimg)
    rr = r * r
    ir = 1.0 / r
    ir2, ir3, ir4 = ir * ir, ir ** 3, ir ** 4
    a2 = alpha * alpha
    a3 = a2 * alpha
    a4 = a3 * alpha
    rm = _reduced_mass_kg(state, pt)
    T = params.temperature
    du = -2.0 * alpha * gaussian_term / (r * _SQRT_PI) - erfc_term * ir2
    d2u = (4.0 / _SQRT_PI) * gaussian_term * (a3 + 1.0 * ir2) + \
        2.0 * erfc_term * ir3
    fh = (const.M2A2 * (const.hBar2 / (24.0 * const.kB * T * rm)) *
          (d2u + 2.0 * du / r))
    if flags.feynman_hibbs_order >= 4:
        d3u = (gaussian_term / _SQRT_PI) * (
            -8.0 * (a3 * a2) * r - 8.0 * a3 / r - 12.0 * alpha * ir3) - \
            6.0 * erfc_term * ir4
        d4u = (gaussian_term / _SQRT_PI) * (
            8.0 * a3 * a2 + 16.0 * a3 * a4 * rr + 32.0 * a3 * ir2 +
            48.0 * ir4) + 24.0 * erfc_term * (ir4 * ir)
        fh = fh + (const.M2A4 *
                   (const.hBar4 / (1152.0 * const.kB2 * T * T * rm * rm)) *
                   (15.0 * du * ir3 + 4.0 * d3u / r + d4u))
    return fh


def coulombic_real(state: SystemState, pt: PairTensors, flags: FFlags,
                   params: RunParams):
    """Real-space erfc sum minus intra-molecular screening correction."""
    alpha = params.ewald_alpha
    q_i, q_j = pt.row(state.charge)[:, None], state.charge[None, :]
    base = pt.pair_once & pt.alive & ~pt.frozen
    in_cut = ~(pt.rimg > state.pbc.cutoff) & ~pt.es_excluded
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    erfc_term = torch.special.erfc(alpha * r)
    pot = q_i * q_j * erfc_term / r
    if flags.feynman_hibbs:
        pot = pot + coulombic_real_fh(flags, params, state, pt.rimg,
                                      torch.exp(-alpha * alpha * r * r),
                                      erfc_term, pt)
    real = torch.sum(torch.where(base & in_cut, pot, 0.0))
    # screening-charge correction for excluded (same-molecule) pairs uses
    # the real (unwrapped) distance (src/System.Energy.cpp:1504)
    rr = torch.where(pt.r == 0.0, 1.0, pt.r)
    intra = q_i * q_j * torch.special.erf(alpha * rr) / rr
    return real - torch.sum(torch.where(base & pt.es_excluded, intra, 0.0))


def coulombic_reciprocal(state: SystemState, flags: FFlags,
                         params: RunParams):
    """Hemisphere structure-factor sum."""
    alpha = params.ewald_alpha
    k, k2 = kvectors(state, flags.ewald_kmax)
    q = torch.where(state.atom_alive() & ~state.frozen, state.charge, 0.0)
    phase = phase_dot(state.pos, k)             # [A,K]
    sf_re = q @ torch.cos(phase)                # [K]
    sf_im = q @ torch.sin(phase)
    pot = torch.sum(torch.exp(-k2 / (4.0 * alpha * alpha)) / k2 *
                    (sf_re ** 2 + sf_im ** 2))
    return pot * 4.0 * const.pi / state.pbc.volume


def coulombic_self(state: SystemState, params: RunParams):
    alpha = params.ewald_alpha
    ok = state.atom_alive() & ~state.frozen
    return -torch.sum(torch.where(
        ok, alpha * state.charge ** 2 / np.sqrt(const.pi), 0.0))


def coulombic_wolf(state: SystemState, pt: PairTensors, flags: FFlags,
                   params: RunParams):
    """Wolf damped-shifted direct sum (src/System.Energy.cpp:1420-1462).
    It has no self term: the total is this pair sum alone."""
    alpha = params.ewald_alpha
    R = state.pbc.cutoff
    iR = 1.0 / R
    erfaRoverR = torch.special.erf(alpha * R) / R
    ok = (pt.pair_once & pt.alive & ~pt.frozen & ~pt.es_excluded &
          (pt.rimg < R))
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    q_i, q_j = pt.row(state.charge)[:, None], state.charge[None, :]
    pot = q_i * q_j * (1.0 / r - erfaRoverR - iR * iR * (R - r))
    return torch.sum(torch.where(ok, pot, 0.0))


def coulombic_nopbc(state: SystemState, pt: PairTensors):
    """Plain Coulomb over the real (unwrapped) distance, no PBC
    (src/System.Energy.cpp:1304-1326; ewald.py:149-154)."""
    ok = pt.pair_once & pt.alive & ~pt.es_excluded
    r = torch.where(pt.r == 0.0, 1.0, pt.r)
    q_i, q_j = pt.row(state.charge)[:, None], state.charge[None, :]
    return torch.sum(torch.where(ok, q_i * q_j / r, 0.0))


def coulombic_nopbc_gwp(state: SystemState, pt: PairTensors):
    """Gaussian-wave-packet Coulomb (src/System.Energy.cpp:1330-1367;
    ewald.py:157-169): over every pair, with no exclusion, as the
    reference applies it."""
    ok = pt.pair_once & pt.alive
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    q_i, q_j = pt.row(state.charge)[:, None], state.charge[None, :]
    ai = pt.row(state.gwp_alpha)[:, None]
    aj = state.gwp_alpha[None, :]
    spin = pt.row(state.gwp_spin)[:, None] | state.gwp_spin[None, :]
    pe_gwp = q_i * q_j * torch.special.erf(
        torch.sqrt(1.5 * (ai * ai + aj * aj)) * r) / r
    pe = torch.where(spin, pe_gwp, q_i * q_j / r)
    return torch.sum(torch.where(ok, pe, 0.0))


def coulombic_kinetic_gwp(state: SystemState):
    """GWP kinetic energy (src/System.Energy.cpp:1371-1392;
    ewald.py:172-179)."""
    ok = state.atom_alive() & state.gwp_spin
    ai = state.gwp_alpha / const.METER2ANGSTROM
    mass = const.AMU2KG * state.mass
    e = 9.0 * const.hBar ** 2 / (8.0 * ai * ai * torch.where(
        mass == 0, 1.0, mass)) / const.kB
    return torch.sum(torch.where(ok, e, 0.0))


def coulombic(state: SystemState, pt: PairTensors, flags: FFlags,
              params: RunParams):
    """Total electrostatic energy of the pairs in ``pt``: Wolf or Ewald
    (src/System.Energy.cpp:1396-1416)."""
    if flags.wolf:
        return coulombic_wolf(state, pt, flags, params)
    return (coulombic_real(state, pt, flags, params) +
            coulombic_reciprocal(state, flags, params) +
            coulombic_self(state, params))
