"""Boltzmann acceptance factors.

JAX twin: mpmcxx_tpu/mc/metropolis.py (System::boltzmann_factor,
src/System.MonteCarlo.cpp:1345-1470).  Quantities are evaluated on the
post-move state, as in the reference.
"""

from __future__ import annotations

import torch

from .. import constants as const


def uvt_factor(movetype, delta_energy, temperature, volume, fugacity,
               N_after, sorbate_count, biased_move, cavity_volume,
               cavity_bias_probability, partfunc_ratio):
    """(src/System.MonteCarlo.cpp:1358-1422)"""
    T = temperature
    boltz = torch.exp(-delta_energy / T)
    f_ins = (volume * fugacity * const.ATM2REDUCED / (T * N_after) * boltz *
             sorbate_count)
    f_rem = (T * (N_after + 1.0) / (volume * fugacity * const.ATM2REDUCED) *
             boltz / sorbate_count)
    # cavity-biased variants (src/System.MonteCarlo.cpp:1370-1388)
    cb_ins = (cavity_volume * cavity_bias_probability * fugacity *
              const.ATM2REDUCED / (T * N_after)) * boltz * sorbate_count
    cb_rem = (T * (N_after + 1.0) /
              (cavity_volume * cavity_bias_probability * fugacity *
               const.ATM2REDUCED)) * boltz / sorbate_count
    ins = torch.where(biased_move, cb_ins, f_ins)
    rem = torch.where(biased_move, cb_rem, f_rem)
    return torch.where(
        movetype == const.MOVETYPE_INSERT, ins,
        torch.where(movetype == const.MOVETYPE_REMOVE, rem,
                    torch.where(movetype == const.MOVETYPE_SPINFLIP,
                                partfunc_ratio, boltz)))


def nvt_factor(movetype, delta_energy, temperature, partfunc_ratio):
    return torch.where(movetype == const.MOVETYPE_SPINFLIP, partfunc_ratio,
                       torch.exp(-delta_energy / temperature))


def npt_factor(movetype, delta_energy, temperature, pressure,
               v_old, v_new, N_after):
    vol = torch.exp(-(delta_energy
                      + pressure * const.ATM2REDUCED * (v_new - v_old)
                      - (N_after + 1) * temperature * torch.log(v_new / v_old))
                    / temperature)
    return torch.where(movetype == const.MOVETYPE_VOLUME, vol,
                       torch.exp(-delta_energy / temperature))


def nve_factor(total_energy, initial_energy, final_energy, N):
    """Microcanonical (E_tot - E)^{3N/2} weight ratio
    (src/System.MonteCarlo.cpp:1459-1462) in log space, as the twin
    (metropolis.py:61-90).  C pow sign semantics are kept (a reference
    quirk): with E > E_tot and 3N/2 integral, pow(negative, int) is signed
    and the signs of numerator and denominator cancel; with 3N/2
    non-integral pow(negative) is NaN and the step rejects.  E_old ==
    E_tot exactly (the reference divides by pow(0)) rejects."""
    num = total_energy - final_energy
    den = total_energy - initial_energy
    p = 1.5 * N
    is_int = p == torch.floor(p)
    odd = torch.remainder(torch.floor(p), 2.0) == 1.0

    def sign_valid(base):
        sign = torch.where((base < 0.0) & odd, -1.0, 1.0)
        return sign, (base > 0.0) | ((base < 0.0) & is_int)

    s_num, v_num = sign_valid(num)
    s_den, v_den = sign_valid(den)
    valid = v_num & v_den
    log_ratio = (torch.log(torch.abs(torch.where(valid, num, 1.0)))
                 - torch.log(torch.abs(torch.where(valid, den, 1.0))))
    return torch.where(valid, s_num * s_den * torch.exp(p * log_ratio), 0.0)


def spin_partfunc_ratio(nuclear_spin_after, g, u):
    """Ratio of rotational partition functions for the flipped state
    (src/System.MonteCarlo.cpp:1407-1415)."""
    return torch.where(nuclear_spin_after == const.NUCLEAR_SPIN_PARA,
                       g / (g + u), u / (g + u))
