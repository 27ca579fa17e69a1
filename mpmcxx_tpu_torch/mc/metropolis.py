"""Boltzmann acceptance factors.

JAX twin: mpmcxx_tpu/mc/metropolis.py (``uvt_factor`` and
``spin_partfunc_ratio``; System::boltzmann_factor,
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


def spin_partfunc_ratio(nuclear_spin_after, g, u):
    """Ratio of rotational partition functions for the flipped state
    (src/System.MonteCarlo.cpp:1407-1415)."""
    return torch.where(nuclear_spin_after == const.NUCLEAR_SPIN_PARA,
                       g / (g + u), u / (g + u))
