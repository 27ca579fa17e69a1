"""Lennard-Jones repulsion/dispersion.

JAX twin: mpmcxx_tpu/ops/pair_potentials.py (``lj`` and ``lj_lrc`` only:
src/System.Energy.cpp:897-1096).  The twin's other potentials, crystal
sums, Feynman-Hibbs and cavity branches are not ported;
flags.require_supported rejects the flags that reach them.
"""

from __future__ import annotations

import torch

from .. import constants as const
from ..flags import FFlags, RunParams
from ..state import SystemState
from .pairwise import PairTensors


def _safe_div(a, b):
    return a / torch.where(b == 0.0, 1.0, b)


def lj(state: SystemState, pt: PairTensors, flags: FFlags,
       params: RunParams, pair_only: bool = False):
    """Lennard-Jones energy (src/System.Energy.cpp:897-1032)."""
    cutoff = state.pbc.cutoff
    contrib = (pt.pair_once & pt.alive & (pt.rimg - const.SMALL_dR < cutoff) &
               ~pt.rd_excluded & ~pt.frozen)
    sor = _safe_div(torch.abs(pt.sigma), pt.rimg)
    sor6 = sor ** 6
    term12 = torch.where(pt.attractive_only, 0.0, sor6 * sor6)
    pot = 4.0 * pt.epsilon * (term12 - sor6)
    energy = torch.sum(torch.where(contrib, pot, 0.0))
    if flags.rd_lrc:
        energy = energy + lj_lrc(state, pt, cutoff, pair_only=pair_only)
    return energy


def lj_lrc(state: SystemState, pt: PairTensors, cutoff,
           pair_only: bool = False):
    """Pair + self long-range corrections (src/System.Energy.cpp:1036-1096)."""
    vol = state.pbc.volume
    # every alive, non-frozen pair with nonzero mixed eps & sigma;
    # rd-excluded (same molecule) pairs DO contribute (reference comment)
    sp = state.spectre
    ss_pair = pt.row(sp)[:, None] & sp[None, :]
    ok = (pt.pair_once & pt.alive & ~pt.frozen & ~ss_pair &
          (pt.epsilon != 0.0) & (pt.sigma != 0.0))
    sig_cut = torch.abs(pt.sigma) / cutoff
    sig3 = torch.abs(pt.sigma) ** 3
    sig_cut3 = sig_cut ** 3
    sig_cut9 = sig_cut3 ** 3
    pair_lrc = ((16.0 / 3.0) * const.pi * pt.epsilon * sig3 *
                ((1.0 / 3.0) * sig_cut9 - sig_cut3) / vol)
    total = torch.sum(torch.where(ok, pair_lrc, 0.0))
    if pair_only:
        return total

    aok = (state.atom_alive() & (state.sigma != 0.0) &
           (state.epsilon != 0.0) & ~state.frozen & ~state.spectre)
    s_cut = torch.abs(state.sigma) / cutoff
    s3 = torch.abs(state.sigma) ** 3
    s_cut3 = s_cut ** 3
    s_cut9 = s_cut3 ** 3
    self_lrc = ((16.0 / 3.0) * const.pi * state.epsilon * s3 *
                ((1.0 / 3.0) * s_cut9 - s_cut3) / vol)
    return total + torch.sum(torch.where(aok, self_lrc, 0.0))
