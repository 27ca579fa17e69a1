"""Full-recompute energy: dense for small systems, in row blocks for
large ones.

JAX twin: mpmcxx_tpu/ops/energy.py (``EnergyBreakdown``,
``energy_breakdown`` and ``energy_breakdown_blocked``, the LJ + Ewald +
Thole branches): the equivalent of System::energy()
(src/System.Energy.cpp:19-171) on the dense [A,A] pairs, or by
O(B*A)-memory row-block tiling of the dense pair triangle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..flags import FFlags, RunParams, require_supported
from ..state import SystemState
from . import ewald, pair_potentials, polar
from .pairwise import build_pairs, build_pairs_block


class EnergyBreakdown(NamedTuple):
    total: torch.Tensor              # potential (K)
    rd: torch.Tensor
    coulombic: torch.Tensor
    polarization: torch.Tensor
    vdw: torch.Tensor
    three_body: torch.Tensor
    kinetic: torch.Tensor
    mu: torch.Tensor                 # [A,3] induced dipoles
    polarization_iterations: torch.Tensor
    iterator_failed: torch.Tensor
    dipole_rrms: torch.Tensor
    cavity_penalty: torch.Tensor


def _no_polar(state: SystemState):
    """(energy, mu, iterations, failed, rrms) with polarization off."""
    z = torch.zeros((), dtype=torch.float64, device=state.pos.device)
    return z, state.mu * 0.0, z, torch.zeros_like(z, dtype=torch.bool), z


def energy_breakdown(state: SystemState, flags: FFlags,
                     params: RunParams) -> EnergyBreakdown:
    """Full energy on the dense [A,A] pairs (energy.py:48-117)."""
    require_supported(flags, params)
    pt = build_pairs(state, flags)
    coul = ewald.coulombic(state, pt, flags, params)
    if flags.polarization:
        pol, mu, pol_iters, failed, rrms = polar.polar(state, pt, flags,
                                                       params)
    else:
        pol, mu, pol_iters, failed, rrms = _no_polar(state)
    rd = pair_potentials.lj(state, pt, flags, params)
    z = torch.zeros_like(rd)
    return EnergyBreakdown(
        total=rd + coul + pol, rd=rd, coulombic=coul, polarization=pol,
        vdw=z, three_body=z, kinetic=z, mu=mu,
        polarization_iterations=pol_iters, iterator_failed=failed,
        dipole_rrms=rrms, cavity_penalty=z)


def energy_breakdown_blocked(state: SystemState, flags: FFlags,
                             params: RunParams,
                             block: int = 256) -> EnergyBreakdown:
    """Full energy via [block, A] row tiles (energy.py:120-218)."""
    require_supported(flags, params)
    A = state.n_atom_slots
    dev = state.pos.device
    z = torch.zeros((), dtype=torch.float64, device=dev)
    rd, es = z, z
    for b in range(-(-A // block)):
        rows_f = b * block + torch.arange(block, device=dev)
        pt = build_pairs_block(state, flags,
                               torch.where(rows_f < A, rows_f, -1))
        rd = rd + pair_potentials.lj(state, pt, flags, params,
                                     pair_only=True)
        es = es + ewald.coulombic_real(state, pt, flags, params)

    if flags.rd_lrc:
        # the self-only part: pair part over an empty row set
        empty = build_pairs_block(
            state, flags, -torch.ones(1, dtype=torch.int64, device=dev))
        rd = rd + pair_potentials.lj(state, empty, flags, params)

    coul = es + ewald.coulombic_reciprocal(state, flags, params) + \
        ewald.coulombic_self(state, params)
    if flags.polarization:
        pol, mu, pol_iters, failed, rrms = polar.polar_blocked(
            state, flags, params, block)
    else:
        pol, mu, pol_iters, failed, rrms = _no_polar(state)
    return EnergyBreakdown(
        total=rd + coul + pol, rd=rd, coulombic=coul, polarization=pol,
        vdw=z, three_body=z, kinetic=z, mu=mu,
        polarization_iterations=pol_iters, iterator_failed=failed,
        dipole_rrms=rrms, cavity_penalty=z)
