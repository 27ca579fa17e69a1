"""Full-recompute energy in row blocks.

JAX twin: mpmcxx_tpu/ops/energy.py (``EnergyBreakdown`` and
``energy_breakdown_blocked``, the LJ + Ewald + Thole branches): the
equivalent of System::energy() (src/System.Energy.cpp:19-171) by
O(B*A)-memory row-block tiling of the dense pair triangle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..flags import FFlags, RunParams, require_supported
from ..state import SystemState
from . import ewald, pair_potentials, polar
from .pairwise import build_pairs_block


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
    pol, mu, pol_iters, failed, rrms = polar.polar_blocked(state, flags,
                                                           params, block)
    return EnergyBreakdown(
        total=rd + coul + pol, rd=rd, coulombic=coul, polarization=pol,
        vdw=z, three_body=z, kinetic=z, mu=mu,
        polarization_iterations=pol_iters, iterator_failed=failed,
        dipole_rrms=rrms, cavity_penalty=z)
