"""Full-recompute energy: dense for small systems, in row blocks for
large ones.

JAX twin: mpmcxx_tpu/ops/energy.py (``EnergyBreakdown``,
``cavity_absolute_check``, ``energy_breakdown``, ``total_energy`` and
``energy_breakdown_blocked``): the equivalent of System::energy()
(src/System.Energy.cpp:19-171) on the dense [A,A] pairs, or by
O(B*A)-memory row-block tiling of the dense pair triangle.  The dense
path dispatches every repulsion-dispersion form, Ewald or Wolf
electrostatics, SPECTRE's no-PBC Coulomb, the GWP Coulomb and kinetic
terms, the anharmonic well, every Thole SCF (ops/polar.polar), the
many-body vdW term and the Axilrod-Teller 3-body term; the blocked one
the pairwise terms and the matrix-free SCFs (ops/polar.polar_blocked).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as const
from .. import tracing
from ..flags import FFlags, RunParams, dense_only, require_supported
from ..state import SystemState
from . import cuda_pairs, ewald, pair_potentials, polar, polarvdw, three_body
from .pairwise import PairTensors, build_pairs, build_pairs_block


class EnergyBreakdown(NamedTuple):
    total: torch.Tensor              # potential incl. GWP kinetic (K)
    rd: torch.Tensor
    coulombic: torch.Tensor
    polarization: torch.Tensor
    vdw: torch.Tensor
    three_body: torch.Tensor
    kinetic: torch.Tensor            # GWP kinetic
    mu: torch.Tensor                 # [A,3] induced dipoles
    polarization_iterations: torch.Tensor
    iterator_failed: torch.Tensor
    dipole_rrms: torch.Tensor
    cavity_penalty: torch.Tensor     # cavity_autoreject_absolute extra


def _no_polar(state: SystemState):
    """(energy, mu, iterations, failed, rrms) with polarization off."""
    z = torch.zeros((), dtype=torch.float64, device=state.pos.device)
    return z, state.mu * 0.0, z, torch.zeros_like(z, dtype=torch.bool), z


def _close_pairs(pt: PairTensors, params: RunParams):
    """Whether any inter-molecular pair of pt lies closer than the
    absolute scale (src/System.Cavity.cpp:211-228)."""
    return torch.any(pt.pair_once & pt.alive & ~pt.same_mol &
                     (pt.rimg < params.cavity_autoreject_scale))


def cavity_absolute_check(state: SystemState, pt: PairTensors,
                          params: RunParams):
    """MAXVALUE if any inter-molecular pair closer than the absolute scale
    (energy.py:39-45)."""
    return _penalty(_close_pairs(pt, params))


def _penalty(close):
    """MAXVALUE where ``close`` (a 0-d bool), else 0, in float64."""
    return torch.where(close, const.MAXVALUE,
                       torch.zeros((), dtype=torch.float64,
                                   device=close.device))


def energy_breakdown(state: SystemState, flags: FFlags,
                     params: RunParams) -> EnergyBreakdown:
    """Full energy on the dense [A,A] pairs (energy.py:48-117)."""
    require_supported(flags, params)
    pt = build_pairs(state, flags)
    z = torch.zeros((), dtype=torch.float64, device=state.pos.device)
    coul, vdw_e, kin = z, z, z
    pol, mu, pol_iters, failed, rrms = _no_polar(state)
    amat = None
    if not (flags.use_sg or flags.rd_only):
        if flags.spectre:
            coul = ewald.coulombic_nopbc(state, pt)
        elif flags.gwp:
            coul = ewald.coulombic_nopbc_gwp(state, pt)
            kin = ewald.coulombic_kinetic_gwp(state)
        else:
            coul = ewald.coulombic(state, pt, flags, params)
        if flags.polarization:
            pol, mu, pol_iters, failed, rrms = polar.polar(state, pt, flags,
                                                           params)
        if flags.polarvdw:
            amat = polar.thole_amatrix(state, pt, flags, params)
            vdw_e = polarvdw.vdw(state, amat, pt, flags, params)

    rd = pair_potentials.rd_energy(state, pt, flags, params)
    if flags.disp_expansion_mbvdw and flags.using_disp_expansion and not (
            flags.rd_anharmonic or flags.use_sg or flags.use_dreiding or
            flags.using_lj_buffered_14_7):
        # mbvdw couples the many-body vdW term into rd
        # (src/System.Energy.cpp:1998-2002)
        if amat is None:
            amat = polar.thole_amatrix(state, pt, flags, params)
        rd = rd + polarvdw.vdw(state, amat, pt, flags, params)
    tb = three_body.axilrod_teller(state, pt, flags) \
        if flags.using_axilrod_teller else z
    pen = cavity_absolute_check(state, pt, params) \
        if flags.cavity_autoreject_absolute else z
    return EnergyBreakdown(
        total=rd + coul + pol + vdw_e + tb + kin, rd=rd, coulombic=coul,
        polarization=pol, vdw=vdw_e, three_body=tb, kinetic=kin, mu=mu,
        polarization_iterations=pol_iters, iterator_failed=failed,
        dipole_rrms=rrms, cavity_penalty=pen)


def total_energy(state: SystemState, flags: FFlags,
                 params: RunParams) -> torch.Tensor:
    """Scalar potential energy with the cavity penalty, the MC accept
    input (System::energy()'s return value, src/System.Energy.cpp:167-170;
    energy.py:221-226)."""
    eb = energy_breakdown(state, flags, params)
    return eb.total + eb.cavity_penalty


def pair_sums_plain(state: SystemState, flags: FFlags, params: RunParams,
                    block: int = 256):
    """(rd, es, close) of the pairs by [block, A] row tiles of the dense
    triangle (energy.py:147-158): the repulsion-dispersion pair sums
    (pair_only: the whole-system self and LRC sums are added once by the
    caller), Wolf or Ewald real space unless ``use_sg``/``rd_only``, and
    the absolute cavity check where it is on.  K6
    (ops/cuda_pairs.pair_sums) computes the same sums on the card."""
    A = state.n_atom_slots
    dev = state.pos.device
    z = torch.zeros((), dtype=torch.float64, device=dev)
    use_es = not (flags.use_sg or flags.rd_only)
    rd, es, close = z, z, torch.zeros((), dtype=torch.bool, device=dev)
    for b in range(-(-A // block)):
        rows_f = b * block + torch.arange(block, device=dev)
        pt = build_pairs_block(state, flags,
                               torch.where(rows_f < A, rows_f, -1))
        rd = rd + pair_potentials.rd_energy(state, pt, flags, params,
                                            pair_only=True)
        if use_es:
            es = es + (ewald.coulombic_wolf if flags.wolf
                       else ewald.coulombic_real)(state, pt, flags, params)
        if flags.cavity_autoreject_absolute:
            close = close | _close_pairs(pt, params)
    return rd, es, close


def energy_breakdown_blocked(state: SystemState, flags: FFlags,
                             params: RunParams,
                             block: int = 256) -> EnergyBreakdown:
    """Full energy via [block, A] row tiles (energy.py:120-218): the
    pairwise terms and Thole polarization.  The pair sums run as one K6
    launch where ``cuda_pairs.takes`` the state and form (counted
    ``pair_kernel``), else as the row-tile loop ``pair_sums_plain``
    (``pair_plain``).  The full-Ewald SCF and the
    special moves' terms (SPECTRE, GWP, the anharmonic well) are routed
    to the dense ``energy_breakdown`` (flags.dense_only; the twin's
    blocked SCF would solve on the no-PBC field instead, and its blocked
    energy raises on the special moves); the many-body and crystal-sum
    terms are dense-only and raise."""
    require_supported(flags, params)
    if (flags.polarization and flags.polar_ewald_full) or flags.spectre or \
            flags.gwp or flags.rd_anharmonic:
        return energy_breakdown(state, flags, params)
    if dense_only(flags):
        raise ValueError("blocked energy requires pairwise + k-space terms "
                         "(+ optional Thole polarization); polarvdw/mbvdw/"
                         "3-body/rd_crystal are dense-only")
    dev = state.pos.device
    z = torch.zeros((), dtype=torch.float64, device=dev)
    use_es = not (flags.use_sg or flags.rd_only)
    # pair sums only: the whole-system self/LRC sums are added once
    if cuda_pairs.takes(state, flags):
        tracing.count("pair_kernel")
        rd, es, close = cuda_pairs.pair_sums(state, flags, params)
    else:
        tracing.count("pair_plain")
        rd, es, close = pair_sums_plain(state, flags, params, block)

    if flags.rd_lrc and not (flags.use_sg or flags.use_dreiding or
                             flags.using_lj_buffered_14_7):
        # the self-only part: the pair part over an empty row set
        empty = build_pairs_block(
            state, flags, -torch.ones(1, dtype=torch.int64, device=dev))
        rd = rd + pair_potentials.rd_energy(state, empty, flags, params)

    coul = z
    if use_es:
        coul = es
        if not flags.wolf:
            coul = coul + ewald.coulombic_reciprocal(state, flags, params) + \
                ewald.coulombic_self(state, params)
    pol, mu, pol_iters, failed, rrms = _no_polar(state)
    if flags.polarization and use_es:
        pol, mu, pol_iters, failed, rrms = polar.polar_blocked(
            state, flags, params, block)
    pen = _penalty(close) if flags.cavity_autoreject_absolute else z
    return EnergyBreakdown(
        total=rd + coul + pol, rd=rd, coulombic=coul, polarization=pol,
        vdw=z, three_body=z, kinetic=z, mu=mu,
        polarization_iterations=pol_iters, iterator_failed=failed,
        dipole_rrms=rrms, cavity_penalty=pen)
