"""Incremental Delta-E move evaluation.

JAX twin: mpmcxx_tpu/ops/delta.py.  For a move that touches one
molecule, evaluate the pair kernels on the [S,A] slice (S = that
molecule's atom slots) in the old and new states and take the difference
— O(S*A) instead of O(A^2) — plus an incrementally maintained Ewald
structure factor for the k-space term (the role of the reference's
``recalculate_energy`` pair caches, src/System.cpp:1202-1279).  Every
pairwise repulsion-dispersion form and Ewald or Wolf electrostatics run
here (``rect_rd``, ``rect_es_real``).

One deliberate difference from the twin: with Wolf electrostatics no
Ewald self-term difference is added.  The Wolf total (ewald.coulombic)
has no self term, so the twin's delta.py:152-155 gives a Delta-E that is
off by alpha * sum q^2 / sqrt(pi) of the molecule on every insertion and
removal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as const
from ..flags import FFlags, RunParams, dense_only
from ..state import SystemState
from . import ewald, pair_potentials
from .pairwise import (build_pairs_rect, normalize_window, phase_dot,
                       slice_rows, sum_small_rows)


def supports(flags: FFlags) -> bool:
    """True when the total energy is strictly pairwise + k-space
    (delta.py:39-44)."""
    return not (flags.polarization or dense_only(flags))


def uses_recip(flags: FFlags) -> bool:
    """Whether the energy has a k-space term the structure-factor cache
    tracks (delta.py:47-48)."""
    return not (flags.use_sg or flags.rd_only or flags.wolf)


class SFCache(NamedTuple):
    """Ewald structure factors over the static hemisphere k-lattice."""
    re: torch.Tensor   # [K]
    im: torch.Tensor   # [K]


def empty_sf(device) -> SFCache:
    """The [0] cache a chain without the incremental path carries
    (chain.py:802-807)."""
    z = torch.zeros(0, dtype=torch.float64, device=device)
    return SFCache(z, z)


def sf_compute(state: SystemState, flags: FFlags, params: RunParams
               ) -> SFCache:
    k, _ = ewald.kvectors(state, flags.ewald_kmax)
    q = torch.where(state.atom_alive() & ~state.frozen, state.charge, 0.0)
    phase = phase_dot(state.pos, k)
    return SFCache(re=q @ torch.cos(phase), im=q @ torch.sin(phase))


def recip_energy(sf: SFCache, state: SystemState, flags: FFlags,
                 params: RunParams):
    _, k2 = ewald.kvectors(state, flags.ewald_kmax)
    alpha = params.ewald_alpha
    pot = torch.sum(torch.exp(-k2 / (4.0 * alpha * alpha)) / k2 *
                    (sf.re ** 2 + sf.im ** 2))
    return pot * 4.0 * const.pi / state.pbc.volume


def sf_shift(state: SystemState, flags: FFlags, rows, sign: float
             ) -> SFCache:
    """Contribution of ``rows`` atoms to the structure factor (0 where the
    row is padding, dead, or frozen)."""
    A = state.n_atom_slots
    S = rows.shape[0]
    start, _, valid = normalize_window(rows, A)
    valid = valid & slice_rows(state.atom_alive(), start, S) & \
        ~slice_rows(state.frozen, start, S)
    q = torch.where(valid, slice_rows(state.charge, start, S), 0.0)
    k, _ = ewald.kvectors(state, flags.ewald_kmax)
    phase = phase_dot(slice_rows(state.pos, start, S), k)     # [S,K]
    return SFCache(re=sign * sum_small_rows(q, torch.cos(phase)),
                   im=sign * sum_small_rows(q, torch.sin(phase)))


def sf_apply(sf: SFCache, *shifts) -> SFCache:
    re, im = sf.re, sf.im
    for s in shifts:
        re = re + s.re
        im = im + s.im
    return SFCache(re, im)


def rect_rd(state: SystemState, flags: FFlags, params: RunParams, rows,
            pt=None):
    """RD energy restricted to pairs touching ``rows`` (plus full-system
    self/LRC-self sums, which cancel or difference correctly)."""
    if pt is None:
        pt = build_pairs_rect(state, flags, rows)
    return pair_potentials.rd_energy(state, pt, flags, params)


def rect_es_real(state: SystemState, flags: FFlags, params: RunParams,
                 rows, pt=None):
    if pt is None:
        pt = build_pairs_rect(state, flags, rows)
    if flags.wolf:
        return ewald.coulombic_wolf(state, pt, flags, params)
    return ewald.coulombic_real(state, pt, flags, params)


class DeltaResult(NamedTuple):
    d_rd: torch.Tensor
    d_coul: torch.Tensor
    sf_new: SFCache
    recip_new: torch.Tensor   # k-space energy of the proposal


def delta_energy(old_state: SystemState, new_state: SystemState,
                 rows, sf: SFCache, flags: FFlags, params: RunParams,
                 recip_old=None) -> DeltaResult:
    """Energy difference new-old for a move that only changed the atoms in
    ``rows``; ``recip_old`` is the current state's k-space energy when the
    caller carries it."""
    pt_old = build_pairs_rect(old_state, flags, rows)
    pt_new = build_pairs_rect(new_state, flags, rows)
    d_rd = rect_rd(new_state, flags, params, rows, pt_new) - \
        rect_rd(old_state, flags, params, rows, pt_old)
    if flags.use_sg or flags.rd_only:
        z = torch.zeros_like(d_rd)
        return DeltaResult(d_rd, z, sf, z)
    d_coul = rect_es_real(new_state, flags, params, rows, pt_new) - \
        rect_es_real(old_state, flags, params, rows, pt_old)
    if not flags.wolf:
        # self-term differences are full-system O(A) sums (they change
        # only under insertion/removal); the Wolf sum has no self term
        d_coul = d_coul + (ewald.coulombic_self(new_state, params) -
                           ewald.coulombic_self(old_state, params))
    if not uses_recip(flags):
        return DeltaResult(d_rd, d_coul, sf, torch.zeros_like(d_rd))
    sf_new = sf_apply(sf, sf_shift(old_state, flags, rows, -1.0),
                      sf_shift(new_state, flags, rows, +1.0))
    e_old = recip_energy(sf, old_state, flags, params) \
        if recip_old is None else recip_old
    e_new = recip_energy(sf_new, new_state, flags, params)
    return DeltaResult(d_rd, d_coul + (e_new - e_old), sf_new, e_new)
