"""Ewald electrostatics.

JAX twin: mpmcxx_tpu/ops/ewald.py (``hemisphere_kvecs``, ``kvectors``,
``coulombic_real``, ``coulombic_reciprocal``, ``coulombic_self`` and the
Ewald branch of ``coulombic``):
real-space erfc sum with the intra-molecular screening correction
(src/System.Energy.cpp:1466-1517), hemisphere k-space structure factors
(:1561-1622) and the self term (:1626-1643).  Charges are in reduced
units sqrt(K*Angstrom); energies in Kelvin.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import constants as const
from ..flags import FFlags, RunParams
from ..state import SystemState
from .pairwise import PairTensors, phase_dot


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


def coulombic_real(state: SystemState, pt: PairTensors, flags: FFlags,
                   params: RunParams):
    """Real-space erfc sum minus intra-molecular screening correction."""
    alpha = params.ewald_alpha
    q_i, q_j = pt.row(state.charge)[:, None], state.charge[None, :]
    base = pt.pair_once & pt.alive & ~pt.frozen
    in_cut = ~(pt.rimg > state.pbc.cutoff) & ~pt.es_excluded
    r = torch.where(pt.rimg == 0.0, 1.0, pt.rimg)
    pot = q_i * q_j * torch.special.erfc(alpha * r) / r
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


def coulombic(state: SystemState, pt: PairTensors, flags: FFlags,
              params: RunParams):
    """Total Ewald energy of the pairs in ``pt`` (src/System.Energy.cpp:
    1396-1416; the Wolf branch is not ported)."""
    return (coulombic_real(state, pt, flags, params) +
            coulombic_reciprocal(state, flags, params) +
            coulombic_self(state, params))
