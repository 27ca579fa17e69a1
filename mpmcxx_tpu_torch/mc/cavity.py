"""Cavity-biased insertion (umbrella sampling).

JAX twin: mpmcxx_tpu/mc/cavity.py (src/System.Cavity.cpp): the G^3
occupancy grid is one point-atom test, the accessible-volume Monte Carlo
integration one batched dart throw, and biased insertion a masked pick
over the open points, rebuilt before every move as in the reference.
Both occupancy tests run kernel K3 (ops/cuda_cavity.py).

Where the twin takes a ``jax.random`` key, these functions take the
draws that key yields (mc/chain.py derives them key for key).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda_cavity import occupancy
from ..pbc import _mul3
from ..state import SystemState


class CavityInfo(NamedTuple):
    open_mask: torch.Tensor     # [G^3] bool: cavity point unoccupied
    points: torch.Tensor        # [G^3,3] cartesian grid points
    probability: torch.Tensor   # open fraction
    volume: torch.Tensor        # accessible volume estimate (A^3)


def grid_points(state: SystemState, grid_size: int):
    """Cartesian cavity-grid points at fractional (i+1)/(G+1) - 1/2
    (src/System.Cavity.cpp:39-58)."""
    G = grid_size
    f = (torch.arange(G, dtype=torch.float64, device=state.pos.device) +
         1.0) / (G + 1.0)
    fx, fy, fz = torch.meshgrid(f, f, f, indexing="ij")
    frac = torch.stack([fx, fy, fz], dim=-1).reshape(-1, 3) - 0.5
    return _mul3(frac, state.pbc.basis)


def wrapped_positions(state: SystemState):
    """Atom positions wrapped by molecule COM into the cell; frozen
    molecules stay (the reference's wrapped_pos)."""
    frac = _mul3(state.mol_com(), state.pbc.reciprocal)
    shift = _mul3(torch.round(frac), state.pbc.basis)
    shift = torch.where(state.mol_frozen[:, None], 0.0, shift)
    return state.pos - shift.index_select(0, state.mol_id)


def update_grid(state: SystemState, grid_size: int, radius: float,
                dart_u, points=None) -> CavityInfo:
    """Occupancy + bias probability + MC-integrated accessible volume
    (cavity_update_grid src/System.Cavity.cpp:15-160).  ``dart_u``: the
    twin's ``uniform(key, (n_darts, 3))``, [n_darts, 3] f64; the reference
    throws volume/10 darts (src/System.Cavity.cpp:122-133).  ``points``
    may pass ``grid_points(state, grid_size)`` precomputed."""
    pts = grid_points(state, grid_size) if points is None else points
    open_mask = ~occupancy(pts, wrapped_positions(state), state.aalive,
                           radius)
    prob = torch.mean(open_mask.to(torch.float64))
    darts = _mul3(dart_u - 0.5, state.pbc.basis)
    hit = occupancy(darts, pts, open_mask, radius)
    volume = torch.mean(hit.to(torch.float64)) * state.pbc.volume
    return CavityInfo(open_mask, pts, prob, volume)


def biased_insert_position(info: CavityInfo, u):
    """Pick a random open cavity point from the uniform ``u``; returns
    (com, biased) where biased is False when no cavity is open
    (src/System.MonteCarlo.cpp:742-764).  The reference's rounded index
    ``(n-1) - rint((n-1) * rand)`` is kept, as in the twin."""
    n_open = torch.sum(info.open_mask)
    nm1 = torch.clamp(n_open - 1, min=0).to(torch.float64)
    k = (nm1 - torch.round(u * nm1)).to(torch.int64)
    cum = torch.cumsum(info.open_mask.to(torch.int64), dim=0)
    idx = torch.argmax((cum == (k + 1)).to(torch.int8))
    return info.points.index_select(0, idx.reshape(1))[0], n_open > 0


def remove_biased_flag(u, avg_probability, grid_size: int):
    """Cavity-bias flag for REMOVE moves from the uniform ``u``
    (src/System.MonteCarlo.cpp:838-843)."""
    p = (1.0 - avg_probability) ** float(grid_size ** 3)
    return u >= p
