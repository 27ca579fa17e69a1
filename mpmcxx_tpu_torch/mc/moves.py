"""Monte Carlo trial moves as state transforms.

JAX twin: mpmcxx_tpu/mc/moves.py (make_move, src/System.MonteCarlo.cpp:
252-900).  A move builds a new SystemState that shares every tensor it
leaves alone; accept/reject selects between old and new.  Molecule rows
are contiguous windows addressed by a device start index, so no move
waits on the host.

Where the twin takes a ``jax.random`` key, these functions take the
draws that key yields (``mc/chain.py`` derives them with
``mpmcxx_tpu_torch.random``, key for key as the twin does), so a whole
chunk's draws can be made in one batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import quaternion as quat
from ..ops.pairwise import (_arange, normalize_window, slice_rows,
                            update_rows)
from ..pbc import _mul3
from ..state import SystemState


def movable_mask(state: SystemState):
    return state.mol_alive & ~(state.mol_frozen | state.mol_adiabatic |
                               state.mol_target)


def movable_window(state: SystemState) -> int:
    """The move window S: the atom count of the largest molecule a move
    can touch.  Frozen molecules never move, so they are not counted (the
    twin counts every molecule, a framework's hundreds of atoms
    included, and then works each move on a window of mostly -1 rows)."""
    counts = np.bincount(state.mol_id.cpu().numpy(),
                         minlength=state.n_mol_slots)
    counts = counts[~state.mol_frozen.cpu().numpy()]
    return int(counts.max()) if len(counts) else 1


def particle_mass(state: SystemState) -> float:
    """Mass of the first movable molecule (the averages' particle mass;
    0 without one)."""
    idx = torch.nonzero(movable_mask(state).cpu()).flatten()
    return float(state.mol_mass[idx[0]]) if len(idx) else 0.0


def molecule_rows(mol_start, mol_natoms, mol, S: int):
    """The S-row window of molecule ``mol`` (a 0-d device index) from the
    device topology tables (state.topology): its rows, then -1."""
    off = torch.arange(S, dtype=torch.int64, device=mol.device)
    one = mol.reshape(1)
    rows = mol_start.index_select(0, one) + off
    return torch.where(off < mol_natoms.index_select(0, one), rows, -1)


def pick_kth_true(mask, k):
    """Index of the k-th True in mask (k in [0, count))."""
    cum = torch.cumsum(mask.to(torch.int64), dim=0)
    return torch.argmax((cum == (k + 1)).to(torch.int8))


def pick_random_movable(state: SystemState, u):
    """A uniformly drawn live movable molecule (``u`` = the twin's
    ``uniform(key)``) and the count of such molecules."""
    mask = movable_mask(state)
    n = torch.sum(mask)
    k = torch.floor(u * n).to(torch.int64)
    k = torch.minimum(torch.clamp(k, min=0), torch.clamp(n - 1, min=0))
    return pick_kth_true(mask, k), n


def _window_com(state: SystemState, start, mask_w, S: int):
    pos_r = slice_rows(state.pos, start, S)                # [S,3]
    w = torch.where(mask_w, slice_rows(state.mass, start, S), 0.0)
    wsum = torch.clamp(torch.sum(w), min=1e-300)
    return pos_r, torch.sum(w[:, None] * pos_r, dim=0) / wsum


def displace_rows(state: SystemState, dice, axis, u_angle, rows, row_mask,
                  move_factor, rot_factor) -> SystemState:
    """Random translation + rotation of one molecule's contiguous rows
    (src/System.MonteCarlo.cpp:1226-1230, src/Molecule.cpp:128-321).
    Draws: ``dice`` uniform (6,), ``axis`` normal (3,), ``u_angle``
    uniform ()."""
    trans = move_factor * dice[:3] * state.pbc.cutoff
    trans = torch.where(dice[3:] < 0.5, -trans, trans)
    q = quat.from_axis_angle_deg(axis, u_angle * 360.0 * rot_factor)
    S = rows.shape[0]
    start, _, mask_w = normalize_window(torch.where(row_mask, rows, -1),
                                        state.n_atom_slots)
    pos_r, com = _window_com(state, start, mask_w, S)
    new = quat.rotate(q, pos_r - com) + com + trans
    return state.replace(pos=update_rows(state.pos, start, new, mask_w))


def random_cell_position(state: SystemState, u3):
    """Uniform position in the (centered) unit cell from ``u3`` uniform
    (3,) (src/System.MonteCarlo.cpp:766-775)."""
    return _mul3(0.5 - u3, state.pbc.basis)


def insert_rows(state: SystemState, u_pos, axis, u_angle, tmpl_rows,
                slot_rows, row_mask, slot, valid, com=None):
    """Insert a randomly placed and oriented copy of the template
    molecule's rows into the dead ``slot`` (src/System.MonteCarlo.cpp:
    740-833).  Draws: ``u_pos`` uniform (3,), ``axis`` normal (3,),
    ``u_angle`` uniform ().  ``com`` overrides the position drawn from
    ``u_pos`` (cavity-biased insertion).  Returns (new_state, valid)."""
    A = state.n_atom_slots
    S = tmpl_rows.shape[0]
    t_start, _, t_mask = normalize_window(
        torch.where(row_mask, tmpl_rows, -1), A)
    s_start, _, s_mask = normalize_window(
        torch.where(row_mask, slot_rows, -1), A)

    new_com = random_cell_position(state, u_pos) if com is None else com
    tmpl_pos, tmpl_com = _window_com(state, t_start, t_mask, S)
    q = quat.from_axis_angle_deg(axis, u_angle * 360.0)
    newpos = quat.rotate(q, tmpl_pos - tmpl_com) + new_com
    # template/slot windows can clip with different leading offsets at the
    # array tail (short molecules); realign window row k -> k
    t_off = tmpl_rows[0].clamp(0, A - 1) - t_start
    s_off = slot_rows[0].clamp(0, A - 1) - s_start
    k = _arange(S, tmpl_rows)
    newpos = newpos[torch.remainder(k - (s_off - t_off), S)]
    pos = update_rows(state.pos, s_start, newpos, s_mask & valid)

    slot_c = torch.clamp(slot, min=0)
    one = slot_c.reshape(1)
    alive = state.mol_alive.index_copy(
        0, one, state.mol_alive.index_select(0, one) | valid)
    aalive = torch.where((state.mol_id == slot_c) & valid, True, state.aalive)
    # the inserted copy inherits the template's nuclear spin
    # (src/System.MonteCarlo.cpp:502)
    tmpl_mol = state.mol_id.index_select(0, tmpl_rows[0:1].clamp(0, A - 1))
    spin = state.nuclear_spin.index_copy(0, one, torch.where(
        valid, state.nuclear_spin.index_select(0, tmpl_mol),
        state.nuclear_spin.index_select(0, one)))
    return state.replace(pos=pos, mol_alive=alive, aalive=aalive,
                         nuclear_spin=spin), valid


def find_dead_slot(state: SystemState, species):
    """First dead molecule slot of the given species, or -1."""
    dead = ~state.mol_alive & (state.mol_type == species) & \
        ~(state.mol_frozen | state.mol_adiabatic | state.mol_target)
    return torch.where(torch.any(dead), torch.argmax(dead.to(torch.int8)),
                       -1)


def remove(state: SystemState, mol) -> SystemState:
    """(src/System.MonteCarlo.cpp:836-859)"""
    one = mol.reshape(1)
    return state.replace(
        mol_alive=state.mol_alive.index_fill(0, one, False),
        aalive=torch.where(state.mol_id == mol, False, state.aalive))


def scale_box(state: SystemState, factor) -> SystemState:
    """The box scaled isotropically by ``factor``, molecule COMs moved
    rigidly with it (src/System.MonteCarlo.cpp:1235-1282)."""
    delta = state.mol_com() * (factor - 1.0)
    return state.replace(pos=state.pos + delta.index_select(0, state.mol_id),
                         pbc=state.pbc.scale(factor))


def volume_change(state: SystemState, u, volume_change_factor
                  ) -> SystemState:
    """Log-uniform volume move from the uniform ``u`` (moves.py:246-257)."""
    log_new = torch.log(state.pbc.volume) + (u - 0.5) * volume_change_factor
    return scale_box(state,
                     (torch.exp(log_new) / state.pbc.volume) ** (1.0 / 3.0))
