"""Monte Carlo trial moves as state transforms.

JAX twin: mpmcxx_tpu/mc/moves.py (make_move, src/System.MonteCarlo.cpp:
252-900).  A move builds a new SystemState that shares every tensor it
leaves alone; accept/reject selects between old and new.  Molecule rows
are contiguous windows addressed by a device start index, so no move
waits on the host.  The masked moves over all A rows (``displace``,
``insert``, ``displace_1d``, ``spinflip`` and the SPECTRE and GWP moves)
are those the twin takes without a topology, for the adiabatic move and
for the anharmonic, SPECTRE and GWP runs.

Where the twin takes a ``jax.random`` key, these functions take the
draws that key yields (``mc/chain.py`` derives them with
``mpmcxx_tpu_torch.random``, key for key as the twin does), so a whole
chunk's draws can be made in one batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as const
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


def mask_rows(state: SystemState, mol, S: int):
    """The S-row window of molecule ``mol`` found from ``state.mol_id``
    (its contiguous rows, then -1): the twin's nonzero(mol_id == mol,
    size=S, fill_value=-1) without a topology (chain.py:441-442)."""
    A = state.n_atom_slots
    sel = state.mol_id == mol
    first = torch.min(torch.where(sel, _arange(A, sel), A))
    off = _arange(S, sel)
    return torch.where(off < torch.sum(sel), first + off, -1)


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


# --- masked moves over all A rows (moves.py:132-347) ------------------------

def _atoms_of(state: SystemState, mol):
    return state.mol_id == mol


def _mol_com(state: SystemState, mol):
    """[3] centre of mass of molecule ``mol`` (a 0-d device index)."""
    return state.mol_com().index_select(0, mol.reshape(1))[0]


def _translation(dice, scale, length):
    """The twin's translation from six uniforms: each component
    ``scale * dice[:3] * length``, negated where dice[3:] < 0.5."""
    trans = scale * dice[:3] * length
    return torch.where(dice[3:] < 0.5, -trans, trans)


def displace(state: SystemState, dice, axis, u_angle, mol, move_factor,
             rot_factor) -> SystemState:
    """Random translation + rotation of molecule ``mol`` about its centre
    of mass (src/System.MonteCarlo.cpp:1226-1230; moves.py:132-150), the
    draws as displace_rows'.  The centre comes from ``state.mol_com()``,
    so the result may differ from displace_rows' in the last bits."""
    trans = _translation(dice, move_factor, state.pbc.cutoff)
    q = quat.from_axis_angle_deg(axis, u_angle * 360.0 * rot_factor)
    com = _mol_com(state, mol)
    rotated = quat.rotate(q, state.pos - com) + com + trans
    return state.replace(pos=torch.where(_atoms_of(state, mol)[:, None],
                                         rotated, state.pos))


def displace_1d(state: SystemState, u_trans, u_sign, mol, move_factor
                ) -> SystemState:
    """1-D anharmonic displacement along x (src/System.MonteCarlo.cpp:
    1134-1147; moves.py:153-160): ``u_trans`` and ``u_sign`` are the
    uniforms of the twin's split(key) halves."""
    trans = move_factor * u_trans
    trans = torch.where(u_sign < 0.5, -trans, trans)
    dx = torch.where(_atoms_of(state, mol), trans, 0.0)
    return state.replace(pos=torch.cat([state.pos[:, :1] + dx[:, None],
                                        state.pos[:, 1:]], dim=1))


def spinflip(state: SystemState, mol) -> SystemState:
    """Para <-> ortho on molecule ``mol`` (src/System.MonteCarlo.cpp:
    883-891; moves.py:163-170)."""
    one = mol.reshape(1)
    cur = state.nuclear_spin.index_select(0, one)
    new = torch.where(cur == const.NUCLEAR_SPIN_PARA,
                      const.NUCLEAR_SPIN_ORTHO, const.NUCLEAR_SPIN_PARA)
    return state.replace(nuclear_spin=state.nuclear_spin.index_copy(
        0, one, new.to(state.nuclear_spin.dtype)))


def insert(state: SystemState, u_pos, axis, u_angle, template_mol,
           dead_slot, com=None):
    """A randomly placed and oriented copy of ``template_mol`` into
    ``dead_slot`` by atom masks (src/System.MonteCarlo.cpp:740-833;
    moves.py:181-224), the draws as insert_rows'.  The slot's i-th atom
    takes the template's i-th.  Returns (new_state, valid); with no dead
    slot (-1) the state is unchanged and valid is False."""
    valid = dead_slot >= 0
    slot = torch.clamp(dead_slot, min=0)
    new_com = random_cell_position(state, u_pos) if com is None else com
    A = state.n_atom_slots
    arange = _arange(A, state.mol_id)
    tmpl_sel = _atoms_of(state, template_mol)
    slot_sel = _atoms_of(state, slot)
    intra = arange - torch.min(torch.where(slot_sel, arange, A))
    tmpl_start = torch.min(torch.where(tmpl_sel, arange, A))
    src = torch.clamp(tmpl_start + intra, 0, A - 1)
    rel = state.pos.index_select(0, src) - _mol_com(state, template_mol)
    q = quat.from_axis_angle_deg(axis, u_angle * 360.0)
    newpos = quat.rotate(q, rel) + new_com
    put = slot_sel & valid
    one, t1 = slot.reshape(1), template_mol.reshape(1)
    alive = state.mol_alive.index_copy(
        0, one, state.mol_alive.index_select(0, one) | valid)
    spin = state.nuclear_spin.index_copy(0, one, torch.where(
        valid, state.nuclear_spin.index_select(0, t1),
        state.nuclear_spin.index_select(0, one)))
    return state.replace(
        pos=torch.where(put[:, None], newpos, state.pos), mol_alive=alive,
        aalive=torch.where(put, True, state.aalive),
        nuclear_spin=spin), valid


def spectre_renormalize(state: SystemState, charge):
    """Spread the residual charge evenly over the live SPECTRE sites
    (src/System.MonteCarlo.cpp:1193-1221; moves.py:300-307)."""
    sp = state.spectre & state.atom_alive()
    nsp = torch.sum(sp)
    residual = torch.sum(torch.where(sp, charge, 0.0))
    frac = -residual / torch.where(nsp == 0, 1, nsp)
    return torch.where(sp, charge + frac, charge)


def spectre_displace(state: SystemState, dice, u_q, mol, move_factor,
                     max_charge, max_target) -> SystemState:
    """SPECTRE move (src/System.MonteCarlo.cpp:1152-1221; moves.py:
    260-286): a translation of up to ``move_factor * max_target`` per
    axis from the six uniforms ``dice``, and on the molecule's SPECTRE
    sites a charge delta uniform on [-1, 1] within |q + dq| <=
    max_charge (the closed form of the reference's redraw loop) from the
    [A] uniforms ``u_q``, then the renormalization."""
    trans = _translation(dice, move_factor, max_target)
    sel = _atoms_of(state, mol)
    pos = state.pos + torch.where(sel[:, None], trans[None, :], 0.0)
    lo = torch.clamp(-max_charge - state.charge, min=-1.0)
    hi = torch.clamp(max_charge - state.charge, max=1.0)
    dq = lo + u_q * (hi - lo)
    q = state.charge + torch.where(sel & state.spectre, dq, 0.0)
    return state.replace(pos=pos, charge=spectre_renormalize(state, q))


def spectre_reject_restore(state_old: SystemState, state_new: SystemState,
                           mol):
    """The charges after a rejected SPECTRE move, as the reference leaves
    them (src/System.MonteCarlo.cpp:1559-1582; moves.py:310-329): only
    the moved molecule's charges are restored, then the renormalization
    runs again, so the shift the proposal gave every other SPECTRE site
    stays (the reject leak, kept for parity)."""
    q = torch.where(_atoms_of(state_old, mol), state_old.charge,
                    state_new.charge)
    return spectre_renormalize(state_old, q)


def spectre_wrapall(state: SystemState, max_target) -> SystemState:
    """SPECTRE sites pulled into the cube of side 2 * max_target around
    the target (src/System.cpp:1302-1342; moves.py:332-347); the last
    live target-flagged atom is the centre, as the reference's loop
    leaves it."""
    side = 2.0 * max_target
    tgt = state.target & state.atom_alive()
    idx = torch.max(torch.where(tgt, _arange(state.n_atom_slots, tgt), -1))
    center = torch.where(torch.any(tgt),
                         state.pos.index_select(
                             0, torch.clamp(idx, min=0).reshape(1))[0],
                         torch.zeros_like(state.pos[0]))
    wrapped = state.pos - side * torch.round((state.pos - center) / side)
    return state.replace(pos=torch.where(state.spectre[:, None], wrapped,
                                         state.pos))


def displace_gwp(state: SystemState, u, mol, scale) -> SystemState:
    """The molecule's Gaussian-wave-packet widths moved by ``scale *
    (u - 0.5)`` from the [A] uniforms ``u``, kept positive by abs
    (Molecule::displace_gwp, src/Molecule.cpp:350-366; moves.py:
    289-297)."""
    sel = _atoms_of(state, mol) & state.gwp_spin
    return state.replace(gwp_alpha=torch.abs(
        state.gwp_alpha + torch.where(sel, scale * (u - 0.5), 0.0)))
