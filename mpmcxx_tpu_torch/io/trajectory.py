"""Trajectory, dipole and field writers.

JAX twin: mpmcxx_tpu/io/trajectory.py (``append_traj_frame``,
``write_dipoles``, ``write_fields``; the PI frame writer is not ported).

* multi-frame PQR trajectory with CRYST1 + REMARK step headers
  (write_states, src/System.Output.cpp:661-787)
* per-molecule dipole and field logs in Debye / field units
  (write_dipole/write_field, src/System.Output.cpp:1096-1229)
"""

from __future__ import annotations

import numpy as np

from .. import constants as const
from .pqr import _cryst1, _np, atom_line, state_to_atoms_data


def append_traj_frame(path: str, state, meta, step: int,
                      wrapall: bool = True, long_output: bool = False,
                      first: bool = False) -> None:
    if path == "/dev/null" or not path:
        return
    data = state_to_atoms_data(state, meta, wrapall=wrapall)
    basis = _np(state.pbc.basis)
    ext = bool(long_output) or bool(np.any(np.abs(basis) >= 100.0))
    with open(path, "w" if first else "a") as f:
        f.write(f"REMARK step={step}\n")
        f.write(_cryst1(basis))
        for i in range(len(data["atomtype"])):
            f.write(atom_line(i + 1, data, i, data["molecule_id"][i], ext))
        f.write("ENDMDL\n")


def _per_molecule(state, per_atom: np.ndarray, scale: float):
    """Lines 'x y z' of the per-molecule sums of ``per_atom`` [A,3] / scale
    for live, unfrozen molecules."""
    mol_id = _np(state.mol_id)
    totals = np.zeros((state.n_mol_slots, 3))
    np.add.at(totals, mol_id, per_atom)
    keep = _np(state.mol_alive) & ~_np(state.mol_frozen)
    lines = []
    for m in np.nonzero(keep)[0]:
        d = totals[m] / scale
        lines.append(f"{d[0]:f} {d[1]:f} {d[2]:f}\n")
    return "".join(lines)


def write_dipoles(path: str, state, first: bool = False) -> None:
    """Per-molecule total induced dipole in Debye
    (write_dipole, src/System.Output.cpp:1132-1160)."""
    if path == "/dev/null" or not path:
        return
    with open(path, "w" if first else "a") as f:
        f.write(_per_molecule(state, _np(state.mu), const.DEBYE2SKA))


def write_fields(path: str, state, e_static, e_induced,
                 first: bool = False) -> None:
    """Per-molecule total field E_static + E_induced
    (write_field, src/System.Output.cpp:1184-1229); internal fields carry
    E2REDUCED-scaled charge units, the log prints e/A."""
    if path == "/dev/null" or not path:
        return
    with open(path, "w" if first else "a") as f:
        f.write(_per_molecule(state, np.asarray(e_static) +
                              np.asarray(e_induced), const.E2REDUCED))
