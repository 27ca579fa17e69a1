"""Extended-PQR geometry reader/writer.

JAX twin: mpmcxx_tpu/io/pqr.py.  As there, ``read_pqr`` and
``format_pqr`` go through the native codec (runtime/native.py, the
port's copy of mpmcio.cpp) and take the pure-Python path, which gives
the same records and bytes, on a machine without g++; a restart write
(``write_pqr_with_rotation``) is queued on the codec's writer thread, so
it returns before the file is on disk, and the ``.last`` rotation happens
on that thread too.  ``drain()`` waits for every queued write: each run
calls it at its end (runner.Simulation, mc.pi.PISimulation,
mc.gibbs.GibbsSimulation and parallel.driver.ReplicaSimulation), and a
caller that reads a restart file written in the same process calls it
first.  (The JAX Gibbs run does not drain, and leaves the last writes to
the writer's exit at the end of the process.)

Implements the reference's file contract:
* 20-token ATOM reader with F/A/S/T flags, charge conversion to reduced
  units, frozen-charge scaling, and BOX-particle skipping
  (src/System.cpp:507-770)
* ``REMARK BOX BASIS`` parsing (src/System.cpp:775-854)
* restart/final writer with CRYST1, wrapped coords, box-corner virtual
  particles + CONECT lines, basis remarks, and ``.last`` rotation
  (src/System.Output.cpp:837-1094)
* per-rank filename numbering ``base-0007.ext`` (src/Output.cpp:46-92)
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from .. import constants as const
from ..runtime import native
from ..state import AtomRecord


def _np(t) -> np.ndarray:
    """A state tensor (on any device) as a host numpy array."""
    return t.detach().cpu().numpy()


def make_filename(basename: str, fileno: int) -> str:
    """base.ext -> base-0007.ext; else base-0007 (src/Output.cpp:46-92)."""
    if basename.startswith("/dev/null"):
        return "/dev/null"
    if len(basename) > 4 and basename[-4] == ".":
        return f"{basename[:-4]}-{fileno:04d}{basename[-4:]}"
    return f"{basename}-{fileno:04d}"


def read_pqr(path_or_text: str, is_text: bool = False,
             scale_charge: float = 1.0,
             cdvdw_sig_repulsion: bool = False,
             polarvdw: bool = False,
             cdvdw_exp_repulsion: bool = False) -> list[AtomRecord]:
    """Parse ATOM records into AtomRecords (charges -> reduced units).

    BOX visualization particles (moleculetype "BOX") are skipped, matching
    src/System.cpp:592.
    """
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    parsed = native.pqr_parse_native(text)
    if parsed is None:
        rows = _tokenize(text)
    else:
        rows = zip(parsed["atomtype"], parsed["moleculetype"],
                   parsed["flag"], parsed["molecule_id"].tolist(),
                   parsed["pos"].tolist(), parsed["params"].tolist())
    atoms: list[AtomRecord] = []
    for atomtype, moleculetype, flag, molecule_id, (x, y, z), p in rows:
        flag = flag.upper()
        rec = AtomRecord(
            atomtype=atomtype,
            moleculetype=moleculetype,
            molecule_id=molecule_id,
            frozen=flag == "F",
            adiabatic=flag == "A",
            spectre=flag == "S",
            target=flag == "T",
            x=x, y=y, z=z,
            mass=p[0],
            charge=p[1] * const.E2REDUCED,
            polarizability=p[2],
            epsilon=p[3],
            sigma=p[4],
            omega=p[5],
            gwp_alpha=p[6],
            c6=p[7], c8=p[8], c10=p[9], c9=p[10],
        )
        # parameter coercions (src/System.cpp:656-667)
        if cdvdw_sig_repulsion and rec.epsilon != 1.0:
            rec.epsilon = 1.0
        elif polarvdw and not cdvdw_exp_repulsion and rec.sigma != 1.0:
            rec.sigma = 1.0
        if rec.frozen:
            rec.charge *= scale_charge
        atoms.append(rec)
    if not atoms:
        raise ValueError("no atoms found in PQR input")
    return atoms


def _tokenize(text: str):
    """The Python path of the reader: per ATOM record, (atomtype,
    moleculetype, flag, molecule_id, (x, y, z), the 11 parameters from
    mass to c9), as the codec's ``pqr_parse`` gives them."""
    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0].upper().startswith("END"):
            break
        if tok[0].upper() != "ATOM":
            continue
        if len(tok) < 4 or tok[3].upper() == "BOX":
            continue
        # token layout: ATOM id atomtype moleculetype flag molid x y z mass
        #               charge alpha epsilon sigma omega gwp_alpha c6 c8 c10 c9
        def g(i, default=0.0):
            return float(tok[i]) if i < len(tok) else default

        flag = tok[4] if len(tok) > 4 else "M"
        yield (tok[2], tok[3], flag, int(tok[5]), (g(6), g(7), g(8)),
               [g(i) for i in range(9, 20)])


def read_pqr_box(path: str) -> Optional[np.ndarray]:
    """Extract REMARK BOX BASIS lines -> 3x3 basis, or None."""
    basis = np.zeros((3, 3))
    found = [False, False, False]
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0].startswith("END"):
                break
            if (len(tok) >= 7 and tok[0] == "REMARK" and tok[1] == "BOX"
                    and tok[3] == "="):
                for i in range(3):
                    if tok[2] == f"BASIS[{i}]":
                        try:
                            basis[i] = [float(tok[4]), float(tok[5]),
                                        float(tok[6])]
                            found[i] = True
                        except ValueError:
                            pass
            if all(found):
                break
    return basis if all(found) else None


def _cryst1(basis: np.ndarray) -> str:
    a, b, c = (np.linalg.norm(basis[i]) for i in range(3))

    def ang(u, v):
        return 180.0 / const.pi * math.acos(
            float(np.dot(basis[u], basis[v])) /
            float(np.linalg.norm(basis[u]) * np.linalg.norm(basis[v])))

    # reference writes (beta, alpha, gamma) in this order ("VMD convention")
    return (f"CRYST1{a:9.3f}{b:9.3f}{c:9.3f}"
            f"{ang(2, 0):7.2f}{ang(1, 2):7.2f}{ang(0, 1):7.2f}\n")


def atom_line(i: int, data: dict, idx: int, molid: int, ext: bool) -> str:
    """One ATOM line of the restart/trajectory writers."""
    x, y, z = data["pos"][idx]
    line = ["ATOM  ", f"{i:5d}", f" {data['atomtype'][idx]:<4.4s}",
            f" {data['moleculetype'][idx]:<3.3s} ",
            f"{data['flag'][idx]:<1.1s}", f" {molid:4d}   "]
    if ext:
        line.append(f"{x:11.6f} {y:11.6f} {z:11.6f} ")
    else:
        line.append(f"{x:8.3f}{y:8.3f}{z:8.3f}")
    for key in ("mass", "charge_e", "polarizability", "epsilon", "sigma",
                "omega", "gwp_alpha", "c6", "c8", "c10", "c9"):
        line.append(f" {data[key][idx]:8.5f}")
    return "".join(line) + "\n"


def format_pqr(atoms_data: dict, basis: np.ndarray, wrapall: bool = True,
               long_output: bool = False,
               independent_particle: bool = False) -> str:
    """Serialise a configuration to reference-format PQR text.

    ``atoms_data`` holds parallel lists/arrays: atomtype, moleculetype,
    flag fields, pos (wrapped or not), and per-atom parameters.
    """
    ext = bool(long_output) or bool(np.any(np.abs(basis) >= 100.0))
    out = [_cryst1(basis)]
    block = None if independent_particle else \
        native.pqr_format_native(atoms_data, ext)
    if block is not None:
        out.append(block)
        return _append_footer(out, basis, atoms_data, wrapall, ext)
    mol_seq = atoms_data["molecule_id"]
    for idx in range(len(atoms_data["atomtype"])):
        molid = idx + 1 if independent_particle else mol_seq[idx]
        out.append(atom_line(idx + 1, atoms_data, idx, molid, ext))
    return _append_footer(out, basis, atoms_data, wrapall, ext)


def _append_footer(out, basis, atoms_data, wrapall, ext):
    n = len(atoms_data["atomtype"])
    mol_seq = atoms_data["molecule_id"]
    if wrapall:
        # box-corner virtual particles + CONECT edges
        atom_box = n + 1
        mol_box = (mol_seq[-1] + 1) if n else 1
        labels = {}
        for bi in range(2):
            for bj in range(2):
                for bk in range(2):
                    occ = np.array([bi - 0.5, bj - 0.5, bk - 0.5])
                    posb = occ @ basis
                    line = ["ATOM  ", f"{atom_box:5d}", f" {'X':<4.4s}",
                            f" {'BOX':<3.3s} ", "F", f" {mol_box:4d}   "]
                    if ext:
                        line.append(f"{posb[0]:11.6f} {posb[1]:11.6f} "
                                    f"{posb[2]:11.6f} ")
                    else:
                        line.append(f"{posb[0]:8.3f}{posb[1]:8.3f}"
                                    f"{posb[2]:8.3f}")
                    line.append(f" {0.0:8.4f} {0.0:8.4f} {0.0:8.5f}"
                                f" {0.0:8.5f} {0.0:8.5f}")
                    out.append("".join(line) + "\n")
                    labels[(bi, bj, bk)] = atom_box
                    atom_box += 1
        for (bi, bj, bk), a in labels.items():
            for (li, lj, lk), b in labels.items():
                if abs(bi - li) + abs(bj - lj) + abs(bk - lk) == 1:
                    out.append(f"CONECT {a:4d} {b:4d}\n")

    for i in range(3):
        out.append(f"REMARK BOX BASIS[{i}] = "
                   f"{basis[i][0]:20.14f} {basis[i][1]:20.14f} "
                   f"{basis[i][2]:20.14f}\n")
    out.append("END\n")
    return "".join(out)


def write_pqr_with_rotation(path: str, text: str) -> None:
    """Write with ``.last`` rotation (src/System.Output.cpp:880-886),
    queued on the native writer thread where the codec is built (see
    drain), else at once."""
    if path == "/dev/null":
        return
    if native.async_write(path, text, rotate_last=True):
        return
    if os.path.exists(path):
        try:
            os.replace(path, path + ".last")
        except OSError:
            pass
    with open(path, "w") as f:
        f.write(text)


def state_to_atoms_data(state, meta, wrapall: bool = True) -> dict:
    """Extract live atoms from a SystemState into writer-ready arrays.

    Molecule/atom ids are renumbered 1..N over live molecules, matching
    enumerate_particles (src/System.MonteCarlo.cpp:1117-1129).
    """
    pos = _np(state.pos)
    mol_id = _np(state.mol_id)
    if wrapall:
        # wrap by molecule COM (src/System.cpp:1379-1425); frozen unwrapped
        com = _np(state.mol_com())
        frac = com @ _np(state.pbc.reciprocal)
        shift = np.rint(frac) @ _np(state.pbc.basis)
        shift[_np(state.mol_frozen)] = 0.0
        pos = pos - shift[mol_id]

    alive_mol = _np(state.mol_alive)
    idx = np.nonzero(alive_mol[mol_id])[0]

    # renumber live molecules 1..M in slot order
    renum = np.zeros(len(alive_mol), dtype=np.int64)
    live_mols = np.nonzero(alive_mol)[0]
    renum[live_mols] = np.arange(1, len(live_mols) + 1)

    adiabatic, frozen = _np(state.adiabatic), _np(state.frozen)
    spectre, target = _np(state.spectre), _np(state.target)
    flags = np.where(adiabatic, "A", np.where(
        frozen, "F", np.where(spectre, "S", np.where(target, "T", "M"))))

    data = {
        "atomtype": [meta["atomtypes"][a] for a in idx],
        "moleculetype": [meta["moleculetypes"][mol_id[a]] for a in idx],
        "molecule_id": [int(m) for m in renum[mol_id[idx]]],
        "flag": [str(f) for f in flags[idx]],
        "pos": pos[idx],
        "charge_e": _np(state.charge)[idx] / const.E2REDUCED,
    }
    for k in ("mass", "polarizability", "epsilon", "sigma", "omega",
              "gwp_alpha", "c6", "c8", "c10", "c9"):
        data[k] = _np(getattr(state, k))[idx]
    return data


def state_bool(arr, i) -> bool:
    """Element ``i`` of a state field (a tensor on any device, or an
    array) as a Python bool."""
    return bool(arr[i])


def drain() -> None:
    """Block until every queued restart/final write is on disk."""
    native.async_drain()


def write_state_pqr(path: str, state, meta, wrapall: bool = True,
                    long_output: bool = False) -> None:
    data = state_to_atoms_data(state, meta, wrapall=wrapall)
    text = format_pqr(data, _np(state.pbc.basis), wrapall=wrapall,
                      long_output=long_output)
    write_pqr_with_rotation(path, text)
