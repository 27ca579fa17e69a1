"""Fixed-shape tensor state for a simulation system.

JAX twin: mpmcxx_tpu/state.py.  The reference's linked-list
System/Molecule/Atom model (src/System.h:32, src/Molecule.h:10,
src/Atom.h:10) becomes flat per-atom ``[A]`` and per-molecule ``[M]``
tensors sized to a static capacity; uVT insertion and removal flip
``mol_alive`` on reserved slots.  ``SystemState`` is a dataclass of
tensors; moves build a new state that shares every tensor they leave
alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import constants as const
from .pbc import PBC


@dataclasses.dataclass
class Observables:
    """Mirror of observables_t (src/System.h:94-113); 0-d f64 tensors."""

    energy: torch.Tensor
    coulombic_energy: torch.Tensor
    rd_energy: torch.Tensor
    polarization_energy: torch.Tensor
    vdw_energy: torch.Tensor
    three_body_energy: torch.Tensor
    dipole_rrms: torch.Tensor
    kinetic_energy: torch.Tensor
    temperature: torch.Tensor
    volume: torch.Tensor
    N: torch.Tensor
    NU: torch.Tensor
    spin_ratio: torch.Tensor
    frozen_mass: torch.Tensor
    total_mass: torch.Tensor


@dataclasses.dataclass
class SystemState:
    """Complete dynamic + static per-system state."""

    # --- dynamic ---
    pos: torch.Tensor            # [A,3] f64 atom positions (Angstrom)
    charge: torch.Tensor         # [A] f64 reduced units sqrt(K*A)
    nuclear_spin: torch.Tensor   # [M] int32 (PARA/ORTHO)
    mol_alive: torch.Tensor      # [M] bool: molecule exists
    pbc: PBC
    mu: torch.Tensor             # [A,3] f64 induced dipoles

    # --- static per-atom force-field params (f64 / bool) ---
    mass: torch.Tensor
    polarizability: torch.Tensor
    epsilon: torch.Tensor
    sigma: torch.Tensor
    omega: torch.Tensor
    gwp_alpha: torch.Tensor
    c6: torch.Tensor
    c8: torch.Tensor
    c10: torch.Tensor
    c9: torch.Tensor
    frozen: torch.Tensor
    adiabatic: torch.Tensor
    spectre: torch.Tensor
    target: torch.Tensor
    gwp_spin: torch.Tensor

    # --- static topology ---
    mol_id: torch.Tensor         # [A] int64 molecule index of each atom
    mol_frozen: torch.Tensor     # [M] bool
    mol_adiabatic: torch.Tensor
    mol_spectre: torch.Tensor
    mol_target: torch.Tensor
    mol_mass: torch.Tensor       # [M] f64 amu
    mol_type: torch.Tensor       # [M] int64 species index
    rot_partfunc_g: torch.Tensor
    rot_partfunc_u: torch.Tensor

    # [A] bool == mol_alive[mol_id], kept coherent by every mol_alive write
    aalive: torch.Tensor

    @property
    def n_atom_slots(self) -> int:
        return self.pos.shape[0]

    @property
    def n_mol_slots(self) -> int:
        return self.mol_alive.shape[0]

    def atom_alive(self):
        return self.aalive

    def _movable(self):
        return self.mol_alive & ~(self.mol_frozen | self.mol_adiabatic |
                                  self.mol_target)

    def count_N(self):
        """Number of live movable molecules (src/System.cpp:909-931)."""
        return torch.sum(self._movable())

    def spin_ratio_sum(self):
        return torch.sum(self._movable() & (
            self.nuclear_spin == const.NUCLEAR_SPIN_ORTHO)).to(torch.float64)

    def replace(self, **kw) -> "SystemState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class AtomRecord:
    """One parsed PQR atom line (host side)."""
    atomtype: str = "X"
    moleculetype: str = "M"
    molecule_id: int = 1
    frozen: bool = False
    adiabatic: bool = False
    spectre: bool = False
    target: bool = False
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    mass: float = 0.0
    charge: float = 0.0   # already in reduced units
    polarizability: float = 0.0
    epsilon: float = 0.0
    sigma: float = 0.0
    omega: float = 0.0
    gwp_alpha: float = 0.0
    c6: float = 0.0
    c8: float = 0.0
    c10: float = 0.0
    c9: float = 0.0


_F64 = ("pos", "charge", "mu", "mass", "polarizability", "epsilon", "sigma",
        "omega", "gwp_alpha", "c6", "c8", "c10", "c9", "mol_mass",
        "rot_partfunc_g", "rot_partfunc_u")
_BOOL = ("mol_alive", "frozen", "adiabatic", "spectre", "target",
         "gwp_spin", "mol_frozen", "mol_adiabatic", "mol_spectre",
         "mol_target", "aalive")
_INT = {"nuclear_spin": torch.int32, "mol_id": torch.int64,
        "mol_type": torch.int64}


def _from_numpy(fields: dict, basis, device) -> SystemState:
    kw = {}
    for name, arr in fields.items():
        if name in _F64:
            dt = torch.float64
        elif name in _BOOL:
            dt = torch.bool
        else:
            dt = _INT[name]
        kw[name] = torch.as_tensor(np.array(arr), dtype=dt, device=device)
    basis = torch.as_tensor(np.array(basis, dtype=np.float64),
                            dtype=torch.float64, device=device)
    return SystemState(pbc=PBC.from_basis(basis), **kw)


def build_state(atoms: list[AtomRecord], basis: np.ndarray,
                species_names: Optional[list[str]] = None,
                extra_mol_capacity: int = 0,
                template_moleculetype: Optional[str] = None,
                rot_partfunc: Optional[dict] = None,
                device=None) -> tuple[SystemState, dict]:
    """Assemble a SystemState on ``device`` from parsed atom records
    (state.py:190-352).  ``extra_mol_capacity`` > 0 reserves dead copies of
    the last movable molecule for uVT insertion headroom.  Returns
    (state, meta)."""
    atoms = list(atoms)
    if not atoms:
        raise ValueError("no atoms to build state from")
    if isinstance(extra_mol_capacity, dict):
        raise NotImplementedError("per-species extra_mol_capacity")

    mols: list[list[AtomRecord]] = []
    cur_id = None
    for a in atoms:
        if a.molecule_id != cur_id:
            mols.append([])
            cur_id = a.molecule_id
        mols[-1].append(a)

    species = {}
    for t in (species_names or []):
        species.setdefault(t, len(species))
    for m in mols:
        species.setdefault(m[0].moleculetype, len(species))

    extra: list[list[AtomRecord]] = []
    if extra_mol_capacity > 0:
        cand = [m for m in mols
                if not m[0].frozen and
                (template_moleculetype is None or
                 m[0].moleculetype == template_moleculetype)]
        if not cand:
            raise ValueError("no movable molecule to use as insertion template")
        extra = [cand[-1]] * extra_mol_capacity

    all_mols = mols + extra
    n_live = len(mols)
    A = sum(len(m) for m in all_mols)
    M = len(all_mols)

    per_atom = ("mass", "charge", "polarizability", "epsilon", "sigma",
                "omega", "gwp_alpha", "c6", "c8", "c10", "c9")
    per_atom_flag = ("frozen", "adiabatic", "spectre", "target")
    f = {k: np.zeros(A) for k in per_atom}
    f.update({k: np.zeros(A, dtype=bool)
              for k in per_atom_flag + ("gwp_spin",)})
    pos = np.zeros((A, 3))
    mol_id = np.zeros(A, dtype=np.int64)
    mol = {k: np.zeros(M, dtype=bool) for k in
           ("mol_frozen", "mol_adiabatic", "mol_spectre", "mol_target")}
    mol_mass = np.zeros(M)
    mol_type = np.zeros(M, dtype=np.int64)
    rg, ru = np.zeros(M), np.zeros(M)
    atomtypes = []

    i = 0
    for mi, m in enumerate(all_mols):
        for k in per_atom_flag:
            mol["mol_" + k][mi] = getattr(m[0], k)
        mol_type[mi] = species[m[0].moleculetype]
        if rot_partfunc and m[0].moleculetype in rot_partfunc:
            rg[mi], ru[mi] = rot_partfunc[m[0].moleculetype]
        for a in m:
            pos[i] = (a.x, a.y, a.z)
            for k in per_atom + per_atom_flag:
                f[k][i] = getattr(a, k)
            f["gwp_spin"][i] = a.gwp_alpha != 0.0
            mol_id[i] = mi
            atomtypes.append(a.atomtype)
            mol_mass[mi] += a.mass
            i += 1

    mol_alive = np.arange(M) < n_live
    fields = dict(pos=pos, nuclear_spin=np.zeros(M, dtype=np.int32),
                  mol_alive=mol_alive, mu=np.zeros((A, 3)), mol_id=mol_id,
                  mol_mass=mol_mass, mol_type=mol_type, rot_partfunc_g=rg,
                  rot_partfunc_u=ru, aalive=mol_alive[mol_id], **f, **mol)
    state = _from_numpy(fields, basis, device)
    meta = {
        "species": species,
        "atomtypes": atomtypes,
        "moleculetypes": [m[0].moleculetype for m in all_mols],
        "n_live_molecules": n_live,
    }
    return state, meta


def topology(state: SystemState) -> tuple[np.ndarray, np.ndarray]:
    """Per-molecule-slot (starts, natoms) host arrays; slot layouts never
    change during a run (state.py:355-367)."""
    mol_id = state.mol_id.cpu().numpy()
    counts = np.bincount(mol_id, minlength=state.n_mol_slots)
    starts = np.zeros(state.n_mol_slots, dtype=np.int64)
    first = np.unique(mol_id, return_index=True)
    starts[first[0]] = first[1]
    return starts, counts.astype(np.int64)


def state_from_jax(numpy_fields: dict, device=None) -> SystemState:
    """Carry a JAX ``SystemState`` into the port: ``numpy_fields`` maps each
    SystemState field name to its value as a numpy array, with ``pbc`` a
    mapping of ``basis``, ``reciprocal``, ``volume`` and ``cutoff``.
    Dtypes become the port's (f64, bool, int64 indices)."""
    fields = dict(numpy_fields)
    pbc = fields.pop("pbc")
    state = _from_numpy(fields, pbc["basis"], device)
    state.pbc = PBC(**{k: torch.as_tensor(np.array(pbc[k]),
                                          dtype=torch.float64, device=device)
                       for k in ("basis", "reciprocal", "volume", "cutoff")})
    return state
