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

    def mol_com(self):
        """[M,3] centers of mass (mass-weighted; src/System.cpp:1347-1374),
        the twin's segment sums as ``index_add``."""
        w = torch.where(self.aalive, self.mass, 0.0)
        M = self.n_mol_slots
        num = torch.zeros((M, 3), dtype=self.pos.dtype,
                          device=self.pos.device).index_add_(
            0, self.mol_id, w[:, None] * self.pos)
        den = torch.zeros(M, dtype=w.dtype, device=w.device).index_add_(
            0, self.mol_id, w)
        return num / torch.where(den == 0.0, 1.0, den)[:, None]

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
                device="cuda") -> tuple[SystemState, dict]:
    """Assemble a SystemState on ``device`` (the card unless the caller
    asks for another) from parsed atom records (state.py:190-352).  ``extra_mol_capacity`` > 0 reserves dead copies of
    the last movable molecule for uVT insertion headroom; a dict
    ``{moleculetype: count}`` reserves per-species headroom.  Returns
    (state, meta)."""
    atoms = list(atoms)
    if not atoms:
        raise ValueError("no atoms to build state from")

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
    if isinstance(extra_mol_capacity, dict):
        for mt, count in extra_mol_capacity.items():
            cand = [m for m in mols
                    if not m[0].frozen and m[0].moleculetype == mt]
            if not cand:
                raise ValueError(
                    f"no movable {mt} molecule to use as insertion template")
            extra.extend([cand[-1]] * count)
    elif extra_mol_capacity > 0:
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


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def state_to_records(state: SystemState, meta: dict,
                     atom_idx=None) -> list[AtomRecord]:
    """Atoms of a state back to host AtomRecords in slot order, the live
    atoms by default (state.py:370-404); molecule_id values only delimit
    grouping."""
    mol_id = _np(state.mol_id)
    pos = _np(state.pos)
    cols = {k: _np(getattr(state, k))
            for k in ("mass", "charge", "polarizability", "epsilon",
                      "sigma", "omega", "gwp_alpha", "c6", "c8", "c10",
                      "c9", "frozen", "adiabatic", "spectre", "target")}
    if atom_idx is None:
        atom_idx = np.nonzero(_np(state.aalive))[0]
    out = []
    for a in atom_idx:
        m = int(mol_id[a])
        rec = {k: (bool(v[a]) if v.dtype == bool else float(v[a]))
               for k, v in cols.items()}
        out.append(AtomRecord(
            atomtype=meta["atomtypes"][a],
            moleculetype=meta["moleculetypes"][m], molecule_id=m + 1,
            x=float(pos[a, 0]), y=float(pos[a, 1]), z=float(pos[a, 2]),
            **rec))
    return out


def _pad_extra(state: SystemState, meta: dict, records, extra,
               pad_atoms_multiple: int):
    """Bump the first species' headroom so the regrown atom capacity lands
    on a multiple of ``pad_atoms_multiple`` (state.py:407-431); no-op for
    int extras or when no multiple is reachable within
    ``pad_atoms_multiple`` template molecules."""
    if not pad_atoms_multiple or not isinstance(extra, dict) or not extra:
        return extra
    mt_names = meta["moleculetypes"]
    mol_id = _np(state.mol_id)
    per_atom = {}
    for name in extra:
        m = next(i for i, nm in enumerate(mt_names) if nm == name)
        per_atom[name] = int((mol_id == m).sum())
    base_atoms = len(records) + sum(extra[n] * per_atom[n] for n in extra)
    name0 = next(iter(extra))
    s = max(per_atom[name0], 1)
    for k in range(pad_atoms_multiple):
        if (base_atoms + k * s) % pad_atoms_multiple == 0:
            out = dict(extra)
            out[name0] += k
            return out
    return extra


def grow_mol_capacity(state: SystemState, meta: dict, extra_mol_capacity,
                      ensure_species=(), pad_atoms_multiple: int = 0
                      ) -> tuple[SystemState, dict]:
    """Rebuild a state with more dead insertion slots (state.py:434-505),
    on the state's device, keeping the live contents, the PBC, the
    per-molecule nuclear spins and the live atoms' dipoles.  Species
    indices stay stable.  ``ensure_species``: insertable species that
    must keep an insertion template even with no live molecule — one dead
    exemplar of each is rebuilt as a template and flipped back to dead."""
    records = state_to_records(state, meta)
    mol_alive = _np(state.mol_alive)
    mol_id = _np(state.mol_id)
    mol_frozen = _np(state.mol_frozen)
    live_names = {meta["moleculetypes"][m] for m in np.nonzero(mol_alive)[0]}
    appended = 0
    for name in ensure_species:
        if name in live_names:
            continue
        cand = [m for m in range(state.n_mol_slots)
                if meta["moleculetypes"][m] == name and not mol_alive[m]
                and not mol_frozen[m]]
        if not cand:
            raise ValueError(f"no template molecule for species {name}")
        records.extend(state_to_records(
            state, meta, atom_idx=np.nonzero(mol_id == cand[0])[0]))
        appended += 1

    rot = {}
    rg, ru = _np(state.rot_partfunc_g), _np(state.rot_partfunc_u)
    for m, name in enumerate(meta["moleculetypes"]):
        rot.setdefault(name, (float(rg[m]), float(ru[m])))
    dev = state.pos.device
    new_state, new_meta = build_state(
        records, np.eye(3),  # placeholder basis; the real PBC is kept
        species_names=list(meta["species"]),
        extra_mol_capacity=_pad_extra(state, meta, records,
                                      extra_mol_capacity,
                                      pad_atoms_multiple),
        rot_partfunc=rot, device=dev)

    # live molecules land at slots 0..n_live-1 in slot order
    live_mols = np.nonzero(mol_alive)[0]
    ns = _np(new_state.nuclear_spin).copy()
    ns[:len(live_mols)] = _np(state.nuclear_spin)[live_mols]
    live_atoms = np.nonzero(_np(state.aalive))[0]
    mu = _np(new_state.mu).copy()
    mu[:len(live_atoms)] = _np(state.mu)[live_atoms]
    alive_new = _np(new_state.mol_alive).copy()
    if appended:
        # the rebuilt templates are the last ``appended`` live slots
        n_live = new_meta["n_live_molecules"]
        alive_new[n_live - appended:n_live] = False
        new_meta["n_live_molecules"] = n_live - appended
    alive_t = torch.as_tensor(alive_new, device=dev)
    new_state = new_state.replace(
        pbc=state.pbc,
        nuclear_spin=torch.as_tensor(ns, device=dev),
        mu=torch.as_tensor(mu, device=dev), mol_alive=alive_t,
        aalive=alive_t.index_select(0, new_state.mol_id))
    return new_state, new_meta


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
