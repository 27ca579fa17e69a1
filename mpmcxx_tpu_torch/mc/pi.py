"""Path-integral NVT ensemble.

JAX twin: mpmcxx_tpu/mc/pi.py.  The reference represents P Trotter beads
as P full ``System`` replicas, one MPI rank per bead
(src/SimulationControl.PathIntegral.cpp:31-196, 752-805).  Here, as in
the twin, the beads are a leading ``[P, ...]`` dimension of one
SystemState: displacement, staging and the estimators are batched
tensor ops, and the per-bead energies are evaluated over bead views
(``bead``; views copy nothing), one bead after another.

Implements, as the twin does:
* lockstep whole-chain displace with common dice (PI_displace,
  :1320-1387)
* Coker bead-chain staging with rotating anchor and COM-preserving shift
  (PI_perturb_bead_COMs, :1450-1554)
* Subramanian orientation staging by recursive bisection, its recursion
  unrolled into a static schedule (generate_orientation_configs,
  :1599-1680)
* the primitive energy estimator (PI_calculate_kinetic, :810-828)
* the PI-NVT Boltzmann factor (PI_NVT_boltzmann_factor, :490-547) with
  the reference's quirks: the orientation term omits the reduced-mass
  weight and the system-wide orientation chain term is 0
* simulated annealing on accept.
Quantum rotation (spin flips) and the bead-per-device mesh raise
NotImplementedError.

The chunk is a host loop that never waits on the device: every draw of
a step, Coker's per-bead normals and the bisection sampler's included,
is a function of the carried key, so the chunk's draws are made on the
host up front (``pi_draws``), and with them the move pick and the
rotating Coker anchor.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from .. import quaternion as quat
from .. import random as rnd
from ..config.schema import SimConfig
from ..config.validate import validate
from ..flags import FFlags, RunParams, require_supported
from ..io import output as out_io
from ..io import pqr as pqr_io
from ..io.trajectory import PIFrameWriter
from ..ops import delta as delta_mod
from ..ops.energy import energy_breakdown
from ..pbc import PBC
from ..runner import _live
from ..state import SystemState, build_state, topology
from . import moves
from .averages import AvgObservables, nodestats_from_counters
from .chain import NodeStats, accumulate_stats, annealed_temperature


# ---------------------------------------------------------------------------
# bead-stacked state helpers
# ---------------------------------------------------------------------------

def stack_states(states: list[SystemState]) -> SystemState:
    """[P]-stack single-system states into one bead-axis state."""
    kw = {f.name: torch.stack([getattr(s, f.name) for s in states])
          for f in dataclasses.fields(SystemState) if f.name != "pbc"}
    kw["pbc"] = PBC(**{f.name: torch.stack([getattr(s.pbc, f.name)
                                            for s in states])
                       for f in dataclasses.fields(PBC)})
    return SystemState(**kw)


def bead(stack: SystemState, s: int) -> SystemState:
    """Bead ``s`` of a stack: views of its tensors."""
    kw = {f.name: getattr(stack, f.name)[s]
          for f in dataclasses.fields(SystemState) if f.name != "pbc"}
    kw["pbc"] = PBC(**{f.name: getattr(stack.pbc, f.name)[s]
                       for f in dataclasses.fields(PBC)})
    return SystemState(**kw)


def mol_coms(stack: SystemState):
    """[P, M, 3] per-bead molecule centers of mass (SystemState.mol_com
    over the bead axis)."""
    P, M = stack.mol_alive.shape
    mol_id = stack.mol_id[0]
    w = torch.where(stack.aalive, stack.mass, 0.0)             # [P, A]
    num = torch.zeros((P, M, 3), dtype=stack.pos.dtype,
                      device=stack.pos.device).index_add_(
        1, mol_id, w[..., None] * stack.pos)
    den = torch.zeros((P, M), dtype=w.dtype, device=w.device).index_add_(
        1, mol_id, w)
    return num / torch.where(den == 0.0, 1.0, den)[..., None]


def _of_mol(per_mol, mol):
    """[P, ...] entries of molecule ``mol`` (an int or a 0-d index)."""
    mol = torch.as_tensor(mol, device=per_mol.device).reshape(1)
    return per_mol.index_select(1, mol)[:, 0]


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

# The twin keeps these chain lengths in amu*Angstrom^2 and folds every SI
# conversion into host constants (its TPU's emulated f64 has float32's
# exponent range); the same exact host constants here keep the two
# packages' sums in step.
_C_KIN = 0.5 * const.kB * const.AMU2KG * 1e-20 / const.hBar2
_C_CHAIN = (const.pi ** 2 * const.kB * const.AMU2KG * 1e-20 /
            (2.0 * const.h * const.h))
_C_ORIENT = const.pi ** 2 * const.kB * 1e-20 / (2.0 * const.h * const.h)
_C_SIGMA = const.hBar2 * 1e20 / (const.kB * const.AMU2KG)
_C_KH = (2.0 * const.pi ** 2 * const.kB * const.AMU2KG * 1e-20 /
         (const.h * const.h))


def chain_mass_length2_mol(stack: SystemState, mol):
    """Mass-weighted squared COM ring length of one molecule's bead chain,
    in amu*Angstrom^2 (PI_chain_mass_length2, :916-970)."""
    coms = _of_mol(mol_coms(stack), mol)                       # [P, 3]
    delta = coms - torch.roll(coms, -1, dims=0)
    return torch.sum(delta * delta) * _of_mol(stack.mol_mass, mol)[0]


def chain_mass_length2_system(stack: SystemState):
    """Sum over movable molecules (..._ENTIRE_SYSTEM, :859-904)."""
    coms = mol_coms(stack)                                     # [P, M, 3]
    delta = coms - torch.roll(coms, -1, dims=0)
    len2 = torch.sum(delta * delta, dim=(0, 2))                # [M]
    movable = stack.mol_alive[0] & ~(stack.mol_frozen[0] |
                                     stack.mol_adiabatic[0] |
                                     stack.mol_target[0])
    return torch.sum(torch.where(movable, len2 * stack.mol_mass[0], 0.0))


def orient_mu_length2_mol(stack: SystemState, mol, site_atom, bond_length):
    """Squared ring length of the bond-orientation chain, in Angstrom^2
    (PI_orientational_mu_length2, :978-1039).  No mass weight (reference
    quirk)."""
    coms = _of_mol(mol_coms(stack), mol)                       # [P, 3]
    handle = _of_mol(stack.pos, site_atom)                     # [P, 3]
    bond = handle - coms
    norm = torch.linalg.norm(bond, dim=-1, keepdim=True)
    bond = bond_length * bond / torch.where(norm == 0, 1.0, norm)
    delta = bond - torch.roll(bond, -1, dims=0)
    return torch.sum(delta * delta)


def pi_kinetic(stack: SystemState, temperature):
    """Primitive energy estimator kinetic part in Kelvin
    (PI_calculate_kinetic, :810-828)."""
    P = stack.pos.shape[0]
    N = bead(stack, 0).count_N().to(torch.float64)
    T = temperature
    return 1.5 * N * T * P - _C_KIN * P * T * T * \
        chain_mass_length2_system(stack)


# ---------------------------------------------------------------------------
# PI moves (on the stacked state, with common dice)
# ---------------------------------------------------------------------------

def pi_displace(stack: SystemState, dice, axis, u_angle, mol, move_factor,
                rot_factor) -> SystemState:
    """Rigid whole-chain translation + rotation about the aggregate COM
    (PI_displace, :1320-1387).  Draws: ``dice`` uniform (6,), ``axis``
    normal (3,), ``u_angle`` uniform (); the angle is ``u_angle *
    rot_factor`` degrees, as the twin has it."""
    trans = move_factor * dice[:3] * stack.pbc.cutoff[0]
    trans = torch.where(dice[3:] < 0.5, -trans, trans)
    sel = (stack.mol_id[0] == mol)[None, :, None]             # [1, A, 1]
    pos = torch.where(sel, stack.pos + trans, stack.pos)
    # aggregate COM over beads (post-translation)
    pi_com = torch.mean(_of_mol(mol_coms(stack.replace(pos=pos)), mol),
                        dim=0)
    q = quat.from_axis_angle_deg(axis, u_angle * rot_factor)
    rotated = quat.rotate(q, pos - pi_com) + pi_com
    return stack.replace(pos=torch.where(sel, rotated, pos))


def coker_stage_coms(coms, normals, n: int, starter: int, mass_amu,
                     temperature, P: int):
    """Coker staging of P-bead COM rings ``coms`` [..., P, 3]: perturb n
    beads starting after the rotating anchor ``starter``, then shift to
    preserve each ring's COM (PI_perturb_bead_COMs, :1453-1554).
    ``normals`` [..., n, 3] are the twin's normal(split(key, n)[j], (3,));
    ``mass_amu`` broadcasts against the leading dimensions."""
    chain_com = torch.mean(coms, dim=-2)
    coms = coms.clone()
    prev = starter
    final_idx = (starter + n + 1) % P
    for j in range(n):
        bead_idx = (prev + 1) % P
        init_f = (n - j) / (n + 1 - j)
        sigma = torch.sqrt(torch.as_tensor(
            _C_SIGMA * init_f / (temperature * P * mass_amu),
            dtype=torch.float64))
        coms[..., bead_idx, :] = (init_f * coms[..., prev, :] +
                                  (1.0 - init_f) * coms[..., final_idx, :] +
                                  sigma[..., None] * normals[..., j, :])
        prev = bead_idx
    # COM-preserving shift (:1541-1549)
    return coms - (torch.mean(coms, dim=-2) - chain_com)[..., None, :]


def _orientation_schedule(P: int):
    """Static recursion order of the bisection sampler
    (generate_orientation_configs, :1599-1680)."""
    out = []

    def rec(start, end, p):
        if p <= P:
            J = (start + end) // 2
            K = 0 if end == P else end
            out.append((start, J, K, p))
            if p < P:
                rec(start, J, p * 2)
                rec(J, end, p * 2)

    rec(0, P, 2)
    return out


_SAMPLER_AXIS = {}     # device -> the bisection's fixed helper vector


def sample_orientations(v0, u_c, u_b, P: int, bond_length_A,
                        reduced_mass_amu, temperature):
    """P bead orientations by recursive bisection, [P, 3] unit vectors.
    Draws (the twin's key for key): ``v0`` normal (3,) of the first
    orientation, and per schedule entry the uniforms ``u_c`` (the cone
    angle) and ``u_b`` (the azimuth)."""
    sched = _orientation_schedule(P)
    kh = torch.as_tensor(_C_KH * (bond_length_A * bond_length_A) *
                         reduced_mass_amu * temperature, dtype=torch.float64)
    orients = [None] * P
    orients[0] = v0 / torch.linalg.norm(v0)
    if v0.device not in _SAMPLER_AXIS:
        # made once per device: a host tensor copied in would wait on it
        _SAMPLER_AXIS[v0.device] = torch.tensor(
            [1.0, 2.0, -3.0], dtype=torch.float64, device=v0.device)
    tmp = _SAMPLER_AXIS[v0.device]
    for i, (start, J, K_idx, p) in enumerate(sched):
        vec_I, vec_K = orients[start], orients[K_idx]
        bisector = (vec_I + vec_K) / 2.0
        bisector = bisector / torch.linalg.norm(bisector)
        if p > 2:
            vec_IK = vec_K - vec_I
            cosang = torch.dot(vec_I, vec_K) / (
                torch.linalg.norm(vec_I) * torch.linalg.norm(vec_K))
            psi = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
            cos_half = torch.cos(psi * 0.5)
        else:
            dvec = tmp + bisector
            dvec = dvec / torch.linalg.norm(dvec)
            vec_IK = torch.linalg.cross(dvec, bisector)
            cos_half = 1.0
        K = 4.0 * kh * p * cos_half
        angle_A = torch.arccos(torch.clamp(
            1.0 + (1.0 / K) * torch.log(1.0 - u_c[i] *
                                        (1.0 - torch.exp(-2.0 * K))),
            -1.0, 1.0))
        angle_B = u_b[i] * const.twoPi
        vec_beta = quat.rotate(quat.from_axis_angle(bisector, angle_B),
                               vec_IK)
        orients[J] = quat.rotate(quat.from_axis_angle(vec_beta, angle_A),
                                 bisector)
    return torch.stack(orients)


def orient_molecule(pos, mol_sel, com, site_atom_pos, target_dir):
    """Rotate a molecule (atoms selected by ``mol_sel`` [A]) about its COM
    so the COM->site vector points along ``target_dir``, in every bead at
    once: ``pos`` [P, A, 3], the rest [P, 3] (Molecule::orient,
    src/Molecule.cpp:211-254)."""
    cur = site_atom_pos - com
    cur = cur / torch.linalg.norm(cur, dim=-1, keepdim=True)
    cosang = torch.sum(cur * target_dir, dim=-1) / \
        torch.linalg.norm(target_dir, dim=-1)
    angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    q = quat.from_axis_angle(torch.linalg.cross(cur, target_dir), angle)
    rotated = quat.rotate(q[:, None, :], pos - com[:, None, :]) + \
        com[:, None, :]
    return torch.where(mol_sel[None, :, None], rotated, pos)


class PerturbSpec(NamedTuple):
    """Per-molecule-slot orientation data resolved at setup: [M] device
    tensors."""
    has_orientation: torch.Tensor
    site_offset: torch.Tensor      # atom offset within the molecule
    bond_length: torch.Tensor      # Angstrom
    reduced_mass: torch.Tensor     # amu (the keyword's kg converted)


def pi_perturb_beads(stack: SystemState, mol, coker_normals, n_chain: int,
                     starter: int, temperature, orient=None):
    """Bead-perturbation move: orientation staging, then COM staging
    (PI_perturb_beads, :1392-1397; the twin's step, pi.py:456-486).
    ``orient`` is None without orientation data, else (gate, site atom,
    bond length, reduced mass, v0, u_c, u_b): ``gate`` a device bool that
    keeps the orientation staging, the rest sample_orientations' inputs
    and draws."""
    P = stack.pos.shape[0]
    sel = stack.mol_id[0] == mol
    pos = stack.pos
    if orient is not None:
        gate, site_atom, bond_len, red_mass, v0, u_c, u_b = orient
        orients = sample_orientations(v0, u_c, u_b, P, bond_len,
                                      torch.clamp(red_mass, min=1e-30),
                                      temperature)
        oriented = orient_molecule(pos, sel, _of_mol(mol_coms(stack), mol),
                                   _of_mol(pos, site_atom), orients)
        stack = stack.replace(pos=torch.where(gate, oriented, pos))
    coms = _of_mol(mol_coms(stack), mol)
    new_coms = coker_stage_coms(coms, coker_normals, n_chain, starter,
                                _of_mol(stack.mol_mass, mol)[0],
                                temperature, P)
    delta = new_coms - coms                                    # [P, 3]
    return stack.replace(pos=torch.where(sel[None, :, None],
                                         stack.pos + delta[:, None, :],
                                         stack.pos))


# ---------------------------------------------------------------------------
# per-bead energies
# ---------------------------------------------------------------------------

def pi_potential_per_bead(stack: SystemState, flags: FFlags,
                          params: RunParams, beads=None):
    """[P, 4] per-bead (rd, coul, polar, vdw) and [P] failure flags; one
    full recompute per bead (``beads``: the stack's bead views, when the
    caller has them)."""
    comps, failed = [], []
    for b in beads or [bead(stack, s) for s in range(stack.pos.shape[0])]:
        eb = energy_breakdown(b, flags, params)
        comps.append(torch.stack([eb.rd, eb.coulombic, eb.polarization,
                                  eb.vdw]))
        failed.append(eb.iterator_failed)
    return torch.stack(comps), torch.stack(failed)


def pi_sf_compute(stack: SystemState, flags: FFlags, params: RunParams):
    """[P, K] per-bead Ewald structure factors."""
    sfs = [delta_mod.sf_compute(bead(stack, s), flags, params)
           for s in range(stack.pos.shape[0])]
    return delta_mod.SFCache(torch.stack([s.re for s in sfs]),
                             torch.stack([s.im for s in sfs]))


def pi_delta_potential(old_stack: SystemState, new_stack: SystemState,
                       rows, sf, comps_old, flags: FFlags,
                       params: RunParams, beads=None):
    """Incremental per-bead Delta-E: the move touched only ``rows`` atoms
    of each bead.  Returns (comps_new [P, 4], sf_new, total).  ``beads``:
    (old, new) bead views, when the caller has them."""
    P = old_stack.pos.shape[0]
    old_b, new_b = beads or ([bead(old_stack, s) for s in range(P)],
                             [bead(new_stack, s) for s in range(P)])
    d_rd, d_coul, re, im = [], [], [], []
    for s in range(P):
        d = delta_mod.delta_energy(old_b[s], new_b[s], rows,
                                   delta_mod.SFCache(sf.re[s], sf.im[s]),
                                   flags, params)
        d_rd.append(d.d_rd)
        d_coul.append(d.d_coul)
        re.append(d.sf_new.re)
        im.append(d.sf_new.im)
    zeros = torch.zeros(P, dtype=comps_old.dtype, device=comps_old.device)
    comps_new = comps_old + torch.stack(
        [torch.stack(d_rd), torch.stack(d_coul), zeros, zeros], dim=1)
    total = torch.sum(torch.mean(comps_new, dim=0))
    return comps_new, delta_mod.SFCache(torch.stack(re), torch.stack(im)), \
        total


# ---------------------------------------------------------------------------
# PI chain
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PICarry:
    stack: SystemState
    potential_current: torch.Tensor   # last-accepted bead-avg potential
    obs_components: torch.Tensor      # [4]: rd, coul, polar, vdw (bead-avg)
    comps_per_bead: torch.Tensor      # [P, 4]
    sf: delta_mod.SFCache             # [P, K] per-bead structure factors
    temperature: torch.Tensor
    key: torch.Tensor                 # [2] int64 random key, on the host
    starter_bead: int                 # rotating Coker anchor (host)
    step: torch.Tensor
    accept: torch.Tensor              # [7]
    reject: torch.Tensor
    bf: torch.Tensor


class PIStepOut(NamedTuple):
    boltzmann_factor: torch.Tensor
    accepted: torch.Tensor
    movetype: int


@dataclasses.dataclass(frozen=True)
class PIOptions:
    move_factor: float = 1.0
    rot_factor: float = 1.0
    spinflip_probability: float = 0.0
    bead_perturb_probability: float = 0.0
    quantum_rotation: bool = False
    simulated_annealing: bool = False
    simulated_annealing_linear: bool = False
    simulated_annealing_schedule: float = 0.0
    simulated_annealing_target: float = 0.0
    numsteps: int = 0


# columns of one step's draws (see pi_draws); Coker's normals and the
# orientation sampler's draws follow _COKER
_U_TARGET, _R_MOVE, _U_ACC, _DICE, _AXIS, _U_ANGLE, _COKER = \
    0, 1, 2, 3, 9, 12, 13


def pi_draws(key: torch.Tensor, n: int, n_chain: int, P: int,
             any_orientation: bool):
    """The draws of ``n`` consecutive PI steps from the chain key, as the
    twin's step derives them (pi.py:409, 417-419, 140-154, 174, 223-257,
    295): per step split(key, 5) -> (next key, k_move, k_tgt, k_apply,
    k_acc); the target, move and acceptance uniforms; from split(k_apply,
    3) the displacement's six uniforms, three normals and angle uniform;
    from split(k_apply) -> (k_orient, k_com) Coker's n_chain normal
    triples of split(k_com, n_chain) and, where a species carries
    orientation data, the sampler's normal (3,) of split(k_orient)[0]
    and, for each schedule entry of split(split(k_orient)[1], L), the
    uniforms of its split pair.  Returns (the key after the chunk, [n, W]
    f64 on the host)."""
    subs = []
    for _ in range(n):
        sub = rnd.split(key, 5)
        key = sub[0]
        subs.append(sub)
    ks = torch.stack(subs)                              # [n, 5, 2]
    k_apply = ks[:, 3]
    k3 = rnd.split(k_apply, 3)
    k_orient, k_com = rnd.split(k_apply, 2).unbind(1)
    cols = [rnd.uniform(ks[:, [2, 1, 4]]),
            rnd.uniform(k3[:, 0], (6,)),
            rnd.normal(k3[:, 1], (3,)),
            rnd.uniform(k3[:, 2])[:, None],
            rnd.normal(rnd.split(k_com, n_chain), (3,)).reshape(n, -1)]
    if any_orientation:
        k0, k_sched = rnd.split(k_orient, 2).unbind(1)
        L = len(_orientation_schedule(P))
        kcb = rnd.split(rnd.split(k_sched, L), 2)       # [n, L, 2, 2]
        cols += [rnd.normal(k0, (3,)), rnd.uniform(kcb[:, :, 0]),
                 rnd.uniform(kcb[:, :, 1])]
    return key, torch.cat(cols, dim=1)


def make_pi_step(flags: FFlags, base_params: RunParams, opts: PIOptions,
                 perturb_specs: PerturbSpec, trial_chain_len: int,
                 topology_pair, incremental: bool = False,
                 max_mol_atoms: int = 1, any_orientation: bool = True):
    """Build ``step(carry, d, perturb) -> (carry, PIStepOut)`` (the twin's
    make_pi_step, pi.py:385-573); ``d`` is one row of pi_draws on the
    stack's device, ``perturb`` the host's move pick.  ``topology_pair``
    is the (mol_start[M], mol_natoms[M]) host pair of state.topology;
    ``max_mol_atoms`` the move window; ``any_orientation`` (static) keeps
    the bisection staging in the graph."""
    require_supported(flags, base_params)
    if opts.quantum_rotation:
        raise NotImplementedError("PIOptions.quantum_rotation=True "
                                  "(spin flips)")
    params = base_params
    n = trial_chain_len
    tables = {}
    views = {}

    def on(dev):
        if dev not in tables:
            tables[dev] = tuple(torch.as_tensor(t, dtype=torch.int64,
                                                device=dev)
                                for t in topology_pair)
        return tables[dev]

    def beads_of(stack):
        """Bead views of ``stack``: the static fields' views are made once
        (a PI move changes only the positions)."""
        P = stack.pos.shape[0]
        if views.get("mass") is not stack.mass:
            views["mass"] = stack.mass
            views["beads"] = [bead(stack, s) for s in range(P)]
        return [b.replace(pos=stack.pos[s])
                for s, b in enumerate(views["beads"])]

    def step(carry: PICarry, d, perturb: bool):
        stack = carry.stack
        P = stack.pos.shape[0]
        T = carry.temperature
        dev = stack.pos.device
        target, _ = moves.pick_random_movable(bead(stack, 0), d[_U_TARGET])
        t1 = target.reshape(1)
        spec = [f.index_select(0, t1)[0] for f in perturb_specs]
        has_orient, site_offset, bond_len, red_mass = spec
        site_atom = on(dev)[0].index_select(0, t1)[0] + site_offset

        def chain_metrics(st):
            cml = chain_mass_length2_mol(st, target)
            if not any_orientation:
                return cml, torch.zeros_like(cml)
            oml = orient_mu_length2_mol(st, target, site_atom, bond_len)
            return cml, torch.where(has_orient & (bond_len > 0), oml, 0.0)

        if perturb:
            movetype = const.MOVETYPE_PERTURB_BEADS
            cml_init, oml_init = chain_metrics(stack)
            orient = None
            if any_orientation:
                o = _COKER + 3 * n
                L = len(_orientation_schedule(P))
                orient = (has_orient & (bond_len > 0) & (red_mass > 0),
                          site_atom, bond_len, red_mass, d[o:o + 3],
                          d[o + 3:o + 3 + L], d[o + 3 + L:o + 3 + 2 * L])
            new_stack = pi_perturb_beads(
                stack, target, d[_COKER:_COKER + 3 * n].reshape(n, 3), n,
                carry.starter_bead, T, orient)
        else:
            movetype = const.MOVETYPE_DISPLACE
            new_stack = pi_displace(stack, d[_DICE:_DICE + 6],
                                    d[_AXIS:_AXIS + 3], d[_U_ANGLE], target,
                                    opts.move_factor, opts.rot_factor)

        if incremental:
            rows = moves.molecule_rows(*on(dev), target, max_mol_atoms)
            comps_pb, sf_new, pot_trial = pi_delta_potential(
                stack, new_stack, rows, carry.sf, carry.comps_per_bead,
                flags, params, beads=(beads_of(stack), beads_of(new_stack)))
            failed = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            comps_pb, failed_pb = pi_potential_per_bead(
                new_stack, flags, params, beads=beads_of(new_stack))
            pot_trial = torch.sum(torch.mean(comps_pb, dim=0))
            failed = torch.any(failed_pb)
            sf_new = carry.sf
        comps = torch.mean(comps_pb, dim=0)

        # (PI_NVT_boltzmann_factor, :490-547); SI constants folded into
        # _C_CHAIN/_C_ORIENT (the orientation chain is massless: quirk)
        delta_pot = pot_trial - carry.potential_current
        if perturb:
            cml_trial, oml_trial = chain_metrics(new_stack)
            bf = torch.exp(-delta_pot / T -
                           (cml_trial - cml_init) * (P * T * _C_CHAIN) -
                           (oml_trial - oml_init) * (P * T * _C_ORIENT))
        else:
            bf = torch.exp(-delta_pot / T)
        bf = torch.where(torch.isfinite(pot_trial), bf, 0.0)
        accept = (d[_U_ACC] < bf) & ~failed

        def sel(a, b):
            return torch.where(accept, a, b)

        T_out = T
        if opts.simulated_annealing:
            # (PI main loop :151-160)
            T_out = sel(annealed_temperature(opts, T, carry.step), T)
        out = PIStepOut(bf, accept, movetype)
        return dataclasses.replace(
            carry, stack=stack.replace(pos=sel(new_stack.pos, stack.pos)),
            potential_current=sel(pot_trial, carry.potential_current),
            obs_components=sel(comps, carry.obs_components),
            comps_per_bead=sel(comps_pb, carry.comps_per_bead),
            sf=delta_mod.SFCache(sel(sf_new.re, carry.sf.re),
                                 sel(sf_new.im, carry.sf.im)),
            temperature=T_out,
            starter_bead=(carry.starter_bead + 1) % P if perturb
            else carry.starter_bead,
            step=carry.step + 1, bf=bf), out

    return step


def make_pi_chunk_runner(step, chunk_steps: int, opts: PIOptions,
                         n_chain: int, any_orientation: bool):
    """``run_chunk(carry) -> (carry, PIStepOut of [chunk_steps] columns)``:
    a host loop over ``chunk_steps`` steps of ``step`` (make_pi_step)."""

    def run_chunk(carry: PICarry):
        dev = carry.stack.pos.device
        P = carry.stack.pos.shape[0]
        key, draws = pi_draws(carry.key, chunk_steps, n_chain, P,
                              any_orientation)
        perturb = (draws[:, _R_MOVE] <
                   opts.bead_perturb_probability).tolist()
        draws = draws.to(dev, non_blocking=True)
        outs = []
        for i in range(chunk_steps):
            carry, out = step(carry, draws[i], perturb[i])
            outs.append(out)
        outs = PIStepOut(
            torch.stack([o.boltzmann_factor for o in outs]),
            torch.stack([o.accepted for o in outs]),
            torch.tensor([o.movetype for o in outs]).to(dev,
                                                        non_blocking=True))
        stats = accumulate_stats(NodeStats(carry.accept, carry.reject, None),
                                 outs)
        return dataclasses.replace(carry, key=key, accept=stats.accept,
                                   reject=stats.reject), outs

    return run_chunk


def init_pi_carry(stack: SystemState, flags: FFlags, params: RunParams,
                  temperature: float, key, incremental: bool) -> PICarry:
    """The chain's start (pi.py:753-775): per-bead energies, and their
    structure factors on the incremental path."""
    P = stack.pos.shape[0]
    dev = stack.pos.device
    comps_pb, _ = pi_potential_per_bead(stack, flags, params)
    comps = torch.mean(comps_pb, dim=0)
    if incremental:
        sf = pi_sf_compute(stack, flags, params)
    else:
        z = torch.zeros((P, 0), dtype=torch.float64, device=dev)
        sf = delta_mod.SFCache(z, z)
    zeros7 = torch.zeros(7, dtype=torch.int64, device=dev)
    return PICarry(
        stack=stack, potential_current=torch.sum(comps),
        obs_components=comps, comps_per_bead=comps_pb, sf=sf,
        temperature=torch.full((), temperature, dtype=torch.float64,
                               device=dev),
        key=key, starter_bead=0,
        step=torch.zeros((), dtype=torch.int64, device=dev),
        accept=zeros7, reject=zeros7,
        bf=torch.zeros((), dtype=torch.float64, device=dev))


# ---------------------------------------------------------------------------
# host-side run
# ---------------------------------------------------------------------------

class PISimulation:
    """PI-NVT run (PI_nvt_mc, src/SimulationControl.PathIntegral.cpp:
    31-196) on ``device``."""

    def __init__(self, cfg: SimConfig, P: int = None, quiet: bool = False,
                 mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError("PISimulation(mesh=...): the "
                                      "bead-per-device mesh")
        if cfg.quantum_rotation:
            raise NotImplementedError("quantum_rotation (spin flips) in "
                                      "pi_nvt")
        if P is None:
            P = cfg.total_trotter_number or 8
        self.P = P
        self.cfg = validate(cfg, n_systems=P)
        self.quiet = quiet
        self.out = sys.stdout
        self.device = torch.device(device)
        self.xyz_path = ""

        basis = np.zeros((3, 3))
        if cfg.basis1 and cfg.basis2 and cfg.basis3:
            basis[0], basis[1], basis[2] = cfg.basis1, cfg.basis2, cfg.basis3
        if np.linalg.det(basis) <= 0:
            raise ValueError("invalid simulation box dimensions")

        # per-bead geometry: restart files or the replicated base input
        states = []
        for s in range(P):
            path = cfg.pqr_input
            if cfg.parallel_restarts:
                cand = pqr_io.make_filename(
                    cfg.pqr_restart if cfg.pqr_restart not in ("",
                                                               "/dev/null")
                    else cfg.job_name + ".restart.pqr", s)
                if os.path.exists(cand):
                    path = cand
                elif os.path.exists(cand + ".last"):
                    path = cand + ".last"
            atoms = pqr_io.read_pqr(path, scale_charge=cfg.scale_charge)
            st, self.meta = build_state(atoms, basis, device=self.device)
            states.append(st)
        self.stack = stack_states(states)

        cutoff = float(self.stack.pbc.cutoff[0])
        if not cfg.ewald_alpha_set:
            cfg.ewald_alpha = 3.5 / cutoff
        if not cfg.polar_ewald_alpha_set:
            cfg.polar_ewald_alpha = 3.5 / cutoff
        self.flags = cfg.to_flags()
        self.params = cfg.to_params()
        self.opts = PIOptions(
            move_factor=cfg.move_factor, rot_factor=cfg.rot_factor,
            spinflip_probability=cfg.spinflip_probability,
            bead_perturb_probability=cfg.bead_perturb_probability,
            quantum_rotation=cfg.quantum_rotation,
            simulated_annealing=cfg.simulated_annealing,
            simulated_annealing_linear=cfg.simulated_annealing_linear,
            simulated_annealing_schedule=cfg.simulated_annealing_schedule,
            simulated_annealing_target=cfg.simulated_annealing_target,
            numsteps=cfg.numsteps)

        # per-molecule-slot orientation specs from the sorbate registry;
        # the keyword takes kg (sorbate_reducedMass), device math amu
        types = self.meta["moleculetypes"]
        has = [t in cfg.sorbate_orientation_site and
               t in cfg.sorbate_bond_length for t in types]
        self.perturb_specs = PerturbSpec(
            torch.tensor(has, device=self.device),
            torch.tensor([cfg.sorbate_orientation_site.get(t, 0)
                          for t in types], device=self.device),
            torch.tensor([cfg.sorbate_bond_length.get(t, 0.0)
                          for t in types], dtype=torch.float64,
                         device=self.device),
            torch.tensor([cfg.sorbate_reduced_mass.get(t, 0.0) /
                          const.AMU2KG for t in types],
                         dtype=torch.float64, device=self.device))
        self.any_orientation = any(has)

        self.avg = AvgObservables()
        self.seed = cfg.preset_seed if cfg.preset_seed_on else 0
        self.key = rnd.PRNGKey(self.seed)
        self.incremental = delta_mod.supports(self.flags)
        b0 = bead(self.stack, 0)
        self.topology = topology(b0)
        self.max_mol_atoms = moves.movable_window(b0)
        self._step = make_pi_step(
            self.flags, self.params, self.opts, self.perturb_specs,
            cfg.PI_trial_chain_length, self.topology,
            incremental=self.incremental, max_mol_atoms=self.max_mol_atoms,
            any_orientation=self.any_orientation)
        self._run_chunk = self._chunk_runner(cfg.corrtime)

    def _chunk_runner(self, n: int):
        return make_pi_chunk_runner(self._step, n, self.opts,
                                    self.cfg.PI_trial_chain_length,
                                    self.any_orientation)

    def thermalize(self):
        """Initial whole-system bead perturbation
        (PI_perturb_bead_COMs_ENTIRE_SYSTEM, :1402-1449) with n = P: one
        Coker staging per movable molecule (one key each, in slot order),
        all molecules in one batched staging."""
        P, stack = self.P, self.stack
        movable = moves.movable_mask(bead(stack, 0))
        idx = torch.nonzero(movable).flatten()
        if not len(idx):
            return
        keys = []
        for _ in range(len(idx)):
            self.key, k = rnd.split(self.key)
            keys.append(k)
        normals = rnd.normal(rnd.split(torch.stack(keys), P), (3,))
        coms = mol_coms(stack).index_select(1, idx).transpose(0, 1)
        new = coker_stage_coms(coms, normals.to(stack.pos.device), P, 0,
                               stack.mol_mass[0].index_select(0, idx),
                               self.cfg.temperature, P)
        delta = torch.zeros_like(mol_coms(stack)).index_copy(
            1, idx, (new - coms).transpose(0, 1))             # [P, M, 3]
        self.stack = stack.replace(
            pos=stack.pos + delta.index_select(1, stack.mol_id[0]))

    def _observables(self, carry) -> dict:
        comps = carry.obs_components.tolist()
        kinetic = float(pi_kinetic(carry.stack, carry.temperature))
        b0 = bead(carry.stack, 0)
        N = float(b0.count_N())
        mm = b0.mol_mass.cpu().numpy()
        alive = b0.mol_alive.cpu().numpy()
        fixed = (b0.mol_frozen | b0.mol_adiabatic).cpu().numpy()
        total = sum(comps) + kinetic
        return {
            "energy": total, "rd_energy": comps[0],
            "coulombic_energy": comps[1], "polarization_energy": comps[2],
            "vdw_energy": comps[3], "kinetic_energy": kinetic,
            "temperature": float(carry.temperature), "N": N,
            "spin_ratio": float(b0.spin_ratio_sum()) / max(N, 1.0),
            "volume": float(b0.pbc.volume), "NU": N * total,
            "frozen_mass": float(mm[alive & fixed].sum()),
            "total_mass": float(mm[alive].sum()),
        }

    def _init_carry(self) -> PICarry:
        return init_pi_carry(self.stack, self.flags, self.params,
                             self.cfg.temperature, self.key,
                             self.incremental)

    def _recompute(self, carry: PICarry) -> PICarry:
        """Full per-bead recompute each corrtime on the incremental path:
        Delta-E drift control (pi.py:819-829)."""
        comps_pb, _ = pi_potential_per_bead(carry.stack, self.flags,
                                            self.params)
        comps = torch.mean(comps_pb, dim=0)
        return dataclasses.replace(
            carry, comps_per_bead=comps_pb, obs_components=comps,
            potential_current=torch.sum(comps),
            sf=pi_sf_compute(carry.stack, self.flags, self.params))

    def run(self) -> AvgObservables:
        cfg = self.cfg
        if not cfg.parallel_restarts:
            self.thermalize()
        carry = self._init_carry()
        fp_energy = out_io.open_energy_file(cfg.energy_output) \
            if _live(cfg.energy_output) else None
        fp_csv = out_io.open_energy_file(cfg.energy_output_csv, csv=True) \
            if _live(cfg.energy_output_csv) else None
        # all-bead XYZ frames (write_PI_frame, :699-729), enabled by -xyz
        frames = PIFrameWriter(self.xyz_path)
        perf = out_io.PerformanceTimer(cfg.numsteps)
        pmass = moves.particle_mass(bead(self.stack, 0))

        def corrtime_io(step):
            obs = self._observables(carry)
            self.avg.update(obs, ensemble=cfg.ensemble,
                            temperature=cfg.temperature,
                            volume=obs["volume"], particle_mass=pmass,
                            free_volume=cfg.free_volume,
                            pressure=cfg.pressure)
            for f, csv in ((fp_energy, False), (fp_csv, True)):
                if f:
                    out_io.write_observables(f, step, obs,
                                             obs["temperature"], csv=csv)

        corrtime_io(0)
        if not self.quiet:
            self.out.write("MC: initial values:\n")
            self._display(carry)

        step = 0
        while step < cfg.numsteps:
            n = min(cfg.corrtime, cfg.numsteps - step)
            runner = self._run_chunk if n == cfg.corrtime else \
                self._chunk_runner(n)
            carry, _ = runner(carry)
            step += n
            if self.incremental:
                carry = self._recompute(carry)
            ns = nodestats_from_counters(carry.accept.cpu().numpy(),
                                         carry.reject.cpu().numpy(),
                                         float(carry.bf))
            self.avg.update_nodestats(ns)
            corrtime_io(step)
            frames.write(carry.stack, self.meta)
            self._write_beads(carry, self.cfg.pqr_restart)
            if not self.quiet:
                perf.report(step, self.out)
                self._display(carry)

        self._write_beads(carry, self.cfg.pqr_output)
        for f in (fp_energy, fp_csv):
            if f:
                f.close()
        self.carry = carry
        return self.avg

    def _write_beads(self, carry, basename):
        """One PQR per bead (restart or final), make_filename's -000s."""
        if basename == "/dev/null":
            return
        for s in range(self.P):
            pqr_io.write_state_pqr(pqr_io.make_filename(basename, s),
                                   bead(carry.stack, s), self.meta,
                                   wrapall=self.cfg.wrapall,
                                   long_output=self.cfg.long_output)

    def _display(self, carry):
        out_io.display_averages(
            self.avg, temperature=float(carry.temperature),
            simulated_annealing=self.cfg.simulated_annealing,
            ensemble=self.cfg.ensemble, out=self.out)
