"""Two-box Gibbs (NVT) ensemble.

JAX twin: mpmcxx_tpu/mc/gibbs.py.  Coupled Markov chains over two boxes
(SimulationControl.Gibbs.cpp:136-352): particle transfers (remove from
one box + insert a randomized copy into the other) and coupled volume
exchanges accept jointly; displacements accept per box
(boltzmann_factor_NVT_Gibbs, src/SimulationControl.Gibbs.cpp:358-524,
pick_Gibbs_move src/System.MonteCarlo.cpp:509-714).  The two boxes may
have different capacities, so the carry holds two states.

Ported: displacements, spin flips (quantum rotation; one in each box,
accepted per box), transfers and the coupled volume exchange on the
per-box incremental pairwise branch (any pairwise term of ops/energy,
with the moved rows' cavity_autoreject_absolute penalty; a volume
exchange recomputes both boxes) or the full-recompute branch (dense,
or in row blocks above 1,024 slots), the volume factor's deliberate
deviation from the reference's law (README Fidelity) included.  As in
the twin, no spin flip is accepted: the rotational partition functions
stay 0 and their ratio is NaN.

As in ``mc/chain.py`` the chunk is a host loop that never waits on the
device.  Every draw of a step is a function of the carried key, so the
chunk's draws are made on the host up front (``gibbs_draws``), and with
them the move pick (spin flip, volume exchange, transfer or
displacement) and a transfer's direction.  The one data-dependent
choice, "never empty a box" (a transfer out of a box holding one
molecule becomes a displacement), is a device-side select: on a transfer
step both the transfer and the two displacements are proposed (each an
O(S) window write) and selected before the one energy evaluation per
box.

``GibbsSimulation.run`` drains the PQR writer (``io.pqr.drain``) before
it returns, so the two boxes' final PQRs are on disk when a caller in
the same process reads them.  The twin does not drain there: its writes
finish when the writer thread exits at the end of the process.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from .. import random as rnd
from .. import tracing
from ..config.schema import SimConfig
from ..config.validate import validate
from ..flags import FFlags, RunParams, dense_only, require_supported
from ..io import output as out_io
from ..io import pqr as pqr_io
from ..ops import delta as delta_mod
from ..ops.energy import (EnergyBreakdown, cavity_absolute_check,
                          energy_breakdown, energy_breakdown_blocked)
from ..ops.pairwise import build_pairs_rect
from ..pbc import PBC
from ..state import Observables, SystemState, build_state, topology
from . import chain as chain_mod
from . import metropolis, moves
from .averages import AvgObservables, nodestats_from_counters


@dataclasses.dataclass
class GibbsCarry:
    state_a: SystemState
    state_b: SystemState
    energy_a: torch.Tensor
    energy_b: torch.Tensor
    obs_a: Observables
    obs_b: Observables
    temperature: torch.Tensor
    key: torch.Tensor          # [2] int64 random key, on the host
    step: torch.Tensor
    accept: torch.Tensor       # [7] int64 per movetype
    reject: torch.Tensor
    sf_a: delta_mod.SFCache    # per-box Ewald structure factors ([0]
    sf_b: delta_mod.SFCache    # off the incremental path)
    recip_a: torch.Tensor      # per-box current k-space energies
    recip_b: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GibbsOptions:
    move_factor: float = 1.0
    rot_factor: float = 1.0
    spinflip_probability: float = 0.0
    volume_probability: float = 0.0
    transfer_probability: float = 0.0
    volume_change_factor: float = 0.25
    quantum_rotation: bool = False
    numsteps: int = 0
    # rect Delta-E per box for local moves (ops.delta); coupled volume
    # exchanges fall back to the full recompute
    incremental: bool = False
    max_mol_atoms: int = 1
    blocked_energy: bool = False


class GibbsStepOut(NamedTuple):
    boltzmann_factor: torch.Tensor
    accepted: torch.Tensor
    movetype: torch.Tensor


# the host's move pick of a step (transfers are reported as INSERT)
DISPLACE, TRANSFER, VOLUME, SPIN = "displace", "transfer", "volume", "spin"
# the counter of each pick, on the ``gibbs.step`` span
COUNTERS = {DISPLACE: "gibbs_displace", TRANSFER: "gibbs_transfer",
            VOLUME: "gibbs_volume", SPIN: "gibbs_spin"}

# columns of one step's draws (see gibbs_draws)
_U_MOVE, _U_DIR, _U_T1, _U_T2, _U_ACC1, _U_ACC2, _U_VOL = range(7)
_MOVE_A, _MOVE_B = 7, 17     # each 10 wide: dice (6), axis (3), angle


def gibbs_draws(key: torch.Tensor, n: int):
    """The draws of ``n`` consecutive Gibbs steps from the chain key
    (gibbs.py:88-89): per step split(key, 10) -> (next key, k_move, k_dir,
    ka1, ka2, kt1, kt2, kacc1, kacc2, kv), one uniform of each but ka1 and
    ka2, whose moves' draws follow (``chain.move_draws``).  Returns (the key
    after the chunk, [n, 27] f64 on the host)."""
    key, ks = chain_mod.step_keys(key, n, 10)          # [n, 10, 2]
    u = rnd.uniform(ks[:, [1, 2, 5, 6, 7, 8, 9]])       # [n, 7]
    return key, torch.cat([u, chain_mod.move_draws(ks[:, 3]),
                           chain_mod.move_draws(ks[:, 4])], dim=1)


def move_picks(opts: GibbsOptions, draws) -> list:
    """Per step of a chunk, (move, A->B): the move from the move uniform
    (gibbs.py:98-106: a spin flip below spinflip_probability under
    quantum rotation, then the volume exchange, then the transfer) and
    the transfer direction, both from the host draws."""
    spin_p = opts.spinflip_probability if opts.quantum_rotation else 0.0
    vol_p = opts.volume_probability + spin_p
    xfer_p = opts.transfer_probability + vol_p
    out = []
    for r, u_dir in draws[:, [_U_MOVE, _U_DIR]].tolist():
        move = SPIN if r < spin_p else VOLUME if r < vol_p else \
            TRANSFER if r < xfer_p else DISPLACE
        out.append((move, u_dir < 0.5))
    return out


def make_gibbs_step(flags: FFlags, base_params: RunParams,
                    opts: GibbsOptions, topologies):
    """Build ``step(carry, d, move, a_to_b) -> (carry, GibbsStepOut)``;
    ``d`` is one row of gibbs_draws on the boxes' device, ``move`` and
    ``a_to_b`` the host's pick (move_picks), ``topologies`` the two boxes'
    (mol_start[M], mol_natoms[M]) host pairs (state.topology)."""
    require_supported(flags, base_params)
    params = base_params
    S = opts.max_mol_atoms
    full_energy = _full_energy(opts)
    tables = {}

    def rows_of(box, mol):
        dev = mol.device
        if (box, dev) not in tables:
            tables[box, dev] = tuple(
                torch.as_tensor(t, dtype=torch.int64, device=dev)
                for t in topologies[box])
        return moves.molecule_rows(*tables[box, dev], mol, S)

    def displace(state, box, mol, dm):
        rows = rows_of(box, mol)
        return moves.displace_rows(state, dm[:6], dm[6:9], dm[9], rows,
                                   rows >= 0, opts.move_factor,
                                   opts.rot_factor), rows

    def insert(state, box, template, dm):
        """A copy of ``template`` into the first dead slot of its species
        (moves.insert): (state, valid, the slot's rows)."""
        slot = moves.find_dead_slot(
            state, state.mol_type.index_select(0, template.reshape(1))[0])
        tmpl_rows = rows_of(box, template)
        slot_rows = rows_of(box, torch.clamp(slot, min=0))
        new, valid = moves.insert_rows(state, dm[:3], dm[6:9], dm[9],
                                       tmpl_rows, slot_rows, tmpl_rows >= 0,
                                       slot, slot >= 0)
        return new, valid, slot_rows

    def transfer(state, box, mol, dm, demote, source):
        """The source's removal or the destination's insertion, or, where
        the transfer is demoted, the box's displacement."""
        disp, rows = displace(state, box, mol, dm)
        if source:
            new, valid = moves.remove(state, mol), True
        else:
            new, valid, slot_rows = insert(state, box, mol, dm)
            rows = torch.where(demote, rows, slot_rows)
        sel = state.replace(**{
            f: torch.where(demote, getattr(disp, f), getattr(new, f))
            for f in ("pos", "mol_alive", "aalive", "nuclear_spin")})
        return sel, valid, rows

    def volume_exchange(sa, sb, u):
        """(gibbs.py:137-152): ln V_A moves uniformly, V_B takes the rest."""
        va, vb = sa.pbc.volume, sb.pbc.volume
        va_new = torch.exp(torch.log(va) + (u - 0.5) *
                           opts.volume_change_factor)
        vb_new = vb + va - va_new
        valid = vb_new > 0.0
        fa = (va_new / va) ** (1.0 / 3.0)
        fb = torch.where(valid, (vb_new / vb) ** (1.0 / 3.0), 1.0)
        return moves.scale_box(sa, fa), moves.scale_box(sb, fb), valid

    def evaluate(old, new, rows, sf, obs_prev, recip_old, full):
        """(energy, observables, failed, SF cache, k-space energy) of one
        box's proposal (gibbs.py:164-227)."""
        if not opts.incremental:
            eb = full_energy(new, flags, params)
            obs = chain_mod.observables_from_breakdown(
                new, eb, flags, params, const.ENSEMBLE_NVT_GIBBS)
            return (eb.total + eb.cavity_penalty, obs, eb.iterator_failed,
                    sf, recip_old)
        if full:
            eb = full_energy(new, flags, params)
            rd, coul, pen = eb.rd, eb.coulombic, eb.cavity_penalty
            sf_new, recip_new = _recip_caches(new, flags, params, sf)
        else:
            dres = delta_mod.delta_energy(old, new, rows, sf, flags, params,
                                          recip_old=recip_old)
            rd = obs_prev.rd_energy + dres.d_rd
            coul = obs_prev.coulombic_energy + dres.d_coul
            # the penalty of the moved rows' pairs (gibbs.py:181-187)
            pen = cavity_absolute_check(
                new, build_pairs_rect(new, flags, rows), params) \
                if flags.cavity_autoreject_absolute else torch.zeros_like(rd)
            sf_new, recip_new = dres.sf_new, dres.recip_new
        z = torch.zeros_like(rd)
        eb = EnergyBreakdown(
            total=rd + coul, rd=rd, coulombic=coul, polarization=z, vdw=z,
            three_body=z, kinetic=z, mu=old.mu, polarization_iterations=z,
            iterator_failed=torch.zeros_like(z, dtype=torch.bool),
            dipole_rrms=z, cavity_penalty=pen)
        obs = chain_mod.observables_from_breakdown(
            new, eb, flags, params, const.ENSEMBLE_NVT_GIBBS)
        return eb.total + pen, obs, eb.iterator_failed, sf_new, recip_new

    def step(carry: GibbsCarry, d, move: str, a_to_b: bool):
        T = carry.temperature
        sa, sb = carry.state_a, carry.state_b
        full = move == VOLUME
        with tracing.span("gibbs.step.move"):
            dev = sa.pos.device
            ta, na = moves.pick_random_movable(sa, d[_U_T1])
            tb, nb = moves.pick_random_movable(sb, d[_U_T2])
            dma, dmb = d[_MOVE_A:_MOVE_A + 10], d[_MOVE_B:_MOVE_B + 10]
            demote = None
            if move == VOLUME:
                new_a, new_b, valid = volume_exchange(sa, sb, d[_U_VOL])
                rows_a = rows_b = None
                movetype = torch.full((), const.MOVETYPE_VOLUME,
                                      dtype=torch.int64, device=dev)
            elif move == TRANSFER:
                # never empty a box (src/System.MonteCarlo.cpp:655-661)
                demote = (na <= 1) if a_to_b else (nb <= 1)
                new_a, valid_a, rows_a = transfer(sa, 0, ta, dma, demote,
                                                  a_to_b)
                new_b, valid_b, rows_b = transfer(sb, 1, tb, dmb, demote,
                                                  not a_to_b)
                valid = demote | (valid_b if a_to_b else valid_a)
                movetype = torch.where(demote, const.MOVETYPE_DISPLACE,
                                       const.MOVETYPE_INSERT)
            elif move == SPIN:
                # a spin flip in each box (gibbs.py:121-123)
                new_a, rows_a = moves.spinflip(sa, ta), rows_of(0, ta)
                new_b, rows_b = moves.spinflip(sb, tb), rows_of(1, tb)
                valid = True
                movetype = torch.full((), const.MOVETYPE_SPINFLIP,
                                      dtype=torch.int64, device=dev)
            else:
                new_a, rows_a = displace(sa, 0, ta, dma)
                new_b, rows_b = displace(sb, 1, tb, dmb)
                valid = True
                movetype = torch.full((), const.MOVETYPE_DISPLACE,
                                      dtype=torch.int64, device=dev)
        with tracing.span("gibbs.step.delta_e"):
            ea, obs_a, fail_a, sf_a, recip_a = evaluate(
                sa, new_a, rows_a, carry.sf_a, carry.obs_a, carry.recip_a,
                full)
            eb_, obs_b, fail_b, sf_b, recip_b = evaluate(
                sb, new_b, rows_b, carry.sf_b, carry.obs_b, carry.recip_b,
                full)
        with tracing.span("gibbs.step.accept"):
            dEa = ea - carry.energy_a
            dEb = eb_ - carry.energy_b
            beta = 1.0 / T
            # displacements and spin flips accept per box (gibbs.py:234-252);
            # a flip's ratio of rotational partition functions is NaN while
            # they are 0, as the twin leaves them (fault kept)
            if move == SPIN:
                bf_a_ind = _spin_ratio(sa, new_a, ta)
                bf_b_ind = _spin_ratio(sb, new_b, tb)
            else:
                bf_a_ind, bf_b_ind = torch.exp(-dEa / T), torch.exp(-dEb / T)
            acc_a = (d[_U_ACC1] < torch.where(torch.isfinite(ea), bf_a_ind,
                                              0.0)) & ~fail_a
            acc_b = (d[_U_ACC2] < torch.where(torch.isfinite(eb_), bf_b_ind,
                                              0.0)) & ~fail_b
            bf = bf_a_ind
            if move in (TRANSFER, VOLUME):
                va, vb = sa.pbc.volume, sb.pbc.volume
                if move == TRANSFER:
                    # (src/SimulationControl.Gibbs.cpp:416-441) with the
                    # POST-move counts, as the reference evaluates it
                    N_src, N_dst = (obs_a.N, obs_b.N) if a_to_b else \
                        (obs_b.N, obs_a.N)
                    V_src, V_dst = (va, vb) if a_to_b else (vb, va)
                    bf_joint = (N_src / V_src) * (V_dst / (N_dst + 1.0)) * \
                        torch.exp(-beta * dEa - beta * dEb)
                else:
                    # the deliberate deviation from the reference's law
                    # (gibbs.py:264-278): the d(ln V_A) -> dV_A Jacobian adds
                    # one power of V_A'/V_A
                    dV = new_a.pbc.volume - va
                    bf_joint = ((va + dV) / va) ** (obs_a.N + 1.0) \
                        * ((vb - dV) / vb) ** obs_b.N \
                        * torch.exp(-beta * dEa - beta * dEb)
                finite = torch.isfinite(ea) & torch.isfinite(eb_)
                bf_joint = torch.where(finite & valid, bf_joint, 0.0)
                acc_joint = (d[_U_ACC1] < bf_joint) & ~fail_a & ~fail_b
                if demote is None:
                    acc_a = acc_b = acc_joint
                    bf = bf_joint
                else:
                    acc_a = torch.where(demote, acc_a, acc_joint)
                    acc_b = torch.where(demote, acc_b, acc_joint)
                    bf = torch.where(demote, bf_a_ind, bf_joint)

            changed = ("pos", "mol_alive", "aalive", "nuclear_spin") \
                if move == TRANSFER else ("nuclear_spin",) if move == SPIN \
                else ("pos",)

            def select(acc, new, old):
                out = old.replace(**{f: torch.where(acc, getattr(new, f),
                                                    getattr(old, f))
                                     for f in changed})
                if full:
                    out.pbc = PBC(**{
                        f.name: torch.where(acc, getattr(new.pbc, f.name),
                                            getattr(old.pbc, f.name))
                        for f in dataclasses.fields(PBC)})
                return out

            def sel_obs(acc, new, old):
                return Observables(**{
                    f.name: torch.where(acc, getattr(new, f.name),
                                        getattr(old, f.name))
                    for f in dataclasses.fields(Observables)})

            def sel_sf(acc, new, old):
                return delta_mod.SFCache(torch.where(acc, new.re, old.re),
                                         torch.where(acc, new.im, old.im))

            out = GibbsStepOut(bf, acc_a | acc_b, movetype)
            return dataclasses.replace(
                carry, state_a=select(acc_a, new_a, sa),
                state_b=select(acc_b, new_b, sb),
                energy_a=torch.where(acc_a, ea, carry.energy_a),
                energy_b=torch.where(acc_b, eb_, carry.energy_b),
                obs_a=sel_obs(acc_a, obs_a, carry.obs_a),
                obs_b=sel_obs(acc_b, obs_b, carry.obs_b),
                sf_a=sel_sf(acc_a, sf_a, carry.sf_a),
                sf_b=sel_sf(acc_b, sf_b, carry.sf_b),
                recip_a=torch.where(acc_a, recip_a, carry.recip_a),
                recip_b=torch.where(acc_b, recip_b, carry.recip_b),
                step=carry.step + 1), out

    return step


def _spin_ratio(old, new, mol):
    """The flip's ratio of rotational partition functions in one box
    (gibbs.py:234-245)."""
    one = mol.reshape(1)
    return metropolis.spin_partfunc_ratio(
        new.nuclear_spin.index_select(0, one)[0],
        old.rot_partfunc_g.index_select(0, one)[0],
        old.rot_partfunc_u.index_select(0, one)[0])


def make_gibbs_chunk_runner(flags: FFlags, params: RunParams,
                            opts: GibbsOptions, chunk_steps: int,
                            topologies):
    """``run_chunk(carry) -> (carry, GibbsStepOut of [chunk_steps]
    tensors)``: a host loop over ``chunk_steps`` steps."""
    step = make_gibbs_step(flags, params, opts, topologies)

    def run_chunk(carry: GibbsCarry):
        with tracing.span("gibbs.draws"):
            key, draws = gibbs_draws(carry.key, chunk_steps)
            picks = move_picks(opts, draws)
            draws = draws.to(carry.state_a.pos.device, non_blocking=True)
        outs = []
        for i, (move, a_to_b) in enumerate(picks):
            with tracing.span("gibbs.step", move=True):
                tracing.count(COUNTERS[move])
                carry, out = step(carry, draws[i], move, a_to_b)
            outs.append(out)
        with tracing.span("gibbs.stats"):
            outs = GibbsStepOut(*(torch.stack(col) for col in zip(*outs)))
            stats = chain_mod.accumulate_stats(
                chain_mod.NodeStats(carry.accept, carry.reject, None), outs)
        return dataclasses.replace(carry, key=key, accept=stats.accept,
                                   reject=stats.reject), outs

    return run_chunk


def _full_energy(opts: GibbsOptions):
    return (energy_breakdown_blocked if opts.blocked_energy
            else energy_breakdown)


def _box_energy(state, flags, params, opts: GibbsOptions):
    """(energy, observables) of a full recompute of one box."""
    eb = _full_energy(opts)(state, flags, params)
    obs = chain_mod.observables_from_breakdown(
        state, eb, flags, params, const.ENSEMBLE_NVT_GIBBS)
    return eb.total + eb.cavity_penalty, obs


def _box_recip(state, flags, params, opts: GibbsOptions, sf):
    """(SF cache, k-space energy) of one box that the incremental path
    carries, else ``sf`` unchanged and 0."""
    if opts.incremental:
        return _recip_caches(state, flags, params, sf)
    return sf, torch.zeros((), dtype=torch.float64, device=state.pos.device)


def _recip_caches(state, flags, params, sf):
    """(SF cache, k-space energy) of ``state`` where the energy has a
    k-space term, else ``sf`` unchanged and 0 (gibbs.py:190-195)."""
    if not delta_mod.uses_recip(flags):
        return sf, torch.zeros((), dtype=torch.float64,
                               device=state.pos.device)
    sf = delta_mod.sf_compute(state, flags, params)
    return sf, delta_mod.recip_energy(sf, state, flags, params)


def init_gibbs_carry(state_a, state_b, flags: FFlags, params: RunParams,
                     opts: GibbsOptions, seed: int,
                     temperature: float) -> GibbsCarry:
    """The two boxes' initial energies and caches (gibbs.py:417-446)."""
    dev = state_a.pos.device
    with tracing.span("setup.init_carry"):
        ea, obs_a = _box_energy(state_a, flags, params, opts)
        eb_, obs_b = _box_energy(state_b, flags, params, opts)
        sf_a, recip_a = _box_recip(state_a, flags, params, opts,
                                   delta_mod.empty_sf(dev))
        sf_b, recip_b = _box_recip(state_b, flags, params, opts,
                                   delta_mod.empty_sf(dev))
    zeros7 = torch.zeros(7, dtype=torch.int64, device=dev)
    return GibbsCarry(
        state_a, state_b, ea, eb_, obs_a, obs_b,
        torch.full((), temperature, dtype=torch.float64, device=dev),
        rnd.PRNGKey(seed), torch.zeros((), dtype=torch.int64, device=dev),
        zeros7, zeros7, sf_a, sf_b, recip_a, recip_b)


def make_gibbs_refresher(flags: FFlags, params: RunParams,
                         opts: GibbsOptions):
    """Per-corrtime drift control on the incremental path: full energy and
    structure-factor recompute of both boxes (flag_all_pairs,
    src/System.cpp:1284-1297; gibbs.py:390-414)."""

    def refresh(carry: GibbsCarry) -> GibbsCarry:
        sa, sb = carry.state_a, carry.state_b
        with tracing.span("gibbs.refresh"):
            with tracing.span("gibbs.refresh.energy"):
                ea, obs_a = _box_energy(sa, flags, params, opts)
                eb_, obs_b = _box_energy(sb, flags, params, opts)
            with tracing.span("gibbs.refresh.sf"):
                sf_a, recip_a = _box_recip(sa, flags, params, opts,
                                           carry.sf_a)
                sf_b, recip_b = _box_recip(sb, flags, params, opts,
                                           carry.sf_b)
        return dataclasses.replace(
            carry, energy_a=ea, energy_b=eb_, obs_a=obs_a, obs_b=obs_b,
            sf_a=sf_a, sf_b=sf_b, recip_a=recip_a, recip_b=recip_b)

    return refresh


class GibbsSimulation:
    """Host-side run of NVT-Gibbs (Gibbs_mc,
    src/SimulationControl.Gibbs.cpp:136-352) on ``device``."""

    def __init__(self, cfg: SimConfig, quiet: bool = False, device="cuda"):
        self.cfg = validate(cfg)
        self.quiet = quiet
        self.out = sys.stdout
        self.device = torch.device(device)

        basis = np.zeros((3, 3))
        basis[0], basis[1], basis[2] = cfg.basis1, cfg.basis2, cfg.basis3
        with tracing.span("setup.build_state"):
            atoms_a = pqr_io.read_pqr(cfg.pqr_input,
                                      scale_charge=cfg.scale_charge)
            atoms_b = pqr_io.read_pqr(cfg.pqr_input_B or cfg.pqr_input,
                                      scale_charge=cfg.scale_charge)
            n_a = len({a.molecule_id for a in atoms_a if not a.frozen})
            n_b = len({a.molecule_id for a in atoms_b if not a.frozen})
            # either box can hold every molecule of both
            extra = max(n_a, n_b, 16)
            self.state_a, self.meta_a = build_state(
                atoms_a, basis, extra_mol_capacity=extra, device=self.device)
            self.state_b, self.meta_b = build_state(
                atoms_b, basis, extra_mol_capacity=extra, device=self.device)

        cutoff = float(self.state_a.pbc.cutoff)
        if not cfg.ewald_alpha_set:
            cfg.ewald_alpha = 3.5 / cutoff
        if not cfg.polar_ewald_alpha_set:
            cfg.polar_ewald_alpha = 3.5 / cutoff

        self.flags = cfg.to_flags()
        self.params = cfg.to_params()
        blocked = max(self.state_a.n_atom_slots,
                      self.state_b.n_atom_slots) > 1024 and \
            not dense_only(self.flags)
        self.opts = GibbsOptions(
            move_factor=cfg.move_factor, rot_factor=cfg.rot_factor,
            spinflip_probability=cfg.spinflip_probability,
            volume_probability=cfg.volume_probability,
            transfer_probability=cfg.transfer_probability,
            volume_change_factor=cfg.volume_change_factor,
            quantum_rotation=cfg.quantum_rotation,
            numsteps=cfg.numsteps,
            incremental=delta_mod.supports(self.flags),
            max_mol_atoms=max(moves.movable_window(self.state_a),
                              moves.movable_window(self.state_b)),
            blocked_energy=blocked)
        self.topologies = (topology(self.state_a), topology(self.state_b))
        self.avg = [AvgObservables(), AvgObservables()]
        self._run_chunk = make_gibbs_chunk_runner(
            self.flags, self.params, self.opts, cfg.corrtime,
            self.topologies)
        self._refresh = make_gibbs_refresher(self.flags, self.params,
                                             self.opts)
        self.seed = cfg.preset_seed if cfg.preset_seed_on else 0

    def _init_carry(self) -> GibbsCarry:
        return init_gibbs_carry(self.state_a, self.state_b, self.flags,
                                self.params, self.opts, self.seed,
                                self.cfg.temperature)

    def update_nodestats(self, carry: GibbsCarry) -> None:
        """The corrtime's acceptance statistics into both boxes'
        averages."""
        ns = nodestats_from_counters(carry.accept.cpu().numpy(),
                                     carry.reject.cpu().numpy(), 0.0)
        for i in range(2):
            self.avg[i].update_nodestats(ns)

    def corrtime_io(self, carry: GibbsCarry, step: int, fps=None) -> None:
        """Both boxes' observables into their averages, and into their
        energy logs ``fps`` where given."""
        cfg = self.cfg
        with tracing.span("corrtime_io"):
            T = float(carry.temperature)
            for i, (obs, st) in enumerate(
                    ((carry.obs_a, carry.state_a),
                     (carry.obs_b, carry.state_b))):
                obs = out_io.obs_to_dict(obs)
                self.avg[i].update(obs, ensemble=cfg.ensemble,
                                   temperature=cfg.temperature,
                                   volume=float(st.pbc.volume),
                                   particle_mass=moves.particle_mass(st),
                                   free_volume=cfg.free_volume,
                                   pressure=cfg.pressure, gibbs=False)
                if fps and fps[i]:
                    out_io.write_observables(fps[i], step, obs, T)

    def run(self):
        cfg = self.cfg
        carry = self._init_carry()
        fps = [out_io.open_energy_file(pqr_io.make_filename(
                   cfg.energy_output, i)) if out_io.live(cfg.energy_output)
               else None for i in range(2)]

        perf = out_io.PerformanceTimer(cfg.numsteps)
        self.corrtime_io(carry, 0, fps)
        step = 0
        while step < cfg.numsteps:
            n = min(cfg.corrtime, cfg.numsteps - step)
            runner = self._run_chunk if n == cfg.corrtime else \
                make_gibbs_chunk_runner(self.flags, self.params, self.opts,
                                        n, self.topologies)
            carry, _ = runner(carry)
            step += n
            if self.opts.incremental:
                carry = self._refresh(carry)
            self.update_nodestats(carry)
            self.corrtime_io(carry, step, fps)
            if not self.quiet:
                perf.report(step, self.out)
                for i in range(2):
                    out_io.display_averages(
                        self.avg[i], sys_id=f"_{i}",
                        temperature=float(carry.temperature),
                        ensemble=cfg.ensemble, out=self.out)

        for i, (st, meta) in enumerate(((carry.state_a, self.meta_a),
                                        (carry.state_b, self.meta_b))):
            if cfg.pqr_output != "/dev/null":
                pqr_io.write_state_pqr(
                    pqr_io.make_filename(cfg.pqr_output, i), st, meta,
                    wrapall=cfg.wrapall, long_output=cfg.long_output)
        pqr_io.drain()
        for f in fps:
            if f:
                f.close()
        self.carry = carry
        return self.avg
