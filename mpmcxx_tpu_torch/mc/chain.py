"""The Metropolis Markov chain of the standard ensembles.

JAX twin: mpmcxx_tpu/mc/chain.py.  Ported: uVT (one sorbate or a
mixture, with or without cavity-biased insertion), NVT, NPT and NVE
(``make_step_fn``, chain.py:351-693), with or without simulated
annealing, each on the evaluation branch the runner selects: the
incremental polarization cache with incremental
Delta-E (polar_mixed), incremental LJ/Ewald Delta-E (no polarization), or
a full recompute of every proposal (the float64 SCF); full recomputes are
dense or in row blocks (``blocked_energy``).  Also ``init_carry``,
``make_refresher``, ``accumulate_stats`` and ``make_chunk_runner``.  Any
other option raises NotImplementedError naming it.

The twin's chunk is a jitted ``lax.scan``; here it is a host loop over
``step``.  The loop never waits on the device: the random draws of the
whole chunk are derived from the carried key on the host up front
(``chunk_draws``, key for key as the twin's ``jax.random`` calls; the
cavity bias's darts are made from host-derived keys on the device in one
batched call per chunk), every data-dependent choice is a device-side
select, and the polarization cache is committed in place.  The one
choice made on the host is NPT's volume pick: N is constant in NPT, so
the twin's pick reads only the draws and a count taken once per chunk,
and a volume move (a full O(A^2) recompute) runs only where it is picked.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import constants as const
from .. import random as rnd
from ..flags import FFlags, RunParams, require_supported
from ..ops import delta as delta_mod
from ..ops import polar_cache as pcache_mod
from ..ops.energy import (EnergyBreakdown, energy_breakdown,
                          energy_breakdown_blocked)
from ..pbc import PBC
from ..state import Observables, SystemState
from . import cavity as cavity_mod
from . import metropolis, moves


@dataclasses.dataclass(frozen=True)
class MCOptions:
    """Static MC controls (the twin's fields; see require_options for the
    values the port takes)."""
    ensemble: int = const.ENSEMBLE_NVT
    move_factor: float = 1.0
    rot_factor: float = 1.0
    insert_probability: float = 0.0
    spinflip_probability: float = 0.0
    adiabatic_probability: float = 0.0
    volume_probability: float = 0.0
    volume_change_factor: float = 0.25
    fugacity: float = 0.0          # atm
    sorbate_count: int = 1
    # mixtures: insertion species (mol_type indices) drawn uniformly, and
    # mol_type index -> fugacity (atm) for the per-species factors
    insert_species: tuple = ()
    type_fugacities: tuple = ()
    quantum_rotation: bool = False
    simulated_annealing: bool = False
    simulated_annealing_linear: bool = False
    simulated_annealing_schedule: float = 0.0
    simulated_annealing_target: float = 0.0
    numsteps: int = 0
    cavity_bias: bool = False
    cavity_grid_size: int = 0
    cavity_radius: float = 0.0
    cavity_darts: int = 0
    spectre: bool = False
    spectre_max_charge: float = 0.0
    spectre_max_target: float = 0.0
    rd_anharmonic: bool = False
    gwp: bool = False
    gwp_probability: float = 0.0
    incremental: bool = False
    max_mol_atoms: int = 1
    polar_incremental: bool = False
    blocked_energy: bool = False


# MCOptions fields that select a branch, and the values the port has
_PORTED_OPTS = {
    "ensemble": (const.ENSEMBLE_UVT, const.ENSEMBLE_NVT, const.ENSEMBLE_NPT,
                 const.ENSEMBLE_NVE),
    "quantum_rotation": (False,),
    "spectre": (False,),
    "rd_anharmonic": (False,),
    "gwp": (False,),
}


def require_options(flags: FFlags, params: RunParams,
                    opts: MCOptions) -> None:
    """Raise NotImplementedError naming the first option the port has no
    branch for."""
    require_supported(flags, params)
    for name, ok in _PORTED_OPTS.items():
        v = getattr(opts, name)
        if v not in ok:
            raise NotImplementedError(f"MCOptions.{name}={v!r}")
    if opts.cavity_bias and opts.ensemble != const.ENSEMBLE_UVT:
        raise NotImplementedError("MCOptions.cavity_bias=True outside uVT")


class NodeStats(NamedTuple):
    accept: torch.Tensor            # [7] int64 per-movetype accept counts
    reject: torch.Tensor            # [7]
    boltzmann_factor: torch.Tensor  # last BF


@dataclasses.dataclass
class MCCarry:
    state: SystemState
    obs: Observables
    temperature: torch.Tensor      # 0-d f64
    key: torch.Tensor              # [2] int64 random key, on the host
    step: torch.Tensor             # 0-d int64
    stats: NodeStats
    cavity: torch.Tensor           # [4] cavity bias: per-step mean open
                                   # fraction, dart volume, corrtime
                                   # snapshot of the mean, checkpoint
                                   # count (chain.py:373-387)
    sf: delta_mod.SFCache          # Ewald structure-factor cache ([0]
                                   # off the incremental path)
    recip_e: torch.Tensor          # current state's k-space energy
    pcache: Optional[pcache_mod.PolarCache]  # incremental polarization
                                   # cache (None off that path)


class StepOut(NamedTuple):
    boltzmann_factor: torch.Tensor
    accepted: torch.Tensor
    movetype: torch.Tensor
    polarization_iterations: torch.Tensor
    capacity_reject: torch.Tensor
    biased: torch.Tensor    # the factor was the cavity-biased one (the
                            # port's own column; the twin keeps it inside)


def observables_from_breakdown(state: SystemState, eb: EnergyBreakdown,
                               flags: FFlags, params: RunParams,
                               ensemble: int) -> Observables:
    """The observables updates inside System::energy()
    (src/System.Energy.cpp:150-163); NVE's kinetic energy and temperature
    from the fixed total (chain.py:155-159)."""
    N = state.count_N().to(torch.float64)
    N_safe = torch.where(N == 0, 1.0, N)
    spin = state.spin_ratio_sum() / N_safe
    mol_mass = torch.where(state.mol_alive, state.mol_mass, 0.0)
    fixed = state.mol_frozen | state.mol_adiabatic
    z = torch.zeros_like(eb.total)
    kin, temp = eb.kinetic, z
    if ensemble == const.ENSEMBLE_NVE:
        kin = params.total_energy - eb.total
        temp = (2.0 / 3.0) * kin / N_safe
    return Observables(
        energy=eb.total, coulombic_energy=eb.coulombic, rd_energy=eb.rd,
        polarization_energy=eb.polarization, vdw_energy=eb.vdw,
        three_body_energy=eb.three_body, dipole_rrms=eb.dipole_rrms,
        kinetic_energy=kin, temperature=temp, volume=state.pbc.volume,
        N=N, NU=N * eb.total, spin_ratio=spin,
        frozen_mass=torch.sum(torch.where(fixed, mol_mass, 0.0)),
        total_mass=torch.sum(mol_mass))


def _pick_movetype(opts: MCOptions, r, N_movable, n_adiabatic,
                   volume: bool):
    """Move selection per ensemble (do_checkpoint,
    src/System.MonteCarlo.cpp:318-454; chain.py:163-202) from the four
    uniforms ``r``: uVT on the device; NVT and NVE always displace; NPT's
    volume pick is the host's ``volume`` (see volume_steps)."""
    if opts.ensemble != const.ENSEMBLE_UVT:
        mv = const.MOVETYPE_VOLUME if volume else const.MOVETYPE_DISPLACE
        return torch.full((), mv, dtype=torch.int64, device=r.device)
    disp = torch.where((n_adiabatic > 0) & (r[3] < 0.5),
                       const.MOVETYPE_ADIABATIC, const.MOVETYPE_DISPLACE)
    mv = torch.where(r[0] < opts.insert_probability,
                     torch.where(r[1] < 0.5, const.MOVETYPE_INSERT,
                                 const.MOVETYPE_REMOVE), disp)
    # never remove the last molecule (src/System.MonteCarlo.cpp:449-454)
    return torch.where((mv == const.MOVETYPE_REMOVE) & (N_movable <= 1),
                       const.MOVETYPE_DISPLACE, mv)


# columns of one step's draws (see chunk_draws)
_U_TARGET, _R_MOVE, _DICE, _AXIS, _U_ANGLE, _U_ACC = 0, 1, 5, 11, 14, 15
_U_PICK, _U_RM, _U_VOL, _U_SPEC = 16, 19, 20, 21


def chunk_draws(key: torch.Tensor, n: int):
    """The draws of ``n`` consecutive steps from the chain key, as the
    twin's step derives them (chain.py:352-353, 270, 391, 420-422,
    moves.py:49, 67-73, 93-108, 177, 251, cavity.py:81, 93): returns (the
    key after the chunk, [n, 22] f64 on the host, the [n, 2] dart keys).
    Per step: split(key, 6) -> (next key, k_move, k_target, k_apply,
    k_acc, k_cav); the target uniform; four move-type uniforms from
    split(k_move, 4); with k1 = split(k_apply, 1)[0], from split(k1, 3)
    the move's six translation uniforms (an insertion reads the first
    three as its position: partitionable threefry makes uniform(k, (3,))
    the head of uniform(k, (6,))), three normal axis components and the
    angle uniform; the acceptance uniform; from split(k_cav, 3) ->
    (k_grid, k_pick, k_rm) three uniforms of k_pick (the cavity pick reads
    the first, the fallback insert position all three) and the uniform of
    k_rm; the volume move's uniform(k1); and the mixture's species
    uniform(fold_in(k_target, 2)).  k_grid is returned for the darts."""
    subs = []
    for _ in range(n):
        sub = rnd.split(key, 6)
        key = sub[0]
        subs.append(sub)
    ks = torch.stack(subs)                              # [n, 6, 2]
    k_move, k_target, k_apply, k_acc = ks[:, 1], ks[:, 2], ks[:, 3], ks[:, 4]
    k_vol = rnd.split(k_apply, 1)[:, 0]
    k1 = rnd.split(k_vol, 3)                            # [n, 3, 2]
    k_cav = rnd.split(ks[:, 5], 3)                      # [n, 3, 2]
    draws = torch.cat([
        rnd.uniform(k_target)[:, None],
        rnd.uniform(rnd.split(k_move, 4)),
        rnd.uniform(k1[:, 0], (6,)),
        rnd.normal(k1[:, 1], (3,)),
        rnd.uniform(k1[:, 2])[:, None],
        rnd.uniform(k_acc)[:, None],
        rnd.uniform(k_cav[:, 1], (3,)),
        rnd.uniform(k_cav[:, 2])[:, None],
        rnd.uniform(k_vol)[:, None],
        rnd.uniform(rnd.fold_in(k_target, 2))[:, None],
    ], dim=1)
    return key, draws, k_cav[:, 0]


def volume_steps(opts: MCOptions, draws, state: SystemState) -> list:
    """Which of a chunk's steps are NPT volume moves (chain.py:196-201),
    from the host draws: ``r1 < volume_probability``, or ``< 1/N`` when
    it is 0.  N, the movable molecules, is constant in NPT; reading it
    waits on the device once per chunk."""
    if opts.ensemble != const.ENSEMBLE_NPT:
        return [False] * draws.shape[0]
    thr = opts.volume_probability
    if thr == 0.0:
        thr = 1.0 / max(int(moves.movable_mask(state).sum()), 1)
    return (draws[:, _R_MOVE] < thr).tolist()


def annealed_temperature(opts, T, step):
    """Simulated annealing's temperature after an accepted move
    (src/System.MonteCarlo.cpp:74-85; chain.py:663-674): linear toward the
    target over the steps left after ``step``, or geometric by the
    schedule.  ``opts`` carries the simulated_annealing_* fields and
    numsteps; ``T`` and ``step`` are device scalars."""
    tgt = opts.simulated_annealing_target
    if opts.simulated_annealing_linear:
        remaining = torch.clamp(opts.numsteps - step - 1, min=0)
        return torch.where(remaining == 0, tgt,
                           T + (tgt - T) / torch.clamp(remaining, min=1))
    return tgt + (T - tgt) * opts.simulated_annealing_schedule


def _select_cache(cache: pcache_mod.PolarCache, accept,
                  fresh: pcache_mod.PolarCache) -> pcache_mod.PolarCache:
    """The cache of the selected state after a volume move, written into
    ``cache``'s tensors in place (the twin's cache_init of the selected
    state, chain.py:648-654): one plane-sized temporary at a time."""
    for f in dataclasses.fields(cache):
        t = getattr(cache, f.name)
        t.copy_(torch.where(accept, getattr(fresh, f.name), t))
    return cache


def make_step_fn(flags: FFlags, base_params: RunParams, opts: MCOptions,
                 topology=None):
    """Build ``step(carry, draws, dart_u=None, volume=False) -> (carry,
    StepOut)`` for one move; ``draws`` is one row of chunk_draws on the
    state's device, ``dart_u`` the step's [darts, 3] uniforms when cavity
    bias is on, ``volume`` the host's NPT volume pick.  ``topology`` is
    the (mol_start[M], mol_natoms[M]) host pair of state.topology."""
    require_options(flags, base_params, opts)
    if topology is None:
        raise NotImplementedError("topology=None (masked, non-window moves)")
    params = base_params
    S = opts.max_mol_atoms
    uvt = opts.ensemble == const.ENSEMBLE_UVT
    with_cache = opts.incremental and opts.polar_incremental
    mixture = opts.sorbate_count > 1 and bool(opts.insert_species)
    species_fug = opts.sorbate_count > 1 and bool(opts.type_fugacities)
    consts = {}   # device -> host tables on that device
    # cavity grid points per device: cavity bias is uVT-only
    # (require_options) and uVT never changes the box, so no volume move
    # can leave them stale
    grid = {}

    def on(dev):
        if dev not in consts:
            consts[dev] = (
                tuple(torch.as_tensor(t, dtype=torch.int64, device=dev)
                      for t in topology),
                torch.as_tensor(opts.insert_species, dtype=torch.int64,
                                device=dev),
                torch.as_tensor(opts.type_fugacities, dtype=torch.float64,
                                device=dev))
        return consts[dev]

    def rows_of(mol):
        return moves.molecule_rows(*on(mol.device)[0], mol, S)

    def cavity_branch(carry: MCCarry, d, dart_u, is_ins, is_rem):
        """Cavity-biased insertion machinery (chain.py:373-414): the grid
        is rebuilt before every move.  carry.cavity[0] is the per-step
        running mean of the open fraction, updated at the END of the step
        so the acceptance factor reads the PRIOR value; [1] the current
        dart volume; [2] the per-corrtime snapshot of [0] (advanced by
        make_refresher), read only by the REMOVE flag; [3] the
        checkpoint count.  Returns (cavity carry, biased, prior mean,
        insertion COM)."""
        state = carry.state
        dev = state.pos.device
        if dev not in grid:
            grid[dev] = cavity_mod.grid_points(state, opts.cavity_grid_size)
        info = cavity_mod.update_grid(state, opts.cavity_grid_size,
                                      opts.cavity_radius, dart_u,
                                      points=grid[dev])
        ins_com, any_open = cavity_mod.biased_insert_position(info,
                                                              d[_U_PICK])
        step_f = carry.step.to(torch.float64)
        prior = carry.cavity[0]
        avg_prob = (prior * step_f + info.probability) / (step_f + 1.0)
        cavity = torch.stack([avg_prob, info.volume, carry.cavity[2],
                              carry.cavity[3]])
        rm_flag = cavity_mod.remove_biased_flag(
            d[_U_RM], carry.cavity[2], opts.cavity_grid_size)
        biased = torch.where(is_ins, any_open, is_rem & rm_flag)
        insert_com = torch.where(any_open, ins_com,
                                 moves.random_cell_position(
                                     state, d[_U_PICK:_U_PICK + 3]))
        return cavity, biased, prior, insert_com

    def local_move(carry: MCCarry, d, dart_u, movetype, target):
        """The proposal of a displacement, insertion or removal
        (chain.py:416-431): (new state, valid, target, rows, cavity carry,
        biased, prior cavity mean, insertion slot)."""
        state = carry.state
        disp_of = lambda rows: moves.displace_rows(
            state, d[_DICE:_DICE + 6], d[_AXIS:_AXIS + 3], d[_U_ANGLE],
            rows, rows >= 0, opts.move_factor, opts.rot_factor)
        no = torch.zeros((), dtype=torch.bool, device=state.pos.device)
        if not uvt:
            rows = rows_of(target)
            return (disp_of(rows), True, target, rows, carry.cavity, no,
                    0.0, None)
        is_ins = movetype == const.MOVETYPE_INSERT
        is_rem = movetype == const.MOVETYPE_REMOVE
        if opts.cavity_bias:
            cavity, biased, cavity_prior, insert_com = cavity_branch(
                carry, d, dart_u, is_ins, is_rem)
        else:
            cavity, biased, cavity_prior, insert_com = \
                carry.cavity, no, 0.0, None
        if mixture:
            # draw the insertion species; its dead slot doubles as the
            # geometry template (slots keep their species geometry)
            species = on(state.pos.device)[1]
            si = torch.floor(d[_U_SPEC] * opts.sorbate_count).to(torch.int64)
            insert_slot = moves.find_dead_slot(
                state, species.index_select(0, si.reshape(1))[0])
            target = torch.where(is_ins, torch.clamp(insert_slot, min=0),
                                 target)
        else:
            insert_slot = moves.find_dead_slot(
                state, state.mol_type.index_select(0, target.reshape(1))[0])

        # every branch of the twin's lax.switch, selected on the device
        tmpl_rows = rows_of(target)
        disp = disp_of(tmpl_rows)
        slot_rows = rows_of(torch.clamp(insert_slot, min=0))
        ins, ins_valid = moves.insert_rows(
            state, d[_DICE:_DICE + 3], d[_AXIS:_AXIS + 3], d[_U_ANGLE],
            tmpl_rows, slot_rows, tmpl_rows >= 0, insert_slot,
            insert_slot >= 0, com=insert_com)
        rem = moves.remove(state, target)
        new_state = state.replace(
            pos=torch.where(is_ins, ins.pos,
                            torch.where(is_rem, state.pos, disp.pos)),
            mol_alive=torch.where(is_ins, ins.mol_alive,
                                  torch.where(is_rem, rem.mol_alive,
                                              state.mol_alive)),
            aalive=torch.where(is_ins, ins.aalive,
                               torch.where(is_rem, rem.aalive,
                                           state.aalive)),
            nuclear_spin=torch.where(is_ins, ins.nuclear_spin,
                                     state.nuclear_spin))
        valid = torch.where(is_ins, ins_valid, True)
        rows = torch.where(is_ins, slot_rows, tmpl_rows)
        return (new_state, valid, target, rows, cavity, biased, cavity_prior,
                insert_slot)

    def evaluate(carry: MCCarry, new_state, rows, volume: bool):
        """The proposal's energy (chain.py:434-580): (EnergyBreakdown, new
        state with its dipoles, SF cache, k-space energy, the polar
        cache's commit data or, after a volume move, its rebuild)."""
        state = carry.state
        if volume or not opts.incremental:
            eb, sf, recip, fresh = _full_recompute(new_state, flags, params,
                                                   opts)
            if flags.polarization:
                # converged dipoles ride on the state (dipole/field logs)
                new_state = new_state.replace(mu=eb.mu)
            return eb, new_state, sf, recip, fresh
        dres = delta_mod.delta_energy(state, new_state, rows, carry.sf,
                                      flags, params, recip_old=carry.recip_e)
        rd = carry.obs.rd_energy + dres.d_rd
        coul = carry.obs.coulombic_energy + dres.d_coul
        z = torch.zeros_like(rd)
        if not with_cache:
            eb = EnergyBreakdown(
                total=rd + coul, rd=rd, coulombic=coul, polarization=z,
                vdw=z, three_body=z, kinetic=z, mu=state.mu,
                polarization_iterations=z,
                iterator_failed=torch.zeros_like(z, dtype=torch.bool),
                dipole_rrms=z, cavity_penalty=z)
            return eb, new_state, dres.sf_new, dres.recip_new, None
        # matrix-free proposal: the cached planes stay read-only here; the
        # commit writes them in place after the decision
        pres, pcommit = pcache_mod.polar_proposal(
            carry.pcache, state, new_state, rows, flags, params,
            with_commit=True)
        eb = EnergyBreakdown(
            total=rd + coul + pres.energy, rd=rd, coulombic=coul,
            polarization=pres.energy, vdw=z, three_body=z, kinetic=z,
            mu=pres.mu, polarization_iterations=pres.iterations,
            iterator_failed=pres.iterator_failed,
            dipole_rrms=pres.dipole_rrms, cavity_penalty=z)
        return (eb, new_state.replace(mu=pres.mu), dres.sf_new,
                dres.recip_new, pcommit)

    def step(carry: MCCarry, d, dart_u=None, volume=False):
        state = carry.state
        T = carry.temperature
        target, N_movable = moves.pick_random_movable(state, d[_U_TARGET])
        n_adiabatic = torch.sum(state.mol_alive & state.mol_adiabatic)
        movetype = _pick_movetype(opts, d[_R_MOVE:_R_MOVE + 4], N_movable,
                                  n_adiabatic, volume)
        if volume:
            new_state = moves.volume_change(state, d[_U_VOL],
                                            opts.volume_change_factor)
            valid, rows, cavity = True, None, carry.cavity
            biased = torch.zeros_like(movetype, dtype=torch.bool)
        else:
            (new_state, valid, target, rows, cavity, biased, cavity_prior,
             insert_slot) = local_move(carry, d, dart_u, movetype, target)
        eb, new_state, sf_new, recip_new, pnew = evaluate(
            carry, new_state, rows, volume)

        final_energy = eb.total + eb.cavity_penalty
        obs_after = observables_from_breakdown(new_state, eb, flags, params,
                                               opts.ensemble)
        delta = final_energy - carry.obs.energy
        t1 = target.reshape(1)
        pr = metropolis.spin_partfunc_ratio(
            new_state.nuclear_spin.index_select(0, t1)[0],
            state.rot_partfunc_g.index_select(0, t1)[0],
            state.rot_partfunc_u.index_select(0, t1)[0]) \
            if opts.ensemble in (const.ENSEMBLE_UVT, const.ENSEMBLE_NVT) \
            else None
        if uvt:
            fug = opts.fugacity
            if species_fug:
                # INSERT's target is the slot of the drawn species,
                # REMOVE's the removed molecule (chain.py:596-605)
                tf = on(state.pos.device)[2]
                mt = state.mol_type.index_select(0, t1).clamp(
                    0, len(opts.type_fugacities) - 1)
                fug = tf.index_select(0, mt)[0]
            bf = metropolis.uvt_factor(
                movetype, delta, T, state.pbc.volume, fug, obs_after.N,
                float(opts.sorbate_count), biased, cavity[1], cavity_prior,
                pr)
        elif opts.ensemble == const.ENSEMBLE_NPT:
            bf = metropolis.npt_factor(movetype, delta, T, params.pressure,
                                       state.pbc.volume,
                                       new_state.pbc.volume, obs_after.N)
        elif opts.ensemble == const.ENSEMBLE_NVE:
            bf = metropolis.nve_factor(params.total_energy, carry.obs.energy,
                                       final_energy, obs_after.N)
        else:
            bf = metropolis.nvt_factor(movetype, delta, T, pr)
        bf = torch.where(torch.isfinite(final_energy) & valid, bf, 0.0)
        accept = (d[_U_ACC] < bf) & ~eb.iterator_failed

        def sel(a, b):
            return torch.where(accept, a, b)

        changed = ("pos",) + (("mu",) if flags.polarization else ()) + (
            ("mol_alive", "aalive", "nuclear_spin") if uvt else ())
        state_out = state.replace(**{
            f: sel(getattr(new_state, f), getattr(state, f))
            for f in changed})
        if volume:
            state_out.pbc = PBC(**{
                f.name: sel(getattr(new_state.pbc, f.name),
                            getattr(state.pbc, f.name))
                for f in dataclasses.fields(PBC)})
        obs_out = Observables(**{
            f.name: sel(getattr(obs_after, f.name), getattr(carry.obs, f.name))
            for f in dataclasses.fields(Observables)})
        sf_out = delta_mod.SFCache(sel(sf_new.re, carry.sf.re),
                                   sel(sf_new.im, carry.sf.im))
        pcache = carry.pcache
        if with_cache and volume:
            pcache = _select_cache(pcache, accept, pnew)
        elif with_cache:
            # geometry-free commit from the proposal's own tables: on
            # reject every write re-writes current content
            pcache = pcache_mod.cache_commit(pcache, accept, pnew, flags)
        if uvt:
            capacity_reject = (movetype == const.MOVETYPE_INSERT) & \
                (insert_slot < 0)
        else:
            capacity_reject = torch.zeros_like(accept)
        if opts.simulated_annealing:
            T = sel(annealed_temperature(opts, T, carry.step), T)
        out = StepOut(boltzmann_factor=bf, accepted=accept,
                      movetype=movetype,
                      polarization_iterations=eb.polarization_iterations,
                      capacity_reject=capacity_reject, biased=biased)
        return dataclasses.replace(
            carry, state=state_out, obs=obs_out, temperature=T,
            step=carry.step + 1,
            cavity=cavity, sf=sf_out, recip_e=sel(recip_new, carry.recip_e),
            pcache=pcache), out

    return step


def accumulate_stats(stats: NodeStats, outs: StepOut) -> NodeStats:
    """Fold a chunk's StepOut columns into NodeStats."""
    hist = torch.nn.functional.one_hot(outs.movetype, 7)
    acc = torch.sum(hist * outs.accepted[:, None].to(torch.int64), dim=0)
    return NodeStats(accept=stats.accept + acc,
                     reject=stats.reject + (torch.sum(hist, dim=0) - acc),
                     boltzmann_factor=outs.boltzmann_factor[-1])


def make_chunk_runner(flags: FFlags, params: RunParams, opts: MCOptions,
                      chunk_steps: int, topology=None):
    """``run_chunk(carry) -> (carry, StepOut of [chunk_steps] tensors)``:
    a host loop over ``chunk_steps`` steps.  The carry's polarization
    planes are updated in place; the carry passed in must not be reused."""
    step = make_step_fn(flags, params, opts, topology=topology)

    def run_chunk(carry: MCCarry):
        dev = carry.state.pos.device
        key, draws, k_grid = chunk_draws(carry.key, chunk_steps)
        volume = volume_steps(opts, draws, carry.state)
        draws = draws.to(dev)
        darts = [None] * chunk_steps
        if opts.cavity_bias:
            # the twin's uniform(k_grid, (n_darts, 3)) of every step, made
            # on the device in one call (update_grid's 256 when unset)
            n_darts = opts.cavity_darts if opts.cavity_darts > 0 else 256
            darts = rnd.uniform(k_grid.to(dev), (n_darts, 3))
        outs = []
        for i in range(chunk_steps):
            carry, out = step(carry, draws[i], darts[i], volume[i])
            outs.append(out)
        outs = StepOut(*(torch.stack(col) for col in zip(*outs)))
        carry = dataclasses.replace(
            carry, key=key, stats=accumulate_stats(carry.stats, outs))
        return carry, outs

    return run_chunk


def _full_recompute(state: SystemState, flags: FFlags, params: RunParams,
                    opts: MCOptions):
    """(energy breakdown, SF cache, k-space energy, polar cache) of a full
    recompute of ``state``, with the caches the options carry
    (chain.py:789-851)."""
    full_energy = (energy_breakdown_blocked if opts.blocked_energy
                   else energy_breakdown)
    eb = full_energy(state, flags, params)
    if opts.incremental and delta_mod.uses_recip(flags):
        sf = delta_mod.sf_compute(state, flags, params)
        recip_e = delta_mod.recip_energy(sf, state, flags, params)
    else:
        sf = delta_mod.empty_sf(state.pos.device)
        recip_e = torch.zeros_like(eb.total)
    pcache = (pcache_mod.cache_init(state, flags, params)
              if opts.incremental and opts.polar_incremental else None)
    return eb, sf, recip_e, pcache


def init_carry(state: SystemState, flags: FFlags, params: RunParams,
               opts: MCOptions, seed: int) -> MCCarry:
    """Initial energy + carry (mc_initial_energy,
    src/System.MonteCarlo.cpp:158-173)."""
    require_options(flags, params, opts)
    if bool(torch.any(state.mol_adiabatic)):
        raise NotImplementedError("adiabatic molecules")
    dev = state.pos.device
    eb, sf, recip_e, pcache = _full_recompute(state, flags, params, opts)
    obs = observables_from_breakdown(state, eb, flags, params, opts.ensemble)
    obs = dataclasses.replace(obs, energy=torch.where(
        torch.isfinite(obs.energy), obs.energy, const.MAXVALUE))
    zeros7 = torch.zeros(7, dtype=torch.int64, device=dev)
    z = torch.zeros((), dtype=torch.float64, device=dev)
    return MCCarry(
        state=state, obs=obs,
        temperature=torch.tensor(params.temperature, dtype=torch.float64,
                                 device=dev),
        key=rnd.PRNGKey(seed),
        step=torch.zeros((), dtype=torch.int64, device=dev),
        stats=NodeStats(zeros7, zeros7, z),
        cavity=torch.zeros(4, dtype=torch.float64, device=dev),
        sf=sf, recip_e=recip_e, pcache=pcache)


def make_refresher(flags: FFlags, base_params: RunParams, opts: MCOptions):
    """Full recompute of observables, the structure-factor cache and the
    polarization cache: the drift control of flag_all_pairs
    (src/System.cpp:1284-1297), run every corrtime."""
    require_options(flags, base_params, opts)
    params = base_params

    def refresh(carry: MCCarry) -> MCCarry:
        state = carry.state
        eb, sf, recip_e, pcache = _full_recompute(state, flags, params, opts)
        cavity = carry.cavity
        if opts.cavity_bias:
            # the corrtime tier the REMOVE flag reads: with one rank
            # update_root_nodestats runs at m=1, so avg_observables is a
            # snapshot of the per-step mean (chain.py:852-863)
            c = carry.cavity
            cavity = torch.stack([c[0], c[1], c[0], c[3] + 1.0])
        return dataclasses.replace(
            carry,
            obs=observables_from_breakdown(state, eb, flags, params,
                                           opts.ensemble),
            sf=sf, recip_e=recip_e, pcache=pcache, cavity=cavity)

    return refresh
