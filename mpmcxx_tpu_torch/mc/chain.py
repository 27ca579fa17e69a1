"""The Metropolis Markov chain of the standard ensembles.

JAX twin: mpmcxx_tpu/mc/chain.py.  Ported: uVT (one sorbate or a
mixture), NVT, NPT and NVE (``make_step_fn``, chain.py:351-693), with
or without cavity-biased insertion and simulated annealing, with every
move of the twin: displacement, insertion, removal, the adiabatic
molecules' move, spin flips (quantum rotation), the volume move, and the
special moves' displacements (the 1-D anharmonic one, SPECTRE's with its
domain wrap and reject leak, GWP's with its widths), by molecule window
(``topology``) or by atom masks (``topology=None``, and always for the
adiabatic and special moves, as in the twin).  Each runs on the
evaluation branch the runner selects: the incremental polarization
cache with incremental Delta-E (polar_mixed), incremental pairwise
Delta-E (no polarization), or a full recompute of every proposal (the
float64 SCF, the many-body, crystal-sum and special moves' terms); full
recomputes are dense or in row blocks (``blocked_energy``).  The
incremental branches add the cavity_autoreject_absolute penalty of the
moved rows, and under simulated annealing the Feynman-Hibbs terms read
the chain's temperature (``_params_at``).  Also ``init_carry``,
``make_refresher``, ``accumulate_stats`` and ``make_chunk_runner``.  An
ensemble other than these four raises NotImplementedError naming it.

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
In uVT the step reads once per state layout whether any molecule is
adiabatic, and proposes the adiabatic move only if one is.

Two faults of the twin are kept, each for want of a feature it lacks:
no spin flip is ever accepted (the rotational partition functions stay
0, so their ratio is NaN), and feynman_kleinert drops the anharmonic
well's quantum correction (ops/pair_potentials.anharmonic).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import constants as const
from .. import random as rnd
from .. import tracing
from ..flags import FFlags, RunParams, require_supported
from ..ops import delta as delta_mod
from ..ops import polar_cache as pcache_mod
from ..ops.energy import (EnergyBreakdown, cavity_absolute_check,
                          energy_breakdown, energy_breakdown_blocked)
from ..ops.pairwise import build_pairs_rect
from ..parallel import meshing
from ..parallel.sharded_energy import sharded_breakdown
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


# the ensembles of the standard chain (the twin's _pick_movetype raises on
# any other)
_ENSEMBLES = (const.ENSEMBLE_UVT, const.ENSEMBLE_NVT, const.ENSEMBLE_NPT,
              const.ENSEMBLE_NVE)


def require_options(flags: FFlags, params: RunParams,
                    opts: MCOptions) -> None:
    """Raise NotImplementedError naming a flag or an ensemble outside the
    standard chain's range."""
    require_supported(flags, params)
    if opts.ensemble not in _ENSEMBLES:
        raise NotImplementedError(f"MCOptions.ensemble={opts.ensemble!r}")


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


def _spin_flips(opts: MCOptions) -> bool:
    """Whether the chain proposes spin flips (chain.py:256-260)."""
    return opts.quantum_rotation and opts.ensemble in (
        const.ENSEMBLE_UVT, const.ENSEMBLE_NVT, const.ENSEMBLE_NVE)


def _pick_movetype(opts: MCOptions, r, N_movable, n_adiabatic,
                   volume: bool):
    """Move selection per ensemble (do_checkpoint,
    src/System.MonteCarlo.cpp:318-454; chain.py:163-202) from the four
    uniforms ``r``: uVT, NVT and NVE on the device (a spin flip below
    spinflip_probability under quantum rotation); NPT's volume pick is
    the host's ``volume`` (see volume_steps)."""
    dev = r.device

    def spin_or_displace(u):
        if opts.quantum_rotation:
            return torch.where(u < opts.spinflip_probability,
                               const.MOVETYPE_SPINFLIP,
                               const.MOVETYPE_DISPLACE)
        return torch.full((), const.MOVETYPE_DISPLACE, dtype=torch.int64,
                          device=dev)

    if opts.ensemble == const.ENSEMBLE_NPT:
        mv = const.MOVETYPE_VOLUME if volume else const.MOVETYPE_DISPLACE
        return torch.full((), mv, dtype=torch.int64, device=dev)
    if opts.ensemble != const.ENSEMBLE_UVT:
        return spin_or_displace(r[0])
    disp = torch.where((n_adiabatic > 0) & (r[3] < 0.5),
                       const.MOVETYPE_ADIABATIC, const.MOVETYPE_DISPLACE)
    if opts.quantum_rotation:
        disp = torch.where(r[2] < opts.spinflip_probability,
                           const.MOVETYPE_SPINFLIP, disp)
    mv = torch.where(r[0] < opts.insert_probability,
                     torch.where(r[1] < 0.5, const.MOVETYPE_INSERT,
                                 const.MOVETYPE_REMOVE), disp)
    # never remove the last molecule (src/System.MonteCarlo.cpp:449-454)
    return torch.where((mv == const.MOVETYPE_REMOVE) & (N_movable <= 1),
                       spin_or_displace(r[2]), mv)


# columns of one step's draws (see chunk_draws); those from _U_ADIA on
# are made only with ``special``
_U_TARGET, _R_MOVE, _DICE, _AXIS, _U_ANGLE, _U_ACC = 0, 1, 5, 11, 14, 15
_U_PICK, _U_RM, _U_VOL, _U_SPEC = 16, 19, 20, 21
_U_ADIA, _SP_DICE, _U_1D_SIGN, _GWP = 22, 23, 29, 30


def step_keys(key: torch.Tensor, n: int, num: int = 6):
    """(the key after ``n`` steps, each step's split(key, num): [n, num,
    2]); the first of each split is the next step's key."""
    subs = []
    for _ in range(n):
        sub = rnd.split(key, num)
        key = sub[0]
        subs.append(sub)
    return key, torch.stack(subs)


def move_draws(k):
    """A whole-molecule move's draws from its keys ``k`` [n, 2]
    (moves.py:137-143, 189-213): split(k, 3) -> uniform (6,), normal
    (3,), uniform; [n, 10].  An insertion reads the first three uniforms
    as its position (the head of uniform(k, (6,)) under partitionable
    threefry)."""
    k3 = rnd.split(k, 3)
    return torch.cat([rnd.uniform(k3[:, 0], (6,)),
                      rnd.normal(k3[:, 1], (3,)),
                      rnd.uniform(k3[:, 2])[:, None]], dim=1)


def chunk_draws(key: torch.Tensor, n: int, special: bool = False):
    """The draws of ``n`` consecutive steps from the chain key, as the
    twin's step derives them (chain.py:352-353, 270, 291-302, 365-371,
    391, 420-422, moves.py:49, 67-73, 93-108, 155-157, 177, 251,
    274-283, 294-296, cavity.py:81, 93): returns (the key after the
    chunk, [n, 22] f64 on the host, or [n, 40] with ``special``, the
    [n, 2] dart keys).  Per step: split(key, 6) -> (next key, k_move,
    k_target, k_apply, k_acc, k_cav); the target uniform; four move-type
    uniforms from split(k_move, 4); with k1 = split(k_apply, 1)[0], from
    split(k1, 3) the move's six translation uniforms (an insertion reads
    the first three as its position: partitionable threefry makes
    uniform(k, (3,)) the head of uniform(k, (6,))), three normal axis
    components and the angle uniform; the acceptance uniform; from
    split(k_cav, 3) -> (k_grid, k_pick, k_rm) three uniforms of k_pick
    (the cavity pick reads the first, the fallback insert position all
    three) and the uniform of k_rm; the volume move's uniform(k1); the
    mixture's species uniform(fold_in(k_target, 2)).  With ``special``
    (uVT's adiabatic move and the special moves): the adiabatic target's
    uniform(fold_in(k_target, 1)); with (ka, kb) = split(k1), SPECTRE's
    six uniforms of ka (the anharmonic move reads the first as
    uniform(ka)), uniform(kb) (the anharmonic sign) and GWP's
    displacement draws of ka (split(ka, 3) as above).  k_grid is returned
    for the darts; the [A]-wide draws of kb are ``wide_draws``."""
    key, ks = step_keys(key, n)
    k_move, k_target, k_apply, k_acc = ks[:, 1], ks[:, 2], ks[:, 3], ks[:, 4]
    k_vol = rnd.split(k_apply, 1)[:, 0]
    k_cav = rnd.split(ks[:, 5], 3)                      # [n, 3, 2]
    cols = [
        rnd.uniform(k_target)[:, None],
        rnd.uniform(rnd.split(k_move, 4)),
        move_draws(k_vol),
        rnd.uniform(k_acc)[:, None],
        rnd.uniform(k_cav[:, 1], (3,)),
        rnd.uniform(k_cav[:, 2])[:, None],
        rnd.uniform(k_vol)[:, None],
        rnd.uniform(rnd.fold_in(k_target, 2))[:, None],
    ]
    if special:
        ka, kb = rnd.split(k_vol, 2).unbind(1)
        cols += [rnd.uniform(rnd.fold_in(k_target, 1))[:, None],
                 rnd.uniform(ka, (6,)), rnd.uniform(kb)[:, None],
                 move_draws(ka)]
    return key, torch.cat(cols, dim=1), k_cav[:, 0]


def wide_draws(key: torch.Tensor, n: int, A: int):
    """The [n, A] uniforms of ``n`` steps' kb = split(split(k_apply,
    1)[0])[1] (see chunk_draws): SPECTRE's charge deltas and GWP's width
    moves (moves.py:283, 294)."""
    _, ks = step_keys(key, n)
    k1 = rnd.split(ks[:, 3], 1)[:, 0]
    return rnd.uniform(rnd.split(k1, 2)[:, 1], (A,))


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
    state, chain.py:648-654): one plane-sized temporary at a time (one
    shard's rows on a mesh, on its device); the empty placeholders (the
    planes a mode does not hold, k-space without polar_ewald) stay as
    they are."""
    for f in dataclasses.fields(cache):
        t = getattr(cache, f.name)
        if t.numel():
            for part, new in zip(meshing.parts_of(t),
                                 meshing.parts_of(getattr(fresh, f.name))):
                part.copy_(torch.where(accept.to(part.device), new, part))
    return cache


def _params_at(flags: FFlags, base_params: RunParams, opts: MCOptions):
    """``params_at(T)``: the energy's RunParams at the chain temperature
    ``T`` (the twin's replace(base_params, temperature=carry.temperature),
    chain.py:355).  Only the Feynman-Hibbs terms read the temperature, and
    it leaves the base value only under simulated annealing."""
    if opts.simulated_annealing and flags.feynman_hibbs:
        return lambda T: dataclasses.replace(base_params, temperature=T)
    return lambda T: base_params


def make_step_fn(flags: FFlags, base_params: RunParams, opts: MCOptions,
                 topology=None):
    """Build ``step(carry, draws, dart_u=None, volume=False, wide=None) ->
    (carry, StepOut)`` for one move; ``draws`` is one row of chunk_draws
    on the state's device, ``dart_u`` the step's [darts, 3] uniforms when
    cavity bias is on, ``volume`` the host's NPT volume pick, ``wide`` the
    step's row of wide_draws under SPECTRE or GWP.  ``topology`` is the
    (mol_start[M], mol_natoms[M]) host pair of state.topology; without it
    every move works by atom masks (chain.py:272-305)."""
    require_options(flags, base_params, opts)
    params_at = _params_at(flags, base_params, opts)
    S = opts.max_mol_atoms
    uvt = opts.ensemble == const.ENSEMBLE_UVT
    spins = _spin_flips(opts)
    with_cache = opts.incremental and opts.polar_incremental
    mixture = opts.sorbate_count > 1 and bool(opts.insert_species)
    species_fug = opts.sorbate_count > 1 and bool(opts.type_fugacities)
    # the fields a move may change besides pos (chain.py:219-243)
    moved_fields = (("mol_alive", "aalive", "nuclear_spin") if uvt else
                    ("nuclear_spin",) if spins else ()) + \
        (("charge",) if opts.spectre else ()) + \
        (("gwp_alpha",) if opts.gwp else ())
    consts = {}   # device -> host tables on that device
    # cavity grid points per device; a volume move changes the box, so
    # NPT rebuilds them every step
    grid = {}
    adiabatic = {}   # mol_adiabatic tensor -> whether any is set

    def on(dev):
        if dev not in consts:
            consts[dev] = (
                None if topology is None else
                tuple(torch.as_tensor(t, dtype=torch.int64, device=dev)
                      for t in topology),
                torch.as_tensor(opts.insert_species, dtype=torch.int64,
                                device=dev),
                torch.as_tensor(opts.type_fugacities, dtype=torch.float64,
                                device=dev))
        return consts[dev]

    def rows_of(state, mol):
        if topology is None:
            return moves.mask_rows(state, mol, S)
        return moves.molecule_rows(*on(mol.device)[0], mol, S)

    def any_adiabatic(state) -> bool:
        """Whether a molecule slot is adiabatic: read from the device once
        per state layout (mol_adiabatic is static)."""
        t = state.mol_adiabatic
        if adiabatic.get("t") is not t:
            adiabatic["t"], adiabatic["any"] = t, bool(torch.any(t))
        return adiabatic["any"]

    def cavity_branch(carry: MCCarry, d, dart_u, is_ins, is_rem):
        """Cavity-biased insertion machinery (chain.py:373-414), in every
        ensemble: the grid is rebuilt before every move.  carry.cavity[0]
        is the per-step running mean of the open fraction, updated at the
        END of the step so the acceptance factor reads the PRIOR value;
        [1] the current dart volume; [2] the per-corrtime snapshot of [0]
        (advanced by make_refresher), read only by the REMOVE flag; [3]
        the checkpoint count.  Returns (cavity carry, biased, prior mean,
        insertion COM)."""
        state = carry.state
        dev = state.pos.device
        if dev not in grid or opts.ensemble == const.ENSEMBLE_NPT:
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

    def displacement(state, d, wide, target, rows):
        """The DISPLACE proposal (chain.py:273-305): the special moves'
        (by atom masks), else the molecule's window, or its atom masks
        without a topology."""
        dice, axis, angle = d[_DICE:_DICE + 6], d[_AXIS:_AXIS + 3], \
            d[_U_ANGLE]
        if opts.rd_anharmonic:
            return moves.displace_1d(state, d[_SP_DICE], d[_U_1D_SIGN],
                                     target, opts.move_factor)
        if opts.spectre:
            # the domain wrap after every SPECTRE move
            # (src/System.MonteCarlo.cpp:1183)
            moved = moves.spectre_displace(
                state, d[_SP_DICE:_SP_DICE + 6], wide, target,
                opts.move_factor, opts.spectre_max_charge,
                opts.spectre_max_target)
            return moves.spectre_wrapall(moved, opts.spectre_max_target)
        if opts.gwp:
            # GWP molecules move by gwp_probability and perturb their
            # widths (src/System.MonteCarlo.cpp:868-875)
            g = d[_GWP:_GWP + 10]
            has_gwp = torch.any((state.mol_id == target) & state.gwp_spin)
            scale = torch.where(has_gwp, torch.full_like(
                state.pbc.cutoff, opts.gwp_probability), opts.move_factor)
            moved = moves.displace(state, g[:6], g[6:9], g[9], target,
                                   scale, opts.rot_factor)
            widened = moves.displace_gwp(moved, wide, target,
                                         opts.gwp_probability)
            return moved.replace(gwp_alpha=torch.where(
                has_gwp, widened.gwp_alpha, moved.gwp_alpha))
        if topology is None:
            return moves.displace(state, dice, axis, angle, target,
                                  opts.move_factor, opts.rot_factor)
        return moves.displace_rows(state, dice, axis, angle, rows,
                                   rows >= 0, opts.move_factor,
                                   opts.rot_factor)

    def local_move(carry: MCCarry, d, wide, movetype, target, insert_com):
        """The proposal of a displacement, adiabatic move, spin flip,
        insertion or removal (chain.py:416-431), every possible one built
        and selected on the device: (new state, valid, target, rows,
        insertion slot)."""
        state = carry.state
        is_spin = movetype == const.MOVETYPE_SPINFLIP
        if not uvt:
            rows = rows_of(state, target)
            new = displacement(state, d, wide, target, rows)
            if spins:
                flip = moves.spinflip(state, target)
                new = state.replace(**{
                    f: torch.where(is_spin, getattr(flip, f),
                                   getattr(new, f))
                    for f in ("pos",) + moved_fields})
            return new, True, target, rows, None
        is_ins = movetype == const.MOVETYPE_INSERT
        is_rem = movetype == const.MOVETYPE_REMOVE
        is_disp = movetype == const.MOVETYPE_DISPLACE
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

        tmpl_rows = rows_of(state, target)
        slot_rows = rows_of(state, torch.clamp(insert_slot, min=0))
        if topology is None:
            ins, ins_valid = moves.insert(
                state, d[_DICE:_DICE + 3], d[_AXIS:_AXIS + 3], d[_U_ANGLE],
                target, insert_slot, com=insert_com)
        else:
            ins, ins_valid = moves.insert_rows(
                state, d[_DICE:_DICE + 3], d[_AXIS:_AXIS + 3], d[_U_ANGLE],
                tmpl_rows, slot_rows, tmpl_rows >= 0, insert_slot,
                insert_slot >= 0, com=insert_com)
        disp = displacement(state, d, wide, target, tmpl_rows)
        rem = moves.remove(state, target)
        pos = torch.where(is_ins, ins.pos,
                          torch.where(is_rem, state.pos, disp.pos))
        if any_adiabatic(state):
            # the adiabatic molecules' move: rotation factor 1
            # (chain.py:307-309)
            adia = moves.displace(state, d[_DICE:_DICE + 6],
                                  d[_AXIS:_AXIS + 3], d[_U_ANGLE], target,
                                  opts.adiabatic_probability, 1.0)
            pos = torch.where(movetype == const.MOVETYPE_ADIABATIC,
                              adia.pos, pos)
        spin = torch.where(is_ins, ins.nuclear_spin, state.nuclear_spin)
        if spins:
            spin = torch.where(is_spin, moves.spinflip(state,
                                                       target).nuclear_spin,
                               spin)
        new_state = state.replace(
            pos=pos,
            mol_alive=torch.where(is_ins, ins.mol_alive,
                                  torch.where(is_rem, rem.mol_alive,
                                              state.mol_alive)),
            aalive=torch.where(is_ins, ins.aalive,
                               torch.where(is_rem, rem.aalive,
                                           state.aalive)),
            nuclear_spin=spin,
            **{f: torch.where(is_disp, getattr(disp, f), getattr(state, f))
               for f in ("charge", "gwp_alpha") if f in moved_fields})
        valid = torch.where(is_ins, ins_valid, True)
        rows = torch.where(is_ins, slot_rows, tmpl_rows)
        return new_state, valid, target, rows, insert_slot

    def evaluate(carry: MCCarry, new_state, rows, volume: bool):
        """The proposal's energy (chain.py:434-580): (EnergyBreakdown, new
        state with its dipoles, SF cache, k-space energy, the polar
        cache's commit data or, after a volume move, its rebuild)."""
        state = carry.state
        params = params_at(carry.temperature)
        if volume or not opts.incremental:
            with tracing.span("step.full_recompute"):
                eb, sf, recip, fresh = _full_recompute(
                    new_state, flags, params, opts,
                    meshing.mesh_of(carry.pcache))
            if flags.polarization:
                # converged dipoles ride on the state (dipole/field logs)
                new_state = new_state.replace(mu=eb.mu)
            return eb, new_state, sf, recip, fresh
        with tracing.span("step.delta_e"):
            dres = delta_mod.delta_energy(state, new_state, rows, carry.sf,
                                          flags, params,
                                          recip_old=carry.recip_e)
            rd = carry.obs.rd_energy + dres.d_rd
            coul = carry.obs.coulombic_energy + dres.d_coul
            z = torch.zeros_like(rd)
            # the penalty of the moved rows' pairs (chain.py:460-466, 528)
            pen = cavity_absolute_check(
                new_state, build_pairs_rect(new_state, flags, rows),
                params) if flags.cavity_autoreject_absolute else z
        if not with_cache:
            eb = EnergyBreakdown(
                total=rd + coul, rd=rd, coulombic=coul, polarization=z,
                vdw=z, three_body=z, kinetic=z, mu=state.mu,
                polarization_iterations=z,
                iterator_failed=torch.zeros_like(z, dtype=torch.bool),
                dipole_rrms=z, cavity_penalty=pen)
            return eb, new_state, dres.sf_new, dres.recip_new, None
        # matrix-free proposal: the cached planes stay read-only here; the
        # commit writes them in place after the decision
        with tracing.span("step.polar"):
            pres, pcommit = pcache_mod.polar_proposal(
                carry.pcache, state, new_state, rows, flags, params,
                with_commit=True)
        eb = EnergyBreakdown(
            total=rd + coul + pres.energy, rd=rd, coulombic=coul,
            polarization=pres.energy, vdw=z, three_body=z, kinetic=z,
            mu=pres.mu, polarization_iterations=pres.iterations,
            iterator_failed=pres.iterator_failed,
            dipole_rrms=pres.dipole_rrms, cavity_penalty=pen)
        return (eb, new_state.replace(mu=pres.mu), dres.sf_new,
                dres.recip_new, pcommit)

    def step(carry: MCCarry, d, dart_u=None, volume=False, wide=None):
        state = carry.state
        T = carry.temperature
        with tracing.span("step.target"):
            target, N_movable = moves.pick_random_movable(state,
                                                          d[_U_TARGET])
            n_adiabatic = torch.sum(state.mol_alive & state.mol_adiabatic)
            movetype = _pick_movetype(opts, d[_R_MOVE:_R_MOVE + 4],
                                      N_movable, n_adiabatic, volume)
            if uvt and any_adiabatic(state):
                # ADIABATIC moves target the k-th live adiabatic molecule
                # (src/System.MonteCarlo.cpp:405-410; chain.py:365-371)
                ka = torch.floor(d[_U_ADIA] *
                                 torch.clamp(n_adiabatic, min=1))
                adia_target = moves.pick_kth_true(
                    state.mol_alive & state.mol_adiabatic,
                    ka.to(torch.int64))
                target = torch.where(movetype == const.MOVETYPE_ADIABATIC,
                                     adia_target, target)
            is_ins = movetype == const.MOVETYPE_INSERT
            is_rem = movetype == const.MOVETYPE_REMOVE
        if opts.cavity_bias:
            with tracing.span("step.cavity"):
                cavity, biased, cavity_prior, insert_com = cavity_branch(
                    carry, d, dart_u, is_ins, is_rem)
        else:
            cavity, cavity_prior, insert_com = carry.cavity, 0.0, None
            biased = torch.zeros_like(movetype, dtype=torch.bool)
        with tracing.span("step.move"):
            if volume:
                new_state = moves.volume_change(state, d[_U_VOL],
                                                opts.volume_change_factor)
                valid, rows, insert_slot = True, None, None
            else:
                new_state, valid, target, rows, insert_slot = local_move(
                    carry, d, wide, movetype, target, insert_com)
        eb, new_state, sf_new, recip_new, pnew = evaluate(
            carry, new_state, rows, volume)
        with tracing.span("step.accept"):
            final_energy = eb.total + eb.cavity_penalty
            obs_after = observables_from_breakdown(new_state, eb, flags,
                                                   base_params, opts.ensemble)
            delta = final_energy - carry.obs.energy
            t1 = target.reshape(1)
            # the spin flip's ratio of rotational partition functions: NaN
            # while they are 0, as the twin leaves them (fault kept)
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
                bf = metropolis.npt_factor(movetype, delta, T,
                                           base_params.pressure,
                                           state.pbc.volume,
                                           new_state.pbc.volume, obs_after.N)
            elif opts.ensemble == const.ENSEMBLE_NVE:
                bf = metropolis.nve_factor(base_params.total_energy,
                                           carry.obs.energy,
                                           final_energy, obs_after.N)
            else:
                bf = metropolis.nvt_factor(movetype, delta, T, pr)
            bf = torch.where(torch.isfinite(final_energy) & valid, bf, 0.0)
            accept = (d[_U_ACC] < bf) & ~eb.iterator_failed

            def sel(a, b):
                return torch.where(accept, a, b)

            changed = ("pos",) + (("mu",) if flags.polarization else ()) + \
                moved_fields
            state_out = state.replace(**{
                f: sel(getattr(new_state, f), getattr(state, f))
                for f in changed})
            if opts.spectre:
                # a rejected SPECTRE move keeps the renormalization shift it
                # gave the other SPECTRE sites (the reference's restore,
                # src/System.MonteCarlo.cpp:1559-1582; chain.py:627-635)
                state_out.charge = sel(new_state.charge,
                                       moves.spectre_reject_restore(
                                           state, new_state, target))
            if volume:
                state_out.pbc = PBC(**{
                    f.name: sel(getattr(new_state.pbc, f.name),
                                getattr(state.pbc, f.name))
                    for f in dataclasses.fields(PBC)})
            obs_out = Observables(**{
                f.name: sel(getattr(obs_after, f.name),
                            getattr(carry.obs, f.name))
                for f in dataclasses.fields(Observables)})
            sf_out = delta_mod.SFCache(sel(sf_new.re, carry.sf.re),
                                       sel(sf_new.im, carry.sf.im))
            if uvt and not volume:
                capacity_reject = is_ins & (insert_slot < 0)
            else:
                capacity_reject = torch.zeros_like(accept)
            if opts.simulated_annealing:
                T = sel(annealed_temperature(opts, T, carry.step), T)
            out = StepOut(boltzmann_factor=bf, accepted=accept,
                          movetype=movetype,
                          polarization_iterations=eb.polarization_iterations,
                          capacity_reject=capacity_reject, biased=biased)
            recip_out = sel(recip_new, carry.recip_e)
        pcache = carry.pcache
        if with_cache:
            with tracing.span("step.commit"):
                if volume:
                    pcache = _select_cache(pcache, accept, pnew)
                else:
                    # geometry-free commit from the proposal's own tables:
                    # on reject every write re-writes current content
                    pcache = pcache_mod.cache_commit(pcache, accept, pnew,
                                                     flags)
        return dataclasses.replace(
            carry, state=state_out, obs=obs_out, temperature=T,
            step=carry.step + 1, cavity=cavity, sf=sf_out,
            recip_e=recip_out, pcache=pcache), out

    step.any_adiabatic = any_adiabatic
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
        with tracing.span("draws"):
            special = opts.rd_anharmonic or opts.spectre or opts.gwp or (
                opts.ensemble == const.ENSEMBLE_UVT and
                step.any_adiabatic(carry.state))
            key, draws, k_grid = chunk_draws(carry.key, chunk_steps, special)
            volume = volume_steps(opts, draws, carry.state)
            draws = draws.to(dev)
            darts = wide = [None] * chunk_steps
            if opts.cavity_bias:
                # the twin's uniform(k_grid, (n_darts, 3)) of every step,
                # made on the device in one call (update_grid's 256 when
                # unset)
                n_darts = opts.cavity_darts if opts.cavity_darts > 0 else 256
                darts = rnd.uniform(k_grid.to(dev), (n_darts, 3))
            if opts.spectre or opts.gwp:
                wide = wide_draws(carry.key, chunk_steps,
                                  carry.state.n_atom_slots).to(dev)
        outs = []
        for i in range(chunk_steps):
            with tracing.span("step", move=True):
                carry, out = step(carry, draws[i], darts[i], volume[i],
                                  wide[i])
            outs.append(out)
        with tracing.span("stats"):
            outs = StepOut(*(torch.stack(col) for col in zip(*outs)))
            carry = dataclasses.replace(
                carry, key=key, stats=accumulate_stats(carry.stats, outs))
        return carry, outs

    return run_chunk


# the refresh's spans of its three parts (_full_recompute's ``spans``)
_REFRESH_SPANS = ("refresh.energy", "refresh.sf", "refresh.polar_cache")


def _full_recompute(state: SystemState, flags: FFlags, params: RunParams,
                    opts: MCOptions, mesh=None, spans=None):
    """(energy breakdown, SF cache, k-space energy, polar cache) of a full
    recompute of ``state``, with the caches the options carry
    (chain.py:789-851).  On a ``mesh`` the cache's planes are built row
    sharded, and the blocked energy is the sharded one
    (parallel/sharded_energy.py): no device builds the whole planes.
    ``spans`` names a span for each of the three parts."""
    energy_span, sf_span, cache_span = (
        (tracing.NOOP,) * 3 if spans is None else map(tracing.span, spans))
    with energy_span:
        if mesh is not None and opts.blocked_energy:
            eb = sharded_breakdown(state, flags, params, mesh)
        else:
            full_energy = (energy_breakdown_blocked if opts.blocked_energy
                           else energy_breakdown)
            eb = full_energy(state, flags, params)
    with sf_span:
        if opts.incremental and delta_mod.uses_recip(flags):
            sf = delta_mod.sf_compute(state, flags, params)
            recip_e = delta_mod.recip_energy(sf, state, flags, params)
        else:
            sf = delta_mod.empty_sf(state.pos.device)
            recip_e = torch.zeros_like(eb.total)
    with cache_span:
        pcache = (pcache_mod.cache_init(state, flags, params, mesh=mesh)
                  if opts.incremental and opts.polar_incremental else None)
    return eb, sf, recip_e, pcache


def init_carry(state: SystemState, flags: FFlags, params: RunParams,
               opts: MCOptions, seed: int, mesh=None) -> MCCarry:
    """Initial energy + carry (mc_initial_energy,
    src/System.MonteCarlo.cpp:158-173); on a ``mesh`` (leader: the
    state's device) the polar cache's planes are row-sharded, each shard
    building its own rows."""
    require_options(flags, params, opts)
    dev = state.pos.device
    with tracing.span("setup.init_carry"):
        eb, sf, recip_e, pcache = _full_recompute(state, flags, params,
                                                  opts, mesh)
        obs = observables_from_breakdown(state, eb, flags, params,
                                         opts.ensemble)
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
    (src/System.cpp:1284-1297), run every corrtime.  A carry whose cache
    is row-sharded is rebuilt on its mesh, each shard its own rows."""
    require_options(flags, base_params, opts)
    params_at = _params_at(flags, base_params, opts)

    def refresh(carry: MCCarry) -> MCCarry:
        with tracing.span("refresh"):
            state = carry.state
            params = params_at(carry.temperature)
            eb, sf, recip_e, pcache = _full_recompute(
                state, flags, params, opts, meshing.mesh_of(carry.pcache),
                spans=_REFRESH_SPANS)
            cavity = carry.cavity
            if opts.cavity_bias:
                # the corrtime tier the REMOVE flag reads: with one rank
                # update_root_nodestats runs at m=1, so avg_observables is
                # a snapshot of the per-step mean (chain.py:852-863)
                c = carry.cavity
                cavity = torch.stack([c[0], c[1], c[0], c[3] + 1.0])
            return dataclasses.replace(
                carry,
                obs=observables_from_breakdown(state, eb, flags, params,
                                               opts.ensemble),
                sf=sf, recip_e=recip_e, pcache=pcache, cavity=cavity)

    return refresh
