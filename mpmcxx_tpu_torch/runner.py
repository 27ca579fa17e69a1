"""Simulation controller: config -> state -> Markov chain -> outputs.

JAX twin: mpmcxx_tpu/runner.py (``Simulation`` with ``apply_state_fixups``,
``capacity_opts``, capacity regrowth, the corrtime loop and the
row-sharded planes of ``mesh=``; plane donation has no counterpart, since
the planes are written in place).  The front-end role of SimulationControl
(src/SimulationControl.cpp:37-129, runSimulation :2853-2971): parse +
validate input, build the system, run the chain, and do the
per-corrtime bookkeeping (averages, per-sorbate statistics, energy log,
restart/trajectory, dipole and field files, the population histogram
and the frozen-lattice OpenDX file) with the reference's file contract,
for the uVT (one sorbate or a mixture), NVT, NPT and NVE ensembles; and
the polarizability-tensor analysis mode, which prints the tensor and
ends the run.

``run_input_file`` dispatches an input file to this Simulation, to
``mc.pi.PISimulation`` (path integrals) or to ``mc.gibbs.GibbsSimulation``;
as in the twin, an input with ``parallel_tempering`` runs here as one
chain (the CLI's ``--replicas`` and tempering dispatch to
``parallel.driver.ReplicaSimulation``).  The run drains the PQR writer
(``io.pqr.drain``) before it returns.  The special moves (SPECTRE with
its initial domain wrap, GWP, the anharmonic oscillator), adiabatic
molecules and spin flips run as the chain takes them (mc/chain.py).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from . import constants as const
from . import tracing
from .config.parser import read_config
from .config.schema import SimConfig
from .config.validate import validate
from .flags import dense_only
from .io import histogram as hist_io
from .io import output as out_io
from .io import pqr as pqr_io
from .io import trajectory as traj_io
from .mc import chain as chain_mod
from .mc import moves
from .mc.averages import AvgObservables, nodestats_from_counters
from .mc.sorbate import SorbateTracker
from .ops import delta as delta_mod
from .ops import polar as polar_mod
from .ops import polar_cache as pcache_mod
from .ops.pairwise import build_pairs
from .state import build_state, grow_mol_capacity, topology


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def apply_state_fixups(state, cfg: SimConfig):
    """Post-build_state config overrides every constructed state receives:
    the manual cutoff (pbc_cutoff keyword, src/SimulationControl.cpp:
    1204-1208; update_pbc keeps it)."""
    if cfg.pbc_cutoff > 0.0:
        state = state.replace(pbc=dataclasses.replace(
            state.pbc, cutoff=torch.full((), cfg.pbc_cutoff,
                                         dtype=torch.float64,
                                         device=state.pos.device)))
    return state


def capacity_opts(opts, flags, state, n_caches: int = 1, mesh=None):
    """Recompute the capacity-derived MCOptions fields after a state
    rebuild: blocked_energy and the polar-cache eligibility depend on the
    atom-slot count and on the ``n_caches`` caches (one per replica) that
    share the device, or on the rows each card of ``mesh`` holds
    (polar_cache.max_slots); the move window ``max_mol_atoms`` is the
    largest movable species of a mixture (``moves.movable_window``; the
    twin's is the flagship's 512-atom framework)."""
    polar_incremental = pcache_mod.supports(flags, state.n_atom_slots,
                                            state.pos.device, n_caches,
                                            mesh)
    incremental = delta_mod.supports(flags) or polar_incremental
    blocked = state.n_atom_slots > 1024 and not dense_only(flags)
    return dataclasses.replace(
        opts, incremental=incremental,
        polar_incremental=polar_incremental, blocked_energy=blocked,
        max_mol_atoms=moves.movable_window(state))


def _movable_np(state):
    return ~(_np(state.mol_frozen) | _np(state.mol_adiabatic) |
             _np(state.mol_target))


class Simulation:
    """One standard-ensemble run (NVT / uVT / NPT / NVE) on ``device``.

    ``mesh`` (parallel/meshing.Mesh, whose leader must be of ``device``'s
    type): the polar cache's [A,A] planes row-sharded over its devices,
    each shard building, contracting and committing its own rows, and the
    blocked full recompute sharded (parallel/sharded_energy.py); the
    state and the rest of the carry live on the leader (runner.py:75-83,
    225-232).  It requires the polar-incremental cache and an atom
    capacity that the mesh divides, at the start and after a regrowth
    (ValueError otherwise); the sampled trajectory is the one-device
    run's."""

    def __init__(self, cfg: SimConfig, quiet: bool = False,
                 uvt_capacity_factor: float = 2.0, device="cuda",
                 mesh=None):
        self.cfg = validate(cfg)
        self.quiet = quiet
        self.out = sys.stdout
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.leader.type != self.device.type:
                raise ValueError(f"Simulation: a mesh led by {mesh.leader} "
                                 f"for a run on {self.device}")
            self.device = mesh.leader

        with tracing.span("setup.build_state"):
            self._build(cfg, uvt_capacity_factor)

        # ewald alpha defaults to 3.5/cutoff unless user-set
        # (src/System.cpp:871-874)
        cutoff = float(self.state.pbc.cutoff)
        if not cfg.ewald_alpha_set:
            cfg.ewald_alpha = 3.5 / cutoff
        if not cfg.polar_ewald_alpha_set:
            cfg.polar_ewald_alpha = 3.5 / cutoff

        self.flags = cfg.to_flags()
        self.params = cfg.to_params()
        # the initial SPECTRE domain wrap (src/SimulationControl.cpp:192;
        # runner.py:127-131)
        if cfg.spectre:
            self.state = moves.spectre_wrapall(self.state,
                                               cfg.spectre_max_target)

        # multi-sorbate mixtures: uniform-species insertion with
        # per-species fugacities (fugacities[sorbateInsert],
        # src/System.MonteCarlo.cpp:1362-1367; runner.py:149-172)
        fug = cfg.fugacities[0] if cfg.fugacities else cfg.pressure
        mov = _np(self.state.mol_alive) & _movable_np(self.state)
        self._insert_types = tuple(sorted(
            set(_np(self.state.mol_type)[mov].tolist())))
        sorbate_count = max(len(self._insert_types), 1)
        insert_species, type_fugacities = (), ()
        if sorbate_count > 1:
            insert_species = self._insert_types
            tf = [0.0] * len(self.meta["species"])
            user = cfg.user_fugacities and \
                len(cfg.fugacities) >= sorbate_count
            for i, t in enumerate(self._insert_types):
                tf[t] = cfg.fugacities[i] if user else fug
            type_fugacities = tuple(tf)
        opts = chain_mod.MCOptions(
            ensemble=cfg.ensemble,
            move_factor=cfg.move_factor,
            rot_factor=cfg.rot_factor,
            insert_probability=cfg.insert_probability,
            spinflip_probability=cfg.spinflip_probability,
            adiabatic_probability=cfg.adiabatic_probability,
            volume_probability=cfg.volume_probability,
            volume_change_factor=cfg.volume_change_factor,
            fugacity=fug,
            sorbate_count=sorbate_count,
            insert_species=insert_species,
            type_fugacities=type_fugacities,
            quantum_rotation=cfg.quantum_rotation,
            simulated_annealing=cfg.simulated_annealing,
            simulated_annealing_linear=cfg.simulated_annealing_linear,
            simulated_annealing_schedule=cfg.simulated_annealing_schedule,
            simulated_annealing_target=cfg.simulated_annealing_target,
            numsteps=cfg.numsteps,
            spectre=cfg.spectre,
            spectre_max_charge=cfg.spectre_max_charge,
            spectre_max_target=cfg.spectre_max_target,
            rd_anharmonic=cfg.rd_anharmonic,
            gwp=cfg.gwp,
            gwp_probability=cfg.gwp_probability,
            cavity_bias=cfg.cavity_bias,
            cavity_grid_size=cfg.cavity_grid_size,
            cavity_radius=cfg.cavity_radius,
            # volume/10 darts (src/System.Cavity.cpp:131), sized from the
            # initial volume as in the twin
            cavity_darts=max(int(float(self.state.pbc.volume) * 0.1), 1)
            if cfg.cavity_bias else 0)
        self.opts = capacity_opts(opts, self.flags, self.state, mesh=mesh)
        if mesh is not None and not self.opts.polar_incremental:
            raise ValueError(
                "mesh sharding requires the polar-incremental cache "
                "(polarization + polar_mixed); this config has no "
                "[A,A] planes to shard")

        self.avg = AvgObservables()
        # per-sorbate statistics when more than one movable species
        self.sorbates = SorbateTracker(
            self.meta["species"], _np(self.state.mol_type),
            _np(self.state.mol_mass), _movable_np(self.state))
        if self.sorbates.count <= 1:
            self.sorbates = None
        self.seed = cfg.preset_seed if cfg.preset_seed_on else 0
        self.carry = chain_mod.init_carry(self.state, self.flags, self.params,
                                          self.opts, self.seed, mesh=mesh)
        self._make_engine()

    def _build(self, cfg: SimConfig, uvt_capacity_factor: float):
        """The state of the PQR input, with the uVT insertion headroom."""
        atoms = pqr_io.read_pqr(
            cfg.pqr_input, scale_charge=cfg.scale_charge,
            cdvdw_sig_repulsion=cfg.cdvdw_sig_repulsion,
            polarvdw=cfg.polarvdw,
            cdvdw_exp_repulsion=cfg.cdvdw_exp_repulsion)

        basis = self._resolve_basis(cfg)
        extra = 0
        if cfg.ensemble == const.ENSEMBLE_UVT:
            mov_by_species: dict = {}
            for a in atoms:
                if not a.frozen and not a.adiabatic and not a.target:
                    mov_by_species.setdefault(a.moleculetype,
                                              set()).add(a.molecule_id)
            if len(mov_by_species) > 1:
                # mixture: per-species dead-slot headroom
                extra = {mt: max(int(len(ids) * (uvt_capacity_factor - 1.0)),
                                 32)
                         for mt, ids in mov_by_species.items()}
            else:
                n_mov = len({a.molecule_id for a in atoms if not a.frozen})
                extra = max(int(n_mov * (uvt_capacity_factor - 1.0)), 32)

        self.state, self.meta = build_state(
            atoms, basis, extra_mol_capacity=extra, device=self.device)
        self.state = apply_state_fixups(self.state, cfg)

    def _make_engine(self):
        self.topology = topology(self.state)
        self.run_chunk = chain_mod.make_chunk_runner(
            self.flags, self.params, self.opts, self.cfg.corrtime,
            topology=self.topology)
        self.refresh = chain_mod.make_refresher(self.flags, self.params,
                                                self.opts)

    @staticmethod
    def _resolve_basis(cfg: SimConfig) -> np.ndarray:
        basis = np.zeros((3, 3))
        if cfg.basis1 and cfg.basis2 and cfg.basis3:
            basis[0] = cfg.basis1
            basis[1] = cfg.basis2
            basis[2] = cfg.basis3
        if cfg.read_pqr_box:
            b = pqr_io.read_pqr_box(cfg.pqr_input)
            if b is not None:
                basis = b
        if np.linalg.det(basis) <= 0:
            raise ValueError("invalid simulation box dimensions")
        return basis

    def _particle_mass(self) -> float:
        st = self.state
        mov = _np(st.mol_alive) & ~_np(st.mol_frozen) & \
            ~_np(st.mol_adiabatic)
        idx = np.nonzero(mov)[0]
        return float(_np(st.mol_mass)[idx[0]]) if len(idx) else 0.0

    # -- uVT molecule-capacity regrowth (runner.py:273-359): a proactive
    # regrow when the dead slots drop below a quarter corrtime, and a
    # reactive one that DISCARDS the chunk that hit the ceiling and re-runs
    # it at the larger capacity, so the ceiling never biases the ensemble.

    def _dead_counts(self, state) -> dict:
        mt = _np(state.mol_type)
        dead = ~_np(state.mol_alive) & _movable_np(state)
        return {t: int((dead & (mt == t)).sum()) for t in self._insert_types}

    def _headroom_low(self) -> bool:
        if self.cfg.ensemble != const.ENSEMBLE_UVT or \
                not self._insert_types:
            return False
        thresh = max(8, int(self.cfg.corrtime) // 4)
        return any(v < thresh
                   for v in self._dead_counts(self.carry.state).values())

    def _grow_capacity(self, base_carry) -> None:
        """Rebuild state and engine with more insertion slots, continuing
        the chain from ``base_carry`` (key, step, stats, temperature and
        cavity statistics carry over; energies and caches are rebuilt)."""
        with tracing.span("grow_capacity"):
            st = base_carry.state
            name_of = {i: n for n, i in self.meta["species"].items()}
            mt = _np(st.mol_type)
            live = _np(st.mol_alive) & _movable_np(st)
            extra = {name_of[t]: max(int((live & (mt == t)).sum()),
                                     int(self.cfg.corrtime), 64)
                     for t in self._insert_types}
            self.state, self.meta = grow_mol_capacity(
                st, self.meta, extra, ensure_species=tuple(extra),
                pad_atoms_multiple=512 if self.flags.polar_mixed else 0)
            if not self.quiet:
                self.out.write(
                    f"MC: molecule capacity grown to "
                    f"{self.state.n_mol_slots} slots "
                    f"({self.state.n_atom_slots} atom slots)\n")
            self.opts = capacity_opts(self.opts, self.flags, self.state,
                                      mesh=self.mesh)
            self._make_engine()
            if self.sorbates is not None:
                # species indices are stable across a regrowth: only the
                # per-slot masks change; the statistics carry over
                self.sorbates.mol_type = _np(self.state.mol_type)
                self.sorbates.movable = _movable_np(self.state)
            fresh = chain_mod.init_carry(self.state, self.flags, self.params,
                                         self.opts, self.seed, mesh=self.mesh)
            self.carry = dataclasses.replace(
                fresh, key=base_carry.key, step=base_carry.step,
                stats=base_carry.stats, temperature=base_carry.temperature,
                cavity=base_carry.cavity)

    def _corrtime_io(self, step: int):
        with tracing.span("corrtime_io"):
            obs = out_io.obs_to_dict(self.carry.obs)
            T = float(self.carry.temperature)
            self.avg.update(obs, ensemble=self.cfg.ensemble,
                            temperature=self.cfg.temperature,
                            volume=float(self.carry.state.pbc.volume),
                            particle_mass=self._particle_mass(),
                            free_volume=self.cfg.free_volume,
                            fugacity=(self.cfg.fugacities[0]
                                      if self.cfg.fugacities else None),
                            pressure=self.cfg.pressure)
            if self.sorbates is not None:
                self.sorbates.update(
                    _np(self.carry.state.mol_alive),
                    volume=float(self.carry.state.pbc.volume),
                    frozen_mass=obs["frozen_mass"],
                    total_mass=obs["total_mass"],
                    free_volume=self.cfg.free_volume,
                    pressure_or_fugacity=(self.cfg.fugacities[0]
                                          if self.cfg.fugacities
                                          else self.cfg.pressure),
                    temperature=self.cfg.temperature)
            if self.fp_energy:
                out_io.write_observables(self.fp_energy, step, obs, T)
            if self.fp_energy_csv:
                out_io.write_observables(self.fp_energy_csv, step, obs, T,
                                         csv=True)

    def run(self) -> AvgObservables:
        cfg = self.cfg
        # analysis mode: print the molecular polarizability tensor and end
        # the run, as the reference does from its first energy() call
        # (src/System.Energy.cpp:2601-2605; runner.py:392-400)
        if cfg.polarizability_tensor and cfg.polarization and \
                not cfg.polar_iterative:
            polar_mod.print_polarizability_tensor(
                self.state, self.flags, self.params, self.out)
            return self.avg
        self.fp_energy = None
        self.fp_energy_csv = None
        if out_io.live(cfg.energy_output):
            self.fp_energy = out_io.open_energy_file(cfg.energy_output)
        if out_io.live(cfg.energy_output_csv):
            self.fp_energy_csv = out_io.open_energy_file(
                cfg.energy_output_csv, csv=True)
        perf = out_io.PerformanceTimer(cfg.numsteps)
        first_frame = True

        # population histogram (src/System.Histogram.cpp)
        hist = None
        if cfg.calc_hist:
            hist = hist_io.PopulationHistogram(_np(self.state.pbc.basis),
                                               cfg.hist_resolution)
        # frozen-lattice OpenDX (write_frozen, src/System.Output.cpp:85-116)
        if out_io.live(cfg.frozen_output):
            with open(cfg.frozen_output, "w") as f:
                hist_io.write_frozen_dx(f, self.state, self.meta,
                                        cfg.max_bondlength)

        # initial-state output (setup_mpi, src/System.MonteCarlo.cpp:178-206)
        self._corrtime_io(0)
        if not self.quiet:
            self.out.write("MC: initial values:\n")
            self._display()

        step = 0
        while step < cfg.numsteps:
            n = min(cfg.corrtime, cfg.numsteps - step)
            if n != cfg.corrtime:
                runner = chain_mod.make_chunk_runner(
                    self.flags, self.params, self.opts, n,
                    topology=self.topology)
            else:
                runner = self.run_chunk
            prev_carry = self.carry
            self.carry, stats = runner(self.carry)
            if cfg.ensemble == const.ENSEMBLE_UVT and \
                    bool(stats.capacity_reject.any()):
                # an INSERT hit the capacity ceiling: discard the chunk,
                # regrow from the pre-chunk state and re-run the window
                # (the chunk's in-place plane commits are rebuilt too)
                self._grow_capacity(prev_carry)
                continue
            del prev_carry
            # full recompute every corrtime: kills Delta-E drift (on a
            # mesh each shard rebuilds its rows in place of the twin's
            # re-shard, runner.py:455-460)
            self.carry = self.refresh(self.carry)
            step += n

            ns = nodestats_from_counters(
                _np(self.carry.stats.accept), _np(self.carry.stats.reject),
                float(self.carry.stats.boltzmann_factor),
                polarization_iterations=float(
                    stats.polarization_iterations[-1]),
                cavity_bias_probability=float(self.carry.cavity[0])
                if cfg.cavity_bias else 0.0)
            self.avg.update_nodestats(ns)

            self._corrtime_io(step)
            with tracing.span("output"):
                if cfg.pqr_restart != "/dev/null":
                    pqr_io.write_state_pqr(cfg.pqr_restart, self.carry.state,
                                           self.meta, wrapall=cfg.wrapall,
                                           long_output=cfg.long_output)
                if out_io.live(cfg.traj_output):
                    traj_io.append_traj_frame(
                        cfg.traj_output, self.carry.state, self.meta, step,
                        wrapall=cfg.wrapall, long_output=cfg.long_output,
                        first=first_frame)
                    first_frame = False
                if hist is not None:
                    st = self.carry.state
                    hist.zero()
                    hist.accumulate(_np(st.mol_com()), _np(st.mol_frozen) |
                                    ~_np(st.mol_alive))
                    hist.update_root()
                    if out_io.live(cfg.histogram_output):
                        with open(cfg.histogram_output, "w") as f:
                            hist.write_dx(f)
                if cfg.polarization:
                    traj_io.write_dipoles(cfg.dipole_output, self.carry.state,
                                          first=(step <= cfg.corrtime))
                    if out_io.live(cfg.field_output):
                        self._write_field(step)
            if not self.quiet:
                perf.report(step, self.out)
                self._display()
            if step < cfg.numsteps and self._headroom_low():
                self._grow_capacity(self.carry)

        if cfg.pqr_output != "/dev/null":
            pqr_io.write_state_pqr(cfg.pqr_output, self.carry.state,
                                   self.meta, wrapall=cfg.wrapall,
                                   long_output=cfg.long_output)
        for f in (self.fp_energy, self.fp_energy_csv):
            if f:
                f.close()
        pqr_io.drain()
        return self.avg

    def _write_field(self, step: int):
        """Per-molecule static+induced field log (write_field,
        src/System.Output.cpp:1184-1229).  E_static is the refreshed
        polar cache's static field of the current state where the chain
        carries one, else the full static field, dense or in row blocks
        (the twin recomputes it with its dense thole_field); the induced
        field is backed out of the dipoles (mu/alpha - E_static)."""
        st = self.carry.state
        if self.carry.pcache is not None:
            e_static = pcache_mod.static_field(st, self.flags, self.params,
                                               self.carry.pcache)
        elif self.opts.blocked_energy:
            e_static = polar_mod.thole_field_blocked(st, self.flags,
                                                     self.params)
        else:
            e_static = polar_mod.thole_field(st, build_pairs(st, self.flags),
                                             self.flags, self.params)
        e_static = _np(e_static)
        alpha = _np(st.polarizability)
        safe = np.where(alpha == 0.0, 1.0, alpha)
        e_ind = np.where(alpha[:, None] != 0.0,
                         _np(st.mu) / safe[:, None] - e_static, 0.0)
        traj_io.write_fields(self.cfg.field_output, st, e_static, e_ind,
                             first=(step <= self.cfg.corrtime))

    def _display(self):
        out_io.display_averages(
            self.avg, temperature=float(self.carry.temperature),
            simulated_annealing=self.cfg.simulated_annealing,
            gwp=self.cfg.gwp, ensemble=self.cfg.ensemble,
            sorbate_count=(self.sorbates.count if self.sorbates else 1),
            polar_rrms=self.cfg.polar_rrms, out=self.out)
        if self.sorbates is not None:
            self.sorbates.display(
                self.out, frozen_mass=float(self.carry.obs.frozen_mass))


def make_simulation(cfg: SimConfig, quiet: bool = False, device="cuda"):
    """The simulation of ``cfg``'s ensemble (runner.py:556-566): PISimulation
    for pi_nvt, GibbsSimulation for nvt_gibbs, else Simulation."""
    if cfg.ensemble == const.ENSEMBLE_PATH_INTEGRAL_NVT:
        from .mc.pi import PISimulation
        return PISimulation(cfg, quiet=quiet, device=device)
    if cfg.ensemble == const.ENSEMBLE_NVT_GIBBS:
        from .mc.gibbs import GibbsSimulation
        return GibbsSimulation(cfg, quiet=quiet, device=device)
    return Simulation(cfg, quiet=quiet, device=device)


def run_input_file(path: str, quiet: bool = False, device="cuda"):
    """Read ``path`` and run it; returns the averages (a list of the two
    boxes' for Gibbs)."""
    return make_simulation(read_config(path), quiet=quiet,
                           device=device).run()
