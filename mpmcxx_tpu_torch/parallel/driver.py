"""Replica simulation driver on one device or a mesh of devices.

JAX twin: mpmcxx_tpu/parallel/driver.py.  The runner-level counterpart
of the reference's MPI operation: R independent chains (optionally at a
temperature ladder with parallel tempering) run one after the other on
one device, or replica i on device i % n of a mesh, each with its own
carry and polarization cache; every
corrtime the host aggregates each replica's observables into the root
averages as rank 0 does in do_corrtime_bookkeeping
(src/System.MonteCarlo.cpp:1954-2028), writes per-replica energy-log
rows and restart PQRs (queued on the native writer thread, io/pqr.py),
and ``run`` drains the writer before it returns.

Parallel tempering follows the reference's (disabled) design
(src/System.MonteCarlo.cpp:1767-1897): neighbor-bath swaps every
``ptemp_freq`` steps exchanging temperatures, with observables collected
from the coldest bath.  On a GPU the caches of the replicas on one card
share its memory budget (``polar_cache.max_slots(n_caches=...)``); a
system too large for it runs every replica on the no-cache path, as
``capacity_opts`` chooses.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from .. import constants as const
from .. import random as rnd
from ..config.schema import SimConfig
from ..io import histogram as hist_io
from ..io import output as out_io
from ..io import pqr as pqr_io
from ..mc import chain as chain_mod
from ..mc.averages import AvgObservables, nodestats_from_counters
from ..runner import (Simulation, _movable_np, _np, apply_state_fixups,
                      capacity_opts)
from ..state import build_state, grow_mol_capacity
from . import meshing
from . import replicas as rep


class ReplicaSimulation:
    """R replica chains of a standard-ensemble run on ``device``, or on
    ``mesh`` (replica i on device i % n; its leader must be of
    ``device``'s type).  Without one, a CUDA run on a host with more than
    one card takes a mesh of min(R, cards) cards, as the twin does
    (driver.py:48-50)."""

    def __init__(self, cfg: SimConfig, n_replicas: int,
                 quiet: bool = False, device="cuda", mesh=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ReplicaSimulation: no CUDA device is "
                               "available; pass device='cpu'")
        if mesh is None and device.type == "cuda" and \
                torch.cuda.device_count() > 1:
            mesh = rep.make_mesh(min(n_replicas, torch.cuda.device_count()))
        if mesh is not None:
            if mesh.leader.type != device.type:
                raise ValueError(f"ReplicaSimulation: a mesh led by "
                                 f"{mesh.leader} for a run on {device}")
            device = mesh.leader
        self.mesh = mesh
        self.base = Simulation(cfg, quiet=True, device=device)
        self.cfg = self.base.cfg
        self.device = self.base.device
        self.R = n_replicas
        self.quiet = quiet
        self.out = sys.stdout

        seed = cfg.preset_seed if cfg.preset_seed_on else 0
        # the resident polar caches of the replicas on one card share its
        # budget
        self._set_opts(capacity_opts(
            self.base.opts, self.base.flags, self.base.state,
            n_caches=rep.caches_per_device(mesh, n_replicas)))
        self.carries = self._place(self._init_carries(n_replicas, seed))
        self.base.carry = None        # its planes live on in the replicas

        self.tempering = cfg.parallel_tempering
        if self.tempering:
            if cfg.max_temperature <= cfg.temperature:
                raise ValueError("parallel_tempering requires "
                                 "max_temperature > temperature")
            ladder = rep.temperature_ladder(cfg.temperature,
                                            cfg.max_temperature, n_replicas)
            self.carries = [self._with_temperature(c, t)
                            for c, t in zip(self.carries, ladder)]
            self.ptemp_freq = cfg.ptemp_freq or const.PTEMP_FREQ_DEFAULT
            chunk = min(self.ptemp_freq, cfg.corrtime)
        else:
            chunk = cfg.corrtime
        self.chunk = chunk
        self._make_engine()

        self.avg = AvgObservables()
        self._swap_key = rnd.PRNGKey(seed + 7919)
        self._parity = 0
        # tempering swap acceptance bookkeeping (the reference's
        # temper_system is dead code and tracks nothing; the counters let
        # users check the ladder's health)
        self.swap_attempts = 0
        self.swap_accepts = 0

        # cross-replica population histogram + multi-sorbate roll-up: the
        # replica-axis role of the reference's per-corrtime MPI gather
        # (System.MPI.cpp:9-43; update_root_histogram /
        # update_root_sorb_averages, System.MonteCarlo.cpp:1954-2028)
        self.hist = None
        if cfg.calc_hist:
            self.hist = hist_io.PopulationHistogram(
                _np(self.base.state.pbc.basis), cfg.hist_resolution)
        self.sorbates = self.base.sorbates

    def _set_opts(self, opts) -> None:
        """Adopt the R-replica options; a polar cache that does not fit
        the R-replica budget takes the no-cache path, said once."""
        if self.base.opts.polar_incremental and not opts.polar_incremental:
            if not self.quiet:
                self.out.write(
                    f"MC: {self.R} polar caches of "
                    f"{self.base.state.n_atom_slots} atom slots do not fit "
                    f"{self.device}: every replica runs without one\n")
            self.base.carry = chain_mod.init_carry(
                self.base.state, self.base.flags, self.base.params, opts,
                self.base.seed)
        self.base.opts = opts

    def _with_temperature(self, carry, t: float):
        return dataclasses.replace(carry, temperature=torch.full(
            (), float(t), dtype=torch.float64,
            device=carry.temperature.device))

    def _place(self, carries: list) -> list:
        """Each replica's carry on its mesh device (as they are without a
        mesh)."""
        if self.mesh is None:
            return carries
        return [meshing.to_device(c, rep.replica_device(self.mesh, r))
                for r, c in enumerate(carries)]

    def _make_engine(self) -> None:
        self.runner = rep.make_replica_runner(
            self.base.flags, self.base.params, self.base.opts, self.chunk,
            mesh=self.mesh)
        refresh = chain_mod.make_refresher(
            self.base.flags, self.base.params, self.base.opts)

        def refresh_on_device(carry):
            with meshing.device_guard(carry.state.pos.device):
                return refresh(carry)

        self.refresh = refresh_on_device

    def _restart_path(self, r: int) -> str:
        """Per-replica resume search: restart-000r.pqr -> .last -> input.

        The reference performs this search only when ``parallel_restarts``
        is on (SimulationControl.cpp:2298-2355); without it every rank
        starts from pqr_input even if restart files from a previous run
        are sitting in the directory."""
        cfg = self.cfg
        if not cfg.parallel_restarts:
            return cfg.pqr_input
        if cfg.pqr_restart == "/dev/null":
            # restart output explicitly disabled: nothing to resume from
            return cfg.pqr_input
        base = cfg.pqr_restart if cfg.pqr_restart \
            else cfg.job_name + ".restart.pqr"
        cand = pqr_io.make_filename(base, r)
        if os.path.exists(cand):
            return cand
        if os.path.exists(cand + ".last"):
            return cand + ".last"
        return cfg.pqr_input

    def _init_carries(self, R: int, seed: int) -> list:
        """Per-replica initial carries: resume each replica from its own
        restart file when one exists (the reference's parallel_restarts
        role for MPI ranks), else copy the shared input state
        (driver.py:117-209)."""
        cfg = self.cfg
        base = self.base
        paths = [self._restart_path(r) for r in range(R)]
        if all(p == cfg.pqr_input for p in paths):
            # slot layouts never change during a run (insert/remove only
            # flip mol_alive), so the shared base meta stays valid for
            # every replica (consumed by _grow_replica_capacity)
            self._replica_metas = [base.meta] * R
            return rep.replicate_carry(base.carry, R, base_seed=seed)

        atom_lists = {}
        for p in set(paths):
            atom_lists[p] = pqr_io.read_pqr(
                p, scale_charge=cfg.scale_charge,
                cdvdw_sig_repulsion=cfg.cdvdw_sig_repulsion,
                polarvdw=cfg.polarvdw,
                cdvdw_exp_repulsion=cfg.cdvdw_exp_repulsion)

        # one common PER-SPECIES slot reservation, so that every replica
        # has the same slot counts (the twin stacks them) AND every
        # insertable species keeps dead template slots (a scalar extra
        # replicates only the last movable molecule, which starves the
        # other species' insertions in multi-sorbate uVT resumes)
        basis = _np(base.state.pbc.basis)

        def mov_by_species(atoms):
            out: dict = {}
            for a in atoms:
                if not a.frozen and not a.adiabatic and not a.target:
                    out.setdefault(a.moleculetype, set()).add(a.molecule_id)
            return {k: len(v) for k, v in out.items()}

        live_sp = {p: mov_by_species(atoms)
                   for p, atoms in atom_lists.items()}
        all_names = sorted({n for d in live_sp.values() for n in d})
        if len(all_names) > 1 or cfg.ensemble != const.ENSEMBLE_UVT:
            # per-species totals: max live across paths + headroom
            target_sp = {n: max(d.get(n, 0) for d in live_sp.values()) +
                         32 for n in all_names}
            for p, d in live_sp.items():
                missing = [n for n in all_names if d.get(n, 0) == 0]
                if missing and cfg.ensemble == const.ENSEMBLE_UVT:
                    raise ValueError(
                        f"replica restart {p} has no molecule of species "
                        f"{missing}: cannot reserve insertion templates "
                        "for a fully depleted species — restart from "
                        "pqr_input instead")

            def extra_of(p):
                return {n: target_sp[n] - live_sp[p].get(n, 0)
                        for n in all_names if n in live_sp[p]}
        else:
            n_mols = {p: len({a.molecule_id for a in atoms})
                      for p, atoms in atom_lists.items()}
            target = max(base.state.n_mol_slots,
                         max(n_mols.values()) + 32)

            def extra_of(p):
                return target - n_mols[p]

        carries, states, metas = [], {}, {}
        for r, p in enumerate(paths):
            if p not in states:
                st, meta = build_state(
                    atom_lists[p], basis,
                    extra_mol_capacity=extra_of(p),
                    species_names=list(base.meta["species"]),
                    device=self.device)
                # the post-build fixups Simulation.__init__ applies
                # (pbc_cutoff override), so resumed replicas use the
                # same cutoff as fresh ones
                states[p] = apply_state_fixups(st, cfg)
                metas[p] = meta
            st, s0 = states[p], states[paths[0]]
            if st.n_atom_slots != s0.n_atom_slots or \
                    st.n_mol_slots != s0.n_mol_slots:
                raise ValueError(
                    f"replica {r} restart {p} does not stack with replica "
                    f"0 ({st.n_atom_slots} vs {s0.n_atom_slots} atom slots)")
            carries.append(chain_mod.init_carry(
                st, base.flags, base.params, base.opts, seed))
        self._replica_metas = [metas[p] for p in paths]
        key0 = rnd.PRNGKey(seed)
        return [dataclasses.replace(c, key=rnd.fold_in(key0, r))
                for r, c in enumerate(carries)]

    def _grow_replica_capacity(self, prev: list) -> None:
        """Mid-run molecule-capacity regrowth of every replica
        (driver.py:211-299).

        Same contract as runner.Simulation._grow_capacity: the chunk that
        hit the ceiling is discarded by the caller and re-run at the
        larger capacity, so saturation never biases any replica's
        ensemble.  Every replica regrows to a COMMON per-species slot
        total.  ``prev``: the carries before the discarded chunk (their
        states; the caches are rebuilt)."""
        cfg, base = self.cfg, self.base
        name_of = {i: n for n, i in base.meta["species"].items()}
        insert_types = base._insert_types
        live = {t: [] for t in insert_types}
        for c in prev:
            mt = _np(c.state.mol_type)
            alive = _np(c.state.mol_alive) & _movable_np(c.state)
            for t in insert_types:
                live[t].append(int((alive & (mt == t)).sum()))
        target_total = {t: max(live[t]) + max(int(cfg.corrtime), 64)
                        for t in insert_types}
        new_metas, new_states = [], []
        st0 = None
        for r, (c, meta) in enumerate(zip(prev, self._replica_metas)):
            extra = {name_of[t]: target_total[t] - live[t][r]
                     for t in insert_types}
            ns, nm = grow_mol_capacity(
                c.state, meta, extra, ensure_species=tuple(extra),
                # the mixed SCF's tiles want atom capacity % 512 == 0;
                # the common totals give every replica the same pad
                pad_atoms_multiple=512 if base.flags.polar_mixed else 0)
            if st0 is None:
                st0 = ns
            elif ns.n_atom_slots != st0.n_atom_slots or \
                    ns.n_mol_slots != st0.n_mol_slots:
                raise ValueError(
                    f"replica {r} regrew to {ns.n_atom_slots} atom slots "
                    f"vs replica 0's {st0.n_atom_slots}: replicas have "
                    "unequal non-insertable movable populations")
            new_metas.append(nm)
            new_states.append(ns)
        # the capacity-derived options change with the atom-slot count:
        # recompute them for R caches and rebuild the runner/refresher
        base.opts = capacity_opts(
            base.opts, base.flags, st0,
            n_caches=rep.caches_per_device(self.mesh, self.R))
        self._make_engine()
        carries = []
        for c, ns in zip(prev, new_states):
            with meshing.device_guard(ns.pos.device):
                fresh = chain_mod.init_carry(ns, base.flags, base.params,
                                             base.opts, 0)
            carries.append(dataclasses.replace(
                fresh, key=c.key, step=c.step, stats=c.stats,
                temperature=c.temperature, cavity=c.cavity))
        self.carries = carries
        self._replica_metas = new_metas
        if not self.quiet:
            self.out.write(
                f"MC: replica molecule capacity grown to "
                f"{st0.n_mol_slots} slots ({st0.n_atom_slots} atom "
                f"slots)\n")
        if self.sorbates is not None:
            # per-slot masks resized (species indices unchanged; replica
            # 0's layout, as the twin's tracker)
            self.sorbates.mol_type = _np(st0.mol_type)
            self.sorbates.movable = _movable_np(st0)

    def _corrtime_io(self, step: int, fp_energy) -> None:
        """Rank-0-style aggregation: average every replica's observables
        into the root statistics (coldest bath only under tempering)."""
        temps = [float(c.temperature) for c in self.carries]
        cold = int(np.argmin(temps))
        if self.hist is not None:
            self.hist.zero()
        for r, c in enumerate(self.carries):
            obs = out_io.obs_to_dict(c.obs)
            if fp_energy:
                out_io.write_observables(fp_energy, step, obs, temps[r])
            if self.tempering and r != cold:
                continue
            self.avg.update(
                obs, ensemble=self.cfg.ensemble,
                temperature=self.cfg.temperature, volume=obs["volume"],
                particle_mass=self.base._particle_mass(),
                free_volume=self.cfg.free_volume,
                pressure=self.cfg.pressure)
            st = c.state
            if self.hist is not None:
                self.hist.accumulate(
                    _np(st.mol_com()),
                    _np(st.mol_frozen) | ~_np(st.mol_alive))
            if self.sorbates is not None:
                fug = (self.cfg.fugacities[0] if self.cfg.fugacities
                       else self.cfg.pressure)
                self.sorbates.update(
                    _np(st.mol_alive), volume=float(st.pbc.volume),
                    frozen_mass=obs["frozen_mass"],
                    total_mass=obs["total_mass"],
                    free_volume=self.cfg.free_volume,
                    pressure_or_fugacity=fug,
                    temperature=self.cfg.temperature)
        if self.hist is not None:
            self.hist.update_root()
            if self.cfg.histogram_output and \
                    self.cfg.histogram_output != "/dev/null":
                with open(self.cfg.histogram_output, "w") as f:
                    self.hist.write_dx(f)

    def _swap(self) -> None:
        """One tempering sweep after a chunk (driver.py:374-383)."""
        keys = rnd.split(self._swap_key)
        self._swap_key, k = keys[0], keys[1]
        new_t, swapped = rep.tempering_swap(
            [float(c.temperature) for c in self.carries],
            [float(c.obs.energy) for c in self.carries], k, self._parity)
        self.swap_attempts += sum(
            1 for i in range(self.R - 1) if i % 2 == self._parity)
        self.swap_accepts += int(swapped.sum())
        self._parity ^= 1
        self.carries = [self._with_temperature(c, t)
                        for c, t in zip(self.carries, new_t)]

    def _write_pqrs(self, basename: str) -> None:
        for r, c in enumerate(self.carries):
            pqr_io.write_state_pqr(
                pqr_io.make_filename(basename, r), c.state,
                self._replica_metas[r], wrapall=self.cfg.wrapall,
                long_output=self.cfg.long_output)

    def run(self) -> AvgObservables:
        cfg = self.cfg
        fp_energy = None
        if cfg.energy_output and cfg.energy_output != "/dev/null":
            fp_energy = out_io.open_energy_file(cfg.energy_output)

        perf = out_io.PerformanceTimer(cfg.numsteps)
        self._corrtime_io(0, fp_energy)

        step = 0
        since_corr = 0
        while step < cfg.numsteps:
            prev = self.carries
            self.carries, outs = self.runner(self.carries)
            if cfg.ensemble == const.ENSEMBLE_UVT and \
                    any(bool(o.capacity_reject.any()) for o in outs):
                # a replica's INSERT hit the capacity ceiling inside this
                # chunk: discard it, regrow every replica to a larger
                # common capacity and re-run the window.  The chunk wrote
                # the planes in place: drop them before the rebuild.
                prev = [dataclasses.replace(c, pcache=None) for c in prev]
                self.carries = outs = None
                self._grow_replica_capacity(prev)
                continue
            del prev
            step += self.chunk
            since_corr += self.chunk

            if self.tempering:
                self._swap()

            if since_corr >= cfg.corrtime or step >= cfg.numsteps:
                since_corr = 0
                # one replica at a time: one refresh's transient planes
                # at the peak (polar_cache.max_slots)
                for r in range(self.R):
                    self.carries[r] = self.refresh(self.carries[r])
                acc = sum(_np(c.stats.accept) for c in self.carries)
                rej = sum(_np(c.stats.reject) for c in self.carries)
                self.avg.update_nodestats(nodestats_from_counters(
                    acc, rej,
                    float(self.carries[0].stats.boltzmann_factor),
                    cavity_bias_probability=float(np.mean(
                        [float(c.cavity[0]) for c in self.carries]))
                    if cfg.cavity_bias else 0.0))
                self._corrtime_io(step, fp_energy)
                if cfg.pqr_restart != "/dev/null":
                    self._write_pqrs(cfg.pqr_restart)
                if not self.quiet:
                    perf.report(step, self.out)
                    out_io.display_averages(
                        self.avg,
                        temperature=min(float(c.temperature)
                                        for c in self.carries),
                        ensemble=cfg.ensemble, out=self.out)

        if cfg.pqr_output != "/dev/null":
            self._write_pqrs(cfg.pqr_output)
        pqr_io.drain()
        if fp_energy:
            fp_energy.close()
        return self.avg
