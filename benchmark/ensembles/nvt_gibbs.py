"""The CLI's two-box NVT-Gibbs chain (``mc/gibbs.GibbsSimulation.run``),
a chunk at a time, and its judge.

Set-up is the CLI's: box B's lattice start (the configuration's
``geometry_b``) is written beside the ``run.in`` as its ``pqr_input_B``,
then ``cli.dispatch`` builds the simulation, both boxes' atom slots are
held to the configuration's (``slots``, ``slots_b``), and the chain's
first energies are made (``init_gibbs_carry``).  The chain is the
module's public functions over the simulation's ``flags``, ``params``,
``opts`` and ``topologies``: ``make_gibbs_chunk_runner`` a chunk at a
time, and each corrtime ends as ``GibbsSimulation.run`` ends it: the
full recompute of both boxes on the incremental path
(``make_gibbs_refresher``; the ``refresh`` span), then the acceptance
statistics and both boxes' observables into their averages
(``update_nodestats``, ``corrtime_io``; ``host_read``; every output goes
to /dev/null).  NVT-Gibbs discards no move and runs no SCF: every kept
move counts 0 SCF iterations.  ``slots`` is both boxes' slots together.

The judge holds each box on its own to the float64 reference
(``reference.energy.energy_terms`` over that box's live atoms, at the
box's own side read from its state): its carried rd, Coulomb, k-space
and polarization energies, and its carried molecule count against its
live molecules.  Besides, the live molecules of both boxes against the
start's N_a + N_b, and V_a + V_b against the start's.  Two conventions
are the program's, as MPMC++ has them:

- the Ewald alpha is 3.5 over box A's starting cutoff, set once at
  set-up and kept through every volume exchange (``ewald_alpha``
  defaults to 3.5 / cutoff at set-up, src/System.cpp:871-874; the
  reference's own default, 3.5 over the cutoff of the side it is given,
  would follow each box's side), so the judge passes it to the
  reference;
- each box's cutoff is half its current side (half the shortest lattice
  vector, src/PeriodicBoundary.cpp:40-66, scaled with the box on a volume
  change, src/System.MonteCarlo.cpp:1235-1282): the reference's rc of
  the side it is given.

The harness's six numbers carry the gaps, each the worst over both
boxes: ``rd_gap`` also holds |V_a + V_b - V_0| / V_0 (from each box's
volume and from its side cubed), the volumes its long-range correction
and every k-space sum read; ``n_gap`` also holds |N_a + N_b - N_0| of
both the live and the carried counts.  ``unmoved`` is
``harness.moved_share`` of the window's accepted displacements and
transfers (the kept ``GibbsStepOut`` rows of any other type than a
volume exchange) over both boxes' molecules taken as one state, where a
molecule has moved if its alive flag changed or its centre of mass
moved in its box's fractional coordinates (by more than ``FRAC_TOL``, the
rounding of the exchanges' rescaling): a volume exchange rescales every
molecule of both boxes and leaves those fixed, so it neither hides a
displacement or transfer that left no trace nor counts as one.  An
accepted step can change two molecules (a displacement accepted in both
boxes, a transfer's removal and insertion) and counts one, so a sound
chain reads ``unmoved`` at or below 0, and a chain whose accepted moves
leave the state as it was reads 1.
"""

from __future__ import annotations

import os

import numpy as np

from .. import harness
from ..inputs import geometry
from ..reference import physics as ref_physics
from ..reference.energy import energy_terms

BOXES = ("a", "b")
# the snapshot's per-box arrays of the layout
LAYOUT = ("pos", "mol_id", "mol_alive", "mol_frozen")
# a fractional centre that moved by no more than this reads as unmoved
FRAC_TOL = 1e-9


def _ewald_alpha(config, traffic) -> float:
    """The program's Ewald alpha: the run.in's, else 3.5 over box A's
    starting cutoff (half its side)."""
    keys = {**config["physics"], **traffic["runin"]}
    if "ewald_alpha" in keys:
        return float(keys["ewald_alpha"])
    return 3.5 / (0.5 * config["geometry"]["box"])


def build(path: str, config, traffic, dev):
    """The GibbsSimulation of the ``run.in`` at ``path`` with box B's
    start beside it, its slots held to the configuration's, and its
    ``carry`` made."""
    from mpmcxx_tpu_torch import cli
    from mpmcxx_tpu_torch.config.parser import read_config
    from mpmcxx_tpu_torch.mc import gibbs
    geo_a, geo_b = config["geometry"], config["geometry_b"]
    if geo_b["box"] != geo_a["box"]:
        raise ValueError("both boxes start from the run.in's basis; "
                         "geometry_b states another side")
    pqr_b = os.path.join(os.path.dirname(path), "input_b.pqr")
    geometry.write_pqr(pqr_b, config["model"],
                       geometry.molecules(config["model"], geo_b))
    cfg = read_config(path)
    cfg.pqr_input_B = pqr_b
    sim = cli.dispatch(cfg, 1, quiet=True, device=dev)
    got = (sim.state_a.n_atom_slots, sim.state_b.n_atom_slots)
    want = (config.get("slots"), config.get("slots_b"))
    if any(w and g != w for g, w in zip(got, want)):
        raise ValueError(f"{got} atom slots, the configuration states "
                         f"{want}")
    sim.carry = gibbs.init_gibbs_carry(
        sim.state_a, sim.state_b, sim.flags, sim.params, sim.opts,
        sim.seed, sim.cfg.temperature)
    return sim


class Chain:
    """``GibbsSimulation.run``'s corrtime loop over ``sim``, a chunk at a
    time."""

    def __init__(self, sim, traffic, spans):
        from mpmcxx_tpu_torch.mc import gibbs
        self.sim, self.spans = sim, spans
        self.chunk, self.corrtime = traffic["chunk"], traffic["corrtime"]
        self.run_chunk = gibbs.make_gibbs_chunk_runner(
            sim.flags, sim.params, sim.opts, self.chunk, sim.topologies)
        self.refresh = gibbs.make_gibbs_refresher(sim.flags, sim.params,
                                                  sim.opts)
        self.pending = []           # GibbsStepOut of the chunks since the
        self.since = 0              # last corrtime boundary; their moves
        self.step = 0               # the chain's kept moves
        self.kept = []              # GibbsStepOut of every kept chunk
        self.discarded = 0          # NVT-Gibbs discards nothing
        self.snapshots = False      # copy the carry before each refresh
        self.before_refresh = None  # the last such copy

    def advance(self):
        with self.spans.span("chunk"):
            self.sim.carry, outs = self.run_chunk(self.sim.carry)
        self.pending.append(outs)
        self.since += self.chunk
        return outs

    def at_boundary(self) -> bool:
        return self.since >= self.corrtime

    def boundary(self):
        """The corrtime's end, as GibbsSimulation.run does it."""
        sim = self.sim
        if self.snapshots:
            self.before_refresh = snapshot(sim.carry)
        with self.spans.span("refresh", timed=True):
            if sim.opts.incremental:
                sim.carry = self.refresh(sim.carry)
        self.step += self.since
        self.kept += self.pending
        self.pending, self.since = [], 0
        with self.spans.span("host_read"):
            sim.update_nodestats(sim.carry)
            sim.corrtime_io(sim.carry, self.step)

    def finish(self):
        """The window's last, partial corrtime: kept."""
        self.step += self.since
        self.kept += self.pending
        self.pending, self.since = [], 0

    def marks(self) -> dict:
        c = self.sim.carry
        return {"frac": np.concatenate([centres(s).cpu().numpy()
                                        for s in (c.state_a, c.state_b)]),
                "alive": np.concatenate([s.mol_alive.cpu().numpy()
                                         for s in (c.state_a, c.state_b)]),
                "accepted": int(c.accept.sum())}

    def moved(self, marks: dict, end: dict):
        """The window's accepted moves, and ``unmoved``:
        ``harness.moved_share`` of its accepted displacements and
        transfers over both boxes' molecules as one state (box B's
        numbered after box A's), each molecule's fractional centre taken
        as its one atom."""
        from mpmcxx_tpu_torch import constants as pconst
        accepted = int(self.sim.carry.accept.sum()) - marks["accepted"]
        local = sum(int((o.accepted &
                         (o.movetype != pconst.MOVETYPE_VOLUME)).sum())
                    for o in self.kept)
        f0 = marks["frac"]
        f1 = np.concatenate([end["frac_a"], end["frac_b"]])
        f1 = np.where(np.abs(f1 - f0) <= FRAC_TOL, f0, f1)
        alive = np.concatenate([end["mol_alive_a"], end["mol_alive_b"]])
        frozen = np.concatenate([end["mol_frozen_a"], end["mol_frozen_b"]])
        return accepted, {"unmoved": harness.moved_share(
            f0, marks["alive"], f1, alive, np.arange(len(alive)), frozen,
            local)}

    @staticmethod
    def iterations(outs):
        """0 SCF iterations for each move of a chunk."""
        import torch
        return torch.zeros(outs.accepted.shape[0], dtype=torch.float64)

    def slots(self) -> int:
        c = self.sim.carry
        return c.state_a.n_atom_slots + c.state_b.n_atom_slots


def centres(state):
    """[M,3] the molecules' centres of mass in the box's fractional
    coordinates (0 for a dead molecule)."""
    return state.mol_com() @ state.pbc.reciprocal


def snapshot(carry) -> dict:
    """Device copies of what the judge reads of a carry, per box: the
    layout and positions, the basis and volume, the carried energies and
    molecule count; and the fractional centres ``moved`` reads."""
    out = {}
    for box, st, obs, recip in (
            ("a", carry.state_a, carry.obs_a, carry.recip_a),
            ("b", carry.state_b, carry.obs_b, carry.recip_b)):
        out.update({f"{k}_{box}": getattr(st, k).detach().clone()
                    for k in LAYOUT})
        out.update({f"basis_{box}": st.pbc.basis.clone(),
                    f"volume_{box}": st.pbc.volume.clone(),
                    f"rd_{box}": obs.rd_energy.clone(),
                    f"coulombic_{box}": obs.coulombic_energy.clone(),
                    f"recip_{box}": recip.clone(),
                    f"polarization_{box}": obs.polarization_energy.clone(),
                    f"N_{box}": obs.N.clone(),
                    f"frac_{box}": centres(st)})
    return out


def side(basis) -> float:
    """The side of a cubic box's basis; ValueError for any other box."""
    L = float(basis[0, 0])
    if not np.array_equal(np.asarray(basis), L * np.eye(3)):
        raise ValueError("a box is not cubic; the reference is")
    return L


def _totals(n_live: list, n_carried: list, volumes: list, sides: list,
            config) -> tuple:
    """(|N_a + N_b - N_0| of the live and of the carried counts, the
    relative gap of V_a + V_b to V_0 from the volumes and from the sides
    cubed) against the start's totals."""
    geo_a, geo_b = config["geometry"], config["geometry_b"]
    n0 = geo_a["molecules"] + geo_b["molecules"]
    v0 = geo_a["box"] ** 3 + geo_b["box"] ** 3
    n_gap = max(abs(sum(n_live) - n0), abs(sum(n_carried) - n0))
    v_gap = max(abs(sum(volumes) - v0), abs(sum(L ** 3 for L in sides) -
                                            v0)) / v0
    return float(n_gap), v_gap


def _merge(per_box: list, n_gap: float, v_gap: float) -> dict:
    """The worst of each gap over the boxes, with the totals' gaps."""
    out = {k: max(g[k] for g in per_box) for k in per_box[0]}
    out["rd_gap"] = max(out["rd_gap"], v_gap)
    out["n_gap"] = max(out["n_gap"], n_gap)
    return out


def judge(st: dict, config, traffic, dev, control: bool):
    """One judged pair of boxes (``on_host(snapshot)``) against the
    float64 reference of each box: (its gaps, the control's gaps or None,
    the reference's terms of each box).  Raises ValueError where the
    state contradicts the inputs."""
    import torch
    phys = ref_physics.physics(config, traffic)
    phys["ewald_alpha"] = _ewald_alpha(config, traffic)
    got, low, refs, n_live, sides = [], [], [], [], []
    for box in BOXES:
        atoms, n_ref = harness.judge_inputs(
            {k: st[f"{k}_{box}"] for k in LAYOUT}, config)
        L = side(st[f"basis_{box}"])
        ta = harness._to_torch(atoms, dev)
        ref = energy_terms(ta, phys, L)
        carried = {k: st[f"{k}_{box}"] for k in
                   ("rd", "coulombic", "recip", "polarization", "N")}
        got.append(harness.gaps(carried, ref, n_ref))
        if control:
            lo = energy_terms(ta, phys, L, dtype=torch.float32,
                              plane_dtype=torch.bfloat16)
            lo["N"] = float(n_ref)
            low.append(harness.gaps(lo, ref, n_ref))
        refs.append(ref)
        n_live.append(n_ref)
        sides.append(L)
    n_gap, v_gap = _totals(n_live, [st["N_a"], st["N_b"]],
                           [st["volume_a"], st["volume_b"]], sides, config)
    low_gaps = None
    if control:
        # the control is the reference's energies in the program's place;
        # the totals are the state's
        low_gaps = _merge(low, n_gap, v_gap)
    return _merge(got, n_gap, v_gap), low_gaps, refs
