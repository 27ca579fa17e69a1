"""The CLI's path-integral NVT chain (``mc/pi.PISimulation.run``), a
chunk at a time, and its judge.

Set-up is the CLI's: the traffic's ``trotter`` beads as ``-P`` gives
them, ``cli.dispatch``, the whole-system Coker staging of the start
(``thermalize``; the inputs have no ``parallel_restarts``) and the
chain's first per-bead energies (``_init_carry``).  Each corrtime ends
as ``PISimulation.run`` ends it: the per-bead full recompute
(``_recompute``, the ``refresh`` span), then the acceptance statistics
and the corrtime's observables, the primitive kinetic estimator
included, into the averages (``host_read``; every output goes to
/dev/null).  NVT discards no move, and the path runs no SCF: every
kept move counts 0 SCF iterations.

The judge holds each bead's carried components (``comps_per_bead``:
rd, Coulomb, polarization) to the float64 reference of that bead alone
(``reference.energy.energy_terms`` over the bead's live atoms: MPMC++
evaluates each bead as a whole system, one MPI rank a bead), and the
bead means the chain reads besides (``obs_components``, which the
averages take, and ``potential_current``, which the acceptance takes)
to the reference's bead means; bead 0's molecule count to the live
molecules; and the window's accepted moves to the molecules they
changed, every one of whose beads has to have moved.  Each gap is the
worst of its term's carried values.  The carry keeps no k-space energy
apart (its Coulomb column holds it), but on the incremental path it
carries each bead's structure factors (``sf``, [P, K]): there a bead's
``recip_gap`` is the worse of the k-space energy those give
(``reference.energy.recip_from_sf``, the reference's lattice and
formula) against the reference's of the bead, and of the factors
themselves against the reference's, as norms over k; a charged
configuration whose carried K is not the reference lattice's
contradicts the inputs.  On the per-bead full recompute
(``PISimulation.incremental`` False: under polarization) the carry
holds no structure factors ([P, 0]) and each move's Coulomb column is a
fresh full recompute that contains the k-space term: there
``recip_gap`` is ``coul_gap``.  The control reads its own float32
factors and k-space energy.  The many-body van der Waals column is not
compared: no configuration of this ensemble turns it on.
"""

from __future__ import annotations

import numpy as np

from .. import harness
from ..reference import physics as ref_physics
from ..reference.energy import energy_terms, recip_from_sf


def build(path: str, config, traffic, dev):
    """The PISimulation of the ``run.in`` at ``path`` at the traffic's
    beads, with its start staged and its ``carry`` made."""
    from mpmcxx_tpu_torch import cli
    from mpmcxx_tpu_torch.config.parser import read_config
    cfg = read_config(path)
    cfg.total_trotter_number = traffic["trotter"]      # as -P does
    sim = cli.dispatch(cfg, 1, quiet=True, device=dev)
    P, A = sim.stack.pos.shape[:2]
    if P != traffic["trotter"] or (config.get("slots") and
                                   A != config["slots"]):
        raise ValueError(f"{P} beads of {A} atom slots, the cell states "
                         f"{traffic['trotter']} of {config.get('slots')}")
    if not sim.cfg.parallel_restarts:
        sim.thermalize()
    sim.carry = sim._init_carry()
    return sim


class Chain:
    """``PISimulation.run``'s corrtime loop over ``sim``, a chunk at a
    time."""

    def __init__(self, sim, traffic, spans):
        from mpmcxx_tpu_torch.mc import moves, pi
        self.sim, self.spans = sim, spans
        self.chunk, self.corrtime = traffic["chunk"], traffic["corrtime"]
        self.run_chunk = sim._chunk_runner(self.chunk)
        self.pmass = moves.particle_mass(pi.bead(sim.stack, 0))
        self.pending = []           # PIStepOut of the chunks since the
        self.since = 0              # last corrtime boundary; their moves
        self.step = 0               # the chain's kept moves
        self.kept = []              # PIStepOut of every kept chunk
        self.discarded = 0          # NVT discards nothing
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
        """The corrtime's end, as PISimulation.run does it."""
        from mpmcxx_tpu_torch.mc.averages import nodestats_from_counters
        sim, cfg = self.sim, self.sim.cfg
        if self.snapshots:
            self.before_refresh = snapshot(sim.carry)
        with self.spans.span("refresh", timed=True):
            if sim.incremental:
                sim.carry = sim._recompute(sim.carry)
        self.step += self.since
        self.kept += self.pending
        self.pending, self.since = [], 0
        with self.spans.span("host_read"):
            c = sim.carry
            sim.avg.update_nodestats(nodestats_from_counters(
                c.accept.cpu().numpy(), c.reject.cpu().numpy(),
                float(c.bf)))
            obs = sim._observables(c)
            sim.avg.update(obs, ensemble=cfg.ensemble,
                           temperature=cfg.temperature,
                           volume=obs["volume"], particle_mass=self.pmass,
                           free_volume=cfg.free_volume,
                           pressure=cfg.pressure)

    def finish(self):
        """The window's last, partial corrtime: kept."""
        self.step += self.since
        self.kept += self.pending
        self.pending, self.since = [], 0

    def marks(self) -> dict:
        from mpmcxx_tpu_torch.mc import pi
        c = self.sim.carry
        st = pi.whole(c.stack)
        return {"pos": st.pos.detach().cpu().numpy(),
                "alive": st.mol_alive[0].cpu().numpy(),
                "accepted": int(c.accept.sum())}

    def moved(self, marks: dict, end: dict):
        """The window's accepted moves, and ``unmoved``:
        ``harness.moved_share`` of them (an atom's positions on every
        bead taken as one row), or 1 where a changed molecule left a
        bead where it was (``beads_left``), since a sound move leaves
        its trace on every bead or on none."""
        accepted = int(self.sim.carry.accept.sum()) - marks["accepted"]

        def rows(pos):                       # [P, A, 3] -> [A, 3 P]
            return np.transpose(pos, (1, 0, 2)).reshape(pos.shape[1], -1)

        share = harness.moved_share(
            rows(marks["pos"]), marks["alive"], rows(end["pos"]),
            end["mol_alive"][0], end["mol_id"], end["mol_frozen"],
            accepted)
        if share is not None and \
                beads_left(marks["pos"], end["pos"], end["mol_id"]):
            share = 1.0
        return accepted, {"unmoved": share}

    @staticmethod
    def iterations(outs):
        """0 SCF iterations for each move of a chunk."""
        import torch
        return torch.zeros(outs.accepted.shape[0], dtype=torch.float64)

    def slots(self) -> int:
        from mpmcxx_tpu_torch.mc import pi
        return pi.whole(self.sim.carry.stack).pos.shape[1]


def beads_left(pos0, pos1, mol_id) -> int:
    """The molecules changed between the bead stacks ``pos0`` and
    ``pos1`` [P, A, 3] that left a bead where it was: 0 when sound, as
    each PI move changes every bead of its molecule (a displacement moves
    the whole chain; a Coker staging moves its staged beads and shifts
    every bead to keep the chain's centre)."""
    bead_moved = np.zeros((pos0.shape[0], int(mol_id.max()) + 1), bool)
    for s in range(pos0.shape[0]):
        atom = np.any(pos0[s] != pos1[s], axis=1)
        bead_moved[s] = np.bincount(mol_id, weights=atom.astype(float),
                                    minlength=bead_moved.shape[1]) > 0
    return int(np.sum(bead_moved.any(axis=0) & ~bead_moved.all(axis=0)))


def snapshot(carry) -> dict:
    """Device copies of what the judge reads of a carry: the bead stack's
    positions and layout, the carried per-bead components and structure
    factors ([P, 0] where the chain carries none), their bead means and
    the potential, and bead 0's molecule count."""
    from mpmcxx_tpu_torch.mc import pi
    st = pi.whole(carry.stack)
    return {"pos": st.pos.detach().clone(), "mol_id": st.mol_id[0].clone(),
            "mol_alive": st.mol_alive.clone(),
            "mol_frozen": st.mol_frozen[0].clone(),
            "comps": carry.comps_per_bead.clone(),
            "sf_re": carry.sf.re.clone(), "sf_im": carry.sf.im.clone(),
            "obs": carry.obs_components.clone(),
            "pot": carry.potential_current.clone(),
            "N": pi.bead(st, 0).count_N()}


def _recip_gap(recip: float, s_re, s_im, ref: dict) -> float:
    """One bead's k-space gap: the k-space energy ``recip`` against the
    reference's, or the structure factors ``s_re``, ``s_im`` [K] against
    the reference's (the norm of their difference over k against the
    norm of the reference's), whichever is worse."""
    got = np.concatenate([s_re, s_im])
    want = np.concatenate([ref["s_re"], ref["s_im"]])
    return max(harness._rel(recip, ref["recip"]),
               harness._rel(float(np.linalg.norm(got - want)), 0.0,
                            float(np.linalg.norm(want))))


def _carried_recip(st: dict, refs, config, phys, box) -> list:
    """Each bead's ``_recip_gap`` of the carried structure factors, with
    the k-space energy they give over the reference's lattice; None where
    the carry holds none.  Raises ValueError where a charged
    configuration's carried lattice is not the reference's."""
    import torch
    K = st["sf_re"].shape[1]
    if K == 0:
        return None
    if K != len(refs[0]["s_re"]):
        if any(s["charge"] != 0 for s in config["model"]["sites"]):
            raise ValueError(f"the carried structure factors hold {K} "
                             f"k-vectors, the reference's lattice "
                             f"{len(refs[0]['s_re'])}")
        # uncharged: both k-space energies are 0 whatever the lattice
        zero = np.zeros(K)
        refs = [dict(r, s_re=zero, s_im=zero) for r in refs]
        recips = [0.0] * len(refs)
    else:
        recips = [float(recip_from_sf(torch.as_tensor(re), torch.as_tensor(
            im), phys, box)) for re, im in zip(st["sf_re"], st["sf_im"])]
    return [_recip_gap(e, re, im, r) for e, re, im, r in
            zip(recips, st["sf_re"], st["sf_im"], refs)]


def _gaps(comps, obs, pot, N, refs, n_ref, recip) -> dict:
    """The gaps of one bead stack's carried terms: each term's worst over
    its bead values (``comps`` [P, >=3]: rd, Coulomb, polarization) and
    its bead mean (``obs``), the potential ``pot`` (the sum of the
    means) in ``rd_gap``, the worst of the beads' k-space gaps
    (``recip``; None: ``coul_gap``), and the count's."""
    def mean(key):
        return float(np.mean([r[key] for r in refs]))

    def worst(col, key, scale=None):
        beads = [harness._rel(float(g), r[key], None if scale is None
                              else r[scale])
                 for g, r in zip(comps[:, col], refs)]
        return max(beads + [harness._rel(float(obs[col]), mean(key),
                                         None if scale is None
                                         else mean(scale))])

    keys = ("rd", "coulombic", "polarization")
    total = sum(mean(k) for k in keys)
    scale = mean("rd_scale") + mean("coulombic_scale") + \
        abs(mean("polarization"))
    coul = worst(1, "coulombic", "coulombic_scale")
    return {"rd_gap": max(worst(0, "rd", "rd_scale"),
                          harness._rel(float(pot), total, scale)),
            "coul_gap": coul,
            "recip_gap": coul if recip is None else max(recip),
            "polar_gap": worst(2, "polarization"),
            "n_gap": abs(float(N) - n_ref)}


def judge(st: dict, config, traffic, dev, control: bool):
    """One judged bead stack (``on_host(snapshot)``) against the float64
    reference of each bead: (its gaps, the control's gaps or None, the
    reference's terms of each bead).  Raises ValueError where the state
    contradicts the inputs."""
    import torch
    alive = st["mol_alive"]
    if np.any(alive != alive[0]):
        raise ValueError("the beads disagree on which molecules are alive")
    tables = [harness.judge_inputs(dict(st, pos=pos, mol_alive=alive[0]),
                                   config) for pos in st["pos"]]
    n_ref = tables[0][1]
    beads = [harness._to_torch(a, dev) for a, _ in tables]
    phys = ref_physics.physics(config, traffic)
    box = config["geometry"]["box"]
    refs = [energy_terms(a, phys, box, keep_sf=True) for a in beads]
    got = _gaps(st["comps"], st["obs"], st["pot"], st["N"], refs, n_ref,
                _carried_recip(st, refs, config, phys, box))
    low = None
    if control:
        lo = [energy_terms(a, phys, box, dtype=torch.float32,
                           plane_dtype=torch.bfloat16, keep_sf=True)
              for a in beads]
        comps = np.asarray([[t[k] for k in ("rd", "coulombic",
                                            "polarization")] for t in lo])
        obs = comps.mean(axis=0)
        low = _gaps(comps, obs, obs.sum(), float(n_ref), refs, n_ref,
                    [_recip_gap(t["recip"], t["s_re"], t["s_im"], r)
                     for t, r in zip(lo, refs)])
    for r in refs:
        del r["s_re"], r["s_im"]
    return got, low, refs
