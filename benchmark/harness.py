"""One run of one cell: set-up, the measured window, the comparison.

Set-up (``setup_s``, from the process's start): the cell's inputs
(benchmark/inputs: the PQR of the configuration's lattice start and the
``run.in``, whose ``seed`` is the run's, under TMPDIR),
the program's ``Simulation`` built as its CLI builds it
(``cli.dispatch``), and a warm-up of the cell's own shapes: one chunk and
one corrtime refresh with its host reads.

The window is the CLI's corrtime loop (``runner.Simulation.run``) in
chunks of the traffic's ``chunk`` moves, so that it ends within a chunk
of ``--seconds``: every ``corrtime`` moves the capacity check (a
corrtime that hit the molecule ceiling is discarded and run again at the
larger capacity, as the CLI does; its moves do not count), the full
recompute (``refresh``) and the per-corrtime host reads of the CLI (the
acceptance statistics, the averages; every output goes to /dev/null).
``moves_per_s`` is the moves kept over the window's whole wall time, and
``memory_peak_mb`` the device's allocation peak from set-up's warm-up to
the window's end (``memory_peak_bytes``), in MB.
The window ends off a corrtime boundary: at least one chunk follows its
last refresh.

The carried energies are judged twice: as they stood just before the
window's last refresh (a whole corrtime of incremental updates; the
state and the carried sums are copied on the device there) and at the
window's end.  After the window, with the peak memory read and the
program's state freed, each is held against the float64 reference
(benchmark/reference), term by term, with the molecule count; and the
window's accepted moves against the molecules they changed.  Each number
is the worse of the two states; ``correct`` is every number within its
limit (``limits/<workload>.json``).

A run finds its chain by the configuration's ensemble, by name:
``ensembles/<physics.ensemble>.py`` (``Manifest.ensemble``).  Where
that file exists, it supplies the four parts this module supplies for
the uVT chain of ``runner.Simulation``: ``build`` (the simulation from
the ``run.in``, with its ``carry``), ``Chain`` (the loop a chunk at a
time, with ``marks``, ``moved``, ``iterations`` and ``slots``),
``snapshot`` and ``judge``.  Set-up timing, the window, the traced stretch, the
metrics and the result stay here, shared by every ensemble.

With ``trace``, a run of its own: the refreshes are timed between two
synchronisations, and one stretch around a corrtime boundary (the last
``profile_chunks`` chunks, the refresh, the host reads) is profiled with
span markers (benchmark/trace.py); the per-layer metrics are read from
that record, which also holds the window's kept moves and wall time, by
``metrics/<name>.py``.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import roofline, trace
from .inputs import geometry
from .inputs.runin import run_in
from .manifest import ROOT, Manifest
from .reference import physics as ref_physics
from .reference.energy import energy_terms

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "mpmcxx_tpu")
# intra-op threads of the host's tensor work: one process with few
# threads; the H2 cell's rate read the same with 1 and with torch's
# default of 8 (PERF.md, section 6)
THREADS = 1
CACHE = ".benchcache"
PROFILE_TRIES = 3    # corrtime boundaries a traced run may profile


class NoDevice(RuntimeError):
    """The cell's CUDA devices are not there."""


def cache_env(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    set before torch loads; no library the port uses may load JAX."""
    base = os.path.join(root, CACHE)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """The forbidden top-level names in sys.modules, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def _rel(got: float, want: float, scale: float = None) -> float:
    """|got - want| over ``scale``, by default |want|."""
    scale = abs(want) if scale is None else scale
    return abs(got - want) / (scale if scale != 0.0 else 1.0)


class Chain:
    """The CLI's corrtime loop over the simulation ``sim``, a chunk at a
    time."""

    def __init__(self, sim, traffic, spans):
        from mpmcxx_tpu_torch import constants as pconst
        self.sim, self.spans = sim, spans
        self.chunk, self.corrtime = traffic["chunk"], traffic["corrtime"]
        self.uvt = sim.cfg.ensemble == pconst.ENSEMBLE_UVT
        self.sim.fp_energy = self.sim.fp_energy_csv = None
        self._runner()
        self.start = sim.carry      # carry at the last corrtime boundary
        self.pending = []           # StepOut of the chunks since then
        self.since = 0              # moves since then
        self.step = 0               # the chain's kept moves
        self.kept = []              # StepOut of every kept chunk
        self.discarded = 0
        self.snapshots = False      # copy the carry before each refresh
        self.before_refresh = None  # the last such copy

    def _runner(self):
        from mpmcxx_tpu_torch.mc import chain
        s = self.sim
        self.run_chunk = chain.make_chunk_runner(s.flags, s.params, s.opts,
                                                 self.chunk,
                                                 topology=s.topology)

    def advance(self):
        with self.spans.span("chunk"):
            self.sim.carry, outs = self.run_chunk(self.sim.carry)
        self.pending.append(outs)
        self.since += self.chunk
        return outs

    def at_boundary(self) -> bool:
        return self.since >= self.corrtime

    def _hit_capacity(self) -> bool:
        import torch
        return self.uvt and bool(torch.stack(
            [o.capacity_reject.any() for o in self.pending]).any())

    def boundary(self):
        """The corrtime's end, as Simulation.run does it."""
        from mpmcxx_tpu_torch.mc.averages import nodestats_from_counters
        sim = self.sim
        with self.spans.span("host_read"):
            hit = self._hit_capacity()
        if hit:
            self.discarded += self.since
            sim._grow_capacity(self.start)
            self._runner()
            self.pending, self.since = [], 0
            self.start = sim.carry
            return
        if self.snapshots:
            self.before_refresh = snapshot(sim.carry)
        with self.spans.span("refresh", timed=True):
            sim.carry = sim.refresh(sim.carry)
        self.step += self.since
        self.kept += self.pending
        last = self.pending[-1]
        self.pending, self.since = [], 0
        with self.spans.span("host_read"):
            c = sim.carry
            ns = nodestats_from_counters(
                c.stats.accept.cpu().numpy(), c.stats.reject.cpu().numpy(),
                float(c.stats.boltzmann_factor),
                polarization_iterations=float(
                    last.polarization_iterations[-1]),
                cavity_bias_probability=float(c.cavity[0])
                if sim.cfg.cavity_bias else 0.0)
            sim.avg.update_nodestats(ns)
            sim._corrtime_io(self.step)
            if sim._headroom_low():
                sim._grow_capacity(sim.carry)
                self._runner()
        self.start = sim.carry

    def finish(self):
        """The window's last, partial corrtime: kept unless it hit the
        ceiling (then its moves are discarded; the state stays a sound
        state of the chain)."""
        if self.pending:
            if self._hit_capacity():
                self.discarded += self.since
            else:
                self.step += self.since
                self.kept += self.pending
            self.pending, self.since = [], 0

    def marks(self) -> dict:
        """On the host, what ``moved`` compares the window's end with."""
        st = self.sim.carry.state
        return {"pos": st.pos.detach().cpu().numpy(),
                "alive": st.mol_alive.cpu().numpy(),
                "accepted": int(self.sim.carry.stats.accept.sum())}

    def moved(self, marks: dict, end: dict):
        """The window's accepted moves, and the numbers that hold them
        to the state at its end (``end``: the final state's
        ``on_host(snapshot)``): ``unmoved``, their ``moved_share``."""
        accepted = int(self.sim.carry.stats.accept.sum()) - \
            marks["accepted"]
        return accepted, {"unmoved": moved_share(
            marks["pos"], marks["alive"], end["pos"], end["mol_alive"],
            end["mol_id"], end["mol_frozen"], accepted)}

    @staticmethod
    def iterations(outs):
        """The SCF iterations of each move of one chunk's output."""
        return outs.polarization_iterations

    def slots(self) -> int:
        return self.sim.carry.state.n_atom_slots


def snapshot(carry) -> dict:
    """Device copies of what the judge reads of a carry: the layout, the
    positions and the carried energies and molecule count."""
    st, obs = carry.state, carry.obs
    out = {k: getattr(st, k).detach().clone() for k in
           ("pos", "mol_id", "mol_alive", "mol_frozen")}
    out.update(rd=obs.rd_energy.clone(), coulombic=obs.coulombic_energy
               .clone(), recip=carry.recip_e.clone(),
               polarization=obs.polarization_energy.clone(),
               N=obs.N.clone())
    return out


def on_host(snap: dict) -> dict:
    """A snapshot's arrays in numpy and its energies in floats."""
    return {k: (v.cpu().numpy() if v.dim() else float(v))
            for k, v in snap.items()}


def judge_inputs(snap: dict, config):
    """The reference's atom table of a state (``on_host(snapshot)``): the
    live atoms' positions and layout from the state, every parameter from
    the configuration's model.  Raises ValueError where the state
    contradicts the inputs (a frozen atom, a molecule short of a
    site)."""
    pos, mol_id = snap["pos"], snap["mol_id"]
    mol_alive, mol_frozen = snap["mol_alive"], snap["mol_frozen"]
    live = np.nonzero(mol_alive[mol_id])[0]
    mid = mol_id[live]
    if mol_frozen[mid].any():
        raise ValueError("a live atom is frozen; the inputs froze none")
    S = len(config["model"]["sites"])
    sizes = np.bincount(mid)
    if np.any(sizes[sizes > 0] != S):
        raise ValueError("a live molecule does not hold every site")
    first = np.r_[True, mid[1:] != mid[:-1]]
    head = np.maximum.accumulate(np.where(first, np.arange(len(mid)), 0))
    site = np.arange(len(mid)) - head
    _, mol = np.unique(mid, return_inverse=True)
    n_mol = int(np.sum(mol_alive & ~mol_frozen))
    return ref_physics.atoms(config, pos[live], site, mol), n_mol


def _to_torch(atoms, device):
    import torch
    return {k: torch.as_tensor(v, device=device) for k, v in atoms.items()}


def moved_share(pos0, alive0, pos1, alive1, mol_id, mol_frozen, accepted):
    """1 - (sorbate molecules whose atoms or alive flag changed in the
    window) / (the distinct molecules ``accepted`` moves would change,
    each a molecule of M at random: M (1 - (1 - 1/M)^accepted), M those
    alive at either end): about 0 when every accepted move left its
    trace, 1 when none did.  None where a regrowth changed the slot
    layout."""
    if pos0.shape != pos1.shape or alive0.shape != alive1.shape:
        return None
    if accepted <= 0:
        return 1.0
    atom_moved = np.any(pos0 != pos1, axis=1) & alive1[mol_id]
    mol_moved = np.bincount(mol_id, weights=atom_moved.astype(float),
                            minlength=len(alive1)) > 0
    changed = (mol_moved | (alive0 != alive1)) & ~mol_frozen
    M = max(int(np.sum((alive0 | alive1) & ~mol_frozen)), 1)
    expected = M * (1.0 - (1.0 - 1.0 / M) ** accepted)
    return 1.0 - float(changed.sum()) / expected


def gaps(carried: dict, ref: dict, n_ref: int) -> dict:
    """The gaps of one judged state's carried energies and count."""
    return {
        "rd_gap": _rel(carried["rd"], ref["rd"], ref["rd_scale"]),
        "coul_gap": _rel(carried["coulombic"], ref["coulombic"],
                         ref["coulombic_scale"]),
        "recip_gap": _rel(carried["recip"], ref["recip"]),
        "polar_gap": _rel(carried["polarization"], ref["polarization"]),
        "n_gap": abs(carried["N"] - n_ref),
    }


def build(path: str, config, traffic, dev):
    """The CLI's simulation of the ``run.in`` at ``path``, its atom slots
    held to the configuration's."""
    from mpmcxx_tpu_torch import cli
    from mpmcxx_tpu_torch.config.parser import read_config
    sim = cli.dispatch(read_config(path), 1, quiet=True, device=dev)
    if config.get("slots") and sim.state.n_atom_slots != config["slots"]:
        raise ValueError(f"{sim.state.n_atom_slots} atom slots, the "
                         f"configuration states {config['slots']}")
    return sim


def judge(st: dict, config, traffic, dev, control: bool):
    """One judged state (``on_host(snapshot)``) against the float64
    reference: (its gaps, the control's gaps or None, the reference's
    terms).  Raises ValueError where the state contradicts the inputs."""
    import torch
    atoms, n_ref = judge_inputs(st, config)
    phys = ref_physics.physics(config, traffic)
    box = config["geometry"]["box"]
    ta = _to_torch(atoms, dev)
    ref = energy_terms(ta, phys, box)
    low = None
    if control:
        low = energy_terms(ta, phys, box, dtype=torch.float32,
                           plane_dtype=torch.bfloat16)
        low["N"] = float(n_ref)
        low = gaps(low, ref, n_ref)
    return gaps(st, ref, n_ref), low, ref


def compare(judged: list, moved: dict, limits: dict):
    """The numbers compared, each beside its limit, and ``correct``:
    ``judged`` holds the gaps of each judged state, and each number is
    the worst of them; ``moved`` the numbers of the window's moves
    (``Chain.moved``)."""
    nums = {k: max(g[k] for g in judged) for k in judged[0]}
    nums.update(moved)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    # ``unmoved`` is None only where a regrowth changed the slot layout
    correct = all(v is None or (np.isfinite(v) and v <= limits[k])
                  for k, v in nums.items())
    return checks, correct


def power_limit():
    """The card's power limit in W from nvidia-smi, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_start: float = None, man=None,
             config=None, traffic=None, limits=None,
             control=False) -> dict:
    """One run; returns the result object (and, with ``control``, the
    control's numbers under "control")."""
    import torch

    import mpmcxx_tpu_torch  # noqa: F401  (the system under test)
    t_start = time.perf_counter() if t_start is None else t_start
    man = man or Manifest()
    cell = man.workload(name)
    config = config or man.config(cell["config"])
    traffic = traffic or man.traffic(cell["traffic"])
    limits = limits or man.limits(name)
    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available() or
                               torch.cuda.device_count() < cell["chips"]):
        raise NoDevice(f"{name} needs {cell['chips']} CUDA device(s)")
    torch.set_num_threads(THREADS)
    work = tempfile.mkdtemp(prefix="mpmc-bench-")
    try:
        return _run(man, cell, config, traffic, limits, seed, seconds,
                    trace_on, dev, t_start, work, control)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(man, cell, config, traffic, limits, seed, seconds, trace_on, dev,
         t_start, work, control):
    import torch
    model = config["model"]
    pqr = os.path.join(work, "input.pqr")
    geometry.write_pqr(pqr, model, geometry.molecules(model,
                                                      config["geometry"]))
    path = os.path.join(work, "run.in")
    with open(path, "w") as f:
        f.write(run_in(config, traffic, seed, pqr))

    # the configuration's ensemble file, else this module's uVT chain
    ens = man.ensemble(config["physics"]["ensemble"]) or \
        sys.modules[__name__]
    sim = ens.build(path, config, traffic, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    spans = trace.Spans(timing=trace_on, cuda=dev.type == "cuda")
    ch = ens.Chain(sim, traffic, spans)
    # warm-up: one chunk and one refresh with its host reads
    ch.advance()
    ch.since = ch.corrtime
    ch.boundary()
    ch.step, ch.kept, ch.discarded, spans.times = 0, [], 0, {}
    ch.snapshots = True
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    marks = ch.marks()
    per_corrtime = traffic["corrtime"] // traffic["chunk"]
    pro_at = max(per_corrtime - traffic["profile_chunks"], 0)
    stretch, profiled, profile = None, [], None
    tries = 0

    t0 = time.perf_counter()
    while True:
        if trace_on and dev.type == "cuda" and profile is None and \
                stretch is None and tries < PROFILE_TRIES and \
                ch.since == pro_at * ch.chunk:
            stretch = trace.Stretch(spans)
            profiled = []
        outs = ch.advance()
        if stretch is not None:
            profiled.append(outs)
        if ch.at_boundary():
            ch.boundary()
            if stretch is not None:
                stretch.stop()
                tries += 1
                seg = trace.segment(stretch.device_ops(), spans.bounds)
                if seg is not None and seg[0]:
                    profile = (seg, profiled)
                stretch = None
        # the window ends off a boundary, so that the final state carries
        # incremental updates since the last refresh
        done = time.perf_counter() - t0 >= seconds and ch.since > 0
        if done and stretch is None and (not trace_on or profile is not None
                                         or tries >= PROFILE_TRIES or
                                         dev.type != "cuda"):
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    ch.finish()

    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    states = [on_host(ens.snapshot(sim.carry))]
    if ch.before_refresh is not None:
        states.insert(0, on_host(ch.before_refresh))
    accepted, moved = ch.moved(marks, states[-1])
    iters = torch.cat([ch.iterations(o) for o in ch.kept]).cpu() \
        .numpy() if ch.kept else np.zeros(0)
    discarded = ch.discarded
    record = None
    if trace_on:
        record = _trace_record(man, config, traffic, spans, profile, iters,
                               ch, dev)
        record["moves"], record["moves_wall_s"] = len(iters), window_s
    del sim, ch, stretch, profiled, profile
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    phys = ref_physics.physics(config, traffic)
    t_ref = time.perf_counter()
    judged, ctl, refs, fault = [], [], [], None
    for st in states:
        try:
            got, low, ref = ens.judge(st, config, traffic, dev, control)
        except ValueError as e:
            fault = str(e)
            break
        refs.append(ref)
        judged.append(got)
        if control:
            ctl.append(low)
    if fault is None:
        checks, correct = compare(judged, moved, limits)
    else:
        checks = {"layout": {"value": fault, "limit": None}}
        correct = False
    moves = len(iters)
    result = {"correct": bool(correct), "attempted": moves + discarded,
              "failed": discarded + scf_fallbacks(iters, phys)}
    unit = {m["name"]: m["unit"] for m in
            man.data["end_to_end"] + man.data["per_layer"]}
    metrics = {}
    if not trace_on:
        vals = {"moves_per_s": moves / window_s, "setup_s": setup_s,
                "memory_peak_mb": peak / 1e6}
        for m in man.end_to_end(cell["name"]):
            if m["name"] in vals:
                metrics[m["name"]] = {"value": vals[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in man.per_layer(cell["name"]):
            v = man.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": unit[m["name"]]}
    result["metrics"] = metrics
    result["device"] = _device(dev, cell, peak, record)
    if trace_on and record.get("breakdown"):
        result["breakdown"] = record["breakdown"]
    if control and fault is None:
        result["control"], result["control_correct"] = compare(
            ctl, dict.fromkeys(moved, 0.0), limits)
        result["reference"] = refs
    result["window"] = {"seconds": window_s, "moves": moves,
                        "accepted": accepted, "seed": seed,
                        "judged": len(states),
                        "reference_s": time.perf_counter() - t_ref}
    result["checks"] = checks
    return result


def scf_fallbacks(iters, phys) -> int:
    """Moves whose SCF took the divergence fallback (a precision-ended
    SCF that ran every allowed sweep)."""
    from .reference import constants as C
    if phys["polar_precision"] == 0.0:
        return 0
    return int(np.sum(iters >= C.MAX_ITERATION_COUNT))


def _device(dev, cell, peak, record) -> dict:
    import torch
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": cell["chips"], "memory_peak_bytes": peak}
        pl = power_limit()
        if pl is not None:
            out["power_limit_w"] = pl
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": peak}
    if record is not None and record.get("window_s"):
        out["busy_s"] = record["busy_s"]
        out["window_s"] = record["window_s"]
    return out


def _trace_record(man, config, traffic, spans, profile, iters, ch, dev):
    """What the per-layer readers read: refresh times, SCF iterations per
    move (``ch.iterations``), and the profiled stretch's device ops by
    span."""
    import torch
    rec = {"refresh_s": spans.times.get("refresh", []),
           "iterations": [float(x) for x in iters],
           "slots": ch.slots(), "planes": config["scf"]["planes"],
           "palmo": ref_physics.physics(config, traffic)["polar_palmo"],
           "kernels": man.kernels(), "ops": None, "segments": None,
           "chunk_iterations": None, "peak": None}
    if dev.type == "cuda":
        rec["peak"] = roofline.peak(man.peaks(),
                                    torch.cuda.get_device_name(dev))
    if profile is None:
        return rec
    (ops, segs), outs = profile
    rec["ops"], rec["segments"] = ops, segs
    rec["chunk_iterations"] = [float(x) for x in torch.cat(
        [ch.iterations(o) for o in outs]).cpu().numpy()]
    whole = [s for s in segs if s[0] == "stretch"]
    if whole:
        _, w0, w1 = whole[0]
        rec["window_s"] = w1 - w0
        rec["busy_s"] = trace.union_s((s, s + d) for _, s, d, _ in ops)
    rec["breakdown"] = trace.breakdown(ops, segs, rec["kernels"])
    return rec


def main(argv=None, t_start=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        res = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=t_start)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    out = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                               "device")}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["window"] = res["window"]
    out["checks"] = res["checks"]
    print(json.dumps(out), flush=True)
    return 0
