"""The chunk runners' CUDA graphs of a move (mpmcxx_tpu_torch/mc/graph.py,
``MoveGraph``; mc/chain.py and mc/pi.py, each ``graphs_apply`` and chunk
runner: one graph a PI move type).

On the CPU: each rule that picks the graph or the eager loop, case by
case; a runner on the CPU counts every move ``graph_eager``; the carry's
tensors come apart and back together whole; a step reads whether any
slot is adiabatic once in its life; a Coker staging at a device anchor is
bitwise the host int's; the uVT and the PI runners' graph bookkeeping
(buffers, anchors, columns, a graph a move type), each capture stood in
for by a rerun of its move, keeps the eager chain bitwise; and the mc
layer imports nothing from above it and no private name of another mc
module.

The ``gpu`` tests run on the card (``python -m pytest
tests/test_torch_graph.py -m gpu --noconftest``; this file imports no
jax): a CLI ``Simulation`` whose chunks replay the graph runs the same
chain as its eager loop over ``make_step_fn``'s step, seed for seed,
through corrtime refreshes (new planes) and a capacity regrowth (a new
layout), on a polarizable H2 uVT system with Feynman-Hibbs, cavity bias
and fixed sweeps, and on a CO2 LJ + Ewald uVT system; and a
``PISimulation`` whose chunks replay a graph a move type runs its eager
chain bitwise through the per-bead recomputes, on para-H2 and on a
two-site H2 with orientation data."""

import ast
import dataclasses
import pathlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_co2_system as co2  # noqa: E402
import torch_pi_system as pi_system  # noqa: E402
from mpmcxx_tpu_torch import constants as const  # noqa: E402
from mpmcxx_tpu_torch import flags as fl  # noqa: E402
from mpmcxx_tpu_torch import random as rnd  # noqa: E402
from mpmcxx_tpu_torch import tracing  # noqa: E402
from mpmcxx_tpu_torch.config.parser import read_config  # noqa: E402
from mpmcxx_tpu_torch.mc import chain, graph, pi  # noqa: E402
from mpmcxx_tpu_torch.ops import polar_cache as pcache_mod  # noqa: E402
from mpmcxx_tpu_torch.parallel import meshing  # noqa: E402
from mpmcxx_tpu_torch.runner import Simulation  # noqa: E402
from mpmcxx_tpu_torch.state import topology  # noqa: E402

CHUNK = 4


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _polar():
    """(flags, params, opts, cache) of the flagship's polarizable uVT
    chain with fixed sweeps: a move the graph takes."""
    flags, params, opts = co2.config(fl, const, chain.MCOptions)
    return flags, params, opts, pcache_mod.empty_cache("cpu")


def _sharded(cache):
    mesh = meshing.make_mesh(devices=["cpu"] * 2)
    return dataclasses.replace(cache, dx=meshing.RowShards(
        (cache.dx, cache.dx), (0, 0), mesh))


# case -> (device, change of (flags, params, opts, cache), marking, graph)
RULE = {
    "cuda-fixed-sweeps": ("cuda", None, False, True),
    "cuda-lj-ewald": ("cuda", lambda f, p, o, c: (
        f.replace(polarization=False, polar_iterative=False,
                  polar_ewald=False, polar_mixed=False), p,
        dataclasses.replace(o, polar_incremental=False), None), False, True),
    "cpu": ("cpu", None, False, False),
    "precision-ended-scf": ("cuda", lambda f, p, o, c: (
        f, p.replace(polar_precision=1e-5), o, c), False, False),
    "exact-solve": ("cuda", lambda f, p, o, c: (
        f.replace(polar_iterative=False), p, o, c), False, False),
    "row-sharded-cache": ("cuda", lambda f, p, o, c: (
        f, p, o, _sharded(c)), False, False),
    "full-recompute": ("cuda", lambda f, p, o, c: (
        f, p, dataclasses.replace(o, incremental=False), c), False, False),
    "npt": ("cuda", lambda f, p, o, c: (
        f, p, dataclasses.replace(o, ensemble=const.ENSEMBLE_NPT), c),
        False, False),
    "spectre": ("cuda", lambda f, p, o, c: (
        f, p, dataclasses.replace(o, spectre=True), c), False, False),
    "gwp": ("cuda", lambda f, p, o, c: (
        f, p, dataclasses.replace(o, gwp=True), c), False, False),
    "tracer-marking": ("cuda", None, True, False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_graph_rule(case):
    device, change, marking, want = RULE[case]
    flags, params, opts, cache = _polar()
    if change is not None:
        flags, params, opts, cache = change(flags, params, opts, cache)
    assert chain.graphs_apply(torch.device(device), flags, params, opts,
                              cache, marking) is want


SYSTEMS = {"co2": co2.torch_co2_lj_ewald, "h2": co2.torch_h2_cavity}


def test_runner_on_the_cpu_runs_every_move_eager():
    state, flags, params, opts = co2.torch_co2_lj_ewald()
    carry = chain.init_carry(state, flags, params, opts, seed=5)
    run = chain.make_chunk_runner(flags, params, opts, CHUNK,
                                  topology=topology(state))
    tracing.enable()
    for _ in range(2):
        carry, _ = run(carry)
    snap = tracing.snapshot()
    assert snap["moves"] == 2 * CHUNK
    assert snap["counters"]["graph_eager"] == {"step": 2 * CHUNK}
    assert not snap["counters"].get("graph_capture")
    assert not snap["counters"].get("graph_replay")


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_carry_comes_apart_and_back_whole(system):
    state, flags, params, opts = SYSTEMS[system]()
    carry = chain.init_carry(state, flags, params, opts, seed=1)
    leaves = chain._leaves(carry)
    assert all(isinstance(t, torch.Tensor) for t in leaves)
    back = chain._with_leaves(carry, leaves)
    assert all(a is b for a, b in zip(chain._leaves(back), leaves))
    assert back.pcache is carry.pcache and back.key is carry.key and \
        back.stats is carry.stats
    # a move replaces state tensors, observables and caches, and keeps
    # the layout's static tensors
    run = chain.make_step_fn(flags, params, opts, topology=topology(state))
    _, draws, _ = chain.chunk_draws(carry.key, 1)
    darts = torch.rand((opts.cavity_darts, 3), dtype=torch.float64) \
        if opts.cavity_bias else None
    new, _ = run(carry, draws[0], darts)
    kept = {j for j, (a, b) in enumerate(zip(leaves, chain._leaves(new)))
            if a is b}
    names = graph.STATE_FIELDS
    assert {names.index(n) for n in ("mol_id", "mass", "sigma")} <= kept
    assert names.index("pos") not in kept


class _Rerun:
    """A capture's stand-in on the CPU: its replay reruns the captured
    move on the graph's buffers, as the graph would."""

    def __init__(self, owner, carry, key):
        self.graph, self.carry, self.key = owner, carry, key

    def replay(self):
        self.graph._eager(self.carry, self.key)


def _rerun_captures(mp):
    """Stand in for every capture on the CPU with a _Rerun."""
    mp.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    mp.setattr(graph.MoveGraph, "_capture",
               lambda self, carry, key: (_Rerun(self, carry, key), {}))


def test_step_reads_adiabatic_slots_once():
    """A step reads from the device whether any slot is adiabatic once in
    its life, on its first call: not again over carries whose tensors are
    fresh copies, nor for a state whose slots all became adiabatic."""
    state, flags, params, opts = co2.torch_co2_lj_ewald()
    carry = chain.init_carry(state, flags, params, opts, seed=3)
    step = chain.make_step_fn(flags, params, opts, topology=topology(state))
    _, draws, _ = chain.chunk_draws(carry.key, CHUNK)
    copies, read, real_any = [], [], torch.any

    def spy(t, *a, **k):
        if any(t is c for c in copies):
            read.append(t)
        return real_any(t, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "any", spy)
        for d in draws:
            carry = chain._with_leaves(carry, [t.clone() for t in
                                               chain._leaves(carry)])
            copies.append(carry.state.mol_adiabatic)
            carry, _ = step(carry, d)
    assert len(copies) == CHUNK and len(read) == 1 and read[0] is copies[0]
    assert step.any_adiabatic(state.replace(
        mol_adiabatic=torch.ones_like(state.mol_adiabatic))) is False


UVT_CHUNKS = 3


def _drive_uvt(system, graphed):
    """UVT_CHUNKS chunks of CHUNK moves of ``system``'s uVT chain on the
    CPU, each followed by the corrtime refresh; with ``graphed`` the
    runner's graph bookkeeping runs, each capture a _Rerun.  Returns (the
    moves' StepOut columns, the carry after the last chunk, the tracer's
    snapshot, [a returned carry's leaves as returned, and after the next
    chunk])."""
    state, flags, params, opts = SYSTEMS[system]()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chain, "graphs_apply", lambda *a, **k: graphed)
        if graphed:
            _rerun_captures(mp)
        carry = chain.init_carry(state, flags, params, opts, seed=7)
        run = chain.make_chunk_runner(flags, params, opts, CHUNK,
                                      topology=topology(state))
        refresh = chain.make_refresher(flags, params, opts)
        tracing.reset()
        tracing.enable()
        outs, kept = [], []
        for _ in range(UVT_CHUNKS):
            carry, out = run(carry)
            if kept:
                kept[-1].append([t.clone() for t in
                                 chain._leaves(kept[-1][0])])
            kept.append([carry, [t.clone() for t in chain._leaves(carry)]])
            outs.append(out)
            last = carry
            carry = refresh(carry)
        snap = tracing.snapshot()
        tracing.disable()
    return chain.StepOut(*(torch.cat(c) for c in zip(*outs))), last, snap, \
        [k[1:] for k in kept[:-1]]


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_uvt_graph_bookkeeping_keeps_the_eager_chain(system):
    """On the CPU, with each capture a rerun of its move: the uVT graph's
    buffers, draws and dart rows and output columns give the eager chain
    bitwise, with one eager move, a capture per set of polar-cache planes
    (one, without the cache) and every other move replayed."""
    o_e, c_e, s_e, _ = _drive_uvt(system, False)
    o_g, c_g, s_g, kept = _drive_uvt(system, True)
    moves = UVT_CHUNKS * CHUNK
    assert len(o_g.accepted) == moves and 0 < int(o_g.accepted.sum())
    for a, b in zip(o_g, o_e):
        assert torch.equal(a, b)
    for a, b in zip(chain._leaves(c_g) + list(c_g.stats),
                    chain._leaves(c_e) + list(c_e.stats)):
        assert torch.equal(a, b)
    if c_e.pcache is not None:
        for f in dataclasses.fields(c_e.pcache):
            assert torch.equal(getattr(c_g.pcache, f.name),
                               getattr(c_e.pcache, f.name))
    captures = 1 if c_e.pcache is None else UVT_CHUNKS
    assert s_e["counters"]["graph_eager"] == {"step": moves}
    assert s_g["counters"]["graph_eager"] == {"step": 1}
    assert s_g["counters"]["graph_capture"] == {"step": captures}
    assert s_g["counters"]["graph_replay"] == {"step": moves - 1}
    # no later chunk wrote a carry the runner returned
    for returned, later in kept:
        for a, b in zip(returned, later):
            assert torch.equal(a, b)


_PKG = pathlib.Path(chain.__file__).parents[1]


def _absolute(node: ast.ImportFrom, here: str) -> str:
    """The module an ``from ... import`` in module ``here`` names."""
    if not node.level:
        return node.module
    base = here.split(".")[:-node.level]
    return ".".join(base + ([node.module] if node.module else []))


def test_the_mc_layer_imports_nothing_above_it_or_private():
    """No module under mc/ imports the runner, and none imports an
    underscore name of another mc module, or reads one off an mc module
    it imports."""
    found = []
    for path in sorted((_PKG / "mc").glob("*.py")):
        here = f"{_PKG.name}.mc.{path.stem}"
        mods = set()     # local names of mc modules
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                found += [(here, a.name) for a in node.names
                          if a.name == f"{_PKG.name}.runner"]
            elif isinstance(node, ast.ImportFrom):
                src = _absolute(node, here)
                for a in node.names:
                    full = f"{src}.{a.name}"
                    if f"{_PKG.name}.runner" in (src, full):
                        found.append((here, full))
                    elif src == f"{_PKG.name}.mc":
                        mods.add(a.asname or a.name)
                    elif src.startswith(f"{_PKG.name}.mc.") and \
                            a.name.startswith("_"):
                        found.append((here, full))
            elif isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in mods and node.attr.startswith("_"):
                found.append((here, f"{node.value.id}.{node.attr}"))
    assert not found


# -- on the card ------------------------------------------------------------

RUN_IN = {
    "h2": """job_name gr
ensemble uvt
temperature 77.0
pressure 20.0
insert_probability 0.3
move_factor 0.1
numsteps 1000
corrtime {n}
seed {seed}
feynman_hibbs on
feynman_hibbs_order 4
polarization on
polar_iterative on
polar_ewald on
polar_mixed on
polar_max_iter 4
polar_damp_type exponential
polar_damp 2.1304
cavity_bias on
cavity_grid 5
cavity_radius 2.6
pqr_input sys.pqr
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
""",
    "co2": """job_name gr
ensemble uvt
temperature 298.0
pressure 30.0
insert_probability 0.3
move_factor 0.1
numsteps 1000
corrtime {n}
seed {seed}
pqr_input sys.pqr
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
""",
}
CORRTIME, CORRTIMES, GROW_AFTER = 8, 4, 1
CONTRACTIONS = ("K1 contract_planes", "K4 contract_planes_tri",
                "K5 contract_planes_sym")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _drive(path, graphed: bool):
    """CORRTIMES corrtimes of a CLI Simulation a chunk each, each chunk
    followed by the refresh, and the capacity grown after chunk
    GROW_AFTER; with ``graphed`` off the runner's eager loop runs every
    move.  Returns (the moves' movetype and accepted, the final carry,
    the tracer's snapshot, [a returned carry, its leaves as returned, and
    after the next chunk])."""
    with pytest.MonkeyPatch.context() as mp:
        if not graphed:
            mp.setattr(chain, "graphs_apply", lambda *a, **k: False)
        sim = Simulation(read_config(path), quiet=True, device="cuda")
        tracing.reset()
        tracing.enable()
        movetype, accepted, kept = [], [], []
        slots = sim.state.n_atom_slots
        for k in range(CORRTIMES):
            sim.carry, outs = sim.run_chunk(sim.carry)
            if kept:
                kept[-1].append([t.clone() for t in
                                 chain._leaves(kept[-1][0])])
            kept.append([sim.carry, [t.clone() for t in
                                     chain._leaves(sim.carry)]])
            movetype += outs.movetype.tolist()
            accepted += outs.accepted.tolist()
            sim.carry = sim.refresh(sim.carry)
            if k == GROW_AFTER:
                sim._grow_capacity(sim.carry)
        torch.cuda.synchronize()
        snap = tracing.snapshot()
        tracing.disable()
    assert sim.state.n_atom_slots > slots
    return movetype, accepted, sim.carry, snap, kept[:-1]


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    scale = torch.clamp(b.abs().max(), min=1e-300)
    return float((a - b).abs().max() / scale)


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["h2", "co2"])
def test_graphed_chain_is_the_eager_chain(cuda, system, tmp_path,
                                          monkeypatch):
    co2.write_pqr(str(tmp_path / "sys.pqr"), co2.records(model=system))
    (tmp_path / "run.in").write_text(RUN_IN[system].format(
        n=CORRTIME, seed=2147483649, L=co2.L))
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "run.in")
    m_e, a_e, c_e, s_e, _ = _drive(path, False)
    m_g, a_g, c_g, s_g, kept = _drive(path, True)
    moves = CORRTIMES * CORRTIME
    assert len(m_g) == moves and m_g == m_e and a_g == a_e
    assert sum(a_g) > 0 and const.MOVETYPE_INSERT in m_g
    for a, b in ((c_g.state.pos, c_e.state.pos), (c_g.state.mu, c_e.state.mu),
                 (c_g.obs.rd_energy, c_e.obs.rd_energy),
                 (c_g.obs.coulombic_energy, c_e.obs.coulombic_energy),
                 (c_g.obs.polarization_energy, c_e.obs.polarization_energy),
                 (c_g.recip_e, c_e.recip_e)):
        assert _rel(a, b) <= 1e-12
    # the graph's launches are counted as the eager loop's
    assert s_g["launches"] == s_e["launches"]
    if system == "h2":
        got = s_g["launches"]
        assert got["K2 write_plane_strips"] > 0 and got["K3 occupancy"] > 0
        assert sum(got[k] for k in CONTRACTIONS) >= 4 * moves
    # one eager move per layout, a capture per layout and per refreshed
    # plane set (the refresh leaves a chain without polarization none),
    # every other move replayed
    layouts = 2
    assert s_e["counters"]["graph_eager"] == {"step": moves}
    assert s_g["counters"]["graph_eager"] == {"step": layouts}
    assert s_g["counters"]["graph_capture"] == {
        "step": CORRTIMES if system == "h2" else layouts}
    assert s_g["counters"]["graph_replay"] == {"step": moves - layouts}
    # no later chunk wrote a carry the runner returned
    for _, returned, later in kept:
        for a, b in zip(returned, later):
            assert torch.equal(a, b)


# -- the path-integral runner ------------------------------------------------


# The PI runner (mc/pi.py: ``pi.graphs_apply``, ``make_pi_chunk_runner``
# over graph.MoveGraph, one graph a move type): the rule case by case,
# the Coker staging at a device anchor, the eager loop on the CPU, and
# the graph's bookkeeping against the eager chain on the CPU with each
# capture stood in for by a rerun of its move on the graph's buffers.

PI_CHUNK, PI_CHUNKS = 8, 3


def _pi_stack():
    return pi.stack_states([co2.torch_co2_lj_ewald()[0]] * 2)


# case -> (device, incremental, bead-sharded, marking, graph)
PI_RULE = {"cuda-incremental": ("cuda", True, False, False, True),
           "cpu": ("cpu", True, False, False, False),
           "full-recompute": ("cuda", False, False, False, False),
           "bead-sharded": ("cuda", True, True, False, False),
           "tracer-marking": ("cuda", True, False, True, False)}


@pytest.mark.parametrize("case", sorted(PI_RULE))
def test_pi_graph_rule(case):
    device, incremental, sharded, marking, want = PI_RULE[case]
    stack = _pi_stack()
    if sharded:
        stack = meshing.BeadShards.split(
            stack, meshing.make_mesh(devices=["cpu"] * 2))
    assert pi.graphs_apply(torch.device(device), incremental, stack,
                           marking) is want


@pytest.mark.parametrize("anchor", range(16))
def test_coker_at_a_device_anchor_is_the_int_anchors(anchor):
    """A Coker staging of 4 beads at P = 16 from a 0-d device anchor is
    bitwise the one from the host int."""
    coms = rnd.normal(rnd.PRNGKey(3), (16, 3)) * 0.4
    normals = rnd.normal(rnd.split(rnd.PRNGKey(4), 4), (3,))
    mass = torch.tensor(2.016, dtype=torch.float64)
    want = pi.coker_stage_coms(coms, normals, 4, anchor, mass, 25.0, 16)
    got = pi.coker_stage_coms(coms, normals, 4, torch.tensor(anchor),
                              mass, 25.0, 16)
    assert torch.equal(got, want)
    assert not torch.equal(want, coms)


def test_coker_at_a_device_anchor_stages_the_whole_system():
    """thermalize's form: every molecule's ring at once, n = P, anchor
    0."""
    P, M = 16, 5
    coms = rnd.normal(rnd.PRNGKey(5), (M, P, 3)) * 0.4
    normals = rnd.normal(rnd.split(rnd.split(rnd.PRNGKey(6), M), P), (3,))
    mass = torch.linspace(1.0, 3.0, M, dtype=torch.float64)
    want = pi.coker_stage_coms(coms, normals, P, 0, mass, 25.0, P)
    got = pi.coker_stage_coms(coms, normals, P, torch.tensor(0), mass,
                              25.0, P)
    assert torch.equal(got, want)


def test_pi_runner_on_the_cpu_runs_every_move_eager(tmp_path):
    sim = pi_system.simulation(tmp_path, pi_system.CPU["para-h2"], "cpu")
    run = sim._chunk_runner(PI_CHUNK)
    tracing.enable()
    carry = sim.carry
    for _ in range(2):
        carry, _ = run(carry)
    snap = tracing.snapshot()
    assert snap["moves"] == 2 * PI_CHUNK
    assert snap["counters"]["graph_eager"] == {"pi.step": 2 * PI_CHUNK}
    assert not snap["counters"].get("graph_capture")
    assert not snap["counters"].get("graph_replay")


def _drive_pi(d, system, device, graphed):
    """PI_CHUNKS chunks of PI_CHUNK moves of a PISimulation of ``system``,
    each chunk followed by the corrtime's per-bead recompute; with
    ``graphed`` off the runner's eager loop runs every move.  Returns
    (the moves' movetype, accepted and Boltzmann factor, the carry after
    the last chunk, the tracer's snapshot, [a returned carry's leaves as
    returned, and after the next chunk])."""
    with pytest.MonkeyPatch.context() as mp:
        if not graphed:
            mp.setattr(pi, "graphs_apply", lambda *a, **k: False)
        elif device == "cpu":
            mp.setattr(pi, "graphs_apply", lambda *a, **k: True)
            _rerun_captures(mp)
        sim = pi_system.simulation(d, system, device)
        run = sim._chunk_runner(PI_CHUNK)
        carry = sim.carry
        tracing.reset()
        tracing.enable()
        movetype, accepted, bf, kept = [], [], [], []
        for _ in range(PI_CHUNKS):
            carry, outs = run(carry)
            if kept:
                kept[-1].append([t.clone() for t in pi._leaves(kept[-1][0])])
            kept.append([carry, [t.clone() for t in pi._leaves(carry)]])
            movetype += outs.movetype.tolist()
            accepted += outs.accepted.tolist()
            bf.append(outs.boltzmann_factor)
            last = carry
            carry = sim._recompute(carry)
        if device != "cpu":
            torch.cuda.synchronize()
        snap = tracing.snapshot()
        tracing.disable()
    return (movetype, accepted, torch.cat(bf)), last, snap, \
        [k[1:] for k in kept[:-1]]


def _assert_same_pi_chain(eager, graphed):
    (o_e, c_e, s_e, _), (o_g, c_g, s_g, kept) = eager, graphed
    moves = PI_CHUNKS * PI_CHUNK
    assert o_g[0] == o_e[0] and o_g[1] == o_e[1]
    assert torch.equal(o_g[2], o_e[2])
    assert len(o_g[0]) == moves and len(set(o_g[0])) == 2
    assert 0 < sum(o_g[1]) < moves
    for a, b in ((c_g.stack.pos, c_e.stack.pos),
                 (c_g.comps_per_bead, c_e.comps_per_bead),
                 (c_g.sf.re, c_e.sf.re), (c_g.sf.im, c_e.sf.im),
                 (c_g.potential_current, c_e.potential_current),
                 (c_g.obs_components, c_e.obs_components),
                 (c_g.accept, c_e.accept), (c_g.reject, c_e.reject),
                 (c_g.step, c_e.step), (c_g.bf, c_e.bf)):
        assert torch.equal(a, b)
    assert c_g.starter_bead == c_e.starter_bead
    # one eager move and one capture a move type, every other move
    # replayed (the recompute moves no tensor the graphs read in place)
    assert s_e["counters"]["graph_eager"] == {"pi.step": moves}
    assert s_g["counters"]["graph_eager"] == {"pi.step": 2}
    assert s_g["counters"]["graph_capture"] == {"pi.step": 2}
    assert s_g["counters"]["graph_replay"] == {"pi.step": moves - 2}
    assert s_g["moves"] == moves
    for name in ("pi.draws", "pi.stats"):
        assert s_g["spans"][name]["count"] == PI_CHUNKS
    # no later chunk wrote a carry the runner returned
    for returned, later in kept:
        for a, b in zip(returned, later):
            assert torch.equal(a, b)


@pytest.mark.parametrize("system", sorted(pi_system.CPU))
def test_pi_graph_bookkeeping_keeps_the_eager_chain(system, tmp_path):
    """On the CPU, with each capture a rerun of its move: the graph's
    buffers, anchors, output columns and move types give the eager chain
    bitwise."""
    _assert_same_pi_chain(
        _drive_pi(tmp_path, pi_system.CPU[system], "cpu", False),
        _drive_pi(tmp_path, pi_system.CPU[system], "cpu", True))


@pytest.mark.gpu
@pytest.mark.parametrize("system", sorted(pi_system.CARD))
def test_graphed_pi_chain_is_the_eager_chain(cuda, system, tmp_path):
    """A PISimulation whose chunks replay a graph a move type runs the
    chain of its eager loop over make_pi_step, seed for seed and bitwise,
    through the corrtime recomputes: 64 para-H2 and 27 two-site H2 with
    orientation data, P = 8."""
    _assert_same_pi_chain(
        _drive_pi(tmp_path, pi_system.CARD[system], "cuda", False),
        _drive_pi(tmp_path, pi_system.CARD[system], "cuda", True))
