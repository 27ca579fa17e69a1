"""The port's tracer (mpmcxx_tpu_torch/tracing.py): a disabled span is the
shared no-op; spans nest into per-name aggregates with self time;
counters go to the innermost span; the snapshot carries K1-K6's
launches; the chain's carry after a chunk is bitwise the same with
tracing off, on, and on with device marking; and every span of the
chain, the refresh, the set-up and the runner opens where it should, the
per-move ones once a move.  The small cuts are tests/torch_co2_system.py's
systems: H2 (polarizable, 768 slots) with cavity bias, and CO2 without
polarization on the incremental and the full-recompute branches; the
path-integral chain's spans on a small para-H2 stack
(tests/torch_pi_system.py), in a chunk and in a CLI run.

The ``gpu`` tests run on the card (``python -m pytest
tests/test_torch_tracing.py -m gpu --noconftest``; this file imports no
jax): host syncs are counted, and the device markers appear in a profiled
chunk once per boundary the tracer made."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_co2_system as co2  # noqa: E402
import torch_pi_system as pi_system  # noqa: E402
from mpmcxx_tpu_torch import cli, tracing  # noqa: E402
from mpmcxx_tpu_torch import constants as const  # noqa: E402
from mpmcxx_tpu_torch.mc import chain  # noqa: E402
from mpmcxx_tpu_torch.ops import cuda_cavity, cuda_pairs, cuda_polar  # noqa: E402
from mpmcxx_tpu_torch.state import topology  # noqa: E402

CHUNK = 4
MARKER = "mpmcxx_span_mark_kernel"
# the spans of every move on each cut's branch
MOVE_SPANS = ("step", "step.target", "step.move", "step.accept")
H2_SPANS = MOVE_SPANS + ("step.cavity", "step.delta_e", "step.polar",
                         "step.polar.scf", "step.commit")
CO2_SPANS = MOVE_SPANS + ("step.delta_e",)
FULL_SPANS = MOVE_SPANS + ("step.full_recompute",)
REFRESH_SPANS = ("refresh", "refresh.energy", "refresh.sf",
                 "refresh.polar_cache")


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


_h2, _co2 = co2.torch_h2_cavity, co2.torch_co2_lj_ewald
CUTS = {"h2": (_h2, H2_SPANS), "co2": (_co2, CO2_SPANS),
        "co2-full": (lambda: _co2(incremental=False), FULL_SPANS)}


def _chunk(system, seed=3):
    """A fresh carry of ``system`` after one chunk, and the refresher."""
    state, flags, params, opts = system
    carry = chain.init_carry(state, flags, params, opts, seed=seed)
    run = chain.make_chunk_runner(flags, params, opts, CHUNK,
                                  topology=topology(state))
    carry, outs = run(carry)
    return carry, outs, chain.make_refresher(flags, params, opts)


def _tensors(tree, prefix=""):
    """Every tensor of a carry (or StepOut) by its path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if tree is None or isinstance(tree, (int, float, bool)):
        return {prefix: tree}
    if dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    else:
        items = tree._asdict().items()
    out = {}
    for k, v in items:
        out.update(_tensors(v, f"{prefix}.{k}"))
    return out


def _assert_bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k, x in ta.items():
        y = tb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.detach().cpu().numpy().tobytes() == \
                y.detach().cpu().numpy().tobytes(), k
        else:
            assert x == y, k


def test_disabled_span_is_the_shared_noop(monkeypatch):
    def no_clock():
        raise AssertionError("a disabled span read the clock")

    monkeypatch.setattr(tracing, "_clock", no_clock)
    assert not tracing.enabled()
    s = tracing.span("step")
    assert s is tracing.NOOP and tracing.span("x", move=True) is s
    with s:
        with tracing.span("step.polar"):
            tracing.count(tracing.SYNC)
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["moves"] == 0
    assert all(not v for v in snap["counters"].values())
    assert tracing.marks() == ([], [])


def test_nesting_self_time_and_counters(monkeypatch):
    """On a clock that ticks 10 ns a read: step [0, 50] holds polar [10,
    40], which holds scf [20, 30]."""
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    tracing.enable()
    with tracing.span("step", move=True):
        with tracing.span("step.polar"):
            tracing.count("probe")
            with tracing.span("step.polar.scf"):
                tracing.count("probe", 2)
        tracing.count("probe")
    tracing.count("probe")
    snap = tracing.snapshot()
    spans = snap["spans"]
    assert spans["step"] == {"count": 1, "total_ns": 50, "self_ns": 20,
                             "max_ns": 50}
    assert spans["step.polar"] == {"count": 1, "total_ns": 30,
                                   "self_ns": 20, "max_ns": 30}
    assert spans["step.polar.scf"] == {"count": 1, "total_ns": 10,
                                       "self_ns": 10, "max_ns": 10}
    assert snap["counters"]["probe"] == {"step.polar": 1,
                                         "step.polar.scf": 2, "step": 1,
                                         "": 1}
    assert snap["moves"] == 1
    json.dumps(snap)
    # a second, longer move: count, total and max fold
    with tracing.span("step", move=True):
        with tracing.span("step.polar"):
            pass
        next(ticks)
        next(ticks)
    s = tracing.snapshot()["spans"]["step"]
    assert s == {"count": 2, "total_ns": 50 + 50, "self_ns": 20 + 40,
                 "max_ns": 50}
    tracing.reset()
    assert tracing.snapshot()["spans"] == {}


def test_snapshot_carries_the_kernel_launches(monkeypatch):
    """K1-K6's ``.launches`` are the one store: the snapshot reads each
    wrapper's count since the last reset."""
    tracing.enable()
    for fn, n in ((cuda_polar.contract_planes_sym, 3),
                  (cuda_polar.write_plane_strips, 2),
                  (cuda_cavity.occupancy, 1),
                  (cuda_pairs.pair_sums, 4)):
        monkeypatch.setattr(fn, "launches", fn.launches + n)
    got = tracing.snapshot()["launches"]
    assert got == {"K1 contract_planes": 0, "K2 write_plane_strips": 2,
                   "K3 occupancy": 1, "K4 contract_planes_tri": 0,
                   "K5 contract_planes_sym": 3, "K6 pair_energy": 4}
    tracing.reset()
    assert set(tracing.snapshot()["launches"].values()) == {0}


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_carry_is_bitwise_equal_with_tracing_off_and_on(cut):
    build, _ = CUTS[cut]
    off, outs_off, _ = _chunk(build())
    tracing.enable()
    on, outs_on, _ = _chunk(build())
    tracing.disable()
    tracing.enable(mark_device=True)
    marked, outs_marked, _ = _chunk(build())
    assert tracing.marks() == ([], [])    # marking is a no-op on the CPU
    for carry, outs in ((on, outs_on), (marked, outs_marked)):
        _assert_bitwise(carry, off)
        _assert_bitwise(outs, outs_off)


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_every_span_opens_once_a_move(cut):
    build, spans = CUTS[cut]
    system = build()
    tracing.enable()
    carry, _, refresh = _chunk(system)
    snap = tracing.snapshot()
    got = snap["spans"]
    assert snap["moves"] == CHUNK
    for name in spans:
        assert got[name]["count"] == CHUNK, name
    assert got["draws"]["count"] == got["stats"]["count"] == 1
    assert got["setup.init_carry"]["count"] == 1
    per_move = {k for k in got if k.startswith("step")}
    assert per_move == set(spans)
    # the children's time lies inside the move's
    inner = sum(got[k]["total_ns"] for k in spans
                if k.count(".") == 1)
    assert inner <= got["step"]["total_ns"]
    tracing.reset()
    refresh(carry)
    got = tracing.snapshot()["spans"]
    assert set(got) == set(REFRESH_SPANS)
    assert all(v["count"] == 1 for v in got.values())
    parts = sum(got[k]["total_ns"] for k in REFRESH_SPANS[1:])
    assert got["refresh"]["self_ns"] == got["refresh"]["total_ns"] - parts


RUN_IN = """job_name tr
ensemble uvt
temperature 77.0
pressure 20.0
insert_probability 0.3
move_factor 0.1
numsteps 8
corrtime 4
seed 0
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
pqr_input h2.pqr
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
"""


def test_cli_trace_writes_the_snapshot(tmp_path, monkeypatch):
    """``--trace FILE``: the set-up, chain, refresh, corrtime and output
    spans of a CLI run, written as JSON at its end; the tracer is off
    afterwards.  A regrowth opens ``grow_capacity`` (with its init)."""
    co2.write_pqr(str(tmp_path / "h2.pqr"), co2.records(model="h2"))
    (tmp_path / "run.in").write_text(RUN_IN.format(L=co2.L))
    monkeypatch.chdir(tmp_path)
    rc, sim = cli.run(["--device", "cpu", "--quiet", "--trace",
                       "spans.json", "run.in"])
    assert rc == 0 and not tracing.enabled()
    snap = json.loads((tmp_path / "spans.json").read_text())
    got = snap["spans"]
    assert snap["moves"] == 8
    for name in H2_SPANS:
        assert got[name]["count"] == 8, name
    for name in REFRESH_SPANS:
        assert got[name]["count"] == 2, name
    assert got["draws"]["count"] == got["stats"]["count"] == 2
    assert got["setup.build_state"]["count"] == 1
    assert got["setup.init_carry"]["count"] == 1
    # the initial state's and each corrtime's
    assert got["corrtime_io"]["count"] == 3
    assert got["output"]["count"] == 2
    for v in got.values():
        assert 0 <= v["self_ns"] <= v["total_ns"] and \
            v["max_ns"] <= v["total_ns"]
    tracing.reset()
    tracing.enable()
    sim._grow_capacity(sim.carry)
    got = tracing.snapshot()["spans"]
    assert got["grow_capacity"]["count"] == 1
    assert got["setup.init_carry"]["count"] == 1


GIBBS_MOVE_SPANS = ("gibbs.step", "gibbs.step.move", "gibbs.step.delta_e",
                    "gibbs.step.accept")
GIBBS_REFRESH_SPANS = ("gibbs.refresh", "gibbs.refresh.energy",
                       "gibbs.refresh.sf")


def _gibbs(tmp_path, corrtime=8):
    """The CLI's GibbsSimulation of two small boxes of TraPPE CO2 (the
    benchmark's model and lattice generator; 8 and 4 molecules in 20 A
    boxes, transfers and volume exchanges frequent), on the incremental
    path."""
    from benchmark.inputs import geometry
    from benchmark.manifest import Manifest
    from mpmcxx_tpu_torch.config.parser import read_config
    model = Manifest().config("co2-trappe-vle-250k")["model"]
    for name, n, seed in (("a.pqr", 8, 3), ("b.pqr", 4, 4)):
        geometry.write_pqr(str(tmp_path / name), model, geometry.molecules(
            model, {"seed": seed, "box": 20.0, "molecules": n,
                    "jitter": 0.3}))
    (tmp_path / "run.in").write_text(GIBBS_RUN_IN.format(
        L=20.0, corrtime=corrtime, d=tmp_path))
    sim = cli.dispatch(read_config(str(tmp_path / "run.in")), 1,
                       quiet=True, device="cpu")
    assert sim.opts.incremental
    return sim


GIBBS_RUN_IN = """job_name gb
ensemble nvt_gibbs
temperature 250.0
transfer_probability 0.4
volume_probability 0.3
volume_change_factor 0.1
move_factor 0.1
numsteps 16
corrtime {corrtime}
seed 4
pqr_input {d}/a.pqr
pqr_input_B {d}/b.pqr
energy_output off
pqr_output /dev/null
pqr_restart off
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
"""


def test_gibbs_chunk_spans_and_counters(tmp_path):
    """A Gibbs chunk with the tracer on opens each of its spans, once a
    move for the step's, and counts each move under its host pick; the
    carry is bitwise the one with the tracer off, which records
    nothing."""
    from mpmcxx_tpu_torch.mc import gibbs
    n = 12

    def chunk():
        sim = _gibbs(tmp_path)
        carry = gibbs.init_gibbs_carry(
            sim.state_a, sim.state_b, sim.flags, sim.params, sim.opts,
            sim.seed, sim.cfg.temperature)
        run = gibbs.make_gibbs_chunk_runner(sim.flags, sim.params,
                                            sim.opts, n, sim.topologies)
        carry, outs = run(carry)
        refresh = gibbs.make_gibbs_refresher(sim.flags, sim.params,
                                             sim.opts)
        return refresh(carry), outs

    off, outs_off = chunk()
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["moves"] == 0
    assert all(not v for v in snap["counters"].values())
    tracing.enable()
    on, outs_on = chunk()
    snap = tracing.snapshot()
    tracing.disable()
    _assert_bitwise(on, off)
    _assert_bitwise(outs_on, outs_off)
    got = snap["spans"]
    assert snap["moves"] == n
    for name in GIBBS_MOVE_SPANS:
        assert got[name]["count"] == n, name
    assert got["gibbs.draws"]["count"] == got["gibbs.stats"]["count"] == 1
    for name in GIBBS_REFRESH_SPANS:
        assert got[name]["count"] == 1, name
    assert got["setup.build_state"]["count"] == 1
    assert got["setup.init_carry"]["count"] == 1
    inner = sum(got[k]["total_ns"] for k in GIBBS_MOVE_SPANS[1:])
    assert inner <= got["gibbs.step"]["total_ns"]
    parts = sum(got[k]["total_ns"] for k in GIBBS_REFRESH_SPANS[1:])
    assert got["gibbs.refresh"]["self_ns"] == \
        got["gibbs.refresh"]["total_ns"] - parts
    # one count a move, on the move's span, by the host's pick
    picks = {k: v for k, v in snap["counters"].items()
             if k in gibbs.COUNTERS.values()}
    assert sum(c["gibbs.step"] for c in picks.values()) == n
    assert all(set(c) == {"gibbs.step"} for c in picks.values())
    moves = [int(m) for m in outs_on.movetype]
    assert picks.get("gibbs_volume", {}).get("gibbs.step", 0) == \
        moves.count(const.MOVETYPE_VOLUME) > 0
    assert picks["gibbs_transfer"]["gibbs.step"] > 0


def test_cli_trace_of_a_gibbs_run(tmp_path, monkeypatch):
    """``--trace FILE`` on a Gibbs input writes every Gibbs span and
    counter: 16 moves in two corrtimes of 8."""
    _gibbs(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc, sim = cli.run(["--device", "cpu", "--quiet", "--trace",
                       "spans.json", "run.in"])
    assert rc == 0 and not tracing.enabled()
    snap = json.loads((tmp_path / "spans.json").read_text())
    got = snap["spans"]
    assert snap["moves"] == 16
    for name in GIBBS_MOVE_SPANS:
        assert got[name]["count"] == 16, name
    for name in GIBBS_REFRESH_SPANS + ("gibbs.draws", "gibbs.stats"):
        assert got[name]["count"] == 2, name
    assert got["corrtime_io"]["count"] == 3
    assert got["setup.build_state"]["count"] == 1
    assert got["setup.init_carry"]["count"] == 1
    counted = {k for k, v in snap["counters"].items() if v}
    assert counted >= {"gibbs_displace", "gibbs_transfer"}
    assert sum(snap["counters"][k]["gibbs.step"] for k in counted) == 16


PI_SPANS = ("pi.draws", "pi.step", "pi.stats")


def _pi_chunks(tmp_path, n=2):
    """``n`` chunks of 8 moves of a small para-H2 PISimulation on the
    CPU, each followed by the per-bead recompute."""
    sim = pi_system.simulation(tmp_path, pi_system.CPU["para-h2"], "cpu")
    run = sim._chunk_runner(8)
    carry, outs = sim.carry, []
    for _ in range(n):
        carry, o = run(carry)
        outs.append(o)
        carry = sim._recompute(carry)
    return carry, outs


def test_pi_chunk_spans_and_counters(tmp_path):
    """A PI chunk with the tracer on opens ``pi.draws`` and ``pi.stats``
    once and ``pi.step`` once a move, on which each move counts as
    ``graph_eager`` on the CPU; the carry is bitwise the one with the
    tracer off, which records nothing."""
    off, outs_off = _pi_chunks(tmp_path)
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["moves"] == 0
    tracing.enable()
    on, outs_on = _pi_chunks(tmp_path)
    snap = tracing.snapshot()
    tracing.disable()
    _assert_bitwise(on, off)
    for a, b in zip(outs_on, outs_off):
        _assert_bitwise(a, b)
    got = snap["spans"]
    assert snap["moves"] == 16 and set(got) == set(PI_SPANS)
    assert got["pi.step"]["count"] == 16
    assert got["pi.draws"]["count"] == got["pi.stats"]["count"] == 2
    assert snap["counters"]["graph_eager"] == {"pi.step": 16}


def test_cli_trace_of_a_pi_run(tmp_path, monkeypatch):
    """``--trace FILE`` on a PI input writes its spans and the graph
    counters on ``pi.step``: 16 moves in two corrtimes of 8."""
    pi_system.write(str(tmp_path), pi_system.CPU["para-h2"], steps=16)
    monkeypatch.chdir(tmp_path)
    rc, sim = cli.run(["--device", "cpu", "--quiet", "-P", "8", "--trace",
                       "spans.json", "run.in"])
    assert rc == 0 and not tracing.enabled()
    snap = json.loads((tmp_path / "spans.json").read_text())
    got = snap["spans"]
    assert snap["moves"] == 16 and got["pi.step"]["count"] == 16
    assert got["pi.draws"]["count"] == got["pi.stats"]["count"] == 2
    assert snap["counters"]["graph_eager"] == {"pi.step": 16}


def test_every_span_of_the_program_is_documented():
    """The tracer's docstring lists every span the program opens and
    every counter it counts (PERF.md section 3 says what reads each)."""
    import pathlib
    import re
    root = pathlib.Path(tracing.__file__).parent
    opened, counted = set(), set()
    for path in root.rglob("*.py"):
        text = path.read_text()
        opened |= set(re.findall(r'tracing\.span\("([\w.]+)"', text))
        counted |= set(re.findall(r'tracing\.count\("([\w.]+)"', text))
    opened |= set(REFRESH_SPANS[1:])
    doc = set(re.findall(r"``([\w.]+)``", tracing.__doc__))
    assert opened and opened <= doc
    assert opened == set(H2_SPANS + FULL_SPANS + REFRESH_SPANS) | {
        "draws", "stats", "corrtime_io", "grow_capacity",
        "setup.build_state", "setup.init_carry", "setup.library",
        "output"} | set(GIBBS_MOVE_SPANS + GIBBS_REFRESH_SPANS) | {
        "gibbs.draws", "gibbs.stats"} | set(PI_SPANS)
    from mpmcxx_tpu_torch.mc import gibbs
    counted |= set(gibbs.COUNTERS.values())
    assert counted | {tracing.SYNC} <= doc
    assert counted == {"graph_capture", "graph_replay", "graph_eager",
                       "gibbs_displace", "gibbs_transfer", "gibbs_volume",
                       "gibbs_spin", "pair_kernel", "pair_plain"}


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_host_syncs_are_counted_by_span(cuda):
    x = torch.ones(8, device=cuda)
    tracing.enable()
    with tracing.span("step"):
        y = x * 2.0 + 1.0
    with tracing.span("step.polar"):
        assert bool(y[0] > 0)
    snap = tracing.snapshot()
    tracing.disable()
    assert snap["counters"][tracing.SYNC] == {"step.polar": 1}
    # the mode is restored, and off nothing is counted
    assert torch.cuda.get_sync_debug_mode() == 0
    assert bool(y[1] > 0)
    assert tracing.snapshot()["counters"][tracing.SYNC] == {"step.polar": 1}


@pytest.mark.gpu
def test_device_markers_split_a_profiled_chunk(cuda):
    """With ``mark_device``, the profiled chunk holds one marker kernel
    per boundary made, in the order made, and the carry is bitwise the
    unmarked one's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    off, outs_off, _ = _chunk(_h2(cuda))
    torch.cuda.synchronize()
    for _ in range(3):   # the profiler now and then records no device event
        tracing.reset()
        tracing.enable(mark_device=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            on, outs_on, _ = _chunk(_h2(cuda))
            torch.cuda.synchronize()
        tracing.disable()
        bounds, spans = tracing.marks()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    marks = [n for n in names if MARKER in n]
    assert bounds and len(marks) == len(bounds)
    assert sum(k == "start" for k, _, _ in bounds) == len(spans)
    assert [n for k, n, _ in bounds if k == "start"].count("step") == CHUNK
    assert not any("spin_kernel" in n for n in marks)
    _assert_bitwise(on, off)
    _assert_bitwise(outs_on, outs_off)
    assert np.all(np.diff([ns for _, _, ns in bounds]) >= 0)
