"""The program's spans in a traced run (benchmark/program_trace.py): both
kinds of marker split a device trace by harness span and program span; a
dropped marker gives nothing; each new reader reads its metric from a
record, or nothing where the record lacks the program's keys (a program
without the tracer, a CPU run); and a small cut's run reads the host
spans through the harness's loop."""

import pytest

from benchmark import program_trace as pt
from benchmark import trace
from benchmark.manifest import Manifest
from benchmark.tests import small

H = "at::cuda::(anonymous namespace)::spin_kernel(long)"
P = "mpmcxx_span_mark_kernel(int)"
K5 = "contract_sym_kernel(CUtensorMap, CUtensorMap, CUtensorMap, int)"
MUL = "vectorized_elementwise_kernel MulFunctor"
BOUNDS = [("start", "stretch"), ("start", "chunk"), ("end", "chunk"),
          ("start", "refresh"), ("end", "refresh"), ("end", "stretch")]
PBOUNDS = [("start", "step", 10), ("start", "step.polar", 11),
           ("start", "step.polar.scf", 12), ("end", "step.polar.scf", 13),
           ("end", "step.polar", 14), ("end", "step", 15),
           ("start", "refresh", 20), ("start", "refresh.energy", 21),
           ("end", "refresh.energy", 22), ("end", "refresh", 23)]
# (name, start, duration): the chunk's move launches a Mul in step.polar,
# K5 in its SCF and a Mul in the step itself; the refresh a Mul in its
# energy and another after it
OPS = [(H, 0.0, 0.1), (H, 1.0, 0.1), (P, 1.2, 0.1), (P, 1.4, 0.1),
       (MUL, 2.0, 0.5), (P, 3.0, 0.1), (K5, 4.0, 1.0), (P, 5.5, 0.1),
       (P, 5.7, 0.1), (MUL, 6.0, 0.5), (P, 6.6, 0.1), (H, 7.0, 0.1),
       (H, 8.0, 0.1), (P, 8.2, 0.1), (P, 8.4, 0.1), (MUL, 9.0, 2.0),
       (P, 11.5, 0.1), (MUL, 12.0, 0.5), (P, 13.0, 0.1), (H, 14.0, 0.1),
       (H, 15.0, 0.1)]


def _record(**kw):
    snap = {"spans": {
        "step": {"count": 4, "total_ns": 40_000_000, "self_ns": 4_000_000,
                 "max_ns": 12_000_000},
        "step.polar": {"count": 4, "total_ns": 20_000_000,
                       "self_ns": 8_000_000, "max_ns": 6_000_000},
        "step.delta_e": {"count": 4, "total_ns": 6_000_000,
                         "self_ns": 6_000_000, "max_ns": 2_000_000}},
        "counters": {"host_sync": {"step.polar.scf": 12, "step": 2,
                                   "stats": 1, "": 3, "refresh": 5}},
        "moves": 4, "launches": {}}
    rec = pt.record(snap, pt.segment(OPS, BOUNDS, PBOUNDS))
    rec.update(kw)
    return rec


def test_segment_labels_ops_by_both_spans():
    ops, segs = pt.segment(OPS, BOUNDS, PBOUNDS)
    assert [(o[0], o[3]) for o in ops] == [
        (MUL, "chunk/step.polar"), (K5, "chunk/step.polar.scf"),
        (MUL, "chunk/step"), (MUL, "refresh/refresh.energy"),
        (MUL, "refresh/refresh")]
    assert ("chunk/step.polar.scf", 3.0, 5.6) in segs
    assert ("refresh/refresh.energy", 8.4, 11.6) in segs
    assert ("chunk", 1.0, 7.1) in segs and ("stretch", 0.0, 15.1) in segs
    # the harness's own segmentation of the same trace is unchanged
    h_ops, h_segs = trace.segment([o for o in OPS if P not in o[0]], BOUNDS)
    assert [o[3] for o in h_ops] == ["chunk"] * 3 + ["refresh"] * 2
    assert ("chunk", 1.0, 7.1) in h_segs


@pytest.mark.parametrize("drop", [1, 2, 11, 13])
def test_a_dropped_marker_gives_nothing(drop):
    assert pt.segment(OPS[:drop] + OPS[drop + 1:], BOUNDS, PBOUNDS) is None


def test_markers_that_do_not_nest_give_nothing():
    swapped = list(PBOUNDS)
    swapped[3], swapped[4] = swapped[4], swapped[3]
    assert pt.segment(OPS, BOUNDS, swapped) is None
    assert pt.segment(OPS, BOUNDS, []) is None


def test_idle_gaps_by_program_span():
    ops, _ = pt.segment(OPS, BOUNDS, PBOUNDS)
    gaps = dict(pt.idle_gaps(ops))
    # the gap before K5 (2.5 -> 4.0) ends in the SCF, before the step's
    # Mul (5.0 -> 6.0) in the step, ...
    assert gaps["chunk/step.polar.scf (sum)"] == pytest.approx(1.5)
    assert gaps["chunk/step (sum)"] == pytest.approx(1.0)
    assert gaps["refresh/refresh.energy (sum)"] == pytest.approx(2.5)
    assert gaps["refresh/refresh (longest)"] == pytest.approx(1.0)
    assert len(pt.idle_gaps(ops, top=1)) == 2


def test_readers():
    man = Manifest()
    rec = _record()
    read = {m: man.reader(m) for m in pt.READERS}
    assert read["host_syncs_per_move"](rec) == pytest.approx(14 / 4)
    assert read["polar_ms_per_move"](rec) == pytest.approx(5.0)
    assert read["delta_e_ms_per_move"](rec) == pytest.approx(1.5)
    assert read["refresh_energy_ms"](rec) == pytest.approx(3200.0)


def test_readers_find_nothing_and_return_nothing():
    """The harness's own record (no program keys), a program without the
    tracer, a CPU run (no syncs counted, no marked stretch) and a move-less
    window read None."""
    man = Manifest()
    read = {m: man.reader(m) for m in pt.READERS}
    base = {"refresh_s": [], "iterations": [], "ops": None,
            "segments": None}
    for rec in (base, pt.record(None, None)):
        for m, r in read.items():
            assert r(rec) is None, m
    cpu = _record(program_ops=None, program_segments=None)
    del cpu["program"]["counters"]["host_sync"]
    assert read["host_syncs_per_move"](cpu) is None
    assert read["refresh_energy_ms"](cpu) is None
    no_polar = _record()
    del no_polar["program"]["spans"]["step.polar"]
    assert read["polar_ms_per_move"](no_polar) is None
    none_moved = _record()
    del none_moved["program"]["spans"]["step"]
    for m in ("host_syncs_per_move", "polar_ms_per_move",
              "delta_e_ms_per_move"):
        assert read[m](none_moved) is None, m


def test_small_cut_reads_the_program_spans():
    """The H2 cell cut small, on the CPU: the window's host spans are read
    (no sync counts and no marked stretch there), and the ``step`` spans
    hold the chunk's time less its draws and statistics."""
    cfg, tr = small.small("h2-bulk-77k.fixed4")
    out = pt.run("h2-bulk-77k.fixed4", 2 ** 31 + 11, 1.0, device="cpu",
                 config=cfg, traffic=tr)
    m = out["metrics"]
    assert m["polar_ms_per_move"] > 0 and m["delta_e_ms_per_move"] > 0
    assert m["host_syncs_per_move"] is None and m["refresh_energy_ms"] is None
    spans = out["program"]["spans"]
    assert spans["step"]["count"] == out["moves"] == out["program"]["moves"]
    assert out["step_ms_per_move"] + out["draws_stats_ms_per_move"] <= \
        out["chunk_ms_per_move"]
    assert out["setup"]["spans"]["setup.init_carry"]["count"] == 1
    off = pt.run("h2-bulk-77k.fixed4", 2 ** 31 + 11, 1.0, on=False,
                 device="cpu", config=cfg, traffic=tr)
    assert "program" not in off and set(off["metrics"].values()) == {None}
