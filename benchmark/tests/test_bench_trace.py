"""The traced run's reading: markers split the device trace by span, and
each per-layer reader reads its metric from the record, or nothing."""

import pytest

from benchmark import roofline, trace
from benchmark.manifest import Manifest

MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"
K5 = "contract_sym_kernel(CUtensorMap, CUtensorMap, CUtensorMap, int)"
MUL = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
       "AUnaryFunctor<double, double, double, at::native::binary_internal::"
       "MulFunctor<double> >, std::array<char*, 2ul> >(int)")
BOUNDS = [("start", "stretch"), ("start", "chunk"), ("end", "chunk"),
          ("start", "refresh"), ("end", "refresh"), ("start", "host_read"),
          ("end", "host_read"), ("end", "stretch")]
OPS = [(MARK, 0.0, 0.1), (MARK, 1.0, 0.1), (K5, 2.0, 1.0), (MUL, 4.0, 1.0),
       (MARK, 6.0, 0.1), (MARK, 7.0, 0.1), (MUL, 8.0, 2.0),
       (MARK, 11.0, 0.1), (MARK, 12.0, 0.1), ("Memcpy DtoH", 12.5, 0.1),
       (MARK, 13.0, 0.1), (MARK, 14.0, 0.1)]


def _record(**kw):
    man = Manifest()
    ops, segs = trace.segment(OPS, BOUNDS)
    rec = {"refresh_s": [1.5, 2.5], "iterations": [4.0, 4.0, 6.0],
           "slots": 19712, "planes": 3, "palmo": False,
           "kernels": man.kernels(), "ops": ops, "segments": segs,
           "chunk_iterations": [4.0, 4.0], "peak": man.peaks()["H100"]}
    rec.update(kw)
    return man, rec


def test_segment_labels_ops_by_span():
    ops, segs = trace.segment(OPS, BOUNDS)
    assert [(o[0][:8], o[3]) for o in ops] == [
        (K5[:8], "chunk"), (MUL[:8], "chunk"), (MUL[:8], "refresh"),
        ("Memcpy D", "host_read")]
    assert ("chunk", 1.0, 6.1) in segs and ("stretch", 0.0, 14.1) in segs
    assert trace.segment(OPS[:-2] + OPS[-1:], BOUNDS) is None


def test_union_and_breakdown():
    assert trace.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    man, rec = _record()
    bd = trace.breakdown(rec["ops"], rec["segments"], rec["kernels"])
    names = dict(bd["device_ops"])
    assert names["torch vectorized_elementwise_kernel MulFunctor"] == 3.0
    assert names["K5 contract_planes_sym"] == 1.0
    gaps = dict(bd["idle_gaps"])
    assert gaps["chunk (sum)"] == pytest.approx(1.0)
    assert gaps["refresh (longest)"] == pytest.approx(3.0)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_readers():
    man, rec = _record()
    read = {m["name"]: man.reader(m["name"]) for m in man.data["per_layer"]}
    assert read["refresh_ms"](rec) == pytest.approx(2000.0)
    assert read["scf_iters_per_move"](rec) == pytest.approx(14.0 / 3.0)
    assert read["launches_per_move"](rec) == pytest.approx(1.0)
    assert read["device_idle_pct"](rec) == pytest.approx(
        100.0 * (1.0 - 2.0 / 5.1))
    least = roofline.contraction_least_s(19712, 3, rec["peak"])
    assert read["contraction_roofline_pct"](rec) == pytest.approx(
        100.0 * 8 * least / 1.0)
    _, palmo = _record(palmo=True)
    assert read["contraction_roofline_pct"](palmo) == pytest.approx(
        100.0 * 10 * least / 1.0)


def test_readers_find_nothing_and_return_nothing():
    man, rec = _record(refresh_s=[], iterations=[], ops=None, segments=None,
                       chunk_iterations=None)
    for m in man.data["per_layer"]:
        assert man.reader(m["name"])(rec) is None, m["name"]
    _, no_k = _record(ops=[o for o in _record()[1]["ops"]
                           if "contract" not in o[0]])
    assert man.reader("contraction_roofline_pct")(no_k) is None


def test_roofline_of_the_cells():
    """The contraction's bound at the CO2 cell's 19,712 slots is the bytes
    of one triangle with its diagonal: 0.6961 ms (PERF.md's kernels table
    gives K5's 0.698, its 64-row tile triangle)."""
    pk = Manifest().peaks()["H100"]
    A = 19712
    nbytes = 3 * (A * (A + 1) // 2) * 4 + 6 * A * 4
    assert roofline.contraction_least_s(A, 3, pk) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)
    assert 0.696e-3 < nbytes / 3.35e12 < 0.6962e-3
    assert roofline.peak(Manifest().peaks(), "NVIDIA H100 80GB HBM3") == pk
    assert roofline.peak(Manifest().peaks(), "cpu") is None
