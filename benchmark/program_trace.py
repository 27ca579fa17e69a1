"""The program's own spans in a traced run, read beside the harness's.

The port times its own spans and counts its host syncs
(``mpmcxx_tpu_torch/tracing.py``: ``step``, ``step.delta_e``,
``step.polar``, ``step.polar.scf``, ``refresh.energy``, ...; the counter
``host_sync``).  A traced run reads them in two ways:

- over the traced window, the tracer's ``snapshot()`` (per-name count,
  total, self and longest host ns; counters by span): the record's
  ``program``;
- in a second profiled stretch of the same shape as the harness's (the
  last ``profile_chunks`` chunks before a corrtime boundary, the refresh,
  the host reads), with the tracer's device marking on: each harness
  span boundary enqueues the harness's marker (``spin_kernel``,
  benchmark/trace.py) and each program span boundary the program's
  (``mpmcxx_span_mark_kernel``).  ``segment`` puts every device op under
  the harness span and the innermost program span whose markers enclose
  its launch (``chunk/step.polar.scf``): the record's ``program_ops`` and
  ``program_segments``.

``metrics/host_syncs_per_move.py``, ``polar_ms_per_move.py``,
``delta_e_ms_per_move.py`` and ``refresh_energy_ms.py`` read these keys,
and ``idle_gaps`` sums the stretch's idle gaps by program span.  A
program without the tracer (``tracer()`` None), a run on the CPU (no
marking, no sync counts) or a stretch whose markers were dropped leaves
the keys empty, and the readers return None.

Stand-alone, one cell's run with the tracer on (or off, ``--off``) over
the harness's window loop, then the marked stretch; one JSON line:

    python3 -m benchmark.program_trace --workload h2-bulk-77k.fixed4 \\
        --seed 7 --seconds 45
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

from . import harness, trace
from .inputs import geometry
from .inputs.runin import run_in
from .manifest import Manifest

MARKER = "mpmcxx_span_mark_kernel"
STEP = "step"
READERS = ("host_syncs_per_move", "polar_ms_per_move",
           "delta_e_ms_per_move", "refresh_energy_ms")


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from mpmcxx_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def segment(ops, bounds, pbounds):
    """Split the device ops [(name, start s, dur s)] at both kinds of
    marker: ``bounds`` [(kind, label)] are the harness's (trace.Spans),
    ``pbounds`` [(kind, span, host ns)] the program's (tracing.marks()),
    each in launch order.  Returns (ops [(name, start, dur, label)]
    without the markers, segments [(label, start, end)] of the harness
    spans and the program spans); a label is the harness span ("harness"
    between spans), then "/" and the innermost program span where one is
    open.  None when the markers seen are not the boundaries made (the
    profiler dropped events) or do not nest."""
    n_h = sum(1 for o in ops if trace.MARKER in o[0])
    n_p = sum(1 for o in ops if MARKER in o[0])
    if not bounds or not pbounds or n_h != len(bounds) or \
            n_p != len(pbounds):
        return None
    out, segs, hstack, pstack = [], [], [], []
    hk = pk = 0

    def outer():
        return hstack[-1][0] if hstack and hstack[-1][0] != "stretch" \
            else "harness"

    for name, start, dur in ops:
        if trace.MARKER in name or MARKER in name:
            harness_mark = trace.MARKER in name
            if harness_mark:
                kind, lab = bounds[hk]
                hk += 1
                stack = hstack
            else:
                kind, lab, _ = pbounds[pk]
                pk += 1
                stack = pstack
            if kind == "start":
                stack.append((lab, start, None if harness_mark
                              else f"{outer()}/{lab}"))
                continue
            if not stack or stack[-1][0] != lab:
                return None
            lab0, s0, full = stack.pop()
            segs.append((full or lab0, s0, start + dur))
            continue
        label = outer() + (f"/{pstack[-1][0]}" if pstack else "")
        out.append((name, start, dur, label))
    return out, segs


def idle_gaps(ops, top: int = 10) -> list:
    """The stretch's idle gaps summed by label (benchmark/trace.py's
    rule: a gap belongs to the span of the op that ends it), for the
    ``top`` labels by sum: "<label> (sum)" and "<label> (longest)"."""
    total, longest = {}, {}
    end = None
    for _, start, dur, label in ops:
        if end is not None and start > end:
            gap = start - end
            total[label] = total.get(label, 0.0) + gap
            longest[label] = max(longest.get(label, 0.0), gap)
        end = start + dur if end is None else max(end, start + dur)
    out = []
    for k in sorted(total, key=lambda k: -total[k])[:top]:
        out += [[f"{k} (sum)", total[k]], [f"{k} (longest)", longest[k]]]
    return out


def record(snapshot, seg) -> dict:
    """The record's program keys: the window's snapshot and the marked
    stretch's segmentation (either None)."""
    ops, segs = seg if seg is not None else (None, None)
    return {"program": snapshot, "program_ops": ops,
            "program_segments": segs}


def per_move(record, value):
    """``value`` over the window's moves (the program's ``step`` count),
    or None without them."""
    prog = record.get("program")
    if value is None or not prog:
        return None
    steps = prog["spans"].get(STEP, {}).get("count", 0)
    return value / steps if steps else None


def span_ms(record, name):
    """Host ms of the window's spans ``name`` in all, or None."""
    prog = record.get("program")
    if not prog or name not in prog["spans"]:
        return None
    return prog["spans"][name]["total_ns"] * 1e-6


def marked_stretch(ch, traffic, spans, tr, tries=harness.PROFILE_TRIES):
    """Profile the harness's stretch once more with the program's
    markers: up to ``tries`` corrtime boundaries; returns ``segment``'s
    result, or None.  Leaves the tracer off."""
    pro_at = max(traffic["corrtime"] // traffic["chunk"] -
                 traffic["profile_chunks"], 0) * ch.chunk
    for _ in range(tries):
        while ch.since != pro_at:
            ch.advance()
            if ch.at_boundary():
                ch.boundary()
        tr.reset()
        tr.enable(mark_device=True)
        stretch = trace.Stretch(spans)
        while not ch.at_boundary():
            ch.advance()
        ch.boundary()
        stretch.stop()
        tr.disable()
        seg = segment(stretch.device_ops(), spans.bounds, tr.marks()[0])
        if seg is not None and seg[0]:
            return seg
    return None


def run(name: str, seed: int, seconds: float, on: bool = True,
        device: str = "cuda", config=None, traffic=None) -> dict:
    """The cell's window (the harness's loop) with the tracer on or off,
    then, on and on CUDA, the marked stretch; the record's program keys,
    the four readers' values and the identities they should meet.
    ``config``, ``traffic``: the cell's own by default."""
    import torch
    t_start = time.perf_counter()
    man = Manifest()
    cell = man.workload(name)
    config = config or man.config(cell["config"])
    traffic = traffic or man.traffic(cell["traffic"])
    dev = torch.device(device)
    torch.set_num_threads(harness.THREADS)
    tr = tracer() if on else None
    work = tempfile.mkdtemp(prefix="mpmc-ptrace-")
    try:
        model = config["model"]
        pqr = os.path.join(work, "input.pqr")
        geometry.write_pqr(pqr, model,
                           geometry.molecules(model, config["geometry"]))
        path = os.path.join(work, "run.in")
        with open(path, "w") as f:
            f.write(run_in(config, traffic, seed, pqr))
        from mpmcxx_tpu_torch import cli
        from mpmcxx_tpu_torch.config.parser import read_config
        if tr is not None:
            tr.reset()
            tr.enable()
        sim = cli.dispatch(read_config(path), 1, quiet=True, device=dev)
        spans = trace.Spans(timing=False, cuda=dev.type == "cuda")
        ch = harness.Chain(sim, traffic, spans)
        ch.advance()
        ch.since = ch.corrtime
        ch.boundary()
        ch.step, ch.kept, ch.discarded = 0, [], 0
        harness._sync(dev)
        setup = tr.snapshot() if tr is not None else None
        setup_s = time.perf_counter() - t_start
        if tr is not None:
            tr.reset()
        chunk_s = 0.0
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            ch.advance()
            chunk_s += time.perf_counter() - t1
            if ch.at_boundary():
                ch.boundary()
            if time.perf_counter() - t0 >= seconds and ch.since > 0:
                break
        harness._sync(dev)
        window_s = time.perf_counter() - t0
        moves = ch.step + ch.since
        snap = tr.snapshot() if tr is not None else None
        marked = None
        if tr is not None and dev.type == "cuda":
            marked = marked_stretch(ch, traffic, spans, tr)
        if tr is not None:
            tr.disable()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec = record(snap, marked)
    out = {"workload": name, "seed": seed, "tracer": on,
           "moves_per_s": moves / window_s, "moves": moves,
           "window_s": window_s, "setup_s": setup_s,
           "chunk_ms_per_move": 1e3 * chunk_s / moves,
           "metrics": {m: man.reader(m)(rec) for m in READERS}}
    if snap is not None:
        out["program"] = snap
        out["setup"] = setup
        out["step_ms_per_move"] = per_move(rec, span_ms(rec, STEP))
        out["draws_stats_ms_per_move"] = per_move(
            rec, (span_ms(rec, "draws") or 0.0) +
            (span_ms(rec, "stats") or 0.0))
    if marked:
        ops, segs = marked
        gaps = idle_gaps(ops)
        harness_ops = [(n, s, d, lab.split("/")[0]) for n, s, d, lab in ops]
        chunk_idle = dict(trace.breakdown(harness_ops, segs, [],
                                          top=100)["idle_gaps"]).get(
            "chunk (sum)", 0.0)
        by_program = sum(v for k, v in gaps
                         if k.startswith("chunk/") and k.endswith("(sum)"))
        out["stretch"] = {
            "idle_gaps": gaps, "chunk_idle_s": chunk_idle,
            "chunk_idle_by_program_span_s": by_program,
            "refresh_device_ms": [1e3 * (e - s) for lab, s, e in segs
                                  if lab == "refresh"],
            "device_ops": trace.breakdown(ops, segs, man.kernels())[
                "device_ops"]}
    return out


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="python3 -m benchmark.program_trace")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--off", action="store_true",
                   help="the same window with the tracer off")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.cache_env()
    print(json.dumps(run(args.workload, args.seed, args.seconds,
                         on=not args.off, device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
