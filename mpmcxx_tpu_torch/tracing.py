"""Host-clock spans and counters inside the program, off by default.

JAX twin: none (the JAX package is traced by jax.profiler; this tracer
serves the port's host loop).  ``span(name)`` marks a stretch of the
program's work; ``count(name, n)`` adds to a counter of the innermost
open span.  Off (the default), ``span`` returns the one shared no-op
context: no clock read, no allocation, no device call.  On (``enable``),
each span is timed on ``time.perf_counter_ns`` (the host clock of the
benchmark's own spans) and folded into per-name aggregates (count, total
ns, self ns: the duration less what its child spans cover, and max ns),
so a run of any length holds bounded memory; with CUDA available every
synchronising CUDA call (``torch.cuda.set_sync_debug_mode("warn")``: a
``.item()``, a ``bool`` of a device tensor, a copy to the host, a
``nonzero``) is counted as ``host_sync`` on the innermost open span, and
the warning it raises reaches no one.

``enable(mark_device=True)`` also enqueues, at each span boundary, a
one-thread marker kernel (``mpmcxx_span_mark_kernel``, ``csrc/span_mark.cu``)
on the current CUDA stream, and keeps each boundary as (kind, span, host
ns) in launch order, with every span's (name, parent, start ns, end ns,
move).  In a device trace, stream order then puts each device operation
under the innermost span whose markers enclose its launch, and each
marker's device start beside its host ns maps one clock onto the other.
Without CUDA marking is a no-op.

No span synchronises the device or changes what the chain computes.
``snapshot()`` returns the aggregates, the counters, the moves counted
by the chunk runner and the launches of K1-K6 since the last ``reset``
(read from the kernel wrappers' ``.launches``, their one store; a
replayed CUDA graph adds the launches its capture recorded).

Where the chunk runner replays a move as a CUDA graph (mc/graph.py), the
move's ``step`` span opens as always, but the ``step.*`` spans inside it
fire only where the move is captured or runs eager: a replay runs no
Python of the step.  The counters ``graph_capture``, ``graph_replay``
and ``graph_eager``, on the ``step`` span, say which: a captured move is
also replayed, so ``graph_replay`` over the moves is the share of moves
the graph ran.  The path-integral runner (mc/pi.py) counts them alike on
its ``pi.step`` span, one graph a move type.  With device marking on,
either runner runs every move eager.

The spans and counters, and what reads each (PERF.md section 3):
``draws``, ``step``, ``step.target``, ``step.cavity``, ``step.move``,
``step.delta_e``, ``step.polar``, ``step.polar.scf``,
``step.full_recompute``, ``step.accept``, ``step.commit``, ``stats``
(mc/chain.py); ``refresh``, ``refresh.energy``, ``refresh.sf``,
``refresh.polar_cache`` (mc/chain.py); ``corrtime_io``,
``grow_capacity``, ``setup.build_state``, ``output`` (runner.py);
``setup.init_carry`` (mc/chain.py); ``setup.library`` (ops/kernels.py);
the counter ``host_sync``; the counters ``graph_capture``,
``graph_replay``, ``graph_eager`` (mc/graph.py); the counters
``pair_kernel`` and ``pair_plain`` (ops/energy.py: each blocked full
recompute's pair sums, by K6 or by the plain row-tile loop, on the
innermost open span; ``pair_kernel`` over both is K6's engagement).
The two-box Gibbs chain (mc/gibbs.py): ``gibbs.draws``, ``gibbs.step``
(opens a move), ``gibbs.step.move``, ``gibbs.step.delta_e``,
``gibbs.step.accept``, ``gibbs.stats``; ``gibbs.refresh``,
``gibbs.refresh.energy``, ``gibbs.refresh.sf``; the counters
``gibbs_displace``, ``gibbs_transfer``, ``gibbs_volume``, ``gibbs_spin``
(the host's pick of each move, on ``gibbs.step``); its set-up opens
``setup.build_state`` and ``setup.init_carry``, its corrtime
``corrtime_io``.  The path-integral chain (mc/pi.py): ``pi.draws`` (the
chunk's draws, move picks, Coker anchors and their copy to the device),
``pi.step`` (opens a move; the counters ``graph_capture``,
``graph_replay``, ``graph_eager``), ``pi.stats`` (the chunk's columns
and acceptance statistics).
"""

from __future__ import annotations

import time
import warnings

SYNC = "host_sync"
_SYNC_TEXT = "called a synchronizing CUDA operation"
# torch's note, on setting the mode, that it may miss some syncs
_PROTOTYPE_TEXT = "Synchronization debug mode is a prototype"

_clock = time.perf_counter_ns


class _Noop:
    """The disabled span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Tracer:
    def __init__(self):
        self.on = False
        self.marking = False
        self.stack = []        # open: [name, start ns, child ns, marked]
        self.agg = {}          # name -> [count, total ns, self ns, max ns]
        self.counters = {}     # counter -> {innermost span: n}
        self.moves = 0
        self.move = 0          # the move the open spans belong to
        self.bounds = []       # (kind, span, host ns) while marking
        self.spans = []        # (name, parent, start, end, move) likewise
        self.base = {}         # K1-K6 launches at the last reset
        self.sync_mode = None  # the sync-debug mode enable() replaced
        self.warn_ctx = None   # the warnings state enable() replaced
        self.show = None       # and its showwarning
        self.stream = None     # marking: torch.cuda.current_stream
        self.lib = None


_T = _Tracer()


class _Span:
    __slots__ = ("name", "move")

    def __init__(self, name, move):
        self.name, self.move = name, move

    def __enter__(self):
        t = _T
        if self.move:
            t.moves += 1
            t.move = t.moves
        marked = t.marking
        if marked:
            _mark("start", self.name, _clock())
        t.stack.append([self.name, _clock(), 0, marked])
        return self

    def __exit__(self, *exc):
        t = _T
        end = _clock()
        name, start, child, marked = t.stack.pop()
        dur = end - start
        a = t.agg.get(name)
        if a is None:
            a = t.agg[name] = [0, 0, 0, 0]
        a[0] += 1
        a[1] += dur
        a[2] += dur - child
        if dur > a[3]:
            a[3] = dur
        parent = t.stack[-1] if t.stack else None
        if parent is not None:
            parent[2] += dur
        if marked and t.marking:
            _mark("end", name, end)
            t.spans.append((name, parent[0] if parent else None, start, end,
                            t.move))
        return False


def span(name: str, move: bool = False):
    """A context over the work named ``name``; ``move`` opens a move (the
    chunk runner's ``step``), whose number its spans share."""
    if not _T.on:
        return NOOP
    return _Span(name, move)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span ("" with
    none open)."""
    t = _T
    if not t.on:
        return
    key = t.stack[-1][0] if t.stack else ""
    c = t.counters.setdefault(name, {})
    c[key] = c.get(key, 0) + n


def _mark(kind, name, ns):
    t = _T
    rc = t.lib.mpmcxx_span_mark(t.stream().cuda_stream, len(t.bounds))
    if rc != 0:
        raise RuntimeError(f"span marker launch failed: CUDA error {rc}")
    t.bounds.append((kind, name, ns))


def _show(message, category, filename, lineno, file=None, line=None):
    """The warnings hook while tracing: a sync warning is a count."""
    if _SYNC_TEXT in str(message):
        count(SYNC)
        return
    _T.show(message, category, filename, lineno, file, line)


def kernel_wrappers() -> dict:
    """K1-K6's wrappers by name; each counts its launches in
    ``.launches``."""
    from .ops import cuda_cavity, cuda_pairs, cuda_polar
    return {"K1 contract_planes": cuda_polar.contract_planes,
            "K2 write_plane_strips": cuda_polar.write_plane_strips,
            "K3 occupancy": cuda_cavity.occupancy,
            "K4 contract_planes_tri": cuda_polar.contract_planes_tri,
            "K5 contract_planes_sym": cuda_polar.contract_planes_sym,
            "K6 pair_energy": cuda_pairs.pair_sums}


def _launches() -> dict:
    """K1-K6's launches, from each wrapper's ``.launches``."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def enabled() -> bool:
    return _T.on


def marking() -> bool:
    """Whether span boundaries are marked on the device."""
    return _T.marking


def enable(mark_device: bool = False) -> None:
    """Start tracing, and with ``mark_device`` marking the device trace
    (where CUDA is available).  Where CUDA is available, sync-debug mode
    "warn" counts host syncs until ``disable``."""
    import torch
    t = _T
    if not t.on:
        t.on = True
        t.base = _launches()
        if torch.cuda.is_available():
            t.warn_ctx = warnings.catch_warnings()
            t.warn_ctx.__enter__()
            t.show = warnings.showwarning
            warnings.filterwarnings("always", message=_SYNC_TEXT)
            warnings.filterwarnings("ignore", message=_PROTOTYPE_TEXT)
            warnings.showwarning = _show
            t.counters.setdefault(SYNC, {})
            t.sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
    if mark_device and not t.marking and torch.cuda.is_available():
        from .ops import kernels
        t.lib = kernels.load()
        t.stream = torch.cuda.current_stream
        t.marking = True


def disable() -> None:
    """Stop tracing; what was recorded stays until ``reset``."""
    import torch
    t = _T
    t.marking = False
    if not t.on:
        return
    t.on = False
    if t.sync_mode is not None:
        torch.cuda.set_sync_debug_mode(t.sync_mode)
        t.sync_mode = None
    if t.warn_ctx is not None:
        t.warn_ctx.__exit__(None, None, None)
        t.warn_ctx = None


def reset() -> None:
    """Forget what was recorded (spans left open stay open)."""
    t = _T
    t.agg, t.moves = {}, 0
    t.counters = {k: {} for k in t.counters}
    t.bounds, t.spans = [], []
    t.base = _launches()


def snapshot() -> dict:
    """{"spans": {name: {count, total_ns, self_ns, max_ns}}, "counters":
    {counter: {span: n}}, "moves", "launches": {kernel: launches since
    the last reset}}; a copy, JSON-ready."""
    t = _T
    now = _launches()
    return {
        "spans": {k: {"count": a[0], "total_ns": a[1], "self_ns": a[2],
                      "max_ns": a[3]} for k, a in t.agg.items()},
        "counters": {k: dict(v) for k, v in t.counters.items()},
        "moves": t.moves,
        "launches": {k: v - t.base.get(k, 0) for k, v in now.items()},
    }


def marks():
    """(boundaries [(kind, span, host ns)] in launch order, spans [(name,
    parent, start ns, end ns, move)]) recorded while marking."""
    return list(_T.bounds), list(_T.spans)
