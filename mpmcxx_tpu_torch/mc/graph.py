"""One move of a chunk runner replayed as a CUDA graph, beneath the
ensembles.

JAX twin: none (the twin's chunk is one jitted ``lax.scan``).  The uVT
runner (mc/chain.py) and the path-integral runner (mc/pi.py) each hand
``MoveGraph`` their move, how their carry comes apart (``CarryLeaves``)
and their move span, and run every chunk through ``MoveGraph.run``: each
move eager, or where the ensemble's rule holds (its ``graphs_apply``,
over ``can_capture``), one graph replay a move.  This module imports no
ensemble.

What a graph reads: a buffer for every tensor of the carry's leaves,
filled from the carry at a chunk's start, so that no carry's tensor is
written; the move's row of each of the chunk's device inputs, at a row
index it holds on the device and advances; the carry's cache (the polar
cache), read and written in place, as an eager move writes its planes;
and what the step made on its first call and holds for its life (its
device tables, PI's bead views).  What it writes: the carry it made into
the buffers, the move's outputs into that row of [n] columns, and the
cache's tensors.  The step reads its host facts (the topology, whether
any slot is adiabatic) once in its life, on that first call, which runs
eager; so a capture reads nothing of the buffers' identity.

When it captures: the first move on a carry whose leaves differ in shape
or dtype from the buffers' runs eager on the carry itself (the lazy
set-up: library load, launch configurations, the step's host tables; and
it shows which leaves a move replaces), and new buffers are made; so
does the first move of each other graph key, on the buffers.  A key's
next move is captured, and it and every later move of that key
replayed.  A graph whose cache tensors moved (a refresh's cache_init
made new planes) is captured anew into the same memory pool.  A replay
adds to each kernel wrapper's ``.launches`` what its capture recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .. import tracing
from ..pbc import PBC
from ..state import SystemState

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SystemState)
                     if f.name != "pbc")
PBC_FIELDS = tuple(f.name for f in dataclasses.fields(PBC))


def state_leaves(st: SystemState) -> list:
    """A state's tensors, its box's included, in a fixed order."""
    return ([getattr(st, n) for n in STATE_FIELDS] +
            [getattr(st.pbc, n) for n in PBC_FIELDS])


def with_state_leaves(st: SystemState, it) -> SystemState:
    """``st`` with the next tensors of the iterator ``it``, in
    state_leaves order."""
    return st.replace(**{n: next(it) for n in STATE_FIELDS},
                      pbc=PBC(**{n: next(it) for n in PBC_FIELDS}))


class CarryLeaves(NamedTuple):
    """How MoveGraph takes a runner's carry apart: ``leaves(carry)``, the
    carry's tensors a move reads or replaces, in a fixed order;
    ``with_leaves(carry, leaves)``, the carry with those tensors;
    ``cache(carry)``, the dataclass whose tensors a move reads and writes
    in place (the polar cache), or None."""
    leaves: Callable
    with_leaves: Callable
    cache: Callable


def can_capture(device, marking: bool) -> bool:
    """The half of every ensemble's graph rule: a CUDA ``device``, and no
    tracer device ``marking``, whose markers label each eager launch by
    its span."""
    return torch.device(device).type == "cuda" and not marking


def _cache_tensors(cache) -> dict:
    return {} if cache is None else {
        f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}


def _where(tensors: dict) -> tuple:
    """Where each tensor lies: (address, shape, strides)."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride())
                 for t in tensors.values())


def _restore(cache, tensors: dict):
    """Point ``cache``'s fields back at ``tensors``: a move's commit may
    re-point some at tensors of its own; a graph writes the originals."""
    for name, t in tensors.items():
        setattr(cache, name, t)


# device -> the side stream every capture runs on: one a device, so that
# what the libraries keep per stream (cuBLAS's workspace) is made once
_CAPTURE_STREAMS = {}


def _capture_stream(dev: torch.device):
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


class _Captured(NamedTuple):
    graph: object          # torch.cuda.CUDAGraph
    launches: dict         # kernel wrapper -> launches in one replay
    cache: tuple           # _where of the carry's cache at the capture


class MoveGraph:
    """A chunk runner's moves: ``n`` a chunk, each eager or one replay of
    the CUDA graph of its graph key (PI's move type; uVT's NPT volume
    pick, always False where graphed), all graphs sharing one memory
    pool, the buffers and the row index.

    ``move(carry, key, *rows) -> (carry, out)`` is one move of ``key`` on
    its rows of the chunk's device inputs (the draws, ...); ``out`` a
    tuple of device scalars.  ``parts`` (CarryLeaves) takes the carry
    apart; ``span()`` opens the span of each move."""

    def __init__(self, move, n: int, parts: CarryLeaves, span: Callable):
        self.move, self.n, self.parts, self.span = move, n, parts, span
        self.graphs = {}       # key -> _Captured
        self.ran = set()       # the keys whose eager move ran
        self.bufs = None       # per leaf: its buffer
        self.written = None    # the leaves a move replaces
        self.cols = self.inputs = self.row = self.pool = None

    def _same_layout(self, leaves) -> bool:
        return self.bufs is not None and all(
            x.shape == b.shape and x.dtype == b.dtype
            for x, b in zip(leaves, self.bufs))

    def _adopt(self, before, after, out, inputs, key):
        """Take new buffers from a first move, of ``key``: ``before`` and
        ``after`` are that move's leaves, ``out`` its output."""
        dev = after[0].device
        self.written = {j for j, (x, y) in enumerate(zip(before, after))
                        if x is not y}
        self.bufs = [torch.empty_like(x) for x in after]
        self.cols = [torch.empty(self.n, dtype=v.dtype, device=dev)
                     for v in out]
        self.inputs = [torch.empty_like(x) if isinstance(x, torch.Tensor)
                       else None for x in inputs]
        self.row = torch.zeros(1, dtype=torch.int64, device=dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs, self.ran = {}, {key}

    def _capture(self, carry, key) -> tuple:
        """Capture one move of ``key`` on the buffers and ``carry``'s
        cache: (the graph, kernel wrapper -> launches in one replay)."""
        dev = self.row.device
        pc = self.parts.cache(carry)
        cache = _cache_tensors(pc)
        kernels = list(tracing.kernel_wrappers().values())
        before = [fn.launches for fn in kernels]
        graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(self.pool)
                try:
                    self._move(carry, key, cache)
                finally:
                    graph.capture_end()
        finally:
            _restore(pc, cache)
            launches = {fn: fn.launches - k
                        for fn, k in zip(kernels, before)
                        if fn.launches != k}
            for fn, k in zip(kernels, before):
                fn.launches = k
        torch.cuda.current_stream(dev).wait_stream(stream)
        return graph, launches

    def _eager(self, carry, key):
        """Run one move of ``key`` eager on the buffers, as a graph
        would."""
        pc = self.parts.cache(carry)
        cache = _cache_tensors(pc)
        try:
            self._move(carry, key, cache)
        finally:
            _restore(pc, cache)

    def _move(self, carry, key, cache):
        """The work of a graph: the move of ``key`` on the buffers at the
        row index, then the copies of what it made into the buffers, the
        cache's tensors ``cache`` and the output columns, and the row
        index advanced."""
        row = self.row
        new, out = self.move(
            self.parts.with_leaves(carry, self.bufs), key,
            *(None if b is None else b.index_select(0, row)[0]
              for b in self.inputs))
        for j, (x, y) in enumerate(zip(self.bufs, self.parts.leaves(new))):
            if y is not x:
                x.copy_(y)
                self.written.add(j)
        fresh = self.parts.cache(new)
        for name, t in cache.items():
            y = getattr(fresh, name)
            if y is not t:
                t.copy_(y)
        for col, v in zip(self.cols, out):
            col.index_copy_(0, row, v.reshape(1))
        row.add_(1)

    def run(self, carry, inputs, keys, graphed: bool):
        """The chunk's moves from ``carry``, with the chunk's device
        ``inputs`` (each [n, ...], or ``[None] * n``) and the host's graph
        key of each move, each under the move span: with ``graphed`` off
        each move eager, else a first move eager where the carry is a new
        layout and the rest on the graphs.  Returns (carry, the outputs of
        the moves run eager on the carry itself); the carry's leaves that
        a move replaces are the buffers until ``collect``."""
        first, eager = self.n, []
        if graphed:
            leaves = self.parts.leaves(carry)
            first = int(not self._same_layout(leaves))
        for i in range(first):
            with self.span():
                tracing.count("graph_eager")
                carry, out = self.move(carry, keys[i],
                                       *(x[i] for x in inputs))
            eager.append(out)
        if not graphed:
            return carry, eager
        if first:
            self._adopt(leaves, self.parts.leaves(carry), eager[0], inputs,
                        keys[0])
        # a graph whose cache moved is captured anew into the same memory
        # pool, and only then let go, so that the pool stays held
        where = _where(_cache_tensors(self.parts.cache(carry)))
        for i in range(first, self.n):
            key = keys[i]
            with self.span():
                if i == first:
                    self._feed(self.parts.leaves(carry), inputs, eager)
                if key not in self.ran:
                    tracing.count("graph_eager")
                    self._eager(carry, key)
                    self.ran.add(key)
                    continue
                g = self.graphs.get(key)
                if g is None or g.cache != where:
                    tracing.count("graph_capture")
                    g = self.graphs[key] = _Captured(
                        *self._capture(carry, key), where)
                tracing.count("graph_replay")
                g.graph.replay()
                for fn, k in g.launches.items():
                    fn.launches += k
        return carry, eager

    def _feed(self, leaves, inputs, eager):
        """Fill the buffers for the chunk's first move on them."""
        for b, x in zip(self.bufs, leaves):
            b.copy_(x)
        for b, x in zip(self.inputs, inputs):
            if b is not None:
                b.copy_(x)
        self.row.fill_(len(eager))
        for col, v in zip(self.cols, eager[0] if eager else ()):
            col[0] = v

    def collect(self, carry, eager) -> tuple:
        """(carry, [n] output columns) after ``run``: copies of what the
        buffers hold, so that no later replay writes what the caller
        keeps."""
        if len(eager) == self.n:
            return carry, tuple(torch.stack(col) for col in zip(*eager))
        leaves = [b.clone() if j in self.written else x
                  for j, (x, b) in enumerate(zip(self.parts.leaves(carry),
                                                 self.bufs))]
        return self.parts.with_leaves(carry, leaves), \
            tuple(c.clone() for c in self.cols)
