"""The traced run's record: spans of the harness and a device trace.

Spans are the harness's own, around its calls into the program:
``chunk`` (one chunk runner call), ``refresh`` (the corrtime full
recompute) and ``host_read`` (the corrtime's reads and averages).  While
a stretch of the window is profiled (torch.profiler, CUDA activity only:
recording host operations too would multiply the host's cost), every
span boundary enqueues a marker kernel (``torch.cuda._sleep``, device
kernel ``spin_kernel``) on the program's stream, so the device trace
itself says which span launched each device operation.  The profiler's
event handling is ``chip_smoke.device_split``'s (a session that records
no device event is unusable), a
kernel is named by its function and the functor it runs.
"""

from __future__ import annotations

import contextlib
import re
import time

MARK_CYCLES = 64
MARKER = "spin_kernel"
# host seconds between the profiler's start or stop and the stretch's
# outer markers: the profiler drops device events that its clock places
# outside its window, and on some H100 hosts every try of a run lost
# markers, which the stretch's edges hold
EDGE_S = 0.1
_HEAD = re.compile(r"(?:void\s+)?([\w:]+)")
_WHAT = re.compile(r"\w+(?:Functor|_kernel_cuda|_kernel_impl)\b")


def short_name(name: str) -> str:
    """A kernel's function name, with the operation it was instantiated
    for where the name carries one (``vectorized_elementwise_kernel
    MulFunctor``)."""
    name = name.replace("(anonymous namespace)::", "")
    head = _HEAD.match(name)
    if not head:
        return name[:40]
    base = head.group(1).split("::")[-1]
    what = _WHAT.findall(name, head.end())
    functors = [w for w in what if w.endswith("Functor")]
    what = functors[-1:] or what[:1]
    return f"{base} {what[0]}" if what else base


class Spans:
    """Host-clock spans of the window; while ``marking``, each boundary
    also enqueues a device marker and is remembered in order."""

    def __init__(self, timing: bool, cuda: bool):
        self.timing = timing       # time the spans asked for
        self.cuda = cuda           # synchronise the device around them
        self.marking = False
        self.bounds = []           # (kind, label) of each marker, in order
        self.times = {}            # label -> [host seconds]

    def _mark(self, kind, label):
        import torch
        torch.cuda._sleep(MARK_CYCLES)
        self.bounds.append((kind, label))

    @contextlib.contextmanager
    def span(self, label: str, timed: bool = False):
        import torch
        if self.marking:
            self._mark("start", label)
        timed = timed and self.timing
        if timed and self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if timed:
                if self.cuda:
                    torch.cuda.synchronize()
                self.times.setdefault(label, []).append(
                    time.perf_counter() - t0)
            if self.marking:
                self._mark("end", label)


class Stretch:
    """One profiled stretch of the window."""

    def __init__(self, spans: Spans):
        """Start profiling, and marking the spans' boundaries."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.spans = spans
        spans.bounds = []
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        spans.marking = True
        spans._mark("start", "stretch")

    def stop(self):
        import torch
        self.spans._mark("end", "stretch")
        self.spans.marking = False
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        self.prof.stop()

    def device_ops(self):
        """[(name, start s, duration s)] of every device operation, in
        start order (chip_smoke.device_split's reading)."""
        from torch.autograd import DeviceType
        ops = []
        for e in self.prof.events():
            if e.device_type == DeviceType.CUDA:
                ops.append((e.name, e.time_range.start * 1e-6,
                            e.time_range.elapsed_us() * 1e-6))
        ops.sort(key=lambda o: o[1])
        return ops


def segment(ops, bounds):
    """Split the device ops at the markers: (ops [(name, start, dur,
    label)] without the markers, segments [(label, start, end)] of the
    spans).  A label is the span the op's launch fell in, "harness"
    between spans.  None when the markers seen are not the boundaries
    made (the profiler dropped events)."""
    marks = [o for o in ops if MARKER in o[0]]
    if len(marks) != len(bounds) or not bounds:
        return None
    out, segs, stack = [], [], []
    label, k = "harness", 0
    for name, start, dur in ops:
        if MARKER in name:
            kind, lab = bounds[k]
            k += 1
            if kind == "start":
                stack.append((lab, start))
            else:
                lab0, s0 = stack.pop()
                segs.append((lab0, s0, start + dur))
            label = stack[-1][0] if stack and stack[-1][0] != "stretch" \
                else "harness"
            continue
        out.append((name, start, dur, label))
    return out, segs


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_label(name: str, kernels: list) -> str:
    """A device op's name in the breakdown: its kernel mapping's label,
    else "torch <kernel>" (memsets and copies by their own name)."""
    for k in kernels:
        if any(f in name for f in k["fragments"]):
            return k["label"]
    if "Memset" in name or "Memcpy" in name:
        return name.split()[0] if name.split() else name
    return "torch " + short_name(name)


def breakdown(ops, segs, kernels, top: int = 10) -> dict:
    """The device ops that took most time (by kernel label) and the idle
    gaps of the stretch, summed by what the host was doing (the span of
    the op that ended the gap) and the longest single gap of each."""
    by = {}
    for name, _, dur, _ in ops:
        lab = kernel_label(name, kernels)
        by[lab] = by.get(lab, 0.0) + dur
    device_ops = sorted(([k, v] for k, v in by.items()),
                        key=lambda kv: -kv[1])[:top]
    total, longest = {}, {}
    end = None
    for name, start, dur, label in ops:
        if end is not None and start > end:
            gap = start - end
            total[label] = total.get(label, 0.0) + gap
            longest[label] = max(longest.get(label, 0.0), gap)
        end = start + dur if end is None else max(end, start + dur)
    gaps = [[f"{k} (sum)", v] for k, v in total.items()] + \
        [[f"{k} (longest)", v] for k, v in longest.items()]
    gaps.sort(key=lambda kv: -kv[1])
    return {"device_ops": device_ops, "idle_gaps": gaps[:top]}
