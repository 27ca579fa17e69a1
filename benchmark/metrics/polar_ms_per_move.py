"""Host ms per move inside the program's ``step.polar`` span (the polar
proposal: its row blocks, static field and SCF, ``polar_cache.
polar_proposal``) over the window's ``step`` count
(benchmark/program_trace.py).  The chain is host-bound, and a sync in
the span makes the host wait for the device, so this is the wall time
the polar proposal costs a move.  None without the span."""

from ..program_trace import per_move, span_ms


def read(record):
    return per_move(record, span_ms(record, "step.polar"))
