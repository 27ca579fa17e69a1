"""Host ms per move inside the program's ``step.delta_e`` span (the
incremental LJ + Ewald Delta-E, ``delta.delta_energy``, and the cavity
penalty) over the window's ``step`` count
(benchmark/program_trace.py).  None without the span."""

from ..program_trace import per_move, span_ms


def read(record):
    return per_move(record, span_ms(record, "step.delta_e"))
