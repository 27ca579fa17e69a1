"""Host syncs per move: the program's ``host_sync`` counts (every
synchronising CUDA call, by the innermost program span open; the port's
tracer, ``mpmcxx_tpu_torch/tracing.py``) inside its ``step`` spans over
the window's ``step`` count (``record["program"]``,
benchmark/program_trace.py).  None where the program has no tracer or
counted no syncs (no CUDA device)."""

from ..program_trace import STEP, per_move


def read(record):
    prog = record.get("program")
    if not prog or "host_sync" not in prog["counters"]:
        return None
    syncs = prog["counters"]["host_sync"]
    return per_move(record, sum(n for span, n in syncs.items()
                                if span == STEP or
                                span.startswith(STEP + ".")))
