"""Device operations (kernels, copies, memsets; the span markers left
out) launched inside the profiled chunks, per move of those chunks; the
refresh and the host reads are not counted."""


def read(record):
    if not record["ops"] or not record["chunk_iterations"]:
        return None
    n = sum(1 for op in record["ops"] if op[3] == "chunk")
    return n / len(record["chunk_iterations"])
