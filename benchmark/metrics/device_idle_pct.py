"""Share of the profiled chunks' device time (marker to marker) in which
no device operation ran, in %."""

from ..trace import union_s


def read(record):
    if not record["segments"]:
        return None
    segs = [(s, e) for lab, s, e in record["segments"] if lab == "chunk"]
    wall = sum(e - s for s, e in segs)
    if wall <= 0.0:
        return None
    busy = 0.0
    for s0, e0 in segs:
        busy += union_s((max(s, s0), min(s + d, e0))
                        for _, s, d, lab in record["ops"]
                        if lab == "chunk" and s < e0 and s + d > s0)
    return 100.0 * (1.0 - busy / wall)
