"""Device-timeline ms of the refresh's full energy: from the program's
``refresh.energy`` start marker to its end marker in the marked stretch
(``record["program_segments"]``, benchmark/program_trace.py), the mean
over the refreshes there.  None where the stretch has no such
markers."""


def read(record):
    segs = [e - s for label, s, e in record.get("program_segments") or ()
            if label.endswith("/refresh.energy")]
    if not segs:
        return None
    return 1e3 * sum(segs) / len(segs)
