"""Mean SCF iterations per move over the window's kept moves, the
program's own count (``StepOut.polarization_iterations``)."""


def read(record):
    its = record["iterations"]
    if not its:
        return None
    return sum(its) / len(its)
