"""Mean host milliseconds of the window's corrtime refreshes (the full
recompute and cache rebuild, ``Simulation.refresh``), each timed between
two synchronisations of the device."""


def read(record):
    times = record["refresh_s"]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
