"""The traced run's moves kept over its window's whole wall time
(``moves_per_s``'s reading, profiled stretch included), for a cell whose
host-bound rate spreads too widely between runs to carry a bound."""


def read(record):
    moves, wall = record.get("moves"), record.get("moves_wall_s")
    if not moves or not wall:
        return None
    return moves / wall
