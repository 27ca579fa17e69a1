"""The validation studies' statistics, copied from their tools.

Twins: tools/uvt_crosscheck.py (``stats_from_rows``, ``parse_energy_dat``),
tools/npt_crosscheck.py (``stats_from_rows``, ``parse_energy_dat``: the
naive error, kept as it is), tools/gibbs_vle.py (the rho_l / rho_v
reduction of its ``main``) and tools/ptemp_validate.py (``block_err``).
The arithmetic is the tools' operation for operation, so each result is
bitwise theirs on the same rows.  ``error_parts`` splits the uVT tool's
error into its block and tau-corrected halves, for the studies' JSON
lines.
"""

from __future__ import annotations

import numpy as np

GATE_SIGMA = 3.0     # every tool's agreement gate


def tau_int(x) -> float:
    """Integrated autocorrelation time in samples, summed until the
    autocorrelation drops under 0.05 (uvt_crosscheck.py:197-210,
    gibbs_vle.py:214-226)."""
    x = np.asarray(x, float) - np.mean(x)
    n = len(x)
    var = np.dot(x, x) / n
    if var == 0:
        return 0.5
    tau = 0.5
    for k in range(1, n // 3):
        c = np.dot(x[:-k], x[k:]) / ((n - k) * var)
        if c < 0.05:
            break
        tau += c
    return tau


def error_parts(x, n_blocks: int = 10) -> tuple:
    """(mean, block error, tau-corrected error) of the samples ``x``, as
    uvt_crosscheck.stats_from_rows's ``block_stats`` computes them
    (uvt_crosscheck.py:212-220)."""
    x = np.asarray(x)
    nb = min(n_blocks, max(len(x) // 2, 1))
    blocks = np.array_split(x, nb)
    bm = np.asarray([b.mean() for b in blocks])
    berr = float(bm.std(ddof=1) / np.sqrt(len(bm))
                 if len(bm) > 1 else 0.0)
    terr = float(x.std(ddof=1) * np.sqrt(2 * tau_int(x) / len(x))
                 if len(x) > 3 else 0.0)
    return float(x.mean()), berr, terr


def stats_from_rows(rows, burn_frac: float = 0.25,
                    n_blocks: int = 10) -> dict:
    """uvt_crosscheck.stats_from_rows (:182): {"E", "N"} of the (E, N)
    rows after dropping the first ``burn_frac`` (at least one row), each
    (mean, max(block error, tau-corrected error))."""
    rows = rows[max(int(len(rows) * burn_frac), 1):]

    def block_stats(x):
        mean, berr, terr = error_parts(x, n_blocks)
        return mean, max(berr, terr)

    return {"E": block_stats([r[0] for r in rows]),
            "N": block_stats([r[1] for r in rows])}


def parse_energy_dat(path: str, column: int = 8) -> list:
    """uvt_crosscheck.parse_energy_dat (:224): (E, N) of every row of an
    energy log (#step #energy ... #N at token 8); ``column`` = 10 reads
    the volume instead (npt_crosscheck.parse_energy_dat, :63)."""
    rows = []
    with open(path) as f:
        for line in f.read().splitlines()[1:]:
            t = line.split()
            if len(t) >= column + 1:
                try:
                    rows.append((float(t[1]), float(t[column])))
                except ValueError:
                    pass
    return rows


def npt_stats_from_rows(rows, burn_frac: float = 0.25) -> dict:
    """npt_crosscheck.stats_from_rows (:53): {"E", "V"} of the (E, V)
    rows, each (mean, std / sqrt(n - 1)): the naive error of
    uncorrelated samples."""
    rows = rows[max(int(len(rows) * burn_frac), 1):]
    E = np.asarray([r[0] for r in rows])
    V = np.asarray([r[1] for r in rows])
    sd = max(len(E) - 1, 1) ** 0.5
    return {"E": (float(E.mean()), float(E.std() / sd)),
            "V": (float(V.mean()), float(V.std() / sd))}


def read_rows(path: str) -> list:
    """The rows of a saved two-column file (``.xc_snapshots/*.rows.txt``,
    one "E N" per corrtime): a list of (float, float)."""
    rows = []
    with open(path) as f:
        for line in f:
            t = line.split()
            if len(t) == 2 and not line.startswith("#"):
                rows.append((float(t[0]), float(t[1])))
    return rows


def vle_densities(samples, sig: float, warmup_frac: float = 0.33) -> dict:
    """gibbs_vle.main's reduction (:184-243) of its (N_a, V_a, N_b, V_b)
    samples: after the first ``warmup_frac``, each sample's denser box is
    the liquid.  {"rho_l", "rho_v"}: each (mean, block error,
    tau-corrected error, tau_int) in reduced units (``sig`` in A); the
    tool's error is the larger of the two."""
    burn = int(len(samples) * warmup_frac)
    use = np.asarray(samples[burn:])
    rho_a = use[:, 0] / use[:, 1] * sig ** 3
    rho_b = use[:, 2] / use[:, 3] * sig ** 3
    rho_l = np.maximum(rho_a, rho_b)
    rho_v = np.minimum(rho_a, rho_b)

    def block_stats(x, nblock=10):
        nb_ = min(nblock, len(x))
        blocks = np.array_split(x, nb_)
        means = np.asarray([b.mean() for b in blocks])
        return float(x.mean()), float(means.std(ddof=1) / np.sqrt(nb_))

    out = {}
    for name, arr in (("rho_l", rho_l), ("rho_v", rho_v)):
        mean, berr = block_stats(arr)
        tau = tau_int(arr)
        terr = float(arr.std(ddof=1) * np.sqrt(2 * tau / len(arr)))
        out[name] = (mean, berr, terr, tau)
    return out


def block_err(x, n_blocks: int = 10) -> tuple:
    """ptemp_validate.block_err (:39): (mean, block error)."""
    x = np.asarray(x, float)
    nb = min(n_blocks, max(len(x) // 2, 1))
    bm = np.asarray([b.mean() for b in np.array_split(x, nb)])
    return float(x.mean()), float(bm.std(ddof=1) / np.sqrt(len(bm))
                                  if len(bm) > 1 else 0.0)


def sigma_distance(a: tuple, b: tuple) -> float:
    """|a - b| in combined standard errors of two (mean, error) pairs, the
    tools' comparison (the denominator at least 1e-9)."""
    err = max((a[1] ** 2 + b[1] ** 2) ** 0.5, 1e-9)
    return abs(a[0] - b[0]) / err


def quarters(rows) -> list:
    """Each column's mean over each quarter of ``rows`` (the uVT tool's
    drift table, uvt_crosscheck.py:432-442)."""
    out = []
    q = len(rows) // 4
    for i in range(4):
        seg = rows[i * q:(i + 1) * q]
        out.append(tuple(sum(r[c] for r in seg) / len(seg)
                         for c in range(len(rows[0]))))
    return out
