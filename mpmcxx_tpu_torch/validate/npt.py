"""NPT held to the reference binary's ensemble averages.

Twin: the "ours" side of tools/npt_crosscheck.py (``run_ours``): argon at
135 K / 60 atm from examples/gibbs-argon's box, condensing from 8,000 A^3
to the ~1,270 A^3 liquid through the single-box (N+1) ln V volume
acceptance, on the port's ``runner.Simulation``.  The per-corrtime
(E, V) rows are compared at 50 % burn-in with the README's reference
means (100k steps: <E> -15374 +- 131 K, <V> 1279 +- 9 A^3) and JAX means
(-15445 +- 134 K, 1268 +- 10 A^3).

The tool's own error is the naive one (stats.npt_stats_from_rows); the
record carries it beside the block and tau-corrected errors, and the gate
uses the larger of those two, as the uVT tool does, since per-corrtime
samples of a condensing box are correlated.
"""

from __future__ import annotations

import os
import tempfile

from . import common, systems
from .stats import error_parts, npt_stats_from_rows, parse_energy_dat, \
    quarters, sigma_distance

TEMPERATURE = 135.0
PRESSURE = 60.0
STEPS = 30000
CORRTIME = 250
SEED = 10          # the tool's side runs at its --seed 9 + 1
GATE_BURN = 0.5
TRUTHS = {"reference": {"E": (-15374.0, 131.0), "V": (1279.0, 9.0)},
          "jax": {"E": (-15445.0, 134.0), "V": (1268.0, 10.0)}}


def run_in(steps: int, corrtime: int, seed: int) -> str:
    return systems.NPT_CONFIG.format(
        steps=steps, corrtime=corrtime, seed=seed, pressure=PRESSURE,
        temperature=TEMPERATURE)


def run_rows(steps: int, corrtime: int, seed: int, device, workdir: str):
    """The port's run in ``workdir``: (its per-corrtime (E, V) rows, the
    finished Simulation)."""
    common.write_inputs(workdir, run_in(steps, corrtime, seed),
                        systems.ARGON_BOX)
    sim, _ = common.run_simulation(workdir, device)
    return parse_energy_dat(os.path.join(workdir, "g.energy.dat"),
                            column=10), sim


def run(steps: int = STEPS, corrtime: int = CORRTIME, seed: int = SEED,
        device="cuda") -> dict:
    """Run the NPT study on ``device`` and reduce it: the JSON record."""
    study = "npt"
    with tempfile.TemporaryDirectory(prefix="npt_") as d:
        clock = common.Clock(device)
        rows, _ = run_rows(steps, corrtime, seed, device, d)
        wall = clock.seconds()
    common.log(study, f"{'quarter':>8s} {'ours <E>':>12s} {'ours <V>':>9s}")
    for i, (e, v) in enumerate(quarters(rows)):
        common.log(study, f"{i:>8d} {e:>12.1f} {v:>9.1f}")
    naive = npt_stats_from_rows(rows, burn_frac=GATE_BURN)
    gate = rows[max(int(len(rows) * GATE_BURN), 1):]
    means = {q: common.mean_record(*error_parts([r[i] for r in gate]),
                                   naive_err=naive[q][1])
             for i, q in enumerate(("E", "V"))}
    sigma = {name: {q: sigma_distance((means[q]["mean"], means[q]["err"]),
                                      t[q]) for q in ("E", "V")}
             for name, t in TRUTHS.items()}
    for q in ("E", "V"):
        common.log(study, f"burn-in 50% {q}: ours {means[q]['mean']:.3f} +- "
                   f"{means[q]['err']:.3f} (naive {naive[q][1]:.3f}); "
                   + "; ".join(f"{k} {t[q][0]} +- {t[q][1]} "
                               f"({sigma[k][q]:.2f} sigma)"
                               for k, t in TRUTHS.items()))
    return dict(
        study=study, steps=steps, corrtime=corrtime, seed=seed,
        burn_frac=GATE_BURN, samples=len(gate), wall_s=wall, means=means,
        truths={k: {q: list(v) for q, v in t.items()}
                for k, t in TRUTHS.items()},
        sigma=sigma,
        verdict=common.verdict(s for t in sigma.values()
                               for s in t.values()),
        rows=[list(r) for r in rows])
