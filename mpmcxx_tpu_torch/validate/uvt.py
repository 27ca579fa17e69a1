"""uVT GCMC held to the reference binary's ensemble averages.

Twin: the "ours" side of tools/uvt_crosscheck.py (``run_ours``,
``_run_ours_inner``): the tool's input through the port's
``runner.Simulation`` on the card, the per-corrtime (E, N) rows of its
energy log reduced as the tool reduces them (stats.stats_from_rows) and
compared with what the reference binary gave at the same state point.
The binary itself is not run: its numbers are the saved rows or the
means the README records.

* ``uvt-argon``: argon at 110 K / 15 atm from examples/gibbs-argon's box;
  the check that found the insertion capacity saturating, so it runs
  ``runner.Simulation._grow_capacity``.  Truths: the README's 30k-step
  reference and JAX means.
* ``uvt-polar``: 8 frozen charges and polarizable sorbates at 250 K /
  30 atm under a 4-iteration Thole SCF on the polar cache
  (``polar_mixed``, as the tool sets it).  Truths: the reference's and
  the JAX run's saved 250k-step rows (.xc_snapshots/).
* ``uvt-cavity``: cavity-biased insertion (6^3 grid) of supercritical
  argon at 180 K / 60 atm from a dense lattice.  Truths: the README's
  150k-step reference and JAX means.

The gate is the tool's: 50 % burn-in, every sigma distance under 3.  The
per-quarter drift table and both burn-ins go to stderr.
"""

from __future__ import annotations

import os
import tempfile

from . import common, systems
from .stats import (error_parts, parse_energy_dat, quarters, read_rows,
                    sigma_distance, stats_from_rows)

SNAPSHOTS = os.path.join(systems.ROOT, ".xc_snapshots")
GATE_BURN = 0.5

# study -> its state point, input and truths: (mean, error) per quantity,
# or a saved rows file reduced at the gate's burn-in
STUDIES = {
    "uvt-argon": dict(
        temperature=110.0, pressure=15.0, extra="", box=systems.ARGON_BOX,
        polar_mixed=False,
        truths={"reference": {"E": (-73658.0, 945.0), "N": (134.3, 0.8)},
                "jax": {"E": (-74681.0, 914.0), "N": (135.5, 0.9)}}),
    "uvt-polar": dict(
        temperature=250.0, pressure=30.0, extra=systems.POLAR_EXTRA,
        box=None, polar_mixed=True,
        truths={"reference": os.path.join(
                    SNAPSHOTS, "polar_250K_250000_ref.rows.txt"),
                "jax": os.path.join(
                    SNAPSHOTS, "polar_250K_250000_ours.rows.txt")}),
    "uvt-cavity": dict(
        temperature=180.0, pressure=60.0, extra=systems.CAVITY_EXTRA,
        box=None, polar_mixed=False,
        truths={"reference": {"E": (-2653.0, 143.0), "N": (23.2, 0.6)},
                "jax": {"E": (-2723.0, 177.0), "N": (23.6, 0.7)}}),
}
STEPS = 30000
CORRTIME = 250
SEED = 8           # the tool's side runs at its --seed 7 + 1


def box_of(study: str):
    """The study's boxA.pqr: a path to copy or the PQR's text."""
    if study == "uvt-polar":
        return systems.polar_system_pqr()
    if study == "uvt-cavity":
        return systems.dense_argon_pqr()
    return STUDIES[study]["box"]


def run_in(study: str, steps: int, corrtime: int, seed: int) -> str:
    s = STUDIES[study]
    return systems.UVT_CONFIG.format(
        steps=steps, corrtime=corrtime, seed=seed, pressure=s["pressure"],
        extra=s["extra"], temperature=s["temperature"])


def truths_of(study: str) -> dict:
    """{truth: {"E": (mean, err), "N": (mean, err)}}; a saved rows file is
    reduced at the gate's burn-in."""
    out = {}
    for name, t in STUDIES[study]["truths"].items():
        out[name] = (stats_from_rows(read_rows(t), burn_frac=GATE_BURN)
                     if isinstance(t, str) else t)
    return out


def run_rows(study: str, steps: int, corrtime: int, seed: int, device,
             workdir: str):
    """The port's run of ``study`` in ``workdir``: (its per-corrtime (E, N)
    rows, the finished Simulation, its molecule slots at the start)."""
    common.write_inputs(workdir, run_in(study, steps, corrtime, seed),
                        box_of(study))
    sim, slots = common.run_simulation(
        workdir, device, polar_mixed=STUDIES[study]["polar_mixed"])
    return parse_energy_dat(os.path.join(workdir, "g.energy.dat")), sim, \
        slots


def drift_table(study: str, rows, truths: dict) -> None:
    """The tool's per-quarter table and both burn-ins, on stderr."""
    common.log(study, f"{'quarter':>8s} {'ours <E>':>12s} {'ours <N>':>9s}")
    for i, (e, n) in enumerate(quarters(rows)):
        common.log(study, f"{i:>8d} {e:>12.1f} {n:>9.2f}")
    for burn in (0.25, GATE_BURN):
        ours = stats_from_rows(rows, burn_frac=burn)
        for q in ("E", "N"):
            common.log(study, f"burn-in {burn:.0%} {q}: ours "
                       f"{ours[q][0]:.3f} +- {ours[q][1]:.3f}; " + "; ".join(
                           f"{name} {t[q][0]:.3f} +- {t[q][1]:.3f}"
                           for name, t in truths.items()))


def run(study: str, steps: int = STEPS, corrtime: int = CORRTIME,
        seed: int = SEED, device="cuda") -> dict:
    """Run ``study`` on ``device`` and reduce it: the JSON record."""
    truths = truths_of(study)
    with tempfile.TemporaryDirectory(prefix=f"{study}_") as d:
        clock = common.Clock(device)
        rows, sim, slots = run_rows(study, steps, corrtime, seed, device, d)
        wall = clock.seconds()
    drift_table(study, rows, truths)
    gate = rows[max(int(len(rows) * GATE_BURN), 1):]
    means = {q: common.mean_record(*error_parts([r[i] for r in gate]))
             for i, q in enumerate(("E", "N"))}
    sigma = {name: {q: sigma_distance((means[q]["mean"], means[q]["err"]),
                                      t[q]) for q in ("E", "N")}
             for name, t in truths.items()}
    rec = dict(
        study=study, steps=steps, corrtime=corrtime, seed=seed,
        burn_frac=GATE_BURN, samples=len(gate), wall_s=wall, means=means,
        truths={k: {q: list(v) for q, v in t.items()}
                for k, t in truths.items()},
        sigma=sigma,
        verdict=common.verdict(s for t in sigma.values()
                               for s in t.values()),
        mol_slots=[slots, sim.state.n_mol_slots],
        rows=[list(r) for r in rows])
    return rec
