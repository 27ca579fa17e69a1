"""Parallel tempering held to the Metropolis law.

Twin: tools/ptemp_validate.py, on the port's ``parallel/replicas``
(``make_replica_runner``, ``replicate_carry``, ``temperature_ladder``,
``tempering_swap``).  16 LJ argon atoms in an 18 A box, R baths on a
geometric ladder; swaps exchange the replicas' temperatures every
``swap_every`` steps.  Two gates:

1. per bath, the energies collected at that bath's temperature agree
   with an independent single-T chain's (the same R chains, no swaps);
2. the measured swap acceptance agrees with <min(1, exp(dB dE))> over
   the same attempted pairs.

The default ladder is the README's 140-240 K over 4 baths: at the tool's
100-180 K the independent mid-rung chains mix too slowly to serve as the
truth (README, Fidelity), which is no fault of the ladder.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import common, systems
from .stats import block_err, error_parts

STEPS = 40000
SWAP_EVERY = 50
BATHS = 4
T_MIN, T_MAX = 140.0, 240.0
SEED = 11


def with_temperature(carry, t: float):
    return dataclasses.replace(carry, temperature=torch.full(
        (), float(t), dtype=torch.float64, device=carry.temperature.device))


def run_chains(tempering: bool, seed: int, steps: int, swap_every: int,
               ladder, device):
    """R chains of the tool's box on ``device``, replica r starting at
    ``ladder[r]`` (ptemp_validate.run_chains, :96-137): (per-bath energy
    samples after the first quarter of the chunks, under tempering the
    [analytic probability, accepted] record of every attempted swap, and
    the final carries)."""
    from .. import random as rnd
    from ..mc import chain
    from ..parallel import replicas as rep
    state, flags, params, opts = systems.ptemp_system(float(ladder[0]),
                                                      device)
    R = len(ladder)
    runner = rep.make_replica_runner(flags, params, opts, swap_every)
    carry1 = chain.init_carry(state, flags, params, opts, seed)
    carries = [with_temperature(c, t) for c, t in
               zip(rep.replicate_carry(carry1, R, base_seed=seed), ladder)]
    key = rnd.PRNGKey(seed + 7919)
    parity = 0
    bath_samples = {t: [] for t in range(R)}
    swaps = []
    n_chunks = steps // swap_every
    burn = n_chunks // 4
    for c in range(n_chunks):
        carries, _ = runner(carries)
        E = np.asarray([float(x.obs.energy) for x in carries])
        T = np.asarray([float(x.temperature) for x in carries])
        if c >= burn:
            for r in range(R):
                b = int(np.argmin(np.abs(ladder - T[r])))
                bath_samples[b].append(E[r])
        if tempering:
            keys = rnd.split(key)
            key, k1 = keys[0], keys[1]
            new_t, swapped = rep.tempering_swap(T, E, k1, parity)
            if c >= burn:
                # pairs by replica index: left partners i % 2 == parity
                for i in range(parity, R - 1, 2):
                    p = min(1.0, float(np.exp(
                        (1 / T[i] - 1 / T[i + 1]) * (E[i] - E[i + 1]))))
                    swaps.append([p, float(swapped[i])])
            parity ^= 1
            carries = [with_temperature(x, t)
                       for x, t in zip(carries, new_t)]
    return bath_samples, swaps, carries


def run(steps: int = STEPS, seed: int = SEED, device="cuda",
        swap_every: int = SWAP_EVERY) -> dict:
    """Run the tempering study on ``device`` (a tempering run at ``seed``,
    independent chains at ``seed`` + 1, ``steps`` each, on the BATHS-rung
    ladder from T_MIN to T_MAX): the JSON record."""
    from ..parallel import replicas as rep
    study = "ptemp"
    ladder = np.asarray(rep.temperature_ladder(T_MIN, T_MAX, BATHS))
    common.log(study, f"ladder {np.round(ladder, 2).tolist()}, {steps} "
               f"steps per run, swaps every {swap_every}")
    clock = common.Clock(device)
    pt, swaps, _ = run_chains(True, seed, steps, swap_every, ladder,
                              device)
    ind, _, _ = run_chains(False, seed + 1, steps, swap_every, ladder,
                           device)
    wall = clock.seconds()
    baths_out, sigmas = [], []
    for b in range(BATHS):
        rec = {"T": float(ladder[b])}
        for name, s in (("tempering", pt[b]), ("independent", ind[b])):
            rec[name] = common.mean_record(*error_parts(s))
        e = max(np.hypot(rec["tempering"]["err"], rec["independent"]["err"]),
                1e-9)
        rec["sigma"] = abs(rec["tempering"]["mean"] -
                           rec["independent"]["mean"]) / e
        sigmas.append(rec["sigma"])
        baths_out.append(rec)
        common.log(study, f"T {ladder[b]:.2f}: tempering "
                   f"{rec['tempering']['mean']:.1f} +- "
                   f"{rec['tempering']['err']:.1f}, independent "
                   f"{rec['independent']['mean']:.1f} +- "
                   f"{rec['independent']['err']:.1f} "
                   f"({rec['sigma']:.2f} sigma)")
    sw = np.asarray(swaps)
    measured, analytic = float(sw[:, 1].mean()), float(sw[:, 0].mean())
    err = max(np.hypot(np.sqrt(measured * (1 - measured) / len(sw)),
                       block_err(sw[:, 0])[1]), 1e-9)
    swap = {"measured": measured, "analytic": analytic,
            "attempts": len(sw), "err": float(err),
            "sigma": abs(measured - analytic) / err}
    sigmas.append(swap["sigma"])
    common.log(study, f"swap acceptance: measured {measured:.4f} vs "
               f"analytic {analytic:.4f} over {len(sw)} attempts "
               f"({swap['sigma']:.2f} sigma)")
    return dict(study=study, steps=steps, swap_every=swap_every, seed=seed,
                ladder=ladder.tolist(), wall_s=wall, baths=baths_out,
                swap=swap, verdict=common.verdict(sigmas))
