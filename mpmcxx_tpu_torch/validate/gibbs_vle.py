"""Gibbs-ensemble argon vapor-liquid coexistence held to the literature.

Twin: tools/gibbs_vle.py.  Full GEMC (displace, transfer and the coupled
volume exchange) of LJ argon at T* = 0.90, 2 x ``nbox`` atoms at overall
rho* = 0.30 split by the lever rule at the literature densities, through
the port's ``GibbsSimulation`` chunk and refresh as the tool drives them;
each corrtime's (N_a, V_a, N_b, V_b) sample is reduced as the tool
reduces it (stats.vle_densities: the denser box is the liquid, the
larger of the block and tau-corrected errors) and compared with Lotfi,
Vrabec & Fischer (rho_l* 0.7465 +- 0.0020, rho_v* 0.0146 +- 0.0015).
"""

from __future__ import annotations

import tempfile

import numpy as np

from . import common, systems
from .stats import vle_densities

STEPS = 600000
CORRTIME = 400
SEED = 4
WARMUP_FRAC = 0.33


def simulation(nbox: int, steps: int, corrtime: int, seed: int, device):
    """The tool's boxes and run.in written into the working directory and
    its GibbsSimulation on ``device``: (the simulation, (n_a, n_b, L))."""
    from ..config.parser import read_config
    from ..mc.gibbs import GibbsSimulation
    n_a, n_b, L = systems.vle_split(nbox)
    systems.write_box("boxA.pqr", n_a, L, seed)
    systems.write_box("boxB.pqr", n_b, L, seed + 1)
    with open("run.in", "w") as f:
        f.write(systems.vle_run_in(L, steps, corrtime, seed))
    return GibbsSimulation(read_config("run.in"), quiet=True,
                           device=device), (n_a, n_b, L)


def sample(sim, n_chunks: int, study: str = "gibbs-vle"):
    """``n_chunks`` corrtimes of ``sim`` from its initial carry, each a
    chunk and a refresh (gibbs_vle.py:163-183): (the per-corrtime
    (N_a, V_a, N_b, V_b) samples, the final carry)."""
    sig3 = systems.SIG ** 3
    carry = sim._init_carry()
    samples = []
    for c in range(n_chunks):
        carry, _ = sim._run_chunk(carry)
        carry = sim._refresh(carry)
        na = float(carry.state_a.mol_alive.sum())
        nb = float(carry.state_b.mol_alive.sum())
        va = float(carry.state_a.pbc.volume)
        vb = float(carry.state_b.pbc.volume)
        samples.append((na, va, nb, vb))
        if c % 25 == 0 or c == n_chunks - 1:
            common.log(study, f"chunk {c + 1}/{n_chunks}: rho* = "
                       f"({na / va * sig3:.4f}, {nb / vb * sig3:.4f}) "
                       f"N = ({na:.0f}, {nb:.0f}) V* = ({va / sig3:.1f}, "
                       f"{vb / sig3:.1f})")
    return samples, carry


def run(steps: int = STEPS, corrtime: int = CORRTIME, seed: int = SEED,
        device="cuda", nbox: int = systems.N_BOX) -> dict:
    """Run the VLE study on ``device`` and reduce it: the JSON record."""
    study = "gibbs-vle"
    with tempfile.TemporaryDirectory(prefix="gibbs_vle_") as d, \
            common.in_dir(d):
        sim, (n_a, n_b, L) = simulation(nbox, steps, corrtime, seed, device)
        common.log(study, f"T = {systems.T_K:.2f} K, L = {L:.2f} A, "
                   f"N = ({n_a}, {n_b}) in equal boxes")
        clock = common.Clock(device)
        samples, carry = sample(sim, steps // corrtime)
        wall = clock.seconds()
    dens = vle_densities(samples, systems.SIG, WARMUP_FRAC)
    means, sigma = {}, {}
    for name, (mean, berr, terr, tau) in dens.items():
        means[name] = common.mean_record(mean, berr, terr, tau_int=tau)
        lit, lit_err = systems.LIT[name]
        comb = float(np.hypot(means[name]["err"], lit_err))
        sigma[name] = abs(mean - lit) / comb if comb else float("inf")
        common.log(study, f"{name}* = {mean:.4f} +- {means[name]['err']:.4f}"
                   f" (block {berr:.4f}, tau-corrected {terr:.4f} at tau_int"
                   f" {tau:.1f} samples); literature {lit:.4f} +- "
                   f"{lit_err:.4f} ({sigma[name]:.2f} sigma)")
    acc = carry.accept.cpu().numpy()
    return dict(
        study=study, steps=steps, corrtime=corrtime, seed=seed, nbox=nbox,
        start=[n_a, n_b], burn_frac=WARMUP_FRAC,
        samples=len(samples) - int(len(samples) * WARMUP_FRAC),
        wall_s=wall, means=means,
        truths={"literature": {k: list(v) for k, v in systems.LIT.items()}},
        sigma={"literature": sigma},
        verdict=common.verdict(sigma.values()),
        accepts={"volume": int(acc[5]), "transfer": int(acc[0]),
                 "displace": int(acc[2])},
        rows=[list(s) for s in samples])
