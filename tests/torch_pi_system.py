"""Small path-integral NVT systems of the port, built as the CLI builds
them (a ``run.in`` and a PQR, ``PISimulation``): Buch's one-site para-H2
(LJ 34.2 K, 2.96 A, 2.016 amu; the benchmark's PI model) and a two-site
H2 with orientation data (the bisection staging).  This module imports
no jax, so the card's tests can use it."""

import os

import numpy as np

import torch_co2_system as co2

RUN_IN = """job_name pg
ensemble pi_nvt
temperature {T}
bead_perturb_probability 0.5
pi_trial_chain_length 4
move_factor {move}
rot_factor 30.0
numsteps {steps}
corrtime {corrtime}
seed {seed}
pqr_input sys.pqr
energy_output /dev/null
pqr_output /dev/null
pqr_restart /dev/null
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
"""
# the two-site H2's orientation data (atom 1 its site; the keyword takes
# the reduced mass in kg)
ORIENTATION = """sorbate_orientation_site H2 1
sorbate_bondlength H2 0.742
sorbate_reducedmass H2 8.368618e-28
"""

# system -> (two sites, lattice side, box, beads, temperature, move
# factor): the card's sizes (64 para-H2 at 0.019 A^-3, 27 two-site H2)
# and the CPU's (8 of each)
CARD = {"para-h2": (False, 4, 15.0, 8, 25.0, 0.02),
        "h2-orientation": (True, 3, 12.0, 8, 20.0, 0.05)}
CPU = {"para-h2": (False, 2, 7.6, 8, 25.0, 0.02),
       "h2-orientation": (True, 2, 7.6, 8, 20.0, 0.05)}


def records(two_site: bool, g: int, L: float, seed: int = 5):
    """PQR records of g^3 H2 on a jittered lattice of side ``L``: the
    one-site para-H2, or the two-site H2 (+-0.371 A along a random
    axis)."""
    rng = np.random.default_rng(seed)
    out = []
    for m in range(g ** 3):
        c = (np.array([m // (g * g), (m // g) % g, m % g]) + 0.5) * \
            (L / g) - L / 2 + rng.uniform(-0.05, 0.05, 3)
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        sites = [(c + 0.371 * u, 1.008), (c - 0.371 * u, 1.008)] \
            if two_site else [(c, 2.016)]
        for p, mass in sites:
            out.append(dict(atomtype="H2", moleculetype="H2",
                            molecule_id=m + 1, x=p[0], y=p[1], z=p[2],
                            mass=mass, charge=0.0, polarizability=0.0,
                            epsilon=17.0 if two_site else 34.2,
                            sigma=2.7 if two_site else 2.96))
    return out


def write(d, system, seed=2147483651, steps=1000, corrtime=8) -> str:
    """The ``run.in`` and ``sys.pqr`` of ``system`` (CARD or CPU) in the
    directory ``d``; returns the ``run.in``'s path."""
    two, g, L, _, T, move = system
    co2.write_pqr(os.path.join(d, "sys.pqr"), records(two, g, L))
    path = os.path.join(d, "run.in")
    with open(path, "w") as f:
        f.write(RUN_IN.format(T=T, move=move, steps=steps,
                              corrtime=corrtime, seed=seed, L=L) +
                (ORIENTATION if two else ""))
    return path


def simulation(d, system, device, seed=2147483651):
    """A PISimulation of ``system`` as the CLI builds it from the files
    ``write`` leaves in ``d``, its start staged and its ``carry``
    made."""
    from mpmcxx_tpu_torch.config.parser import read_config
    from mpmcxx_tpu_torch.mc import pi
    path = write(d, system, seed)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        sim = pi.PISimulation(read_config(path), P=system[3], quiet=True,
                              device=device)
    finally:
        os.chdir(cwd)
    assert sim.incremental and sim.any_orientation == system[0]
    sim.thermalize()
    sim.carry = sim._init_carry()
    return sim
