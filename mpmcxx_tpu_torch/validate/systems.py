"""The validation studies' inputs, byte for byte their tools'.

Twins: tools/uvt_crosscheck.py (``_dense_argon_pqr``,
``_polar_system_pqr``, ``CONFIG`` and the ``--polar`` / ``--cavity``
lines), tools/npt_crosscheck.py (``CONFIG`` on
examples/gibbs-argon/boxA.pqr), tools/gibbs_vle.py (its constants,
``write_box``, the lever-rule split and the run.in of its ``main``) and
tools/ptemp_validate.py (the 16-atom 18 A argon box and its chain
options).  The port imports nothing from tools/: these are copies, and
tests/test_torch_validate.py holds them to the tools' bytes.
"""

from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARGON_BOX = os.path.join(ROOT, "examples", "gibbs-argon", "boxA.pqr")


# --- uVT (tools/uvt_crosscheck.py) ---------------------------------------

UVT_CONFIG = """job_name ar_uvt
ensemble uvt
temperature {temperature}
pressure {pressure}
insert_probability 0.4
numsteps {steps}
corrtime {corrtime}
seed {seed}
move_factor 0.25
{extra}pqr_input boxA.pqr
energy_output g.energy.dat
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
"""

# the --polar lines: 4-iteration Thole SCF with exponential damping
POLAR_EXTRA = ("polarization on\npolar_iterative on\npolar_ewald on\n"
               "polar_damp_type exponential\npolar_damp 2.1304\n"
               "polar_gamma 1.0\npolar_max_iter 4\n")
# the --cavity lines: a 6^3 grid of 2.6 A cavities
CAVITY_EXTRA = "cavity_bias on\ncavity_grid 6\ncavity_radius 2.6\n"


def dense_argon_pqr() -> str:
    """~100 argon atoms on a jittered 5x5x4 lattice in the 20 A box
    (uvt_crosscheck._dense_argon_pqr, :37)."""
    rng = np.random.default_rng(21)
    lines = []
    i = 0
    for ix in range(5):
        for iy in range(5):
            for iz in range(4):
                i += 1
                x = -10 + 4.0 * ix + 2.0 + rng.uniform(-0.4, 0.4)
                y = -10 + 4.0 * iy + 2.0 + rng.uniform(-0.4, 0.4)
                z = -10 + 5.0 * iz + 2.5 + rng.uniform(-0.4, 0.4)
                lines.append(
                    f"ATOM  {i:5d} Ar   Ar M {i:4d}   "
                    f"{x:8.3f} {y:8.3f} {z:8.3f} 39.948  0.0000  0.0000 "
                    f"119.8  3.405  0.0  0.0")
    return "\n".join(lines) + "\nEND\n"


def polar_system_pqr(n_sorb: int = 14) -> str:
    """8 frozen +-0.35e framework charges on a grid and ``n_sorb`` neutral
    polarizable argon-like sorbates (uvt_crosscheck._polar_system_pqr,
    :57): uniformly random for ``n_sorb`` <= 14, else on jittered FCC
    sites kept 3 A from the framework."""
    rng = np.random.default_rng(31)
    lines = []
    i = 0
    for ix in range(2):
        for iy in range(2):
            for iz in range(2):
                i += 1
                q = 0.35 if (ix + iy + iz) % 2 else -0.35
                lines.append(
                    f"ATOM  {i:5d} FW   FRM F {i:4d}   "
                    f"{-5 + 10 * ix:8.3f} {-5 + 10 * iy:8.3f} "
                    f"{-5 + 10 * iz:8.3f} 50.000 {q:8.4f}  0.5000 "
                    f"40.0  2.800  0.0  0.0")
    if n_sorb <= 14:
        pts = rng.uniform(-9, 9, (n_sorb, 3))
    else:
        nc = int(np.ceil((n_sorb / 4) ** (1 / 3)))
        while True:
            a = 20.0 / nc
            cell = np.stack(np.meshgrid(*[np.arange(nc)] * 3,
                                        indexing="ij"),
                            axis=-1).reshape(-1, 3)
            offs = np.array([[0, 0, 0], [0, .5, .5],
                             [.5, 0, .5], [.5, .5, 0]])
            pts = ((cell[:, None, :] + offs[None, :, :] + 0.25)
                   .reshape(-1, 3) * a - 10.0)
            pts += rng.uniform(-0.05 * a, 0.05 * a, pts.shape)
            fw = np.stack(np.meshgrid(*[[-5.0, 5.0]] * 3,
                                      indexing="ij"), axis=-1).reshape(-1, 3)
            d = pts[:, None, :] - fw[None, :, :]
            d -= 20.0 * np.round(d / 20.0)
            clear = (np.sqrt((d ** 2).sum(-1)).min(1) > 3.0)
            if clear.sum() >= n_sorb:
                break
            nc += 1
        pts = pts[clear]
        keep = rng.permutation(len(pts))[:n_sorb]
        pts = pts[keep]
    for m in range(n_sorb):
        i += 1
        x, y, z = pts[m]
        lines.append(
            f"ATOM  {i:5d} Ar   Ar M {i:4d}   "
            f"{x:8.3f} {y:8.3f} {z:8.3f} 39.948  0.0000  1.0000 "
            f"119.8  3.405  0.0  0.0")
    return "\n".join(lines) + "\nEND\n"


# --- NPT (tools/npt_crosscheck.py) ---------------------------------------

NPT_CONFIG = """job_name ar_npt
ensemble npt
temperature {temperature}
pressure {pressure}
volume_probability 0.05
volume_change_factor 0.12
numsteps {steps}
corrtime {corrtime}
seed {seed}
move_factor 0.3
pqr_input boxA.pqr
energy_output g.energy.dat
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
"""


# --- Gibbs VLE (tools/gibbs_vle.py) ---------------------------------------

EPS, SIG, MASS = 119.8, 3.405, 39.948     # argon
TSTAR = 0.90
T_K = TSTAR * EPS                         # 107.82 K
N_BOX = 128                               # per box initially
RHO_TOTAL = 0.30                          # overall reduced density
# Lotfi, Vrabec & Fischer, Mol. Phys. 76, 1319 (1992): full LJ at T* 0.90
LIT = {"rho_l": (0.7465, 0.002), "rho_v": (0.0146, 0.0015)}


def write_box(path, n, L, seed):
    """n argon atoms on a jittered lattice in an L^3 box (PQR, e units;
    gibbs_vle.write_box, :68)."""
    rng = np.random.default_rng(seed)
    g = int(np.ceil(n ** (1 / 3)))
    s = L / g
    pts = []
    for i in range(g):
        for j in range(g):
            for k in range(g):
                if len(pts) < n:
                    pts.append(((i + .5) * s - L / 2, (j + .5) * s - L / 2,
                                (k + .5) * s - L / 2))
    pts = np.asarray(pts) + rng.uniform(-0.25, 0.25, (n, 3))
    with open(path, "w") as f:
        for m, (x, y, z) in enumerate(pts):
            f.write(f"ATOM  {m+1:5d} Ar   Ar M {m+1:4d}   "
                    f"{x:8.3f}{y:8.3f}{z:8.3f} {MASS:.5f}  0.00000 "
                    f"0.00000 {EPS:.5f} {SIG:.5f} 0.0 0.0\n")
        f.write("END\n")


def vle_split(n_box: int) -> tuple:
    """(n_a, n_b, L) of gibbs_vle.main's lever start (:120-142): two L^3
    boxes of ``n_box`` / RHO_TOTAL sigma^3 each, the 2 ``n_box`` atoms
    split by the lever rule at the literature densities."""
    V_box = n_box / RHO_TOTAL * SIG ** 3     # A^3 per box
    L = V_box ** (1 / 3)
    n_total, V_total = 2 * n_box, 2 * V_box
    rl, rv = LIT["rho_l"][0] / SIG ** 3, LIT["rho_v"][0] / SIG ** 3
    V_l = (n_total - V_total * rv) / (rl - rv)
    n_a = int(round(rl * V_l))
    return n_a, n_total - n_a, L


def vle_run_in(L: float, steps: int, corrtime: int, seed: int) -> str:
    """The run.in gibbs_vle.main writes (:145-162) at its move_factor
    0.05."""
    return f"""job_name vle
ensemble nvt_gibbs
rd_lrc on
temperature {T_K}
transfer_probability 0.25
volume_probability 0.02
volume_change_factor 0.10
numsteps {steps}
corrtime {corrtime}
seed {seed}
move_factor 0.05
pqr_input boxA.pqr
pqr_input_B boxB.pqr
energy_output off
pqr_restart off
pqr_output off
traj_output off
basis1 {L:.6f} 0 0
basis2 0 {L:.6f} 0
basis3 0 0 {L:.6f}
"""


# --- parallel tempering (tools/ptemp_validate.py) -------------------------

PTEMP_L = 18.0
PTEMP_MOVE_FACTOR = 0.3


def ptemp_atoms() -> list:
    """The 16 LJ argon atoms of ptemp_validate.main (:72-86) as the port's
    AtomRecords: 4 x 2 x 2 sites of an 18 A box, jittered by 0.3 A."""
    from ..state import AtomRecord
    L = PTEMP_L
    rng = np.random.default_rng(7)
    atoms = []
    i = 0
    for ix in range(4):
        for iy in range(2):
            for iz in range(2):
                i += 1
                p = (np.array([ix * 4.5, iy * 9.0, iz * 9.0]) - L / 2
                     + 2.25 + rng.uniform(-0.3, 0.3, 3))
                atoms.append(AtomRecord(
                    "Ar", "Ar", i, x=p[0], y=p[1], z=p[2], mass=39.948,
                    charge=0.0, epsilon=119.8, sigma=3.405))
    return atoms


def ptemp_system(t_min: float, device):
    """(state, flags, params, opts) of ptemp_validate.main (:87-91): the
    box of ``ptemp_atoms`` on ``device``, plain LJ, NVT at ``t_min``,
    move_factor 0.3."""
    from .. import constants as const
    from ..flags import FFlags, RunParams
    from ..mc.chain import MCOptions
    from ..state import build_state
    state, _ = build_state(ptemp_atoms(), np.eye(3) * PTEMP_L,
                           device=device)
    opts = MCOptions(ensemble=const.ENSEMBLE_NVT,
                     move_factor=PTEMP_MOVE_FACTOR)
    return state, FFlags(), RunParams(temperature=t_min), opts
