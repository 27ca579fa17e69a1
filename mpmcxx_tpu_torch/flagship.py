"""The flagship benchmark workloads: ~10k-atom polarizable GCMC.

Twin: tools/flagship.py, the JAX side's builders (the port imports
nothing from tools/).  The constants and the numpy geometry are that file's, line
for line, so both packages and the reference binary's PQR see the same
configuration; the builders make the port's SystemState on ``device``.
An 80 A cubic box with a rigid charged framework (512 frozen atoms on an
8x8x8 grid, one molecule) and one of three sorbate models:

* **co2** (the headline): 3,200 rigid 3-site CO2-like sorbates (PHAST*
  shape: quadrupolar partial charges, per-site polarizabilities, two LJ
  site types) = 10,112 live atoms, 11,264 atom slots.
* **h2**: 2,000 rigid 5-site H2-like sorbates (BSS* shape: charged
  polarizable COM site, massive charged proton sites, off-center
  uncharged LJ sites) = 10,512 live atoms, 10,752 slots.
* **ar** (legacy): 9,728 monatomic uncharged polarizable sorbates
  (10,240 atoms, 10,752 slots).

Each runs uVT with oriented insertion, the incremental Delta-E and
structure-factor paths, polar_mixed Thole SCF (4 iterations per move) on
the polar cache and full Ewald.
"""

from __future__ import annotations

import numpy as np

L = 80.0
G_FRAME = 8                  # framework grid -> 512 frozen atoms
N_SORB = 9728                # mobile single-atom polarizable sorbates
N_TOTAL = G_FRAME ** 3 + N_SORB   # 10,240

TEMPERATURE = 150.0
FUGACITY = 1.0               # atm
INSERT_PROB = 0.2
EWALD_ALPHA = 3.5 / (L / 2.0)
POLAR_DAMP = 2.1304          # exponential Thole damping
POLAR_MAX_ITER = 4
MOVE_FACTOR = 0.5

FRAME_CHARGE_E = 0.30        # |e|, alternating sign
FRAME_EPS, FRAME_SIG, FRAME_ALPHA, FRAME_MASS = 40.0, 2.6, 1.0, 50.0
SORB_EPS, SORB_SIG, SORB_ALPHA, SORB_MASS = 119.8, 3.405, 1.64, 39.948

# --- 3-site CO2-like sorbate ----------------------------------------------
N_CO2 = 3200                      # live sorbate molecules
CO2_BOND = 1.162                  # C=O distance, A
CO2_Q_C, CO2_Q_O = 0.6512, -0.3256          # |e|
CO2_ALPHA_C, CO2_ALPHA_O = 1.2281, 0.7395   # A^3
CO2_EPS_C, CO2_SIG_C = 8.52, 3.055          # K, A
CO2_EPS_O, CO2_SIG_O = 76.76, 2.99
CO2_MASS_C, CO2_MASS_O = 12.011, 15.999
# 384 insertion slots land the atom capacity on 11,264 = 22*512
CO2_EXTRA_SLOTS = 384
N_TOTAL_CO2 = G_FRAME ** 3 + 3 * N_CO2      # 10,112 live atoms

# --- 5-site H2-like sorbate: zero-polarizability and zero-mass sites are
# legal (exponential Thole damping never reads alpha, alpha == 0 pins a
# dipole to zero, COMs are mass-weighted over the two proton sites) -------
N_H2 = 2000                       # live sorbate molecules
H2_BOND = 0.371                   # H2G -> H2E (half the H-H bond), A
H2_NOFF = 0.363                   # H2G -> H2N off-center LJ sites, A
# exactly 5-decimal (the PQR writer's %8.5f quantum) and neutral, so the
# reference binary reads the charges the builders use
H2_Q_G, H2_Q_E = -0.84616, 0.42308          # |e|
H2_ALPHA_G = 0.6938               # A^3, COM site only
H2_EPS_G, H2_SIG_G = 8.8516, 3.2293         # K, A
H2_EPS_N, H2_SIG_N = 4.0659, 2.3406
H2_MASS_E = 1.00794
# 48 insertion slots land the atom capacity on 10,752 = 21*512
H2_EXTRA_SLOTS = 48
N_TOTAL_H2 = G_FRAME ** 3 + 5 * N_H2        # 10,512 live atoms

# the monatomic model's insertion slots: 10,752 = 21*512 atom slots
AR_EXTRA_SLOTS = 512


def _framework_and_sites(clearance: float, n_wanted: int):
    """The 8x8x8 alternating-charge framework lattice plus a 23^3 site grid
    (3.48 A pitch) filtered to keep >= ``clearance`` A (min-image) from
    every framework atom, strided down to ``n_wanted`` sites."""
    s = L / G_FRAME
    framework = []
    for i in range(G_FRAME):
        for j in range(G_FRAME):
            for k in range(G_FRAME):
                q = FRAME_CHARGE_E if (i + j + k) % 2 == 0 else -FRAME_CHARGE_E
                framework.append(dict(
                    x=(i + .5) * s - L / 2, y=(j + .5) * s - L / 2,
                    z=(k + .5) * s - L / 2, q=q))

    gs = 23
    ss = L / gs
    pts = np.stack(np.meshgrid(*[np.arange(gs)] * 3, indexing="ij"),
                   axis=-1).reshape(-1, 3) * ss + ss / 2 - L / 2
    fpos = np.asarray([[a["x"], a["y"], a["z"]] for a in framework])
    d = pts[:, None, :] - fpos[None, :, :]
    d -= L * np.round(d / L)
    keep = np.sqrt((d * d).sum(-1)).min(axis=1) >= clearance
    sites = pts[keep]
    if len(sites) < n_wanted:
        raise RuntimeError(f"only {len(sites)} sorbate sites survive")
    idx = np.linspace(0, len(sites) - 1, n_wanted).round().astype(int)
    return framework, sites[idx]


def flagship_atoms(seed: int = 3):
    """(framework, sorbates): lists of dicts with positions in A and
    charges in |e|.  Sorbate sites keep >= 3.0 A from the framework,
    jittered to break lattice symmetry."""
    rng = np.random.default_rng(seed)
    framework, sites = _framework_and_sites(3.0, N_SORB)
    sites = sites + rng.uniform(-0.4, 0.4, (N_SORB, 3))
    sorbates = [dict(x=p[0], y=p[1], z=p[2], q=0.0) for p in sites]
    return framework, sorbates


def flagship_co2_molecules(seed: int = 3):
    """(framework, molecules): molecules as [N_CO2, 3, 3] positions (C, O,
    O) with random orientations; COMs keep >= 3.2 A (min-image) from every
    framework atom."""
    rng = np.random.default_rng(seed)
    framework, sites = _framework_and_sites(3.2, N_CO2)
    coms = sites + rng.uniform(-0.3, 0.3, (N_CO2, 3))

    # random molecular axes, uniform on the sphere
    u = rng.normal(size=(N_CO2, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    mols = np.stack([coms, coms + CO2_BOND * u, coms - CO2_BOND * u],
                    axis=1)                          # [N,3(sites),3(xyz)]
    # quantized to the PQR writer's %8.3f, so the state and the reference
    # binary's parsed configuration are bit-identical
    mols = np.round(mols, 3)
    return framework, mols


def flagship_h2_molecules(seed: int = 3):
    """(framework, molecules): molecules as [N_H2, 5, 3] positions (H2G,
    H2E, H2E, H2N, H2N) with random orientations; COMs keep >= 3.0 A
    (min-image) from every framework atom."""
    rng = np.random.default_rng(seed)
    framework, sites = _framework_and_sites(3.0, N_H2)
    coms = sites + rng.uniform(-0.3, 0.3, (N_H2, 3))

    u = rng.normal(size=(N_H2, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    offs = np.array([0.0, H2_BOND, -H2_BOND, H2_NOFF, -H2_NOFF])
    mols = coms[:, None, :] + offs[None, :, None] * u[:, None, :]
    mols = np.round(mols, 3)
    return framework, mols


CO2_SITES = (  # (atomtype, mass, q_e, alpha, eps, sig)
    ("CC", CO2_MASS_C, CO2_Q_C, CO2_ALPHA_C, CO2_EPS_C, CO2_SIG_C),
    ("OC", CO2_MASS_O, CO2_Q_O, CO2_ALPHA_O, CO2_EPS_O, CO2_SIG_O),
    ("OC", CO2_MASS_O, CO2_Q_O, CO2_ALPHA_O, CO2_EPS_O, CO2_SIG_O),
)


H2_SITES = (  # (atomtype, mass, q_e, alpha, eps, sig)
    ("H2G", 0.0, H2_Q_G, H2_ALPHA_G, H2_EPS_G, H2_SIG_G),
    ("H2E", H2_MASS_E, H2_Q_E, 0.0, 0.0, 0.0),
    ("H2E", H2_MASS_E, H2_Q_E, 0.0, 0.0, 0.0),
    ("H2N", 0.0, 0.0, 0.0, H2_EPS_N, H2_SIG_N),
    ("H2N", 0.0, 0.0, 0.0, H2_EPS_N, H2_SIG_N),
)

AR_SITES = (("Ar", SORB_MASS, 0.0, SORB_ALPHA, SORB_EPS, SORB_SIG),)

# the PQR writers quantize to %8.5f, so every charge, alpha and mass must
# already be 5-decimal for the reference binary to read the same values
for _sites in (CO2_SITES, H2_SITES):
    for _row in _sites:
        for _v in _row[1:]:
            if round(_v, 5) != _v:
                raise ValueError(f"{_row[0]}: {_v!r} is not exact in the "
                                 "PQR %8.5f quantum")
del _sites, _row, _v


def _monatomic():
    """(framework, [N_SORB, 1, 3] sorbate positions) of flagship_atoms."""
    framework, sorbates = flagship_atoms()
    return framework, np.array([[[a["x"], a["y"], a["z"]]]
                                for a in sorbates])


def _build(framework, mols, sites, moltype, extra_mol_capacity, device):
    """(state, meta, flags, params, opts) of the framework and the
    [N, S, 3] sorbate positions ``mols`` of one site table, under the
    flagship's force field and uVT options."""
    from . import constants as const
    from .flags import FFlags, RunParams
    from .mc.chain import MCOptions
    from .state import AtomRecord, build_state as _build_state

    atoms = [AtomRecord(
        "Fw", "MOF", 1, frozen=True, x=a["x"], y=a["y"], z=a["z"],
        mass=FRAME_MASS, charge=a["q"] * const.E2REDUCED,
        epsilon=FRAME_EPS, sigma=FRAME_SIG, polarizability=FRAME_ALPHA)
        for a in framework]
    for m in range(len(mols)):
        for site, (at, mass, q, al, eps, sig) in enumerate(sites):
            p = mols[m, site]
            atoms.append(AtomRecord(
                at, moltype, 100 + m, x=p[0], y=p[1], z=p[2], mass=mass,
                charge=q * const.E2REDUCED, epsilon=eps, sigma=sig,
                polarizability=al))
    state, meta = _build_state(atoms, np.eye(3) * L,
                               extra_mol_capacity=extra_mol_capacity,
                               device=device)
    flags = FFlags(polarization=True, polar_iterative=True, polar_ewald=True,
                   polar_mixed=True, polar_max_iter=POLAR_MAX_ITER,
                   damp_type=const.DAMPING_EXPONENTIAL)
    params = RunParams(temperature=TEMPERATURE, ewald_alpha=EWALD_ALPHA,
                       polar_ewald_alpha=EWALD_ALPHA, polar_damp=POLAR_DAMP,
                       polar_gamma=1.0)
    opts = MCOptions(
        ensemble=const.ENSEMBLE_UVT, move_factor=MOVE_FACTOR,
        insert_probability=INSERT_PROB, fugacity=FUGACITY,
        incremental=True, polar_incremental=True,
        max_mol_atoms=len(sites), blocked_energy=True)
    return state, meta, flags, params, opts


def build_state_co2(extra_mol_capacity: int = CO2_EXTRA_SLOTS,
                    device="cuda"):
    """The multi-site flagship on ``device``: SystemState, meta and
    (flags, params, opts) of the 3-site charged polarizable sorbate GCMC
    chain (S = 3 rows)."""
    framework, mols = flagship_co2_molecules()
    return _build(framework, mols, CO2_SITES, "CO2", extra_mol_capacity,
                  device)


def build_state_h2(extra_mol_capacity: int = H2_EXTRA_SLOTS,
                   device="cuda"):
    """The 5-site flagship on ``device``: SystemState, meta and (flags,
    params, opts) of the BSS*-shaped H2 sorbate GCMC chain (S = 5 rows with
    mixed zero-mass / zero-alpha / zero-LJ sites)."""
    framework, mols = flagship_h2_molecules()
    return _build(framework, mols, H2_SITES, "H2", extra_mol_capacity,
                  device)


def build_state(extra_mol_capacity: int = AR_EXTRA_SLOTS, device="cuda"):
    """The monatomic flagship on ``device``: SystemState, meta and (flags,
    params, opts) of the 9,728-sorbate GCMC chain (S = 1)."""
    return _build(*_monatomic(), AR_SITES, "ARG", extra_mol_capacity,
                  device)


def build(model: str, device="cuda"):
    """The flagship ``model`` ("co2", "h2" or "ar") on ``device``, as its
    builder makes it."""
    builders = {"co2": build_state_co2, "h2": build_state_h2,
                "ar": build_state}
    if model not in builders:
        raise ValueError(f"no flagship model {model!r}")
    return builders[model](device=device)


def topology(state):
    """Per-molecule-slot (starts, natoms) host arrays of a flagship state."""
    from .state import topology as _topology
    return _topology(state)


def _write_pqr(path, framework, mols, sites, moltype):
    """The framework (token 5 = F freezes it) and the [N, S, 3] molecules
    ``mols`` of one site table as a 20-token PQR (charges in e) for the
    reference binary."""
    with open(path, "w") as f:
        i = 0
        for a in framework:
            i += 1
            f.write(f"ATOM  {i:5d} Fw   MOF F    1   "
                    f"{a['x']:8.3f}{a['y']:8.3f}{a['z']:8.3f} "
                    f"{FRAME_MASS:.5f} {a['q']:8.5f} {FRAME_ALPHA:.5f} "
                    f"{FRAME_EPS:.5f} {FRAME_SIG:.5f} 0.00000 0.00000\n")
        for m in range(len(mols)):
            for site, (at, mass, q, al, eps, sig) in enumerate(sites):
                p = mols[m, site]
                i += 1
                f.write(f"ATOM  {i:5d} {at:<4s} {moltype:<3s} M {m + 2:4d}   "
                        f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f} "
                        f"{mass:.5f} {q:8.5f} {al:.5f} "
                        f"{eps:.5f} {sig:.5f} 0.00000 0.00000\n")
        f.write("END\n")


def write_pqr_co2(path: str):
    """The CO2 flagship's configuration as a PQR file."""
    _write_pqr(path, *flagship_co2_molecules(), CO2_SITES, "CO2")


def write_pqr_h2(path: str):
    """The H2 flagship's configuration as a PQR file."""
    _write_pqr(path, *flagship_h2_molecules(), H2_SITES, "H2")


def write_pqr(path: str):
    """The monatomic flagship's configuration as a PQR file."""
    _write_pqr(path, *_monatomic(), AR_SITES, "ARG")
