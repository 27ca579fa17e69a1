"""A small flagship-shaped system built into both packages from one
seeded numpy recipe: 8 frozen charged framework atoms and 40 rigid
sorbates in an 18 A box, with dead insertion slots, under the flagship's
force field and uVT options.  The sorbate is one of the three flagship
models of tools/flagship.py (``MODELS``): 3-site CO2 (CO2_SITES, 6 dead
slots: 134 atom slots), 5-site H2 (H2_SITES, 112 dead slots: 768 atom
slots, a size the triangle contraction schedules take) or monatomic Ar
(208 dead slots: 256 atom slots, the smallest such size)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import flagship  # noqa: E402

L = 18.0
N_MOL = 40
EXTRA = 6
E2REDUCED = 408.7816
AR_SITES = (("Ar", flagship.SORB_MASS, 0.0, flagship.SORB_ALPHA,
             flagship.SORB_EPS, flagship.SORB_SIG),)
# model -> (moleculetype, site table, site offsets along the molecular
# axis, dead insertion slots)
MODELS = {
    "co2": ("CO2", flagship.CO2_SITES,
            (0.0, flagship.CO2_BOND, -flagship.CO2_BOND), EXTRA),
    "h2": ("H2", flagship.H2_SITES,
           (0.0, flagship.H2_BOND, -flagship.H2_BOND, flagship.H2_NOFF,
            -flagship.H2_NOFF), 112),
    "ar": ("ARG", AR_SITES, (0.0,), 208),
}


def records(seed: int = 11, box: float = L, n_mol: int = N_MOL,
            g: int = 4, model: str = "co2"):
    """(kwargs per atom) for AtomRecord of either package: the 8 framework
    atoms and ``n_mol`` sorbates of ``model`` (see MODELS), centred on a
    jittered g^3 lattice of ``box`` and randomly oriented."""
    moltype, sites, offsets, _ = MODELS[model]
    rng = np.random.default_rng(seed)
    out = []
    s = box / 2
    for i in range(2):
        for j in range(2):
            for k in range(2):
                q = flagship.FRAME_CHARGE_E * (1 if (i + j + k) % 2 else -1)
                out.append(dict(
                    atomtype="Fw", moleculetype="MOF", molecule_id=1,
                    frozen=True, x=(i + .5) * s - s, y=(j + .5) * s - s,
                    z=(k + .5) * s - s, mass=flagship.FRAME_MASS,
                    charge=q * E2REDUCED, epsilon=flagship.FRAME_EPS,
                    sigma=flagship.FRAME_SIG,
                    polarizability=flagship.FRAME_ALPHA))
    pts = (np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                    -1).reshape(-1, 3) + 0.5) * (box / g) - box / 2
    frame = np.array([[r["x"], r["y"], r["z"]] for r in out])
    near = np.linalg.norm(pts[:, None] - frame[None], axis=-1).min(1) < 3.0
    pts = pts[~near]
    coms = pts[rng.choice(len(pts), n_mol, replace=False)] + \
        rng.uniform(-0.3, 0.3, (n_mol, 3))
    u = rng.normal(size=(n_mol, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    mols = np.round(np.stack([coms + o * u for o in offsets], 1), 3)
    for m in range(n_mol):
        for site, (at, mass, q, al, eps, sig) in enumerate(sites):
            p = mols[m, site]
            out.append(dict(
                atomtype=at, moleculetype=moltype, molecule_id=100 + m,
                x=p[0], y=p[1], z=p[2], mass=mass, charge=q * E2REDUCED,
                epsilon=eps, sigma=sig, polarizability=al))
    return out


def config(pkg_flags, pkg_const, MCOptions, max_iter=4, max_mol_atoms=3):
    """(flags, params, opts) of the flagship scaled to the small box."""
    alpha = 3.5 / (L / 2.0)
    flags = pkg_flags.FFlags(
        polarization=True, polar_iterative=True, polar_ewald=True,
        polar_mixed=True, polar_max_iter=max_iter,
        damp_type=pkg_const.DAMPING_EXPONENTIAL)
    params = pkg_flags.RunParams(
        temperature=flagship.TEMPERATURE, ewald_alpha=alpha,
        polar_ewald_alpha=alpha, polar_damp=flagship.POLAR_DAMP,
        polar_gamma=1.0)
    opts = MCOptions(
        ensemble=pkg_const.ENSEMBLE_UVT, move_factor=0.1,
        insert_probability=0.3, fugacity=20.0, incremental=True,
        polar_incremental=True, max_mol_atoms=max_mol_atoms,
        blocked_energy=True)
    return flags, params, opts


def jax_system(model: str = "co2"):
    from mpmcxx_tpu import constants as const
    from mpmcxx_tpu import flags as fl
    from mpmcxx_tpu.mc.chain import MCOptions
    from mpmcxx_tpu.state import AtomRecord, build_state
    _, sites, _, extra = MODELS[model]
    state, meta = build_state(
        [AtomRecord(**r) for r in records(model=model)], np.eye(3) * L,
        extra_mol_capacity=extra)
    return (state, meta) + config(fl, const, MCOptions,
                                  max_mol_atoms=len(sites))


def torch_system(device="cpu", model: str = "co2"):
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch import flags as fl
    from mpmcxx_tpu_torch.mc.chain import MCOptions
    from mpmcxx_tpu_torch.state import AtomRecord, build_state
    _, sites, _, extra = MODELS[model]
    state, meta = build_state(
        [AtomRecord(**r) for r in records(model=model)], np.eye(3) * L,
        extra_mol_capacity=extra, device=device)
    return (state, meta) + config(fl, const, MCOptions,
                                  max_mol_atoms=len(sites))


def jax_state_numpy(state):
    """A JAX SystemState as the field -> numpy mapping of
    mpmcxx_tpu_torch.state.state_from_jax."""
    import dataclasses
    out = {f.name: np.asarray(getattr(state, f.name))
           for f in dataclasses.fields(state) if f.name != "pbc"}
    out["pbc"] = {k: np.asarray(getattr(state.pbc, k))
                  for k in ("basis", "reciprocal", "volume", "cutoff")}
    return out


def write_pqr(path: str, recs) -> None:
    """``recs`` as a 20-token PQR (charges in e, F freezes the framework),
    every value exact at the file's precision."""
    with open(path, "w") as f:
        for i, r in enumerate(recs, 1):
            f.write(f"ATOM  {i:5d} {r['atomtype']:<4s} "
                    f"{r['moleculetype']:<3s} {'F' if r.get('frozen') else 'M'}"
                    f" {r['molecule_id']:4d}   "
                    f"{r['x']:8.3f}{r['y']:8.3f}{r['z']:8.3f} "
                    f"{r['mass']:.5f} {r['charge'] / E2REDUCED:8.5f} "
                    f"{r['polarizability']:.5f} {r['epsilon']:.5f} "
                    f"{r['sigma']:.5f} 0.00000 0.00000\n")
        f.write("END\n")
