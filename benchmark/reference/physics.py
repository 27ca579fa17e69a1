"""The reference's parameters of a cell, read from the benchmark's own
configuration and traffic files (the ``run.in`` keys both carry), with
MPMC++'s defaults where a key is absent."""

from __future__ import annotations

from . import constants as C


def _on(v) -> bool:
    return v is True or str(v).lower() in ("on", "1", "yes", "true")


def physics(config: dict, traffic: dict) -> dict:
    keys = {**config["physics"], **traffic["runin"]}
    return {
        "temperature": float(keys["temperature"]),
        "polarization": _on(keys.get("polarization", "off")),
        "polar_damp": float(keys.get("polar_damp", 0.0)),
        "polar_gamma": float(keys.get("polar_gamma", 1.0)),
        "polar_max_iter": int(keys.get("polar_max_iter", 0)),
        "polar_precision": float(keys.get("polar_precision", 0.0)),
        "polar_palmo": _on(keys.get("polar_palmo", "off")),
        "feynman_hibbs": _on(keys.get("feynman_hibbs", "off")),
        "feynman_hibbs_order": int(keys.get("feynman_hibbs_order", 2)),
        "ewald_kmax": int(keys.get("ewald_kmax", C.EWALD_KMAX_DEFAULT)),
        "ewald_alpha": (float(keys["ewald_alpha"]) if "ewald_alpha" in keys
                        else None),
        "polar_ewald_alpha": (float(keys["polar_ewald_alpha"])
                              if "polar_ewald_alpha" in keys else None),
    }


def atoms(config: dict, pos, site, mol):
    """The live atoms' parameter table (numpy) from the configuration's
    model: ``pos`` [n, 3] the live atoms' positions, ``site`` [n] their
    index in the model's site table, ``mol`` [n] a molecule index."""
    import numpy as np
    tab = np.asarray([[s["mass"], s["charge"], s["alpha"], s["epsilon"],
                       s["sigma"]] for s in config["model"]["sites"]],
                     dtype=np.float64)
    mass, q, alpha, eps, sig = tab[site].T
    mol_mass = np.bincount(mol, weights=mass)[mol]
    return {"pos": np.asarray(pos, dtype=np.float64),
            "q": q * C.E2REDUCED, "sigma": sig, "epsilon": eps,
            "alpha": alpha, "frozen": np.zeros(len(site), dtype=bool),
            "mol": mol.astype(np.int64), "mol_mass": mol_mass}
